"""Build the native library (g++; ctypes ABI, no pybind11): the
shared-memory store (``store.cpp``), the mutable shared-memory channel
of compiled DAGs (``channel.cpp``) and the TFRecord scanner
(``tfrec.cpp``, the Data library's frame walk and crc32c).

Host C++, not a kernel. Compiles lazily into
``ray_tpu_torch/native/_build/`` on first use; rebuilt when a source
is newer than the library. Safe under concurrent processes (atomic
rename). Linked ``-Bsymbolic``: the library's calls into its own C
functions bind to its own definitions, never to a same-named one of
another library in the process (the JAX package's exports the same
names).
"""

from __future__ import annotations

import os
import subprocess
import tempfile

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_SRC_DIR, "_build")
_SOURCES = ["store.cpp", "channel.cpp", "tfrec.cpp"]
_LIB = "libraytpu_torch_native.so"


def lib_path() -> str:
    return os.path.join(_BUILD_DIR, _LIB)


def _needs_build() -> bool:
    lib = lib_path()
    if not os.path.exists(lib):
        return True
    lib_mtime = os.path.getmtime(lib)
    return any(
        os.path.getmtime(os.path.join(_SRC_DIR, s)) > lib_mtime
        for s in _SOURCES)


def ensure_built() -> str | None:
    """Returns the library path, building if needed; None on failure."""
    if not _needs_build():
        return lib_path()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
           "-Wl,-Bsymbolic", "-o", tmp, *srcs, "-lpthread", "-lrt"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path())
        return lib_path()
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError) as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        stderr = getattr(e, "stderr", b"")
        if stderr:
            import sys
            print(f"[ray_tpu_torch.native] build failed:\n"
                  f"{stderr.decode(errors='replace')[:2000]}",
                  file=sys.stderr)
        return None
