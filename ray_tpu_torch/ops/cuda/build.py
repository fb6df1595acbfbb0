"""Build the CUDA kernels with nvcc and bind them through ctypes.

Counterpart of ``ray_tpu/native/build.py``: each ``csrc/*.cu`` source is
compiled lazily, at first use, into its own shared library under
``ray_tpu_torch/ops/cuda/_build/`` with a plain C interface. The
sources build in parallel, one nvcc process each. A library is rebuilt
when its source or a shared header is newer than it; the rename into
place is atomic, so concurrent processes are safe.

Unlike the JAX package's build module this one raises on failure: a kernel
that does not build is an error, never a silent fallback.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, "csrc")
BUILD_DIR = os.path.join(_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, str]:
    """{name: path} of every ``csrc/<name>.cu``."""
    return {os.path.splitext(os.path.basename(p))[0]: p
            for p in sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))}


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def log_path(name: str) -> str:
    """nvcc's output for ``name``, with ptxas' register and spill counts."""
    return os.path.join(BUILD_DIR, f"{name}.log")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin: the "
                       "CUDA kernels of ray_tpu_torch cannot be built")


def _stale(name: str, src: str) -> bool:
    lib = lib_path(name)
    if not os.path.exists(lib):
        return True
    deps = [src] + glob.glob(os.path.join(SRC_DIR, "*.cuh"))
    return any(os.path.getmtime(d) > os.path.getmtime(lib) for d in deps)


def ensure_built() -> dict[str, str]:
    """Build every stale source, all at once; return {name: library path}.

    Raises RuntimeError naming the source and nvcc's output when a build
    fails."""
    todo = {name: src for name, src in sources().items()
            if _stale(name, src)}
    if todo:
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name, src in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-I", SRC_DIR, "-o", tmp, src]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            text = out.decode(errors="replace")
            with open(log_path(name), "w") as f:
                f.write(text)
            if proc.returncode == 0:
                os.replace(tmp, lib_path(name))
            else:
                os.unlink(tmp)
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                              f"{text[-4000:]}")
        if failed:
            raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return {name: lib_path(name) for name in sources()}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library ``name`` (a ``csrc/<name>.cu``),
    building the kernels first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = ensure_built()
            if name not in paths:
                raise RuntimeError(f"no CUDA source csrc/{name}.cu")
            lib = ctypes.CDLL(paths[name])
            _libs[name] = lib
        return lib
