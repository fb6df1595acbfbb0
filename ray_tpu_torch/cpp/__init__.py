"""C++ worker API: write tasks and actors in C++, run them as ray_tpu_torch
tasks/actors (counterpart of ``ray_tpu/cpp``; host code, no torch).

Reference analog: the ``cpp/`` worker tree (``cpp/include/ray/api.h``,
``cpp/src/ray/runtime/task/task_executor.cc``). The reference runs C++
tasks inside dedicated C++ worker processes speaking the full gRPC
protocol; the scoped re-base here runs the user's native code inside
the standard worker process through a stable C ABI (see
``ray_tpu_torch/cpp/ray_tpu.h``, the same macros and C ABI as the JAX
package's header, so a library built against either loads here) — the task *body* is C++, the transport is
the existing task machinery, and the cross-language boundary is raw
bytes (the reference's boundary is msgpack).

Driver-side usage::

    from ray_tpu_torch import cpp
    lib_path = cpp.compile_library(CPP_SOURCE)     # or a prebuilt .so
    lib = cpp.load_library(lib_path)
    ref = lib.add.remote(cpp.f64(1.5), cpp.f64(2.0))   # -> bytes
    assert cpp.to_f64(ray_tpu_torch.get(ref)) == 3.5

    Counter = lib.actor_class("Counter")
    c = Counter.remote(cpp.i64(10))
    assert cpp.to_i64(ray_tpu_torch.get(c.add.remote(cpp.i64(5)))) == 15

Args must be bytes-like (``bytes``/``bytearray``/``memoryview``/numpy
arrays); ``int``/``float``/``str`` are packed automatically (i64 / f64
little-endian / utf-8) to match ``raytpu::as<T>`` on the C++ side.
Returns are always ``bytes``. The shared object must be readable at
the same path on every node that may execute the task — on multi-node
clusters ship it via ``runtime_env={"working_dir": ...}``.

C++ exceptions propagate as :class:`CppError` through the normal
task-error path (retries, dependency-error propagation all apply).
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import tempfile

__all__ = [
    "CppError", "CppLibrary", "compile_library", "load_library",
    "f64", "i64", "to_f64", "to_i64",
]

_HEADER_DIR = os.path.dirname(os.path.abspath(__file__))


class CppError(RuntimeError):
    """A C++ task/actor raised an exception (message is e.what())."""


# -------------------------------------------------------------------
# Scalar packing helpers (mirror raytpu::as<T> / raytpu::bytes_of<T>).

def f64(x: float) -> bytes:
    return struct.pack("<d", x)


def i64(x: int) -> bytes:
    return struct.pack("<q", x)


def to_f64(b: bytes) -> float:
    return struct.unpack("<d", b)[0]


def to_i64(b: bytes) -> int:
    return struct.unpack("<q", b)[0]


def _coerce_arg(a) -> bytes:
    if isinstance(a, bytes):
        return a
    if isinstance(a, (bytearray, memoryview)):
        return bytes(a)
    if isinstance(a, bool):
        raise TypeError("pass bools to C++ tasks explicitly as i64(...)")
    if isinstance(a, int):
        return i64(a)
    if isinstance(a, float):
        return f64(a)
    if isinstance(a, str):
        return a.encode()
    tobytes = getattr(a, "tobytes", None)  # numpy host arrays
    if callable(tobytes):
        return tobytes()
    raise TypeError(
        f"C++ task args must be bytes-like/int/float/str, got {type(a)!r}")


# -------------------------------------------------------------------
# Library loading (per-process dlopen cache — workers land here too).

_DLLS: dict[str, ctypes.CDLL] = {}


def _dll(path: str) -> ctypes.CDLL:
    d = _DLLS.get(path)
    if d is not None:
        return d
    d = ctypes.CDLL(path, mode=ctypes.RTLD_LOCAL)
    d.rtpu_abi_version.restype = ctypes.c_int32
    ver = d.rtpu_abi_version()
    if ver != 1:
        raise CppError(f"{path}: unsupported rtpu ABI version {ver}")
    d.rtpu_task_count.restype = ctypes.c_int32
    d.rtpu_task_name.restype = ctypes.c_char_p
    d.rtpu_task_name.argtypes = [ctypes.c_int32]
    d.rtpu_actor_count.restype = ctypes.c_int32
    d.rtpu_actor_name.restype = ctypes.c_char_p
    d.rtpu_actor_name.argtypes = [ctypes.c_int32]
    d.rtpu_actor_method_count.restype = ctypes.c_int32
    d.rtpu_actor_method_count.argtypes = [ctypes.c_char_p]
    d.rtpu_actor_method_name.restype = ctypes.c_char_p
    d.rtpu_actor_method_name.argtypes = [ctypes.c_char_p, ctypes.c_int32]
    PP = ctypes.POINTER(ctypes.c_char_p)
    d.rtpu_task_invoke.restype = ctypes.c_int32
    d.rtpu_task_invoke.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t), PP]
    d.rtpu_actor_new.restype = ctypes.c_void_p
    d.rtpu_actor_new.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_size_t), ctypes.c_int32, PP]
    d.rtpu_actor_invoke.restype = ctypes.c_int32
    d.rtpu_actor_invoke.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t), PP]
    d.rtpu_actor_delete.restype = None
    d.rtpu_actor_delete.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    d.rtpu_free.restype = None
    d.rtpu_free.argtypes = [ctypes.c_void_p]
    _DLLS[path] = d
    return d


def _pack_args(args) -> tuple:
    blobs = [_coerce_arg(a) for a in args]
    n = len(blobs)
    ptrs = (ctypes.c_void_p * max(n, 1))()
    lens = (ctypes.c_size_t * max(n, 1))()
    # keep the bytes objects alive via `blobs` until the call returns
    for j, b in enumerate(blobs):
        ptrs[j] = ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p)
        lens[j] = len(b)
    return blobs, ptrs, lens, n


def _take_result(d, rc, out, out_len, err) -> bytes:
    if rc != 0:
        msg = ctypes.cast(err, ctypes.c_char_p).value or b"unknown error"
        d.rtpu_free(err)
        raise CppError(msg.decode(errors="replace"))
    try:
        return ctypes.string_at(out.value, out_len.value)
    finally:
        d.rtpu_free(out)


def invoke_task(path: str, name: str, *args) -> bytes:
    """Worker-side trampoline for a C++ task (also callable locally)."""
    d = _dll(path)
    _keep, ptrs, lens, n = _pack_args(args)
    out = ctypes.c_void_p()
    out_len = ctypes.c_size_t()
    err = ctypes.c_char_p()
    rc = d.rtpu_task_invoke(name.encode(), ptrs, lens, n,
                            ctypes.byref(out), ctypes.byref(out_len),
                            ctypes.byref(err))
    return _take_result(d, rc, out, out_len, err)


def _actor_new(path: str, cls: str, args) -> int:
    d = _dll(path)
    _keep, ptrs, lens, n = _pack_args(args)
    err = ctypes.c_char_p()
    h = d.rtpu_actor_new(cls.encode(), ptrs, lens, n, ctypes.byref(err))
    if not h:
        msg = ctypes.cast(err, ctypes.c_char_p).value or b"ctor failed"
        d.rtpu_free(err)
        raise CppError(msg.decode(errors="replace"))
    return h


def _actor_invoke(path: str, cls: str, handle: int, method: str,
                  args) -> bytes:
    d = _dll(path)
    _keep, ptrs, lens, n = _pack_args(args)
    out = ctypes.c_void_p()
    out_len = ctypes.c_size_t()
    err = ctypes.c_char_p()
    rc = d.rtpu_actor_invoke(ctypes.c_void_p(handle), cls.encode(),
                             method.encode(), ptrs, lens, n,
                             ctypes.byref(out), ctypes.byref(out_len),
                             ctypes.byref(err))
    return _take_result(d, rc, out, out_len, err)


def _actor_delete(path: str, cls: str, handle: int) -> None:
    _dll(path).rtpu_actor_delete(cls.encode(), ctypes.c_void_p(handle))


# -------------------------------------------------------------------
# Driver-side wrappers.

class CppTask:
    """A named C++ task bound to a library path; ``.remote(*args)``."""

    def __init__(self, path: str, name: str, remote_fn):
        self._path, self._name, self._rf = path, name, remote_fn

    def remote(self, *args):
        return self._rf.remote(self._path, self._name, *args)

    def options(self, **opts) -> "CppTask":
        return CppTask(self._path, self._name, self._rf.options(**opts))

    def __call__(self, *args) -> bytes:  # local (in-process) invocation
        return invoke_task(self._path, self._name, *args)

    def __repr__(self):
        return f"CppTask({self._name!r} @ {os.path.basename(self._path)})"


def _make_actor_namespace(path: str, cls: str, methods: list[str]) -> dict:
    def __init__(self, *args):
        from ray_tpu_torch import cpp as _cpp
        self._h = _cpp._actor_new(path, cls, args)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._h = None
            try:
                from ray_tpu_torch import cpp as _cpp
                _cpp._actor_delete(path, cls, h)
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass

    ns = {"__init__": __init__, "__del__": __del__}

    def make(m):
        def method(self, *args):
            from ray_tpu_torch import cpp as _cpp
            return _cpp._actor_invoke(path, cls, self._h, m, args)
        method.__name__ = m
        return method

    for m in methods:
        if m not in ns:
            ns[m] = make(m)
    return ns


class CppLibrary:
    """An enumerated, loaded C++ task library.

    ``lib.<task>`` / ``lib.task(name)`` return :class:`CppTask`;
    ``lib.actor_class(name)`` returns a ray_tpu_torch actor class whose
    methods run the C++ methods inside the actor's worker process.
    """

    def __init__(self, path: str, num_cpus: float = 1):
        from ray_tpu_torch.core import api as _api
        self.path = os.path.abspath(path)
        d = _dll(self.path)
        self.task_names = [
            d.rtpu_task_name(i).decode() for i in range(d.rtpu_task_count())]
        self.actor_names = [
            d.rtpu_actor_name(i).decode()
            for i in range(d.rtpu_actor_count())]
        self._methods = {}
        for cls in self.actor_names:
            c = cls.encode()
            self._methods[cls] = [
                d.rtpu_actor_method_name(c, i).decode()
                for i in range(d.rtpu_actor_method_count(c))]
        self._remote_invoke = _api.remote(num_cpus=num_cpus)(invoke_task)
        self._tasks = {
            n: CppTask(self.path, n, self._remote_invoke)
            for n in self.task_names}
        self._actor_classes: dict[str, object] = {}

    def task(self, name: str) -> CppTask:
        try:
            return self._tasks[name]
        except KeyError:
            raise AttributeError(
                f"no C++ task {name!r} in {self.path} "
                f"(has: {self.task_names})") from None

    def actor_class(self, name: str, **remote_opts):
        key = name
        if key in self._actor_classes and not remote_opts:
            return self._actor_classes[key]
        if name not in self._methods:
            raise AttributeError(
                f"no C++ actor {name!r} in {self.path} "
                f"(has: {self.actor_names})")
        from ray_tpu_torch.core import api as _api
        ns = _make_actor_namespace(self.path, name, self._methods[name])
        klass = type(f"Cpp{name}", (), ns)
        opts = {"num_cpus": 0, **remote_opts}
        wrapped = _api.remote(**opts)(klass)
        if not remote_opts:
            self._actor_classes[key] = wrapped
        return wrapped

    def methods(self, actor: str) -> list[str]:
        return list(self._methods[actor])

    def __getattr__(self, name: str) -> CppTask:
        if name.startswith("_"):
            raise AttributeError(name)
        return self.task(name)

    def __repr__(self):
        return (f"CppLibrary({self.path!r}, tasks={self.task_names}, "
                f"actors={self.actor_names})")


def load_library(path: str, num_cpus: float = 1) -> CppLibrary:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return CppLibrary(path, num_cpus=num_cpus)


def compile_library(source: str, out: str | None = None,
                    extra_flags: list[str] | None = None) -> str:
    """Compile C++ source text (or a source-file path) into a shared
    object including the ``ray_tpu.h`` API header; returns the .so
    path. The caller owns the returned file (with ``out=None`` it is a
    file under ``ray_tpu_torch_cpp`` in the temporary directory, which
    the caller should delete when done).
    """
    from ray_tpu_torch.core.config import temp_path
    scratch = temp_path("ray_tpu_torch_cpp")
    os.makedirs(scratch, exist_ok=True)
    if os.path.exists(source) and source.endswith((".cc", ".cpp", ".cxx")):
        src_path, cleanup = source, False
    else:
        fd, src_path = tempfile.mkstemp(suffix=".cc", dir=scratch)
        with os.fdopen(fd, "w") as f:
            f.write(source)
        cleanup = True
    made_out = out is None
    if out is None:
        fd, out = tempfile.mkstemp(suffix=".so", dir=scratch)
        os.close(fd)
    # hidden visibility: each library keeps a private registry (only the
    # RAY_TPU_MODULE C ABI is exported) — see the note in ray_tpu.h.
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
           "-fvisibility=hidden", "-fvisibility-inlines-hidden",
           f"-I{_HEADER_DIR}", "-o", out, src_path,
           *(extra_flags or [])]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=180)
        if r.returncode != 0:
            raise CppError(
                "compile failed:\n" + r.stderr.decode(errors="replace")[:4000])
    except BaseException:
        if made_out:  # don't leave a zero-byte .so behind on failure
            try:
                os.unlink(out)
            except OSError:
                pass
        raise
    finally:
        if cleanup:
            try:
                os.unlink(src_path)
            except OSError:
                pass
    return out
