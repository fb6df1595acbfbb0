"""ctypes binding for the native TFRecord scanner (tfrec.cpp).

Loads lazily from the shared native library; every entry point
degrades to None when the toolchain is unavailable so the pure-Python
codec in ray_tpu_torch.data.tfrecord keeps working.
"""

from __future__ import annotations

import ctypes

_lib = None
_tried = False


def get_lib():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        from ray_tpu_torch.native.build import ensure_built
        path = ensure_built()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.rtf_crc32c.restype = ctypes.c_uint32
        lib.rtf_crc32c.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
        lib.rtf_masked_crc.restype = ctypes.c_uint32
        lib.rtf_masked_crc.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.rtf_scan.restype = ctypes.c_long
        lib.rtf_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_long, ctypes.POINTER(ctypes.c_size_t)]
        _lib = lib
    except Exception:  # noqa: BLE001
        _lib = None
    return _lib


def scan_addr(addr: int, n: int, verify: bool, batch: int = 4096):
    """Yield (offset, length) of each record payload in the n-byte
    buffer at ``addr`` (e.g. an mmap'ed file). Raises ValueError on
    malformed frames / CRC mismatch, mirroring the pure-Python
    reader's errors."""
    lib = get_lib()
    assert lib is not None
    off = (ctypes.c_size_t * batch)()
    ln = (ctypes.c_size_t * batch)()
    pos = ctypes.c_size_t(0)
    while True:
        got = lib.rtf_scan(addr, n, 1 if verify else 0, off, ln,
                           batch, ctypes.byref(pos))
        if got == -1:
            raise ValueError("truncated TFRecord frame")
        if got == -2:
            raise ValueError("TFRecord crc mismatch")
        for i in range(got):
            yield off[i], ln[i]
        if got < batch:
            return
