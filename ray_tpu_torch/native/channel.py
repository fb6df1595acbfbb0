"""ctypes binding + Python Channel over the native mutable-object slot.

Counterpart of ``ray_tpu/native/channel.py``. The native layer
(channel.cpp) is the reference's experimental mutable
plasma object (src/ray/core_worker/experimental_mutable_object_manager
.cc); this class is the `Channel` of python/ray/experimental/channel/
shared_memory_channel.py: ``write(value)`` publishes a new version in
place, ``begin_read()``/``end_read()`` give each reader every version
exactly once. Values are serialized with the framework serializer;
payload framing is ``[1-byte err flag][data_len u64][data][n_bufs u64]
[buf_len u64, buf bytes]...`` so out-of-band numpy buffers are written
contiguously without an intermediate pickle copy.

A channel carries host values. A torch tensor goes through the port's
serializer: a CUDA tensor is copied to the host on write and is read
back as a CPU tensor of the same dtype, shape and bits, which the
reader moves to its own card. A tensor read never aliases the slot,
even with ``copy=False`` (the serializer copies a read-only buffer);
numpy arrays read with ``copy=False`` do, read-only. Shared-memory
names start with ``/rttch-``, apart from the JAX package's ``/rtch-``.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import uuid

from ray_tpu_torch.core import serialization as ser
from ray_tpu_torch.core.serialization import SerializedObject

_lib = None
_lib_lock = threading.Lock()

_OK = 0
_CLOSED = -1
_TIMEOUT = -2
_TOO_LARGE = -3
_ERROR = -4


class ChannelClosedError(Exception):
    """The channel was closed (or its writer died)."""


class ChannelTimeoutError(Exception):
    """A channel read/write timed out."""


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from ray_tpu_torch.native.build import ensure_built
        path = ensure_built()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.chn_create.restype = ctypes.c_void_p
        lib.chn_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.chn_attach.restype = ctypes.c_void_p
        lib.chn_attach.argtypes = [ctypes.c_char_p]
        lib.chn_reader_register.restype = ctypes.c_int
        lib.chn_reader_register.argtypes = [ctypes.c_void_p]
        lib.chn_reader_unregister.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int]
        lib.chn_write.restype = ctypes.c_int
        lib.chn_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_uint64, ctypes.c_int64]
        lib.chn_write_begin.restype = ctypes.c_int
        lib.chn_write_begin.argtypes = [ctypes.c_void_p,
                                        ctypes.c_uint64,
                                        ctypes.c_int64]
        lib.chn_write_commit.argtypes = [ctypes.c_void_p,
                                         ctypes.c_uint64]
        lib.chn_read_begin.restype = ctypes.c_int
        lib.chn_read_begin.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64]
        lib.chn_read_ack.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_uint64]
        lib.chn_close.argtypes = [ctypes.c_void_p]
        lib.chn_is_closed.restype = ctypes.c_int
        lib.chn_is_closed.argtypes = [ctypes.c_void_p]
        lib.chn_reader_count.restype = ctypes.c_int
        lib.chn_reader_count.argtypes = [ctypes.c_void_p]
        lib.chn_claim_writer.argtypes = [ctypes.c_void_p]
        lib.chn_capacity.restype = ctypes.c_uint64
        lib.chn_capacity.argtypes = [ctypes.c_void_p]
        lib.chn_data_ptr.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.chn_data_ptr.argtypes = [ctypes.c_void_p]
        lib.chn_detach.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def channels_available() -> bool:
    return _load() is not None


def _frame_size(obj) -> int:
    total = 1 + 8 + len(obj.data) + 8
    for b in obj.buffers:
        total += 8 + len(b)
    return total


DEFAULT_BUFFER_SIZE = 16 * 1024 * 1024


class Channel:
    """One mutable shm slot: single writer, N registered readers.

    Pickles to its shm name: passing a Channel to an actor attaches
    the same slot there (the reference passes channel refs into the
    DAG worker loop the same way).
    """

    def __init__(self, buffer_size: int = DEFAULT_BUFFER_SIZE,
                 _name: str | None = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native channel library unavailable")
        self._lib = lib
        self._creator = _name is None
        self.name = _name or f"/rttch-{os.getpid()}-{uuid.uuid4().hex[:12]}"
        if self._creator:
            self._h = lib.chn_create(self.name.encode(), buffer_size)
        else:
            self._h = lib.chn_attach(self.name.encode())
        if not self._h:
            raise OSError(f"could not open channel {self.name!r}")
        self._slot = -1            # reader registration (lazy)
        self._pending_ack: int | None = None
        self._detached = False

    def __reduce__(self):
        return (Channel, (0, self.name))

    # -- writer side --

    def write(self, value, timeout: float | None = None,
              _is_error: bool = False) -> None:
        # One copy total: serialize keeps out-of-band buffers as views
        # over the source arrays; after write_begin grants the payload
        # region (all readers acked — single-writer, so no lock is
        # needed while filling it), the frame is assembled directly in
        # the mapped shm and committed.
        obj = ser.serialize(value, copy_buffers=False)
        size = _frame_size(obj)
        cap = self._lib.chn_capacity(self._h)
        if size > cap:
            raise ValueError(
                f"serialized value ({size} B) exceeds channel buffer "
                f"({cap} B); pass a larger buffer_size at compile/create")
        tmo = -1 if timeout is None else int(timeout * 1000)
        rc = self._lib.chn_write_begin(self._h, size, tmo)
        if rc == _CLOSED:
            raise ChannelClosedError(self.name)
        if rc == _TIMEOUT:
            raise ChannelTimeoutError(f"write to {self.name} timed out")
        if rc != _OK:
            raise OSError(f"channel write failed (rc={rc})")
        base = self._lib.chn_data_ptr(self._h)
        addr = ctypes.addressof(base.contents)
        dst = memoryview((ctypes.c_uint8 * size).from_address(addr))\
            .cast("B")
        dst[0] = 1 if _is_error else 0
        pos = 1
        struct.pack_into("<Q", dst, pos, len(obj.data))
        pos += 8
        dst[pos:pos + len(obj.data)] = obj.data
        pos += len(obj.data)
        struct.pack_into("<Q", dst, pos, len(obj.buffers))
        pos += 8
        for b in obj.buffers:
            struct.pack_into("<Q", dst, pos, len(b))
            pos += 8
            dst[pos:pos + len(b)] = b
            pos += len(b)
        self._lib.chn_write_commit(self._h, size)

    def write_error(self, exc: BaseException,
                    timeout: float | None = None) -> None:
        self.write(exc, timeout, _is_error=True)

    # -- reader side --

    def _ensure_reader(self) -> None:
        if self._slot < 0:
            self._slot = self._lib.chn_reader_register(self._h)
            if self._slot < 0:
                raise OSError(f"channel {self.name}: reader table full")

    def register_reader(self) -> None:
        """Register now (instead of lazily on first read) — loops call
        this up front so no published version is missed."""
        self._ensure_reader()

    def reader_count(self) -> int:
        return self._lib.chn_reader_count(self._h)

    def claim_writer(self) -> None:
        """Mark this process as the producer (reader-side liveness
        then tracks the actor, not the creating driver)."""
        self._lib.chn_claim_writer(self._h)

    def begin_read(self, timeout: float | None = None, *,
                   copy: bool = False):
        """Block for the next version; returns (value, is_error).

        Zero-copy aliasing contract: with ``copy=False`` the
        deserialized buffers VIEW the mapped payload. The writer
        cannot overwrite them until ``end_read`` — but any value
        retained past ``end_read()`` is silently overwritten by the
        writer's next commit. Views are handed out read-only (numpy
        arrays arrive with ``writeable=False``) so mutation races are
        at least one-directional. Pass ``copy=True`` to copy out and
        ack immediately (the value then survives subsequent writes —
        used by driver-side reads).
        """
        self._ensure_reader()
        size = ctypes.c_uint64()
        version = ctypes.c_uint64()
        tmo = -1 if timeout is None else int(timeout * 1000)
        rc = self._lib.chn_read_begin(self._h, self._slot,
                                      ctypes.byref(size),
                                      ctypes.byref(version), tmo)
        if rc == _CLOSED:
            raise ChannelClosedError(self.name)
        if rc == _TIMEOUT:
            raise ChannelTimeoutError(f"read on {self.name} timed out")
        if rc != _OK:
            raise OSError(f"channel read failed (rc={rc})")
        base = self._lib.chn_data_ptr(self._h)
        addr = ctypes.addressof(base.contents)
        raw = (ctypes.c_uint8 * size.value).from_address(addr)
        view = memoryview(raw).cast("B")
        is_err = view[0] == 1
        pos = 1
        (dlen,) = struct.unpack_from("<Q", view, pos)
        pos += 8
        data = view[pos:pos + dlen]
        pos += dlen
        (nbufs,) = struct.unpack_from("<Q", view, pos)
        pos += 8
        buffers = []
        for _ in range(nbufs):
            (blen,) = struct.unpack_from("<Q", view, pos)
            pos += 8
            buffers.append(view[pos:pos + blen].toreadonly())
            pos += blen
        if copy:
            data = bytes(data)
            buffers = [bytes(b) for b in buffers]
        value = ser.deserialize(SerializedObject(data=bytes(data),
                                                 buffers=buffers))
        if copy:
            self._lib.chn_read_ack(self._h, self._slot, version.value)
            self._pending_ack = None
        else:
            self._pending_ack = version.value
        return value, is_err

    def end_read(self) -> None:
        """Release the version from the last ``begin_read``."""
        if self._pending_ack is not None:
            self._lib.chn_read_ack(self._h, self._slot,
                                   self._pending_ack)
            self._pending_ack = None

    def read(self, timeout: float | None = None):
        """Copying read: returns the value, raising a shipped error."""
        value, is_err = self.begin_read(timeout, copy=True)
        if is_err:
            raise value
        return value

    # -- lifecycle --

    def close(self) -> None:
        if not self._detached:
            self._lib.chn_close(self._h)

    def detach(self) -> None:
        if not self._detached:
            self._detached = True
            if self._slot >= 0:
                self._lib.chn_reader_unregister(self._h, self._slot)
            self._lib.chn_detach(self._h)

    def __del__(self):
        try:
            self.detach()
        except Exception:  # noqa: BLE001
            pass
