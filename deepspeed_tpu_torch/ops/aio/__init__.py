"""Async file I/O handle over the native worker pool.

Port of ``deepspeed_tpu/ops/aio/__init__.py`` (the reference's
``AsyncIOBuilder().load().aio_handle(...)``, ``csrc/aio/py_lib/
py_ds_aio.cpp``: ``async_pread`` / ``async_pwrite`` / ``wait``) over CPU torch
tensors. ``ops/csrc/aio.c`` (the JAX package's pool, plus byte counters)
builds at first use with the host C compiler (``ops/build.py::load_host``);
a failed build raises, nothing falls back to synchronous Python I/O.
Requests larger than ``block_size`` split into block requests across the
pool's threads. A request whose buffer and file offset are 4096-aligned
(:func:`aligned_empty`) moves its aligned bulk through ``O_DIRECT``; the C
pool switches to buffered I/O on a file system that refuses it. The handle
counts the bytes each way (:attr:`AsyncIOHandle.bytes_read`,
:attr:`bytes_written`) and the pool the ``O_DIRECT`` and buffered bytes
(:meth:`AsyncIOHandle.io_stats`).
"""

import ctypes
import os

import torch

from .. import build

SOURCE = "aio"
FLAGS = ("-O2", )
ALIGN = 4096

_lib = None


def load_library():
    """The native pool, built on first use (raises on a failed build)."""
    global _lib
    if _lib is None:
        lib = build.load_host(SOURCE, FLAGS, ("-lpthread", ))
        lib.ds_aio_create.restype = ctypes.c_void_p
        lib.ds_aio_create.argtypes = [ctypes.c_int]
        lib.ds_aio_submit.restype = ctypes.c_int
        lib.ds_aio_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.ds_aio_wait.restype = ctypes.c_int64
        lib.ds_aio_wait.argtypes = [ctypes.c_void_p]
        lib.ds_aio_stats.restype = None
        lib.ds_aio_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.ds_aio_destroy.restype = None
        lib.ds_aio_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def aio_available():
    """True when the native pool builds here (no fallback exists)."""
    try:
        load_library()
        return True
    except RuntimeError:
        return False


def aligned_empty(n, dtype=torch.float32, align=ALIGN):
    """An uninitialized flat CPU tensor of ``n`` elements whose data pointer
    is ``align``-byte aligned, so the pool's ``O_DIRECT`` path takes it."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = int(n) * itemsize
    raw = torch.empty(nbytes + align, dtype=torch.uint8)
    off = (-raw.data_ptr()) % align
    return raw[off:off + nbytes].view(dtype)


class AsyncIOHandle:
    """``async_pread`` / ``async_pwrite`` / ``wait`` over contiguous CPU
    tensors. One handle owns one native thread pool. A buffer handed to an
    async call must stay alive, and unmodified for a write, until
    ``wait()`` returns; the handle keeps a reference until then.
    ``queue_depth`` / ``overlap_events`` are recorded for config parity: the
    pool's queue is unbounded and its overlap comes from its threads."""

    def __init__(self, block_size=1048576, queue_depth=8, single_submit=False,
                 overlap_events=True, thread_count=4):
        self.block_size = int(block_size)
        self.thread_count = int(thread_count)
        self.queue_depth = int(queue_depth)
        self.single_submit = bool(single_submit)
        self.overlap_events = bool(overlap_events)
        self._lib = load_library()
        self._h = self._lib.ds_aio_create(self.thread_count)
        self._keepalive = []
        self.bytes_read = 0
        self.bytes_written = 0

    def _submit(self, buf, filename, is_write, file_offset=0):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError("async I/O buffers must be contiguous CPU tensors")
        if self._h is None:
            raise RuntimeError("async I/O handle is closed")
        self._keepalive.append(buf)
        nbytes = buf.numel() * buf.element_size()
        base = buf.data_ptr()
        path = os.fsencode(filename)
        step = nbytes if self.single_submit or nbytes <= self.block_size else self.block_size
        off = 0
        while True:
            chunk = min(step, nbytes - off)
            if self._lib.ds_aio_submit(self._h, path, base + off, chunk, file_offset + off,
                                       int(is_write)) != 0:
                raise OSError(f"aio submit failed for {filename}")
            off += chunk
            if off >= nbytes:
                break
        if is_write:
            self.bytes_written += nbytes
        else:
            self.bytes_read += nbytes

    def async_pread(self, buffer, filename, file_offset=0):
        self._submit(buffer, filename, is_write=False, file_offset=file_offset)

    def async_pwrite(self, buffer, filename, file_offset=0):
        self._submit(buffer, filename, is_write=True, file_offset=file_offset)

    def wait(self):
        """Block until every submitted request finished; raise if any
        failed (a short read of a missing or short file fails)."""
        failed = self._lib.ds_aio_wait(self._h)
        self._keepalive.clear()
        if failed:
            raise OSError(f"{failed} async IO request(s) failed")
        return 0

    def sync_pread(self, buffer, filename, file_offset=0):
        self.async_pread(buffer, filename, file_offset)
        return self.wait()

    def sync_pwrite(self, buffer, filename, file_offset=0):
        self.async_pwrite(buffer, filename, file_offset)
        return self.wait()

    def io_stats(self):
        """{"direct_read", "direct_write", "buffered_read", "buffered_write"}:
        bytes the pool moved each way through ``O_DIRECT`` and buffered."""
        out = (ctypes.c_int64 * 4)()
        self._lib.ds_aio_stats(self._h, out)
        return dict(zip(("direct_read", "direct_write", "buffered_read", "buffered_write"), out))

    def close(self):
        if self._h is not None:
            self._lib.ds_aio_wait(self._h)
            self._keepalive.clear()
            self._lib.ds_aio_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
