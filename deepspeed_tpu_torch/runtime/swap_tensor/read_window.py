"""Rotating NVMe read window: per-slot AIO handles and persistent buffers.

Port of ``deepspeed_tpu/runtime/swap_tensor/read_window.py``. The
ZeRO-Infinity stream issues optimizer-state reads ``k`` blocks ahead of the
block being applied. One shared :class:`~deepspeed_tpu_torch.ops.aio.
AsyncIOHandle` cannot express that (its ``wait()`` fences every request,
the look-ahead too), so :class:`AioReadWindow` rotates a few slots, each
with a private handle and persistent 4096-aligned fp32 buffers keyed by
block size (host memory: slots x buffers a block x the largest block). A
slot whose buffers still ride a write-back is released only once that
write is fenced (``NVMeParamStore.apply_block``).
"""

import torch

from ...ops.aio import AsyncIOHandle, aligned_empty


class _Slot:
    """One window slot: a private AIO handle and its persistent buffers."""

    __slots__ = ("handle", "_bufs")

    def __init__(self, handle_kw):
        self.handle = AsyncIOHandle(**handle_kw)
        self._bufs = {}

    def buffers(self, n, count):
        """``count`` persistent aligned fp32 buffers of ``n`` elements."""
        key = (int(n), int(count))
        bufs = self._bufs.get(key)
        if bufs is None:
            bufs = tuple(aligned_empty(int(n), torch.float32) for _ in range(count))
            self._bufs[key] = bufs
        return bufs


class AioReadWindow:
    """Pool of read slots: acquire one per in-flight block, release it when
    no async request references its buffers any more."""

    def __init__(self, slots, handle_kw):
        self._slots = [_Slot(handle_kw) for _ in range(max(1, int(slots)))]
        self._free = list(self._slots)

    def acquire(self):
        """A free slot, or None when the window is saturated."""
        return self._free.pop() if self._free else None

    def release(self, slot):
        self._free.append(slot)

    @property
    def size(self):
        return len(self._slots)

    def io_stats(self):
        """The slots' pools' O_DIRECT and buffered bytes, summed."""
        out = {}
        for s in self._slots:
            for k, v in s.handle.io_stats().items():
                out[k] = out.get(k, 0) + v
        return out
