"""ZeRO-Infinity optimizer tier: the fp32 master and the Adam moments on
NVMe.

Port of ``deepspeed_tpu/runtime/swap_tensor/optimizer_swapper.py``
(``NVMeOffloadOptimizer``; reference ``partitioned_optimizer_swapper.py:40``
and ``pipelined_optimizer_swapper.py:164``). Each block (one per tensor,
this rank's partition of it) keeps three flat files (master, m, v) under
``nvme_path``, one file set per rank; host
memory holds the compute copy, the gradient landing buffer and a rotating
window of three blocks' buffers. The step walks the blocks:

    read[i+1] in flight  |  C AdamW on block i  |  write[i-1] in flight

(``pipeline_read`` / ``pipeline_write`` off: each read / write is waited on
at once). The math is the host tier's, block by block, so the masters are
bitwise the host tier's.
"""

import os
import time

from ... import comm as dist
from ...ops.aio import AsyncIOHandle, aligned_empty
from ...utils.logging import log_dist
from ..zero.offload import HostOffloadOptimizer, _sync, cast_to
from .aio_config import get_aio_config
from .read_window import AioReadWindow

_KINDS = ("master", "m", "v")


class NVMeOffloadOptimizer(HostOffloadOptimizer):
    """:class:`HostOffloadOptimizer` with its state in files."""

    def __init__(self, optimizer_config, device, compute_dtype, nvme_path, aio_config=None,
                 pipeline_read=True, pipeline_write=True):
        super().__init__(optimizer_config, device, compute_dtype)
        aio = aio_config if aio_config is not None else get_aio_config({})
        kw = dict(block_size=aio["block_size"], queue_depth=aio["queue_depth"],
                  single_submit=aio["single_submit"], overlap_events=aio["overlap_events"],
                  thread_count=max(1, aio["thread_count"]) * 2)
        # one file set per rank: each holds its own partition
        self.swap_dir = os.path.join(nvme_path, f"zero_stage_opt_swap_rank{dist.get_rank():05d}")
        os.makedirs(self.swap_dir, exist_ok=True)
        self._window = AioReadWindow(3, kw)
        self._write_h = AsyncIOHandle(**kw)
        self.pipeline_read = bool(pipeline_read)
        self.pipeline_write = bool(pipeline_write)

    def _path(self, i, kind):
        return os.path.join(self.swap_dir, f"blk{i:05d}.{kind}")

    # -- state -----------------------------------------------------------
    def _alloc_state(self, named_params):
        zeros = aligned_empty(max((b - a for a, b in self.blocks), default=0)).zero_()
        for i, ((a, b), t) in enumerate(zip(self.blocks, named_params.values())):
            buf = aligned_empty(b - a)
            buf.copy_(t.detach().reshape(-1))
            self._write_h.async_pwrite(buf, self._path(i, "master"))
            for kind in ("m", "v"):
                self._write_h.async_pwrite(zeros[:b - a], self._path(i, kind))
            self._write_h.wait()
        log_dist(f"ZeRO-Infinity: {self.n:,} params' optimizer state on NVMe "
                 f"({12 * self.n / 2**30:.2f} GiB under {self.swap_dir})", [0])

    def host_bytes(self):
        return 2 * self.n * self.host_c.element_size()

    def io_stats(self):
        """Bytes read and written, and the O_DIRECT and buffered bytes."""
        out = self._window.io_stats()
        for k, v in self._write_h.io_stats().items():
            out[k] += v
        out["bytes_read"] = sum(s.handle.bytes_read for s in self._window._slots)
        out["bytes_written"] = self._write_h.bytes_written
        return out

    def _read(self, i):
        slot = self._window.acquire()
        a, b = self.blocks[i]
        for buf, kind in zip(slot.buffers(b - a, 3), _KINDS):
            slot.handle.async_pread(buf, self._path(i, kind))
        if not self.pipeline_read:
            slot.handle.wait()
        return slot

    def _read_block(self, i):
        """(master, m, v) of block ``i``, read serially (owned tensors)."""
        a, b = self.blocks[i]
        slot = self._read(i)
        slot.handle.wait()
        out = tuple(x.clone() for x in slot.buffers(b - a, 3))
        self._window.release(slot)
        return out

    def refresh_compute(self):
        _sync(self._push_done)
        for i, (a, b) in enumerate(self.blocks):
            cast_to(self._read_block(i)[0], self.host_c[a:b])
        self._push_done = self._io.copy(self._io.h2d, self.dev_c, self.host_c)
        self._io.consume(self._push_done)

    # -- the pipelined step ------------------------------------------------
    def step(self, grad_coef, lr):
        self.t += 1
        _sync(self._push_done)
        t0 = time.perf_counter()
        for ev in self._fetch():
            _sync(ev)
        t1 = time.perf_counter()
        writing = None
        nxt = self._read(0) if self.blocks else None
        for i, (a, b) in enumerate(self.blocks):
            slot = nxt
            slot.handle.wait()
            if i + 1 < len(self.blocks):
                nxt = self._read(i + 1)
            master, m, v = slot.buffers(b - a, 3)
            self.opt.step(master, m, v, self.grad_host[a:b], self.t, lr=lr, grad_coef=grad_coef)
            cast_to(master, self.host_c[a:b])
            self._write_h.wait()
            if writing is not None:
                self._window.release(writing)
            for buf, kind in zip((master, m, v), _KINDS):
                self._write_h.async_pwrite(buf, self._path(i, kind))
            if not self.pipeline_write:
                self._write_h.wait()
            writing = slot
        self._write_h.wait()
        if writing is not None:
            self._window.release(writing)
        t2 = time.perf_counter()
        self._push_done = self._io.copy(self._io.h2d, self.dev_c, self.host_c)
        self._io.consume(self._push_done)
        self.last_times = {"fetch_s": t1 - t0, "adam_s": t2 - t1,
                           "push_s": time.perf_counter() - t2}
        return self.last_times

    # -- checkpoint --------------------------------------------------------
    def state_tensors(self):
        master, mu, nu = {}, [], []
        for i, (k, s) in enumerate(zip(self.names, self.shapes)):
            p, m, v = self._read_block(i)
            master[k] = p.view(s)
            mu.append(m.view(s))
            nu.append(v.view(s))
        return master, mu, nu

    def load_state(self, master, mu=None, nu=None, count=0):
        for i, (k, (a, b)) in enumerate(zip(self.names, self.blocks)):
            for kind, src in (("master", master[k]), ("m", None if mu is None else mu[k]),
                              ("v", None if nu is None else nu[k])):
                buf = aligned_empty(b - a)
                if src is None:
                    buf.zero_()
                else:
                    buf.copy_(src.reshape(-1))
                self._write_h.async_pwrite(buf, self._path(i, kind))
            self._write_h.wait()
        self.t = int(count)
        self.refresh_compute()
