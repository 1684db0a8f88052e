"""ZeRO-Offload: the fp32 master and the Adam moments in host memory,
stepped by the native CPU AdamW.

Port of ``deepspeed_tpu/runtime/zero/offload.py`` (``HostOffloadOptimizer``;
reference ``runtime/zero/stage_1_and_2.py:1031`` with
``csrc/adam/cpu_adam.cpp``) on one process: the JAX per-device shard
discovery collapses to one block per tensor, all of them views of one flat
buffer per kind (master, m, v). The device keeps only the compute-dtype
parameters, one flat buffer whose views are the model's leaves, and one
flat gradient buffer of the same dtype. One step, after the device's
forward and backward:

    fetch  the flat gradient device -> pinned host, in chunks of ``CHUNK``
           elements on a copy stream (chunk i+1 in flight while the host
           steps chunk i)
    step   the C AdamW over the chunk's master and moments (the gradient
           coefficient folds unscaling, averaging and clipping)
    push   the chunk's master cast to bf16 on the host (``f32_to_bf16``,
           torch's rounding) into a pinned compute copy, copied back to the
           device on another copy stream

The next step's forward waits on the last push's event; the host waits on
it before it rewrites the pinned compute copy (a ``non_blocking`` copy
reads its source after the call returns). HBM holds 2 bytes a parameter of
weights and 2 of gradients instead of 16; the host 12 bytes of state and 4
of pinned compute copy and gradient landing buffer.

Pinned buffers are registered with ``cudaHostRegister`` (:func:`host_buffer`):
PyTorch's pinned allocator rounds each allocation up to a power of two.
"""

import time
import weakref

import torch

from ...ops.adam.cpu_adam import DeepSpeedCPUAdam, f32_to_bf16
from ...ops.aio import aligned_empty
from ...utils.logging import log_dist, logger
from ..constants import ADAM_OPTIMIZER, ADAMW_OPTIMIZER, CPU_ADAM_OPTIMIZER, FUSED_ADAM_OPTIMIZER

# elements a pipelined fetch/step/push chunk (128 MB of fp32)
CHUNK = 1 << 25

_HOST_ADAM_TYPES = (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, CPU_ADAM_OPTIMIZER, FUSED_ADAM_OPTIMIZER)

# bytes registered with cudaHostRegister, and by the pinned allocator
PINNED = {"registered": 0, "allocator": 0}


def _unregister(ptr, nbytes):
    torch.cuda.cudart().cudaHostUnregister(ptr)
    PINNED["registered"] -= nbytes


def host_buffer(n, dtype, pin):
    """A flat CPU tensor of ``n`` elements, 4096-aligned; with ``pin`` its
    pages are registered with ``cudaHostRegister`` (exact size, unlike the
    pinned allocator's power-of-two rounding), unregistered when the tensor
    is collected. Where registration fails the pinned allocator is used."""
    t = aligned_empty(n, dtype)
    if not pin or n == 0:
        return t
    nbytes = t.numel() * t.element_size()
    rc = torch.cuda.cudart().cudaHostRegister(t.data_ptr(), nbytes, 0)
    if int(rc) != 0:
        logger.warning(f"cudaHostRegister of {nbytes} bytes failed ({rc}); using the pinned allocator")
        PINNED["allocator"] += nbytes
        return torch.empty(n, dtype=dtype, pin_memory=True)
    PINNED["registered"] += nbytes
    weakref.finalize(t, _unregister, t.data_ptr(), nbytes)
    return t


def build_host_adam(opt_config, what):
    """The C AdamW of the ``optimizer`` section (Adam / AdamW; Adam with
    ``adam_w_mode: false`` folds the decay into the gradient, as the JAX
    offload tier does); other optimizers raise."""
    name = (opt_config.type or ADAMW_OPTIMIZER).lower()
    if name not in _HOST_ADAM_TYPES:
        raise ValueError(f"{opt_config.type} does not compose with {what} (the host step is the "
                         f"native C AdamW)")
    p = dict(opt_config.params)
    return DeepSpeedCPUAdam(lr=p.get("lr", 1e-3), betas=tuple(p.get("betas", (0.9, 0.999))),
                            eps=p.get("eps", 1e-8), weight_decay=p.get("weight_decay", 0.0),
                            adamw_mode=True if name == ADAMW_OPTIMIZER else p.get("adam_w_mode", True))


def cast_to(src, out):
    """fp32 host ``src`` into the compute-dtype host tensor ``out`` (bf16
    through the C cast, else torch's)."""
    if out.dtype == torch.bfloat16:
        f32_to_bf16(src, out)
    else:
        out.copy_(src)


class _Copies:
    """Two copy streams (device -> host, host -> device) and their events;
    on the CPU plain copies."""

    def __init__(self, device):
        self.device = device
        cuda = device.type == "cuda"
        self.d2h = torch.cuda.Stream(device) if cuda else None
        self.h2d = torch.cuda.Stream(device) if cuda else None

    def copy(self, stream, dst, src):
        """``dst.copy_(src)`` on ``stream`` after the current stream's work;
        returns the event marking its end (None on the CPU)."""
        if stream is None:
            dst.copy_(src)
            return None
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            dst.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        return ev

    def consume(self, ev):
        """Make the current stream wait for ``ev``."""
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)


def _sync(ev):
    if ev is not None:
        ev.synchronize()


class HostOffloadOptimizer:
    """fp32 master and Adam moments on the host, one block per tensor;
    the device's compute-dtype weights and gradients as flat buffers."""

    def __init__(self, optimizer_config, device, compute_dtype):
        self.opt = build_host_adam(optimizer_config, "offload_optimizer")
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.pin = self.device.type == "cuda"
        self._io = _Copies(self.device)
        self._push_done = None
        self.t = 0  # applied updates
        self.last_times = None

    # -- layout ----------------------------------------------------------
    def _record_layout(self, named):
        self.names = list(named)
        self.shapes = [tuple(t.shape) for t in named.values()]
        self.blocks, off = [], 0  # one block per tensor: (start, stop) of the flat
        for t in named.values():
            self.blocks.append((off, off + t.numel()))
            off += t.numel()
        self.n = off
        self.chunks = [(a, min(a + CHUNK, self.n)) for a in range(0, self.n, CHUNK)]

    def num_params(self):
        return self.n

    def views(self, flat):
        """{name: view of ``flat``} in the model's shapes."""
        return {k: flat[a:b].view(s) for k, (a, b), s in zip(self.names, self.blocks, self.shapes)}

    def init(self, named_params):
        """Take the fp32 master from ``named_params`` (name -> tensor, any
        device) and return the device compute-dtype leaves (views of one
        flat buffer, each a leaf that requires grad)."""
        self._record_layout(named_params)
        self._alloc_state(named_params)
        self.host_c = host_buffer(self.n, self.compute_dtype, self.pin)
        self.grad_host = host_buffer(self.n, self.compute_dtype, self.pin)
        self.dev_c = torch.empty(self.n, dtype=self.compute_dtype, device=self.device)
        self.dev_grad = torch.empty(self.n, dtype=self.compute_dtype, device=self.device)
        self.refresh_compute()
        leaves = self.views(self.dev_c)
        for t in leaves.values():
            t.requires_grad_(True)
        log_dist(f"ZeRO-Offload: {self.n:,} params' fp32 master and moments in host memory "
                 f"({3 * 4 * self.n / 2**30:.2f} GiB, native cpu_adam), "
                 f"{str(self.compute_dtype).split('.')[-1]} compute copy on {self.device}", [0])
        return leaves

    def _alloc_state(self, named_params):
        self.master = torch.empty(self.n, dtype=torch.float32)
        for (a, b), t in zip(self.blocks, named_params.values()):
            self.master[a:b].copy_(t.detach().reshape(-1))
        self.m = torch.zeros(self.n, dtype=torch.float32)
        self.v = torch.zeros(self.n, dtype=torch.float32)

    def host_bytes(self):
        """Host bytes this tier holds (state, compute copy, grad landing)."""
        return 12 * self.n + 2 * self.n * self.host_c.element_size()

    def refresh_compute(self):
        """Cast the master into the host compute copy and push it whole (after
        a load)."""
        _sync(self._push_done)
        for a, b in self.chunks:
            cast_to(self.master[a:b], self.host_c[a:b])
        self._push_done = self._io.copy(self._io.h2d, self.dev_c, self.host_c)
        self._io.consume(self._push_done)

    # -- hot path ----------------------------------------------------------
    def step(self, grad_coef, lr):
        """One update from ``dev_grad`` (filled by the engine): fetch, C
        AdamW, cast and push, pipelined by chunk. Returns the host times."""
        self.t += 1
        _sync(self._push_done)  # the host copy is rewritten below
        times = {"fetch_s": 0.0, "adam_s": 0.0, "push_s": 0.0}
        fetched = self._fetch()
        for (a, b), ev in zip(self.chunks, fetched):
            t0 = time.perf_counter()
            _sync(ev)
            t1 = time.perf_counter()
            self._step_range(a, b, grad_coef, lr)
            t2 = time.perf_counter()
            cast_to(self.master[a:b], self.host_c[a:b])
            self._push_done = self._io.copy(self._io.h2d, self.dev_c[a:b], self.host_c[a:b])
            t3 = time.perf_counter()
            times["fetch_s"] += t1 - t0
            times["adam_s"] += t2 - t1
            times["push_s"] += t3 - t2
        self._io.consume(self._push_done)
        self.last_times = times
        return times

    def _fetch(self):
        """Enqueue the chunks' device -> host copies; one event each."""
        return [self._io.copy(self._io.d2h, self.grad_host[a:b], self.dev_grad[a:b])
                for a, b in self.chunks]

    def _step_range(self, a, b, grad_coef, lr):
        self.opt.step(self.master[a:b], self.m[a:b], self.v[a:b], self.grad_host[a:b], self.t, lr=lr,
                      grad_coef=grad_coef)

    # -- checkpoint --------------------------------------------------------
    def state_tensors(self):
        """(master {name: fp32 tensor}, mu [tensors], nu [tensors]) in the
        model's order: the keys an on-device AdamW checkpoint holds."""
        master = {k: v.clone() for k, v in self.views(self.master).items()}
        return master, [x.clone() for x in self.views(self.m).values()], \
            [x.clone() for x in self.views(self.v).values()]

    def load_state(self, master, mu=None, nu=None, count=0):
        """Overwrite master and the moments (name -> tensor dicts; moments
        None: zeros), then push the compute copy."""
        for flat, src in ((self.master, master), (self.m, mu), (self.v, nu)):
            if src is None:
                flat.zero_()
            else:
                for k, (a, b) in zip(self.names, self.blocks):
                    flat[a:b].copy_(src[k].reshape(-1))
        self.t = int(count)
        self.refresh_compute()
