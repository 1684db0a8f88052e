"""ZeRO-Infinity parameter offload: the parameters live on the host (or
NVMe) and stream through the step one layer block at a time.

Port of ``deepspeed_tpu/runtime/zero/param_offload.py`` (reference
``runtime/swap_tensor/partitioned_param_swapper.py:36``, ``stage3.py:463``,
ZeRO-Inference) on one process. The model exposes block functions
(``stream_embed`` / ``stream_layer`` / ``stream_tail_loss`` /
``stream_logits``, ``models/transformer.py``) and this runner drives them:

  forward   embed -> [put(l + k) in flight | layer l] x L -> tail loss
  backward  tail grads -> [layer l: its forward again, then its backward;
            grads -> host] x L -> embed grads
  update    native C AdamW (``ops/csrc/cpu_adam.c``) over each block's host
            fp32 master and moments; its bf16 compute copy rewritten in place

The backward recomputes each block's forward inside its backward (the
JAX runner's ``jax.vjp`` per block): a micro step launches the flash
forward 2 L times and dq and dk/dv L times each. HBM holds the embed block,
the blocks in flight and one (B, T, H) activation a layer, whatever the
parameter count.

With ``gas`` = 1 a layer block's AdamW runs the moment its gradient lands
(host memory never holds a whole model's gradients), clipping by the
previous step's global norm (the JAX runner's trade; step 1 applies
unclipped) and skipping a non-finite block alone. With ``gas`` > 1 the
gradients accumulate in fp32 host staging buffers and the step applies
after the last micro-batch, with the exact norm and an atomic skip.
Norms and tied-embedding sums add in a fixed order, so the result is
bitwise the same whatever the threads' timing, the prefetch depth or the
fetch window, and on either tier.

Across ranks (data parallelism over expert x data) every rank holds the
whole host store and trains on its rows: the loss divides by the global
valid-token count, each block's gradient is summed over expert x data (a
split expert axis's experts over ``data``) in fp32 before it ships, so
every rank steps the same gradients and the stores stay equal (the JAX
engine's rule; rank 0 alone writes a checkpoint).

Stores: :class:`HostParamStore` (``cpu``: master, moments and the pinned
compute copy of every block in host memory) and :class:`NVMeParamStore`
(``nvme``: master and moments in flat per-block files, read ``k`` blocks
ahead through an :class:`~..swap_tensor.read_window.AioReadWindow`). The
transfers ride :class:`~deepspeed_tpu_torch.memory.streams.LayerStreamExecutor`
(``zero_optimization.offload_optimizer.prefetch_depth`` / ``fetch_window``).
On the card the blocks are initialized there from a seeded generator and
copied to the host: no model is generated on the CPU.
"""

import os
import threading
import time

import numpy as np
import torch

from ... import comm as dist
from ...memory.streams import LayerStreamExecutor
from ...ops.aio import AsyncIOHandle, aligned_empty
from ...utils.logging import log_dist, logger
from .offload import build_host_adam, cast_to, host_buffer

_KINDS = ("master", "m", "v")


class HostParamStore:
    """``cpu`` tier: each block's fp32 master, moments and compute copy
    (pinned on the card) as flat host tensors, with per-key views."""

    def __init__(self, opt, compute_dtype, pin):
        self.opt = opt
        self.compute_dtype = compute_dtype
        self.pin = pin
        self.blocks = {}  # name -> {"keys", "shapes", "ranges", "n", kinds..., "c"}
        self.t = 0
        self.adam_s = 0.0
        self._lock = threading.Lock()

    def _layout(self, name, tensors):
        keys, shapes, ranges, off = list(tensors), [], [], 0
        for t in tensors.values():
            shapes.append(tuple(t.shape))
            ranges.append((off, off + t.numel()))
            off += t.numel()
        b = {"keys": keys, "shapes": shapes, "ranges": ranges, "n": off,
             "c": host_buffer(off, self.compute_dtype, self.pin)}
        self.blocks[name] = b
        return b

    @staticmethod
    def _flat(b, tensors):
        out = torch.empty(b["n"], dtype=torch.float32)
        for (a, e), t in zip(b["ranges"], tensors.values()):
            out[a:e].copy_(t.detach().reshape(-1))
        return out

    def add_block(self, name, tensors):
        """Block ``name`` from {key: fp32 tensor} (any device)."""
        b = self._layout(name, tensors)
        b["master"] = self._flat(b, tensors)
        b["m"] = torch.zeros(b["n"], dtype=torch.float32)
        b["v"] = torch.zeros(b["n"], dtype=torch.float32)
        cast_to(b["master"], b["c"])

    def compute(self, name):
        """{key: view of the host compute copy}."""
        b = self.blocks[name]
        return {k: b["c"][a:e].view(s) for k, (a, e), s in zip(b["keys"], b["ranges"], b["shapes"])}

    def num_params(self):
        return sum(b["n"] for b in self.blocks.values())

    def host_bytes(self):
        return sum(b["n"] * (12 + b["c"].element_size()) for b in self.blocks.values())

    def schedule_state_prefetch(self, names):
        """State look-ahead: host state is in memory already."""

    def begin_step(self):
        self.t += 1

    def _step(self, master, m, v, b, grads, grad_coef, lr):
        """The C AdamW over one block: ``grads`` a flat tensor of the block
        or a list aligned with its keys."""
        t0 = time.perf_counter()
        if isinstance(grads, torch.Tensor):
            self.opt.step(master, m, v, grads, self.t, lr=lr, grad_coef=grad_coef)
        else:
            for (a, e), g in zip(b["ranges"], grads):
                self.opt.step(master[a:e], m[a:e], v[a:e], g.reshape(-1), self.t, lr=lr,
                              grad_coef=grad_coef)
        cast_to(master, b["c"])
        with self._lock:
            self.adam_s += time.perf_counter() - t0

    def apply_block(self, name, grads, grad_coef, lr):
        b = self.blocks[name]
        self._step(b["master"], b["m"], b["v"], b, grads, grad_coef, lr)

    def flush(self):
        pass

    def state(self, name):
        """(master, m, v) flat fp32 copies of block ``name``."""
        b = self.blocks[name]
        return tuple(b[k].clone() for k in _KINDS)

    def set_state(self, name, master, m=None, v=None):
        b = self.blocks[name]
        b["master"].copy_(master)
        for k, x in (("m", m), ("v", v)):
            b[k].zero_() if x is None else b[k].copy_(x)
        cast_to(b["master"], b["c"])


class NVMeParamStore(HostParamStore):
    """``nvme`` tier: master and moments in flat per-block files; host
    memory holds the compute copies and a rotating (read | step | write)
    window of block buffers."""

    def __init__(self, opt, compute_dtype, pin, nvme_path, aio_config=None, state_window=2):
        super().__init__(opt, compute_dtype, pin)
        from ..swap_tensor.aio_config import get_aio_config
        from ..swap_tensor.read_window import AioReadWindow
        aio = aio_config if aio_config is not None else get_aio_config({})
        kw = dict(block_size=aio["block_size"], queue_depth=aio["queue_depth"],
                  single_submit=aio["single_submit"], overlap_events=aio["overlap_events"],
                  thread_count=max(1, aio["thread_count"]))
        self._read_h = AsyncIOHandle(**kw)
        self._write_h = AsyncIOHandle(**kw)
        self.swap_dir = os.path.join(nvme_path, f"zero_param_swap_rank{dist.get_rank():05d}")
        os.makedirs(self.swap_dir, exist_ok=True)
        self._window = AioReadWindow(max(2, int(state_window)), kw)
        self._prefetched = {}   # name -> slot with (master, m, v) in flight
        self._writing_slot = None
        self._applied = set()   # blocks applied this step (their write may be in flight)
        # applies arrive from pool threads; the handles and the window are
        # single-consumer (re-entrant: prefetch_state runs under apply_block)
        self._apply_lock = threading.RLock()

    def _file(self, name, kind):
        return os.path.join(self.swap_dir, f"{name}.{kind}")

    def _write_state(self, name, master, m=None, v=None):
        n = self.blocks[name]["n"]
        for kind, x in zip(_KINDS, (master, m, v)):
            buf = aligned_empty(n)
            buf.zero_() if x is None else buf.copy_(x)
            self._write_h.async_pwrite(buf, self._file(name, kind))
        self._write_h.wait()

    def add_block(self, name, tensors):
        b = self._layout(name, tensors)
        master = self._flat(b, tensors)
        self._write_state(name, master)
        cast_to(master, b["c"])

    def host_bytes(self):
        return sum(b["n"] * b["c"].element_size() for b in self.blocks.values())

    def io_stats(self):
        out = self._window.io_stats()
        for h in (self._read_h, self._write_h):
            for k, v in h.io_stats().items():
                out[k] += v
        out["bytes_read"] = self._read_h.bytes_read + sum(s.handle.bytes_read for s in self._window._slots)
        out["bytes_written"] = self._write_h.bytes_written
        return out

    def begin_step(self):
        super().begin_step()
        with self._apply_lock:
            self._applied.clear()

    def _issue_reads(self, slot, name):
        for buf, kind in zip(slot.buffers(self.blocks[name]["n"], 3), _KINDS):
            slot.handle.async_pread(buf, self._file(name, kind))

    def prefetch_state(self, name):
        """Issue reads of block ``name``'s state into a free window slot
        (no-op when in flight, applied this step, or the window is full)."""
        with self._apply_lock:
            if name in self._prefetched or name in self._applied:
                return
            slot = self._window.acquire()
            if slot is not None:
                self._issue_reads(slot, name)
                self._prefetched[name] = slot

    def schedule_state_prefetch(self, names):
        for name in names:
            if name in self.blocks:
                self.prefetch_state(name)

    def apply_block(self, name, grads, grad_coef, lr):
        b = self.blocks[name]
        with self._apply_lock:
            slot = self._prefetched.pop(name, None)
            if slot is None:
                slot = self._window.acquire()
                if slot is not None:
                    self._issue_reads(slot, name)
            if slot is not None:
                slot.handle.wait()
                master, m, v = slot.buffers(b["n"], 3)
            else:  # the window is busy: one-off buffers through the shared handle
                master, m, v = (aligned_empty(b["n"]) for _ in _KINDS)
                for buf, kind in zip((master, m, v), _KINDS):
                    self._read_h.async_pread(buf, self._file(name, kind))
                self._read_h.wait()
            self._applied.add(name)
            self._step(master, m, v, b, grads, grad_coef, lr)
            # the write-back overlaps the next block's read and step; its slot
            # rejoins the window once the next wait proves the write done
            self._write_h.wait()
            if self._writing_slot is not None:
                self._window.release(self._writing_slot)
            self._writing_slot = slot
            for buf, kind in zip((master, m, v), _KINDS):
                self._write_h.async_pwrite(buf, self._file(name, kind))

    def flush(self):
        with self._apply_lock:
            self._write_h.wait()
            if self._writing_slot is not None:
                self._window.release(self._writing_slot)
                self._writing_slot = None
            for slot in self._prefetched.values():  # stale look-aheads
                slot.handle.wait()
                self._window.release(slot)
            self._prefetched.clear()

    def state(self, name):
        self.flush()
        out = tuple(aligned_empty(self.blocks[name]["n"]) for _ in _KINDS)
        for buf, kind in zip(out, _KINDS):
            self._read_h.async_pread(buf, self._file(name, kind))
        self._read_h.wait()
        return out

    def set_state(self, name, master, m=None, v=None):
        self.flush()
        self._write_state(name, master, m, v)
        cast_to(master.contiguous(), self.blocks[name]["c"])


class ParamStreamRunner:
    """The host param store and the layer-streamed train / eval / generate
    loops (the engine builds it for ``offload_param`` cpu or nvme)."""

    def __init__(self, model, config, device, compute_dtype, lr_schedule_fn, seed=0, params=None):
        cfg = config
        self.model = model
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.lr_schedule_fn = lr_schedule_fn
        self.gas = cfg.gradient_accumulation_steps
        self.clip = cfg.gradient_clipping
        # fp16 loss-scaled streaming: a host-side dynamic scaler (halve on
        # overflow, double after a clean window), the JAX runner's
        self._fp16 = compute_dtype == torch.float16
        if self._fp16 and cfg.fp16.loss_scale:
            self._scale, self._scale_dynamic = float(cfg.fp16.loss_scale), False
        elif self._fp16:
            self._scale, self._scale_dynamic = float(2.0**cfg.fp16.initial_scale_power), True
            self._scale_window = int(cfg.fp16.loss_scale_window)
            self._min_scale = float(cfg.fp16.min_loss_scale)
            self._good_steps = 0
        else:
            self._scale, self._scale_dynamic = 1.0, False

        self.plan = model.stream_plan()
        # MoE: expert leaves ride each layer block; the gating aux loss
        # enters through each layer's backward (the JAX runner's rule)
        cfg_m = getattr(model, "cfg", None)
        self._moe = getattr(cfg_m, "num_experts", 0) > 0
        self._aux_coef = float(getattr(cfg_m, "moe_aux_loss_coef", 0.0)) if self._moe else 0.0
        self.L = self.plan["num_layers"]
        self._layer_names = [f"layer{i:05d}" for i in range(self.L)]
        self._shapes = model.param_shapes()
        tail_own = [k for k in self.plan["tail"] if k not in self.plan["embed"]]
        self._block_keys = {"embed": list(self.plan["embed"]), "tail": tail_own}
        for i, name in enumerate(self._layer_names):
            self._block_keys[name] = [f"layers.{i}.{k}" for k in self.plan["layer"]]
        self._tied = [k for k in self.plan["tail"] if k in self.plan["embed"]]

        zc = cfg.zero_optimization
        self.prefetch_depth = max(0, int(zc.offload_optimizer.prefetch_depth))
        self.fetch_window = max(1, int(zc.offload_optimizer.fetch_window))
        opt = build_host_adam(cfg.optimizer, "offload_param")
        pin = self.device.type == "cuda"
        if zc.offload_param.device == "nvme":
            if not zc.offload_param.nvme_path:
                raise ValueError("offload_param.device='nvme' requires nvme_path")
            from ..swap_tensor.aio_config import get_aio_config
            self.store = NVMeParamStore(opt, compute_dtype, pin, zc.offload_param.nvme_path,
                                        get_aio_config(cfg.raw_config),
                                        state_window=min(4, self.prefetch_depth + 1))
        else:
            self.store = HostParamStore(opt, compute_dtype, pin)
        if params is not None:
            for name, keys in self._block_keys.items():
                self.store.add_block(name, {k: torch.as_tensor(params[k]) for k in keys})
        else:
            self._init_store(int(seed))
        self.executor = LayerStreamExecutor(self._dispatch_block, self.store, self.prefetch_depth,
                                            self.fetch_window, self.device)
        self._landing = {}  # (numel, dtype) -> free pinned landing buffers
        self._landing_lock = threading.Lock()
        self.global_steps = 0
        self._last_gnorm = None
        self.last_phase_times = None
        self._dp = dist.get_world_size(dist.DP_AXES)
        split = getattr(cfg_m, "moe_local_experts", None)
        self._expert_key = model.expert_pattern() if split else None
        tier = "NVMe" if zc.offload_param.device == "nvme" else "host memory"
        log_dist(f"ZeRO-Infinity param offload: {self.store.num_params():,} params on {tier} "
                 f"({self.store.host_bytes() / 2**30:.2f} GiB of host memory), streamed per layer block", [0])

    # -- init ---------------------------------------------------------------
    def _init_store(self, seed):
        """Each block initialized on the device from a generator seeded with
        ``seed + block index`` (ones for norm scales, zeros for biases,
        normal(0.02) otherwise), then copied to the host."""
        for i, (name, keys) in enumerate(self._block_keys.items()):
            gen = torch.Generator(self.device).manual_seed(seed + i)
            tensors = {}
            for k in keys:
                shape, leaf = self._shapes[k][0], k.rsplit(".", 1)[-1]
                if leaf == "scale":
                    tensors[k] = torch.ones(shape, device=self.device)
                elif leaf == "bias":
                    tensors[k] = torch.zeros(shape, device=self.device)
                else:
                    tensors[k] = torch.empty(shape, device=self.device).normal_(0.0, 0.02, generator=gen)
            self.store.add_block(name, tensors)
            del tensors

    # -- device feed --------------------------------------------------------
    def _dispatch_block(self, name):
        """Block ``name``'s compute copy put on the device (the tail's tied
        embedding comes from the embed block's copy)."""
        host = self.store.compute(name)
        if name == "tail":
            host.update({k: self.store.compute("embed")[k] for k in self._tied})
        return {k: t.to(self.device, non_blocking=True, copy=True) for k, t in host.items()}

    def _local(self, tree, name):
        """Per-layer keys of layer block ``name``'s device tree."""
        n = len(f"layers.{int(name[5:])}.")
        return {k[n:]: v for k, v in tree.items()}

    # -- landing buffers ----------------------------------------------------
    def _take_landing(self, n, dtype):
        with self._landing_lock:
            free = self._landing.setdefault((n, dtype), [])
            if free:
                return free.pop()
        return host_buffer(n, dtype, self.device.type == "cuda")

    def _give_landing(self, buf):
        with self._landing_lock:
            self._landing[(buf.numel(), buf.dtype)].append(buf)

    def _ship(self, grads):
        """Enqueue the device -> host copy of ``grads`` (a key -> tensor
        dict) into one pinned landing buffer, with the block's fp64 sum of
        squares. Returns (buffer, {key: view}, event, sum-of-squares host
        tensor)."""
        n = sum(g.numel() for g in grads.values())
        buf = self._take_landing(n, self.compute_dtype)
        views, off = {}, 0
        for k, g in grads.items():
            views[k] = buf[off:off + g.numel()].view(g.shape)
            off += g.numel()
        sq_dev = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float64)
                              for g in grads.values()]).square().sum()
        sq = torch.empty((), dtype=torch.float64, pin_memory=self.device.type == "cuda")
        ev = self.executor.d2h([(views[k], g) for k, g in grads.items()] + [(sq, sq_dev)])
        return buf, views, ev, sq

    def _reduce_block(self, grads):
        """Across ranks: a block's gradients summed over their group in fp32,
        back at their dtype (one flat buffer a group)."""
        if self._dp == 1:
            return grads
        out = dict(grads)
        for grp in (dist.DP_AXES, dist.DATA_AXIS):
            ks = [k for k in grads if (self._expert_key is not None and self._expert_key in k) ==
                  (grp == dist.DATA_AXIS)]
            if not ks or dist.get_world_size(grp) == 1:
                continue
            parts = [grads[k].float() for k in ks]
            flat = dist.all_reduce(torch._utils._flatten_dense_tensors(parts), group=grp)
            for k, r in zip(ks, torch._utils._unflatten_dense_tensors(flat, parts)):
                out[k] = r.to(grads[k].dtype)
        return out

    # -- hot loop -----------------------------------------------------------
    def _micro_grads(self, ids, mask, labels, valid, shift, sink, scale):
        """One micro-batch, streamed forward then backward; each block's
        gradients go to ``sink(name, {key: device tensor})`` as soon as
        they exist (their fetch overlaps the next block's compute). The
        backward walk streams the layers again in reverse order."""
        ex, model, cd = self.executor, self.model, self.compute_dtype
        names = self._layer_names
        fwd = ["embed"] + names + ["tail"]
        bwd = names[::-1]
        n_valid, share = None, 1.0
        if self._dp > 1:
            n_valid = torch.clamp(dist.all_reduce(valid.sum(), group=dist.DP_AXES), min=1)
            share = 1.0 / self._dp
        ep = ex.take("embed", ahead=fwd[1:])
        acts = []
        aux_total = 0.0
        with torch.no_grad():
            h = model.stream_embed(ep, ids).to(cd)
            for i, name in enumerate(names):
                lp = ex.take(name, ahead=fwd[i + 2:])
                acts.append(h)
                if self._moe:
                    h, aux = model.stream_layer(self._local(lp, name), h, mask, return_aux=True)
                    aux_total = aux_total + aux.float()
                else:
                    h = model.stream_layer(self._local(lp, name), h, mask)
                h = h.to(cd)
                del lp
        tp = ex.take("tail", ahead=bwd)
        with torch.enable_grad():
            tp = {k: v.requires_grad_(True) for k, v in tp.items()}
            h = h.requires_grad_(True)
            loss = model.stream_tail_loss(tp, h, labels, valid, shift=shift, n_valid=n_valid)
            g = torch.autograd.grad(loss.float() * scale, [*tp.values(), h])
        if self._moe:  # CE + coef * sum(aux), as the on-device engine reports it
            loss = loss + self._aux_coef * aux_total * share
        dh = g[-1]
        sink("tail", self._reduce_block(dict(zip(tp, g[:-1]))))
        del tp, h, g
        for i, name in enumerate(bwd):
            lp = self._local(ex.take(name, ahead=bwd[i + 1:]), name)
            with torch.enable_grad():
                lp = {k: v.requires_grad_(True) for k, v in lp.items()}
                x = acts.pop().requires_grad_(True)
                if self._moe:
                    # the layer's aux loss enters with its coefficient and the
                    # loss scale, so the gate's and experts' gradients carry
                    # the load balancing
                    y, aux = model.stream_layer(lp, x, mask, return_aux=True)
                    g = torch.autograd.grad([y.to(cd), aux.float()], [*lp.values(), x],
                                            grad_outputs=[dh, torch.tensor(self._aux_coef * scale * share,
                                                                           device=aux.device)])
                else:
                    y = model.stream_layer(lp, x, mask).to(cd)
                    g = torch.autograd.grad(y, [*lp.values(), x], grad_outputs=dh)
            dh = g[-1]
            pre = f"layers.{int(name[5:])}."
            sink(name, self._reduce_block({pre + k: gk for k, gk in zip(lp, g[:-1])}))
            del lp, x, y, g
        with torch.enable_grad():
            ep = {k: v.requires_grad_(True) for k, v in ep.items()}
            x = model.stream_embed(ep, ids).to(cd)
            g = torch.autograd.grad(x, list(ep.values()), grad_outputs=dh, allow_unused=True)
        sink("embed", self._reduce_block({k: torch.zeros_like(v) if gk is None else gk
                                          for (k, v), gk in zip(ep.items(), g)}))
        return loss.detach()

    def _batch(self, batch, lead):
        """(ids, mask, labels, valid, shift) on the device, each reshaped to
        ``lead + (T,)``."""
        dev = self.device
        ids = torch.as_tensor(np.asarray(batch["input_ids"])).long().to(dev)
        ids = ids.reshape(lead + (ids.shape[-1], ))
        mask = batch.get("attention_mask")
        if mask is not None:
            mask = torch.as_tensor(np.asarray(mask)).to(dev).bool().reshape(ids.shape)
        if "labels" in batch:
            labels = torch.as_tensor(np.asarray(batch["labels"])).long().to(dev).reshape(ids.shape)
            shift = False
        else:
            labels, shift = ids[..., 1:], True
        return ids, mask, torch.clamp(labels, min=0), labels >= 0, shift

    def train_batch(self, batch):
        ids, mask, labels, valid, shift = self._batch(batch, (self.gas, -1))
        ex, store = self.executor, self.store
        # staged gradients by (block, key, source): the tied embedding gets
        # one from the embed block and one from the tail
        grads = {}
        acc_lock = threading.Lock()
        stream_apply = self.gas == 1
        lr = float(self.lr_schedule_fn(self.global_steps))
        scale = self._scale
        stream_coef = 1.0 / scale
        if stream_apply and self.clip and self.clip > 0:
            prev = self._last_gnorm
            if prev is not None and np.isfinite(prev) and prev > 0:
                stream_coef = min(1.0, float(self.clip) / (prev + 1e-6)) / scale
        sq_by_block = {}   # summed in sorted order: independent of arrival order
        skipped = []
        if stream_apply:
            store.begin_step()
        apply_order = self._layer_names[::-1] + ["embed", "tail"]
        apply_pos = {n: i for i, n in enumerate(apply_order)}
        acc_dtype = self.compute_dtype if self.gas == 1 else torch.float32

        def accumulate(name, key, host, src):
            with acc_lock:
                dt = torch.float32 if (name == "embed" and self._tied) else acc_dtype
                slot = grads.setdefault(name, {}).setdefault(key, {})
                slot[src] = ex.stage_grad((name, src), key, host, dt)

        def sink(name, dev_grads):
            nxt = 0 if name == "tail" else apply_pos.get(name, len(apply_order) - 1) + 1
            look_ahead = apply_order[nxt:] if stream_apply else ()
            buf, views, ev, sq = self._ship(dev_grads)
            del dev_grads

            def fetch():
                try:
                    if look_ahead:
                        ex.schedule_state_prefetch(look_ahead)
                    ex.timed_fetch(ev)
                    if stream_apply and name.startswith("layer"):
                        s = float(sq)
                        with acc_lock:
                            sq_by_block[name] = s
                        if not np.isfinite(s):
                            skipped.append(name)
                            return
                        ex.wait_put(name)
                        store.apply_block(name, buf, stream_coef, lr)
                        return
                    for key, host in views.items():
                        if name == "tail" and key in self._tied:
                            accumulate("embed", key, host, "tail")
                        else:
                            accumulate(name, key, host, name)
                finally:
                    self._give_landing(buf)
            ex.submit_fetch(fetch)

        t0 = time.perf_counter()
        adam0 = store.adam_s
        ex.begin_step()
        loss_sum = 0.0
        for i in range(self.gas):
            loss = self._micro_grads(ids[i], None if mask is None else mask[i], labels[i], valid[i], shift,
                                     sink, scale)
            if self._dp > 1:  # this rank's share of the global loss
                loss = dist.all_reduce(loss.float(), group=dist.DP_AXES)
            loss_sum += float(loss)
            ex.drain_fetches()  # same-slot accumulations must not race the next micro-batch
        t_loop = time.perf_counter()
        final = self._finalize(grads)
        st = ex.collect_stats()
        realized = st["put_realized_s"] + st["fetch_realized_s"]
        exposed = st["put_wait_s"] + st["fetch_wait_s"]

        sq_final = {name: {key: float(torch.linalg.vector_norm(g, dtype=torch.float64)) ** 2
                           for key, g in slots.items()} for name, slots in final.items()}
        sq_sum = sum(sq_by_block[k] for k in sorted(sq_by_block))
        for name in sorted(sq_final):
            for key in sorted(sq_final[name]):
                sq_sum += sq_final[name][key]
        gnorm_raw = float(np.sqrt(sq_sum)) if np.isfinite(sq_sum) else float("inf")
        overflow = not np.isfinite(gnorm_raw)
        gnorm = gnorm_raw / self.gas / scale
        if stream_apply:
            for name in ("embed", "tail"):
                if name not in final:
                    continue
                if all(np.isfinite(sq) for sq in sq_final[name].values()):
                    ex.wait_put(name)
                    store.apply_block(name, [final[name][k] for k in self._block_keys[name]], stream_coef, lr)
                else:
                    skipped.append(name)
            store.flush()
            if skipped:
                logger.warning(f"param offload: skipped non-finite grad blocks {sorted(skipped)[:4]}")
            self.global_steps += 1
            self._last_gnorm = gnorm
            self._update_scaler(bool(skipped))
            metrics = {"loss": loss_sum / self.gas, "grad_norm": gnorm, "lr": lr, "overflow": bool(skipped),
                       "loss_scale": scale, "clip_coef": stream_coef * scale}
        else:
            clip_coef = 1.0
            if not overflow:
                coef = 1.0 / self.gas / scale
                if self.clip and self.clip > 0:
                    clip_coef = min(1.0, self.clip / (gnorm + 1e-6))
                    coef *= clip_coef
                store.begin_step()
                for name in self._block_keys:
                    ex.wait_put(name)
                    store.apply_block(name, [final[name][k] for k in self._block_keys[name]], coef, lr)
                store.flush()
                self.global_steps += 1
            self._last_gnorm = gnorm
            self._update_scaler(overflow)
            metrics = {"loss": loss_sum / self.gas, "grad_norm": gnorm, "lr": lr, "overflow": overflow,
                       "loss_scale": scale, "clip_coef": clip_coef}
        t_end = time.perf_counter()
        self.last_phase_times = {
            "step_s": t_end - t0, "loop_s": t_loop - t0, "apply_tail_s": t_end - t_loop,
            "adam_s": store.adam_s - adam0,
            "drain_s": st["fetch_wait_s"], "put_s": st["put_wait_s"],
            "put_dispatch_s": st["put_dispatch_s"], "put_realized_s": st["put_realized_s"],
            "fetch_realized_s": st["fetch_realized_s"],
            "overlap_efficiency": max(0.0, min(1.0, 1.0 - exposed / realized)) if realized > 0 else 0.0,
        }
        return metrics

    def _finalize(self, grads):
        """{block: {key: gradient}}: each multi-source slot (the tied
        embedding) summed in sorted-source order, in fp32."""
        ex, out = self.executor, {}
        for name, slots in grads.items():
            out[name] = {}
            for key, slot in slots.items():
                srcs = sorted(slot)
                if len(srcs) == 1:
                    out[name][key] = slot[srcs[0]]
                    continue
                acc = ex.stage_grad((name, "__combined__"), key, slot[srcs[0]], torch.float32)
                for s in srcs[1:]:
                    acc.add_(slot[s].float())
                out[name][key] = acc
        return out

    def _update_scaler(self, overflow):
        if not self._scale_dynamic:
            return
        if overflow:
            self._scale = max(self._scale / 2.0, self._min_scale)
            self._good_steps = 0
            logger.warning(f"param offload fp16: overflow, loss scale -> {self._scale:g}")
        else:
            self._good_steps += 1
            if self._good_steps >= self._scale_window:
                self._scale *= 2.0
                self._good_steps = 0

    @torch.no_grad()
    def eval_batch(self, batch):
        ids, mask, labels, valid, shift = self._batch(batch, (-1, ))
        ex, model, cd = self.executor, self.model, self.compute_dtype
        ex.invalidate()
        names = self._layer_names
        fwd = ["embed"] + names + ["tail"]
        h = model.stream_embed(ex.take("embed", ahead=fwd[1:]), ids).to(cd)
        aux_total = 0.0
        for i, name in enumerate(names):
            lp = self._local(ex.take(name, ahead=fwd[i + 2:]), name)
            if self._moe:
                h, aux = model.stream_layer(lp, h, mask, return_aux=True)
                aux_total += float(aux)
            else:
                h = model.stream_layer(lp, h, mask)
            h = h.to(cd)
        loss = model.stream_tail_loss(ex.take("tail"), h, labels, valid, shift=shift)
        return {"loss": float(loss) + self._aux_coef * aux_total}

    # -- ZeRO-Inference: generate from streamed weights ---------------------
    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=16):
        """Greedy decode with the weights streamed host -> device every step
        (each layer's attention through the decode kernel on the card).
        ``input_ids``: (B, T0) of one length; returns (B, T0 +
        max_new_tokens) token ids. The cache layout is the inference
        engine's (the prompt right-padded to a multiple of 64, the cache a
        multiple of 64 or of ``decode_block_kv``), so the tokens are its
        ``generate()``'s."""
        model, dev = self.model, self.device
        cfg = model.cfg
        ids = np.asarray(input_ids)
        B, T0 = ids.shape
        P = -(-T0 // 64) * 64
        S = -(-(P + max_new_tokens) // 64) * 64
        if S > cfg.decode_block_kv:
            S = -(-S // cfg.decode_block_kv) * cfg.decode_block_kv
        if S > cfg.max_seq_len:
            raise ValueError(f"prompt+max_new_tokens needs cache of {S} > model max_seq_len {cfg.max_seq_len}")
        padded = np.zeros((B, P), np.int64)
        padded[:, :T0] = ids
        cache = [(torch.zeros((B, cfg.kv_heads, S, cfg.head_size), dtype=cfg.dtype, device=dev),
                  torch.zeros((B, cfg.kv_heads, S, cfg.head_size), dtype=cfg.dtype, device=dev))
                 for _ in range(self.L)]
        ex = self.executor
        ex.invalidate()
        names = self._layer_names
        fwd = ["embed"] + names + ["tail"]

        def forward(tok, index, pos):
            h = model.stream_embed(ex.take("embed", ahead=fwd[1:]), tok, position_ids=pos, cache_index=index)
            for i, name in enumerate(names):
                h = model.stream_layer_cached(self._local(ex.take(name, ahead=fwd[i + 2:]), name), h,
                                              cache[i], index, position_ids=pos)
            return model.stream_logits(ex.take("tail"), h)

        logits = forward(torch.as_tensor(padded, device=dev), 0, None)
        tok = torch.argmax(logits[:, T0 - 1].float(), dim=-1)
        out = [tok]
        for t in range(max_new_tokens - 1):
            pos = torch.full((B, 1), T0 + t, dtype=torch.long, device=dev)
            tok = torch.argmax(forward(tok[:, None], T0 + t, pos)[:, 0].float(), dim=-1)
            out.append(tok)
        new = torch.stack(out, dim=1).cpu().numpy().astype(ids.dtype)
        return np.concatenate([ids, new], axis=1)

    # -- host param import / export and checkpoints -------------------------
    def state_tensors(self):
        """(master {key: fp32 tensor}, mu, nu) in the model's key order: the
        on-device AdamW checkpoint's layout."""
        self.store.flush()
        master, mu, nu = {}, {}, {}
        for name, keys in self._block_keys.items():
            flats = self.store.state(name)
            b = self.store.blocks[name]
            for k, (a, e), s in zip(keys, b["ranges"], b["shapes"]):
                for out, flat in zip((master, mu, nu), flats):
                    out[k] = flat[a:e].view(s).clone()
        order = list(self._shapes)
        return {k: master[k] for k in order}, [mu[k] for k in order], [nu[k] for k in order]

    def load_state(self, master, mu=None, nu=None, count=0):
        """Overwrite every block's master and moments (key -> tensor dicts;
        moments None: zeros)."""
        self.store.flush()
        for name, keys in self._block_keys.items():
            flat = lambda src: None if src is None else torch.cat(
                [torch.as_tensor(src[k]).float().reshape(-1) for k in keys])
            self.store.set_state(name, flat(master), flat(mu), flat(nu))
        self.store.t = int(count)

    def set_params_from_tree(self, params):
        """Overwrite the masters from a full state dict; moments reset."""
        self.load_state(params, None, None, self.store.t)

    def get_params_tree(self):
        """The full fp32 state dict on the host (owned copies)."""
        return self.state_tensors()[0]
