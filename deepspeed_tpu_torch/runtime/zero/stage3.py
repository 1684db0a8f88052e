"""ZeRO stage 3 on the device: the compute-dtype parameters exist whole
only a block at a time.

The JAX engine pins stage 3's compute parameters to their scattered
sharding and XLA all-gathers each just before its layer and frees it after
(``deepspeed_tpu/runtime/engine.py:640-643``). The port drives a model that
has the parameter-streaming protocol (``stream_plan``, ``stream_embed``,
``stream_layer``, ``stream_tail_loss``; ``models/transformer.py``) one block
at a time, as ``param_offload.ParamStreamRunner`` does, in one autograd
graph:

  forward   gather block b's tensors (cast the fp32 master shard to the
            compute dtype, ``all_gather`` it to the whole tensor), run the
            block, drop them; with ``overlap_comm`` block b + 1's gather is
            issued on a side stream before block b runs
  backward  every tensor the block's operations saved that is one of its
            gathered parameters (or a view of one) was packed as its key by
            a ``saved_tensors_hooks`` pair; the first unpack of a block
            gathers it again (and, with ``overlap_comm``, issues the next
            block's re-gather), the cache lives until the backward reaches
            another block. No layer is recomputed beyond the remat policy
  gradient  each gathered tensor's gradient, cast to fp32, is reduced over
            its data-parallel group and scattered to this rank's shard
            (``grad_spec``) inside the backward

Tensors of at most ``stage3_param_persistence_threshold`` elements (norm
scales) are gathered once a micro-step and kept. Every tensor is gathered
from the layout of its master shard (``master_spec``): a persistent
tensor's compute spec is whole, but its master is sharded like the rest. A tied embedding is
gathered by the embed block and again by the tail; autograd sums its two
gradients. A block whose forward saved none of its parameters (the
embedding lookup saves only indices) is not gathered in the backward: a
micro-step gathers ``L + 2`` blocks in the forward and one per block with a
saved parameter in the backward (``L + 1`` for llama: the layers and the
tail). Under a remat policy the checkpoint keeps its inputs, so the
gathered layers live until the backward (correct, without the memory
saving).

The gathers are tracked by the comm overlap tracker as ``all_gather``: on
the card each gather is bracketed by CUDA timing events on its stream, so
its realized span is device time (a host clock would count the queue of
compute ahead of it); a gather issued on the stream that uses it is
exposed whole, a prefetched one for the time the consuming stream waited
on it (a timing event recorded where it waits). The engine folds them in
after the step's synchronize (:meth:`BlockGatherer.settle`). On the CPU a
gather is synchronous and exposed whole.
"""

import math
import time
import weakref
from contextlib import nullcontext

import torch

from ...comm.overlap import get_overlap_tracker
from ...utils.counter_hash import fold_in
from .sharding import unshard


class _Gathered(torch.autograd.Function):
    """The gathered compute tensor ``box[0]`` as a function of the fp32
    master shard: the backward casts the whole tensor's gradient to the
    master's dtype and reduces it to the shard (``reduce``)."""

    @staticmethod
    def forward(ctx, shard, box, reduce):
        ctx.reduce = reduce
        ctx.dtype = shard.dtype
        return box.pop()

    @staticmethod
    def backward(ctx, g):
        return ctx.reduce(g.to(ctx.dtype)), None, None


class BlockGatherer:
    """One micro-step's gathers for :class:`Stage3Loss`: issue, consume,
    the pack/unpack registry and the backward cache, with the counts a
    step predicts (``counts``: forward and backward block gathers)."""

    def __init__(self, master, specs, compute_dtype, blocks, reduce_fn, overlap, track):
        self.master = master
        self.specs = specs  # key -> the spec of its master shard (the layout it is gathered from)
        self.cd = compute_dtype
        self.blocks = blocks  # name -> keys, in forward order
        self.order = list(blocks)
        self.reduce_fn = reduce_fn
        dev = next(iter(master.values())).device
        self.cuda = dev.type == "cuda"
        self.side = torch.cuda.Stream(dev) if (overlap and self.cuda) else None
        self.overlap = overlap
        self.track = track
        self.counts = {"forward": 0, "backward": 0}
        self.shapes = None  # key -> the compute shape a gather must give (the model's shard)
        self._timed = []  # (start event, done event, host dispatch s, wait event or None) a gather
        self.reset()

    def reset(self):
        self._live = {}        # storage ptr -> (block, key): gathered tensors alive in the forward
        self._packed = {}      # block -> keys packed at least once
        self._cache = {}       # key -> re-gathered tensor of the block in backward
        self._cache_block = None
        self._pending = {}     # (phase, block) -> (tensors, (done event, timing record), on the side stream)

    # -- gathers ------------------------------------------------------------
    def _issue(self, block, keys, side):
        """Cast and all-gather ``keys`` of ``block``; on ``side`` (a CUDA
        stream) after the current stream's work, else in place."""
        t0 = time.perf_counter()
        ctx = torch.cuda.stream(self.side) if side else nullcontext()
        if side:
            self.side.wait_stream(torch.cuda.current_stream())
        host = self.track and not self.cuda
        timed = self.track and self.cuda
        with torch.no_grad(), ctx, (get_overlap_tracker().track_host("all_gather") if host else nullcontext()):
            start = None
            if timed:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            out = {k: unshard(self.master[k].detach().to(self.cd, copy=True), self.specs[k]) for k in keys}
            if self.shapes is not None:
                # over the data axes only: a tensor-parallel shard stays a shard
                bad = [k for k, t in out.items() if tuple(t.shape) != self.shapes[k]]
                if bad:
                    raise RuntimeError(f"stage 3 gathered {bad[0]} to {tuple(out[bad[0]].shape)}, not the "
                                       f"model's {self.shapes[bad[0]]}")
            done = None
            if self.cuda:
                done = torch.cuda.Event(enable_timing=timed)
                done.record()
        if timed:
            self._timed.append([start, done, time.perf_counter() - t0, None])
        return out, (done, self._timed[-1] if timed else None), side

    def _take(self, phase, block, keys, count=True):
        """Block ``block``'s gathered tensors, ready on the current stream
        (issued now unless prefetched)."""
        got = self._pending.pop((phase, block), None)
        if got is None:
            got = self._issue(block, keys, False)
        out, (done, rec), side = got
        self.counts[phase] += count
        if side:
            cur = torch.cuda.current_stream()
            if rec is not None:
                rec[3] = torch.cuda.Event(enable_timing=True)
                rec[3].record(cur)
            cur.wait_event(done)
            for t in out.values():
                t.record_stream(cur)
        return out

    def prefetch(self, phase, block, keys):
        if self.overlap and (phase, block) not in self._pending:
            self._pending[(phase, block)] = self._issue(block, keys, self.side is not None)

    def settle(self):
        """Fold the step's timed gathers into the tracker (after a
        synchronize: every event has completed): each one's device span
        from the first gather's start, exposed whole when issued where it
        was used, else for the time its consumer waited on it."""
        timed, self._timed = self._timed, []
        if not timed:
            return
        tracker, ref = get_overlap_tracker(), timed[0][0]
        spans = []
        for start, done, dispatch, need in timed:
            t0, t1 = ref.elapsed_time(start) / 1e3, ref.elapsed_time(done) / 1e3
            exposed = t1 - t0 if need is None else need.elapsed_time(done) / 1e3
            spans.append((t0, t1, dispatch, exposed))
        for t0, t1, dispatch, exposed in sorted(spans):
            tracker.add_span("all_gather", t0, t1, dispatch_s=dispatch, exposed_s=exposed)

    # -- forward ------------------------------------------------------------
    def bind(self, block, keys, register=True):
        """{key: gathered tensor} of ``block`` as functions of the master
        shards; registered for packing (and counted as a block gather)
        unless ``register`` is False (the persistent tensors)."""
        full = self._take("forward", block, keys, count=register)
        out = {}
        for k in keys:
            t = full[k]
            if register:
                self._live[t.untyped_storage().data_ptr()] = (block, k)
            out[k] = _Gathered.apply(self.master[k], [t], self._reducer(k))
        return out

    def _reducer(self, k):
        return lambda g: self.reduce_fn()(k, g)

    def release(self, block):
        """The block's forward is done: its tensors are no longer packed."""
        self._live = {p: bk for p, bk in self._live.items() if bk[0] != block}

    # -- saved tensors --------------------------------------------------------
    def pack(self, t):
        hit = self._live.get(t.untyped_storage().data_ptr()) if self._live else None
        if hit is None:
            return t
        block, key = hit
        self._packed.setdefault(block, set()).add(key)
        return (block, key, tuple(t.shape), t.stride(), t.storage_offset())

    def unpack(self, packed):
        if isinstance(packed, torch.Tensor):
            return packed
        block, key, shape, stride, offset = packed
        if self._cache_block != block:
            self._cache = {}
            self._cache_block = block
            keys = sorted(self._packed[block], key=self.blocks[block].index)
            self._cache = self._take("backward", block, keys)
            nxt = self._next_backward(block)
            if nxt is not None:
                self.prefetch("backward", nxt, sorted(self._packed[nxt], key=self.blocks[nxt].index))
        return self._cache[key].as_strided(shape, stride, offset)

    def _next_backward(self, block):
        i = self.order.index(block)
        for name in reversed(self.order[:i]):
            if self._packed.get(name):
                return name
        return None

    def finish(self):
        """The backward is done: drop the cache and anything in flight."""
        self._cache, self._cache_block = {}, None
        self._pending.clear()
        self._live.clear()


class Stage3Loss:
    """A micro-step's loss through the stream protocol at stage 3, with the
    gradients reduced to the master shards. The engine builds it once."""

    def __init__(self, engine, model):
        # the engine holds this object: a weak reference back, so dropping
        # the engine frees its tensors at once (no reference cycle)
        self.engine = weakref.proxy(engine)
        self.model = model
        plan = model.stream_plan()
        L = plan["num_layers"]
        threshold = engine.planner.persistence_threshold
        shapes = engine._shapes_global
        self.persistent = [k for k in engine.master if math.prod(shapes[k]) <= threshold]
        keep = set(self.persistent)
        blocks = {"embed": [k for k in plan["embed"] if k not in keep]}
        for i in range(L):
            blocks[f"layer{i}"] = [f"layers.{i}.{k}" for k in plan["layer"] if f"layers.{i}.{k}" not in keep]
        blocks["tail"] = [k for k in plan["tail"] if k not in keep]
        self.blocks = blocks
        self.plan = plan
        self.moe = getattr(model.cfg, "num_experts", 0) > 0
        zero = engine._config.zero_optimization
        self.gatherer = BlockGatherer(engine.master, engine._specs["master"], engine.compute_dtype, blocks,
                                      weakref.WeakMethod(engine._reduce_grad), bool(zero.overlap_comm), False)
        self.gatherer.shapes = {k: tuple(s) for k, (s, _) in model.param_shapes().items()}

    def predicted_gathers(self):
        """(forward, backward) block gathers of one micro-step: every block
        forward; backward, each block whose forward saved a parameter."""
        g = self.gatherer
        return len(self.blocks), sum(1 for b in self.blocks if g._packed.get(b))

    def __call__(self, batch, scale, rng=None, impl="kernel", n_valid=None, aux_share=1.0):
        """(loss, fp32 gradients of ``loss * scale`` as master shards)."""
        eng, model, g = self.engine, self.model, self.gatherer
        cfg = model.cfg
        ids = batch["input_ids"]
        mask = batch.get("attention_mask")
        if "labels" in batch:
            labels, shift = batch["labels"], False
        else:
            labels, shift = ids[:, 1:], True
        valid = labels >= 0
        labels = torch.clamp(labels, min=0).long()
        key = rng if rng is not None and cfg.dropout > 0 else None
        moe_out = [] if self.moe else None
        keys = list(eng.master)
        g.reset()
        g.track = eng.telemetry.enabled
        order = list(self.blocks)
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(g.pack, g.unpack):
            persist = g.bind("persistent", self.persistent, register=False) if self.persistent else {}
            h = None
            for i, name in enumerate(order):
                if i + 1 < len(order):
                    g.prefetch("forward", order[i + 1], self.blocks[order[i + 1]])
                tensors = g.bind(name, self.blocks[name])
                if name == "embed":
                    tree = {**tensors, **{k: persist[k] for k in self.plan["embed"] if k in persist}}
                    h = model.stream_embed(tree, ids)
                elif name == "tail":
                    tree = {**tensors, **{k: persist[k] for k in self.plan["tail"] if k in persist}}
                    loss = model.stream_tail_loss(tree, h, labels, valid, shift=shift, n_valid=n_valid)
                else:
                    li = int(name[5:])
                    pre = f"layers.{li}."
                    tree = {k[len(pre):]: v for k, v in {**tensors, **persist}.items() if k.startswith(pre)}
                    lkey = None if key is None else fold_in(key, li)
                    h = model.stream_layer(tree, h, mask, impl=impl, dropout_key=lkey, remat=True,
                                           moe_out=moe_out)
                del tensors, tree
                g.release(name)
            if moe_out:
                aux = sum(a for a, _ in moe_out)
                loss = loss + cfg.moe_aux_loss_coef * aux * aux_share
                model.last_moe = {"aux_loss": aux.detach(),
                                  "drop_frac": torch.stack([d for _, d in moe_out]).detach()}
            del persist
        try:
            grads = torch.autograd.grad(loss.float() * scale, [eng.master[k] for k in keys], allow_unused=True)
        finally:
            g.finish()
        grads = [torch.zeros_like(eng.master[k]) if gk is None else gk for k, gk in zip(keys, grads)]
        return loss.detach(), grads

