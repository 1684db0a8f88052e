"""Pipeline schedules: one instruction stream a rank.

Port of ``deepspeed_tpu/runtime/pipe/schedule.py`` (reference
``runtime/pipe/engine.py:40`` ``PipelineEngine``, ``schedule.py:189``
``TrainSchedule``, ``p2p.py``). The JAX package runs a schedule as one SPMD
scan inside ``shard_map`` and differentiates through it; here every rank is
one stage and runs its part eagerly, tick by tick, exchanging activations
and their gradients with its neighbours through ``comm.ppermute`` over the
``pipe`` group. Every member takes part in every exchange of a tick; a tick
whose exchange carries nothing valid is skipped by every member alike.

A stage is a :class:`PipeStage`: ``forward(m, x)`` runs microbatch ``m``
through it and keeps its autograd graph, ``backward(m, dy)`` consumes that
graph, accumulates the stage's gradients and returns the gradient of its
input. Two schedules drive it:

- :func:`fill_drain` (``spmd_pipeline``): every microbatch forward, stage
  ``s`` on microbatch ``t - s`` at tick ``t`` (M + S - 1 ticks), then the
  backward of each, in microbatch order (the last stage starts microbatch
  0 at backward tick 0). Every microbatch's graph is alive at the turn:
  M in flight on every stage.
- :func:`one_f_one_b` (``spmd_pipeline_1f1b``): M + 2 (S - 1) ticks; at tick
  ``t`` stage ``s`` runs the forward of microbatch ``t - s`` and then the
  backward of microbatch ``t - 2 (S - 1) + s``. The loss head runs on the
  last stage the moment a microbatch's forward ends, so its backward
  starts in the same tick. A stage keeps the graph of each microbatch in
  flight instead of JAX's ring of stored inputs and its recompute: at most
  ``min(M, 2 (S - 1 - s) + 1)`` at stage ``s``, JAX's ring bound
  (``PipeStage.max_in_flight`` records it).

Neither recomputes a forward: each microbatch runs each layer's forward and
backward once on its stage (for the model, one flash forward, dQ and dK/dV
a layer a microbatch on the stage that owns the layer; a remat policy adds
its own recompute). Both call ``backward`` in microbatch order, so a stage
accumulates its gradients in the same order under either, and a stage's
microbatch computes the same bits under either: 1F1B is bitwise
fill-drain. A group of one (``pipe`` of 1) runs the stage alone with no
exchange (JAX's ``_single_stage`` / ``_single_stage_1f1b``).

:func:`spmd_pipeline` and :func:`spmd_pipeline_1f1b` are the JAX
functions' forms over a ``stage_fn``: the first is differentiable (the
stream leaving the last stage, on every member), the second returns the
loss and the gradients. Their ``stage_fn(local_params, x, m)`` gets the
microbatch index ``m`` where JAX passes its tick.
"""

import torch

from ... import comm as dist


def num_pipeline_steps(num_microbatches, num_stages):
    return num_microbatches + num_stages - 1


class PipeStage:
    """One rank's stage. Subclasses define :meth:`run` (and, to train,
    :meth:`targets` and :meth:`accumulate`); :meth:`source` gives stage 0
    its microbatch input when the stage does not make its own."""

    def __init__(self, index, num_stages, train=True):
        self.index, self.num_stages, self.train = index, num_stages, train
        self.side = {}  # microbatch -> detached values of its side terms
        self.max_in_flight = 0
        self._held = {}

    @property
    def first(self):
        return self.index == 0

    @property
    def last(self):
        return self.index == self.num_stages - 1

    def source(self, m):
        """Stage 0's input of microbatch ``m`` (None: :meth:`run` makes it)."""
        return None

    def run(self, m, x):
        """(activation sent to the next stage or None on the last, [scalar
        side terms whose backward is seeded with ones: the loss head, an
        aux loss])."""
        raise NotImplementedError

    def targets(self):
        """The tensors whose gradients :meth:`accumulate` takes."""
        return []

    def accumulate(self, m, grads):
        """Take microbatch ``m``'s gradients of :meth:`targets` (None where
        unused)."""

    def forward(self, m, x):
        """Run microbatch ``m`` on ``x`` (the previous stage's activation;
        None on stage 0), keep its graph; returns the activation to send."""
        if x is None:
            x = self.source(m)
        if x is not None and self.train:
            x = x.detach().requires_grad_(True)
        with torch.enable_grad() if self.train else torch.no_grad():
            y, side = self.run(m, x)
        self.side[m] = [s.detach() for s in side]
        if self.train:
            self._held[m] = (x, y, side)
            self.max_in_flight = max(self.max_in_flight, len(self._held))
        return None if y is None else y.detach()

    def backward(self, m, dy, side_seeds=None):
        """Microbatch ``m``'s backward from ``dy`` (the gradient of its
        activation; None on the last stage) and its side terms (seeded with
        ones, or ``side_seeds``); returns the gradient of its input (None
        when stage 0 made its own)."""
        x, y, side = self._held.pop(m)
        outs = list(side)
        seeds = [torch.ones_like(s) for s in side] if side_seeds is None else list(side_seeds)
        if y is not None:
            outs.append(y)
            seeds.append(dy)
        targets = list(self.targets())
        inputs = targets + ([x] if x is not None else [])
        grads = torch.autograd.grad(outs, inputs, seeds, allow_unused=True) if inputs else ()
        self.accumulate(m, list(grads[:len(targets)]))
        return grads[len(targets)] if x is not None else None


def _exchange(value, blank, pairs, group):
    """``comm.ppermute`` of ``value`` (``blank`` where this member sends
    nothing) over ``pairs``; None when no pair exists."""
    if not pairs:
        return None
    if value is not None and (value.shape != blank.shape or value.dtype != blank.dtype):
        # every member must post the same shape and dtype: a receiver sizes its buffer from its own
        raise ValueError(f"pipeline: a stage sent {tuple(value.shape)} {value.dtype}, the wire carries "
                         f"{tuple(blank.shape)} {blank.dtype}")
    return dist.ppermute(value if value is not None else blank, pairs, group)


def _blank(like):
    shape, dtype, device = like
    return torch.zeros(shape, dtype=dtype, device=device)


def fill_drain(stage, num_micro, like, group=dist.PIPE_AXIS):
    """Every microbatch forward through the pipe group's stages, then (when
    the stage trains) every backward in microbatch order. ``like``: the
    (shape, dtype, device) of an activation on the wire."""
    _fill(stage, num_micro, like, group)
    if stage.train:
        _drain(stage, num_micro, like, group)


def _fill(stage, M, like, group):
    S, s = stage.num_stages, stage.index
    blank = _blank(like) if S > 1 else None
    recv = None
    for t in range(M + S - 1):
        y = stage.forward(t - s, recv if s > 0 else None) if 0 <= t - s < M else None
        recv = _exchange(y, blank, [(i, i + 1) for i in range(S - 1) if 0 <= t - i < M], group)


def _drain(stage, M, like, group, dy_last=None, side_seeds=None):
    """The backward half: stage ``s`` on microbatch ``u - (S - 1 - s)`` at
    tick ``u``; the last stage's activation gradients from ``dy_last(m)``
    (None: it sends no activation)."""
    S, s = stage.num_stages, stage.index
    blank = _blank(like) if S > 1 else None
    recv = None
    for u in range(M + S - 1):
        b = u - (S - 1 - s)
        dx = None
        if 0 <= b < M:
            dy = (dy_last(b) if dy_last is not None else None) if stage.last else recv
            dx = stage.backward(b, dy, side_seeds)
        recv = _exchange(dx, blank, [(i, i - 1) for i in range(1, S) if 0 <= u - (S - 1 - i) < M], group)


def one_f_one_b(stage, num_micro, like, group=dist.PIPE_AXIS):
    """1F1B: each tick one forward micro-step and one backward micro-step
    on every stage (warm-up forwards, the steady state, cool-down
    backwards). ``like`` as :func:`fill_drain`."""
    S, s, M = stage.num_stages, stage.index, num_micro
    blank = _blank(like) if S > 1 else None
    fwd_in = bwd_in = None
    for t in range(M + 2 * (S - 1)):
        f, b = t - s, t - 2 * (S - 1) + s
        y = stage.forward(f, fwd_in if s > 0 else None) if 0 <= f < M else None
        dx = stage.backward(b, bwd_in if s < S - 1 else None) if 0 <= b < M else None
        fwd_in = _exchange(y, blank, [(i, i + 1) for i in range(S - 1) if 0 <= t - i < M], group)
        bwd_in = _exchange(dx, blank, [(i, i - 1) for i in range(1, S) if 0 <= t - 2 * (S - 1) + i < M],
                           group)


# ---------------------------------------------------------------------------
# the JAX functions' forms over a stage_fn


class _FnStage(PipeStage):
    """A ``stage_fn`` over this stage's ``params``; stage 0 reads
    ``x_stream``, the last keeps its outputs (and runs ``loss_head``)."""

    def __init__(self, stage_fn, params, x_stream, group, with_aux=False, loss_head=None, head_params=(),
                 loss_denom=None, train=True):
        super().__init__(dist.get_rank(group), dist.get_world_size(group), train)
        self.fn, self.params, self.xs = stage_fn, list(params), x_stream
        self.with_aux, self.loss_head, self.head_params = with_aux, loss_head, list(head_params)
        self.loss_denom = loss_denom
        self.outputs, self.dxs = {}, {}
        self.grads = [None] * (len(self.params) + len(self.head_params))

    def source(self, m):
        return self.xs[m] if self.first else None

    def run(self, m, x):
        out = self.fn(self.params, x, m)
        y, aux = out if self.with_aux else (out, None)
        side = [] if aux is None else [aux.float()]
        if self.last:
            if self.loss_head is None:
                self.outputs[m] = y.detach()
                return (y if self.train else None), side
            loss = self.loss_head(self.head_params, y, m)
            if self.loss_denom is not None:
                loss = loss / self.loss_denom
            return None, side + [loss.float()]
        return y, side

    def targets(self):
        return self.params + (self.head_params if self.last else [])

    def accumulate(self, m, grads):
        for i, g in enumerate(grads):
            if g is not None:
                self.grads[i] = g if self.grads[i] is None else self.grads[i] + g

    def backward(self, m, dy, side_seeds=None):
        dx = super().backward(m, dy, side_seeds)
        if self.first:
            self.dxs[m] = dx
        return dx


def _from_last(t, group):
    """``t`` of the group's last member, on every member."""
    return dist.broadcast(t, src=dist.get_world_size(group) - 1, group=group)


def _from_first(t, group):
    return dist.broadcast(t, src=0, group=group)


class _Pipeline(torch.autograd.Function):
    """The fill-drain forward; the backward drains the gradient of the
    last member's stream through the stages in microbatch order."""

    @staticmethod
    def forward(ctx, holder, x_stream, *params):
        st = holder["stage"]
        M = x_stream.shape[0]
        like = (tuple(x_stream.shape[1:]), x_stream.dtype, x_stream.device)
        st.train = any(p.requires_grad for p in params) or x_stream.requires_grad
        _fill(st, M, like, holder["group"])
        ctx.holder, ctx.M, ctx.like = holder, M, like
        out = torch.stack([st.outputs[m] for m in range(M)]) if st.last else torch.zeros_like(x_stream)
        stream = _from_last(out, holder["group"])
        if not holder["with_aux"]:
            return stream
        aux = torch.zeros((), device=x_stream.device)
        for m in range(M):
            aux = aux + st.side[m][0]
        return stream, dist.all_reduce(aux, group=holder["group"])

    @staticmethod
    def backward(ctx, g_stream, g_aux=None):
        holder = ctx.holder
        st, group, M = holder["stage"], holder["group"], ctx.M
        g_stream = _from_last(g_stream.contiguous(), group)
        seeds = None
        if holder["with_aux"]:  # the aux term's gradient, the same on every member
            seeds = [torch.zeros((), device=g_stream.device) if g_aux is None else g_aux.reshape(())]
        _drain(st, M, ctx.like, group, lambda m: g_stream[m], seeds)
        dxs = torch.stack([st.dxs[m] for m in range(M)]) if st.first else torch.zeros(g_stream.shape, dtype=ctx.like[1],
                                                                                        device=g_stream.device)
        dxs = _from_first(dxs, group)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(st.params, st.grads)]
        return (None, dxs, *grads)


def spmd_pipeline(stage_fn, stage_params, x_stream, group=dist.PIPE_AXIS, with_aux=False):
    """``x_stream`` ((M, ...) microbatches entering stage 0) through the
    pipe group's stages: ``stage_fn(local_params, x, m) -> y`` (or ``(y,
    aux)`` with ``with_aux``) runs this member's ``stage_params`` (a list of
    tensors). Returns the stream leaving the last stage on every member
    (and, with ``with_aux``, the sum of ``aux`` over every (stage,
    microbatch), summed over the group); differentiable w.r.t.
    ``stage_params`` and ``x_stream``: the gradient of the last member's
    stream is what the backward drains."""
    stage = _FnStage(stage_fn, stage_params, x_stream.detach(), group, with_aux=with_aux)
    holder = {"stage": stage, "group": group, "with_aux": with_aux}
    return _Pipeline.apply(holder, x_stream, *stage.params)


def spmd_pipeline_1f1b(stage_fn, loss_head, stage_params, head_params, x_stream, group=dist.PIPE_AXIS,
                       loss_denom=None):
    """1F1B over ``stage_fn`` (the :func:`spmd_pipeline` contract) with
    ``loss_head(head_params, y, m)``, microbatch ``m``'s raw loss, run on
    the last stage the moment its forward ends and divided by
    ``loss_denom`` (the global normalizer) when given. Returns ``(loss,
    stage_grads, head_grads, dx_stream)``: the loss summed in microbatch
    order and the head gradients, from the last member, on every member;
    this member's stage gradients; the gradient of ``x_stream`` from
    stage 0, on every member."""
    stage = _FnStage(stage_fn, stage_params, x_stream.detach(), group, loss_head=loss_head,
                     head_params=head_params, loss_denom=loss_denom)
    M = x_stream.shape[0]
    one_f_one_b(stage, M, (tuple(x_stream.shape[1:]), x_stream.dtype, x_stream.device), group)
    zero = torch.zeros((), device=x_stream.device)
    loss = sum((stage.side[m][-1] for m in range(M)), zero) if stage.last else zero
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(stage.params + stage.head_params, stage.grads)]
    n = len(stage.params)
    head = [g if stage.last else torch.zeros_like(g) for g in grads[n:]]
    dxs = torch.stack([stage.dxs[m] for m in range(M)]) if stage.first else torch.zeros_like(x_stream)
    return (_from_last(loss, group), grads[:n], [_from_last(g, group) for g in head], _from_first(dxs, group))
