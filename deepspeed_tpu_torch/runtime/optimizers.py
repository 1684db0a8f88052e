"""Optimizers of the port's training engine.

The JAX engine builds optax transformations (``deepspeed_tpu/runtime/
engine.py:555-632``); XLA runs them, no Pallas kernel. The port writes the
same update math as plain ``torch._foreach_*`` ops over the fp32 master
tensors, in place, with ``n`` the count of updates applied before this one
and ``lr`` the learning rate of that count:

- Adam (either ``adam_w_mode``) and AdamW are ``optax.adamw`` (the JAX
  package's Adam without ``adam_w_mode`` chains ``scale_by_adam``,
  ``add_decayed_weights`` and ``scale_by_learning_rate``, the same
  update)::

      mu = b1 mu + (1 - b1) g            nu = b2 nu + (1 - b2) g^2
      p -= lr * (mu / (1 - b1^(n+1)) / (sqrt(nu / (1 - b2^(n+1))) + eps) + wd p)

- Adagrad is ``scale_by_rss(initial_accumulator_value, eps)``: ``s += g^2;
  p -= lr * where(s > 0, rsqrt(s + eps), 0) * g``;
- LAMB is ``scale_by_adam``, ``add_decayed_weights(wd)``,
  ``scale_by_trust_ratio(min_norm=min_coeff)``: the Adam step ``u`` (plus
  ``wd p``) scaled by ``max(|p|, min) / max(|u|, min)`` (1 where either norm
  is 0), the norms over each group of tensors. optax takes them per leaf,
  and the JAX model's scanned layers stack each per-layer weight into one
  leaf, so with ``scan_layers`` the engine groups the per-layer tensors of
  one name (:func:`norm_groups`);
- SGD is ``optax.sgd(lr, momentum, nesterov)``: ``t = g + momentum t``, the
  update ``t`` (or ``g + momentum t`` with ``nesterov``), no weight decay;
- Lion is ``optax.lion(lr, b1, b2, wd)``: ``p -= lr * (sign((1 - b1) g +
  b1 m) + wd p)``, then ``m = (1 - b2) g + b2 m``;
- a client ``torch.optim.Optimizer`` (or a callable building one over the
  master tensors) takes ``.grad`` from the engine, the learning rate in
  every ``param_group``, and steps.

Under ZeRO stage >= 1 the master tensors are this rank's shards and every
optimizer steps them as they are: the moments are made at the shard's
shape, AdamW, Adagrad, SGD and Lion are elementwise, LAMB's trust ratio
takes whole-tensor norms by summing the shards' squared norms over their
group (``norm_reduce``, from the engine), and a client optimizer gets the
shard tensors.

The built-in optimizers work through the tensor list a chunk of at most
``CHUNK_ELEMS`` elements at a time, so an update's temporaries never
exceed one chunk (whole-list temporaries, two fp32 copies of the model,
would set a training step's peak device memory above the backward pass's
and hide what remat saves); LAMB computes the Adam step twice, once for
the norms and once to apply it, from the same moments and so to the same
bits. Every optimizer has ``state_dict()`` / ``load_state_dict()`` (tensors
and plain numbers only) for checkpoints. The 1-bit optimizers raise
``NotImplementedError`` naming their ROADMAP item.
"""

import re

import torch

from .constants import (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER, CPU_ADAM_OPTIMIZER,
                        ADAGRAD_OPTIMIZER, LAMB_OPTIMIZER, SGD_OPTIMIZER, LION_OPTIMIZER,
                        ONEBIT_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER)

# elements of one chunk of the tensor list (256 MB of fp32; a tensor larger
# than that is a chunk of its own)
CHUNK_ELEMS = 1 << 26

_UNPORTED = {
    ONEBIT_ADAM_OPTIMIZER: "ROADMAP Queue 1 #10, ops/adam/onebit_adam.py",
    ONEBIT_LAMB_OPTIMIZER: "ROADMAP Queue 1 #10, ops/adam/onebit_adam.py",
    ZERO_ONE_ADAM_OPTIMIZER: "ROADMAP Queue 1 #10, ops/adam/onebit_adam.py",
}


def tensor_norms(tensors):
    """The L2 norm of each tensor, as fp32 0-d tensors (a bf16 gradient's
    in fp32 too, so ZeRO-Offload's bf16 gradients norm as the on-device
    step's upcast ones). On the CPU PyTorch's fp32 norm sums in one pass
    (5e-3 off at 64M elements, a gpt2-large embedding), so there it
    accumulates in fp64; the card's reduction is a tree and stays within
    fp32 rounding."""
    if tensors and tensors[0].is_cuda:
        return list(torch._foreach_norm(tensors, 2, dtype=torch.float32))
    return [torch.linalg.vector_norm(t, dtype=torch.float64).float() for t in tensors]


class _Optimizer:
    """Base: ``count`` updates applied and the per-tensor state lists named
    in ``_STATE``; ``step(params, grads, lr)`` updates ``params`` in place."""

    _STATE = ()

    def __init__(self):
        self.count = 0

    @staticmethod
    def _chunks(params):
        """Slices of the tensor list, each of at most ``CHUNK_ELEMS``
        elements (or one tensor)."""
        start, size = 0, 0
        for i, p in enumerate(params):
            if size and size + p.numel() > CHUNK_ELEMS:
                yield slice(start, i)
                start, size = i, 0
            size += p.numel()
        if start < len(params):
            yield slice(start, len(params))

    def state_dict(self):
        return {"count": self.count, **{name: list(getattr(self, name)) for name in self._STATE}}

    @torch.no_grad()
    def load_state_dict(self, sd):
        """Copy a :meth:`state_dict` into this optimizer's tensors (they keep
        their device)."""
        for name in self._STATE:
            mine, theirs = getattr(self, name), sd[name]
            if len(mine) != len(theirs):
                raise ValueError(f"optimizer state '{name}' has {len(theirs)} tensors, expected "
                                 f"{len(mine)}")
            for a, b in zip(mine, theirs):
                a.copy_(b)
        self.count = int(sd["count"])


def _move_moments(opt, sl, grads):
    """Adam's moments of the tensors ``sl`` moved by their gradients."""
    b1, b2 = opt.b1, opt.b2
    mu, nu = opt.mu[sl], opt.nu[sl]
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)


def _adam_update(opt, sl, params):
    """``scale_by_adam``'s update of the tensors ``sl`` (a new list) from
    the moved moments, plus ``weight_decay * params``."""
    n = opt.count + 1
    denom = torch._foreach_div(opt.nu[sl], 1.0 - opt.b2**n)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, opt.eps)
    update = torch._foreach_div(opt.mu[sl], 1.0 - opt.b1**n)
    torch._foreach_div_(update, denom)
    del denom
    if opt.weight_decay:
        torch._foreach_add_(update, params, alpha=opt.weight_decay)
    return update


class AdamW(_Optimizer):
    """``optax.adamw`` over a list of fp32 tensors, updated in place. The
    moments are fp32 tensors beside the parameters."""

    _STATE = ("mu", "nu")

    def __init__(self, params, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0):
        super().__init__()
        self.b1, self.b2, self.eps, self.weight_decay = float(b1), float(b2), float(eps), float(weight_decay)
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params, grads, lr):
        """One update of ``params`` (in place) from ``grads`` at learning
        rate ``lr`` (a Python float)."""
        for sl in self._chunks(params):
            _move_moments(self, sl, grads[sl])
            torch._foreach_add_(params[sl], _adam_update(self, sl, params[sl]), alpha=-lr)
        self.count += 1


class Adagrad(_Optimizer):
    """``scale_by_rss(initial_accumulator_value, eps)`` then the lr."""

    _STATE = ("sum_sq", )

    def __init__(self, params, initial_accumulator_value=0.0, eps=1e-8):
        super().__init__()
        self.eps = float(eps)
        self.sum_sq = [torch.full_like(p, float(initial_accumulator_value)) for p in params]

    @torch.no_grad()
    def step(self, params, grads, lr):
        for p, s, g in zip(params, self.sum_sq, grads):
            s.addcmul_(g, g)
            scale = torch.where(s > 0, torch.rsqrt(s + self.eps), torch.zeros_like(s))
            p.add_(scale * g, alpha=-lr)
        self.count += 1


class Lamb(_Optimizer):
    """``scale_by_adam`` → ``add_decayed_weights`` → ``scale_by_trust_ratio(
    min_norm=min_coeff)`` → lr, the trust ratio over ``groups`` (lists of
    tensor indices; default each tensor alone, optax's per-leaf ratio)."""

    _STATE = ("mu", "nu")

    def __init__(self, params, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, min_coeff=0.01,
                 groups=None, norm_reduce=None):
        super().__init__()
        self.norm_reduce = norm_reduce  # shards' norms -> whole tensors' norms (ZeRO stage >= 1)
        self.b1, self.b2, self.eps, self.weight_decay = float(b1), float(b2), float(eps), float(weight_decay)
        self.min_norm = float(min_coeff)
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        groups = groups if groups is not None else [[i] for i in range(len(params))]
        of = torch.empty(len(params), dtype=torch.long)
        for gi, members in enumerate(groups):
            of[members] = gi
        self._n_groups = len(groups)
        self._group_of = of.to(params[0].device) if params else of

    def _group_norms(self, norms):
        """Each group's L2 norm from its tensors' norms, floored at
        ``min_norm`` (optax ``safe_norm``), as a (groups,) fp32 tensor."""
        sq = torch.stack(norms).square()
        norms = torch.zeros(self._n_groups, dtype=sq.dtype, device=sq.device).index_add_(
            0, self._group_of, sq).sqrt()
        return torch.where(norms <= self.min_norm, torch.full_like(norms, self.min_norm), norms)

    @torch.no_grad()
    def step(self, params, grads, lr):
        u_norms = []
        for sl in self._chunks(params):
            _move_moments(self, sl, grads[sl])
            u_norms += tensor_norms(_adam_update(self, sl, params[sl]))
        pn, un = tensor_norms(params), u_norms
        if self.norm_reduce is not None:
            pn, un = self.norm_reduce(pn), self.norm_reduce(un)
        pn, un = self._group_norms(pn), self._group_norms(un)
        ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)[self._group_of].unbind()
        for sl in self._chunks(params):
            update = _adam_update(self, sl, params[sl])
            torch._foreach_mul_(update, list(ratio[sl]))
            torch._foreach_add_(params[sl], update, alpha=-lr)
        self.count += 1


class SGD(_Optimizer):
    """``optax.sgd(lr, momentum, nesterov)``: a trace of the gradients."""

    _STATE = ("trace", )

    def __init__(self, params, momentum=0.0, nesterov=False):
        super().__init__()
        self.momentum, self.nesterov = float(momentum), bool(nesterov)
        self.trace = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params, grads, lr):
        for sl in self._chunks(params):
            trace = self.trace[sl]
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads[sl])
            update = trace
            if self.nesterov:
                update = torch._foreach_mul(trace, self.momentum)
                torch._foreach_add_(update, grads[sl])
            torch._foreach_add_(params[sl], update, alpha=-lr)
        self.count += 1


class Lion(_Optimizer):
    """``optax.lion(lr, b1, b2, weight_decay)``."""

    _STATE = ("mu", )

    def __init__(self, params, b1=0.9, b2=0.99, weight_decay=0.0):
        super().__init__()
        self.b1, self.b2, self.weight_decay = float(b1), float(b2), float(weight_decay)
        self.mu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params, grads, lr):
        for sl in self._chunks(params):
            mu, g, p = self.mu[sl], grads[sl], params[sl]
            update = torch._foreach_mul(g, 1.0 - self.b1)
            torch._foreach_add_(update, torch._foreach_mul(mu, self.b1))
            torch._foreach_sign_(update)
            if self.weight_decay:
                torch._foreach_add_(update, p, alpha=self.weight_decay)
            torch._foreach_mul_(mu, self.b2)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b2)
            torch._foreach_add_(p, update, alpha=-lr)
        self.count += 1


class ClientOptimizer(_Optimizer):
    """A client ``torch.optim.Optimizer`` over the master tensors: each step
    sets ``.grad``, writes ``lr`` into every ``param_group`` and calls
    ``step()``."""

    def __init__(self, optimizer, params):
        super().__init__()
        ids = {id(p) for p in params}
        for group in optimizer.param_groups:
            for p in group["params"]:
                if id(p) not in ids:
                    raise ValueError("a client torch.optim.Optimizer must hold the engine's master "
                                     "tensors: pass fp32 tensors on the engine's device as "
                                     "model_parameters, or a callable params -> Optimizer")
        self.optimizer = optimizer

    @property
    def lr(self):
        return float(self.optimizer.param_groups[0]["lr"])

    @torch.no_grad()
    def step(self, params, grads, lr):
        for p, g in zip(params, grads):
            p.grad = g
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        for p in params:
            p.grad = None
        self.count += 1

    def state_dict(self):
        return {"count": self.count, "client": self.optimizer.state_dict()}

    def load_state_dict(self, sd):
        self.optimizer.load_state_dict(sd["client"])
        self.count = int(sd["count"])


def norm_groups(names):
    """LAMB's norm groups for a scanned model: the tensors of ``names``
    whose keys differ only in the layer index (``layers.{i}.<rest>``) form
    one group, the JAX model's stacked leaf; every other tensor is a group
    of its own."""
    groups, where = [], {}
    for i, name in enumerate(names):
        m = re.fullmatch(r"layers\.\d+\.(.+)", name)
        key = ("layers", m.group(1)) if m else ("leaf", name)
        if key not in where:
            where[key] = len(groups)
            groups.append([])
        groups[where[key]].append(i)
    return groups


def build_optimizer(opt_config, named_params, scanned=False, client=None, norm_reduce=None):
    """The optimizer over ``named_params`` (the master state dict, fp32, or
    this rank's shards of it): ``client`` (a ``torch.optim.Optimizer``, or
    a callable taking the list of master tensors and returning one), else
    the ``optimizer`` config section's type (default AdamW). ``scanned``:
    the model stacks its layers in the JAX package (LAMB's norm groups,
    :func:`norm_groups`). ``norm_reduce``: LAMB's whole-tensor norms from
    the shards' (None: the tensors are whole)."""
    params = list(named_params.values())
    if client is not None:
        if isinstance(client, torch.optim.Optimizer):
            return ClientOptimizer(client, params)
        if callable(client):
            return ClientOptimizer(client(params), params)
        raise ValueError("client optimizer must be a torch.optim.Optimizer or a callable "
                         "params -> torch.optim.Optimizer")
    name = (opt_config.type or ADAMW_OPTIMIZER).lower()
    p = dict(opt_config.params)
    if name in _UNPORTED:
        raise NotImplementedError(f"deepspeed_tpu_torch does not support the {opt_config.type} "
                                  f"optimizer yet ({_UNPORTED[name]})")
    betas = p.get("betas", (0.9, 0.999))
    eps, wd = p.get("eps", 1e-8), p.get("weight_decay", 0.0)
    if name in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER, CPU_ADAM_OPTIMIZER):
        return AdamW(params, b1=betas[0], b2=betas[1], eps=eps, weight_decay=wd)
    if name == ADAGRAD_OPTIMIZER:
        return Adagrad(params, initial_accumulator_value=p.get("initial_accumulator_value", 0.0), eps=eps)
    if name == LAMB_OPTIMIZER:
        groups = norm_groups(list(named_params)) if scanned else None
        return Lamb(params, b1=betas[0], b2=betas[1], eps=eps, weight_decay=wd,
                    min_coeff=p.get("min_coeff", 0.01), groups=groups, norm_reduce=norm_reduce)
    if name == SGD_OPTIMIZER:
        return SGD(params, momentum=p.get("momentum", 0.0), nesterov=p.get("nesterov", False))
    if name == LION_OPTIMIZER:
        return Lion(params, b1=betas[0], b2=betas[1], weight_decay=wd)
    raise ValueError(f"Unknown optimizer type {opt_config.type}")
