"""ZeRO as sharding rules.

Port of ``deepspeed_tpu/runtime/zero/sharding.py``. The JAX package
declares where each tensor lives as a ``PartitionSpec`` and lets XLA insert
the all-gathers and reduce-scatters; the port keeps the same rules and the
engine (``runtime/engine.py``) runs the collectives itself:

- stage 0: parameters, gradients and optimizer state replicated over the
  data-parallel group;
- stage 1: the fp32 master and the optimizer moments sharded over it;
- stage 2: the gradient accumulators too (reduce-scattered);
- stage 3: the compute-dtype parameters too, gathered a block at a time.

Rules that carry over from DeepSpeed: ``stage3_param_persistence_threshold``
(a compute tensor of at most that many elements stays whole); MoE-aware
groups (an expert tensor shards over ``data`` only, a dense one over
``('expert', 'data')``); tensor-parallel rules, matched by key regex before
the data-parallel axes are placed; the pipe rule, :meth:`ShardingPlanner.
pipe_stage`. The ``seq`` axis takes no part: seq ranks hold replicas, as
the JAX planner places them.

A spec is a tuple with one entry per dim: None, an axis name, or a tuple
of axis names (a ``PartitionSpec``'s entries). The JAX package's paths
join keys with ``/`` and stack a scanned model's layers on a leading dim;
the port's state dict has one key per layer (``layers.{i}.…``). The rules
are shape-driven, so a port tensor gets the spec the JAX planner gives its
layer slice, except where the stacked dim changes which dim is largest or
divisible: only the memory layout differs there, never a number. The JAX
planner shards a layer stack's leading dim over ``pipe``; the port places
each ``layers.{i}.*`` tensor whole on its owner stage instead
(:meth:`ShardingPlanner.pipe_stage`), and its spec is the JAX spec of its
layer slice: the data axes within the stage.
"""

import math
import re

from ...comm import comm as dist
from ...utils.logging import logger
from .config import ZeroStageEnum


def entry_axes(entry):
    """The axes of one spec entry, as a tuple (empty for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry, )


def _shape_of(mesh):
    return dict(mesh.shape) if hasattr(mesh, "shape") else dict(mesh)


class TensorParallelRules:
    """Ordered (regex, spec) rules; the first match wins (the JAX file's
    form of AutoTP's row/column parser, ``module_inject/auto_tp.py:84``)."""

    def __init__(self, rules=()):
        self.rules = [(re.compile(pat), tuple(spec)) for pat, spec in rules]

    def match(self, path_str, ndim):
        for pat, spec in self.rules:
            if pat.search(path_str):
                if len(spec) > ndim:
                    raise ValueError(f"TP rule {pat.pattern} spec {spec} has more dims than param "
                                     f"{path_str} (ndim={ndim})")
                return spec + (None, ) * (ndim - len(spec))
        return None

    def __bool__(self):
        return bool(self.rules)


def best_shardable_dim(shape, size, taken):
    """The largest dim divisible by ``size`` and not already sharded; None
    if there is none (a real dim is split, so nothing is padded or
    flattened)."""
    best = None
    for d, extent in enumerate(shape):
        if d in taken:
            continue
        if extent % size == 0 and extent >= size:
            if best is None or extent > shape[best]:
                best = d
    return best


class ShardingPlanner:
    """Specs for the compute parameters, the fp32 master and optimizer
    state, the gradients and the offloaded optimizer state. ``mesh``: the
    ``comm`` mesh or a mapping of axis name to size."""

    def __init__(self, mesh, zero_config=None, tp_rules=None, expert_pattern=None, pipe_pattern=None,
                 num_layers=None):
        self.mesh_shape = _shape_of(mesh)
        self.stage = zero_config.stage if zero_config is not None else 0
        self.tp_rules = tp_rules if isinstance(tp_rules, TensorParallelRules) else \
            TensorParallelRules(tp_rules or ())
        self.expert_pattern = re.compile(expert_pattern) if expert_pattern else None
        self.pipe_pattern = re.compile(pipe_pattern) if pipe_pattern else None
        self.num_layers = num_layers
        self.persistence_threshold = (zero_config.stage3_param_persistence_threshold
                                      if zero_config is not None else int(1e5))

    def _size(self, axes):
        return math.prod(self.mesh_shape.get(a, 1) for a in axes)

    # -- one tensor ----------------------------------------------------------
    def _validate(self, spec, shape, path_str):
        """Drop the entries whose dim is not divisible by their axes' size
        (2 kv heads under tensor 4 fall back to replication)."""
        entries = list(spec)
        changed = False
        for d, entry in enumerate(entries):
            if entry is None:
                continue
            if d >= len(shape) or shape[d] % self._size(entry_axes(entry)) != 0:
                entries[d] = None
                changed = True
        if changed:
            logger.debug(f"{path_str}: shape {shape} not divisible by rule {spec}; relaxed to {entries}")
        return tuple(entries)

    def pipe_stage(self, path_str):
        """The pipe stage that holds ``path_str`` whole: a key of
        ``pipe_pattern`` (its group the layer index) belongs to stage
        ``i // (L / S)``, the JAX split of the stacked dim; None for a
        tensor replicated over ``pipe`` (embed, head) or without a pipe
        axis."""
        pipe = self.mesh_shape.get(dist.PIPE_AXIS, 1)
        match = self.pipe_pattern.search(path_str) if pipe > 1 and self.pipe_pattern is not None else None
        if match is None:
            return None
        if not self.num_layers or self.num_layers % pipe != 0:
            raise ValueError(f"{self.num_layers} layers do not split evenly over pipe={pipe}")
        return int(match.group(1)) // (self.num_layers // pipe)

    def dp_axes_for(self, path_str):
        """The ZeRO group of a tensor: ``data`` for an expert, else expert x
        data."""
        if self.expert_pattern is not None and self.expert_pattern.search(path_str):
            return (dist.DATA_AXIS, )
        return (dist.EXPERT_AXIS, dist.DATA_AXIS)

    def _apply_dp(self, spec, shape, path_str):
        """The ZeRO axes on the largest free divisible dim."""
        axes = [a for a in self.dp_axes_for(path_str) if self.mesh_shape.get(a, 1) > 1]
        if not axes:
            return spec
        size = self._size(axes)
        taken = {d for d, e in enumerate(spec) if e is not None}
        dim = best_shardable_dim(shape, size, taken)
        if dim is None:
            logger.debug(f"param {path_str} shape {shape} not divisible by dp={size}; replicating")
            return spec
        entries = list(spec)
        entries[dim] = tuple(axes) if len(axes) > 1 else axes[0]
        return tuple(entries)

    def _base(self, path_str, shape):
        ndim = len(shape)
        spec = self.tp_rules.match(path_str, ndim) or (None, ) * ndim
        return self._validate(spec, shape, path_str)

    def param_spec(self, path_str, shape):
        """Spec of a compute parameter: sharded at stage 3 above the
        persistence threshold."""
        spec = self._base(path_str, shape)
        if self.stage >= ZeroStageEnum.weights and math.prod(shape) > self.persistence_threshold:
            spec = self._apply_dp(spec, shape, path_str)
        return spec

    def master_spec(self, path_str, shape):
        """Spec of the fp32 master and the optimizer moments (stage >= 1)."""
        spec = self._base(path_str, shape)
        if self.stage >= ZeroStageEnum.optimizer_states:
            spec = self._apply_dp(spec, shape, path_str)
        return spec

    def grad_spec(self, path_str, shape):
        """Spec of the gradients and their accumulators (stage >= 2)."""
        spec = self._base(path_str, shape)
        if self.stage >= ZeroStageEnum.gradients:
            spec = self._apply_dp(spec, shape, path_str)
        return spec

    def offload_spec(self, path_str, shape):
        """Spec of offloaded optimizer state and the gradients feeding it:
        scattered over the ZeRO axes at any stage, so each rank's host steps
        only its partition (reference ``stage_1_and_2.py:1031``)."""
        return self._apply_dp(self._base(path_str, shape), shape, path_str)


# ---------------------------------------------------------------------------
# this rank's shard of a tensor, and the whole tensor back


def sharded_dims(spec):
    """[(dim, axes)] of the entries of ``spec`` whose group has more than
    one member in the live mesh (an axis of size 1 splits nothing)."""
    out = []
    for d, entry in enumerate(spec or ()):
        axes = entry_axes(entry)
        if axes and dist.get_world_size(axes) > 1:
            out.append((d, axes))
    return out


def shard(t, spec):
    """This rank's chunk of ``t`` along each sharded entry of ``spec``, in
    the group's member order (a view; ``t`` itself when nothing splits)."""
    for d, axes in sharded_dims(spec):
        n = dist.get_world_size(axes)
        step = t.shape[d] // n
        t = t.narrow(d, dist.get_rank(axes) * step, step)
    return t


def unshard(s, spec):
    """The whole tensor from every member's shard: ``comm.all_gather``
    along each sharded entry (``s`` itself when nothing splits)."""
    for d, axes in reversed(sharded_dims(spec)):
        s = dist.all_gather(s.contiguous(), group=axes, axis=d)
    return s


def shard_group(spec):
    """The axes a tensor of ``spec`` is split over (a tuple; empty when
    whole): the group its shards' sums run over."""
    axes = []
    for _, a in sharded_dims(spec):
        axes.extend(a)
    return tuple(axes)
