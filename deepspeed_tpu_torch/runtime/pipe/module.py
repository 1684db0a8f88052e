"""Pipeline module / layer partitioning.

Port of ``deepspeed_tpu/runtime/pipe/module.py`` (reference
``runtime/pipe/module.py``: ``LayerSpec`` :29, ``TiedLayerSpec`` :76,
``PipelineModule`` :85, ``_partition_layers`` :353), copied so the port
imports nothing of the JAX package: the same boundaries for the same
inputs. A ``LayerSpec`` is a lazy factory; partitioning produces the stage
boundaries the schedules (``schedule.py``) run.
"""

import re

import numpy as np


class LayerSpec:
    """Lazy layer: build only on the owning stage (reference ``module.py:29``).

    ``typename``: a class or factory; called with ``*args, **kwargs`` by
    ``build()``.
    """

    def __init__(self, typename, *args, **kwargs):
        self.typename = typename
        self.args = args
        self.kwargs = kwargs

    def build(self):
        return self.typename(*self.args, **self.kwargs)

    @property
    def name(self):
        return getattr(self.typename, "__name__", str(self.typename))

    def __repr__(self):
        return f"LayerSpec({self.name})"


class TiedLayerSpec(LayerSpec):
    """Layer whose parameters are shared across stages by key (reference
    ``module.py:76``; e.g. tied embeddings). In the SPMD pipeline tied
    parameters live *outside* the pipelined segment (embed/head run
    replicated over ``pipe``); the training engine sums their gradients
    over ``pipe`` (the reference's tied-grad allreduce,
    ``pipe/engine.py:223``)."""

    def __init__(self, key, typename, *args, forward_fn=None, tied_weight_attr="weight", **kwargs):
        super().__init__(typename, *args, **kwargs)
        self.key = key
        self.forward_fn = forward_fn
        self.tied_weight_attr = tied_weight_attr


def partition_uniform(num_items, num_parts):
    """Balanced contiguous split: boundaries array of len num_parts+1."""
    base = num_items // num_parts
    extra = num_items % num_parts
    counts = [base + (1 if i < extra else 0) for i in range(num_parts)]
    bounds = [0]
    for c in counts:
        bounds.append(bounds[-1] + c)
    return bounds


def partition_balanced(weights, num_parts):
    """Split ``weights`` into ``num_parts`` contiguous groups minimizing the
    heaviest group (reference ``ds_utils.partition_balanced``): binary search
    over the bottleneck + greedy packing."""
    weights = [float(w) for w in weights]
    n = len(weights)
    if num_parts >= n:
        return list(range(n + 1)) + [n] * (num_parts - n)

    def fits(cap):
        parts, cur = 1, 0.0
        for w in weights:
            if w > cap:
                return False
            if cur + w > cap:
                parts += 1
                cur = w
            else:
                cur += w
        return parts <= num_parts

    lo, hi = max(weights), sum(weights)
    for _ in range(64):
        mid = (lo + hi) / 2
        if fits(mid):
            hi = mid
        else:
            lo = mid
    cap = hi
    bounds, cur = [0], 0.0
    for i, w in enumerate(weights):
        if cur + w > cap and len(bounds) < num_parts:
            bounds.append(i)
            cur = w
        else:
            cur += w
    bounds.append(n)
    while len(bounds) < num_parts + 1:
        bounds.insert(-1, bounds[-1])
    return bounds


class PipelineModule:
    """Sequence-of-layers container partitioned across pipeline stages
    (reference ``module.py:85``).

    ``layers``: list of LayerSpec (or callables). ``num_stages``: pipe size.
    ``partition_method``: 'uniform' | 'parameters' | 'type:<regex>'
    (reference ``_partition_layers`` :353).
    """

    def __init__(self, layers, num_stages, partition_method="parameters", loss_fn=None,
                 activation_checkpoint_interval=0):
        self.specs = [l if isinstance(l, LayerSpec) else LayerSpec(lambda l=l: l) for l in layers]
        self.num_stages = num_stages
        self.loss_fn = loss_fn
        self.activation_checkpoint_interval = activation_checkpoint_interval
        self.parts = self._partition(partition_method)
        self.tied_keys = sorted({s.key for s in self.specs if isinstance(s, TiedLayerSpec)})

    def _partition(self, method):
        n = len(self.specs)
        method = method.lower()
        if method in ("uniform", "uniform:"):
            return partition_uniform(n, self.num_stages)
        if method == "parameters":
            weights = [self._spec_param_count(s) for s in self.specs]
            return partition_balanced(weights, self.num_stages)
        if method.startswith("type:"):
            pat = re.compile(method[len("type:"):], re.IGNORECASE)
            weights = [1 if pat.search(s.name) else 0 for s in self.specs]
            return partition_balanced([max(w, 1e-6) for w in weights], self.num_stages)
        raise ValueError(f"Unknown partition_method {method!r}")

    @staticmethod
    def _spec_param_count(spec):
        built = spec.build()
        if hasattr(built, "num_params"):
            return max(1, built.num_params())
        if hasattr(built, "cfg") and hasattr(built.cfg, "num_params"):
            return max(1, built.cfg.num_params())
        return 1

    def stage_layers(self, stage_id):
        lo, hi = self.parts[stage_id], self.parts[stage_id + 1]
        return self.specs[lo:hi]

    def stage_owner(self, layer_idx):
        return int(np.searchsorted(np.asarray(self.parts[1:]), layer_idx, side="right"))

    def describe(self):
        lines = []
        for s in range(self.num_stages):
            names = [spec.name for spec in self.stage_layers(s)]
            lines.append(f"stage {s}: layers[{self.parts[s]}:{self.parts[s+1]}] {names}")
        return "\n".join(lines)
