"""The port's ZeRO plan and its helpers against the JAX package:

- ``runtime/zero/sharding.py``'s planner gives the JAX ``ShardingPlanner``'s
  specs for every parameter of the ``tiny`` and ``tiny-moe`` presets, on
  data 2, data 4 and expert 2 x data 2, at every stage and at persistence
  thresholds 0 and 10^9: on the JAX model's own paths, shapes and rules
  (the logic), and on the port's state dict with the port model's rules
  wherever the two layouts give a tensor the same shape. They differ in
  shape for every per-layer tensor (the JAX model stacks the layers on a
  leading dim): there the port's spec is the JAX spec without the stacked
  dim, except for the attention kernels, which are 2-D (H, heads x hd) in
  the port and 3-D (H, heads, hd) in JAX, and are held to their own rules;
- on a gloo world of 4 (expert 2 x data 2): the group API's answers, and
  ``shard`` then ``unshard`` is the identity for specs on every axis set;
  ``utils.tensor_fragment``'s getters and setters round-trip at stage 3 (a
  master tensor, a moment, the facade's gradient);
- ``CommOverlapTracker`` on planted spans: a hidden asynchronous transfer
  and an exposed synchronous one give ``1 - exposed / realized``, and two
  overlapping spans count their union once;
- ``runtime/utils.py``'s norms equal ``torch.linalg.vector_norm``, and its
  clip scales to the limit.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.models as jm
from deepspeed_tpu.runtime.zero.sharding import ShardingPlanner as JaxPlanner, _path_str
from deepspeed_tpu_torch.comm import overlap
from deepspeed_tpu_torch.models import get_model
from deepspeed_tpu_torch.runtime import utils as rt_utils
from deepspeed_tpu_torch.runtime.zero.sharding import ShardingPlanner, best_shardable_dim

from . import torch_dist_workers as workers
from .torch_dist_workers import run_world

MESHES = {"data2": {"data": 2}, "data4": {"data": 4}, "expert2xdata2": {"expert": 2, "data": 2}}
AXES = ("pipe", "expert", "data", "seq", "tensor")


def _mesh(layout):
    return types.SimpleNamespace(shape={a: layout.get(a, 1) for a in AXES})


def _zero(stage, threshold):
    return types.SimpleNamespace(stage=stage, stage3_param_persistence_threshold=threshold)


def _jax_shapes(model):
    import jax
    out = {}
    jax.tree_util.tree_map_with_path(lambda p, leaf: out.__setitem__(_path_str(p), tuple(leaf.shape)),
                                     jax.eval_shape(model.init_params, jax.random.key(0)))
    return out


def _spec(p):
    return tuple(tuple(e) if isinstance(e, list) else e for e in p)


def _jax_path(key):
    """The JAX (scanned) path of a port key, and whether it is a layer slice."""
    parts = key.split(".")
    if parts[0] == "layers":
        return "/".join(["layers"] + parts[2:]), True
    return "/".join(parts), False


@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
@pytest.mark.parametrize("layout", list(MESHES))
def test_planner_matches_jax(name, layout):
    jmod = jm.get_model(name, dtype=jnp.float32)
    jshapes = _jax_shapes(jmod)
    port = get_model(name, dtype=torch.float32)
    pshapes = {k: s for k, (s, _) in port.param_shapes().items()}
    mesh = _mesh(MESHES[layout])
    jrules = [(pat, tuple(spec)) for pat, spec in jmod.tp_rules()]
    compared = {"same shape": 0, "layer slice": 0, "attention": 0}
    for stage in range(4):
        for threshold in (0, 10**9):
            zc = _zero(stage, threshold)
            jp = JaxPlanner(mesh, zc, tp_rules=jmod.tp_rules(), expert_pattern=jmod.expert_pattern())
            mine = ShardingPlanner(mesh.shape, zc, tp_rules=jrules, expert_pattern=jmod.expert_pattern())
            ours = ShardingPlanner(mesh.shape, zc, tp_rules=port.tp_rules(), expert_pattern=port.expert_pattern())
            for which in ("param", "master", "grad", "offload"):
                # the logic: JAX's own paths, shapes and rules
                for path, shape in jshapes.items():
                    want = _spec(getattr(jp, f"{which}_spec")(path, shape))
                    assert getattr(mine, f"{which}_spec")(path, shape) == want, (which, path, stage)
                # the port's layout
                for key, shape in pshapes.items():
                    path, layer = _jax_path(key)
                    want = _spec(getattr(jp, f"{which}_spec")(path, jshapes[path]))
                    got = getattr(ours, f"{which}_spec")(key, shape)
                    if tuple(jshapes[path]) == tuple(shape):
                        assert got == want, (which, key, stage, threshold)
                        compared["same shape"] += 1
                    elif layer and tuple(jshapes[path][1:]) == tuple(shape):
                        assert want[0] is None and got == want[1:], (which, key, stage, threshold)
                        compared["layer slice"] += 1
                    else:  # q/k/v (H, heads x hd) vs (H, heads, hd); o the transpose
                        assert ".attn." in key and key.endswith("_proj.kernel"), key
                        assert len(shape) == 2 and len(jshapes[path]) == 4
                        compared["attention"] += 1
    assert all(compared.values()), compared


def test_best_shardable_dim():
    assert best_shardable_dim((4, 64, 128), 2, set()) == 2
    assert best_shardable_dim((4, 64, 128), 2, {2}) == 1
    assert best_shardable_dim((3, 5), 2, set()) is None
    assert best_shardable_dim((2, 6), 4, set()) is None


def test_groups_shards_and_tensor_fragment(tmp_path):
    """A gloo world of 4, mesh expert 2 x data 2."""
    ranks = run_world(workers.zero_helpers_world, 4, tmp_path)
    for r, got in enumerate(ranks):
        e, d = divmod(r, 2)
        assert got["groups"] == {
            "dp": ("expert", "data"), "edp": "data", "ep": "expert", "mp": "tensor", "sp": "seq", "pp": "pipe",
            "dp_size": 4, "edp_size": 2, "ep_size": 2, "mp_size": 1, "sp_size": 1, "pp_size": 1,
            "dp_rank": r, "ep_rank": e, "edp_rank": d, "world": 4}
        for name, (whole, part, back) in got["shards"].items():
            np.testing.assert_array_equal(back, whole)
            assert part.shape != whole.shape or name == "whole"
        frag = got["fragment"]
        np.testing.assert_array_equal(frag["set_then_get"], frag["value"])
        assert frag["sharded"] and frag["shard_shape"] != frag["value"].shape
        np.testing.assert_array_equal(frag["exp_avg_sq"], ranks[0]["fragment"]["exp_avg_sq"])
        assert frag["exp_avg_sq"].shape == frag["value"].shape and frag["exp_avg_sq"].min() >= 0
        np.testing.assert_array_equal(frag["grad"], ranks[0]["fragment"]["grad"])
        assert frag["grad"].shape == frag["value"].shape and np.abs(frag["grad"]).max() > 0
        assert frag["no_grad_outside_facade"] is None


class _Clock:
    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        return self.t


def test_overlap_tracker_planted_spans(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(overlap, "time", clock)
    tr = overlap.CommOverlapTracker()
    # hidden: an async transfer issued at t=100, observed complete at t=102
    clock.t = 102.0
    tr.track_async("host_to_device", torch.zeros(4), t0=100.0)
    # exposed: a synchronous op the caller blocked on for 1 s
    with tr.track_host("barrier"):
        clock.t = 103.0
    st = tr.collect()
    assert st["ops"]["host_to_device"] == {"dispatch_s": 2.0, "exposed_s": 0.0, "realized_s": 2.0, "calls": 1}
    assert st["ops"]["barrier"] == {"dispatch_s": 1.0, "exposed_s": 1.0, "realized_s": 1.0, "calls": 1}
    assert st["overlap_efficiency"] == pytest.approx(1 - 1.0 / 3.0)
    assert tr.collect()["ops"] == {}  # drained
    # two overlapping spans of one op count their union once
    clock.t = 12.0
    tr.track_async("all_gather", None, t0=10.0)
    clock.t = 13.0
    tr.track_async("all_gather", None, t0=11.0)
    st = tr.collect()
    assert st["ops"]["all_gather"]["realized_s"] == pytest.approx(3.0)
    assert st["overlap_efficiency"] == 1.0
    assert overlap.get_overlap_tracker() is overlap.get_overlap_tracker()


def test_runtime_utils_norms():
    gen = torch.Generator().manual_seed(3)
    tree = {"a": torch.randn(3, 5, generator=gen), "b": [torch.randn(7, generator=gen)]}
    flat = torch.cat([tree["a"].reshape(-1), tree["b"][0]])
    want = float(torch.linalg.vector_norm(flat))
    assert rt_utils.get_grad_norm(tree) == pytest.approx(want, rel=1e-6)
    assert rt_utils.get_global_norm(norm_list=[3.0, 4.0]) == 5.0
    norm = rt_utils.clip_grad_norm_(tree, want / 2)
    assert norm == pytest.approx(want, rel=1e-6)
    assert rt_utils.get_grad_norm(tree) == pytest.approx(want / 2, rel=1e-5)
    rt_utils.see_memory_usage("zero test", force=True)
    rt_utils.empty_cache()
