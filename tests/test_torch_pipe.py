"""Pipeline parallelism in one process: the port's ``runtime/pipe/module.py``
against the JAX package's (the same boundaries, owners and descriptions
for the same inputs), the config's pipe axis and ``pipeline`` section
against the JAX config and engine, the planner's pipe rule against the JAX
planner's stacked-dim spec, the model's stage split, and the schedules at
a group of one (JAX's ``_single_stage`` paths: no exchange) against a
sequential apply. Multi-rank worlds are in ``tests/test_torch_pipe_ranks.py``.
"""

import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.models as jm
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.pipe import module as jmod
from deepspeed_tpu.runtime.zero.sharding import ShardingPlanner as JaxPlanner, _path_str
from deepspeed_tpu_torch import comm as dist
from deepspeed_tpu_torch.models import get_model
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.runtime.pipe import module as pmod
from deepspeed_tpu_torch.runtime.pipe import schedule as sch
from deepspeed_tpu_torch.runtime.zero.sharding import ShardingPlanner
from deepspeed_tpu_torch.utils.logging import logger

AXES = ("pipe", "expert", "data", "seq", "tensor")


@pytest.mark.parametrize("n, parts", [(8, 4), (10, 4), (3, 5), (36, 2), (7, 3), (1, 1)])
def test_partition_uniform_matches_jax(n, parts):
    assert pmod.partition_uniform(n, parts) == jmod.partition_uniform(n, parts)


@pytest.mark.parametrize("weights, parts", [([1, 1, 1, 100, 1, 1, 1, 1], 2), ([5, 1, 1, 1, 1, 5], 3),
                                            ([1.5] * 36, 2), ([3, 1, 4, 1, 5, 9, 2, 6], 4), ([2, 2], 5),
                                            ([0.0, 1e-6, 1e-6, 1.0], 2)])
def test_partition_balanced_matches_jax(weights, parts):
    got = pmod.partition_balanced(weights, parts)
    assert got == jmod.partition_balanced(weights, parts)
    assert got[0] == 0 and got[-1] == len(weights) and len(got) == parts + 1


class _Toy:
    def __init__(self, n):
        self.n = n

    def num_params(self):
        return self.n


class Dense(_Toy):
    pass


class Norm(_Toy):
    pass


@pytest.mark.parametrize("method", ["uniform", "parameters", "type:dense", "type:Norm$"])
def test_pipeline_module_matches_jax(method):
    def specs(m):
        out = [m.LayerSpec(Dense, 10), m.LayerSpec(Norm, 1), m.LayerSpec(Dense, 1000), m.LayerSpec(Norm, 1),
               m.TiedLayerSpec("embed", Dense, 500), m.LayerSpec(Dense, 10), m.LayerSpec(Dense, 20)]
        out.append(lambda: None)  # a bare callable becomes a LayerSpec
        return out

    for stages in (1, 2, 3):
        ours, ref = (m.PipelineModule(specs(m), num_stages=stages, partition_method=method) for m in (pmod, jmod))
        assert ours.parts == ref.parts, (method, stages)
        assert ours.describe() == ref.describe()
        assert ours.tied_keys == ref.tied_keys == ["embed"]
        assert [ours.stage_owner(i) for i in range(8)] == [ref.stage_owner(i) for i in range(8)]
        assert [len(ours.stage_layers(s)) for s in range(stages)] == [len(ref.stage_layers(s)) for s in range(stages)]
    with pytest.raises(ValueError, match="Unknown partition_method"):
        pmod.PipelineModule(specs(pmod), num_stages=2, partition_method="zigzag")


def test_config_pipe_axis_and_schedule_section(caplog):
    # the pipe axis builds: data is what tensor x pipe x expert leave (the JAX rule)
    for kw, world in (({"pipeline_parallel_size": 2}, 2), ({"pipeline_parallel_size": 2, "tensor_parallel_size": 2},
                                                            8), ({"pipeline_parallel_size": 4}, 8)):
        cfg = {"train_batch_size": 16, "mesh": kw}
        ours, ref = DeepSpeedConfig(cfg, world_size=world), JaxConfig(dict(cfg, mesh=dict(kw)), world_size=world)
        assert ours.mesh.data_parallel_size == ref.mesh.data_parallel_size
        assert ours.train_micro_batch_size_per_gpu == ref.train_micro_batch_size_per_gpu
    for cfg, world in (({"train_batch_size": 16, "mesh": {"pipeline_parallel_size": 2}}, 3),
                       ({"train_batch_size": 16, "mesh": {"pipeline_parallel_size": 2, "expert_parallel_size": 2}},
                        2)):
        with pytest.raises(DeepSpeedConfigError) as ours:
            DeepSpeedConfig(cfg, world_size=world)
        with pytest.raises(Exception) as ref:
            JaxConfig({**cfg, "mesh": dict(cfg["mesh"])}, world_size=world)
        assert str(ours.value) == str(ref.value)
    # the sequence axis builds too (data = world / (tp x pp x sp))
    cfg = DeepSpeedConfig({"train_batch_size": 16, "mesh": {"sequence_parallel_size": 2}}, world_size=2)
    assert cfg.mesh.data_parallel_size == 1 and cfg.train_micro_batch_size_per_gpu == 16
    base = {"train_batch_size": 4}
    assert DeepSpeedConfig(base).pipeline_schedule() == "auto"
    for s in ("auto", "fill_drain", "1f1b"):
        assert DeepSpeedConfig({**base, "pipeline": {"schedule": s}}).pipeline_schedule() == s
    with pytest.raises(ValueError, match="pipeline.schedule must be 'auto', 'fill_drain' or '1f1b', got 'zigzag'"):
        DeepSpeedConfig({**base, "pipeline": {"schedule": "zigzag"}}).pipeline_schedule()
    logger.propagate = True
    try:
        with caplog.at_level(logging.WARNING, logger=logger.name):
            DeepSpeedConfig({**base, "pipeline": {"stages": 2, "partition_method": "uniform"}}).pipeline_schedule()
    finally:
        logger.propagate = False
    assert "['partition_method', 'stages'] are not consumed" in caplog.text


def _jax_shapes(model):
    out = {}
    jax.tree_util.tree_map_with_path(lambda p, leaf: out.__setitem__(_path_str(p), tuple(leaf.shape)),
                                     jax.eval_shape(model.init_params, jax.random.key(0)))
    return out


@pytest.mark.parametrize("layout", [{"pipe": 2}, {"pipe": 2, "data": 2}, {"pipe": 4, "expert": 2}])
def test_planner_pipe_rule_matches_jax(layout):
    """Each ``layers.{i}.*`` key lies whole on stage ``i // (L / S)`` with the
    JAX spec of its layer slice (the stacked dim's 'pipe' entry dropped);
    the embed and head are replicated over pipe."""
    name, L = "tiny-moe", 4
    jmodel = jm.get_model(name, dtype=jnp.float32, num_layers=L)
    port = get_model(name, dtype=torch.float32, num_layers=L)
    jshapes = _jax_shapes(jmodel)
    mesh = types.SimpleNamespace(shape={a: layout.get(a, 1) for a in AXES})
    S = layout["pipe"]
    for stage in range(4):
        zc = types.SimpleNamespace(stage=stage, stage3_param_persistence_threshold=0)
        jp = JaxPlanner(mesh, zc, tp_rules=jmodel.tp_rules(), expert_pattern=jmodel.expert_pattern(),
                        pipe_pattern=jmodel.pipeline_pattern())
        ours = ShardingPlanner(mesh.shape, zc, tp_rules=port.tp_rules(), expert_pattern=port.expert_pattern(),
                               pipe_pattern=port.pipeline_pattern(), num_layers=L)
        for key, (shape, _) in port.param_shapes().items():
            parts = key.split(".")
            if parts[0] != "layers":
                assert ours.pipe_stage(key) is None, key
                continue
            assert ours.pipe_stage(key) == int(parts[1]) // (L // S), key
            path = "/".join(["layers"] + parts[2:])
            if ".attn." in key and key.endswith("_proj.kernel"):
                continue  # q/k/v (H, heads x hd) vs the JAX (H, heads, hd): another layout
            want = tuple(tuple(e) if isinstance(e, list) else e for e in jp.master_spec(path, jshapes[path]))
            assert want[0] == "pipe" and ours.master_spec(key, shape) == want[1:], (key, stage)
    assert ShardingPlanner(mesh.shape, zc, pipe_pattern=port.pipeline_pattern(), num_layers=3).pipe_stage(
        "final_norm.scale") is None
    with pytest.raises(ValueError, match="do not split evenly"):
        ShardingPlanner(mesh.shape, zc, pipe_pattern=port.pipeline_pattern(), num_layers=3).pipe_stage(
            "layers.0.attn_norm.scale")


def test_model_stage_split():
    model = get_model("tiny", dtype=torch.float32, num_layers=4)
    assert model.pipeline_pattern() == r"^layers\.(\d+)\."
    assert [list(model.pipeline_layers(s, 2)) for s in range(2)] == [[0, 1], [2, 3]]
    assert [list(model.pipeline_layers(s, 4)) for s in range(4)] == [[0], [1], [2], [3]]
    with pytest.raises(ValueError, match="num_layers=4 does not split evenly over pipeline_parallel_size=3"):
        model.pipeline_layers(0, 3)


def test_schedules_at_a_group_of_one():
    """``pipe`` of 1: the stage runs alone, no exchange; both functional
    forms equal a sequential apply, and a ppermute returns its input."""
    assert not dist.is_initialized()
    rng = np.random.default_rng(3)
    w = [torch.from_numpy((rng.standard_normal((6, 6)) * 0.4).astype(np.float32)).requires_grad_(True)
         for _ in range(3)]
    xs = torch.from_numpy(rng.standard_normal((4, 2, 6)).astype(np.float32)).requires_grad_(True)

    def stage_fn(ws, h, m):
        for wi in ws:
            h = torch.tanh(h @ wi)
        return h

    ref = stage_fn(w, xs, None)
    g_ref = torch.autograd.grad((ref ** 2).sum(), w + [xs])
    out = sch.spmd_pipeline(stage_fn, w, xs)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), rtol=1e-6, atol=1e-6)
    for a, b in zip(torch.autograd.grad((out ** 2).sum(), w + [xs]), g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    loss, grads, head, dxs = sch.spmd_pipeline_1f1b(stage_fn, lambda hp, y, m: (y ** 2).sum(), w, [], xs.detach(),
                                                    loss_denom=2.0)
    np.testing.assert_allclose(float(loss), float((ref.detach() ** 2).sum() / 2), rtol=1e-6)
    for a, b in zip(grads + [dxs], g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy() / 2, rtol=1e-5, atol=1e-6)
    assert head == []
    x = torch.ones(3)
    assert dist.ppermute(x, [(0, 0)]) is x and dist.ppermute_autograd(x, [(0, 0)]) is x
    assert dist.send_recv_next(x) is x and dist.send_recv_prev(x) is x
    assert sch.num_pipeline_steps(4, 2) == 5
