"""The port's training stack against the JAX package, on the same numpy
inputs: ``DeepSpeedConfig`` (batch triples, error text, the sections it does
not run yet), every lr schedule, the AdamW update against ``optax.adamw``,
the dynamic loss scaler, and ``initialize`` → ``train_batch`` loss
trajectories on ``tiny`` and ``tiny-gpt2`` against ``deepspeed_tpu``'s
engine on the same weights; then the port's facade against its own fused
path.

The JAX engine runs on the conftest's 8-device CPU mesh (micro 1 x gas 2 x
dp 8 for a train batch of 16); the port runs micro 8 x gas 2 on one device,
the same mathematics. Everything is fp32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import get_model as jax_get_model
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.fp16.loss_scaler import DynamicLossScaler as JaxDynamicLossScaler
from deepspeed_tpu.runtime.lr_schedules import get_lr_schedule as jax_get_lr_schedule
from deepspeed_tpu_torch.models import get_model
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import DynamicLossScaler
from deepspeed_tpu_torch.runtime.lr_schedules import get_lr_schedule
from deepspeed_tpu_torch.runtime.optimizers import AdamW

from .torch_port_helpers import numpy_params, to_numpy

# ---------------------------------------------------------------------------
# config


@pytest.mark.parametrize("keys", [
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4},
    {"train_batch_size": 32, "gradient_accumulation_steps": 4},
    {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 3},
    {"train_batch_size": 12},
    {"train_micro_batch_size_per_gpu": 5},
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 4},
])
def test_batch_triple_matches_jax(keys):
    ours, ref = DeepSpeedConfig(dict(keys)), JaxConfig(dict(keys), world_size=1)
    for name in ("train_batch_size", "train_micro_batch_size_per_gpu", "gradient_accumulation_steps"):
        assert getattr(ours, name) == getattr(ref, name), name


@pytest.mark.parametrize("keys", [
    {},  # no batch key
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 3},
    {"train_batch_size": 8, "fp16": {"enabled": True, "bogus_key": 1}},
    {"train_batch_size": 8, "optimizer": {"type": "AdamW", "parms": {}}},
    {"train_batch_size": 8, "bf16": True},
    {"train_batch_size": 8, "fp16": {"enabled": True}, "bf16": {"enabled": True}},
])
def test_bad_keys_raise_the_jax_error_text(keys):
    with pytest.raises(Exception) as ref:
        JaxConfig(dict(keys), world_size=1)
    with pytest.raises(Exception) as ours:
        DeepSpeedConfig(dict(keys))
    assert type(ours.value).__name__ == type(ref.value).__name__
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("section", [
    {"nebula": {"enabled": True}},
    {"elasticity": {"enabled": True}},
    {"curriculum_learning": {"enabled": True}},
    {"progressive_layer_drop": {"enabled": True, "theta": 0.5}},
    {"data_efficiency": {"enabled": True}},
    {"hybrid_engine": {"enabled": True}},
    {"eigenvalue": {"enabled": True}},
    {"flops_profiler": {"enabled": True}},
    {"compression_training": {"enabled": True}},
])
def test_sections_not_ported_raise(section):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        DeepSpeedConfig({"train_batch_size": 4, **section})


@pytest.mark.parametrize("section", [{"telemetry": {"enabled": True, "output_path": "tel"}},
                                     {"tensorboard": {"enabled": True}},
                                     {"csv_monitor": {"enabled": True, "output_path": "csv"}},
                                     {"wandb": {"enabled": True, "project": "p"}}])
def test_telemetry_and_monitor_sections_build(section):
    """The telemetry section and the three monitor backends build (ROADMAP
    Queue 1 #6 is ported); the engines wire them (test_torch_telemetry.py)."""
    cfg = DeepSpeedConfig({"train_batch_size": 4, **section})
    (key, val), = section.items()
    assert getattr(cfg, key).enabled
    if "output_path" in val:
        assert getattr(cfg, key).output_path == val["output_path"]


def test_disabled_sections_and_dtypes():
    cfg = DeepSpeedConfig({"train_batch_size": 4, "telemetry": {}, "bf16": {"enabled": True},
                           "curriculum_learning": {"enabled": False}, "steps_per_print": 10**9})
    assert cfg.compute_dtype == torch.bfloat16
    assert DeepSpeedConfig({"train_batch_size": 4, "fp16": {"enabled": True}}).compute_dtype == torch.float16
    assert DeepSpeedConfig({"train_batch_size": 4}).compute_dtype == torch.float32


def test_engine_refuses_what_it_does_not_run():
    model = get_model("tiny", dtype=torch.float32)
    base = {"train_batch_size": 4}
    # ZeRO stages 1-3, the tensor, pipe and sequence axes train (tests/test_torch_zero_ranks.py,
    # tests/test_torch_tp_ranks.py, tests/test_torch_pipe_ranks.py, tests/test_torch_seq_ranks.py);
    # each needs a world it divides
    for extra, err, item in (({"mesh": {"pipeline_parallel_size": 2}}, DeepSpeedConfigError, "tp\\*pp\\*sp = 2"),
                             ({"mesh": {"sequence_parallel_size": 2}}, DeepSpeedConfigError, "tp\\*pp\\*sp = 2"),
                             # offload_param requires stage 3 (the JAX engine's error text)
                             ({"zero_optimization": {"stage": 2, "offload_param": {"device": "cpu"}}},
                              ValueError, "stage 3"),
                             ({"pipeline": {"schedule": "zigzag"}}, ValueError, "pipeline.schedule"),
                             ({"optimizer": {"type": "OneBitAdam"}}, NotImplementedError, "#10"),
                             ({"optimizer": {"type": "OneBitLamb"}}, NotImplementedError, "#10")):
        with pytest.raises(err, match=item):
            deepspeed_tpu_torch.initialize(model=model, config={**base, **extra}, device="cpu")
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=base, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #10"):
        engine.deepspeed_io("unused")


def test_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None takes it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.initialize(model=get_model("tiny"), config={"train_batch_size": 4})


# ---------------------------------------------------------------------------
# schedules, optimizer, loss scaler

SCHEDULES = [
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3, "warmup_num_steps": 20}),
    ("WarmupLR", {"warmup_max_lr": 2e-3, "warmup_num_steps": 30, "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 40, "warmup_max_lr": 1e-3, "warmup_num_steps": 10}),
    ("WarmupCosineLR", {"total_num_steps": 45, "warmup_num_steps": 10, "warmup_min_ratio": 0.1,
                        "cos_min_ratio": 0.01, "warmup_max_lr": 3e-4}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3, "cycle_first_step_size": 15,
                  "cycle_second_step_size": 20, "decay_step_size": 5, "decay_lr_rate": 0.1}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 7,
                     "lr_range_test_step_rate": 0.5, "lr_range_test_staircase": True}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 7}),
]


@pytest.mark.parametrize("name,params", SCHEDULES, ids=lambda x: x if isinstance(x, str) else "")
def test_lr_schedules_match_jax(name, params):
    ours, ref = get_lr_schedule(name, dict(params)), jax_get_lr_schedule(name, dict(params))
    steps = np.arange(50, dtype=np.float32)
    want = np.asarray([float(ref(jnp.asarray(s))) for s in steps])
    got = np.asarray([ours(float(s)) for s in steps])
    # the JAX schedules compute in fp32, the port's in Python floats
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_adamw_matches_optax():
    rng = np.random.default_rng(0)
    shapes = [(5, 3), (7, ), (2, 2, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(6)]
    lrs = [1e-3 * (1 + i) for i in range(6)]
    tx = optax.adamw(lambda n: jnp.asarray(lrs)[n], b1=0.8, b2=0.95, eps=1e-6, weight_decay=0.1)
    p_ref = [jnp.asarray(p) for p in params]
    state = tx.init(p_ref)
    opt_params = [torch.from_numpy(p.copy()) for p in params]
    opt = AdamW(opt_params, b1=0.8, b2=0.95, eps=1e-6, weight_decay=0.1)
    for g, lr in zip(grads, lrs):
        upd, state = tx.update([jnp.asarray(x) for x in g], state, p_ref)
        p_ref = optax.apply_updates(p_ref, upd)
        opt.step(opt_params, [torch.from_numpy(x) for x in g], lr)
    assert opt.count == 6
    for a, b in zip(opt_params, p_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_dynamic_loss_scaler_matches_jax():
    kw = dict(init_scale=2**8, scale_window=3, min_scale=2.0, delayed_shift=2)
    ours, ref = DynamicLossScaler(**kw), JaxDynamicLossScaler(**kw)
    s, r = ours.init_state(), ref.init_state()
    for overflow in [False, False, False, True, True, False, True, True, True, False, False, False]:
        s, r = ours.update(s, overflow), ref.update(r, jnp.asarray(overflow))
        assert (s.cur_scale, s.cur_hysteresis, s.last_overflow_iter, s.iteration) == \
            (float(r.cur_scale), int(r.cur_hysteresis), int(r.last_overflow_iter), int(r.iteration))


# ---------------------------------------------------------------------------
# the engine

TRAIN_CONFIG = {
    "train_batch_size": 16,
    "gradient_accumulation_steps": 2,
    "gradient_clipping": 1.0,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3,
                                                 "warmup_num_steps": 3}},
    "steps_per_print": 10**9,
}


def _batch(seed, n=16, T=128):
    return {"input_ids": np.random.default_rng(seed).integers(0, 256, (n, T)).astype(np.int32)}


def _port_engine(name, tree, config=TRAIN_CONFIG, dtype=torch.float32):
    model = get_model(name, dtype=dtype, attention_impl="flash")
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params_from_jax(to_numpy(tree), model.cfg), config=dict(config),
        device="cpu")
    return engine


@pytest.mark.parametrize("name", ["tiny", "tiny-gpt2"])
def test_loss_trajectory_matches_jax(name):
    jm = jax_get_model(name, dtype=jnp.float32, attention_impl="flash")
    tree = numpy_params(jm, 0)
    batch = _batch(1)
    je, *_ = deepspeed_tpu.initialize(model=jm, model_parameters=jax.tree_util.tree_map(jnp.asarray, tree),
                                      config=dict(TRAIN_CONFIG))
    want = [float(je.train_batch(batch=batch)) for _ in range(4)]
    engine = _port_engine(name, tree)
    got = [float(engine.train_batch(batch=batch)) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    assert engine.global_steps == 4 and engine.step_count == 4 and engine.skipped_steps == 0
    assert engine.get_lr() == pytest.approx(je.get_lr(), rel=1e-6)


def test_facade_matches_fused():
    """forward/backward/step over the gas microbatches == train_batch."""
    tree = numpy_params(jax_get_model("tiny", dtype=jnp.float32), 2)
    fused_engine, facade_engine = _port_engine("tiny", tree), _port_engine("tiny", tree)
    gas, micro = facade_engine.gradient_accumulation_steps(), facade_engine.train_micro_batch_size_per_gpu()
    fused, facade = [], []
    for i in range(3):
        batch = _batch(100 + i % 2)
        fused.append(float(fused_engine.train_batch(batch=batch)))
        losses = []
        for g in range(gas):
            loss = facade_engine.forward({"input_ids": batch["input_ids"][g * micro:(g + 1) * micro]})
            facade_engine.backward(loss)
            assert facade_engine.is_gradient_accumulation_boundary() == (g == gas - 1)
            losses.append(float(loss))
        facade_engine.step()
        facade.append(float(np.mean(losses)))
    np.testing.assert_allclose(facade, fused, rtol=2e-6)
    for k, v in fused_engine.params.items():
        torch.testing.assert_close(facade_engine.params[k], v, rtol=1e-6, atol=1e-7)


def test_bf16_training_on_the_host():
    """bf16 compute over fp32 master weights and moments: the loss falls
    and the master tensors stay fp32."""
    tree = numpy_params(jax_get_model("tiny-gpt2", dtype=jnp.float32), 4)
    engine = _port_engine("tiny-gpt2", tree, {**TRAIN_CONFIG, "bf16": {"enabled": True}},
                          dtype=torch.bfloat16)
    batch = _batch(5)
    losses = [float(engine.train_batch(batch=batch)) for _ in range(4)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert all(v.dtype == torch.float32 for v in engine.params.values())
    assert all(m.dtype == torch.float32 for m in engine.optimizer.mu)
    ev = engine.eval_batch({"input_ids": batch["input_ids"][:4]})
    assert ev.dtype == torch.float32 and bool(torch.isfinite(ev))
