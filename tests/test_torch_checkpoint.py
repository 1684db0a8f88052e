"""Checkpoints of the port's training engine and the ZeRO checkpoint
readers: 2 steps, save, load into a fresh engine, 2 more steps bitwise the
4 uninterrupted ones (fused path, after facade use, fp16 with a dynamic
loss scale, a schedule, other optimizers, dropout with remat); the JAX
engine's save/load/resume losses against the port's; the load options;
async save then ``wait_checkpoint_saves``; ``latest``, a missing
checkpoint and ``weights_only`` loads; ``save_16bit_model``; and the
``zero_checkpoint`` readers bitwise JAX's on the committed reference
fixture and on ``tests/unit/test_checkpoint_import.py``'s stage-2/3 and
universal writers."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import checkpoint as jax_ckpt
from deepspeed_tpu.comm import comm
from deepspeed_tpu.models import get_model as jax_get_model
from deepspeed_tpu_torch import checkpoint as port_ckpt

from .torch_port_helpers import jax_engine, numpy_params, port_engine, token_batch
from .unit.test_checkpoint_import import _tiny_gpt2, _write_zero2_checkpoint, _write_zero3_checkpoint

CONFIG = {
    "train_batch_size": 16,
    "gradient_accumulation_steps": 2,
    "gradient_clipping": 1.0,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "steps_per_print": 10**9,
}
CASES = {
    "fused": ({}, {}),
    "facade": ({}, {}),
    "fp16_dynamic": ({"fp16": {"enabled": True, "initial_scale_power": 20, "loss_scale_window": 2,
                               "hysteresis": 1}}, {"dtype": torch.float16}),
    "schedule": ({"scheduler": {"type": "WarmupDecayLR", "params": {"total_num_steps": 10,
                                                                    "warmup_max_lr": 1e-3,
                                                                    "warmup_num_steps": 3}}}, {}),
    "lamb": ({"optimizer": {"type": "Lamb", "params": {"lr": 1e-3, "weight_decay": 0.01}}}, {}),
    "lion": ({"optimizer": {"type": "Lion", "params": {"lr": 1e-4}}}, {}),
    "dropout_remat": ({"activation_checkpointing": {"policy": "dots_saveable"}}, {"dropout": 0.1}),
}


def _batches():
    return [token_batch(10 + i) for i in range(4)]


def _step(engine, batch, facade=False):
    if not facade:
        return float(engine.train_batch(batch=batch))
    gas, micro = engine.gradient_accumulation_steps(), engine.train_micro_batch_size_per_gpu()
    losses = []
    for g in range(gas):
        loss = engine.forward({"input_ids": batch["input_ids"][g * micro:(g + 1) * micro]})
        engine.backward(loss)
        losses.append(float(loss))
    engine.step()
    return float(np.mean(losses))


@pytest.mark.parametrize("case", list(CASES))
def test_resume_is_bitwise(case, tmp_path):
    extra, model_kw = CASES[case]
    cfg = {**CONFIG, **extra}
    tree = numpy_params(jax_get_model("tiny", dtype=jnp.float32), 0)
    batches = _batches()
    facade = case == "facade"
    engine = port_engine("tiny", tree, cfg, **model_kw)
    losses = [_step(engine, b, facade) for b in batches[:2]]
    if facade:  # a half-accumulated micro-step is in flight: it is not saved
        engine.forward({"input_ids": batches[2]["input_ids"][:8]})
    engine.save_checkpoint(str(tmp_path), client_state={"note": case})
    engine.zero_grad()
    losses += [_step(engine, b) for b in batches[2:]]

    fresh = port_engine("tiny", numpy_params(jax_get_model("tiny", dtype=jnp.float32), 1), cfg, **model_kw)
    path, client_sd = fresh.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path) and client_sd["note"] == case
    assert fresh.global_steps == 2
    resumed = [_step(fresh, b) for b in batches[2:]]
    assert resumed == losses[2:], (resumed, losses)
    for k, v in engine.params.items():
        assert torch.equal(fresh.params[k], v), k
    assert (fresh.step_count, fresh.skipped_steps, fresh.global_steps, fresh.global_samples) == \
        (engine.step_count, engine.skipped_steps, engine.global_steps, engine.global_samples)
    assert fresh.loss_scale_state == engine.loss_scale_state
    if case == "fp16_dynamic":
        assert engine.skipped_steps > 0  # the scale started high enough to overflow
    if case == "schedule":
        assert fresh.lr_scheduler.state_dict() == engine.lr_scheduler.state_dict()


def test_resume_matches_jax(tmp_path):
    tree = numpy_params(jax_get_model("tiny", dtype=jnp.float32), 0)
    batches = _batches()

    def run(make, d):
        engine = make(tree)
        first = [float(engine.train_batch(batch=b)) for b in batches[:2]]
        engine.save_checkpoint(str(d))
        fresh = make(numpy_params(jax_get_model("tiny", dtype=jnp.float32), 1))
        _, client_sd = fresh.load_checkpoint(str(d))
        assert client_sd["global_steps"] == 2 and fresh.global_steps == 2
        return first + [float(fresh.train_batch(batch=b)) for b in batches[2:]]

    def make_jax(t):
        comm._state["mesh"] = None
        return jax_engine("tiny", t, CONFIG)

    want = run(make_jax, tmp_path / "jax")
    got = run(lambda t: port_engine("tiny", t, CONFIG), tmp_path / "port")
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("how", ["no_optimizer_states", "module_only", "no_lr_scheduler_states"])
def test_load_options(how, tmp_path):
    cfg = {**CONFIG, "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 5}}}
    tree = numpy_params(jax_get_model("tiny", dtype=jnp.float32), 0)
    engine = port_engine("tiny", tree, cfg)
    for b in _batches()[:2]:
        engine.train_batch(batch=b)
    engine.save_checkpoint(str(tmp_path), tag="t2")
    fresh = port_engine("tiny", numpy_params(jax_get_model("tiny", dtype=jnp.float32), 1), cfg)
    kw = {"no_optimizer_states": {"load_optimizer_states": False}, "module_only": {"load_module_only": True},
          "no_lr_scheduler_states": {"load_lr_scheduler_states": False}}[how]
    fresh.load_checkpoint(str(tmp_path), tag="t2", **kw)
    for k, v in engine.params.items():
        assert torch.equal(fresh.params[k], v)
    assert fresh.step_count == 2 and fresh.global_steps == 2
    loaded_opt = how == "no_lr_scheduler_states"
    assert fresh.optimizer.count == (2 if loaded_opt else 0)
    assert all(bool((m == 0).all()) != loaded_opt for m in fresh.optimizer.mu)
    want_sched = 2 if how != "no_lr_scheduler_states" else -1
    assert fresh.lr_scheduler.last_batch_iteration == want_sched


def test_async_save_then_wait(tmp_path):
    cfg = {**CONFIG, "checkpoint": {"async_save": True}}
    tree = numpy_params(jax_get_model("tiny", dtype=jnp.float32), 0)
    batches = _batches()
    engine = port_engine("tiny", tree, cfg)
    for b in batches[:2]:
        engine.train_batch(batch=b)
    at_save = {k: v.detach().clone() for k, v in engine.params.items()}
    engine.save_checkpoint(str(tmp_path), tag="a2")
    for b in batches[2:]:  # steps that change the master while the file may still be written
        engine.train_batch(batch=b)
    engine.wait_checkpoint_saves()
    with open(tmp_path / "latest") as f:
        assert f.read() == "a2"
    fresh = port_engine("tiny", numpy_params(jax_get_model("tiny", dtype=jnp.float32), 1), cfg)
    fresh.load_checkpoint(str(tmp_path))
    for k, v in at_save.items():
        assert torch.equal(fresh.params[k], v)


def test_latest_missing_and_weights_only(tmp_path):
    tree = numpy_params(jax_get_model("tiny", dtype=jnp.float32), 0)
    engine = port_engine("tiny", tree, CONFIG)
    assert engine.load_checkpoint(str(tmp_path / "nowhere")) == (None, None)
    engine.train_batch(batch=_batches()[0])
    engine.save_checkpoint(str(tmp_path))
    engine.save_checkpoint(str(tmp_path), tag="other", save_latest=False)
    with open(tmp_path / "latest") as f:
        assert f.read() == "global_step1"
    assert engine.load_checkpoint(str(tmp_path), tag="global_step9") == (None, None)
    state = torch.load(tmp_path / "global_step1" / "state" / "state.pt", weights_only=True)
    assert set(state) == {"master", "optimizer", "loss_scale", "step_count", "skipped_steps"}
    assert all(v.device.type == "cpu" for v in state["master"].values())
    with open(tmp_path / "global_step1" / "client_sd.json") as f:
        client_sd = json.load(f)
    assert client_sd["ds_config"] == CONFIG and client_sd["world_size"] == 1
    client_sd["world_size"] = 2
    with open(tmp_path / "global_step1" / "client_sd.json", "w") as f:
        json.dump(client_sd, f)
    with pytest.raises(NotImplementedError, match="#9"):
        engine.load_checkpoint(str(tmp_path))


def test_save_16bit_model(tmp_path):
    tree = numpy_params(jax_get_model("tiny-gpt2", dtype=jnp.float32), 0)
    engine = port_engine("tiny-gpt2", tree, {**CONFIG, "bf16": {"enabled": True}}, dtype=torch.bfloat16)
    engine.train_batch(batch=_batches()[0])
    path = engine.save_16bit_model(str(tmp_path))
    assert os.path.basename(path) == "pytorch_model.bin"
    sd = torch.load(path, weights_only=True)
    assert set(sd) == set(engine.params)
    for k, v in engine.params.items():
        assert sd[k].dtype == torch.bfloat16 and torch.equal(sd[k], v.detach().to(torch.bfloat16))


def _same(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_zero_reader_on_the_committed_fixture():
    fix = os.path.join(os.path.dirname(__file__), "fixtures", "reference_zero2")
    _same(port_ckpt.get_fp32_state_dict_from_zero_checkpoint(fix),
          jax_ckpt.get_fp32_state_dict_from_zero_checkpoint(fix))


@pytest.mark.parametrize("writer", [_write_zero2_checkpoint, _write_zero3_checkpoint])
def test_zero_reader_matches_jax(writer, tmp_path):
    model, _ = _tiny_gpt2()
    writer(str(tmp_path / "global_step5"), model)
    with open(tmp_path / "latest", "w") as f:
        f.write("global_step5")
    _same(port_ckpt.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path)),
          jax_ckpt.get_fp32_state_dict_from_zero_checkpoint(str(tmp_path)))


def test_universal_reader_matches_jax(tmp_path):
    model, _ = _tiny_gpt2()
    for n, p in model.named_parameters():
        d = tmp_path / "global_step3" / "zero" / n
        os.makedirs(d, exist_ok=True)
        torch.save(p.detach().float(), d / "fp32.pt")
    _same(port_ckpt.load_universal_checkpoint_params(str(tmp_path), tag="global_step3"),
          jax_ckpt.load_universal_checkpoint_params(str(tmp_path), tag="global_step3"))


@pytest.mark.parametrize("fn,args", [("load_megatron_3d_state_dict", ("d", )),
                                     ("megatron_3d_checkpoint_to_params", ("d", None)),
                                     ("export_reference_fp32", ({}, None, "out")),
                                     ("reference_checkpoint_to_params", ("d", None))])
def test_policy_readers_raise(fn, args):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #10, module_inject"):
        getattr(port_ckpt, fn)(*args)
