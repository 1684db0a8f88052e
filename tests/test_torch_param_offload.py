"""ZeRO-Infinity parameter offload in the port
(``runtime/zero/param_offload.py`` over the model's streaming protocol)
against the JAX package's streamed step and the port's fused step: the
streamed step trains and matches both, the NVMe tier bitwise the host
tier, gradient accumulation, clipping and the fp16 loss scale, checkpoints
(with and without optimizer states, across tiers), ZeRO-Inference
``generate`` equal to dense greedy decoding, and the refusals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.comm import comm
from deepspeed_tpu.models import get_model as jax_get_model
from deepspeed_tpu_torch.models import get_model
from deepspeed_tpu_torch.models.convert import params_from_jax

from .torch_port_helpers import numpy_params, port_engine, to_numpy, token_batch

BASE = {"train_batch_size": 8, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
        "steps_per_print": 10**9}


def _cfg(device="cpu", tmp=None, **over):
    off = {"device": device}
    if device == "nvme":
        off["nvme_path"] = str(tmp)
    return {**BASE, "zero_optimization": {"stage": 3, "offload_param": off}, **over}


def _batch(bs=8, T=32, seed=0):
    return token_batch(seed, n=bs, T=T)


def _tree(name="tiny", seed=0):
    return numpy_params(jax_get_model(name, dtype=jnp.float32), seed)


def _losses(engine, steps, bs=8):
    return [float(engine.train_batch(batch=_batch(bs, seed=i % 2))) for i in range(steps)]


@pytest.mark.parametrize("name", ["tiny", "tiny-gpt2", "tiny-moe"])
def test_streamed_matches_jax_streamed_step(name):
    """Same weights and batches: losses within rtol 1e-4 of the JAX runner's
    over 3 steps, masters within 1e-5 (tied embeddings: both gradient
    sources summed). Adam's eps is 1e-6 here: at 1e-8 a gradient within
    rounding of zero and of eps (an embedding row no token uses) steps by
    the rounding's sign. Even so a rare element's gradient is within
    rounding of zero (a saturated SwiGLU unit): at most 1 in 1000 of a
    tensor may differ by more, each by at most its 3 steps of lr. The
    attention k bias's gradient is zero in exact arithmetic (softmax
    ignores a shift of a row's scores), so each side steps it by its
    rounding noise: it is held to 3 steps of lr alone."""
    tree = _tree(name)
    cfg = _cfg(optimizer={"type": "AdamW", "params": {"lr": 1e-3, "eps": 1e-6}})
    comm._state["mesh"] = None
    je, *_ = deepspeed_tpu.initialize(model=jax_get_model(name, dtype=jnp.float32), config=cfg, rng_seed=0)
    je.param_stream.set_params_from_tree(tree)
    want = _losses(je, 3)
    engine = port_engine(name, tree, cfg)
    got = _losses(engine, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    ref = params_from_jax(to_numpy(je.param_stream.get_params_tree()), engine.module.cfg)
    mine = engine.param_stream.get_params_tree()
    assert list(mine) == list(engine.module.param_shapes())
    for k in ref:
        diff = (mine[k] - ref[k]).abs()
        assert float(diff.max()) <= 3 * 1e-3 * (1 + 1e-6), k
        if not k.endswith("k_proj.bias"):
            assert int((diff > 1e-5).sum()) <= max(1, diff.numel() // 1000), (k, float(diff.max()))


@pytest.mark.parametrize("clip", [None, 1e6])
def test_streamed_matches_fused_step(clip):
    """One streamed step == one fused on-device AdamW step (a clip that never
    binds keeps the coefficient exactly 1)."""
    tree = _tree(seed=1)
    over = {} if clip is None else {"gradient_clipping": clip}
    fused = port_engine("tiny", tree, {**BASE, **over})
    streamed = port_engine("tiny", tree, _cfg(**over))
    b = _batch()
    l_f, l_s = float(fused.train_batch(batch=b)), float(streamed.train_batch(batch=b))
    assert abs(l_f - l_s) <= 1e-5 * abs(l_f)
    assert streamed._last_metrics["grad_norm"] == pytest.approx(fused._last_metrics["grad_norm"], rel=1e-5)
    mine = streamed.param_stream.get_params_tree()
    for k, v in fused.params.items():
        torch.testing.assert_close(mine[k], v.detach(), rtol=0, atol=1e-6)


def test_streaming_with_clipping_uses_the_previous_norm():
    """gas 1 with clipping applies each block as its gradient lands, clipped
    by the previous step's norm (step 1 unclipped), as the JAX runner does."""
    engine = port_engine("tiny", _tree(seed=2), _cfg(gradient_clipping=0.5))
    losses, coefs, norms = [], [], []
    for i in range(4):
        losses.append(float(engine.train_batch(batch=_batch(seed=i % 2))))
        coefs.append(engine._last_metrics["clip_coef"])
        norms.append(engine._last_metrics["grad_norm"])
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert coefs[0] == 1.0
    for prev, coef in zip(norms, coefs[1:]):
        assert coef == pytest.approx(min(1.0, 0.5 / (prev + 1e-6)))


def test_gradient_accumulation_is_the_exact_norm_step():
    """gas 2 (the buffered path): the exact norm and clip; the losses fall,
    and one step equals the fused engine's gas-2 step."""
    tree = _tree(seed=3)
    cfg = {"train_batch_size": 16, "gradient_accumulation_steps": 2, "gradient_clipping": 0.5}
    fused = port_engine("tiny", tree, {**BASE, **cfg})
    streamed = port_engine("tiny", tree, _cfg(**cfg))
    b = _batch(16)
    l_f, l_s = float(fused.train_batch(batch=b)), float(streamed.train_batch(batch=b))
    assert abs(l_f - l_s) <= 1e-5 * abs(l_f)
    assert streamed._last_metrics["clip_coef"] == pytest.approx(
        min(1.0, 0.5 / (fused._last_metrics["grad_norm"] + 1e-6)), rel=1e-5)
    mine = streamed.param_stream.get_params_tree()
    for k, v in fused.params.items():
        torch.testing.assert_close(mine[k], v.detach(), rtol=0, atol=1e-6)
    losses = [l_s] + [float(streamed.train_batch(batch=b)) for _ in range(2)]
    assert losses[-1] < losses[0]


def test_fp16_loss_scaled_streaming():
    engine = port_engine("tiny", _tree(seed=4), _cfg(fp16={"enabled": True, "initial_scale_power": 8}),
                         dtype=torch.float16)
    ps = engine.param_stream
    assert ps._fp16 and ps._scale == 2.0**8
    losses = _losses(engine, 4)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    ps._scale, ps._scale_dynamic = 2.0**40, True  # every block overflows: all skipped
    before = {n: ps.store.state(n)[0] for n in ps.store.blocks}
    engine.train_batch(batch=_batch())
    assert ps._scale < 2.0**40 and engine._last_metrics["overflow"]
    for n, b in before.items():
        assert torch.equal(ps.store.state(n)[0], b), n


def test_nvme_tier_bitwise_host_tier(tmp_path):
    """Losses and masters of the NVMe tier are bitwise the host tier's, on
    two runs."""
    tree = _tree(seed=5)
    host = port_engine("tiny", tree, _cfg(gradient_clipping=0.5))
    want = _losses(host, 3)
    ref = host.param_stream.state_tensors()
    for run in range(2):
        nv = port_engine("tiny", tree, _cfg("nvme", tmp_path / f"r{run}", gradient_clipping=0.5))
        assert _losses(nv, 3) == want
        got = nv.param_stream.state_tensors()
        for k in ref[0]:
            assert torch.equal(got[0][k], ref[0][k]), k
        assert all(torch.equal(a, b) for a, b in zip(got[1] + got[2], ref[1] + ref[2]))
        io = nv.param_stream.store.io_stats()
        assert io["bytes_read"] > 0 and io["bytes_written"] > 0


@pytest.mark.parametrize("src,dst", [("cpu", "cpu"), ("cpu", "nvme"), ("nvme", "cpu"), ("cpu", "none"),
                                     ("none", "cpu")])
def test_checkpoint_roundtrip_and_cross_tier(src, dst, tmp_path):
    def cfg(tier, tag):
        return BASE if tier == "none" else _cfg(tier, tmp_path / tag)
    a = port_engine("tiny", _tree(seed=6), cfg(src, "a"))
    _losses(a, 2)
    a.save_checkpoint(str(tmp_path / "ckpt"), tag="t1")
    want = _losses(a, 2)
    b = port_engine("tiny", _tree(seed=7), cfg(dst, "b"))
    load_dir, _ = b.load_checkpoint(str(tmp_path / "ckpt"))
    assert load_dir is not None and b.global_steps == 2
    got = _losses(b, 2)
    if (src == "none") == (dst == "none"):
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_load_checkpoint_without_optimizer_states(tmp_path):
    a = port_engine("tiny", _tree(seed=6), _cfg())
    _losses(a, 2)
    ref_eval = float(a.eval_batch(_batch()))
    a.save_checkpoint(str(tmp_path), tag="t1")
    b = port_engine("tiny", _tree(seed=7), _cfg())
    load_dir, _ = b.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    assert load_dir is not None and b.global_steps == 2 and b.param_stream.store.t == 0
    assert float(b.eval_batch(_batch())) == pytest.approx(ref_eval, abs=1e-6)
    for blk in b.param_stream.store.blocks.values():
        assert float(blk["m"].abs().max()) == 0.0 and float(blk["v"].abs().max()) == 0.0


@pytest.mark.parametrize("name,T", [("tiny", 8), ("tiny-gpt2", 8), ("tiny", 128)])
def test_zero_inference_generate_matches_dense(name, T):
    """Streamed greedy decode == the inference engine's generate() on the
    same weights (a 128-token prompt takes the flash prefill)."""
    kw = {"max_seq_len": 256} if T >= 128 else {}
    engine = port_engine(name, _tree(name, seed=8), _cfg(), **kw)
    params = engine.param_stream.get_params_tree()
    dense = deepspeed_tpu_torch.init_inference(get_model(name, dtype=torch.float32, attention_impl="flash", **kw),
                                               config={"dtype": "float32"}, params=params, device="cpu")
    ids = _batch(bs=2, T=T, seed=9)["input_ids"]
    out = engine.param_stream.generate(ids, max_new_tokens=5)
    assert out.shape == (2, T + 5) and np.array_equal(out[:, :T], ids)
    assert np.array_equal(out[:, T:], np.stack(dense.generate(ids, max_new_tokens=5)))
    with pytest.raises(ValueError, match="max_seq_len"):
        engine.param_stream.generate(ids, max_new_tokens=1000)


def test_eval_batch_matches_the_fused_loss():
    tree = _tree(seed=10)
    fused, streamed = port_engine("tiny", tree, BASE), port_engine("tiny", tree, _cfg())
    b = _batch()
    assert float(streamed.eval_batch(b)) == pytest.approx(float(fused.eval_batch(b)), rel=1e-6)


def test_blocks_initialize_from_the_seed_without_a_host_model():
    a = deepspeed_tpu_torch.initialize(model=get_model("tiny", dtype=torch.float32), config=_cfg(),
                                       device="cpu")[0]
    b = deepspeed_tpu_torch.initialize(model=get_model("tiny", dtype=torch.float32), config=_cfg(),
                                       device="cpu")[0]
    ta, tb = a.param_stream.get_params_tree(), b.param_stream.get_params_tree()
    assert all(torch.equal(ta[k], tb[k]) for k in ta)
    assert float(ta["layers.0.attn_norm.scale"].min()) == 1.0
    assert 0.015 < float(ta["layers.1.mlp.up_proj.kernel"].std()) < 0.025
    losses = _losses(a, 3)
    assert losses[-1] < losses[0]


def test_refusals():
    with pytest.raises(ValueError, match="stage 3"):
        deepspeed_tpu_torch.initialize(model=get_model("tiny"), device="cpu",
                                       config={**BASE, "zero_optimization": {"stage": 2, "offload_param":
                                                                             {"device": "cpu"}}})
    # stage 3 without offload_param trains on the device (runtime/zero/stage3.py)
    on_device, *_ = deepspeed_tpu_torch.initialize(model=get_model("tiny"), device="cpu",
                                                   config={**BASE, "zero_optimization": {"stage": 3}})
    assert on_device.param_stream is None and on_device._stage3 is not None
    with pytest.raises(ValueError, match="nvme_path"):
        deepspeed_tpu_torch.initialize(model=get_model("tiny"), device="cpu",
                                       config={**BASE, "zero_optimization": {"stage": 3, "offload_param":
                                                                             {"device": "nvme"}}})
    engine = port_engine("tiny", _tree(), _cfg())
    with pytest.raises(RuntimeError, match="offload_param"):
        engine.forward(_batch())


def test_offload_param_subsumes_offload_optimizer():
    engine = port_engine("tiny", _tree(), {**_cfg(), "zero_optimization": {
        "stage": 3, "offload_param": {"device": "cpu"}, "offload_optimizer": {"device": "cpu"}}})
    assert engine.param_stream is not None and engine.host_opt is None and not engine.offload_optimizer
