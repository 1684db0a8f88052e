"""Dropout in the port's training path. JAX's ``jax.random`` bits cannot be
reproduced in PyTorch, so dropout is held to flax through the mask: flax's
``nn.Dropout`` runs with a key, its mask is read off its output, and the
port's dropout with that mask must give flax's output bitwise. The port's
own masks come from a counter hash: the keep fraction, masks that differ
by layer, site, micro-step and step, eval equal to rate 0, bitwise repeats
from one seed, remat on and off bitwise with dropout on, facade == fused,
and ``generate()`` untouched."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import get_model as jax_get_model
from deepspeed_tpu_torch.models import get_model
from deepspeed_tpu_torch.models.transformer import dropout_apply, dropout_mask
from deepspeed_tpu_torch.utils.counter_hash import fold_in, seed_key

from .torch_port_helpers import RECOMPUTE_ATTN, loss_and_grads, numpy_params, port_engine, token_batch

CONFIG = {
    "train_batch_size": 16,
    "gradient_accumulation_steps": 2,
    "gradient_clipping": 1.0,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "steps_per_print": 10**9,
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.5, 1.0])
def test_dropout_with_flax_mask_is_flax_output(dtype, rate):
    x = np.random.default_rng(0).standard_normal((4, 32, 64)).astype(np.float32)
    x[np.abs(x) < 1e-3] = 1.0  # no zero input, so the output shows the mask
    xj = jnp.asarray(x, dtype=dtype)
    want = nn.Dropout(rate=rate).apply({}, xj, deterministic=False, rngs={"dropout": jax.random.key(7)})
    want = np.asarray(want.astype(jnp.float32))
    keep = torch.from_numpy(want != 0)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = dropout_apply(xt, keep, rate).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_keep_fraction_within_4_sigma(rate):
    shape = (4, 256, 256)
    n = int(np.prod(shape))
    kept = int(dropout_mask(seed_key(11), shape, rate, "cpu").sum())
    p = 1.0 - rate
    assert abs(kept - n * p) <= 4 * np.sqrt(n * p * (1 - p))


def _site_key(seed, step, micro, layer, site):
    return fold_in(fold_in(fold_in(fold_in(seed_key(seed), step), micro), layer), site)


def test_masks_differ_by_layer_site_micro_step_and_step():
    base = (1234, 3, 1, 2, 0)
    variants = [base, (1235, 3, 1, 2, 0), (1234, 4, 1, 2, 0), (1234, 3, 0, 2, 0), (1234, 3, 1, 1, 0),
                (1234, 3, 1, 2, 1)]
    masks = [dropout_mask(_site_key(*v), (8, 128, 64), 0.1, "cpu") for v in variants]
    for i in range(len(masks)):
        for j in range(i):
            differ = float((masks[i] != masks[j]).float().mean())
            assert 0.1 < differ < 0.25, (variants[i], variants[j], differ)  # ~2 p (1 - p) = 0.18
    assert torch.equal(dropout_mask(_site_key(*base), (8, 128, 64), 0.1, "cpu"), masks[0])


def test_eval_equals_rate_zero():
    tree = numpy_params(jax_get_model("tiny", dtype=jnp.float32), 0)
    drop = port_engine("tiny", tree, CONFIG, dropout=0.1)
    plain = port_engine("tiny", tree, CONFIG)
    batch = {"input_ids": token_batch(2)["input_ids"][:4]}
    assert torch.equal(drop.eval_batch(batch), plain.eval_batch(batch))
    model, params = drop.module, {k: v.detach() for k, v in drop.params.items()}
    ids = {"input_ids": torch.from_numpy(batch["input_ids"]).long()}
    no_key = model.loss(params, ids)
    assert torch.equal(no_key, plain.module.loss(params, ids))
    assert not torch.equal(model.loss(params, ids, rng=seed_key(5)), no_key)


def test_same_seed_gives_bitwise_losses():
    tree = numpy_params(jax_get_model("tiny", dtype=jnp.float32), 1)
    batch = token_batch(3)

    def losses(seed):
        engine = port_engine("tiny", tree, {**CONFIG, "seed": seed}, dropout=0.1)
        return [float(engine.train_batch(batch=batch)) for _ in range(3)]

    a, b = losses(7), losses(7)
    assert a == b
    assert losses(8) != a


@pytest.mark.parametrize("policy", ["nothing_saveable", "dots_saveable", "dots_and_attn_saveable"])
def test_remat_gradients_bitwise_with_dropout(policy):
    key = seed_key(99)
    loss0, g0, _ = loss_and_grads("tiny-gpt2", None, rng=key, dropout=0.1)
    loss, g, calls = loss_and_grads("tiny-gpt2", policy, rng=key, dropout=0.1)
    assert torch.equal(loss, loss0)
    for a, b in zip(g, g0):
        assert torch.equal(a, b)
    assert calls["fwd"] == (4 if policy in RECOMPUTE_ATTN else 2)
    drop0, _, _ = loss_and_grads("tiny-gpt2", None, rng=None, dropout=0.1)
    assert not torch.equal(loss0, drop0)


def test_facade_matches_fused_with_dropout():
    tree = numpy_params(jax_get_model("tiny", dtype=jnp.float32), 2)
    fused_engine = port_engine("tiny", tree, CONFIG, dropout=0.1)
    facade_engine = port_engine("tiny", tree, CONFIG, dropout=0.1)
    gas, micro = facade_engine.gradient_accumulation_steps(), facade_engine.train_micro_batch_size_per_gpu()
    fused, facade = [], []
    for i in range(3):
        batch = token_batch(100 + i % 2)
        fused.append(float(fused_engine.train_batch(batch=batch)))
        losses = []
        for g in range(gas):
            loss = facade_engine.forward({"input_ids": batch["input_ids"][g * micro:(g + 1) * micro]})
            facade_engine.backward(loss)
            losses.append(float(loss))
        facade_engine.step()
        facade.append(float(np.mean(losses)))
    np.testing.assert_allclose(facade, fused, rtol=2e-6)
    for k, v in fused_engine.params.items():
        torch.testing.assert_close(facade_engine.params[k], v, rtol=1e-6, atol=1e-7)


def test_generate_ignores_dropout():
    model = get_model("tiny", dtype=torch.float32, dropout=0.1)
    params = model.init_params(4)
    rows = [[5, 6, 7, 8], [9, 10, 11, 12]]
    outs = []
    for m in (model, get_model("tiny", dtype=torch.float32)):
        eng = deepspeed_tpu_torch.init_inference(m, config={"dtype": "float32"}, params=params, device="cpu")
        outs.append(np.asarray(eng.generate(rows, max_new_tokens=6)))
    again = deepspeed_tpu_torch.init_inference(model, config={"dtype": "float32"}, params=params,
                                               device="cpu").generate(rows, max_new_tokens=6)
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], np.asarray(again))
