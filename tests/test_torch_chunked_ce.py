"""The port's chunked cross entropy and training loss against the JAX
package, on the same numpy inputs: ``chunked_cross_entropy``'s value and its
(hidden, w) gradients against ``jax.vjp`` of the JAX function, tied
(``transpose``) and untied, with a ragged last chunk and ignored positions;
and ``CausalLMModel.loss`` with its parameter gradients against
``jax.value_and_grad`` of the JAX model's ``loss`` on ``tiny`` and
``tiny-gpt2`` (chunked and dense CE, flash attention)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import get_model as jax_get_model
from deepspeed_tpu.models.transformer import chunked_cross_entropy as jax_chunked_ce
from deepspeed_tpu_torch.models import get_model
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.transformer import chunked_cross_entropy

from .torch_port_helpers import numpy_params, to_numpy


@pytest.mark.parametrize("transpose", [True, False])
def test_chunked_ce_matches_jax(transpose):
    B, T, H, V, chunk = 2, 40, 16, 96, 16  # 40 = 2 full chunks + 8
    rng = np.random.default_rng(7 + transpose)
    hidden = rng.standard_normal((B, T, H)).astype(np.float32)
    w = (0.5 * rng.standard_normal((V, H) if transpose else (H, V))).astype(np.float32)
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    valid = rng.random((B, T)) > 0.2

    def jax_fn(h, w):
        return jax_chunked_ce(h, w, jnp.asarray(labels), jnp.asarray(valid), chunk=chunk,
                              transpose=transpose)

    ref, vjp = jax.vjp(jax_fn, jnp.asarray(hidden), jnp.asarray(w))
    ref_dh, ref_dw = vjp(jnp.asarray(0.7, jnp.float32))

    ht, wt = torch.from_numpy(hidden).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    total = chunked_cross_entropy(ht, wt, torch.from_numpy(labels), torch.from_numpy(valid),
                                  chunk=chunk, transpose=transpose)
    (total * 0.7).backward()
    # fp32 throughout; sums of ~60 CE terms of O(5) and matmul gradients in
    # other orders: a few ulps
    np.testing.assert_allclose(float(total.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(ref_dh), atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(ref_dw), atol=1e-5)


# ce_chunk_size 32 takes the chunked CE below the 4096-vocab threshold
# (tied head for tiny-gpt2, untied lm_head for tiny); 0 the dense CE
@pytest.mark.parametrize("name,chunk", [("tiny", 32), ("tiny-gpt2", 32), ("tiny-gpt2", 0)])
def test_model_loss_and_grads_match_jax(name, chunk):
    jm = jax_get_model(name, dtype=jnp.float32, attention_impl="flash", ce_chunk_size=chunk)
    tree = numpy_params(jm, 11)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 256, (2, 128)).astype(np.int32)
    labels = np.where(rng.random((2, 128)) < 0.1, -100, rng.integers(0, 256, (2, 128))).astype(np.int32)
    batch = {"input_ids": ids, "labels": labels}
    ref, ref_g = jax.value_and_grad(jm.loss)(jax.tree_util.tree_map(jnp.asarray, tree),
                                             jax.tree_util.tree_map(jnp.asarray, batch), None)

    tm = get_model(name, dtype=torch.float32, attention_impl="flash", ce_chunk_size=chunk)
    params = {k: v.requires_grad_(True) for k, v in params_from_jax(tree, tm.cfg).items()}
    loss = tm.loss(params, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    loss.backward()
    want = params_from_jax(to_numpy(ref_g), tm.cfg)
    # fp32 forward and backward through 2 layers; relative to each
    # gradient's largest entry, floored at 1% of the tree's largest: the k
    # bias gradient is zero in exact arithmetic (softmax is shift-invariant
    # per row), so both sides hold rounding noise there
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    floor = 1e-2 * max(float(g.abs().max()) for g in want.values())
    for k, g in want.items():
        scale = max(float(g.abs().max()), floor)
        np.testing.assert_allclose(params[k].grad.numpy() / scale, g.numpy() / scale, atol=2e-5,
                                   err_msg=k)
