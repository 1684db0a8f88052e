"""The port's flash attention forward (plain version, CPU) against the JAX
package's Pallas ``flash_attention_with_lse`` (interpret mode on the CPU),
on the same numpy inputs: output and log-sum-exp.

The CUDA kernel itself cannot run here; ``chip_smoke.py`` holds it against
this plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_attention import flash_attention_with_lse as jax_flash
from deepspeed_tpu_torch.ops.flash_attention import flash_attention, flash_attention_with_lse


def _qkv(B, H, Hkv, T, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    return q, k, v


# T=100 is not a multiple of the JAX block (64): the TPU kernel pads, the
# port masks the edges
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("T", [128, 100])
def test_plain_matches_jax(causal, g, T):
    B, H, D = 2, 4, 32
    q, k, v = _qkv(B, H, H // g, T, D, seed=T + g)
    ref_out, ref_lse = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 64, 64)
    out, lse = flash_attention_with_lse(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), causal=causal)
    # fp32 softmax on both sides; the online (JAX) and direct (port) softmax
    # sum in different orders: differences of a few ulps of O(1) values
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=2e-5)


def test_explicit_scale_and_output_only_entry():
    q, k, v = _qkv(1, 2, 2, 64, 16, seed=7)
    ref_out, _ = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, 64, 64, 0.3)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-5)


def test_kv_length_differs_from_query_length():
    """Tk = 96 keys for T = 64 queries, not a multiple of the JAX block."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((1, 2, 64, 16)).astype(np.float32)
    k = rng.standard_normal((1, 1, 96, 16)).astype(np.float32)
    v = rng.standard_normal((1, 1, 96, 16)).astype(np.float32)
    ref_out, ref_lse = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), False, 64, 64)
    out, lse = flash_attention_with_lse(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=2e-5)
