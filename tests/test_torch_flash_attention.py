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


# bf16: both sides round p to bf16 before P V (the row sum unrounded) and
# the output to bf16. Causal, a row's running max in the JAX online softmax
# is mostly its final max, so the two roundings mostly coincide: rel L2
# within 1e-3 (measured at most 5.6e-4 over these cases; with p left
# unrounded in the port, 1.7e-3 or more). Non-causal, the first KV block's
# running max is often not the row's, so p rounds at other points: within
# 2e-3 (measured at most 1.6e-3). Every entry within one bf16 ulp of the
# largest, 2^-7 max|JAX|; lse (fp32 on both sides) within 1e-5.
@pytest.mark.parametrize("causal,rel_l2", [(True, 1e-3), (False, 2e-3)])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("T", [128, 100])
def test_plain_matches_jax_bf16(causal, rel_l2, g, T):
    q, k, v = _qkv(2, 4, 4 // g, T, 32, seed=T + g)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)
    ref_out, ref_lse = jax_flash(bf(q), bf(k), bf(v), causal, 64, 64)
    ref_out = np.asarray(ref_out.astype(jnp.float32))
    out, lse = flash_attention_with_lse(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                                        causal=causal)
    out = out.float().numpy()
    assert np.linalg.norm(out - ref_out) <= rel_l2 * np.linalg.norm(ref_out)
    np.testing.assert_allclose(out, ref_out, rtol=0, atol=2.0**-7 * np.abs(ref_out).max())
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=0, atol=1e-5)


def test_kernel_scale_contract():
    """The CUDA forward's wrapper takes the default 1/sqrt(D) or a finite
    scale above 0, and refuses any other before it builds or launches."""
    from deepspeed_tpu_torch.ops.flash_attention import _kernel_scale
    assert _kernel_scale(None, 64) == 0.125
    assert _kernel_scale(0.3, 128) == 0.3
    for bad in (0.0, -0.125, float("inf"), float("nan")):
        with pytest.raises(ValueError, match="scale"):
            _kernel_scale(bad, 64)


def test_bwd_kernel_scale_contract():
    """The CUDA backward's wrappers take the default 1/sqrt(D) or any finite
    scale (no row max), and refuse an infinite or NaN one before they build
    or launch."""
    from deepspeed_tpu_torch.ops.flash_attention import _bwd_kernel_scale
    assert _bwd_kernel_scale(None, 128, "flash_bwd_dq") == 1.0 / 128**0.5
    for ok in (0.3, 0.0, -0.2):
        assert _bwd_kernel_scale(ok, 64, "flash_bwd_dkv") == ok
    for bad in (float("inf"), float("-inf"), float("nan")):
        with pytest.raises(ValueError, match="flash_bwd_dq kernel: scale"):
            _bwd_kernel_scale(bad, 64, "flash_bwd_dq")
