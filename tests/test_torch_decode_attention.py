"""The port's decode attention (plain version, CPU) against the JAX
package's Pallas ``decode_attention`` and ``paged_decode_attention``
(interpret mode on the CPU), on the same numpy inputs.

The CUDA kernel itself cannot run here; ``chip_smoke.py`` holds it against
this plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.decode_attention import decode_attention as jax_decode
from deepspeed_tpu.ops.pallas.decode_attention import paged_decode_attention as jax_paged
from deepspeed_tpu_torch.ops.decode_attention import decode_attention


def _inputs(B, H, nkv, S, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, nkv, S, D)).astype(np.float32)
    vc = rng.standard_normal((B, nkv, S, D)).astype(np.float32)
    return q, kc, vc


# nkv < H: GQA groups of 2 and 4; end well below S so the JAX kernel skips
# whole KV blocks (block_kv 128 of S 512); starts > 0 are left-pad rows
@pytest.mark.parametrize("H,nkv", [(4, 4), (4, 2), (8, 2)])
@pytest.mark.parametrize("end", [200, 129])
def test_plain_matches_jax(H, nkv, end):
    B, S, D = 3, 512, 32
    q, kc, vc = _inputs(B, H, nkv, S, D, seed=H + nkv + end)
    start = np.array([0, 5, 63], np.int32)
    ref = jax_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(start),
                     end, block_kv=128)
    out = decode_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                           torch.from_numpy(start), end, block_kv=128)
    # fp32 on both sides; online (JAX) vs direct (port) softmax order only
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_per_row_ends_match_jax_paged():
    """A (B,) ``end`` is the scheduler's per-row contract (paged mode)."""
    B, H, nkv, S, D = 3, 4, 2, 256, 32
    q, kc, vc = _inputs(B, H, nkv, S, D, seed=11)
    start = np.array([0, 10, 3], np.int32)
    ends = np.array([40, 250, 129], np.int32)
    ref = jax_paged(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(start),
                    jnp.asarray(ends), block_kv=128)
    out = decode_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                           torch.from_numpy(start), torch.from_numpy(ends), block_kv=128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_empty_window_gives_zeros():
    """start >= end: l = 0, guarded to 1, so the row's output is 0."""
    q, kc, vc = _inputs(2, 2, 2, 64, 16, seed=5)
    out = decode_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
                           torch.tensor([10, 0]), 10)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert out[1].abs().sum() > 0


def test_cache_length_must_be_a_block_multiple():
    q, kc, vc = _inputs(1, 2, 2, 96, 16, seed=6)
    with pytest.raises(ValueError, match="multiple of block_kv"):
        decode_attention(torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc), 0, 5,
                         block_kv=64)
