"""The port's paged decode and paged span attention (plain versions, CPU)
against the JAX package's Pallas ``paged_decode_attention`` and
``paged_span_attention`` (interpret mode on the CPU, as the JAX tests run
them), on the same numpy inputs, and the port's ``quantize_kv_rows``
against JAX's bitwise.

Only live outputs are compared: a dead slot (``ends == 0``) is garbage in
the TPU kernel (the caller masks it) and zeros in the port; span columns
past a row's live span are garbage the caller never reads in both.

Tolerances: fp32 queries (bf16 or int8 caches dequantized identically on
both sides) agree to 1e-5 of max|ref| (online vs direct softmax order).
bf16 queries and outputs: both sides compute in fp32 and round once to bf16,
so they differ by at most one bf16 ulp, 2^-7 of max|ref|.

The CUDA kernels cannot run here; ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py`` hold them against these plain versions
on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.decode_attention import paged_decode_attention as jax_paged
from deepspeed_tpu.ops.pallas.decode_attention import paged_span_attention as jax_span
from deepspeed_tpu.ops.quantizer import quantize_kv_rows as jax_quantize_kv_rows
from deepspeed_tpu_torch.ops.decode_attention import paged_decode_attention, paged_span_attention
from deepspeed_tpu_torch.ops.quantizer import dequantize_kv_rows, quantize_kv_rows

B, NKV, S, BLOCK = 3, 2, 256, 128


def _cache(D, kind, seed):
    """(k, v, k_scale, v_scale) as numpy and as torch, for ``kind`` in
    fp32/bf16/int8; int8 caches carry the port's quantize_kv_rows scales."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, NKV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, NKV, S, D)).astype(np.float32)
    if kind == "int8":
        kq, vq, sc = quantize_kv_rows(torch.from_numpy(k), torch.from_numpy(v))
        jax_ops = (jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
                   jnp.asarray(sc.numpy()), jnp.asarray(sc.numpy()))
        return jax_ops, (kq, vq, sc, sc)
    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    kt, vt = torch.from_numpy(k).to(dt), torch.from_numpy(v).to(dt)
    jdt = jnp.bfloat16 if kind == "bf16" else jnp.float32
    return (jnp.asarray(k, jdt), jnp.asarray(v, jdt), None, None), (kt, vt, None, None)


def _query(shape, kind, seed):
    q = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if kind == "bf16":
        return jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).to(torch.bfloat16)
    return jnp.asarray(q), torch.from_numpy(q)


def _tol(kind, ref):
    return (2.0**-7 if kind == "bf16" else 1e-5) * float(np.abs(ref).max())


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_paged_decode_matches_jax(g, D, kind):
    """Ragged per-row ends (one dead slot, ends 0), start > 0."""
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _cache(D, kind, seed=g * D)
    qkind = "bf16" if kind == "bf16" else "fp32"
    jq, tq = _query((B, NKV * g, D), qkind, seed=g + D)
    start = np.array([0, 7, 0], np.int32)
    ends = np.array([40, 200, 0], np.int32)
    ref = _np(jax_paged(jq, jk, jv, jnp.asarray(start), jnp.asarray(ends), block_kv=BLOCK,
                        k_scale=jks, v_scale=jvs))
    out = paged_decode_attention(tq, tk, tv, torch.from_numpy(start), torch.from_numpy(ends),
                                 block_kv=BLOCK, k_scale=tks, v_scale=tvs).float().numpy()
    live = ends > 0
    np.testing.assert_allclose(out[live], ref[live], rtol=0, atol=_tol(qkind, ref[live]))
    assert not out[~live].any()  # a dead slot gets zeros


@pytest.mark.parametrize("T", [1, 5, 64])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_paged_span_matches_jax(T, g, kind):
    """Row 0 decodes (span 1), row 1 prefills a chunk (span T) after a
    prefix, row 2 starts late (start > 0) with a partial span; columns past
    each span are dead and not compared."""
    D = 64 if g == 4 else 128
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _cache(D, kind, seed=T * g + D)
    qkind = "bf16" if kind == "bf16" else "fp32"
    jq, tq = _query((B, NKV * g, T, D), qkind, seed=T + g)
    start = np.array([0, 0, 30], np.int32)
    base = np.array([17, 128, 60], np.int32)
    spans = np.array([1, T, max(1, T // 2)], np.int32)
    ref = _np(jax_span(jq, jk, jv, jnp.asarray(start), jnp.asarray(base), block_kv=BLOCK,
                       k_scale=jks, v_scale=jvs))
    out = paged_span_attention(tq, tk, tv, torch.from_numpy(start), torch.from_numpy(base),
                               block_kv=BLOCK, k_scale=tks, v_scale=tvs).float().numpy()
    for b in range(B):
        o, r = out[b, :, :spans[b]], ref[b, :, :spans[b]]
        np.testing.assert_allclose(o, r, rtol=0, atol=_tol(qkind, r))


def test_quantize_kv_rows_bitwise_equal_to_jax():
    """int8 values and fp16 scales equal JAX's bit for bit, including
    round-half-to-even ties (a row whose absmax is 127 has scale 1, so its
    x.5 values are ties)."""
    rng = np.random.default_rng(3)
    k = (3 * rng.standard_normal((2, 3, 9, 16))).astype(np.float32)
    v = (3 * rng.standard_normal((2, 3, 9, 16))).astype(np.float32)
    k[0, :, 4] = 0.0
    v[0, :, 4] = 0.0  # an all-zero row: the scale floor 1e-8
    k[1, 0, 2, :6] = [127.0, 2.5, 3.5, -2.5, -0.5, 126.5]
    kq, vq, sc = quantize_kv_rows(torch.from_numpy(k), torch.from_numpy(v))
    jkq, jvq, jsc = jax_quantize_kv_rows(jnp.asarray(k), jnp.asarray(v))
    assert kq.dtype == torch.int8 and sc.dtype == torch.float16 and sc.shape == (2, 1, 9, 1)
    np.testing.assert_array_equal(kq.numpy(), np.asarray(jkq))
    np.testing.assert_array_equal(vq.numpy(), np.asarray(jvq))
    np.testing.assert_array_equal(sc.numpy().view(np.uint16), np.asarray(jsc).view(np.uint16))
    assert kq[1, 0, 2, :6].tolist() == [127, 2, 4, -2, 0, 126]
    # the round trip is within half an int8 step of each row's scale
    back = dequantize_kv_rows(kq, sc)
    assert float((back - torch.from_numpy(k)).abs().max()) <= 0.5 * float(sc.float().max()) + 1e-6
