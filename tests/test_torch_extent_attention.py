"""The port's extent modes of decode attention (plain versions, CPU) against
the JAX package's Pallas ``extent_paged_decode_attention`` and
``extent_paged_span_attention`` (interpret mode on the CPU, as the JAX tests
run them), on the same numpy inputs: shuffled extent tables, a single-extent
row, a dead row, -1 entries inside a lossy sliding window's hole, bf16 and
int8 pools, T in {1, 16}, D in {64, 128}, g in {1, 4}. Plus the two
promises the TPU kernel makes, bitwise here: an identity table computes what
the paged modes compute, and a chain computes what one slot of E * S rows
holding the same logical window computes.

Only live outputs are compared: a dead row (``ends == 0``) is garbage in the
TPU kernel and zeros in the port; span columns past a row's live span are
never read. Tolerances as in ``test_torch_paged_attention.py``: fp32
queries within 1e-5 of max|ref| (online vs direct softmax order), bf16
within one bf16 ulp of max|ref| (2^-7; both sides compute in fp32 and round
once).

The CUDA kernel cannot run here; ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py`` hold it against these plain versions
on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.decode_attention import \
    extent_paged_decode_attention as jax_ext_decode
from deepspeed_tpu.ops.pallas.decode_attention import \
    extent_paged_span_attention as jax_ext_span
from deepspeed_tpu_torch.ops.decode_attention import (extent_paged_decode_attention,
                                                      extent_paged_span_attention,
                                                      paged_decode_attention,
                                                      paged_span_attention)
from deepspeed_tpu_torch.ops.quantizer import quantize_kv_rows

NP, NKV, S, E, BLOCK = 5, 2, 64, 3, 32
# row 0: a shuffled 3-extent chain; row 1: one extent; row 2: dead
EXT = np.array([[4, 1, 3], [2, -1, -1], [0, -1, -1]], np.int32)
START = np.array([0, 3, 0], np.int32)


def _pool(D, kind, seed):
    """(k, v, k_scale, v_scale) of an (NP, NKV, S, D) pool, as JAX arrays and
    as torch tensors; int8 pools carry the port's quantize_kv_rows scales."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((NP, NKV, S, D)).astype(np.float32)
    v = rng.standard_normal((NP, NKV, S, D)).astype(np.float32)
    if kind == "int8":
        kq, vq, sc = quantize_kv_rows(torch.from_numpy(k), torch.from_numpy(v))
        jops = (jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()), jnp.asarray(sc.numpy()),
                jnp.asarray(sc.numpy()))
        return jops, (kq, vq, sc, sc)
    dt, jdt = (torch.bfloat16, jnp.bfloat16) if kind == "bf16" else (torch.float32, jnp.float32)
    return ((jnp.asarray(k, jdt), jnp.asarray(v, jdt), None, None),
            (torch.from_numpy(k).to(dt), torch.from_numpy(v).to(dt), None, None))


def _query(shape, kind, seed):
    q = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if kind == "bf16":
        return jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).to(torch.bfloat16)
    return jnp.asarray(q), torch.from_numpy(q)


def _tol(kind, ref):
    return (2.0**-7 if kind == "bf16" else 1e-5) * float(np.abs(ref).max())


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _lossy(lossy, ext):
    """Row 0 keeps a 6-token sink and a 40-token recent window: extent 1
    (positions 64..127) lies in the hole and is dropped (-1)."""
    if not lossy:
        return ext, None, None
    ext = ext.copy()
    ext[0, 1] = -1
    return ext, np.array([6, 0, 0], np.int32), np.array([40, 0, 0], np.int32)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("lossy", [False, True])
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("g,D", [(1, 128), (4, 64)])
def test_extent_decode_matches_jax(g, D, kind, lossy):
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _pool(D, kind, seed=g * D)
    qkind = "bf16" if kind == "bf16" else "fp32"
    jq, tq = _query((3, NKV * g, D), qkind, seed=g + D)
    ends = np.array([180, 40, 0], np.int32)
    ext, sink, win = _lossy(lossy, EXT)
    ref = _np(jax_ext_decode(jq, jk, jv, jnp.asarray(START), jnp.asarray(ends), jnp.asarray(ext),
                             block_kv=BLOCK, k_scale=jks, v_scale=jvs, sink=_j(sink),
                             window=_j(win)))
    out = extent_paged_decode_attention(tq, tk, tv, _t(START), _t(ends), _t(ext), block_kv=BLOCK,
                                        k_scale=tks, v_scale=tvs, sink=_t(sink),
                                        window=_t(win)).float().numpy()
    live = ends > 0
    np.testing.assert_allclose(out[live], ref[live], rtol=0, atol=_tol(qkind, ref[live]))
    assert not out[~live].any()  # a dead row gets zeros


@pytest.mark.parametrize("lossy", [False, True])
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("T,g,D", [(1, 4, 64), (16, 1, 128), (16, 4, 64)])
def test_extent_span_matches_jax(T, g, D, kind, lossy):
    """Row 0 prefills a span of T at logical base 170 of its chain (each
    column's own window end, its own lossy hole), row 1 decodes inside one
    extent, row 2 is dead."""
    (jk, jv, jks, jvs), (tk, tv, tks, tvs) = _pool(D, kind, seed=T * g + D)
    qkind = "bf16" if kind == "bf16" else "fp32"
    jq, tq = _query((3, NKV * g, T, D), qkind, seed=T + g)
    base = np.array([170, 39, 0], np.int32)
    spans = [min(T, E * S - 170), 1]
    ext, sink, win = _lossy(lossy, EXT)
    ref = _np(jax_ext_span(jq, jk, jv, jnp.asarray(START), jnp.asarray(base), jnp.asarray(ext),
                           block_kv=BLOCK, k_scale=jks, v_scale=jvs, sink=_j(sink),
                           window=_j(win)))
    out = extent_paged_span_attention(tq, tk, tv, _t(START), _t(base), _t(ext), block_kv=BLOCK,
                                      k_scale=tks, v_scale=tvs, sink=_t(sink),
                                      window=_t(win)).float().numpy()
    for b, n in enumerate(spans):
        o, r = out[b, :, :n], ref[b, :, :n]
        np.testing.assert_allclose(o, r, rtol=0, atol=_tol(qkind, r))


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_identity_table_equals_paged_modes_bitwise(kind):
    """ext[b] = [b]: the extent modes compute bitwise what the paged modes
    compute over the same pool (decode, and a span of 16)."""
    (_, _, _, _), (tk, tv, tks, tvs) = _pool(64, kind, seed=5)
    ident = torch.arange(NP, dtype=torch.int32)[:, None]
    start = torch.tensor([0, 3, 0, 9, 1], dtype=torch.int32)
    ends = torch.tensor([64, 40, 0, 17, 1], dtype=torch.int32)
    _, q = _query((NP, 4 * NKV, 64), "bf16", seed=1)
    a = extent_paged_decode_attention(q, tk, tv, start, ends, ident, k_scale=tks, v_scale=tvs)
    b = paged_decode_attention(q, tk, tv, start, ends, k_scale=tks, v_scale=tvs)
    assert torch.equal(a, b)
    _, q4 = _query((NP, 4 * NKV, 16, 64), "bf16", seed=2)
    base = torch.tensor([30, 0, 48, 10, 47], dtype=torch.int32)
    a = extent_paged_span_attention(q4, tk, tv, start, base, ident, k_scale=tks, v_scale=tvs)
    b = paged_span_attention(q4, tk, tv, start, base, k_scale=tks, v_scale=tvs)
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_chain_equals_one_big_slot_bitwise(kind):
    """Row 0's 3-extent chain against one slot of E * S = 192 rows holding
    the same logical positions: bitwise equal, decode and span."""
    (_, _, _, _), (tk, tv, tks, tvs) = _pool(128, kind, seed=6)
    ext = torch.from_numpy(EXT[:1])
    big = [leaf[ext[0].long()].transpose(0, 1).reshape(1, leaf.shape[1], E * S, leaf.shape[3])
           for leaf in (tk, tv) + ((tks, ) if tks is not None else ())]
    bks = big[2] if tks is not None else None
    start, ends = torch.tensor([2], dtype=torch.int32), torch.tensor([150], dtype=torch.int32)
    _, q = _query((1, 4 * NKV, 128), "bf16", seed=3)
    a = extent_paged_decode_attention(q, tk, tv, start, ends, ext, k_scale=tks, v_scale=tvs)
    b = paged_decode_attention(q, big[0], big[1], start, ends, k_scale=bks, v_scale=bks)
    assert torch.equal(a, b)
    _, q4 = _query((1, 4 * NKV, 16, 128), "bf16", seed=4)
    base = torch.tensor([140], dtype=torch.int32)
    a = extent_paged_span_attention(q4, tk, tv, start, base, ext, k_scale=tks, v_scale=tvs)
    b = paged_span_attention(q4, big[0], big[1], start, base, k_scale=bks, v_scale=bks)
    assert torch.equal(a, b)


def test_extent_modes_refuse_bad_shapes():
    (_, _, _, _), (tk, tv, _, _) = _pool(64, "fp32", seed=7)
    q = torch.zeros((3, NKV, 64))
    with pytest.raises(ValueError, match="extent table"):
        extent_paged_decode_attention(q, tk, tv, 0, torch.ones(3, dtype=torch.int32),
                                      torch.zeros((2, E), dtype=torch.int32))
    with pytest.raises(ValueError, match="kv_heads"):
        extent_paged_decode_attention(torch.zeros((3, NKV, 32)), tk, tv, 0,
                                      torch.ones(3, dtype=torch.int32), torch.from_numpy(EXT))
    with pytest.raises(ValueError, match="Npool"):
        extent_paged_decode_attention(q, tk.to(torch.int8), tv.to(torch.int8), 0,
                                      torch.ones(3, dtype=torch.int32), torch.from_numpy(EXT),
                                      k_scale=torch.ones((3, 1, S, 1), dtype=torch.float16),
                                      v_scale=torch.ones((3, 1, S, 1), dtype=torch.float16))
