"""The port's fused decode layer (``deepspeed_tpu_torch.ops.decode_block``,
plain versions on the CPU) against the JAX package's
(``deepspeed_tpu.ops.pallas.decode_block``, its Pallas kernels in interpret
mode on the CPU), on the same numpy inputs: kernel A and kernel C alone, and
the whole layer over 4 decode steps after a prefill, caches included.

The CUDA kernels cannot run here; ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py`` hold them against these plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import decode_block as jdb
from deepspeed_tpu_torch.ops import decode_block as tdb

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# name: (H, nh, nkv, hd, F, activation, norm, rope, groups (qkv, o, up, down))
SHAPES = {
    # gpt2 family: layernorm, gelu, MHA, no rotation; several groups
    "gpt2": (256, 4, 4, 64, 512, "gelu", "layernorm", False, (2, 2, 2, 4)),
    # llama family: rmsnorm, RoPE, swiglu, GQA (2 q heads per kv head)
    "llama": (256, 4, 2, 64, 384, "swiglu", "rmsnorm", True, (2, 2, 2, 3)),
    # one group over every contraction (128 divides none of 192, 192, 320)
    "g1": (192, 4, 4, 48, 320, "relu", "layernorm", True, (1, 1, 1, 1)),
    # H = 1152 > 1024: the JAX kernel C walks the up/gate contraction in 3
    # k-blocks (nku = 3) and rounds its partials to the compute dtype between
    # them; geglu, GQA with one kv head
    "nku3": (1152, 2, 1, 64, 256, "geglu", "rmsnorm", True, (9, 1, 9, 2)),
}


def _proj(rng, K, N, G):
    return (rng.integers(-127, 128, (K, N)).astype(np.int8),
            (rng.random((G, N)) * 0.02 + 0.001).astype(np.float32),
            (0.1 * rng.standard_normal(N)).astype(np.float32))


def _layer(name, seed):
    """numpy operands of one layer: norms, qkv, o, up, down, gate-or-None."""
    H, nh, nkv, hd, F, act, norm, _, (gq, go, gu, gd) = SHAPES[name]
    rng = np.random.default_rng(seed)
    norms = np.stack([1 + 0.1 * rng.standard_normal(H), 0.1 * rng.standard_normal(H),
                      1 + 0.1 * rng.standard_normal(H), 0.1 * rng.standard_normal(H)])
    if norm == "rmsnorm":  # rmsnorm models pass zero bias rows
        norms[1] = norms[3] = 0.0
    gate = _proj(rng, H, F, gu) if act in ("swiglu", "geglu") else None
    return (norms.astype(np.float32), _proj(rng, H, (nh + 2 * nkv) * hd, gq),
            _proj(rng, nh * hd, H, go), _proj(rng, H, F, gu), _proj(rng, F, H, gd), gate)


def _tables(rng, B, hd):
    ang = (rng.random((B, hd // 2)) * 6).astype(np.float32)
    return np.sin(ang), np.cos(ang)


def _j(p):
    return None if p is None else tuple(jnp.asarray(t) for t in p)


def _t(p):
    return None if p is None else tuple(torch.from_numpy(t) for t in p)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def _assert_close(out, ref, dtype):
    """fp32: the two sum the K contraction in other orders, within 1e-5 of
    max|ref|. bf16: the inputs of each dot are rounded to bf16 in both, but a
    value next to a rounding boundary may round the other way after an fp32
    difference of a few ulps, and the JAX kernel C rounds its up/gate partial
    sums to bf16 between k-blocks where the port keeps fp32 — within 2^-6 of
    max|ref| (a few bf16 ulps at the largest magnitude)."""
    out, ref = _f32(out), _f32(ref)
    tol = (1e-5 if dtype == "float32" else 2.0**-6) * np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol)


# batches: a decode width, and one above 32 (the kernels' wgmma widths: the
# scheduler's verify and chunk steps)
@pytest.mark.parametrize("B", [3, 40])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_fused_qkv_ln_plain_matches_jax(name, dtype, B):
    H, nh, nkv, hd, F, act, norm, rope, _ = SHAPES[name]
    jdt, tdt = DTYPES[dtype]
    norms, qkv = _layer(name, seed=1)[:2]
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((B, H)) * 2 + 0.5).astype(np.float32)
    jrope = trope = None
    if rope:
        sin, cos = _tables(rng, B, hd)
        jrope = (jnp.asarray(sin), jnp.asarray(cos), nh + nkv, hd)
        trope = (torch.from_numpy(sin), torch.from_numpy(cos), nh + nkv, hd)
    ref = jdb.fused_qkv_ln(jnp.asarray(x, jdt), jnp.asarray(norms), _j(qkv), norm=norm, rope=jrope)
    out = tdb.fused_qkv_ln_plain(torch.from_numpy(x).to(tdt), torch.from_numpy(norms), _t(qkv),
                                 norm=norm, rope=trope)
    assert out.dtype == tdt and tuple(out.shape) == tuple(ref.shape)
    _assert_close(out, ref, dtype)


@pytest.mark.parametrize("B", [2, 40])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_fused_out_mlp_plain_matches_jax(name, dtype, B):
    H, nh, nkv, hd, F, act, norm, _, _ = SHAPES[name]
    jdt, tdt = DTYPES[dtype]
    norms, _, o, up, down, gate = _layer(name, seed=3)
    rng = np.random.default_rng(4)
    attn = rng.standard_normal((B, nh * hd)).astype(np.float32)
    x = (rng.standard_normal((B, H)) * 4).astype(np.float32)
    ref = jdb.fused_out_mlp(jnp.asarray(attn, jdt), jnp.asarray(x, jdt), jnp.asarray(norms),
                            _j(o), _j(up), _j(down), activation=act, norm=norm, gate=_j(gate))
    out = tdb.fused_out_mlp(torch.from_numpy(attn).to(tdt), torch.from_numpy(x).to(tdt),
                            torch.from_numpy(norms), _t(o), _t(up), _t(down), activation=act,
                            norm=norm, gate=_t(gate))
    assert out.dtype == tdt and tuple(out.shape) == tuple(ref.shape)
    _assert_close(out, ref, dtype)


@pytest.mark.parametrize("name,dtype", [("gpt2", "float32"), ("llama", "bfloat16")])
def test_fused_decode_block_matches_jax_over_decode_steps(name, dtype):
    """4 decode steps after a prefill of 20 slots (random cache rows stand in
    for it), ragged rows (start 0 and 7): each step's layer output and, at
    the end, both caches."""
    H, nh, nkv, hd, F, act, norm, rope, _ = SHAPES[name]
    jdt, tdt = DTYPES[dtype]
    norms, qkv, o, up, down, gate = _layer(name, seed=5)
    rng = np.random.default_rng(6)
    B, S, P = 2, 64, 20
    starts = np.array([0, 7], np.int32)
    kc = np.zeros((B, nkv, S, hd), np.float32)
    vc = np.zeros((B, nkv, S, hd), np.float32)
    kc[:, :, :P] = rng.standard_normal((B, nkv, P, hd))
    vc[:, :, :P] = rng.standard_normal((B, nkv, P, hd))
    jk, jv = jnp.asarray(kc, jdt), jnp.asarray(vc, jdt)
    tk, tv = torch.from_numpy(kc).to(tdt), torch.from_numpy(vc).to(tdt)
    kw = dict(activation=act, norm=norm, block_kv=256)
    for step in range(4):
        pos = P + step
        x = (rng.standard_normal((B, H)) * 2).astype(np.float32)
        jrope = trope = None
        if rope:  # tables at each row's true position, pos - start
            sin, cos = _tables(np.random.default_rng(pos), B, hd)
            jrope, trope = (jnp.asarray(sin), jnp.asarray(cos)), (torch.from_numpy(sin),
                                                                 torch.from_numpy(cos))
        jx, jk, jv = jdb.fused_decode_block(jnp.asarray(x, jdt), jnp.asarray(norms), jk, jv,
                                            _j(qkv), _j(o), _j(up), _j(down),
                                            jnp.asarray(starts), jnp.int32(pos), rope=jrope,
                                            gate=_j(gate), **kw)
        tx, tk2, tv2 = tdb.fused_decode_block(torch.from_numpy(x).to(tdt), torch.from_numpy(norms),
                                              tk, tv, _t(qkv), _t(o), _t(up), _t(down),
                                              torch.from_numpy(starts), pos, rope=trope,
                                              gate=_t(gate), **kw)
        assert tk2 is tk and tv2 is tv  # the caches are written in place
        _assert_close(tx, jx, dtype)
    _assert_close(tk, jk, dtype)
    _assert_close(tv, jv, dtype)


def test_cpu_tensors_take_the_plain_versions_without_counting():
    norms, qkv, o, up, down, gate = (_t(p) if isinstance(p, tuple) else torch.from_numpy(p)
                                     for p in _layer("llama", seed=7))
    x = torch.randn(2, 256, generator=torch.Generator().manual_seed(0))
    before = (tdb.fused_qkv_ln.launches, tdb.fused_out_mlp.launches)
    a = tdb.fused_qkv_ln(x, norms, qkv, norm="rmsnorm")
    assert torch.equal(a, tdb.fused_qkv_ln_plain(x, norms, qkv, norm="rmsnorm"))
    attn = a[:, :256]
    c = tdb.fused_out_mlp(attn, x, norms, o, up, down, activation="swiglu", norm="rmsnorm", gate=gate)
    assert torch.equal(c, tdb.fused_out_mlp_plain(attn, x, norms, o, up, down, activation="swiglu",
                                                  norm="rmsnorm", gate=gate))
    assert (tdb.fused_qkv_ln.launches, tdb.fused_out_mlp.launches) == before


def test_shape_errors():
    norms, qkv, o, up, down, gate = (_t(p) if isinstance(p, tuple) else torch.from_numpy(p)
                                     for p in _layer("llama", seed=8))
    x = torch.zeros(2, 256)
    with pytest.raises(ValueError, match="norms"):
        tdb.fused_qkv_ln(x, norms[:, :128], qkv)
    with pytest.raises(ValueError, match="rope"):
        tdb.fused_qkv_ln(x, norms, qkv, rope=(torch.zeros(2, 16), torch.zeros(2, 16), 6, 64))
    with pytest.raises(ValueError, match="gate/up"):
        tdb.fused_out_mlp(torch.zeros(2, 256), x, norms, o, up, down, activation="swiglu",
                          gate=(gate[0], gate[1][:1].contiguous(), gate[2]))


# ---------------------------------------------------------------- the kernels' launch plan
# (the CUDA kernels run only on the card; their plan is Python and is held
# here: where the segment partials are made, never how they are summed)

# gpt2-large's and llama3-8b's layer products, (K, N, G, passes): qkv, o,
# up (and gate: two passes), down
LAYER_PRODUCTS = [(1280, 3840, 10, 1), (1280, 1280, 10, 1), (1280, 5120, 10, 1), (5120, 1280, 40, 1),
                  (4096, 6144, 32, 1), (4096, 4096, 32, 1), (4096, 14336, 32, 2), (14336, 4096, 112, 1)]
# the scheduler's widths: decode, verify (8 x 5), chunk steps, prefill
PLAN_M = (1, 4, 8, 16, 32, 33, 40, 64, 256, 512, 1024)


@pytest.mark.parametrize("K,N,G,passes", LAYER_PRODUCTS)
def test_plan_takes_mma_sync_to_32_rows_and_wgmma_above(K, N, G, passes):
    """mma.sync with quant_matmul's M-free split plan at M <= 32 (8, 16 or
    32 rows a block), wgmma on 64- or 128-row tiles above; K split only in
    whole segments, none empty, and the wgmma splits' partials within the
    workspace cap."""
    from deepspeed_tpu_torch.ops.quant_matmul import _split_plan
    segs = tdb._segments(K, G)
    for M in PLAN_M:
        bm, splits = tdb._plan(M, K, N, G, passes)
        per = -(-segs // splits)
        assert 1 <= splits <= segs and (splits - 1) * per < segs <= splits * per
        if M <= 32:
            assert bm == (8 if M <= 8 else 16 if M <= 16 else 32)
            assert splits == _split_plan(K, N)
        else:
            assert bm in (64, 128)
            if splits > 1:
                assert passes * segs * M * N * 4 <= tdb._WS_CAP
        ws = tdb._ws_floats(M, K, N, G, passes, (bm, splits))
        assert ws == (0 if bm > 32 and splits == 1 else passes * segs * M * N)


@pytest.mark.parametrize("K,N,G", [(200, 264, 1), (1152, 512, 2), (256, 200, 2), (320, 1024, 1)])
def test_plan_keeps_mma_sync_for_shapes_wgmma_cannot_take(K, N, G):
    """N % 16 (TMA's 16-byte rows) or a group size that is not a multiple of
    128 (the ring's whole segments): mma.sync at every M, 32 rows a block
    above 32 rows."""
    for M in PLAN_M:
        bm, splits = tdb._plan(M, K, N, G)
        assert bm <= 32 and bm == (8 if M <= 8 else 16 if M <= 16 else 32)


def test_segments_never_cross_a_group():
    """K's segments: at most 128 rows inside a quantization group (a group
    of 200 is two: 128 and 72)."""
    assert tdb._segments(1280, 10) == 10
    assert tdb._segments(200, 1) == 2
    assert tdb._segments(1152, 3) == 9
    assert tdb._segments(14336, 112) == 112


def test_kernel_sources_share_the_quant_matmul_mainloops():
    """Kernels A and C and quant_matmul build from one header of mainloops,
    so an edit there rebuilds all three (the library name hashes every
    csrc/ header a source includes)."""
    import os

    from deepspeed_tpu_torch.ops import build
    for name in ("fused_qkv_ln", "fused_out_mlp", "quant_matmul"):
        heads = {os.path.basename(p) for p in build.sources(name)}
        assert {"qmm_core.cuh", "hopper.cuh", "int8_mma.cuh"} <= heads
    for name in ("fused_qkv_ln", "fused_out_mlp"):
        assert "fused_layer.cuh" in {os.path.basename(p) for p in build.sources(name)}
