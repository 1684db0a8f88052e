"""The decode-shape microbench's three TPU kernels and its bench module against
the port's (``deepspeed_tpu_torch/ops/qmm_microbench.py``,
``deepspeed_tpu_torch/benchmarks/qmm_microbench.py``), on the CPU.

``benchmarks/qmm_microbench.py`` is loaded by path and its ``qmm2``,
``qmm3`` and ``qmm4`` run in Pallas interpret mode (``pl.pallas_call``
wrapped with ``interpret=True`` for the test's duration; the file itself is
not touched), at the bench's full width 8 x 1280 x 5120, against the port's
plain versions on the same numpy inputs. The CUDA kernels cannot run here;
``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py`` hold them against
these plain versions on the card. The kernel's launch grid, chosen on the
host (``_grid``, ``_plan``), is checked here: every output covered once, the
card filled at the bench's shape, no dependence on ``block_n``, and the
refusals of what the kernel cannot take."""

import functools
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import deepspeed_tpu.ops.pallas.quant_matmul  # noqa: F401  (the JAX bench's pallas_old imports it)
from deepspeed_tpu_torch.benchmarks import qmm_microbench as tbench
from deepspeed_tpu_torch.ops import qmm_microbench as tq

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks",
                     "qmm_microbench.py")


@functools.lru_cache(maxsize=None)
def _load_jax_bench():
    spec = importlib.util.spec_from_file_location("_jax_qmm_microbench", BENCH)
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path  # the file puts its own checkout first on sys.path
    return mod


@pytest.fixture
def qb(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    return _load_jax_bench()


def _layer(seed=0, M=8, K=1280, N=5120, gsize=128):
    """One layer quantized as the bench's make_data does: x bf16, qw int8,
    scales fp32, as (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    G = K // gsize
    w = rng.standard_normal((K, N), np.float32) * 0.02
    x = rng.standard_normal((M, K), np.float32) * 0.1
    wg = w.reshape(G, gsize, N)
    sc = (np.abs(wg).max(axis=1) / 127.0 + 1e-8).astype(np.float32)
    qw = np.clip(np.round(wg / sc[:, None, :]), -127, 127).astype(np.int8).reshape(K, N)
    return ((jnp.asarray(x, jnp.bfloat16), jnp.asarray(qw), jnp.asarray(sc)),
            (torch.from_numpy(x).bfloat16(), torch.from_numpy(qw), torch.from_numpy(sc)))


CASES = [("qmm2", 512), ("qmm2", 1024), ("qmm2", 2560), ("qmm3", 512), ("qmm3", 2560), ("qmm4", 512),
         ("qmm4", 2560)]


@pytest.mark.parametrize("which,block_n", CASES)
def test_plain_matches_jax_kernel(qb, which, block_n):
    """qmm2 and qmm3 within 2^-20 of max|ref|: fp32 on both sides, every
    bf16 x int8 product exact, only the order of each group's 128-term sum
    differs. qmm4: see test_qmm4_rounds_as_jax_but_for_the_fused_multiply_add."""
    (xj, qwj, scj), (xt, qwt, sct) = _layer()
    assert np.array_equal(np.asarray(xj.astype(jnp.float32)), xt.float().numpy())
    ref = np.asarray(getattr(qb, which)(xj, qwj, scj, block_n=block_n))
    got = getattr(tq, which)(xt, qwt, sct, block_n=block_n)  # a CPU tensor: the plain version
    assert got.dtype == torch.float32 and got.shape == (8, 5120)
    got = got.numpy()
    tol = (2.0**-22 if which == "qmm4" else 2.0**-20) * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_qmm4_rounds_as_jax_but_for_the_fused_multiply_add(qb):
    """qmm4's activation quantization (xq, sx) is bitwise JAX's formula. The
    JAX kernel's ``acc += part * (sx * s)`` runs on the CPU as one fused
    multiply-add (XLA's CPU backend contracts it), which rounds once where
    the port's kernel and plain version round the product and the sum
    apart (``__fmul_rn`` / ``__fadd_rn``, so that the kernel is bitwise its
    plain version). Shown on the port's own xq and sx: the port's output is
    the separately rounded recurrence bit for bit, and JAX's the fused one
    bit for bit; the two differ by at most 2^-22 of max|ref|."""
    (xj, qwj, scj), (xt, qwt, sct) = _layer(seed=3)
    xf = xj.astype(jnp.float32)
    sx = jnp.max(jnp.abs(xf), axis=1) / 127.0 + 1e-12
    xq = jnp.clip(jnp.round(xf / sx[:, None]), -127, 127).astype(jnp.int8)
    txq, tsx = tq.quantize_rows(xt)
    assert np.array_equal(np.asarray(xq), txq.numpy()) and np.array_equal(np.asarray(sx), tsx.numpy())
    ref = np.asarray(qb.qmm4(xj, qwj, scj))
    got = tq.qmm4(xt, qwt, sct).numpy()
    x64, w64, s = txq.numpy().astype(np.float64), qwt.numpy().astype(np.float64), sct.numpy()
    separate = np.zeros((8, 5120), np.float32)
    fused = np.zeros((8, 5120), np.float32)
    for g in range(10):
        part = (x64[:, g * 128:(g + 1) * 128] @ w64[g * 128:(g + 1) * 128]).astype(np.float32)
        scale = tsx.numpy()[:, None] * s[g][None, :]  # fp32 x fp32 -> fp32
        separate = separate + part * scale
        # one rounding of acc + part * scale: the product of an integer below
        # 2^22 and an fp32 value is exact in float64
        fused = (fused.astype(np.float64) + part.astype(np.float64) * scale).astype(np.float32)
    assert np.array_equal(got, separate)
    assert np.array_equal(ref, fused)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0**-22 * np.abs(ref).max())


def test_kernel_arguments_are_checked():
    """The wrappers refuse what the JAX functions refuse, on every route."""
    _, (x, qw, sc) = _layer(K=256, N=512)
    with pytest.raises(ValueError, match="block_n"):
        tq.qmm2(x, qw, sc, block_n=384)
    with pytest.raises(ValueError, match="block_k"):
        tq.qmm3(x, qw, sc, block_n=512, block_k=64)
    with pytest.raises(ValueError, match="impl"):
        tq.qmm4(x, qw, sc, block_n=512, impl="cuda")
    assert np.array_equal(tq.qmm2(x, qw, sc, impl="plain").numpy(), tq.qmm3_plain(x, qw, sc, block_n=512).numpy())


def _bench_data(qb):
    jx = qb.make_data(np.random.default_rng(0))
    tx = tbench.make_data(np.random.default_rng(0), "cpu")
    for j, t in zip(jx, tx):  # the same numbers, made from the same seed
        assert np.array_equal(np.asarray(j.astype(jnp.float32)), t.float().numpy())
    return jx, tx


@pytest.mark.parametrize("name", list(tbench.VARIANTS))
def test_bench_variant_matches_jax(qb, monkeypatch, name):
    """The port's ``run_scan`` of each variant against the JAX file's
    ``v_*`` at L 2, R 1 on ``make_data``'s inputs: within 2^-20 of max|ref|
    (fp32 sums in other orders; w8a8 2^-22 for the fused multiply-add, as
    above). Both keep the carry feedback and the 0.5 decay."""
    for mod in (qb, tbench):
        monkeypatch.setattr(mod, "L", 2)
        monkeypatch.setattr(mod, "R", 1)
    assert set(tbench.VARIANTS) == set(qb.VARIANTS)
    (xj, wj, qwj, scj), (xt, wt, qwt, sct) = _bench_data(qb)
    ref = np.asarray(jax.jit(qb.VARIANTS[name][0])(xj, wj, qwj, scj))
    got = tbench.variant(name, xt, wt, qwt, sct).numpy()
    assert got.shape == ref.shape == (8, 5120)
    tol = (2.0**-22 if name == "w8a8_n2560" else 2.0**-20) * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    assert tbench.VARIANTS[name][2] == qb.VARIANTS[name][1]  # the JAX file's byte counts


# the kernel's launch grid (``_grid``), checked on the CPU: (M, K, N, G)
GRID_SHAPES = [(8, 1280, 5120, 10), (5, 256, 384, 1), (13, 512, 1024, 1), (3, 256, 512, 8), (16, 1024, 640, 2),
               (8, 5120, 1280, 40), (8, 1024, 256, 8), (8, 1280, 10240, 10), (8, 1280, 20480, 10),
               (33, 1280, 5120, 10), (8, 1280, 8576, 10), (8, 1280, 17024, 10)]


@pytest.mark.parametrize("which", ["qmm2", "qmm3", "qmm4"])
@pytest.mark.parametrize("M,K,N,G", GRID_SHAPES)
def test_grid_covers_every_output_once(which, M, K, N, G):
    """Every (row, column) of out belongs to exactly one CTA: strips of 32
    columns by tiles of 8 rows; the cluster divides the strips and the smem
    fits a block."""
    grid = tq._grid(which, M, K, N, G)
    strip = tq._STRIP
    cover = np.zeros((grid.row_tiles * 8, N), np.int64)
    for by in range(grid.row_tiles):
        for bx in range(N // strip):
            cover[by * 8:(by + 1) * 8, bx * strip:(bx + 1) * strip] += 1
    assert grid.ctas == (N // strip) * grid.row_tiles
    assert (cover[:M] == 1).all() and grid.row_tiles == -(-M // 8)
    assert (N // strip) % tq._CLUSTER == 0 and grid.smem <= tq._MAX_SMEM


@pytest.mark.parametrize("which", ["qmm2", "qmm3", "qmm4"])
def test_grid_fills_the_card_at_the_bench_shape(which):
    """At 8x1280x5120 on 132 SMs: at least a CTA an SM, two CTAs fit an SM's
    228 KB, at least 3 stages of 8 KB each, and at least 3.3 MB of weight
    bytes in flight over the card (Little's law at 3.35 TB/s and ~1 us)."""
    grid = tq._grid(which, 8, 1280, 5120, 10)
    assert grid.ctas >= 132 and grid.stages >= 3
    assert 2 * (grid.smem + 1024) <= 233472
    assert grid.ctas * grid.stages * tq._BOX_BYTES >= 3.3e6


@pytest.mark.parametrize("which", ["qmm2", "qmm3", "qmm4"])
def test_grid_does_not_depend_on_block_n(which):
    """``block_n`` is checked as the JAX code checks it and sets nothing: the
    bench's three qmm2 tilings, and every other legal block, give one grid."""
    _, (x, qw, sc) = _layer()
    grids = {tq._plan(which, x, qw, sc, bn, None) for bn in (128, 256, 512, 640, 1024, 1280, 2560, 5120)}
    assert len(grids) == 1


@pytest.mark.parametrize("which,M,K,N,G,block_n,match", [
    ("qmm2", 8, 384, 256, 8, 128, "multiple of 32"),   # groups of 48 rows
    ("qmm3", 8, 2048, 256, 2, 128, "at most 512"),     # groups of 1024 rows
    ("qmm4", 8, 96, 256, 1, 128, "multiple of 64"),    # K = 96: one group of 96, x's slabs of 64
    ("qmm2", 8, 32768, 256, 64, 128, "shared memory"),  # x's rows alone fill a block's shared memory
    ("qmm3", 8, 256, 256, 2, 64, "multiple of 128"),   # block_n 64
    ("qmm4", 8, 256, 512, 2, 384, "block_n"),          # block_n does not divide N
])
def test_grid_refuses_what_the_kernel_cannot_take(which, M, K, N, G, block_n, match):
    """The host refuses, before any launch, what the kernel cannot take."""
    x, qw, sc = torch.zeros((M, K), dtype=torch.bfloat16), torch.zeros((K, N), dtype=torch.int8), \
        torch.zeros((G, N), dtype=torch.float32)
    with pytest.raises(ValueError, match=match):
        tq._plan(which, x, qw, sc, block_n, None)
