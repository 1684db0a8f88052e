"""The port's CUDA kernels against their plain versions on the card, at the
edge shapes of each kernel's contract: one quantization group over all of K,
M not a multiple of the row tile, many K splits, the padded vocab; T and Tk
edges, Tk != T, non-causal, GQA, head dims 64 and 128, for the forward and
the two backward kernels (the forward also at every edge of its 128-row
tiles, causal with Tk above and below T, T = 2048 under a per-row relative
L2 gate, bitwise repeats, NaN past Tk changing no bit, a refused scale) (with an lse cotangent, a row that attends nothing,
bitwise-equal repeats, and autograd through the forward; the backward
kernels also at T and Tk off their 64-row tiles both ways, GQA groups 1, 4
and 8, T = 4096, rows with lse -inf in several tiles, under a per-row
relative L2 gate, NaN past T in q, dO, lse and delta and past Tk in k and v
changing no bit, any finite scale taken and a non-finite one refused); empty decode windows,
per-row and scalar ends, left-pad starts; for the fused decode layer, batches
other than 8, G=1, contractions longer than 1024, gated and ungated MLPs,
every activation, head dims 64 and 128 with and without RoPE, and a fully
padded row; kernels A and C and the int8 head at the scheduler's chunk
width (M = 8 slots x 64 columns = 512 rows); kernels A and C's rows bitwise
across M on every path of their plan (mma.sync, wgmma with K split, wgmma
with the chain in registers), RoPE at hd 128 above 32 rows, C at the verify
width M = 40, and shapes that keep mma.sync at every M.
The paged modes: dead slots (ends 0), start > 0, bf16 and int8 KV, GQA up
to g = 8, spans T of 1 to 100 (folded rows across several 64-row tiles),
windows reaching the end of the cache; the fused slot-pool step through
every kernel against its plain versions; and the sampler's draws, bitwise
equal on the card and the CPU. The extent modes (long context): one extent,
a chain ending exactly at an extent boundary, a lossy window that keeps
nothing of a row, D 64 and 128, bf16 and int8 KV, against their plain
versions, an identity table bitwise equal to the paged modes and a chain
bitwise equal to one big slot; a chained request's K/V in the pool bitwise
equal to one big slot's, with the dead-row write collision planted. And
quant_matmul's rows bitwise the same whatever M shares the call (1 to 1024
rows, across every tile edge, at gpt2-large's and llama3-8b's projection and head shapes). The
block-sparse kernels (forward, dq, dk/dv) at blocks 16/32/64/128 and head
dims 64/128, causal or not, on a layout with blocks above the diagonal, an
empty q row, a kv block no query reads and a row that reads only the
future, also with the forward's and dk/dv's walks cut every 2 table
positions (split over CTAs and merged); a ragged T, also cut every 3;
rows and columns of exactly CHUNK and CHUNK + 1 blocks, and the split plan
against the one-piece plan; different layouts per head; bitwise-equal
repeats of all three kernels; autograd through ``SparseSelfAttention``; and the ValueErrors for
what the kernels do not take (fp32, head dim 96, block 48, tables off the
card). The decode-shape microbench's kernels (qmm2, qmm3, qmm4) at long K
and narrow N, bitwise repeats, qmm4's
in-kernel quantization on ties at .5, a zero row and a large row, and one
allocation a call (the output).
``chip_smoke.py`` covers the main path's shapes; this file covers the rest.

These tests need an NVIDIA card with the CUDA toolkit (a CUDA kernel has no
CPU mode): they carry the ``cuda`` marker and skip without a card. On the
card, from the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX's CPU mesh, and this
file needs no JAX.)"""

import dataclasses

import pytest
import torch

from deepspeed_tpu_torch.inference.scheduler import sample_uniforms
from deepspeed_tpu_torch.models.transformer import CausalLMModel, TransformerConfig
import numpy as np

import deepspeed_tpu_torch
from deepspeed_tpu_torch.ops.decode_attention import (decode_attention, decode_attention_plain,
                                                      extent_paged_decode_attention,
                                                      extent_paged_decode_attention_plain,
                                                      extent_paged_span_attention,
                                                      extent_paged_span_attention_plain,
                                                      paged_decode_attention,
                                                      paged_decode_attention_plain,
                                                      paged_span_attention,
                                                      paged_span_attention_plain)
from deepspeed_tpu_torch.ops.quantizer import quantize_kv_rows
from deepspeed_tpu_torch.ops.decode_block import (fused_decode_block, fused_out_mlp,
                                                  fused_out_mlp_plain, fused_qkv_ln,
                                                  fused_qkv_ln_plain)
from deepspeed_tpu_torch.ops.flash_attention import (_group_sum, flash_attention, flash_attention_bwd,
                                                     flash_attention_bwd_plain, flash_attention_fwd,
                                                     flash_attention_plain, flash_attention_with_lse,
                                                     flash_bwd_dkv, flash_bwd_dq)
from deepspeed_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def _assert_close(out, ref, what):
    """bf16 outputs (the working type): within one bf16 ulp at the largest
    magnitude, 2^-7 of max|ref| (so an all-zero reference needs exact
    zeros). fp32 outputs (the qmm fp32 path, the flash lse): the kernel and
    the plain version sum in other orders, within 1e-3 absolute or 1e-4 of
    max|ref|, whichever is larger."""
    assert out.shape == ref.shape and out.dtype == ref.dtype, what
    finite = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(out), finite), f"{what}: non-finite entries differ"
    assert torch.equal(out[~finite], ref[~finite]), f"{what}: infinities differ"
    o, r = out[finite].float(), ref[finite].float()
    if r.numel() == 0:
        return
    scale = float(r.abs().max())
    tol = 2.0**-7 * scale if out.dtype == torch.bfloat16 else max(1e-3, 1e-4 * scale)
    err = float((o - r).abs().max())
    assert err <= tol, f"{what}: max abs err {err:.3e} > {tol:.3e}"


# the decode kernel's and the flash forward's outputs are also held to a
# relative L2 error in each row (the D outputs of one folded decode row,
# head and column; of one flash (b, h, query row)), as chip_smoke.py holds
# them (DECODE_ROW_REL_L2, FLASH_ROW_REL_L2): max|ref| is set by the short
# windows or rows, so the max-abs gate alone would pass a long window that
# lost one 512-position chunk in the merge, or a long row that lost a
# 128-key tile. (chip_smoke.py's decode gate over a whole output is
# calibrated at full-size outputs; at these sizes one bf16 ulp of a large
# entry can pass it.)
ROW_REL_L2 = 2.0**-6


def _assert_rows_close(out, ref, what):
    """``_assert_close``, then each row of the last axis within
    ``ROW_REL_L2`` relative L2 error; a row whose reference is all zeros
    (an empty window) is all zeros."""
    _assert_close(out, ref, what)
    o, r = out.float().reshape(-1, out.shape[-1]), ref.float().reshape(-1, ref.shape[-1])
    num, den = (o - r).norm(dim=1), r.norm(dim=1)
    assert not bool(num[den == 0].any()), f"{what}: an empty window's row is not zeros"
    if bool((den > 0).any()):
        row = float((num[den > 0] / den[den > 0]).max())
        assert row <= ROW_REL_L2, f"{what}: a row's rel L2 err {row:.3e} > {ROW_REL_L2:g}"


# (M, K, N, G): G=1 (quantize_params' fallback when 128 does not divide K);
# M not a multiple of the 8-row tile; K split into many blocks (N too
# narrow to fill the card); the int8 head's padded vocab; a ragged prefill
# M; a group size that is not a multiple of 8 (K=196) and N not a multiple
# of 16 (the element-wise loads, at M <= 32 and above, where such shapes
# keep the mma.sync path); a last column tile of the wgmma path cut at
# N = 400 (the TMA box zero-fills past it)
QMM_CASES = [(1, 1280, 1280, 1), (5, 200, 64, 1), (13, 256, 384, 2), (3, 5120, 128, 40),
             (8, 1280, 51200, 10), (1030, 1280, 1280, 10), (9, 196, 100, 1), (40, 1000, 260, 1),
             (100, 256, 400, 2)]


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N,G", QMM_CASES)
def test_quant_matmul_kernel_matches_plain(dev, M, K, N, G, out_dtype):
    g = _gen(dev, M + K + N)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    qw = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
    sc = torch.rand((G, N), generator=g, device=dev) * 0.01 + 1e-4
    before = quant_matmul.launches
    out = quant_matmul(x, qw, sc, out_dtype=out_dtype)
    assert quant_matmul.launches == before + 1  # a CUDA tensor always launches
    torch.cuda.synchronize()
    _assert_close(out, quant_matmul_plain(x, qw, sc, out_dtype=out_dtype), f"qmm {M}x{K}x{N} G={G}")
    # no atomics: a second launch agrees bitwise
    assert torch.equal(quant_matmul(x, qw, sc, out_dtype=out_dtype), out)


# every tile edge of the kernel's M configurations (8, 16, 32 rows; 128 rows
# of the wide one) at one group over K and at groups of 128, for bf16 and
# fp32 out: M 1, 7, 9, 32 (the narrow tiles), 33 (the first wide M), 63,
# 65 and 1000 (a ragged last wide tile)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("G", [1, 10])
@pytest.mark.parametrize("M", [1, 7, 9, 32, 33, 63, 65, 1000])
def test_quant_matmul_kernel_matches_plain_at_ragged_m(dev, M, G, out_dtype):
    K, N = 1280, 1280
    g = _gen(dev, M + 7 * G)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    qw = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
    sc = torch.rand((G, N), generator=g, device=dev) * 0.01 + 1e-4
    out = quant_matmul(x, qw, sc, out_dtype=out_dtype)
    torch.cuda.synchronize()
    _assert_close(out, quant_matmul_plain(x, qw, sc, out_dtype=out_dtype), f"qmm M={M} G={G}")


@pytest.mark.parametrize("M", [8, 16, 1024])
def test_quant_matmul_two_calls_bitwise(dev, M):
    """Run to run: the split-K path (M 8 and 16, its partials summed by a
    second launch) and the wide path (M 1024) give the same bits twice."""
    g = _gen(dev, 11 * M)
    x = torch.randn((M, 5120), generator=g, device=dev).to(torch.bfloat16)
    qw = torch.randint(-127, 128, (5120, 1280), generator=g, device=dev, dtype=torch.int8)
    sc = torch.rand((40, 1280), generator=g, device=dev) * 0.01 + 1e-4
    outs = [quant_matmul(x, qw, sc, out_dtype=torch.float32) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


def test_quant_matmul_kernel_refuses_what_it_does_not_take(dev):
    x = torch.randn((8, 256), device=dev)
    qw = torch.zeros((256, 128), dtype=torch.int8, device=dev)
    sc = torch.ones((2, 128), device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        quant_matmul(x, qw, sc)  # fp32 activations
    with pytest.raises(ValueError, match="multiple of 4"):
        quant_matmul(x.to(torch.bfloat16)[:, :256], qw[:, :126].contiguous(), sc[:, :126].contiguous())


# (B, H, Hkv, T, Tk, D, causal): T edges inside a 32-row tile; non-causal
# GQA at D=128; Tk != T; GQA g=4 at D=128 (llama); g=2 causal over two tiles
FLASH_CASES = [(1, 2, 2, 100, 100, 64, True), (2, 4, 2, 70, 70, 128, False),
               (1, 2, 1, 64, 96, 64, False), (1, 8, 2, 160, 160, 128, True),
               (2, 4, 2, 33, 33, 64, True)]


@pytest.mark.parametrize("B,H,Hkv,T,Tk,D,causal", FLASH_CASES)
def test_flash_kernel_matches_plain(dev, B, H, Hkv, T, Tk, D, causal):
    g = _gen(dev, T + Tk + D)
    q = torch.randn((B, H, T, D), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, Hkv, Tk, D), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, Hkv, Tk, D), generator=g, device=dev).to(torch.bfloat16)
    before = flash_attention_fwd.launches
    out, lse = flash_attention_with_lse(q, k, v, causal=causal)
    assert flash_attention_fwd.launches == before + 1
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    what = f"flash B={B} H={H}/{Hkv} T={T} Tk={Tk} D={D} causal={causal}"
    _assert_close(out, ref_out, what + " out")
    _assert_close(lse, ref_lse, what + " lse")


# (B, H, Hkv, T, Tk, D, causal): T not a multiple of the 32-row tile; Tk != T
# non-causal; g=4 at D=128 (llama); g=4 ragged non-causal at D=128; causal
# with more keys than queries (kv tiles no query reaches get zeros); then
# against the kernels' 64-row tiles (dq: 64 q rows a CTA, 64-key K/V tiles;
# dk/dv: 64 kv rows a warpgroup, 128 a CTA at D = 128, 64-row Q/dO tiles):
# T and Tk at 63, 65, 127, 129, 191 and 300, T != Tk both ways, causal and
# not, up to 15 distinct heads (a box read across a head's edge would show)
BWD_CASES = [(2, 4, 4, 100, 100, 64, True), (1, 4, 4, 64, 96, 64, False),
             (1, 8, 2, 128, 128, 128, True), (2, 4, 1, 77, 77, 128, False),
             (1, 2, 2, 40, 70, 64, True),
             (1, 2, 2, 63, 63, 64, True), (2, 2, 1, 65, 65, 128, True),
             (1, 4, 2, 127, 129, 64, True), (1, 4, 2, 129, 127, 128, True),
             (1, 2, 2, 191, 300, 64, True), (1, 2, 2, 300, 191, 128, True),
             (2, 3, 3, 100, 77, 64, False), (1, 4, 1, 77, 200, 128, False),
             (3, 5, 5, 129, 129, 128, True), (2, 4, 4, 200, 200, 64, False)]


def _bwd_inputs(dev, B, H, Hkv, T, Tk, D, causal, seed):
    g = _gen(dev, seed)
    q = torch.randn((B, H, T, D), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, Hkv, Tk, D), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, Hkv, Tk, D), generator=g, device=dev).to(torch.bfloat16)
    do = torch.randn((B, H, T, D), generator=g, device=dev).to(torch.bfloat16)
    g_lse = torch.randn((B, H, T), generator=g, device=dev)
    out, lse = flash_attention_plain(q, k, v, causal=causal)
    return q, k, v, do, g_lse, out, lse


# the flash backward's rows (dq: one (b, h, q row); dk, dv: one (b, kv head,
# kv row)) are held to ROW_REL_L2 of their norm or of BWD_ROW_FLOOR times the
# rms of the output's row norms, whichever is larger, as chip_smoke.py holds
# them (FLASH_BWD_ROW_REL_L2): dq's first causal row attends one key, where
# dp - delta vanishes but for rounding, so its own norm is no yardstick.
BWD_ROW_FLOOR = 2.0**-4


def _assert_bwd_rows_close(out, ref, what):
    """``_assert_close``, then every row within the floored row gate; an
    all-zero reference needs exact zeros."""
    _assert_close(out, ref, what)
    o, r = out.float().reshape(-1, out.shape[-1]), ref.float().reshape(-1, ref.shape[-1])
    num, den = (o - r).norm(dim=1), r.norm(dim=1)
    floor = BWD_ROW_FLOOR * float(den.square().mean().sqrt())
    if floor == 0:
        assert not bool(num.any()), f"{what}: not zeros"
        return
    row = float((num / den.clamp_min(floor)).max())
    assert row <= ROW_REL_L2, f"{what}: a row's rel L2 err {row:.3e} > {ROW_REL_L2:g}"


def _bwd_kernels(q, k, v, do, lse, delta, causal, scale=None):
    """(dq, dk, dv) of the two backward kernels, dk/dv summed over the GQA
    group."""
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    return dq, _group_sum(dk, k.shape[1]), _group_sum(dv, k.shape[1])


def _check_bwd(dev, q, k, v, do, out, lse, causal, what, scale=None):
    """The kernels against the plain backward under the row gate, and two
    calls bitwise equal."""
    delta = (do.float() * out.float()).sum(-1)
    got = _bwd_kernels(q, k, v, do, lse, delta, causal, scale)
    again = _bwd_kernels(q, k, v, do, lse, delta, causal, scale)
    torch.cuda.synchronize()
    ref = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal, scale=scale)
    for name, a, b, r in zip(("dq", "dk", "dv"), got, again, ref):
        assert torch.equal(a, b), f"{what} {name}: two calls differ"
        assert bool(torch.isfinite(a.float()).all()), f"{what} {name}: non-finite entries"
        _assert_bwd_rows_close(a, r, f"{what} {name}")


@pytest.mark.parametrize("with_lse_grad", [False, True])
@pytest.mark.parametrize("B,H,Hkv,T,Tk,D,causal", BWD_CASES)
def test_flash_bwd_kernels_match_plain(dev, B, H, Hkv, T, Tk, D, causal, with_lse_grad):
    q, k, v, do, g_lse, out, lse = _bwd_inputs(dev, B, H, Hkv, T, Tk, D, causal, T + Tk + D + H)
    g_lse = g_lse if with_lse_grad else None
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal, g_lse=g_lse)
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    again = flash_attention_bwd(q, k, v, out, lse, do, causal=causal, g_lse=g_lse)
    torch.cuda.synchronize()
    ref = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal, g_lse=g_lse)
    what = f"flash bwd B={B} H={H}/{Hkv} T={T} Tk={Tk} D={D} causal={causal} g_lse={with_lse_grad}"
    for name, a, b, r in zip(("dq", "dk", "dv"), got, again, ref):
        assert torch.equal(a, b), f"{what} {name}: two calls differ"  # no atomics
        _assert_bwd_rows_close(a, r, f"{what} {name}")


def test_flash_bwd_kernels_row_that_attends_nothing(dev):
    """lse = -inf (a row that attended nothing) reads as lse 0 in both
    kernels, as in the TPU kernels and the plain version."""
    q, k, v, do, _, out, lse = _bwd_inputs(dev, 1, 4, 2, 64, 64, 64, True, 11)
    lse[0, 1, 5] = float("-inf")
    lse[0, 3, 40] = float("-inf")
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    ref = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert bool(torch.isfinite(a.float()).all()), name
        _assert_close(a, r, f"flash bwd -inf lse rows {name}")


def test_flash_bwd_kernels_refuse_what_they_do_not_take(dev):
    q, k, v, do, _, out, lse = _bwd_inputs(dev, 1, 2, 2, 64, 64, 64, True, 12)
    delta = (do.float() * out.float()).sum(-1)
    with pytest.raises(ValueError, match="lse"):
        flash_bwd_dq(q, k, v, do, lse.double(), delta)
    with pytest.raises(ValueError, match="dout"):
        flash_bwd_dkv(q, k, v, do.float(), lse, delta)
    q32 = torch.randn((1, 2, 64, 32), device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_bwd_dq(q32, q32, q32, q32, lse, delta)


@pytest.mark.parametrize("Hkv", [4, 1])
def test_autograd_through_flash_on_the_card(dev, Hkv):
    """Backward through flash_attention on CUDA tensors (the kernels) gives
    the plain version's gradients within the bf16 rule."""
    g = _gen(dev, 21 + Hkv)
    q = torch.randn((2, 4, 160, 64), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((2, Hkv, 160, 64), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((2, Hkv, 160, 64), generator=g, device=dev).to(torch.bfloat16)
    do = torch.randn((2, 4, 160, 64), generator=g, device=dev).to(torch.bfloat16)
    grads = {}
    for impl in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention(*leaves, causal=True, impl=impl)
        assert out.grad_fn is not None
        out.backward(do)
        grads[impl] = [t.grad for t in leaves]
    torch.cuda.synchronize()
    for name, a, r in zip(("dq", "dk", "dv"), grads["kernel"], grads["plain"]):
        assert a is not None, name
        _assert_close(a, r, f"autograd flash Hkv={Hkv} {name}")


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_flash_bwd_kernels_gqa_groups(dev, group, D):
    """GQA groups 1, 4 and 8: every query head of a group reads one KV head;
    dk/dv per query head, summed after."""
    q, k, v, do, _, out, lse = _bwd_inputs(dev, 2, 8, 8 // group, 256, 256, D, True, 17 * group + D)
    _check_bwd(dev, q, k, v, do, out, lse, True, f"flash bwd GQA g={group} D={D}")


@pytest.mark.parametrize("Hkv,D", [(1, 128), (2, 64)])
def test_flash_bwd_kernels_long_rows(dev, Hkv, D):
    """T = 4096 causal: the dq walk of the last q tile is 32 to 64 K/V
    tiles, the dk/dv walk of the first kv tile 64 Q/dO tiles."""
    q, k, v, do, _, out, lse = _bwd_inputs(dev, 1, 2, Hkv, 4096, 4096, D, True, 4096 + D)
    _check_bwd(dev, q, k, v, do, out, lse, True, f"flash bwd T=4096 Hkv={Hkv} D={D}")


@pytest.mark.parametrize("D", [64, 128])
def test_flash_bwd_kernels_rows_with_neg_inf_lse(dev, D):
    """lse = -inf rows in several q tiles (first, last, across a tile edge)
    read as lse 0 in both kernels."""
    q, k, v, do, _, out, lse = _bwd_inputs(dev, 2, 4, 2, 200, 200, D, True, 13 + D)
    for b, h, r in ((0, 0, 0), (0, 1, 63), (0, 3, 64), (1, 2, 130), (1, 3, 199)):
        lse[b, h, r] = float("-inf")
    _check_bwd(dev, q, k, v, do, out, lse, True, f"flash bwd -inf lse rows D={D}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_bwd_kernels_read_nothing_past_t_and_tk(dev, D, causal):
    """q, dO, lse and delta are the leading T = 150 rows, k and v the
    leading Tk = 200 rows, of buffers whose later rows are NaN (B = H = Hkv
    = 1, so the views are contiguous): the kernels' edge boxes fill zeros,
    so the gradients are bitwise the clean call's."""
    g = _gen(dev, 43 + D)
    T, Tk = 150, 200

    def leading(n, rows):  # the leading n rows of a (1, 1, rows, D) buffer with a NaN tail
        buf = torch.randn((1, 1, rows, D), generator=g, device=dev).to(torch.bfloat16)
        buf[:, :, n:] = float("nan")
        return buf[:, :, :n]

    def vec(x):  # x (1, 1, T) fp32 as the leading T entries of a buffer with a NaN tail
        buf = torch.full((1, 1, 256), float("nan"), device=dev)
        buf[..., :T] = x
        return buf[..., :T]

    q, do = leading(T, 256), leading(T, 256)
    k, v = leading(Tk, 384), leading(Tk, 384)
    out, lse = flash_attention_plain(q, k, v, causal=causal)
    delta = (do.float() * out.float()).sum(-1)
    lse_v, delta_v = vec(lse), vec(delta)
    assert all(t.is_contiguous() for t in (q, do, k, v, lse_v, delta_v))
    got = _bwd_kernels(q, k, v, do, lse_v, delta_v, causal)
    clean = _bwd_kernels(*(t.clone() for t in (q, k, v, do, lse, delta)), causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, clean):
        assert bool(torch.isfinite(a.float()).all()), f"{name}: a NaN past T or Tk reached it"
        assert torch.equal(a, b), f"{name}: the NaN tails changed the result"
    ref = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        _assert_bwd_rows_close(a, r, f"flash bwd NaN tails D={D} causal={causal} {name}")


def test_flash_bwd_kernels_take_any_finite_scale(dev):
    """No row max: a scale of 0.3, or below 0, works (the plain version's
    arithmetic); an infinite or NaN one is refused."""
    for scale in (0.3, -0.2):
        g = _gen(dev, 31)
        q, k, v, do = (torch.randn((1, 4, 130, 64), generator=g, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        out, lse = flash_attention_plain(q, k[:, :2], v[:, :2], causal=True, scale=scale)
        _check_bwd(dev, q, k[:, :2].contiguous(), v[:, :2].contiguous(), do, out, lse, True,
                   f"flash bwd scale={scale}", scale=scale)
    q, k, v, do, _, out, lse = _bwd_inputs(dev, 1, 2, 2, 64, 64, 64, True, 12)
    delta = (do.float() * out.float()).sum(-1)
    for scale in (float("inf"), float("nan")):
        with pytest.raises(ValueError, match="scale"):
            flash_bwd_dq(q, k, v, do, lse, delta, scale=scale)
        with pytest.raises(ValueError, match="scale"):
            flash_bwd_dkv(q, k, v, do, lse, delta, scale=scale)


def _flash_inputs(dev, B, H, Hkv, T, Tk, D, seed):
    g = _gen(dev, seed)
    q = torch.randn((B, H, T, D), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, Hkv, Tk, D), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, Hkv, Tk, D), generator=g, device=dev).to(torch.bfloat16)
    return q, k, v


def _assert_flash_close(got, ref, what):
    """out by ``_assert_rows_close``, lse by ``_assert_close``."""
    _assert_rows_close(got[0], ref[0], what + " out")
    _assert_close(got[1], ref[1], what + " lse")


# (B, H, Hkv, T, Tk, D, causal) against the kernel's q tiles (64 rows at
# D = 64, 128 at D = 128) and 128-key K/V tiles: T at 127, 128, 129 and 255;
# T < 64 (at D = 128 one warpgroup's rows all padding); causal with Tk > T
# and with Tk < T (rows past Tk attend every key); g = 1 and g = 4 at D = 64
# and D = 128; B*H up to 15 distinct heads, so a box read across a head's
# edge would show
FLASH_EDGE_CASES = [(1, 2, 2, 127, 127, 64, True), (1, 2, 2, 128, 128, 128, True),
                    (2, 2, 1, 129, 129, 64, True), (1, 4, 1, 255, 255, 128, True),
                    (2, 3, 3, 40, 40, 64, True), (1, 2, 2, 17, 17, 128, False),
                    (1, 4, 2, 100, 300, 128, True), (1, 4, 2, 300, 100, 64, True),
                    (1, 4, 2, 129, 257, 64, False), (2, 4, 4, 200, 200, 64, True),
                    (2, 8, 2, 200, 200, 64, True), (2, 4, 4, 200, 200, 128, False),
                    (2, 8, 2, 200, 200, 128, True), (3, 5, 5, 129, 129, 128, False)]


@pytest.mark.parametrize("B,H,Hkv,T,Tk,D,causal", FLASH_EDGE_CASES)
def test_flash_kernel_tile_edges(dev, B, H, Hkv, T, Tk, D, causal):
    q, k, v = _flash_inputs(dev, B, H, Hkv, T, Tk, D, 7 * T + Tk + D + H)
    got = flash_attention_with_lse(q, k, v, causal=causal)
    again = flash_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    what = f"flash B={B} H={H}/{Hkv} T={T} Tk={Tk} D={D} causal={causal}"
    assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: two calls differ"
    _assert_flash_close(got, flash_attention_plain(q, k, v, causal=causal), what)


@pytest.mark.parametrize("Hkv,D", [(1, 128), (4, 64)])
def test_flash_kernel_long_rows(dev, Hkv, D):
    """T = 2048, 16 K/V tiles a long row: every row within the row gate."""
    q, k, v = _flash_inputs(dev, 1, 4, Hkv, 2048, 2048, D, 2048 + D)
    got = flash_attention_with_lse(q, k, v, causal=True)
    torch.cuda.synchronize()
    _assert_flash_close(got, flash_attention_plain(q, k, v, causal=True), f"flash T=2048 Hkv={Hkv} D={D}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernel_reads_no_kv_row_past_tk(dev, D, causal):
    """k and v are the leading Tk = 150 rows of buffers whose later rows are
    NaN (B = Hkv = 1, so the views are contiguous): the kernel's edge boxes
    fill zeros past Tk, so the result is bitwise the clean call's."""
    g = _gen(dev, 41 + D)
    q = torch.randn((1, 4, 200, D), generator=g, device=dev).to(torch.bfloat16)
    bufs = [torch.randn((1, 1, 384, D), generator=g, device=dev).to(torch.bfloat16) for _ in range(2)]
    for b in bufs:
        b[:, :, 150:] = float("nan")
    k, v = (b[:, :, :150] for b in bufs)
    assert k.is_contiguous() and v.is_contiguous()
    got = flash_attention_with_lse(q, k, v, causal=causal)
    clean = flash_attention_with_lse(q, k.clone(), v.clone(), causal=causal)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got[0].float()).all()), "a NaN past Tk reached the output"
    assert all(torch.equal(a, b) for a, b in zip(got, clean)), "the NaN tail changed the result"


def test_flash_kernel_refuses_a_scale_it_does_not_take(dev):
    q, k, v = _flash_inputs(dev, 1, 2, 2, 64, 64, 64, 5)
    for scale in (0.0, -0.3, float("inf")):
        with pytest.raises(ValueError, match="scale"):
            flash_attention_fwd(q, k, v, causal=True, scale=scale)


def test_flash_kernel_explicit_scale(dev):
    g = _gen(dev, 3)
    q, k, v = (torch.randn((1, 2, 64, 64), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    out, lse = flash_attention_with_lse(q, k, v, causal=True, scale=0.3)
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal=True, scale=0.3)
    _assert_close(out, ref_out, "flash scale=0.3 out")
    _assert_close(lse, ref_lse, "flash scale=0.3 lse")


# (B, H, nkv, S, D, starts, ends): an empty window (start == end) and a
# one-slot window; GQA g=2 and the largest g=8 at D=128; per-row ends
# (the scheduler's contract) and a scalar end (the static engine's)
DECODE_CASES = [
    (3, 4, 4, 64, 64, [10, 0, 63], [10, 1, 64]),
    (4, 8, 4, 256, 64, [0, 5, 63, 0], 129),
    (2, 32, 4, 512, 128, [0, 300], [512, 301]),
    (3, 20, 20, 256, 64, [0, 17, 40], [129, 200, 255]),
]


@pytest.mark.parametrize("B,H,nkv,S,D,starts,ends", DECODE_CASES)
def test_decode_kernel_matches_plain(dev, B, H, nkv, S, D, starts, ends):
    g = _gen(dev, S + H)
    q = torch.randn((B, H, D), generator=g, device=dev).to(torch.bfloat16)
    kc = torch.randn((B, nkv, S, D), generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn((B, nkv, S, D), generator=g, device=dev).to(torch.bfloat16)
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    end = ends if isinstance(ends, int) else torch.tensor(ends, dtype=torch.int32, device=dev)
    before = decode_attention.launches
    out = decode_attention(q, kc, vc, start, end)
    assert decode_attention.launches == before + 1
    torch.cuda.synchronize()
    _assert_rows_close(out, decode_attention_plain(q, kc, vc, start, end),
                  f"decode B={B} H={H}/{nkv} S={S} D={D}")
    empty = [b for b in range(B) if starts[b] >= (ends if isinstance(ends, int) else ends[b])]
    for b in empty:  # l = 0 is guarded to 1: the row's output is exactly 0
        assert torch.equal(out[b], torch.zeros_like(out[b]))


def _proj(g, dev, K, N, G):
    return (torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8),
            torch.rand((G, N), generator=g, device=dev) * 0.02 + 1e-3,
            torch.randn((N, ), generator=g, device=dev) * 0.1)


def _norms(g, dev, H, norm):
    n = torch.randn((4, H), generator=g, device=dev) * 0.1
    n[0] += 1.0
    n[2] += 1.0
    if norm == "rmsnorm":  # rmsnorm models pass zero bias rows
        n[1] = 0.0
        n[3] = 0.0
    return n


def _rope(g, dev, B, hd):
    ang = torch.rand((B, hd // 2), generator=g, device=dev) * 6.0
    return torch.sin(ang), torch.cos(ang)


# (B, H, nh, nkv, hd, G, rope, norm): gpt2-large and llama3-8b; B=3 with one
# group over a K of 200 (not a whole 64-row chunk); B=13 (two row tiles) at
# hd 128 without RoPE; B=1 over K=1152 (> 1024) with RoPE at hd 64
QKV_CASES = [(8, 1280, 20, 20, 64, 10, False, "layernorm"), (4, 4096, 32, 8, 128, 32, True, "rmsnorm"),
             (3, 200, 2, 1, 64, 1, True, "rmsnorm"), (13, 512, 4, 2, 128, 4, False, "layernorm"),
             (1, 1152, 6, 2, 64, 9, True, "layernorm")]


@pytest.mark.parametrize("B,H,nh,nkv,hd,G,rope,norm", QKV_CASES)
def test_fused_qkv_ln_kernel_matches_plain(dev, B, H, nh, nkv, hd, G, rope, norm):
    g = _gen(dev, B + H + hd)
    x = (torch.randn((B, H), generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)
    norms = _norms(g, dev, H, norm)
    qkv = _proj(g, dev, H, (nh + 2 * nkv) * hd, G)
    rope_op = (*_rope(g, dev, B, hd), nh + nkv, hd) if rope else None
    before = fused_qkv_ln.launches
    out = fused_qkv_ln(x, norms, qkv, norm=norm, rope=rope_op)
    assert fused_qkv_ln.launches == before + 1
    torch.cuda.synchronize()
    _assert_close(out, fused_qkv_ln_plain(x, norms, qkv, norm=norm, rope=rope_op),
                  f"qkv_ln B={B} H={H} heads {nh}/{nkv}x{hd} G={G} rope={rope}")
    assert torch.equal(fused_qkv_ln(x, norms, qkv, norm=norm, rope=rope_op), out)  # deterministic


# (B, H, Ko, F, activation, norm, groups (o, up, down)): gpt2-large; llama3-8b
# (swiglu); G=1 everywhere with an F that is not a whole column tile; B=13
# with K=1152 > 1024 (several JAX k-blocks) and geglu; gelu_exact and
# quick_gelu at B=5
MLP_CASES = [(8, 1280, 1280, 5120, "gelu", "layernorm", (10, 10, 40)),
             (4, 4096, 4096, 14336, "swiglu", "rmsnorm", (32, 32, 112)),
             (3, 200, 128, 264, "relu", "rmsnorm", (1, 1, 1)),
             (13, 1152, 384, 512, "geglu", "layernorm", (3, 9, 4)),
             (5, 256, 256, 1024, "gelu_exact", "layernorm", (2, 2, 8)),
             (5, 256, 256, 1024, "quick_gelu", "rmsnorm", (2, 2, 8))]


@pytest.mark.parametrize("B,H,Ko,F,act,norm,G", MLP_CASES)
def test_fused_out_mlp_kernel_matches_plain(dev, B, H, Ko, F, act, norm, G):
    g = _gen(dev, B + H + F)
    attn = torch.randn((B, Ko), generator=g, device=dev).to(torch.bfloat16)
    x = (torch.randn((B, H), generator=g, device=dev) * 4).to(torch.bfloat16)
    norms = _norms(g, dev, H, norm)
    o, up, down = _proj(g, dev, Ko, H, G[0]), _proj(g, dev, H, F, G[1]), _proj(g, dev, F, H, G[2])
    gate = _proj(g, dev, H, F, G[1]) if act in ("swiglu", "geglu") else None
    kw = dict(activation=act, norm=norm, gate=gate)
    before = fused_out_mlp.launches
    out = fused_out_mlp(attn, x, norms, o, up, down, **kw)
    assert fused_out_mlp.launches == before + 1
    torch.cuda.synchronize()
    _assert_close(out, fused_out_mlp_plain(attn, x, norms, o, up, down, **kw),
                  f"out_mlp B={B} H={H} Ko={Ko} F={F} {act} {norm} G={G}")
    assert torch.equal(fused_out_mlp(attn, x, norms, o, up, down, **kw), out)  # deterministic


@pytest.mark.parametrize("hd,rope", [(64, False), (128, True)])
def test_fused_decode_block_matches_plain_with_a_fully_padded_row(dev, hd, rope):
    """Row 1's window [start, pos + 1) is empty: its attention is exactly 0
    and the layer still gives the residual path's result."""
    g = _gen(dev, hd)
    B, H, nh, nkv, S, F, pos = 3, 512, 8, 2, 256, 1024, 130
    x = torch.randn((B, H), generator=g, device=dev).to(torch.bfloat16)
    norms = _norms(g, dev, H, "rmsnorm" if rope else "layernorm")
    qkv = _proj(g, dev, H, (nh + 2 * nkv) * hd, 4)
    o, up, down = _proj(g, dev, nh * hd, H, nh * hd // 128), _proj(g, dev, H, F, 4), _proj(g, dev, F, H, 8)
    gate = _proj(g, dev, H, F, 4) if rope else None
    kc = torch.randn((B, nkv, S, hd), generator=g, device=dev).to(torch.bfloat16)
    vc = torch.randn((B, nkv, S, hd), generator=g, device=dev).to(torch.bfloat16)
    start = torch.tensor([0, pos + 1, 17], dtype=torch.int32, device=dev)
    kw = dict(activation="swiglu" if rope else "gelu", norm="rmsnorm" if rope else "layernorm",
              rope=_rope(g, dev, B, hd) if rope else None, gate=gate)
    caches = {impl: (kc.clone(), vc.clone()) for impl in ("kernel", "plain")}
    outs = {impl: fused_decode_block(x, norms, *caches[impl], qkv, o, up, down, start, pos,
                                     impl=impl, **kw)[0] for impl in ("kernel", "plain")}
    torch.cuda.synchronize()
    _assert_close(outs["kernel"], outs["plain"], f"decode block hd={hd} rope={rope}")
    for i in range(2):
        _assert_close(caches["kernel"][i], caches["plain"][i], f"cache {i} hd={hd}")
    # the padded row's output does not depend on the cache at all
    kc2, vc2 = torch.zeros_like(kc), torch.zeros_like(vc)
    again = fused_decode_block(x, norms, kc2, vc2, qkv, o, up, down, start, pos, **kw)[0]
    assert torch.equal(again[1], outs["kernel"][1])


# ---------------------------------------------------------------- slot-pool modes


def _kv(g, dev, B, nkv, S, D, int8):
    k = torch.randn((B, nkv, S, D), generator=g, device=dev) * 2
    v = torch.randn((B, nkv, S, D), generator=g, device=dev) * 2
    if int8:
        return quantize_kv_rows(k, v)
    return k.to(torch.bfloat16), v.to(torch.bfloat16), None


# (B, H, nkv, S, D, starts, ends): the gpt2-large pool with two dead slots;
# GQA g=8 at D=128 with a window to the end of the cache and start > 0;
# long windows over several 512-position chunks (S = 2048 and 4096), ending
# at, before and after a chunk boundary, one starting past the first chunk
PAGED_DECODE_CASES = [(8, 20, 20, 512, 64, [0] * 8, [130, 0, 257, 1, 0, 512, 64, 300]),
                      (3, 32, 4, 256, 128, [0, 100, 5], [256, 101, 0]),
                      (3, 20, 20, 2048, 64, [0, 700, 0], [2048, 1500, 513]),
                      (4, 32, 8, 4096, 128, [0, 0, 600, 0], [4096, 1024, 3001, 1023])]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,H,nkv,S,D,starts,ends", PAGED_DECODE_CASES)
def test_paged_decode_kernel_matches_plain(dev, B, H, nkv, S, D, starts, ends, int8):
    g = _gen(dev, S + H + int8)
    q = torch.randn((B, H, D), generator=g, device=dev).to(torch.bfloat16)
    kc, vc, sc = _kv(g, dev, B, nkv, S, D, int8)
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    end = torch.tensor(ends, dtype=torch.int32, device=dev)
    counter = "launches_int8" if int8 else "launches"
    before = getattr(paged_decode_attention, counter)
    out = paged_decode_attention(q, kc, vc, start, end, k_scale=sc, v_scale=sc)
    assert getattr(paged_decode_attention, counter) == before + 1
    torch.cuda.synchronize()
    _assert_rows_close(out, paged_decode_attention_plain(q, kc, vc, start, end, k_scale=sc,
                                                           v_scale=sc),
                  f"paged decode B={B} H={H}/{nkv} S={S} D={D} int8={int8}")
    for b in range(B):
        if ends[b] <= starts[b]:  # a dead slot: exactly zeros
            assert torch.equal(out[b], torch.zeros_like(out[b]))


# (B, H, nkv, T, S, D, starts, bases): the gpt2-large chunk step (one row
# prefilling 64 columns at base 128, seven rows of span 1 carried at T=64);
# llama's g=4 (256 folded rows, four tiles); T=5 with g=3 (15 rows, one
# partial tile); T=100 (two tiles) whose columns run past the cache end;
# T=1 (the substep width) with start > 0; long windows (S = 2048 and 4096)
# whose columns cross a 512-position chunk boundary or run past the cache
SPAN_CASES = [(8, 20, 20, 64, 512, 64, [0] * 8, [128, 0, 7, 300, 0, 64, 511, 200]),
              (4, 32, 8, 64, 512, 128, [0, 0, 0, 0], [0, 64, 190, 448]),
              (2, 6, 2, 5, 256, 64, [0, 3], [250, 17]),
              (2, 4, 2, 100, 256, 128, [0, 10], [200, 5]),
              (3, 8, 8, 1, 256, 64, [4, 0, 0], [9, 255, 0]),
              (3, 20, 20, 64, 2048, 64, [0, 0, 600], [1000, 2040, 1500]),
              (2, 32, 8, 64, 4096, 128, [0, 0], [4000, 480])]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,H,nkv,T,S,D,starts,bases", SPAN_CASES)
def test_paged_span_kernel_matches_plain(dev, B, H, nkv, T, S, D, starts, bases, int8):
    g = _gen(dev, T + S + H + int8)
    q = torch.randn((B, H, T, D), generator=g, device=dev).to(torch.bfloat16)
    kc, vc, sc = _kv(g, dev, B, nkv, S, D, int8)
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    base = torch.tensor(bases, dtype=torch.int32, device=dev)
    counter = "launches_int8" if int8 else "launches"
    before = getattr(paged_span_attention, counter)
    out = paged_span_attention(q, kc, vc, start, base, k_scale=sc, v_scale=sc)
    assert getattr(paged_span_attention, counter) == before + 1
    torch.cuda.synchronize()
    _assert_rows_close(out, paged_span_attention_plain(q, kc, vc, start, base, k_scale=sc, v_scale=sc),
                         f"paged span B={B} H={H}/{nkv} T={T} S={S} D={D} int8={int8}")
    assert torch.equal(paged_span_attention(q, kc, vc, start, base, k_scale=sc, v_scale=sc), out)


def test_paged_kernels_refuse_what_they_do_not_take(dev):
    q = torch.randn((2, 4, 64), device=dev)
    kc = torch.zeros((2, 4, 64, 64), device=dev, dtype=torch.bfloat16)
    ends = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        paged_decode_attention(q, kc, kc, 0, ends)  # fp32 queries
    with pytest.raises(ValueError, match="head dim"):
        paged_span_attention(torch.zeros((2, 4, 3, 32), device=dev, dtype=torch.bfloat16),
                             kc[..., :32].contiguous(), kc[..., :32].contiguous(), 0, ends)
    sc = torch.ones((2, 1, 64, 1), device=dev)  # fp32 scales
    with pytest.raises(ValueError, match="float16"):
        paged_decode_attention(q.to(torch.bfloat16), kc.to(torch.int8), kc.to(torch.int8), 0, ends,
                               k_scale=sc, v_scale=sc)


# (D, nkv, g): gpt2-large's heads (D 64, MHA) and llama3-8b's (D 128, GQA g=4)
INVARIANT_HEADS = [(64, 4, 1), (128, 2, 4)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("D,nkv,gq", INVARIANT_HEADS)
def test_span_column_equals_decode_bitwise(dev, D, nkv, gq, int8):
    """Every live column c of a paged span call (T = 64) is bitwise the
    paged decode call whose row has the same window [start, base + c + 1):
    columns share a CTA with longer windows, and rows whose columns cross
    the 512-position chunk boundaries (450 -> 514, 1000 -> 1064, 1500 ->
    1564) are merged across chunks."""
    g = _gen(dev, D + int8)
    B, S, T = 4, 2048, 64
    kc, vc, sc = _kv(g, dev, B, nkv, S, D, int8)
    q = torch.randn((B, nkv * gq, T, D), generator=g, device=dev).to(torch.bfloat16)
    start = torch.tensor([0, 0, 37, 0], dtype=torch.int32, device=dev)
    base = torch.tensor([450, 1000, 1500, 2000], dtype=torch.int32, device=dev)
    span = paged_span_attention(q, kc, vc, start, base, k_scale=sc, v_scale=sc)
    for c in range(T):
        live = (base + 1 + c <= S).nonzero()[:, 0]
        dec = paged_decode_attention(q[live, :, c].contiguous(), kc[live], vc[live], start[live],
                                     base[live] + 1 + c, k_scale=None if sc is None else sc[live],
                                     v_scale=None if sc is None else sc[live])
        assert torch.equal(span[live, :, c], dec), f"column {c} differs from its decode row"


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("D,nkv,gq", INVARIANT_HEADS)
def test_lossy_extent_span_column_equals_decode_bitwise(dev, D, nkv, gq, int8):
    """Every column c of a lossy extent span call (T = 64) is bitwise the
    extent decode call with the same window and hole, where each column's
    hole [sink, end - window) ends elsewhere: across a 512-position chunk
    boundary, over dropped extents, empty while end - window < sink. Chains
    of 11 extents of S = 100 (no multiple of the 64-position tile)."""
    g = _gen(dev, 3 * D + int8)
    B, S, E, T = 5, 100, 11, 64
    kc, vc, sc = _pool_kv(g, dev, B * E, nkv, S, D, int8)
    perm = np.random.default_rng(3 * D + int8).permutation(B * E).reshape(B, E)
    ext = torch.tensor(perm, dtype=torch.int32, device=dev)
    ext[1, :7] = -1  # wholly inside row 1's holes [0, 701 + c)
    start = torch.tensor([0, 3, 0, 600, 0], dtype=torch.int32, device=dev)
    base = torch.tensor([700, 1000, 600, 1030, 0], dtype=torch.int32, device=dev)
    lossy = {"sink": torch.tensor([10, 0, 500, 64, 4], dtype=torch.int32, device=dev),
             "window": torch.tensor([220, 300, 50, 1024, 2], dtype=torch.int32, device=dev)}
    q = torch.randn((B, nkv * gq, T, D), generator=g, device=dev).to(torch.bfloat16)
    span = extent_paged_span_attention(q, kc, vc, start, base, ext, k_scale=sc, v_scale=sc, **lossy)
    for c in range(T):
        dec = extent_paged_decode_attention(q[:, :, c].contiguous(), kc, vc, start, base + 1 + c, ext,
                                            k_scale=sc, v_scale=sc, **lossy)
        assert torch.equal(span[:, :, c], dec), f"column {c} differs from its decode row"


def _plant(leaf, keep, fill):
    """``leaf`` (Np, h, S, d) with ``fill`` at every (pool row, offset) that
    ``keep`` (Np, S) does not mark."""
    out = leaf.clone()
    out.masked_fill_(~keep[:, None, :, None], fill)
    return out


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("D,nkv,gq", INVARIANT_HEADS)
def test_decode_kernel_ignores_bytes_outside_windows(dev, D, nkv, gq, int8):
    """NaN in every cache position that no window of a call keeps (past the
    ends, before a start, in a lossy hole, in the pool row of a dropped
    extent, in pool rows no table names) changes nothing: all five modes
    give bitwise what they give with zeros there (the int8 tier plants NaN
    in the scales and random bytes in K/V). S = 100 is no multiple of the
    64-position tile, and the chains run over several chunks."""
    g = _gen(dev, 7 * D + int8)
    S, H, T = 100, nkv * gq, 8
    # paged: rows 0..2 over their own slots
    start = torch.tensor([5, 0, 0], dtype=torch.int32, device=dev)
    ends = torch.tensor([70, 100, 0], dtype=torch.int32, device=dev)
    base = torch.tensor([40, 90, 0], dtype=torch.int32, device=dev)
    pos = torch.arange(S, device=dev)
    kept_dec = (pos >= start[:, None]) & (pos < ends[:, None])
    kept_span = (pos >= start[:, None]) & (pos < base[:, None] + T)
    # extents: row 0 a lossy chain (sink 10, window 60, end 590: extents 1..4
    # wholly in its hole and dropped), row 1 a 3-extent chain, row 2 dead
    table = [[3, -1, -1, -1, -1, 1], [0, 2, 5, -1, -1, -1], [4, -1, -1, -1, -1, -1]]
    ext = torch.tensor(table, dtype=torch.int32, device=dev)
    x_end = torch.tensor([590, 250, 0], dtype=torch.int32, device=dev)
    x_start = torch.zeros(3, dtype=torch.int32, device=dev)
    lossy = {"sink": torch.tensor([10, 0, 0], dtype=torch.int32, device=dev),
             "window": torch.tensor([60, 0, 0], dtype=torch.int32, device=dev)}
    L = ext.shape[1] * S
    lpos = torch.arange(L, device=dev)

    def pool_keep(col_ends):  # (Np, S): the pool positions some column keeps
        keep = torch.zeros((6, S), dtype=torch.bool, device=dev)
        for b in range(3):
            for e_end in col_ends[b]:
                k = (lpos >= x_start[b]) & (lpos < e_end)
                if lossy["window"][b] > 0:
                    k &= (lpos < lossy["sink"][b]) | (lpos >= e_end - lossy["window"][b])
                for e, prow in enumerate(table[b]):
                    if prow >= 0:
                        keep[prow] |= k[e * S:(e + 1) * S]
        return keep

    kc, vc, sc = _kv(g, dev, 6, nkv, S, D, int8)
    q = torch.randn((6, H, D), generator=g, device=dev).to(torch.bfloat16)
    q4 = torch.randn((6, H, T, D), generator=g, device=dev).to(torch.bfloat16)
    x_base = (x_end - 1).clamp(min=0)
    first3 = lambda t: None if t is None else t[:3]  # noqa: E731
    cases = [("paged decode", kept_dec, lambda k, v, s: paged_decode_attention(
                  q[:3], k[:3], v[:3], start, ends, k_scale=first3(s), v_scale=first3(s))),
             ("paged span", kept_span, lambda k, v, s: paged_span_attention(
                  q4[:3], k[:3], v[:3], start, base, k_scale=first3(s), v_scale=first3(s))),
             ("extent decode", pool_keep([[int(e)] for e in x_end]),
              lambda k, v, s: extent_paged_decode_attention(q[:3], k, v, x_start, x_end, ext,
                                                            k_scale=s, v_scale=s, **lossy)),
             ("extent span", pool_keep([[int(e) + 1 + j for j in range(T)] for e in x_base]),
              lambda k, v, s: extent_paged_span_attention(q4[:3], k, v, x_start, x_base, ext,
                                                          k_scale=s, v_scale=s, **lossy))]
    if not int8:
        cases.append(("decode", kept_dec, lambda k, v, s: decode_attention(
            q[:3], k[:3], v[:3], start, ends)))
    for what, keep, call in cases:
        if keep.shape[0] == 3:  # the paged modes' slots 3..5 are not passed
            keep = torch.cat([keep, torch.zeros((3, S), dtype=torch.bool, device=dev)])
        if int8:
            noise = torch.randint(-128, 128, kc.shape, generator=g, device=dev, dtype=torch.int8)
            planted = (torch.where(keep[:, None, :, None], kc, noise),
                       torch.where(keep[:, None, :, None], vc, noise), _plant(sc, keep, float("nan")))
            zeroed = (_plant(kc, keep, 0), _plant(vc, keep, 0), _plant(sc, keep, 0))
        else:
            planted = (_plant(kc, keep, float("nan")), _plant(vc, keep, float("nan")), None)
            zeroed = (_plant(kc, keep, 0), _plant(vc, keep, 0), None)
        got, ref = call(*planted), call(*zeroed)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), f"{what}: bytes outside the windows changed the result"
        assert bool(torch.isfinite(got.float()).all()), what


# the scheduler's chunk step at gpt2-large width: M = 8 slots x 64 columns
CHUNK_M = 512


def test_quant_matmul_kernel_at_the_chunk_width(dev):
    g = _gen(dev, CHUNK_M)
    x = torch.randn((CHUNK_M, 1280), generator=g, device=dev).to(torch.bfloat16)
    qw = torch.randint(-127, 128, (1280, 51200), generator=g, device=dev, dtype=torch.int8)
    sc = torch.rand((10, 51200), generator=g, device=dev) * 0.01 + 1e-4
    out = quant_matmul(x, qw, sc)
    torch.cuda.synchronize()
    _assert_close(out, quant_matmul_plain(x, qw, sc), "qmm head at M=512")


@pytest.mark.parametrize("rope", [False, True])
def test_fused_qkv_ln_kernel_at_the_chunk_width(dev, rope):
    g = _gen(dev, CHUNK_M + rope)
    H, nh, hd = 1280, 20, 64
    x = (torch.randn((CHUNK_M, H), generator=g, device=dev) * 2).to(torch.bfloat16)
    norms = _norms(g, dev, H, "layernorm")
    qkv = _proj(g, dev, H, 3 * nh * hd, 10)
    rope_op = (*_rope(g, dev, CHUNK_M, hd), 2 * nh, hd) if rope else None
    out = fused_qkv_ln(x, norms, qkv, rope=rope_op)
    torch.cuda.synchronize()
    _assert_close(out, fused_qkv_ln_plain(x, norms, qkv, rope=rope_op), f"qkv_ln M=512 rope={rope}")


@pytest.mark.parametrize("M,H,F,act,norm,G", [(CHUNK_M, 1280, 5120, "gelu", "layernorm", (10, 10, 40)),
                                              (256, 4096, 14336, "swiglu", "rmsnorm", (32, 32, 112))])
def test_fused_out_mlp_kernel_at_the_chunk_width(dev, M, H, F, act, norm, G):
    """gpt2-large's chunk step (the wgmma path on 64-row tiles, 320 up
    tiles: several waves); llama3-8b's (4 slots x 64 columns: up and gate
    as two passes of one block, the first parked in shared memory)."""
    g = _gen(dev, M + F)
    attn = torch.randn((M, H), generator=g, device=dev).to(torch.bfloat16)
    x = (torch.randn((M, H), generator=g, device=dev) * 4).to(torch.bfloat16)
    norms = _norms(g, dev, H, norm)
    o, up, down = _proj(g, dev, H, H, G[0]), _proj(g, dev, H, F, G[1]), _proj(g, dev, F, H, G[2])
    gate = _proj(g, dev, H, F, G[1]) if act == "swiglu" else None
    kw = dict(activation=act, norm=norm, gate=gate)
    out = fused_out_mlp(attn, x, norms, o, up, down, **kw)
    torch.cuda.synchronize()
    _assert_close(out, fused_out_mlp_plain(attn, x, norms, o, up, down, **kw), f"out_mlp M={M} {act}")


# kernels A and C on every path of their plan: mma.sync to 32 rows, wgmma
# on 64-row tiles with K split over blocks (33-64 rows), wgmma with the
# chain in registers on 64- or 128-row tiles above; the scheduler's decode,
# verify and chunk steps need a row's bits to be the same on all of them
BLOCK_M = (1, 8, 16, 32, 33, 40, 64, 200, 256)
# (H, nh, nkv, hd, F, activation, norm, rope, groups (qkv, o, up, down))
BLOCK_LAYERS = {"gpt2": (1280, 20, 20, 64, 5120, "gelu", "layernorm", False, (10, 10, 10, 40)),
                "llama": (1024, 8, 2, 128, 3584, "swiglu", "rmsnorm", True, (8, 8, 8, 28)),
                # N % 16 and a group of 192 rows: mma.sync at every M
                "narrow": (384, 4, 2, 72, 904, "gelu", "layernorm", False, (2, 3, 2, 113))}


def _block_operands(dev, name, M):
    H, nh, nkv, hd, F, act, norm, rope, (gq, go, gu, gd) = BLOCK_LAYERS[name]
    g = _gen(dev, H + F + M)
    x = (torch.randn((M, H), generator=g, device=dev) * 2).to(torch.bfloat16)
    attn = torch.randn((M, nh * hd), generator=g, device=dev).to(torch.bfloat16)
    norms = _norms(g, dev, H, norm)
    qkv = _proj(g, dev, H, (nh + 2 * nkv) * hd, gq)
    o, up, down = _proj(g, dev, nh * hd, H, go), _proj(g, dev, H, F, gu), _proj(g, dev, F, H, gd)
    gate = _proj(g, dev, H, F, gu) if act == "swiglu" else None
    sin, cos = _rope(g, dev, M, hd)

    def a(m, impl="kernel"):
        r = (sin[:m].contiguous(), cos[:m].contiguous(), nh + nkv, hd) if rope else None
        return fused_qkv_ln(x[:m], norms, qkv, norm=norm, rope=r, impl=impl)

    def c(m, impl="kernel"):
        return fused_out_mlp(attn[:m], x[:m], norms, o, up, down, activation=act, norm=norm, gate=gate,
                             impl=impl)

    return a, c


@pytest.mark.parametrize("kernel", ["A", "C"])
@pytest.mark.parametrize("name", sorted(BLOCK_LAYERS))
def test_fused_kernels_rows_bitwise_across_m(dev, name, kernel):
    """The rows of every M are bitwise the same rows at M = 256, and two
    calls are bitwise equal; the largest M also matches the plain version."""
    a, c = _block_operands(dev, name, max(BLOCK_M))
    fn = a if kernel == "A" else c
    full = fn(max(BLOCK_M))
    assert torch.equal(fn(max(BLOCK_M)), full)
    for m in BLOCK_M:
        part = fn(m)
        torch.cuda.synchronize()
        diff = int((part != full[:m]).sum())
        assert diff == 0, f"{kernel} {name}: rows of M={m} differ from M={max(BLOCK_M)} in {diff} entries"
    _assert_close(full, fn(max(BLOCK_M), impl="plain"), f"{kernel} {name} M={max(BLOCK_M)}")


@pytest.mark.parametrize("M", [33, 40, 256])
def test_fused_qkv_ln_kernel_wide_with_rope_at_hd_128(dev, M):
    """Above 32 rows (wgmma), RoPE at hd 128: a rotated pair spans the two
    64-column warpgroups of a block and meets in its staged tile."""
    a, _ = _block_operands(dev, "llama", M)
    out = a(M)
    torch.cuda.synchronize()
    _assert_close(out, a(M, impl="plain"), f"qkv_ln llama M={M}")
    ref = a(M, impl="plain").float()
    rel = ((out.float() - ref).norm(dim=1) / ref.norm(dim=1)).max()
    assert float(rel) <= ROW_REL_L2


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_fused_out_mlp_kernel_at_the_verify_width(dev, name):
    """M = 40 (8 slots x (1 + 4 drafts)): the first width on the wgmma path,
    K split over blocks and the ordered reduce running the epilogues."""
    _, c = _block_operands(dev, name, 40)
    out = c(40)
    torch.cuda.synchronize()
    ref = c(40, impl="plain")
    _assert_close(out, ref, f"out_mlp {name} M=40")
    rel = ((out.float() - ref.float()).norm(dim=1) / ref.float().norm(dim=1)).max()
    assert float(rel) <= ROW_REL_L2


@pytest.mark.parametrize("M", [8, 40, 100])
def test_fused_kernels_keep_mma_sync_where_wgmma_cannot_go(dev, M):
    """N % 16 and a group size that is not a multiple of 128 (the wgmma
    path's TMA rows and whole segments): mma.sync at every M, against the
    plain versions."""
    a, c = _block_operands(dev, "narrow", M)
    for fn, what in ((a, "A"), (c, "C")):
        out = fn(M)
        torch.cuda.synchronize()
        _assert_close(out, fn(M, impl="plain"), f"{what} narrow M={M}")


@pytest.mark.parametrize("int8_kv", [False, True])
@pytest.mark.parametrize("C", [1, 64])
def test_fused_paged_step_matches_plain(dev, C, int8_kv):
    """The slot-pool step through kernels A and C, the span commit and the
    paged kernels, against the same step through their plain versions, on
    a small llama-shaped model (hd 64, GQA g=2, RoPE): logits, and every pool
    leaf (rows of dead columns, and the whole of a dead slot, untouched).
    Tolerance: two layers compose the kernels' one-ulp bf16 differences, and
    the int8 tier requantizes rows whose bf16 values differ by an ulp (a
    one-step int8 flip), so the live logits are held to relative L2 2e-2
    (the on-card generate checks use 5e-2); the pool rows to one ulp, or one
    int8 step."""
    cfg = TransformerConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
                            num_kv_heads=2, max_seq_len=256, intermediate_size=512,
                            attention_impl="flash", int8_weights=True, int8_fused_qkv=True,
                            scan_layers=False, dtype=torch.bfloat16)
    model = CausalLMModel(cfg)
    init = CausalLMModel(dataclasses.replace(cfg, int8_weights=False, int8_fused_qkv=False)).init_params(0)
    # weights of std 0.2 (ten times the init's), so activations are not tiny
    params = {k: v.to(dev) for k, v in model.quantize_params(
        {k: v * 10 if v.dim() == 2 else v for k, v in init.items()}).items()}
    ops = model.fused_decode_operands(params)
    N, S = 4, 256
    g = _gen(dev, C + int8_kv)
    pool = model.init_cache(N, S, device=dev, quantized=int8_kv)
    for t in (t for comp in pool for t in comp):  # a warm pool: every row holds values
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g, device=dev, dtype=torch.int8))
        elif t.dtype == torch.float16:
            t.copy_(torch.rand(t.shape, generator=g, device=dev) * 0.05 + 0.01)
        else:
            t.copy_(torch.randn(t.shape, generator=g, device=dev))
    ids = torch.randint(0, 512, (N, C), generator=g, device=dev)
    widx = torch.tensor([70, 0, 190, 5], device=dev)
    spans = torch.tensor([1, 0, min(C, 40), 1], device=dev)
    pos = widx[:, None] + torch.arange(C, device=dev)[None, :]
    pools = {impl: tuple(tuple(t.clone() for t in comp) for comp in pool) for impl in ("kernel", "plain")}
    logits = {impl: model.fused_paged_step(ops, ids, pools[impl], pos, widx, spans, impl=impl)[0]
              for impl in ("kernel", "plain")}
    torch.cuda.synchronize()
    live = [b for b in range(N) if spans[b] > 0]
    lk = torch.cat([logits["kernel"][b, :int(spans[b])] for b in live]).float()
    lp = torch.cat([logits["plain"][b, :int(spans[b])] for b in live]).float()
    assert bool(torch.isfinite(lk).all())
    rel = float((lk - lp).norm() / lp.norm())
    assert rel <= 2e-2, f"step logits: rel L2 {rel:.3e}"
    for ck, cp, c0 in zip((t for comp in pools["kernel"] for t in comp),
                          (t for comp in pools["plain"] for t in comp), (t for comp in pool for t in comp)):
        assert torch.equal(ck[1], c0[1])  # the dead slot
        for b in (0, 2, 3):
            w, sp = int(widx[b]), int(spans[b])
            assert torch.equal(ck[b, :, :w], c0[b, :, :w]) and torch.equal(ck[b, :, w + sp:],
                                                                            c0[b, :, w + sp:])
            if ck.dtype == torch.int8:  # quantized rows: a one-step difference at most
                assert int((ck[b, :, w:w + sp].int() - cp[b, :, w:w + sp].int()).abs().max()) <= 1
            else:
                _assert_close(ck[b, :, w:w + sp].to(cp.dtype), cp[b, :, w:w + sp], f"pool row {b}")


def test_sampler_draws_equal_on_the_card_and_the_cpu(dev):
    seeds = torch.tensor([0, 7, 4294967295, 123456789], dtype=torch.int64)
    steps = torch.tensor([0, 3, 1, 1000], dtype=torch.int64)
    cpu = sample_uniforms(seeds, steps, 50257)
    card = sample_uniforms(seeds.to(dev), steps.to(dev), 50257)
    assert torch.equal(card.cpu(), cpu)


# ---------------------------------------------------------------- batch invariance

# (K, N): gpt2-large's qkv, o, up, down and padded int8 head; llama3-8b's
ROW_SHAPES = [(1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280), (1280, 51200),
              (4096, 6144), (4096, 4096), (4096, 14336), (14336, 4096), (4096, 129024)]


@pytest.mark.parametrize("K,N", ROW_SHAPES)
def test_quant_matmul_rows_do_not_depend_on_the_batch(dev, K, N):
    """Rows of quant_matmul(x[:m]) are bitwise the same rows of
    quant_matmul(x) for m in 1, 8, 16, 32, 33, 64, 65, 512 and 1024, every
    tile edge of the kernel (mma.sync with K split over blocks up to 32
    rows, wgmma with the chain in registers above): every M runs the same
    segment partials and the same fma chain (the scheduler's chunk and
    decode steps, and a chained request's per-projection dispatches, give a
    row the same bits)."""
    g = _gen(dev, K + N)
    x = torch.randn((1024, K), generator=g, device=dev).to(torch.bfloat16)
    qw = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
    sc = torch.rand((K // 128, N), generator=g, device=dev) * 0.01 + 1e-4
    full = quant_matmul(x, qw, sc)
    for m in (1, 8, 16, 32, 33, 64, 65, 512, 1024):
        part = quant_matmul(x[:m], qw, sc)
        torch.cuda.synchronize()
        diff = int((part != full[:m]).sum())
        assert diff == 0, f"qmm {K}x{N}: rows of M={m} differ from M=1024 in {diff} entries"


# ---------------------------------------------------------------- extent modes


def _pool_kv(g, dev, Np, nkv, S, D, int8):
    return _kv(g, dev, Np, nkv, S, D, int8)


# (Np, S, D, nkv, g, table, starts, ends, sinks, windows): one extent (E=1)
# over a shuffled pool; a 3-extent chain ending exactly at an extent
# boundary (end 3*S), a row ending at its first boundary, a dead row; a
# lossy chain with a dropped (-1) extent inside its hole, a lossy row keeping
# only its last position (window 1), and a row whose kept window is empty
# (start == end)
EXTENT_CASES = [
    (4, 256, 64, 20, 1, [[2], [0], [3], [1]], [0, 5, 0, 0], [256, 100, 1, 0], None, None),
    (6, 128, 128, 8, 4, [[5, 0, 3], [1, -1, -1], [2, 4, -1], [0, -1, -1]], [0, 0, 3, 0],
     [384, 128, 129, 0], None, None),
    (6, 128, 64, 4, 2, [[5, -1, 3], [1, 0, -1], [2, 4, -1], [3, -1, -1]], [0, 0, 129, 0],
     [370, 200, 129, 0], [4, 0, 0, 0], [100, 1, 0, 0]),
]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("Np,S,D,nkv,gq,table,starts,ends,sinks,windows", EXTENT_CASES)
def test_extent_kernels_match_plain(dev, Np, S, D, nkv, gq, table, starts, ends, sinks, windows,
                                    int8):
    g = _gen(dev, Np + S + D + int8)
    B = len(table)
    kc, vc, sc = _pool_kv(g, dev, Np, nkv, S, D, int8)
    ext = torch.tensor(table, dtype=torch.int32, device=dev)
    start = torch.tensor(starts, dtype=torch.int32, device=dev)
    end = torch.tensor(ends, dtype=torch.int32, device=dev)
    lossy = {} if sinks is None else {
        "sink": torch.tensor(sinks, dtype=torch.int32, device=dev),
        "window": torch.tensor(windows, dtype=torch.int32, device=dev)}
    q = torch.randn((B, nkv * gq, D), generator=g, device=dev).to(torch.bfloat16)
    counter = "launches_int8" if int8 else "launches"
    before = getattr(extent_paged_decode_attention, counter)
    out = extent_paged_decode_attention(q, kc, vc, start, end, ext, k_scale=sc, v_scale=sc, **lossy)
    assert getattr(extent_paged_decode_attention, counter) == before + 1
    torch.cuda.synchronize()
    ref = extent_paged_decode_attention_plain(q, kc, vc, start, end, ext, k_scale=sc, v_scale=sc,
                                              **lossy)
    _assert_rows_close(out, ref, f"extent decode Np={Np} S={S} D={D} int8={int8}")
    # the span: T = 16 columns ending at each row's end
    T = 16
    base = (end - T).clamp(min=0)
    q4 = torch.randn((B, nkv * gq, T, D), generator=g, device=dev).to(torch.bfloat16)
    out = extent_paged_span_attention(q4, kc, vc, start, base, ext, k_scale=sc, v_scale=sc, **lossy)
    torch.cuda.synchronize()
    ref = extent_paged_span_attention_plain(q4, kc, vc, start, base, ext, k_scale=sc, v_scale=sc,
                                            **lossy)
    _assert_rows_close(out, ref, f"extent span Np={Np} S={S} D={D} int8={int8}")
    assert torch.equal(extent_paged_span_attention(q4, kc, vc, start, base, ext, k_scale=sc,
                                                   v_scale=sc, **lossy), out)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("D", [64, 128])
def test_extent_kernel_identity_and_chain_bitwise(dev, D, int8):
    """An identity table launches bitwise what the paged modes launch; a
    3-extent chain bitwise what one slot of 3 * S rows holding the same
    logical window gives (decode and span; the big slot's 384 rows take
    block_kv 128); and 11-extent chains of S = 100 whose windows end at the
    512-position chunk boundaries +-1 bitwise one slot of 1100 rows."""
    g = _gen(dev, D + int8)
    Np, nkv, S, H = 5, 4, 128, 16
    kc, vc, sc = _pool_kv(g, dev, Np, nkv, S, D, int8)
    ident = torch.arange(Np, dtype=torch.int32, device=dev)[:, None]
    start = torch.tensor([0, 3, 0, 9, 1], dtype=torch.int32, device=dev)
    ends = torch.tensor([128, 40, 0, 17, 1], dtype=torch.int32, device=dev)
    q = torch.randn((Np, H, D), generator=g, device=dev).to(torch.bfloat16)
    assert torch.equal(extent_paged_decode_attention(q, kc, vc, start, ends, ident, k_scale=sc,
                                                     v_scale=sc),
                       paged_decode_attention(q, kc, vc, start, ends, k_scale=sc, v_scale=sc))
    q4 = torch.randn((Np, H, 64, D), generator=g, device=dev).to(torch.bfloat16)
    base = torch.tensor([64, 0, 10, 30, 64], dtype=torch.int32, device=dev)
    assert torch.equal(extent_paged_span_attention(q4, kc, vc, start, base, ident, k_scale=sc,
                                                   v_scale=sc),
                       paged_span_attention(q4, kc, vc, start, base, k_scale=sc, v_scale=sc))
    chain = torch.tensor([[4, 1, 3]], dtype=torch.int32, device=dev)
    big = [leaf[chain[0].long()].transpose(0, 1).reshape(1, leaf.shape[1], 3 * S, leaf.shape[3])
           .contiguous() for leaf in (kc, vc) + ((sc, ) if int8 else ())]
    bsc = big[2] if int8 else None
    s1, e1 = start[:1], torch.tensor([300], dtype=torch.int32, device=dev)
    assert torch.equal(extent_paged_decode_attention(q[:1], kc, vc, s1, e1, chain, k_scale=sc,
                                                     v_scale=sc),
                       paged_decode_attention(q[:1], big[0], big[1], s1, e1, k_scale=bsc,
                                              v_scale=bsc, block_kv=128))
    b1 = torch.tensor([236], dtype=torch.int32, device=dev)
    assert torch.equal(extent_paged_span_attention(q4[:1].contiguous(), kc, vc, s1, b1, chain,
                                                   k_scale=sc, v_scale=sc),
                       paged_span_attention(q4[:1].contiguous(), big[0], big[1], s1, b1,
                                            k_scale=bsc, v_scale=bsc, block_kv=128))
    # chains over S = 100 (no multiple of the 64-position tile) whose windows
    # end just before, at and just after the 512- and 1024-position chunk
    # boundaries, decode and a 4-column span, against one slot of 1100 rows
    S2, E2, ends2 = 100, 11, [511, 512, 513, 1023, 1024, 1025]
    B2 = len(ends2)
    kc2, vc2, sc2 = _pool_kv(g, dev, B2 * E2, nkv, S2, D, int8)
    perm = np.random.default_rng(D + int8).permutation(B2 * E2).reshape(B2, E2)
    chain2 = torch.tensor(perm, dtype=torch.int32, device=dev)
    big2 = [leaf[chain2.long()].transpose(1, 2).reshape(B2, leaf.shape[1], E2 * S2, leaf.shape[3])
            .contiguous() for leaf in (kc2, vc2) + ((sc2, ) if int8 else ())]
    bsc2 = big2[2] if int8 else None
    s2 = torch.tensor([0, 3, 0, 600, 0, 0], dtype=torch.int32, device=dev)
    e2 = torch.tensor(ends2, dtype=torch.int32, device=dev)
    q2 = torch.randn((B2, H, D), generator=g, device=dev).to(torch.bfloat16)
    assert torch.equal(extent_paged_decode_attention(q2, kc2, vc2, s2, e2, chain2, k_scale=sc2,
                                                     v_scale=sc2),
                       paged_decode_attention(q2, big2[0], big2[1], s2, e2, k_scale=bsc2,
                                              v_scale=bsc2, block_kv=100))
    q24 = torch.randn((B2, H, 4, D), generator=g, device=dev).to(torch.bfloat16)
    assert torch.equal(extent_paged_span_attention(q24, kc2, vc2, s2, e2 - 2, chain2, k_scale=sc2,
                                                   v_scale=sc2),
                       paged_span_attention(q24, big2[0], big2[1], s2, e2 - 2, k_scale=bsc2,
                                            v_scale=bsc2, block_kv=100))


def test_chained_request_pool_bytes_equal_one_big_slot(dev):
    """A 3-slot pool on the card, int8 weights through the batch-invariant
    quant_matmul per projection (chained dispatches skip the fused kernels,
    so the big slot's reference skips them too): a 200-token prompt on a chain [0, 1] passes its write head
    over logical 128, offset 0 of extent 1, whose pool row 1 is also a dead
    dispatch row (the planted collision). The pool then holds, in every
    layer, bitwise the K/V of the same prompt on one 256-row slot, and the
    greedy streams are equal."""
    cfg = TransformerConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
                            num_kv_heads=2, max_seq_len=256, intermediate_size=512,
                            scan_layers=False)
    config = {"dtype": "int8", "kernel_inject": True, "fused_decode_block": False,
              "continuous_batching": {"enabled": True, "num_slots": 3}}
    prompt = [int(t) for t in np.resize(np.arange(3, 500, 7), 200)]
    outs, pools = [], []
    for kw in ({"max_len": 128, "max_extents": 2}, {"max_len": 256}):
        eng = deepspeed_tpu_torch.init_inference(CausalLMModel(cfg), config=config)
        s = eng.scheduler(prefill_chunk=64, **kw)
        assert s.max_len == kw["max_len"]
        outs.append(s.submit(prompt, max_new_tokens=8).result())
        pools.append([t for comp in s.cache.pool for t in comp])
        if "max_extents" in kw:
            assert s.forwards[64] > 0 and s.cache.extents(0) == [0] and not s.cache.chain
    torch.cuda.synchronize()
    np.testing.assert_array_equal(outs[0], outs[1])
    for chained, big in zip(*pools):
        logical = torch.cat([chained[0], chained[1]], dim=1)
        assert torch.equal(logical[:, :200], big[0, :, :200])


# ------------------------------------------------------- block-sparse attention


def _sparse_inputs(dev, B, H, T, D, seed):
    g = _gen(dev, seed)
    return [torch.randn((B, H, T, D), generator=g, device=dev).to(torch.bfloat16) for _ in range(4)]


def _edge_layout(H, nb, seed):
    """Random blocks, different per head, some above the diagonal; in every
    head q block 1 reads nothing and kv block nb - 2 is read by nobody, and
    q block 0 reads only a future block (every entry masked under causal)."""
    layout = (np.random.default_rng(seed).random((H, nb, nb)) < 0.4).astype(np.int64)
    layout[:, 1, :] = 0
    layout[:, :, nb - 2] = 0
    layout[:, 0, :] = 0
    layout[:, 0, nb - 1] = 1
    return layout


def _check_sparse_kernels(dev, layout, block, B, T, D, causal, seed, chunk="default"):
    """Each of the three kernels against its plain version (the backward
    kernels on the plain forward's out and lse), on the work plans of
    ``chunk`` ("default": the block size's ``CHUNK``; an int cuts the walks
    there; dq on the forward's plan), one launch a call, all three bitwise
    equal on two calls. Returns the kernels' (out, lse, dq, dk, dv)."""
    from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention import (
        CHUNK, WorkPlan, block_sparse_attention_plain, block_sparse_bwd_dkv,
        block_sparse_bwd_dkv_plain, block_sparse_bwd_dq, block_sparse_bwd_dq_plain, block_sparse_fwd,
        make_block_sparse_attention)
    q, k, v, do = _sparse_inputs(dev, B, layout.shape[0], T, D, seed)
    attn = make_block_sparse_attention(layout, block, causal)
    q_idx, q_cnt, kv_idx, kv_cnt = attn.tables(dev)
    c = CHUNK[block] if chunk == "default" else chunk
    fwd_plan, dkv_plan = WorkPlan(attn.np_tables[1], c), WorkPlan(attn.np_tables[3], c)
    what = f"block {block} D {D} T {T} causal {causal} chunk {c}"
    before = block_sparse_fwd.launches
    out, lse = block_sparse_fwd(q, k, v, q_idx, q_cnt, block, causal, plan=fwd_plan)
    assert block_sparse_fwd.launches == before + 1
    out2, lse2 = block_sparse_fwd(q, k, v, q_idx, q_cnt, block, causal, plan=fwd_plan)
    assert torch.equal(out2, out) and torch.equal(lse2, lse), f"fwd repeat, {what}"
    torch.cuda.synchronize()
    ref_out, ref_lse = block_sparse_attention_plain(q, k, v, q_idx, q_cnt, block, causal, plan=fwd_plan)
    _assert_close(out, ref_out, f"fwd out, {what}")
    _assert_close(lse, ref_lse, f"fwd lse, {what}")
    delta = (do.float() * ref_out.float()).sum(-1)
    dq_args = (q, k, v, do, ref_lse, delta, q_idx, q_cnt, block, causal)
    before = block_sparse_bwd_dq.launches
    dq = block_sparse_bwd_dq(*dq_args, plan=fwd_plan)
    assert block_sparse_bwd_dq.launches == before + 1
    assert torch.equal(block_sparse_bwd_dq(*dq_args, plan=fwd_plan), dq), f"dq repeat, {what}"
    torch.cuda.synchronize()
    _assert_close(dq, block_sparse_bwd_dq_plain(*dq_args, plan=fwd_plan), f"dq, {what}")
    dkv_args = (q, k, v, do, ref_lse, delta, kv_idx, kv_cnt, block, causal)
    dk, dv = block_sparse_bwd_dkv(*dkv_args, plan=dkv_plan)
    dk2, dv2 = block_sparse_bwd_dkv(*dkv_args, plan=dkv_plan)
    assert torch.equal(dk2, dk) and torch.equal(dv2, dv), f"dk/dv repeat, {what}"
    torch.cuda.synchronize()
    ref_dk, ref_dv = block_sparse_bwd_dkv_plain(*dkv_args, plan=dkv_plan)
    _assert_close(dk, ref_dk, f"dk, {what}")
    _assert_close(dv, ref_dv, f"dv, {what}")
    return out, lse, dq, dk, dv


@pytest.mark.parametrize("chunk", ["default", 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_block_sparse_kernels_match_plain(dev, block, D, causal, chunk):
    """Every block size and head dim, on a layout with blocks above the
    diagonal, an empty q row, an empty kv column and a row that reads only
    the future: those rows give out 0, lse -inf (the empty row always, the
    future-only row under causal) and dq 0, the unread block dk = dv = 0.
    With the walks cut every 2 table positions, every row and column of more
    than 2 blocks is split over CTAs and merged."""
    nb = 6
    layout = _edge_layout(3, nb, block + D)
    out, lse, dq, dk, dv = _check_sparse_kernels(dev, layout, block, 2, nb * block, D, causal,
                                                 block * D + causal, chunk)
    empty = slice(block, 2 * block)
    assert not out[:, :, empty].any() and torch.isneginf(lse[:, :, empty]).all()
    assert not dq[:, :, empty].any()
    if causal:
        assert not out[:, :, :block].any() and torch.isneginf(lse[:, :, :block]).all()
    unread = slice((nb - 2) * block, (nb - 1) * block)
    assert not dk[:, :, unread].any() and not dv[:, :, unread].any()


@pytest.mark.parametrize("chunk", ["default", 3])
@pytest.mark.parametrize("block,D", [(16, 128), (64, 64), (128, 64)])
def test_block_sparse_kernels_ragged_tail(dev, block, D, chunk):
    """T short of the layout's capacity by part of a block (and, at block
    16, by more than a block): key columns past T are masked in all three
    kernels, query rows past T in dk/dv; also with the walks cut every 3
    positions (a split global column whose last piece holds the ragged q
    block)."""
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
    nb = 8
    layout = FixedSparsityConfig(2, block=block, num_local_blocks=2,
                                 attention="unidirectional").make_layout(nb * block)
    T = nb * block - (block + 5 if block == 16 else block // 2 + 3)
    _check_sparse_kernels(dev, layout, block, 2, T, D, True, T, chunk)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_block_sparse_walks_of_chunk_and_chunk_plus_one(dev, block, D):
    """At the block size's own CHUNK: a row and a column of exactly CHUNK
    blocks (one piece) and of CHUNK + 1 (two pieces, the second of one
    block), non-causal and causal; then the split plan against the
    one-piece plan (forward, dq, dk/dv), within the same gates as the plain
    version."""
    from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention import (
        CHUNK, WorkPlan, block_sparse_bwd_dkv, block_sparse_bwd_dq, block_sparse_fwd,
        make_block_sparse_attention)
    c = CHUNK[block]
    nb = c + 2
    layout = np.zeros((2, nb, nb), np.int64)
    layout[:, np.arange(nb), np.arange(nb)] = 1
    layout[0, nb - 2, 1:c + 1] = 1  # head 0: q block nb - 2 walks c kv blocks, nb - 1 walks c + 1
    layout[0, nb - 1, 1:c + 2] = 1
    layout[1, :c, 0] = 1  # head 1: kv block 0 is read by c q blocks, kv block 1 by c + 1
    layout[1, 1:c + 2, 1] = 1
    assert layout[0, nb - 2].sum() == c and layout[0, nb - 1].sum() == c + 1
    assert layout[1, :, 0].sum() == c and layout[1, :, 1].sum() == c + 1
    for causal in (False, True):
        attn = make_block_sparse_attention(layout, block, causal)
        plans = attn.plans
        assert sorted(int(n) for n in plans[0].items[:, 2])[-2:] == [c, c]
        assert len(plans[0].splits) == 1 and len(plans[1].splits) == 1
        out, lse, dq, dk, dv = _check_sparse_kernels(dev, layout, block, 2, nb * block, D, causal,
                                                     block + D + causal)
        q, k, v, do = _sparse_inputs(dev, 2, 2, nb * block, D, block + D + causal)
        q_idx, q_cnt, kv_idx, kv_cnt = attn.tables(dev)
        whole = (WorkPlan(attn.np_tables[1]), WorkPlan(attn.np_tables[3]))
        w_out, w_lse = block_sparse_fwd(q, k, v, q_idx, q_cnt, block, causal, plan=whole[0])
        _assert_close(out, w_out, f"split vs one-piece out, block {block} D {D} causal {causal}")
        _assert_close(lse, w_lse, f"split vs one-piece lse, block {block} D {D} causal {causal}")
        delta = (do.float() * w_out.float()).sum(-1)
        dq_args = (q, k, v, do, w_lse, delta, q_idx, q_cnt, block, causal)
        _assert_close(block_sparse_bwd_dq(*dq_args, plan=plans[0]),
                      block_sparse_bwd_dq(*dq_args, plan=whole[0]),
                      f"split vs one-piece dq, block {block} D {D} causal {causal}")
        args = (q, k, v, do, w_lse, delta, kv_idx, kv_cnt, block, causal)
        split = block_sparse_bwd_dkv(*args, plan=plans[1])
        for tag, a, b in zip(("dk", "dv"), split, block_sparse_bwd_dkv(*args, plan=whole[1])):
            _assert_close(a, b, f"split vs one-piece {tag}, block {block} D {D} causal {causal}")


def test_block_sparse_kernels_different_layout_per_head(dev):
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    layout = BigBirdSparsityConfig(4, block=32, num_random_blocks=2, different_layout_per_head=True,
                                   attention="unidirectional").make_layout(512)
    assert not all(np.array_equal(layout[0], layout[h]) for h in range(1, 4))
    _check_sparse_kernels(dev, layout, 32, 2, 512, 64, True, 5)


def test_sparse_self_attention_through_autograd_on_the_card(dev):
    """SparseSelfAttention's forward and backward launch each kernel once
    and agree with impl="plain"."""
    from deepspeed_tpu_torch.ops.sparse_attention import (BSLongformerSparsityConfig,
                                                          SparseSelfAttention,
                                                          make_block_sparse_attention)
    from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention import (
        block_sparse_bwd_dkv, block_sparse_bwd_dq, block_sparse_fwd)
    ssa = SparseSelfAttention(BSLongformerSparsityConfig(4, block=64, global_block_indices=[0, 3]))
    q, k, v, do = _sparse_inputs(dev, 2, 4, 1024, 128, 17)
    fns = (block_sparse_fwd, block_sparse_bwd_dq, block_sparse_bwd_dkv)
    before = [f.launches for f in fns]
    got = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = ssa(*got)
    out.backward(do)
    assert [f.launches for f in fns] == [b + 1 for b in before]
    attn = ssa._cache[1024]
    assert attn.tables(dev)[0].device == q.device
    ref = [t.detach().requires_grad_(True) for t in (q, k, v)]
    plain = make_block_sparse_attention(attn.layout, 64, attn.causal, impl="plain")
    ref_out = plain(*ref)
    ref_out.backward(do)
    torch.cuda.synchronize()
    _assert_close(out.detach(), ref_out.detach(), "SparseSelfAttention out")
    for tag, a, b in zip("qkv", got, ref):
        _assert_close(a.grad, b.grad, f"SparseSelfAttention d{tag}")


def test_block_sparse_kernels_refuse_what_they_do_not_take(dev):
    """fp32 on the card, a head dim of 96, a block of 48, tables on the CPU:
    a ValueError, never the plain version."""
    from deepspeed_tpu_torch.ops.sparse_attention import make_block_sparse_attention
    from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention import block_sparse_fwd
    layout = np.ones((2, 4, 4), np.int64)
    q = torch.zeros((1, 2, 256, 64), device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        make_block_sparse_attention(layout, 64)(q, q, q)
    q96 = torch.zeros((1, 2, 256, 96), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim 96"):
        make_block_sparse_attention(layout, 64)(q96, q96, q96)
    q48 = torch.zeros((1, 2, 192, 64), device=dev, dtype=torch.bfloat16)
    attn = make_block_sparse_attention(layout, 48)
    with pytest.raises(ValueError, match="block 48"):
        attn(q48, q48, q48)
    q_idx, q_cnt = (t for t in make_block_sparse_attention(layout, 64).tables("cpu")[:2])
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="int32 tensor on cuda"):
        block_sparse_fwd(qb, qb, qb, q_idx, q_cnt, 64)


# the decode-shape microbench's kernels (ops/qmm_microbench.py): (M, K, N,
# G, block_n): the bench's shape at its three qmm2 tilings; fewer rows than
# the 8-row tile and two row tiles; one group over all of K; the smallest
# group (32 rows) and the largest (512); the smallest column tile (128); a
# long K (20 boxes through a ring of 5); a narrow N (8 CTAs, fewer than the
# SMs)
MICRO_CASES = [(8, 1280, 5120, 10, 512), (8, 1280, 5120, 10, 1024), (8, 1280, 5120, 10, 2560),
               (5, 256, 384, 1, 128), (13, 512, 1024, 1, 256), (3, 256, 512, 8, 128),
               (16, 1024, 640, 2, 640), (8, 5120, 1280, 40, 1280), (8, 1024, 256, 8, 256)]


def _micro_inputs(dev, M, K, N, G, seed):
    g = _gen(dev, seed)
    x = (torch.randn((M, K), generator=g, device=dev) * 0.1).to(torch.bfloat16)
    qw = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
    sc = torch.rand((G, N), generator=g, device=dev) * 0.001 + 1e-5
    return x, qw, sc


@pytest.mark.parametrize("which", ["qmm2", "qmm3", "qmm4"])
@pytest.mark.parametrize("M,K,N,G,block_n", MICRO_CASES)
def test_microbench_kernels_match_plain(dev, which, M, K, N, G, block_n):
    """qmm4 bitwise its plain version (exact int32 partials, then the same
    separately rounded fp32 recurrence in group order); qmm2 and qmm3
    within 2^-16 of max|plain| (every bf16 x int8 product is exact; the
    tensor cores sum each group's products in their own order and
    precision, the plain version in cuBLAS fp32). A second call is bitwise
    the first (the groups are summed in a fixed order, without atomics)."""
    from deepspeed_tpu_torch.ops import qmm_microbench as qm
    x, qw, sc = _micro_inputs(dev, M, K, N, G, M + K + N + block_n)
    fn = getattr(qm, which)
    before = fn.launches
    out = fn(x, qw, sc, block_n=block_n)
    assert fn.launches == before + 1
    ref = getattr(qm, which + "_plain")(x, qw, sc, block_n=block_n)
    torch.cuda.synchronize()
    assert out.shape == (M, N) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    if which == "qmm4":
        assert torch.equal(out, ref), f"qmm4 {M}x{K}x{N}: max abs err {float((out - ref).abs().max()):.3e}"
    else:
        err, tol = float((out - ref).abs().max()), 2.0**-16 * float(ref.abs().max())
        assert err <= tol, f"{which} {M}x{K}x{N} block_n {block_n}: max abs err {err:.3e} > {tol:.3e}"
    assert torch.equal(fn(x, qw, sc, block_n=block_n), out)


def test_microbench_qmm4_quantizes_inside_bitwise(dev):
    """qmm4's in-kernel row quantization against ``quantize_rows`` on rows
    that test its rounding points: x / sx on ties at .5 (max|x| 127 makes sx
    1.0, so rint's ties go to even), an all-zero row (sx = 1e-12, xq 0), a
    row of large magnitude, and random rows: the output bitwise
    ``qmm4_plain``, and ``quantize_rows`` on the card bitwise its CPU run
    (fp32 division on both: the plain version the kernel is held to)."""
    from deepspeed_tpu_torch.ops import qmm_microbench as qm
    M, K, N, G = 8, 1280, 5120, 10
    x, qw, sc = _micro_inputs(dev, M, K, N, G, 7)
    ties = torch.arange(K, device=dev, dtype=torch.float32) % 254 - 126.5
    ties[0] = 127.0
    x[0] = ties.to(torch.bfloat16)
    x[1] = 0
    x[2] = (x[2].float() * 3e30).to(torch.bfloat16)
    x[3] = -x[0]
    xq, sx = qm.quantize_rows(x)
    cq, csx = qm.quantize_rows(x.cpu())
    assert torch.equal(xq.cpu(), cq) and torch.equal(sx.cpu(), csx)
    assert float(sx[0]) == 1.0 and float(sx[1]) == torch.tensor(1e-12).item() and int(xq[1].abs().max()) == 0
    assert int(xq[0, 1]) == -126 and int(xq[0, 2]) == -124  # -125.5 and -124.5: ties to even
    out = qm.qmm4(x, qw, sc, block_n=2560)
    ref = qm.qmm4_plain(x, qw, sc, block_n=2560)
    torch.cuda.synchronize()
    assert torch.equal(out, ref), f"qmm4: max abs err {float((out - ref).abs().max()):.3e}"


@pytest.mark.parametrize("which", ["qmm2", "qmm3", "qmm4"])
def test_microbench_launch_allocates_only_out(dev, which):
    """One launch and no workspace: a call's device memory grows by its
    output alone."""
    from deepspeed_tpu_torch.ops import qmm_microbench as qm
    x, qw, sc = _micro_inputs(dev, 8, 1280, 5120, 10, 3)
    fn = getattr(qm, which)
    fn(x, qw, sc, block_n=2560)  # builds and loads the library
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    out = fn(x, qw, sc, block_n=2560)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) - before == out.untyped_storage().nbytes() == 8 * 5120 * 4


def test_microbench_kernels_refuse_what_they_do_not_take(dev):
    """A group of 48 rows, a column tile of 64, fp32 x: a ValueError on the
    card, never the plain version."""
    from deepspeed_tpu_torch.ops import qmm_microbench as qm
    x, qw, sc = _micro_inputs(dev, 8, 384, 256, 8, 0)
    with pytest.raises(ValueError, match="multiple of 32"):
        qm.qmm2(x, qw, sc, block_n=128)
    x, qw, sc = _micro_inputs(dev, 8, 256, 256, 2, 0)
    with pytest.raises(ValueError, match="multiple of 128"):
        qm.qmm3(x, qw, sc, block_n=64)
    with pytest.raises(ValueError, match="bfloat16"):
        qm.qmm4(x.float(), qw, sc, block_n=128)


def _fp16_edge_rows(dev, seed):
    """K/V rows (1, 4, T, 16) whose row max |x| puts max / 127 at an fp16
    rounding edge: the 127 multiples of fp16 midpoints (2^-10 to 4) and
    their fp32 neighbours where the exact quotient and the product with
    fp32(1/127) round to different fp16 scales, then random rows."""
    h = torch.arange(0x1400, 0x4400, dtype=torch.int32).to(torch.int16).view(torch.float16).float()
    mid = ((h[:-1].double() + h[1:].double()) / 2 * 127).float()
    cands = torch.cat([torch.nextafter(mid, mid + s) for s in (-1, 1)] + [mid])
    quot = (cands / torch.full_like(cands, 127.0)).half()
    recip = (cands * torch.tensor(1 / 127, dtype=torch.float32)).half()
    edges = cands[quot != recip]
    T = edges.numel() + 16
    g = torch.Generator().manual_seed(seed)
    k = torch.rand((1, 4, T, 16), generator=g) * 2 - 1
    v = torch.rand((1, 4, T, 16), generator=g) * 2 - 1
    k[0, :, :edges.numel()] *= edges[None, :, None] / 2  # below each row's max
    v[0, :, :edges.numel()] *= edges[None, :, None] / 2
    k[0, 1, :edges.numel(), 3] = -edges                  # the row max, negative
    return k.to(dev), v.to(dev), edges.numel()


def test_quantize_kv_rows_card_equals_cpu_bitwise(dev):
    """``quantize_kv_rows`` on the card gives the CPU's int8 rows and fp16
    scales bit for bit, on rows whose max / 127 sits at an fp16 rounding
    edge (where dividing by a Python 127 on the card, a multiply by the
    fp32 reciprocal, picks the other scale) and on random rows."""
    k, v, n_edge = _fp16_edge_rows(dev, 5)
    assert n_edge > 0
    kq, vq, sc = quantize_kv_rows(k, v)
    ck, cv, cs = quantize_kv_rows(k.cpu(), v.cpu())
    torch.cuda.synchronize()
    assert torch.equal(sc.cpu().view(torch.int16), cs.view(torch.int16))
    assert torch.equal(kq.cpu(), ck) and torch.equal(vq.cpu(), cv)
