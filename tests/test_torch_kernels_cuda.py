"""The port's CUDA kernels against their plain versions on the card, at the
edge shapes of each kernel's contract: one quantization group over all of K,
M not a multiple of the row tile, many K splits, the padded vocab; T and Tk
edges, Tk != T, non-causal, GQA, head dims 64 and 128, for the forward and
the two backward kernels (with an lse cotangent, a row that attends nothing,
bitwise-equal repeats, and autograd through the forward); empty decode windows,
per-row and scalar ends, left-pad starts; for the fused decode layer, batches
other than 8, G=1, contractions longer than 1024, gated and ungated MLPs,
every activation, head dims 64 and 128 with and without RoPE, and a fully
padded row. ``chip_smoke.py`` covers the main path's shapes; this file covers
the rest.

These tests need an NVIDIA card with the CUDA toolkit (a CUDA kernel has no
CPU mode): they carry the ``cuda`` marker and skip without a card. On the
card, from the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX's CPU mesh, and this
file needs no JAX.)"""

import pytest
import torch

from deepspeed_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from deepspeed_tpu_torch.ops.decode_block import (fused_decode_block, fused_out_mlp,
                                                  fused_out_mlp_plain, fused_qkv_ln,
                                                  fused_qkv_ln_plain)
from deepspeed_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd,
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


# (M, K, N, G): G=1 (quantize_params' fallback when 128 does not divide K);
# K not a multiple of the 64-row staged chunk; M not a multiple of the
# 8-row tile; K split into many blocks (N too narrow to fill the card);
# the int8 head's padded vocab; a ragged prefill M
QMM_CASES = [(1, 1280, 1280, 1), (5, 200, 64, 1), (13, 256, 384, 2), (3, 5120, 128, 40),
             (8, 1280, 51200, 10), (1030, 1280, 1280, 10)]


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
    # the split-K tile counters are left zeroed: a second launch agrees bitwise
    assert torch.equal(quant_matmul(x, qw, sc, out_dtype=out_dtype), out)


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
# with more keys than queries (kv tiles no query reaches get zeros)
BWD_CASES = [(2, 4, 4, 100, 100, 64, True), (1, 4, 4, 64, 96, 64, False),
             (1, 8, 2, 128, 128, 128, True), (2, 4, 1, 77, 77, 128, False),
             (1, 2, 2, 40, 70, 64, True)]


def _bwd_inputs(dev, B, H, Hkv, T, Tk, D, causal, seed):
    g = _gen(dev, seed)
    q = torch.randn((B, H, T, D), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, Hkv, Tk, D), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, Hkv, Tk, D), generator=g, device=dev).to(torch.bfloat16)
    do = torch.randn((B, H, T, D), generator=g, device=dev).to(torch.bfloat16)
    g_lse = torch.randn((B, H, T), generator=g, device=dev)
    out, lse = flash_attention_plain(q, k, v, causal=causal)
    return q, k, v, do, g_lse, out, lse


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
        _assert_close(a, r, f"{what} {name}")


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
    _assert_close(out, decode_attention_plain(q, kc, vc, start, end),
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
