"""The port's CUDA kernels against their plain versions on the card, at the
edge shapes of each kernel's contract: one quantization group over all of K,
M not a multiple of the row tile, many K splits, the padded vocab; T and Tk
edges, Tk != T, non-causal, GQA, head dims 64 and 128; empty decode windows,
per-row and scalar ends, left-pad starts. ``chip_smoke.py`` covers the main
path's shapes; this file covers the rest.

These tests need an NVIDIA card with the CUDA toolkit (a CUDA kernel has no
CPU mode): they carry the ``cuda`` marker and skip without a card. On the
card, from the repo root:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX's CPU mesh, and this
file needs no JAX.)"""

import pytest
import torch

from deepspeed_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from deepspeed_tpu_torch.ops.flash_attention import flash_attention_plain, flash_attention_with_lse
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
    before = flash_attention_with_lse.launches
    out, lse = flash_attention_with_lse(q, k, v, causal=causal)
    assert flash_attention_with_lse.launches == before + 1
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    what = f"flash B={B} H={H}/{Hkv} T={T} Tk={Tk} D={D} causal={causal}"
    _assert_close(out, ref_out, what + " out")
    _assert_close(lse, ref_lse, what + " lse")


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
