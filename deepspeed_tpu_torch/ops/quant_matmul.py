"""w8a16 quantized matmul: ``x @ dequantize(qw, scales)``.

Port of ``deepspeed_tpu/ops/pallas/quant_matmul.py`` (the TPU kernel
``_qmm_kernel``). The CUDA kernel is ``ops/csrc/quant_matmul.cu``; its
header says what bounds it on the H100 and how its design answers that.

Layout: x (M, K); qw (K, N) int8; scales (G, N) fp32 with group size K/G
along the contraction. Each group's fp32 partial sum is multiplied by that
group's scale row; the dequantized weight never exists in memory.

A CUDA tensor launches the kernel (or the call raises); a CPU tensor, or
``impl="plain"``, takes :func:`quant_matmul_plain`, the same arithmetic in
plain PyTorch.
"""

import ctypes

import torch

from . import build

# the CUDA sources under ops/csrc this module launches
SOURCES = ("quant_matmul", )
_libs = {}

# kernel tiling (ops/csrc/quant_matmul.cu): 128 columns a block; K in
# segments of 128 rows, the unit of the fp32 sum
_COLS, _SEG = 128, 128
# at M <= 32, split K over blocks until the column tiles x splits reach
# about two blocks per SM of the H100 (132 SMs)
_TARGET_BLOCKS, _NARROW_M = 264, 32


def _split_plan(K, N):
    """How many blocks share a column tile's K at M <= 32, each taking
    whole 128-row segments, so that column tiles x splits about fill the
    card. A function of the weight's shape alone. It decides
    only where the segments' partials are made: every M runs the same fma
    chain over the same segment partials in K order (the kernel's header),
    so a row's bits never depend on the plan, on M or on what else shares
    the call (the scheduler's chunk and decode steps give a row the same
    bits)."""
    segs = -(-K // _SEG)
    per = -(-segs // min(segs, -(-_TARGET_BLOCKS // -(-N // _COLS))))
    return -(-segs // per)


def _spread(M, splits):
    """Whether K is split over blocks (a workspace of segment partials and
    an ordered second launch): only at M <= 32, where the column tiles alone
    cannot fill the card. Where the partials are made never changes a
    result."""
    return splits > 1 and M <= _NARROW_M


def _bind(lib):
    lib.qmm_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.qmm_launch.restype = ctypes.c_int


def _kernel():
    return build.bind(_libs, SOURCES[0], _bind)


def _check_shapes(x, qw, scales):
    if x.dim() != 2 or qw.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"expected x (M, K), qw (K, N), scales (G, N); got "
                         f"{tuple(x.shape)}, {tuple(qw.shape)}, {tuple(scales.shape)}")
    M, K = x.shape
    K2, N = qw.shape
    G = scales.shape[0]
    if K != K2:
        raise ValueError(f"x K={K} != qw K={K2}")
    if scales.shape[1] != N:
        raise ValueError(f"scales N={scales.shape[1]} != weight N={N}")
    if K % G != 0:
        raise ValueError(f"groups {G} must divide K={K}")


def quant_matmul_plain(x, qw, scales, out_dtype=None):
    """Plain PyTorch version: per-group fp32 dots of x and the widened int8
    weight, each scaled by its group's row, summed in group order. A lone
    row runs as one row of two (torch.mm hands a single row to a
    matrix-vector routine that sums in another order), so a row's bits do
    not depend on M."""
    _check_shapes(x, qw, scales)
    M, K = x.shape
    G, N = scales.shape
    gs = K // G
    xf = x.float()
    if M == 1:
        xf = torch.cat([xf, torch.zeros_like(xf)])
    acc = torch.zeros((xf.shape[0], N), dtype=torch.float32, device=x.device)
    for g in range(G):
        sl = slice(g * gs, (g + 1) * gs)
        acc += torch.mm(xf[:, sl], qw[sl].float()) * scales[g].float()
    return acc[:M].to(out_dtype or x.dtype)


def quant_matmul(x, qw, scales, out_dtype=None, impl="kernel"):
    """``x @ dequantize(qw, scales)`` -> (M, N) in ``out_dtype`` (x's dtype
    by default). On the card: x bf16, out bf16 or fp32, N % 4 == 0."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    if impl == "plain" or not x.is_cuda:
        return quant_matmul_plain(x, qw, scales, out_dtype)
    _check_shapes(x, qw, scales)
    out_dtype = out_dtype or x.dtype
    M, K = x.shape
    G, N = scales.shape
    for name, t, dt in (("x", x, torch.bfloat16), ("qw", qw, torch.int8),
                        ("scales", scales, torch.float32)):
        if t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"quant_matmul kernel: {name} must be a contiguous {dt} tensor on "
                             f"{x.device}; got {t.dtype} on {t.device}, contiguous={t.is_contiguous()}")
        if t.data_ptr() % 16:
            raise ValueError(f"quant_matmul kernel: {name} must be 16-byte aligned")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"quant_matmul kernel: out_dtype must be bf16 or fp32, got {out_dtype}")
    if N % 4:
        raise ValueError(f"quant_matmul kernel: N={N} must be a multiple of 4")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    splits = _split_plan(K, N)
    ws = None
    if _spread(M, splits):
        segs = G * -(-(K // G) // _SEG)  # a group's last segment may be shorter
        ws = torch.empty((segs, M, N), dtype=torch.float32, device=x.device)
    else:
        splits = 1
    lib = _kernel()
    rc = lib.qmm_launch(x.data_ptr(), qw.data_ptr(), scales.data_ptr(), out.data_ptr(),
                        None if ws is None else ws.data_ptr(), M, K, N, G, splits,
                        int(out_dtype == torch.float32), build.stream_of(x))
    build.check(lib, rc, "quant_matmul")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
