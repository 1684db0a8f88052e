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
_lib = None
_arrivals = {}  # device -> zeroed int32 tile counters of the split-K reduction

# kernel tiling (ops/csrc/quant_matmul.cu): 8 rows x 128 columns per block
_ROWS, _COLS = 8, 128
# split K until one row tile's blocks number about two per SM of the H100
# (132 SMs), keeping at least 64 K rows (one staged chunk) per split
_TARGET_BLOCKS, _MIN_SPLIT_K = 264, 64


def _split_plan(K, N):
    """(splits, k_per_split): K cut into ranges of whole staged chunks so
    that one row tile's (column tiles x splits) blocks about fill the card.
    The plan is a function of the weight's shape alone, never of the row
    count M: a row's fp32 partials are summed in the same order whatever
    else shares the call, so the scheduler's chunk step (M = slots x chunk)
    and decode step (M = slots) give a row the same bits (its K- and
    batch-invariance on the card). At M <= 8 (one row tile) it is the plan
    the kernel has always used at decode."""
    tiles = -(-N // _COLS)
    splits = max(1, min(-(-_TARGET_BLOCKS // tiles), K // _MIN_SPLIT_K))
    k_per_split = -(-K // (splits * _MIN_SPLIT_K)) * _MIN_SPLIT_K  # whole staged chunks
    return -(-K // k_per_split), k_per_split


def _spread(M, N, splits):
    """Whether the splits run as blocks of their own (grid z) rather than
    in order inside each block: only while the (n, m) tile grid alone is too
    small to fill the card. Where they run never changes a result."""
    return splits > 1 and -(-N // _COLS) * -(-M // _ROWS) < _TARGET_BLOCKS


def _kernel():
    global _lib
    if _lib is None:
        lib = build.load(SOURCES[0])
        lib.qmm_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.qmm_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    weight, each scaled by its group's row, summed in group order."""
    _check_shapes(x, qw, scales)
    M, K = x.shape
    G, N = scales.shape
    gs = K // G
    xf = x.float()
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for g in range(G):
        sl = slice(g * gs, (g + 1) * gs)
        acc += torch.mm(xf[:, sl], qw[sl].float()) * scales[g].float()
    return acc.to(out_dtype or x.dtype)


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
    splits, k_per_split = _split_plan(K, N)
    spread = _spread(M, N, splits)
    ws = arrivals = None
    if spread:
        tiles = -(-N // _COLS) * -(-M // _ROWS)
        ws = torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
        arrivals = _arrivals.get(x.device)
        if arrivals is None or arrivals.numel() < tiles:
            arrivals = _arrivals[x.device] = torch.zeros(tiles, dtype=torch.int32, device=x.device)
    lib = _kernel()
    rc = lib.qmm_launch(x.data_ptr(), qw.data_ptr(), scales.data_ptr(), out.data_ptr(),
                        None if ws is None else ws.data_ptr(),
                        None if arrivals is None else arrivals.data_ptr(),
                        M, K, N, G, splits, k_per_split, int(spread),
                        int(out_dtype == torch.float32), build.stream_of(x))
    build.check(lib, rc, "quant_matmul")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
