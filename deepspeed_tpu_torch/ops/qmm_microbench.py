"""The three w8a16 / w8a8 tilings of the decode-shape microbench.

Port of the TPU kernels of ``benchmarks/qmm_microbench.py``: ``_qmm2_kernel``
(the int8 tile widened to bf16 before the dot), ``_qmm3_kernel`` (the same
function, the s8 operand handed to the dot) and ``_qmm4_kernel`` (w8a8: a
per-row dynamic int8 quantization of x, an int8 x int8 dot in int32 per
group). All three compute

    out (M, N) fp32 = sum over groups g, in order, of part_g * scale

with ``part_g`` the group's (M, N) partial product and ``scale`` the group's
scale row ``s[g, :]`` (qmm4: ``sx[m] * s[g, n]``). The CUDA kernels are
``ops/csrc/qmm_microbench.cu``; its header says what bounds each one on the
H100 and how its design answers that. ``block_n`` is the JAX kernel's column
block, which is the CUDA kernel's column tile, so the bench's ``new_n512``,
``new_n1024`` and ``new_n2560`` variants are three configurations of one
kernel. ``block_k`` is the group size, as the JAX code takes it at the
bench's group of 128.

A CUDA tensor launches the kernel (or the call raises); a CPU tensor, or
``impl="plain"``, takes the plain version (``qmm2_plain``, ``qmm3_plain``,
``qmm4_plain``), the same arithmetic in plain PyTorch in the same group
order.
"""

import ctypes

import torch

from . import build

# the CUDA sources under ops/csrc this module launches
SOURCES = ("qmm_microbench", )
_lib = None

# the kernels' staging (ops/csrc/qmm_microbench.cu): chunks of 32 K rows by
# 128 columns; the x stage holds a group of at most 512 K rows
_CHUNK_K, _CHUNK_N, _MAX_GS = 32, 128, 512


def _kernel():
    global _lib
    if _lib is None:
        lib = build.load(SOURCES[0])
        for fn in (lib.qmm2_launch, lib.qmm3_launch):
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.qmm4_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.qmm4_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, qw, scales, block_n, block_k):
    """(M, K, N, G) of a call; raises on shapes the JAX function refuses."""
    if x.dim() != 2 or qw.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"expected x (M, K), qw (K, N), scales (G, N); got "
                         f"{tuple(x.shape)}, {tuple(qw.shape)}, {tuple(scales.shape)}")
    M, K = x.shape
    K2, N = qw.shape
    G = scales.shape[0]
    if K != K2 or scales.shape[1] != N or K % G:
        raise ValueError(f"x {tuple(x.shape)}, qw {tuple(qw.shape)}, scales {tuple(scales.shape)}: "
                         f"K must agree, scales must have N columns and G must divide K")
    if N % block_n:
        raise ValueError(f"block_n={block_n} must divide N={N}")
    if block_k not in (None, K // G):
        raise ValueError(f"block_k={block_k}: the kernels take one group ({K // G} rows) per K step")
    return M, K, N, G


def _groups(K, G):
    gs = K // G
    return [slice(g * gs, (g + 1) * gs) for g in range(G)]


def qmm2_plain(x, qw, scales, block_n=512, block_k=None, out_dtype=torch.float32):
    """Plain version: per group, the fp32 product of x and the widened int8
    rows (every bf16 x int8 product is exact in fp32), times the group's
    scale row, added to the sum in group order."""
    M, K, N, G = _check(x, qw, scales, block_n, block_k)
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for g, sl in enumerate(_groups(K, G)):
        acc = acc + torch.mm(x[:, sl].float(), qw[sl].float()) * scales[g].float()
    return acc.to(out_dtype)


def qmm3_plain(x, qw, scales, block_n=2560, block_k=None, out_dtype=torch.float32):
    """Plain version of qmm3: the same function as qmm2 (only the kernel's
    path to the dot differs)."""
    return qmm2_plain(x, qw, scales, block_n, block_k, out_dtype)


def quantize_rows(x):
    """The JAX code's dynamic per-row activation quantization, bitwise: in
    fp32, ``sx = max|x| / 127 + 1e-12`` and ``xq = clip(round(x / sx), -127,
    127)`` as int8 (``torch.round`` rounds half to even as ``jnp.round``
    does). Returns (xq (M, K) int8, sx (M,) fp32)."""
    xf = x.float()
    sx = xf.abs().amax(dim=1) / 127.0 + 1e-12
    xq = torch.clamp(torch.round(xf / sx[:, None]), -127, 127).to(torch.int8)
    return xq, sx


def qmm4_plain(x, qw, scales, block_n=2560, block_k=None, out_dtype=torch.float32):
    """Plain version of qmm4: each group's int8 x int8 dot is exact (float64
    sums of integers below 2^53, the same integers as an int32 dot), then
    ``acc = acc + float(part) * (sx[m] * s[g, n])`` in fp32, in group order,
    each product and sum rounded once: bitwise the kernel."""
    M, K, N, G = _check(x, qw, scales, block_n, block_k)
    xq, sx = quantize_rows(x)
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for g, sl in enumerate(_groups(K, G)):
        part = torch.mm(xq[:, sl].double(), qw[sl].double()).float()
        acc = acc + part * (sx[:, None] * scales[g].float()[None, :])
    return acc.to(out_dtype)


def _launch(which, x, qw, scales, block_n, block_k, out_dtype):
    M, K, N, G = _check(x, qw, scales, block_n, block_k)
    gs = K // G
    if gs % _CHUNK_K or gs > _MAX_GS:
        raise ValueError(f"{which} kernel: the group size {gs} must be a multiple of {_CHUNK_K} "
                         f"and at most {_MAX_GS}")
    if block_n % _CHUNK_N:
        raise ValueError(f"{which} kernel: block_n={block_n} must be a multiple of {_CHUNK_N}")
    for name, t, dt in (("x", x, torch.bfloat16), ("qw", qw, torch.int8),
                        ("scales", scales, torch.float32)):
        if t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{which} kernel: {name} must be a contiguous {dt} tensor on {x.device}; "
                             f"got {t.dtype} on {t.device}, contiguous={t.is_contiguous()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{which} kernel: {name} must be 16-byte aligned")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    lib = _kernel()
    dims = (M, K, N, G, block_n, build.stream_of(x))
    if which == "qmm4":
        xq, sx = quantize_rows(x)  # outside the kernel, as outside pallas_call in JAX
        ws = torch.empty((G, M, N), dtype=torch.int32, device=x.device)
        rc = lib.qmm4_launch(xq.data_ptr(), sx.data_ptr(), qw.data_ptr(), scales.data_ptr(),
                             out.data_ptr(), ws.data_ptr(), *dims)
    else:
        ws = torch.empty((G, M, N), dtype=torch.float32, device=x.device)
        fn = lib.qmm2_launch if which == "qmm2" else lib.qmm3_launch
        rc = fn(x.data_ptr(), qw.data_ptr(), scales.data_ptr(), out.data_ptr(), ws.data_ptr(), *dims)
    build.check(lib, rc, which)
    return out.to(out_dtype)


def _route(fn, plain, x, qw, scales, block_n, block_k, out_dtype, impl):
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    if impl == "plain" or not x.is_cuda:
        return plain(x, qw, scales, block_n, block_k, out_dtype)
    out = _launch(fn.__name__, x, qw, scales, block_n, block_k, out_dtype)
    fn.launches += 1
    return out


def qmm2(x, qw, scales, block_n=512, block_k=None, out_dtype=torch.float32, impl="kernel"):
    """``x @ dequantize(qw, scales)`` with the int8 tile widened to bf16 in
    shared memory before a bf16 tensor-core dot -> (M, N) ``out_dtype``."""
    return _route(qmm2, qmm2_plain, x, qw, scales, block_n, block_k, out_dtype, impl)


def qmm3(x, qw, scales, block_n=2560, block_k=None, out_dtype=torch.float32, impl="kernel"):
    """The same function with the int8 fragments widened in registers right
    before the bf16 tensor-core dot (no bf16 copy of the tile)."""
    return _route(qmm3, qmm3_plain, x, qw, scales, block_n, block_k, out_dtype, impl)


def qmm4(x, qw, scales, block_n=2560, block_k=None, out_dtype=torch.float32, impl="kernel"):
    """w8a8: x quantized per row (``quantize_rows``), an int8 tensor-core dot
    with exact int32 partials per group, each scaled by ``sx[m] * s[g, n]``."""
    return _route(qmm4, qmm4_plain, x, qw, scales, block_n, block_k, out_dtype, impl)


qmm2.launches = qmm3.launches = qmm4.launches = 0
