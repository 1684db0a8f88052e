"""The three w8a16 / w8a8 tilings of the decode-shape microbench.

Port of the TPU kernels of ``benchmarks/qmm_microbench.py``: ``_qmm2_kernel``
(the int8 tile widened to bf16 before the dot), ``_qmm3_kernel`` (the same
function, the s8 operand handed to the dot) and ``_qmm4_kernel`` (w8a8: a
per-row dynamic int8 quantization of x, an int8 x int8 dot in int32 per
group). All three compute

    out (M, N) fp32 = sum over groups g, in order, of part_g * scale

with ``part_g`` the group's (M, N) partial product and ``scale`` the group's
scale row ``s[g, :]`` (qmm4: ``sx[m] * s[g, n]``). The CUDA kernel is
``ops/csrc/qmm_microbench.cu``, one template in three modes; its header
says what bounds each one on the H100 and how its design answers that.
One launch a call, no workspace: a CTA walks all of K for a strip of 32
columns and 8 rows of x, and the grid comes from the shapes (``_grid``),
never from ``block_n``. ``block_n`` is the JAX kernel's column block: it is
checked as the JAX code checks it and sets nothing on the card, so the bench's ``new_n512``, ``new_n1024`` and ``new_n2560`` variants
run one configuration. ``block_k`` is the group size, as the JAX code takes
it at the bench's group of 128. qmm4 quantizes x inside the kernel, bit for
bit ``quantize_rows``.

A CUDA tensor launches the kernel (or the call raises); a CPU tensor, or
``impl="plain"``, takes the plain version (``qmm2_plain``, ``qmm3_plain``,
``qmm4_plain``), the same arithmetic in plain PyTorch in the same group
order.
"""

import collections
import ctypes

import torch

from . import build

# the CUDA sources under ops/csrc this module launches
SOURCES = ("qmm_microbench", )
_libs = {}
# 0, or a fault planted in the kernel for the card's gates to catch: 1 drops
# group 1 from the first strip's walk, 2 sums the groups in reverse order
_plant = 0

_MODES = {"qmm2": 0, "qmm3": 1, "qmm4": 2}
# the kernel's staging (ops/csrc/qmm_microbench.cu): 32-row mma steps; a
# group of at most 512 rows (the JAX kernel's largest block); strips of 32
# columns in clusters of 4 along N that share x's rows (N is a multiple of
# 128: block_n is, and divides it); TMA boxes of 8 KB (32 columns by 256 K
# rows) on a ring of at most 5 stages; the rows of x a CTA takes and its
# warps; the most dynamic shared memory a block may have and what the kernel
# adds for its 1024-byte alignment
_STEP_K, _MAX_GS = 32, 512
_STRIP, _CLUSTER = 32, 4
_BOX_BYTES, _MAX_STAGES = 8192, 5
_ROWS_M, _WARPS = 8, 8
_MAX_SMEM, _SMEM_ALIGN = 232448, 1024

Grid = collections.namedtuple("Grid", "ctas row_tiles stages smem")


def _bind(lib):
    lib.qmm_microbench_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                                          + [ctypes.c_void_p])
    lib.qmm_microbench_launch.restype = ctypes.c_int


def _kernel():
    return build.bind(_libs, SOURCES[0], _bind)


def _smem_bytes(which, K, G, stages):
    """A CTA's dynamic shared memory, as the kernel lays it out: the ring of
    weight boxes; x's rows in 1 KB slabs, a whole number of them for each
    CTA of the cluster; qmm2's per-warp bf16 copies of a pair of steps;
    qmm4's int8 rows; the groups' scaled partials; sx; the ring's counters
    and barriers; the alignment. The launch refuses a figure below the
    kernel's own ``Layout``."""
    slabs = -(-(K // 64) // _CLUSTER) * _CLUSTER
    nbytes = (stages * _BOX_BYTES + slabs * 1024 + (_WARPS * 2 * 32 * 24 * 2 if which == "qmm2" else 0)
              + (_ROWS_M * (K + 16) if which == "qmm4" else 0) + G * _STRIP * 32 + _ROWS_M * 4 + stages * 4)
    return -(-nbytes // 8) * 8 + (stages + 1) * 8 + _SMEM_ALIGN


def _grid(which, M, K, N, G):
    """The launch's grid, from the shapes alone: a CTA for each strip of 32
    columns and tile of 8 rows of x (160 CTAs at the bench's 8x1280x5120);
    a ring of as many 8 KB boxes as the strip's K rows fill, at most 5.
    Raises on what the kernel cannot take (a group that is not a multiple of
    32 rows or longer than 512, a K that is not a multiple of 64, an N that
    is not a multiple of 128, more shared memory than a block may take)."""
    gs = K // G
    if gs % _STEP_K or gs > _MAX_GS:
        raise ValueError(f"{which} kernel: the group size {gs} must be a multiple of {_STEP_K} "
                         f"and at most {_MAX_GS}")
    if K % 64:
        raise ValueError(f"{which} kernel: K={K} must be a multiple of 64 (x is loaded in 64-column slabs)")
    if N % (_STRIP * _CLUSTER):
        raise ValueError(f"{which} kernel: N={N} must be a multiple of {_STRIP * _CLUSTER}")
    row_tiles = -(-M // _ROWS_M)
    stages = min(-(-K // (_BOX_BYTES // _STRIP)), _MAX_STAGES)
    smem = _smem_bytes(which, K, G, stages)
    if smem > _MAX_SMEM:
        raise ValueError(f"{which} kernel: K={K}, G={G} need {smem} bytes of shared memory a CTA, "
                         f"more than the {_MAX_SMEM} a block may take")
    return Grid(N // _STRIP * row_tiles, row_tiles, stages, smem)


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
    amax = xf.abs().amax(dim=1)
    # a tensor divisor: a CUDA tensor divided by a Python number is
    # multiplied by its fp32 reciprocal, which is not the division
    sx = amax / torch.full_like(amax, 127.0) + 1e-12
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


def _plan(which, x, qw, scales, block_n, block_k):
    """The grid of a kernel call, after every check
    of the call's shapes: ``block_n`` is refused as the JAX code and the
    earlier grid refused it, and sets nothing."""
    M, K, N, G = _check(x, qw, scales, block_n, block_k)
    if block_n % 128:
        raise ValueError(f"{which} kernel: block_n={block_n} must be a multiple of 128")
    return _grid(which, M, K, N, G)


def _launch(which, x, qw, scales, block_n, block_k, out_dtype):
    grid = _plan(which, x, qw, scales, block_n, block_k)
    for name, t, dt in (("x", x, torch.bfloat16), ("qw", qw, torch.int8),
                        ("scales", scales, torch.float32)):
        if t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{which} kernel: {name} must be a contiguous {dt} tensor on {x.device}; "
                             f"got {t.dtype} on {t.device}, contiguous={t.is_contiguous()}")
        if t.data_ptr() % 16:
            raise ValueError(f"{which} kernel: {name} must be 16-byte aligned")
    M, K = x.shape
    N, G = qw.shape[1], scales.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    lib = _kernel()
    rc = lib.qmm_microbench_launch(_MODES[which], x.data_ptr(), qw.data_ptr(), scales.data_ptr(),
                                   out.data_ptr(), M, K, N, G, grid.stages, grid.smem, _plant,
                                   build.stream_of(x))
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
    """w8a8: x quantized per row (``quantize_rows``'s arithmetic, inside the
    kernel), an int8 tensor-core dot with exact int32 partials per group,
    each scaled by ``sx[m] * s[g, n]``."""
    return _route(qmm4, qmm4_plain, x, qw, scales, block_n, block_k, out_dtype, impl)


qmm2.launches = qmm3.launches = qmm4.launches = 0
