"""Fused decode layer: kernel A, decode attention, kernel C.

Port of ``deepspeed_tpu/ops/pallas/decode_block.py`` (the TPU kernels
``_qkv_ln_kernel`` and ``_out_mlp_kernel``). A decode layer runs as

    kernel A  norm1(x) @ dequant(Wqkv) + bias, RoPE on the q and k heads
              (``ops/csrc/fused_qkv_ln.cu``)
    commit    the new k and v rows written into the cache at ``pos``
    attention ``decode_attention`` over each row's ``[start, pos + 1)``
    kernel C  o-projection + bias + residual -> norm2 -> up (and gate)
              + bias + activation -> down + bias + residual
              (``ops/csrc/fused_out_mlp.cu``)

in place of the per-projection path's ~8 kernels and ~20 small PyTorch ops
per layer; the scheduler's decode, verify and chunk steps run kernels A and
C on M = slots, slots x (1 + spec_tokens) and slots x chunk rows.

What bounds the kernels on the H100: at decode the int8 weight bytes over
3.35 TB/s; at the chunk step the products' operations over the 989 TFLOP/s
of the bf16 tensor cores. Both are a norm pass (a row's normalized bf16
values written once) and products on ``quant_matmul``'s tensor-core
mainloops (``ops/csrc/qmm_core.cuh``: ``mma.sync`` at M <= 32, ``wgmma``
with TMA-fed tiles at M > 32) with elementwise epilogues (bias, RoPE,
residuals, activation), several launches issued by one C call. A row's
bits never depend on M or on the launch plan (:func:`_plan`): every plan
runs the same segment partials and the same ordered fma chain, so the
scheduler's chunk, verify and decode steps give a row the same bits (K=1 ==
K=4, radix hit == cold, spec 4 == 0 on the card). The CUDA sources' headers
say more.

Operand layouts are the JAX functions': ``norms`` is (4, H) fp32 with rows
[norm1 scale, norm1 bias, norm2 scale, norm2 bias] (zero bias rows for
rmsnorm); each projection is ``(int8 (K, N), fp32 scales (G, N), fp32 bias
(N,))``; ``rope`` is ``(sin2d, cos2d, rot_heads, hd)`` with (B, hd/2) fp32
tables gathered at each row's position.

The plain versions follow the JAX kernels' arithmetic step by step (norms
in fp32 and cast to the compute dtype before each dot, per-group fp32
partials times their scale row, biases, RoPE and the residuals in fp32, one
cast at the end) with one difference: the JAX kernel C keeps the up and
gate partial sums in the compute dtype between its k-blocks, so at bf16 it
rounds them once per k-block; the port keeps them in fp32, in the plain
version and in the kernel.

A CUDA tensor launches the kernel (or the call raises); a CPU tensor, or
``impl="plain"``, takes the plain version.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build
from .decode_attention import decode_attention
from .quant_matmul import _split_plan as _narrow_splits
from .quant_matmul import quant_matmul_plain

# the CUDA sources under ops/csrc this module launches
SOURCES = ("fused_qkv_ln", "fused_out_mlp")
_libs = {}
# device -> zeroed int32 arrival counts of the mma.sync plans' block tiles.
# One buffer a device holds while calls on a device run one at a time: the
# serving fleet's pump threads all launch on the device's default stream (a
# new thread's current stream), so their kernels queue in one order. A
# stream per replica would need a buffer per stream.
_flags = {}

# the products' tiling (ops/csrc/qmm_core.cuh): 128 columns a block, K in
# segments of at most 128 rows inside a quantization group; mma.sync up to
# 32 rows a block, wgmma on 64 or 128
_COLS, _SEG, _NARROW_M = 128, 128, 32
# the H100's SMs: a wgmma plan aims at one block an SM
_SMS = 132
# the most segment-partial workspace a wgmma plan may take to split K
_WS_CAP = 16 << 20
# a planted fault for the invariance gate's own check (chip_smoke.py's
# block_invariance): when set, the wgmma path with the chain in registers
# runs the chain over K's segments in reverse order. 0 on every other call.
_plant = 0
# activation codes of fused_layer.cuh
_ACTS = {"gelu": 0, "gelu_exact": 1, "quick_gelu": 2, "silu": 3, "relu": 4}


def _bind(name, lib):
    if name == "fused_qkv_ln":
        lib.qkv_ln_launch.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                                      + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.qkv_ln_launch.restype = ctypes.c_int
    else:
        lib.out_mlp_launch.argtypes = ([ctypes.c_void_p] * 21 + [ctypes.c_int] * 14
                                       + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.out_mlp_launch.restype = ctypes.c_int


def _lib(name):
    return build.bind(_libs, name, lambda lib: _bind(name, lib))


def _flags_for(device, n):
    """n zeroed int32 arrival counts on ``device``; the kernels leave them
    zeroed (one call at a time on a device uses them)."""
    buf = _flags.get(device)
    if buf is None or buf.numel() < n:
        buf = _flags[device] = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
    return buf


def _tiles(M, N, plan):
    """The block tiles of an mma.sync plan (one arrival count each)."""
    bm = plan[0]
    return 0 if bm > _NARROW_M else -(-M // bm) * -(-N // _COLS)


def _scratch(device, *sizes):
    """One allocation carved into 256-byte aligned pieces of ``sizes`` bytes:
    the pieces' addresses."""
    offs, total = [], 0
    for n in sizes:
        offs.append(total)
        total += -(-n // 256) * 256
    buf = torch.empty((max(total, 1), ), dtype=torch.uint8, device=device)
    base = buf.data_ptr()
    return buf, [base + o if n else None for o, n in zip(offs, sizes)]


def _segments(K, G):
    """K's segments: at most 128 rows, never across a quantization group."""
    return G * -(-(K // G) // _SEG)


@functools.lru_cache(maxsize=4096)
def _plan(M, K, N, G, passes=1):
    """(bm, splits) of one product: bm rows of x a block (8, 16 or 32:
    mma.sync; 64 or 128: wgmma) and the blocks K is split over (the segment
    partials then go to a workspace and an ordered reduce runs the chain).

    At M <= 32, and for a shape the wgmma path cannot take (N % 16, a group
    size that is not a multiple of 128), mma.sync with ``quant_matmul``'s
    M-free split plan. At M > 32, wgmma on the row tile (64 or 128) whose
    waves of blocks take the least time (a 64-row block takes about two
    thirds of a 128-row one: the weight tile costs it as much), and K split
    where the tiles fill under half the SMs and the partials stay within
    ``_WS_CAP``. A plan decides only where the segment partials are made:
    every plan runs the same partials and the same chain, so a row's bits
    never depend on it or on M (``ops/csrc/qmm_core.cuh``)."""
    segs = _segments(K, G)
    if M <= _NARROW_M or N % 16 or (K // G) % _SEG:
        bm = 8 if M <= 8 else 16 if M <= 16 else _NARROW_M
        return bm, _narrow_splits(K, N)
    tiles_n = -(-N // _COLS)

    def cost(bm):  # waves of blocks x a block's time, which halving bm cuts by a third
        return -(-(-(-M // bm) * tiles_n) // _SMS) * (bm + 64)

    bm = 128 if cost(128) <= cost(64) else 64
    tiles = -(-M // bm) * tiles_n * passes
    splits = 1
    if 2 * tiles <= _SMS and passes * segs * M * N * 4 <= _WS_CAP:
        per = -(-segs // min(segs, _SMS // tiles))
        splits = -(-segs // per)
    return bm, splits


def _ws_floats(M, K, N, G, passes, plan):
    """The segment-partial workspace a plan writes: every segment of every
    pass, M x N floats each, unless the chain runs in registers."""
    bm, splits = plan
    return 0 if bm > _NARROW_M and splits == 1 else passes * _segments(K, G) * M * N


# ---------------------------------------------------------------- plain parts


def _norm(x32, norms, row, kind, eps):
    """Row ``row`` of ``norms`` is the scale, ``row + 1`` the bias (the JAX
    kernels' ``_norm``: two-pass variance; rmsnorm ignores the bias row)."""
    scale = norms[row].float()
    if kind == "rmsnorm":
        ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        return x32 * torch.rsqrt(ms + eps) * scale
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    return (x32 - mu) * torch.rsqrt(var + eps) * scale + norms[row + 1].float()


def _act(h, kind):
    if kind == "gelu":
        return F.gelu(h, approximate="tanh")
    if kind == "gelu_exact":
        return F.gelu(h)
    if kind == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    if kind == "silu":
        return F.silu(h)
    return torch.relu(h)


def _qdot(a, proj):
    """fp32 ``a @ dequant(W)``: per-group fp32 partials times their scale."""
    w, scales, _ = proj
    return quant_matmul_plain(a, w, scales, out_dtype=torch.float32)


def _rope_rotate(y, sin, cos, rot_heads, hd):
    """Rotate the first ``rot_heads`` head segments of the fused [q;k;v] row
    ``y`` (fp32 (B, N)), half-split convention; the v tail passes through."""
    B = y.shape[0]
    half = hd // 2
    r = y[:, :rot_heads * hd].reshape(B, rot_heads, hd)
    a, b = r[..., :half], r[..., half:]
    sin, cos = sin.float()[:, None], cos.float()[:, None]
    rot = torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1).reshape(B, rot_heads * hd)
    return torch.cat([rot, y[:, rot_heads * hd:]], dim=-1)


def _gated_act(activation, gate):
    """The activation kernel C applies: to the gate (silu for swiglu, tanh
    gelu for geglu) when the MLP is gated, else to the up projection."""
    if gate is None:
        return activation
    return "silu" if activation == "swiglu" else "gelu"


# ---------------------------------------------------------------- kernel A


def _check_qkv(x, norms, qkv, rope):
    if x.dim() != 2 or norms.dim() != 2 or norms.shape != (4, x.shape[1]):
        raise ValueError(f"expected x (B, H), norms (4, H); got {tuple(x.shape)}, {tuple(norms.shape)}")
    w, sc, b = qkv
    H = x.shape[1]
    if w.dim() != 2 or w.shape[0] != H or sc.dim() != 2 or sc.shape[1] != w.shape[1] \
            or H % sc.shape[0] or b.shape != (w.shape[1], ):
        raise ValueError(f"qkv: expected W (H={H}, N), scales (G, N) with G | H, bias (N,); got "
                         f"{tuple(w.shape)}, {tuple(sc.shape)}, {tuple(b.shape)}")
    if rope is not None:
        sin, cos, rot_heads, hd = rope
        if hd % 2 or rot_heads * hd > w.shape[1] or sin.shape != (x.shape[0], hd // 2) \
                or cos.shape != sin.shape:
            raise ValueError(f"rope: expected (B, hd/2) tables and rot_heads*hd <= N; got sin "
                             f"{tuple(sin.shape)}, cos {tuple(cos.shape)}, rot_heads={rot_heads}, hd={hd}")


def fused_qkv_ln_plain(x, norms, qkv, *, eps=1e-5, norm="layernorm", rope=None):
    """Plain PyTorch version of kernel A; returns (B, N) in x's dtype."""
    _check_qkv(x, norms, qkv, rope)
    xn = _norm(x.float(), norms, 0, norm, eps).to(x.dtype)
    y = _qdot(xn, qkv) + qkv[2].float()
    if rope is not None:
        sin, cos, rot_heads, hd = rope
        y = _rope_rotate(y, sin, cos, rot_heads, hd)
    return y.to(x.dtype)


def _require(name, t, dtype, device, what):
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{what} kernel: {name} must be a contiguous {dtype} tensor on {device}; "
                         f"got {t.dtype} on {t.device}, contiguous={t.is_contiguous()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} kernel: {name} must be 16-byte aligned")


def fused_qkv_ln(x, norms, qkv, *, eps=1e-5, norm="layernorm", rope=None, impl="kernel"):
    """norm1(x) @ dequant(Wqkv) + bias (+ RoPE) -> (B, N). x: (B, H); norms:
    (4, H) fp32, rows 0-1 used; qkv: (W int8 (H, N), scales (G, N), bias
    (N,)); rope: optional (sin2d, cos2d, rot_heads, hd). On the card: x bf16,
    H and N multiples of 4, and with RoPE a head dim that divides 128."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    if impl == "plain" or not x.is_cuda:
        return fused_qkv_ln_plain(x, norms, qkv, eps=eps, norm=norm, rope=rope)
    _check_qkv(x, norms, qkv, rope)
    if norm not in ("layernorm", "rmsnorm"):
        raise ValueError(f"fused_qkv_ln: norm must be 'layernorm' or 'rmsnorm', got {norm!r}")
    w, sc, b = qkv
    dev, what = x.device, "fused_qkv_ln"
    ops = [("x", x, torch.bfloat16), ("norms", norms, torch.float32), ("W", w, torch.int8),
           ("scales", sc, torch.float32), ("bias", b, torch.float32)]
    rot_cols, hd, sin, cos = 0, 2, None, None
    if rope is not None:
        sin, cos, rot_heads, hd = rope
        ops += [("sin", sin, torch.float32), ("cos", cos, torch.float32)]
        rot_cols = rot_heads * hd
        if _COLS % hd:
            raise ValueError(f"{what} kernel: RoPE needs a head dim dividing {_COLS} (a column "
                             f"tile holds whole heads); got {hd}")
    for name, t, dt in ops:
        _require(name, t, dt, dev, what)
    M, K = x.shape
    G, N = sc.shape
    if N % 4 or K % 4:
        raise ValueError(f"{what} kernel: H={K} and N={N} must be multiples of 4")
    plan = _plan(M, K, N, G)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    # the scratch allocation is held until the launches are queued
    keep, (xn, ws) = _scratch(dev, M * K * 2, 4 * _ws_floats(M, K, N, G, 1, plan))
    flags = _flags_for(dev, _tiles(M, N, plan))
    lib = _lib("fused_qkv_ln")
    rc = lib.qkv_ln_launch(x.data_ptr(), norms.data_ptr(), w.data_ptr(), sc.data_ptr(), b.data_ptr(),
                           None if sin is None else sin.data_ptr(),
                           None if cos is None else cos.data_ptr(), out.data_ptr(), xn, ws,
                           flags.data_ptr(), M, K, N, G, *plan, float(eps), int(norm == "rmsnorm"),
                           rot_cols, hd, _plant, build.stream_of(x))
    build.check(lib, rc, what)
    fused_qkv_ln.launches += 1
    return out


fused_qkv_ln.launches = 0

# ---------------------------------------------------------------- kernel C


def _check_out_mlp(attn2d, x, norms, o, up, down, gate):
    B, H = x.shape
    if attn2d.dim() != 2 or attn2d.shape[0] != B or norms.shape != (4, H):
        raise ValueError(f"expected attn2d (B, Ko), x (B, H), norms (4, H); got "
                         f"{tuple(attn2d.shape)}, {tuple(x.shape)}, {tuple(norms.shape)}")
    F_ = up[0].shape[1]
    want = [("o", o, attn2d.shape[1], H), ("up", up, H, F_), ("down", down, F_, H)]
    if gate is not None:
        want.append(("gate", gate, H, F_))
    for name, (w, sc, b), K, N in want:
        if tuple(w.shape) != (K, N) or sc.dim() != 2 or sc.shape[1] != N or K % sc.shape[0] \
                or tuple(b.shape) != (N, ):
            raise ValueError(f"{name}: expected W ({K}, {N}), scales (G, {N}) with G | {K}, bias "
                             f"({N},); got {tuple(w.shape)}, {tuple(sc.shape)}, {tuple(b.shape)}")
    if gate is not None and gate[1].shape != up[1].shape:
        raise ValueError("gate/up projections must share shape and quant grouping")


def fused_out_mlp_plain(attn2d, x, norms, o, up, down, *, activation="gelu", eps=1e-5,
                        norm="layernorm", gate=None):
    """Plain PyTorch version of kernel C; returns (B, H) in x's dtype."""
    _check_out_mlp(attn2d, x, norms, o, up, down, gate)
    act = _gated_act(activation, gate)
    res2 = _qdot(attn2d, o) + o[2].float() + x.float()
    ln2 = _norm(res2, norms, 2, norm, eps).to(x.dtype)
    ub = _qdot(ln2, up) + up[2].float()
    if gate is not None:
        h = _act(_qdot(ln2, gate) + gate[2].float(), act) * ub
    else:
        h = _act(ub, act)
    return (res2 + _qdot(h.to(x.dtype), down) + down[2].float()).to(x.dtype)


def fused_out_mlp(attn2d, x, norms, o, up, down, *, activation="gelu", eps=1e-5, norm="layernorm",
                  gate=None, impl="kernel"):
    """x + o_proj(attn) -> norm2 -> up [* act(gate)] -> down -> + residual,
    -> (B, H). attn2d: (B, nh*hd); x: (B, H) residual stream; norms (4, H)
    fp32, rows 2-3 used; o/up/down (and ``gate`` for swiglu/geglu): (W int8,
    scales, bias). On the card: bf16 activations, H and F multiples of 4."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    if impl == "plain" or not x.is_cuda:
        return fused_out_mlp_plain(attn2d, x, norms, o, up, down, activation=activation, eps=eps,
                                   norm=norm, gate=gate)
    _check_out_mlp(attn2d, x, norms, o, up, down, gate)
    what, dev = "fused_out_mlp", x.device
    act = _gated_act(activation, gate)
    if act not in _ACTS or norm not in ("layernorm", "rmsnorm"):
        raise ValueError(f"{what}: unsupported activation {activation!r} or norm {norm!r}")
    ops = [("attn2d", attn2d, torch.bfloat16), ("x", x, torch.bfloat16), ("norms", norms, torch.float32)]
    projs = [("o", o), ("up", up), ("down", down)] + ([("gate", gate)] if gate is not None else [])
    for name, (w, sc, b) in projs:
        ops += [(name + " W", w, torch.int8), (name + " scales", sc, torch.float32),
                (name + " bias", b, torch.float32)]
    for name, t, dt in ops:
        _require(name, t, dt, dev, what)
    M, H = x.shape
    Ko, F_ = attn2d.shape[1], up[0].shape[1]
    if H % 4 or F_ % 4:
        raise ValueError(f"{what} kernel: H={H} and F={F_} must be multiples of 4")
    Go, Gu, Gd = o[1].shape[0], up[1].shape[0], down[1].shape[0]
    passes = 1 if gate is None else 2
    shapes = [(Ko, H, Go, 1), (H, F_, Gu, passes), (F_, H, Gd, 1)]
    plans = [_plan(M, K, N, G, p) for K, N, G, p in shapes]
    ws_n = max(_ws_floats(M, K, N, G, p, plan) for (K, N, G, p), plan in zip(shapes, plans))
    out = torch.empty((M, H), dtype=torch.bfloat16, device=dev)
    # the scratch allocation is held until the launches are queued
    keep, (res2, ln2, h, ws) = _scratch(dev, M * H * 4, M * H * 2, M * F_ * 2, ws_n * 4)
    flags = _flags_for(dev, max(_tiles(M, N, plan) for (_, N, _, _), plan in zip(shapes, plans)))
    g = gate if gate is not None else (None, None, None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _lib(what)
    rc = lib.out_mlp_launch(
        ptr(attn2d), ptr(x), ptr(norms), *[ptr(t) for t in o], *[ptr(t) for t in up],
        *[ptr(t) for t in g], *[ptr(t) for t in down], ptr(out), res2, ln2, h, ws, ptr(flags),
        M, H, F_, Ko, Go, Gu, Gd, *plans[0], *plans[1], *plans[2], _ACTS[act], float(eps),
        int(norm == "rmsnorm"), _plant, build.stream_of(x))
    build.check(lib, rc, what)
    fused_out_mlp.launches += 1
    return out


fused_out_mlp.launches = 0

# ---------------------------------------------------------------- the layer


def fused_decode_block(x, norms, k_cache, v_cache, qkv, o, up, down, start, pos, *,
                       activation="gelu", eps=1e-5, block_kv=256, norm="layernorm", rope=None,
                       gate=None, impl="kernel"):
    """One fused transformer decode layer for a single token per row.

    x: (B, H) residual stream. k_cache/v_cache: (B, kv_heads, S, hd), written
    in place at slot ``pos`` (an int) before attention, as the unfused model
    path does. start: (B,) int32 first attendable slot of each row; attention
    covers ``[start, pos + 1)``. ``rope``: optional (sin2d, cos2d), (B, hd/2)
    fp32 tables gathered at each row's position. The rest as in
    :func:`fused_qkv_ln` and :func:`fused_out_mlp`.

    Returns (x_out (B, H), k_cache, v_cache), the caches being the same
    tensors, updated."""
    B, H = x.shape
    _, nkv, S, hd = k_cache.shape
    Nq = qkv[0].shape[1]
    nh = Nq // hd - 2 * nkv
    rope_op = None
    if rope is not None:
        sin2d, cos2d = rope
        rope_op = (sin2d, cos2d, nh + nkv, hd)
    qkv2d = fused_qkv_ln(x, norms, qkv, eps=eps, norm=norm, rope=rope_op, impl=impl)
    qf, kf, vf = torch.split(qkv2d, [nh * hd, nkv * hd, nkv * hd], dim=-1)
    k_cache[:, :, pos] = kf.reshape(B, nkv, hd)
    v_cache[:, :, pos] = vf.reshape(B, nkv, hd)
    attn = decode_attention(qf.reshape(B, nh, hd).contiguous(), k_cache, v_cache, start, pos + 1,
                            block_kv=min(block_kv, S), impl=impl)
    x_out = fused_out_mlp(attn.reshape(B, nh * hd), x, norms, o, up, down, activation=activation,
                          eps=eps, norm=norm, gate=gate, impl=impl)
    return x_out, k_cache, v_cache
