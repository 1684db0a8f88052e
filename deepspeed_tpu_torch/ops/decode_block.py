"""Fused single-token decode layer: kernel A, decode attention, kernel C.

Port of ``deepspeed_tpu/ops/pallas/decode_block.py`` (the TPU kernels
``_qkv_ln_kernel`` and ``_out_mlp_kernel``). A decode layer runs as

    kernel A  norm1(x) @ dequant(Wqkv) + bias, RoPE on the q and k heads
              (``ops/csrc/fused_qkv_ln.cu``)
    commit    the new k and v rows written into the cache at ``pos``
    attention ``decode_attention`` over each row's ``[start, pos + 1)``
    kernel C  o-projection + bias + residual -> norm2 -> up (and gate)
              + bias + activation -> down + bias + residual
              (``ops/csrc/fused_out_mlp.cu``, one cooperative launch)

in place of the per-projection path's ~8 kernels and ~20 small PyTorch ops
per layer. The CUDA sources' headers say what bounds each kernel on the
H100 and how its design answers that.

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

import torch
import torch.nn.functional as F

from . import build
from .decode_attention import decode_attention
from .quant_matmul import quant_matmul_plain

# the CUDA sources under ops/csrc this module launches
SOURCES = ("fused_qkv_ln", "fused_out_mlp")
_libs = {}
_arrivals = {}  # (kernel, device) -> zeroed int32 tile counters of the split-K reductions
_resident = {}  # (kernel, device) -> blocks the device holds at once

# the kernels' tiling (ops/csrc/int8_stream.cuh): 8 rows x 128 columns per
# work item, K split in whole 128-row staged chunks
_ROWS, _COLS, _CHUNK = 8, 128, 128
# activation codes of fused_out_mlp.cu
_ACTS = {"gelu": 0, "gelu_exact": 1, "quick_gelu": 2, "silu": 3, "relu": 4}


def _lib(name):
    lib = _libs.get(name)
    if lib is None:
        lib = build.load(name)
        lib.resident_blocks.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.resident_blocks.restype = ctypes.c_int
        if name == "fused_qkv_ln":
            lib.qkv_ln_launch.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                                          + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
            lib.qkv_ln_launch.restype = ctypes.c_int
        else:
            lib.out_mlp_launch.argtypes = ([ctypes.c_void_p] * 25 + [ctypes.c_int] * 14
                                           + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
            lib.out_mlp_launch.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def _counters(kernel, device, n):
    """Zeroed int32 tile counters; each kernel leaves them zeroed."""
    key = (kernel, device)
    buf = _arrivals.get(key)
    if buf is None or buf.numel() < n:
        buf = _arrivals[key] = torch.zeros(n, dtype=torch.int32, device=device)
    return buf


def _resident_blocks(name, device):
    """SMs x blocks per SM of kernel ``name`` on ``device`` (the occupancy
    query): the grid that fills the card in one wave, and for the
    cooperative kernel C the largest grid it may launch."""
    n = _resident.get((name, device))
    if n is None:
        lib = _lib(name)
        c = ctypes.c_int(0)
        with torch.cuda.device(device):
            build.check(lib, lib.resident_blocks(ctypes.byref(c)), f"{name} occupancy")
        n = _resident[(name, device)] = c.value
    return n


def _split_plan(K, N, blocks):
    """(splits, k_per_split): split K across blocks in whole staged chunks
    so that one row tile's (column tiles x splits) stays within ``blocks``.
    The plan depends on the weight's shape, never on the row count M: a
    row's sums run in the same order whatever else is in the batch, so the
    scheduler's chunk step (M = slots x chunk) and decode step (M = slots)
    compute a row's token bitwise alike (its K- and slot-invariance on the
    card). Beyond one row tile the work items outnumber the blocks and the
    kernels loop over them."""
    tiles = -(-N // _COLS)
    splits = max(1, min(blocks // tiles, -(-K // _CHUNK)))
    k_per = -(-K // (splits * _CHUNK)) * _CHUNK
    return -(-K // k_per), k_per


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
    splits, k_per = _split_plan(K, N, _resident_blocks(what, dev))
    tiles = -(-N // _COLS) * -(-M // _ROWS)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=dev)
    lib = _lib("fused_qkv_ln")
    rc = lib.qkv_ln_launch(x.data_ptr(), norms.data_ptr(), w.data_ptr(), sc.data_ptr(), b.data_ptr(),
                           None if sin is None else sin.data_ptr(),
                           None if cos is None else cos.data_ptr(), out.data_ptr(), ws.data_ptr(),
                           _counters(what, dev, tiles).data_ptr(), M, K, N, G, splits, k_per,
                           float(eps), int(norm == "rmsnorm"), rot_cols, hd, build.stream_of(x))
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
    lib = _lib(what)
    blocks = _resident_blocks(what, dev)
    so, ko = _split_plan(Ko, H, blocks)
    su, ku = _split_plan(H, F_, blocks)
    sd, kd = _split_plan(F_, H, blocks)
    tiles_h, tiles_f = -(-H // _COLS) * -(-M // _ROWS), -(-F_ // _COLS) * -(-M // _ROWS)
    arr = _counters(what, dev, 2 * tiles_h + tiles_f)
    f32 = torch.float32
    out = torch.empty((M, H), dtype=torch.bfloat16, device=dev)
    res2 = torch.empty((M, H), dtype=f32, device=dev)
    up_h = torch.empty((M, F_), dtype=torch.bfloat16, device=dev)
    ws_o = torch.empty((so, M, H), dtype=f32, device=dev)
    ws_u = torch.empty((su, M, F_), dtype=f32, device=dev)
    ws_g = torch.empty((su, M, F_), dtype=f32, device=dev) if gate is not None else None
    ws_d = torch.empty((sd, M, H), dtype=f32, device=dev)
    g = gate if gate is not None else (None, None, None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.out_mlp_launch(
        ptr(attn2d), ptr(x), ptr(norms), *[ptr(t) for t in o], *[ptr(t) for t in up],
        *[ptr(t) for t in g], *[ptr(t) for t in down], ptr(out), ptr(res2), ptr(up_h), ptr(ws_o),
        ptr(ws_u), ptr(ws_g), ptr(ws_d), ptr(arr), ptr(arr[tiles_h:]), ptr(arr[tiles_h + tiles_f:]),
        M, H, F_, Ko, o[1].shape[0], up[1].shape[0], down[1].shape[0], so, ko, su, ku, sd, kd,
        _ACTS[act], float(eps), int(norm == "rmsnorm"), blocks, build.stream_of(x))
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
