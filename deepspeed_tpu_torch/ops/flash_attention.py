"""Flash attention, forward and backward, with the per-row log-sum-exp.

Port of ``deepspeed_tpu/ops/pallas/flash_attention.py`` (the TPU kernels
``_fwd_kernel``, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``; entry points
``flash_attention`` and ``flash_attention_with_lse``). The CUDA kernels are
``ops/csrc/flash_attention_fwd.cu`` and ``ops/csrc/flash_attention_bwd.cu``;
their headers say what bounds them on the H100 and how their designs answer
that.

q (B, H, T, D); k/v (B, Hkv, Tk, D) with H a multiple of Hkv (GQA-native:
query head h reads KV head h // (H // Hkv)). Returns out (B, H, T, D) in q's
dtype and lse (B, H, T) fp32; a row that attends nothing gets out 0 and
lse -inf.

Both entry points are differentiable through one registered operator,
``torch.ops.deepspeed_tpu_torch.flash_fwd`` (:func:`flash_fwd_op`), whose
autograd saves q, k, v, out and lse; its backward computes ``delta =
rowsum(dO * O)`` in fp32 (minus the lse cotangent, which folds into the
same kernels), launches the dq and the dk/dv kernels, and sums dk/dv over
the GQA group. Forward and backward each choose
by device: a CUDA tensor launches the kernels (or the call raises); a CPU
tensor, or ``impl="plain"``, takes :func:`flash_attention_plain` and
:func:`flash_attention_bwd_plain`.
"""

import ctypes
import math
import threading
from typing import Optional, Tuple

import torch

from . import build

# the CUDA sources under ops/csrc this module launches
SOURCES = ("flash_attention_fwd", "flash_attention_bwd")
_lib = {}


def _bind(name, lib):
    if name == "flash_attention_fwd":
        lib.flash_fwd_launch.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_fwd_launch.restype = ctypes.c_int
    else:
        lib.flash_bwd_dq_launch.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                                            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_bwd_dq_launch.restype = ctypes.c_int
        lib.flash_bwd_dkv_launch.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                                             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_bwd_dkv_launch.restype = ctypes.c_int


def _kernel(name):
    return build.bind(_lib, name, lambda lib: _bind(name, lib))


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, H, T, D), k/v (B, Hkv, Tk, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, T, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"query heads {H} not a multiple of kv heads {k.shape[1]}")


def _check_kernel_operands(what, bf16=(), fp32=(), like=None):
    """The kernels take contiguous bf16 (fp32 for lse/delta) tensors on one
    card, head dim 64 or 128."""
    for name, t, dt in [(n, t, torch.bfloat16) for n, t in bf16] + [(n, t, torch.float32) for n, t in fp32]:
        if t.dtype != dt or t.device != like.device or not t.is_contiguous():
            raise ValueError(f"{what} kernel: {name} must be a contiguous {dt} tensor on "
                             f"{like.device}; got {t.dtype} on {t.device}, contiguous={t.is_contiguous()}")
    if like.shape[-1] not in (64, 128):
        raise ValueError(f"{what} kernel: head dim {like.shape[-1]} not in (64, 128)")


def _check_aligned(what, **tensors):
    """The kernels load through TMA, whose tensors start on 16-byte
    boundaries."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{what} kernel: {name} must start on a 16-byte boundary")


def _aligned(t):
    """``t`` contiguous and 16-byte aligned (a copy only when it is not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _scale(scale, D):
    return scale if scale is not None else 1.0 / (D**0.5)


def _kernel_scale(scale, D):
    """The forward kernel's softmax scale: it folds log2(e) into a positive
    scale and takes the row max before scaling, so it refuses a scale that
    is not a finite number above 0 (the plain version takes any)."""
    scale = float(_scale(scale, D))
    if not (math.isfinite(scale) and scale > 0):
        raise ValueError(f"flash_attention kernel: scale must be a finite number > 0, got {scale}")
    return scale


def _bwd_kernel_scale(scale, D, what):
    """The backward kernels' scale: they fold scale * log2(e) into
    exp2(s * c - lse * log2(e)) and take no row max, so any finite scale
    works; they refuse an infinite or NaN one."""
    scale = float(_scale(scale, D))
    if not math.isfinite(scale):
        raise ValueError(f"{what} kernel: scale must be finite, got {scale}")
    return scale


def _causal_keep(T, Tk, causal, device):
    if not causal:
        return torch.ones((T, Tk), dtype=torch.bool, device=device)
    return torch.arange(Tk, device=device)[None, :] <= torch.arange(T, device=device)[:, None]


def flash_attention_plain(q, k, v, causal=True, scale=None):
    """Plain PyTorch version of the forward: fp32 scores and softmax, with
    ``p`` rounded to v's dtype before the P V product and the row sum taken
    on the unrounded ``p`` (the TPU kernel's rounding point)."""
    _check(q, k, v)
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    scale = _scale(scale, D)
    g = H // Hkv
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale  # (B, H, T, Tk)
    s = s.masked_fill(~_causal_keep(T, Tk, causal, q.device), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.matmul(p.to(v.dtype).float(), vf) / l_safe
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")), m + torch.log(l_safe))
    return out.to(q.dtype), lse[..., 0]


def flash_attention_fwd(q, k, v, causal=True, scale=None):
    """The forward kernel on CUDA tensors: (out, lse). Counts its launches."""
    _check(q, k, v)
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    _check_kernel_operands("flash_attention", bf16=(("q", q), ("k", k), ("v", v)), like=q)
    _check_aligned("flash_attention", q=q, k=k, v=v)
    scale = _kernel_scale(scale, D)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _kernel("flash_attention_fwd")
    rc = lib.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                              lse.data_ptr(), B, H, Hkv, T, Tk, D, scale, int(bool(causal)),
                              build.stream_of(q))
    build.check(lib, rc, "flash_attention")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=True, scale=None, g_lse=None):
    """Plain PyTorch version of the backward, following ``_flash_bwd_impl``'s
    arithmetic: fp32 scores and products, ``ds`` rounded to q's dtype before
    its products and ``p`` to dO's dtype before dv's (the TPU kernels'
    rounding points), a row with lse -inf (attended nothing) read as lse 0,
    and the lse cotangent ``g_lse`` folded into delta. Returns (dq, dk, dv)
    with dk/dv summed over the GQA group."""
    _check(q, k, v)
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = _scale(scale, D)
    delta = _delta(out, dout, g_lse)[..., None]
    lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))[..., None]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    qf, dof = q.float(), dout.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    keep = _causal_keep(T, Tk, causal, q.device)
    p = torch.where(keep, torch.exp(s - lse), torch.zeros_like(s))
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf).to(k.dtype)
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), dof).to(v.dtype)
    return dq.to(q.dtype), _group_sum(dk, Hkv), _group_sum(dv, Hkv)


def _delta(out, dout, g_lse):
    """delta = rowsum(dO * O) in fp32, minus the lse cotangent if any."""
    delta = (dout.float() * out.float()).sum(dim=-1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta


def _group_sum(x, Hkv):
    """Per-query-head (B, H, Tk, D) gradients summed onto the KV heads."""
    B, H, Tk, D = x.shape
    if H == Hkv:
        return x
    return x.reshape(B, Hkv, H // Hkv, Tk, D).sum(dim=2)


def flash_bwd_dq(q, k, v, dout, lse, delta, causal=True, scale=None):
    """The dq kernel on CUDA tensors. Counts its launches."""
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    _check_kernel_operands("flash_bwd_dq", bf16=(("q", q), ("k", k), ("v", v), ("dout", dout)),
                           fp32=(("lse", lse), ("delta", delta)), like=q)
    _check_aligned("flash_bwd_dq", q=q, k=k, v=v, dout=dout)
    scale = _bwd_kernel_scale(scale, D, "flash_bwd_dq")
    dq = torch.empty_like(q)
    lib = _kernel("flash_attention_bwd")
    rc = lib.flash_bwd_dq_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, H, Hkv, T, Tk,
                                 D, scale, int(bool(causal)), build.stream_of(q))
    build.check(lib, rc, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal=True, scale=None):
    """The dk/dv kernel on CUDA tensors: per-query-head (dk, dv), (B, H, Tk,
    D), not yet summed over the GQA group. Counts its launches."""
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    _check_kernel_operands("flash_bwd_dkv", bf16=(("q", q), ("k", k), ("v", v), ("dout", dout)),
                           fp32=(("lse", lse), ("delta", delta)), like=q)
    _check_aligned("flash_bwd_dkv", q=q, k=k, v=v, dout=dout)
    scale = _bwd_kernel_scale(scale, D, "flash_bwd_dkv")
    dk = torch.empty((B, H, Tk, D), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    lib = _kernel("flash_attention_bwd")
    rc = lib.flash_bwd_dkv_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                                  lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B,
                                  H, Hkv, T, Tk, D, scale, int(bool(causal)),
                                  build.stream_of(q))
    build.check(lib, rc, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, causal=True, scale=None, g_lse=None,
                        impl="kernel"):
    """(dq, dk, dv) of softmax attention; the kernels on CUDA tensors, else
    :func:`flash_attention_bwd_plain`."""
    if impl == "plain" or not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal, scale, g_lse)
    _check(q, k, v)
    q, k, v, dout = (_aligned(t) for t in (q, k, v, dout))
    delta = _delta(out, dout, g_lse)
    dq = flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, causal, scale)
    Hkv = k.shape[1]
    return dq, _group_sum(dk, Hkv), _group_sum(dv, Hkv)


@torch.library.custom_op("deepspeed_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                 scale: Optional[float], impl: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) = attention(q, k, v) as one dispatched operator: the
    forward kernel on CUDA tensors, :func:`flash_attention_plain` on CPU
    tensors or with ``impl="plain"``. A selective-checkpoint policy sees
    this operator (and none of the work inside it), so it can keep its
    outputs (``dots_and_attn_saveable``, the JAX package's
    ``checkpoint_name(..., "flash_out"/"flash_lse")``) or run it again in
    the backward pass (``nothing_saveable``, ``dots_saveable``)."""
    residuals = getattr(HOST_RESIDUALS, "active", None)
    if residuals is not None and residuals.replaying:
        return residuals.pop(q.device)
    if impl == "plain" or not q.is_cuda:
        out = flash_attention_plain(q, k, v, causal, scale)
    else:
        q, k, v = (_aligned(t) for t in (q, k, v))
        out = flash_attention_fwd(q, k, v, causal, scale)
    if residuals is not None:
        residuals.push(out)
    return out


# ``runtime/activation_checkpointing/checkpointing.py``'s cpu_checkpointing:
# the active region's host copies of (out, lse), recorded in the region's
# forward and handed back in order when its backward recomputes it
HOST_RESIDUALS = threading.local()


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, scale, impl):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, scale, impl = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal, ctx.scale, ctx.impl = causal, scale, impl


def _flash_backward(ctx, g_out, g_lse):
    """Gradients in q, k and v through both outputs (the lse cotangent
    folds into delta)."""
    q, k, v, out, lse = ctx.saved_tensors
    if g_out is None:
        g_out = torch.zeros_like(out)
    dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g_out, ctx.causal, ctx.scale, g_lse,
                                     ctx.impl)
    return dq, dk, dv, None, None, None


flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def flash_attention_with_lse(q, k, v, causal=True, scale=None, impl="kernel"):
    """(out, lse) of softmax attention; see the module docstring."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    _check(q, k, v)
    return flash_fwd_op(q, k, v, bool(causal), None if scale is None else float(scale), impl)


def flash_attention(q, k, v, causal=True, scale=None, impl="kernel"):
    """Attention output only (B, H, T, D); see :func:`flash_attention_with_lse`."""
    return flash_attention_with_lse(q, k, v, causal, scale, impl)[0]


def sharded_flash_attention(q, k, v, causal=True, scale=None, impl="kernel", axis="tensor"):
    """:func:`flash_attention` over ``axis`` of the ``comm`` mesh (the JAX
    package's ``sharded_flash_attention``, its head-parallel placement):
    replicated q (B, H, T, D) and k/v (B, Hkv, Tk, D), the kernel on this
    rank's H/t query heads and Hkv/t kv heads, the heads all-gathered
    (forward only). Bitwise the unsharded call; a head count the degree
    does not divide raises."""
    from .decode_attention import _on_heads
    return _on_heads(flash_attention, axis, q, k, v, causal, scale, impl)
