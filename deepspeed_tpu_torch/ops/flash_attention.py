"""Flash attention forward, with the per-row log-sum-exp.

Port of the forward of ``deepspeed_tpu/ops/pallas/flash_attention.py`` (the
TPU kernel ``_fwd_kernel``; entry points ``flash_attention`` and
``flash_attention_with_lse``). The CUDA kernel is
``ops/csrc/flash_attention_fwd.cu``; its header says what bounds it on the
H100 and how its design answers that. The backward kernels are not ported
yet (training, ROADMAP Queue 2).

q (B, H, T, D); k/v (B, Hkv, Tk, D) with H a multiple of Hkv (GQA-native:
query head h reads KV head h // (H // Hkv)). Returns out (B, H, T, D) in q's
dtype and lse (B, H, T) fp32; a row that attends nothing gets out 0 and
lse -inf.

A CUDA tensor launches the kernel (or the call raises); a CPU tensor, or
``impl="plain"``, takes :func:`flash_attention_plain`.
"""

import ctypes

import torch

from . import build

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = build.load("flash_attention_fwd")
        lib.flash_fwd_launch.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.flash_fwd_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, H, T, D), k/v (B, Hkv, Tk, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, T, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"query heads {H} not a multiple of kv heads {k.shape[1]}")


def flash_attention_plain(q, k, v, causal=True, scale=None):
    """Plain PyTorch version of the same function (fp32 softmax)."""
    _check(q, k, v)
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (D**0.5)
    g = H // Hkv
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale  # (B, H, T, Tk)
    mask = torch.ones((T, Tk), dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.arange(Tk, device=q.device)[None, :] <= torch.arange(T, device=q.device)[:, None]
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.matmul(p, vf) / l_safe
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")), m + torch.log(l_safe))
    return out.to(q.dtype), lse[..., 0]


def flash_attention_with_lse(q, k, v, causal=True, scale=None, impl="kernel"):
    """(out, lse) of softmax attention; see the module docstring."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    if impl == "plain" or not q.is_cuda:
        return flash_attention_plain(q, k, v, causal, scale)
    _check(q, k, v)
    B, H, T, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} must be a contiguous bf16 tensor on "
                             f"{q.device}; got {t.dtype} on {t.device}, contiguous={t.is_contiguous()}")
    if D not in (64, 128):
        raise ValueError(f"flash_attention kernel: head dim {D} not in (64, 128)")
    scale = scale if scale is not None else 1.0 / (D**0.5)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _kernel()
    rc = lib.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                              lse.data_ptr(), B, H, Hkv, T, Tk, D, float(scale), int(bool(causal)),
                              build.stream_of(q))
    build.check(lib, rc, "flash_attention")
    flash_attention_with_lse.launches += 1
    return out, lse


flash_attention_with_lse.launches = 0


def flash_attention(q, k, v, causal=True, scale=None, impl="kernel"):
    """Attention output only (B, H, T, D); see :func:`flash_attention_with_lse`."""
    return flash_attention_with_lse(q, k, v, causal, scale, impl)[0]
