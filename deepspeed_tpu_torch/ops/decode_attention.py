"""Single-token decode attention over a contiguous KV cache.

Port of ``deepspeed_tpu/ops/pallas/decode_attention.py::decode_attention``
(the TPU kernel ``_decode_kernel`` in its decode mode: bf16 KV, one query per
row). The CUDA kernel is ``ops/csrc/decode_attention.cu``; its header says
what bounds it on the H100 and how its design answers that. The paged,
span, extent and int8-KV modes come with the scheduler (ROADMAP Queue 2).

q (B, H, D); k_cache/v_cache (B, kv_heads, S, D); row b attends the cache
slots ``[start[b], end[b])``. ``end`` is a scalar shared by every row (the
static-batch engine: ``cache_index + 1``) or a (B,) tensor of per-row ends
(the scheduler's contract). Returns (B, H, D) in q's dtype; a row whose
window is empty gets zeros.

A CUDA tensor launches the kernel (or the call raises); a CPU tensor, or
``impl="plain"``, takes :func:`decode_attention_plain`.
"""

import ctypes

import torch

from . import build

_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = build.load("decode_attention")
        lib.decode_launch.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                                      + [ctypes.c_float, ctypes.c_void_p])
        lib.decode_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _windows(q, k_cache, start, end, block_kv):
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"expected q (B, H, D), cache (B, kv_heads, S, D); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}")
    B, H, D = q.shape
    nkv, S = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != D or H % nkv:
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match q {tuple(q.shape)}")
    block_kv = min(block_kv, S)
    if S % block_kv:
        raise ValueError(f"cache length {S} must be a multiple of block_kv={block_kv}")
    return _rows(start, B, q.device), _rows(end, B, q.device)


def _rows(v, B, device):
    """A scalar or (B,) window bound as a contiguous (B,) int32 tensor. A
    Python scalar becomes a device fill, never a host-to-device copy, which
    would wait for the stream."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32).expand(B).contiguous()
    return torch.full((B, ), int(v), dtype=torch.int32, device=device)


def decode_attention_plain(q, k_cache, v_cache, start, end, *, block_kv=256, scale=None):
    """Plain PyTorch version of the same function (fp32 softmax)."""
    start, ends = _windows(q, k_cache, start, end, block_kv)
    B, H, D = q.shape
    nkv, S = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / (D**0.5)
    qg = q.float().reshape(B, nkv, H // nkv, D) * scale
    s = torch.matmul(qg, k_cache.float().transpose(-1, -2))  # (B, nkv, g, S)
    pos = torch.arange(S, device=q.device)
    live = (pos[None, :] >= start[:, None]) & (pos[None, :] < ends[:, None])  # (B, S)
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v_cache.float()) / torch.where(l == 0, torch.ones_like(l), l)
    return out.reshape(B, H, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, start, end, *, block_kv=256, scale=None,
                     impl="kernel"):
    """One query per row over its cache window; see the module docstring.
    ``block_kv``: the cache-length granularity (S must be a multiple)."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    if impl == "plain" or not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, start, end, block_kv=block_kv,
                                      scale=scale)
    start, ends = _windows(q, k_cache, start, end, block_kv)
    B, H, D = q.shape
    nkv, S = k_cache.shape[1], k_cache.shape[2]
    g = H // nkv
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != torch.bfloat16 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"decode_attention kernel: {name} must be a contiguous bf16 tensor "
                             f"on {q.device}; got {t.dtype} on {t.device}, "
                             f"contiguous={t.is_contiguous()}")
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"v_cache {tuple(v_cache.shape)} != k_cache {tuple(k_cache.shape)}")
    if D not in (64, 128) or g > 8:
        raise ValueError(f"decode_attention kernel: needs head dim in (64, 128) and at most 8 "
                         f"query heads per kv head; got D={D}, g={g}")
    scale = scale if scale is not None else 1.0 / (D**0.5)
    out = torch.empty_like(q)
    lib = _kernel()
    rc = lib.decode_launch(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), start.data_ptr(),
                           ends.data_ptr(), out.data_ptr(), B, nkv, g, S, D, float(scale),
                           build.stream_of(q))
    build.check(lib, rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
