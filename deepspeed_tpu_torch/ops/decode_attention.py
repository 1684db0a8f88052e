"""Decode attention over a KV cache: the static engine's decode mode, the
continuous-batching scheduler's paged decode, paged span and int8-KV modes,
and their extent modes (long-context KV chains, lossy sliding windows).

Port of ``deepspeed_tpu/ops/pallas/decode_attention.py`` (the TPU kernels
``_decode_kernel`` in every mode of its ``_decode_call``, and
``_extent_kernel``). One CUDA source, ``ops/csrc/decode_attention.cu``,
templated on bf16 and int8 KV, carries every mode with one tile routine on
the tensor cores (flash-decoding on ``mma.sync``): a CTA takes 64 folded
rows (the span modes; a warp each 16) or 16 (the decode modes; four warps
splitting each tile's positions and columns) and one chunk of 512 logical
positions (aligned to 0), streams the
chunk's 64-position tiles through a ``cp.async`` ring, computes the scores
in bf16 with fp32 sums and P V with p split into bf16 high and low parts;
a row kept over several chunks is merged by a second launch in chunk
order. What bounds it: the bytes of the kept windows,
and at the chunk step (T = 64) the tensor-core work. The tile and chunk are
constants, a tile a row keeps nothing of is an exact no-op for it, and
positions no row of a CTA keeps are never read (zero-filled), so a row's
bits depend only on its own logical window: a span column computes bitwise
what the decode mode computes for the same window (the scheduler's results
do not depend on whether a token rode a chunk step or a decode step), a
row whose window runs through an extent chain computes bitwise what one
slot holding the same window computes, and an identity table what the
paged modes compute. The kernel's header gives the details.

- :func:`decode_attention`: q (B, H, D); row b attends the cache slots
  ``[start[b], end)``, ``end`` a scalar shared by every row (the static
  engine: ``cache_index + 1``) or a (B,) tensor of per-row ends.
- :func:`paged_decode_attention`: the scheduler's slot pool, per-row
  ``ends``; a dead slot (``ends == 0``) gets zeros.
- :func:`paged_span_attention`: q (B, H, T, D); column j of row b sits at
  cache position ``base[b] + j`` and attends ``[start[b], base[b] + j]``.
- :func:`extent_paged_decode_attention`, :func:`extent_paged_span_attention`:
  the same over a pool of extents, caches (Npool, kv_heads, S, D): an
  extent table ``ext`` (B, E) int32 puts row b's LOGICAL position p at pool
  row ``ext[b, p // S]``, offset ``p % S`` (-1: a dropped extent, which no
  kept position may lie in); ``start``/``ends``/``base`` are logical, up to
  E * S. Per-row ``sink``/``window`` (B,) int32: a row with ``window > 0``
  also skips the positions in ``[sink, end - window)``, ``end`` its column's
  own end (the lossy StreamingLLM window; ``window == 0`` is exact).

Caches are (B, kv_heads, S, D) (the extent modes: (Npool, ...)). With
``k_scale``/``v_scale`` ((B or Npool, 1, S, 1) fp16, from
:func:`deepspeed_tpu_torch.ops.quantizer.quantize_kv_rows`) the caches are
int8 and each row is dequantized as ``k * scale`` in fp32. The output is in
q's dtype; a row whose window is empty gets zeros. Cache positions that no
window of a call keeps are never read; positions some folded row of a
(row, kv head) keeps must hold finite values (written or zero-filled rows).

Where a logical window can pass 512 positions (E * S > 512), each call
allocates a workspace for the merge: ``(D + 2)`` fp32 values per folded row
and chunk, ``B * nkv * R * ceil(E * S / 512) * (D + 2)`` in all. It is sized
from shapes, never from ``ends`` (no host read), so it covers every chunk of
every folded row: about R / 512 of the bytes of the logical K and V windows
in bf16. In the span modes (R = g * T) that is the most: at llama3-8b's
long-context pool (16 rows, 8 kv heads, g = 4, T = 64, 8 extents of 1024)
272.6 MB a call, back in the caching allocator when it returns; in the decode modes
(R = g) it is g / 512 of the windows' bytes.

A CUDA tensor launches the kernel (or the call raises); a CPU tensor, or
``impl="plain"``, takes the plain version, which computes what the TPU
kernels' ``_decode_call``/``_extent_call`` compute: the (head-group,
column) fold with the column fastest, ``end + column`` per column, fp32
scores and softmax, ``l == 0 -> 1``; the extent modes gather each row's
logical window first.

The ``sharded_*`` wrappers (the JAX package's) take replicated operands,
run the same kernel on this rank's heads over a mesh axis (``tensor``) and
all-gather the heads: bitwise the unsharded call. The tensor-parallel model
does not need them (its pool already holds this rank's kv heads).
:func:`seq_sharded_span_attention` is the sequence-parallel prefill's: a
rank computes its share of a wide chunk's query columns against the whole
pool and the columns are all-gathered over ``seq``.
"""

import ctypes

import torch

from . import build

# the CUDA sources under ops/csrc this module launches
SOURCES = ("decode_attention", )
_libs = {}


def _bind(lib):
    lib.decode_launch.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
                                  + [ctypes.c_float, ctypes.c_void_p])
    lib.decode_launch.restype = ctypes.c_int
    lib.decode_workspace.argtypes = [ctypes.c_int] * 6
    lib.decode_workspace.restype = ctypes.c_longlong


def _lib():
    return build.bind(_libs, SOURCES[0], _bind)


def _rows(v, B, device):
    """A scalar or (B,) window bound as a contiguous (B,) int32 tensor. A
    Python scalar becomes a device fill, never a host-to-device copy, which
    would wait for the stream."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32).expand(B).contiguous()
    return torch.full((B, ), int(v), dtype=torch.int32, device=device)


def _check_cache(qg, k_cache, v_cache, block_kv, k_scale, v_scale):
    """Shapes of a folded query block (B, nkv, rows, D) against the caches."""
    B, nkv, _, D = qg.shape
    if k_cache.dim() != 4 or k_cache.shape[0] != B or k_cache.shape[1] != nkv \
            or k_cache.shape[3] != D or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches {tuple(k_cache.shape)}/{tuple(v_cache.shape)} do not match the "
                         f"queries' (B={B}, kv_heads={nkv}, D={D})")
    S = k_cache.shape[2]
    block_kv = min(block_kv, S)
    if S % block_kv:
        raise ValueError(f"cache length {S} must be a multiple of block_kv={block_kv}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale go together (int8 KV)")
    if k_scale is not None and (k_scale.shape != (B, 1, S, 1) or v_scale.shape != k_scale.shape):
        raise ValueError(f"int8 KV scales must be (B, 1, S, 1) = {(B, 1, S, 1)}; got "
                         f"{tuple(k_scale.shape)}, {tuple(v_scale.shape)}")


def _decode_call_plain(qg, k_cache, v_cache, start, ends, *, span=1, scale=None, k_scale=None,
                       v_scale=None, sink=None, win=None):
    """Plain PyTorch version of the TPU kernel's ``_decode_call``: ``qg``
    (B, nkv, g, D) folded queries (g = head-groups x span columns, column
    fastest); folded row r attends ``[start, ends + r % span)``, less
    ``[sink, ends + r % span - win)`` where ``win > 0`` (``_extent_call``'s
    lossy mask)."""
    B, nkv, g, D = qg.shape
    S = k_cache.shape[2]
    dev = qg.device
    scale = scale if scale is not None else 1.0 / (D**0.5)
    q = qg.float() * scale
    k, v = k_cache.float(), v_cache.float()
    if k_scale is not None:
        k = k * k_scale.float()
        v = v * v_scale.float()
    s = torch.matmul(q, k.transpose(-1, -2))  # (B, nkv, g, S)
    col = torch.arange(g, device=dev) % span
    end = ends[:, None] + col[None, :]  # (B, g)
    pos = torch.arange(S, device=dev)
    live = (pos >= start[:, None, None]) & (pos < end[:, :, None])  # (B, g, S)
    if win is not None:
        w = win[:, None, None]
        live &= (w == 0) | (pos < sink[:, None, None]) | (pos >= end[:, :, None] - w)
    s = s.masked_fill(~live[:, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v) / torch.where(l == 0, torch.ones_like(l), l)
    return out.to(qg.dtype)


def _group(q, nkv):
    if q.dim() != 3:
        raise ValueError(f"expected q (B, H, D); got {tuple(q.shape)}")
    B, H, D = q.shape
    if H % nkv:
        raise ValueError(f"{H} query heads do not split into {nkv} kv-head groups")
    return q.reshape(B, nkv, H // nkv, D)


def _fold_span(q, nkv):
    """(B, H, T, D) -> (B, nkv, g * T, D), the column fastest."""
    if q.dim() != 4:
        raise ValueError(f"expected q (B, H, T, D); got {tuple(q.shape)}")
    B, H, T, D = q.shape
    if H % nkv:
        raise ValueError(f"{H} query heads do not split into {nkv} kv-head groups")
    return q.reshape(B, nkv, (H // nkv) * T, D)


def _launch(what, qg, k_cache, v_cache, start, ends, k_scale, v_scale, scale, span, ext=None,
            sink=None, win=None):
    """Launch the kernel on the folded queries (B, nkv, R, D); folded row r
    attends ``[start, ends + r % span)`` (logical positions through ``ext``
    (B, E) when given, less the lossy hole of ``sink``/``win``)."""
    B, nkv, R, D = qg.shape
    quant = k_scale is not None
    kv_dtype = torch.int8 if quant else torch.bfloat16
    ops = [("q", qg, torch.bfloat16), ("k_cache", k_cache, kv_dtype), ("v_cache", v_cache, kv_dtype)]
    if quant:
        ops += [("k_scale", k_scale, torch.float16), ("v_scale", v_scale, torch.float16)]
    if ext is not None:
        ops += [("ext", ext, torch.int32)]
    if win is not None:
        ops += [("sink", sink, torch.int32), ("window", win, torch.int32)]
    for name, t, dt in ops:
        if t.dtype != dt or t.device != qg.device or not t.is_contiguous():
            raise ValueError(f"{what} kernel: {name} must be a contiguous {dt} tensor on "
                             f"{qg.device}; got {t.dtype} on {t.device}, "
                             f"contiguous={t.is_contiguous()}")
    if D not in (64, 128):
        raise ValueError(f"{what} kernel: needs head dim 64 or 128; got {D}")
    S = k_cache.shape[2]
    E = 1 if ext is None else ext.shape[1]
    scale = scale if scale is not None else 1.0 / (D**0.5)
    out = torch.empty_like(qg)
    lib = _lib()
    # the per-chunk partials of rows kept over several 512-position chunks
    n_ws = lib.decode_workspace(B, nkv, R, S, E, D)
    ws = torch.empty(n_ws, dtype=torch.float32, device=qg.device) if n_ws else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.decode_launch(ptr(qg), ptr(k_cache), ptr(v_cache), ptr(k_scale), ptr(v_scale),
                           ptr(start), ptr(ends), ptr(ext), ptr(sink), ptr(win), ptr(out), ptr(ws),
                           B, nkv, R, span, S, E, D, int(quant), float(scale),
                           build.stream_of(qg))
    build.check(lib, rc, what)
    return out


def _impl_ok(impl):
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")


# ---------------------------------------------------------------- decode mode


def decode_attention_plain(q, k_cache, v_cache, start, end, *, block_kv=256, scale=None):
    """Plain PyTorch version of :func:`decode_attention` (fp32 softmax)."""
    qg = _group(q, k_cache.shape[1])
    _check_cache(qg, k_cache, v_cache, block_kv, None, None)
    B = q.shape[0]
    out = _decode_call_plain(qg, k_cache, v_cache, _rows(start, B, q.device), _rows(end, B, q.device),
                             scale=scale)
    return out.reshape(q.shape)


def decode_attention(q, k_cache, v_cache, start, end, *, block_kv=256, scale=None,
                     impl="kernel"):
    """One query per row over its cache window ``[start, end)``; see the
    module docstring. ``block_kv``: the cache-length granularity (S must be
    a multiple). bf16 KV on the card."""
    _impl_ok(impl)
    if impl == "plain" or not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, start, end, block_kv=block_kv,
                                      scale=scale)
    qg = _group(q, k_cache.shape[1])
    _check_cache(qg, k_cache, v_cache, block_kv, None, None)
    B = q.shape[0]
    out = _launch("decode_attention", qg, k_cache, v_cache, _rows(start, B, q.device),
                  _rows(end, B, q.device), None, None, scale, 1)
    decode_attention.launches += 1
    return out.reshape(q.shape)


decode_attention.launches = 0

# ---------------------------------------------------------------- paged modes


def paged_decode_attention_plain(q, k_cache, v_cache, start, ends, *, block_kv=256, scale=None,
                                 k_scale=None, v_scale=None):
    """Plain PyTorch version of :func:`paged_decode_attention`."""
    qg = _group(q, k_cache.shape[1])
    _check_cache(qg, k_cache, v_cache, block_kv, k_scale, v_scale)
    B = q.shape[0]
    out = _decode_call_plain(qg, k_cache, v_cache, _rows(start, B, q.device),
                             _rows(ends, B, q.device), scale=scale, k_scale=k_scale,
                             v_scale=v_scale)
    return out.reshape(q.shape)


def paged_decode_attention(q, k_cache, v_cache, start, ends, *, block_kv=256, scale=None,
                           k_scale=None, v_scale=None, impl="kernel"):
    """Slot-pool decode: q (B, H, D), per-row ``ends`` (B,) one past each
    slot's last written position; a row with ``ends == 0`` (a dead slot)
    gets zeros. ``k_scale``/``v_scale``: (B, 1, S, 1) fp16 row scales of an
    int8 pool, dequantized inside the kernel. Returns (B, H, D)."""
    _impl_ok(impl)
    if impl == "plain" or not q.is_cuda:
        return paged_decode_attention_plain(q, k_cache, v_cache, start, ends, block_kv=block_kv,
                                            scale=scale, k_scale=k_scale, v_scale=v_scale)
    qg = _group(q, k_cache.shape[1])
    _check_cache(qg, k_cache, v_cache, block_kv, k_scale, v_scale)
    B = q.shape[0]
    out = _launch("decode_attention", qg, k_cache, v_cache, _rows(start, B, q.device),
                  _rows(ends, B, q.device), k_scale, v_scale, scale, 1)
    if k_scale is None:
        paged_decode_attention.launches += 1
    else:
        paged_decode_attention.launches_int8 += 1
    return out.reshape(q.shape)


paged_decode_attention.launches = 0  # bf16 KV
paged_decode_attention.launches_int8 = 0


def paged_span_attention_plain(q, k_cache, v_cache, start, base, *, block_kv=256, scale=None,
                               k_scale=None, v_scale=None):
    """Plain PyTorch version of :func:`paged_span_attention`."""
    qf = _fold_span(q, k_cache.shape[1])
    _check_cache(qf, k_cache, v_cache, block_kv, k_scale, v_scale)
    B, T = q.shape[0], q.shape[2]
    out = _decode_call_plain(qf, k_cache, v_cache, _rows(start, B, q.device),
                             _rows(base, B, q.device) + 1, span=T, scale=scale, k_scale=k_scale,
                             v_scale=v_scale)
    return out.reshape(q.shape)


def paged_span_attention(q, k_cache, v_cache, start, base, *, block_kv=256, scale=None,
                         k_scale=None, v_scale=None, impl="kernel"):
    """Per-row query spans (the fused chunked-prefill step): q (B, H, T, D);
    column j of row b sits at cache position ``base[b] + j`` and attends
    ``[start[b], base[b] + j]``, its own freshly written row included.
    Columns past a row's live span compute values the caller never reads.
    ``k_scale``/``v_scale`` as in :func:`paged_decode_attention`. Returns
    (B, H, T, D)."""
    _impl_ok(impl)
    if impl == "plain" or not q.is_cuda:
        return paged_span_attention_plain(q, k_cache, v_cache, start, base, block_kv=block_kv,
                                          scale=scale, k_scale=k_scale, v_scale=v_scale)
    qf = _fold_span(q, k_cache.shape[1])
    _check_cache(qf, k_cache, v_cache, block_kv, k_scale, v_scale)
    B, T = q.shape[0], q.shape[2]
    out = _launch("paged_span_attention", qf.contiguous(), k_cache, v_cache,
                  _rows(start, B, q.device), _rows(base, B, q.device) + 1, k_scale, v_scale, scale,
                  T)
    if k_scale is None:
        paged_span_attention.launches += 1
    else:
        paged_span_attention.launches_int8 += 1
    return out.reshape(q.shape)


paged_span_attention.launches = 0  # bf16 KV
paged_span_attention.launches_int8 = 0

# ---------------------------------------------------------------- extent modes


def _check_pool(qg, k_cache, v_cache, ext, block_kv, k_scale, v_scale):
    """Shapes of a folded query block (B, nkv, rows, D) against a pool of
    extents (Npool, nkv, S, D) and its (B, E) table."""
    B, nkv, _, D = qg.shape
    if k_cache.dim() != 4 or k_cache.shape[1] != nkv or k_cache.shape[3] != D \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"pool caches {tuple(k_cache.shape)}/{tuple(v_cache.shape)} do not match "
                         f"the queries' (kv_heads={nkv}, D={D})")
    if ext.dim() != 2 or ext.shape[0] != B or ext.shape[1] < 1:
        raise ValueError(f"extent table must be (B={B}, E >= 1); got {tuple(ext.shape)}")
    Np, S = k_cache.shape[0], k_cache.shape[2]
    block_kv = min(block_kv, S)
    if S % block_kv:
        raise ValueError(f"cache length {S} must be a multiple of block_kv={block_kv}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale go together (int8 KV)")
    if k_scale is not None and (k_scale.shape != (Np, 1, S, 1) or v_scale.shape != k_scale.shape):
        raise ValueError(f"int8 KV scales must be (Npool, 1, S, 1) = {(Np, 1, S, 1)}; got "
                         f"{tuple(k_scale.shape)}, {tuple(v_scale.shape)}")


def _logical(leaf, ext):
    """A pool leaf (Npool, h, S, d) read through the extent table (B, E):
    (B, h, E * S, d), row b's logical positions in order (a dropped extent
    reads pool row 0, masked out by its window)."""
    B, E = ext.shape
    _, h, S, d = leaf.shape
    return leaf[ext.clamp(min=0).long()].transpose(1, 2).reshape(B, h, E * S, d)


def _lossy(sink, window, B, device):
    """(sink, window) as (B,) int32 tensors, or (None, None) for the exact
    mask (the kernel then takes null pointers)."""
    if sink is None and window is None:
        return None, None
    return _rows(0 if sink is None else sink, B, device), _rows(0 if window is None else window, B,
                                                               device)


def _extent_plain(qf, k_cache, v_cache, start, ends, ext, span, scale, k_scale, v_scale, sink,
                  window):
    B = qf.shape[0]
    sk, wn = _lossy(sink, window, B, qf.device)
    return _decode_call_plain(qf, _logical(k_cache, ext), _logical(v_cache, ext),
                              _rows(start, B, qf.device), ends, span=span, scale=scale,
                              k_scale=None if k_scale is None else _logical(k_scale, ext),
                              v_scale=None if v_scale is None else _logical(v_scale, ext),
                              sink=sk, win=wn)


def extent_paged_decode_attention_plain(q, k_cache, v_cache, start, ends, ext, *, block_kv=256,
                                        scale=None, k_scale=None, v_scale=None, sink=None,
                                        window=None):
    """Plain PyTorch version of :func:`extent_paged_decode_attention`."""
    qg = _group(q, k_cache.shape[1])
    _check_pool(qg, k_cache, v_cache, ext, block_kv, k_scale, v_scale)
    out = _extent_plain(qg, k_cache, v_cache, start, _rows(ends, q.shape[0], q.device), ext, 1,
                        scale, k_scale, v_scale, sink, window)
    return out.reshape(q.shape)


def extent_paged_decode_attention(q, k_cache, v_cache, start, ends, ext, *, block_kv=256,
                                  scale=None, k_scale=None, v_scale=None, sink=None, window=None,
                                  impl="kernel"):
    """:func:`paged_decode_attention` over a pool of extents: q (B, H, D),
    caches (Npool, kv_heads, S, D), ``ext`` (B, E) int32, logical ``ends``
    (B,); ``sink``/``window`` (B,) the lossy window (None: exact). With an
    identity table (``ext[b] = [b]``) it computes bitwise what
    :func:`paged_decode_attention` computes. Returns (B, H, D)."""
    _impl_ok(impl)
    if impl == "plain" or not q.is_cuda:
        return extent_paged_decode_attention_plain(q, k_cache, v_cache, start, ends, ext,
                                                   block_kv=block_kv, scale=scale, k_scale=k_scale,
                                                   v_scale=v_scale, sink=sink, window=window)
    qg = _group(q, k_cache.shape[1])
    _check_pool(qg, k_cache, v_cache, ext, block_kv, k_scale, v_scale)
    B = q.shape[0]
    sk, wn = _lossy(sink, window, B, q.device)
    out = _launch("extent_paged_decode_attention", qg, k_cache, v_cache, _rows(start, B, q.device),
                  _rows(ends, B, q.device), k_scale, v_scale, scale, 1, ext=ext, sink=sk, win=wn)
    if k_scale is None:
        extent_paged_decode_attention.launches += 1
    else:
        extent_paged_decode_attention.launches_int8 += 1
    return out.reshape(q.shape)


extent_paged_decode_attention.launches = 0  # bf16 KV
extent_paged_decode_attention.launches_int8 = 0


def extent_paged_span_attention_plain(q, k_cache, v_cache, start, base, ext, *, block_kv=256,
                                      scale=None, k_scale=None, v_scale=None, sink=None,
                                      window=None):
    """Plain PyTorch version of :func:`extent_paged_span_attention`."""
    qf = _fold_span(q, k_cache.shape[1])
    _check_pool(qf, k_cache, v_cache, ext, block_kv, k_scale, v_scale)
    out = _extent_plain(qf, k_cache, v_cache, start, _rows(base, q.shape[0], q.device) + 1, ext,
                        q.shape[2], scale, k_scale, v_scale, sink, window)
    return out.reshape(q.shape)


def extent_paged_span_attention(q, k_cache, v_cache, start, base, ext, *, block_kv=256, scale=None,
                                k_scale=None, v_scale=None, sink=None, window=None, impl="kernel"):
    """:func:`paged_span_attention` over a pool of extents (the chunk step
    while a row's context spans extents): q (B, H, T, D), ``base`` (B,)
    logical write heads, the rest as in :func:`extent_paged_decode_attention`.
    Returns (B, H, T, D)."""
    _impl_ok(impl)
    if impl == "plain" or not q.is_cuda:
        return extent_paged_span_attention_plain(q, k_cache, v_cache, start, base, ext,
                                                 block_kv=block_kv, scale=scale, k_scale=k_scale,
                                                 v_scale=v_scale, sink=sink, window=window)
    qf = _fold_span(q, k_cache.shape[1])
    _check_pool(qf, k_cache, v_cache, ext, block_kv, k_scale, v_scale)
    B, T = q.shape[0], q.shape[2]
    sk, wn = _lossy(sink, window, B, q.device)
    out = _launch("extent_paged_span_attention", qf.contiguous(), k_cache, v_cache,
                  _rows(start, B, q.device), _rows(base, B, q.device) + 1, k_scale, v_scale, scale,
                  T, ext=ext, sink=sk, win=wn)
    if k_scale is None:
        extent_paged_span_attention.launches += 1
    else:
        extent_paged_span_attention.launches_int8 += 1
    return out.reshape(q.shape)


extent_paged_span_attention.launches = 0  # bf16 KV
extent_paged_span_attention.launches_int8 = 0


# ---------------------------------------------------------------------------
# tensor-parallel wrappers: this rank's heads, all-gathered


def _on_heads(fn, axis, q, k_cache, v_cache, *args, **kw):
    """``fn`` on this rank's slice of the head axis (dim 1) of ``q`` and the
    caches over the mesh axis ``axis``, its output's heads all-gathered in
    rank order; raises when a head count does not divide the degree."""
    from .. import comm as dist
    t, i = dist.get_world_size(axis), dist.get_rank(axis)
    for name, x in (("q", q), ("k/v cache", k_cache), ("k/v cache", v_cache)):
        if x.shape[1] % t:
            raise ValueError(f"{name} heads {x.shape[1]} do not divide the {axis} degree {t}")
    local = [x.narrow(1, i * (x.shape[1] // t), x.shape[1] // t).contiguous() for x in (q, k_cache, v_cache)]
    out = fn(*local, *args, **kw)
    return out if t == 1 else dist.all_gather(out.contiguous(), group=axis, axis=1)


def sharded_paged_decode_attention(q, k_cache, v_cache, start, ends, *, axis="tensor", **kw):
    """:func:`paged_decode_attention` over ``axis`` of the ``comm`` mesh (the
    JAX package's ``sharded_paged_decode_attention``): replicated operands,
    the kernel on this rank's q heads and kv heads (the int8 row scales
    stay whole), the heads all-gathered. Bitwise the unsharded call: heads
    are independent."""
    return _on_heads(paged_decode_attention, axis, q, k_cache, v_cache, start, ends, **kw)


def sharded_paged_span_attention(q, k_cache, v_cache, start, base, *, axis="tensor", **kw):
    """:func:`paged_span_attention` on this rank's heads, all-gathered (see
    :func:`sharded_paged_decode_attention`)."""
    return _on_heads(paged_span_attention, axis, q, k_cache, v_cache, start, base, **kw)


def sharded_extent_paged_decode_attention(q, k_cache, v_cache, start, ends, ext, *, axis="tensor", **kw):
    """:func:`extent_paged_decode_attention` on this rank's heads (the
    extent table and the lossy window whole), all-gathered."""
    return _on_heads(extent_paged_decode_attention, axis, q, k_cache, v_cache, start, ends, ext, **kw)


def sharded_extent_paged_span_attention(q, k_cache, v_cache, start, base, ext, *, axis="tensor", **kw):
    """:func:`extent_paged_span_attention` on this rank's heads,
    all-gathered."""
    return _on_heads(extent_paged_span_attention, axis, q, k_cache, v_cache, start, base, ext, **kw)


# ---------------------------------------------------------------------------
# the sequence-parallel prefill: this rank's query columns, all-gathered


def seq_sharded_span_attention(q, k_cache, v_cache, start, base, *, axis="seq", block_kv=256, scale=None,
                               k_scale=None, v_scale=None, ext=None, sink=None, window=None, impl="kernel"):
    """:func:`paged_span_attention` (or, with ``ext``, the extent walk of
    :func:`extent_paged_span_attention`, ``sink``/``window`` its lossy
    window) with the ``T`` query columns split over the mesh axis ``axis``
    (the JAX package's ``seq_sharded_span_attention``,
    ``ops/pallas/decode_attention.py:635``): rank s takes columns ``[s*Tl,
    (s+1)*Tl)``, ``Tl = T / n``, against the replicated pool, its base
    advanced by ``s*Tl``; the columns are all-gathered in rank order. A
    column's bits depend only on its own window, so the result is bitwise
    the one-rank call, column for column. A width the axis does not divide
    raises."""
    from .. import comm as dist
    n, s = dist.get_world_size(axis), dist.get_rank(axis)
    T = q.shape[2]
    if T % n:
        raise ValueError(f"span width {T} must divide by the {axis} axis size {n}")
    Tl = T // n
    qs = q.narrow(2, s * Tl, Tl)
    bs = _rows(base, q.shape[0], q.device) + s * Tl
    if ext is None:
        out = paged_span_attention(qs, k_cache, v_cache, start, bs, block_kv=block_kv, scale=scale,
                                   k_scale=k_scale, v_scale=v_scale, impl=impl)
    else:
        out = extent_paged_span_attention(qs, k_cache, v_cache, start, bs, ext, block_kv=block_kv,
                                          scale=scale, k_scale=k_scale, v_scale=v_scale, sink=sink,
                                          window=window, impl=impl)
    return out if n == 1 else dist.all_gather(out.contiguous(), group=axis, axis=2)
