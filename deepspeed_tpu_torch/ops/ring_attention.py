"""Ring attention: sequence parallelism with every rank at O(T / n).

Port of ``deepspeed_tpu/ops/pallas/ring_attention.py``. Each rank of the
``seq`` group holds one chunk of the sequence's Q, K and V; K/V chunks
rotate around the group (:func:`~deepspeed_tpu_torch.comm.ppermute_autograd`)
and each step's attention merges into a running (out, lse) pair, the online
softmax across ranks. Every step is one :func:`flash_attention_with_lse`
call: the flash kernels on CUDA tensors (non-causal and rectangular past
the diagonal step, with the lse cotangent of the merge folded into the
backward's delta), their plain versions on CPU tensors. Each step runs
under ``torch.utils.checkpoint``, so the backward recomputes it (the JAX
package's ``jax.checkpoint``) instead of keeping n steps' residuals.

Two causal schedules (``schedule=``):

- ``unbalanced``: at step s rank i holds rank (i - s) mod n's chunk; step 0
  is the causal diagonal, a later step a full block that only ranks
  i >= s keep (a wrapped chunk lies in the future: merged with lse -inf),
  so about half of the off-diagonal work is thrown away;
- ``zigzag`` (default): the sequence splits into 2n chunks and rank i holds
  chunks i and 2n-1-i (one early, one late), so every off-diagonal step is
  one useful half block: from a rank behind, all of Q against its early
  half; from a rank ahead, Q's late half against all of it. The relayout
  from contiguous chunks and back is half-chunk exchanges
  (:func:`_zigzag_relayout`).

Non-causal attention always takes the plain rotation (every block counts).
The carry stays fp32 and rounds once to the input dtype at the end.
"""

import functools

import torch
from torch.utils.checkpoint import checkpoint

from .. import comm as dist
from .flash_attention import flash_attention, flash_attention_with_lse

NEG_INF = float("-inf")


def _merge(o1, lse1, o2, lse2):
    """Combine two normalized attention results over disjoint K/V sets,
    in fp32; an lse of -inf means "attended nothing". Guarded so that no
    gradient is NaN."""
    m = torch.maximum(lse1, lse2)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    zero = torch.zeros_like(m)
    w1 = torch.where(torch.isfinite(lse1), torch.exp(torch.clamp(lse1 - m_safe, max=0.0)), zero)
    w2 = torch.where(torch.isfinite(lse2), torch.exp(torch.clamp(lse2 - m_safe, max=0.0)), zero)
    denom = w1 + w2
    denom_safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    out = (o1.float() * w1[..., None] + o2.float() * w2[..., None]) / denom_safe[..., None]
    lse = torch.where(denom == 0, torch.full_like(denom, NEG_INF), m_safe + torch.log(denom_safe))
    return out, lse


def _sees_past(idx, step):
    """Whether rank ``idx``'s K/V at ring step ``step`` came from a rank
    behind it (its chunk precedes this rank's), not wrapped from ahead."""
    return idx >= step


def _attend(q, k, v, causal, scale, impl):
    """One ring step: (out, lse) of ``q`` against ``k``/``v``, recomputed in
    the backward."""
    fn = functools.partial(flash_attention_with_lse, causal=causal, scale=scale, impl=impl)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return checkpoint(fn, q, k, v, use_reentrant=False)
    return fn(q, k, v)


def _ring(n):
    return [(i, (i + 1) % n) for i in range(n)]


def ring_attention_local(q, k, v, causal=True, scale=None, impl="kernel", group=dist.SEQ_AXIS):
    """The unbalanced rotation on this rank's chunk: q (B, H, Tc, D), k/v
    (B, Hkv, Tc, D) at global positions ``rank * Tc + t``. Returns (B, H,
    Tc, D)."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    o, lse = _attend(q, k, v, causal, scale, impl)
    out = o.float()
    kv = (k, v)
    for s in range(1, n):
        kv = tuple(dist.ppermute_autograd(x, _ring(n), group) for x in kv)
        o_s, lse_s = _attend(q, kv[0], kv[1], False, scale, impl)
        if causal and not _sees_past(idx, s):
            lse_s = torch.full_like(lse_s, NEG_INF)  # a wrapped (future) chunk
        out, lse = _merge(out, lse, o_s, lse_s)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# zig-zag


def _zigzag_mapping(n, inverse=False):
    """Half-chunk routes: ``mapping[dst_slot]`` lists ``(src_rank, src_slot,
    dst_rank)``. Forward: contiguous (rank s holds chunks 2s, 2s+1) to
    zig-zag (rank i holds chunks i, 2n-1-i); ``inverse`` the way back."""
    mapping = {0: [], 1: []}
    for i in range(n):
        for dst_slot, chunk in ((0, i), (1, 2 * n - 1 - i)):
            src_rank, src_slot = chunk // 2, chunk % 2
            if inverse:
                mapping[src_slot].append((i, dst_slot, src_rank))
            else:
                mapping[dst_slot].append((src_rank, src_slot, i))
    return mapping


def _permute_halves(halves, mapping, group):
    """Route the local half-chunks by ``mapping``: at most two exchanges a
    destination slot; a rank that is no route's destination receives
    zeros, so the sum of a slot's exchanges is each destination's half
    exactly once."""
    out = []
    for dst_slot in (0, 1):
        acc = None
        for src_slot in (0, 1):
            pairs = [(sr, dr) for sr, ss, dr in mapping[dst_slot] if ss == src_slot]
            if pairs:
                moved = dist.ppermute_autograd(halves[src_slot], pairs, group)
                acc = moved if acc is None else acc + moved
        out.append(acc)
    return out


def _zigzag_relayout(x, group, n, inverse=False):
    """(B, H, 2c, D) local chunk pair -> the re-routed pair."""
    c = x.shape[2] // 2
    h0, h1 = _permute_halves((x[:, :, :c], x[:, :, c:]), _zigzag_mapping(n, inverse), group)
    return torch.cat([h0, h1], dim=2)


def zigzag_ring_attention_local(q, k, v, scale=None, impl="kernel", group=dist.SEQ_AXIS):
    """The zig-zag schedule on this rank's chunk pair (chunks i and 2n-1-i
    of the 2n-chunk causal sequence). Every position of the early chunk
    precedes every position of the late one, so the diagonal step is one
    causal call on the pair."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    B, H, T2, D = q.shape
    c = T2 // 2
    o, lse = _attend(q, k, v, True, scale, impl)
    out = o.float()
    kv = (k, v)
    for s in range(1, n):
        kv = tuple(dist.ppermute_autograd(x, _ring(n), group) for x in kv)
        if _sees_past(idx, s):
            # from a rank behind: its early chunk precedes both local
            # chunks, its late chunk follows both
            o_s, lse_s = _attend(q, kv[0][:, :, :c], kv[1][:, :, :c], False, scale, impl)
            o_s = o_s.float()
        else:
            # from a rank ahead: both its chunks lie between the local
            # early and late chunks; the early half attends nothing
            o_h, lse_h = _attend(q[:, :, c:], kv[0], kv[1], False, scale, impl)
            o_s = torch.cat([torch.zeros((B, H, c, D), dtype=torch.float32, device=q.device),
                             o_h.float()], dim=2)
            lse_s = torch.cat([torch.full((B, H, c), NEG_INF, dtype=lse_h.dtype, device=q.device),
                               lse_h], dim=2)
        out, lse = _merge(out, lse, o_s, lse_s)
    return out.to(q.dtype)


def ring_attention(q, k, v, causal=True, scale=None, schedule="zigzag", impl="kernel",
                   group=dist.SEQ_AXIS):
    """Attention over a sequence split across ``group``: q (B, H, Tc, D),
    k/v (B, Hkv, Tc, D) are this rank's contiguous chunk (global positions
    ``rank * Tc + t``; H a multiple of Hkv, GQA-native); returns this
    rank's (B, H, Tc, D). ``schedule``: ``'zigzag'`` (balanced causal, the
    default; needs an even Tc) or ``'unbalanced'``. A group of one is one
    flash call."""
    if schedule not in ("zigzag", "unbalanced"):
        raise ValueError(f"schedule must be 'zigzag' or 'unbalanced', got {schedule!r}")
    n = dist.get_world_size(group)
    if n == 1:
        return flash_attention(q, k, v, causal, scale, impl)
    if schedule == "zigzag" and causal and q.shape[2] % 2 == 0:
        qz, kz, vz = (_zigzag_relayout(x, group, n) for x in (q, k, v))
        out = zigzag_ring_attention_local(qz, kz, vz, scale, impl, group)
        return _zigzag_relayout(out, group, n, inverse=True)
    return ring_attention_local(q, k, v, causal, scale, impl, group)
