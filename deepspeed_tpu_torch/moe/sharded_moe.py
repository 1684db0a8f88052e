"""MoE gating and dispatch math.

Port of ``deepspeed_tpu/moe/sharded_moe.py`` (reference
``deepspeed/moe/sharded_moe.py``: ``_capacity`` :157, ``top1gating`` :179,
``top2gating`` :277, ``_AllToAll`` :90, which is
:class:`deepspeed_tpu_torch.comm.AllToAll` here).

The JAX package gates the whole global batch as one program: a token's
capacity slot, and whether it is dropped, is a ``cumsum`` over the global
token order, and the capacity comes from the global token count. Across
ranks :func:`top_k_gating` keeps that: given the token group (the ranks
that hold the global batch, in its row order), each rank's slots are
offset by the routed counts of the ranks before it, the capacity and the
aux loss's means are global, and ``me``'s sum over the group carries a
gradient. Per-rank gating, as the reference does it, would differ from
the JAX package as soon as a token is dropped.
"""

import torch
import torch.nn.functional as F

from .. import comm as dist


def capacity(num_tokens, num_experts, capacity_factor, min_capacity=4):
    """Tokens per expert (reference ``_capacity``, sharded_moe.py:157)."""
    cap = int(num_tokens * capacity_factor / num_experts)
    return max(cap, min_capacity)


def _top_k_masks(logits, k):
    """The k rounds of iterative argmax: (N, E) fp32 one-hot masks, ties
    to the lowest expert index (``torch.argmax`` returns the first)."""
    E = logits.shape[-1]
    masked = logits.float()
    masks = []
    for _ in range(k):
        m = F.one_hot(torch.argmax(masked, dim=-1), E).float()
        masks.append(m)
        masked = torch.where(m > 0, torch.full_like(masked, float("-inf")), masked)
    return masks


def top_k_gating(logits, k, capacity_factor, min_capacity=4, group=None, rows=None):
    """Top-k gating with per-expert capacity over the global batch.

    ``logits``: (N, E) router logits of this rank's tokens. ``group``: the
    token group (axis names of the mesh, e.g. ``("expert", "data")``; None
    or a group of one for a single program). With ``seq`` last in
    ``group`` and ``rows`` (this rank's batch rows: N = rows x Tc) the
    tokens are a chunk of each row's sequence, and a slot goes by the
    global token order (row-major over the whole sequence, as JAX
    flattens it). Returns ``dispatch`` (N, E, C) one-hot, ``combine`` (N,
    E, C) weights, the load-balancing ``aux_loss`` (reference l_aux,
    sharded_moe.py:217) and ``drop_frac``, the fraction of routed slots
    dropped, both global."""
    N, E = logits.shape
    R = dist.get_world_size(group) if group is not None else 1
    axes = () if group is None else ((group, ) if isinstance(group, str) else tuple(group))
    sp = dist.get_world_size(dist.SEQ_AXIS) if dist.SEQ_AXIS in axes else 1
    n_global = N * R
    C = capacity(n_global * k, E, capacity_factor, min_capacity)
    probs = torch.softmax(logits.float(), dim=-1)
    masks = _top_k_masks(logits, k)

    # aux loss from the top-1 assignment, global means
    me = dist.all_reduce_autograd(probs.sum(0), group) / n_global if R > 1 else probs.mean(0)
    ce = (dist.all_reduce(masks[0].sum(0), group=group) / n_global) if R > 1 else masks[0].mean(0)
    aux_loss = torch.sum(me * ce) * E

    # per round, the counts of every rank before this one (the global
    # order is the group's rank order) and of all ranks
    counts = torch.stack([m.sum(0) for m in masks]).to(torch.int64)  # (k, E)
    if sp > 1:
        if axes[-1] != dist.SEQ_AXIS or rows is None:
            raise ValueError("gating over seq needs seq last in the group and this rank's rows")
        before, total = _seq_before(masks, rows, group, sp)
    elif R > 1:
        every = dist.all_gather(counts[None], group=group)  # (R, k, E)
        before = every[:dist.get_rank(group)].sum(0)
        total = every.sum(0)
    else:
        before, total = torch.zeros_like(counts), counts

    dispatch = torch.zeros((N, E, C), dtype=torch.float32, device=logits.device)
    combine = torch.zeros_like(dispatch)
    prior = torch.zeros((E, ), dtype=torch.int64, device=logits.device)
    kept = torch.zeros((), dtype=torch.float32, device=logits.device)
    for j, m in enumerate(masks):
        if sp > 1:  # within each row's chunk, after every earlier token of the global order
            pos = (torch.cumsum(m.to(torch.int64).reshape(rows, N // rows, E), dim=1) - 1
                   + (prior[None, :] + before[j])[:, None, :]).reshape(N, E)
        else:
            pos = torch.cumsum(m.to(torch.int64), dim=0) - 1 + (prior + before[j])[None, :]  # (N, E)
        keep = (pos < C) & (m > 0)
        kept = kept + keep.sum()
        loc = torch.where(keep, pos, torch.zeros_like(pos))
        oh = F.one_hot((loc * m.to(torch.int64)).sum(-1), C).float()  # (N, C)
        d = (m * keep)[:, :, None] * oh[:, None, :]
        gate_p = torch.sum(probs * m, dim=-1, keepdim=True)  # (N, 1)
        dispatch = dispatch + d
        combine = combine + d * gate_p[:, :, None]
        prior = prior + total[j]

    # renormalize over the selected experts (top-2 norm, reference :303)
    if k > 1:
        denom = torch.sum(combine, dim=(1, 2), keepdim=True)
        combine = combine / torch.clamp(denom, min=1e-9)

    if R > 1:
        kept = dist.all_reduce(kept, group=group)
    drop_frac = 1.0 - kept / (n_global * k)
    return dispatch, combine, aux_loss, drop_frac


def _seq_before(masks, rows, group, sp):
    """(before (k, rows, E), total (k, E)) when the group's tokens are
    chunks of sequences: ``before[j, b, e]`` counts the round-j picks of
    expert e by every token ahead of row b's chunk here in the global
    order (every row of the earlier data ranks; the earlier rows of this
    data rank, whole; row b's earlier chunks), ``total`` every pick."""
    k, E = len(masks), masks[0].shape[1]
    per_row = torch.stack([m.reshape(rows, -1, E).sum(1) for m in masks]).to(torch.int64)  # (k, rows, E)
    every = dist.all_gather(per_row[None], group=group)  # (R, k, rows, E), seq fastest
    every = every.reshape(-1, sp, k, rows, E)
    me = dist.get_rank(group)
    d, s = me // sp, me % sp
    earlier_ranks = every[:d].sum(dim=(0, 1, 3))  # (k, E)
    mine = every[d].sum(0)  # this data rank's rows over the whole sequence, (k, rows, E)
    earlier_rows = torch.cumsum(mine, dim=1) - mine
    earlier_chunks = every[d, :s].sum(0)
    return earlier_ranks[:, None, :] + earlier_rows + earlier_chunks, every.sum(dim=(0, 1, 3))


def top_k_serving_weights(logits, k):
    """Per-token combine weights for serving: the training gate's top-k
    selection, each selected expert weighted by its probability
    renormalized over the k, no capacity and nothing dropped, so every
    token's row is a function of its own logits alone (slot- and
    batch-independent). Returns (N, E) fp32 weights, zero outside each
    token's top-k."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights = torch.zeros_like(probs)
    for m in _top_k_masks(logits, k):
        weights = weights + m * probs
    if k > 1:
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights
