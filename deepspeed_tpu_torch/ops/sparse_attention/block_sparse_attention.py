"""Block-sparse flash attention, forward and backward.

Port of ``deepspeed_tpu/ops/sparse_attention/block_sparse_attention.py``
(the TPU kernels ``_fwd_kernel``, ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``; entry point ``make_block_sparse_attention``). The CUDA
kernels are ``ops/csrc/block_sparse_attention_fwd.cu`` and
``ops/csrc/block_sparse_attention_bwd.cu``; their headers say what bounds
them on the H100 and how their designs answer that.

A static ``(H, nq, nk)`` 0/1 layout of ``block`` x ``block`` tiles decides
which key blocks each query block reads. :func:`_index_tables` turns it
into per-(head, q-block) lists of active kv blocks in ascending order (for
the forward and dq) and the transposed per-(head, kv-block) lists of the q
blocks that read it (for dk/dv), with their counts; the kernels walk those
lists, so the work scales with the layout's active blocks. All three
kernels take those walks as the items of a :class:`WorkPlan` (the forward
and dq the q table's, dk/dv the transposed table's): a walk
longer than the block size's chunk (``CHUNK``) is cut at fixed table
positions, its pieces run on separate CTAs, and the last piece to finish
merges their partials in piece order. Inside a tile
the causal mask is ``kv_pos <= q_pos`` and key positions ``>= T`` are
masked (q/k/v may be shorter than ``nq * block``: the kernels mask the
tail, they do not pad). A query row whose every visited entry is masked
gets out 0 and lse -inf, and its gradients read lse 0, so it contributes
nothing.

q, k, v: (B, H, T, D), H the layout's heads (no GQA). A CUDA tensor
launches the kernels (bf16, D 64 or 128, block 16/32/64/128; anything
else raises); a CPU tensor, or ``impl="plain"``, takes the plain versions,
which walk the same plan's pieces in the same order and merge them as the
kernels do, with the TPU kernels' arithmetic: fp32 online softmax, ``p``
rounded to the input dtype before ``p V`` with the row sums unrounded,
``ds`` rounded before ``ds K`` and ``ds^T Q``, ``p`` before ``p^T dO``, and
``delta = rowsum(dO O)`` in fp32.
"""

import ctypes

import numpy as np
import torch

from .. import build
from ..flash_attention import _aligned, _check_aligned, _check_kernel_operands, _scale

# the TPU kernels' finite mask value: exp(s - m) of a masked score never
# makes a NaN, and masked probabilities are zeroed explicitly
MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
BLOCKS = (16, 32, 64, 128)

# the CUDA sources under ops/csrc this module launches
SOURCES = ("block_sparse_attention_fwd", "block_sparse_attention_bwd")
_lib = {}


def _bind(name, lib):
    if name == "block_sparse_attention_fwd":
        lib.block_sparse_fwd_launch.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                                                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.block_sparse_fwd_launch.restype = ctypes.c_int
    else:
        lib.block_sparse_bwd_dq_launch.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
                                                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.block_sparse_bwd_dq_launch.restype = ctypes.c_int
        lib.block_sparse_bwd_dkv_launch.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
                                                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.block_sparse_bwd_dkv_launch.restype = ctypes.c_int


def _kernel(name):
    return build.bind(_lib, name, lambda lib: _bind(name, lib))


def _index_tables(layout):
    """(H, nq, nk) 0/1 -> per-row and per-column active index tables.

    Returns (q_idx (H,nq,K), q_cnt (H,nq), kv_idx (H,nk,Kt), kv_cnt (H,nk)),
    int32 numpy arrays, each list in ascending order; padding entries repeat
    index 0 but are never visited (count-bounded loops)."""
    H, nq, nk = layout.shape
    q_cnt = layout.sum(-1).astype(np.int32)
    kv_cnt = layout.sum(-2).astype(np.int32)
    K = max(1, int(q_cnt.max()))
    Kt = max(1, int(kv_cnt.max()))
    q_idx = np.zeros((H, nq, K), np.int32)
    kv_idx = np.zeros((H, nk, Kt), np.int32)
    for h in range(H):
        for i in range(nq):
            act = np.nonzero(layout[h, i])[0]
            q_idx[h, i, :len(act)] = act
        for j in range(nk):
            act = np.nonzero(layout[h, :, j])[0]
            kv_idx[h, j, :len(act)] = act
    return q_idx, q_cnt, kv_idx, kv_cnt


# table positions a work item walks at most, per block size: a walk longer
# than this is cut into pieces on separate CTAs. The layouts SparsityConfig
# makes walk a median of 3-10 blocks and their global rows and columns up to
# every block, so the longest item stays a few times the median walk while
# only the long walks pay for a piece's start and the merge (measured on the
# H100: PERF.md); a tile costs block^2 * D, so block 128 cuts shorter.
CHUNK = {16: 32, 32: 32, 64: 32, 128: 16}


class WorkPlan:
    """A kernel's work items over one index table (the forward's and dq's
    over the q table, dk/dv's over the transposed table), built
    on the host from the table's counts alone: it depends on the layout and
    the chunk length, never on the batch, the device or timing.

    A walk of ``cnt[h, r]`` positions longer than ``chunk`` is cut at the
    fixed table positions 0, chunk, 2 * chunk, ...; such a row is *split*,
    each piece writes fp32 partials, and the last piece to finish merges
    them in piece order. ``chunk=None`` gives one piece a row (the unsplit
    walk). A row of count 0 is one item of length 0 (it writes zeros).

    ``items`` (n, 4) int32: (h * rows + r, first position, length, split id
    or -1), longest first, ties in (h, r, position) order; ``splits``
    (n_split, 2) int32: (index of the row's first partial, its pieces);
    ``n_partials``: the pieces of the split rows."""

    def __init__(self, cnt, chunk=None):
        cnt = np.asarray(cnt, dtype=np.int64)
        self.shape = cnt.shape
        flat = cnt.reshape(-1)
        self.chunk = int(max(1, flat.max(initial=0)) if chunk is None else chunk)
        n_pieces = np.maximum(1, -(-flat // self.chunk))
        row = np.repeat(np.arange(flat.size), n_pieces)
        start = (np.arange(row.size) - np.repeat(np.cumsum(n_pieces) - n_pieces, n_pieces)) * self.chunk
        length = np.minimum(self.chunk, flat[row] - start)
        split_rows = np.nonzero(n_pieces > 1)[0]
        split_id = np.full(flat.size, -1, np.int64)
        split_id[split_rows] = np.arange(split_rows.size)
        self.splits = np.stack([np.cumsum(n_pieces[split_rows]) - n_pieces[split_rows],
                                n_pieces[split_rows]], 1).astype(np.int32).reshape(-1, 2)
        order = np.argsort(-length, kind="stable")
        self.items = np.stack([row, start, length, split_id[row]], 1)[order].astype(np.int32)
        self.n_partials = int(n_pieces[split_rows].sum())
        self._dev, self._flags = {}, {}

    def on(self, device):
        """(items, splits) as int32 tensors on ``device``, cached."""
        device = torch.device(device)
        t = self._dev.get(device)
        if t is None:
            t = self._dev[device] = (torch.from_numpy(self.items).to(device),
                                     torch.from_numpy(self.splits).to(device))
        return t

    def flags(self, device, B):
        """One zeroed int32 arrival count a (split row, batch entry) on
        ``device``; the kernels leave them zeroed (one call at a time on a
        device uses them)."""
        device = torch.device(device)
        n = max(1, len(self.splits) * B)
        buf = self._flags.get(device)
        if buf is None or buf.numel() < n:
            buf = self._flags[device] = torch.zeros(n, dtype=torch.int32, device=device)
        return buf

    def workspace_floats(self, B, block, row_floats):
        """fp32 values of the split rows' partials: ``row_floats`` a row of
        every piece of a split row, for each batch entry. Sized by the split
        rows alone, not by T or the heads."""
        return self.n_partials * B * block * row_floats


def _check_qkv(q, k, v):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v of one shape (B, H, T, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def _check_tables(what, q, idx, cnt, block):
    """The tables fit q: (H, n, K) and (H, n) int32, n * block >= T."""
    B, H, T, D = q.shape
    if idx.dim() != 3 or idx.shape[0] != H or tuple(cnt.shape) != tuple(idx.shape[:2]):
        raise ValueError(f"{what}: tables {tuple(idx.shape)}, {tuple(cnt.shape)} do not fit "
                         f"{H} heads")
    if T > idx.shape[1] * block:
        raise ValueError(f"{what}: sequence {T} exceeds layout capacity {idx.shape[1] * block}")


def _check_kernel(what, q, idx, cnt, block, bf16, fp32=()):
    _check_kernel_operands(what, bf16=bf16, fp32=fp32, like=q)
    if block not in BLOCKS:
        raise ValueError(f"{what} kernel: block {block} not in {BLOCKS}")
    for name, t in (("index table", idx), ("count table", cnt)):
        if t.dtype != torch.int32 or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what} kernel: the {name} must be a contiguous int32 tensor on "
                             f"{q.device}; got {t.dtype} on {t.device}")
    _check_tables(what, q, idx, cnt, block)
    _check_aligned(what, **dict(bf16))


def _plan_for(what, plan, cnt, chunk=None):
    """``plan``, or the plan of ``cnt`` cut at ``chunk`` (a copy to the
    host); it must fit the table."""
    if plan is None:
        plan = WorkPlan(cnt.cpu().numpy(), chunk)
    if tuple(plan.shape) != tuple(cnt.shape):
        raise ValueError(f"{what}: a plan of {tuple(plan.shape)} rows does not fit the table's "
                         f"{tuple(cnt.shape)}")
    return plan


# ---------------------------------------------------------------------------
# plain versions: the kernels' table walks, vectorised over (b, item, block)


def _blocks(x, n, block):
    """(B, H, T, D) -> (B, H, n, block, D) fp32, zero rows past T."""
    B, H, T, D = x.shape
    x = torch.nn.functional.pad(x.float(), (0, 0, 0, n * block - T))
    return x.view(B, H, n, block, D)


def _tile_mask(row_blk, col_blk, block, T, causal, rows_in_range=False):
    """(H, n, block, block) keep-mask of tiles (row block, col block): key
    positions < T, ``kv <= q`` when causal, query positions < T if asked."""
    r = torch.arange(block, device=row_blk.device)
    q_pos = (row_blk * block)[..., None, None] + r[:, None]
    kv_pos = (col_blk * block)[..., None, None] + r[None, :]
    keep = kv_pos < T
    if rows_in_range:
        keep = keep & (q_pos < T)
    if causal:
        keep = keep & (kv_pos <= q_pos)
    return keep


def _pieces(plan, device):
    """The plan's items as long tensors: (row, first position, length, piece)."""
    it = torch.from_numpy(plan.items).to(device).long()
    return it[:, 0], it[:, 1], it[:, 2], it[:, 1] // plan.chunk


def _sum_pieces(x, rows, piece, n):
    """Each row's pieces of ``x`` (B, items, block, D) summed from zero in
    piece order, as the backward kernels' last piece sums the partials:
    (B, n, block, D) fp32. A row of one piece gets that piece exactly."""
    out = torch.zeros((x.shape[0], n, *x.shape[2:]), device=x.device)
    for pc in range(int(piece.max()) + 1 if rows.numel() else 0):
        sel = piece == pc
        r = rows[sel]
        out[:, r] = out[:, r] + x[:, sel]
    return out


def _merge_softmax(M, L, A, m, l, acc):
    """The merged (max, sum, unnormalized out) of a row after one more piece
    (m, l, acc); a piece that saw nothing (l = 0) changes nothing. From
    (-inf, 0, 0) one piece gives itself exactly, so a one-piece plan is the
    unsplit walk bit for bit."""
    keep = l > 0
    m_new = torch.where(keep, torch.maximum(M, m), M)
    a = torch.where(keep, torch.exp(M - m_new), torch.ones_like(M))
    b = torch.where(keep, torch.exp(m - m_new), torch.zeros_like(m))
    return m_new, torch.where(keep, L * a + l * b, L), torch.where(keep, A * a + acc * b, A)


def block_sparse_attention_plain(q, k, v, q_idx, q_cnt, block, causal=True, scale=None, plan=None):
    """Plain PyTorch version of the forward kernel: (out (B, H, T, D) in q's
    dtype, lse (B, H, T) fp32), contiguous as the kernel's. Each item of
    ``plan`` (a :class:`WorkPlan` of the q table; None: one piece a q block)
    walks its table positions in order with the TPU kernel's online
    softmax; a split row's pieces are merged in piece order, as the kernel
    merges them."""
    _check_qkv(q, k, v)
    _check_tables("block_sparse_attention", q, q_idx, q_cnt, block)
    plan = _plan_for("block_sparse_attention", plan, q_cnt)
    B, H, T, D = q.shape
    nq, K = q_idx.shape[1], q_idx.shape[2]
    sc = _scale(scale, D)
    q_idx = q_idx.long()
    rows, start, length, piece = _pieces(plan, q.device)
    h, qi = rows // nq, rows % nq
    qb = _blocks(q, nq, block)[:, h, qi]  # (B, items, block, D)
    nk = max(nq, int(q_idx.max()) + 1)
    kb, vb = _blocks(k, nk, block), _blocks(v, nk, block)
    m = torch.full((B, rows.numel(), block, 1), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qb)
    for j in range(int(length.max()) if rows.numel() else 0):
        kvb = q_idx[h, qi, (start + j).clamp(max=K - 1)]
        active = (j < length)[None, :, None, None]
        s = torch.matmul(qb, kb[:, h, kvb].transpose(-1, -2)) * sc
        keep = _tile_mask(qi, kvb, block, T, causal)
        s = torch.where(keep, s, torch.full_like(s, MASK_VALUE))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(keep, torch.exp(s - m_new), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        pv = torch.matmul(p.to(v.dtype).float(), vb[:, h, kvb])
        m = torch.where(active, m_new, m)
        l = torch.where(active, l * alpha + p.sum(-1, keepdim=True), l)
        acc = torch.where(active, acc * alpha + pv, acc)
    M = torch.full((B, H * nq, block, 1), float("-inf"), device=q.device)
    L = torch.zeros_like(M)
    A = torch.zeros((B, H * nq, block, D), device=q.device)
    for pc in range(int(piece.max()) + 1 if rows.numel() else 0):  # pieces in order
        sel = piece == pc
        r = rows[sel]
        M[:, r], L[:, r], A[:, r] = _merge_softmax(M[:, r], L[:, r], A[:, r], m[:, sel], l[:, sel],
                                                   acc[:, sel])
    l_safe = torch.where(L == 0, torch.ones_like(L), L)
    out = (A / l_safe).reshape(B, H, nq * block, D)[:, :, :T]
    lse = torch.where(L == 0, torch.full_like(L, float("-inf")), M + torch.log(l_safe))
    return out.to(q.dtype).contiguous(), lse.reshape(B, H, nq * block)[:, :, :T].contiguous()


def _lse_or_zero(lse):
    return torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))


def block_sparse_bwd_dq_plain(q, k, v, dout, lse, delta, q_idx, q_cnt, block, causal=True,
                              scale=None, plan=None):
    """Plain PyTorch version of the dq kernel: each item of ``plan`` (a
    :class:`WorkPlan` of the q table, the forward's; None: one piece a q
    block) walks its kv blocks in order, ``ds = bf16(p (dO V^T - delta)
    scale)``, ``dq += ds K`` from zero; a split row's pieces are summed in
    piece order, as the kernel sums them."""
    plan = _plan_for("block_sparse_bwd_dq", plan, q_cnt)
    B, H, T, D = q.shape
    nq, K = q_idx.shape[1], q_idx.shape[2]
    sc = _scale(scale, D)
    q_idx = q_idx.long()
    rows, start, length, piece = _pieces(plan, q.device)
    h, qi = rows // nq, rows % nq
    qb, dob = _blocks(q, nq, block)[:, h, qi], _blocks(dout, nq, block)[:, h, qi]  # (B, items, block, D)
    lse_b = _blocks(_lse_or_zero(lse)[..., None], nq, block)[:, h, qi]
    delta_b = _blocks(delta[..., None], nq, block)[:, h, qi]
    nk = max(nq, int(q_idx.max()) + 1)
    kb, vb = _blocks(k, nk, block), _blocks(v, nk, block)
    dq = torch.zeros_like(qb)
    for j in range(int(length.max()) if rows.numel() else 0):
        kvb = q_idx[h, qi, (start + j).clamp(max=K - 1)]
        active = (j < length)[None, :, None, None]
        kg = kb[:, h, kvb]
        s = torch.matmul(qb, kg.transpose(-1, -2)) * sc
        keep = _tile_mask(qi, kvb, block, T, causal)
        p = torch.where(keep, torch.exp(s - lse_b), torch.zeros_like(s))
        dp = torch.matmul(dob, vb[:, h, kvb].transpose(-1, -2))
        ds = (p * (dp - delta_b) * sc).to(q.dtype).float()
        dq = torch.where(active, dq + torch.matmul(ds, kg), dq)
    DQ = _sum_pieces(dq, rows, piece, H * nq)
    return DQ.reshape(B, H, nq * block, D)[:, :, :T].to(q.dtype).contiguous()


def block_sparse_bwd_dkv_plain(q, k, v, dout, lse, delta, kv_idx, kv_cnt, block, causal=True,
                               scale=None, plan=None):
    """Plain PyTorch version of the dk/dv kernel: each item of ``plan`` (a
    :class:`WorkPlan` of the transposed table; None: one piece a kv block)
    walks its q blocks in order, ``dv += bf16(p)^T dO`` and
    ``dk += ds^T Q``, query rows past T masked; a split column's pieces are
    summed in piece order, as the kernel sums them. Returns (dk, dv)."""
    plan = _plan_for("block_sparse_bwd_dkv", plan, kv_cnt)
    B, H, T, D = q.shape
    nk, Kt = kv_idx.shape[1], kv_idx.shape[2]
    sc = _scale(scale, D)
    kv_idx = kv_idx.long()
    rows, start, length, piece = _pieces(plan, q.device)
    h, ki = rows // nk, rows % nk
    kb, vb = _blocks(k, nk, block)[:, h, ki], _blocks(v, nk, block)[:, h, ki]  # (B, items, block, D)
    nq = max(nk, int(kv_idx.max()) + 1)
    qb, dob = _blocks(q, nq, block), _blocks(dout, nq, block)
    lse_b = _blocks(_lse_or_zero(lse)[..., None], nq, block)
    delta_b = _blocks(delta[..., None], nq, block)
    dk, dv = torch.zeros_like(kb), torch.zeros_like(vb)
    for n in range(int(length.max()) if rows.numel() else 0):
        qblk = kv_idx[h, ki, (start + n).clamp(max=Kt - 1)]
        active = (n < length)[None, :, None, None]
        qg, dog = qb[:, h, qblk], dob[:, h, qblk]
        s = torch.matmul(qg, kb.transpose(-1, -2)) * sc  # (.., q rows, kv rows)
        keep = _tile_mask(qblk, ki, block, T, causal, rows_in_range=True)
        p = torch.where(keep, torch.exp(s - lse_b[:, h, qblk]), torch.zeros_like(s))
        dv = torch.where(active, dv + torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), dog),
                         dv)
        dp = torch.matmul(dog, vb.transpose(-1, -2))
        ds = (p * (dp - delta_b[:, h, qblk]) * sc).to(q.dtype).float()
        dk = torch.where(active, dk + torch.matmul(ds.transpose(-1, -2), qg), dk)
    DK, DV = (_sum_pieces(x, rows, piece, H * nk) for x in (dk, dv))
    crop = lambda x, like: x.reshape(B, H, nk * block, D)[:, :, :T].to(like.dtype).contiguous()
    return crop(DK, k), crop(DV, v)


def _delta(out, dout):
    """delta = rowsum(dO * O) in fp32, from the rounded output."""
    return (dout.float() * out.float()).sum(dim=-1)


def block_sparse_attention_bwd_plain(q, k, v, out, lse, dout, tables, block, causal=True,
                                     scale=None, dq_plan=None, dkv_plan=None):
    """(dq, dk, dv) through the plain versions of both backward kernels;
    ``tables`` as :func:`_index_tables` returns them, as tensors;
    ``dq_plan`` the q table's :class:`WorkPlan` (the forward's),
    ``dkv_plan`` the transposed table's."""
    q_idx, q_cnt, kv_idx, kv_cnt = tables
    delta = _delta(out, dout)
    dq = block_sparse_bwd_dq_plain(q, k, v, dout, lse, delta, q_idx, q_cnt, block, causal, scale,
                                   dq_plan)
    dk, dv = block_sparse_bwd_dkv_plain(q, k, v, dout, lse, delta, kv_idx, kv_cnt, block, causal,
                                        scale, dkv_plan)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the kernels


def block_sparse_fwd(q, k, v, q_idx, q_cnt, block, causal=True, scale=None, plan=None):
    """The forward kernel on CUDA tensors: (out, lse). Counts its launches.
    ``plan``: the q table's :class:`WorkPlan` (``BlockSparseAttention.plans``
    caches it); None builds the default one from ``q_cnt``, a copy to the
    host. A split row's partials take a workspace of
    ``plan.workspace_floats(B, block, D + 2)`` fp32 values."""
    _check_qkv(q, k, v)
    _check_kernel("block_sparse_fwd", q, q_idx, q_cnt, block, (("q", q), ("k", k), ("v", v)))
    plan = _plan_for("block_sparse_fwd", plan, q_cnt, CHUNK[block])
    B, H, T, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    items, splits = plan.on(q.device)
    flags = plan.flags(q.device, B)
    n_ws = plan.workspace_floats(B, block, D + 2)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device) if n_ws else None
    lib = _kernel("block_sparse_attention_fwd")
    rc = lib.block_sparse_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_idx.data_ptr(),
                                     items.data_ptr(), splits.data_ptr(), flags.data_ptr(),
                                     ws.data_ptr() if ws is not None else None, out.data_ptr(),
                                     lse.data_ptr(), B, H, T, D, block, q_idx.shape[1],
                                     q_idx.shape[2], len(plan.items), plan.chunk,
                                     float(_scale(scale, D)), int(bool(causal)), build.stream_of(q))
    build.check(lib, rc, "block_sparse_fwd")
    block_sparse_fwd.launches += 1
    return out, lse


block_sparse_fwd.launches = 0


def block_sparse_bwd_dq(q, k, v, dout, lse, delta, q_idx, q_cnt, block, causal=True, scale=None,
                        plan=None):
    """The dq kernel on CUDA tensors. Counts its launches. ``plan``: the q
    table's :class:`WorkPlan`, the forward's (``BlockSparseAttention.plans[0]``);
    None builds the default one from ``q_cnt``, a copy to the host. A split
    row's partials take ``plan.workspace_floats(B, block, D)`` fp32 values."""
    _check_qkv(q, k, v)
    _check_kernel("block_sparse_bwd_dq", q, q_idx, q_cnt, block,
                  (("q", q), ("k", k), ("v", v), ("dout", dout)), (("lse", lse), ("delta", delta)))
    plan = _plan_for("block_sparse_bwd_dq", plan, q_cnt, CHUNK[block])
    B, H, T, D = q.shape
    dq = torch.empty_like(q)
    items, splits = plan.on(q.device)
    flags = plan.flags(q.device, B)
    n_ws = plan.workspace_floats(B, block, D)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device) if n_ws else None
    lib = _kernel("block_sparse_attention_bwd")
    rc = lib.block_sparse_bwd_dq_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                                        lse.data_ptr(), delta.data_ptr(), q_idx.data_ptr(),
                                        items.data_ptr(), splits.data_ptr(), flags.data_ptr(),
                                        ws.data_ptr() if ws is not None else None, dq.data_ptr(), B, H,
                                        T, D, block, q_idx.shape[1], q_idx.shape[2], len(plan.items),
                                        plan.chunk, float(_scale(scale, D)), int(bool(causal)),
                                        build.stream_of(q))
    build.check(lib, rc, "block_sparse_bwd_dq")
    block_sparse_bwd_dq.launches += 1
    return dq


block_sparse_bwd_dq.launches = 0


def block_sparse_bwd_dkv(q, k, v, dout, lse, delta, kv_idx, kv_cnt, block, causal=True,
                         scale=None, plan=None):
    """The dk/dv kernel on CUDA tensors: (dk, dv). Counts its launches.
    ``plan``: the transposed table's :class:`WorkPlan`, as for the forward;
    a split column's partials take ``plan.workspace_floats(B, block, 2 * D)``
    fp32 values."""
    _check_qkv(q, k, v)
    _check_kernel("block_sparse_bwd_dkv", q, kv_idx, kv_cnt, block,
                  (("q", q), ("k", k), ("v", v), ("dout", dout)), (("lse", lse), ("delta", delta)))
    plan = _plan_for("block_sparse_bwd_dkv", plan, kv_cnt, CHUNK[block])
    B, H, T, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    items, splits = plan.on(q.device)
    flags = plan.flags(q.device, B)
    n_ws = plan.workspace_floats(B, block, 2 * D)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device) if n_ws else None
    lib = _kernel("block_sparse_attention_bwd")
    rc = lib.block_sparse_bwd_dkv_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                                         lse.data_ptr(), delta.data_ptr(), kv_idx.data_ptr(),
                                         items.data_ptr(), splits.data_ptr(), flags.data_ptr(),
                                         ws.data_ptr() if ws is not None else None, dk.data_ptr(),
                                         dv.data_ptr(), B, H, T, D, block, kv_idx.shape[1],
                                         kv_idx.shape[2], len(plan.items), plan.chunk,
                                         float(_scale(scale, D)), int(bool(causal)),
                                         build.stream_of(q))
    build.check(lib, rc, "block_sparse_bwd_dkv")
    block_sparse_bwd_dkv.launches += 1
    return dk, dv


block_sparse_bwd_dkv.launches = 0


class BlockSparseAttentionFunction(torch.autograd.Function):
    """out = block-sparse attention(q, k, v) over ``attn``'s layout,
    differentiable in q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, attn, impl):
        q_idx, q_cnt, kv_idx, kv_cnt = tables = attn.tables(q.device)
        fwd_plan = attn.plans[0]
        if impl == "plain" or not q.is_cuda:
            out, lse = block_sparse_attention_plain(q, k, v, q_idx, q_cnt, attn.block, attn.causal,
                                                    attn.scale, fwd_plan)
        else:
            q, k, v = (_aligned(t) for t in (q, k, v))
            out, lse = block_sparse_fwd(q, k, v, q_idx, q_cnt, attn.block, attn.causal, attn.scale,
                                        fwd_plan)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attn, ctx.impl, ctx.tables = attn, impl, tables
        return out

    @staticmethod
    def backward(ctx, g_out):
        q, k, v, out, lse = ctx.saved_tensors
        attn = ctx.attn
        args = (attn.block, attn.causal, attn.scale)
        dq_plan, dkv_plan = attn.plans
        if ctx.impl == "plain" or not q.is_cuda:
            dq, dk, dv = block_sparse_attention_bwd_plain(q, k, v, out, lse, g_out, ctx.tables, *args,
                                                          dq_plan, dkv_plan)
        else:
            q_idx, q_cnt, kv_idx, kv_cnt = ctx.tables
            g_out = _aligned(g_out)
            delta = _delta(out, g_out)
            dq = block_sparse_bwd_dq(q, k, v, g_out, lse, delta, q_idx, q_cnt, *args, dq_plan)
            dk, dv = block_sparse_bwd_dkv(q, k, v, g_out, lse, delta, kv_idx, kv_cnt, *args,
                                          dkv_plan)
        return dq, dk, dv, None, None


class BlockSparseAttention:
    """``fn(q, k, v) -> out`` over one static layout: the layout, its index
    tables (numpy, and int32 tensors cached per device), the work plans
    over them (``plans``: the q table's, for the forward and dq, and the
    transposed table's, for dk/dv; chunked by ``CHUNK[block]``) and the
    options."""

    def __init__(self, layout, block, causal=True, scale=None, impl="kernel"):
        layout = np.asarray(layout)
        if layout.ndim != 3:
            raise ValueError(f"layout must be (H, nq, nk), got {layout.shape}")
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        self.layout, self.block, self.causal, self.scale, self.impl = layout, block, causal, scale, impl
        self.np_tables = _index_tables(layout)
        chunk = CHUNK.get(block)
        self.plans = (WorkPlan(self.np_tables[1], chunk), WorkPlan(self.np_tables[3], chunk))
        self._tables = {}

    def tables(self, device):
        """(q_idx, q_cnt, kv_idx, kv_cnt) as int32 tensors on ``device``."""
        device = torch.device(device)
        t = self._tables.get(device)
        if t is None:
            t = tuple(torch.from_numpy(a).to(device) for a in self.np_tables)
            self._tables[device] = t
        return t

    def __call__(self, q, k, v):
        _check_qkv(q, k, v)
        H, nq, nk = self.layout.shape
        if q.shape[1] != H:
            raise ValueError(f"layout built for {H} heads, got {q.shape[1]}")
        cap = min(nq, nk) * self.block
        if q.shape[2] > cap:
            raise ValueError(f"sequence {q.shape[2]} exceeds layout capacity {cap}")
        return BlockSparseAttentionFunction.apply(q, k, v, self, self.impl)


def make_block_sparse_attention(layout, block, causal=True, scale=None, impl="kernel"):
    """Build an attention fn specialized to a static block ``layout``.

    ``layout``: numpy (H, nq_blocks, nkv_blocks) 0/1. Returns
    ``fn(q, k, v) -> out`` for q/k/v of shape (B, H, T, D) with
    T <= nq_blocks*block (the kernels mask the tail). Differentiable
    (:class:`BlockSparseAttentionFunction`: the dq and the dk/dv kernels)."""
    return BlockSparseAttention(layout, block, causal, scale, impl)
