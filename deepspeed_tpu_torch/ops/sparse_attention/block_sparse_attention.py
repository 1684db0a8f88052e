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
lists, so the work scales with the layout's active blocks. Inside a tile
the causal mask is ``kv_pos <= q_pos`` and key positions ``>= T`` are
masked (q/k/v may be shorter than ``nq * block``: the kernels mask the
tail, they do not pad). A query row whose every visited entry is masked
gets out 0 and lse -inf, and its gradients read lse 0, so it contributes
nothing.

q, k, v: (B, H, T, D), H the layout's heads (no GQA). A CUDA tensor
launches the kernels (bf16, D 64 or 128, block 16/32/64/128; anything
else raises); a CPU tensor, or ``impl="plain"``, takes the plain versions,
which walk the same tables in the same order with the TPU kernels'
arithmetic: fp32 online softmax, ``p`` rounded to the input dtype before
``p V`` with the row sums unrounded, ``ds`` rounded before ``ds K`` and
``ds^T Q``, ``p`` before ``p^T dO``, and ``delta = rowsum(dO O)`` in fp32.
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


def _kernel(name):
    lib = _lib.get(name)
    if lib is None:
        lib = build.load(name)
        if name == "block_sparse_attention_fwd":
            lib.block_sparse_fwd_launch.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                                                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            lib.block_sparse_fwd_launch.restype = ctypes.c_int
        else:
            lib.block_sparse_bwd_dq_launch.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                                                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            lib.block_sparse_bwd_dq_launch.restype = ctypes.c_int
            lib.block_sparse_bwd_dkv_launch.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                                                        + [ctypes.c_float, ctypes.c_int,
                                                           ctypes.c_void_p])
            lib.block_sparse_bwd_dkv_launch.restype = ctypes.c_int
        _lib[name] = lib
    return lib


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


# ---------------------------------------------------------------------------
# plain versions: the kernels' table walks, vectorised over (b, h, block)


def _blocks(x, n, block):
    """(B, H, T, D) -> (B, H, n, block, D) fp32, zero rows past T."""
    B, H, T, D = x.shape
    x = torch.nn.functional.pad(x.float(), (0, 0, 0, n * block - T))
    return x.view(B, H, n, block, D)


def _gather(xb, idx_j):
    """Blocks ``idx_j[h, i]`` of each head: (B, H, n, block, D)."""
    H = idx_j.shape[0]
    return xb[:, torch.arange(H, device=xb.device)[:, None], idx_j]


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


def block_sparse_attention_plain(q, k, v, q_idx, q_cnt, block, causal=True, scale=None):
    """Plain PyTorch version of the forward kernel: (out (B, H, T, D) in q's
    dtype, lse (B, H, T) fp32), contiguous as the kernel's, walking each q
    block's kv blocks in table order with the TPU kernel's online softmax."""
    _check_qkv(q, k, v)
    _check_tables("block_sparse_attention", q, q_idx, q_cnt, block)
    B, H, T, D = q.shape
    nq = q_idx.shape[1]
    sc = _scale(scale, D)
    q_idx, q_cnt = q_idx.long(), q_cnt.long()
    qb = _blocks(q, nq, block)
    nk = max(nq, int(q_idx.max()) + 1)
    kb, vb = _blocks(k, nk, block), _blocks(v, nk, block)
    qi = torch.arange(nq, device=q.device).expand(H, nq)
    m = torch.full((B, H, nq, block, 1), float("-inf"), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qb)
    for j in range(q_idx.shape[2]):
        kvb = q_idx[:, :, j]
        active = (j < q_cnt)[None, :, :, None, None]
        s = torch.matmul(qb, _gather(kb, kvb).transpose(-1, -2)) * sc
        keep = _tile_mask(qi, kvb, block, T, causal)
        s = torch.where(keep, s, torch.full_like(s, MASK_VALUE))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(keep, torch.exp(s - m_new), torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        pv = torch.matmul(p.to(v.dtype).float(), _gather(vb, kvb))
        m = torch.where(active, m_new, m)
        l = torch.where(active, l * alpha + p.sum(-1, keepdim=True), l)
        acc = torch.where(active, acc * alpha + pv, acc)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / l_safe).reshape(B, H, nq * block, D)[:, :, :T]
    lse = torch.where(l == 0, torch.full_like(l, float("-inf")), m + torch.log(l_safe))
    return out.to(q.dtype).contiguous(), lse.reshape(B, H, nq * block)[:, :, :T].contiguous()


def _lse_or_zero(lse):
    return torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))


def block_sparse_bwd_dq_plain(q, k, v, dout, lse, delta, q_idx, q_cnt, block, causal=True,
                              scale=None):
    """Plain PyTorch version of the dq kernel: over each q block's kv blocks
    in table order, ``ds = bf16(p (dO V^T - delta) scale)``, ``dq += ds K``."""
    B, H, T, D = q.shape
    nq = q_idx.shape[1]
    sc = _scale(scale, D)
    q_idx, q_cnt = q_idx.long(), q_cnt.long()
    qb, dob = _blocks(q, nq, block), _blocks(dout, nq, block)
    nk = max(nq, int(q_idx.max()) + 1)
    kb, vb = _blocks(k, nk, block), _blocks(v, nk, block)
    lse_b = _blocks(_lse_or_zero(lse)[..., None], nq, block)
    delta_b = _blocks(delta[..., None], nq, block)
    qi = torch.arange(nq, device=q.device).expand(H, nq)
    dq = torch.zeros_like(qb)
    for j in range(q_idx.shape[2]):
        kvb = q_idx[:, :, j]
        active = (j < q_cnt)[None, :, :, None, None]
        kg = _gather(kb, kvb)
        s = torch.matmul(qb, kg.transpose(-1, -2)) * sc
        keep = _tile_mask(qi, kvb, block, T, causal)
        p = torch.where(keep, torch.exp(s - lse_b), torch.zeros_like(s))
        dp = torch.matmul(dob, _gather(vb, kvb).transpose(-1, -2))
        ds = (p * (dp - delta_b) * sc).to(q.dtype).float()
        dq = torch.where(active, dq + torch.matmul(ds, kg), dq)
    return dq.reshape(B, H, nq * block, D)[:, :, :T].to(q.dtype).contiguous()


def block_sparse_bwd_dkv_plain(q, k, v, dout, lse, delta, kv_idx, kv_cnt, block, causal=True,
                               scale=None):
    """Plain PyTorch version of the dk/dv kernel: over each kv block's q
    blocks (the transposed table) in order, ``dv += bf16(p)^T dO`` and
    ``dk += ds^T Q``, query rows past T masked. Returns (dk, dv)."""
    B, H, T, D = q.shape
    nk = kv_idx.shape[1]
    sc = _scale(scale, D)
    kv_idx, kv_cnt = kv_idx.long(), kv_cnt.long()
    kb, vb = _blocks(k, nk, block), _blocks(v, nk, block)
    nq = max(nk, int(kv_idx.max()) + 1)
    qb, dob = _blocks(q, nq, block), _blocks(dout, nq, block)
    lse_b = _blocks(_lse_or_zero(lse)[..., None], nq, block)
    delta_b = _blocks(delta[..., None], nq, block)
    ki = torch.arange(nk, device=q.device).expand(H, nk)
    dk, dv = torch.zeros_like(kb), torch.zeros_like(vb)
    for n in range(kv_idx.shape[2]):
        qblk = kv_idx[:, :, n]
        active = (n < kv_cnt)[None, :, :, None, None]
        qg, dog = _gather(qb, qblk), _gather(dob, qblk)
        s = torch.matmul(qg, kb.transpose(-1, -2)) * sc  # (.., q rows, kv rows)
        keep = _tile_mask(qblk, ki, block, T, causal, rows_in_range=True)
        p = torch.where(keep, torch.exp(s - _gather(lse_b, qblk)), torch.zeros_like(s))
        dv = torch.where(active, dv + torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), dog),
                         dv)
        dp = torch.matmul(dog, vb.transpose(-1, -2))
        ds = (p * (dp - _gather(delta_b, qblk)) * sc).to(q.dtype).float()
        dk = torch.where(active, dk + torch.matmul(ds.transpose(-1, -2), qg), dk)
    crop = lambda x, like: x.reshape(B, H, nk * block, D)[:, :, :T].to(like.dtype).contiguous()
    return crop(dk, k), crop(dv, v)


def _delta(out, dout):
    """delta = rowsum(dO * O) in fp32, from the rounded output."""
    return (dout.float() * out.float()).sum(dim=-1)


def block_sparse_attention_bwd_plain(q, k, v, out, lse, dout, tables, block, causal=True,
                                     scale=None):
    """(dq, dk, dv) through the plain versions of both backward kernels;
    ``tables`` as :func:`_index_tables` returns them, as tensors."""
    q_idx, q_cnt, kv_idx, kv_cnt = tables
    delta = _delta(out, dout)
    dq = block_sparse_bwd_dq_plain(q, k, v, dout, lse, delta, q_idx, q_cnt, block, causal, scale)
    dk, dv = block_sparse_bwd_dkv_plain(q, k, v, dout, lse, delta, kv_idx, kv_cnt, block, causal,
                                        scale)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the kernels


def block_sparse_fwd(q, k, v, q_idx, q_cnt, block, causal=True, scale=None):
    """The forward kernel on CUDA tensors: (out, lse). Counts its launches."""
    _check_qkv(q, k, v)
    _check_kernel("block_sparse_fwd", q, q_idx, q_cnt, block, (("q", q), ("k", k), ("v", v)))
    B, H, T, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _kernel("block_sparse_attention_fwd")
    rc = lib.block_sparse_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_idx.data_ptr(),
                                     q_cnt.data_ptr(), out.data_ptr(), lse.data_ptr(), B, H, T, D,
                                     block, q_idx.shape[1], q_idx.shape[2],
                                     float(_scale(scale, D)), int(bool(causal)), build.stream_of(q))
    build.check(lib, rc, "block_sparse_fwd")
    block_sparse_fwd.launches += 1
    return out, lse


block_sparse_fwd.launches = 0


def block_sparse_bwd_dq(q, k, v, dout, lse, delta, q_idx, q_cnt, block, causal=True, scale=None):
    """The dq kernel on CUDA tensors. Counts its launches."""
    _check_qkv(q, k, v)
    _check_kernel("block_sparse_bwd_dq", q, q_idx, q_cnt, block,
                  (("q", q), ("k", k), ("v", v), ("dout", dout)), (("lse", lse), ("delta", delta)))
    B, H, T, D = q.shape
    dq = torch.empty_like(q)
    lib = _kernel("block_sparse_attention_bwd")
    rc = lib.block_sparse_bwd_dq_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                                        lse.data_ptr(), delta.data_ptr(), q_idx.data_ptr(),
                                        q_cnt.data_ptr(), dq.data_ptr(), B, H, T, D, block,
                                        q_idx.shape[1], q_idx.shape[2], float(_scale(scale, D)),
                                        int(bool(causal)), build.stream_of(q))
    build.check(lib, rc, "block_sparse_bwd_dq")
    block_sparse_bwd_dq.launches += 1
    return dq


block_sparse_bwd_dq.launches = 0


def block_sparse_bwd_dkv(q, k, v, dout, lse, delta, kv_idx, kv_cnt, block, causal=True,
                         scale=None):
    """The dk/dv kernel on CUDA tensors: (dk, dv). Counts its launches."""
    _check_qkv(q, k, v)
    _check_kernel("block_sparse_bwd_dkv", q, kv_idx, kv_cnt, block,
                  (("q", q), ("k", k), ("v", v), ("dout", dout)), (("lse", lse), ("delta", delta)))
    B, H, T, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _kernel("block_sparse_attention_bwd")
    rc = lib.block_sparse_bwd_dkv_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                                         lse.data_ptr(), delta.data_ptr(), kv_idx.data_ptr(),
                                         kv_cnt.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, T,
                                         D, block, kv_idx.shape[1], kv_idx.shape[2],
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
        if impl == "plain" or not q.is_cuda:
            out, lse = block_sparse_attention_plain(q, k, v, q_idx, q_cnt, attn.block, attn.causal,
                                                    attn.scale)
        else:
            q, k, v = (_aligned(t) for t in (q, k, v))
            out, lse = block_sparse_fwd(q, k, v, q_idx, q_cnt, attn.block, attn.causal, attn.scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attn, ctx.impl, ctx.tables = attn, impl, tables
        return out

    @staticmethod
    def backward(ctx, g_out):
        q, k, v, out, lse = ctx.saved_tensors
        attn = ctx.attn
        args = (attn.block, attn.causal, attn.scale)
        if ctx.impl == "plain" or not q.is_cuda:
            dq, dk, dv = block_sparse_attention_bwd_plain(q, k, v, out, lse, g_out, ctx.tables, *args)
        else:
            q_idx, q_cnt, kv_idx, kv_cnt = ctx.tables
            g_out = _aligned(g_out)
            delta = _delta(out, g_out)
            dq = block_sparse_bwd_dq(q, k, v, g_out, lse, delta, q_idx, q_cnt, *args)
            dk, dv = block_sparse_bwd_dkv(q, k, v, g_out, lse, delta, kv_idx, kv_cnt, *args)
        return dq, dk, dv, None, None


class BlockSparseAttention:
    """``fn(q, k, v) -> out`` over one static layout: the layout, its index
    tables (numpy, and int32 tensors cached per device) and the options."""

    def __init__(self, layout, block, causal=True, scale=None, impl="kernel"):
        layout = np.asarray(layout)
        if layout.ndim != 3:
            raise ValueError(f"layout must be (H, nq, nk), got {layout.shape}")
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        self.layout, self.block, self.causal, self.scale, self.impl = layout, block, causal, scale, impl
        self.np_tables = _index_tables(layout)
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
