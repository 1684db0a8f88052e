"""Decoder-only transformer family, in PyTorch.

Port of ``deepspeed_tpu/models/transformer.py`` for serving and training:
one configurable causal LM covering the GPT-2/OPT shape (learned positions,
LayerNorm, gelu/relu) and the llama shape (RoPE, RMSNorm, SwiGLU, GQA),
with int8 weights through the hand-written quant-matmul kernel and the
flash attention (forward and backward) and decode attention kernels
(``ops/``). :meth:`CausalLMModel.loss` is the training loss: next-token
cross entropy, through :func:`chunked_cross_entropy` at real vocab sizes.

Layers are always unrolled (``nn.ModuleList``), the form the JAX engine's
``kernel_inject`` forces; the KV cache is per-layer ``(B, kv_heads, S,
head_dim)`` tensors written in place. Weights live in a flat state dict
whose keys mirror the JAX tree (``layers.{i}.attn.q_proj.kernel``, ...) with
every kernel in matmul layout (K, N); ``models/convert.py`` carries a JAX
tree across. Modules are built on the meta device and receive their tensors
through :meth:`CausalLMModel.bind` (or ``torch.func.functional_call``).
:meth:`CausalLMModel.fused_decode_operands` hands the same int8 tensors to
the fused decode-layer kernels (``ops/decode_block.py``).

The continuous-batching scheduler's slot pool (``inference/scheduler.py``)
drives the same forward with per-row ``write_index`` and ``q_spans``: each
row writes its query columns at its own cache position (columns past its
span are dropped) and attends through the paged decode and span modes of
the decode-attention kernels; a 3-leaf cache (k int8, v int8, fp16 row
scales) is the int8 KV tier, quantized on write. With ``ext_ops`` (long
context) positions are LOGICAL: each row writes into the pool row of its
write extent and attends through the extent modes of the same kernel.
:meth:`CausalLMModel.fused_paged_step` is the same step through the fused
decode-layer kernels.

Training runs the JAX model's remat policies (:func:`resolve_remat_policy`:
each ``Block`` under non-reentrant ``torch.utils.checkpoint``, a named
policy mapped to a selective-checkpoint ``context_fn``) and its two
residual dropouts a block, their masks drawn from a counter hash of
(seed, step, micro-step, layer, site, element) so a recomputed block draws
the same mask (:func:`dropout_mask`).

A model with ``num_experts > 0`` (Mixtral) replaces each block's MLP by the
routed experts of ``moe/layer.py``: training runs the capacity-buffered
dispatch and adds ``moe_aux_loss_coef`` times the layers' load-balancing
losses to the loss; the cached (serving) forward routes each token on its
own, capacity-free, and can return the per-layer routed-token counts
(``apply_with_cache(..., expert_stats=True)``). Expert weights are
(E, H, F)/(E, F, H) under ``layers.{i}.moe.experts.``, int8 per expert
after ``quantize_params``; ``moe_local_experts`` holds a rank's slice of
them under expert parallelism.

Tensor parallelism (``cfg.tp_shard``, set by :func:`tp_shard_config`;
:func:`tp_shard_params` cuts a rank's shard of a whole state dict by
:meth:`CausalLMModel.tp_rules`): a rank runs its q/k/v heads, its up/gate
columns and its vocab rows (the embedding takes each token's row from the
rank that holds it, a select). In the serving layout (``bitwise_tp``, the
JAX model's) the attention heads and the MLP activation are all-gathered
before the whole o_proj and down_proj and the logits before they are read:
every transfer a concatenation, so tp > 1 is bitwise tp 1. In training
o_proj and down_proj are row-parallel, summed over ``tensor`` before the
bias, and the loss is :func:`vocab_parallel_cross_entropy`; the region
operators of ``comm`` carry the gradients.

Sequence parallelism (``cfg.seq_shard``, set by :func:`seq_shard_config`):
a training forward holds this rank's contiguous chunk of the sequence, its
positions (learned ``pos_embed``, RoPE) and dropout masks those of the
chunk's global rows, and attention runs over the ``seq`` axis of ``comm``:
Ulysses (an all-to-all from sequence- to head-sharded q/k/v and back;
k/v gathered over ``seq`` when the kv heads do not divide it; the sequence
gathered when the heads do not) or ring attention (``ops/ring_attention.py``,
on the flash path only, with the JAX model's once-only warning and fallback
elsewhere). ``apply_with_cache(..., seq_shard=True)`` is the scheduler's
sequence-parallel prefill: the span kernel's query columns split over
``seq`` (``ops/decode_attention.py::seq_sharded_span_attention``).

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP item:
LoRA, alibi, local attention windows, cold-expert paging and activation
fake-quantization.
"""

import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
                                    noop_context_fn)

from .. import comm as dist
from ..ops.decode_attention import (decode_attention, extent_paged_decode_attention,
                                    extent_paged_span_attention, paged_decode_attention,
                                    paged_span_attention)
from ..ops.decode_attention import seq_sharded_span_attention
from ..ops.flash_attention import flash_attention
from ..ops.quant_matmul import quant_matmul
from ..ops.ring_attention import ring_attention
from ..ops.quantizer import dequantize_kv_rows, quantize_kv_rows
from ..utils.counter_hash import GOLDEN, fold_in, mix32, mulmod32
from ..utils.logging import warning_once


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    intermediate_size: Optional[int] = None  # default 4x (or 8/3 x for swiglu)
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: Optional[int] = None  # GQA; None = MHA
    head_dim: Optional[int] = None
    max_seq_len: int = 1024
    # family switches
    pos_embedding: str = "rope"  # "rope" | "learned" | "none" | "alibi"
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    activation: str = "swiglu"  # "swiglu" | "gelu" (tanh) | "gelu_exact" (erf) | "relu" | "geglu"
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    rotary_dim: Optional[int] = None  # partial rotary (GPT-J/NeoX); None = full head
    parallel_residual: bool = False  # x + attn(n1(x)) + mlp(n2(x)) (GPT-J/NeoX)
    embed_norm: bool = False  # layernorm right after the embedding (BLOOM)
    lm_head_bias: bool = False  # untied lm_head with bias (GPT-J)
    attn_bias: Optional[bool] = None  # None = follow norm (layernorm -> biased); GPT-J: False
    act_quant_bits: Optional[int] = None
    act_quant_symmetric: bool = True
    attn_scale: Optional[float] = None  # None = 1/sqrt(head_size)
    local_attention_window: int = 0
    local_attention_layers: Tuple[int, ...] = ()
    layernorm_epsilon: float = 1e-5
    dropout: float = 0.0
    # MoE (0 experts = dense)
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01
    moe_expert_bias: bool = False
    # this rank's experts under expert parallelism, (first, count); None =
    # all of them (moe/layer.py:shard_config sets it)
    moe_local_experts: Optional[Tuple[int, int]] = None
    # this rank's shard over the ``tensor`` axis, (index, degree); None =
    # whole (tp_shard_config sets it). The head, ffn and vocab counts stay
    # the model's; ``local_*`` are the rank's.
    tp_shard: Optional[Tuple[int, int]] = None
    # this rank's chunk of the sequence over the ``seq`` axis, (index,
    # degree); None = the whole sequence (seq_shard_config sets it)
    seq_shard: Optional[Tuple[int, int]] = None
    # systems
    dtype: Any = torch.bfloat16
    scan_layers: bool = True
    remat_policy: Optional[str] = None
    ce_chunk_size: Optional[int] = None
    attention_impl: str = "xla"  # "xla" (plain torch) | "flash" (the kernels)
    sequence_parallel_impl: str = "ulysses"  # "ulysses" | "ring"
    ring_schedule: str = "zigzag"  # ring attention's causal schedule: "zigzag" | "unbalanced"
    attention_block_q: int = 512
    attention_block_kv: int = 512
    decode_block_kv: int = 256  # cache-length granularity of the decode kernel
    # int8 weight serving: projections read int8 weights + per-group scales
    # through the quant-matmul kernel; params come from quantize_params
    int8_weights: bool = False
    int8_group_size: int = 0  # 0 = 128 where it divides the contraction, else one group
    int8_fused_qkv: bool = False  # one [q;k;v] int8 matmul (tp=1 serving)
    bitwise_tp: bool = False

    def __post_init__(self):
        if self.attention_impl not in ("xla", "flash"):
            raise ValueError(f"attention_impl must be 'xla' or 'flash', got {self.attention_impl!r}")
        if self.pos_embedding not in ("rope", "learned", "none", "alibi"):
            raise ValueError(f"pos_embedding must be 'rope'/'learned'/'none'/'alibi', "
                             f"got {self.pos_embedding!r}")
        if self.sequence_parallel_impl not in ("ulysses", "ring"):
            raise ValueError(f"sequence_parallel_impl must be 'ulysses' or 'ring', "
                             f"got {self.sequence_parallel_impl!r}")
        if self.sequence_parallel_impl == "ring" and self.attention_impl != "flash":
            raise ValueError("sequence_parallel_impl='ring' requires attention_impl='flash'")
        if self.ring_schedule not in ("zigzag", "unbalanced"):
            raise ValueError(f"ring_schedule must be 'zigzag' or 'unbalanced', got {self.ring_schedule!r}")
        if self.local_attention_layers and self.scan_layers:
            raise ValueError("local_attention_layers (per-layer windows) requires "
                             "scan_layers=False — scanned layers share one program")
        if self.tp_size > 1:
            t = self.tp_size
            if self.num_heads % t or self.kv_heads % t or self.ffn_size % t:
                raise ValueError(f"tensor degree {t} must divide num_heads={self.num_heads}, "
                                 f"kv_heads={self.kv_heads} and ffn_size={self.ffn_size}")
            if self.int8_fused_qkv:
                raise ValueError("int8_fused_qkv concatenates [q;k;v] on one column axis, which a "
                                 "tensor shard would split across component boundaries")
            if self.int8_weights and (padded_vocab(self) // t) % 4:
                raise ValueError(f"the int8 head's shard of {padded_vocab(self)}/{t} columns must be a "
                                 f"multiple of 4 (the quant-matmul kernel's)")

    @property
    def kv_heads(self):
        return self.num_kv_heads or self.num_heads

    @property
    def tp_size(self):
        return self.tp_shard[1] if self.tp_shard else 1

    @property
    def tp_index(self):
        return self.tp_shard[0] if self.tp_shard else 0

    @property
    def seq_size(self):
        return self.seq_shard[1] if self.seq_shard else 1

    @property
    def seq_index(self):
        return self.seq_shard[0] if self.seq_shard else 0

    @property
    def local_heads(self):
        return self.num_heads // self.tp_size

    @property
    def local_kv_heads(self):
        return self.kv_heads // self.tp_size

    @property
    def local_ffn(self):
        return self.ffn_size // self.tp_size

    @property
    def tp_vocab(self):
        """Whether the embedding and a float head split the vocab over
        ``tensor`` (a vocab the degree does not divide stays whole, as the
        JAX planner relaxes it)."""
        return self.tp_size > 1 and self.vocab_size % self.tp_size == 0

    @property
    def tp_mode(self):
        """How o_proj and down_proj (and an expert's down_proj) meet the
        tensor shards: None at tp 1; ``"reduce"``: they split their
        contraction and the partial outputs sum over ``tensor`` (training);
        ``"gather"``: under ``bitwise_tp`` they stay whole and read
        all-gathered activations (serving)."""
        if self.tp_size == 1:
            return None
        return "gather" if self.bitwise_tp else "reduce"

    @property
    def head_size(self):
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def ffn_size(self):
        if self.intermediate_size is not None:
            return self.intermediate_size
        if self.activation in ("swiglu", "geglu"):
            # llama convention: 8/3 * hidden rounded to multiple of 256
            d = int(8 * self.hidden_size / 3)
            return (d + 255) // 256 * 256
        return 4 * self.hidden_size

    def num_params(self):
        """Approximate parameter count (for MFU math)."""
        h, v, L = self.hidden_size, self.vocab_size, self.num_layers
        attn = h * self.head_size * (self.num_heads + 2 * self.kv_heads) + self.num_heads * self.head_size * h
        if self.activation in ("swiglu", "geglu"):
            mlp = 3 * h * self.ffn_size
        else:
            mlp = 2 * h * self.ffn_size
        if self.num_experts > 0:
            mlp *= self.num_experts
        emb = v * h * (1 if self.tie_embeddings else 2)
        pos = self.max_seq_len * h if self.pos_embedding == "learned" else 0
        return L * (attn + mlp + 2 * h) + emb + pos + h


def _unported(what, item):
    return NotImplementedError(f"deepspeed_tpu_torch does not support {what} yet ({item})")


def _check_supported(cfg):
    if cfg.pos_embedding == "alibi":
        raise _unported("alibi positions", "ROADMAP Queue 1 #10, module_inject policies")
    if cfg.local_attention_layers:
        raise _unported("local attention windows", "ROADMAP Queue 1 #10, module_inject policies")
    if cfg.act_quant_bits:
        raise _unported("activation fake-quantization", "ROADMAP Queue 1 #10, compression")


# ---------------------------------------------------------------------------
# chunked cross entropy


def _ce_logits(xc, w, transpose):
    """(B, chunk, V) fp32 logits of one chunk, the matmul in xc's dtype."""
    wc = w.to(xc.dtype)
    return torch.matmul(xc, wc.T if transpose else wc).float()


class _ChunkedCE(torch.autograd.Function):
    """Sum of next-token CE over valid positions, chunked over time. The
    backward rebuilds each chunk's logits and emits d(hidden) and d(w) from
    softmax(p) - onehot, so live memory is one (B, chunk, V) block either
    way (``_chunked_ce_fwd``/``_chunked_ce_bwd`` of the JAX package)."""

    @staticmethod
    def forward(ctx, hidden, w, labels, valid, chunk, transpose):
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c0 in range(0, hidden.shape[1], chunk):
            logits = _ce_logits(hidden[:, c0:c0 + chunk], w, transpose)
            lse = torch.logsumexp(logits, dim=-1)
            corr = torch.gather(logits, -1, labels[:, c0:c0 + chunk, None])[..., 0]
            total = total + ((lse - corr) * valid[:, c0:c0 + chunk]).sum()
        ctx.save_for_backward(hidden, w, labels, valid)
        ctx.chunk, ctx.transpose = chunk, transpose
        return total

    @staticmethod
    def backward(ctx, g):
        hidden, w, labels, valid = ctx.saved_tensors
        chunk, transpose = ctx.chunk, ctx.transpose
        wc = w.to(hidden.dtype)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dx = []
        for c0 in range(0, hidden.shape[1], chunk):
            xc = hidden[:, c0:c0 + chunk]
            dlogit = torch.softmax(_ce_logits(xc, w, transpose), dim=-1)
            dlogit.scatter_add_(-1, labels[:, c0:c0 + chunk, None],
                                torch.full_like(dlogit[..., :1], -1.0))
            dlogit = (dlogit * (valid[:, c0:c0 + chunk] * g)[..., None]).to(xc.dtype)
            if transpose:  # w (V, H)
                dx.append(torch.matmul(dlogit, wc))
                dw += torch.matmul(dlogit.flatten(0, 1).T, xc.flatten(0, 1)).float()
            else:  # w (H, V)
                dx.append(torch.matmul(dlogit, wc.T))
                dw += torch.matmul(xc.flatten(0, 1).T, dlogit.flatten(0, 1)).float()
        return torch.cat(dx, dim=1).to(hidden.dtype), dw.to(w.dtype), None, None, None, None


def chunked_cross_entropy(hidden, w, labels, valid, chunk=128, transpose=False):
    """Sum of next-token CE over valid positions without the full fp32
    ``(B, T, V)`` logits. ``hidden``: (B, T, H) compute dtype; ``w``: (V, H)
    when ``transpose`` (tied embedding) else (H, V); ``labels`` (B, T)
    integer, ``valid`` (B, T) bool. Chunks of ``chunk`` time steps; the last
    may be shorter (the JAX package pads it with invalid rows instead)."""
    return _ChunkedCE.apply(hidden, w, labels.long(), valid.to(torch.float32), chunk, transpose)


class _VocabParallelCE(torch.autograd.Function):
    """:class:`_ChunkedCE` over a vocab split across ``tensor`` (Megatron's
    vocab-parallel cross entropy): ``w`` holds this rank's vocab rows
    ``[start, start + V/t)``. Each chunk's max is all-reduced with MAX, its
    sum of exponentials and the target logit (taken from the rank that owns
    the label, zero elsewhere) with SUM, so every rank gets the same loss.
    The backward stays local: this rank's softmax columns give its part of
    d(hidden), which the :func:`~deepspeed_tpu_torch.comm.copy_to_region`
    the caller put before ``hidden`` sums over the ranks, and its own
    vocab rows' d(w)."""

    @staticmethod
    def forward(ctx, hidden, w, labels, valid, chunk, transpose, start):
        Vl = w.shape[0] if transpose else w.shape[1]
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        lses = []
        for c0 in range(0, hidden.shape[1], chunk):
            logits = _ce_logits(hidden[:, c0:c0 + chunk], w, transpose)
            m = dist.all_reduce(logits.amax(dim=-1), dist.ReduceOp.MAX, dist.TENSOR_AXIS)
            loc = labels[:, c0:c0 + chunk] - start
            own = (loc >= 0) & (loc < Vl)
            corr = torch.gather(logits, -1, loc.clamp(0, Vl - 1)[..., None])[..., 0]
            sums = torch.stack([torch.exp(logits - m[..., None]).sum(dim=-1),
                                torch.where(own, corr, torch.zeros_like(corr))])
            sums = dist.all_reduce(sums, dist.ReduceOp.SUM, dist.TENSOR_AXIS)
            lse = m + torch.log(sums[0])
            lses.append(lse)
            total = total + ((lse - sums[1]) * valid[:, c0:c0 + chunk]).sum()
        ctx.save_for_backward(hidden, w, labels, valid, torch.cat(lses, dim=1))
        ctx.chunk, ctx.transpose, ctx.start = chunk, transpose, start
        return total

    @staticmethod
    def backward(ctx, g):
        hidden, w, labels, valid, lse = ctx.saved_tensors
        chunk, transpose, start = ctx.chunk, ctx.transpose, ctx.start
        Vl = w.shape[0] if transpose else w.shape[1]
        wc = w.to(hidden.dtype)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dx = []
        for c0 in range(0, hidden.shape[1], chunk):
            xc = hidden[:, c0:c0 + chunk]
            dlogit = torch.exp(_ce_logits(xc, w, transpose) - lse[:, c0:c0 + chunk, None])
            loc = labels[:, c0:c0 + chunk] - start
            own = ((loc >= 0) & (loc < Vl)).to(dlogit.dtype)
            dlogit.scatter_add_(-1, loc.clamp(0, Vl - 1)[..., None], -own[..., None])
            dlogit = (dlogit * (valid[:, c0:c0 + chunk] * g)[..., None]).to(xc.dtype)
            if transpose:  # w (V/t, H)
                dx.append(torch.matmul(dlogit, wc))
                dw += torch.matmul(dlogit.flatten(0, 1).T, xc.flatten(0, 1)).float()
            else:  # w (H, V/t)
                dx.append(torch.matmul(dlogit, wc.T))
                dw += torch.matmul(xc.flatten(0, 1).T, dlogit.flatten(0, 1)).float()
        return torch.cat(dx, dim=1).to(hidden.dtype), dw.to(w.dtype), None, None, None, None, None


def vocab_parallel_cross_entropy(hidden, w, labels, valid, cfg, chunk=256, transpose=False):
    """:func:`chunked_cross_entropy` with the vocab split over ``tensor``
    (``cfg.tp_vocab``): ``w`` is this rank's (V/t, H) rows when
    ``transpose`` (a tied embedding), else its (H, V/t) columns. ``hidden``
    enters the tensor region here, so its gradient sums over the ranks."""
    start = cfg.tp_index * (cfg.vocab_size // cfg.tp_size)
    return _VocabParallelCE.apply(dist.copy_to_region(hidden), w, labels.long(), valid.to(torch.float32),
                                  chunk, transpose, start)


def _chunked_ce(hidden, w, labels, valid, cfg, transpose):
    """The model's chunked CE: vocab-parallel when the vocab splits over
    ``tensor``."""
    chunk = cfg.ce_chunk_size or 256
    if cfg.tp_vocab:
        return vocab_parallel_cross_entropy(hidden, w, labels, valid, cfg, chunk=chunk, transpose=transpose)
    return chunked_cross_entropy(hidden, w, labels, valid, chunk=chunk, transpose=transpose)


def embed_lookup(table, ids, cfg):
    """The embedding rows of ``ids``. With the vocab split over ``tensor``
    (``cfg.tp_vocab``) each rank looks up the rows it holds, every rank's
    rows are all-gathered on a new last axis and each token takes its
    owner's: a select, so the result is exactly the stored row (a sum of
    the ranks' masked rows would turn a stored -0.0 into +0.0), and its
    gradient reaches the owner's table only."""
    if not cfg.tp_vocab:
        return table[ids]
    Vl = table.shape[0]
    rows = table[(ids - cfg.tp_index * Vl).clamp(0, Vl - 1)]
    stacked = dist.gather_from_region(rows.unsqueeze(-1))  # (..., H, t)
    owner = torch.div(ids, Vl, rounding_mode="floor")
    return torch.gather(stacked, -1, owner[..., None, None].expand(rows.shape + (1, )))[..., 0]


# ---------------------------------------------------------------------------
# remat policies and dropout

# jax.checkpoint_policies' public names (JAX 0.9), quoted by the error for
# an unknown name as the JAX package quotes them
_JAX_POLICY_NAMES = ("checkpoint_dots", "checkpoint_dots_with_no_batch_dims", "dots_saveable",
                     "dots_with_no_batch_dims_saveable", "everything_saveable", "nothing_saveable",
                     "offload_dot_with_no_batch_dims", "save_and_offload_only_these_names",
                     "save_any_names_but_these", "save_anything_except_these_names",
                     "save_from_both_policies", "save_only_these_names")


def _saving(ops):
    """A selective-checkpoint ``context_fn`` that keeps the outputs of
    ``ops`` (aten overloads) and recomputes everything else."""

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in ops else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def resolve_remat_policy(name):
    """The ``torch.utils.checkpoint`` ``context_fn`` of a remat policy
    name, or None where a block runs without a checkpoint (the JAX
    package's ``resolve_remat_policy``, ``models/transformer.py:172``).

    ``nothing_saveable`` recomputes the whole block; ``everything_saveable``
    keeps every residual, which is what autograd does without a
    checkpoint; ``dots_saveable`` / ``checkpoint_dots`` keep the products
    (``aten.mm``, ``addmm``, ``bmm``); ``dots_with_no_batch_dims_saveable``
    / ``checkpoint_dots_with_no_batch_dims`` the 2-D ones only;
    ``dots_and_attn_saveable`` the products and the flash forward's out and
    lse (the ``flash_fwd`` operator), so the backward pass does not run the
    forward kernel again. A ``jax.checkpoint_policies`` factory (it takes
    arguments) and an unknown name raise ``ValueError``."""
    if name is None or name == "everything_saveable":
        return None
    if name == "nothing_saveable":
        return noop_context_fn
    aten = torch.ops.aten
    mm = {aten.mm.default, aten.addmm.default}
    if name in ("dots_saveable", "checkpoint_dots"):
        return _saving(mm | {aten.bmm.default})
    if name in ("dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims"):
        return _saving(mm)
    if name == "dots_and_attn_saveable":
        return _saving(mm | {aten.bmm.default, torch.ops.deepspeed_tpu_torch.flash_fwd.default})
    if name in _JAX_POLICY_NAMES:
        raise ValueError(f"remat policy {name!r} is a jax.checkpoint_policies factory: it takes "
                         f"arguments and returns a policy, and is not a policy by itself")
    raise ValueError(f"unknown remat policy {name!r} (a typo would silently mean full recompute); use "
                     f"'nothing_saveable', 'dots_and_attn_saveable', or one of "
                     f"jax.checkpoint_policies: {list(_JAX_POLICY_NAMES)}")


def _remat_block(blk, context_fn, x, sin, cos, attn_mask, position_ids, impl, key, tensors=None):
    """``blk`` on ``x`` under a non-reentrant checkpoint; returns (x, the
    MoE layer's (aux_loss, drop_frac) or None). The block's
    tensors go in as an argument and every run binds them again: the
    backward pass recomputes outside the caller's ``functional_call``, where
    the module holds meta tensors. ``tensors``: the block's tensors when the
    caller binds none (the streamed layer)."""
    tensors = dict(blk.named_buffers()) if tensors is None else tensors

    def run(x, tensors):
        out = torch.func.functional_call(blk, tensors, (x, sin, cos, attn_mask),
                                         {"position_ids": position_ids, "impl": impl,
                                          "dropout_key": key})
        return out[0], out[2]

    return checkpoint(run, x, tensors, use_reentrant=False, context_fn=context_fn,
                      preserve_rng_state=False)


@functools.lru_cache(maxsize=8)
def _element_codes(shape, seq, device):
    """mulmod32(i, GOLDEN) for the elements of a (B, T, ...) block, i an
    element's row-major index in the whole (B, n T, ...) tensor of which the
    block is chunk s along T (``seq`` = (s, n)); the same for every layer
    and site, so kept."""
    (s, n), B, T, inner = seq, shape[0], shape[1], math.prod(shape[2:])
    rows = torch.arange(B, dtype=torch.int64, device=device)[:, None] * (n * T) + s * T \
        + torch.arange(T, dtype=torch.int64, device=device)[None, :]
    idx = rows[:, :, None] * inner + torch.arange(inner, dtype=torch.int64, device=device)
    return mulmod32(idx.reshape(-1), GOLDEN)


def dropout_mask(key, shape, rate, device, seq=(0, 1)):
    """The keep mask (bool, ``shape``) of dropout at ``rate`` under ``key``
    (a uint32 Python int): element i (row-major) is kept when
    ``mix32(mulmod32(i, GOLDEN) ^ key) >= round(rate * 2^32)``. Integer ops
    and an integer threshold only, so the card and the CPU draw the same
    bits, and a recomputed block draws its forward's mask (a
    ``torch.Generator`` would not: ``torch.utils.checkpoint`` restores only
    the global generators). ``seq``: (index, degree) when ``shape`` (B, T,
    ...) is chunk ``index`` of a sequence split in ``degree``: element i is
    then numbered in the whole (B, degree * T, ...) tensor, so a split
    sequence draws the masks of the whole one."""
    codes = _element_codes(tuple(shape), tuple(seq), torch.device(device))
    return (mix32(codes ^ key) >= int(round(rate * 2**32))).reshape(shape)


def dropout_apply(x, keep, rate):
    """flax ``nn.Dropout``'s output for the mask ``keep``: ``select(keep, x
    / (1 - rate), 0)``, the division by ``1 - rate`` rounded to x's dtype
    (a tensor divisor: on the card a Python number would become a multiply
    by its reciprocal)."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep_prob = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def dropout(x, rate, key, seq=(0, 1)):
    return dropout_apply(x, dropout_mask(key, x.shape, rate, x.device, seq), rate)


# ---------------------------------------------------------------------------
# positions and norms


def rope_table(head_size, max_len, theta, device=None):
    freq = 1.0 / (theta**(torch.arange(0, head_size, 2, dtype=torch.float32, device=device) / head_size))
    pos = torch.arange(max_len, dtype=torch.float32, device=device)
    angles = torch.outer(pos, freq)  # (T, hd/2)
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x, sin, cos):
    """x: (B, H, T, hd); tables (T, hd/2) shared across the batch or
    (B, T, hd/2) per row (left-padded generation)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    if sin.dim() == 2:
        sin, cos = sin[None, None], cos[None, None]
    else:
        sin, cos = sin[:, None], cos[:, None]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


class RMSNorm(nn.Module):
    """RMSNorm with fp32 statistics, output in the compute dtype."""

    def __init__(self, features, epsilon, dtype):
        super().__init__()
        self.epsilon, self.dtype = epsilon, dtype
        self.register_buffer("scale", _meta(features))

    def forward(self, x):
        return F.rms_norm(x.float(), self.scale.shape, self.scale.float(), self.epsilon).to(self.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics, output in the compute dtype (flax
    ``nn.LayerNorm`` with ``param_dtype=float32``; flax takes the variance as
    E[x^2] - E[x]^2, PyTorch as E[(x - E[x])^2], equal to fp32 rounding).
    PyTorch's kernel computes in fp32 from bf16 operands, so the bf16 path
    needs no casts."""

    def __init__(self, features, epsilon, dtype):
        super().__init__()
        self.epsilon, self.dtype = epsilon, dtype
        self.register_buffer("scale", _meta(features))
        self.register_buffer("bias", _meta(features))

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.scale.dtype)
        return F.layer_norm(x.to(dt), self.scale.shape, self.scale.to(dt), self.bias.to(dt),
                            self.epsilon).to(self.dtype)


def make_norm(cfg):
    cls = RMSNorm if cfg.norm == "rmsnorm" else LayerNorm
    return cls(cfg.hidden_size, cfg.layernorm_epsilon, cfg.dtype)


# ---------------------------------------------------------------------------
# projections


def _q_groups(k, group_size):
    """Scale-group count for a contraction of k: group_size (default 128)
    when it divides k, else one group — the rule quantize_params uses."""
    gs = group_size or 128
    return k // gs if k % gs == 0 else 1


def _matmul_rows(x2d, w, w_rows=False):
    """``x2d (M, K) @ w`` (``w`` (K, N)), or ``@ w.T`` when ``w_rows`` (``w``
    (N, K), a tied embedding), with rows that do not depend on M: a lone
    row runs as one row of two, since torch.matmul hands a single row to a
    matrix-vector routine that sums in another order, and a (N, K) weight
    stays the left operand (through a transposed view, small M takes other
    routines too). A decode step's row and a verify's then get the same
    bits."""
    pad = x2d.shape[0] == 1
    if pad:
        x2d = torch.cat([x2d, torch.zeros_like(x2d)])
    y = torch.matmul(w, x2d.T).T.contiguous() if w_rows else torch.matmul(x2d, w)
    return y[:1] if pad else y


def _qmm2d(x2d, qw, scales, out_dtype=None, impl="kernel"):
    """int8 matmul ``x @ dequant(qw)`` through the quant-matmul kernel."""
    return quant_matmul(x2d, qw, scales, out_dtype=out_dtype or x2d.dtype, impl=impl)


class QuantDense(nn.Module):
    """Dense layer over a (K, N) kernel in matmul layout: float (``kernel``)
    or int8 (``kernel_q`` + fp32 ``kernel_scale``) through the quant-matmul
    kernel; optional ``bias`` (N,). Computes in ``dtype``."""

    def __init__(self, k, n, use_bias, dtype, int8=False, group_size=0):
        super().__init__()
        self.dtype, self.int8 = dtype, int8
        if int8:
            self.register_buffer("kernel_q", _meta(k, n, dtype=torch.int8))
            self.register_buffer("kernel_scale", _meta(_q_groups(k, group_size), n))
        else:
            self.register_buffer("kernel", _meta(k, n))
        self.register_buffer("bias", _meta(n) if use_bias else None)

    def forward(self, x, impl="kernel", reduce=None):
        """``reduce``: applied to the product before the bias (a
        row-parallel shard's sum over ``tensor``, so the bias is added
        once)."""
        K = x.shape[-1]
        x2 = x.reshape(-1, K).to(self.dtype)
        if self.int8:
            y = _qmm2d(x2, self.kernel_q, self.kernel_scale, impl=impl)
        else:
            y = _matmul_rows(x2, self.kernel.to(self.dtype))
        if reduce is not None:
            y = reduce(y)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y.reshape(x.shape[:-1] + (y.shape[-1], ))


class HeadProjection(QuantDense):
    """q/k/v projection emitting head-major (B, heads, T, head_dim)."""

    def __init__(self, hidden, heads, head_dim, use_bias, dtype, int8=False, group_size=0):
        super().__init__(hidden, heads * head_dim, use_bias, dtype, int8, group_size)
        self.heads, self.head_dim = heads, head_dim

    def forward(self, x, impl="kernel"):  # (B, T, H) -> (B, heads, T, hd)
        B, T, _ = x.shape
        y = super().forward(x, impl)
        return y.reshape(B, T, self.heads, self.head_dim).transpose(1, 2)


class OutProjection(QuantDense):
    """Attention output projection consuming (B, heads, T, hd). Under
    tensor parallelism the input is this rank's heads: ``bitwise_tp``
    all-gathers them (a concatenation in head order) before the whole
    projection, else this rank's rows of the projection run and the
    partial outputs are summed over ``tensor`` before the bias."""

    def forward(self, x, impl="kernel", tp=None):  # (B, heads, T, hd) -> (B, T, features)
        B, n, T, d = x.shape
        x = x.transpose(1, 2).reshape(B, T, n * d)
        if tp == "gather":
            return super().forward(dist.gather_from_region(x), impl)
        return super().forward(x, impl, reduce=dist.reduce_from_region if tp == "reduce" else None)


# ---------------------------------------------------------------------------
# attention


def _sdpa_plain(q, k, v, bias, dtype):
    """Plain attention in bhtd: scores in the compute dtype, fp32 softmax."""
    hd = q.shape[-1]
    scores = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd) + bias
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.matmul(probs, v)


def _cached_attention_plain(q, ck, cv, cache_index, cache_mask, dtype, by_column=False):
    """Grouped-query attention against a KV cache, no head expansion: query
    position i sits at cache position ``cache_index + i`` and attends every
    earlier slot that ``cache_mask`` (B, S) allows. ``cache_index`` is a
    shared int or a (B,) tensor (the slot pool: every row at its own
    position). The fallback for ragged (left-padded) prefill, short prompts
    and ``attention_impl="xla"``.

    ``by_column`` (``attention_impl="xla"``, the plain cached forward): one
    matmul per query column, so a column's scores and its probs @ v run the
    same routine whatever T is, and a decode step's column is bitwise a
    verify's (torch.matmul picks its routine by shape: one column takes
    another path than five). The flash configuration's fallback (prefill
    only) keeps one matmul for all columns."""
    B, nh, T, hd = q.shape
    nkv, S = ck.shape[1], ck.shape[2]
    g = nh // nkv
    qg = q.reshape(B, nkv, g, T, hd)
    kt = ck[:, :, None].transpose(-1, -2)
    if by_column:
        scores = torch.cat([torch.matmul(qg[:, :, :, i:i + 1], kt) for i in range(T)], dim=3)
    else:
        scores = torch.matmul(qg, kt)
    scores = scores.float() / math.sqrt(hd)
    t = torch.arange(T, device=q.device)
    if isinstance(cache_index, torch.Tensor):
        qpos = cache_index.long()[:, None] + t[None, :]  # (B, T)
    else:
        qpos = (cache_index + t)[None, :]  # (1, T)
    keep = torch.arange(S, device=q.device)[None, None, :] <= qpos[..., None]  # (B or 1, T, S)
    bias = torch.where(keep, 0.0, -1e30)[:, None, None]  # (B or 1, 1, 1, T, S)
    if cache_mask is not None:
        bias = bias + torch.where(cache_mask, 0.0, -1e30)[:, None, None, None, :]
    probs = torch.softmax(scores + bias, dim=-1).to(dtype)
    vg = cv[:, :, None]
    if by_column:
        out = torch.cat([torch.matmul(probs[:, :, :, i:i + 1], vg) for i in range(T)], dim=3)
    else:
        out = torch.matmul(probs, vg)
    return out.reshape(B, nh, T, hd)


def span_targets(write_index, q_spans, T, S, wslot=None, ext_base=None):
    """Where :func:`span_write` puts a (B, T) block of query columns in a
    cache of S rows: ``(rows (B, T) int64, live (B, T) bool)``. Column j of
    row b is live when it is inside the row's span (``j < q_spans[b]``) and
    inside the cache (``write_index[b] + j < S``); its row is
    ``(write_index[b] + j) % S``, so the T rows of a batch row are distinct
    while T <= S. Computed once per forward and shared by every layer's
    leaves.

    The extent write (long context, ``wslot``/``ext_base`` (B,) given):
    ``(pool rows (B,), offsets (B, T), live (B, T))``; column j of row b
    lands in pool row ``wslot[b]`` at offset ``write_index[b] - ext_base[b] +
    j``, live when inside the span. The scheduler clamps a chunk and a
    sync's substeps to the write extent, so a live offset never leaves
    ``[0, S)`` (else it would land in another request's row), and hands
    every batch row a pool row of its own (a dead row one that no live row
    writes), so no two columns target one (row, offset). On the CPU both
    are checked and a breach raises; on the card a check would wait for the
    device."""
    if T > S:
        raise ValueError(f"a span of {T} columns does not fit a cache of {S} rows")
    col = torch.arange(T, device=write_index.device)
    tgt = write_index.long()[:, None] + col[None, :]
    if wslot is None:
        return tgt % S, (col[None, :] < q_spans[:, None]) & (tgt < S)
    off = tgt - ext_base.long()[:, None]
    live = col[None, :] < q_spans[:, None]
    if not off.is_cuda:
        out = (live & ((off < 0) | (off >= S))).any(1).nonzero()[:, 0].tolist()
        if out:
            raise ValueError(f"an extent write leaves its extent of {S} rows: rows {out}, "
                             f"write_index {write_index[out].tolist()}, ext_base "
                             f"{ext_base[out].tolist()}, span {q_spans[out].tolist()}")
        if torch.unique(wslot).numel() != wslot.numel():
            raise ValueError(f"two batch rows write one pool row: wslot {wslot.tolist()}")
    return wslot.long(), off % S, live


def span_write(cache, val, targets):
    """Write the live columns of ``val`` (B, heads, T, hd) into ``cache``
    (B, heads, S, hd) in place, at the rows of ``targets`` (from
    :func:`span_targets`); every other column is dropped, as the JAX
    package's ``mode="drop"`` writes are. PyTorch has no dropping scatter (an
    out-of-range index raises on the CPU and is a device-side assert on the
    card), so this gathers the rows the columns would hit, selects the new
    value where the column is live and the old one where it is dead, and
    scatters back: a dead column rewrites a row with its own bytes, so a
    retained prefix in a dead slot stays byte-stable, with no host sync. A
    batch row's targets are distinct, so the scatter has no duplicate index.
    With extent targets the same happens in each row's pool row, and the
    targets of all rows are distinct."""
    if len(targets) == 3:
        pool_rows, offs, live = targets
        B, _, T, _ = val.shape
        view = cache.transpose(1, 2)  # (Npool, S, heads, hd), a view
        idx = (pool_rows[:, None].expand(B, T), offs)
        old = view[idx]  # (B, T, heads, hd)
        view.index_put_(idx, torch.where(live[:, :, None, None], val.transpose(1, 2).to(cache.dtype),
                                         old))
        return
    rows, live = targets
    B, heads, _, hd = cache.shape
    idx = rows[:, None, :, None].expand(B, heads, rows.shape[1], hd)
    old = torch.gather(cache, 2, idx)
    cache.scatter_(2, idx, torch.where(live[:, None, :, None], val.to(cache.dtype), old))


class Attention(nn.Module):

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        H, nh, nkv, hd = cfg.hidden_size, cfg.local_heads, cfg.local_kv_heads, cfg.head_size
        self.use_bias = cfg.attn_bias if cfg.attn_bias is not None else cfg.norm == "layernorm"
        i8, gs = cfg.int8_weights, cfg.int8_group_size
        self.fused = i8 and cfg.int8_fused_qkv
        if self.fused:
            N = (nh + 2 * nkv) * hd
            self.register_buffer("qkv_q", _meta(H, N, dtype=torch.int8))
            self.register_buffer("qkv_scale", _meta(_q_groups(H, gs), N))
            self.register_buffer("qkv_bias", _meta(N) if self.use_bias else None)
        else:
            self.q_proj = HeadProjection(H, nh, hd, self.use_bias, cfg.dtype, i8, gs)
            self.k_proj = HeadProjection(H, nkv, hd, self.use_bias, cfg.dtype, i8, gs)
            self.v_proj = HeadProjection(H, nkv, hd, self.use_bias, cfg.dtype, i8, gs)
        o_rows = nh * hd if cfg.tp_mode == "reduce" else cfg.num_heads * hd
        self.o_proj = OutProjection(o_rows, H, self.use_bias, cfg.dtype, i8, gs)

    def forward(self, x, sin, cos, attn_mask=None, kv_cache=None, cache_index=None,
                position_ids=None, decode_window=None, slot_write=None, impl="kernel"):
        """``attn_mask``: without a cache (B, T) over the current tokens;
        with a cache (B, S) over cache slots (True = attendable, the left-pad
        mask of batched generation). ``decode_window``: the (start, end) rows
        of the decode kernel (with ``slot_write`` at T > 1: (start, base) of
        the span kernel), computed once per forward by :class:`CausalLM`.
        ``slot_write``: the slot pool's ``(write_index, q_spans, targets,
        ext, seq_shard)``, per-row (B,) write positions, live query counts
        (or None), their :func:`span_targets`, for long context ``(ext_table,
        sinks, windows)`` (else None): attention then runs through the
        extent modes over logical positions; and whether the span's query
        columns split over ``seq`` (the sequence-parallel prefill). A
        3-leaf cache is the int8 KV tier: fresh K/V are quantized on write.
        Without a cache, a model with ``seq_shard`` holds this rank's chunk
        of the sequence (see :meth:`_seq_attention`). Returns (out,
        kv_cache); the cache is written in place."""
        cfg = self.cfg
        B, T, H = x.shape
        nh, nkv, hd = cfg.local_heads, cfg.local_kv_heads, cfg.head_size
        x = dist.copy_to_region(x) if cfg.tp_size > 1 else x
        if self.fused:
            y = _qmm2d(x.reshape(B * T, H).to(cfg.dtype), self.qkv_q, self.qkv_scale, impl=impl)
            if self.qkv_bias is not None:
                y = y + self.qkv_bias.to(y.dtype)
            q, k, v = torch.split(y, [nh * hd, nkv * hd, nkv * hd], dim=-1)
            q = q.reshape(B, T, nh, hd).transpose(1, 2)
            k = k.reshape(B, T, nkv, hd).transpose(1, 2)
            v = v.reshape(B, T, nkv, hd).transpose(1, 2)
        else:
            q = self.q_proj(x, impl)
            k = self.k_proj(x, impl)
            v = self.v_proj(x, impl)

        if cfg.pos_embedding == "rope":
            if position_ids is not None:
                pos_sin, pos_cos = sin[position_ids], cos[position_ids]  # (B, T, hd/2)
            elif cache_index is not None:
                pos_sin, pos_cos = sin[cache_index:cache_index + T], cos[cache_index:cache_index + T]
            else:  # a seq rank's chunk sits at its global rows
                p0 = cfg.seq_index * T
                pos_sin, pos_cos = sin[p0:p0 + T], cos[p0:p0 + T]
            rot = cfg.rotary_dim or hd
            if rot < hd:  # partial rotary (GPT-J/NeoX): pass-through tail dims
                q = torch.cat([apply_rope(q[..., :rot], pos_sin, pos_cos), q[..., rot:]], dim=-1)
                k = torch.cat([apply_rope(k[..., :rot], pos_sin, pos_cos), k[..., rot:]], dim=-1)
            else:
                q = apply_rope(q, pos_sin, pos_cos)
                k = apply_rope(k, pos_sin, pos_cos)
        if cfg.attn_scale is not None:
            # every attention path divides scores by sqrt(hd); pre-scaling q
            # by attn_scale*sqrt(hd) nets the configured scale (GPT-Neo: 1.0)
            q = q * torch.tensor(cfg.attn_scale * (hd**0.5), dtype=q.dtype)

        flash = cfg.attention_impl == "flash"
        write_index, q_spans, targets, ext, seq_split = slot_write or (None, None, None, None, False)
        if kv_cache is not None:
            quant_kv = len(kv_cache) == 3
            csc = None
            if quant_kv:
                ck, cv, csc = kv_cache
                kq, vq, sc_new = quantize_kv_rows(k, v, group=dist.TENSOR_AXIS if cfg.tp_size > 1 else None)
                writes = [(ck, kq), (cv, vq), (csc, sc_new)]
            else:
                ck, cv = kv_cache
                writes = [(ck, k), (cv, v)]
            if write_index is not None:
                for c, val in writes:
                    span_write(c, val, targets)
            else:
                for c, val in writes:
                    c[:, :, cache_index:cache_index + T] = val.to(c.dtype)
            if seq_split:
                # the sequence-parallel prefill: this rank's query columns
                starts, base = decode_window
                ext_table, sinks, wins = ext or (None, None, None)
                out = seq_sharded_span_attention(q.contiguous(), ck, cv, starts, base,
                                                 block_kv=cfg.decode_block_kv, k_scale=csc, v_scale=csc,
                                                 ext=ext_table, sink=sinks, window=wins, impl=impl)
            elif ext is not None:
                # long context: logical windows through each row's extent table
                starts, ends = decode_window
                ext_table, sinks, wins = ext
                if T == 1:
                    out = extent_paged_decode_attention(
                        q[:, :, 0].contiguous(), ck, cv, starts, ends, ext_table,
                        block_kv=cfg.decode_block_kv, k_scale=csc, v_scale=csc, sink=sinks,
                        window=wins, impl=impl)[:, :, None]
                else:
                    out = extent_paged_span_attention(
                        q.contiguous(), ck, cv, starts, ends, ext_table,
                        block_kv=cfg.decode_block_kv, k_scale=csc, v_scale=csc, sink=sinks,
                        window=wins, impl=impl)
            elif flash and T == 1 and (write_index is not None or not quant_kv):
                starts, ends = decode_window
                if write_index is not None:
                    out = paged_decode_attention(q[:, :, 0].contiguous(), ck, cv, starts, ends,
                                                 block_kv=cfg.decode_block_kv, k_scale=csc,
                                                 v_scale=csc, impl=impl)[:, :, None]
                else:
                    out = decode_attention(q[:, :, 0].contiguous(), ck, cv, starts, ends,
                                           block_kv=cfg.decode_block_kv, impl=impl)[:, :, None]
            elif flash and write_index is not None and q_spans is not None:
                # the fused chunked-prefill step: per-row query spans
                starts, base = decode_window
                out = paged_span_attention(q.contiguous(), ck, cv, starts, base,
                                           block_kv=cfg.decode_block_kv, k_scale=csc, v_scale=csc,
                                           impl=impl)
            elif flash and attn_mask is None and T >= 128 and write_index is None and cache_index == 0:
                # unpadded prefill: nothing earlier in the cache, so attention
                # over the current tokens only (GQA-native flash kernel)
                out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                                      impl=impl)
            else:
                if quant_kv:
                    ck = dequantize_kv_rows(ck, csc, dtype=cfg.dtype)
                    cv = dequantize_kv_rows(cv, csc, dtype=cfg.dtype)
                out = _cached_attention_plain(q, ck, cv,
                                              cache_index if write_index is None else write_index,
                                              attn_mask, cfg.dtype, by_column=not flash)
            out = out.to(cfg.dtype)
            new_cache = kv_cache
        else:
            new_cache = None
            if cfg.seq_size > 1:
                out = self._seq_attention(q, k, v, attn_mask, impl)
            else:
                out = _causal_attention(q, k, v, attn_mask, flash and T >= 128 and attn_mask is None, cfg,
                                        impl)
        return self.o_proj(out, impl, cfg.tp_mode), new_cache

    def _seq_attention(self, q, k, v, attn_mask, impl):
        """Causal attention of this rank's chunk (q (B, nh, Tc, hd), k/v
        (B, nkv, Tc, hd) at global rows ``seq_index * Tc + t``) over the
        ``seq`` axis (the JAX model's ``models/transformer.py:962-1016``):
        the flash path (the whole sequence >= 128 rows, no mask) by ring
        attention under ``sequence_parallel_impl='ring'``; else Ulysses,
        an all-to-all to this rank's heads over the whole sequence and back
        (k/v gathered over ``seq`` when the kv heads do not divide it, the
        sequence gathered when the heads do not). ``attn_mask``: (B, Tc),
        gathered over ``seq``."""
        cfg = self.cfg
        n, s = cfg.seq_size, cfg.seq_index
        B, nh, Tc, hd = q.shape
        nkv = k.shape[1]
        if attn_mask is not None:  # the key mask of the whole sequence
            attn_mask = dist.all_gather(attn_mask.to(torch.uint8), group=dist.SEQ_AXIS, axis=1).bool()
        flash = cfg.attention_impl == "flash" and n * Tc >= 128 and attn_mask is None
        if cfg.sequence_parallel_impl == "ring":
            if flash:
                return ring_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                                      schedule=cfg.ring_schedule, impl=impl)
            warning_once("sequence_parallel_impl='ring' requested but this attention call cannot use it "
                         "(needs the flash path: T >= 128 and no attention_mask) — falling back to "
                         "full-sequence attention")
        if dist.SEQ_AXIS not in dist.attention_partition_axes(B, cfg.num_heads)[1]:
            # the heads do not tile over (tensor, seq): every rank attends the
            # whole sequence and keeps its rows
            qf, kf, vf = (dist.all_gather_autograd(t.contiguous(), dist.SEQ_AXIS, 2) for t in (q, k, v))
            return _causal_attention(qf, kf, vf, attn_mask, flash, cfg, impl).narrow(2, s * Tc, Tc)
        hl, g = nh // n, nh // nkv
        qh = dist.AllToAll.apply(q.contiguous(), dist.SEQ_AXIS, 1, 2)  # (B, nh / n, T, hd)
        if nkv % n == 0:
            kh, vh = (dist.AllToAll.apply(t.contiguous(), dist.SEQ_AXIS, 1, 2) for t in (k, v))
        else:  # this rank's query heads read the kv heads h // g of the gathered sequence
            kf, vf = (dist.all_gather_autograd(t.contiguous(), dist.SEQ_AXIS, 2) for t in (k, v))
            if hl % g == 0 or g % hl == 0:
                lo, hi = s * hl // g, ((s + 1) * hl - 1) // g + 1
                kh, vh = kf[:, lo:hi], vf[:, lo:hi]
            else:
                kh, vh = (t.repeat_interleave(g, dim=1)[:, s * hl:(s + 1) * hl] for t in (kf, vf))
        out = _causal_attention(qh, kh, vh, attn_mask, flash, cfg, impl)
        return dist.AllToAll.apply(out.contiguous(), dist.SEQ_AXIS, 2, 1)


def _causal_attention(q, k, v, attn_mask, flash, cfg, impl):
    """Causal attention of q (B, nh, T, hd) over k/v (B, nkv, T, hd): the
    flash kernel (GQA-native) when ``flash``, else the plain softmax with
    the key mask ``attn_mask`` (B, T)."""
    if flash:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True, impl=impl)
    nh, nkv, T = q.shape[1], k.shape[1], q.shape[2]
    if nkv != nh:
        k = k.repeat_interleave(nh // nkv, dim=1)
        v = v.repeat_interleave(nh // nkv, dim=1)
    keep = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    bias = torch.where(keep, 0.0, -1e30)[None, None]
    if attn_mask is not None:
        bias = bias + torch.where(attn_mask, 0.0, -1e30)[:, None, None, :]
    return _sdpa_plain(q, k, v, bias, cfg.dtype)


class MLP(nn.Module):

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        H, Fs = cfg.hidden_size, cfg.local_ffn
        bias = cfg.norm == "layernorm"
        i8, gs = cfg.int8_weights, cfg.int8_group_size
        if cfg.activation in ("swiglu", "geglu"):
            self.gate_proj = QuantDense(H, Fs, bias, cfg.dtype, i8, gs)
        self.up_proj = QuantDense(H, Fs, bias, cfg.dtype, i8, gs)
        self.down_proj = QuantDense(Fs if cfg.tp_mode == "reduce" else cfg.ffn_size, H, bias, cfg.dtype, i8, gs)

    def forward(self, x, impl="kernel"):
        """Under tensor parallelism ``x`` enters the region whole and the
        up/gate columns are this rank's; ``bitwise_tp`` all-gathers the
        activation before the whole down_proj, else this rank's down_proj
        rows run and their outputs sum over ``tensor`` before the bias."""
        act = self.cfg.activation
        mode = self.cfg.tp_mode
        if mode is not None:
            x = dist.copy_to_region(x)
        if act in ("swiglu", "geglu"):
            gate = self.gate_proj(x, impl)
            up = self.up_proj(x, impl)
            h = (F.silu(gate) if act == "swiglu" else F.gelu(gate, approximate="tanh")) * up
        else:
            h = self.up_proj(x, impl)
            if act == "gelu":
                h = F.gelu(h, approximate="tanh")  # HF "gelu_new"
            elif act == "gelu_exact":
                h = F.gelu(h)
            elif act == "quick_gelu":
                h = h * torch.sigmoid(1.702 * h)
            else:
                h = F.relu(h)
        if mode == "gather":
            h = dist.gather_from_region(h)
        return self.down_proj(h, impl, reduce=dist.reduce_from_region if mode == "reduce" else None)


class Block(nn.Module):

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = make_norm(cfg)
        self.attn = Attention(cfg)
        self.mlp_norm = make_norm(cfg)
        if cfg.num_experts > 0:
            from ..moe.layer import MoE
            self.moe = MoE(cfg)
        else:
            self.mlp = MLP(cfg)

    def forward(self, x, sin, cos, attn_mask=None, kv_cache=None, cache_index=None,
                position_ids=None, decode_window=None, slot_write=None, impl="kernel",
                dropout_key=None, expert_stats=None):
        """``dropout_key``: this layer's key (training with dropout), else
        None: the attention and MLP branches each pass through dropout
        under a key of their own (the JAX ``Block``'s two residual
        dropouts). Returns ``(x, kv_cache, moe)``: ``moe`` is the MoE
        layer's ``(aux_loss, drop_frac)`` without a cache (training), else
        None. With a cache an MoE layer routes each token on its own and
        appends its routed-token counts to the ``expert_stats`` list when
        one is given."""
        rate = self.cfg.dropout
        h, new_cache = self.attn(self.attn_norm(x), sin, cos, attn_mask, kv_cache, cache_index,
                                 position_ids, decode_window, slot_write, impl)
        seq = (self.cfg.seq_index, self.cfg.seq_size)
        if dropout_key is not None:
            h = dropout(h, rate, fold_in(dropout_key, 0), seq)
        ff_in = x if self.cfg.parallel_residual else x + h
        moe = None
        if self.cfg.num_experts == 0:
            ff = self.mlp(self.mlp_norm(ff_in), impl)
        elif kv_cache is not None:
            ff = self.moe.serving(self.mlp_norm(ff_in), None if slot_write is None else slot_write[1],
                                  expert_stats)
        else:
            ff, aux, drop = self.moe(self.mlp_norm(ff_in))
            moe = (aux, drop)
        if dropout_key is not None:
            ff = dropout(ff, rate, fold_in(dropout_key, 1), seq)
        if self.cfg.parallel_residual:
            return x + h + ff, new_cache, moe
        return ff_in + ff, new_cache, moe


class Embed(nn.Module):

    def __init__(self, vocab, hidden):
        super().__init__()
        self.register_buffer("embedding", _meta(vocab, hidden))


def padded_vocab(cfg):
    """The int8 head's vocab, padded to a 2048 multiple (quantize_params
    builds the padding)."""
    return -(-cfg.vocab_size // 2048) * 2048


class CausalLM(nn.Module):

    def __init__(self, cfg):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self._remat = resolve_remat_policy(cfg.remat_policy)
        H = cfg.hidden_size
        V = cfg.vocab_size // cfg.tp_size if cfg.tp_vocab else cfg.vocab_size
        self.embed = Embed(V, H)
        if cfg.embed_norm:
            self.embed_norm = make_norm(cfg)
        if cfg.pos_embedding == "learned":
            self.register_buffer("pos_embed", _meta(cfg.max_seq_len, H))
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.final_norm = make_norm(cfg)
        if cfg.int8_weights:
            Vpad = padded_vocab(cfg) // cfg.tp_size  # this rank's columns of the padded head
            self.register_buffer("logits_q", _meta(H, Vpad, dtype=torch.int8))
            self.register_buffer("logits_scale", _meta(_q_groups(H, cfg.int8_group_size), Vpad))
            if cfg.lm_head_bias:
                self.register_buffer("logits_bias", _meta(cfg.vocab_size))
        elif not cfg.tie_embeddings:
            self.lm_head = QuantDense(H, V, cfg.lm_head_bias, cfg.dtype)
        self._rope = {}

    def _rope_table(self, device):
        key = str(device)
        if key not in self._rope:
            cfg = self.cfg
            self._rope[key] = rope_table(cfg.rotary_dim or cfg.head_size, cfg.max_seq_len,
                                         cfg.rope_theta, device=device)
        return self._rope[key]

    def forward(self, input_ids, attn_mask=None, kv_cache=None, cache_index=None,
                position_ids=None, impl="kernel", return_hidden=False, write_index=None,
                q_spans=None, ext_ops=None, dropout_key=None, moe_out=None, expert_stats=None,
                seq_shard=False):
        """``kv_cache``: ``(ks, vs)`` (or ``(ks, vs, scales)``, the int8 KV
        tier), per-layer (B, kv_heads, S, hd) caches written in place.
        Returns logits, or (logits, kv_cache) with a cache, or the
        final-norm hidden states when ``return_hidden`` (the loss fuses the
        vocab projection into the chunked cross entropy). ``write_index``/
        ``q_spans``: the slot pool's per-row write positions and live query
        counts (``cache_index`` is then unused). ``ext_ops``: long-context
        extent operands, see :meth:`CausalLMModel.apply_with_cache`.
        ``seq_shard``: the span's query columns split over ``seq`` (the
        sequence-parallel prefill; the flash span path and tp 1 only).
        ``impl="plain"`` routes every kernel to its plain version (the
        on-card check that the kernel path computes the same logits).
        ``dropout_key``: the micro-step's dropout key (training), folded
        with each layer's index; with a remat policy and no cache each
        block runs under its checkpoint. ``moe_out``: a list that receives
        each MoE layer's ``(aux_loss, drop_frac)`` (training);
        ``expert_stats``: a list that receives each MoE layer's (E,) routed
        counts (cached forward)."""
        cfg = self.cfg
        B, T = input_ids.shape
        if (ext_ops is not None or seq_shard) and (cfg.attention_impl != "flash" or cfg.local_attention_window
                                                   or write_index is None or q_spans is None):
            # a fall-through to the plain cached attention, which knows no
            # extents, would read the wrong rows
            raise ValueError("ext_ops/seq_shard require the fused flash span path "
                             "(attention_impl='flash', rope/none positions, no per-layer local "
                             "window, write_index + q_spans)")
        if seq_shard and cfg.tp_size > 1:
            raise ValueError("seq-parallel prefill requires tensor parallelism of 1 (seq and tensor kernel "
                             "sharding don't compose)")
        if kv_cache is not None and cfg.seq_size > 1:
            raise ValueError("a model holding a chunk of the sequence (seq_shard) trains only; serve it "
                             "whole (the scheduler's seq-parallel prefill splits the span kernel)")
        if write_index is not None and position_ids is not None:
            # columns past a row's span may sit past the position tables;
            # their values are never read (the JAX gathers clamp them too)
            position_ids = position_ids.clamp(max=cfg.max_seq_len - 1)
        x = embed_lookup(self.embed.embedding, input_ids, cfg).to(cfg.dtype)
        if cfg.embed_norm:
            x = self.embed_norm(x)
        if cfg.pos_embedding == "learned":
            if position_ids is not None:
                x = x + self.pos_embed[position_ids].to(cfg.dtype)
            else:  # a seq rank's chunk sits at its global rows
                c0 = cache_index or cfg.seq_index * T
                x = x + self.pos_embed[c0:c0 + T].to(cfg.dtype)
        sin = cos = None
        if cfg.pos_embedding == "rope":
            sin, cos = self._rope_table(input_ids.device)
        decode_window = None
        if kv_cache is not None and cfg.attention_impl == "flash" and (T == 1 or write_index is not None):
            # the decode and span kernels' per-row windows, once for all layers
            if attn_mask is not None:
                starts = torch.argmax(attn_mask.to(torch.int32), dim=1).to(torch.int32)
            else:
                starts = torch.zeros((B, ), dtype=torch.int32, device=input_ids.device)
            if write_index is None:
                ends = torch.full((B, ), cache_index + 1, dtype=torch.int32, device=input_ids.device)
            else:  # decode: one past each row's write; span: each row's write head
                ends = (write_index + 1 if T == 1 else write_index).to(torch.int32)
            decode_window = (starts, ends)

        slot_write = None
        if write_index is not None:
            spans = q_spans if q_spans is not None else torch.full_like(write_index, T)
            ext = None
            if ext_ops is None:
                targets = span_targets(write_index, spans, T, kv_cache[0][0].shape[2])
            else:
                ext_table, wslot, ext_base, sinks, wins = ext_ops
                targets = span_targets(write_index, spans, T, kv_cache[0][0].shape[2], wslot,
                                       ext_base)
                ext = (ext_table, sinks, wins)
            slot_write = (write_index, q_spans, targets, ext, bool(seq_shard))

        remat = self._remat if kv_cache is None and torch.is_grad_enabled() else None
        for i, blk in enumerate(self.layers):
            key = None if dropout_key is None else fold_in(dropout_key, i)
            if remat is not None:
                x, moe = _remat_block(blk, remat, x, sin, cos, attn_mask, position_ids, impl, key)
            else:
                layer_cache = None if kv_cache is None else tuple(comp[i] for comp in kv_cache)
                x, _, moe = blk(x, sin, cos, attn_mask, layer_cache, cache_index, position_ids,
                                decode_window, slot_write, impl, key, expert_stats)
            if moe is not None and moe_out is not None:
                moe_out.append(moe)

        x = self.final_norm(x)
        if return_hidden:
            return x
        if cfg.int8_weights:
            # one int8 vocab projection covers tied and untied heads; under
            # tensor parallelism each rank's vocab columns, all-gathered
            logits = _qmm2d(x.reshape(B * T, cfg.hidden_size), self.logits_q, self.logits_scale,
                            impl=impl)
            logits = _tp_gather(logits, cfg.tp_size > 1).reshape(B, T, -1)[..., :cfg.vocab_size]
            if cfg.lm_head_bias:
                logits = logits + self.logits_bias.to(logits.dtype)
        else:
            logits = _float_head(x, self.embed.embedding, self.lm_head if not cfg.tie_embeddings else None, cfg)
        if kv_cache is not None:
            return logits, kv_cache
        return logits


def _tp_gather(x, on):
    return dist.gather_from_region(x) if on else x


def _float_head(x, embedding, lm_head, cfg, impl="kernel"):
    """The float vocab projection of (B, T, H) ``x``: the tied embedding's
    rows, or ``lm_head`` (a :class:`QuantDense`, called as the module or
    through ``functional_call``); a vocab split over ``tensor`` is
    all-gathered, so every rank holds the whole logits."""
    B, T = x.shape[:2]
    if cfg.tp_vocab:
        x = dist.copy_to_region(x)
    if lm_head is None:
        logits = _matmul_rows(x.reshape(B * T, -1), embedding.to(cfg.dtype), w_rows=True).reshape(B, T, -1)
    else:
        logits = lm_head(x, impl)
    return _tp_gather(logits, cfg.tp_vocab)


def _init_leaf(name, shape, dtype, gen):
    """flax initializers by parameter name: norm scales and int8 scales
    ones, biases and int8 weights zeros, everything else (the MoE router
    and expert kernels too) normal(0.02)."""
    leaf = name.rsplit(".", 1)[-1]
    if dtype == torch.int8:
        return torch.zeros(shape, dtype=torch.int8)
    if leaf.endswith("scale"):
        return torch.ones(shape, dtype=torch.float32)
    if leaf.endswith("bias"):
        return torch.zeros(shape, dtype=torch.float32)
    return torch.empty(shape, dtype=torch.float32).normal_(0.0, 0.02, generator=gen)


class CausalLMModel:
    """Engine-facing wrapper: init_params / apply / quantize_params /
    init_cache / apply_with_cache over a flat state dict."""

    def __init__(self, cfg: TransformerConfig):
        self.cfg = cfg
        self.module = CausalLM(cfg)

    def param_shapes(self):
        """{state-dict key: (shape, dtype)} of this model's parameters."""
        return {k: (tuple(v.shape), v.dtype) for k, v in self.module.state_dict().items()}

    def init_params(self, seed=0):
        """Random host (CPU) parameters from a seed, fp32 (int8 leaves for an
        int8 model, as flax initializes them)."""
        gen = torch.Generator().manual_seed(int(seed))
        return {k: _init_leaf(k, shape, dt, gen) for k, (shape, dt) in self.param_shapes().items()}

    def bind(self, params):
        """A ``CausalLM`` module holding ``params`` (assigned, not copied).
        The state-dict keys and shapes must match exactly."""
        mod = CausalLM(self.cfg)
        mod.load_state_dict(params, strict=True, assign=True)
        return mod

    def apply(self, params, input_ids, attn_mask=None, impl="kernel"):
        return torch.func.functional_call(self.module, params, (input_ids, attn_mask),
                                          {"impl": impl}, strict=True)

    # ---- training ----------------------------------------------------------
    def _use_chunked_ce(self):
        """Chunked CE unless ``ce_chunk_size`` is 0, the vocab is below 4096
        (the dense logits are small there) or the head carries a bias (the
        chunks rebuild logits from the weight only), as in the JAX model."""
        cfg = self.cfg
        if cfg.ce_chunk_size == 0:
            return False
        if cfg.ce_chunk_size is None and cfg.vocab_size < 4096:
            return False
        return not cfg.lm_head_bias

    def set_remat_policy(self, policy):
        """Engine hook for the ``activation_checkpointing`` config section:
        rebuild the module with the named remat policy."""
        self.cfg = dataclasses.replace(self.cfg, remat_policy=policy)
        self.module = CausalLM(self.cfg)

    def loss(self, params, batch, impl="kernel", rng=None, n_valid=None, aux_share=1.0):
        """Next-token cross entropy, the mean over valid tokens. ``batch``:
        ``input_ids`` (B, T); optional ``labels`` (B, T; -100 = ignore),
        aligned with the positions (no shift), and ``attention_mask`` (B, T).
        Without labels position t predicts token t + 1. ``params``: the
        compute-dtype state dict the gradients flow back through. ``rng``:
        the micro-step's dropout key (``utils/counter_hash.py``); dropout
        is on when it is given and ``dropout > 0``, as in the JAX model.

        An MoE model adds ``moe_aux_loss_coef`` times the sum of its layers'
        load-balancing losses (the JAX model's ``loss``, which sums the
        sown ``moe_aux_loss``); ``last_moe`` then holds the step's summed
        aux loss and each layer's drop fraction. Under data parallelism the
        engine passes ``n_valid``, the global valid-token count (the JAX
        loss divides by the global ``sum(valid)``), and ``aux_share``, this
        rank's share of the aux term, so the ranks' losses sum to the
        global loss."""
        cfg = self.cfg
        if cfg.int8_weights:
            raise ValueError("loss() trains float weights; int8_weights models serve only")
        input_ids = batch["input_ids"]
        chunked = self._use_chunked_ce()
        key = rng if rng is not None and cfg.dropout > 0 else None
        moe_out = [] if cfg.num_experts > 0 else None
        out = torch.func.functional_call(self.module, params, (input_ids, batch.get("attention_mask")),
                                         {"impl": impl, "return_hidden": chunked, "dropout_key": key,
                                          "moe_out": moe_out}, strict=True)
        if "labels" in batch:
            labels, out_t = batch["labels"], out
        else:
            labels, out_t = input_ids[:, 1:], out[:, :-1]
        valid = labels >= 0
        labels_c = torch.clamp(labels, min=0).long()
        n_valid = torch.clamp(valid.sum(), min=1) if n_valid is None else n_valid
        if chunked:
            if cfg.tie_embeddings:
                w, transpose = params["embed.embedding"], True  # (V, H)
            else:
                w, transpose = params["lm_head.kernel"], False  # (H, V)
            loss = _chunked_ce(out_t, w, labels_c, valid, cfg, transpose) / n_valid
        else:
            ce = F.cross_entropy(out_t.float().flatten(0, 1), labels_c.flatten(), reduction="none")
            loss = (ce * valid.flatten()).sum() / n_valid
        if moe_out:
            aux = sum(a for a, _ in moe_out)
            loss = loss + cfg.moe_aux_loss_coef * aux * aux_share
            self.last_moe = {"aux_loss": aux.detach(),
                             "drop_frac": torch.stack([d for _, d in moe_out]).detach()}
        return loss

    # ---- ZeRO-Infinity parameter streaming --------------------------------
    # Layer-granular entry points for the param-offload runner
    # (``runtime/zero/param_offload.py``), after the JAX model's
    # ``models/transformer.py:2017-2110``: host-resident blocks stream through
    # these one at a time, on the same modules (and so the same kernels) as
    # the whole-model forward. An MoE layer's expert leaves ride its block.
    def stream_plan(self):
        """Block partition of the state dict: ``embed`` and ``tail`` keys,
        and the per-layer keys (``layers.{i}.`` stripped) of ``num_layers``
        layer blocks. A tied embedding sits in the embed block and is listed
        in ``tail`` too (one host copy; the runner sums both gradients)."""
        cfg = self.cfg
        if cfg.int8_weights:
            raise ValueError("parameter streaming trains float weights; int8_weights models serve only")
        keys = list(self.param_shapes())
        embed = [k for k in keys if k.split(".")[0] in ("embed", "embed_norm", "pos_embed")]
        tail = [k for k in keys if k.split(".")[0] in ("final_norm", "lm_head")]
        if cfg.tie_embeddings:
            tail.append("embed.embedding")
        layer = [k[len("layers.0."):] for k in keys if k.startswith("layers.0.")]
        extra = [k for k in keys if k not in embed and k not in tail and not k.startswith("layers.")]
        if extra:
            raise ValueError(f"stream_plan: unrecognized params {extra}")
        return {"embed": embed, "tail": tail, "layer": layer, "num_layers": cfg.num_layers}

    @staticmethod
    def _sub(tree, prefix):
        n = len(prefix) + 1
        return {k[n:]: v for k, v in tree.items() if k.startswith(prefix + ".")}

    def stream_embed(self, embed_tree, input_ids, position_ids=None, cache_index=None):
        """Token embedding (+ embed norm, learned positions): (B, T) ids ->
        (B, T, H) in the compute dtype."""
        cfg, mod = self.cfg, self.module
        x = embed_lookup(embed_tree["embed.embedding"], input_ids, cfg).to(cfg.dtype)
        if cfg.embed_norm:
            x = torch.func.functional_call(mod.embed_norm, self._sub(embed_tree, "embed_norm"), (x, ))
        if cfg.pos_embedding == "learned":
            if position_ids is None:
                c0 = cache_index or cfg.seq_index * input_ids.shape[1]
                pe = embed_tree["pos_embed"][c0:c0 + input_ids.shape[1]]
            else:
                pe = embed_tree["pos_embed"][position_ids]
            x = x + pe.to(cfg.dtype)
        return x

    def _rope(self, device):
        if self.cfg.pos_embedding != "rope":
            return None, None
        return self.module._rope_table(device)

    def stream_layer(self, layer_tree, h, attn_mask=None, impl="kernel", return_aux=False, dropout_key=None,
                     remat=False, moe_out=None):
        """One transformer block: ``layer_tree`` holds one layer's tensors
        under their per-layer keys. ``return_aux``: also return the MoE
        layer's load-balancing aux loss (zero for a dense block), so the
        streamed trainer can include its gradient. ``dropout_key``: this
        layer's dropout key (``fold_in`` of the micro-step's key and the
        layer index, as :meth:`loss` folds it), else no dropout. ``remat``:
        run the block under the model's remat policy when grad is on, as
        :meth:`loss` does. ``moe_out``: a list that receives the MoE layer's
        ``(aux_loss, drop_frac)``."""
        sin, cos = self._rope(h.device)
        blk = self.module.layers[0]
        if remat and self.module._remat is not None and torch.is_grad_enabled():
            y, moe = _remat_block(blk, self.module._remat, h, sin, cos, attn_mask, None, impl, dropout_key,
                                  tensors=layer_tree)
        else:
            y, _, moe = torch.func.functional_call(blk, layer_tree, (h, sin, cos, attn_mask),
                                                   {"impl": impl, "dropout_key": dropout_key}, strict=True)
        if moe is not None and moe_out is not None:
            moe_out.append(moe)
        if not return_aux:
            return y
        return y, (moe[0] if moe is not None else torch.zeros((), device=h.device))

    def stream_layer_cached(self, layer_tree, h, kv_cache, cache_index, position_ids=None, impl="kernel"):
        """One block writing into (and attending over) this layer's (k, v)
        cache at ``cache_index`` (an int shared by the rows), as the
        whole-model :meth:`apply_with_cache` does for an unpadded batch."""
        cfg = self.cfg
        B, T = h.shape[:2]
        sin, cos = self._rope(h.device)
        window = None
        if cfg.attention_impl == "flash" and T == 1:
            window = (torch.zeros((B, ), dtype=torch.int32, device=h.device),
                      torch.full((B, ), cache_index + 1, dtype=torch.int32, device=h.device))
        return torch.func.functional_call(
            self.module.layers[0], layer_tree, (h, sin, cos, None, tuple(kv_cache), int(cache_index),
                                                position_ids, window), {"impl": impl}, strict=True)[0]

    def stream_logits(self, tail_tree, h, impl="kernel"):
        """Final norm and vocab projection: (B, T, H) -> (B, T, V)."""
        cfg, mod = self.cfg, self.module
        x = torch.func.functional_call(mod.final_norm, self._sub(tail_tree, "final_norm"), (h, ))
        if cfg.tie_embeddings:
            return _float_head(x, tail_tree["embed.embedding"], None, cfg)
        sub = self._sub(tail_tree, "lm_head")
        return _float_head(x, None, lambda y, impl: torch.func.functional_call(mod.lm_head, sub, (y, ),
                                                                                {"impl": impl}), cfg, impl)

    def stream_tail_loss(self, tail_tree, h, labels, valid, shift=True, n_valid=None):
        """Final norm, vocab projection and the masked cross entropy (the
        mean over valid tokens), as :meth:`loss`. ``shift``: position t
        predicts label t (``labels`` then has T - 1 columns). ``n_valid``:
        the divisor (the global valid-token count under data parallelism),
        else this batch's count."""
        cfg = self.cfg
        n_valid = torch.clamp(valid.sum(), min=1) if n_valid is None else n_valid
        if not self._use_chunked_ce():
            logits = self.stream_logits(tail_tree, h)
            if shift:
                logits = logits[:, :-1]
            ce = F.cross_entropy(logits.float().flatten(0, 1), labels.long().flatten(), reduction="none")
            return (ce * valid.flatten()).sum() / n_valid
        x = torch.func.functional_call(self.module.final_norm, self._sub(tail_tree, "final_norm"), (h, ))
        if shift:
            x = x[:, :-1]
        if cfg.tie_embeddings:
            w, transpose = tail_tree["embed.embedding"], True
        else:
            w, transpose = tail_tree["lm_head.kernel"], False
        return _chunked_ce(x, w, labels.long(), valid, cfg, transpose) / n_valid

    # ---- pipeline parallelism ---------------------------------------------
    # The model's side of the ``pipe`` axis (the JAX model's
    # ``pipeline_loss`` / ``pipeline_value_and_grad`` / ``pipeline_pattern``,
    # ``models/transformer.py:1786-1895``) on the streaming protocol above:
    # stage 0 runs ``stream_embed``, every stage its layers through
    # :meth:`pipeline_stage`, the last ``stream_tail_loss``; the engine's
    # ``runtime/pipe/stage.py`` drives them. Embed and head stay replicated
    # over ``pipe``.
    def pipeline_pattern(self):
        """Regex of the state-dict keys placed on one stage; its group is
        the layer index (the JAX model's ``^layers/``: the stacked leading
        dim split over ``pipe``)."""
        return r"^layers\.(\d+)\."

    def pipeline_layers(self, stage, num_stages):
        """The global indices of ``stage``'s layers: layer ``i`` belongs to
        stage ``i // (L / S)``, the JAX rule (the stacked dim split
        evenly)."""
        L = self.cfg.num_layers
        if L % num_stages != 0:
            raise ValueError(f"num_layers={L} does not split evenly over pipeline_parallel_size="
                             f"{num_stages} (the JAX package splits the stacked layer dim evenly)")
        per = L // num_stages
        return range(stage * per, (stage + 1) * per)

    def pipeline_stage(self, layer_trees, h, first_layer, attn_mask=None, dropout_key=None, impl="kernel",
                       moe_out=None):
        """A stage's layers on ``h``: ``layer_trees`` yields the stage's
        layers in order (per-layer keys; an iterator may fetch each just
        before its layer runs), the first of them global layer
        ``first_layer``. Each layer's dropout key is ``fold_in`` of the
        micro-step's ``dropout_key`` and its global index, as :meth:`loss`
        folds it, so a pipelined run draws the masks of an unpipelined
        one."""
        for j, tree in enumerate(layer_trees):
            key = None if dropout_key is None else fold_in(dropout_key, first_layer + j)
            h = self.stream_layer(tree, h, attn_mask, impl=impl, dropout_key=key, remat=True, moe_out=moe_out)
        return h

    # ---- generation (KV cache) -------------------------------------------
    def quantize_params(self, params, group_size=None, dtype=None):
        """Float state dict -> the int8 serving state dict an
        ``int8_weights=True`` model expects, on the host: every projection
        kernel becomes (int8 weight, fp32 per-group scales), the vocab
        projection a padded ``logits_q``, and every other float leaf the
        compute dtype. Same grouping and rounding as the JAX package's
        ``quantize_params`` (projection kernels are quantized from their
        compute-dtype values, the head from the original ones; MoE expert
        kernels (E, K, N) per expert, with (E, G, N) scales)."""
        cfg = self.cfg
        gs_cfg = group_size if group_size is not None else (cfg.int8_group_size or 128)
        dtype = dtype or cfg.dtype

        def host(x):
            return torch.as_tensor(x).detach().cpu()

        def to_dtype(x):
            x = host(x)
            return x.to(dtype) if x.is_floating_point() else x

        def quant(w):  # (..., K, N) -> int8 (..., K, N) + (..., G, N) fp32 scales
            w = host(w).float()
            K, N = w.shape[-2:]
            gs = gs_cfg if gs_cfg and K % gs_cfg == 0 else K
            grouped = w.reshape(w.shape[:-2] + (K // gs, gs, N))
            scale = grouped.abs().amax(dim=-2, keepdim=True) / 127.0
            scale = torch.where(scale == 0, torch.ones_like(scale), scale)
            q = torch.clamp(torch.round(grouped / scale), -127, 127).to(torch.int8)
            return q.reshape(w.shape), scale[..., 0, :].contiguous()

        out = {k: to_dtype(v) for k, v in params.items() if not k.startswith("lm_head.")}

        for i in range(cfg.num_layers):
            p = f"layers.{i}."
            attn = p + "attn."
            names = ("q_proj", "k_proj", "v_proj")
            if cfg.int8_fused_qkv and all(f"{attn}{n}.kernel" in out for n in names):
                ws = [out.pop(f"{attn}{n}.kernel").float() for n in names]
                out[attn + "qkv_q"], out[attn + "qkv_scale"] = quant(torch.cat(ws, dim=-1))
                biases = [out.pop(f"{attn}{n}.bias").float() for n in names
                          if f"{attn}{n}.bias" in out]
                if biases:
                    out[attn + "qkv_bias"] = torch.cat(biases, dim=-1)
            kernels = [attn + n for n in names + ("o_proj", )]
            kernels += [f"{p}mlp.{n}" for n in ("gate_proj", "up_proj", "down_proj")]
            for base in kernels:
                if base + ".kernel" in out:
                    w = out.pop(base + ".kernel").float()
                    out[base + ".kernel_q"], out[base + ".kernel_scale"] = quant(w)
            # batched (E, K, N) expert kernels, quantized per expert; the
            # router stays in the compute dtype
            for n in ("gate_proj", "up_proj", "down_proj"):
                key = f"{p}moe.experts.{n}"
                if key in out:
                    out[key + "_q"], out[key + "_scale"] = quant(out.pop(key).float())

        H = cfg.hidden_size
        if cfg.tie_embeddings:
            head = host(params["embed.embedding"]).float().T  # (H, V)
        else:
            head = host(params["lm_head.kernel"]).float()
        head_p = torch.zeros((H, padded_vocab(cfg)), dtype=torch.float32)
        head_p[:, :cfg.vocab_size] = head
        out["logits_q"], out["logits_scale"] = quant(head_p)
        if cfg.lm_head_bias and "lm_head.bias" in params:
            out["logits_bias"] = host(params["lm_head.bias"]).float()
        return out

    def fused_decode_operands(self, params):
        """Per-layer kernel operand tuples for ``ops/decode_block.py``, from
        the int8 state dict (``quantize_params`` with ``int8_fused_qkv``).
        The int8 weights, fp32 scales and the embedding pass through by
        reference; only the small norm and bias leaves convert to fp32, and
        missing biases (rmsnorm models carry none) become zeros so the
        kernels stay uniform.

        Returns ``(layers, head)``: ``layers[i] = (norms (4, H) fp32, qkv, o,
        up, down, gate-or-None)`` with each projection a ``(w int8, scales
        fp32, bias fp32)`` tuple, and ``head`` the final-norm, embedding and
        int8 vocab-projection leaves."""
        cfg = self.cfg
        H = cfg.hidden_size
        dev = params["embed.embedding"].device

        def f32(key, n):
            v = params.get(key)
            return torch.zeros((n, ), dtype=torch.float32, device=dev) if v is None else v.float()

        def proj(base, n):
            return (params[base + ".kernel_q"], params[base + ".kernel_scale"].float(),
                    f32(base + ".bias", n))

        layers = []
        for i in range(cfg.num_layers):
            p = f"layers.{i}."
            norms = torch.stack([f32(p + "attn_norm.scale", H), f32(p + "attn_norm.bias", H),
                                 f32(p + "mlp_norm.scale", H), f32(p + "mlp_norm.bias", H)])
            Nq = params[p + "attn.qkv_q"].shape[1]
            qkv = (params[p + "attn.qkv_q"], params[p + "attn.qkv_scale"].float(),
                   f32(p + "attn.qkv_bias", Nq))
            F_ = params[p + "mlp.up_proj.kernel_q"].shape[1]
            gate = proj(p + "mlp.gate_proj", F_) if p + "mlp.gate_proj.kernel_q" in params else None
            layers.append((norms, qkv, proj(p + "attn.o_proj", H), proj(p + "mlp.up_proj", F_),
                           proj(p + "mlp.down_proj", H), gate))
        head = {"final_scale": params["final_norm.scale"].float(),
                "embed": params["embed.embedding"],
                "logits_q": params["logits_q"],
                "logits_scale": params["logits_scale"].float()}
        if "final_norm.bias" in params:
            head["final_bias"] = params["final_norm.bias"].float()
        if cfg.pos_embedding == "learned":
            head["pos_embed"] = params["pos_embed"]
        if "logits_bias" in params:
            head["logits_bias"] = params["logits_bias"].float()
        return tuple(layers), head

    def tp_rules(self):
        """Megatron row/column rules over the ``tensor`` axis by state-dict
        key (the JAX model's unscanned ``tp_rules``, on the port's 2-D
        attention kernels: q/k/v (H, heads x hd) split their columns, o
        (heads x hd, H) its rows). The ZeRO planner applies them before the
        data-parallel axes, as the JAX engine does, and
        :func:`tp_shard_params` cuts a rank's shard by them. Beyond the JAX
        rules: the int8 kernels' scale columns go with their kernel
        columns, and a column-parallel bias with its columns (the JAX
        package keeps biases whole and lets GSPMD slice them; a rank here
        holds only what its shard reads). Under ``bitwise_tp`` o_proj and
        down_proj stay whole."""
        t, e = "tensor", "expert"  # comm.TENSOR_AXIS, comm.EXPERT_AXIS
        row = (None, None) if self.cfg.bitwise_tp else (t, None)
        return [
            (r"experts\.(gate|up)_proj(_q|_scale)?$", (e, None, t)),
            (r"experts\.up_bias$", (e, t)),
            (r"experts\.down_proj(_q|_scale)?$", (e, None, None) if self.cfg.bitwise_tp else (e, t, None)),
            (r"attn\.(q|k|v)_proj\.(kernel|kernel_q|kernel_scale)$", (None, t)),
            (r"attn\.(q|k|v)_proj\.bias$", (t, )),
            (r"attn\.o_proj\.(kernel|kernel_q|kernel_scale)$", row),
            (r"mlp\.(gate|up)_proj\.(kernel|kernel_q|kernel_scale)$", (None, t)),
            (r"mlp\.(gate|up)_proj\.bias$", (t, )),
            (r"mlp\.down_proj\.(kernel|kernel_q|kernel_scale)$", row),
            (r"embed\.embedding$", (t, None)),
            (r"lm_head\.kernel$", (None, t)),
            (r"lm_head\.bias$", (t, )),
            (r"logits_(q|scale)$", (None, t)),
        ]

    def expert_pattern(self):
        """The state-dict key fragment of the expert parameters (the JAX
        model's ``expert_pattern``), None for a dense model."""
        from ..moe.layer import EXPERT_KEYS
        return EXPERT_KEYS if self.cfg.num_experts > 0 else None

    def init_cache(self, batch_size, max_len, dtype=None, device=None, quantized=False):
        """Preallocated per-layer KV cache: ``(ks, vs)``, each a tuple of
        ``(B, kv_heads, S, head_dim)`` tensors written in place.
        ``quantized``: the int8 KV tier (serving ``kv_cache_dtype: int8``),
        ``(ks, vs, scales)`` with int8 K/V and one fp16 scale per cache row,
        (B, 1, S, 1), shared by K and V across heads; scales start at 1."""
        cfg = self.cfg
        shape = (batch_size, cfg.local_kv_heads, max_len, cfg.head_size)
        L = range(cfg.num_layers)
        if quantized:
            sshape = (batch_size, 1, max_len, 1)
            return (tuple(torch.zeros(shape, dtype=torch.int8, device=device) for _ in L),
                    tuple(torch.zeros(shape, dtype=torch.int8, device=device) for _ in L),
                    tuple(torch.ones(sshape, dtype=torch.float16, device=device) for _ in L))
        dt = dtype or cfg.dtype
        return (tuple(torch.zeros(shape, dtype=dt, device=device) for _ in L),
                tuple(torch.zeros(shape, dtype=dt, device=device) for _ in L))

    def apply_with_cache(self, params, input_ids, kv_cache, cache_index, cache_mask=None,
                         position_ids=None, write_index=None, q_spans=None, impl="kernel",
                         ext_ops=None, expert_stats=False, seq_shard=False, **unported):
        """Forward writing into (and attending over) the KV cache. Returns
        (logits, kv_cache). ``cache_index``: the shared write position (an
        int); ``cache_mask``: (B, S) attendable slots. ``write_index``:
        optional (B,) per-row cache positions (the slot pool; pass
        ``position_ids`` with it); ``q_spans``: optional (B,) live query
        counts per row (the fused chunked-prefill step; columns past a row's
        span are not written). ``params`` is a state dict or a module from
        :meth:`bind`.

        ``ext_ops``: long-context extent operands ``(ext_table (B, E),
        wslot (B,), ext_base (B,), sinks (B,), windows (B,))``, int32 on the
        pool's device: ``ext_table`` maps each row's logical extent i
        (tokens ``[i*S, (i+1)*S)``) to its pool row (-1 = dropped),
        ``wslot``/``ext_base`` the pool row of the write head's extent and
        that extent's logical base, so a row writes at offset ``write_index
        - ext_base`` of pool row ``wslot``; ``write_index``, ``q_spans`` and
        ``position_ids`` stay LOGICAL. ``sinks``/``windows``: the lossy
        sliding-window mask (0 = exact). Requires the flash span path
        (``attention_impl='flash'``, ``write_index`` and ``q_spans``); other
        combinations raise ``ValueError``.

        ``expert_stats=True`` (an MoE model) also returns the per-layer
        routed-token counts, (L, E) int32 over the live columns (``q_spans``),
        as a third output.

        ``seq_shard=True``: the sequence-parallel prefill (the JAX
        package's ``seq_shard``): every rank of the mesh's ``seq`` axis runs
        the same forward, and the span attention's query columns split over
        ``seq`` and are all-gathered (bitwise the one-rank forward). It
        needs the flash span path (``write_index`` and ``q_spans``) and
        raises ``ValueError`` at tensor parallelism above 1."""
        _reject_unported_args(unported)
        args = (input_ids, cache_mask, kv_cache, 0 if write_index is not None else int(cache_index),
                position_ids)
        stats = [] if expert_stats else None
        kwargs = {"impl": impl, "write_index": write_index, "q_spans": q_spans, "ext_ops": ext_ops,
                  "expert_stats": stats, "seq_shard": bool(seq_shard)}
        if isinstance(params, nn.Module):
            out = params(*args, **kwargs)
        else:
            out = torch.func.functional_call(self.module, params, args, kwargs, strict=True)
        if expert_stats:
            if not stats:
                raise ValueError("expert_stats=True on a dense model (num_experts == 0)")
            return out + (torch.stack(stats), )
        return out

    def fused_paged_step(self, params, input_ids, kv_cache, position_ids, write_index, q_spans,
                         impl="kernel"):
        """The slot-pool step through the fused decode-layer kernels, the
        counterpart of ``apply_with_cache(params, ids, pool, 0,
        position_ids=..., write_index=..., q_spans=...)``: embeddings, then
        per layer kernel A (norm1 + [q;k;v] + bias + RoPE), the span commit
        into the pool (:func:`span_write`, int8-quantized for a 3-leaf
        pool), paged decode attention (C == 1) or paged span attention
        (C > 1), kernel C (o-proj, residual, norm2, MLP, residual); then the
        final norm in fp32 and the int8 head over all N*C positions, as the
        JAX package's ``fused_paged_step`` does. ``params``: the int8 state
        dict or its :meth:`fused_decode_operands`. Returns (logits (N, C, V)
        in the compute dtype, kv_cache), the pool written in place."""
        from ..ops.decode_block import fused_out_mlp, fused_qkv_ln
        cfg = self.cfg
        N, C = input_ids.shape
        nh, nkv, hd, H = cfg.num_heads, cfg.kv_heads, cfg.head_size, cfg.hidden_size
        layers, head = params if isinstance(params, tuple) else self.fused_decode_operands(params)
        pos_flat = position_ids.reshape(-1).clamp(max=cfg.max_seq_len - 1)
        x2d = head["embed"][input_ids.reshape(-1)]  # (N*C, H)
        if cfg.pos_embedding == "learned":
            x2d = x2d + head["pos_embed"][pos_flat].to(x2d.dtype)
        rope = None
        if cfg.pos_embedding == "rope":
            sin, cos = self.module._rope_table(input_ids.device)
            rope = (sin[pos_flat], cos[pos_flat], nh + nkv, hd)
        quant_kv = len(kv_cache) == 3
        starts = torch.zeros((N, ), dtype=torch.int32, device=input_ids.device)
        ends = (write_index + 1 if C == 1 else write_index).to(torch.int32)
        targets = span_targets(write_index, q_spans, C, kv_cache[0][0].shape[2])
        for i, (norms, qkv, o, up, down, gate) in enumerate(layers):
            layer_cache = tuple(comp[i] for comp in kv_cache)
            y = fused_qkv_ln(x2d, norms, qkv, eps=cfg.layernorm_epsilon, norm=cfg.norm, rope=rope,
                             impl=impl)
            qf, kf, vf = torch.split(y, [nh * hd, nkv * hd, nkv * hd], dim=-1)
            k = kf.reshape(N, C, nkv, hd).transpose(1, 2)
            v = vf.reshape(N, C, nkv, hd).transpose(1, 2)
            csc = None
            if quant_kv:
                ck, cv, csc = layer_cache
                kq, vq, sc_new = quantize_kv_rows(k, v)
                writes = [(ck, kq), (cv, vq), (csc, sc_new)]
            else:
                ck, cv = layer_cache
                writes = [(ck, k), (cv, v)]
            for c, val in writes:
                span_write(c, val, targets)
            if C == 1:
                out = paged_decode_attention(qf.reshape(N, nh, hd).contiguous(), ck, cv, starts, ends,
                                             block_kv=cfg.decode_block_kv, k_scale=csc, v_scale=csc,
                                             impl=impl)
                attn2d = out.to(cfg.dtype).reshape(N, nh * hd)
            else:
                q4 = qf.reshape(N, C, nh, hd).transpose(1, 2).contiguous()
                out = paged_span_attention(q4, ck, cv, starts, ends, block_kv=cfg.decode_block_kv,
                                           k_scale=csc, v_scale=csc, impl=impl)
                attn2d = out.to(cfg.dtype).transpose(1, 2).reshape(N * C, nh * hd)
            x2d = fused_out_mlp(attn2d, x2d, norms, o, up, down, activation=cfg.activation,
                                eps=cfg.layernorm_epsilon, norm=cfg.norm, gate=gate, impl=impl)
        x32 = x2d.float()
        if "final_bias" in head:  # layernorm head
            xn = F.layer_norm(x32, (H, ), head["final_scale"], head["final_bias"], cfg.layernorm_epsilon)
        else:
            xn = F.rms_norm(x32, (H, ), head["final_scale"], cfg.layernorm_epsilon)
        logits = quant_matmul(xn.to(x2d.dtype), head["logits_q"], head["logits_scale"], impl=impl)
        logits = logits.reshape(N, C, -1)[..., :cfg.vocab_size]
        if "logits_bias" in head:
            logits = logits + head["logits_bias"].to(logits.dtype)
        return logits, kv_cache


# ---------------------------------------------------------------------------
# a rank's shard over the tensor axis


def tp_shard_config(cfg, tp, bitwise):
    """``cfg`` with ``tp_shard`` set to this rank's (index, ``tp``) over the
    ``tensor`` axis (None when ``tp`` is 1: a whole model) and
    ``bitwise_tp``."""
    shard = (dist.get_rank(dist.TENSOR_AXIS), int(tp)) if tp > 1 else None
    return dataclasses.replace(cfg, tp_shard=shard, bitwise_tp=bool(bitwise))


def seq_shard_config(cfg, sp):
    """``cfg`` with ``seq_shard`` set to this rank's (index, ``sp``) over
    the ``seq`` axis (None when ``sp`` is 1: the whole sequence)."""
    shard = (dist.get_rank(dist.SEQ_AXIS), int(sp)) if sp > 1 else None
    return dataclasses.replace(cfg, seq_shard=shard)


def tp_dims(model, shapes):
    """{key: the dim split over ``tensor``, or None} for a whole-model state
    dict's ``shapes`` under ``model``'s :meth:`~CausalLMModel.tp_rules`; a
    dim the degree does not divide stays whole (the planner's rule)."""
    from ..runtime.zero.sharding import TensorParallelRules
    rules = TensorParallelRules(model.tp_rules())
    t = model.cfg.tp_size
    out = {}
    for k, shape in shapes.items():
        spec = rules.match(k, len(shape)) if t > 1 else None
        dims = [d for d, a in enumerate(spec or ()) if a == dist.TENSOR_AXIS and shape[d] % t == 0]
        out[k] = dims[0] if dims else None
    return out


def tp_shard_params(params, model):
    """A whole-model state dict sliced to this rank's shard
    (``model.cfg.tp_shard``), by :func:`tp_dims`: the int8 scale columns
    with their kernel columns. A split tensor is this rank's contiguous
    copy (a view would keep the whole tensor alive, and the kernels take
    contiguous operands); the dict itself at tp 1."""
    cfg = model.cfg
    if cfg.tp_size == 1:
        return params
    dims = tp_dims(model, {k: tuple(v.shape) for k, v in params.items()})
    return {k: v if dims[k] is None else tp_slice(torch.as_tensor(v), dims[k], cfg).clone(
        memory_format=torch.contiguous_format) for k, v in params.items()}


def tp_slice(t, dim, cfg):
    """This rank's slice of a whole tensor ``t`` along ``dim`` (a view; ``t``
    itself when ``dim`` is None)."""
    if dim is None:
        return t
    n = t.shape[dim] // cfg.tp_size
    return t.narrow(dim, cfg.tp_index * n, n)


_UNPORTED_ARGS = {
    "lora_ops": "ROADMAP Queue 1 #9, multi-LoRA",
    "expert_ops": "ROADMAP Queue 1 #9, MoE expert offload",
}


def _reject_unported_args(kwargs):
    for name, value in kwargs.items():
        if name not in _UNPORTED_ARGS:
            raise TypeError(f"apply_with_cache() got an unexpected keyword argument {name!r}")
        if value is not None and value is not False:
            raise _unported(name, _UNPORTED_ARGS[name])
