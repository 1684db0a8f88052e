"""Decoder-only transformer family, in PyTorch.

Port of ``deepspeed_tpu/models/transformer.py`` for serving: one
configurable causal LM covering the GPT-2/OPT shape (learned positions,
LayerNorm, gelu/relu) and the llama shape (RoPE, RMSNorm, SwiGLU, GQA),
with int8 weights through the hand-written quant-matmul kernel and the
flash-prefill and decode attention kernels (``ops/``).

Layers are always unrolled (``nn.ModuleList``), the form the JAX engine's
``kernel_inject`` forces; the KV cache is per-layer ``(B, kv_heads, S,
head_dim)`` tensors written in place. Weights live in a flat state dict
whose keys mirror the JAX tree (``layers.{i}.attn.q_proj.kernel``, ...) with
every kernel in matmul layout (K, N); ``models/convert.py`` carries a JAX
tree across. Modules are built on the meta device and receive their tensors
through :meth:`CausalLMModel.bind` (or ``torch.func.functional_call``).

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP item:
MoE, LoRA, alibi, local attention windows, per-row ``write_index``,
``q_spans``, ``ext_ops``, int8 KV, sequence sharding, activation
fake-quantization.
"""

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.decode_attention import decode_attention
from ..ops.flash_attention import flash_attention
from ..ops.quant_matmul import quant_matmul


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
    # systems
    dtype: Any = torch.bfloat16
    scan_layers: bool = True
    remat_policy: Optional[str] = None
    ce_chunk_size: Optional[int] = None
    attention_impl: str = "xla"  # "xla" (plain torch) | "flash" (the kernels)
    sequence_parallel_impl: str = "ulysses"  # "ulysses" | "ring"
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
        if self.local_attention_layers and self.scan_layers:
            raise ValueError("local_attention_layers (per-layer windows) requires "
                             "scan_layers=False — scanned layers share one program")

    @property
    def kv_heads(self):
        return self.num_kv_heads or self.num_heads

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
    if cfg.num_experts > 0:
        raise _unported("MoE models", "ROADMAP Queue 1 #7, MoE")
    if cfg.pos_embedding == "alibi":
        raise _unported("alibi positions", "ROADMAP Queue 1 #10, module_inject policies")
    if cfg.local_attention_layers:
        raise _unported("local attention windows", "ROADMAP Queue 1 #10, module_inject policies")
    if cfg.act_quant_bits:
        raise _unported("activation fake-quantization", "ROADMAP Queue 1 #10, compression")


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

    def forward(self, x, impl="kernel"):
        K = x.shape[-1]
        x2 = x.reshape(-1, K).to(self.dtype)
        if self.int8:
            y = _qmm2d(x2, self.kernel_q, self.kernel_scale, impl=impl)
        else:
            y = torch.matmul(x2, self.kernel.to(self.dtype))
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
    """Attention output projection consuming (B, heads, T, hd)."""

    def forward(self, x, impl="kernel"):  # (B, heads, T, hd) -> (B, T, features)
        B, n, T, d = x.shape
        return super().forward(x.transpose(1, 2).reshape(B, T, n * d), impl)


# ---------------------------------------------------------------------------
# attention


def _sdpa_plain(q, k, v, bias, dtype):
    """Plain attention in bhtd: scores in the compute dtype, fp32 softmax."""
    hd = q.shape[-1]
    scores = torch.matmul(q, k.transpose(-1, -2)).float() / math.sqrt(hd) + bias
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.matmul(probs, v)


def _cached_attention_plain(q, ck, cv, cache_index, cache_mask, dtype):
    """Grouped-query attention against a KV cache, no head expansion: query
    position i sits at cache position ``cache_index + i`` and attends every
    earlier slot that ``cache_mask`` (B, S) allows. The fallback for ragged
    (left-padded) prefill and short prompts."""
    B, nh, T, hd = q.shape
    nkv, S = ck.shape[1], ck.shape[2]
    g = nh // nkv
    qg = q.reshape(B, nkv, g, T, hd)
    scores = torch.matmul(qg, ck[:, :, None].transpose(-1, -2)).float() / math.sqrt(hd)
    qpos = cache_index + torch.arange(T, device=q.device)
    keep = torch.arange(S, device=q.device)[None, :] <= qpos[:, None]  # (T, S)
    bias = torch.where(keep, 0.0, -1e30)[None, None, None]  # (1, 1, 1, T, S)
    if cache_mask is not None:
        bias = bias + torch.where(cache_mask, 0.0, -1e30)[:, None, None, None, :]
    probs = torch.softmax(scores + bias, dim=-1).to(dtype)
    out = torch.matmul(probs, cv[:, :, None])
    return out.reshape(B, nh, T, hd)


class Attention(nn.Module):

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        H, nh, nkv, hd = cfg.hidden_size, cfg.num_heads, cfg.kv_heads, cfg.head_size
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
        self.o_proj = OutProjection(nh * hd, H, self.use_bias, cfg.dtype, i8, gs)

    def forward(self, x, sin, cos, attn_mask=None, kv_cache=None, cache_index=None,
                position_ids=None, decode_window=None, impl="kernel"):
        """``attn_mask``: without a cache (B, T) over the current tokens;
        with a cache (B, S) over cache slots (True = attendable, the left-pad
        mask of batched generation). ``decode_window``: the (start, end) rows
        of the decode kernel, computed once per forward by :class:`CausalLM`.
        Returns (out, kv_cache); the cache is written in place."""
        cfg = self.cfg
        B, T, H = x.shape
        nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.head_size
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
            else:
                pos_sin, pos_cos = sin[:T], cos[:T]
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
        if kv_cache is not None:
            if len(kv_cache) != 2:
                raise _unported("int8 KV caches", "ROADMAP Queue 2, _decode_kernel int8-KV mode")
            ck, cv = kv_cache
            ck[:, :, cache_index:cache_index + T] = k.to(ck.dtype)
            cv[:, :, cache_index:cache_index + T] = v.to(cv.dtype)
            if flash and T == 1:
                starts, ends = decode_window
                out = decode_attention(q[:, :, 0].contiguous(), ck, cv, starts, ends,
                                       block_kv=cfg.decode_block_kv, impl=impl)[:, :, None]
            elif flash and attn_mask is None and T >= 128 and cache_index == 0:
                # unpadded prefill: nothing earlier in the cache, so attention
                # over the current tokens only (GQA-native flash kernel)
                out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                                      impl=impl)
            else:
                out = _cached_attention_plain(q, ck, cv, cache_index, attn_mask, cfg.dtype)
            out = out.to(cfg.dtype)
            new_cache = kv_cache
        else:
            new_cache = None
            if flash and T >= 128 and attn_mask is None:
                out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
                                      impl=impl)
            else:
                if nkv != nh:
                    k = k.repeat_interleave(nh // nkv, dim=1)
                    v = v.repeat_interleave(nh // nkv, dim=1)
                keep = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
                bias = torch.where(keep, 0.0, -1e30)[None, None]
                if attn_mask is not None:
                    bias = bias + torch.where(attn_mask, 0.0, -1e30)[:, None, None, :]
                out = _sdpa_plain(q, k, v, bias, cfg.dtype)
        return self.o_proj(out, impl), new_cache


class MLP(nn.Module):

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        H, Fs = cfg.hidden_size, cfg.ffn_size
        bias = cfg.norm == "layernorm"
        i8, gs = cfg.int8_weights, cfg.int8_group_size
        if cfg.activation in ("swiglu", "geglu"):
            self.gate_proj = QuantDense(H, Fs, bias, cfg.dtype, i8, gs)
        self.up_proj = QuantDense(H, Fs, bias, cfg.dtype, i8, gs)
        self.down_proj = QuantDense(Fs, H, bias, cfg.dtype, i8, gs)

    def forward(self, x, impl="kernel"):
        act = self.cfg.activation
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
        return self.down_proj(h, impl)


class Block(nn.Module):

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = make_norm(cfg)
        self.attn = Attention(cfg)
        self.mlp_norm = make_norm(cfg)
        self.mlp = MLP(cfg)

    def forward(self, x, sin, cos, attn_mask=None, kv_cache=None, cache_index=None,
                position_ids=None, decode_window=None, impl="kernel"):
        h, new_cache = self.attn(self.attn_norm(x), sin, cos, attn_mask, kv_cache, cache_index,
                                 position_ids, decode_window, impl)
        if self.cfg.parallel_residual:
            return x + h + self.mlp(self.mlp_norm(x), impl), new_cache
        x = x + h
        return x + self.mlp(self.mlp_norm(x), impl), new_cache


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
        H = cfg.hidden_size
        self.embed = Embed(cfg.vocab_size, H)
        if cfg.embed_norm:
            self.embed_norm = make_norm(cfg)
        if cfg.pos_embedding == "learned":
            self.register_buffer("pos_embed", _meta(cfg.max_seq_len, H))
        self.layers = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.final_norm = make_norm(cfg)
        if cfg.int8_weights:
            Vpad = padded_vocab(cfg)
            self.register_buffer("logits_q", _meta(H, Vpad, dtype=torch.int8))
            self.register_buffer("logits_scale", _meta(_q_groups(H, cfg.int8_group_size), Vpad))
            if cfg.lm_head_bias:
                self.register_buffer("logits_bias", _meta(cfg.vocab_size))
        elif not cfg.tie_embeddings:
            self.lm_head = QuantDense(H, cfg.vocab_size, cfg.lm_head_bias, cfg.dtype)
        self._rope = {}

    def _rope_table(self, device):
        key = str(device)
        if key not in self._rope:
            cfg = self.cfg
            self._rope[key] = rope_table(cfg.rotary_dim or cfg.head_size, cfg.max_seq_len,
                                         cfg.rope_theta, device=device)
        return self._rope[key]

    def forward(self, input_ids, attn_mask=None, kv_cache=None, cache_index=None,
                position_ids=None, impl="kernel"):
        """``kv_cache``: ``(ks, vs)``, per-layer (B, kv_heads, S, hd) caches
        written in place. Returns logits, or (logits, kv_cache) with a cache.
        ``impl="plain"`` routes every kernel to its plain version (the
        on-card check that the kernel path computes the same logits)."""
        cfg = self.cfg
        B, T = input_ids.shape
        x = self.embed.embedding[input_ids].to(cfg.dtype)
        if cfg.embed_norm:
            x = self.embed_norm(x)
        if cfg.pos_embedding == "learned":
            if position_ids is not None:
                x = x + self.pos_embed[position_ids].to(cfg.dtype)
            else:
                c0 = cache_index or 0
                x = x + self.pos_embed[c0:c0 + T].to(cfg.dtype)
        sin = cos = None
        if cfg.pos_embedding == "rope":
            sin, cos = self._rope_table(input_ids.device)
        decode_window = None
        if kv_cache is not None and T == 1 and cfg.attention_impl == "flash":
            # the decode kernel's per-row windows, once for all layers
            if attn_mask is not None:
                starts = torch.argmax(attn_mask.to(torch.int32), dim=1).to(torch.int32)
            else:
                starts = torch.zeros((B, ), dtype=torch.int32, device=input_ids.device)
            ends = torch.full((B, ), cache_index + 1, dtype=torch.int32, device=input_ids.device)
            decode_window = (starts, ends)

        for i, blk in enumerate(self.layers):
            layer_cache = None if kv_cache is None else tuple(comp[i] for comp in kv_cache)
            x, _ = blk(x, sin, cos, attn_mask, layer_cache, cache_index, position_ids,
                       decode_window, impl)

        x = self.final_norm(x)
        if cfg.int8_weights:
            # one int8 vocab projection covers tied and untied heads
            logits = _qmm2d(x.reshape(B * T, cfg.hidden_size), self.logits_q, self.logits_scale,
                            impl=impl)
            logits = logits.reshape(B, T, -1)[..., :cfg.vocab_size]
            if cfg.lm_head_bias:
                logits = logits + self.logits_bias.to(logits.dtype)
        elif cfg.tie_embeddings:
            logits = torch.matmul(x, self.embed.embedding.to(cfg.dtype).T)
        else:
            logits = self.lm_head(x)
        if kv_cache is not None:
            return logits, kv_cache
        return logits


def _init_leaf(name, shape, dtype, gen):
    """flax initializers by parameter name: norm scales and int8 scales
    ones, biases and int8 weights zeros, everything else normal(0.02)."""
    leaf = name.rsplit(".", 1)[-1]
    if dtype == torch.int8:
        return torch.zeros(shape, dtype=torch.int8)
    if leaf in ("scale", "kernel_scale", "qkv_scale", "logits_scale"):
        return torch.ones(shape, dtype=torch.float32)
    if leaf in ("bias", "qkv_bias", "logits_bias"):
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

    # ---- generation (KV cache) -------------------------------------------
    def quantize_params(self, params, group_size=None, dtype=None):
        """Float state dict -> the int8 serving state dict an
        ``int8_weights=True`` model expects, on the host: every projection
        kernel becomes (int8 weight, fp32 per-group scales), the vocab
        projection a padded ``logits_q``, and every other float leaf the
        compute dtype. Same grouping and rounding as the JAX package's
        ``quantize_params`` (projection kernels are quantized from their
        compute-dtype values, the head from the original ones)."""
        cfg = self.cfg
        gs_cfg = group_size if group_size is not None else (cfg.int8_group_size or 128)
        dtype = dtype or cfg.dtype

        def host(x):
            return torch.as_tensor(x).detach().cpu()

        def to_dtype(x):
            x = host(x)
            return x.to(dtype) if x.is_floating_point() else x

        def quant(w):  # (K, N) -> int8 (K, N) + (G, N) fp32 scales
            w = host(w).float()
            K, N = w.shape
            gs = gs_cfg if gs_cfg and K % gs_cfg == 0 else K
            grouped = w.reshape(K // gs, gs, N)
            scale = grouped.abs().amax(dim=1, keepdim=True) / 127.0
            scale = torch.where(scale == 0, torch.ones_like(scale), scale)
            q = torch.clamp(torch.round(grouped / scale), -127, 127).to(torch.int8)
            return q.reshape(K, N), scale[:, 0, :].contiguous()

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

    def init_cache(self, batch_size, max_len, dtype=None, device=None):
        """Preallocated per-layer KV cache: ``(ks, vs)``, each a tuple of
        ``(B, kv_heads, S, head_dim)`` tensors written in place."""
        cfg = self.cfg
        shape = (batch_size, cfg.kv_heads, max_len, cfg.head_size)
        dt = dtype or cfg.dtype
        return (tuple(torch.zeros(shape, dtype=dt, device=device) for _ in range(cfg.num_layers)),
                tuple(torch.zeros(shape, dtype=dt, device=device) for _ in range(cfg.num_layers)))

    def apply_with_cache(self, params, input_ids, kv_cache, cache_index, cache_mask=None,
                         position_ids=None, impl="kernel", **unported):
        """Forward writing into (and attending over) the KV cache. Returns
        (logits, kv_cache). ``cache_index``: the shared write position (an
        int); ``cache_mask``: (B, S) attendable slots. ``params`` is a state
        dict or a module from :meth:`bind`."""
        _reject_unported_args(unported)
        args = (input_ids, cache_mask, kv_cache, int(cache_index), position_ids)
        if isinstance(params, nn.Module):
            return params(*args, impl=impl)
        return torch.func.functional_call(self.module, params, args, {"impl": impl}, strict=True)


_UNPORTED_ARGS = {
    "write_index": "ROADMAP Queue 1 #5, continuous batching",
    "q_spans": "ROADMAP Queue 1 #5, continuous batching",
    "lora_ops": "ROADMAP Queue 1 #9, multi-LoRA",
    "expert_ops": "ROADMAP Queue 1 #9, MoE serving",
    "expert_stats": "ROADMAP Queue 1 #9, MoE serving",
    "ext_ops": "ROADMAP Queue 1 #9, long context",
    "seq_shard": "ROADMAP Queue 1 #9, long context",
}


def _reject_unported_args(kwargs):
    for name, value in kwargs.items():
        if name not in _UNPORTED_ARGS:
            raise TypeError(f"apply_with_cache() got an unexpected keyword argument {name!r}")
        if value is not None and value is not False:
            raise _unported(name, _UNPORTED_ARGS[name])
