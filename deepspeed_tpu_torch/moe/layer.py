"""MoE layer.

Port of ``deepspeed_tpu/moe/layer.py`` (reference ``deepspeed/moe/layer.py``
``MoE`` :16 and ``experts.py`` ``Experts`` :10). The JAX package computes
its experts with XLA (dequantize, then ``einsum``) and its gate as a plain
matmul, so here they are ``torch.matmul``: one matmul per expert, at a
shape that does not depend on how the experts are split.

Expert parallelism follows the ``expert`` axis of the ``comm`` mesh. With
ep > 1 dividing ``num_experts`` each rank holds the E/ep experts
``cfg.moe_local_experts`` names (``(first, count)``, set by the engines
through :func:`shard_config`; :func:`shard_params` slices a full state
dict to them):

- training (:meth:`MoE.forward`): the capacity-buffered dispatch of
  :func:`~deepspeed_tpu_torch.moe.sharded_moe.top_k_gating` over the
  global batch, then an all-to-all over ``expert`` (split the expert
  axis, concatenate the capacity axis) to the ranks that hold the experts,
  the FFNs, and the all-to-all back. Its backward already sums each
  expert's gradient over the tokens of every rank of the expert group;
  the engine then sums expert gradients over ``data`` only;
- serving (:meth:`MoE.serving`): each rank computes its experts on every
  token, the outputs are all-gathered in expert order (a concatenation),
  and the fp32 combine walks the experts in increasing index, so ep > 1
  is bitwise ep = 1. The router and expert products run in blocks of
  ``SERVE_ROWS`` rows, so a token's output does not depend on the step's
  width or on the other rows (a decode token rides a chunk step bitwise).

A count that ep does not divide keeps every expert on every rank (the
replicated fallback): no exchange, expert gradients summed like the
dense ones.

Tensor parallelism (``cfg.tp_shard``) splits each expert's gate/up
columns over ``tensor`` (``(e, None, t)``). Serving (``bitwise_tp``)
all-gathers the activation before a whole down_proj, a concatenation, so
tp > 1 is bitwise tp 1 (the JAX ``expert_ffn``'s re-replication); training
runs this rank's down_proj rows and sums the outputs over ``tensor``
before the bias. ep x tp composes: the tensor exchange happens inside an
expert's FFN, the expert exchange around it.
"""

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import comm as dist
from .sharded_moe import top_k_gating, top_k_serving_weights

GLU = ("swiglu", "geglu")
# serving runs the router and expert products in blocks of this many rows,
# so a token's bits are the same at every step width (decode, chunk, verify)
SERVE_ROWS = 64


def expert_parallel(num_experts):
    """(ep, sharded): the live ``expert`` axis size, and whether it splits
    ``num_experts`` (else the replicated fallback)."""
    if not dist.is_initialized():
        return 1, False
    ep = dist.get_world_size(dist.EXPERT_AXIS)
    return ep, ep > 1 and num_experts % ep == 0


def shard_config(cfg):
    """``cfg`` with ``moe_local_experts`` set to this rank's slice of the
    experts when the expert axis splits them, else unchanged."""
    if cfg.num_experts == 0:
        return cfg
    ep, sharded = expert_parallel(cfg.num_experts)
    if not sharded:
        return dataclasses.replace(cfg, moe_local_experts=None)
    n = cfg.num_experts // ep
    return dataclasses.replace(cfg, moe_local_experts=(dist.get_rank(dist.EXPERT_AXIS) * n, n))


EXPERT_KEYS = "moe.experts."  # the state-dict key fragment of expert parameters


def is_expert_key(key):
    return EXPERT_KEYS in key


def shard_params(params, cfg):
    """A full state dict sliced to the experts ``cfg.moe_local_experts``
    names (views; a dict without them is returned as is)."""
    if not cfg.moe_local_experts:
        return params
    first, n = cfg.moe_local_experts
    out = {}
    for k, v in params.items():
        if is_expert_key(k) and v.shape[0] == cfg.num_experts:
            v = v[first:first + n]
        out[k] = v
    return out


def _deq(q, s, dtype):
    """Dequantize int8 expert kernels (..., K, N) with per-group scales
    (..., G, N): both cast to ``dtype`` and multiplied there, as the JAX
    package's ``_deq`` does."""
    k, n = q.shape[-2:]
    G = s.shape[-2]
    lead = q.shape[:-2]
    return (q.to(dtype).reshape(lead + (G, k // G, n)) * s.to(dtype)[..., :, None, :]).reshape(lead + (k, n))


def _in_blocks(fn, x, rows):
    """``fn`` over ``x``'s rows in blocks of ``rows`` (the last padded with
    zeros), concatenated: every block is one product of the same shape,
    so a row's bits do not depend on how many rows come with it (a library
    picks its routine, and so its order of summation, by shape). ``rows``
    None: one call on all of ``x``."""
    M = x.shape[0]
    if rows is None:
        return fn(x)
    pad = -M % rows
    if pad:
        x = torch.cat([x, x.new_zeros((pad, ) + x.shape[1:])])
    return torch.cat([fn(b) for b in x.split(rows)])[:M]


def expert_kernels(kernels, e, dtype):
    """Expert ``e``'s (K, N) kernels in ``dtype`` (int8 ones dequantized,
    one expert at a time) and its biases, from the leaf-name dict of
    :class:`Experts` (fp ``{gate,up,down}_proj`` (E, K, N) or their int8
    ``*_q``/``*_scale`` pairs, optional ``up_bias`` and ``down_bias``)."""
    out = {}
    for name in ("gate_proj", "up_proj", "down_proj"):
        if name + "_q" in kernels:
            out[name] = _deq(kernels[name + "_q"][e], kernels[name + "_scale"][e], dtype)
        elif name in kernels:
            out[name] = kernels[name][e].to(dtype)
    for name in ("up_bias", "down_bias"):
        if name in kernels:
            out[name] = kernels[name][e]
    return out


def expert_ffn(x, kern, activation, dtype, rows=None, tp=None):
    """One expert's FFN on its token rows ``x`` (M, H) (the JAX package's
    ``expert_ffn`` for one expert), ``kern`` from :func:`expert_kernels`.
    ``rows``: run in fixed blocks of that many rows (:func:`_in_blocks`).
    ``tp``: None, ``"gather"`` (the ffn-sharded activation all-gathered
    before a whole down_proj) or ``"reduce"`` (a row-parallel down_proj
    summed over ``tensor`` before the bias)."""

    def ffn(x):
        if activation in GLU:
            g = torch.matmul(x, kern["gate_proj"])
            u = torch.matmul(x, kern["up_proj"])
            h = (F.silu(g) if activation == "swiglu" else F.gelu(g, approximate="tanh")) * u
        else:
            h = torch.matmul(x, kern["up_proj"])
            if "up_bias" in kern:
                h = h + kern["up_bias"].to(h.dtype)
            h = F.gelu(h, approximate="tanh") if activation == "gelu" else F.relu(h)
        if tp == "gather":
            h = dist.gather_from_region(h)
        out = torch.matmul(h, kern["down_proj"])
        if tp == "reduce":
            out = dist.reduce_from_region(out)
        if "down_bias" in kern:
            out = out + kern["down_bias"].to(out.dtype)
        return out

    return _in_blocks(ffn, x.to(dtype), rows)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


class Experts(nn.Module):
    """Batched expert FFN weights, (E, H, F) and (E, F, H) in fp32, or
    int8 (E, K, N) with fp32 scales (E, G, N) from ``quantize_params``;
    E is this rank's count. ``moe_expert_bias`` adds ``down_bias`` (E, H)
    and, without a gate, ``up_bias`` (E, F)."""

    def __init__(self, cfg, count):
        super().__init__()
        H, Fs = cfg.hidden_size, cfg.local_ffn
        Fd = Fs if cfg.tp_mode == "reduce" else cfg.ffn_size  # down_proj's rows
        gs = cfg.int8_group_size or 128
        for name, k, n in (("gate_proj", H, Fs), ("up_proj", H, Fs), ("down_proj", Fd, H)):
            if cfg.int8_weights:
                G = k // gs if k % gs == 0 else 1
                self.register_buffer(name + "_q", _meta(count, k, n, dtype=torch.int8))
                self.register_buffer(name + "_scale", _meta(count, G, n))
            else:
                self.register_buffer(name, _meta(count, k, n))
        if cfg.moe_expert_bias:
            self.register_buffer("down_bias", _meta(count, H))
            if cfg.activation not in GLU:
                self.register_buffer("up_bias", _meta(count, Fs))

    def kernels(self):
        return dict(self.named_buffers())


class MoE(nn.Module):
    """Top-k routed MoE FFN: the router ``gate`` (H, E) and the
    ``experts``."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        count = cfg.moe_local_experts[1] if cfg.moe_local_experts else cfg.num_experts
        self.register_buffer("gate", _meta(cfg.hidden_size, cfg.num_experts))
        self.experts = Experts(cfg, count)

    def _logits(self, tokens, rows=None):
        gate = self.gate.float()
        return _in_blocks(lambda t: torch.matmul(t, gate), tokens.float(), rows)

    def forward(self, x):
        """Training: ``x`` (B, T, H) -> (output, aux_loss, drop_frac)
        through the capacity-buffered dispatch over the global batch (under
        ``seq``, ``x`` is this rank's chunk of each row)."""
        cfg = self.cfg
        B, T, H = x.shape
        tokens = x.reshape(B * T, H)
        # the global batch: the data axes' rows, and under seq each row's chunks
        group = dist.DP_AXES + ((dist.SEQ_AXIS, ) if cfg.seq_size > 1 else ())
        dispatch, combine, aux, drop = top_k_gating(self._logits(tokens), cfg.moe_top_k,
                                                    cfg.moe_capacity_factor, group=group, rows=B)
        N, E, C = dispatch.shape
        expert_in = torch.matmul(dispatch.to(cfg.dtype).reshape(N, E * C).T, tokens.to(cfg.dtype))
        expert_in = expert_in.reshape(E, C, H)
        sharded = cfg.moe_local_experts is not None
        if sharded:  # (E, C, H) -> (E/ep, ep*C, H): this rank's experts, every rank's slots
            expert_in = dist.AllToAll.apply(expert_in, dist.EXPERT_AXIS, 0, 1)
        tp = cfg.tp_mode
        if tp is not None:  # the column-parallel gate/up see the whole slots
            expert_in = dist.copy_to_region(expert_in)
        kernels = self.experts.kernels()
        expert_out = torch.stack([expert_ffn(expert_in[i], expert_kernels(kernels, i, cfg.dtype),
                                             cfg.activation, cfg.dtype, tp=tp)
                                  for i in range(expert_in.shape[0])])
        if sharded:  # back to (E, C, H), this rank's slots of every expert
            expert_out = dist.AllToAll.apply(expert_out, dist.EXPERT_AXIS, 1, 0)
        out = torch.matmul(combine.to(cfg.dtype).reshape(N, E * C), expert_out.reshape(E * C, H))
        return out.reshape(B, T, H), aux, drop

    def serving(self, x, q_spans=None, stats=None):
        """Serving: per-token capacity-free top-k (``x`` (B, T, H) ->
        (B, T, H)). ``q_spans``: per-row live query counts (the routed
        counts skip padding columns); ``stats``: a list that receives this
        layer's (E,) int32 routed-token counts."""
        cfg = self.cfg
        B, T, H = x.shape
        N, E = B * T, cfg.num_experts
        tokens = x.reshape(N, H)
        weights = top_k_serving_weights(self._logits(tokens, SERVE_ROWS), cfg.moe_top_k)  # (N, E) fp32
        if stats is not None:
            if q_spans is not None:
                valid = (torch.arange(T, device=x.device)[None, :] < q_spans[:, None]).reshape(N)
            else:
                valid = torch.ones((N, ), dtype=torch.bool, device=x.device)
            stats.append(((weights > 0) & valid[:, None]).sum(0, dtype=torch.int32))
        kernels = self.experts.kernels()
        count = next(iter(kernels.values())).shape[0]
        outs = [expert_ffn(tokens, expert_kernels(kernels, i, cfg.dtype), cfg.activation, cfg.dtype,
                           SERVE_ROWS, tp=cfg.tp_mode) for i in range(count)]
        if cfg.moe_local_experts is not None:  # every rank's experts, in expert order
            outs = list(dist.all_gather(torch.stack(outs), group=dist.EXPERT_AXIS).unbind(0))
        # a fixed increasing-expert-index walk: every split of the experts
        # adds in the same order
        acc = torch.zeros((N, H), dtype=torch.float32, device=x.device)
        for e in range(E):
            acc = acc + weights[:, e:e + 1] * outs[e].float()
        return acc.to(cfg.dtype).reshape(B, T, H)
