"""Inference engine: static-batch ``generate()`` over a preallocated KV cache.

Port of ``deepspeed_tpu/inference/engine.py`` (reference
``inference/engine.py``, ``InferenceEngine``) for one device and
tensor-parallel degree 1:

- kernel injection selects the model's kernel paths (``attention_impl=
  'flash'``: flash prefill and the decode-attention kernel; int8 weights
  through the quant-matmul kernel) and unrolls the layers;
- ``dtype='int8'`` quantizes the weights on the host before the first copy
  to the device, and computes in bf16;
- the JAX decode ``while_loop`` becomes an eager Python loop that stops when
  every row is done; the KV cache is written in place and pooled per
  (batch, cache length) across calls.

Batched generation follows the JAX engine: a uniform batch is right-padded
to the 64-token prompt bucket and decoding starts at the true length (no
cache mask, so a prompt of >= 128 tokens prefills through the flash
kernel); a ragged batch is left-padded so every row shares one write head,
with per-row positions and a left-pad cache mask.
"""

import dataclasses

import numpy as np
import torch

from ..utils.logging import logger, log_dist
from .config import DeepSpeedInferenceConfig


def _round_up(x, m):
    return (x + m - 1) // m * m


def _sample_tokens(gen, logits, do_sample, temperature, top_k, top_p):
    """Greedy or filtered sampling. logits: (B, V) fp32; ``gen`` is the
    request's ``torch.Generator`` (the JAX engine's rng key)."""
    if not do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p (always >= 1 token)
        keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool), cum[:, :-1] < top_p], dim=-1)
        threshold = torch.where(keep, sorted_logits, float("inf")).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < threshold, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


class FusedDecodeEligibility:
    """Structured result of the fused decode-block gate
    (:meth:`InferenceEngine._fused_decode_eligible`): truthy iff the decode
    loop could use the fused decode-block kernels; otherwise ``reasons``
    names every failing condition."""
    __slots__ = ("eligible", "reasons")

    def __init__(self, reasons=()):
        self.reasons = tuple(reasons)
        self.eligible = not self.reasons

    def __bool__(self):
        return self.eligible

    def __repr__(self):
        return (f"FusedDecodeEligibility(eligible={self.eligible}, "
                f"reasons={list(self.reasons)})")


def resolve_device(device):
    """``None`` means the card. Without one this raises: the engine never
    drops to the CPU unless the caller asks for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_inference: no CUDA device is available; pass device='cpu' "
                           "to run the kernels' plain versions on the host")
    return device


class InferenceEngine:
    """Wraps a zoo model (or preset name) for single-device generation."""

    def __init__(self, model, config=None, params=None, device=None):
        self._construct(model, config, params, device)

    def _construct(self, model, config, params, device):
        self._config = config if isinstance(config, DeepSpeedInferenceConfig) else \
            DeepSpeedInferenceConfig(dict(config or {}))
        cfg = self._config
        self.device = resolve_device(device)

        if isinstance(model, str):
            from ..models import get_model
            model = get_model(model)
        if not hasattr(model, "cfg") or not hasattr(model, "apply_with_cache"):
            raise ValueError("init_inference expects a deepspeed_tpu_torch model (CausalLMModel or "
                             f"preset name); got {type(model)}")

        # dtype 'int8' means int8 weights + bf16 compute: the memory-bound
        # decode loop reads half the weight bytes through the quant matmul
        self._int8_weights = cfg.dtype == torch.int8
        compute_dtype = torch.bfloat16 if self._int8_weights else cfg.dtype
        overrides = {"dtype": compute_dtype, "decode_block_kv": cfg.decode_block_kv}
        if self._int8_weights:
            # fused [q;k;v] int8 matmul: tensor parallelism is 1 in the port
            overrides["int8_weights"] = True
            overrides["int8_fused_qkv"] = True
        if cfg.kernel_inject:
            overrides["attention_impl"] = "flash"
            overrides["scan_layers"] = False
        self.module = type(model)(dataclasses.replace(model.cfg, **overrides))
        self.model_config = self.module.cfg

        if self._int8_weights and cfg.fused_decode_block:
            gate = self._fused_decode_eligible()
            if gate:
                raise NotImplementedError(
                    "init_inference(int8): this config selects the fused decode block "
                    "(_qkv_ln_kernel + _out_mlp_kernel), which deepspeed_tpu_torch has not "
                    "ported yet (ROADMAP Queue 2, next slice); set fused_decode_block: False "
                    "to serve through the per-projection kernels")
            logger.warning("init_inference(int8): fused decode-block disabled — "
                           + "; ".join(gate.reasons))

        self.params = self._materialize_params(params)
        self.net = self.module.bind(self.params)
        self._cache_pool = {}  # (B, S) -> reusable KV cache buffers
        log_dist(f"InferenceEngine ready: model dtype={self.model_config.dtype} device={self.device} "
                 f"tp=1 int8_weights={self._int8_weights} kernel_inject={cfg.kernel_inject} "
                 f"max_out_tokens={cfg.max_out_tokens}", [0])

    # ------------------------------------------------------------------ params
    def _materialize_params(self, params):
        """Random init (seed 0) or the given state dict; int8 quantizes on the
        host BEFORE the copy to the device (the float weights never reach it)."""
        if params is None:
            logger.warning("init_inference: no params given; initializing random weights")
            init_cfg = dataclasses.replace(self.model_config, int8_weights=False)
            params = type(self.module)(init_cfg).init_params(0)
        if self._int8_weights:
            params = self.module.quantize_params(params)
        dtype = self.model_config.dtype
        out = {}
        for k, v in params.items():
            v = torch.as_tensor(v)
            if v.is_floating_point() and not self._int8_weights:
                v = v.to(dtype)
            out[k] = v.to(self.device)
        return out

    # ------------------------------------------------------------------ generate
    def _fused_decode_eligible(self):
        """Structured gate for the fused per-layer decode kernels (the JAX
        package's ``ops/pallas/decode_block.py``), with the JAX engine's
        reason strings. The port has no fused kernels yet: an eligible int8
        config is refused at construction."""
        mc = self.model_config
        reasons = []

        if not getattr(mc, "int8_weights", False):
            reasons.append("dtype is not int8 (the fused kernels stream "
                           "int8 weights)")
        elif not getattr(mc, "int8_fused_qkv", False):
            reasons.append("int8_fused_qkv=off")
        if getattr(mc, "scan_layers", True) is not False:
            reasons.append("scan_layers=True (the fused path needs "
                           "per-layer unrolled caches; enable kernel_inject)")
        if getattr(mc, "num_experts", 0) > 0:
            reasons.append(
                f"num_experts={mc.num_experts}: the fused per-layer decode "
                f"kernel has no expert dispatch; serving the per-projection "
                f"MoE path")
        if getattr(mc, "parallel_residual", False):
            reasons.append("parallel_residual=True (the fused out/mlp kernel "
                           "computes the sequential residual)")
        if getattr(mc, "norm", "") not in ("layernorm", "rmsnorm"):
            reasons.append(f"norm={getattr(mc, 'norm', '?')} (fused kernels "
                           f"support layernorm/rmsnorm)")
        if getattr(mc, "embed_norm", False):
            reasons.append("embed_norm=True (no fused embedding norm)")
        if mc.pos_embedding not in ("learned", "none", "rope"):
            reasons.append(f"pos_embedding={mc.pos_embedding}: no in-kernel "
                           f"alibi bias")
        elif (mc.pos_embedding == "rope"
              and (mc.rotary_dim or 0) not in (0, mc.head_size)):
            reasons.append(
                f"partial rotary (rotary_dim={mc.rotary_dim} < head_size="
                f"{mc.head_size}): the in-kernel rotation is full-head only")
        if mc.activation not in ("gelu", "gelu_exact", "quick_gelu", "relu",
                                 "swiglu", "geglu"):
            reasons.append(f"activation={mc.activation} not in the fused "
                           f"out/mlp kernel's set")
        if getattr(mc, "attn_scale", None) is not None:
            reasons.append(f"attn_scale={mc.attn_scale} (fused attention "
                           f"uses the default 1/sqrt(head_size))")
        if getattr(mc, "local_attention_layers", ()):
            reasons.append("local-attention layers (the fused path has no "
                           "per-layer sliding-window starts)")
        if getattr(mc, "act_quant_bits", 0):
            reasons.append(f"act_quant_bits={mc.act_quant_bits} (no fused "
                           f"fake-quant of block inputs)")
        gs = getattr(mc, "int8_group_size", 0) or 128
        # effective group per contraction dim: quantize_params uses gs
        # only when it divides K, else the whole dim is one group
        dims = (mc.hidden_size,                      # qkv / up K
                mc.num_heads * mc.head_size,         # o-proj K
                getattr(mc, "ffn_size", 4 * mc.hidden_size))  # down K
        bad = [k for k in dims if (gs if k % gs == 0 else k) > 1024]
        if bad:
            reasons.append(
                f"int8 group spans {max(bad)} > 1024 on a contraction dim "
                f"(group_size={gs}): the weight block would exceed VMEM")
        tp = self._config.tensor_parallel.tp_size
        if tp != 1:
            reasons.append(f"tensor={tp}: the fused kernels are opaque "
                           f"to GSPMD; tp decodes per-projection")
        if not self._config.fused_decode_block:
            reasons.append("fused_decode_block=False in config")
        return FusedDecodeEligibility(reasons)

    def generate(self, input_ids, max_new_tokens=64, do_sample=False, temperature=1.0, top_k=0,
                 top_p=1.0, eos_token_id=None, pad_token_id=0, seed=0):
        """Batched generation. ``input_ids``: list of token lists or (B, P)
        array. Returns a list of 1-D np arrays of *new* tokens per row
        (trimmed at ``eos_token_id``)."""
        buf, trim = self._generate_raw(input_ids, max_new_tokens=max_new_tokens,
                                       do_sample=do_sample, temperature=temperature,
                                       top_k=top_k, top_p=top_p, eos_token_id=eos_token_id,
                                       pad_token_id=pad_token_id, seed=seed)
        return trim(buf.cpu().numpy())

    def _generate_raw(self, input_ids, max_new_tokens=64, do_sample=False, temperature=1.0,
                      top_k=0, top_p=1.0, eos_token_id=None, pad_token_id=0, seed=0):
        """Run one generate; returns (device buf, trim(host_buf) -> per-row
        new-token arrays). The KV cache returns to the pool."""
        rows = [np.asarray(r, np.int32).reshape(-1) for r in input_ids]
        B = len(rows)
        lens = np.array([len(r) for r in rows], np.int32)
        if lens.min() < 1:
            raise ValueError("generate() requires at least one prompt token per row")
        P = int(_round_up(lens.max(), 64))
        # cache length: multiple of the decode-kernel KV block (or of 64 when
        # the whole cache fits in one block)
        block = self._config.decode_block_kv
        S = int(_round_up(P + max_new_tokens, 64))
        if S > block:
            S = int(_round_up(S, block))
        if S > self.model_config.max_seq_len:
            raise ValueError(f"prompt+max_new_tokens needs cache of {S} > model max_seq_len "
                             f"{self.model_config.max_seq_len}")
        if S > self._config.max_out_tokens:
            raise ValueError(f"prompt+max_new_tokens needs cache of {S} tokens > max_out_tokens="
                             f"{self._config.max_out_tokens}; raise max_out_tokens")
        padded = bool((lens != lens[0]).any())
        ids = np.full((B, P), pad_token_id, np.int32)
        if padded:  # ragged: left-pad so all rows share one write head
            pads = P - lens
            for i, r in enumerate(rows):
                ids[i, pads[i]:] = r
            W = P
        else:  # uniform: right-pad the bucket; decode starts at the true length
            pads = np.zeros(B, np.int32)
            for i, r in enumerate(rows):
                ids[i, :lens[i]] = r
            W = int(lens[0])

        # reuse pooled cache buffers: stale contents are never attended (the
        # causal window and the per-row cache mask gate every slot)
        cache = self._cache_pool.pop((B, S), None)
        if cache is None:
            cache = self._init_cache(B, S)
        buf = self._decode(cache, ids, pads, padded, S, W, max_new_tokens, do_sample, temperature,
                           top_k, top_p, eos_token_id, pad_token_id, seed)
        self._cache_pool[(B, S)] = cache
        while len(self._cache_pool) > 2:  # bound device memory held by idle cache buckets
            self._cache_pool.pop(next(iter(self._cache_pool)))

        def trim(host_buf):
            host_buf = host_buf[:, :max_new_tokens]
            out = []
            for i in range(B):
                row = host_buf[i]
                if eos_token_id is not None:
                    hits = np.nonzero(row == eos_token_id)[0]
                    if hits.size:
                        row = row[:hits[0] + 1]
                out.append(row)
            return out
        return buf, trim

    @torch.inference_mode()
    def _decode(self, cache, ids, pads, padded, S, W, max_new, do_sample, temperature, top_k,
                top_p, eos, pad, seed):
        """Prefill, then one token per step until ``max_new`` tokens or every
        row is done. ``W``: the cache write head after prefill."""
        dev = self.device
        B, P = ids.shape
        max_gen = S - W
        ids_t = torch.as_tensor(ids, device=dev).long()
        pads_t = torch.as_tensor(pads, device=dev).long()
        cache_mask = pos_prefill = None
        if padded:
            cache_mask = torch.arange(S, device=dev)[None, :] >= pads_t[:, None]
            pos_prefill = torch.clamp(torch.arange(P, device=dev)[None, :] - pads_t[:, None], min=0)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))

        logits, cache = self.module.apply_with_cache(self.net, ids_t, cache, 0, cache_mask,
                                                     pos_prefill)
        tok = _sample_tokens(gen, logits[:, W - 1].float(), do_sample, temperature, top_k, top_p)
        buf = torch.full((B, max_gen), pad, dtype=torch.int32, device=dev)
        buf[:, 0] = tok
        done = (tok == eos) if eos is not None else None
        for t in range(max_new - 1):
            if done is not None and bool(done.all()):
                break
            pos = (W + t - pads_t)[:, None]  # (B, 1) true positions
            logits, cache = self.module.apply_with_cache(self.net, tok[:, None].long(), cache,
                                                         W + t, cache_mask, pos)
            nxt = _sample_tokens(gen, logits[:, 0].float(), do_sample, temperature, top_k, top_p)
            if done is not None:
                nxt = torch.where(done, torch.full_like(nxt, pad), nxt)
                buf[:, t + 1] = torch.where(done, buf[:, t + 1], nxt)
                done = done | (nxt == eos)
            else:
                buf[:, t + 1] = nxt
            tok = nxt
        return buf

    def _init_cache(self, B, S):
        return self.module.init_cache(B, S, device=self.device)

    # ------------------------------------------------------------------ misc parity
    @property
    def config(self):
        return self._config

    def eval(self):
        return self

    def train(self, mode=True):
        return self
