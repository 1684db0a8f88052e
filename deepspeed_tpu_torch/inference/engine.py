"""Inference engine: static-batch ``generate()`` over a preallocated KV cache.

Port of ``deepspeed_tpu/inference/engine.py`` (reference
``inference/engine.py``, ``InferenceEngine``), on one device or across the
ranks of the ``comm`` mesh:

- tensor parallelism over the ``tensor`` axis in the JAX engine's bitwise
  all-gather layout (``TransformerConfig.bitwise_tp``): each rank holds its
  q/k/v heads, its up/gate columns, its vocab rows and int8 head columns
  and its KV heads; activations are all-gathered before the whole o_proj
  and down_proj and the logits before anything reads them, so every
  cross-rank transfer is a concatenation and tp > 1 is bitwise tp 1. Head
  counts the degree does not divide serve REPLICATED, with the JAX
  warning; the fused [q;k;v] matmul and the fused decode layer are off at
  tp > 1 (the mesh's degree decides). Every rank runs the same requests;
- expert parallelism for an MoE model over the ``expert`` axis (each rank
  serves every token through its experts and all-gathers their outputs,
  bitwise the one-rank result; an expert count the axis does not divide
  serves replicated, with a warning);
- the sequence-parallel prefill over the ``seq`` axis (a mesh the caller
  made, ``comm.initialize_mesh(seq=n)``): the scheduler's wide chunks,
  with ``continuous_batching.long_context.seq_parallel_min_tokens``, split
  their span attention's query columns over the ranks, bitwise one rank;
  every rank holds the whole model and pool and runs the same requests:

- kernel injection selects the model's kernel paths (``attention_impl=
  'flash'``: flash prefill and the decode-attention kernel; int8 weights
  through the quant-matmul kernel) and unrolls the layers;
- ``dtype='int8'`` quantizes the weights on the host before the first copy
  to the device, and computes in bf16;
- the JAX decode ``while_loop`` becomes an eager Python loop that stops when
  every row is done; the KV cache is written in place and pooled per
  (batch, cache length) across calls;
- an int8 kernel-injected config that the gate admits
  (:meth:`InferenceEngine._fused_decode_eligible`, the JAX engine's reasons
  word for word) decodes through the fused decode layer
  (``ops/decode_block.py``: kernel A, the cache commit, decode attention,
  kernel C per layer, then the int8 head); the prefill stays on the
  per-projection path, as in the JAX engine.

With ``continuous_batching.enabled``, :meth:`InferenceEngine.submit` routes
each row through the shared continuous-batching scheduler
(:meth:`InferenceEngine.scheduler`, ``inference/scheduler.py``); its
handles return what ``generate()`` returns.

Telemetry: the engine reuses an already-installed enabled global sink
(``telemetry.get_sink()``, e.g. a training engine's, so training and
serving share one event stream), else builds one from the config's
``telemetry`` section; ``generate()`` records a ``generate`` span, the
``decode/latency_ms_per_token`` and ``decode/ttft_ms`` histograms and the
``decode/tokens`` counter, and the scheduler and the serving gateway
report through the same sink.

Batched generation follows the JAX engine: a uniform batch is right-padded
to the 64-token prompt bucket and decoding starts at the true length (no
cache mask, so a prompt of >= 128 tokens prefills through the flash
kernel); a ragged batch is left-padded so every row shares one write head,
with per-row positions and a left-pad cache mask.
"""

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .. import comm as dist
from ..accelerator import resolve_device
from ..models.transformer import tp_shard_config, tp_shard_params
from ..moe.layer import expert_parallel, shard_config, shard_params
from ..telemetry import TelemetrySink, get_sink, set_sink
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

        # the mesh decides the effective tensor parallelism (an existing mesh
        # with tensor > 1 shards serving even when the config left tp_size
        # at 1), before the overrides that depend on it
        tp = int(cfg.tensor_parallel.tp_size)
        if dist.is_initialized() and dist.has_mesh():
            mesh_tp = dist.get_mesh().shape[dist.TENSOR_AXIS]
            if mesh_tp != tp and tp > 1:
                raise ValueError(f"existing mesh has tensor={mesh_tp}, config asks tp_size={tp}")
        elif tp > 1:
            world = dist.get_world_size()
            if tp > world or world % tp:
                raise ValueError(f"tensor_parallel.tp_size={tp} needs a world of a multiple of {tp} "
                                 f"ranks; this one has {world} (start torch.distributed with one rank "
                                 f"per shard)")
            dist.initialize_mesh(tensor=tp)
        self._tp = dist.get_world_size(dist.TENSOR_AXIS)
        # head-divisibility gate (the JAX engine's): uneven head shards would
        # cost bit-identity, so heads the degree does not divide serve
        # REPLICATED, loudly
        nh, nkv = model.cfg.num_heads, model.cfg.kv_heads
        heads_divide = nh % self._tp == 0 and nkv % self._tp == 0
        self._tp_replicated_fallback = self._tp > 1 and not heads_divide
        if self._tp_replicated_fallback:
            logger.warning(
                f"init_inference: mesh tensor={self._tp} but head counts "
                f"(num_heads={nh}, kv_heads={nkv}) don't divide it — serving "
                f"REPLICATED (uneven head shards would cost bit-identity); "
                f"choose a tensor degree dividing the kv head count to shard")

        # dtype 'int8' means int8 weights + bf16 compute: the memory-bound
        # decode loop reads half the weight bytes through the quant matmul
        self._int8_weights = cfg.dtype == torch.int8
        compute_dtype = torch.bfloat16 if self._int8_weights else cfg.dtype
        overrides = {"dtype": compute_dtype, "decode_block_kv": cfg.decode_block_kv}
        self._int8_fused_note = None
        if self._int8_weights:
            # fused [q;k;v] int8 matmul at tp 1; tp > 1 (by the mesh) forces
            # the split projections, whose columns shard
            overrides["int8_weights"] = True
            overrides["int8_fused_qkv"] = self._tp == 1
            if self._tp > 1:
                self._int8_fused_note = (
                    f"tensor={self._tp} shards split q/k/v projections "
                    f"column-wise; the fused [q;k;v] column axis cannot "
                    f"shard without splitting component boundaries")
                logger.warning(
                    "init_inference(int8): fused-qkv decode disabled under "
                    f"tensor parallelism (mesh tensor={self._tp}) — {self._int8_fused_note}")
        if cfg.kernel_inject:
            overrides["attention_impl"] = "flash"
            overrides["scan_layers"] = False
        # expert parallelism from the mesh's expert axis; a count it does not
        # divide serves REPLICATED expert weights, loudly (the JAX engine's rule)
        n_experts = getattr(model.cfg, "num_experts", 0)
        self._ep, sharded = expert_parallel(n_experts) if n_experts else (1, False)
        self._ep_replicated_fallback = self._ep > 1 and not sharded
        if self._ep_replicated_fallback:
            logger.warning(
                f"init_inference: mesh expert={self._ep} but num_experts="
                f"{n_experts} doesn't divide it — serving REPLICATED expert "
                f"weights (uneven expert shards would cost bit-identity)")
        tp_shard = self._tp if heads_divide else 1
        self.module = type(model)(tp_shard_config(shard_config(dataclasses.replace(model.cfg, **overrides)),
                                                  tp=tp_shard, bitwise=tp_shard > 1))
        self.model_config = self.module.cfg

        # fused decode-block gating: every failing condition gets its reason
        # (ready line + warning). Only for int8 configs that asked for it
        self._fused_decode_note = None
        if self._int8_weights and cfg.fused_decode_block:
            elig = self._fused_decode_eligible()
            if not elig:
                self._fused_decode_note = "; ".join(elig.reasons)
                logger.warning("init_inference(int8): fused decode-block disabled — "
                               + self._fused_decode_note)

        self.params = self._materialize_params(params)
        self.net = self.module.bind(self.params)
        self._cache_pool = {}  # (B, S) -> reusable KV cache buffers
        self._scheduler = None
        # an installed enabled sink first, else this config's section
        self.telemetry = get_sink()
        if self.telemetry is None or not self.telemetry.enabled:
            if dict(cfg.telemetry or {}).get("enabled"):
                self.telemetry = TelemetrySink(cfg.telemetry)
                set_sink(self.telemetry)
            elif self.telemetry is None:
                self.telemetry = TelemetrySink(None)
        self._inflight = 0  # static submits not yet fetched
        fused = ""
        if self._fused_decode_note:
            fused = f" fused_decode=off ({self._fused_decode_note})"
        elif self._int8_weights and cfg.fused_decode_block:
            fused = " fused_decode=on"
        log_dist(f"InferenceEngine ready: model dtype={self.model_config.dtype} device={self.device} "
                 f"{self._tp_desc()}{self._moe_desc()} int8_weights={self._int8_weights}{fused} "
                 f"kernel_inject={cfg.kernel_inject} max_out_tokens={cfg.max_out_tokens}", [0])

    def _tp_desc(self):
        """The ready line's tensor layout (the JAX engine's ``_shard_desc``
        tensor and int8 fused-qkv parts): the mesh's degree, the layout in
        force and the fused-qkv outcome."""
        if self._tp <= 1:
            desc = "tp=1"
        elif self._tp_replicated_fallback:
            mc = self.model_config
            desc = (f"tp={self._tp} (REPLICATED fallback: num_heads={mc.num_heads}/"
                    f"kv_heads={mc.kv_heads} don't divide the tensor degree)")
        else:
            desc = f"tp={self._tp} (bitwise all-gather layout, kv_heads sharded /{self._tp})"
        if self._int8_weights:
            fused = self.model_config.int8_fused_qkv
            desc += (f" int8_fused_qkv={'on' if fused else 'off'}"
                     + (f" ({self._int8_fused_note})" if self._int8_fused_note else ""))
        return desc

    def _moe_desc(self):
        """The ready line's expert layout (the JAX engine's ``_shard_desc``
        MoE part), empty for a dense model."""
        n_experts = getattr(self.model_config, "num_experts", 0)
        if not n_experts:
            return ""
        if self._ep <= 1:
            moe = "ep=1"
        elif self._ep_replicated_fallback:
            moe = (f"ep={self._ep} (REPLICATED experts: num_experts="
                   f"{n_experts} doesn't divide the expert degree)")
        else:
            moe = f"ep={self._ep} (expert-sharded, all-gather combine)"
        return f" moe[{n_experts}e top{self.model_config.moe_top_k}] {moe}"

    # ------------------------------------------------------------------ params
    def _materialize_params(self, params):
        """Random init (seed 0) or the given state dict; int8 quantizes on the
        host BEFORE the copy to the device (the float weights never reach it).
        An int8 engine also takes an int8 engine's own ``params`` (the
        quantized tree, ``logits_q`` and all) as they are: tensors already on
        the device are shared, not copied."""
        if params is None:
            logger.warning("init_inference: no params given; initializing random weights")
            init_cfg = dataclasses.replace(self.model_config, int8_weights=False, moe_local_experts=None,
                                           tp_shard=None)
            params = type(self.module)(init_cfg).init_params(0)
        if self._int8_weights and "logits_q" not in params:
            params = self.module.quantize_params(params)
        # this rank's experts, then its tensor shard (a whole tree: an int8
        # engine's own params are its shard already)
        params = shard_params(params, self.model_config)
        shapes = self.module.param_shapes()
        if any(tuple(np.shape(v)) != shapes[k][0] for k, v in params.items() if k in shapes):
            params = tp_shard_params(params, self.module)
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
        """Structured gate for the fused per-layer decode kernels
        (``ops/decode_block.py``), with the JAX engine's reason strings word
        for word, so the port decodes fused exactly the configs the JAX
        engine does (the group-size reason keeps its VMEM wording)."""
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
        tp = self._tp  # the mesh's degree, not the config's
        if tp != 1:
            reasons.append(f"tensor={tp}: the fused kernels are opaque "
                           f"to GSPMD; tp decodes per-projection")
        if not self._config.fused_decode_block:
            reasons.append("fused_decode_block=False in config")
        return FusedDecodeEligibility(reasons)

    def _fast_tree(self):
        """The fused decode kernels' per-layer operands, derived once from
        the int8 params. The int8 weights and the embedding pass through by
        reference; only the small norm and bias leaves convert. Keyed on the
        params OBJECT (``is``, not ``id()``): replacing ``self.params``
        rebuilds it, so the fused decode never serves old weights while the
        prefill uses new ones."""
        cached = getattr(self, "_fast_tree_cache", None)
        if cached is not None and cached[0] is self.params:
            return cached[1]
        self._fast_tree_cache = (self.params, self.module.fused_decode_operands(self.params))
        return self._fast_tree_cache[1]

    def _fused_step(self, layers, head, caches, tok, pos_rows, pos, starts, impl="kernel"):
        """One fused decode step for one token per row: embedding (+ learned
        position rows at ``pos_rows``), the L fused layers with the cache
        committed in place at ``pos`` and attention over ``[starts, pos +
        1)``, the final norm in fp32, and the int8 head with fp32 output.
        Returns the (B, V) fp32 logits. ``impl="plain"`` routes every kernel
        to its plain version (the on-card check of the kernel path)."""
        from ..ops.decode_block import fused_decode_block
        from ..ops.quant_matmul import quant_matmul
        mc = self.model_config
        x = head["embed"][tok.long()]  # (B, H) in the compute dtype
        if mc.pos_embedding == "learned":
            x = x + head["pos_embed"][pos_rows].to(x.dtype)
        rope = None
        if mc.pos_embedding == "rope":
            sin, cos = self.net._rope_table(x.device)
            rope = (sin[pos_rows], cos[pos_rows])
        cks, cvs = caches
        for i, (norms, qkv, o, up, down, gate) in enumerate(layers):
            x, _, _ = fused_decode_block(x, norms, cks[i], cvs[i], qkv, o, up, down, starts, pos,
                                         activation=mc.activation, eps=mc.layernorm_epsilon,
                                         block_kv=mc.decode_block_kv, norm=mc.norm, rope=rope,
                                         gate=gate, impl=impl)
        H = mc.hidden_size
        if "final_bias" in head:  # layernorm head
            xn = F.layer_norm(x.float(), (H, ), head["final_scale"], head["final_bias"],
                              mc.layernorm_epsilon)
        else:
            xn = F.rms_norm(x.float(), (H, ), head["final_scale"], mc.layernorm_epsilon)
        logits = quant_matmul(xn.to(x.dtype), head["logits_q"], head["logits_scale"],
                              out_dtype=torch.float32, impl=impl)[:, :mc.vocab_size]
        if "logits_bias" in head:
            logits = logits + head["logits_bias"]
        return logits

    def generate(self, input_ids, max_new_tokens=64, do_sample=False, temperature=1.0, top_k=0,
                 top_p=1.0, eos_token_id=None, pad_token_id=0, seed=0):
        """Batched generation. ``input_ids``: list of token lists or (B, P)
        array. Returns a list of 1-D np arrays of *new* tokens per row
        (trimmed at ``eos_token_id``)."""
        tel = self.telemetry
        t0 = tel.now() if tel.enabled else None
        buf, trim = self._generate_raw(input_ids, max_new_tokens=max_new_tokens,
                                       do_sample=do_sample, temperature=temperature,
                                       top_k=top_k, top_p=top_p, eos_token_id=eos_token_id,
                                       pad_token_id=pad_token_id, seed=seed)
        out = trim(buf.cpu().numpy())
        if t0 is not None:
            self._record_decode(t0, out, max_new_tokens)
        return out

    def _record_decode(self, t0, out, max_new_tokens):
        """Decode telemetry for one finished generate: a ``generate`` span,
        the per-token-step latency and TTFT histograms. The whole batch
        comes back at once, so TTFT here is the request's completion
        latency (the scheduler's ``serving/ttft_ms`` is the first token's)."""
        tel = self.telemetry
        dur = tel.now() - t0
        n_steps = max(1, max((len(r) for r in out), default=1))
        tokens = int(sum(len(r) for r in out))
        tel.record_span("generate", t0, dur, attrs={"batch": len(out), "tokens": tokens,
                                                    "max_new_tokens": int(max_new_tokens)})
        tel.histogram("decode/latency_ms_per_token", dur * 1e3 / n_steps)
        tel.histogram("decode/ttft_ms", dur * 1e3)
        tel.counter("decode/tokens", tokens)

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
        row is done. ``W``: the cache write head after prefill. Decode steps
        take the fused decode layer when the gate admits the config."""
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
        fused = bool(self._fused_decode_eligible())
        if fused:
            layers, head = self._fast_tree()
            starts = pads_t.to(torch.int32)
        for t in range(max_new - 1):
            if done is not None and bool(done.all()):
                break
            if fused:  # one fused layer kernel pair per layer (the reference's fused pass)
                logits2d = self._fused_step(layers, head, cache, tok, W + t - pads_t, W + t, starts)
            else:
                pos = (W + t - pads_t)[:, None]  # (B, 1) true positions
                logits, cache = self.module.apply_with_cache(self.net, tok[:, None].long(), cache,
                                                             W + t, cache_mask, pos)
                logits2d = logits[:, 0].float()
            nxt = _sample_tokens(gen, logits2d, do_sample, temperature, top_k, top_p)
            if done is not None:
                nxt = torch.where(done, torch.full_like(nxt, pad), nxt)
                buf[:, t + 1] = torch.where(done, buf[:, t + 1], nxt)
                done = done | (nxt == eos)
            else:
                buf[:, t + 1] = nxt
            tok = nxt
        return buf

    def _init_cache(self, B, S, kv_dtype=None):
        """``kv_dtype``: None = the model compute dtype; "int8" = the
        quantized KV tier (3-leaf cache with per-row scales; serving
        ``kv_cache_dtype: int8``); a torch float dtype = a plain cache of it."""
        if kv_dtype == "int8":
            return self.module.init_cache(B, S, device=self.device, quantized=True)
        return self.module.init_cache(B, S, dtype=kv_dtype, device=self.device)

    # ------------------------------------------------------------------ serving
    def scheduler(self, **overrides):
        """The engine's continuous-batching :class:`DecodeScheduler`
        (``inference/scheduler.py``), built lazily from the
        ``continuous_batching`` config section; ``overrides`` replace config
        fields on first construction."""
        if self._scheduler is None:
            from .scheduler import DecodeScheduler
            cb = self._config.continuous_batching
            kw = {"num_slots": cb.num_slots, "max_len": cb.max_len,
                  "prefill_bucket": cb.prefill_bucket, "collect_logits": cb.collect_logits,
                  "steps_per_sync": cb.steps_per_sync, "prefill_chunk": cb.prefill_chunk,
                  "prefix_cache": cb.prefix_cache, "spec_tokens": cb.spec_tokens,
                  "spec_ngram_max": cb.spec_ngram_max, "spec_ngram_min": cb.spec_ngram_min,
                  "kv_cache_dtype": cb.kv_cache_dtype}
            lc = cb.long_context  # extent chains, seq-parallel prefill, lossy windows
            kw.update(max_extents=lc.max_extents,
                      seq_parallel_min_tokens=lc.seq_parallel_min_tokens,
                      seq_parallel_degree=lc.seq_parallel_degree,
                      allow_lossy_kv=lc.allow_lossy_kv)
            hk = cb.hierarchical_kv
            if hk.enabled or cb.disaggregation.enabled:
                # ONE host prefix store per engine: the scheduler threads it
                # through _init_kwargs, so every ReplicaSet sibling binds the
                # same store; disaggregated prefill/decode rides it as its
                # migration transport, so it is built without the tier too
                # (the hierarchical_kv knobs apply)
                from ..memory.prefix_store import GlobalPrefixStore
                kw["prefix_store"] = GlobalPrefixStore(
                    capacity_bytes=int(hk.host_capacity_mb) << 20, nvme_path=hk.nvme_path,
                    telemetry=self.telemetry)
                kw["restore_min_tokens"] = hk.restore_min_tokens
            kw.update(overrides)
            self._scheduler = DecodeScheduler(self, **kw)
        elif overrides:
            raise ValueError("scheduler already built; overrides must be passed on the first "
                             "scheduler() call")
        return self._scheduler

    def submit(self, input_ids, **kwargs):
        """Generation behind a handle whose ``result()`` returns what
        ``generate()`` would. With ``continuous_batching.enabled`` the rows
        join the shared scheduler (requests from different submit() calls
        batch into one step, finished rows evict mid-loop); otherwise the
        static batch runs now and the handle holds its device output until
        ``result()`` fetches it."""
        if self._config.continuous_batching.enabled:
            return self._submit_continuous(input_ids, **kwargs)
        tel = self.telemetry
        t0 = tel.now() if tel.enabled else None
        buf, trim = self._generate_raw(input_ids, **kwargs)
        if t0 is not None:
            self._inflight += 1
            tel.gauge("inference/queue_depth", self._inflight)
        eng, max_new = self, kwargs.get("max_new_tokens", 64)

        class _Handle:
            done = True
            _accounted = False

            def _settle(self_h):
                if t0 is not None and not self_h._accounted:
                    self_h._accounted = True
                    eng._inflight -= 1
                    tel.gauge("inference/queue_depth", eng._inflight)
                    return True
                return False

            def result(self_h):
                out = trim(buf.cpu().numpy())
                if self_h._settle():
                    eng._record_decode(t0, out, max_new)
                return out

            def __del__(self_h):
                # an abandoned handle settles the queue-depth gauge, and never
                # raises (at interpreter exit the sink may be gone)
                try:
                    self_h._settle()
                except Exception:
                    pass

        return _Handle()

    def _submit_continuous(self, input_ids, max_new_tokens=64, do_sample=False, temperature=1.0,
                           top_k=0, top_p=1.0, eos_token_id=None, pad_token_id=0, seed=0):
        """submit() on the continuous-batching path: each row becomes one
        scheduler request (row i seeded ``seed + i``); the handle reassembles
        ``generate()``'s per-row output lists (eos-inclusive)."""
        sched = self.scheduler()
        handles = []
        try:
            for i, row in enumerate(input_ids):
                handles.append(sched.submit(row, max_new_tokens=max_new_tokens,
                                            eos_token_id=eos_token_id, do_sample=do_sample,
                                            temperature=temperature, top_k=top_k, top_p=top_p,
                                            seed=seed + i))
        except Exception:
            for h in handles:  # don't orphan already-queued rows
                h.cancel()
            raise

        class _BatchHandle:
            def result(self_h):
                return [h.result() for h in handles]

            @property
            def done(self_h):
                return all(h.done for h in handles)

            def __del__(self_h):
                # flag abandoned requests for eviction at the scheduler's next
                # iteration; never pump the loop from GC
                for h in handles:
                    if not h.done:
                        h.cancel()

        return _BatchHandle()

    # ------------------------------------------------------------------ misc parity
    @property
    def config(self):
        return self._config

    def eval(self):
        return self

    def train(self, mode=True):
        return self
