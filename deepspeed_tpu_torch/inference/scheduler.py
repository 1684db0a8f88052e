"""Continuous-batching decode scheduler (iteration-level scheduling) with
chunked prefill fused into the decode step and a radix prefix cache.

Port of ``deepspeed_tpu/inference/scheduler.py`` (``DecodeScheduler``) for
one device. Queued requests are admitted into free KV-cache slots at
token-iteration granularity: a finished sequence evicts mid-loop and the
next queued request joins the very next step.

**Chunked prefill (Sarathi-Serve).** Each scheduler iteration with a
prefill in flight runs ONE step over ``(num_slots, prefill_chunk)`` query
columns: live decode rows carry their next token in column 0, the (at most
one) in-flight prefill row carries up to ``prefill_chunk`` prompt tokens,
per-row query spans mask the rest (their KV writes are dropped); then the
sync's remaining ``steps_per_sync - 1`` decode steps. A sync with no
prefill is the same step body at chunk width 1. Either way it is a Python
loop of K forwards that reads nothing back: sampled tokens feed the next
forward as device tensors, and one ``.cpu()`` of the (K, num_slots) token
block (and the logits, when collected) ends the sync. The paged kernels
take per-row ends on the device, so no ``max(ends)`` is needed on the host.
The shapes dispatched are (chunk, K), (chunk, 1) for a non-final chunk on
an idle pool, and (1, K): ``dispatched`` records them.

**Radix prefix cache (SGLang RadixAttention).** Finished slots are retained
with their prompts registered in a token trie; admission copies the longest
matched prefix's KV rows from the donor slot (``copy_slot``) and
chunk-prefills only the suffix. Matches round DOWN to a ``prefill_chunk``
multiple, so hit and cold paths run identical chunk boundaries: a hit's
logits are bitwise equal to a cold prefill's.

**Sampling.** Per-request greedy (``argmax``) or temperature / top-k /
top-p sampling, with the draw a function of (request seed, absolute step,
vocab index) only: a counter-based 32-bit hash of those three computed in
int64 tensor ops (the same integers on the CPU and the card) gives one
uniform per vocab entry, and the token is the Gumbel-max over the filtered
logits. So a request's tokens do not depend on its slot, on what shares the
batch, or on K, and no host sync or per-row Python loop is involved. (The
JAX package's ``fold_in(key(seed), step)`` draws cannot be reproduced in
PyTorch.)

**int8 paged KV** (``kv_cache_dtype: "int8"``): the pool stores per-row
quantized K/V (``ops/quantizer.py``) and the paged kernels dequantize in
registers.

**Long context** (``max_extents > 1``, the ``long_context`` config
section): a request whose prompt and budget exceed one slot is admitted onto
a CHAIN of pool rows reserved whole at admission; logical position ``p``
lives in extent ``p // max_len`` at offset ``p % max_len``, and a dispatch
with a chain (or a lossy window) live hands the model an extent operand
block (:meth:`DecodeScheduler._ext_operands`): the paged kernels walk each
row's chain through its extent table and each row writes into its write
extent's pool row. A chunk never crosses an extent boundary and a K-step
sync falls to K = 1 when a row lacks K rows of room in its write extent.
Chained rows skip the radix cache both ways. A request may opt into the
lossy StreamingLLM window ``kv_window=(sink, recent)`` (with
``allow_lossy_kv``): extents that slide out of it are dropped once per
step. ``seq_parallel_min_tokens`` prefills long prompts at the wide chunk
width (``seq_parallel_degree``, by default the mesh's ``seq`` axis, times
the chunk, rounded to a multiple of the axis): with ranks on ``seq`` the
first forward of such a sync splits the span attention's query columns
over them (``seq_shard``, the JAX scheduler's ``seqp`` program), bitwise
the one-rank stream since a column's bits depend only on its own window;
on one rank it is the same arithmetic unsharded. A wide chunk goes per
projection at every degree (the JAX scheduler takes the fused decode
block for it on one rank), so the one-rank stream is the sharded one under
any config. Every rank runs the same requests.

**Monolithic prefill** (``prefill_chunk=0``, the legacy admission): every
free slot is filled at once, FIFO, each request by one single-slot forward
over its prompt right-padded to a power-of-two bucket (``prefill_bucket``
floor, the slot's length cap): ``apply_with_cache(params, ids,
slot_slice(pool, slot), 0)`` writes the slot's rows in place. The padding
rows are causally invisible to the real tokens and later decode writes
overwrite them. The radix cache is off in this mode (reuse replays chunk
boundaries), and extent chains and the seq-parallel prefill need the
chunked path.

**Self-speculative decoding** (``spec_tokens > 0``): each pure-decode sync
drafts up to ``spec_tokens`` continuation tokens per live row with the
prompt-lookup drafter (``inference/speculative.py``) and verifies every
column in ONE forward over the ``(num_slots, 1 + spec_tokens)`` ids block,
through the same per-row span machinery as chunked prefill. Each column is
sampled at its absolute step index, and a draft commits only when it equals
the sampled token, so the streams are bitwise those of non-speculative
decode: a column's bits do not depend on the width of the forward it rides
(``quant_matmul`` and kernels A and C split by weight shape only, and the
span kernel's column is bitwise its decode mode). A sync where no row
drafts, or where a row is chained or lossy (the verify carries no extent
walk), runs the K-step decode sync instead.

With the fused decode-layer gate open (int8, kernel injection), each
forward runs ``CausalLMModel.fused_paged_step`` (kernels A and C); else, and
in every dispatch that carries extent operands (the fused kernels walk no
extents), the per-projection ``apply_with_cache``. Both write and read the
same pool.

**Hierarchical KV tier** (``prefix_store=``, built by ``engine.scheduler()``
from the ``hierarchical_kv`` config section): a radix eviction DEMOTES the
victim's prefix KV to the host prefix store
(:class:`~deepspeed_tpu_torch.memory.kv_tier.KVTier`, spilling to NVMe
past its RAM budget) instead of destroying it; admission probes the store
beside the trie and restores a host match that beats the device match,
rounded and capped exactly as a device hit is, so restored == device hit
== cold prefill bitwise. A submit-time probe starts the NVMe read of a
spilled match. With the tier, ``demote_cold_extents`` is lossless: a live
chained request's cold extents page to the store and the row is PARKED
(left out of every dispatch) until the paging pump at the top of
:meth:`step` has restored them all.

**Telemetry** (the engine's sink, ``telemetry/``): the JAX scheduler's
counters, gauges and histograms (``serving/admitted``, ``decode_steps``,
``decode_tokens``, ``step_ms``, ``ttft_ms``, ``queue_depth``, prefix-cache
hits, cancellations, the tier's ``prefix_cache_{demote,restore,
restore_tokens,spill}`` and ``longctx_{demote,restore}_tokens`` counters
and ``kv_host_tier_bytes`` / ``kv_tier_hit_rate`` gauges, ...), a
``sched/step`` span per iteration with flow
links to the phases of the requests it served (``submit(trace=...)``: a
:class:`~deepspeed_tpu_torch.telemetry.tracing.RequestTrace`), the capacity
meter (every ``capacity_sample_every``-th sync drains the device before its
dispatch, so the wall time to its fetch prices ``serving/mfu`` and
``serving/hbm_bw_util``) and the host-gap tracker (the device-idle time
between a sync's fetch and the next dispatch, split into admission, trie
probe, sampling, on_token delivery and other). The port adds two
histograms per sync: ``serving/sync_launch_ms``, the host time from the
dispatch's first launch to its fetch call (the Python loop that enqueues
the forwards), and ``serving/sync_wait_ms``, the time the fetch then
blocks on the device (in a replica fleet also as
``serving/replica/<id>/sync_{launch,wait}_ms``). With the sink disabled
every hook is one attribute test: nothing is allocated and nothing
fenced.

An MoE model serves through the same steps (each token routed on its own,
capacity-free, ``moe/layer.py``); with telemetry on, the chunk, decode and
verify forwards also return their per-layer routed-token counts over live
columns, read back with the sync's tokens into the
``serving/expert_dispatch_tokens`` counter and the
``serving/expert_load_balance`` gauge (``expert_dispatch_tokens`` keeps the
total).

**Disaggregated prefill/decode** (``serving/replica.py`` drives both
halves): when the final chunk of a prefill lands, the ``migrate_hook`` the
replica set installed may take the request (not a chained or lossy-window
row); :meth:`DecodeScheduler.migrate_out` then demotes the request's whole
KV (the prompt's rows and the rows its final sync decoded; int8 pools
carry their row scales) to the fleet's shared host store through
``KVTier.demote_request`` and releases the slot, and a decode replica's
:meth:`DecodeScheduler.admit_migration` restores the rows into a slot of
its own, where decode resumes from the request object as it left: the
write head, the absolute step index and the sampling parameters travel
with it, so the stream is bitwise the one that never moved. (The JAX
scheduler calls the hook at two sites, its per-projection and its fused
chunk steps; here both forwards run inside one chunk step.)

Every scheduler has a process-unique id (``uid``) that keys its extent
demotes in the host store, so schedulers sharing one store never collide
on their per-scheduler request ids.

Not ported, each raising naming its ROADMAP item: multi-LoRA, cold-expert
offload and the weight-swap protocol (#9, RLHF).
"""

import collections
import itertools
import time

import numpy as np
import torch

from .. import comm as dist
from .kv_cache import RadixPrefixCache, SlotKVCache, copy_slot, slot_slice
from .speculative import PromptLookupDrafter
from ..utils.counter_hash import GOLDEN, M32, mix32, mulmod32

# host-store namespace of mid-decode extent demotion: a parked extent's
# entry keys as (_EXT_NS, scheduler uid, rid, extent index), a negative
# sentinel no prompt can collide with; the entries are pinned and held by
# their scheduler
_EXT_NS = -0x10C7E57
_UIDS = itertools.count()


def _round_up(x, m):
    return (x + m - 1) // m * m


def _bucket_len(n, base, cap):
    """Monolithic prefill bucket: the next power of two >= n (floor
    ``base``), capped at ``cap``: ~log2(cap / base) widths, at most 2x the
    prefill's work."""
    b = base
    while b < n:
        b *= 2
    return min(b, cap)


def _unported(what, item):
    return NotImplementedError(f"deepspeed_tpu_torch does not support {what} yet ({item})")


def _replicate_logits(logits, vocab_size, shard_deg):
    """The step logits, whole on every rank before sampling (the JAX
    scheduler's ``_replicate_logits``): the model's cached forward already
    all-gathers a vocab-split head (a concatenation), so under any live
    shard axis this checks that every rank holds the whole vocab and draws
    the same token from the counter hash."""
    if shard_deg > 1 and logits.shape[-1] != vocab_size:
        raise RuntimeError(f"step logits hold {logits.shape[-1]} of {vocab_size} vocab columns under a "
                           f"shard degree of {shard_deg}: sampling needs them whole on every rank")
    return logits


# ---------------------------------------------------------------- sampling


def sample_uniforms(seeds, steps, V):
    """(N, V) float64 uniforms in (0, 1), a function of (seed, step, vocab
    index) alone: bitwise the same on the CPU and the card. ``seeds``,
    ``steps``: (N,) int64, seeds in [0, 2^32)."""
    key = mix32(mix32(seeds & M32) ^ mulmod32(steps & M32, GOLDEN))
    v = torch.arange(V, dtype=torch.int64, device=seeds.device)
    h = mix32(mix32(key[:, None] ^ mulmod32(v, 0x27D4EB2F)[None, :]) ^ 0x165667B1)
    return (h.double() + 0.5) / 4294967296.0


def sample_rows(logits, seeds, steps, flags, temps, topks, topps):
    """Per-row token choice with per-row sampling parameters, all tensors
    on the logits' device: greedy rows take the argmax; sampling rows take
    the Gumbel-max over the temperature-scaled logits filtered by top-k and
    then top-p of the top-k-filtered distribution (the JAX ``_sample_slot``
    filters). ``logits`` (N, V) fp32; ``seeds``/``steps``/``topks`` (N,)
    int64; ``flags`` (N,) bool; ``temps``/``topps`` (N,) fp32."""
    N, V = logits.shape
    greedy = logits.argmax(-1)
    x = logits / temps.clamp(min=1e-6)[:, None]
    desc = torch.sort(x, dim=-1, descending=True).values
    kth = desc.gather(1, (topks - 1).clamp(0, V - 1)[:, None])
    x = torch.where((topks > 0)[:, None] & (x < kth), float("-inf"), x)
    desc = torch.sort(x, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(desc, dim=-1), dim=-1)
    keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool), cum[:, :-1] < topps[:, None]],
                     dim=-1)
    threshold = torch.where(keep, desc, float("inf")).amin(dim=-1, keepdim=True)
    x = torch.where((topps < 1.0)[:, None] & (x < threshold), float("-inf"), x)
    gumbel = (-torch.log(-torch.log(sample_uniforms(seeds, steps, V)))).float()
    return torch.where(flags, (x + gumbel).argmax(-1), greedy)


# ---------------------------------------------------------------- requests


class _Request:
    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_token_id", "do_sample", "temperature",
                 "top_k", "top_p", "seed", "slot", "out", "logits", "done", "cancelled",
                 "submit_ts", "first_token_ts", "collect_logits", "on_token", "kv_window",
                 "row_budget", "trace", "handle", "migrating", "error")

    def __init__(self, rid, prompt, max_new_tokens, eos_token_id, do_sample, temperature, top_k,
                 top_p, seed, collect_logits, on_token=None, kv_window=None, trace=None):
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("scheduler requires at least one prompt token")
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed) & 0xFFFFFFFF
        self.collect_logits = bool(collect_logits)
        self.slot = None
        self.out = []      # generated token ids (host ints)
        self.logits = []   # per-step (V,) logits when collect_logits
        self.done = False
        self.cancelled = False
        self.submit_ts = time.perf_counter()
        self.first_token_ts = None
        self.on_token = on_token
        # lossy long-context window (sink, recent), or None (exact)
        self.kv_window = kv_window
        # rows reserved at submit (the budget rounded up to K): admission
        # sizes an extent chain from prompt + row_budget, so a chain never
        # runs out of extents mid-decode
        self.row_budget = 0
        self.trace = trace  # optional telemetry.tracing.RequestTrace
        # disaggregated serving: the handle made at submit (re-pointed
        # when the request changes scheduler) and the in-handoff flag (set
        # from migrate-out to admission, while no scheduler owns it)
        self.handle = None
        self.migrating = False
        # a failed request (a migration failure): done with this set, and
        # result() raises it rather than return a truncated stream
        self.error = None


class SchedulerHandle:
    """Future-like handle for one scheduled request. ``result()`` pumps the
    shared scheduler loop (serving every in-flight request, not just this
    one) until this request finishes."""

    __slots__ = ("_sched", "_req")

    def __init__(self, sched, req):
        self._sched = sched
        self._req = req

    @property
    def done(self):
        return self._req.done

    def cancel(self):
        """Flag the request for eviction: pure host bookkeeping, safe from
        ``__del__``; the loop frees the slot (or drops the queued request)
        at its next iteration."""
        self._req.cancelled = True

    def result(self):
        while not self._req.done:
            self._sched.step()
        if self._req.error is not None:
            raise RuntimeError(self._req.error)
        return np.asarray(self._req.out, np.int32)

    def result_logits(self):
        """(T, V) per-generated-token logits (requires ``collect_logits``)."""
        self.result()
        if not self._req.collect_logits:
            raise ValueError("request was not submitted with collect_logits=True")
        if self._req.logits:
            return np.stack(self._req.logits)
        return np.zeros((0, self._sched.engine.model_config.vocab_size), np.float32)


class _PrefillState:
    """The (at most one) in-flight chunked prefill: ``pos`` is the next
    prompt position to feed; rows ``[0, pos)`` of the slot hold KV.
    ``seq_parallel``: the prompt prefills at the wide chunk width."""

    __slots__ = ("req", "pos", "seq_parallel")

    def __init__(self, req, pos):
        self.req = req
        self.pos = pos
        self.seq_parallel = False


class DecodeScheduler:
    """Continuous-batching serving loop over an :class:`InferenceEngine`.

    ``num_slots`` fixes the decode batch (the pool shape); ``max_len`` is
    the per-slot KV capacity (one extent). Requests whose ``prompt +
    max_new_tokens`` (rounded up to ``steps_per_sync``) exceed ``max_len x
    max_extents`` are rejected at submit. ``prefix_cache`` retains finished
    prefixes for cross-request KV reuse; ``prefix_store`` (a
    :class:`~deepspeed_tpu_torch.memory.prefix_store.GlobalPrefixStore`,
    which several schedulers may share) turns on the hierarchical KV tier
    in the chunked radix mode, with ``restore_min_tokens`` its
    restore-vs-recompute threshold. ``max_extents``,
    ``seq_parallel_min_tokens``, ``seq_parallel_degree`` and
    ``allow_lossy_kv`` are the ``long_context`` section's (see the module
    docstring). ``prefill_chunk=0`` selects the monolithic prefill, bucketed
    at powers of two from ``prefill_bucket``; ``spec_tokens`` drafted
    columns (n-grams of ``spec_ngram_max`` down to ``spec_ngram_min``
    tokens) are verified per pure-decode sync. The other arguments keep the
    JAX scheduler's names; the unported features' arguments raise when set
    (their tuning knobs are not taken)."""

    def __init__(self, engine, num_slots=8, max_len=None, prefill_bucket=64, collect_logits=False,
                 steps_per_sync=4, prefill_chunk=64, prefix_cache=True, spec_tokens=0,
                 spec_ngram_max=3, spec_ngram_min=1, kv_cache_dtype="auto", prefix_store=None,
                 restore_min_tokens=0, adapter_store=None, expert_store=None, max_extents=1,
                 seq_parallel_min_tokens=0, seq_parallel_degree=0, allow_lossy_kv=False):
        me = max(1, int(max_extents))
        if me > 1 and int(prefill_chunk) <= 0:
            raise ValueError("long_context.max_extents > 1 requires chunked prefill "
                             "(prefill_chunk > 0): the monolithic prefill path writes one "
                             "contiguous slot and has no extent plumbing")
        if int(seq_parallel_min_tokens) > 0 and int(prefill_chunk) <= 0:
            raise ValueError("seq_parallel_min_tokens > 0 requires chunked prefill "
                             "(prefill_chunk > 0): sequence parallelism shards the chunked "
                             "path's wide prefill forwards")
        if adapter_store is not None:
            raise _unported("multi-LoRA serving", "ROADMAP Queue 1 #9, multi-LoRA")
        if expert_store is not None:
            raise _unported("cold-expert offload", "ROADMAP Queue 1 #9, MoE expert offload")
        self.engine = engine
        # the raw arguments, so a replica set clones this scheduler's exact
        # configuration for its siblings (the normalization below re-runs
        # the same); the prefix store rides by reference, so every sibling
        # binds the one fleet-wide host store
        self._init_kwargs = dict(
            num_slots=num_slots, max_len=max_len, prefill_bucket=prefill_bucket,
            collect_logits=collect_logits, steps_per_sync=steps_per_sync,
            prefill_chunk=prefill_chunk, prefix_cache=prefix_cache, spec_tokens=spec_tokens,
            spec_ngram_max=spec_ngram_max, spec_ngram_min=spec_ngram_min,
            kv_cache_dtype=kv_cache_dtype, prefix_store=prefix_store,
            restore_min_tokens=restore_min_tokens, max_extents=max_extents,
            seq_parallel_min_tokens=seq_parallel_min_tokens,
            seq_parallel_degree=seq_parallel_degree, allow_lossy_kv=allow_lossy_kv)
        self.uid = next(_UIDS)
        self.device = engine.device
        model = engine.module
        cfg = engine._config
        if max_len is None:
            max_len = min(model.cfg.max_seq_len, cfg.max_out_tokens)
        # pool length: multiple of the decode KV block (same rule as the
        # static path) so the paged kernel's block walk tiles evenly; when
        # the model's max_seq_len caps it, round DOWN so the tiling holds
        # (the kernel needs S % block only when S exceeds one block)
        block = cfg.decode_block_kv
        S = int(_round_up(max_len, 64))
        if S > block:
            S = int(_round_up(S, block))
        if S > model.cfg.max_seq_len:
            S = model.cfg.max_seq_len
            if S > block:
                S = (S // block) * block
        if S < 1:
            raise ValueError(f"model max_seq_len {model.cfg.max_seq_len} leaves no "
                             f"room for a KV slot")
        self.max_len = S
        self.prefill_bucket = int(prefill_bucket)
        self.collect_logits = bool(collect_logits)
        self.steps_per_sync = max(1, int(steps_per_sync))
        # chunked prefill, the chunk clamped to the slot; 0: monolithic
        self.prefill_chunk = min(max(0, int(prefill_chunk)), S)
        # a chain's logical positions are bounded by the model's position
        # horizon: extents past max_seq_len could never hold a valid row
        me = max(1, min(me, model.cfg.max_seq_len // S))
        self.allow_lossy_kv = bool(allow_lossy_kv)
        self.seq_parallel_min_tokens = max(0, int(seq_parallel_min_tokens))
        # the mesh's shard degrees (the JAX scheduler's): every rank runs the
        # same requests, and sampling reads whole logits under any of them
        self.tp_size = int(getattr(engine, "_tp", 1))
        self.ep_size = int(getattr(engine, "_ep", 1))
        self._shard_deg = max(self.tp_size, self.ep_size)
        seq_on = self.seq_parallel_min_tokens > 0
        seq_ax = dist.get_world_size(dist.SEQ_AXIS) if dist.is_initialized() and dist.has_mesh() else 1
        self._seq_shards = seq_ax if seq_on else 1
        if self._seq_shards > 1 and self.tp_size > 1:
            raise ValueError(
                "sequence-parallel prefill composes with tp=1 only: the "
                "seq-sharded span kernel gathers over the seq axis while "
                "tensor parallelism already shards the attention heads")
        if seq_on:
            # the wide chunk: degree (default: the seq axis) x the base
            # chunk, clamped to the extent and rounded to a shard multiple
            # (the sharded span splits the query block evenly); on a seq
            # axis of one it runs unsharded, the same arithmetic (chunk
            # boundaries do not change a column's attention)
            deg = max(1, int(seq_parallel_degree) or seq_ax)
            Cs = min(deg * self.prefill_chunk, S)
            self._seq_chunk = max((Cs // self._seq_shards) * self._seq_shards, self.prefill_chunk)
        else:
            self._seq_chunk = 0
        if (me > 1 or self._seq_chunk or self.allow_lossy_kv) \
                and getattr(model.cfg, "attention_impl", "xla") != "flash":
            raise ValueError("long-context serving (max_extents > 1 / seq-parallel prefill / lossy "
                             "KV windows) requires attention_impl='flash': the extent block walk "
                             "and the seq-sharded span kernel live in the paged kernel path")
        kvd = str(kv_cache_dtype or "auto").lower()
        if kvd in ("auto", "model", "none"):
            kv_arg = None
        elif kvd == "int8":
            kv_arg = "int8"
        else:
            from .config import _DTYPE_MAP
            if kvd not in _DTYPE_MAP or _DTYPE_MAP[kvd] == torch.int8:
                raise ValueError(f"kv_cache_dtype must be 'auto', 'int8', or a float "
                                 f"dtype name, got {kv_cache_dtype!r}")
            kv_arg = _DTYPE_MAP[kvd]
        self.kv_quantized = kv_arg == "int8"
        self.cache = SlotKVCache(engine._init_cache(int(num_slots), S, kv_dtype=kv_arg),
                                 int(num_slots), S, max_extents=me)
        # self-speculative decoding: spec_tokens drafted columns verified per
        # pure-decode sync (clamped so a full verify block always fits one
        # slot beside at least one row of decode headroom)
        self.spec_tokens = max(0, min(int(spec_tokens), max(0, S - 2)))
        self._spec_width = 1 + self.spec_tokens
        self.drafter = (PromptLookupDrafter(self.spec_tokens, spec_ngram_max, spec_ngram_min)
                        if self.spec_tokens > 0 else None)
        self.spec_steps = 0      # verify dispatches
        self.spec_row_steps = 0  # (live row, verify dispatch) pairs
        self.spec_drafted = 0    # draft tokens submitted to verification
        self.spec_accepted = 0   # draft tokens that committed
        self.spec_delivered = 0  # tokens delivered by verify dispatches
        # radix prefix cache: chunked mode only (a hit replays the cold
        # path's chunk boundaries)
        self.radix = (RadixPrefixCache(self.cache)
                      if prefix_cache and self.prefill_chunk > 0 else None)
        # hierarchical KV tier: radix eviction demotes to the shared host
        # store and admission restores from it (chunked radix mode only:
        # a restore replays the device hit's chunk boundaries)
        self.kv_tier = None
        if prefix_store is not None and self.radix is not None:
            from ..memory.kv_tier import KVTier
            self.kv_tier = KVTier(self, prefix_store, min_restore_tokens=restore_min_tokens)
            self.radix.tier = self.kv_tier
        # the fused decode-layer kernels serve the step when the engine's
        # gate admits the config (the JAX scheduler's `fused_block` programs)
        if hasattr(engine.model_config, "int8_weights"):
            elig = engine._fused_decode_eligible()
            self._fused_block = bool(elig)
            self._fused_block_reasons = list(elig.reasons)
        else:
            self._fused_block = False
            self._fused_block_reasons = ["model family without fused decode-block support"]
        # MoE serving: the per-token capacity-free dispatch rides the same
        # step; with telemetry on, each forward also returns its per-layer
        # routed-token counts (live columns only), summed over a sync and
        # read back with its tokens (the JAX scheduler's `expert_stats`)
        self._moe = getattr(engine.model_config, "num_experts", 0) > 0
        self._moe_stats = self._moe and engine.telemetry.enabled
        self._expert_counts = None
        self.expert_dispatch_tokens = 0
        self._prefill = None  # at most one in-flight _PrefillState
        # long-context paging: slots whose chained extents are (partly)
        # host-demoted sit in _parked, left out of every dispatch until the
        # paging pump restores them; their pinned store entries park in
        # _ext_parked keyed (rid, extent index)
        self._parked = set()
        self._ext_parked = {}
        self.longctx_demotes = 0
        self.longctx_restores = 0
        self.queue = collections.deque()
        self.active = {}  # slot -> _Request
        self._rid = 0
        # plain counters (the JAX scheduler's telemetry counters, without a sink)
        self.admitted = 0
        self.evicted = 0
        self.decode_steps = 0
        # (chunk width, K) -> syncs dispatched at that shape (("spec", W) for
        # a verify, ("prefill", bucket) for a monolithic prefill), and
        # slot-pool forwards run at each width (the paged kernels launch
        # once per layer each)
        self.dispatched = collections.Counter()
        self.forwards = collections.Counter()
        # chunk width -> forwards that carried extent operands (per projection)
        self.ext_forwards = collections.Counter()
        self.last_shape = None
        # request tracing: the per-sync "sched/step" span collects flow ids
        # minted by the request phases it executed (a list while a traced
        # sync is in flight)
        self._iter = 0
        self._iter_links = None
        self.telemetry = engine.telemetry
        # the replica index this scheduler serves under (serving/replica.py)
        self.replica_idx = None
        # disaggregated serving: the replica set's hook, called when a
        # prefill completes (True: the request migrated out), and the
        # handoffs each way
        self.migrate_hook = None
        self.migrations_out = 0
        self.migrations_in = 0
        # capacity accounting (telemetry/capacity.py): built only on an
        # enabled sink; every hook below tests `self._gap is None` first
        self.capacity = None
        self._gap = None
        self._sync_seq = 0
        self._cap_sample = False
        self._goodput_spec_seen = 0
        if self.telemetry.enabled:
            from ..accelerator import get_accelerator
            from ..telemetry.capacity import CapacityMeter, CapacityModel, HostGapTracker
            accel = get_accelerator()
            self.capacity = CapacityMeter(
                self.telemetry,
                CapacityModel(engine.model_config, self.cache.bytes_per_token(), int(num_slots)),
                peak_flops=accel.peak_flops(), peak_hbm_bw=accel.peak_hbm_bandwidth(),
                sample_every=getattr(self.telemetry, "capacity_sample_every", 32))
            self._gap = HostGapTracker(self.telemetry)
            # the KV tier's price tag: int8 shows ~half the bytes per
            # resident token of a bf16 pool
            self.telemetry.gauges([
                ("serving/kv_bytes_per_token", self.cache.bytes_per_token(), None),
                ("serving/kv_cache_capacity_bytes", self.cache.capacity_bytes(), None)])

    # ------------------------------------------------------------------ API
    def submit(self, prompt, max_new_tokens=64, eos_token_id=None, do_sample=False,
               temperature=1.0, top_k=0, top_p=1.0, seed=0, collect_logits=None,
               on_token=None, trace=None, adapter_id=None, kv_window=None):
        """Enqueue one request; returns a :class:`SchedulerHandle`. The
        request joins the decode batch as soon as a slot frees up.

        ``on_token(token, done)``: optional host-side streaming hook, called
        once per generated token from inside the loop, in delivery order,
        with ``done=True`` on the final token.

        ``kv_window``: optional ``(sink, recent)`` lossy long-context window
        (attention sinks + sliding window, StreamingLLM): the request
        attends only its first ``sink`` and most recent ``recent`` tokens,
        and extents that slide entirely out of that window are dropped.
        This changes the logits, so it needs ``allow_lossy_kv``.

        ``trace``: optional
        :class:`~deepspeed_tpu_torch.telemetry.tracing.RequestTrace`; the
        scheduler records the request's phase tree on it (prefix probe,
        prefill chunks, decode, complete/cancel), flow-linked to the
        ``sched/step`` spans. ``adapter_id`` is not ported and raises when
        set."""
        req = self._make_request(prompt, max_new_tokens, eos_token_id, do_sample, temperature, top_k,
                                 top_p, seed, collect_logits, on_token, trace, adapter_id, kv_window)
        if not req.done:
            self._enqueue(req)
        return req.handle

    def _make_request(self, prompt, max_new_tokens=64, eos_token_id=None, do_sample=False,
                      temperature=1.0, top_k=0, top_p=1.0, seed=0, collect_logits=None, on_token=None,
                      trace=None, adapter_id=None, kv_window=None, rid=None):
        """:meth:`submit`'s request and handle, validated, not queued yet
        (:meth:`_enqueue`). ``rid``: the id to give it (a rank following
        another's calls), else the next one."""
        if adapter_id is not None:
            raise _unported("multi-LoRA serving (adapter_id)", "ROADMAP Queue 1 #9, multi-LoRA")
        if kv_window is not None:
            if not self.allow_lossy_kv:
                raise ValueError("request sets kv_window but lossy long-context KV is not enabled "
                                 "(continuous_batching.long_context.allow_lossy_kv): "
                                 "sliding-window attention changes logits and must be opted into "
                                 "explicitly")
            sink, recent = int(kv_window[0]), int(kv_window[1])
            if sink < 0 or recent < 1:
                raise ValueError(f"kv_window must be (sink >= 0, recent >= 1), got {kv_window!r}")
            kv_window = (sink, recent)
        rid = self._rid if rid is None else int(rid)
        req = _Request(rid, prompt, max_new_tokens, eos_token_id, do_sample, temperature,
                       top_k, top_p, seed,
                       self.collect_logits if collect_logits is None else collect_logits,
                       on_token=on_token, kv_window=kv_window, trace=trace)
        self._rid = max(self._rid, rid + 1)
        req.handle = SchedulerHandle(self, req)
        if trace is not None:
            trace.attrs.setdefault("sched_rid", req.rid)
        # the monolithic prefill writes one slot; chunks may span a chain
        cap = self.cache.spannable_len if self.prefill_chunk > 0 else self.max_len
        if req.prompt.size >= cap:
            raise ValueError(
                f"prompt of {req.prompt.size} tokens exceeds the per-slot KV capacity "
                f"{self.max_len} x {self.cache.max_extents} extent(s) = {cap} spannable rows (a "
                f"prompt needs at least one row of decode headroom); raise the scheduler's "
                f"max_len / the engine's max_out_tokens / long_context.max_extents, or shorten "
                f"the prompt")
        if req.max_new_tokens <= 0:  # static-path parity: zero budget -> no tokens
            req.done = True
            return req
        # the K-step sync writes K rows even when the budget ends mid-block;
        # a verify block likewise writes up to W rows past the final token
        budget = _round_up(req.max_new_tokens, self.steps_per_sync)
        if self.spec_tokens > 0:
            budget = max(budget, req.max_new_tokens + self._spec_width - 1)
        if not self.cache.fits(req.prompt.size, budget):
            raise ValueError(f"request needs {req.prompt.size + budget} cache rows > slot "
                             f"capacity {self.max_len} x {self.cache.max_extents} extent(s) = "
                             f"{self.cache.spannable_len}; raise max_out_tokens / max_len / "
                             f"long_context.max_extents, or shorten the request")
        req.row_budget = int(budget)
        return req

    def _enqueue(self, req):
        """Queue a request of :meth:`_make_request`."""
        self.queue.append(req)
        if self.kv_tier is not None:
            # look-ahead: an NVMe-spilled host match starts its disk read
            # now, overlapping the queue wait (admission's restore joins it)
            self.kv_tier.prefetch(req.prompt)
        if self.telemetry.enabled:
            self.telemetry.gauge("serving/queue_depth", len(self.queue))

    def drain(self):
        """Run until every queued/active request finishes."""
        while self.queue or self.active or self._prefill is not None:
            self.step()

    @property
    def num_slots(self):
        return self.cache.num_slots

    def _weight_swap(self, *args, **kwargs):
        raise _unported("the weight-swap protocol (pause/resume/flush/swap_weights)",
                        "ROADMAP Queue 1 #9, RLHF")

    pause = resume = flush = swap_weights = _weight_swap

    def owns(self, req):
        """Does this scheduler hold ``req`` now (queued, prefilling or
        decoding)? A request migrated out is held by none while its handoff
        is parked, so a prefill replica failing after the handoff cannot
        fail it."""
        return ((self._prefill is not None and self._prefill.req is req)
                or (req.slot is not None and self.active.get(req.slot) is req)
                or any(q is req for q in self.queue))

    # ------------------------------------------------------------------ migration
    def migrate_out(self, req, key, on_ready):
        """Release ``req`` with its KV parked in the store under ``key``
        (the replica set's migrate hook, on this scheduler's pump thread,
        right after the final prefill sync delivered its tokens).
        ``on_ready(entry or None)`` fires once the handoff entry is
        claimable (None: the fetch failed). Returns the rows parked."""
        slot = req.slot
        kv_len = int(self.cache.lengths[slot])
        # demote first, release after: the rows are gathered into fresh
        # memory, so the slot is reusable at once, and a failure here
        # propagates while this scheduler still owns the request
        t0 = time.perf_counter() if self._gap is not None else 0.0
        self.kv_tier.demote_request(slot, kv_len, key, on_ready)
        if self._gap is not None:
            self._gap.add("tier_transfer", time.perf_counter() - t0)
        if self.capacity is not None:
            # handoff traffic: no token comes out of moving these bytes
            self.capacity.account(0, wasted_bytes=kv_len * self.cache.bytes_per_token())
        req.migrating = True
        del self.active[slot]
        # retained cached: the prompt prefix _finish_prefill registered
        # stays a donor here
        self._release_slot(slot)
        self.migrations_out += 1
        req.slot = None
        if req.trace is not None and req.trace.enabled:
            req.trace.mark("migration")
            req.trace.instant("migrate_out", replica=self.replica_idx, kv_len=kv_len)
        return kv_len

    def _settle_migration(self, record, error=None, discard=True):
        """End a failed or cancelled handoff: the request done (with
        ``error`` unless the client cancelled it), its parked entry
        dropped, and the outcome counted. Returns ``"settled"``."""
        req = record.req
        if error is not None and not req.cancelled:
            req.error = error
        req.done = True
        req.migrating = False
        if discard and record.entry is not None:
            self.kv_tier.store.discard(record.key)
        tel = self.telemetry
        if tel.enabled:
            tel.counter("serving/cancelled" if req.cancelled else "serving/migrations_failed")
        if req.trace is not None:
            req.trace.instant("cancelled" if req.cancelled else "failed", where="migration")
        return "settled"

    def admit_migration(self, record):
        """Admit a migrated request (this scheduler's pump thread, the decode
        half of the handoff). Returns ``"resumed"`` when it decodes here,
        ``"settled"`` when it ended without a slot (cancelled mid-handoff, a
        failed demote, another weights version), None when no slot is free
        (it stays parked). A restore that raises settles the request as
        failed first, then re-raises."""
        req = record.req
        tel = self.telemetry
        if req.cancelled or record.entry is None:
            return self._settle_migration(
                record, error="migration failed: KV handoff device->host fetch failed")
        if record.version != int(self.cache.weights_version):
            return self._settle_migration(
                record, error="migration failed: weights version changed while the handoff was "
                              "parked (stale KV must not decode)")
        slot = self.cache.alloc(owner=req.rid)
        if slot is None and self.radix is not None:
            victim = self.radix.evict_lru()
            if victim is not None:
                self.cache.reclaim(victim)
                if tel.enabled:
                    tel.counter("serving/prefix_cache_evict")
                slot = self.cache.alloc(owner=req.rid)
        if slot is None:
            return None
        try:
            t0 = time.perf_counter() if self._gap is not None else 0.0
            ok = self.kv_tier.restore_request(record.entry, slot, record.kv_len)
            if self._gap is not None:
                self._gap.add("tier_transfer", time.perf_counter() - t0)
            if ok:
                if self.capacity is not None:
                    self.capacity.account(0, wasted_bytes=record.kv_len * self.cache.bytes_per_token())
                self.cache.adopt_rows(slot, record.kv_len, record.version)
        except Exception:
            # the record is consumed: settle and free before propagating, so
            # no slot leaks and no request is left without an owner
            self.cache.free(slot)
            self._settle_migration(record, error="migration failed: KV restore raised on the "
                                                 "decode replica")
            raise
        if not ok:
            self.cache.free(slot)
            return self._settle_migration(
                record, discard=False,
                error="migration failed: handoff entry dropped before the decode replica claimed it")
        req.slot = slot
        req.migrating = False
        self.active[slot] = req
        self.migrations_in += 1
        if req.handle is not None:
            # result() now pumps the scheduler that owns the request
            req.handle._sched = self
        if req.trace is not None and req.trace.enabled:
            req.trace.phase("migration", replica=self.replica_idx, kv_len=record.kv_len)
            req.trace.instant("migrated", replica=self.replica_idx, replica_kv_len=record.kv_len)
        return "resumed"

    # ------------------------------------------------------------------ loop
    def step(self):
        """One scheduler iteration: settle cancellations; admit at most one
        chunked prefill (monolithic: prefill a queued request into every
        free slot); then one fused chunk sync while a prefill is in flight,
        else a speculative verify sync (with a drafter) or ``steps_per_sync``
        decode steps. Returns tokens delivered."""
        tel = self.telemetry
        t0 = tel.now()
        tracing = tel.enabled and getattr(tel, "trace_requests", False)
        self._iter_links = [] if tracing else None
        if self.capacity is not None:
            # every Nth sync is fenced and timed for the capacity gauges
            self._sync_seq += 1
            self._cap_sample = self.capacity.should_sample(self._sync_seq)
        self._reap_cancelled()
        if self._parked or self.cache.chain:
            # extent paging, before admission: parked rows restore their
            # demoted extents (a freed row un-parks a live request before
            # new work is admitted), lossy rows drop extents that slid out
            # of their window
            self._service_long_context()
        while self.queue and self.queue[0].cancelled:
            self.queue.popleft().done = True
        delivered = admitted = 0
        if self.prefill_chunk <= 0:
            while self.queue and self.cache.active_slots < self.cache.num_slots:
                req = self.queue.popleft()
                if req.cancelled:
                    req.done = True
                    continue
                delivered += self._admit(req)
                admitted += 1
        elif self._prefill is None and self.queue:
            pick = next((i for i, r in enumerate(self.queue) if not r.cancelled), None)
            if pick is not None:
                req = self.queue[pick]
                slot, match = self._acquire_slot(req)
                if slot is not None:
                    del self.queue[pick]
                    self._begin_prefill(req, slot, match)
                    admitted = 1
        self.admitted += admitted
        if self._gap is not None:
            # everything since t0 was host-side admission work (the trie
            # probe inside _acquire_slot re-files its share)
            self._gap.add("admission", tel.now() - t0)
        if admitted and tel.enabled:
            tel.counter("serving/admitted", admitted)
        if self._prefill is not None:
            kind = "fused"
            n, ksteps = self._fused_chunk_step()
        elif self.active:
            if self._parked and all(s in self._parked for s in self.active):
                # nothing can dispatch and nothing can free a row: every live
                # request waits on a restore that needs a free row
                self._iter_links = None
                raise RuntimeError("long-context paging deadlock: every live request is parked "
                                   "on demoted extents and no free pool row exists to restore "
                                   "into; demote fewer extents or leave slot headroom")
            kind = "spec" if self.drafter is not None else "decode"
            n, ksteps = self._spec_decode_step() if self.drafter is not None else self._decode_step()
        else:
            self._iter_links = None
            return delivered
        delivered += n
        self.decode_steps += ksteps
        self._iter += 1
        if tel.enabled:
            self._record_step(t0, kind, n, ksteps, tracing)
        self._iter_links = None
        return delivered

    def _record_step(self, t0, kind, delivered, ksteps, tracing):
        """One sync's counters, histograms, gauges, goodput and (with request
        tracing) its ``sched/step`` span."""
        tel = self.telemetry
        dur_ms = (tel.now() - t0) * 1e3
        tel.counter("serving/decode_steps", ksteps)
        tel.counter("serving/decode_tokens", delivered)
        tel.histogram("serving/step_ms", dur_ms / ksteps)
        tel.histogram("serving/tokens_per_step", delivered / ksteps)
        tel.gauges([("serving/slot_occupancy", self.cache.occupancy(), None),
                    ("serving/batch_efficiency", delivered / (ksteps * self.cache.num_slots), None),
                    ("serving/kv_token_utilization", self.cache.token_utilization(), None),
                    ("serving/kv_bytes_live", self.cache.live_bytes(), None)])
        if self.capacity is not None:
            # goodput: tokens delivered vs computed-then-discarded (the
            # rejected speculative columns of this sync)
            rejected = (self.spec_drafted - self.spec_accepted) - self._goodput_spec_seen
            self._goodput_spec_seen += rejected
            live_lens = [int(self.cache.lengths[s]) for s in self.active]
            ctx = (sum(live_lens) / len(live_lens)) if live_lens else 0.0
            self.capacity.account(delivered, wasted_tokens=max(0, rejected), ctx=ctx)
        if tracing:
            # the shared per-iteration span: request phases that landed
            # this sync flow-link to it via _iter_links
            tel.record_span("sched/step", t0, tel.now() - t0,
                            attrs={"iter": self._iter, "kind": kind, "live": len(self.active),
                                   "delivered": delivered},
                            flow_out=self._iter_links or None)

    def _trace_link(self, trace):
        """Mint a flow id binding a request phase to the sync in flight
        (registered on this iteration's ``sched/step`` span); None when
        tracing is off or no traced sync is active."""
        if trace is None or self._iter_links is None or not trace.enabled:
            return None
        fid = trace.link()
        self._iter_links.append(fid)
        return fid

    def _open_dispatch(self):
        """The first device work of a sync: the host gap closes and, on a
        sampled sync, the device is drained so the wall time to the sync's
        fetch is this dispatch alone. Returns the dispatch's start time,
        or None with the sink disabled."""
        if self._gap is None:
            return None
        self._gap.dispatch(time.perf_counter())
        if self._cap_sample and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _close_dispatch(self, t0, t_fetch, key, live_ctx, kv_mult=1):
        """The sync's fetch returned: the device idles and the host gap
        opens. ``t0``: the dispatch's start (``_open_dispatch``); ``t_fetch``:
        when the fetch was called (every launch of the sync enqueued). A
        sampled sync folds its wall time into the capacity gauges."""
        t = time.perf_counter()
        self._gap.sync_end(t)
        tel = self.telemetry
        launch_ms, wait_ms = (t_fetch - t0) * 1e3, (t - t_fetch) * 1e3
        tel.histogram("serving/sync_launch_ms", launch_ms)
        tel.histogram("serving/sync_wait_ms", wait_ms)
        if self.replica_idx is not None:
            tel.histogram(f"serving/replica/{self.replica_idx}/sync_launch_ms", launch_ms)
            tel.histogram(f"serving/replica/{self.replica_idx}/sync_wait_ms", wait_ms)
        if self._cap_sample:
            self._cap_sample = False  # one fenced dispatch per sampled sync
            self.capacity.observe_dispatch(key, t - t0, live_ctx, kv_mult)

    def _release_slot(self, slot):
        """Return a finished/cancelled request's slot: retained (state
        ``cached``) when the radix trie references its prefix, else freed.
        Retained lengths clamp to the registered prompt prefix (decode and
        K-step overshoot rows are garbage for reuse)."""
        if self.radix is not None and self.cache.refs[slot] > 0:
            self.cache.lengths[slot] = min(int(self.cache.lengths[slot]),
                                           self.radix.registered_len(slot))
            self.cache.retain(slot)
        else:
            self.cache.free(slot)

    def _drop_parked(self, slot, req):
        """Forget a departing request's extent-paging state: the slot leaves
        the parked set and its host-parked extent entries are discarded
        (a finished or cancelled request's demoted KV dies with it)."""
        if not self._parked and not self._ext_parked:
            return
        self._parked.discard(slot)
        for key in [k for k in self._ext_parked if k[0] == req.rid]:
            del self._ext_parked[key]
            if self.kv_tier is not None:
                self.kv_tier.store.discard((_EXT_NS, self.uid, req.rid, key[1]))

    def _reap_cancelled(self):
        """Evict slots whose requests were cancelled. Runs only from step(),
        so eviction never races a dispatch."""
        tel = self.telemetry
        for slot, req in list(self.active.items()):
            if req.cancelled and not req.done:
                req.done = True
                del self.active[slot]
                self._release_slot(slot)
                self._drop_parked(slot, req)
                if tel.enabled:
                    tel.counter("serving/cancelled")
                if req.trace is not None:
                    req.trace.instant("cancelled", where="decode", tokens=len(req.out))
        if self._prefill is not None and self._prefill.req.cancelled:
            req = self._prefill.req
            req.done = True
            self._release_slot(req.slot)  # mid-prefill slots are never registered
            self._prefill = None
            if tel.enabled:
                tel.counter("serving/cancelled")
            if req.trace is not None:
                req.trace.instant("cancelled", where="prefill")

    # ------------------------------------------------------------ long context
    def _ext_operands(self, rows):
        """The extent operand block of ONE dispatch, over the full slot axis:
        ``(ext_table (N, E), wslot (N,), ext_base (N,), sinks (N,), wins
        (N,))`` int32 tensors on the device, or None when no row of
        ``rows`` (the dispatch's live rows) needs it (no chain in the pool,
        no lossy window): the dispatch then runs the pre-extent path
        unchanged. Rows without a chain get the identity single-extent
        table; dropped extents carry -1. ``wslot``/``ext_base`` put each
        live row's writes into its WRITE extent's pool row.

        Every dead row writes too (its span-0 columns rewrite old bytes,
        ``span_write``), so it gets a pool row of its own that no live row
        writes: its own row where that is free of live writes, else one of
        the rows left over (a chain's primary row while the chain writes
        another extent). There are exactly as many such rows as dead rows,
        so no two columns of a dispatch target one (row, offset); a dead
        row keeping its identity ``wslot`` could hit the row a chain writes
        when that row is itself a dead (``extent``) dispatch row."""
        if not self.cache.chain and not any(r.kv_window is not None for _, r in rows):
            return None
        N, S = self.cache.num_slots, self.max_len
        E = max(1, self.cache.max_extents)
        ext = np.full((N, E), -1, np.int32)
        ext[:, 0] = np.arange(N, dtype=np.int32)
        wslot = np.full(N, -1, np.int32)
        base = np.zeros(N, np.int32)
        sinks = np.zeros(N, np.int32)
        wins = np.zeros(N, np.int32)
        for slot, req in rows:
            members = self.cache.extents(slot)
            ext[slot, :len(members)] = members
            w = min(int(self.cache.lengths[slot]) // S, len(members) - 1)
            wslot[slot] = max(int(members[w]), 0)
            base[slot] = w * S
            if req.kv_window is not None:
                sinks[slot], wins[slot] = req.kv_window
        written = set(int(w) for w in wslot if w >= 0)
        dead = [b for b in range(N) if wslot[b] < 0]
        spare = iter(sorted(set(range(N)) - written - set(dead)))
        for b in dead:
            wslot[b] = b if b not in written else next(spare)
        return tuple(torch.from_numpy(a).to(self.device) for a in (ext, wslot, base, sinks, wins))

    def demote_cold_extents(self, slot, keep_recent=1):
        """Page a live multi-extent request's COLD extents out of the pool.
        Extent 0 (the attention-sink prefix, pinned) and the write extent
        (plus ``keep_recent - 1`` extents before it) stay resident; extents
        past the write head hold nothing and are skipped. Lossless (no
        ``kv_window`` on the request): each demoted extent is copied to the
        hierarchical KV tier and the row is PARKED, skipping every dispatch
        until :meth:`step`'s paging pump has restored them all, so the
        stream stays bitwise the same; without the tier this raises. A lossy
        request (``kv_window``) drops the rows outright: its sliding-window
        mask already hides every position they held. Returns the number of
        extents demoted."""
        req = self.active.get(slot)
        if req is None:
            raise ValueError(f"slot {slot} is not a live decode row")
        members = self.cache.extents(slot)
        if len(members) <= 1:
            return 0
        lossy = req.kv_window is not None
        if not lossy and self.kv_tier is None:
            raise ValueError("lossless extent demotion requires the hierarchical KV tier "
                             "(continuous_batching.hierarchical_kv) for the host-side copy; "
                             "enable it, or submit the request with kv_window for the lossy "
                             "sliding-window mode")
        S = self.max_len
        tel = self.telemetry
        w = min(int(self.cache.lengths[slot]) // S, len(members) - 1)
        keep = {max(0, w - i) for i in range(max(1, int(keep_recent)))}
        demoted = 0
        for idx in range(1, len(members)):
            if idx in keep or idx > w or members[idx] < 0:
                continue
            if not lossy:
                # the rows go to fresh memory first: the cache-level demote
                # frees the pool row
                self._ext_parked[(req.rid, idx)] = self.kv_tier.demote_extent(
                    members[idx], (_EXT_NS, self.uid, req.rid, idx))
            self.cache.demote_extent(slot, idx)
            demoted += 1
            self.longctx_demotes += 1
            if tel.enabled:
                tel.counter("serving/longctx_demote_tokens", S)
            if self.capacity is not None and not lossy:
                # paging traffic, not tokens
                self.capacity.account(0, wasted_bytes=S * self.cache.bytes_per_token())
        if demoted and not lossy:
            self._parked.add(slot)
        return demoted

    def _service_long_context(self):
        """Extent paging, once per scheduler iteration: lossy rows
        (``kv_window``) drop every extent that has slid entirely out of their
        attention sink and recent window (the window's trailing edge only
        advances, so a dropped extent is never needed again); parked rows
        (lossless :meth:`demote_cold_extents`) restore every missing extent
        into free pool rows, evicting LRU radix prefixes under pressure,
        and rejoin the batch once the last one lands."""
        tel = self.telemetry
        S = self.max_len
        for slot, req in list(self.active.items()):
            if req.kv_window is None or slot not in self.cache.chain:
                continue
            sink, recent = req.kv_window
            length = int(self.cache.lengths[slot])
            members = self.cache.extents(slot)
            for idx in range(1, len(members)):
                if members[idx] >= 0 and idx * S >= sink and (idx + 1) * S <= length - recent:
                    self.cache.demote_extent(slot, idx)
                    self.longctx_demotes += 1
                    if tel.enabled:
                        tel.counter("serving/longctx_demote_tokens", S)
        for slot in sorted(self._parked):
            req = self.active.get(slot)
            if req is None or req.cancelled:
                continue  # _reap_cancelled owns the teardown
            restored_all = True
            for idx in self.cache.missing_extents(slot):
                row = self.cache.restore_extent(slot, idx)
                while row is None and self.radix is not None:
                    victim = self.radix.evict_lru()
                    if victim is None:
                        break
                    self.cache.reclaim(victim)
                    if tel.enabled:
                        tel.counter("serving/prefix_cache_evict")
                    row = self.cache.restore_extent(slot, idx)
                if row is None:
                    restored_all = False  # free list dry: retry next iteration
                    break
                entry = self._ext_parked.pop((req.rid, idx), None)
                if entry is None:
                    raise RuntimeError("long-context paging invariant violated: a demoted extent "
                                       "has no parked host entry to restore from")
                t0 = time.perf_counter() if self._gap is not None else 0.0
                ok = self.kv_tier.restore_extent(entry, row)
                if self._gap is not None:
                    self._gap.add("tier_transfer", time.perf_counter() - t0)
                if not ok:
                    raise RuntimeError("long-context paging invariant violated: a parked extent "
                                       "entry vanished from the host store while its request "
                                       "was live")
                self.longctx_restores += 1
                if tel.enabled:
                    tel.counter("serving/longctx_restore_tokens", S)
                if self.capacity is not None:
                    self.capacity.account(0, wasted_bytes=S * self.cache.bytes_per_token())
            if restored_all:
                self._parked.discard(slot)

    # ------------------------------------------------------------------ admit
    def _acquire_slot(self, req):
        """A free slot for admission plus the radix match for ``req``'s
        prompt, matched BEFORE any eviction (reclaiming a cached slot drops
        its registration). When the free list is dry, reclaims the LRU
        cached slot, sparing the matched donor when another exists. Returns
        ``(slot, (matched_len, donor))``; slot is None when every slot
        serves a live request.

        A request longer than one extent reserves its WHOLE chain (prompt +
        row budget) up front, all or nothing, evicting LRU radix slots for
        room: extents claimed lazily could deadlock mid-decode with nothing
        evictable. Chains skip radix reuse both ways (donors are
        single-extent slots, and a chained slot is never retained)."""
        tel = self.telemetry
        n_ext = self.cache.extents_needed(req.prompt.size + req.row_budget)
        if n_ext > 1:
            slot = self.cache.alloc_chain(n_ext, owner=req.rid)
            while slot is None and self.radix is not None:
                victim = self.radix.evict_lru()
                if victim is None:
                    break
                self.cache.reclaim(victim)
                if tel.enabled:
                    tel.counter("serving/prefix_cache_evict")
                slot = self.cache.alloc_chain(n_ext, owner=req.rid)
            return slot, (0, None)
        if self.radix is not None:
            t0 = time.perf_counter() if self._gap is not None else 0.0
            match = self.radix.match(req.prompt)
            if self._gap is not None:
                # the probe ran inside the admission region step() stamps:
                # re-file its share so the buckets stay disjoint
                self._gap.add("trie_probe", time.perf_counter() - t0, steal_from="admission")
        else:
            match = (0, None)
        slot = self.cache.alloc(owner=req.rid)
        if slot is None and self.radix is not None:
            victim = self.radix.evict_lru(prefer_not=match[1])
            if victim is not None:
                self.cache.reclaim(victim)
                if tel.enabled:
                    tel.counter("serving/prefix_cache_evict")
                slot = self.cache.alloc(owner=req.rid)
        return slot, match

    def _begin_prefill(self, req, slot, match=(0, None)):
        """Seed ``slot`` with the longest matched prefix (``copy_slot``) and
        leave the suffix to the fused chunk steps. Matches are capped at
        ``prompt - 1`` (the last prompt token must run through the model)
        and rounded DOWN to a ``prefill_chunk`` multiple, so a hit replays
        the cold path's exact chunk boundaries."""
        tel = self.telemetry
        req.slot = slot
        pos = 0
        tr = req.trace
        if tr is not None and tr.enabled:
            tr.mark("prefill")  # the phase closes at _finish_prefill
            probe_t0 = tel.now()
        if self.radix is not None and slot not in self.cache.chain:
            m, donor = match
            m = min(m, req.prompt.size - 1)
            m = (m // self.prefill_chunk) * self.prefill_chunk
            # the donor may have been the LRU victim reclaimed for this very
            # admission: then it IS our slot, its rows still resident
            if donor is None or not (donor == slot or donor in self.radix._slot_node):
                m = 0
            # hierarchical KV: a host match restores when it beats the device
            # match, rounded and capped as the device hit is, so restored ==
            # device hit == cold run the same chunk boundaries
            hm, entry, restored = 0, None, False
            if self.kv_tier is not None:
                tier_t0 = time.perf_counter() if self._gap is not None else 0.0
                hm, entry = self.kv_tier.probe(req.prompt)
                hm = min(hm, req.prompt.size - 1)
                hm = (hm // self.prefill_chunk) * self.prefill_chunk
                if entry is not None and hm > m and hm >= max(self.prefill_chunk,
                                                              self.kv_tier.min_restore_tokens):
                    restored = self.kv_tier.restore(entry, slot, hm, req.prompt.size)
                if self._gap is not None:
                    # the probe and restore ran inside the admission region
                    # step() stamps: re-file their share
                    self._gap.add("tier_transfer", time.perf_counter() - tier_t0,
                                  steal_from="admission")
            if restored:
                pos = hm
                if tel.enabled:
                    tel.counter("serving/prefix_cache_restore")
                    tel.counter("serving/prefix_cache_restore_tokens", hm)
            elif m > 0:
                if donor != slot:
                    copy_slot(self.cache.pool, donor, slot)
                pos = m
                self.radix.hits += 1
                self.radix.touch(donor)
                if tel.enabled:
                    tel.counter("serving/prefix_cache_hit")
                    tel.counter("serving/prefix_cache_hit_tokens", m)
            else:
                self.radix.misses += 1
                if tel.enabled:
                    tel.counter("serving/prefix_cache_miss")
            if tel.enabled:
                tel.gauge("serving/prefix_cache_hit_rate", self.radix.hit_rate())
                if self.kv_tier is not None:
                    tel.gauge("serving/kv_tier_hit_rate", self.kv_tier.hit_rate(self.radix))
            if tr is not None and tr.enabled:
                tr.phase("prefix_probe", start=probe_t0, slot=slot, cached_tokens=pos,
                         prompt=int(req.prompt.size), **({"restored": True} if restored else {}))
        self.cache.lengths[slot] = pos
        pf = _PrefillState(req, pos)
        pf.seq_parallel = bool(self._seq_chunk and req.prompt.size >= self.seq_parallel_min_tokens)
        if tel.enabled:
            tel.histogram("serving/kv_extents_per_request", len(self.cache.extents(slot)))
            if pf.seq_parallel:
                tel.counter("serving/seq_parallel_prefills")
        self._prefill = pf

    @torch.inference_mode()
    def _admit(self, req):
        """Monolithic prefill of ``req`` into a free slot: the prompt
        right-padded to its bucket, one single-slot forward, the last real
        token's logits sampled for token 0 at step 0. A failed prefill frees
        its slot. Returns tokens delivered (1)."""
        slot = self.cache.alloc(owner=req.rid)
        if slot is None:
            raise RuntimeError("monolithic admission found no free slot")
        req.slot = slot
        L = req.prompt.size
        Pb = _bucket_len(L, self.prefill_bucket, self.max_len)
        ids = np.zeros((1, Pb), np.int64)
        ids[0, :L] = req.prompt
        tel = self.telemetry
        t_pf = tel.now()
        try:
            t0 = self._open_dispatch()
            model = self.engine.module
            cache = slot_slice(self.cache.pool, slot)
            # the forward writes the slot's rows in place, through the views
            # (the JAX package's slot_update of its functional pool)
            logits, _ = model.apply_with_cache(self.engine.net, torch.from_numpy(ids).to(self.device),
                                               cache, 0)
            logits = _replicate_logits(logits, model.cfg.vocab_size, self._shard_deg)
            last = logits[:, L - 1].float()  # (1, V)
            samp, sampling, _ = self._gather_sampling([(0, req)], rows=1)
            if sampling:
                t = [torch.from_numpy(a).to(self.device) for a in samp]
                tok = sample_rows(last, t[0], t[1], t[2] > 0, t[3], t[4], t[5])
            else:
                tok = last.argmax(-1)
            t_fetch = time.perf_counter() if t0 is not None else 0.0
            tok = int(tok.cpu()[0])
            last_logits = last[0].cpu().numpy() if req.collect_logits else None
            if t0 is not None:
                self._close_dispatch(t0, t_fetch, ("prefill", Pb), [L])
        except Exception:
            # a failed prefill must not strand its slot
            self.cache.free(slot)
            raise
        self.dispatched[("prefill", Pb)] += 1
        self.cache.lengths[slot] = L
        self.active[slot] = req
        req.first_token_ts = time.perf_counter()
        ttft_ms = (req.first_token_ts - req.submit_ts) * 1e3
        if tel.enabled:
            # the monolithic prefill stalls every live decode row for the
            # whole prompt (chunked prefill bounds it at one chunk)
            tel.histogram("serving/prefill_stall_ms", (tel.now() - t_pf) * 1e3)
            tel.histogram("serving/ttft_ms", ttft_ms)
            tel.gauge("serving/queue_depth", len(self.queue))
        tr = req.trace
        if tr is not None and tr.enabled:
            tr.phase("prefill", start=t_pf, prompt=int(L), monolithic=True,
                     ttft_ms=round(ttft_ms, 3))
            tr.mark("decode")
        if last_logits is not None:
            req.logits.append(last_logits)
        self._deliver(req, tok)
        return 1

    def _finish_prefill(self, req, tok, last_logits):
        """The final chunk landed: register the prompt in the radix trie
        (live prefixes serve as donors too), move the row to decode and
        deliver token 0."""
        self._prefill = None
        self.active[req.slot] = req
        if self.radix is not None and req.slot not in self.cache.chain:
            if self.kv_tier is not None:
                # a cold or device-hit prefill supersedes this scheduler's own
                # host copy of the same prompt (a restore consumes it; a match
                # rounded below a chunk or beaten by the device leaves it)
                self.kv_tier.discard_exact(req.prompt)
            self.radix.insert(req.slot, req.prompt)
        req.first_token_ts = time.perf_counter()
        ttft_ms = (req.first_token_ts - req.submit_ts) * 1e3
        tel = self.telemetry
        if tel.enabled:
            tel.histogram("serving/ttft_ms", ttft_ms)
            tel.gauge("serving/queue_depth", len(self.queue))
        tr = req.trace
        if tr is not None and tr.enabled:
            tr.phase("prefill", prompt=int(req.prompt.size), ttft_ms=round(ttft_ms, 3))
            tr.mark("decode")  # the phase closes when the request finishes
        if req.collect_logits and last_logits is not None:
            req.logits.append(last_logits)
        self._deliver(req, tok)

    def _deliver(self, req, tok):
        """Append one generated token; finish on EOS or length budget and
        evict the slot the same iteration."""
        if req.done:  # cancelled elsewhere: never double-free the slot
            return
        req.out.append(tok)
        if ((req.eos_token_id is not None and tok == req.eos_token_id)
                or len(req.out) >= req.max_new_tokens):
            req.done = True
            if req.slot in self.active:
                del self.active[req.slot]
            self._release_slot(req.slot)
            self._drop_parked(req.slot, req)
            self.evicted += 1
            if self.telemetry.enabled:
                self.telemetry.counter("serving/evicted")
            tr = req.trace
            if tr is not None and tr.enabled:
                now = time.perf_counter()
                eos = req.eos_token_id is not None and tok == req.eos_token_id
                n = len(req.out)
                ttft = ((req.first_token_ts - req.submit_ts) * 1e3
                        if req.first_token_ts is not None else 0.0)
                itl = ((now - req.first_token_ts) * 1e3 / (n - 1)
                       if req.first_token_ts is not None and n > 1 else 0.0)
                fid = self._trace_link(tr)
                tr.phase("decode", flow_in=[fid] if fid else None, tokens=n)
                tr.instant("complete", reason="stop" if eos else "length", tokens=n,
                           ttft_ms=round(ttft, 3), itl_ms=round(itl, 4))
        if req.on_token is not None:
            try:
                req.on_token(tok, req.done)
            except Exception:
                from ..utils.logging import logger
                logger.warning("scheduler on_token hook raised", exc_info=True)

    # ------------------------------------------------------------------ steps
    def _gather_sampling(self, live, rows=None):
        """Per-slot sampling rows for a step: (seeds, steps, flags, temps,
        topks, topps, sampling, collect); ``steps`` is each row's ABSOLUTE
        step index, so results are K- and fused-invariant. ``rows``: the
        row count (the pool's slots by default)."""
        N = self.cache.num_slots if rows is None else rows
        t0 = time.perf_counter() if self._gap is not None else 0.0
        seeds = np.zeros(N, np.int64)
        steps = np.zeros(N, np.int64)
        flags = np.zeros(N, np.int64)
        temps = np.ones(N, np.float32)
        topks = np.zeros(N, np.int64)
        topps = np.ones(N, np.float32)
        sampling = collect = False
        for slot, req in live:
            seeds[slot] = req.seed
            steps[slot] = len(req.out)  # prefill consumed step 0
            flags[slot] = req.do_sample
            temps[slot] = req.temperature
            topks[slot] = req.top_k
            topps[slot] = req.top_p
            sampling = sampling or req.do_sample
            collect = collect or req.collect_logits
        if self._gap is not None:
            self._gap.add("sampling_host", time.perf_counter() - t0)
        return [seeds, steps, flags, temps, topks, topps], sampling, collect

    def _forward(self, ids, pos, widx, spans, ext_ops=None, seq_parallel=False):
        """One in-sync forward over the pool; returns (N, C, V) logits. A
        dispatch with extent operands, or a wide seq-parallel chunk
        (``seq_parallel``), goes per projection: the fused decode-layer
        kernels walk no extents and split no columns. A wide chunk takes
        that path at every seq degree, so one rank's stream is the one a
        seq axis of ranks gives, bit for bit (the two paths round in other
        places); with ranks on ``seq`` its span attention splits over them
        (``seq_shard``)."""
        model = self.engine.module
        seq_shard = seq_parallel and self._seq_shards > 1
        if self._fused_block and ext_ops is None and not seq_parallel:
            logits, _ = model.fused_paged_step(self.engine._fast_tree(), ids, self.cache.pool, pos,
                                               widx, spans)
        elif self._moe_stats:
            logits, _, counts = model.apply_with_cache(self.engine.net, ids, self.cache.pool, 0,
                                                       position_ids=pos, write_index=widx,
                                                       q_spans=spans, ext_ops=ext_ops,
                                                       expert_stats=True, seq_shard=seq_shard)
            self._expert_counts = counts if self._expert_counts is None else self._expert_counts + counts
        else:
            logits, _ = model.apply_with_cache(self.engine.net, ids, self.cache.pool, 0,
                                               position_ids=pos, write_index=widx, q_spans=spans,
                                               ext_ops=ext_ops, seq_shard=seq_shard)
        return _replicate_logits(logits, model.cfg.vocab_size, self._shard_deg)

    def _take_expert_counts(self):
        """After a sync's fetch: its summed (L, E) routed-token counts into
        the routing telemetry."""
        if self._expert_counts is None:
            return
        counts, self._expert_counts = self._expert_counts.cpu().numpy(), None
        self._record_expert_stats(counts)

    def _record_expert_stats(self, counts):
        """Routing telemetry from one dispatch's (L, E) counts: total
        token->expert assignments and the per-step load-balance gauge (1.0 =
        tokens spread evenly; 1/E = everything on one expert)."""
        total = int(counts.sum())
        self.expert_dispatch_tokens += total
        tel = self.telemetry
        if not tel.enabled or total == 0:
            return
        tel.counter("serving/expert_dispatch_tokens", total)
        mx = counts.max(axis=1)
        tot = counts.sum(axis=1)
        live = mx > 0
        if live.any():
            E = counts.shape[1]
            tel.gauge("serving/expert_load_balance", float(np.mean(tot[live] / (E * mx[live]))))

    def _device_inputs(self, ids, lens, spans, samp, sampling):
        """A dispatch's host rows on the device, in two host-to-device
        copies: (ids, lens, spans, sample), ``sample(logits (N, V), k)``
        choosing each row's token at its absolute step + k."""
        C = ids.shape[1]
        seeds, steps, flags, temps, topks, topps = samp
        ints = torch.from_numpy(np.concatenate(
            [ids.astype(np.int64), np.stack([lens, spans, seeds, steps, flags, topks], 1)
             .astype(np.int64)], axis=1)).to(self.device)
        floats = torch.from_numpy(np.stack([temps, topps], 1)).to(self.device)
        lens_t, spans_t, seeds_t, steps_t, flags_t, topks_t = ints[:, C:].unbind(1)
        flags_t = flags_t > 0
        temps_t, topps_t = floats.unbind(1)

        def sample(lg, k):
            if not sampling:
                return lg.argmax(-1)
            return sample_rows(lg, seeds_t, steps_t + k, flags_t, temps_t, topks_t, topps_t)

        return ints[:, :C], lens_t, spans_t, sample

    @torch.inference_mode()
    def _run(self, ids, lens, spans, samp, sampling, collect, K, ext_ops=None, hold=None, seq_parallel=False):
        """THE step body: the first forward over the (N, C) ids block with
        per-row spans, then K - 1 single-column decode forwards, all on the
        device with nothing read back until the (K, N) token block (and the
        (K, N, V) logits when collected) comes back at the end. Each row
        continues at its own write head ``lens + max(span, 1) - 1 + k``;
        span-0 (dead or cached) rows write nothing in any forward.
        ``ext_ops``: the dispatch's extent operands (every forward of the
        sync writes inside each row's write extent), or None. ``hold``: the
        row of a non-final prefill chunk in an extent dispatch; it writes
        nothing in the substeps (their tokens are discarded and the next
        chunk rewrites those rows; past a chunk that ends at its extent's
        end they would leave the extent). ``seq_parallel``: the first
        forward is a wide seq-parallel chunk (``_forward``; the
        single-column substeps cannot split)."""
        N, C = ids.shape
        dev = self.device
        t0 = self._open_dispatch()
        ids_t, lens_t, spans_t, sample = self._device_inputs(ids, lens, spans, samp, sampling)
        self.dispatched[(C, K)] += 1
        self.last_shape = (C, K)
        pos = lens_t[:, None] + torch.arange(C, device=dev)[None, :]
        logits = self._forward(ids_t, pos, lens_t, spans_t, ext_ops, seq_parallel)
        self.forwards[C] += 1
        if ext_ops is not None:
            self.ext_forwards[C] += 1
            self.ext_forwards[1] += K - 1
        # each row's LAST live column: decode rows column 0, the prefill row
        # its chunk fill - 1 (dead rows clamp to 0, a token never read)
        last = (spans_t - 1).clamp(min=0)
        V = logits.shape[-1]
        lg = logits.gather(1, last[:, None, None].expand(N, 1, V))[:, 0].float()
        tok = sample(lg, 0)
        toks, lgs = [tok], [lg]
        base = lens_t + spans_t.clamp(min=1) - 1  # per-row write head - 1
        live01 = spans_t.clamp(max=1)  # substep spans: dead rows never write
        if hold is not None:
            live01[hold] = 0
        for k in range(1, K):
            widx = base + k
            logits = self._forward(tok[:, None], widx[:, None], widx, live01, ext_ops)
            self.forwards[1] += 1
            lg = logits[:, 0].float()
            tok = sample(lg, k)
            toks.append(tok)
            lgs.append(lg)
        t_fetch = time.perf_counter() if t0 is not None else 0.0
        toks_k = torch.stack(toks).cpu().numpy()  # the sync's one round trip
        logits_k = torch.stack(lgs).cpu().numpy() if collect else None
        self._take_expert_counts()
        if t0 is not None:
            self._close_dispatch(t0, t_fetch, ("chunk", C, K) if C > 1 else ("decode", K),
                                 lens[spans > 0], self.cache.max_extents if ext_ops is not None else 1)
        return toks_k, logits_k

    def _deliver_block(self, live, toks_k, logits_k, K):
        """Deliver a fetched (K, N) token block to the live rows: each
        row's KV advanced K positions on the device; tokens past EOS or the
        budget were computed but are discarded. Returns tokens delivered."""
        n = 0
        t0 = time.perf_counter() if self._gap is not None else 0.0
        for slot, req in live:
            self.cache.lengths[slot] += K
            for k in range(K):
                if req.done:
                    break
                if req.collect_logits and logits_k is not None:
                    req.logits.append(logits_k[k, slot])
                self._deliver(req, int(toks_k[k, slot]))
                n += 1
        if self._gap is not None:
            self._gap.add("on_token", time.perf_counter() - t0)
        return n

    def _decode_step(self):
        """A pure decode sync: the step at chunk width 1, every live row
        span 1. Dead and cached rows carry span 0 and length 0: their
        writes are dropped and their windows are empty."""
        N = self.cache.num_slots
        live = [(s, r) for s, r in sorted(self.active.items()) if s not in self._parked]
        ids = np.zeros((N, 1), np.int64)
        spans = np.zeros(N, np.int64)
        lens = np.zeros(N, np.int64)
        for slot, req in live:
            ids[slot, 0] = req.out[-1]
            spans[slot] = 1
            lens[slot] = self.cache.lengths[slot]
        samp, sampling, collect = self._gather_sampling(live)
        K = self.steps_per_sync
        eo = self._ext_operands(live)
        if eo is not None and K > 1:
            # a K-step sync writes rows [len, len + K) in the write extent: a
            # row about to cross an extent boundary steps through it one
            # token at a time
            S = self.max_len
            if any(S - int(self.cache.lengths[s]) % S < K for s, _ in live):
                K = 1
        toks_k, logits_k = self._run(ids, lens, spans, samp, sampling, collect, K, eo)
        return self._deliver_block(live, toks_k, logits_k, K), K

    @torch.inference_mode()
    def _verify(self, ids, lens, spans, samp, sampling, collect):
        """The speculative verify: ONE forward over the (N, W) ids block with
        per-row spans (a row's last token and its drafts), every column j
        sampled at the row's step + j. Returns the (W, N) token block and
        the (W, N, V) logits when collected, in one round trip."""
        N, W = ids.shape
        t0 = self._open_dispatch()
        ids_t, lens_t, spans_t, sample = self._device_inputs(ids, lens, spans, samp, sampling)
        self.dispatched[("spec", W)] += 1
        self.last_shape = ("spec", W)
        pos = lens_t[:, None] + torch.arange(W, device=self.device)[None, :]
        logits = self._forward(ids_t, pos, lens_t, spans_t).float()
        self.forwards[W] += 1
        toks = torch.stack([sample(logits[:, j], j) for j in range(W)])
        t_fetch = time.perf_counter() if t0 is not None else 0.0
        toks = toks.cpu().numpy()
        logits = logits.transpose(0, 1).cpu().numpy() if collect else None
        self._take_expert_counts()
        if t0 is not None:
            self._close_dispatch(t0, t_fetch, ("verify", W), lens[spans > 0])
        return toks, logits

    def _spec_decode_step(self):
        """One self-speculative verify sync: the prompt-lookup drafter
        proposes up to ``spec_tokens`` tokens per live row (capped by the
        row's remaining budget and its slot's headroom), one forward
        verifies every column, and each row commits its drafts up to the
        first that differs from the token sampled before it, plus that
        sampled token: between 1 and ``1 + spec_tokens`` tokens a row. The
        rejected columns' KV rows sit past the row's head until later writes
        reclaim them. A sync where no row drafts, or a live row is chained
        or lossy (the verify carries no extent walk), runs the K-step decode
        sync instead; both give the same bits. Returns (tokens delivered,
        1)."""
        N, W = self.cache.num_slots, self._spec_width
        live = [(s, r) for s, r in sorted(self.active.items()) if s not in self._parked]
        if any(s in self.cache.chain or r.kv_window is not None for s, r in live):
            return self._decode_step()
        drafts, total = {}, 0
        for slot, req in live:
            cap = min(W - 1, req.max_new_tokens - len(req.out) - 1,
                      self.max_len - int(self.cache.lengths[slot]) - 1)
            drafts[slot] = (self.drafter.draft(np.concatenate([req.prompt, np.asarray(req.out, np.int32)]),
                                               cap) if cap > 0 else np.empty(0, np.int32))
            total += drafts[slot].size
        if total == 0:
            return self._decode_step()
        ids = np.zeros((N, W), np.int64)
        spans = np.zeros(N, np.int64)
        lens = np.zeros(N, np.int64)
        for slot, req in live:
            d = drafts[slot]
            ids[slot, 0] = req.out[-1]
            ids[slot, 1:1 + d.size] = d
            spans[slot] = 1 + d.size
            lens[slot] = self.cache.lengths[slot]
        samp, sampling, collect = self._gather_sampling(live)
        toks, logits = self._verify(ids, lens, spans, samp, sampling, collect)
        delivered = accepted = 0
        t0 = time.perf_counter() if self._gap is not None else 0.0
        for slot, req in live:
            # acceptance walk: toks[j] is the token sampled after column j;
            # column j + 1 is valid only while its draft equals toks[j]
            m = 1
            while m < spans[slot] and toks[m - 1, slot] == ids[slot, m]:
                m += 1
            self.cache.lengths[slot] += m  # before delivery: a finish releases the slot
            n = 0
            for j in range(m):
                if req.done:  # EOS inside the accepted block ends delivery
                    break
                if req.collect_logits and logits is not None:
                    req.logits.append(logits[j, slot])
                self._deliver(req, int(toks[j, slot]))
                n += 1
            delivered += n
            accepted += max(0, n - 1)
        if self._gap is not None:
            self._gap.add("on_token", time.perf_counter() - t0)
        self.spec_steps += 1
        self.spec_row_steps += len(live)
        self.spec_drafted += total
        self.spec_accepted += accepted
        self.spec_delivered += delivered
        return delivered, 1

    def mean_spec_tokens_per_step(self):
        """Mean tokens delivered per (live row, verify sync): above 1 means
        speculation nets multi-token steps."""
        return self.spec_delivered / self.spec_row_steps if self.spec_row_steps else 0.0

    def _fused_chunk_step(self):
        """One sync over ``(num_slots, prefill_chunk)`` query columns plus
        the remaining ``steps_per_sync - 1`` decode steps: live decode rows
        advance K tokens, the prefill row consumes up to a chunk of prompt
        tokens (and, on its final chunk, starts decoding in the same sync),
        dead rows carry span 0. Returns (tokens delivered, K)."""
        N, S = self.cache.num_slots, self.max_len
        pf = self._prefill
        preq = pf.req
        # seq-parallel prefill: the wide chunk width, sharded over seq when
        # the axis has ranks
        C = self._seq_chunk if pf.seq_parallel else self.prefill_chunk
        L = preq.prompt.size
        # a chunk never crosses an extent boundary: its KV write lands in
        # exactly one extent's pool row
        take = min(C, L - pf.pos, S - pf.pos % S)
        final = pf.pos + take >= L
        ids = np.zeros((N, C), np.int64)
        spans = np.zeros(N, np.int64)
        lens = np.zeros(N, np.int64)
        live = [(s, r) for s, r in sorted(self.active.items()) if s not in self._parked]
        samp, sampling, collect = self._gather_sampling(live)
        for slot, req in live:
            ids[slot, 0] = req.out[-1]
            spans[slot] = 1
            lens[slot] = self.cache.lengths[slot]
        ps = preq.slot
        ids[ps, :take] = preq.prompt[pf.pos:pf.pos + take]
        spans[ps] = take
        lens[ps] = self.cache.lengths[ps]  # prefix copy and/or earlier chunks
        seeds, steps, flags, temps, topks, topps = samp
        seeds[ps] = preq.seed  # steps[ps] stays 0: the prefill samples token 0
        flags[ps] = preq.do_sample
        temps[ps] = preq.temperature
        topks[ps] = preq.top_k
        topps[ps] = preq.top_p
        sampling = sampling or preq.do_sample
        collect = collect or preq.collect_logits
        # substeps pay off only when something decodes in them: live rows,
        # or the prefill row itself once its final chunk lands
        K = self.steps_per_sync if (live or final) else 1
        eo = self._ext_operands(live + [(ps, preq)])
        if eo is not None and K > 1:
            # substep writes stay inside each row's write extent: decode rows
            # need K rows of room; a FINAL chunk's row needs its chunk plus
            # the K - 1 substep rows to fit its extent
            room = [S - int(self.cache.lengths[s]) % S for s, _ in live]
            if final:
                room.append(S - pf.pos % S - take + 1)
            if any(r < K for r in room):
                K = 1
        tel = self.telemetry
        t0 = tel.now()
        toks_k, logits_k = self._run(ids, lens, spans, samp, sampling, collect, K, eo,
                                     hold=None if final or eo is None else ps, seq_parallel=pf.seq_parallel)
        if tel.enabled:
            # the stall co-resident decode rows eat while a chunk rides
            # their sync (measured through the block fetch)
            tel.histogram("serving/prefill_stall_ms", (tel.now() - t0) * 1e3)
        tr = preq.trace
        if tr is not None and tr.enabled:
            fid = self._trace_link(tr)
            tr.phase("prefill_chunk", start=t0, flow_in=[fid] if fid else None, pos=int(pf.pos),
                     take=int(take), final=bool(final))
        delivered = self._deliver_block(live, toks_k, logits_k, K)
        pf.pos += take
        if final:
            # the chunk's rows plus K - 1 substep rows; set before delivery,
            # since a request finishing mid-sync releases the slot
            self.cache.lengths[ps] = L + K - 1
            self._finish_prefill(preq, int(toks_k[0, ps]),
                                 logits_k[0, ps] if (preq.collect_logits and logits_k is not None)
                                 else None)
            delivered += 1
            for k in range(1, K):
                if preq.done:
                    break
                if preq.collect_logits and logits_k is not None:
                    preq.logits.append(logits_k[k, ps])
                self._deliver(preq, int(toks_k[k, ps]))
                delivered += 1
            # disaggregated serving: a prefill-role replica hands the request
            # to the decode side here, after this sync's tokens streamed, with
            # budget left; decode resumes elsewhere from the per-row state
            # this sync left. Chained and lossy-window rows stay: the handoff
            # moves one contiguous slot
            if (not preq.done and self.migrate_hook is not None and ps not in self.cache.chain
                    and preq.kv_window is None):
                self.migrate_hook(self, preq)
        else:
            self.cache.lengths[ps] = pf.pos
        return delivered, K
