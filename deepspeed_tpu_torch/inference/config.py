"""Inference config.

PyTorch counterpart of ``deepspeed_tpu/inference/config.py`` (reference
``deepspeed/inference/config.py``, ``DeepSpeedInferenceConfig``), with the
same keys and dtype map so one config dict serves both packages. Sections
whose subsystem the port does not have yet are accepted while disabled and
raise ``NotImplementedError`` naming the ROADMAP item when enabled.
"""

import torch

from ..runtime.config_utils import DeepSpeedConfigModel, ConfigField
from ..utils.logging import logger

_DTYPE_MAP = {
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp16": torch.bfloat16,  # fp16 requested -> bf16, as in the JAX package
    "float16": torch.bfloat16,
    "half": torch.bfloat16,
    "fp32": torch.float32,
    "float32": torch.float32,
    "float": torch.float32,
    "int8": torch.int8,
}


class TensorParallelConfig(DeepSpeedConfigModel):
    tp_size = ConfigField(default=1)
    enabled = ConfigField(default=True)
    mpu = ConfigField(default=None)
    tp_group = ConfigField(default=None)


class QuantConfig(DeepSpeedConfigModel):
    enabled = ConfigField(default=False)
    qkv = ConfigField(default=None)


class MoEInferenceConfig(DeepSpeedConfigModel):
    enabled = ConfigField(default=True)
    ep_size = ConfigField(default=1)
    moe_experts = ConfigField(default=lambda: [1])
    type = ConfigField(default="standard")


class HierarchicalKVConfig(DeepSpeedConfigModel):
    """Hierarchical KV tier (``deepspeed_tpu/memory/``): radix-evicted
    prefix KV demotes to a fleet-global host store (with optional NVMe
    spill) instead of being destroyed, and admission restores matched
    prefixes ahead of chunked prefill — restored decode is bit-identical to
    a device-resident hit and to cold prefill. The store is shared across
    all scheduler replicas, so any replica can restore a prefix any other
    computed. See ``benchmarks/SERVING.md`` ("Hierarchical KV")."""

    enabled = ConfigField(default=False)
    host_capacity_mb = ConfigField(default=256, help="host-RAM budget for demoted "
                                   "prefix KV (fleet-wide); LRU entries past it "
                                   "spill to nvme_path, or drop when no NVMe tier "
                                   "is configured")
    nvme_path = ConfigField(default=None, help="directory for spilled prefix KV "
                            "(one flat file per entry, read back through the "
                            "shared AIO read window with submit-time look-ahead); "
                            "None disables the NVMe tier")
    restore_min_tokens = ConfigField(default=0, help="restore-vs-recompute "
                                     "threshold: host matches shorter than this "
                                     "(after prefill_chunk rounding) chunk-prefill "
                                     "cold instead of paying the host->device "
                                     "copy; 0 = one chunk (the structural floor)")


class DisaggregationConfig(DeepSpeedConfigModel):
    """Disaggregated prefill/decode serving (DistServe/Splitwise on the
    replica fleet, ``serving/replica.py``): replicas carry a phase role —
    ``prefill``, ``decode``, or ``mixed`` — the gateway places new prompts
    only on prefill-capable replicas, and when a prompt's chunked prefill
    completes on a ``prefill`` replica its KV migrates to a decode replica
    through the hierarchical-KV host staging layer (``memory/``), where
    decode resumes bit-identically to a single-replica run. TTFT (prefill
    capacity) and ITL (decode capacity) become independently tunable; a
    long prefill can no longer stall co-resident decodes. Requires the
    chunked-prefill radix path; the prefix store is created automatically
    when ``hierarchical_kv`` is off. See ``benchmarks/SERVING.md``
    ("Disaggregated prefill/decode")."""

    enabled = ConfigField(default=False)
    roles = ConfigField(default=list, help="per-replica phase roles by index "
                        "(e.g. ['prefill', 'decode']); replicas past the end "
                        "of the list run 'mixed' (both phases, no migration). "
                        "At least one prefill-capable AND one decode-capable "
                        "replica are required when any role is non-mixed. "
                        "Runtime override: POST /v1/replicas/<i>/role")
    migrate_min_tokens = ConfigField(default=0, help="colocate threshold: a "
                                     "prompt SHORTER than this decodes on the "
                                     "prefill replica that computed it instead "
                                     "of migrating (the device->host->device "
                                     "round trip is not worth it for tiny "
                                     "prompts); 0 migrates everything")


class MultihostConfig(DeepSpeedConfigModel):
    """Multi-host serving (``serving/router.py``): this process joins a
    cross-process worker fleet behind a router tier. The worker registers
    with the router, heartbeats the gateway's capacity signals (the same
    dict the local Retry-After reads), and swaps its KV-tier store for a
    networked shard (``memory/net_store.py``) so cross-HOST prefix restore
    and prefill->decode handoff work exactly like their cross-replica
    versions — weights-version stamps and the pinned-entry protocol stay
    the consistency contract. ``python -m deepspeed_tpu.serving --worker``
    sets these from flags. See ``benchmarks/SERVING.md`` ("Multi-host
    serving")."""

    router_url = ConfigField(default=None, help="router base URL (e.g. "
                             "http://10.0.0.1:8800); None = standalone "
                             "single-process serving (everything off)")
    worker_id = ConfigField(default=None, help="stable fleet-unique worker id; "
                            "default w<pid>. Re-registering an id tells the "
                            "router the process RESTARTED (its shard is empty), "
                            "so keep ids stable across restarts, unique across "
                            "live workers")
    worker_role = ConfigField(default="mixed", help="process-level phase role "
                              "(prefill/decode/mixed): 'prefill' workers hand "
                              "finished prefills to decode workers through the "
                              "networked shard; conflicts with in-process "
                              "disaggregation roles — pick ONE phase split")
    heartbeat_interval_s = ConfigField(default=2.0, help="capacity-signal "
                                       "heartbeat cadence (owner-side lease "
                                       "reaping rides the same timer)")
    heartbeat_timeout_s = ConfigField(default=10.0, help="router-side: a worker "
                                      "silent this long stops receiving "
                                      "placements (marked sick) until it "
                                      "heartbeats again")
    lease_s = ConfigField(default=30.0, help="handoff claim deadline: a parked "
                          "cross-process handoff nobody resumed within this "
                          "window is reclaimed (owner frees the pinned entry, "
                          "router drops the directory record)")
    net_timeout_s = ConfigField(default=30.0, help="per-call timeout for "
                                "worker<->router control traffic and "
                                "worker<->worker KV fetches")
    advertise_host = ConfigField(default=None, help="host other processes dial "
                                 "to reach this worker; default = the gateway "
                                 "bind host (set this when binding 0.0.0.0)")
    migrate_min_tokens = ConfigField(default=0, help="colocate threshold for "
                                     "cross-process handoff, same semantics as "
                                     "disaggregation.migrate_min_tokens but the "
                                     "round trip now crosses hosts")


class ExpertOffloadConfig(DeepSpeedConfigModel):
    """Cold-expert host offload (``deepspeed_tpu/moe/expert_store.py``):
    MoE expert kernels leave the device param tree at engine build and page
    through per-(layer, expert) device pools — LRU residency, hot-loads
    through the shared streaming layer, detect-miss-and-replay dispatch —
    so a model whose experts exceed HBM still decodes through the
    continuous-batching scheduler. Exact: replayed steps rewrite every KV
    row the garbage forward wrote, and all-hot paged output is bit-identical
    to the in-tree path. Scheduler path only (chunked prefill, scan_layers,
    expert mesh axis 1). See ``benchmarks/SERVING.md`` ("MoE serving")."""

    enabled = ConfigField(default=False)
    resident_experts = ConfigField(default=0, help="device pages per layer (the "
                                   "HBM budget knob): 0 = all experts resident "
                                   "(paging machinery, no memory saving). Must "
                                   "be >= moe_top_k — a single token's per-layer "
                                   "demand — and a step whose per-layer routing "
                                   "demand exceeds it is served by the backoff "
                                   "ladder (smaller sync / chunk / row groups), "
                                   "so undersizing costs replays, not "
                                   "correctness")


class MultiLoRAConfig(DeepSpeedConfigModel):
    """Multi-tenant adapter serving (``deepspeed_tpu/adapters/``): paged
    LoRA store + batched mixed-adapter decode. Adapter (A, B) pages live in
    rank-bucketed device pools; per-request ``adapter_id`` selects the
    variant, heterogeneous-adapter batches decode through ONE fused program
    (per-row gather — compile count O(1) in adapter count/mix/churn), and
    cold adapters LRU hot-load/evict through the shared streaming layer.
    See ``benchmarks/SERVING.md`` ("Multi-LoRA serving")."""

    enabled = ConfigField(default=False)
    pool_slots = ConfigField(default=4, help="resident adapters per rank bucket "
                             "(on top of the reserved all-zero base page); more "
                             "slots = less load/evict churn at more HBM")
    rank_buckets = ConfigField(default=lambda: [8], help="pow2 LoRA rank tiers; "
                               "an adapter lands in the smallest bucket holding "
                               "its rank (zero-padded). One pool pair per "
                               "projection site per bucket — each bucket adds "
                               "its gather cost to every mixed-adapter step, so "
                               "keep the list short")


class LongContextConfig(DeepSpeedConfigModel):
    """Long-context serving (``inference/scheduler.py`` +
    ``inference/kv_cache.py``): requests whose context exceeds one slot
    extent span chained pool slots through the extent-walking paged
    kernels, their prefill optionally sharded over the ``seq`` mesh axis,
    and cold extent ranges optionally paged to the host tier mid-decode.
    See benchmarks/SERVING.md ("Long-context serving")."""

    max_extents = ConfigField(default=1, help="pool slots ONE request may chain "
                              "(spannable capacity = max_len x max_extents); the "
                              "extent count is a runtime operand, so any value "
                              "keeps the compiled-program count O(1). 1 disables "
                              "chaining (byte-identical pre-extent programs); "
                              "> 1 requires chunked prefill + flash attention")
    seq_parallel_min_tokens = ConfigField(default=0, help="prompts at or above "
                                          "this length prefill at the sequence-"
                                          "parallel chunk width (sharded over "
                                          "the seq mesh axis when it has "
                                          "devices) — bit-identical to the "
                                          "single-shard chunked path; 0 "
                                          "disables seq-parallel prefill")
    seq_parallel_degree = ConfigField(default=0, help="seq-parallel chunk width "
                                      "multiplier: the wide chunk is "
                                      "degree x prefill_chunk (clamped to the "
                                      "slot extent); 0 = the seq mesh axis size")
    allow_lossy_kv = ConfigField(default=False, help="permit per-request "
                                 "kv_window=(sink, recent) lossy sliding-window "
                                 "attention (StreamingLLM): out-of-window "
                                 "extents drop from HBM without a host copy. "
                                 "CHANGES LOGITS — off by default, and requests "
                                 "must still opt in per-call")


class AutoscalerConfig(DeepSpeedConfigModel):
    """Elastic fleet control plane (``serving/controller.py``): an
    SLO-driven :class:`FleetController` ticked from the replica-0 pump
    that scales the replica fleet, re-balances prefill/decode roles, and
    runs a brownout load-shedding ladder. Policy-as-config: every
    threshold below is a decision input; the decision function itself is
    pure (no wall clock) and every decision is an ``autoscale/decision``
    telemetry event. See benchmarks/SERVING.md ("Elastic fleet")."""

    enabled = ConfigField(default=False)
    dry_run = ConfigField(default=False, help="evaluate and RECORD decisions "
                          "(events, /v1/autoscaler) without actuating — the "
                          "rollout mode: watch what the controller WOULD do "
                          "against live traffic before handing it the keys")
    min_replicas = ConfigField(default=1, help="scale-down floor (>= 1; "
                               "replica 0 never retires — it owns the shared "
                               "compiled-program cache)")
    max_replicas = ConfigField(default=4, help="scale-up ceiling: each replica "
                               "adds a KV slot pool's HBM but ZERO XLA "
                               "programs (shared compiled-program dict)")
    interval_s = ConfigField(default=2.0, help="decision cadence; signals are "
                             "snapshotted once per tick (FleetSignals)")
    scale_up_burn = ConfigField(default=2.0, help="fast-window SLO burn rate "
                                "at/above which the fleet is overloaded "
                                "(paired with slow_burn_floor: both windows "
                                "must burn, so a blip doesn't scale)")
    slow_burn_floor = ConfigField(default=1.0, help="slow-window burn rate "
                                  "that must ALSO hold for overload (multi-"
                                  "window burn: fast catches the spike, slow "
                                  "confirms it is sustained)")
    queue_wait_up_s = ConfigField(default=5.0, help="head-of-line queue wait "
                                  "that declares overload even without an SLO "
                                  "burn (covers disabled-telemetry fleets)")
    scale_down_burn = ConfigField(default=0.5, help="both burn windows at/"
                                  "below this + empty queue + occupancy below "
                                  "scale_down_occupancy = calm enough to shrink")
    scale_down_occupancy = ConfigField(default=0.3, help="fleet slot occupancy "
                                       "ceiling for scale-down (shrinking a "
                                       "busy fleet would immediately re-queue)")
    cooldown_up_s = ConfigField(default=10.0, help="minimum seconds between "
                                "scale-ups (a new replica needs a tick or two "
                                "to absorb load before judging it)")
    cooldown_down_s = ConfigField(default=30.0, help="minimum seconds after "
                                  "ANY scale action before shrinking "
                                  "(hysteresis against grow/shrink flapping)")
    host_gap_veto = ConfigField(default=0.5, help="host-gap fraction (device-"
                                "idle seconds per wall second, from serving/"
                                "host_gap/*) at/above which scale-up is "
                                "VETOED: the host, not the device, is the "
                                "bottleneck, and another replica would only "
                                "add host work")
    brownout_tiers = ConfigField(default=lambda: ["standard"],
                                 help="escalation ladder: each tier name "
                                 "yields two brownout levels — first EVICT "
                                 "queued flows whose priority weighs below "
                                 "it, then PREEMPT in-flight work below it "
                                 "(cancel, or park-for-resume with "
                                 "brownout_park)")
    brownout_step_s = ConfigField(default=5.0, help="minimum seconds between "
                                  "brownout level changes (either direction)")
    brownout_cooldown_s = ConfigField(default=15.0, help="seconds without "
                                      "overload before the ladder de-"
                                      "escalates one level")
    brownout_retry_after_s = ConfigField(default=20, help="Retry-After "
                                         "advertised on brownout 503s (shed "
                                         "tiers should back off harder than "
                                         "the live-state estimate suggests)")
    brownout_park = ConfigField(default=False, help="preempt in-flight work "
                                "by PARKING its decode state through the "
                                "migrate-out transport (resumes bit-identical "
                                "when the brownout lifts; requires the "
                                "hierarchical-KV/disaggregation prefix "
                                "store) instead of cancelling it")
    goodput_free_threshold = ConfigField(default=0.5, help="when serving/"
                                         "goodput_fraction falls below this, "
                                         "preemption is priced as FREE (the "
                                         "fleet is mostly wasted work — spec-"
                                         "rejected or replayed tokens) and "
                                         "the ladder may skip the step "
                                         "cooldown to escalate")
    rebalance_ratio = ConfigField(default=2.0, help="phase-saturation skew "
                                  "(busier side / calmer side) at/above which "
                                  "a disaggregated fleet flips one replica's "
                                  "role toward the busy phase")
    cooldown_flip_s = ConfigField(default=20.0, help="minimum seconds between "
                                  "role flips (a flip costs sticky purges and "
                                  "possibly a one-off tier-program warmup)")


class ContinuousBatchingConfig(DeepSpeedConfigModel):
    """Continuous-batching serving path (``inference/scheduler.py``):
    iteration-level admission into a fixed slot-pool KV cache. When enabled,
    ``submit()`` routes through the shared :class:`DecodeScheduler` instead
    of dispatching a per-shape static-batch program."""

    enabled = ConfigField(default=False)
    num_slots = ConfigField(default=8, help="decode batch = KV pool slots; the one "
                            "shape XLA compiles the decode step against")
    max_len = ConfigField(default=None, help="per-slot KV rows; default "
                          "min(model max_seq_len, max_out_tokens)")
    prefill_bucket = ConfigField(default=64, help="prompt lengths round up to "
                                 "powers of two from this floor (bounds prefill "
                                 "compile count at ~log2(max_len/bucket))")
    collect_logits = ConfigField(default=False, help="also return per-step logits "
                                 "(debug/parity testing; fetches (slots, V) per token)")
    steps_per_sync = ConfigField(default=4, help="decode steps per host round trip "
                                 "(multi-step scheduling, vLLM --num-scheduler-steps): "
                                 "amortizes dispatch/fetch K-fold; admission/eviction "
                                 "granularity becomes K tokens; results identical for "
                                 "any K (sampling keys use absolute step indices)")
    prefill_chunk = ConfigField(default=64, help="chunked prefill (Sarathi-Serve): "
                                "admission feeds at most this many prompt tokens per "
                                "fused chunk+decode step, so live decode rows stall one "
                                "chunk instead of a whole prompt (smaller = better "
                                "decode p95, worse TTFT); 0 restores the monolithic "
                                "pow2-bucketed prefill path")
    prefix_cache = ConfigField(default=True, help="radix prefix cache (SGLang "
                               "RadixAttention): retain finished slots' prompt KV in a "
                               "token trie and seed new requests from the longest "
                               "matched prefix (LRU eviction when admission needs a "
                               "slot); chunked-prefill mode only")
    spec_tokens = ConfigField(default=0, help="self-speculative decoding (Leviathan "
                              "et al. / prompt-lookup drafting): up to this many "
                              "host-drafted tokens verified per decode step through "
                              "the fused span program — accepted prefixes commit, "
                              "the first mismatch truncates, greedy/sampled outputs "
                              "stay bit-identical to non-speculative decode; 0 "
                              "disables (see benchmarks/SERVING.md)")
    spec_ngram_max = ConfigField(default=3, help="longest context suffix n-gram the "
                                 "prompt-lookup drafter matches against earlier "
                                 "context before proposing its continuation")
    spec_ngram_min = ConfigField(default=1, help="shortest n-gram the drafter falls "
                                 "back to when longer suffixes have no prior "
                                 "occurrence (1 = always drafts when any token "
                                 "repeats; raise to cut wasted verify columns on "
                                 "low-repetition streams)")
    kv_cache_dtype = ConfigField(default="auto", help="slot-pool KV storage: 'auto' "
                                 "= the model compute dtype; 'int8' = group-"
                                 "quantized paged KV (per-token-row fp16 scales, "
                                 "dequant fused into the paged decode kernels) — "
                                 "~1.9x the resident slots per HBM byte at a small "
                                 "bounded logit error; 'bf16'/'fp32' force a plain "
                                 "cache at that precision")
    hierarchical_kv = ConfigField(
        default=HierarchicalKVConfig,
        help="hierarchical KV tier: demote radix-evicted prefixes to a "
        "fleet-global host/NVMe store and restore them on admission "
        "(deepspeed_tpu/memory/; see benchmarks/SERVING.md)")
    multi_lora = ConfigField(
        default=MultiLoRAConfig,
        help="multi-tenant adapter serving: paged LoRA store + batched "
        "mixed-adapter decode (deepspeed_tpu/adapters/; see "
        "benchmarks/SERVING.md)")
    expert_offload = ConfigField(
        default=ExpertOffloadConfig,
        help="cold-expert host offload: page MoE expert kernels through "
        "LRU device pools so experts bigger than HBM still decode "
        "(deepspeed_tpu/moe/expert_store.py; see benchmarks/SERVING.md)")
    long_context = ConfigField(
        default=LongContextConfig,
        help="long-context serving: multi-extent paged KV chains, "
        "sequence-parallel chunked prefill, and mid-decode cold-range "
        "demotion (see benchmarks/SERVING.md)")
    disaggregation = ConfigField(
        default=DisaggregationConfig,
        help="disaggregated prefill/decode: phase-specialized replicas with "
        "KV migration over the hierarchical-KV transport "
        "(serving/replica.py; see benchmarks/SERVING.md)")
    multihost = ConfigField(
        default=MultihostConfig,
        help="multi-host serving: join a cross-process worker fleet behind "
        "a router tier, with a networked prefix/handoff store "
        "(serving/router.py + memory/net_store.py; see "
        "benchmarks/SERVING.md)")
    autoscaler = ConfigField(
        default=AutoscalerConfig,
        help="elastic fleet control plane: SLO-driven replica autoscaling, "
        "prefill/decode re-balancing, and brownout preemption "
        "(serving/controller.py; see benchmarks/SERVING.md)")
    replicas = ConfigField(default=1, help="data-parallel scheduler replicas behind "
                           "the gateway (serving/replica.py): N independent slot "
                           "pools (each tp-sharded per the mesh) sharing ONE "
                           "compiled program set and one weight tree, with "
                           "least-loaded + radix-prefix-sticky dispatch and "
                           "per-replica drain/health; aggregate KV capacity and "
                           "throughput scale with N at zero extra XLA programs")


class GatewayConfig(DeepSpeedConfigModel):
    """Serving-gateway section (``deepspeed_tpu/serving/``): the stdlib
    HTTP frontend over the continuous-batching scheduler — admission
    control, per-tenant weighted fair queuing, SSE token streaming, and
    graceful drain. See ``benchmarks/SERVING.md`` ("Gateway")."""

    host = ConfigField(default="127.0.0.1")
    port = ConfigField(default=8000, help="0 binds an ephemeral port (the bound "
                       "port is on Gateway.port and in the ready log line)")
    max_queue_depth = ConfigField(default=64, help="bound on requests waiting in "
                                  "the fair queue; past it new requests shed with "
                                  "429 + Retry-After instead of growing the queue")
    default_max_tokens = ConfigField(default=64, help="max_tokens when the request "
                                     "body omits it")
    request_timeout_s = ConfigField(default=120.0, help="per-request deadline "
                                    "(queue wait + decode); a request body's "
                                    "'timeout_s' overrides it downward. Expired "
                                    "requests cancel their slot mid-decode")
    drain_timeout_s = ConfigField(default=60.0, help="SIGTERM drain grace: how long "
                                  "to wait for admitted requests to finish before "
                                  "forcing exit")
    tenant_header = ConfigField(default="x-tenant-id", help="HTTP header carrying "
                                "the tenant key (falls back to the body's 'user' "
                                "field, then to 'anonymous')")
    priority_header = ConfigField(default="x-priority", help="HTTP header selecting "
                                  "the priority class (a key of priority_weights)")
    default_priority = ConfigField(default="standard")
    priority_weights = ConfigField(
        default=lambda: {"interactive": 4.0, "standard": 2.0, "batch": 1.0},
        help="priority class -> DRR weight multiplier")
    tenant_weights = ConfigField(default=dict, help="tenant key -> DRR weight "
                                 "(default 1.0); a 2.0 tenant gets twice the "
                                 "admission bandwidth of a 1.0 tenant under "
                                 "contention")
    quantum_tokens = ConfigField(default=256, help="DRR quantum: deficit credit "
                                 "(in estimated prompt+max_tokens units) a flow "
                                 "earns per round-robin visit")
    retry_after_cap_s = ConfigField(default=30, help="upper bound on the advertised "
                                    "Retry-After")
    max_body_bytes = ConfigField(default=1 << 22, help="largest accepted request "
                                 "body (bytes); bigger Content-Lengths answer 413 "
                                 "WITHOUT buffering the body — a long-lived gateway "
                                 "must not be OOM-able by one fat POST")


class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    """Reference ``inference/config.py`` key parity."""

    kernel_inject = ConfigField(default=False, aliases=("replace_with_kernel_inject", ))
    dtype = ConfigField(default="bfloat16")
    tensor_parallel = ConfigField(default=TensorParallelConfig, aliases=("tp", ))
    min_out_tokens = ConfigField(default=1)
    max_out_tokens = ConfigField(default=1024, aliases=("max_tokens", ))
    checkpoint = ConfigField(default=None)
    base_dir = ConfigField(default="")
    quant = ConfigField(default=QuantConfig)
    moe = ConfigField(default=MoEInferenceConfig)
    triangular_masking = ConfigField(default=True)
    return_tuple = ConfigField(default=True)
    training_mp_size = ConfigField(default=1)
    replace_method = ConfigField(default="auto")
    injection_policy = ConfigField(default=None)
    enable_cuda_graph = ConfigField(default=False)
    save_mp_checkpoint_path = ConfigField(default=None)
    # TPU additions
    decode_block_kv = ConfigField(default=256, help="KV block streamed per decode-kernel step")
    mp_size = ConfigField(default=None, help="deprecated alias for tensor_parallel.tp_size")
    fused_decode_block = ConfigField(
        default=True, help="use the fused per-layer decode kernels (qkv->attention->o->mlp) "
        "when the int8 serving config allows it; not ported yet, so an int8 config that "
        "would select them raises until this is set False")
    telemetry = ConfigField(
        default=dict, help="unified telemetry sink section (same keys as the training "
        "config's 'telemetry': enabled/output_path/flush_interval/trace_format/"
        "hist_window_s/hist_max_samples/request_tracing/flight_recorder/slo); an "
        "already-installed global sink (e.g. the training engine's) takes precedence")
    continuous_batching = ConfigField(
        default=ContinuousBatchingConfig, aliases=("serving", ),
        help="continuous-batching scheduler section (slot-pool paged KV cache; "
        "see benchmarks/SERVING.md)")
    gateway = ConfigField(
        default=GatewayConfig,
        help="serving-gateway section (HTTP frontend + admission control + "
        "per-tenant fair queuing over the scheduler; see benchmarks/SERVING.md)")

    def __init__(self, param_dict=None):
        super().__init__(param_dict)
        if self.mp_size is not None:
            logger.warning("Config parameter mp_size is deprecated, use tensor_parallel.tp_size")
            self.tensor_parallel.tp_size = self.mp_size
        if self.enable_cuda_graph:
            logger.info("enable_cuda_graph ignored: the port's decode loop runs eagerly")
        if isinstance(self.dtype, str):
            key = self.dtype.replace("torch.", "")
            if key not in _DTYPE_MAP:
                raise ValueError(f"Invalid inference dtype {self.dtype!r}; expected one of {sorted(_DTYPE_MAP)}")
            if key in ("fp16", "float16", "half"):
                logger.info("fp16 inference requested; using bfloat16, as the JAX package does")
            self.dtype = _DTYPE_MAP[key]
        elif self.dtype not in _DTYPE_MAP.values():
            raise ValueError(f"Invalid inference dtype {self.dtype!r}; expected one of {sorted(_DTYPE_MAP)}")
        self._reject_unported()

    def _reject_unported(self):
        """Sections the port has no subsystem for yet: accepted while off,
        refused when on, each naming its ROADMAP Queue 1 item."""
        unported = []
        if self.continuous_batching.enabled:
            unported.append("continuous_batching.enabled (ROADMAP Queue 1 #5, continuous batching)")
        if self.gateway.to_dict() != GatewayConfig().to_dict():
            unported.append("gateway (ROADMAP Queue 1 #6, serving and telemetry)")
        if dict(self.telemetry or {}).get("enabled"):
            unported.append("telemetry.enabled (ROADMAP Queue 1 #6, serving and telemetry)")
        if self.moe.to_dict() != MoEInferenceConfig().to_dict():
            unported.append("moe (ROADMAP Queue 1 #7, distributed runtime: MoE)")
        if self.checkpoint is not None:
            unported.append("checkpoint (ROADMAP Queue 1 #10, checkpoint loading)")
        if self.tensor_parallel.tp_size > 1:
            unported.append("tensor_parallel.tp_size > 1 (ROADMAP Queue 1 #7, distributed runtime)")
        if unported:
            raise NotImplementedError("deepspeed_tpu_torch does not support yet: " + "; ".join(unported))
