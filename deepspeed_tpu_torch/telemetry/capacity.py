"""Serving capacity accounting: a roofline registry per dispatch kind,
sampled fenced dispatch timing, host-gap attribution, and goodput.

Port of ``deepspeed_tpu/telemetry/capacity.py``. Three pieces, owned by the
scheduler's pump thread, built only when the telemetry sink is enabled (the
disabled path allocates nothing):

- :class:`CapacityModel` — analytic FLOPs and HBM bytes of one step
  dispatch, from the model config and the dispatch's batch shape (live
  rows' contexts, query columns, K substeps). The numbers count what the
  device executes: the full slot block, padded rows too.

- :class:`CapacityMeter` — the registry of the port's dispatch kinds
  (``decode``, ``chunk``, ``verify``, ``prefill``; the port compiles no
  programs, so the JAX meter's per-program keys become the scheduler's
  dispatch keys). Every ``sample_every``-th sync is fenced: the scheduler
  drains the device (``torch.cuda.synchronize()``) before the dispatch, and
  the dispatch's own fetch of its token block ends it, so the wall time
  between is the dispatch alone. It turns that into ``serving/mfu``,
  ``serving/hbm_bw_util`` and ``serving/roofline/<kind>`` (arithmetic
  intensity over the machine balance: >= 1 compute-bound). An unsampled
  sync gets no fence. The meter also owns goodput: useful against wasted
  token-FLOPs (rejected speculative columns) in
  ``serving/goodput_fraction``. Peaks come from the port's accelerator
  (the H100 datasheet on the card).

- :class:`HostGapTracker` — device-idle attribution for the pump thread,
  a copy of the JAX class: the gap between one sync's fetch and the next
  dispatch is host time; the scheduler stamps its admission / trie-probe
  / sampling-host / on_token sections into it and the tracker emits the
  ``serving/host_gap_ms`` histogram and ``serving/host_gap/<bucket>_ms``
  counters that sum to the measured gap exactly (the residue lands in
  ``other``); the hierarchical KV tier's probe, restore and extent
  paging file under ``tier_transfer``.
"""

# host-gap attribution buckets, in emission order. "other" is the residue
# between the measured gap and the stamped sections — it absorbs pump-loop
# overhead, GIL waits, and anything not explicitly instrumented.
GAP_BUCKETS = ("admission", "trie_probe", "sampling_host", "on_token",
               "tier_transfer", "other")

_GATED_ACTS = ("swiglu", "geglu")


def _cfg(model_config, name, default=None):
    return getattr(model_config, name, default)


class CapacityModel:
    """Analytic FLOPs/HBM-bytes for one transformer step dispatch.

    All coefficients are precomputed from the model config at build so the
    per-sample cost is a handful of float multiplies. ``matmul_flops_per_col``
    counts every projection, the ACTIVE expert MLPs (``moe_top_k`` of
    ``num_experts``; dense models count one), and the LM head — per query
    column, full slot block (the dispatch computes padded rows too).
    Attention score/value FLOPs scale with each live row's context and are
    added per dispatch."""

    __slots__ = ("matmul_flops_per_col", "attn_flops_per_ctx_tok",
                 "weight_read_bytes", "kv_bytes_per_token", "num_slots")

    def __init__(self, model_config, kv_bytes_per_token, num_slots):
        h = int(_cfg(model_config, "hidden_size", 0) or 0)
        L = int(_cfg(model_config, "num_layers", 0) or 0)
        nh = int(_cfg(model_config, "num_heads", 1) or 1)
        kvh = int(_cfg(model_config, "kv_heads", nh) or nh)
        hd = int(_cfg(model_config, "head_size", max(1, h // max(1, nh))))
        ffn = int(_cfg(model_config, "ffn_size", 4 * h) or 4 * h)
        V = int(_cfg(model_config, "vocab_size", 0) or 0)
        E = int(_cfg(model_config, "num_experts", 0) or 0)
        topk = int(_cfg(model_config, "moe_top_k", 1) or 1)
        act = str(_cfg(model_config, "activation", "gelu"))
        mlp_mats = 3 if act in _GATED_ACTS else 2

        attn_proj = L * (h * hd * (nh + 2 * kvh)  # qkv
                         + nh * hd * h)           # o
        mlp_active = L * mlp_mats * h * ffn * (min(topk, E) if E > 0 else 1)
        lm_head = h * V
        # 2 FLOPs per MAC; per query column the dispatch runs every matmul
        self.matmul_flops_per_col = 2.0 * (attn_proj + mlp_active + lm_head)
        # QK^T + AV: 2 matmuls x 2 FLOPs x (heads*head_dim) per context
        # token per query column, per layer
        self.attn_flops_per_ctx_tok = 4.0 * L * nh * hd
        # active weights read once per forward (each of the K forwards of a
        # sync re-reads them); router/embeddings are noise
        if _cfg(model_config, "int8_weights", False):
            # int8 serving streams 1 byte/param plus the fp32 per-group
            # scales (4 bytes per group of `int8_group_size` params)
            gs = int(_cfg(model_config, "int8_group_size", 0) or 128)
            dtype_bytes = 1.0 + 4.0 / max(1, gs)
        else:
            # the compute dtype's width (bf16 when unknown)
            dtype_bytes = int(getattr(_cfg(model_config, "dtype"), "itemsize", 2) or 2)
        self.weight_read_bytes = float((attn_proj + mlp_active + lm_head) * dtype_bytes)
        self.kv_bytes_per_token = float(kv_bytes_per_token)
        self.num_slots = int(num_slots)

    def dispatch_cost(self, live_ctx, width, ksteps, kv_mult=1.0):
        """(flops, hbm_bytes) for ONE step dispatch: ``width`` query columns
        over the full slot block plus ``ksteps - 1`` single-column substeps,
        with ``live_ctx`` the live rows' context lengths (attention + KV
        traffic scale with these). ``kv_mult`` scales the KV-read term for
        the multi-extent block walk, which reads every extent's pool row."""
        ksteps = max(1, int(ksteps))
        cols_full = self.num_slots * (max(1, int(width)) + (ksteps - 1))
        ctx_sum = float(sum(live_ctx))
        cols_per_row = max(1, int(width)) + (ksteps - 1)
        flops = (cols_full * self.matmul_flops_per_col
                 + cols_per_row * ctx_sum * self.attn_flops_per_ctx_tok)
        bytes_ = ksteps * (self.weight_read_bytes
                           + ctx_sum * self.kv_bytes_per_token
                           * max(1.0, float(kv_mult)))
        return flops, bytes_

    def flops_per_token(self, ctx):
        """Per useful token at context ``ctx`` — the goodput unit."""
        return (self.matmul_flops_per_col
                + float(ctx) * self.attn_flops_per_ctx_tok)


def dispatch_shape(key):
    """(width, ksteps) of a dispatch key: ``("decode", K)`` is one column
    and K forwards, ``("chunk", C, K)`` C columns then K - 1 substeps,
    ``("verify", W)`` one forward over W columns, ``("prefill", P)`` one
    single-slot forward over a P-token bucket."""
    kind = key[0]
    if kind == "decode":
        return 1, int(key[1])
    if kind == "chunk":
        return int(key[1]), int(key[2])
    if kind in ("verify", "prefill"):
        return int(key[1]), 1
    return 1, 1


class CapacityMeter:
    """Registry of dispatch kinds + sampled fenced timing + goodput
    accounting. One instance per scheduler; only built when the sink is
    enabled (the disabled path allocates nothing)."""

    def __init__(self, sink, model, *, peak_flops, peak_hbm_bw, sample_every=32):
        self.sink = sink
        self.model = model
        self.peak_flops = float(peak_flops)
        self.peak_hbm_bw = float(peak_hbm_bw)
        # machine balance: FLOPs/byte at the roofline ridge point
        self.balance = self.peak_flops / max(1.0, self.peak_hbm_bw)
        self.sample_every = max(1, int(sample_every))
        self.programs = {}      # dispatch key -> {"kind", "samples", "mfu", ...}
        self.samples = 0
        # goodput accumulators (token-FLOPs)
        self.useful_flops = 0.0
        self.wasted_flops = 0.0

    def should_sample(self, sync_seq):
        return sync_seq % self.sample_every == 0

    # ---------------------------------------------------------------- sampling
    def observe_dispatch(self, key, dur_s, live_ctx, kv_mult=1.0):
        """Fold one fenced dispatch sample into the live gauges. ``dur_s``
        is the fence-to-fetch wall time of the dispatch alone."""
        if dur_s <= 0.0:
            return
        width, ksteps = dispatch_shape(key)
        flops, bytes_ = self.model.dispatch_cost(live_ctx, width, ksteps, kv_mult)
        mfu = flops / dur_s / self.peak_flops
        bw = bytes_ / dur_s / self.peak_hbm_bw
        intensity = flops / max(1.0, bytes_)
        self.samples += 1
        ent = self.programs.setdefault(
            key, {"kind": str(key[0]), "samples": 0, "mfu": 0.0, "hbm_bw_util": 0.0,
                  "intensity": 0.0})
        ent["samples"] += 1
        ent["mfu"] = mfu
        ent["hbm_bw_util"] = bw
        ent["intensity"] = intensity
        sink = self.sink
        if sink is not None and sink.enabled:
            sink.gauge("serving/mfu", mfu)
            sink.gauge("serving/hbm_bw_util", bw)
            # >= 1: compute-bound (intensity past the ridge); < 1: the
            # dispatch is bandwidth-bound at this batch shape
            sink.gauge(f"serving/roofline/{ent['kind']}",
                       intensity / max(1e-9, self.balance))
            sink.counter("serving/capacity_samples")

    # ---------------------------------------------------------------- goodput
    def account(self, useful_tokens, wasted_tokens=0, ctx=0.0, wasted_bytes=0.0):
        """Fold one sync's goodput inputs: tokens delivered to requests,
        tokens computed-then-discarded (rejected speculative columns), and
        pure-traffic waste in bytes — converted to FLOP-equivalents at the
        machine balance so one fraction covers both compute and bandwidth
        waste."""
        ft = self.model.flops_per_token(ctx)
        self.useful_flops += max(0, useful_tokens) * ft
        wasted = max(0, wasted_tokens) * ft
        if wasted_bytes > 0.0:
            wasted += float(wasted_bytes) * self.balance
        self.wasted_flops += wasted
        sink = self.sink
        if sink is not None and sink.enabled:
            if wasted > 0.0:
                sink.counter("serving/goodput/wasted_token_flops", int(wasted))
            total = self.useful_flops + self.wasted_flops
            if total > 0.0:
                sink.gauge("serving/goodput_fraction", self.useful_flops / total)

    @property
    def goodput_fraction(self):
        total = self.useful_flops + self.wasted_flops
        return self.useful_flops / total if total > 0.0 else 1.0

    # ---------------------------------------------------------------- snapshot
    def program_table(self):
        """Registry view for ``/v1/metrics``: per dispatch key its kind,
        sample count, last MFU/bandwidth and roofline class."""
        out = {}
        for key, ent in self.programs.items():
            out[str(key)] = {
                "kind": ent["kind"], "samples": ent["samples"],
                "mfu": round(ent["mfu"], 5),
                "hbm_bw_util": round(ent["hbm_bw_util"], 5),
                "bound": ("compute" if ent["intensity"] >= self.balance
                          else "bandwidth"),
            }
        return out


class HostGapTracker:
    """Device-idle (host-gap) attribution for one pump thread.

    Lifecycle per sync: the scheduler calls :meth:`sync_end` when a
    dispatch's results are fenced on the host (the device goes idle),
    stamps host sections into the open gap via :meth:`add`, and calls
    :meth:`dispatch` the moment the next program is handed to the device —
    closing the gap, normalizing attribution so the per-bucket counters
    sum EXACTLY to the measured gap, and emitting the histogram. All
    methods are single-float arithmetic; the tracker is only constructed
    when the sink is enabled."""

    __slots__ = ("sink", "_open_ts", "_acc", "gaps", "total_gap_s")

    def __init__(self, sink):
        self.sink = sink
        self._open_ts = None
        self._acc = {b: 0.0 for b in GAP_BUCKETS if b != "other"}
        self.gaps = 0
        self.total_gap_s = 0.0

    def sync_end(self, ts):
        """Device results just landed on the host: the idle gap opens."""
        self._open_ts = ts

    def add(self, bucket, dur, steal_from=None):
        """Stamp ``dur`` seconds of host work into ``bucket``.
        ``steal_from`` moves the time out of an ENCLOSING section (e.g. the
        trie probe runs inside the admission region) so nested timers never
        double-count. The debit may land before the enclosing section is
        stamped — the accumulator is allowed to go negative and is floored
        at :meth:`dispatch`, so stamp order doesn't matter."""
        if dur <= 0.0:
            return
        self._acc[bucket] += dur
        if steal_from is not None:
            self._acc[steal_from] -= dur

    def dispatch(self, ts):
        """The next program is being handed to the device: close the gap,
        emit, and reset. A dispatch before any sync (warmup) just clears
        the accumulators."""
        open_ts, self._open_ts = self._open_ts, None
        acc = self._acc
        if open_ts is None:
            for b in acc:
                acc[b] = 0.0
            return
        gap = max(0.0, ts - open_ts)
        for b in acc:  # floor deferred-steal debits (see :meth:`add`)
            if acc[b] < 0.0:
                acc[b] = 0.0
        attributed = sum(acc.values())
        if attributed > gap > 0.0:
            # timer overlap / clock skew: scale back so the invariant
            # "buckets sum to the measured gap" holds exactly
            scale = gap / attributed
            for b in acc:
                acc[b] *= scale
            attributed = gap
        other = max(0.0, gap - attributed)
        self.gaps += 1
        self.total_gap_s += gap
        sink = self.sink
        if sink is not None and sink.enabled:
            sink.histogram("serving/host_gap_ms", gap * 1e3)
            for b, v in acc.items():
                if v > 0.0:
                    sink.counter(f"serving/host_gap/{b}_ms", v * 1e3)
            if other > 0.0:
                sink.counter("serving/host_gap/other_ms", other * 1e3)
        for b in acc:
            acc[b] = 0.0
