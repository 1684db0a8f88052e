"""Declarative SLO engine with multi-window burn-rate alerting.

Turns the sink's raw counters/gauges/windowed histograms into the question
an operator actually asks: *are we meeting our objectives right now, and
how fast are we burning the error budget?* Objectives are declared in the
``telemetry.slo`` config section (or supplied as code defaults — the
serving gateway ships TTFT/ITL/queue-wait/shed-rate objectives); each is
evaluated on a cadence into a *bad fraction* (what share of recent work
violated the objective), and the burn rate is that fraction divided by the
objective's error budget, averaged over a FAST and a SLOW window (the
classic SRE multi-window rule: a one-blip spike does not page, a sustained
burn does).

Objective kinds:

- ``histogram`` — bad fraction = share of the histogram's observations
  above ``threshold``, counted CUMULATIVELY via the sink's per-threshold
  exceed counters (registered at engine construction,
  :meth:`TelemetrySink.track_threshold`) so window deltas are exact and
  genuinely fast/slow — the sink's own 300s sliding reservoir would smear
  a 60s burn window across five minutes. Budget = ``1 - target`` (default
  target 0.95: "p95 under threshold").
- ``ratio`` — bad fraction = Δ(sum of ``num`` counters) / Δ(sum of ``den``
  counters) over the window. Budget = ``max`` (e.g. shed rate < 5%).
- ``gauge_min`` / ``gauge_max`` — bad fraction = 1.0 whenever the latest
  gauge violates the floor/ceiling (MFU floor, offload/comm
  overlap-efficiency floor). Budget = ``budget`` (default 0.25: a quarter
  of recent evaluations may violate before the alert trips).

An alert fires when BOTH window burn rates reach ``burn_threshold``; the
transition emits a ``slo/alert`` telemetry event, bumps ``slo/alerts``,
sets the per-objective ``slo/<name>/burning`` gauge, and invokes the
registered ``on_alert`` hooks (the gateway wires a flight-recorder dump).
``state()`` is what ``GET /v1/slo`` serves.

A copy of ``deepspeed_tpu/telemetry/slo.py`` (stdlib only): the port imports nothing
of the JAX package.
"""

from collections import deque

# the serving gateway's default objective slate (used when the config
# section declares none): latency through the two user-visible histograms,
# scheduler inter-token latency, and the shed/expiry error rate
DEFAULT_SERVING_OBJECTIVES = [
    # serving/ttft_ms is true submit->first-token time for EVERY request;
    # gateway/ttfb_ms would be wrong here — the unary path records it at
    # full completion, so healthy long non-streaming generations would
    # trip a "TTFT" alert
    {"name": "ttft_p95", "kind": "histogram", "metric": "serving/ttft_ms",
     "threshold": 2000.0, "target": 0.95},
    {"name": "queue_wait_p95", "kind": "histogram",
     "metric": "gateway/queue_wait_ms", "threshold": 1000.0, "target": 0.95},
    {"name": "itl_p95", "kind": "histogram", "metric": "serving/step_ms",
     "threshold": 250.0, "target": 0.95},
    {"name": "error_rate", "kind": "ratio",
     "num": ["gateway/shed_429", "gateway/shed_503",
             "gateway/deadline_expired"],
     "den": ["gateway/requests"], "max": 0.05},
]


class _Objective:
    __slots__ = ("name", "kind", "metric", "num", "den", "threshold",
                 "budget", "history", "breached")

    def __init__(self, spec):
        self.name = str(spec["name"])
        self.kind = str(spec.get("kind", "histogram"))
        self.metric = spec.get("metric")
        self.num = list(spec.get("num", ()))
        self.den = list(spec.get("den", ()))
        if self.kind == "histogram":
            self.threshold = float(spec.get("threshold",
                                            spec.get("threshold_ms", 0.0)))
            self.budget = max(1e-6, 1.0 - float(spec.get("target", 0.95)))
        elif self.kind == "ratio":
            self.threshold = None
            self.budget = max(1e-6, float(spec.get("max", 0.05)))
        elif self.kind in ("gauge_min", "gauge_max"):
            self.threshold = float(spec["min" if self.kind == "gauge_min"
                                        else "max"])
            self.budget = max(1e-6, float(spec.get("budget", 0.25)))
        else:
            raise ValueError(f"unknown SLO objective kind {self.kind!r} "
                             f"(objective {self.name!r})")
        # (ts, bad, good) samples — fractions for histogram/gauge kinds,
        # cumulative counter totals for ratio kind
        self.history = deque()
        self.breached = False


class SLOEngine:
    """Evaluates objectives against one :class:`TelemetrySink`.

    ``config`` keys (all optional): ``objectives`` (list of specs; see
    module docstring), ``fast_window_s`` (60), ``slow_window_s`` (300),
    ``burn_threshold`` (1.0 — budget fully consumed at window scale),
    ``eval_interval_s`` (5.0 — the caller's pacing hint, see
    :meth:`maybe_evaluate`), ``enabled``.
    """

    def __init__(self, sink, config=None, defaults=()):
        config = dict(config or {})
        self.sink = sink
        self.fast_window_s = float(config.get("fast_window_s", 60.0))
        self.slow_window_s = float(config.get("slow_window_s", 300.0))
        self.burn_threshold = float(config.get("burn_threshold", 1.0))
        self.eval_interval_s = float(config.get("eval_interval_s", 5.0))
        specs = config.get("objectives") or list(defaults)
        self.objectives = [_Objective(s) for s in specs]
        self.enabled = bool(config.get("enabled", True)) and bool(self.objectives)
        for obj in self.objectives:
            # cumulative exceed counting starts now — construct the engine
            # before traffic (the gateway/training engine both do)
            if obj.kind == "histogram":
                sink.track_threshold(obj.metric, obj.threshold)
        self.on_alert = []       # callables(objective_state_dict)
        self.alerts = 0          # alert transitions fired
        self._last_eval = None
        self._last_state = {"enabled": self.enabled, "objectives": []}

    # ------------------------------------------------------------------ sampling
    def _sample(self, obj, snapshot, ts):
        """One (bad, good) sample for ``obj``: CUMULATIVE totals for the
        histogram/ratio kinds (windows take deltas — exact over any window
        length), instantaneous violation for gauge kinds."""
        if obj.kind == "histogram":
            bad, total = self.sink.hist_exceed(obj.metric, obj.threshold)
            if total == 0:
                return None
            return bad, total  # cumulative; windows take deltas
        if obj.kind == "ratio":
            counters = snapshot["counters"]
            num = sum(counters.get(n, {}).get("total", 0) for n in obj.num)
            den = sum(counters.get(d, {}).get("total", 0) for d in obj.den)
            return num, den  # cumulative; windows take deltas
        # gauge floors/ceilings
        val = snapshot["gauges"].get(obj.metric)
        if val is None:
            return None
        bad = (val < obj.threshold) if obj.kind == "gauge_min" \
            else (val > obj.threshold)
        return (1.0 if bad else 0.0), 1.0

    def _window_burn(self, obj, now, window_s):
        """Burn rate over ``window_s``: bad-share within the window divided
        by the objective's budget."""
        hist = [h for h in obj.history if now - h[0] <= window_s]
        if not hist:
            return 0.0
        if obj.kind in ("ratio", "histogram"):
            # cumulative totals: delta across the window (include the last
            # sample BEFORE the window as the baseline when available)
            older = [h for h in obj.history if now - h[0] > window_s]
            base = older[-1] if older else (hist[0][0], 0, 0)
            d_num = hist[-1][1] - base[1]
            d_den = hist[-1][2] - base[2]
            frac = (d_num / d_den) if d_den > 0 else 0.0
        else:
            bad = sum(h[1] for h in hist)
            good = sum(h[2] for h in hist)
            frac = (bad / good) if good > 0 else 0.0
        return frac / obj.budget

    # ------------------------------------------------------------------ evaluation
    def maybe_evaluate(self, now=None):
        """Evaluate if ``eval_interval_s`` has elapsed since the last pass
        (the gateway pump calls this every loop turn)."""
        if not self.enabled:
            return None
        now = self.sink.now() if now is None else now
        if self._last_eval is not None and now - self._last_eval < self.eval_interval_s:
            return None
        return self.evaluate(now)

    def evaluate(self, now=None):
        """One evaluation pass: sample every objective, update both window
        burn rates, fire alert transitions. Returns (and caches) the state
        dict ``/v1/slo`` serves."""
        if not self.enabled:
            return self._last_state
        sink = self.sink
        now = sink.now() if now is None else now
        self._last_eval = now
        snapshot = sink.snapshot()
        horizon = now - 2 * self.slow_window_s
        states = []
        for obj in self.objectives:
            sample = self._sample(obj, snapshot, now)
            if sample is not None:
                obj.history.append((now, sample[0], sample[1]))
            while obj.history and obj.history[0][0] < horizon:
                obj.history.popleft()
            burn_fast = self._window_burn(obj, now, self.fast_window_s)
            burn_slow = self._window_burn(obj, now, self.slow_window_s)
            burning = (burn_fast >= self.burn_threshold
                       and burn_slow >= self.burn_threshold)
            state = {"name": obj.name, "kind": obj.kind,
                     "metric": obj.metric or "+".join(obj.num),
                     "budget": obj.budget,
                     "burn_fast": round(burn_fast, 4),
                     "burn_slow": round(burn_slow, 4),
                     "burning": burning}
            if sink.enabled:
                sink.gauges([(f"slo/{obj.name}/burn_rate", burn_fast, None),
                             (f"slo/{obj.name}/burning", float(burning), None)])
            if burning and not obj.breached:
                obj.breached = True
                self.alerts += 1
                if sink.enabled:
                    sink.event("slo/alert",
                               attrs={"objective": obj.name,
                                      "burn_fast": round(burn_fast, 3),
                                      "burn_slow": round(burn_slow, 3),
                                      "budget": obj.budget})
                    sink.counter("slo/alerts")
                for hook in self.on_alert:
                    try:
                        hook(state)
                    except Exception:  # noqa: BLE001 — alert fan-out must not
                        pass           # wedge the serving loop
            elif not burning and obj.breached:
                obj.breached = False
                if sink.enabled:
                    sink.event("slo/recovered", attrs={"objective": obj.name})
            states.append(state)
        self._last_state = {
            "enabled": True,
            "fast_window_s": self.fast_window_s,
            "slow_window_s": self.slow_window_s,
            "burn_threshold": self.burn_threshold,
            "alerts": self.alerts,
            "objectives": states,
        }
        return self._last_state

    def state(self):
        """The most recent evaluation (``/v1/slo`` payload)."""
        return self._last_state
