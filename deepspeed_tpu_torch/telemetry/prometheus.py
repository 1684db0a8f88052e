"""Prometheus text exposition for the telemetry snapshot.

Renders :meth:`TelemetrySink.snapshot` (plus any extra scalar gauges the
gateway wants to expose) in the Prometheus text format (version 0.0.4), so
a standard scraper pointed at ``GET /v1/metrics`` with the usual
``Accept: text/plain`` header works with zero glue. Mapping:

- counters -> ``# TYPE ... counter`` with a ``_total`` suffix;
  ``gateway/tenant/<t>/tokens``, ``comm/<op>/<group>/bytes``, and
  ``serving/replica/<id>/...`` become labeled series instead of a
  per-tenant/per-group/per-replica metric-name explosion.
- gauges   -> ``# TYPE ... gauge`` (``serving/replica/<id>/...`` gauges
  fold into labeled series the same way).
- histograms -> ``# TYPE ... summary`` (windowed quantiles:
  ``{quantile="0.5|0.95|0.99"}`` + ``_sum`` + ``_count``) PLUS a parallel
  ``<name>_hist`` native histogram family — lifetime cumulative
  ``_bucket``/``le`` counts on the sink's fixed ladder, so external
  alerting can compute its own quantiles over any rate() window.

Everything is prefixed ``dstpu_`` and sanitized to the metric-name charset.
Stdlib-only by design (same budget as the gateway).

A copy of ``deepspeed_tpu/telemetry/prometheus.py`` (stdlib only): the port imports nothing
of the JAX package.
"""

import re

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
_TENANT_RE = re.compile(r"^gateway/tenant/(?P<tenant>.+)/tokens$")
_COMM_RE = re.compile(r"^comm/(?P<op>[^/]+)/(?P<group>[^/]+)/bytes$")
_REPLICA_RE = re.compile(r"^serving/replica/(?P<replica>\d+)/(?P<metric>.+)$")
_ADAPTER_RE = re.compile(r"^serving/adapter/(?P<adapter>.+)/"
                         r"(?P<metric>loads|evicts|requests|tokens)$")
# multi-host serving (serving/router.py): per-worker fleet families fold
# into one labeled series per metric, same shape as per-replica — the
# router caps wid cardinality at 256 labels before these ever render
_WORKER_RE = re.compile(r"^serving/worker/(?P<worker>[^/]+)/(?P<metric>.+)$")

_PREFIX = "dstpu_"


def _name(raw):
    return _PREFIX + _NAME_RE.sub("_", raw.strip("/"))


def _labels(pairs):
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
    return "{" + inner + "}"


def _escape(value):
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(value):
    value = float(value)
    # the text format has non-finite literals; int(nan/inf) would raise —
    # and a NaN loss gauge must not fail the whole scrape mid-incident
    if value != value:
        return "NaN"
    if value in (float("inf"), float("-inf")):
        return "+Inf" if value > 0 else "-Inf"
    return repr(int(value)) if value == int(value) else repr(value)


def _counter_series(raw_name):
    """(metric_name, label_pairs) for one counter, folding the
    client/topology-cardinality families into labels."""
    m = _TENANT_RE.match(raw_name)
    if m:
        return _PREFIX + "gateway_tenant_tokens_total", [("tenant", m.group("tenant"))]
    m = _COMM_RE.match(raw_name)
    if m:
        return _PREFIX + "comm_bytes_total", [("op", m.group("op")),
                                              ("group", m.group("group"))]
    m = _REPLICA_RE.match(raw_name)
    if m:
        return (_name("serving/replica/" + m.group("metric")) + "_total",
                [("replica", m.group("replica"))])
    m = _WORKER_RE.match(raw_name)
    if m:
        return (_name("serving/worker/" + m.group("metric")) + "_total",
                [("worker", m.group("worker"))])
    m = _ADAPTER_RE.match(raw_name)
    if m:  # per-adapter multi-LoRA counters: one labeled family per metric.
        # "per_adapter" (not "adapter") keeps the labeled family's name
        # disjoint from the fleet-total counters (serving/adapter_loads ->
        # dstpu_serving_adapter_loads_total) — mixing an unlabeled
        # aggregate into a labeled family would double-count sum() queries
        return (_name("serving/per_adapter/" + m.group("metric")) + "_total",
                [("adapter", m.group("adapter"))])
    return _name(raw_name) + "_total", []


def _gauge_series(raw_name):
    """(metric_name, label_pairs) for one gauge — per-replica serving
    gauges fold into one labeled family per metric."""
    m = _REPLICA_RE.match(raw_name)
    if m:
        return (_name("serving/replica/" + m.group("metric")),
                [("replica", m.group("replica"))])
    m = _WORKER_RE.match(raw_name)
    if m:
        return (_name("serving/worker/" + m.group("metric")),
                [("worker", m.group("worker"))])
    return _name(raw_name), []


def render(snapshot, extra_gauges=None):
    """Prometheus text body from a sink snapshot dict. ``extra_gauges``:
    ``{raw_name: scalar}`` appended as plain gauges (the gateway passes its
    queue/occupancy stats so scrapers see one coherent surface)."""
    lines = []
    typed = set()

    def header(name, kind):
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    # group counter samples by RESOLVED metric name first: the text format
    # requires all samples of one metric to form a single contiguous group,
    # and sorting by raw name would interleave the labeled families
    # (comm/<op>/<group>/bytes) with unlabeled comm/* counters
    counter_groups = {}
    for raw, c in sorted(snapshot.get("counters", {}).items()):
        name, labels = _counter_series(raw)
        counter_groups.setdefault(name, []).append((labels, c["total"]))
    for name in sorted(counter_groups):
        header(name, "counter")
        for labels, total in counter_groups[name]:
            lines.append(f"{name}{_labels(labels)} {_fmt(total)}")

    all_gauges = dict(snapshot.get("gauges", {}))
    for raw, value in (extra_gauges or {}).items():
        if value is not None:
            all_gauges[raw] = value
    # group by RESOLVED name (same contiguity rule as counters: the
    # per-replica labeled families must not interleave with plain gauges)
    gauge_groups = {}
    for raw, value in sorted(all_gauges.items()):
        name, labels = _gauge_series(raw)
        gauge_groups.setdefault(name, []).append((labels, value))
    for name in sorted(gauge_groups):
        header(name, "gauge")
        for labels, value in gauge_groups[name]:
            lines.append(f"{name}{_labels(labels)} {_fmt(value)}")

    for raw, h in sorted(snapshot.get("histograms", {}).items()):
        name = _name(raw)
        header(name, "summary")
        for q in ("0.5", "0.95", "0.99"):
            key = "p" + q[2:].ljust(2, "0")  # 0.5 -> p50, 0.95 -> p95, 0.99 -> p99
            lines.append(f'{name}{{quantile="{q}"}} {_fmt(h[key])}')
        lines.append(f"{name}_sum {_fmt(h['sum'])}")
        lines.append(f"{name}_count {_fmt(h['count'])}")
        # native histogram alongside the summary (a metric can't be both
        # types, so the bucketed family rides a ``_hist`` suffix): lifetime
        # cumulative counts on the sink's fixed ladder — external alerting
        # computes its own quantiles over ANY window via rate(), which the
        # sliding-window summary can't offer
        buckets = h.get("buckets")
        if buckets:
            hname = name + "_hist"
            header(hname, "histogram")
            for le, cum in buckets:
                lines.append(f'{hname}_bucket{{le="{_fmt(le)}"}} {_fmt(cum)}')
            lines.append(f'{hname}_bucket{{le="+Inf"}} {_fmt(h["count"])}')
            lines.append(f"{hname}_sum {_fmt(h['sum'])}")
            lines.append(f"{hname}_count {_fmt(h['count'])}")

    uptime = snapshot.get("uptime_s")
    if uptime is not None:
        header(_PREFIX + "uptime_seconds", "gauge")
        lines.append(f"{_PREFIX}uptime_seconds {_fmt(uptime)}")
    return "\n".join(lines) + "\n"
