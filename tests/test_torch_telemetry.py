"""The port's telemetry package (``deepspeed_tpu_torch/telemetry``,
``monitor``) against the JAX package's.

One scripted event sequence — counters, gauges, histograms over a sliding
window and through the reservoir, spans on two threads, async spans with
flows, instants, a flight dump — drives the JAX ``TelemetrySink`` and the
port's on one fake clock (each sink's ``now`` replaced): ``snapshot()``,
the JSONL (the wall-clock ``started_at`` masked), ``trace.json`` and the
Prometheus text must be equal. The SLO engine's burn and recovery, the
flight recorder's ring, dump and rate limit, ``traceparent`` parsing and
the capacity model are held to the JAX modules' results the same way. Port
only: the disabled sink writes nothing and its hooks are inert, the
host-gap buckets sum exactly, the CSV monitor gets the training engine's
gauges, and a ``torch.profiler`` capture answers 409 while busy and stops at
its deadline."""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu.telemetry as jtel
import deepspeed_tpu.telemetry.capacity as jcap
import deepspeed_tpu.telemetry.prometheus as jprom
import deepspeed_tpu.telemetry.tracing as jtracing
import deepspeed_tpu.models as jm
import deepspeed_tpu_torch
import deepspeed_tpu_torch.models as tm
import deepspeed_tpu_torch.telemetry as ttel
import deepspeed_tpu_torch.telemetry.capacity as tcap
import deepspeed_tpu_torch.telemetry.prometheus as tprom
import deepspeed_tpu_torch.telemetry.tracing as ttracing
from deepspeed_tpu_torch.telemetry.profiler import ProfileBusy, TorchProfiler, trace_artifacts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _sink(mod, path, clock, **cfg):
    sink = mod.TelemetrySink({"enabled": True, "output_path": str(path), "flush_interval": 7,
                              **cfg})
    sink.now = clock
    return sink


def _script(sink, clock):
    """One event sequence, every producer, on the fake clock."""
    sink.track_threshold("lat_ms", 5.0)
    for i in range(40):
        clock.t = 0.5 * i
        sink.counter("req", 1)
        sink.counter("bytes", 1000 + i, attrs={"unit": "B"})
        sink.gauge("depth", i % 5)
        sink.histogram("lat_ms", float((i * 7) % 13), attrs={"unit": "ms"})
        if i % 3 == 0:
            sink.gauges([("mfu", 0.1 * (i % 4), i), ("hbm", 0.2, i)])
    clock.t = 21.0
    with sink.span("outer", k=1):
        clock.t = 21.5

    def worker():
        clock.t = 22.0
        sink.record_span("pump", 21.8, 0.2, attrs={"iter": 1}, flow_out=["t1/1", "t1/2"])

    th = threading.Thread(target=worker, name="pump-thread")
    th.start()
    th.join(30)
    assert not th.is_alive()
    clock.t = 22.5
    sink.record_async("req/decode", "t1", 21.9, 0.5, attrs={"rid": 3}, flow_in=["t1/1"])
    sink.event("req/complete", attrs={"tokens": 8}, track="t1")
    sink.event("slo/alert", attrs={"objective": "x"})
    clock.t = 23.0
    sink.flush()
    clock.t = 24.0
    sink.counter("req", 2)
    sink.histogram("lat_ms", 99.0)
    sink.close()


def _masked_jsonl(path):
    lines = [json.loads(line) for line in open(os.path.join(path, "telemetry.jsonl"))]
    assert lines[0]["type"] == "meta"
    lines[0].pop("started_at")
    return lines


@pytest.mark.parametrize("cfg", [{}, {"hist_window_s": 6.0}, {"hist_max_samples": 12},
                                 {"hist_window_s": 12.0, "hist_max_samples": 6}],
                         ids=["default", "window", "reservoir", "window_and_reservoir"])
def test_sink_matches_jax_on_a_scripted_sequence(tmp_path, cfg):
    """snapshot(), JSONL (started_at masked), trace.json and the Prometheus
    text equal the JAX sink's, with the histogram window sliding (6 s over a
    20 s stream) and the reservoir downsampling (2 samples a chunk)."""
    cj, ct = _Clock(), _Clock()
    js = _sink(jtel, tmp_path / "jax", cj, **cfg)
    ts = _sink(ttel, tmp_path / "port", ct, **cfg)
    _script(js, cj)
    _script(ts, ct)
    snap_j, snap_t = js.snapshot(), ts.snapshot()
    assert snap_t == snap_j
    hist = snap_t["histograms"]["lat_ms"]
    if "hist_window_s" in cfg:
        assert hist["window_count"] < hist["count"]  # the window slid
    if "hist_max_samples" in cfg:
        assert hist["dropped"] > 0  # the reservoir sampled
    assert _masked_jsonl(tmp_path / "port") == _masked_jsonl(tmp_path / "jax")
    with open(tmp_path / "jax" / "trace.json") as f_j, open(tmp_path / "port" / "trace.json") as f_t:
        assert json.load(f_t) == json.load(f_j)
    extra = {"gateway/ready": 1.0}
    assert tprom.render(snap_t, extra_gauges=extra) == jprom.render(snap_j, extra_gauges=extra)
    assert ts.hist_exceed("lat_ms", 5.0) == js.hist_exceed("lat_ms", 5.0)


def test_trace_summary_reads_the_port_jsonl(tmp_path):
    """``tools/trace_summary.py`` reads the port's JSONL unchanged, and
    prints what it prints for the JAX sink's."""
    outs = []
    for mod, sub in ((jtel, "jax"), (ttel, "port")):
        clock = _Clock()
        _script(_sink(mod, tmp_path / sub, clock), clock)
        for flags in ([], ["--requests", "2"]):
            r = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "trace_summary.py"),
                                str(tmp_path / sub / "telemetry.jsonl")] + flags,
                               capture_output=True, text=True, timeout=120)
            assert r.returncode == 0, r.stderr
            outs.append(r.stdout)
    assert outs[2:] == outs[:2] and "lat_ms" in outs[2] and "t1" in outs[3]


def _slo_run(mod, path):
    """A ratio and a histogram objective through a burn and a recovery;
    returns every evaluation's state and the alert/recover events."""
    clock = _Clock()
    sink = _sink(mod, path, clock)
    cfg = {"fast_window_s": 10.0, "slow_window_s": 30.0, "eval_interval_s": 1.0,
           "objectives": [{"name": "errors", "kind": "ratio", "num": ["bad"], "den": ["all"],
                           "max": 0.1},
                          {"name": "lat", "kind": "histogram", "metric": "lat_ms",
                           "threshold": 50.0, "target": 0.9},
                          {"name": "mfu_floor", "kind": "gauge_min", "metric": "mfu",
                           "min": 0.2, "budget": 0.5}]}
    slo = mod.SLOEngine(sink, cfg)
    fired = []
    slo.on_alert.append(lambda st: fired.append(st["name"]))
    states = []
    for t in range(80):
        clock.t = float(t)
        storm = 20 <= t < 40
        sink.counter("all", 10)
        sink.counter("bad", 5 if storm else 0)
        sink.histogram("lat_ms", 90.0 if storm else 10.0)
        sink.gauge("mfu", 0.1 if storm else 0.5)
        st = slo.maybe_evaluate()
        if st is not None:
            states.append(json.dumps(st, sort_keys=True))
    sink.close()
    events = [json.loads(line)["name"] for line in open(os.path.join(path, "telemetry.jsonl"))
              if '"type": "event"' in line]
    return states, fired, slo.alerts, events


def test_slo_burn_and_recovery_match_jax(tmp_path):
    """Ratio, histogram and gauge objectives through a 20 s storm and its
    recovery: every evaluation's state, the alert hooks and events equal the
    JAX engine's; each objective alerts once and recovers."""
    j = _slo_run(jtel, str(tmp_path / "jax"))
    t = _slo_run(ttel, str(tmp_path / "port"))
    assert t == j
    states, fired, alerts, _ = t
    assert sorted(fired) == ["errors", "lat", "mfu_floor"] and alerts == 3
    assert not any(o["burning"] for o in json.loads(states[-1])["objectives"])


def _flight_run(mod, path):
    clock = _Clock()
    sink = _sink(mod, path, clock, flight_recorder={"capacity": 64, "post_window_s": 0.5,
                                                    "min_interval_s": 2.0})
    for i in range(100):  # overflows the 64-event ring
        clock.t = 0.01 * i
        sink.counter("c", 1)
    first = sink.dump_flight("first", {"why": "test"})
    clock.t = 1.2
    assert sink.dump_flight("rate_limited") is None  # inside min_interval_s
    sink.gauge("after", 1.0)  # lands in the post-window
    clock.t = 1.8
    sink.flush()  # the post-window has elapsed: the dump is written
    clock.t = 3.5
    second = sink.dump_flight("second")
    sink.close()  # force-finalizes the pending dump
    docs = []
    for p in (first, second):
        with open(p) as f:
            doc = json.loads(f.read().replace(path, "<dir>"))  # the trigger events' paths
        doc.pop("started_at")
        docs.append(doc)
    return [os.path.basename(first), os.path.basename(second)], docs


def test_flight_recorder_ring_dump_and_rate_limit_match_jax(tmp_path):
    """The ring keeps its last 64 events, a second trigger inside the
    interval is dropped, post-window events are appended, close finalizes a
    pending dump: the dump files equal the JAX recorder's."""
    j = _flight_run(jtel, str(tmp_path / "jax"))
    t = _flight_run(ttel, str(tmp_path / "port"))
    assert t == j
    names, docs = t
    assert names == ["flight_001_first.json", "flight_002_second.json"]
    assert len(docs[0]["events_before"]) == 64
    assert [e[2] for e in docs[0]["events_after"]] == ["flight/trigger", "flight/dumps", "after"]


@pytest.mark.parametrize("headers", [
    {"traceparent": "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"},
    {"traceparent": "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-01"},
    {"traceparent": "00-" + "0" * 32 + "-00f067aa0ba902b7-01", "x-request-id": "fallback"},
    {"traceparent": "garbage", "x-request-id": "req 42/!"},
    {"x-request-id": "a" * 100},
])
def test_traceparent_parsing_matches_jax(headers):
    """W3C traceparent wins (case-insensitive), an all-zero trace id falls
    back to x-request-id (sanitized, 64 characters at most)."""
    assert ttracing.extract_trace_context(headers) == jtracing.extract_trace_context(headers)


def test_minted_trace_ids_and_request_trace_phases(tmp_path):
    """Without identity headers a 32-hex id is minted; a RequestTrace's
    phases land on its track with the gateway's attributes."""
    tid, parent, propagated = ttracing.extract_trace_context({})
    assert len(tid) == 32 and parent is None and not propagated
    clock = _Clock()
    sink = _sink(ttel, tmp_path, clock)
    tr = ttel.RequestTrace(sink, tid, "00f067aa0ba902b7", tenant="acme")
    tr.rid, tr.track = 7, f"{tid}:7"
    tr.mark("queued")
    clock.t = 1.0
    tr.phase("queued", wait_ms=1000.0)
    tr.instant("admitted")
    sink.close()
    spans = [json.loads(line) for line in open(tmp_path / "telemetry.jsonl")][1:]
    assert spans[0]["track"] == f"{tid}:7" and spans[0]["dur"] == 1.0
    assert spans[0]["attrs"] == {"tenant": "acme", "rid": 7, "parent": "00f067aa0ba902b7",
                                 "trace": tid, "wait_ms": 1000.0}
    assert spans[1]["name"] == "req/admitted"


def test_disabled_sink_writes_nothing_and_is_inert(tmp_path, monkeypatch):
    """telemetry off: no files, the span context is one shared null object,
    every producer returns at once and the snapshot stays empty; a
    scheduler on a disabled sink builds no capacity meter and no tracker."""
    monkeypatch.chdir(tmp_path)
    sink = ttel.TelemetrySink({"enabled": False, "output_path": str(tmp_path / "tel")})
    assert sink.span("a") is sink.span("b")
    with sink.span("a"):
        sink.counter("c")
        sink.histogram("h", 1.0)
        sink.gauge("g", 1.0)
        sink.record_async("x", "t", 0.0, 1.0)
        sink.event("e")
    sink.flush()
    sink.close()
    assert sink.dump_flight("x") is None
    assert sink.snapshot()["counters"] == {} and sink.snapshot()["histograms"] == {}
    assert not os.path.exists(tmp_path / "tel") and os.listdir(tmp_path) == []
    ttel.set_sink(None)
    eng = deepspeed_tpu_torch.init_inference(
        "tiny", config={"dtype": "float32", "continuous_batching": {"enabled": True,
                                                                    "num_slots": 2}},
        device="cpu")
    sched = eng.scheduler()
    assert not eng.telemetry.enabled and sched.capacity is None and sched._gap is None
    sched.submit([5, 6, 7], max_new_tokens=4).result()
    assert os.listdir(tmp_path) == []


def test_host_gap_buckets_sum_exactly():
    """Buckets sum to the measured gap exactly: the residue goes to
    ``other``, a nested section steals from its enclosing one (even before
    the enclosing stamp lands), over-attribution scales back; the port's
    tracker gives the JAX tracker's counters."""
    results = []
    for mod, cap in ((jtel, jcap), (ttel, tcap)):
        sink = mod.TelemetrySink(None)
        sink.enabled = True  # counters and histograms only: no file is written
        tr = cap.HostGapTracker(sink)
        tr.dispatch(0.0)  # warm-up dispatch before any sync: clears only
        tr.sync_end(1.0)
        tr.add("trie_probe", 0.002, steal_from="admission")  # debit first
        tr.add("admission", 0.010)
        tr.add("sampling_host", 0.003)
        tr.add("on_token", 0.004)
        tr.dispatch(1.025)
        tr.sync_end(2.0)
        tr.add("admission", 0.030)  # more than the gap: scaled back
        tr.add("on_token", 0.030)
        tr.dispatch(2.020)
        snap = sink.snapshot()
        parts = {k: v["total"] for k, v in snap["counters"].items()}
        results.append((parts, snap["histograms"]["serving/host_gap_ms"]["sum"], tr.gaps,
                        tr.total_gap_s))
    assert results[1] == results[0]
    parts, total_ms, gaps, total_s = results[1]
    assert cap.GAP_BUCKETS == jcap.GAP_BUCKETS and gaps == 2
    assert parts["serving/host_gap/trie_probe_ms"] == pytest.approx(2.0)
    assert parts["serving/host_gap/admission_ms"] == pytest.approx(8.0 + 10.0)
    assert parts["serving/host_gap/other_ms"] == pytest.approx(25.0 - 17.0)
    assert sum(parts.values()) == pytest.approx(total_ms, rel=1e-12, abs=1e-9)
    assert total_ms == pytest.approx(45.0) and total_s == pytest.approx(0.045)


@pytest.mark.parametrize("name,int8", [("tiny", False), ("gpt2-large", True), ("llama3-8b", True)])
def test_capacity_model_matches_jax(name, int8):
    """The analytic FLOPs and HBM bytes of a dispatch equal the JAX model's
    on the same config: a chunk sync (64 columns, K = 4) and a decode sync."""
    jmc = jm.get_model(name).cfg
    tmc = tm.get_model(name).cfg
    if int8:
        import dataclasses
        jmc = dataclasses.replace(jmc, int8_weights=True)
        tmc = dataclasses.replace(tmc, int8_weights=True)
    jmodel = jcap.CapacityModel(jmc, 1024, 8)
    tmodel = tcap.CapacityModel(tmc, 1024, 8)
    ctx = np.array([300, 17, 440], np.int64)
    for key, (width, k) in ((("chunk", 64, 4), (64, 4)), (("decode", 4), (1, 4))):
        assert tcap.dispatch_shape(key) == (width, k)
        got = tmodel.dispatch_cost(ctx.tolist(), width, k)
        want = jmodel.dispatch_cost(ctx, width, k)
        assert got == pytest.approx(want, rel=1e-12)
    assert tmodel.flops_per_token(100) == pytest.approx(jmodel.flops_per_token(100), rel=1e-12)


def test_capacity_meter_gauges_and_goodput(tmp_path):
    """A sampled dispatch sets serving/mfu, serving/hbm_bw_util and the
    kind's roofline gauge from the analytic cost over its wall time; the
    goodput fraction folds rejected tokens in."""
    sink = _sink(ttel, tmp_path, _Clock())
    mc = tm.get_model("gpt2-large").cfg
    meter = tcap.CapacityMeter(sink, tcap.CapacityModel(mc, 100, 8), peak_flops=989e12,
                               peak_hbm_bw=3.35e12, sample_every=4)
    assert [meter.should_sample(i) for i in range(1, 9)] == [False] * 3 + [True] + [False] * 3 + [True]
    meter.observe_dispatch(("decode", 4), 0.05, [100, 200])
    flops, nbytes = meter.model.dispatch_cost([100, 200], 1, 4)
    g = sink.snapshot()["gauges"]
    assert g["serving/mfu"] == pytest.approx(flops / 0.05 / 989e12)
    assert g["serving/hbm_bw_util"] == pytest.approx(nbytes / 0.05 / 3.35e12)
    assert "serving/roofline/decode" in g and meter.program_table()["('decode', 4)"]["samples"] == 1
    meter.account(30, wasted_tokens=10, ctx=50)
    assert meter.goodput_fraction == pytest.approx(0.75)
    sink.close()


def test_csv_monitor_gets_the_training_gauges(tmp_path):
    """The training engine's gauges reach the CSV monitor (one file a
    scalar, ``step,value`` lines) with telemetry off; with it on, the step
    span and the mfu gauge reach the sink too."""
    ttel.set_sink(None)
    model = tm.get_model("tiny", dtype=torch.float32)
    batch = {"input_ids": np.random.default_rng(0).integers(0, 256, (4, 16)),
             "labels": np.random.default_rng(1).integers(0, 256, (4, 16))}
    csv_dir = tmp_path / "csv"
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config={"train_batch_size": 4, "steps_per_print": 1,
                             "csv_monitor": {"enabled": True, "output_path": str(csv_dir),
                                             "job_name": "job"}}, device="cpu")
    assert not eng.telemetry.enabled and eng.monitor.enabled
    for _ in range(2):
        eng.train_batch(batch=batch)
    files = sorted(os.listdir(csv_dir / "job"))
    assert files == ["Train_Samples_lr.csv", "Train_Samples_train_loss.csv"]
    rows = open(csv_dir / "job" / "Train_Samples_train_loss.csv").read().splitlines()
    assert [r.split(",")[0] for r in rows] == ["4", "8"]
    tel_dir = tmp_path / "tel"
    eng, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config={"train_batch_size": 4, "steps_per_print": 1,
                             "telemetry": {"enabled": True, "output_path": str(tel_dir)},
                             "csv_monitor": {"enabled": True, "output_path": str(csv_dir),
                                             "job_name": "tel"}}, device="cpu")
    try:
        eng.train_batch(batch=batch)
        snap = eng.telemetry.snapshot()
        assert 0.0 < snap["gauges"]["mfu"] and "mfu.csv" in os.listdir(csv_dir / "tel")
    finally:
        eng.telemetry.close()
        ttel.set_sink(None)
    spans = [json.loads(line) for line in open(tel_dir / "telemetry.jsonl")
             if '"type": "span"' in line]
    assert [s["name"] for s in spans] == ["step"] and spans[0]["attrs"]["path"] == "fused"


def test_profiler_busy_409_and_deadline(tmp_path):
    """A capture in flight refuses a second (the gateway's 409); it stops at
    its own deadline with no poll and leaves a Chrome trace; the training
    path's request/maybe_capture starts a pending capture once."""
    prof = TorchProfiler(str(tmp_path))
    d = prof.start(0.3, tag="a b")
    assert os.path.basename(d) == "torch_trace_001_a_b"
    with pytest.raises(ProfileBusy):
        prof.start(0.3)
    with pytest.raises(ProfileBusy):
        prof.request(0.3)
    deadline = time.monotonic() + 60
    while prof.active is not None and time.monotonic() < deadline:
        time.sleep(0.02)
    assert prof.active is None and prof.captures == [d]
    assert trace_artifacts(d) == [os.path.join(d, "capture.trace.json")]
    with open(trace_artifacts(d)[0]) as f:
        assert "traceEvents" in json.load(f)
    prof.request(5.0)
    assert prof.maybe_capture(tag="report") is not None
    assert prof.maybe_capture() is None  # nothing pending
    prof.stop()  # force-stops and waits for the export
    assert prof.active is None and len(prof.captures) == 2
