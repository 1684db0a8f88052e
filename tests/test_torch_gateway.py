"""The port's serving gateway (``deepspeed_tpu_torch/serving``) end to end
over localhost HTTP on the CPU.

Against the JAX package: the gateway's greedy SSE streams equal the JAX
scheduler's direct-submit tokens on the same weights (``tiny`` at fp32,
``params_from_jax`` of one numpy tree; the tolerance of
``test_torch_scheduler.py::test_fp32_streams_and_logits_match_jax``: equal
tokens), and bitwise the port's own direct submit. Then the cases of
``tests/unit/serving/test_gateway.py`` and ``test_observability.py``'s
gateway tests on the port: health/ready/metrics, bad requests, overrides
not mutating the engine's config, 429 with a bounded ``Retry-After``,
deadline expiry in the queue and mid-decode, client disconnect cancelling,
the DRR light tenant not starved, drain, tenant telemetry, a
``traceparent`` span tree, Prometheus text, ``/v1/slo`` and
``/v1/debug/flight``; the autoscaler and the elastic fleet refused naming
ROADMAP Queue 1 #9.5; the multi-host worker hooks answering outside worker
mode.

No assertion rests on wall time. A test that needs requests to queue holds
the gateway's dispatch lock (the pump cannot admit) while they arrive; one
that needs a request still decoding slows the scheduler's step. Every
socket, join and wait has its own timeout, and every gateway is closed in a
``finally``."""

import functools
import http.client
import json
import os
import re
import threading
import time

import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu.models as jm
import deepspeed_tpu_torch
import deepspeed_tpu_torch.models as tm
from deepspeed_tpu.comm import comm
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.serving import FairQueue, Gateway, QueueFull, ReplicaSet
from deepspeed_tpu_torch.telemetry import set_sink

from .torch_port_helpers import numpy_params

PROMPT = [5, 6, 7, 8, 9]
PROMPTS = [PROMPT, [int(t) for t in np.resize(np.arange(3, 40), 100)], [10, 11, 12], [7] * 20]
TRACEPARENT = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
JOIN_S = 120
_PROM_LINE = re.compile(r"^(# (TYPE|HELP) .*|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? "
                        r"([0-9eE.+-]+|NaN|[+-]Inf)( [0-9]+)?)$")


@functools.lru_cache(maxsize=None)
def _tree():
    return numpy_params(jm.get_model("tiny", max_seq_len=128), seed=10)


def make_engine(num_slots=2, telemetry=None, **cfg):
    """A port engine on the CPU (tiny, fp32) on the shared weights."""
    set_sink(None)
    tmod = tm.get_model("tiny", max_seq_len=128)
    config = {"dtype": "float32", "continuous_batching": {"enabled": True, "num_slots": num_slots}}
    if telemetry is not None:
        config["telemetry"] = telemetry
    config.update(cfg)
    return deepspeed_tpu_torch.init_inference(tmod, config=config,
                                              params=params_from_jax(_tree(), tmod.cfg), device="cpu")


def start_gateway(num_slots=2, telemetry=None, **gw_overrides):
    gw = Gateway(make_engine(num_slots, telemetry), port=0, **gw_overrides)
    gw.start_background()
    return gw


def close(gw):
    ok = gw.close(timeout=JOIN_S)
    gw.telemetry.close()
    set_sink(None)
    return ok


def slow_steps(gw, seconds):
    """Every scheduler step of ``gw`` sleeps ``seconds`` after its work, so
    requests stay in flight long enough to be acted on."""
    sched = gw.scheduler
    real = sched.step

    def step():
        out = real()
        time.sleep(seconds)
        return out
    sched.step = step


def post(port, body, timeout=JOIN_S):
    """One blocking completion request; returns (status, headers, body)."""
    body = dict(body)
    headers = {"Content-Type": "application/json", **body.pop("_headers", {})}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/completions", json.dumps(body), headers)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def get(port, path, headers=None, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def sse_tokens(raw):
    """An SSE byte stream -> (token list, finish_reason, saw [DONE])."""
    toks, reason, done = [], None, False
    for line in raw.decode().splitlines():
        if not line.startswith("data: "):
            continue
        if line == "data: [DONE]":
            done = True
            continue
        chunk = json.loads(line[6:])["choices"][0]
        toks.extend(chunk["token_ids"])
        if chunk["finish_reason"] is not None:
            reason = chunk["finish_reason"]
    return toks, reason, done


def stream(port, prompt, max_tokens, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=JOIN_S)
    try:
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": prompt, "max_tokens": max_tokens, "stream": True}),
                     headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), sse_tokens(resp.read())
    finally:
        conn.close()


def run_threads(fns):
    threads = [threading.Thread(target=fn) for fn in fns]
    for t in threads:
        t.start()
    return threads


def join_all(threads):
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive(), "a client thread did not finish"


def wait_for(cond, what, timeout=JOIN_S):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


@pytest.fixture(scope="module")
def direct():
    """The port's and the JAX scheduler's direct-submit greedy tokens for
    PROMPTS (8 new each) on the shared weights."""
    eng = make_engine(num_slots=2)
    sched = eng.scheduler()
    port = [h.result().tolist() for h in [sched.submit(p, max_new_tokens=8) for p in PROMPTS]]
    comm._state["mesh"] = None
    from deepspeed_tpu.telemetry import set_sink as set_jax_sink
    set_jax_sink(None)
    je = deepspeed_tpu.init_inference(
        jm.get_model("tiny", max_seq_len=128),
        config={"dtype": "float32", "continuous_batching": {"enabled": True, "num_slots": 2}},
        params=_tree())
    js = je.scheduler()
    jax_out = [np.asarray(h.result()).tolist()
               for h in [js.submit(p, max_new_tokens=8) for p in PROMPTS]]
    return port, jax_out


# ------------------------------------------------------------------ parity
def test_sse_streams_equal_direct_submit_and_jax(direct):
    """Concurrent SSE streams through the gateway equal the port's direct
    submit bitwise and the JAX scheduler's direct submit (equal tokens); the
    unary path agrees."""
    port_ref, jax_ref = direct
    assert port_ref == jax_ref
    gw = start_gateway()
    try:
        out = {}

        def client(i):
            return lambda: out.__setitem__(i, stream(gw.port, PROMPTS[i], 8))
        join_all(run_threads([client(i) for i in range(len(PROMPTS))]))
        for i, ref in enumerate(port_ref):
            status, headers, (toks, reason, done) = out[i]
            assert status == 200 and headers["Content-Type"] == "text/event-stream"
            assert toks == ref, f"stream {i} diverged from direct submit()"
            assert reason == "length" and done
        status, _, body = post(gw.port, {"prompt": PROMPT, "max_tokens": 8})
        assert status == 200
        out = json.loads(body)
        assert out["choices"][0]["token_ids"] == port_ref[0]
        assert out["usage"] == {"prompt_tokens": 5, "completion_tokens": 8, "total_tokens": 13}
    finally:
        assert close(gw)


def test_health_ready_metrics_endpoints():
    gw = start_gateway()
    try:
        assert get(gw.port, "/healthz")[0] == 200
        assert get(gw.port, "/readyz")[0] == 200
        post(gw.port, {"prompt": PROMPT, "max_tokens": 4})
        status, _, body = get(gw.port, "/v1/metrics")
        assert status == 200
        metrics = json.loads(body)
        assert metrics["gateway"]["completed"] == 1 and metrics["gateway"]["tokens"] == 4
        assert metrics["scheduler"]["num_slots"] == 2
        assert metrics["scheduler"]["dispatched"]
        # the fused decode-layer gate's verdict: this fp32 engine is out,
        # and the reasons say why
        assert metrics["scheduler"]["fused_decode_block"] is False
        assert any("int8" in r for r in metrics["scheduler"]["fused_decode_reasons"])
        assert metrics["replicas"][0]["dispatched"] == 1
        assert get(gw.port, "/nope")[0] == 404
    finally:
        assert close(gw)
        assert gw.draining and not gw.ready


def test_bad_requests_rejected():
    gw = start_gateway()
    try:
        for body in ({"prompt": []}, {"prompt": "not ids"}, {"max_tokens": 4},
                     {"prompt": PROMPT, "max_tokens": -1},
                     {"prompt": PROMPT, "max_tokens": 10_000_000},
                     {"prompt": PROMPT, "timeout_s": 0}, {"prompt": PROMPT, "timeout_s": -5},
                     {"prompt": PROMPT, "timeout_s": "soon"},
                     {"prompt": PROMPT, "top_k": [1, 2]}, {"prompt": PROMPT, "temperature": "hot"},
                     {"prompt": PROMPT, "adapter_id": "acme"}):
            status, _, raw = post(gw.port, dict(body))
            assert status == 400, (body, raw)
            assert "error" in json.loads(raw)
        # a resume body is a handoff descriptor: an incomplete one is refused
        status, _, raw = post(gw.port, {"prompt": PROMPT, "resume": {"key": [1]}})
        assert status == 400 and "resume descriptor missing" in json.loads(raw)["error"]["message"]
        status, _, raw = post(gw.port, {"prompt": PROMPT, "adapter_id": "acme"})
        assert status == 400 and "Queue 1 #9.3" in json.loads(raw)["error"]["message"]
        # null sampling params mean "default"
        status, _, raw = post(gw.port, {"prompt": PROMPT, "max_tokens": 2, "top_k": None,
                                        "temperature": None, "seed": None, "top_p": None})
        assert status == 200, raw
        # an oversized body answers 413 before it is buffered
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=60)
        try:
            conn.putrequest("POST", "/v1/completions")
            conn.putheader("Content-Length", str(1 << 30))
            conn.endheaders()
            assert conn.getresponse().status == 413
        finally:
            conn.close()
        status, _, raw = post(gw.port, {"prompt": "5 6 7 8 9", "max_tokens": 2})
        assert status == 200 and json.loads(raw)["usage"]["prompt_tokens"] == 5
    finally:
        assert close(gw)


def test_overrides_do_not_mutate_engine_config():
    """Keyword overrides apply to this gateway only."""
    eng = make_engine()
    before = eng._config.gateway.max_queue_depth
    gw = Gateway(eng, max_queue_depth=before + 7)
    assert gw.config.max_queue_depth == before + 7
    assert eng._config.gateway.max_queue_depth == before
    assert Gateway(eng).config.max_queue_depth == before
    with pytest.raises(ValueError, match="unknown GatewayConfig override"):
        Gateway(eng, no_such_field=1)


# ------------------------------------------------------------------ admission control
def test_overload_sheds_with_429_and_retry_after():
    """With the pump held, a queue of depth 2 takes two requests and sheds
    the other eight with 429 and an integer Retry-After in [1, 30]; the
    two accepted requests then complete in full."""
    gw = start_gateway(num_slots=1, max_queue_depth=2)
    results = []
    lock = threading.Lock()

    def client():
        r = post(gw.port, {"prompt": PROMPT, "max_tokens": 16})
        with lock:
            results.append(r)
    try:
        with gw._dispatch_lock:  # the pump cannot admit while the requests arrive
            threads = run_threads([client] * 10)
            wait_for(lambda: len(results) == 8, "eight 429 responses")
        join_all(threads)
        codes = sorted(status for status, _, _ in results)
        assert codes == [200] * 2 + [429] * 8, codes
        for status, headers, body in results:
            if status == 429:
                assert 1 <= int(headers["Retry-After"]) <= 30
                assert json.loads(body)["error"]["type"] == "overloaded"
                assert "x-request-id" in headers
            else:
                assert len(json.loads(body)["choices"][0]["token_ids"]) == 16
        assert gw.stats["shed_429"] == 8
        assert gw.scheduler.cache.active_slots == 0
    finally:
        assert close(gw)


def test_deadline_expiry_in_queue_answers_504():
    """A request whose deadline lapses while it waits in the fair queue
    answers 504 without taking a slot."""
    gw = start_gateway(num_slots=1)
    results = {}
    try:
        with gw._dispatch_lock:
            t = run_threads([lambda: results.__setitem__(
                "dead", post(gw.port, {"prompt": [1, 2, 3], "max_tokens": 8, "timeout_s": 0.05}))])
            wait_for(lambda: len(gw._fair) == 1, "the request to queue")
            time.sleep(0.1)  # past its deadline before the pump can pop it
        join_all(t)
        assert results["dead"][0] == 504
        assert gw.stats["deadline_expired"] == 1 and gw.stats["completed"] == 0
        assert gw.scheduler.cache.total_allocs == 0
    finally:
        assert close(gw)


def test_active_deadline_cancels_mid_decode():
    """An admitted request whose deadline lapses mid-decode is cancelled:
    its tokens so far return with finish_reason 'deadline' and its slot
    frees (every step is slowed to 0.25 s, so 120 tokens take 7.5 s)."""
    gw = start_gateway(num_slots=1)
    slow_steps(gw, 0.25)
    try:
        status, _, raw = post(gw.port, {"prompt": PROMPT, "max_tokens": 120, "timeout_s": 1.5})
        out = json.loads(raw)
        assert status == 200 and out["choices"][0]["finish_reason"] == "deadline"
        assert 0 < len(out["choices"][0]["token_ids"]) < 120
        wait_for(lambda: gw.scheduler.cache.active_slots == 0, "the slot to free")
        assert gw.stats["deadline_expired"] == 1
    finally:
        assert close(gw)


def test_client_disconnect_cancels_slot():
    """Closing the socket mid-stream cancels the request: its slot frees,
    and the pool serves the next request."""
    gw = start_gateway(num_slots=1)
    slow_steps(gw, 0.05)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=60)
        try:
            conn.request("POST", "/v1/completions",
                         json.dumps({"prompt": PROMPT, "max_tokens": 100, "stream": True}), {})
            resp = conn.getresponse()
            assert resp.status == 200
            resp.read(40)  # a couple of SSE events...
            resp.close()   # ...then vanish
        finally:
            conn.close()
        wait_for(lambda: gw.stats["disconnects"] == 1 and gw.scheduler.cache.active_slots == 0,
                 "the disconnect to cancel the slot")
        status, _, raw = post(gw.port, {"prompt": PROMPT, "max_tokens": 4})
        assert status == 200 and len(json.loads(raw)["choices"][0]["token_ids"]) == 4
    finally:
        assert close(gw)


# ------------------------------------------------------------------ fairness
def test_fair_queue_drr_interleaves_tenants():
    """A 10:1 skew pops interleaved: the light tenant's 2 requests surface
    within the first few pops; each flow stays FIFO; past max_depth, push
    raises QueueFull."""
    fq = FairQueue(max_depth=64, quantum=8)
    for i in range(20):
        fq.push(("A", i), "heavy", "standard", cost=8)
    for i in range(2):
        fq.push(("B", i), "light", "standard", cost=8)
    order = [fq.pop() for _ in range(22)]
    b_ranks = [i for i, item in enumerate(order) if item[0] == "B"]
    assert b_ranks[0] <= 2 and b_ranks[1] <= 4, order[:6]
    assert [it[1] for it in order if it[0] == "A"] == list(range(20))
    small = FairQueue(max_depth=1)
    small.push("a", "t", "standard")
    with pytest.raises(QueueFull):
        small.push("b", "t", "standard")


def test_gateway_drr_light_tenant_not_starved():
    """Tenant B's one request, queued behind tenant A's ten (all queued
    while the pump is held), finishes before the last three of A's."""
    gw = start_gateway(num_slots=1, max_queue_depth=32, quantum_tokens=8)
    order = []
    lock = threading.Lock()

    def run(tag, tenant):
        def fn():
            status, _, _ = post(gw.port, {"prompt": PROMPT, "max_tokens": 8,
                                          "_headers": {"x-tenant-id": tenant}})
            with lock:
                order.append((tag, status))
        return fn
    try:
        with gw._dispatch_lock:
            threads = []
            for i in range(10):  # A's arrivals first, in order
                threads += run_threads([run(f"A{i}", "heavy")])
                wait_for(lambda: len(gw._fair) == i + 1, "A's request to queue")
            threads += run_threads([run("B", "light")])
            wait_for(lambda: len(gw._fair) == 11, "B's request to queue")
        join_all(threads)
        assert all(s == 200 for _, s in order)
        b_rank = [i for i, (tag, _) in enumerate(order) if tag == "B"][0]
        assert b_rank < len(order) - 3, order
    finally:
        assert close(gw)


# ------------------------------------------------------------------ lifecycle
def test_drain_completes_in_flight_then_refuses():
    """Drain finishes every admitted request in full, sheds new ones with
    503 and a Retry-After, and the server thread exits."""
    gw = start_gateway(num_slots=2)
    slow_steps(gw, 0.1)
    results = []
    lock = threading.Lock()
    budget = 64

    def client():
        r = post(gw.port, {"prompt": PROMPT, "max_tokens": budget})
        with lock:
            results.append(r)
    try:
        threads = run_threads([client] * 3)
        wait_for(lambda: len(gw._active) == 2, "two requests decoding")
        gw.begin_drain()
        status, headers, _ = post(gw.port, {"prompt": PROMPT, "max_tokens": 2})
        assert status == 503 and int(headers["Retry-After"]) >= 1
        assert get(gw.port, "/readyz")[0] == 503
        join_all(threads)
        for status, _, raw in results:
            assert status == 200
            assert len(json.loads(raw)["choices"][0]["token_ids"]) == budget
        assert gw.wait_drained(JOIN_S)
        assert gw.stats["shed_503"] == 1 and gw.scheduler.cache.active_slots == 0
    finally:
        close(gw)


def test_tenant_telemetry_and_queue_wait(tmp_path):
    """Gateway telemetry reaches the sink: queue-wait and TTFB histograms,
    per-tenant token counters; /v1/metrics serves the same snapshot."""
    gw = start_gateway(telemetry={"enabled": True, "output_path": str(tmp_path)},
                       max_queue_depth=1)
    try:
        post(gw.port, {"prompt": PROMPT, "max_tokens": 4, "_headers": {"x-tenant-id": "acme"}})
        post(gw.port, {"prompt": PROMPT, "max_tokens": 6, "_headers": {"x-tenant-id": "globex"}})
        tel = gw.telemetry
        assert tel.counter_total("gateway/requests") == 2
        assert tel.counter_total("gateway/tenant/acme/tokens") == 4
        assert tel.counter_total("gateway/tenant/globex/tokens") == 6
        snap = tel.snapshot()
        assert snap["histograms"]["gateway/queue_wait_ms"]["count"] == 2
        assert snap["histograms"]["gateway/ttfb_ms"]["count"] == 2
        _, _, raw = get(gw.port, "/v1/metrics")
        metrics = json.loads(raw)
        assert metrics["telemetry"]["counters"]["gateway/completed"]["total"] == 2
        assert metrics["capacity"]["host_gaps"] > 0
    finally:
        assert close(gw)


# ------------------------------------------------------------------ observability
def _tel(tmp_path, **over):
    return {"enabled": True, "output_path": str(tmp_path), "flush_interval": 16,
            "capacity_sample_every": 1,
            "flight_recorder": {"post_window_s": 0.05, "min_interval_s": 0.0}, **over}


def test_traceparent_yields_connected_span_tree(tmp_path):
    """A request with a W3C traceparent: x-request-id and traceparent echo;
    the trace holds its phase tree on one track, its milestones, and flow
    links running forward from sched/step spans into its phases; the JSONL
    holds the same tree."""
    gw = start_gateway(telemetry=_tel(tmp_path))
    tel = gw.telemetry
    try:
        status, headers, _ = post(gw.port, {"prompt": PROMPT, "max_tokens": 6,
                                            "_headers": {"traceparent": TRACEPARENT}})
        assert status == 200
        assert headers["x-request-id"] == TRACE_ID and headers["traceparent"] == TRACEPARENT
    finally:
        assert gw.close(timeout=JOIN_S)
    tel.close()
    set_sink(None)
    with open(tel.trace_path) as f:
        trace = json.load(f)["traceEvents"]
    tracks = {e["id"] for e in trace if e.get("cat") == "request"
              and str(e.get("id", "")).startswith(TRACE_ID)}
    assert len(tracks) == 1, tracks
    track = tracks.pop()
    assert track.startswith(TRACE_ID + ":")
    phases = [e for e in trace if e.get("cat") == "request" and e.get("id") == track]
    begins = {e["name"]: e["ts"] for e in phases if e["ph"] == "b"}
    ends = {e["name"]: e["ts"] for e in phases if e["ph"] == "e"}
    for name in ("req/queued", "req/prefix_probe", "req/prefill_chunk", "req/prefill", "req/decode"):
        assert name in begins and ends[name] >= begins[name], sorted(begins)
    assert begins["req/queued"] <= begins["req/prefill"] <= begins["req/decode"]
    instants = {e["name"] for e in trace if e.get("ph") == "i" and e.get("id") == track}
    assert {"req/admitted", "req/complete"} <= instants, instants
    finishes = [e for e in trace if e.get("ph") == "f" and str(e.get("id", "")).startswith(TRACE_ID)]
    starts = {e["id"]: e for e in trace if e.get("ph") == "s"}
    iters = [e for e in trace if e.get("ph") == "X" and e["name"] == "sched/step"]
    assert finishes and iters
    for f in finishes:
        s = starts.get(f["id"])
        assert s is not None and s["ts"] <= f["ts"], f
        assert any(e["tid"] == s["tid"] and e["ts"] <= s["ts"] <= e["ts"] + e["dur"] for e in iters)
    with open(tel.jsonl_path) as f:
        events = [json.loads(line) for line in f]
    req = [ev for ev in events if str(ev.get("track", "")).startswith(TRACE_ID)]
    assert {ev["name"] for ev in req} >= {"req/queued", "req/prefill", "req/decode", "req/complete"}
    complete = next(ev for ev in req if ev["name"] == "req/complete")
    assert complete["attrs"]["tokens"] == 6 and complete["attrs"]["ttft_ms"] > 0


def test_prometheus_exposition_and_capacity_gauges(tmp_path):
    """Prometheus text under a scraper's Accept and ?format=prometheus
    (every line parses), JSON by default; the capacity gauges and the
    host-gap buckets are in it, the buckets summing to the histogram."""
    gw = start_gateway(telemetry=_tel(tmp_path))
    try:
        post(gw.port, {"prompt": PROMPTS[1], "max_tokens": 12})
        status, headers, body = get(gw.port, "/v1/metrics",
                                    {"Accept": "text/plain;version=0.0.4;q=0.9,*/*;q=0.1"})
        assert status == 200 and headers["Content-Type"].startswith("text/plain")
        text = body.decode()
        for line in text.strip().splitlines():
            assert _PROM_LINE.match(line), f"unparseable: {line!r}"
        assert "dstpu_gateway_requests_total 1" in text
        assert "dstpu_scheduler_num_slots 2" in text
        assert "dstpu_serving_mfu " in text and "dstpu_serving_host_gap_ms_count" in text
        status, headers, _ = get(gw.port, "/v1/metrics?format=prometheus")
        assert headers["Content-Type"].startswith("text/plain")
        _, headers, body = get(gw.port, "/v1/metrics")
        assert headers["Content-Type"] == "application/json"
        snap = json.loads(body)["telemetry"]
        # the snapshot rounds a histogram's sum to 6 decimals: hold the
        # buckets to the unrounded total the sink keeps
        tel = gw.telemetry
        with tel._lock:
            parts = sum(total for k, (_, total, _) in tel._counters.items()
                        if k.startswith("serving/host_gap/"))
            gap_sum = tel._hists["serving/host_gap_ms"].sum
        assert parts == pytest.approx(gap_sum, rel=1e-9)
        assert 0 < snap["gauges"]["serving/mfu"] and 0 < snap["gauges"]["serving/hbm_bw_util"]
        assert snap["histograms"]["serving/sync_launch_ms"]["count"] > 0
    finally:
        assert close(gw)


def test_slo_endpoint_debug_flight_and_profile(tmp_path):
    """/v1/slo serves the default serving slate; /v1/debug/flight writes a
    dump; /v1/debug/profile starts a torch.profiler capture and answers 409
    while it runs; the autoscaler answers 404 naming its ROADMAP item, and
    the networked store's fetch 404 outside multi-host worker mode (400 on a
    bad body once a shard is attached); the radix flush answers 200 once the
    trie is evicted."""
    gw = start_gateway(telemetry=_tel(tmp_path))
    try:
        status, _, body = get(gw.port, "/v1/slo")
        slo = json.loads(body)
        assert status == 200 and slo["enabled"]
        assert {"ttft_p95", "queue_wait_p95", "itl_p95", "error_rate"} <= {
            o["name"] for o in slo["objectives"]}
        status, _, body = get(gw.port, "/v1/debug/flight")
        assert status == 200
        dump_path = json.loads(body)["path"]
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=60)
        try:
            conn.request("POST", "/v1/debug/profile", json.dumps({"duration_ms": 60000}))
            resp = conn.getresponse()
            assert resp.status == 200
            trace_dir = json.loads(resp.read())["path"]
        finally:
            conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=60)
        try:
            conn.request("POST", "/v1/debug/profile", json.dumps({"duration_ms": 100}))
            assert conn.getresponse().status == 409
        finally:
            conn.close()
        status, _, body = get(gw.port, "/v1/autoscaler")
        assert status == 404 and "Queue 1 #9.5" in json.loads(body)["error"]["message"]
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=60)
        try:
            conn.request("POST", "/v1/store/fetch", json.dumps({"key": [1, 2]}))
            resp = conn.getresponse()
            assert resp.status == 404 and "worker mode" in json.loads(resp.read())["error"]["message"]
        finally:
            conn.close()
        # the radix flush is served: it evicts the trie on the pump thread
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=60)
        try:
            conn.request("POST", "/v1/debug/flush_radix", b"{}")
            resp = conn.getresponse()
            assert resp.status == 200 and json.loads(resp.read()) == {"flushed": True}
        finally:
            conn.close()
        assert not gw.replicas.replicas[0].scheduler.radix.registered_slots()
    finally:
        assert close(gw)  # close() stops the capture and waits for its export
    assert os.path.exists(dump_path)
    assert os.path.exists(os.path.join(trace_dir, "capture.trace.json"))


def test_replicas_autoscaler_and_router_refused():
    """The autoscaler section, elastic growth and scale-down and brownout
    parking raise naming ROADMAP Queue 1 #9.5; the multi-host section is
    taken (the worker mode reads it) and a migration resume without the KV
    tier is refused with ValueError; the single replica drains and resumes
    through /v1/replicas, and its role endpoint answers 400 without the
    migration transport (the host prefix store)."""
    with pytest.raises(NotImplementedError, match="Queue 1 #9.5"):
        make_engine(continuous_batching={"enabled": True, "autoscaler": {"enabled": True}})
    mh = make_engine(continuous_batching={"enabled": True, "multihost": {"router_url": "http://x",
                                                                          "worker_role": "decode"}})
    assert mh._config.continuous_batching.multihost.worker_role == "decode"
    eng = make_engine()
    reps = ReplicaSet.build(eng)
    for call in (reps.add_replica, lambda: reps.begin_scale_down(0),
                 lambda: reps.park_out(reps.replicas[0], None)):
        with pytest.raises(NotImplementedError, match="Queue 1 #9.5"):
            call()
    with pytest.raises(ValueError, match="hierarchical KV tier"):
        reps.inject_resume({})
    gw = Gateway(eng, port=0)
    gw.start_background()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=60)
        try:
            conn.request("POST", "/v1/replicas/0/drain")
            resp = conn.getresponse()
            assert resp.status == 200 and json.loads(resp.read())["replica"]["status"] == "draining"
        finally:
            conn.close()
        assert not gw.replicas.any_capacity()
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=60)
        try:
            conn.request("POST", "/v1/replicas/0/role", json.dumps({"role": "decode"}))
            resp = conn.getresponse()
            assert resp.status == 400 and "prefix store" in resp.read().decode()
        finally:
            conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", gw.port, timeout=60)
        try:
            conn.request("POST", "/v1/replicas/0/resume")
            assert conn.getresponse().status == 200
        finally:
            conn.close()
        status, _, raw = post(gw.port, {"prompt": PROMPT, "max_tokens": 3})
        assert status == 200 and len(json.loads(raw)["choices"][0]["token_ids"]) == 3
    finally:
        assert close(gw)


def test_concurrent_clients_lose_no_update(tmp_path):
    """24 concurrent clients (more threads than cores) with the interpreter
    switching threads every microsecond: every request completes in full
    and the gateway's stats, the sink's counters and the replica's
    dispatch count agree with what was sent (a lost update would break
    one of them)."""
    import sys
    n, budget = 24, 4
    gw = start_gateway(num_slots=4, telemetry={"enabled": True, "output_path": str(tmp_path)})
    results = []
    lock = threading.Lock()

    def client(i):
        def fn():
            r = post(gw.port, {"prompt": [3 + i % 7, 4, 5], "max_tokens": budget,
                               "_headers": {"x-tenant-id": f"t{i % 3}"}})
            with lock:
                results.append(r)
        return fn
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        join_all(run_threads([client(i) for i in range(n)]))
    finally:
        sys.setswitchinterval(old)
    try:
        assert sorted(s for s, _, _ in results) == [200] * n
        assert all(len(json.loads(b)["choices"][0]["token_ids"]) == budget for _, _, b in results)
        tel = gw.telemetry
        assert gw.stats["requests"] == gw.stats["completed"] == n
        assert gw.stats["tokens"] == tel.counter_total("gateway/tokens") == n * budget
        assert tel.counter_total("gateway/requests") == tel.counter_total("gateway/completed") == n
        assert sum(tel.counter_total(f"gateway/tenant/t{k}/tokens") for k in range(3)) == n * budget
        assert gw.replicas.replicas[0].dispatched == n and not gw._active
    finally:
        assert close(gw)
