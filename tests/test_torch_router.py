"""The port's multi-host router (``deepspeed_tpu_torch/serving/router.py``)
against the JAX package's (``deepspeed_tpu/serving/router.py``), in one
process, with no model: the counterparts of
``tests/unit/serving/test_multihost.py``'s router units.

Both routers are fed the same register and heartbeat bodies (through their
own HTTP handlers) and the same sequence of ``_place`` calls, and must
choose the same workers: least-loaded, sticky, sick or stale exclusion,
phase roles with the degraded fallback, adapter residency and the tie
break. The tie break uses ``hash(wid)``, which Python salts per process, so
the two routers are compared inside one process only and no test depends
on which worker wins a tie. The same holds for the fleet Retry-After,
``merged_signals`` with the opposite phase zeroed, the unary stitch and
the Prometheus text with its 256-label cap. Then the port's router on its
own over localhost HTTP: the worker protocol, the store directory routes,
a fleet with no live worker shedding 503, and a ``--router`` process that
initialises no CUDA. Every socket and wait has its own timeout."""

import asyncio
import http.client
import json
import os
import subprocess
import sys
import time

import pytest

from deepspeed_tpu.serving import capacity_math as jax_capacity
from deepspeed_tpu.serving import router as jax_router
from deepspeed_tpu.telemetry import prometheus as jax_prom
from deepspeed_tpu_torch.serving import capacity_math
from deepspeed_tpu_torch.serving import router as port_router
from deepspeed_tpu_torch.telemetry import prometheus as port_prom

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = list(range(5, 70))
SIDES = {"jax": (jax_router, jax_capacity, jax_prom), "port": (port_router, capacity_math, port_prom)}


def _sig(**kw):
    base = {"queued": 0, "inflight": 0, "sched_backlog": 0, "prefill_backlog": 0, "total_slots": 4,
            "prefill_slots": 4, "decode_slots": 4, "ema_service_s": None, "disaggregated": False}
    base.update(kw)
    return base


class _Writer:
    """An asyncio stream writer that keeps what is written."""

    def __init__(self):
        self.data = b""

    def write(self, b):
        self.data += b

    async def drain(self):
        pass

    def json(self):
        return json.loads(self.data.split(b"\r\n\r\n", 1)[1])


def _call(router, handler, body):
    w = _Writer()
    asyncio.run(getattr(router, handler)(json.dumps(body).encode(), w))
    return w.json()


def _register(router, wid, role="mixed", adapters=(), **sig):
    """Register ``wid`` and send one heartbeat, through the router's own
    handlers, with the bodies a WorkerAgent sends."""
    url = f"http://127.0.0.1:{9000 + len(router.workers)}"
    assert _call(router, "_worker_register", {"wid": wid, "url": url, "role": role, "prefill_chunk": 64,
                                              "weights_version": 0, "signals": _sig(**sig)})["ok"]
    body = {"wid": wid, "url": url, "role": role, "signals": dict(_sig(**sig), role=role),
            "weights_version": 0, "store": None, "adapters": list(adapters), "draining": False,
            "stats": {"active_requests": 0, "completed": 0, "handoffs_out": 0, "resumed_in": 0}}
    assert _call(router, "_worker_heartbeat", body) == {"ok": True}


def _least_loaded_then_sticky(mod, r):
    _register(r, "idle", ema_service_s=1.0)
    _register(r, "busy", queued=6, inflight=4, ema_service_s=1.0)
    out = [r._place(PROMPT).wid]
    r.workers["busy"].signals = _sig(ema_service_s=0.01)  # now the lighter one
    out += [r._place(PROMPT).wid, r._place(list(range(500, 600))).wid]
    assert out[:2] == ["idle", "idle"] and out[2] == "busy"  # sticky beats load
    return out


def _sick_and_stale(mod, r):
    r.heartbeat_timeout_s = 0.05
    _register(r, "w0")
    _register(r, "w1")
    r._mark_sick(r.workers["w0"], "test")
    out = [r._place(PROMPT).wid]
    r.workers["w1"].last_seen -= 1.0  # its heartbeat is stale
    out.append(r._place(PROMPT))
    assert out == ["w1", None] and r.counters["worker_sick"] == 1
    return out


def _phase_roles_degraded(mod, r):
    _register(r, "pre", role="prefill")
    _register(r, "dec", role="decode")
    out = [r._place(PROMPT, phase="prefill").wid, r._place(PROMPT, phase="decode").wid]
    r.workers["dec"].sick = True
    out.append(r._place(PROMPT, phase="decode").wid)  # no decode side: any live worker
    assert out == ["pre", "dec", "pre"]
    return out


def _adapter_residency(mod, r):
    _register(r, "a", ema_service_s=1.0)
    _register(r, "b", queued=8, ema_service_s=1.0, adapters=["tenant-x"])
    out = [r._place(PROMPT, adapter="tenant-x").wid, r._place([9] * 70, adapter=None).wid]
    assert out == ["b", "a"]
    return out


def _exclusions_and_ties(mod, r):
    for wid in ("t0", "t1", "t2"):
        _register(r, wid, ema_service_s=0.5)
    out = [r._place([i] * 70).wid for i in range(6)]
    out += [r._place([99] * 70, exclude={"t0", "t1"}).wid]
    assert out[-1] == "t2"
    return out


SCENARIOS = {"least_loaded_then_sticky": _least_loaded_then_sticky, "sick_and_stale": _sick_and_stale,
             "phase_roles_degraded": _phase_roles_degraded, "adapter_residency": _adapter_residency,
             "exclusions_and_ties": _exclusions_and_ties}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_placement_matches_jax(name):
    got = {side: SCENARIOS[name](mods[0], mods[0].Router()) for side, mods in SIDES.items()}
    assert got["port"] == got["jax"]


def test_fleet_retry_after_matches_jax():
    """A draining worker's backlog does not count against capacity it no
    longer advertises; the merged fleet estimate is JAX's."""
    got = {}
    for side, (mod, cm, _) in SIDES.items():
        r = mod.Router()
        _register(r, "live", queued=1, ema_service_s=1.0)
        _register(r, "drain", queued=500, ema_service_s=9.0)
        _register(r, "busy", role="decode", inflight=7, ema_service_s=2.0)
        r.workers["drain"].draining = True
        ra = r._fleet_retry_after()
        both = cm.estimate_retry_after(cm.merge_signals([w.signals for w in r.workers.values()]), 600)
        assert 1 <= ra <= both
        empty = mod.Router()._fleet_retry_after()
        got[side] = (ra, both, empty)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("role", ["prefill", "decode", "mixed"])
def test_merged_signals_match_jax(role):
    got = {}
    for side, (mod, cm, _) in SIDES.items():
        w = mod._Worker(role, "http://127.0.0.1:9", role, 64, 0, _sig(queued=3, ema_service_s=1.5))
        other = mod._Worker("m", "http://127.0.0.1:8", "mixed", 64, 0, _sig())
        merged = cm.merge_signals([w.merged_signals(), other.merged_signals()])
        got[side] = (w.merged_signals(), merged, w.expected_drain_score(1.0), w.prefill_capable(),
                     w.decode_capable())
    assert got["port"] == got["jax"]
    sig = got["port"][0]
    assert sig["decode_slots" if role == "prefill" else "prefill_slots"] == (0 if role != "mixed" else 4)
    assert got["port"][1]["disaggregated"] == (role != "mixed")


def test_unary_stitch_matches_jax():
    first = {"choices": [{"token_ids": [1, 2], "finish_reason": "handoff"}], "logits": [[0.5], [0.25]],
             "handoff": {"key": [1]}, "usage": {"prompt_tokens": 4}}
    second = {"id": "cmpl-9", "choices": [{"token_ids": [3], "finish_reason": "length", "index": 0}],
              "logits": [[0.125]], "usage": {"prompt_tokens": 4, "completion_tokens": 1}}
    port = port_router.Router._stitch_unary(first, second)
    assert port == jax_router.Router._stitch_unary(first, second)
    assert port["choices"][0]["token_ids"] == [1, 2, 3] and "handoff" not in port
    assert port["usage"] == {"prompt_tokens": 4, "completion_tokens": 3, "total_tokens": 7}


def _prom_text(mod, prom, n):
    r = mod.Router()
    r._t0 = time.monotonic()
    for i in range(n):
        r.workers[f"w{i}"] = mod._Worker(f"w{i}", f"http://127.0.0.1:{9000 + i}", "mixed", 64, 0,
                                         _sig(inflight=i % 3, ema_service_s=0.5 if i % 2 else None))
        r.workers[f"w{i}"].routed = i
    r.counters["requests"] += 2
    text = prom.render(r._prom_snapshot(), extra_gauges=r._prom_extra())
    return r, [ln for ln in text.splitlines() if "uptime" not in ln]


@pytest.mark.parametrize("n", [1, 300])
def test_prometheus_text_matches_jax(n):
    """The router's Prometheus text is JAX's line for line (uptime aside),
    with the per-worker families folded into ``worker`` labels and capped
    at 256 labels (the rest under ``__other__``)."""
    (jr, jax_lines), (pr, port_lines) = (_prom_text(m, p, n) for m, _, p in SIDES.values())
    assert port_lines == jax_lines
    text = "\n".join(port_lines)
    assert "dstpu_serving_router_requests_total 2" in text
    assert 'dstpu_serving_worker_up{worker="w0"} 1' in text
    labeled = {k.split("/")[2] for k in pr._prom_extra() if k.startswith("serving/worker/")}
    assert len(labeled) == min(n, 256) + (n > 256)
    assert ("__other__" in labeled) == (n > 256)


# ------------------------------------------------------------------ over HTTP


def _http(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, json.dumps(body) if body is not None else None, headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


@pytest.fixture
def router():
    r = port_router.Router(heartbeat_timeout_s=5.0, reap_interval_s=0.05).start_background()
    try:
        yield r
    finally:
        r.close()


def test_worker_protocol_over_http(router):
    """Register, heartbeat (an unknown wid is told to register again),
    ``/v1/workers`` with the forward widths, deregister; ``/readyz`` and a
    completion with no live worker answer 503 with a Retry-After."""
    port = router.port
    assert _http(port, "GET", "/healthz")[0] == 200
    status, headers, _ = _http(port, "GET", "/readyz")
    assert status == 503 and int(headers["Retry-After"]) >= 1
    status, headers, body = _http(port, "POST", "/v1/completions", {"prompt": [1, 2, 3]})
    assert status == 503 and json.loads(body)["error"]["type"] == "unavailable"
    assert router.counters["shed_503"] == 1
    assert json.loads(_http(port, "POST", "/v1/workers/heartbeat", {"wid": "w0"})[2]) == {"unknown": True}
    assert _http(port, "POST", "/v1/workers/register", {"wid": "w0"})[0] == 400
    status, _, body = _http(port, "POST", "/v1/workers/register",
                            {"wid": "w0", "url": "http://127.0.0.1:1", "role": "decode", "signals": _sig()})
    assert status == 200 and json.loads(body)["heartbeat_timeout_s"] == 5.0
    widths = {"forwards": {"1": 3, "16": 2}, "ext_forwards": {}}
    assert json.loads(_http(port, "POST", "/v1/workers/heartbeat",
                            {"wid": "w0", "signals": _sig(queued=2), "forward_widths": widths})[2]) == {"ok": True}
    assert _http(port, "GET", "/readyz")[0] == 200
    (w, ) = json.loads(_http(port, "GET", "/v1/workers")[2])["workers"]
    assert w["wid"] == "w0" and w["role"] == "decode" and w["status"] == "active"
    assert w["forward_widths"] == widths and w["signals"]["queued"] == 2
    assert _http(port, "POST", "/v1/workers/deregister", {"wid": "w0"})[0] == 200
    assert json.loads(_http(port, "GET", "/v1/workers")[2]) == {"workers": []}
    assert _http(port, "GET", "/nope")[0] == 404


def test_store_directory_routes(router):
    """``/v1/store/{register,probe,unregister,drop}`` over the directory:
    longest same-version prefix, the requester's own entries excluded, a
    lease expiring in the router's reaper, metrics as JSON and text."""
    port = router.port
    reg = {"wid": "w1", "url": "http://127.0.0.1:2", "key": [1, 2, 3], "length": 3, "version": 0,
           "nbytes": 96, "pinned": False}
    assert _http(port, "POST", "/v1/store/register", reg)[0] == 200
    assert _http(port, "POST", "/v1/store/register", {"wid": "w1"})[0] == 400
    hit = json.loads(_http(port, "POST", "/v1/store/probe", {"key": [1, 2, 3, 4], "version": 0, "wid": "w0"})[2])
    assert hit["found"] and hit["entry"]["match_len"] == 3 and hit["entry"]["key"] == [1, 2, 3]
    assert "expires_at" not in hit["entry"]
    for miss in ({"key": [1, 2, 3, 4], "version": 1, "wid": "w0"}, {"key": [1, 2, 3], "version": 0, "wid": "w1"}):
        assert json.loads(_http(port, "POST", "/v1/store/probe", miss)[2]) == {"found": False}
    assert json.loads(_http(port, "POST", "/v1/store/unregister", {"key": [1, 2, 3]})[2]) == {"ok": True}
    assert _http(port, "POST", "/v1/store/register", dict(reg, key=[-(1 << 30), 7, 1], pinned=True,
                                                         lease_s=0.01))[0] == 200
    deadline = time.monotonic() + 30
    while router.directory.stats()["entries"]:
        assert time.monotonic() < deadline, "the lease was never reaped"
        time.sleep(0.02)
    assert router.directory.leases_expired == 1
    assert _http(port, "POST", "/v1/store/register", reg)[0] == 200
    assert json.loads(_http(port, "POST", "/v1/store/drop", {"wid": "w1"})[2]) == {"dropped": 1}
    metrics = json.loads(_http(port, "GET", "/v1/metrics")[2])
    assert metrics["directory"]["leases_expired"] == 1 and metrics["router"]["workers"] == 0
    status, headers, body = _http(port, "GET", "/v1/metrics", headers={"Accept": "text/plain"})
    assert status == 200 and headers["Content-Type"].startswith("text/plain")
    assert b"dstpu_router_store_leases_expired 1" in body


def test_router_process_initialises_no_cuda():
    """The router is host code: importing it and serving a request builds
    no model and initialises no CUDA context."""
    code = ("import torch, http.client\n"
            "from deepspeed_tpu_torch.serving.router import Router\n"
            "r = Router().start_background()\n"
            "c = http.client.HTTPConnection('127.0.0.1', r.port, timeout=60)\n"
            "c.request('GET', '/v1/workers'); assert c.getresponse().status == 200\n"
            "r.close()\n"
            "print(torch.cuda.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True, timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "False"
