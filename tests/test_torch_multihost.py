"""The port's multi-host serving (``serving/router.py`` and its hooks in the
gateway and the replica set) on the CPU: the counterparts of the JAX
package's ``tests/unit/serving/test_multihost.py`` fleet tests.

In process: a port :class:`Router` on a thread fronts worker
:class:`Gateway`\\ s, each with a :class:`WorkerAgent`, built with
``params_from_jax`` of one ``tiny`` tree at fp32 (as
``tests/test_torch_gateway.py`` does). Router A fronts two ``mixed``
workers, router B a ``prefill`` and a ``decode`` worker; a solo gateway is
the one-process run. The bars: greedy streams through either router equal
the JAX scheduler's greedy tokens on that tree (equal tokens, the
tolerance of ``test_torch_gateway.py``); greedy and sampled streams and
logits are bitwise the solo run's, cold and on a radix hit, unary and SSE;
a prefix flushed from one worker's radix restores on the other bitwise
over ``/v1/store/fetch``; a prefill worker hands off to the decode worker
in another gateway bitwise, ``handoff_resumes`` rising and no ``handoff``
event reaching the client. ``inject_resume`` refuses an adapter, a
complete descriptor and a fleet without the KV tier with ``ValueError``.

As subprocesses (``python -m deepspeed_tpu_torch.serving`` with ``--device
cpu --model tiny``): a router spawning two workers serves bitwise a solo
process, and a SIGKILLed worker sheds its stream (no ``[DONE]``) without
sinking the fleet. Every wait has its own deadline and every server and
child is closed in a ``finally``."""

import functools
import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu.models as jm
import deepspeed_tpu_torch
import deepspeed_tpu_torch.models as tm
from deepspeed_tpu.comm import comm
from deepspeed_tpu_torch.memory.net_store import _MIG_SENTINEL
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.serving import Gateway, ReplicaSet
from deepspeed_tpu_torch.serving.router import Router, WorkerAgent, refuse_ranks
from deepspeed_tpu_torch.telemetry import set_sink

from .torch_port_helpers import numpy_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 120
START_S = 180
_RNG = np.random.default_rng(26)
# longer than one prefill chunk (64): the chunked prefill and its handoff
# run. Each test takes prompts of its own (the routers' sticky index
# remembers where a prompt's first chunk went)
PROMPTS = [[int(t) for t in _RNG.integers(0, 256, n)] for n in (65, 90, 72, 100, 66, 80, 70, 95, 77, 85)]
GREEDY = {"max_tokens": 8}
SAMPLED = {"max_tokens": 8, "do_sample": True, "temperature": 1.3, "top_k": 40, "seed": 1234}
CFG = {"dtype": "float32", "max_out_tokens": 128,
       "continuous_batching": {"enabled": True, "num_slots": 2, "hierarchical_kv": {"enabled": True}}}


@functools.lru_cache(maxsize=None)
def _tree():
    return numpy_params(jm.get_model("tiny", max_seq_len=128), seed=10)


def make_engine(tier=True):
    set_sink(None)
    tmod = tm.get_model("tiny", max_seq_len=128)
    config = json.loads(json.dumps(CFG))
    config["continuous_batching"]["hierarchical_kv"]["enabled"] = tier
    return deepspeed_tpu_torch.init_inference(tmod, config=config, params=params_from_jax(_tree(), tmod.cfg),
                                              device="cpu")


def _request(port, method, path, body=None, timeout=JOIN_S):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def post(port, body):
    status, raw = _request(port, "POST", "/v1/completions", body)
    assert status == 200, raw[:400]
    doc = json.loads(raw)
    assert "handoff" not in doc
    return doc


def get_json(port, path):
    status, raw = _request(port, "GET", path)
    assert status == 200, raw[:400]
    return json.loads(raw)


def sse(port, body):
    """A streamed completion -> (tokens, saw [DONE]); no event may carry a
    handoff."""
    status, raw = _request(port, "POST", "/v1/completions", dict(body, stream=True))
    assert status == 200, raw[:400]
    toks, done = [], False
    for line in raw.decode().splitlines():
        if line == "data: [DONE]":
            done = True
        elif line.startswith("data: "):
            ev = json.loads(line[6:])
            assert "handoff" not in ev, "a handoff event reached the client"
            toks += ev["choices"][0]["token_ids"]
    return toks, done


def wait_for(cond, what, timeout=JOIN_S):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


class InProcessFleet:
    """Router A over two mixed workers, router B over a prefill and a decode
    worker, and a solo gateway: every gateway on its own engine over the
    shared tree."""

    def __init__(self):
        self.routers, self.gateways, self.agents = [], [], []
        self.solo = self._gateway()
        self.a = self._router([("w0", "mixed"), ("w1", "mixed")])
        self.b = self._router([("pre", "prefill"), ("dec", "decode")])

    def _gateway(self):
        gw = Gateway(make_engine(), port=0)
        self.gateways.append(gw)
        return gw.start_background()

    def _router(self, workers):
        router = Router(heartbeat_timeout_s=30.0).start_background()
        self.routers.append(router)
        url = f"http://127.0.0.1:{router.port}"
        for wid, role in workers:
            agent = WorkerAgent(self._gateway(), url, wid, role=role, heartbeat_s=0.1).attach()
            self.agents.append(agent.start())
        wait_for(lambda: sum(w.available(time.monotonic(), 30.0) for w in router.workers.values()) == 2,
                 "two live workers")
        return router

    def agent(self, wid):
        return next(a for a in self.agents if a.wid == wid)

    def close(self):
        for agent in self.agents:
            agent.stop()
        ok = [gw.close(timeout=JOIN_S) for gw in self.gateways]
        for router in self.routers:
            router.close()
        set_sink(None)
        assert all(ok)


@pytest.fixture(scope="module")
def fleet():
    f = InProcessFleet()
    try:
        yield f
    finally:
        f.close()


@pytest.fixture(scope="module")
def jax_greedy():
    """The JAX scheduler's greedy tokens for PROMPTS (8 new each) on the
    shared tree."""
    from deepspeed_tpu.telemetry import set_sink as set_jax_sink
    comm._state["mesh"] = None
    set_jax_sink(None)
    je = deepspeed_tpu.init_inference(
        jm.get_model("tiny", max_seq_len=128), params=_tree(),
        config={"dtype": "float32", "max_out_tokens": 128, "continuous_batching": {"enabled": True, "num_slots": 2}})
    js = je.scheduler()
    return [np.asarray(h.result()).tolist() for h in [js.submit(np.asarray(p, np.int32), max_new_tokens=8)
                                                      for p in PROMPTS[:4]]]


@pytest.mark.parametrize("via", ["mixed", "prefill_decode"])
def test_greedy_streams_match_jax_scheduler(fleet, jax_greedy, via):
    router = fleet.a if via == "mixed" else fleet.b
    for prompt, ref in zip(PROMPTS, jax_greedy):
        toks, done = sse(router.port, dict(GREEDY, prompt=prompt))
        assert toks == ref and done


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_streams_and_logits_bitwise_one_process(fleet, sampling):
    """Two mixed workers behind router A serve each prompt cold and then on
    a radix hit (the sticky prefix brings it back to its worker) bitwise
    the solo gateway: unary tokens and logits, and the SSE stream."""
    kw = GREEDY if sampling == "greedy" else SAMPLED
    hits0 = sum(rep.scheduler.radix.hits for a in fleet.agents[:2] for rep in a.gateway.replicas)
    for prompt in PROMPTS[4:6] if sampling == "greedy" else PROMPTS[6:8]:
        body = dict(kw, prompt=prompt, return_logits=True)
        for visit in ("cold", "hit"):
            solo, via = post(fleet.solo.port, body), post(fleet.a.port, body)
            assert via["choices"][0]["token_ids"] == solo["choices"][0]["token_ids"], (prompt, visit)
            assert via["logits"] == solo["logits"], (prompt, visit)
        toks, done = sse(fleet.a.port, dict(kw, prompt=prompt))
        assert toks == solo["choices"][0]["token_ids"] and done
    hits = sum(rep.scheduler.radix.hits for a in fleet.agents[:2] for rep in a.gateway.replicas)
    assert hits - hits0 >= 4  # each prompt's second and third visit
    if sampling == "sampled":
        greedy = post(fleet.solo.port, dict(GREEDY, prompt=PROMPTS[0]))["choices"][0]["token_ids"]
        assert post(fleet.a.port, dict(kw, prompt=PROMPTS[0]))["choices"][0]["token_ids"] != greedy


def test_cross_host_prefix_restore_bitwise(fleet):
    """A prefix flushed from w0's radix into its shard (directory-visible)
    restores on the other worker over ``/v1/store/fetch``: the reply is
    bitwise w0's, and the restoring shard's remote counters rise."""
    w0, w1 = fleet.agents[0], fleet.agents[1]
    body = dict(GREEDY, prompt=PROMPTS[8], max_tokens=6, return_logits=True)
    first = post(w0.gateway.port, body)
    status, raw = _request(w0.gateway.port, "POST", "/v1/debug/flush_radix", {})
    assert status == 200 and json.loads(raw) == {"flushed": True}
    before = get_json(w1.gateway.port, "/v1/metrics")["net_store"]
    again = post(w1.gateway.port, body)
    assert again["choices"][0]["token_ids"] == first["choices"][0]["token_ids"]
    assert again["logits"] == first["logits"]
    after = get_json(w1.gateway.port, "/v1/metrics")["net_store"]
    assert after["remote_restores"] > before["remote_restores"]
    assert after["net_bytes_in"] > before["net_bytes_in"]
    assert get_json(w0.gateway.port, "/v1/metrics")["net_store"]["net_bytes_out"] >= after["net_bytes_in"]


@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
def test_handoff_across_gateways_bitwise(fleet, sampling):
    """Router B: each request prefills on the prefill worker, parks its KV
    in that worker's shard and resumes on the decode worker (another
    gateway and engine): unary tokens and logits and the SSE stream are
    bitwise the solo run's, ``handoff_resumes`` rises, and neither reply
    shows the handoff."""
    kw = GREEDY if sampling == "greedy" else SAMPLED
    pre, dec = fleet.agent("pre").gateway, fleet.agent("dec").gateway
    resumes0, out0, in0 = fleet.b.counters["handoff_resumes"], pre.stats["handoffs_out"], dec.stats["resumed_in"]
    for prompt in PROMPTS[4:6] if sampling == "greedy" else PROMPTS[6:8]:
        body = dict(kw, prompt=prompt, return_logits=True)
        solo, via = post(fleet.solo.port, body), post(fleet.b.port, body)
        assert via["choices"][0]["token_ids"] == solo["choices"][0]["token_ids"]
        assert via["logits"] == solo["logits"]
        assert via["usage"]["completion_tokens"] == len(solo["choices"][0]["token_ids"])
        toks, done = sse(fleet.b.port, dict(kw, prompt=prompt))
        assert toks == solo["choices"][0]["token_ids"] and done
    assert fleet.b.counters["handoff_resumes"] - resumes0 == 4
    assert pre.stats["handoffs_out"] - out0 == 4 and dec.stats["resumed_in"] - in0 == 4
    assert sum(rep.scheduler.migrations_in for rep in dec.replicas) >= 4
    assert fleet.agent("dec").gateway.net_store.stats()["remote_restores"] >= 4


def test_resume_from_a_dead_owner_fails_cleanly(fleet):
    """A resume whose owner is gone answers 500 naming the vanished entry
    (the fetch degrades to a miss), and frees the slot it took."""
    dec = fleet.agent("dec").gateway
    desc = {"key": [_MIG_SENTINEL, 5, 1], "kv_len": 66, "version": 0, "owner_url": "http://127.0.0.1:1",
            "owner_wid": "gone", "prompt": PROMPTS[0], "done_tokens": [3], "max_new_tokens": 8}
    status, raw = _request(dec.port, "POST", "/v1/completions", {"resume": desc})
    assert status == 500 and b"handoff entry dropped" in raw
    status, raw = _request(dec.port, "POST", "/v1/completions", {"resume": dict(desc, kv_len=None) | {"x": 1}})
    assert status in (400, 500)
    wait_for(lambda: all(rep.scheduler.cache.active_slots == 0 for rep in dec.replicas), "the slot to free")
    for missing in ("key", "owner_url"):
        bad = {k: v for k, v in desc.items() if k != missing}
        status, raw = _request(dec.port, "POST", "/v1/completions", {"resume": bad})
        assert status == 400 and missing.encode() in raw


@pytest.mark.parametrize("case", ["adapter", "complete", "no_tier"])
def test_inject_resume_refusals(case):
    """A descriptor this fleet cannot honour raises ValueError: an adapter's
    pages do not travel, a descriptor with its whole budget decoded has
    nothing to resume, and without the KV tier there is no transport."""
    rs = ReplicaSet.build(make_engine(tier=case != "no_tier"))
    desc = {"key": [_MIG_SENTINEL, 1, 1], "kv_len": 66, "version": 0, "owner_url": "http://127.0.0.1:1",
            "prompt": PROMPTS[0], "done_tokens": [1], "max_new_tokens": 8}
    if case == "adapter":
        desc["adapter_id"] = "tenant-a"
    elif case == "complete":
        desc["done_tokens"] = list(range(8))
    match = {"adapter": "adapter", "complete": "already complete", "no_tier": "hierarchical KV tier"}[case]
    with pytest.raises(ValueError, match=match):
        rs.inject_resume(desc)
    assert rs.pending_migrations() == 0


def test_worker_agent_wiring_and_reregistration():
    """The agent swaps one NetPrefixStore shard into every scheduler's tier
    and the gateway; a prefill role needs the tier; a bad role and a worker
    across ranks are refused; a router that forgot the worker (a restart)
    gets it registered again on its next heartbeat."""
    with pytest.raises(NotImplementedError, match=r"#9\.2, its leftover"):
        refuse_ranks(2)
    router = Router().start_background()
    gws = [Gateway(make_engine(tier=False), port=0).start_background(),
           Gateway(make_engine(), port=0).start_background()]
    agent = None
    try:
        url = f"http://127.0.0.1:{router.port}"
        with pytest.raises(ValueError, match="prefix store"):
            WorkerAgent(gws[0], url, "p", role="prefill").attach()
        with pytest.raises(ValueError, match="prefill|decode|mixed"):
            WorkerAgent(gws[1], url, "x", role="both")
        agent = WorkerAgent(gws[1], url, "w9", role="prefill", heartbeat_s=0.05).attach()
        assert gws[1].net_store is agent.net_store
        assert all(rep.scheduler.kv_tier.store is agent.net_store for rep in gws[1].replicas)
        assert all(rep.scheduler.migrate_hook == agent._maybe_migrate_remote for rep in gws[1].replicas)
        agent.start()
        wait_for(lambda: "w9" in router.workers and router.workers["w9"].stats, "a heartbeat")
        assert router.workers["w9"].role == "prefill" and router.workers["w9"].forward_widths == {
            "forwards": {}, "ext_forwards": {}}
        with router._lock:
            router.workers.clear()  # the router restarted
        wait_for(lambda: "w9" in router.workers, "the worker to register again")
    finally:
        if agent is not None:
            agent.stop()
            if agent._thread is not None:
                agent._thread.join(JOIN_S)
        for gw in gws:
            assert gw.close(timeout=JOIN_S)
        router.close()
        set_sink(None)
    assert "w9" not in router.workers  # stop() deregistered it


# ------------------------------------------------------------------ the CLI


def _spawn(args, env=None):
    proc = subprocess.Popen([sys.executable, "-m", "deepspeed_tpu_torch.serving", *args], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
                            env=dict(os.environ, **(env or {})))
    lines = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)
    threading.Thread(target=pump, daemon=True).start()
    return proc, lines


def _ready(lines, token):
    deadline = time.monotonic() + START_S
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            break
        if line is None:
            break
        if line.startswith("{") and f'"{token}"' in line:
            return json.loads(line)
    raise AssertionError(f"no {token} line within {START_S} s")


def _terminate(procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=60)
        if p.stdout is not None:
            p.stdout.close()


def _live_workers(rport, n):
    deadline = time.monotonic() + START_S
    while True:
        workers = [w for w in get_json(rport, "/v1/workers")["workers"] if w["status"] == "active"]
        if len(workers) >= n:
            return {w["wid"]: int(w["url"].rsplit(":", 1)[1]) for w in workers}
        assert time.monotonic() < deadline, f"fewer than {n} live workers"
        time.sleep(0.2)


@pytest.fixture
def cli_config(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"dtype": "float32", "max_out_tokens": 160,
                                "continuous_batching": {"num_slots": 2}}))
    return str(path)


def test_cli_router_and_spawned_workers_serve_bitwise_a_solo_process(cli_config):
    """``--router --spawn-workers 2`` starts two CPU workers behind it; its
    unary replies (tokens and logits, greedy and sampled) and SSE streams
    are bitwise a solo process's, the workers' forward widths are within
    the solo's, and SIGTERM stops the router and its workers (exit 0)."""
    common = ["--model", "tiny", "--device", "cpu", "--config", cli_config]
    procs = []
    try:
        router, rlines = _spawn(["--router", "--port", "0", "--heartbeat-timeout-s", "30", "--spawn-workers", "2",
                                 "--hierarchical-kv", *common])
        procs.append(router)
        solo, slines = _spawn(["--port", "0", "--hierarchical-kv", *common])
        procs.append(solo)
        rport, sport = _ready(rlines, "ROUTER_READY")["port"], _ready(slines, "GATEWAY_READY")["port"]
        workers = _live_workers(rport, 2)
        assert sorted(workers) == ["w0", "w1"]
        for kw in (GREEDY, SAMPLED):
            body = dict(kw, prompt=PROMPTS[0], return_logits=True)
            for _ in ("cold", "hit"):
                s, r = post(sport, body), post(rport, body)
                assert r["choices"][0]["token_ids"] == s["choices"][0]["token_ids"]
                assert r["logits"] == s["logits"]
            toks, done = sse(rport, dict(kw, prompt=PROMPTS[0]))
            assert toks == s["choices"][0]["token_ids"] and done
        solo_widths = get_json(sport, "/v1/metrics")["scheduler"]["forward_widths"]
        for port in workers.values():
            widths = get_json(port, "/v1/metrics")["scheduler"]["forward_widths"]
            for kind in ("forwards", "ext_forwards"):
                assert set(widths[kind]) <= set(solo_widths[kind]), (kind, widths, solo_widths)
        router.send_signal(signal.SIGTERM)
        assert router.wait(timeout=JOIN_S) == 0
    finally:
        _terminate(procs)


def test_cli_killed_worker_sheds_and_the_fleet_serves_on(cli_config):
    """SIGKILL the worker holding a stream after its first event: the
    stream ends without ``[DONE]`` (no silent re-run), the router marks the
    worker sick, and the survivor serves a new request."""
    common = ["--model", "tiny", "--device", "cpu", "--config", cli_config]
    procs = []
    try:
        router, rlines = _spawn(["--router", "--port", "0", "--heartbeat-timeout-s", "30"])
        procs.append(router)
        rport = _ready(rlines, "ROUTER_READY")["port"]
        workers = {}
        for wid in ("w0", "w1"):
            proc, lines = _spawn(["--worker", "--router-url", f"http://127.0.0.1:{rport}", "--worker-id", wid,
                                  "--port", "0", "--heartbeat-s", "0.2", *common])
            procs.append(proc)
            workers[wid] = (proc, lines)
        for wid, (_, lines) in workers.items():
            ready = _ready(lines, "GATEWAY_READY")
            assert ready["worker_id"] == wid and ready["role"] == "mixed"
        _live_workers(rport, 2)
        prompt = PROMPTS[0][:12]
        post(rport, {"prompt": prompt, "max_tokens": 1})  # the sticky index now names the victim
        (victim, ) = [w["wid"] for w in get_json(rport, "/v1/workers")["workers"] if w["routed"]]
        survivor = "w1" if victim == "w0" else "w0"
        conn = http.client.HTTPConnection("127.0.0.1", rport, timeout=JOIN_S)
        try:
            conn.request("POST", "/v1/completions", json.dumps({"prompt": prompt, "max_tokens": 100, "stream": True}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 200
            first = resp.fp.readline()
            assert first.startswith(b"data:")
            workers[victim][0].send_signal(signal.SIGKILL)
            raw = first + resp.fp.read()
        finally:
            conn.close()
        assert b"data: [DONE]" not in raw
        deadline = time.monotonic() + 120
        while True:
            status, body = _request(rport, "POST", "/v1/completions", {"prompt": prompt, "max_tokens": 4})
            if status == 200:
                break
            assert time.monotonic() < deadline, (status, body[:300])
            time.sleep(0.5)
        assert len(json.loads(body)["choices"][0]["token_ids"]) == 4
        m = get_json(rport, "/v1/metrics")
        assert m["router"]["worker_sick"] >= 1
        states = {w["wid"]: w["status"] for w in m["workers"]}
        assert states[survivor] == "active" and states[victim] == "sick"
    finally:
        _terminate(procs)
