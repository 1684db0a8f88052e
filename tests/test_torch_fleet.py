"""The port's serving fleet (``deepspeed_tpu_torch/serving/replica.py``):
the counterparts of the JAX package's ``tests/unit/serving/test_replica.py``
on ``tiny`` at fp32 (the per-projection path) on one set of numpy weights.

Replicas are N schedulers over ONE engine: the same parameter tensors (one
``data_ptr`` each, for every replica), N slot pools. Placement never moves
a stream: a fleet's tokens are bitwise a one-replica run's, greedy and
sampled, and equal to the JAX ``ReplicaSet``'s greedy tokens on the same
weights (``test_torch_scheduler.py``'s bar: equal tokens). Dispatch is
least-loaded with a round-robin tie break and prefix-sticky (the sticky
replica's radix cache hits); a full fleet places nothing; drain, resume and
sick shedding act on placement only; the per-replica telemetry series reach
the sink and Prometheus text. Over HTTP a 2-replica gateway serves every
stream bitwise the direct submit, drains a replica through the admin
endpoint, and a replica whose every step raises goes sick and sheds its
requests while the other serves and the gateway drains.

Beyond the JAX tests: two pump threads stepping two replicas at once for
many steps, each stream bitwise its one-replica run; ``ops/build.py``'s
``load`` and ``bind`` from eight threads building and binding once (nvcc
and ctypes stubbed); and the extent-key repair: two replicas sharing one
host store, each with a chained request whose cold extents are demoted
mid-decode (the same per-scheduler rid on both), each bitwise its
one-replica run.
"""

import functools
import http.client
import json
import threading

import numpy as np

import deepspeed_tpu
import deepspeed_tpu.models as jm
import deepspeed_tpu_torch
import deepspeed_tpu_torch.models as tm
from deepspeed_tpu.comm import comm
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops import build
from deepspeed_tpu_torch.serving import Gateway, ReplicaSet
from deepspeed_tpu_torch.telemetry import prometheus as prom
from deepspeed_tpu_torch.telemetry import set_sink

from .test_torch_kv_tier import _demote_mid_decode, _long_port
from .test_torch_long_context import LPROMPT
from .torch_port_helpers import numpy_params

JOIN_S = 120
PROMPTS = [[5, 6, 7, 8, 9], [10, 11, 12], [1, 2, 3, 4], [9, 8, 7]]
SHARED = list(range(1, 65))  # one full prefill chunk


@functools.lru_cache(maxsize=None)
def _tree():
    return numpy_params(jm.get_model("tiny", max_seq_len=128), seed=10)


def make_engine(num_slots=2, replicas=1, telemetry=None, **cb):
    set_sink(None)
    tmod = tm.get_model("tiny", max_seq_len=128)
    config = {"dtype": "float32",
              "continuous_batching": {"enabled": True, "num_slots": num_slots, "replicas": replicas, **cb}}
    if telemetry is not None:
        config["telemetry"] = telemetry
    return deepspeed_tpu_torch.init_inference(tmod, config=config, params=params_from_jax(_tree(), tmod.cfg),
                                              device="cpu")


def _fleet_streams(rs, prompts, max_new=8):
    """Dispatch ``prompts`` (odd ones sampled), stepping the fleet while it
    is full; returns the streams."""
    handles = []
    for i, p in enumerate(prompts):
        while True:
            _, h = rs.dispatch(p, max_new_tokens=max_new, do_sample=(i % 2 == 1), temperature=0.8,
                               top_k=9, seed=1000 + i)
            if h is not None:
                break
            rs.pump_once()
        handles.append(h)
    rs.drain_all_work()
    return [h.result().tolist() for h in handles]


# --------------------------------------------------------------------- build
def test_build_shares_the_weight_tree():
    eng = make_engine()
    rs = ReplicaSet.build(eng, 3)
    assert len(rs) == 3
    scheds = [r.scheduler for r in rs]
    assert scheds[0] is eng.scheduler()  # replica 0 IS the engine's scheduler
    assert all(s.engine is eng for s in scheds)
    ptrs = [t.data_ptr() for t in eng.params.values()]
    assert ptrs and all([t.data_ptr() for t in s.engine.params.values()] == ptrs for s in scheds)
    # each replica its own pool: no pool tensor shared between two
    pools = [{leaf.data_ptr() for comp in s.cache.pool for leaf in comp} for s in scheds]
    assert all(not (pools[i] & pools[j]) for i in range(3) for j in range(i + 1, 3))
    assert len({id(s.cache) for s in scheds}) == 3
    for key in ("num_slots", "max_len", "prefill_chunk", "steps_per_sync"):
        assert len({getattr(s, key) for s in scheds}) == 1, key
    assert len({s.uid for s in scheds}) == 3


def test_replicas_add_no_weight_copies():
    """Serving the same shapes through replica 1 after replica 0 copies no
    parameter (the tensors stay the engine's) and gives the same bits."""
    eng = make_engine()
    rs = ReplicaSet.build(eng, 2)
    before = [t.data_ptr() for t in eng.params.values()]
    outs = []
    for rep in rs:
        h = rep.submit([5, 6, 7, 8, 9], max_new_tokens=8)
        while not h.done:
            rep.step()
        outs.append(h.result().tolist())
    assert outs[0] == outs[1]
    assert [t.data_ptr() for t in eng.params.values()] == before


def test_results_replica_placement_invariant():
    """The same requests through 1 and 2 replicas: identical streams,
    greedy and sampled."""
    ref = _fleet_streams(ReplicaSet.build(make_engine(), 1), PROMPTS)
    rs = ReplicaSet.build(make_engine(), 2)
    assert _fleet_streams(rs, PROMPTS) == ref
    assert all(r.dispatched for r in rs)


def test_fleet_greedy_streams_match_jax():
    """A 2-replica fleet's greedy streams equal the JAX ``ReplicaSet``'s on
    the same weights."""
    from deepspeed_tpu.serving import ReplicaSet as JaxReplicaSet
    from deepspeed_tpu.telemetry import set_sink as jax_set_sink
    comm._state["mesh"] = None
    jax_set_sink(None)
    je = deepspeed_tpu.init_inference(jm.get_model("tiny", max_seq_len=128), params=_tree(),
                                      config={"dtype": "float32",
                                              "continuous_batching": {"enabled": True, "num_slots": 2}})
    prompts = PROMPTS + [[int(t) for t in np.resize(np.arange(3, 40), 70)]]

    def greedy(rs):
        hs = []
        for p in prompts:
            while True:
                _, h = rs.dispatch(p, max_new_tokens=8, seed=3)
                if h is not None:
                    break
                rs.pump_once()
            hs.append(h)
        rs.drain_all_work()
        return [np.asarray(h.result()).tolist() for h in hs]

    jrs, trs = JaxReplicaSet.build(je, 2), ReplicaSet.build(make_engine(), 2)
    assert greedy(trs) == greedy(jrs)
    assert [r.dispatched for r in trs] == [r.dispatched for r in jrs]


# ------------------------------------------------------------------ dispatch
def test_dispatch_least_loaded_spreads():
    rs = ReplicaSet.build(make_engine(), 2)
    r_a, _ = rs.dispatch([1, 2, 3], max_new_tokens=8)
    r_b, _ = rs.dispatch([4, 5, 6], max_new_tokens=8)
    assert {r_a.idx, r_b.idx} == {0, 1}, "back-to-back dispatches piled up"
    rs.drain_all_work()


def test_dispatch_prefix_sticky_follows_cache():
    """Prompts sharing a leading chunk land on the replica that served the
    first one, and hit its radix cache there."""
    rs = ReplicaSet.build(make_engine(num_slots=3), 2)
    first, _ = rs.dispatch(SHARED + [70], max_new_tokens=4)
    rs.drain_all_work()
    rs.dispatch([200, 201, 202], max_new_tokens=4)  # least-loaded would now pick `first`'s sibling
    second, h2 = rs.dispatch(SHARED + [71], max_new_tokens=4)
    assert second.idx == first.idx, "prefix-matching prompt left its replica"
    rs.drain_all_work()
    h2.result()
    assert first.scheduler.radix.hits >= 1, "sticky routing never hit the trie"


def test_dispatch_none_when_fleet_full():
    rs = ReplicaSet.build(make_engine(num_slots=1), 2)
    assert rs.dispatch([1, 2, 3], max_new_tokens=8)[0] is not None
    assert rs.dispatch([4, 5, 6], max_new_tokens=8)[0] is not None
    assert rs.dispatch([7, 8, 9], max_new_tokens=8) == (None, None)
    rs.drain_all_work()


# ----------------------------------------------------------------- lifecycle
def test_drain_one_replica_sheds_placement_only():
    rs = ReplicaSet.build(make_engine(), 2)
    rep0, h0 = rs.dispatch([1, 2, 3], max_new_tokens=8)
    assert rep0.idx == 0
    rs.drain(0)
    placed = [rs.dispatch([10 + i, 11, 12], max_new_tokens=4)[0] for i in range(2)]
    assert all(r.idx == 1 for r in placed), "drained replica still placed"
    rs.drain_all_work()
    assert h0.result().shape == (8, )  # in-flight work finished
    assert rs.replicas[0].idle()
    rs.resume(0)
    assert rs.dispatch([20, 21], max_new_tokens=2)[0].idx == 0
    rs.drain_all_work()


def test_sick_replica_sheds_and_purges_sticky():
    rs = ReplicaSet.build(make_engine(num_slots=3), 2)
    first, _ = rs.dispatch(SHARED + [70], max_new_tokens=2)
    rs.drain_all_work()
    rs.mark_sick(first.idx, RuntimeError("boom"))
    rs.mark_sick(first.idx, RuntimeError("again"))  # idempotent
    assert not rs.replicas[first.idx].available()
    assert [r.idx for r in rs.healthy()] == [1 - first.idx]
    rep, _ = rs.dispatch(SHARED + [71], max_new_tokens=2)
    assert rep.idx != first.idx  # the sticky entry purged: the prefix re-homed
    rs.drain_all_work()
    state = rs.replicas[first.idx].state()
    assert state["status"] == "sick" and "boom" in state["error"]
    assert not rs.all_sick()
    rs.resume(first.idx)
    assert rs.replicas[first.idx].available()


# ----------------------------------------------------------------- telemetry
def test_per_replica_telemetry_series(tmp_path):
    eng = make_engine(replicas=2, telemetry={"enabled": True, "output_path": str(tmp_path)})
    rs = ReplicaSet.build(eng)
    assert len(rs) == 2  # continuous_batching.replicas
    for i in range(4):
        rs.dispatch([5, 6, 7, i], max_new_tokens=4)
    rs.drain_all_work()
    snap = eng.telemetry.snapshot()
    counters, gauges = snap["counters"], snap["gauges"]
    dispatched = {k: v["total"] for k, v in counters.items()
                  if k.startswith("serving/replica/") and k.endswith("/dispatched")}
    assert sum(dispatched.values()) == 4 and len(dispatched) == 2, dispatched
    assert counters["serving/dispatch/least_loaded"]["total"] == 4
    for idx in (0, 1):
        assert f"serving/replica/{idx}/slot_occupancy" in gauges
        assert f"serving/replica/{idx}/tok_s" in gauges
    text = prom.render(snap)
    assert 'dstpu_serving_replica_dispatched_total{replica="0"} 2' in text
    assert 'dstpu_serving_replica_tok_s{replica="1"}' in text
    eng.telemetry.close()
    set_sink(None)


# ------------------------------------------------------------------- gateway
def _post(port, path, body, timeout=JOIN_S):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=JOIN_S)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_gateway_fleet_end_to_end():
    """2 replicas over HTTP: every completion bitwise the direct submit,
    both replicas placed, /v1/replicas and /v1/metrics report the fleet,
    the drain endpoint sheds placement, bad admin requests answer 4xx, and
    the fleet drains."""
    eng = make_engine(replicas=2)
    ref = eng.scheduler().submit([5, 6, 7, 8], max_new_tokens=6).result().tolist()
    gw = Gateway(eng, port=0, request_timeout_s=60.0)
    gw.start_background()
    try:
        results = [None] * 4

        def client(i):
            results[i] = _post(gw.port, "/v1/completions", {"prompt": [5, 6, 7, 8], "max_tokens": 6})
        threads = [threading.Thread(target=client, args=(i, )) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        for status, out in results:
            assert status == 200 and out["choices"][0]["token_ids"] == ref
        states = _get(gw.port, "/v1/replicas")[1]["replicas"]
        assert len(states) == 2 and sum(s["dispatched"] for s in states) == 4
        m = _get(gw.port, "/v1/metrics")[1]
        assert len(m["replicas"]) == 2 and m["gateway"]["completed"] == 4
        assert _post(gw.port, "/v1/replicas/1/drain", {})[1]["replica"]["status"] == "draining"
        before = _get(gw.port, "/v1/replicas")[1]["replicas"][0]["dispatched"]
        for p in ([9, 9, 9], [8, 8, 8]):
            assert _post(gw.port, "/v1/completions", {"prompt": p, "max_tokens": 4})[0] == 200
        after = _get(gw.port, "/v1/replicas")[1]["replicas"]
        assert after[0]["dispatched"] == before + 2 and after[1]["status"] == "draining"
        assert _post(gw.port, "/v1/replicas/1/resume", {})[1]["replica"]["status"] == "active"
        for path, code in (("/v1/replicas/7/drain", 400), ("/v1/replicas/1/poke", 404)):
            assert _post(gw.port, path, {})[0] == code
    finally:
        assert gw.close(JOIN_S), "fleet failed to drain"


def test_gateway_sick_replica_sheds_not_sinks():
    """A replica whose every step raises goes sick: its requests fail, the
    other keeps completing, /v1/replicas reports it, the health-out counts
    once, and the gateway still drains."""
    eng = make_engine(replicas=2)
    gw = Gateway(eng, port=0, request_timeout_s=30.0)

    def boom():
        raise RuntimeError("injected backend failure")
    gw.replicas.replicas[1].scheduler.step = boom
    gw.start_background()
    try:
        codes = [_post(gw.port, "/v1/completions", {"prompt": [5, 6, 7, i], "max_tokens": 4})[0]
                 for i in range(6)]
        assert 200 in codes and 500 in codes, codes
        states = _get(gw.port, "/v1/replicas")[1]["replicas"]
        assert states[1]["status"] == "sick" and "step failed" in states[1]["error"]
        assert states[0]["status"] == "active"
        assert _post(gw.port, "/v1/completions", {"prompt": [1, 2], "max_tokens": 3})[0] == 200
    finally:
        assert gw.close(JOIN_S)


# ------------------------------------------------------------- beyond the JAX tests
def test_two_pumps_step_at_once():
    """Two threads each step one replica for many steps at once (the
    gateway's pumps, without HTTP): each replica's streams are bitwise
    a one-replica run of the same requests."""
    rng = np.random.default_rng(4)
    work = [[rng.integers(0, 256, int(n)).tolist() for n in rng.integers(3, 70, 8)] for _ in range(2)]

    def run(sched, prompts):
        hs = [sched.submit(p, max_new_tokens=40, do_sample=i % 2 == 1, temperature=0.9, top_k=7, seed=i)
              for i, p in enumerate(prompts)]
        return hs

    refs = []
    for prompts in work:
        s = make_engine(num_slots=3).scheduler()
        hs = run(s, prompts)
        s.drain()
        refs.append([h.result().tolist() for h in hs])
    rs = ReplicaSet.build(make_engine(num_slots=3), 2)
    handles = [run(rep.scheduler, prompts) for rep, prompts in zip(rs, work)]
    steps = [0, 0]
    errors = []

    def pump(i):
        try:
            rep = rs.replicas[i]
            while not rep.idle():
                rep.step()
                steps[i] += 1
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
    threads = [threading.Thread(target=pump, args=(i, )) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not errors and all(not t.is_alive() for t in threads)
    assert min(steps) >= 25
    for hs, ref in zip(handles, refs):
        assert [h.result().tolist() for h in hs] == ref


def test_load_from_threads_builds_and_binds_once(tmp_path, monkeypatch):
    """Eight threads take a kernel's library at once: one nvcc run, one
    ``CDLL``, one binding."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_loaded", {})
    runs, opened, bound = [], [], []
    gate = threading.Barrier(8)

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kw):
            runs.append(cmd)
            self.out = cmd[cmd.index("-o") + 1]

        def communicate(self):
            with open(self.out, "w") as f:
                f.write("built")
            return "ptxas info: Used 32 registers", None

        def poll(self):
            return 0

    class Lib:
        def __init__(self, path):
            opened.append(path)
            self.ds_error_string = type("F", (), {})()

    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", Proc)
    monkeypatch.setattr(build.ctypes, "CDLL", Lib)
    cache, got = {}, []

    def take():
        gate.wait()
        got.append(build.bind(cache, "decode_attention", bound.append))
    threads = [threading.Thread(target=take) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert len(runs) == 1 and len(opened) == 1 and len(bound) == 1
    assert len(got) == 8 and all(g is got[0] for g in got) and cache["decode_attention"] is got[0]


def test_extent_keys_unique_across_the_fleet():
    """Two replicas sharing one host store, each with a chained request
    (rid 0 on both) whose cold extents are demoted mid-decode, then
    restored: each stream bitwise its one-replica run (per-scheduler keys
    would collide in the store and the second demote replace the first)."""
    ref = _long_port(hier=False).scheduler(max_len=64, prefill_chunk=16, max_extents=4)
    h = ref.submit(LPROMPT, max_new_tokens=24)
    tok, logits = h.result(), h.result_logits()
    rs = ReplicaSet.build(_long_port(), 2, max_len=64, prefill_chunk=16, max_extents=4)
    s0, s1 = (r.scheduler for r in rs)
    assert s0.kv_tier.store is s1.kv_tier.store
    demoted = [_demote_mid_decode(s, LPROMPT) for s in (s0, s1)]
    assert all(n >= 1 for _, _, n in demoted)
    assert s0.kv_tier.store.stats()["entries"] == sum(n for _, _, n in demoted)
    for h, _, _ in demoted:
        np.testing.assert_array_equal(h.result(), tok)
        np.testing.assert_array_equal(h.result_logits(), logits)
    assert s0.kv_tier.store.stats()["entries"] == 0
    assert s0.longctx_restores >= 1 and s1.longctx_restores >= 1
