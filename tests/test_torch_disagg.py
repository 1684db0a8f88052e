"""Disaggregated prefill/decode in the port (``serving/replica.py``'s phase
roles over ``DecodeScheduler.migrate_out`` / ``admit_migration``): the
counterparts of the JAX package's ``tests/unit/serving/test_disagg.py``.

The bar: a request whose prefill ran on a ``prefill`` replica and whose KV
migrated to a ``decode`` replica through the shared host store decodes
bitwise as on one replica, tokens and logits, greedy and sampled, on the
model's KV pool (fp32 for ``tiny`` at fp32, bf16 for ``tiny-gpt2`` int8)
and an int8 pool (the row scales travel with the rows), cold and radix
hit, on the per-projection path (both models) and on the fused decode
layer (``tiny-gpt2`` int8 with kernel injection: the plain versions of
kernels A and C here). A prefill/decode pair's greedy streams equal the JAX fleet's on
the same weights. Around it: a cancel while the handoff is parked (and one
racing its demote) frees both ends and the store; a parked handoff belongs
to no replica, so a sick decode replica's work goes to another and a
prefill replica failing after the handoff cannot fail the request; a
fleet with no decode side colocates; ``migrate_min_tokens`` keeps short
prompts home; a zero-role fleet is the plain fleet; role changes keep both
phases coverable and need the store; a warm migration cycle allocates no
staging (the torch terms of JAX's zero-new-programs guard); over HTTP the
pair serves the direct submit's tokens and reports roles, migrations and
the Prometheus series. Adapter requests (multi-LoRA, not ported) raise
naming ROADMAP Queue 1 #9.
"""

import functools
import http.client
import json

import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu.models as jm
import deepspeed_tpu_torch
import deepspeed_tpu_torch.models as tm
from deepspeed_tpu.comm import comm
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.serving import Gateway, ReplicaSet
from deepspeed_tpu_torch.telemetry import set_sink

from .torch_port_helpers import numpy_params

JOIN_S = 120
_RNG = np.random.default_rng(14)
# cold, then an exact revisit (a radix hit on the prefill replica), then cold
PROMPTS = [_RNG.integers(0, 256, 100).astype(np.int32), _RNG.integers(0, 256, 70).astype(np.int32)]
MODELS = {"fp32": ("tiny", {"dtype": "float32"}),
          "int8": ("tiny-gpt2", {"dtype": "int8"}),
          "fused": ("tiny-gpt2", {"dtype": "int8", "kernel_inject": True})}


@functools.lru_cache(maxsize=None)
def _tree(name):
    return numpy_params(jm.get_model(name, max_seq_len=128), seed=10)


def make_engine(num_slots=4, kv_cache_dtype="auto", roles=None, migrate_min_tokens=0, telemetry=None,
                model="fp32", **cb):
    set_sink(None)
    name, base = MODELS[model]
    tmod = tm.get_model(name, max_seq_len=128)
    cbs = {"enabled": True, "num_slots": num_slots, "kv_cache_dtype": kv_cache_dtype, **cb}
    if roles is not None:
        cbs["disaggregation"] = {"enabled": True, "roles": roles, "migrate_min_tokens": migrate_min_tokens}
    config = {**base, "max_out_tokens": 512, "continuous_batching": cbs}
    if telemetry is not None:
        config["telemetry"] = telemetry
    return deepspeed_tpu_torch.init_inference(tmod, config=config, params=params_from_jax(_tree(name), tmod.cfg),
                                              device="cpu")


def _stream(rs, sampled, max_new=10):
    """The cold / radix-hit / cold mix through ``rs``: (tokens, logits) per
    request."""
    kw = dict(do_sample=True, temperature=0.8, top_k=9, seed=123) if sampled else dict(seed=7)
    handles = []
    for p in (PROMPTS[0], PROMPTS[0], PROMPTS[1]):
        _, h = rs.dispatch(p, max_new_tokens=max_new, collect_logits=True, **kw)
        assert h is not None
        handles.append(h)
    rs.drain_all_work()
    return [h.result().tolist() for h in handles], [h.result_logits() for h in handles]


# ----------------------------------------------------------------- bit-identity
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_migrated_decode_bit_identical(kv_dtype, sampled, model):
    ref_t, ref_l = _stream(ReplicaSet.build(make_engine(kv_cache_dtype=kv_dtype, model=model), 1), sampled)
    rs = ReplicaSet.build(make_engine(kv_cache_dtype=kv_dtype, roles=["prefill", "decode"], model=model), 2)
    assert rs.primary._fused_block == (model == "fused")
    got_t, got_l = _stream(rs, sampled)
    assert got_t == ref_t
    for a, b in zip(ref_l, got_l):
        assert a.shape == b.shape and (a == b).all(), "migrated logits diverged"
    assert rs.primary.migrations_out == 3 and rs.replicas[1].scheduler.migrations_in == 3
    assert rs.primary.radix.hits >= 1  # the revisit hit the prefill replica's trie
    assert rs.pending_migrations() == 0
    for rep in rs:
        rep.scheduler.radix.check_invariants()
        assert rep.scheduler.cache.active_slots == 0


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_queued_handoffs_bit_identical(kv_dtype, model):
    """Under load: 8 requests on 2 slots a replica, dispatched at once
    (the fleet stepping while it is full), so prompts queue for the prefill
    replica and handoffs park until the decode replica has room. Every
    request migrates and decodes bitwise as on one replica, tokens and
    logits, greedy and sampled in turn."""
    rng = np.random.default_rng(15)
    prompts = [rng.integers(0, 256, int(n)).astype(np.int32) for n in rng.integers(5, 90, 8)]

    def serve(rs):
        handles = []
        for i, p in enumerate(prompts):
            kw = dict(do_sample=True, temperature=0.8, top_k=9) if i % 2 else {}
            while True:
                _, h = rs.dispatch(p, max_new_tokens=12, collect_logits=True, seed=100 + i, **kw)
                if h is not None:
                    break
                rs.pump_once()
            handles.append(h)
        rs.drain_all_work()
        return [h.result().tolist() for h in handles], [h.result_logits() for h in handles]

    ref_t, ref_l = serve(ReplicaSet.build(make_engine(num_slots=2, kv_cache_dtype=kv_dtype, model=model), 1))
    rs = ReplicaSet.build(make_engine(num_slots=2, kv_cache_dtype=kv_dtype, roles=["prefill", "decode"],
                                      model=model), 2)
    got_t, got_l = serve(rs)
    assert got_t == ref_t
    for a, b in zip(ref_l, got_l):
        assert a.shape == b.shape and (a == b).all(), "a queued handoff's logits diverged"
    assert rs.primary.migrations_out == rs.replicas[1].scheduler.migrations_in == len(prompts)
    assert rs.pending_migrations() == 0
    for rep in rs:
        assert rep.scheduler.cache.active_slots == 0


def test_pair_greedy_streams_match_jax():
    """A prefill/decode pair's greedy streams equal the JAX fleet's with the
    same roles on the same weights; both migrate every request."""
    from deepspeed_tpu.serving import ReplicaSet as JaxReplicaSet
    from deepspeed_tpu.telemetry import set_sink as jax_set_sink
    comm._state["mesh"] = None
    jax_set_sink(None)
    je = deepspeed_tpu.init_inference(
        jm.get_model("tiny", max_seq_len=128), params=_tree("tiny"),
        config={"dtype": "float32", "max_out_tokens": 512,
                "continuous_batching": {"enabled": True, "num_slots": 4,
                                        "disaggregation": {"enabled": True, "roles": ["prefill", "decode"]}}})

    def greedy(rs):
        hs = [rs.dispatch(p, max_new_tokens=10, seed=7)[1] for p in (PROMPTS[0], PROMPTS[0], PROMPTS[1])]
        rs.drain_all_work()
        return [np.asarray(h.result()).tolist() for h in hs]

    jrs = JaxReplicaSet.build(je, 2)
    trs = ReplicaSet.build(make_engine(roles=["prefill", "decode"]), 2)
    assert greedy(trs) == greedy(jrs)
    assert trs.primary.migrations_out == jrs.primary.migrations_out == 3


def test_adapter_requests_raise():
    """Multi-LoRA (an adapter's pages travelling with the handoff) is not
    ported: an adapter request raises naming ROADMAP Queue 1 #9."""
    rs = ReplicaSet.build(make_engine(roles=["prefill", "decode"]), 2)
    with pytest.raises(NotImplementedError, match="Queue 1 #9, multi-LoRA"):
        rs.dispatch(PROMPTS[0], max_new_tokens=8, adapter_id="tenant-a")
    with pytest.raises(NotImplementedError, match="Queue 1 #9"):
        make_engine(multi_lora={"enabled": True})


# ----------------------------------------------------------------- structure
def _park_one_migration(rs, prompt, **kw):
    """Submit onto the prefill replica and step ONLY it until the handoff is
    parked and ready; returns the handle."""
    rep, h = rs.dispatch(prompt, **kw)
    assert rep is rs.replicas[0]
    pre = rs.replicas[0]
    for _ in range(200):
        if rs.pending_migrations():
            break
        pre.step()
    assert rs.pending_migrations() == 1
    pre.scheduler.kv_tier.executor.drain_fetches()
    assert rs._migrations[0].ready and rs._migrations[0].entry is not None
    return h


def test_mid_migration_cancel_frees_both_ends():
    rs = ReplicaSet.build(make_engine(roles=["prefill", "decode"]), 2)
    h = _park_one_migration(rs, PROMPTS[0], max_new_tokens=16, seed=1)
    store = rs.primary.kv_tier.store
    assert len(store) == 1  # the parked handoff
    h.cancel()
    rs.drain_all_work()
    assert h.done and rs.pending_migrations() == 0
    assert len(store) == 0, "cancelled handoff leaked its store entry"
    for rep in rs:
        assert rep.scheduler.cache.active_slots == 0
        rep.scheduler.radix.check_invariants()
    assert rs.replicas[1].scheduler.migrations_in == 0
    # a cancel racing the demote's fetch: the settle waits for the put
    _, h2 = rs.dispatch(PROMPTS[1], max_new_tokens=16, seed=2)
    for _ in range(200):
        if rs.pending_migrations():
            break
        rs.replicas[0].step()
    h2.cancel()
    rs.drain_all_work()
    assert h2.done and rs.pending_migrations() == 0 and len(store) == 0
    assert rs.migrations_failed == 0


def test_sick_decode_replica_failover_replaces_kv():
    ref = make_engine().scheduler().submit(PROMPTS[0], max_new_tokens=12, seed=9).result().tolist()
    rs = ReplicaSet.build(make_engine(roles=["prefill", "decode", "decode"]), 3)
    h = _park_one_migration(rs, PROMPTS[0], max_new_tokens=12, seed=9)
    rs.mark_sick(1, "injected failure")
    rs.drain_all_work()
    assert h.result().tolist() == ref
    assert rs.replicas[1].scheduler.migrations_in == 0
    assert rs.replicas[2].scheduler.migrations_in == 1
    assert rs.migrations_failed == 0


def test_prefill_replica_sick_after_handoff_does_not_kill_request():
    rs = ReplicaSet.build(make_engine(roles=["prefill", "decode"]), 2)
    h = _park_one_migration(rs, PROMPTS[0], max_new_tokens=12, seed=2)
    req = h._req
    assert not rs.primary.owns(req), "migrated-out request still owned by the prefill replica"
    assert not rs.replicas[1].scheduler.owns(req)
    rs.mark_sick(0, "injected failure")
    rs.pump_once()
    assert rs.replicas[1].scheduler.owns(req)
    assert len(h.result()) == 12


def test_no_decode_target_colocates():
    rs = ReplicaSet.build(make_engine(roles=["prefill", "decode"]), 2)
    rs.drain(1)  # the decode side is gone
    rep, h = rs.dispatch(PROMPTS[1], max_new_tokens=8, seed=3)
    assert rep is rs.replicas[0]
    rs.drain_all_work()
    assert len(h.result()) == 8
    assert rs.primary.migrations_out == 0 and rs.pending_migrations() == 0


def test_migrate_min_tokens_colocates_short_prompts():
    rs = ReplicaSet.build(make_engine(roles=["prefill", "decode"], migrate_min_tokens=90), 2)
    _, h_short = rs.dispatch(PROMPTS[1], max_new_tokens=6, seed=4)   # 70 tokens
    _, h_long = rs.dispatch(PROMPTS[0], max_new_tokens=6, seed=4)    # 100 tokens
    rs.drain_all_work()
    assert len(h_short.result()) == 6 and len(h_long.result()) == 6
    assert rs.primary.migrations_out == 1  # only the long prompt moved


def test_zero_role_fleet_identical_to_plain_replicas():
    rs_ref = ReplicaSet.build(make_engine(), 2)
    handles = [rs_ref.dispatch(p, max_new_tokens=8, seed=11)[1] for p in PROMPTS]
    rs_ref.drain_all_work()
    ref = [h.result().tolist() for h in handles]
    rs = ReplicaSet.build(make_engine(roles=[]), 2)
    assert not rs._hooks_installed
    assert all(r.scheduler.migrate_hook is None for r in rs)
    assert rs.primary.kv_tier is not None  # the section builds the store with the tier off
    handles = [rs.dispatch(p, max_new_tokens=8, seed=11)[1] for p in PROMPTS]
    rs.drain_all_work()
    assert [h.result().tolist() for h in handles] == ref
    assert rs.primary.migrations_out == 0


def test_set_role_validation():
    rs = ReplicaSet.build(make_engine(), 2)  # no store
    with pytest.raises(ValueError, match="prefix store"):
        rs.set_role(0, "prefill")
    with pytest.raises(ValueError, match="phase_role"):
        rs.set_role(0, "bogus")
    rs2 = ReplicaSet.build(make_engine(roles=["prefill", "decode"]), 2)
    with pytest.raises(ValueError, match="decode-capable"):
        rs2.set_role(1, "prefill")  # would strand the fleet
    assert rs2.replicas[1].phase_role == "decode"  # reverted
    rs2.set_role(0, "mixed")
    rs2.set_role(1, "mixed")
    assert not rs2.disaggregated()
    rs3 = ReplicaSet.build(make_engine(prefill_chunk=0, hierarchical_kv={"enabled": True}), 2)
    with pytest.raises(ValueError):
        rs3.set_role(0, "prefill")  # no chunked prefill (and no radix): no transport
    assert rs3.replicas[0].phase_role == "mixed"


def test_migration_cycle_allocates_no_new_staging():
    """After the fleet's first mix (cold prefill, radix hit, migration,
    decode, greedy and sampled) a fresh mix with a role flip allocates no
    staging buffer in either replica's tier."""
    rs = ReplicaSet.build(make_engine(roles=["prefill", "decode"]), 2)
    _stream(rs, sampled=False)
    _stream(rs, sampled=True)
    allocs = [r.scheduler.kv_tier.staging_allocs for r in rs]
    rng = np.random.default_rng(77)
    handles = []
    for i, n in enumerate((33, 81, 64, 97, 12)):
        p = rng.integers(0, 256, n).astype(np.int32)
        while True:
            _, h = rs.dispatch(p, max_new_tokens=6, do_sample=(i % 2 == 0), temperature=0.7, top_k=5,
                               seed=100 + i)
            if h is not None:
                break
            rs.pump_once()
        handles.append(h)
    rs.drain_all_work()
    rs.set_role(1, "mixed")
    rs.set_role(1, "decode")
    handles.append(rs.dispatch(rng.integers(0, 256, 50).astype(np.int32), max_new_tokens=6, seed=200)[1])
    rs.drain_all_work()
    assert all(h.done for h in handles)
    assert rs.primary.migrations_out == 3 + 3 + 5 + 1  # the 12-token prompt too: migrate_min_tokens 0
    assert [r.scheduler.kv_tier.staging_allocs for r in rs] == allocs


# ----------------------------------------------------------------- gateway
def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=JOIN_S)
    try:
        conn.request(method, path, json.dumps(body) if body is not None else None, headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_gateway_disagg_end_to_end(tmp_path):
    ref_eng = make_engine(num_slots=2)
    ref = ref_eng.scheduler().submit([5, 6, 7, 8] * 20, max_new_tokens=6, seed=3).result().tolist()
    eng = make_engine(num_slots=2, replicas=2, roles=["prefill", "decode"],
                      telemetry={"enabled": True, "output_path": str(tmp_path)})
    gw = Gateway(eng, port=0, request_timeout_s=60.0)
    gw.start_background()
    try:
        for _ in range(3):
            status, body = _request(gw.port, "POST", "/v1/completions",
                                    {"prompt": [5, 6, 7, 8] * 20, "max_tokens": 6, "seed": 3})
            assert status == 200 and json.loads(body)["choices"][0]["token_ids"] == ref
        states = json.loads(_request(gw.port, "GET", "/v1/replicas")[1])["replicas"]
        assert [s["phase_role"] for s in states] == ["prefill", "decode"]
        assert states[0]["migrations_out"] == 3 and states[1]["migrations_in"] == 3
        m = json.loads(_request(gw.port, "GET", "/v1/metrics")[1])
        assert m["disaggregation"]["roles"] == ["prefill", "decode"]
        assert m["disaggregation"]["migrations"] == 3 and m["disaggregation"]["pending"] == 0
        text = _request(gw.port, "GET", "/v1/metrics", headers={"Accept": "text/plain"})[1].decode()
        assert "dstpu_serving_replicas_prefill_capable 1" in text
        assert "dstpu_serving_migrations_pending 0" in text
        assert 'dstpu_serving_replica_migrations_out_total{replica="0"} 3' in text
        status, body = _request(gw.port, "POST", "/v1/replicas/1/role", {"role": "mixed"})
        assert status == 200 and json.loads(body)["replica"]["phase_role"] == "mixed"
        assert _request(gw.port, "POST", "/v1/replicas/0/role", {"role": "bogus"})[0] == 400
    finally:
        assert gw.close(JOIN_S), "disaggregated fleet failed to drain"
