"""The port's hierarchical KV tier (``memory/kv_tier.py``, the tier hooks of
``inference/kv_cache.py`` and ``inference/scheduler.py``), the counterparts
of the JAX package's ``tests/unit/memory/test_kv_tier.py``,
``test_long_context.py::test_demote_restore_bit_identity`` and the tiered
radix tests of ``test_kv_cache.py``.

On ``tiny`` at fp32 with kernel injection (the paged kernels' plain
versions, the path the card runs), two slots, chunk 16, on the same numpy
weights as the JAX package's (``params_from_jax``). Port against port,
bitwise in tokens and logits: a prefix restored from the host tier ==
the device-resident radix hit == the cold prefill == the cold prefill on a
scheduler without the tier, greedy and sampled, bf16 and int8 KV; the same
across two schedulers sharing one store, through the NVMe tier, and for a
partial restore that keeps the longer entry; a lossless extent demotion
mid-decode leaves the stream as it was, and a parked row skips dispatches
until its extents are back. Against the JAX scheduler: its greedy tokens
for the restored stream and the paged stream are equal and the logits
within 1e-4 of max|ref| (XLA and PyTorch sum in other orders at fp32).
Plus the tier's own mechanics on a bare pool: a demote copies its rows
before the slot can be rewritten (the fetch held until admission has
overwritten the slot), demote/restore of a whole request between two
slots, no staging allocated after warm-up (the torch terms of JAX's
zero-new-programs guard), the one-tier-per-key invariant, eviction
demotes, ``invalidate_all`` drops the host tier, and the telemetry."""

import functools
import json
import os
import threading
import types

import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.models as jm
import deepspeed_tpu_torch
import deepspeed_tpu_torch.models as tm
from deepspeed_tpu.comm import comm
from deepspeed_tpu.models.transformer import CausalLMModel as JaxModel
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu_torch.inference.kv_cache import RadixPrefixCache, SlotKVCache
from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
from deepspeed_tpu_torch.memory import GlobalPrefixStore, KVTier
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.transformer import CausalLMModel, TransformerConfig

from .test_torch_long_context import LONG_KW, LPROMPT, _long_tree
from .torch_port_helpers import numpy_params

_RNG = np.random.default_rng(11)
PROMPT_G = _RNG.integers(0, 256, 100).astype(np.int32)   # greedy stream
PROMPT_S = _RNG.integers(0, 256, 90).astype(np.int32)    # sampled stream
FILLERS = [_RNG.integers(0, 256, 40 + 7 * i).astype(np.int32) for i in range(4)]
SAMPLED = dict(do_sample=True, temperature=0.8, top_k=8, seed=1234)


@functools.lru_cache(maxsize=None)
def _tree():
    return numpy_params(jm.get_model("tiny", max_seq_len=128), seed=10)


def _cfg(kv_cache_dtype="auto", hier=True, telemetry=None, **hk):
    cfg = {"dtype": "float32", "kernel_inject": True, "max_out_tokens": 512,
           "continuous_batching": {"enabled": True, "num_slots": 2,
                                   "kv_cache_dtype": kv_cache_dtype,
                                   "hierarchical_kv": {"enabled": hier, **hk}}}
    if telemetry is not None:
        cfg["telemetry"] = telemetry
    return cfg


def _port(kv_cache_dtype="auto", hier=True, telemetry=None, **hk):
    tmod = tm.get_model("tiny", max_seq_len=128)
    return deepspeed_tpu_torch.init_inference(
        tmod, config=_cfg(kv_cache_dtype, hier, telemetry, **hk),
        params=params_from_jax(_tree(), tmod.cfg), device="cpu")


def _jax(model=None, tree=None, **cb):
    from deepspeed_tpu.telemetry import set_sink
    comm._state["mesh"] = None
    set_sink(None)
    cfg = {"dtype": "float32", "max_out_tokens": 512,
           "continuous_batching": {"enabled": True, "num_slots": 2,
                                   "hierarchical_kv": {"enabled": True}, **cb}}
    return deepspeed_tpu.init_inference(model or jm.get_model("tiny", max_seq_len=128),
                                        config=cfg, params=tree or _tree())


def _submit(sched, prompt, sampled):
    kw = SAMPLED if sampled else dict(seed=7)
    h = sched.submit(prompt, max_new_tokens=8, collect_logits=True, **kw)
    return h.result().tolist(), h.result_logits()


def _thrash(sched):
    for f in FILLERS:  # the 2-slot pool evicts: earlier prefixes demote
        sched.submit(f, max_new_tokens=4).result()


# ---------------------------------------------------------------- scheduler, bitwise


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_restored_equals_device_hit_equals_cold(kv_dtype):
    """Cold prefill, then a device radix hit, then eviction demotes and a
    host restore, and the cold prefill on a scheduler without the tier:
    identical tokens AND logits, greedy and sampled, on the bf16 and the
    3-leaf int8 pool."""
    sched = _port(kv_dtype).scheduler(num_slots=2, prefill_chunk=16)
    assert sched.kv_tier is not None and sched.radix.tier is sched.kv_tier
    runs = {"cold": {}, "hit": {}, "restored": {}, "off": {}}
    for name in ("cold", "hit"):
        for sampled in (False, True):
            runs[name][sampled] = _submit(sched, PROMPT_S if sampled else PROMPT_G, sampled)
    assert sched.radix.hits >= 1  # G hits on device (on two slots, S's copy was demoted)
    _thrash(sched)
    assert sched.kv_tier.store.stats()["entries"] >= 2
    r0 = sched.kv_tier.restores
    for sampled in (False, True):
        runs["restored"][sampled] = _submit(sched, PROMPT_S if sampled else PROMPT_G, sampled)
    assert sched.kv_tier.restores == r0 + 2, sched.kv_tier.stats()
    sched.radix.check_invariants()
    off = _port(kv_dtype, hier=False).scheduler(num_slots=2, prefill_chunk=16)
    assert off.kv_tier is None
    for sampled in (False, True):
        runs["off"][sampled] = _submit(off, PROMPT_S if sampled else PROMPT_G, sampled)
    for sampled in (False, True):
        toks, logits = runs["cold"][sampled]
        for name in ("hit", "restored", "off"):
            assert runs[name][sampled][0] == toks, (kv_dtype, sampled, name)
            np.testing.assert_array_equal(runs[name][sampled][1], logits)


def test_restored_stream_matches_jax():
    """The JAX scheduler with its tier on the same weights, the same
    cold / thrash / restore sequence: equal greedy tokens, logits within
    1e-4 of max|ref|, both schedulers restored."""
    def run(sched, tier):
        cold = _submit(sched, PROMPT_G, False)
        _thrash(sched)
        restored = _submit(sched, PROMPT_G, False)
        assert tier(sched).restores >= 1
        return cold, restored

    port = run(_port().scheduler(num_slots=2, prefill_chunk=16), lambda s: s.kv_tier)
    ref = run(_jax().scheduler(num_slots=2, prefill_chunk=16), lambda s: s.kv_tier)
    for (tok, lg), (rtok, rlg) in zip(port, ref):
        assert tok == rtok
        rlg = np.asarray(rlg)
        assert np.abs(lg - rlg).max() <= 1e-4 * np.abs(rlg).max()


def test_cross_scheduler_restore_through_one_store():
    """Scheduler B serves a prefix only scheduler A computed: both bind one
    store, so A's eviction demote is B's admission restore (B's trie never
    saw the prompt), bitwise A's cold run."""
    eng = _port()
    a = eng.scheduler(num_slots=2, prefill_chunk=16)
    b = DecodeScheduler(eng, num_slots=2, prefill_chunk=16, prefix_store=a.kv_tier.store,
                        kv_cache_dtype="auto")
    assert b.kv_tier.store is a.kv_tier.store and b.kv_tier is not a.kv_tier
    cold = _submit(a, PROMPT_G, False)
    _thrash(a)
    got = _submit(b, PROMPT_G, False)
    assert b.kv_tier.restores == 1 and b.radix.hits == 0
    assert got[0] == cold[0]
    np.testing.assert_array_equal(got[1], cold[1])
    a.radix.check_invariants()
    b.radix.check_invariants()


def test_restore_min_tokens_threshold_falls_back_cold():
    """A host match below the threshold prefills cold, and the superseded
    host entry goes when the prompt registers on the device. The threshold
    also gates demotion: the 100-token prompt demotes (100 >= 100), its
    best re-match rounds to 96 < 100."""
    sched = _port(restore_min_tokens=len(PROMPT_G)).scheduler(num_slots=2, prefill_chunk=16)
    assert sched.kv_tier.min_restore_tokens == len(PROMPT_G)
    sched.submit(PROMPT_G, max_new_tokens=4).result()
    _thrash(sched)
    sched.kv_tier.executor.drain_fetches()
    assert sched.kv_tier.store.stats()["entries"] == 1  # fillers gated out
    sched.submit(PROMPT_G, max_new_tokens=4).result()  # cold: below the threshold
    assert sched.kv_tier.restores == 0
    assert not sched.kv_tier.store.contains_exact(PROMPT_G.tolist(), origin=id(sched.kv_tier))
    sched.radix.check_invariants()


def test_partial_restore_keeps_longer_entry():
    """A short turn restoring only a prefix of a longer demoted prompt keeps
    the longer entry; the full revisit then restores it whole, bitwise its
    cold run, and consumes it."""
    sched = _port().scheduler(num_slots=2, prefill_chunk=16)
    long_cold = _submit(sched, PROMPT_G, False)
    _thrash(sched)
    short = np.concatenate([PROMPT_G[:32], [5, 6]]).astype(np.int32)
    sched.submit(short, max_new_tokens=4).result()
    assert sched.kv_tier.restores == 1 and sched.kv_tier.restored_tokens == 32
    assert sched.kv_tier.store.contains_exact(PROMPT_G.tolist())
    sched.radix.check_invariants()
    _thrash(sched)
    got = _submit(sched, PROMPT_G, False)
    assert sched.kv_tier.restores >= 2
    assert got[0] == long_cold[0]
    np.testing.assert_array_equal(got[1], long_cold[1])
    assert not sched.kv_tier.store.contains_exact(PROMPT_G.tolist())
    sched.radix.check_invariants()


def test_duplicate_key_eviction_never_double_registers():
    """The same prompt admitted twice leaves two device registrations of
    one key; evicting one does NOT demote (the sibling still holds the
    bytes), evicting the last does."""
    sched = _port().scheduler(num_slots=2, prefill_chunk=16)
    sched.submit(PROMPT_G, max_new_tokens=4).result()
    sched.submit(PROMPT_G, max_new_tokens=4).result()  # a device hit: the second registration
    key = PROMPT_G.tolist()
    sched.cache.reclaim(sched.radix.evict_lru())
    sched.kv_tier.executor.drain_fetches()
    assert not sched.kv_tier.store.contains_exact(key)
    sched.radix.check_invariants()
    sched.cache.reclaim(sched.radix.evict_lru())
    sched.kv_tier.executor.drain_fetches()
    assert sched.kv_tier.store.contains_exact(key)
    sched.radix.check_invariants()


def test_nvme_spill_round_trip_through_scheduler(tmp_path):
    """host_capacity 0 sends every demote but the newest to NVMe; the
    restore reads its file back and still matches cold."""
    sched = _port(host_capacity_mb=0, nvme_path=str(tmp_path)).scheduler(num_slots=2,
                                                                          prefill_chunk=16)
    cold = _submit(sched, PROMPT_G, False)
    _thrash(sched)
    sched.kv_tier.executor.drain_fetches()
    st = sched.kv_tier.store.stats()
    assert st["spills"] >= 1 and st["nvme_bytes"] > 0
    got = _submit(sched, PROMPT_G, False)
    assert got[0] == cold[0]
    np.testing.assert_array_equal(got[1], cold[1])
    assert sched.kv_tier.store.stats()["nvme_loads"] >= 1
    sched.radix.check_invariants()


def test_submit_prefetch_issues_the_nvme_read():
    """A submitted prompt whose best host match is spilled starts the disk
    read at submit; the admission's restore joins it."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        sched = _port(host_capacity_mb=0, nvme_path=d).scheduler(num_slots=2, prefill_chunk=16)
        sched.submit(PROMPT_G, max_new_tokens=4).result()
        _thrash(sched)
        sched.kv_tier.executor.drain_fetches()
        store = sched.kv_tier.store
        entry = store.get_exact(PROMPT_G.tolist())
        assert entry is not None and entry.spill_path is not None
        h = sched.submit(PROMPT_G, max_new_tokens=4)
        assert entry.eid in store._reads  # issued at submit
        h.result()
        assert store.io_stats()["prefetches_landed"] == 1 and sched.kv_tier.restores == 1


def test_tier_telemetry_counters_reach_sink(tmp_path):
    """demote / restore / restore_tokens counters and the host-tier bytes
    and tier hit-rate gauges reach the sink's JSONL; ``tier_transfer`` of
    the host-gap buckets is fed; the replica's state reports the tier."""
    from deepspeed_tpu_torch.serving.replica import Replica
    eng = _port(telemetry={"enabled": True, "output_path": str(tmp_path), "flush_interval": 1})
    sched = eng.scheduler(num_slots=2, prefill_chunk=16)
    sched.submit(PROMPT_G, max_new_tokens=4).result()
    _thrash(sched)
    sched.submit(PROMPT_G, max_new_tokens=4).result()
    assert sched.kv_tier.restores >= 1
    eng.telemetry.flush()
    counters, gauges = set(), set()
    with open(os.path.join(str(tmp_path), "telemetry.jsonl")) as f:
        for line in f:
            d = json.loads(line)
            if d["type"] == "counter":
                counters.add(d["name"])
            elif d["type"] == "gauge":
                gauges.add(d["name"])
    assert {"serving/prefix_cache_demote", "serving/prefix_cache_restore",
            "serving/prefix_cache_restore_tokens"} <= counters
    assert {"serving/kv_host_tier_bytes", "serving/kv_tier_hit_rate"} <= gauges
    assert eng.telemetry.counter_total("serving/host_gap/tier_transfer_ms") > 0
    state = Replica(0, sched).state()["kv_tier"]
    assert state["restores"] == sched.kv_tier.restores and state["store"]["entries"] >= 1


# ---------------------------------------------------------------- lossless extent paging


def _long_port(hier=True):
    tmod = CausalLMModel(TransformerConfig(**LONG_KW))
    cfg = {"dtype": "float32", "decode_block_kv": 32, "kernel_inject": True,
           "continuous_batching": {"enabled": True, "num_slots": 4, "collect_logits": True,
                                   "hierarchical_kv": {"enabled": hier, "host_capacity_mb": 64}}}
    return deepspeed_tpu_torch.init_inference(tmod, config=cfg,
                                              params=params_from_jax(_long_tree(), tmod.cfg),
                                              device="cpu")


def _demote_mid_decode(s, prompt):
    """Admit ``prompt``, step until its row holds a cold extent, demote it.
    Returns (handle, slot, extents demoted)."""
    h = s.submit(prompt, max_new_tokens=24)
    while not s.active:
        s.step()
    slot = next(iter(s.active))
    n = 0
    for _ in range(30):
        s.step()
        if slot not in s.active:
            break
        n = s.demote_cold_extents(slot)
        if n:
            break
    return h, slot, n


@pytest.fixture(scope="module")
def long_reference():
    """The port's paged stream without demotion (tokens, logits)."""
    s = _long_port(hier=False).scheduler(max_len=64, prefill_chunk=16, max_extents=4)
    h = s.submit(LPROMPT, max_new_tokens=24)
    return h.result(), h.result_logits()


def test_lossless_demote_restore_bit_identity(long_reference):
    """Mid-decode cold-extent demotion to the host tier, then the pump's
    restore: the stream stays bitwise, the counters fire, nothing stays
    parked and the store holds no extent page."""
    s = _long_port().scheduler(max_len=64, prefill_chunk=16, max_extents=4)
    assert s.cache.max_extents == 4
    h, slot, n = _demote_mid_decode(s, LPROMPT)
    assert n >= 1 and s.cache.missing_extents(slot) and slot in s._parked
    assert len(s._ext_parked) == n and s.kv_tier.store.stats()["entries"] == n
    tok, logits = long_reference
    np.testing.assert_array_equal(h.result(), tok)
    np.testing.assert_array_equal(h.result_logits(), logits)
    assert s.longctx_demotes >= 1 and s.longctx_restores >= 1
    assert s.cache.active_slots == 0 and not s._parked and not s._ext_parked
    assert s.kv_tier.store.stats()["entries"] == 0
    s.radix.check_invariants()


def test_paged_stream_matches_jax(long_reference):
    """The JAX scheduler's lossless demotion on the same weights: equal
    greedy tokens, logits within 1e-4 of max|ref|."""
    s = _jax(JaxModel(JaxConfig(**LONG_KW)), _long_tree(), num_slots=4, collect_logits=True,
             hierarchical_kv={"enabled": True, "host_capacity_mb": 64}).scheduler(
                 max_len=64, prefill_chunk=16, max_extents=4)
    h, _, n = _demote_mid_decode(s, LPROMPT)
    assert n >= 1
    tok, logits = long_reference
    np.testing.assert_array_equal(np.asarray(h.result()), tok)
    ref = np.asarray(h.result_logits())
    assert np.abs(logits - ref).max() <= 1e-4 * np.abs(ref).max()
    assert s.longctx_restores >= 1


def test_parked_row_skips_dispatch_until_restored(long_reference):
    """While the free list is dry (restore_extent finds no row) the parked
    row is left out of every dispatch: its length stands still while a
    second request decodes; once rows come back it is restored and its
    stream is bitwise the reference. With the parked row alone live, the
    scheduler raises the paging deadlock instead of spinning."""
    s = _long_port().scheduler(max_len=64, prefill_chunk=16, max_extents=4)
    h, slot, n = _demote_mid_decode(s, LPROMPT)
    assert n >= 1
    other = s.submit([7, 8, 9, 10, 11], max_new_tokens=12)
    real = s.cache.restore_extent
    s.cache.restore_extent = lambda primary, idx: None  # the free list is dry
    try:
        length = int(s.cache.lengths[slot])
        for _ in range(3):
            s.step()
        assert slot in s._parked and int(s.cache.lengths[slot]) == length
        assert len(other._req.out) > 0
        other.result()
        with pytest.raises(RuntimeError, match="paging deadlock"):
            s.step()
    finally:
        s.cache.restore_extent = real
    tok, logits = long_reference
    np.testing.assert_array_equal(h.result(), tok)
    np.testing.assert_array_equal(h.result_logits(), logits)
    assert not s._parked and not s._ext_parked


def test_cancel_drops_parked_extents():
    """A parked request cancelled before its restore takes its host extent
    pages with it."""
    s = _long_port().scheduler(max_len=64, prefill_chunk=16, max_extents=4)
    h, slot, n = _demote_mid_decode(s, LPROMPT)
    assert n >= 1 and s.kv_tier.store.stats()["entries"] == n
    h.cancel()
    s.step()
    assert not s._parked and not s._ext_parked and s.kv_tier.store.stats()["entries"] == 0
    s.cache.check_invariants()


# ---------------------------------------------------------------- the tier on a bare pool


def _bare(kind="bf16", num_slots=3, max_len=32, store=None):
    """A KVTier over a 2-layer pool of random rows on the CPU, behind a
    stub scheduler (the attributes the tier reads)."""
    gen = torch.Generator().manual_seed(5)

    def leaf(shape, dtype):
        if dtype == torch.int8:
            return torch.randint(-128, 127, shape, generator=gen, dtype=dtype)
        return torch.randn(shape, generator=gen).to(dtype)

    shape = (num_slots, 2, max_len, 8)
    if kind == "int8":
        pool = tuple((leaf(shape, torch.int8), leaf(shape, torch.int8),
                      leaf((num_slots, 1, max_len, 1), torch.float16)) for _ in range(2))
    else:
        pool = tuple((leaf(shape, torch.bfloat16), leaf(shape, torch.bfloat16)) for _ in range(2))
    kv = SlotKVCache(pool, num_slots, max_len)
    sched = types.SimpleNamespace(cache=kv, device=torch.device("cpu"), prefill_chunk=4,
                                  telemetry=types.SimpleNamespace(enabled=False))
    tier = KVTier(sched, store or GlobalPrefixStore(capacity_bytes=1 << 20))
    return kv, tier


def _rows(kv, slot, n):
    return [leaf[slot:slot + 1][..., :n, :].clone() for comp in kv.pool for leaf in comp]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.contiguous().view(torch.uint8), y.contiguous().view(torch.uint8))


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_demote_copies_rows_before_admission_overwrites_the_slot(kind):
    """The fetch closure is held on an event until the evicted slot has
    been rewritten by the next admission; the entry still holds the rows
    as they were at eviction (a demote that kept a view of the pool would
    register the new request's KV)."""
    kv, tier = _bare(kind)
    radix = RadixPrefixCache(kv)
    radix.tier = tier
    a = kv.alloc()
    kv.lengths[a] = 12
    tokens = list(range(10, 22))
    radix.insert(a, tokens)
    kv.retain(a)
    before = _rows(kv, a, 12)
    gate = threading.Event()
    submit = tier.executor.submit_fetch
    tier.executor.submit_fetch = lambda fn: submit(lambda: (gate.wait(30), fn()))
    victim = radix.evict_lru()  # demote: the fetch waits on the gate
    assert victim == a
    kv.reclaim(victim)
    slot = kv.alloc()
    assert slot == a
    for comp in kv.pool:  # the admission's prefill writes the slot
        for leaf in comp:
            leaf[slot].fill_(3)
    gate.set()
    tier.executor.drain_fetches()
    entry = tier.store.get_exact(tokens)
    assert entry is not None and entry.length == 12
    _same(entry.leaves, before)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_demote_request_restore_request_round_trip(kind):
    """A whole request's rows parked from one slot and installed in another:
    rows [0, n) of the destination are bitwise the source's, its rows past
    n untouched; the entry is pinned until the restore consumes it, and a
    second restore of it reports False."""
    kv, tier = _bare(kind)
    key = (-(1 << 30), 7)
    got = []
    tier.demote_request(0, 20, key, got.append)
    tier.executor.drain_fetches()
    (entry, ) = got
    assert entry.pinned and entry.length == 20 and tier.store.contains_exact(key)
    src, tail = _rows(kv, 0, 20), [leaf[2:3][..., 20:, :].clone() for c in kv.pool for leaf in c]
    assert tier.restore_request(entry, 2, 20)
    _same(_rows(kv, 2, 20), src)
    _same([leaf[2:3][..., 20:, :] for c in kv.pool for leaf in c], tail)
    assert not tier.store.contains_exact(key)
    assert not tier.restore_request(entry, 1, 20)


def test_demote_restore_cycle_allocates_no_new_staging():
    """After warm-up a demote -> restore cycle allocates no staging buffer
    (the torch terms of the JAX guard that a cycle adds no compiled
    program): the restore staging is one persistent buffer."""
    kv, tier = _bare()
    tier.warmup()
    n0 = tier.staging_allocs
    assert n0 >= 1
    for cycle in range(3):
        tokens = [cycle] * 8
        tier.demote(0, tokens)
        tier.executor.drain_fetches()
        m, entry = tier.probe(tokens + [99])
        assert m == 8
        assert tier.restore(entry, 1, 8, prompt_len=9)
        _same(_rows(kv, 1, 8), _rows(kv, 0, 8))
    assert tier.staging_allocs == n0 and tier.restores == 3


def test_eviction_demotes_to_host_tier_and_invariants():
    """Eviction demotes the registered rows under the trie path's tokens
    (the path survives edge splits); the store then holds them and the
    device registration is gone; a prefix both device-registered and
    host-demoted by the same scheduler trips the invariant, another
    scheduler's copy does not; ``invalidate_all`` drops the host tier too."""
    kv, tier = _bare(num_slots=3)
    radix = RadixPrefixCache(kv)
    radix.tier = tier
    a, b = kv.alloc(), kv.alloc()
    radix.insert(a, [1, 2, 3, 4, 5])
    radix.insert(b, [1, 2, 9, 9])  # splits a's edge
    assert radix.registered_tokens(a) == (1, 2, 3, 4, 5)
    assert radix.registered_tokens(b) == (1, 2, 9, 9) and radix.registered_tokens(2) == ()
    kv.lengths[a] = 5
    kv.retain(a)
    rows = _rows(kv, a, 5)
    assert radix.evict_lru() == a
    kv.reclaim(a)
    radix.check_invariants()  # drains the fetch: demoted AND unregistered
    assert tier.store.contains_exact([1, 2, 3, 4, 5], origin=id(tier))
    _same(tier.store.get_exact([1, 2, 3, 4, 5]).leaves, rows)
    tier.store.put([1, 2, 9, 9], _rows(kv, b, 4), 0, origin=id(tier))
    with pytest.raises(AssertionError, match="device-registered AND host"):
        radix.check_invariants()
    tier.store.put([1, 2, 9, 9], _rows(kv, b, 4), 0, origin="another scheduler")
    radix.check_invariants()
    kv.lengths[b] = 4
    kv.retain(b)
    with pytest.raises(ValueError, match="live registered"):
        c = kv.alloc()
        radix.insert(c, [5, 5, 5, 5])
        radix.invalidate_all()
    radix.remove(c)
    kv.free(c)
    dropped = radix.invalidate_all()
    assert dropped == 4 + 5 + 4  # device-retained b + host-resident a and b's other copy
    assert len(tier.store) == 0 and kv.free_slots == kv.num_slots
    radix.check_invariants()
