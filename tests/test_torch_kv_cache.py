"""The port's slot pool and radix prefix cache (``inference/kv_cache.py``)
against the JAX package's: the same sequence of alloc / free / retain /
reclaim / radix insert / match / evict_lru on both gives the same slot
states, lengths, references, matches and eviction order, and both hold
their invariants after every operation. Plus ``copy_slot``: it copies
exactly one slot in every layer leaf."""

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.kv_cache import RadixPrefixCache as JaxRadix
from deepspeed_tpu.inference.kv_cache import SlotKVCache as JaxSlots
from deepspeed_tpu_torch.inference.kv_cache import (RadixPrefixCache, SlotKVCache, copy_slot,
                                                    slot_slice, slot_update)


def _same(jkv, jrx, tkv, trx):
    assert tkv.state == jkv.state
    np.testing.assert_array_equal(tkv.lengths, jkv.lengths)
    np.testing.assert_array_equal(tkv.refs, jkv.refs)
    assert tkv._free == jkv._free
    assert (tkv.total_allocs, tkv.total_frees) == (jkv.total_allocs, jkv.total_frees)
    assert trx.registered_slots() == jrx.registered_slots()
    assert (trx.hits, trx.misses, trx.evictions) == (jrx.hits, jrx.misses, jrx.evictions)
    assert tkv.occupancy() == jkv.occupancy()
    assert tkv.token_utilization() == jkv.token_utilization()
    jrx.check_invariants()
    trx.check_invariants()


def _pair(num_slots=4, max_len=128):
    jkv, tkv = JaxSlots(None, num_slots, max_len), SlotKVCache(None, num_slots, max_len)
    return jkv, JaxRadix(jkv), tkv, RadixPrefixCache(tkv)


def test_scripted_lifecycle_matches_jax():
    """Admission, registration, retention, a hit, an eviction sparing the
    matched donor, and the donor itself reclaimed when it is the last
    cached slot."""
    jkv, jrx, tkv, trx = _pair(num_slots=2)
    a, b = list(range(1, 41)), list(range(1, 21)) + list(range(90, 110))
    for kv, rx in ((jkv, jrx), (tkv, trx)):
        s0 = kv.alloc(owner=0)
        kv.lengths[s0] = len(a)
        rx.insert(s0, a)
        kv.retain(s0)
        s1 = kv.alloc(owner=1)
        kv.lengths[s1] = len(b)
        rx.insert(s1, b)
        kv.retain(s1)
    _same(jkv, jrx, tkv, trx)
    assert trx.match(a[:30] + [7]) == jrx.match(a[:30] + [7]) == (30, 0)
    assert trx.match(b) == jrx.match(b) == (40, 1)
    assert trx.match(list(range(1, 21)) + [5]) == jrx.match(list(range(1, 21)) + [5])
    assert trx.match([300]) == jrx.match([300]) == (0, None)
    assert trx.evict_lru(prefer_not=0) == jrx.evict_lru(prefer_not=0) == 1
    for kv in (jkv, tkv):
        kv.reclaim(1)
    _same(jkv, jrx, tkv, trx)
    assert trx.evict_lru(prefer_not=0) == jrx.evict_lru(prefer_not=0) == 0
    assert trx.evict_lru() is None and jrx.evict_lru() is None
    for kv in (jkv, tkv):
        kv.reclaim(0)
    _same(jkv, jrx, tkv, trx)
    with pytest.raises(ValueError, match="double free"):
        tkv.free(0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_operation_storm_matches_jax(seed):
    """300 random operations over prompts drawn from a few shared stems."""
    rng = np.random.default_rng(seed)
    jkv, jrx, tkv, trx = _pair(num_slots=5)
    stems = [list(rng.integers(1, 50, 30)) for _ in range(3)]

    def prompt():
        stem = stems[int(rng.integers(0, 3))]
        return [int(t) for t in stem[:int(rng.integers(1, 31))]
                + list(rng.integers(1, 50, int(rng.integers(0, 10))))]

    for _ in range(300):
        op = int(rng.integers(0, 6))
        active = [i for i, s in enumerate(tkv.state) if s == "active"]
        if op == 0:  # admission: alloc, else evict-and-reclaim
            p = prompt()
            m = trx.match(p)
            assert m == jrx.match(p)
            got = [kv.alloc(owner=1) for kv in (jkv, tkv)]
            assert got[0] == got[1]
            if got[0] is None:
                victims = [rx.evict_lru(prefer_not=m[1]) for rx in (jrx, trx)]
                assert victims[0] == victims[1]
                if victims[0] is not None:
                    for kv in (jkv, tkv):
                        kv.reclaim(victims[0])
                        kv.alloc(owner=1)
        elif op == 1 and active:  # a prefill lands: register the prompt
            slot = active[int(rng.integers(0, len(active)))]
            if slot not in trx._slot_node:
                p = prompt()
                for kv, rx in ((jkv, jrx), (tkv, trx)):
                    kv.lengths[slot] = len(p)
                    rx.insert(slot, p)
        elif op == 2 and active:  # a request ends: retain or free
            slot = active[int(rng.integers(0, len(active)))]
            for kv in (jkv, tkv):
                if kv.refs[slot] > 0:
                    kv.retain(slot)
                else:
                    kv.free(slot)
        elif op == 3:
            p = prompt()
            assert trx.match(p) == jrx.match(p)
        elif op == 4:
            victims = [rx.evict_lru() for rx in (jrx, trx)]
            assert victims[0] == victims[1]
            if victims[0] is not None:
                for kv in (jkv, tkv):
                    kv.reclaim(victims[0])
        elif op == 5:
            slot = int(rng.integers(0, 5))
            for rx in (jrx, trx):
                rx.touch(slot)
        _same(jkv, jrx, tkv, trx)


@pytest.mark.parametrize("quantized", [False, True])
def test_copy_slot_copies_exactly_one_slot(quantized):
    """Every layer leaf (k, v, and the int8 tier's scales) of ``dst`` takes
    ``src``'s rows; every other slot, ``src`` included, keeps its bytes."""
    gen = torch.Generator().manual_seed(0)
    L, N, nkv, S, D = 2, 4, 2, 16, 8

    def leaf(shape, dt):
        return (torch.randn(shape, generator=gen) * 50).to(dt)

    if quantized:
        pool = (tuple(leaf((N, nkv, S, D), torch.int8) for _ in range(L)),
                tuple(leaf((N, nkv, S, D), torch.int8) for _ in range(L)),
                tuple(leaf((N, 1, S, 1), torch.float16) for _ in range(L)))
    else:
        pool = tuple(tuple(leaf((N, nkv, S, D), torch.float32) for _ in range(L)) for _ in range(2))
    before = tuple(tuple(t.clone() for t in comp) for comp in pool)
    assert copy_slot(pool, 1, 3) is pool
    for comp, old in zip(pool, before):
        for t, o in zip(comp, old):
            assert torch.equal(t[3], o[1])
            for s in (0, 1, 2):
                assert torch.equal(t[s], o[s])
    one = slot_slice(pool, 0)
    assert all(t.shape[0] == 1 for comp in one for t in comp)
    slot_update(pool, 2, tuple(tuple(t.clone() for t in comp) for comp in one))
    assert all(torch.equal(t[2], t[0]) for comp in pool for t in comp)
    kv = SlotKVCache(pool, N, S)
    per_row = sum(t.numel() // (N * S) * t.element_size() for comp in pool for t in comp)
    assert kv.bytes_per_token() == per_row and kv.capacity_bytes() == per_row * N * S
