"""The port's host prefix store (``memory/prefix_store.py``) against the
JAX package's ``GlobalPrefixStore``.

The counterparts of ``tests/unit/memory/test_prefix_store.py`` (all nine:
trie matching, exact-key replace and origin-scoped discard, LRU capacity,
NVMe spill with look-ahead and reload, drops that reclaim files and
in-flight reads, partial pops, the stranded-slot reclaim, stale-version
probes and the bookkeeping), on CPU torch tensors. Then a differential
run: one seeded sequence of put, probe, pop, discard and capacity-pressure
operations goes to both stores, on bf16, int8 and fp16 leaves (the pool's
leaf kinds), in RAM and with an NVMe tier under ``tmp_path``; they must
agree on every probe's length and entry, every LRU victim (the resident
and spilled key sets after each operation), ``stats()``, and the bytes of
every popped leaf (bf16 compared through 16-bit integer views). Exact
throughout: the stores hold bytes."""

import os

import numpy as np
import pytest
import torch

import ml_dtypes
from deepspeed_tpu.memory.prefix_store import GlobalPrefixStore as JaxStore
from deepspeed_tpu_torch.memory import GlobalPrefixStore, PrefixEntry
from deepspeed_tpu_torch.memory.prefix_store import GlobalPrefixStore as FromModule


def _rows(n, fill=1):
    """Fake host KV rows: one leaf with the row axis at ndim-2."""
    return [torch.full((2, n, 4), fill, dtype=torch.uint8)]


def test_lazy_exports_are_the_module_classes():
    import deepspeed_tpu_torch.memory as mem
    assert GlobalPrefixStore is FromModule
    assert PrefixEntry.__module__ == "deepspeed_tpu_torch.memory.prefix_store"
    assert mem.KVTier.__module__ == "deepspeed_tpu_torch.memory.kv_tier"
    with pytest.raises(AttributeError):
        mem.NoSuchThing  # noqa: B018


def test_put_probe_pop_longest_prefix():
    st = GlobalPrefixStore(capacity_bytes=1 << 20)
    e1 = st.put([1, 2, 3, 4], _rows(4, 1), version=0, origin="a")
    st.put([1, 2, 9], _rows(3, 2), version=0, origin="b")
    m, e = st.probe([1, 2, 3, 4, 5], version=0)
    assert m == 4 and e is e1
    m, e = st.probe([1, 2, 9, 9], version=0)
    assert m == 3 and e.origin == "b"
    assert st.probe([7], version=0) == (0, None)
    m, e = st.probe([1, 2], version=0)  # partial edge: the subtree shares the depth
    assert m == 2 and e is not None
    leaves = st.pop(e1)
    assert torch.equal(leaves[0], _rows(4, 1)[0])
    assert st.pop(e1) is None  # already claimed
    assert len(st) == 1 and st.restores == 1


def test_exact_key_replace_and_discard_origin_scoped():
    st = GlobalPrefixStore(capacity_bytes=1 << 20)
    st.put([1, 2, 3], _rows(3, 1), version=0, origin="a")
    e2 = st.put([1, 2, 3], _rows(3, 9), version=0, origin="b")  # freshest wins
    assert len(st) == 1
    m, e = st.probe([1, 2, 3], version=0)
    assert e is e2 and int(e.leaves[0][0, 0, 0]) == 9
    assert not st.discard([1, 2, 3], origin="a")  # wrong origin: untouched
    assert st.discard([1, 2, 3], origin="b")
    assert len(st) == 0 and st.host_bytes == 0


def test_capacity_drops_lru_without_nvme():
    one = _rows(4)[0].nbytes
    st = GlobalPrefixStore(capacity_bytes=2 * one)
    st.put([1, 1, 1, 1], _rows(4), version=0)
    st.put([2, 2, 2, 2], _rows(4), version=0)
    st.probe([1, 1, 1, 1], version=0)  # touch: 2s become LRU
    st.put([3, 3, 3, 3], _rows(4), version=0)
    assert len(st) == 2 and st.dropped == 1
    assert st.probe([2, 2, 2, 2], version=0) == (0, None)
    assert st.probe([1, 1, 1, 1], version=0)[0] == 4
    assert st.host_bytes == 2 * one


def test_nvme_spill_prefetch_and_reload(tmp_path):
    one = _rows(4)[0].nbytes
    st = GlobalPrefixStore(capacity_bytes=one, nvme_path=str(tmp_path))
    a = st.put([1, 1, 1, 1], _rows(4, 5), version=0)
    st.put([2, 2, 2, 2], _rows(4, 6), version=0)  # pushes `a` to NVMe
    assert st.spills == 1 and a.leaves is None and os.path.exists(a.spill_path)
    assert st.host_bytes == one and st.nvme_bytes == one
    st.prefetch(a)  # look-ahead read into a window slot
    st.prefetch(a)  # idempotent
    leaves = st.pop(a)
    assert torch.equal(leaves[0], _rows(4, 5)[0])  # bytes exact
    assert st.nvme_loads == 1 and st.nvme_bytes == 0
    assert st.io_stats()["prefetches_landed"] == 1
    assert not os.listdir(str(tmp_path))  # spill file reclaimed


def test_spilled_entry_drop_reclaims_file_and_inflight_read(tmp_path):
    one = _rows(4)[0].nbytes
    st = GlobalPrefixStore(capacity_bytes=one, nvme_path=str(tmp_path))
    st.put([1, 1, 1, 1], _rows(4), version=0)
    a = st.get_exact([1, 1, 1, 1])
    st.put([2, 2, 2, 2], _rows(4), version=0)
    st.prefetch(a)
    st.discard([1, 1, 1, 1])
    assert not os.listdir(str(tmp_path))
    # the window slot came back: two acquires must still succeed
    assert st._window.acquire() is not None and st._window.acquire() is not None


def test_pop_consume_false_keeps_longer_entry():
    """A partial restore must not destroy the longer cached entry."""
    st = GlobalPrefixStore(capacity_bytes=1 << 20)
    e = st.put(list(range(8)), _rows(8, 3), version=0)
    leaves = st.pop(e, consume=False)
    assert torch.equal(leaves[0], _rows(8, 3)[0])
    assert st.contains_exact(list(range(8)))  # still registered
    assert st.pop(e, consume=False) is not None  # restorable again
    assert st.pop(e) is not None  # consume drops it
    assert not st.contains_exact(list(range(8))) and st.restores == 3


def test_prefetch_reclaims_stranded_window_slot(tmp_path):
    """Advisory look-ahead reads never strand the AIO window: with a 1-slot
    window, a second prefetch reclaims the first unclaimed read."""
    one = _rows(4)[0].nbytes
    st = GlobalPrefixStore(capacity_bytes=one, nvme_path=str(tmp_path), nvme_window=1)
    a = st.put([1, 1, 1, 1], _rows(4, 1), version=0)
    b = st.put([2, 2, 2, 2], _rows(4, 2), version=0)  # spills a
    st.put([3, 3, 3, 3], _rows(4, 3), version=0)      # spills b
    assert st.spills == 2
    st.prefetch(a)
    assert a.eid in st._reads
    assert st._window.size == 1  # nvme_window honored (lazy build)
    st.prefetch(b)  # window saturated: a's unclaimed read is reclaimed
    assert b.eid in st._reads and a.eid not in st._reads
    assert torch.equal(st.pop(b)[0], _rows(4, 2)[0])
    assert torch.equal(st.pop(a)[0], _rows(4, 1)[0])  # the synchronous read still fine


def test_stale_version_probe_is_structural_error():
    st = GlobalPrefixStore(capacity_bytes=1 << 20)
    st.put([1, 2, 3, 4], _rows(4), version=0)
    with pytest.raises(ValueError, match="stale host-tier KV"):
        st.probe([1, 2, 3, 4], version=1)
    assert st.drop_version(0) == 4
    assert st.probe([1, 2, 3, 4], version=1) == (0, None)
    assert len(st) == 0 and st.host_bytes == 0


def test_contains_exact_and_stats():
    st = GlobalPrefixStore(capacity_bytes=1 << 20)
    st.put([5, 6, 7], _rows(3), version=0, origin=123)
    assert st.contains_exact([5, 6, 7])
    assert st.contains_exact([5, 6, 7], origin=123)
    assert not st.contains_exact([5, 6, 7], origin=999)
    assert not st.contains_exact([5, 6])
    s = st.stats()
    assert s["entries"] == 1 and s["tokens"] == 3 and s["demotes"] == 1
    st.clear()
    assert len(st) == 0 and st.tokens_resident() == 0


def test_spill_of_unaligned_entry_reads_back_with_a_write_pending(tmp_path):
    """An entry whose size is no multiple of 4096 spills through the
    aligned buffer (the bulk by O_DIRECT where the file system takes it,
    the tail buffered) and reads back exactly; a pop that finds the write
    still pending is served from the pending buffer, and an entry dropped
    while its write is in flight leaves no file."""
    gen = torch.Generator().manual_seed(3)
    big = [torch.randint(-128, 127, (1, 2, 1000, 7), generator=gen, dtype=torch.int8),
           torch.randn(1, 1, 1000, 1, generator=gen).half()]
    nbytes = sum(x.nbytes for x in big)
    assert nbytes % 4096
    st = GlobalPrefixStore(capacity_bytes=nbytes, nvme_path=str(tmp_path))
    a = st.put([1] * 5, [x.clone() for x in big], version=0)
    st.put([2] * 5, [x.clone() for x in big], version=0)  # spills a; the write lands in put
    io = st.io_stats()
    assert io["nvme_bytes_written"] == nbytes
    assert io["direct_write"] + io["buffered_write"] == nbytes
    got = st.pop(a)
    assert all(torch.equal(g, x) and g.dtype == x.dtype for g, x in zip(got, big))
    assert st.io_stats()["nvme_bytes_read"] == nbytes
    # a pending write: the pop reads the staged bytes, and the write that
    # lands after the drop removes its own file
    held = []
    write = st._write_spill
    st._write_spill = lambda victim, flat: held.append((victim, flat))  # hold the write back
    c = st.put([3] * 5, [x.clone() for x in big], version=0)  # spills [2]*5
    assert [v.key for v, _ in held] == [(2, ) * 5]
    victim, flat = held[0]
    assert victim.eid in st._pending_spill
    got = st.pop(victim)  # consumed while its write is pending
    assert all(torch.equal(g, x) for g, x in zip(got, big))
    write(victim, flat)  # the write lands after the drop
    assert os.listdir(str(tmp_path)) == []
    assert st.contains_exact([3] * 5) and c.leaves is not None


# ------------------------------------------------------------- differential


def _leaf_bits(rng, kind, n):
    """One leaf of ``n`` rows as (numpy for the JAX store, torch for the
    port), the same bits."""
    if kind == "bf16":
        bits = rng.integers(0, 1 << 16, (1, 2, n, 4), dtype=np.uint16)
        return bits.view(ml_dtypes.bfloat16), torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    if kind == "int8":
        a = rng.integers(-128, 128, (1, 2, n, 4)).astype(np.int8)
        return a, torch.from_numpy(a.copy())
    a = rng.standard_normal((1, 1, n, 1)).astype(np.float16)
    return a, torch.from_numpy(a.copy())


def _same_bytes(jax_leaves, port_leaves):
    assert len(jax_leaves) == len(port_leaves)
    for a, b in zip(jax_leaves, port_leaves):
        a = np.asarray(a)
        assert tuple(a.shape) == tuple(b.shape)
        assert a.tobytes() == b.contiguous().view(torch.uint8).numpy().tobytes()


def _state(st):
    with st._lock:
        return (st.stats(), sorted(st._by_key), sorted(k for k, e in st._by_key.items()
                                                      if e.spill_path is not None))


@pytest.mark.parametrize("nvme", [False, True], ids=["ram", "nvme"])
def test_differential_against_jax_store(tmp_path, nvme):
    rng = np.random.default_rng(19)
    kinds = ("bf16", "int8", "fp16")
    one_token = sum(_leaf_bits(rng, k, 1)[0].nbytes for k in kinds)
    cap = 40 * one_token  # a few entries of 4-16 tokens: constant pressure
    mk = (lambda sub: dict(nvme_path=str(tmp_path / sub))) if nvme else (lambda sub: {})
    js = JaxStore(capacity_bytes=cap, **mk("jax"))
    ps = GlobalPrefixStore(capacity_bytes=cap, **mk("port"))
    prefixes = [tuple(rng.integers(0, 4, 3)) for _ in range(3)]
    keys = []
    ops = {"put": 0, "probe": 0, "pop": 0, "discard": 0, "prefetch": 0}
    for step in range(160):
        op = rng.choice(["put", "put", "probe", "pop", "discard", "prefetch"])
        if op == "put" or not keys:
            n = int(rng.integers(4, 17))
            key = list(prefixes[rng.integers(0, 3)]) + [int(t) for t in rng.integers(0, 6, n - 3)]
            pairs = [_leaf_bits(rng, k, n) for k in kinds]
            origin = int(rng.integers(0, 2))
            ej = js.put(key, [a for a, _ in pairs], 0, origin=origin)
            ep = ps.put(key, [b for _, b in pairs], 0, origin=origin)
            assert ej.eid == ep.eid and ej.key == ep.key and ej.nbytes == ep.nbytes
            keys.append(key)
            op = "put"
        elif op in ("probe", "pop", "prefetch"):
            base = keys[rng.integers(0, len(keys))]
            cut = int(rng.integers(1, len(base) + 3))
            prompt = (base + [int(t) for t in rng.integers(0, 6, 3)])[:cut]
            mj, ej = js.probe(prompt, 0)
            mp, ep = ps.probe(prompt, 0)
            assert mj == mp, (step, prompt)
            assert (ej is None) == (ep is None) and (ej is None or ej.eid == ep.eid), step
            if ej is not None and op == "prefetch":
                js.prefetch(ej)
                ps.prefetch(ep)
            elif ej is not None and op == "pop":
                consume = bool(rng.integers(0, 2))
                _same_bytes(js.pop(ej, consume=consume), ps.pop(ep, consume=consume))
        else:
            key = keys[rng.integers(0, len(keys))]
            origin = None if rng.integers(0, 2) else int(rng.integers(0, 2))
            assert js.discard(key, origin=origin) == ps.discard(key, origin=origin)
        ops[op] += 1
        sj, sp = _state(js), _state(ps)
        assert sj == sp, (step, op, sj, sp)
    assert all(ops.values()), ops
    st = ps.stats()
    assert st["restores"] > 0 and (st["spills"] > 0 if nvme else st["dropped"] > 0), st
    for key in list(keys):
        ej, ep = js.get_exact(key), ps.get_exact(key)
        assert (ej is None) == (ep is None)
        if ej is not None:
            _same_bytes(js.pop(ej), ps.pop(ep))
    assert _state(js) == _state(ps)
    if nvme:
        assert sorted(os.listdir(str(tmp_path / "jax"))) == sorted(os.listdir(str(tmp_path / "port")))
