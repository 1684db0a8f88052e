"""The port's long-context serving (``inference/scheduler.py`` with
``max_extents > 1``, ``inference/kv_cache.py`` extent chains) against the
JAX package's, the port's counterparts of ``tests/unit/inference/
test_long_context.py``.

On ``tiny`` at fp32 through the flash path (the paged kernels' plain
versions here), ``max_len=32`` rounds up to the 64-row pool floor and the
128-token horizon caps ``max_extents=4`` at 2, as in JAX. Against the JAX
scheduler on the same numpy weights: a chained request's greedy tokens are
equal and its logits within 1e-4 of max|ref| (XLA and PyTorch sum in other
orders at fp32); the lossy window drops as many extents. Port against port,
bitwise, as the JAX tests assert for their own scheduler: a chained request
equals the same request on one 128-row slot (greedy and sampled, tokens and
logits), on the bf16 and on the int8 KV pool; seq-parallel wide chunks
equal base chunks. Plus the gates (lossy windows, spannable capacity,
config), the dead-row write collision planted on purpose, chain admission
evicting retained prefixes with the invariants held after every step, and
the slot pool's chain operations against JAX's ``SlotKVCache``."""

import functools

import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.models as jm
import deepspeed_tpu_torch
import deepspeed_tpu_torch.models as tm
from deepspeed_tpu.comm import comm
from deepspeed_tpu.inference.kv_cache import SlotKVCache as JaxSlots
from deepspeed_tpu.models.transformer import CausalLMModel as JaxModel
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu_torch.inference import scheduler as sched_mod
from deepspeed_tpu_torch.inference.kv_cache import SlotKVCache
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.transformer import CausalLMModel, TransformerConfig, span_targets

from .torch_port_helpers import numpy_params

PROMPT = [int(t) for t in np.resize(np.arange(3, 40), 100)]
LPROMPT = [int(t) for t in np.resize(np.arange(3, 40), 150)]
# the JAX test's 256-horizon tiny variant: chains reach 4 extents
LONG_KW = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
               max_seq_len=256, intermediate_size=128, attention_impl="flash", scan_layers=False,
               decode_block_kv=32)
SAMPLED = dict(temperature=0.8, top_k=20, seed=7, do_sample=True)


def _cfg(**cb):
    return {"dtype": "float32", "decode_block_kv": 32, "kernel_inject": True,
            "continuous_batching": {"enabled": True, "num_slots": 4, "collect_logits": True, **cb}}


@functools.lru_cache(maxsize=None)
def _tiny_tree():
    return numpy_params(jm.get_model("tiny", max_seq_len=128), seed=10)


@functools.lru_cache(maxsize=None)
def _long_tree():
    return numpy_params(JaxModel(JaxConfig(**LONG_KW)), seed=11)


def _port(long=False, **cb):
    if long:
        tmod, tree = CausalLMModel(TransformerConfig(**LONG_KW)), _long_tree()
    else:
        tmod, tree = tm.get_model("tiny", max_seq_len=128), _tiny_tree()
    return deepspeed_tpu_torch.init_inference(tmod, config=_cfg(**cb),
                                              params=params_from_jax(tree, tmod.cfg), device="cpu")


def _jax(long=False, **cb):
    from deepspeed_tpu.telemetry import set_sink
    comm._state["mesh"] = None
    set_sink(None)
    if long:
        model, tree = JaxModel(JaxConfig(**LONG_KW)), _long_tree()
    else:
        model, tree = jm.get_model("tiny", max_seq_len=128), _tiny_tree()
    return deepspeed_tpu.init_inference(model, config=_cfg(**cb), params=tree)


def _run(sched, prompt, **kw):
    h = sched.submit(prompt, max_new_tokens=24, **kw)
    return h.result(), h.result_logits()


@pytest.fixture(scope="module")
def jax_chained():
    """The JAX scheduler's chained request (its extent kernel in interpret
    mode): greedy tokens and logits."""
    s = _jax().scheduler(max_len=32, prefill_chunk=16, max_extents=4)
    assert s.cache.max_extents == 2
    return _run(s, PROMPT)


@pytest.fixture(scope="module")
def port_single():
    """The port's reference: the same requests on one 128-row slot."""
    s = _port().scheduler(max_len=128, prefill_chunk=16)
    return _run(s, PROMPT), _run(s, PROMPT, **SAMPLED)


# ---------------------------------------------------------------- chains


def test_chained_request_bit_identical_to_single_slot(jax_chained, port_single):
    """A request on a 2-extent chain (slot 64 rows, prompt 100 + 24 new)
    emits bitwise the tokens and logits of the same request on one 128-row
    slot, greedy and sampled; its greedy stream matches the JAX scheduler's;
    the chain frees with the request."""
    s = _port().scheduler(max_len=32, prefill_chunk=16, max_extents=4)
    assert s.max_len == 64 and s.cache.max_extents == 2 and s.cache.spannable_len == 128
    (tok, lg), (stok, slg) = _run(s, PROMPT), _run(s, PROMPT, **SAMPLED)
    (ref_tok, ref_lg), (ref_stok, ref_slg) = port_single
    np.testing.assert_array_equal(tok, ref_tok)
    np.testing.assert_array_equal(lg, ref_lg)
    np.testing.assert_array_equal(stok, ref_stok)
    np.testing.assert_array_equal(slg, ref_slg)
    jtok, jlg = jax_chained
    np.testing.assert_array_equal(tok, jtok)
    np.testing.assert_allclose(lg, jlg, rtol=0, atol=1e-4 * np.abs(jlg).max())
    assert s.cache.active_slots == 0 and not s.cache.chain
    s.cache.check_invariants()


def test_int8_kv_chain_bit_identical_to_single_slot():
    """The int8 KV pool: a chained request equals the same request on one
    128-row int8 slot, tokens and logits."""
    a = _run(_port().scheduler(max_len=32, prefill_chunk=16, max_extents=4,
                               kv_cache_dtype="int8"), PROMPT)
    b = _run(_port().scheduler(max_len=128, prefill_chunk=16, kv_cache_dtype="int8"), PROMPT)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_seq_parallel_chunks_bit_identical_to_base_chunks(port_single):
    """One device: prompts of >= 32 tokens prefill at the wide chunk width
    (degree 4 x 16 = 64 columns), unsharded: tokens and logits equal the
    base 16-column chunks', alone and over an extent chain; a short prompt
    keeps the base width."""
    s = _port().scheduler(max_len=128, prefill_chunk=16, seq_parallel_min_tokens=32,
                          seq_parallel_degree=4)
    assert s._seq_chunk == 64
    (ref_tok, ref_lg), (ref_stok, _) = port_single
    tok, lg = _run(s, PROMPT)
    np.testing.assert_array_equal(tok, ref_tok)
    np.testing.assert_array_equal(lg, ref_lg)
    assert (64, 1) in s.dispatched or (64, 4) in s.dispatched
    np.testing.assert_array_equal(_run(s, PROMPT, **SAMPLED)[0], ref_stok)
    s.dispatched.clear()
    s.submit(PROMPT[:20], max_new_tokens=4).result()
    assert all(c == 16 or c == 1 for c, _ in s.dispatched)
    chained = _port().scheduler(max_len=32, prefill_chunk=16, max_extents=4,
                                seq_parallel_min_tokens=32, seq_parallel_degree=4)
    np.testing.assert_array_equal(_run(chained, PROMPT)[0], ref_tok)


def test_dead_row_never_collides_with_a_chain_write():
    """The planted case: a 3-slot pool, a chain on rows [0, 1]; when the
    prefill's write head reaches logical 64 (offset 0 of extent 1, pool row
    1), row 1 is also a dead dispatch row. Dead rows write their span-0
    columns back with old bytes, so a dead row 1 writing its own pool row
    would collide with the chain's write. The operands give it a row no
    live row writes, the extent write targets are distinct (checked on the
    CPU), and the pool then holds, in every layer, bitwise the K/V of the
    same prompt on one 128-row slot."""
    eng = _port(num_slots=3)
    s = eng.scheduler(max_len=32, prefill_chunk=16, max_extents=4)
    h = s.submit(PROMPT, max_new_tokens=4)
    while s._prefill is None or s._prefill.pos < 64:
        s.step()
    assert s.cache.extents(0) == [0, 1] and s.cache.state[1] == "extent"
    pf = s._prefill
    eo = s._ext_operands([(0, pf.req)])
    ext, wslot, base = (t.tolist() for t in eo[:3])
    assert ext[0] == [0, 1] and wslot[0] == 1 and base[0] == 64
    assert sorted(wslot) == [0, 1, 2] and wslot[1] != 1  # dead row 1 redirected
    # the identity wslot of the pre-extent layout would collide: caught here
    ident = torch.tensor([1, 1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="two batch rows write one pool row"):
        span_targets(torch.tensor([64, 0, 0]), torch.tensor([16, 0, 0]), 16, 64, ident,
                     torch.tensor([64, 0, 0]))
    with pytest.raises(ValueError, match="leaves its extent"):
        span_targets(torch.tensor([60, 0, 0]), torch.tensor([16, 0, 0]), 16, 64, eo[1], eo[2])
    single = _port(num_slots=3).scheduler(max_len=128, prefill_chunk=16)
    hs = single.submit(PROMPT, max_new_tokens=4)
    np.testing.assert_array_equal(h.result(), hs.result())
    # finished rows are not scrubbed: the prompt's K/V stay in both pools
    for chained_leaf, big_leaf in zip((t for comp in s.cache.pool for t in comp),
                                      (t for comp in single.cache.pool for t in comp)):
        logical = torch.cat([chained_leaf[0], chained_leaf[1]], dim=1)  # extents 0, 1
        assert torch.equal(logical[:, :100], big_leaf[0, :, :100])


def test_chain_admission_evicts_retained_prefixes_invariants_hold():
    """Short requests leave retained prefixes in 3 of 4 slots; a long
    request then needs a 2-extent chain, evicts LRU prefixes for room, and
    the pool and radix invariants hold after every step; the chain's
    tokens equal a fresh scheduler's."""
    s = _port().scheduler(max_len=32, prefill_chunk=16, max_extents=4)
    for i in range(3):
        s.submit([5 + i, 6, 7, 8], max_new_tokens=4).result()
    assert s.cache.cached_slots == 3
    h = s.submit(PROMPT, max_new_tokens=8)
    while not h.done:
        s.step()
        s.radix.check_invariants()
    assert s.radix.evictions >= 1 and not s.cache.chain
    ref = _port().scheduler(max_len=32, prefill_chunk=16, max_extents=4)
    np.testing.assert_array_equal(h.result(), ref.submit(PROMPT, max_new_tokens=8).result())


def test_mixed_stream_k_invariant_with_chains():
    """Chained and single-extent requests in one stream: equal tokens at
    steps_per_sync 4 and 1 (K falls to 1 at extent boundaries)."""
    prompts = [PROMPT, [5, 6, 7], list(range(3, 40)), PROMPT[:70]]

    def serve(k):
        s = _port().scheduler(max_len=32, prefill_chunk=16, max_extents=4, steps_per_sync=k)
        hs = [s.submit(p, max_new_tokens=12) for p in prompts]
        out = [h.result().tolist() for h in hs]
        s.radix.check_invariants()
        assert not s.cache.chain
        return out

    assert serve(4) == serve(1)


# ---------------------------------------------------------------- gates


def test_lossless_demote_requires_kv_tier(port_single):
    """Without the hierarchical tier there is nowhere to park a lossless
    extent: demote_cold_extents refuses (naming the config section that
    turns the tier on) and leaves the row intact."""
    s = _port().scheduler(max_len=32, prefill_chunk=16, max_extents=4)
    h = s.submit(PROMPT, max_new_tokens=24)
    while not s.active:
        s.step()
    slot = next(iter(s.active))
    while int(s.cache.lengths[slot]) < 65:
        s.step()
    with pytest.raises(ValueError, match="hierarchical_kv"):
        s.demote_cold_extents(slot, keep_recent=0)
    np.testing.assert_array_equal(h.result(), port_single[0][0])


def test_lossy_window_gated_drops_and_not_identical():
    """kv_window is refused unless allow_lossy_kv; enabled, extents that
    slide out of the window drop as the JAX scheduler drops them (the same
    count), their rows return to the pool, and the stream is not the exact
    one (the mode is approximate by design)."""
    s = _port(long=True).scheduler(max_len=64, prefill_chunk=16, max_extents=4)
    with pytest.raises(ValueError, match="allow_lossy_kv"):
        s.submit(LPROMPT, max_new_tokens=8, kv_window=(4, 16))
    with pytest.raises(ValueError, match="kv_window must be"):
        _port(long=True).scheduler(max_len=64, prefill_chunk=16, max_extents=4,
                                   allow_lossy_kv=True).submit(LPROMPT, kv_window=(4, 0))
    exact = _run(_port(long=True).scheduler(max_len=64, prefill_chunk=16, max_extents=4), LPROMPT)
    lossy = _port(long=True).scheduler(max_len=64, prefill_chunk=16, max_extents=4,
                                       allow_lossy_kv=True)
    tok, lg = _run(lossy, LPROMPT, kv_window=(4, 16))
    assert len(tok) == 24
    assert not (np.array_equal(tok, exact[0]) and np.array_equal(lg, exact[1]))
    assert lossy.longctx_demotes >= 1 and lossy.longctx_restores == 0
    assert lossy.cache.free_slots == 4 and not lossy.cache.chain
    js = _jax(long=True).scheduler(max_len=64, prefill_chunk=16, max_extents=4,
                                   allow_lossy_kv=True)
    jtok = js.submit(LPROMPT, max_new_tokens=24, kv_window=(4, 16)).result()
    assert lossy.longctx_demotes == js.longctx_demotes
    assert len(jtok) == 24


def test_lossy_demote_frees_rows_mid_stream():
    """demote_cold_extents on a lossy row drops its cold extents at once
    (extent 0 and the write extent stay), freeing their pool rows."""
    s = _port(long=True).scheduler(max_len=64, prefill_chunk=16, max_extents=4,
                                   allow_lossy_kv=True)
    h = s.submit(LPROMPT, max_new_tokens=24, kv_window=(4, 200))
    while not s.active:
        s.step()
    slot = next(iter(s.active))
    free = s.cache.free_slots
    n = s.demote_cold_extents(slot)
    assert n >= 1 and s.cache.free_slots == free + n
    assert s.cache.missing_extents(slot) and s.cache.extents(slot)[0] == slot
    s.cache.check_invariants()
    assert len(h.result()) == 24 and not s.cache.chain


def test_submit_rejects_beyond_spannable_capacity():
    s = _port().scheduler(max_len=32, prefill_chunk=16, max_extents=4)
    cap = s.cache.spannable_len
    with pytest.raises(ValueError, match="per-slot KV capacity"):
        s.submit(list(range(1, cap + 2)), max_new_tokens=1)
    with pytest.raises(ValueError, match="extent"):
        s.submit([1] * (cap - 1), max_new_tokens=8)
    assert s.cache.total_allocs == 0 and not s.queue


def test_config_validation():
    """Extents and seq-parallel prefill need chunked prefill; the
    long-context machinery needs the flash paged path."""
    eng = _port()
    with pytest.raises(ValueError, match="prefill_chunk"):
        sched_mod.DecodeScheduler(eng, prefill_chunk=0, max_extents=4)
    with pytest.raises(ValueError, match="prefill_chunk"):
        sched_mod.DecodeScheduler(eng, prefill_chunk=0, seq_parallel_min_tokens=32)
    xcfg = TransformerConfig(**{**LONG_KW, "attention_impl": "xla"})
    xeng = deepspeed_tpu_torch.init_inference(
        CausalLMModel(xcfg), config={"dtype": "float32",
                                     "continuous_batching": {"enabled": True, "num_slots": 4}},
        device="cpu")
    with pytest.raises(ValueError, match="flash"):
        xeng.scheduler(max_len=64, prefill_chunk=16, max_extents=4)


def test_long_context_config_section_threads_to_scheduler():
    eng = _port(long_context={"max_extents": 4, "seq_parallel_min_tokens": 0,
                              "allow_lossy_kv": True})
    s = eng.scheduler(max_len=32, prefill_chunk=16)
    assert s.cache.max_extents == 2  # horizon-capped from the configured 4
    assert s.allow_lossy_kv and s.seq_parallel_min_tokens == 0
    np.testing.assert_array_equal(s.submit(PROMPT, max_new_tokens=4).result().shape, (4, ))


def test_ext_ops_outside_the_flash_span_path_raise():
    """The JAX trace-time error: extent operands on the plain attention
    path, or without per-row write indices, would read the wrong rows."""
    model = CausalLMModel(TransformerConfig(**{**LONG_KW, "attention_impl": "xla"}))
    params = model.init_params(seed=0)
    pool = model.init_cache(2, 64)
    z = torch.zeros(2, dtype=torch.int32)
    ext_ops = (torch.zeros((2, 1), dtype=torch.int32), z, z, z, z)
    with pytest.raises(ValueError, match="flash span path"):
        model.apply_with_cache(params, torch.zeros((2, 1), dtype=torch.long), pool, 0,
                               position_ids=torch.zeros((2, 1), dtype=torch.long), write_index=z,
                               q_spans=z + 1, ext_ops=ext_ops)
    flash = CausalLMModel(TransformerConfig(**LONG_KW))
    with pytest.raises(ValueError, match="flash span path"):
        flash.apply_with_cache(params, torch.zeros((2, 1), dtype=torch.long), pool, 0,
                               ext_ops=ext_ops)
    with pytest.raises(ValueError, match="flash span path"):
        flash.apply_with_cache(params, torch.zeros((2, 1), dtype=torch.long), pool, 0,
                               seq_shard=True)


# ---------------------------------------------------------------- slot pool


def _same(jkv, tkv):
    assert tkv.state == jkv.state
    assert tkv.chain == jkv.chain
    np.testing.assert_array_equal(tkv.lengths, jkv.lengths)
    assert tkv._free == jkv._free
    assert (tkv.total_allocs, tkv.total_frees) == (jkv.total_allocs, jkv.total_frees)
    assert (tkv.extent_slots, tkv.free_slots, tkv.active_slots) == \
        (jkv.extent_slots, jkv.free_slots, jkv.active_slots)
    jkv.check_invariants()
    tkv.check_invariants()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_operation_storm_matches_jax(seed):
    """300 random operations over a 7-row pool of 4-extent chains: alloc,
    alloc_chain, demote_extent, restore_extent, free (chains torn down
    whole), retain and reclaim (refused on a chain); the state equals JAX's
    after every one."""
    rng = np.random.default_rng(seed)
    jkv, tkv = JaxSlots(None, 7, 16, max_extents=4), SlotKVCache(None, 7, 16, max_extents=4)
    for _ in range(300):
        op = int(rng.integers(0, 7))
        active = [i for i, s in enumerate(tkv.state) if s == "active"]
        chained = sorted(tkv.chain)
        if op == 0:
            n = int(rng.integers(1, 6))  # 5: beyond max_extents, refused
            assert tkv.alloc_chain(n, owner=1) == jkv.alloc_chain(n, owner=1)
        elif op == 1 and active:
            slot = active[int(rng.integers(0, len(active)))]
            cap = tkv.extent_capacity(slot)
            assert cap == jkv.extent_capacity(slot)
            n = int(rng.integers(0, cap + 1))
            tkv.lengths[slot] = jkv.lengths[slot] = n
        elif op == 2 and chained:
            slot = chained[int(rng.integers(0, len(chained)))]
            idx = int(rng.integers(0, len(tkv.extents(slot)) + 1))
            try:
                want = jkv.demote_extent(slot, idx)
            except ValueError:
                with pytest.raises(ValueError):
                    tkv.demote_extent(slot, idx)
            else:
                assert tkv.demote_extent(slot, idx) == want
        elif op == 3 and chained:
            slot = chained[int(rng.integers(0, len(chained)))]
            assert tkv.missing_extents(slot) == jkv.missing_extents(slot)
            for idx in tkv.missing_extents(slot)[:1]:
                assert tkv.restore_extent(slot, idx) == jkv.restore_extent(slot, idx)
        elif op == 4 and active:
            slot = active[int(rng.integers(0, len(active)))]
            for kv in (jkv, tkv):
                kv.free(slot)
        elif op == 5 and active:  # retain: refused on a chain; reclaim after
            slot = active[int(rng.integers(0, len(active)))]
            for kv in (jkv, tkv):
                kv.refs[slot] = 1
                if slot in kv.chain:
                    with pytest.raises(ValueError, match="multi-extent"):
                        kv.retain(slot)
                    kv.refs[slot] = 0
                else:
                    kv.retain(slot)
                    kv.refs[slot] = 0
                    kv.reclaim(slot)
        elif op == 6:
            n = int(rng.integers(0, 80))
            assert tkv.extents_needed(n) == jkv.extents_needed(n)
        assert tkv.spannable_len == jkv.spannable_len == 64
        _same(jkv, tkv)
    for slot in sorted(tkv.chain):
        for kv in (jkv, tkv):
            kv.free(slot)
    _same(jkv, tkv)
    assert tkv.extent_slots == 0 and not tkv.chain


def test_extents_needed_and_capacity_match_jax():
    jkv, tkv = JaxSlots(None, 4, 64, max_extents=3), SlotKVCache(None, 4, 64, max_extents=3)
    for n in (0, 1, 63, 64, 65, 128, 129, 192, 500):
        assert tkv.extents_needed(n) == jkv.extents_needed(n)
    for kv in (jkv, tkv):
        assert kv.fits(100, 92) and not kv.fits(100, 93)
    p = tkv.alloc_chain(3, owner=0)
    assert p == jkv.alloc_chain(3, owner=0) == 0
    assert tkv.extents(p) == jkv.extents(p) == [0, 1, 2] and tkv.extent_capacity(p) == 192
    assert tkv.extents(3) == [3]
    _same(jkv, tkv)
