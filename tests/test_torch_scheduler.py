"""The port's continuous-batching scheduler (``inference/scheduler.py``).

Against the JAX package's scheduler, on the same weights (``params_from_jax``
of one numpy tree): greedy streams for mixed-length prompts (one and several
prefill chunks) on ``tiny`` at fp32 through the per-projection
``apply_with_cache`` path, and on ``tiny-gpt2`` int8 with kernel injection
through the fused path (``fused_paged_step``). The port's kernels run as
their plain versions here (CPU).

Port against port, bitwise, as the JAX package's ``test_scheduler.py``
asserts for its own scheduler: scheduler == ``generate()``, slot reuse,
``steps_per_sync`` 1 == 3, radix hit == cold prefill, decode advancing
during a chunked prefill, EOS eviction, cancellation, rejection of a
request too long, reproducible and slot-independent sampling; the set of
(chunk width, K) shapes dispatched over a mixed-length stream stays within
2 x 2 (the JAX "O(1) compiled programs" guard); and the int8 KV tier within
the JAX bound of ``test_int8_kv_logit_error_bound_vs_bf16`` against the
port's own full-precision pool. Each test states its tolerance."""

import functools

import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.models as jm
import deepspeed_tpu_torch
import deepspeed_tpu_torch.models as tm
from deepspeed_tpu.comm import comm
from deepspeed_tpu_torch.inference import scheduler as sched_mod
from deepspeed_tpu_torch.inference.scheduler import sample_rows, sample_uniforms
from deepspeed_tpu_torch.models.convert import params_from_jax

from .torch_port_helpers import numpy_params

PROMPTS = [[5, 6, 7, 8, 9], [10, 11, 12]]
LONG = [int(t) for t in np.resize(np.arange(3, 40), 100)]  # two 64-token chunks
SEVENTY = [int(t) for t in np.resize(np.arange(5, 47), 70)]
MIXED = PROMPTS + [LONG, SEVENTY]


@functools.lru_cache(maxsize=None)
def _tree(name, max_seq_len):
    return numpy_params(jm.get_model(name, max_seq_len=max_seq_len), seed=10)


def _cb(num_slots, collect_logits=False):
    return {"enabled": True, "num_slots": num_slots, "collect_logits": collect_logits}


def _port(name="tiny", max_seq_len=128, num_slots=4, collect_logits=False, **cfg):
    """A port engine on the CPU with the continuous-batching section."""
    tmod = tm.get_model(name, max_seq_len=max_seq_len)
    config = {"dtype": "float32", "continuous_batching": _cb(num_slots, collect_logits), **cfg}
    return deepspeed_tpu_torch.init_inference(tmod, config=config,
                                              params=params_from_jax(_tree(name, max_seq_len), tmod.cfg),
                                              device="cpu")


def _jax(name="tiny", max_seq_len=128, num_slots=4, collect_logits=False, **cfg):
    from deepspeed_tpu.telemetry import set_sink
    comm._state["mesh"] = None
    set_sink(None)
    config = {"dtype": "float32", "continuous_batching": _cb(num_slots, collect_logits), **cfg}
    return deepspeed_tpu.init_inference(jm.get_model(name, max_seq_len=max_seq_len), config=config,
                                        params=_tree(name, max_seq_len))


def _serve(eng, prompts, max_new=8, logits=False, **sched_kw):
    sched = eng.scheduler(**sched_kw)
    hs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    if logits:
        return [h.result_logits() for h in hs]
    return [h.result().tolist() for h in hs]


# ---------------------------------------------------------------- against JAX


def test_fp32_streams_and_logits_match_jax():
    """tiny at fp32, per-projection path, mixed prompts of 3 to 100 tokens
    (two chunks) in 4 slots: tokens equal; per-step logits within 1e-4 of
    max|ref| (XLA and PyTorch sum in other orders at fp32)."""
    je, te = _jax(collect_logits=True), _port(collect_logits=True)
    jl, tl = _serve(je, MIXED, logits=True), _serve(te, MIXED, logits=True)
    for j, t in zip(jl, tl):
        assert j.shape == t.shape
        np.testing.assert_array_equal(j.argmax(-1), t.argmax(-1))
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-4 * np.abs(j).max())
    assert not te.scheduler()._fused_block


def test_int8_fused_streams_match_jax(monkeypatch):
    """tiny-gpt2 int8 with kernel injection: both schedulers step through
    the fused decode-layer kernels. Tolerance as in
    test_torch_engine_fused.py: bf16 rounds at other places in XLA and
    PyTorch, so a greedy choice between close logits may flip and a stream
    part for good; the rows' common prefixes cover at least half of the
    generated tokens and at least one row agrees in full."""
    cfg = {"dtype": "int8", "kernel_inject": True, "max_out_tokens": 512}
    je = _jax("tiny-gpt2", 512, **cfg)
    te = _port("tiny-gpt2", 512, **cfg)
    assert je.scheduler()._fused_block and te.scheduler()._fused_block
    calls = []
    real = te.module.fused_paged_step
    monkeypatch.setattr(te.module, "fused_paged_step", lambda *a, **k: calls.append(1) or real(*a, **k))
    jo, to = _serve(je, MIXED), _serve(te, MIXED)
    assert len(calls) == sum(te.scheduler().forwards.values()) > 0
    prefix = [next((i for i, (a, b) in enumerate(zip(j, t)) if a != b), len(j)) for j, t in zip(jo, to)]
    assert sum(prefix) >= sum(len(j) for j in jo) / 2, (jo, to)
    assert max(prefix) == len(jo[0]), (jo, to)


def test_seq_parallel_wide_chunks_go_per_projection(monkeypatch):
    """With the fused decode block on (tiny-gpt2 int8), a wide seq-parallel
    chunk goes per projection on one rank too, as it must where a seq axis
    of ranks splits it, so one rank and many give one stream; the decode
    rows and the base chunks stay fused."""
    te = _port("tiny-gpt2", 512, dtype="int8", kernel_inject=True, max_out_tokens=512)
    sched = te.scheduler(prefill_chunk=16, seq_parallel_min_tokens=32, seq_parallel_degree=4)
    assert sched._fused_block and sched._seq_shards == 1 and sched._seq_chunk == 64
    fused, per_projection = [], []
    real_fused, real_plain = te.module.fused_paged_step, te.module.apply_with_cache
    monkeypatch.setattr(te.module, "fused_paged_step",
                        lambda tree, ids, *a, **k: fused.append(ids.shape[1]) or real_fused(tree, ids, *a, **k))
    monkeypatch.setattr(te.module, "apply_with_cache", lambda p, ids, *a, **k: per_projection.append(
        (ids.shape[1], k["seq_shard"])) or real_plain(p, ids, *a, **k))
    for h in [sched.submit(p, max_new_tokens=4) for p in (LONG, PROMPTS[0])]:
        h.result()
    assert per_projection == [(64, False)] * 2, per_projection  # LONG's two wide chunks, unsharded
    assert fused and 64 not in fused and 16 in fused, fused


# ---------------------------------------------------------------- port vs port


def test_scheduler_matches_generate():
    """Mixed-length greedy requests through the scheduler == generate(),
    and engine.submit() routes through the scheduler."""
    eng = _port()
    want = [r.tolist() for r in eng.generate(PROMPTS, max_new_tokens=8)]
    assert _serve(eng, PROMPTS) == want
    h = eng.submit(PROMPTS, max_new_tokens=8)
    assert [r.tolist() for r in h.result()] == want and h.done
    assert eng.scheduler().cache.total_allocs == 2 * len(PROMPTS)


def test_paged_kernel_path_matches_plain_slot_path():
    """attention_impl flash (the paged decode and span kernels' plain
    versions) == xla (plain cached attention) through a multi-chunk
    prefill: the same tokens at fp32."""
    assert _serve(_port(kernel_inject=True), MIXED) == _serve(_port(), MIXED)


def test_slot_reuse_bit_identical_logits():
    """A request run solo and again late in a busy stream, on a reused
    slot: bitwise-equal per-step logits."""
    eng = _port(num_slots=2, collect_logits=True)
    sched = eng.scheduler()
    solo = sched.submit(PROMPTS[0], max_new_tokens=6)
    solo_logits = solo.result_logits()
    filler = [sched.submit(PROMPTS[1], max_new_tokens=7) for _ in range(3)]
    again = sched.submit(PROMPTS[0], max_new_tokens=6)
    again_logits = again.result_logits()
    for h in filler:
        h.result()
    np.testing.assert_array_equal(solo_logits, again_logits)
    assert (solo.result() == again.result()).all()


def test_steps_per_sync_invariant():
    """K=1 and K=3 (budget not a multiple of K): identical greedy and
    seeded sampled tokens, the greedy stream equal to generate()'s."""
    outs = []
    for k in (1, 3):
        eng = _port(num_slots=2)
        sched = eng.scheduler(steps_per_sync=k)
        hs = [sched.submit(PROMPTS[0], max_new_tokens=8),
              sched.submit(PROMPTS[1], max_new_tokens=7, do_sample=True, temperature=0.8,
                           top_k=15, seed=7)]
        outs.append([h.result() for h in hs])
    (g1, s1), (g3, s3) = outs
    assert (g1 == eng.generate(PROMPTS[:1], max_new_tokens=8)[0]).all() and (g1 == g3).all()
    assert (s1 == s3).all() and len(s1) == 7


def test_prefix_cache_hit_bit_identical_logits(monkeypatch):
    """A 70-token prompt served through a radix hit (64 rows copied from
    the donor slot, the suffix chunk-prefilled) gives bitwise the logits of
    the same prompt cold on a scheduler without the prefix cache."""
    copies = []
    real = sched_mod.copy_slot
    monkeypatch.setattr(sched_mod, "copy_slot", lambda *a: copies.append(a[1:]) or real(*a))
    cold = _serve(_port(collect_logits=True), [SEVENTY], max_new=6, logits=True, prefix_cache=False)[0]
    eng = _port(collect_logits=True)
    sched = eng.scheduler()
    first = sched.submit(SEVENTY, max_new_tokens=6).result_logits()
    hit = sched.submit(SEVENTY, max_new_tokens=6).result_logits()
    assert sched.radix.misses == 1 and sched.radix.hits == 1 and copies == [(0, 1)]
    np.testing.assert_array_equal(cold, first)
    np.testing.assert_array_equal(cold, hit)
    sched.radix.check_invariants()


def test_prefix_cache_single_slot_and_spared_donor(monkeypatch):
    """One slot: the re-submitted prompt reclaims the cached donor itself,
    whose rows stay resident (no copy). Two slots: eviction for admission
    spares the matched donor and evicts the other cached slot."""
    copies = []
    real = sched_mod.copy_slot
    monkeypatch.setattr(sched_mod, "copy_slot", lambda *a: copies.append(a[1:]) or real(*a))
    sched = _port(num_slots=1).scheduler()
    first = sched.submit(SEVENTY, max_new_tokens=6).result()
    again = sched.submit(SEVENTY, max_new_tokens=6).result()
    assert (sched.radix.hits, sched.radix.misses, sched.radix.evictions) == (1, 1, 1)
    assert copies == [] and (first == again).all()
    assert sched.cache.cached_tokens() == len(SEVENTY)
    pb = [int(t) for t in np.resize(np.arange(90, 140), 70)]
    sched = _port(num_slots=2).scheduler()
    sched.submit(SEVENTY, max_new_tokens=3).result()
    sched.submit(pb, max_new_tokens=3).result()
    out = sched.submit(SEVENTY, max_new_tokens=3).result()
    assert sched.radix.hits == 1 and sched.radix.evictions == 1 and copies == [(0, 1)]
    assert (out == sched.submit(SEVENTY, max_new_tokens=3).result()).all()
    sched.radix.check_invariants()


def test_retained_slot_is_byte_stable_while_dead():
    """A retained prefix slot rides every later sync as a dead row (span 0,
    length 0): its pool rows keep their bytes, so a later hit is exact."""
    sched = _port(num_slots=3, kernel_inject=True).scheduler()
    sched.submit(SEVENTY, max_new_tokens=4).result()
    assert sched.cache.state[0] == "cached"
    snap = [t[0].clone() for comp in sched.cache.pool for t in comp]
    hs = [sched.submit(LONG, max_new_tokens=8), sched.submit(PROMPTS[0], max_new_tokens=8)]
    for h in hs:
        h.result()
    assert all(torch.equal(t[0], s) for t, s in zip((t for comp in sched.cache.pool for t in comp), snap))


def test_decode_advances_during_chunked_prefill():
    """While a 100-token prompt chunk-prefills (chunk 16), a live decode
    row advances every sync (at most K tokens a sync) and its stream stays
    bitwise equal to an idle-pool run."""
    eng = _port(num_slots=2)
    sched = eng.scheduler(prefill_chunk=16)
    solo = sched.submit(PROMPTS[0], max_new_tokens=10).result()
    a = sched.submit(PROMPTS[0], max_new_tokens=10)
    sched.step()
    b = sched.submit(LONG, max_new_tokens=4)
    sched.step()
    assert sched._prefill is not None
    n_before = len(a._req.out)
    sched.step()
    assert n_before < len(a._req.out) <= n_before + sched.steps_per_sync
    assert sched._prefill is not None and sched.last_shape == (16, sched.steps_per_sync)
    assert (a.result() == solo).all() and len(b.result()) == 4
    sched.radix.check_invariants()


def test_chunk_width_does_not_change_tokens():
    """The 100-token prompt through chunks of 16 (7 chunks) and of 64 (2
    chunks): the same greedy tokens at fp32."""
    assert _serve(_port(), [LONG], prefill_chunk=16) == _serve(_port(), [LONG])


def test_eos_evicts_mid_loop():
    """Rows finishing at different steps (EOS, length budget, full run)
    evict at once; queued requests take their slots, streams unchanged."""
    eng = _port(num_slots=2)
    out = eng.generate(PROMPTS, max_new_tokens=8)
    sched = eng.scheduler()
    eos0 = int(out[0][0])
    hs = [sched.submit(PROMPTS[0], max_new_tokens=8, eos_token_id=eos0),
          sched.submit(PROMPTS[1], max_new_tokens=3),
          sched.submit(PROMPTS[1], max_new_tokens=8),
          sched.submit(PROMPTS[0], max_new_tokens=8, eos_token_id=int(out[1][0]))]
    r0 = hs[0].result()
    assert r0.tolist() == [eos0]
    assert (hs[1].result() == out[1][:3]).all()
    assert (hs[2].result() == out[1]).all() and (hs[3].result() == out[0]).all()
    assert sched.cache.active_slots == 0 and sched.cache.total_frees == 4 and sched.evicted == 4


def test_cancelled_handles_free_slots():
    """Dropping an unfinished batch handle flags its requests; the next
    iteration evicts them and their slots serve the queue."""
    eng = _port(num_slots=2)
    out = eng.generate(PROMPTS[:1], max_new_tokens=8)[0]
    sched = eng.scheduler()
    abandoned = eng.submit(PROMPTS, max_new_tokens=64)
    sched.step()
    sched.step()
    assert sched.cache.active_slots == 2
    del abandoned
    import gc
    gc.collect()
    assert sched.cache.active_slots == 2  # nothing mutated from GC
    assert (sched.submit(PROMPTS[0], max_new_tokens=8).result() == out).all()
    assert sched.cache.active_slots == 0 and not sched.queue


def test_rejections_and_edge_budgets():
    """A request too long for a slot is rejected at submit; a zero budget
    returns no tokens and takes no slot; negative seeds are masked to
    32 bits and reproducible."""
    sched = _port().scheduler()
    with pytest.raises(ValueError, match="cache rows"):
        sched.submit(list(range(1, 100)), max_new_tokens=sched.max_len)
    with pytest.raises(ValueError, match="per-slot KV capacity"):
        sched.submit(list(range(1, 200)), max_new_tokens=1)
    h = sched.submit(PROMPTS[0], max_new_tokens=0)
    assert h.done and len(h.result()) == 0 and sched.cache.total_allocs == 0
    a = sched.submit(PROMPTS[0], max_new_tokens=5, do_sample=True, seed=-3).result()
    b = sched.submit(PROMPTS[0], max_new_tokens=5, do_sample=True, seed=-3).result()
    assert (a == b).all() and len(a) == 5 and sched.cache.active_slots == 0


def test_sampling_reproducible_and_slot_independent():
    """A sampled request re-submitted into a busy pool (another slot, other
    rows beside it) repeats its tokens; greedy and sampled rows share a step."""
    sched = _port(num_slots=3).scheduler()
    kw = dict(max_new_tokens=6, do_sample=True, temperature=0.7, top_k=20, top_p=0.9, seed=11)
    a = sched.submit(PROMPTS[0], **kw)
    a_out = a.result()
    filler = [sched.submit(PROMPTS[1], max_new_tokens=5) for _ in range(2)]
    b = sched.submit(PROMPTS[0], **kw)
    b_out = b.result()
    for h in filler:
        h.result()
    assert (a_out == b_out).all() and a._req.slot != b._req.slot


def test_dispatched_shapes_bounded_on_mixed_stream():
    """The JAX O(1)-programs guard: a mixed-length stream dispatches at
    most the (chunk, K), (chunk, 1) and (1, K) step shapes, within 2 x 2,
    and the nested-range prompts land radix hits."""
    sched = _port(num_slots=3).scheduler()
    lens = [2, 3, 5, 9, 17, 33, 40, 50, 63, 64, 65, 70, 90, 100]
    hs = [sched.submit(list(range(1, n + 1)), max_new_tokens=4) for n in lens]
    assert all(len(h.result()) == 4 for h in hs)
    C, K = sched.prefill_chunk, sched.steps_per_sync
    assert set(sched.dispatched) <= {(C, K), (C, 1), (1, K)}
    assert len({c for c, _ in sched.dispatched}) <= 2 and len({k for _, k in sched.dispatched}) <= 2
    assert sched.radix.hits > 0 and sched.admitted == len(lens)


def test_on_token_streams_in_delivery_order():
    seen = []
    sched = _port().scheduler()
    out = sched.submit(PROMPTS[0], max_new_tokens=6,
                       on_token=lambda tok, done: seen.append((tok, done))).result()
    assert [t for t, _ in seen] == out.tolist() and [d for _, d in seen] == [False] * 5 + [True]


@pytest.mark.parametrize("kernel_inject", [False, True])
@pytest.mark.parametrize("weights", ["init", "wide"])
def test_int8_kv_logit_error_bound(kernel_inject, weights):
    """The int8 KV tier: >= 1.9x the rows of a bf16 pool per byte, and
    per-step logits within 0.05 * max|ref| + 0.05 of the full-precision
    pool's (the JAX test's bound), through the plain cached attention (xla)
    and the paged kernels' plain versions. ``init``: the model's own random
    init (std 0.02), the JAX test's weights; the greedy argmax survives every
    step. ``wide``: the std-0.3 test weights, whose larger activations make
    quantization flip a close greedy choice after a few steps; the bound is
    held on every step up to and including the first flip (after it the two
    streams feed different tokens, so their logits no longer answer the
    same input)."""
    def engine(collect):
        cfg = {"dtype": "float32", "kernel_inject": kernel_inject,
               "continuous_batching": _cb(4, collect)}
        if weights == "wide":
            return _port(collect_logits=collect, kernel_inject=kernel_inject)
        return deepspeed_tpu_torch.init_inference("tiny", config=cfg, device="cpu")

    ref = _serve(engine(True), [SEVENTY], max_new=12, logits=True)[0]
    s_b = engine(False).scheduler(kv_cache_dtype="bf16")
    s_q = engine(True).scheduler(kv_cache_dtype="int8")
    assert s_q.kv_quantized and not s_b.kv_quantized
    assert s_b.cache.bytes_per_token() / s_q.cache.bytes_per_token() >= 1.9
    q = s_q.submit(SEVENTY, max_new_tokens=12).result_logits()
    same = q.argmax(-1) == ref.argmax(-1)
    n = len(same) if same.all() else int(np.argmin(same)) + 1
    if weights == "init":
        assert same.all()
    assert n >= 3
    assert np.abs(q[:n] - ref[:n]).max() <= 0.05 * np.abs(ref[:n]).max() + 0.05
    s_q.radix.check_invariants()


def test_sampler_is_pinned_and_filters():
    """The counter-based draws are a pure function of (seed, step, vocab
    index), pinned here; the same integers come out on the card
    (tests/test_torch_kernels_cuda.py). Greedy rows and top_k=1 take the
    argmax; sampled frequencies follow softmax(logits / T)."""
    u = sample_uniforms(torch.tensor([0, 7, 4294967295]), torch.tensor([0, 3, 1]), 4)
    h = (u * 4294967296.0 - 0.5).long()
    assert h.tolist() == PINNED_HASHES, h.tolist()
    assert float(u.min()) > 0 and float(u.max()) < 1
    V = 6
    logits = torch.tensor([[0.0, 1.0, 2.0, 0.5, -1.0, 1.5]]).repeat(4000, 1)
    n = logits.shape[0]
    seeds, steps = torch.arange(n, dtype=torch.int64), torch.full((n, ), 5, dtype=torch.int64)
    one = lambda x, dt: torch.full((n, ), x, dtype=dt)  # noqa: E731
    greedy = sample_rows(logits, seeds, steps, one(False, torch.bool), one(1.0, torch.float32),
                         one(0, torch.int64), one(1.0, torch.float32))
    assert (greedy == 2).all()
    top1 = sample_rows(logits, seeds, steps, one(True, torch.bool), one(1.0, torch.float32),
                       one(1, torch.int64), one(1.0, torch.float32))
    assert (top1 == 2).all()
    drawn = sample_rows(logits, seeds, steps, one(True, torch.bool), one(1.0, torch.float32),
                        one(0, torch.int64), one(1.0, torch.float32))
    freq = torch.bincount(drawn, minlength=V).double() / n
    assert float((freq - torch.softmax(logits[0].double(), -1)).abs().max()) < 0.03
    again = sample_rows(logits, seeds, steps, one(True, torch.bool), one(1.0, torch.float32),
                        one(0, torch.int64), one(1.0, torch.float32))
    assert torch.equal(drawn, again)


# murmur3's finalizer over (seed, step, vocab index) in Python integers, for
# (seed, step) = (0, 0), (7, 3), (2^32 - 1, 1) and vocab 0..3
PINNED_HASHES = [[3170179127, 4179371476, 682839416, 3842603924],
                 [2458415211, 3292343723, 2303589594, 112752157],
                 [3781425344, 550142869, 2180557092, 1231045053]]


def test_unported_features_raise():
    """Each unported feature raises naming its ROADMAP item; the
    seq-parallel prefill off the flash span path raises the JAX model's
    ``ValueError``. Speculative decoding (with or without extent chains), the
    monolithic prefill and the hierarchical KV tier are ported: they build,
    from the constructor and from the config, and lossless extent demotion
    without the tier refuses (as in JAX) naming the config section, not a
    ROADMAP item."""
    eng = _port()
    for kw in ({"spec_tokens": 2}, {"prefill_chunk": 0}):
        assert sched_mod.DecodeScheduler(eng, **kw) is not None
    chained = sched_mod.DecodeScheduler(_port(kernel_inject=True), max_len=32, prefill_chunk=16,
                                        spec_tokens=2, max_extents=2)
    assert chained.drafter is not None and chained.cache.max_extents == 2
    with pytest.raises(ValueError, match="flash span path"):
        eng.module.apply_with_cache(eng.net, torch.zeros((1, 1), dtype=torch.long),
                                    eng.module.init_cache(1, 64), 0, seq_shard=True)
    flash = _port(kernel_inject=True).scheduler(max_len=32, prefill_chunk=16, max_extents=2)
    h = flash.submit(LONG, max_new_tokens=8)
    while not flash.active:
        flash.step()
    with pytest.raises(ValueError, match="hierarchical KV tier") as refused:
        flash.demote_cold_extents(next(iter(flash.active)))
    assert "Queue 1" not in str(refused.value)
    h.cancel()
    with pytest.raises(NotImplementedError, match="multi-LoRA"):
        eng.scheduler().submit(PROMPTS[0], adapter_id="a")
    with pytest.raises(NotImplementedError, match="RLHF"):
        eng.scheduler().swap_weights({})
    with pytest.raises(NotImplementedError, match="MoE expert offload"):
        sched_mod.DecodeScheduler(eng, expert_store=object())
    for section in ({"spec_tokens": 2}, {"prefill_chunk": 0}):
        _port(continuous_batching={"enabled": True, **section})
    tiered = _port(continuous_batching={"enabled": True, "hierarchical_kv": {"enabled": True}})
    assert tiered.scheduler().kv_tier is not None
    assert sched_mod.DecodeScheduler(eng, prefix_store=tiered.scheduler().kv_tier.store).kv_tier
