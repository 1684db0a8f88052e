"""Self-speculative decoding in the port's scheduler
(``inference/scheduler.py::_spec_decode_step``) and its prompt-lookup
drafter (``inference/speculative.py``), on the CPU (the kernels' plain
versions).

The drafter against the JAX package's on the same contexts. Port against
port, bitwise, as the JAX package's ``test_scheduler.py`` and
``test_fused_block.py`` assert for its own scheduler: spec_tokens=4 against
0 (greedy and seeded-sampled tokens and collected logits), EOS and budget
inside an accepted block, the acceptance count of an offline prompt-lookup
replay, the fused int8 path, int8 KV with a radix hit, the dispatched
shapes, a retained radix slot untouched by rejected draft rows, and the
exact fallback of a stream with extent chains. And the port's greedy spec
streams against the JAX scheduler's at tp=1, fp32, on the same weights.

The weights are ``numpy_params``' tree with every kernel scaled by 0.6:
greedy streams then fall into repeats now and then, so drafts are accepted
in some syncs and rejected in others (at full scale almost nothing
repeats; at the init scale everything does)."""

import functools

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.models as jm
import deepspeed_tpu_torch
import deepspeed_tpu_torch.models as tm
from deepspeed_tpu.comm import comm
from deepspeed_tpu.inference.speculative import PromptLookupDrafter as JaxDrafter
from deepspeed_tpu_torch.inference.speculative import PromptLookupDrafter
from deepspeed_tpu_torch.models.convert import params_from_jax

from .torch_port_helpers import numpy_params

PROMPTS = [[5, 6, 7, 8, 9], [10, 11, 12], [int(t) for t in np.resize([7, 8, 9], 40)]]
SAMPLED = dict(do_sample=True, temperature=0.7, top_k=20, top_p=0.9, seed=11)


@functools.lru_cache(maxsize=None)
def _tree(name, max_seq_len, scale=0.6):
    tree = numpy_params(jm.get_model(name, max_seq_len=max_seq_len), seed=10)

    def fill(path, leaf):
        return leaf if str(path[-1].key) in ("scale", "bias", "embedding") else leaf * scale

    return jax.tree_util.tree_map_with_path(fill, tree)


def _cb(num_slots, collect_logits):
    return {"enabled": True, "num_slots": num_slots, "collect_logits": collect_logits}


def _port(name="tiny", max_seq_len=128, num_slots=4, collect_logits=False, **cfg):
    tmod = tm.get_model(name, max_seq_len=max_seq_len)
    config = {"dtype": "float32", "continuous_batching": _cb(num_slots, collect_logits), **cfg}
    return deepspeed_tpu_torch.init_inference(tmod, config=config,
                                              params=params_from_jax(_tree(name, max_seq_len), tmod.cfg),
                                              device="cpu")


def _jax(name="tiny", max_seq_len=128, num_slots=4, **cfg):
    from deepspeed_tpu.telemetry import set_sink
    comm._state["mesh"] = None
    set_sink(None)
    config = {"dtype": "float32", "continuous_batching": _cb(num_slots, False), **cfg}
    return deepspeed_tpu.init_inference(jm.get_model(name, max_seq_len=max_seq_len), config=config,
                                        params=_tree(name, max_seq_len))


# ---------------------------------------------------------------- the drafter


def test_drafter_matches_jax_drafter():
    """Equal drafts on seeded random contexts (a small vocabulary, so
    n-grams recur), repetitive contexts, contexts too short to match, at
    every cap and several n-gram ranges."""
    rng = np.random.default_rng(0)
    contexts = [rng.integers(0, v, n).astype(np.int32) for v, n in [(5, 40), (20, 200), (3, 7), (50, 400)]]
    contexts += [np.resize(np.arange(4), 30).astype(np.int32), np.asarray([9], np.int32),
                 np.asarray([1, 1], np.int32), np.resize([7, 8, 9, 7, 8], 23).astype(np.int32)]
    n = 0
    for k, nmax, nmin in [(4, 3, 1), (2, 3, 2), (6, 1, 1), (3, 5, 3)]:
        ours, theirs = PromptLookupDrafter(k, nmax, nmin), JaxDrafter(k, nmax, nmin)
        for ctx in contexts:
            for cap in (None, 0, 1, 3, 10):
                a, b = ours.draft(ctx, cap), theirs.draft(ctx, cap)
                assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b), (k, nmax, nmin, cap)
                n += a.size
    assert n > 0


# ---------------------------------------------------------------- port vs port


def _serve(sched, prompts, max_new=10, **kw):
    hs = [sched.submit(p, max_new_tokens=max_new, **kw) for p in prompts]
    return [h.result() for h in hs], hs


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_spec_greedy_and_sampled_bitwise_equal_to_non_spec(kv):
    """The paged kernels' path (kernel injection, their plain versions):
    greedy streams with their per-step logits and a seeded sampled stream,
    bitwise equal with spec_tokens=4 and 0, on a full-precision and an int8
    KV pool. Speculation ran, accepted and rejected drafts, netted more
    than one token per (row, verify sync), and the pool's invariants
    hold."""
    out = {}
    for spec in (0, 4):
        sched = _port(collect_logits=True, kernel_inject=True).scheduler(spec_tokens=spec,
                                                                          kv_cache_dtype=kv)
        toks, hs = _serve(sched, PROMPTS, max_new=16)
        logits = [h.result_logits() for h in hs]
        sampled = sched.submit(PROMPTS[0], max_new_tokens=16, **SAMPLED).result()
        out[spec] = (toks, logits, sampled, sched)
    (t0, l0, s0, _), (t1, l1, s1, sched) = out[0], out[4]
    for a, b in zip(t0, t1):
        assert np.array_equal(a, b), (a.tolist(), b.tolist())
    for a, b in zip(l0, l1):
        np.testing.assert_array_equal(a, b)
    assert np.array_equal(s0, s1)
    assert sched.spec_steps > 0 and sched.spec_accepted > 0
    assert sched.mean_spec_tokens_per_step() > 1.0
    assert sched.spec_drafted > sched.spec_accepted  # some drafts were rejected too
    sched.cache.check_invariants()
    sched.radix.check_invariants()


@pytest.mark.parametrize("num_slots", [4, 1])
def test_spec_on_the_plain_attention_path(num_slots):
    """attention_impl "xla" (the model's plain cached attention and plain
    projections): greedy tokens and their per-step logits bitwise equal
    with spec_tokens=4 and 0, as the JAX package's plain path holds them.
    The plain cached attention runs one matmul per query column and a lone
    projection row runs as one of two, so a decode step's column (T = 1;
    with one slot also M = 1) and a verify's (T = 5) take the same routines
    (torch.matmul picks its routine by shape)."""
    out = {}
    for spec in (0, 4):
        sched = _port(collect_logits=True, num_slots=num_slots).scheduler(spec_tokens=spec)
        toks, hs = _serve(sched, PROMPTS, max_new=16)
        out[spec] = toks, [h.result_logits() for h in hs], sched
    for a, b in zip(out[0][0], out[4][0]):
        assert np.array_equal(a, b)
    for a, b in zip(out[0][1], out[4][1]):
        np.testing.assert_array_equal(a, b)
    assert out[4][2].spec_accepted > 0


class _Oracle:
    """A drafter that proposes the true continuation (from a reference
    stream): every draft is accepted, so each verify delivers a full block."""

    def __init__(self, prompt, truth):
        self.n, self.truth = len(prompt), np.asarray(truth, np.int32)

    def draft(self, context, max_tokens=None):
        done = len(context) - self.n
        return self.truth[done:done + max_tokens].copy()


def test_spec_eos_and_budget_inside_an_accepted_block():
    """With every draft accepted (an oracle drafter over the reference
    stream), an EOS token delivered inside a verify block stops delivery
    there, the accepted tokens after it are discarded and not counted as
    accepted, and the slot is released; budgets cap the drafts, so a block
    never delivers past max_new_tokens."""
    prompt = PROMPTS[0]
    truth = _port(kernel_inject=True).scheduler().submit(prompt, max_new_tokens=16).result()
    K, W = 4, 5
    # the first verify starts after the final prefill sync's K tokens; an
    # EOS at a token's first occurrence past it, not at a block's end
    eos_at = next(i for i in range(K, 16) if truth[i] not in truth[:i] and (i - K) % W != W - 1)
    sched = _port(kernel_inject=True).scheduler(spec_tokens=W - 1)
    sched.drafter = _Oracle(prompt, truth)
    got = sched.submit(prompt, max_new_tokens=16, eos_token_id=int(truth[eos_at])).result()
    assert np.array_equal(got, truth[:eos_at + 1])
    assert sched.spec_accepted == eos_at - K - sched.spec_steps + 1 > 0
    assert sched.cache.active_slots == 0
    for budget in (1, 3, 6, 9, 16):
        sched.drafter = _Oracle(prompt, truth)
        got = sched.submit(prompt, max_new_tokens=budget).result()
        assert np.array_equal(got, truth[:budget])
    assert sched.cache.active_slots == 0
    sched.cache.check_invariants()


@pytest.mark.parametrize("prompt", [0, 2])
def test_spec_acceptance_matches_prompt_lookup_replay(prompt):
    """The acceptance walk against an offline replay of the drafter over
    the realized greedy stream: the same accepted count. The final prefill
    chunk's sync delivers K tokens (token 0 and the K - 1 substeps) before
    the first verify sync; a sync with no draft delivers K tokens."""
    max_new, k = 30, 3
    truth = _port(kernel_inject=True).scheduler().submit(PROMPTS[prompt], max_new_tokens=max_new).result()
    sched = _port(kernel_inject=True).scheduler(spec_tokens=k)
    got = sched.submit(PROMPTS[prompt], max_new_tokens=max_new).result()
    assert np.array_equal(got, truth)
    drafter = JaxDrafter(k, 3, 1)
    K = sched.steps_per_sync
    ctx = np.asarray(PROMPTS[prompt], np.int32)
    out = [int(t) for t in truth[:min(K, max_new)]]
    accepted = syncs = 0
    while len(out) < max_new:
        d = drafter.draft(np.concatenate([ctx, np.asarray(out, np.int32)]), min(k, max_new - len(out) - 1))
        if d.size == 0:
            out.extend(int(t) for t in truth[len(out):len(out) + min(K, max_new - len(out))])
            continue
        m = 1
        while m <= d.size and int(truth[len(out) + m - 1]) == int(d[m - 1]):
            m += 1
        out.extend(int(t) for t in truth[len(out):len(out) + m])
        accepted += m - 1
        syncs += 1
    assert out == truth.tolist()
    assert (sched.spec_accepted, sched.spec_steps) == (accepted, syncs)
    assert accepted > 0


def test_fused_int8_spec_stream_equals_fused_non_spec(monkeypatch):
    """tiny-gpt2 int8 with kernel injection: the verify forwards go
    through the fused decode-layer step (``fused_paged_step`` at W = 5
    columns), and the greedy and sampled streams equal the fused
    non-speculative scheduler's."""
    cfg = {"dtype": "int8", "kernel_inject": True, "max_out_tokens": 512}
    outs = {}
    for spec in (0, 4):
        eng = _port("tiny-gpt2", 512, **cfg)
        sched = eng.scheduler(spec_tokens=spec)
        assert sched._fused_block
        widths = []
        real = eng.module.fused_paged_step
        monkeypatch.setattr(eng.module, "fused_paged_step",
                            lambda *a, real=real, **k: widths.append(a[1].shape[1]) or real(*a, **k))
        toks, _ = _serve(sched, PROMPTS, max_new=16)
        toks.append(sched.submit(PROMPTS[1], max_new_tokens=12, **SAMPLED).result())
        outs[spec] = toks
    for a, b in zip(outs[0], outs[4]):
        assert np.array_equal(a, b), (a.tolist(), b.tolist())
    assert sched.spec_steps > 0 and sched.spec_accepted > 0
    assert 5 in widths and widths.count(5) == sched.dispatched[("spec", 5)]
    sched.cache.check_invariants()


def test_int8_kv_spec_with_a_radix_hit_bitwise():
    """A 70-token prompt on an int8 pool: cold, then a radix hit, then the
    same prompt on a speculative int8 scheduler (cold and hit again): all
    four logit blocks bitwise equal."""
    prompt = [int(t) for t in np.resize(np.arange(5, 47), 70)]
    blocks = []
    for spec in (0, 4):
        sched = _port(collect_logits=True, kernel_inject=True).scheduler(kv_cache_dtype="int8",
                                                                          spec_tokens=spec)
        for _ in range(2):
            blocks.append(sched.submit(prompt, max_new_tokens=24).result_logits())
        assert sched.radix.hits == 1
    for b in blocks[1:]:
        np.testing.assert_array_equal(blocks[0], b)
    assert sched.spec_steps > 0


def test_dispatched_shapes_and_retained_slot_under_spec():
    """A retained radix slot's pool rows stay byte-stable while speculative
    syncs write (and reject) draft rows in the other slots; a mixed stream
    on a speculative scheduler dispatches only (C, K), (C, 1), (1, K) and
    ("spec", W)."""
    sched = _port(num_slots=3, kernel_inject=True).scheduler(spec_tokens=4)
    long = [int(t) for t in np.resize(np.arange(3, 40), 100)]
    sched.submit(long, max_new_tokens=4).result()  # retained: its prompt is registered
    keep = next(iter(sched.radix.registered_slots()))
    snap = [t[keep].clone() for comp in sched.cache.pool for t in comp]
    _serve(sched, [PROMPTS[1], [2, 3]], max_new=24)  # two live rows: no eviction
    assert sched.cache.state[keep] == "cached" and sched.spec_steps > 0
    assert sched.spec_drafted > sched.spec_accepted > 0
    assert all(torch.equal(t[keep], x) for t, x in zip((t for comp in sched.cache.pool for t in comp), snap))

    sched = _port(num_slots=3, kernel_inject=True).scheduler(spec_tokens=4)
    _serve(sched, PROMPTS + [long, [2, 3], [4, 4, 4, 4, 4, 4]], max_new=12)
    C, K, W = sched.prefill_chunk, sched.steps_per_sync, sched._spec_width
    assert set(sched.dispatched) <= {(C, K), (C, 1), (1, K), ("spec", W)}, dict(sched.dispatched)
    assert sched.dispatched[("spec", W)] == sched.spec_steps > 0
    assert sched.forwards[W] == sched.spec_steps


def test_extent_chains_fall_back_to_exact_decode():
    """max_extents=2 (a 100-token prompt over two 64-row extents): while a
    chained row is live every sync is an exact decode sync (no verify runs
    with a chain in the pool), and the streams equal the same streams
    without speculation; once the chain finishes, the short request's syncs
    speculate again."""
    long = [int(t) for t in np.resize(np.arange(3, 40), 100)]
    outs = {}
    for spec in (0, 4):
        sched = _port(kernel_inject=True).scheduler(max_len=64, max_extents=2, spec_tokens=spec)
        verify = sched._verify
        chained_at_verify = []

        def spy(*a, sched=sched, verify=verify, **k):
            chained_at_verify.append(bool(sched.cache.chain))
            return verify(*a, **k)

        sched._verify = spy
        hs = [sched.submit(long, max_new_tokens=8), sched.submit(PROMPTS[2], max_new_tokens=20)]
        outs[spec] = [h.result() for h in hs]
    for a, b in zip(outs[0], outs[4]):
        assert np.array_equal(a, b)
    assert sched.spec_steps > 0 and not any(chained_at_verify)


# ---------------------------------------------------------------- against JAX


def test_spec_streams_match_jax_spec_streams():
    """tiny at fp32: the port's greedy speculative streams equal the JAX
    scheduler's (tp=1, spec_tokens=4) on the same weights, and so do the
    acceptance counters (the same drafter over the same streams)."""
    je, te = _jax(), _port()
    js, ts = je.scheduler(spec_tokens=4), te.scheduler(spec_tokens=4)
    jo = [h.result() for h in [js.submit(p, max_new_tokens=16) for p in PROMPTS]]
    to = [h.result() for h in [ts.submit(p, max_new_tokens=16) for p in PROMPTS]]
    for a, b in zip(jo, to):
        assert np.array_equal(a, b), (a.tolist(), b.tolist())
    assert ts.spec_accepted > 0
    assert (ts.spec_steps, ts.spec_drafted, ts.spec_accepted, ts.spec_delivered) == \
        (js.spec_steps, js.spec_drafted, js.spec_accepted, js.spec_delivered)


def test_engine_scheduler_takes_the_section():
    """``engine.scheduler()`` builds from the continuous_batching section's
    spec_tokens, spec_ngram_max, spec_ngram_min and prefill_bucket, as the
    JAX engine does."""
    tmod = tm.get_model("tiny", max_seq_len=128)
    cb = {**_cb(2, False), "spec_tokens": 3, "spec_ngram_max": 2, "spec_ngram_min": 2,
          "prefill_bucket": 32, "prefill_chunk": 0}
    eng = deepspeed_tpu_torch.init_inference(tmod, config={"dtype": "float32", "continuous_batching": cb},
                                             params=params_from_jax(_tree("tiny", 128), tmod.cfg),
                                             device="cpu")
    sched = eng.scheduler()
    assert (sched.spec_tokens, sched.drafter.ngram_max, sched.drafter.ngram_min) == (3, 2, 2)
    assert (sched.prefill_bucket, sched.prefill_chunk, sched.radix) == (32, 0, None)
    assert len(sched.submit([5, 6, 7], max_new_tokens=6).result()) == 6
    assert sched.dispatched[("prefill", 32)] == 1
