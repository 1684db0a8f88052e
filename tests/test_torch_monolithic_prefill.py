"""The monolithic prefill (``prefill_chunk=0``) of the port's scheduler
(``inference/scheduler.py::_admit``), on the CPU at fp32.

Against the chunked path (the counterpart of the JAX package's
``test_chunked_prefill_matches_legacy``: a 100-token prompt, chunks of 16
and 64) and against the JAX package's monolithic scheduler on the same
weights (``params_from_jax`` of one numpy tree); the prefill widths are the
power-of-two buckets, the radix cache is off, the two compose rules still
raise, and a failed prefill frees its slot."""

import functools

import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu.models as jm
import deepspeed_tpu_torch
import deepspeed_tpu_torch.models as tm
from deepspeed_tpu.comm import comm
from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler, _bucket_len
from deepspeed_tpu_torch.models.convert import params_from_jax

from .torch_port_helpers import numpy_params

LONG = [int(t) for t in np.resize(np.arange(3, 40), 100)]
# 3, 64 and 65 tokens: the 64 and 128 buckets, a bucket's exact fill
STREAM = [[5, 6, 7], [int(t) for t in np.resize(np.arange(9, 30), 64)], LONG,
          [int(t) for t in np.resize(np.arange(40, 90), 65)], [11, 12, 13, 14]]


@functools.lru_cache(maxsize=None)
def _tree(name, max_seq_len):
    return numpy_params(jm.get_model(name, max_seq_len=max_seq_len), seed=10)


def _cb(num_slots):
    return {"enabled": True, "num_slots": num_slots}


def _port(name="tiny", max_seq_len=256, num_slots=4, **cfg):
    tmod = tm.get_model(name, max_seq_len=max_seq_len)
    config = {"dtype": "float32", "continuous_batching": _cb(num_slots), **cfg}
    return deepspeed_tpu_torch.init_inference(tmod, config=config,
                                              params=params_from_jax(_tree(name, max_seq_len), tmod.cfg),
                                              device="cpu")


def _jax(name="tiny", max_seq_len=256, num_slots=4, **cfg):
    from deepspeed_tpu.telemetry import set_sink
    comm._state["mesh"] = None
    set_sink(None)
    config = {"dtype": "float32", "continuous_batching": _cb(num_slots), **cfg}
    return deepspeed_tpu.init_inference(jm.get_model(name, max_seq_len=max_seq_len), config=config,
                                        params=_tree(name, max_seq_len))


def _serve(sched, prompts, max_new=8):
    hs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    return [h.result().tolist() for h in hs]


@pytest.mark.parametrize("kernel_inject", [False, True])
def test_monolithic_matches_chunked(kernel_inject):
    """A 100-token prompt (the 128 bucket) through the monolithic prefill
    gives the tokens of chunks of 16 (7 chunks) and 64 (2 chunks), on the
    plain cached attention and on the paged kernels' path (their plain
    versions; the monolithic prefill runs the flash forward at the padded
    bucket width there)."""
    legacy = _serve(_port(kernel_inject=kernel_inject).scheduler(prefill_chunk=0), [LONG])[0]
    assert len(legacy) == 8
    for chunk in (16, 64):
        got = _serve(_port(kernel_inject=kernel_inject).scheduler(prefill_chunk=chunk), [LONG])[0]
        assert got == legacy, f"chunk={chunk} diverged from the monolithic prefill"


def test_monolithic_stream_matches_jax_monolithic():
    """A mixed stream (3 to 100 tokens, more requests than slots) through
    the port's and the JAX package's monolithic schedulers: the same
    tokens; and the port's equal generate()'s for the prompts the static
    path takes."""
    jo = _serve(_jax().scheduler(prefill_chunk=0), STREAM)
    eng = _port(num_slots=2)
    to = _serve(eng.scheduler(prefill_chunk=0), STREAM)
    assert to == jo
    assert to[0] == eng.generate([STREAM[0]], max_new_tokens=8)[0].tolist()


def test_prefill_widths_are_pow2_buckets_and_radix_is_off():
    """Every monolithic prefill dispatches at a power-of-two bucket of at
    least ``prefill_bucket`` (64) tokens, capped at the slot; every decode
    sync at width 1; no radix cache in this mode."""
    sched = _port(num_slots=3).scheduler(prefill_chunk=0)
    assert sched.radix is None and sched.prefill_bucket == 64
    _serve(sched, STREAM + [list(range(1, 200))])
    prefills = {k[1]: n for k, n in sched.dispatched.items() if k[0] == "prefill"}
    assert prefills == {64: 3, 128: 2, 256: 1}, dict(sched.dispatched)
    assert {k for k in sched.dispatched if k[0] != "prefill"} == {(1, sched.steps_per_sync)}
    assert [_bucket_len(n, 64, 256) for n in (1, 64, 65, 129, 255)] == [64, 64, 128, 256, 256]
    sched.cache.check_invariants()


def test_monolithic_prompt_cap_and_compose_rules():
    """The prompt cap is the slot (max_len), and the monolithic path refuses
    extent chains and the seq-parallel prefill, as the JAX scheduler does."""
    eng = _port(kernel_inject=True, max_seq_len=256)
    sched = eng.scheduler(prefill_chunk=0, max_len=128)
    with pytest.raises(ValueError, match="exceeds the per-slot KV capacity"):
        sched.submit(list(range(1, 129)), max_new_tokens=1)
    with pytest.raises(ValueError, match="max_extents > 1 requires chunked prefill"):
        DecodeScheduler(eng, prefill_chunk=0, max_extents=2)
    with pytest.raises(ValueError, match="seq_parallel_min_tokens > 0 requires chunked prefill"):
        DecodeScheduler(eng, prefill_chunk=0, seq_parallel_min_tokens=64)


def test_failed_prefill_frees_its_slot(monkeypatch):
    """A prefill forward that raises leaves its slot free (the pool never
    loses capacity), and the scheduler serves the next request."""
    eng = _port(num_slots=1)
    sched = eng.scheduler(prefill_chunk=0)
    real = eng.module.apply_with_cache

    def boom(*a, **k):
        raise RuntimeError("planted prefill failure")

    monkeypatch.setattr(eng.module, "apply_with_cache", boom)
    h = sched.submit([5, 6, 7], max_new_tokens=4)
    with pytest.raises(RuntimeError, match="planted"):
        h.result()
    assert sched.cache.free_slots == 1 and not sched.active
    monkeypatch.setattr(eng.module, "apply_with_cache", real)
    assert len(sched.submit([5, 6, 7], max_new_tokens=4).result()) == 4
    sched.cache.check_invariants()
