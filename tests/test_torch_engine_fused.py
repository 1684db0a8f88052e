"""The port's fused decode path against the JAX package's, on the same
weights: the default int8 kernel-injected config (no ``fused_decode_block``
key) decodes through the fused decode layer in both engines, and their
greedy streams agree for uniform and ragged prompts on ``tiny`` (llama
family: RoPE, RMSNorm, SwiGLU, GQA) and ``tiny-gpt2`` (learned positions,
LayerNorm, gelu). The kernels run as their plain versions here (CPU). The
gate's reasons for a refused config are in ``test_torch_engine.py``."""

import functools

import numpy as np
import pytest

import deepspeed_tpu
import deepspeed_tpu.models as jm
import deepspeed_tpu_torch
import deepspeed_tpu_torch.models as tm
from deepspeed_tpu.comm import comm
from deepspeed_tpu_torch.models.convert import params_from_jax

from .test_torch_engine import PROMPTS
from .torch_port_helpers import numpy_params

CFG = {"dtype": "int8", "kernel_inject": True, "max_out_tokens": 512}


@functools.lru_cache(maxsize=None)
def _engines(name):
    """(JAX engine, port engine) with the default int8 config, one set of
    weights; built once per preset for this file's tests."""
    jmod = jm.get_model(name, max_seq_len=512)
    tree = numpy_params(jmod, seed=10)
    comm._state["mesh"] = None
    je = deepspeed_tpu.init_inference(jmod, config=CFG, params=tree)
    tmod = tm.get_model(name, max_seq_len=512)
    te = deepspeed_tpu_torch.init_inference(tmod, config=CFG, params=params_from_jax(tree, tmod.cfg),
                                            device="cpu")
    return je, te


@pytest.mark.parametrize("name", ["tiny", "tiny-gpt2"])
@pytest.mark.parametrize("kind", ["uniform", "ragged"])
def test_int8_fused_greedy_matches_jax(name, kind, monkeypatch):
    """Tolerance as in test_int8_greedy_matches_jax: the rows' common
    prefixes cover at least half of the generated tokens and at least one
    row agrees in full (bf16 rounds at other places in XLA and PyTorch, so a
    greedy choice between two logits that close may flip, and the streams
    then part for good). The first token comes from the shared prefill; the
    next 7 from 7 fused decode steps in each engine."""
    je, te = _engines(name)
    assert bool(je._fused_decode_eligible()) and bool(te._fused_decode_eligible())
    assert te._fused_decode_note is None
    steps = []
    fused_step = te._fused_step
    monkeypatch.setattr(te, "_fused_step", lambda *a: steps.append(1) or fused_step(*a))
    max_new = 8
    jax_out = [r.tolist() for r in je.generate(PROMPTS[kind], max_new_tokens=max_new)]
    port_out = [r.tolist() for r in te.generate(PROMPTS[kind], max_new_tokens=max_new)]
    assert len(steps) == max_new - 1  # every decode step took the fused layer
    prefix = []
    for j, p in zip(jax_out, port_out):
        prefix.append(next((i for i, (a, b) in enumerate(zip(j, p)) if a != b), len(j)))
    assert sum(prefix) >= sum(len(j) for j in jax_out) / 2, (jax_out, port_out)
    assert max(prefix) == len(jax_out[0]), (jax_out, port_out)
