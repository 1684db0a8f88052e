"""The port's ``init_inference`` -> ``generate()`` against the JAX package's
on the same weights, both with ``fused_decode_block: False`` so both run the
per-projection path: greedy token streams for uniform prompts (flash
prefill) and ragged prompts (left-padded fallback), at float32 and at int8
(bf16 compute). Sampling is held to the port's own invariants (a
``torch.Generator`` cannot reproduce ``jax.random``). The fused decode
gate is held to the JAX engine's reasons here; the fused path's streams are
in ``test_torch_engine_fused.py``."""

import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.models as jm
import deepspeed_tpu_torch
import deepspeed_tpu_torch.models as tm
from deepspeed_tpu.comm import comm
from deepspeed_tpu_torch.models.convert import params_from_jax

from .torch_port_helpers import numpy_params

CFG = {"kernel_inject": True, "fused_decode_block": False, "max_out_tokens": 512}

PROMPTS = {
    # 130 tokens each: P = 192 >= 128 with no mask, so prefill takes flash
    "uniform": [np.random.default_rng(6).integers(0, 256, 130).tolist(),
                np.random.default_rng(7).integers(0, 256, 130).tolist()],
    # ragged: left-padded to one write head, plain cached-attention prefill
    "ragged": [np.random.default_rng(8).integers(0, 256, 70).tolist(),
               np.random.default_rng(9).integers(0, 256, 100).tolist()],
}


def _streams(name, dtype, prompts, max_new=8):
    jmod = jm.get_model(name, max_seq_len=512)
    tree = numpy_params(jmod, seed=10)
    comm._state["mesh"] = None
    cfg = dict(CFG, dtype=dtype)
    je = deepspeed_tpu.init_inference(jmod, config=cfg, params=tree)
    jax_out = je.generate(prompts, max_new_tokens=max_new)
    tmod = tm.get_model(name, max_seq_len=512)
    te = deepspeed_tpu_torch.init_inference(tmod, config=cfg, params=params_from_jax(tree, tmod.cfg),
                                            device="cpu")
    port_out = te.generate(prompts, max_new_tokens=max_new)
    return [r.tolist() for r in jax_out], [r.tolist() for r in port_out]


@pytest.mark.parametrize("name", ["tiny", "tiny-gpt2"])
@pytest.mark.parametrize("kind", ["uniform", "ragged"])
def test_float32_greedy_matches_jax(name, kind):
    jax_out, port_out = _streams(name, "float32", PROMPTS[kind])
    assert port_out == jax_out


@pytest.mark.parametrize("name", ["tiny", "tiny-gpt2"])
@pytest.mark.parametrize("kind", ["uniform", "ragged"])
def test_int8_greedy_matches_jax(name, kind):
    """int8 weights, bf16 compute. Tolerance: XLA and PyTorch round bf16 at
    different places (~0.4% of a logit), which flips a greedy choice where
    the top two logits are that close — about one step in ten on these
    weights — and the streams then diverge for good. So the rows' common
    prefixes must cover at least half of the generated tokens, and at least
    one row must agree in full. (At fp32 compute the streams are equal:
    test_float32_greedy_matches_jax; the int8 logits themselves are held to
    JAX in test_torch_model.)"""
    jax_out, port_out = _streams(name, "int8", PROMPTS[kind])
    prefix = []
    for j, p in zip(jax_out, port_out):
        n = next((i for i, (a, b) in enumerate(zip(j, p)) if a != b), len(j))
        prefix.append(n)
    assert sum(prefix) >= sum(len(j) for j in jax_out) / 2, (jax_out, port_out)
    assert max(prefix) == len(jax_out[0]), (jax_out, port_out)


def _port_engine(dtype="float32", **cfg):
    tmod = tm.get_model("tiny", max_seq_len=512)
    tree = numpy_params(jm.get_model("tiny", max_seq_len=512), seed=10)
    return deepspeed_tpu_torch.init_inference(tmod, config=dict(CFG, dtype=dtype, **cfg),
                                              params=params_from_jax(tree, tmod.cfg), device="cpu")


def test_sampling_is_seeded_and_top_k_1_is_greedy():
    eng = _port_engine()
    prompts = PROMPTS["uniform"]
    kw = dict(max_new_tokens=12, do_sample=True, temperature=1.5, top_p=0.9)
    a = [r.tolist() for r in eng.generate(prompts, seed=3, **kw)]
    b = [r.tolist() for r in eng.generate(prompts, seed=3, **kw)]
    assert a == b
    greedy = [r.tolist() for r in eng.generate(prompts, max_new_tokens=12)]
    top1 = [r.tolist() for r in eng.generate(prompts, max_new_tokens=12, do_sample=True, top_k=1,
                                              seed=5)]
    assert top1 == greedy


def test_eos_stops_rows():
    eng = _port_engine()
    prompts = PROMPTS["uniform"]
    full = eng.generate(prompts, max_new_tokens=10)
    eos = int(full[0][2])
    out = eng.generate(prompts, max_new_tokens=10, eos_token_id=eos)
    for row, ref in zip(out, full):
        ref = ref.tolist()
        stop = ref.index(eos) + 1 if eos in ref else len(ref)
        assert row.tolist() == ref[:stop]  # eos-inclusive trim


# configs the fused gate refuses: model overrides with one reason each, and
# engine settings (no kernel injection leaves the layers scanned; the
# config's own switch)
REFUSED = {
    "model": ("tiny", dict(parallel_residual=True, embed_norm=True, rotary_dim=8, attn_scale=1.0),
              {}),
    "engine": ("tiny-gpt2", {}, dict(kernel_inject=False, fused_decode_block=False)),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_fused_gate_gives_the_jax_reasons(case):
    """Word for word and in the same order, so the port decodes fused
    exactly the configs the JAX engine does."""
    name, over, eng = REFUSED[case]
    cfg = {"dtype": "int8", "kernel_inject": True, "max_out_tokens": 512, **eng}
    jmod = jm.get_model(name, max_seq_len=512, **over)
    tree = numpy_params(jmod, seed=11)
    comm._state["mesh"] = None
    je = deepspeed_tpu.init_inference(jmod, config=cfg, params=tree)
    tmod = tm.get_model(name, max_seq_len=512, **over)
    te = deepspeed_tpu_torch.init_inference(tmod, config=cfg, params=params_from_jax(tree, tmod.cfg),
                                            device="cpu")
    jr, tr = je._fused_decode_eligible(), te._fused_decode_eligible()
    assert not jr and not tr
    assert len(tr.reasons) >= 2 and tr.reasons == jr.reasons
    assert te._fused_decode_note == je._fused_decode_note


def test_unported_config_sections_raise():
    # spec_tokens is ported (speculative decoding); multi-LoRA is not
    with pytest.raises(NotImplementedError, match="continuous_batching.multi_lora"):
        _port_engine(continuous_batching={"enabled": True, "multi_lora": {"enabled": True}})
    assert _port_engine(continuous_batching={"enabled": True, "spec_tokens": 4}).scheduler().drafter
    # tensor parallelism is ported: a degree the world of one cannot hold
    with pytest.raises(ValueError, match="tp_size=2 needs a world"):
        _port_engine(tensor_parallel={"tp_size": 2})


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepspeed_tpu_torch.init_inference("tiny", config=dict(CFG, dtype="float32"))
