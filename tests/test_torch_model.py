"""The port's model (``deepspeed_tpu_torch.models``) against the JAX
package's on the same weights: the int8 tree bitwise, and prefill logits
plus decode steps through ``apply_with_cache`` in the flash branch (uniform
prompt of 128 tokens: flash prefill, decode-attention kernel) and the
fallback branch (ragged, left-padded prompt: plain cached attention for
prefill, the decode kernel with per-row starts), for float and int8 weights
at fp32 compute. The kernels run as their plain versions here (CPU)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.models as jm
import deepspeed_tpu_torch.models as tm
from deepspeed_tpu_torch.models.convert import params_from_jax

from .torch_port_helpers import numpy_params, to_numpy


def _port_view(sd):
    """bf16 compared by its bits."""
    return {k: (v.view(torch.int16) if v.dtype == torch.bfloat16 else v) for k, v in sd.items()}


@pytest.mark.parametrize("name", ["tiny", "tiny-gpt2"])
@pytest.mark.parametrize("fused_qkv", [True, False])
def test_quantize_params_bitwise(name, fused_qkv):
    """params_from_jax(float tree) + the port's quantize_params reproduce the
    JAX int8 tree (params_from_jax of it) bit for bit."""
    jfloat = jm.get_model(name, max_seq_len=512, scan_layers=False)
    tree = numpy_params(jfloat, seed=1)
    int8 = dict(int8_weights=True, int8_fused_qkv=fused_qkv, scan_layers=False)
    jq = type(jfloat)(dataclasses.replace(jfloat.cfg, **int8))
    tq = tm.get_model(name, max_seq_len=512, **int8)
    ref = _port_view(params_from_jax(to_numpy(jq.quantize_params(tree)), tq.cfg))
    mine = _port_view(tq.quantize_params(params_from_jax(tree, tq.cfg)))
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert mine[k].dtype == ref[k].dtype, k
        assert torch.equal(mine[k], ref[k]), k
    assert set(tq.param_shapes()) == set(mine)


def _pair(name, weights):
    """(JAX model, JAX params, port model, port params) at fp32 compute with
    the kernel paths on (attention_impl='flash', unrolled layers)."""
    over = dict(max_seq_len=512, scan_layers=False, attention_impl="flash")
    jfloat = jm.get_model(name, dtype=jnp.float32, **over)
    tree = numpy_params(jfloat, seed=2)
    if weights == "int8":
        over.update(int8_weights=True, int8_fused_qkv=True)
        jmod = jm.get_model(name, dtype=jnp.float32, **over)
        tree = to_numpy(jmod.quantize_params(tree))
    else:
        jmod = jfloat
    tmod = tm.get_model(name, dtype=torch.float32, **over)
    return jmod, tree, tmod, params_from_jax(tree, tmod.cfg)


@pytest.mark.parametrize("name", ["tiny", "tiny-gpt2"])
@pytest.mark.parametrize("weights", ["float", "int8"])
@pytest.mark.parametrize("branch", ["flash", "ragged"])
def test_prefill_and_decode_match_jax(name, weights, branch):
    jmod, jp, tmod, tp = _pair(name, weights)
    B, T, S = 2, 128, 256
    ids = np.random.default_rng(3).integers(0, 256, (B, T)).astype(np.int32)
    pads = np.array([0, 0] if branch == "flash" else [0, 37], np.int32)
    mask = pos = None
    if branch == "ragged":
        mask = np.arange(S)[None, :] >= pads[:, None]
        pos = np.maximum(np.arange(T)[None, :] - pads[:, None], 0).astype(np.int32)
    as_j = lambda a: None if a is None else jnp.asarray(a)
    as_t = lambda a: None if a is None else torch.as_tensor(a).long() if a.dtype != bool \
        else torch.as_tensor(a)
    # the JAX side jitted as its engine runs it: prefill at the static
    # cache index 0 (the flash branch needs it), decode steps at a traced
    # index, so the four steps share one compiled program
    j_prefill = jax.jit(lambda p, i, c, m, ps: jmod.apply_with_cache(p, i, c, 0, m, ps))
    j_step = jax.jit(jmod.apply_with_cache)
    jcache, tcache = jmod.init_cache(B, S), tmod.init_cache(B, S)
    jl, jcache = j_prefill(jp, jnp.asarray(ids), jcache, as_j(mask), as_j(pos))
    tl, tcache = tmod.apply_with_cache(tp, torch.as_tensor(ids).long(), tcache, 0, as_t(mask),
                                       as_t(pos))
    # fp32 compute on both sides with identical weights: summation order is
    # the only difference (1e-5 of logits of magnitude ~10)
    scale = np.abs(np.asarray(jl)).max()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5 * scale)
    tok = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)
    for s in range(4):
        p = (T + s - pads)[:, None].astype(np.int32)
        jl, jcache = j_step(jp, jnp.asarray(tok[:, None]), jcache, jnp.int32(T + s), as_j(mask),
                            jnp.asarray(p))
        tl, tcache = tmod.apply_with_cache(tp, torch.as_tensor(tok[:, None]).long(), tcache, T + s,
                                           as_t(mask), torch.as_tensor(p).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5 * scale)
        tok = np.argmax(np.asarray(jl)[:, -1], axis=-1).astype(np.int32)


@pytest.mark.parametrize("name", ["tiny", "tiny-gpt2"])
def test_full_forward_matches_jax(name):
    """``apply`` without a cache: flash (T >= 128) with scanned JAX params."""
    jmod = jm.get_model(name, dtype=jnp.float32, max_seq_len=512, attention_impl="flash")
    tree = numpy_params(jmod, seed=4)
    tmod = tm.get_model(name, dtype=torch.float32, max_seq_len=512, attention_impl="flash")
    ids = np.random.default_rng(5).integers(0, 256, (2, 128)).astype(np.int32)
    ref = np.asarray(jmod.apply(tree, jnp.asarray(ids)))
    out = tmod.apply(params_from_jax(tree, tmod.cfg), torch.as_tensor(ids).long()).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5 * np.abs(ref).max())


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="alibi"):
        tm.get_model("tiny", pos_embedding="alibi")
    tmod = tm.get_model("tiny", dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="lora_ops"):
        tmod.apply_with_cache({}, torch.zeros(1, 1).long(), tmod.init_cache(1, 64), 0,
                              lora_ops=({}, ))
