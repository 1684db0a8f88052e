"""Remat policies of the port's training path against the JAX package:
each policy's loss trajectory through ``initialize`` → ``train_batch``
against the JAX engine with the same policy; within the port, gradients
under every policy bitwise those without remat (fp32, CPU) and the plain
flash forward's call count per policy (the ``flash_fwd`` operator runs
again in the backward pass unless the policy keeps its outputs); the
``activation_checkpointing`` section and the ``gradient_checkpointing``
alias; unknown and parametrised names; the functional ``checkpoint``
API."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import get_model as jax_get_model
from deepspeed_tpu.models.transformer import resolve_remat_policy as jax_resolve
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu_torch.models import get_model
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

from .torch_port_helpers import (RECOMPUTE_ATTN, jax_engine, loss_and_grads, numpy_params, port_engine,
                                 token_batch)

POLICIES = ["nothing_saveable", "everything_saveable", "dots_saveable", "checkpoint_dots",
            "dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims",
            "dots_and_attn_saveable"]
FACTORIES = ["offload_dot_with_no_batch_dims", "save_and_offload_only_these_names",
             "save_any_names_but_these", "save_anything_except_these_names", "save_from_both_policies",
             "save_only_these_names"]

CONFIG = {
    "train_batch_size": 16,
    "gradient_accumulation_steps": 2,
    "gradient_clipping": 1.0,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
    "steps_per_print": 10**9,
}


@pytest.mark.parametrize("policy", POLICIES)
def test_loss_trajectory_matches_jax_under_remat(policy):
    tree = numpy_params(jax_get_model("tiny", dtype=jnp.float32), 0)
    cfg = {**CONFIG, "activation_checkpointing": {"policy": policy}}
    batch = token_batch(1)
    je = jax_engine("tiny", tree, cfg)
    assert je.module.cfg.remat_policy == policy
    want = [float(je.train_batch(batch=batch)) for _ in range(4)]
    engine = port_engine("tiny", tree, cfg)
    assert engine.module.cfg.remat_policy == policy
    got = [float(engine.train_batch(batch=batch)) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("name", ["tiny", "tiny-gpt2"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_gradients_bitwise(name, policy):
    loss0, g0, _ = loss_and_grads(name, None)
    loss, g, _ = loss_and_grads(name, policy)
    assert torch.equal(loss, loss0)
    for a, b in zip(g, g0):
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", [None] + POLICIES)
def test_flash_forward_calls_per_policy(policy):
    L = get_model("tiny-gpt2").cfg.num_layers
    _, _, calls = loss_and_grads("tiny-gpt2", policy)
    assert calls == {"fwd": 2 * L if policy in RECOMPUTE_ATTN else L, "bwd": L}


SECTIONS = [
    ({}, None),
    ({"activation_checkpointing": {"policy": "dots_saveable"}}, "dots_saveable"),
    ({"activation_checkpointing": {"partition_activations": True}}, "nothing_saveable"),
    ({"activation_checkpointing": {"cpu_checkpointing": True}}, "nothing_saveable"),
    ({"gradient_checkpointing": True}, "nothing_saveable"),
    ({"gradient_checkpointing": True, "activation_checkpointing": {"policy": "dots_and_attn_saveable"}},
     "dots_and_attn_saveable"),
    ({"gradient_checkpointing": False}, None),
]


@pytest.mark.parametrize("section,policy", SECTIONS)
def test_config_sets_the_policy(section, policy):
    """The section and the HF-style alias set the model's policy as in the
    JAX engine (``tests/unit/test_engine.py:248``), and remat changes no
    loss."""
    cfg = {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
           "steps_per_print": 1000, **section}
    assert DeepSpeedConfig(dict(cfg)).activation_checkpointing.policy == \
        JaxConfig(dict(cfg), world_size=1).activation_checkpointing.policy
    batch = token_batch(0, n=8, T=32)

    def run(c):
        model = get_model("tiny", dtype=torch.float32)
        engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=c, device="cpu")
        return model, [float(engine.train_batch(batch=batch)) for _ in range(2)]

    model, losses = run(cfg)
    assert model.cfg.remat_policy == policy
    _, base = run({k: v for k, v in cfg.items() if k not in section})
    assert losses == base


def test_unknown_policy_raises_the_jax_text():
    with pytest.raises(ValueError) as ref:
        jax_resolve("dots_savable")
    with pytest.raises(ValueError) as ours:
        get_model("tiny", remat_policy="dots_savable")
    assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="unknown remat policy"):
        deepspeed_tpu_torch.initialize(model=get_model("tiny"), device="cpu",
                                       config={"train_batch_size": 4,
                                               "activation_checkpointing": {"policy": "dots_savable"}})


@pytest.mark.parametrize("name", FACTORIES)
def test_parametrised_policy_factories_raise(name):
    with pytest.raises(ValueError, match="not a policy by itself"):
        get_model("tiny", remat_policy=name)


def test_functional_checkpoint_equals_the_function():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32)).requires_grad_(True)
    x = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32)).requires_grad_(True)

    def fn(x, w):
        return torch.tanh(x @ w) @ w.T

    want = fn(x, w)
    gx, gw = torch.autograd.grad(want.square().sum(), (x, w))
    checkpointing.reset()
    checkpointing.configure(deepspeed_config={"activation_checkpointing": {"number_checkpoints": 4}})
    assert checkpointing.is_configured()
    for run in (checkpointing.checkpoint, checkpointing.CheckpointFunction.apply):
        got = run(fn, x, w)
        assert torch.equal(got, want)
        for a, b in zip(torch.autograd.grad(got.square().sum(), (x, w)), (gx, gw)):
            assert torch.equal(a, b)
    checkpointing.reset()
    assert not checkpointing.is_configured()
    gen = checkpointing.model_parallel_cuda_manual_seed(1234)
    assert isinstance(gen, torch.Generator) and gen.initial_seed() == 1234
