"""Shared inputs for the port's tests (``tests/test_torch_*.py``): model
weights made with numpy from a seed, in the JAX package's tree layout, so
the same values go to a ``deepspeed_tpu`` model and (through
``params_from_jax``) to its ``deepspeed_tpu_torch`` counterpart."""

import jax
import numpy as np
import torch

# these tests share a few cores with the rest of the suite's workers, and
# their tiny shapes gain nothing from PyTorch's intra-op threads
torch.set_num_threads(1)


def numpy_params(jax_model, seed):
    """A float param tree for ``jax_model`` (a ``deepspeed_tpu`` model):
    norm scales near 1, small biases, token embeddings of unit scale and
    everything else (kernels, positions) of std 0.3 — large enough that greedy streams are not
    one repeated token, as they are at the init scale of 0.02."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jax_model.init_params, jax.random.key(0))

    def fill(path, leaf):
        name = str(path[-1].key)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "embedding":
            return rng.standard_normal(leaf.shape).astype(np.float32)
        return (0.3 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def token_batch(seed, n=16, T=128, vocab=256):
    """A (n, T) batch of random token ids, int32."""
    return {"input_ids": np.random.default_rng(seed).integers(0, vocab, (n, T)).astype(np.int32)}


def port_engine(name, tree, config, dtype=torch.float32, **model_kw):
    """``deepspeed_tpu_torch.initialize`` on the CPU for the preset ``name``
    (flash attention) with the weights of the JAX ``tree``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import get_model
    from deepspeed_tpu_torch.models.convert import params_from_jax
    model = get_model(name, dtype=dtype, attention_impl="flash", **model_kw)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params_from_jax(to_numpy(tree), model.cfg), config=dict(config),
        device="cpu")
    return engine


def jax_engine(name, tree, config, optimizer=None, **model_kw):
    """``deepspeed_tpu.initialize`` for the preset ``name`` (fp32, flash
    attention) on the weights ``tree``."""
    import jax.numpy as jnp
    import deepspeed_tpu
    from deepspeed_tpu.models import get_model
    model = get_model(name, dtype=jnp.float32, attention_impl="flash", **model_kw)
    engine, *_ = deepspeed_tpu.initialize(model=model, optimizer=optimizer, config=dict(config),
                                          model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
    return engine


# the remat policies under which the backward pass runs the flash forward again
RECOMPUTE_ATTN = ("nothing_saveable", "dots_saveable", "checkpoint_dots",
                  "dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims")


def loss_and_grads(name, policy, seed=3, rng=None, dropout=0.0):
    """One fp32 micro-step of the port's loss on the CPU, counting the plain
    flash forward's and backward's calls."""
    from deepspeed_tpu_torch.models import get_model
    from deepspeed_tpu_torch.ops import flash_attention as fa
    model = get_model(name, dtype=torch.float32, attention_impl="flash", remat_policy=policy,
                      dropout=dropout)
    params = {k: v.requires_grad_(True) for k, v in model.init_params(seed).items()}
    ids = torch.from_numpy(token_batch(seed, n=2)["input_ids"]).long()
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = fa.flash_attention_plain, fa.flash_attention_bwd_plain

    def fwd(*a, **k):
        calls["fwd"] += 1
        return real_fwd(*a, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return real_bwd(*a, **k)

    fa.flash_attention_plain, fa.flash_attention_bwd_plain = fwd, bwd
    try:
        loss = model.loss(params, {"input_ids": ids}, rng=rng)
        grads = torch.autograd.grad(loss, list(params.values()))
    finally:
        fa.flash_attention_plain, fa.flash_attention_bwd_plain = real_fwd, real_bwd
    return loss.detach(), grads, calls
