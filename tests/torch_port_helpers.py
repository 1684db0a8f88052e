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
