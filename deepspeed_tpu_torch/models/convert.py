"""Carry weights across from the JAX package's parameter trees.

:func:`params_from_jax` takes a ``deepspeed_tpu`` ``CausalLMModel`` param
tree as nested dicts of numpy arrays (the float tree of ``init_params`` or
the int8 tree of ``quantize_params``, scanned or unrolled) and returns the
port's flat state dict (``models/transformer.py``). Values are copied
bit for bit; only the layout changes:

- ``layer_{i}`` scopes (or the stacked ``layers`` scope of a scanned tree)
  become ``layers.{i}.``;
- float q/k/v kernels (H, heads, hd) become (H, heads*hd), their biases
  (heads, hd) become (heads*hd,), and the o_proj kernel (heads, hd, H)
  becomes (heads*hd, H): every kernel in matmul layout.
"""

import numpy as np
import torch


def _tensor(a):
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[prefix + k] = np.asarray(v)


def _layer_leaf(key, a):
    """Matmul layout for one leaf of a layer scope (key relative to it)."""
    parts = key.split(".")
    if parts[0] == "attn" and len(parts) == 3 and parts[1] in ("q_proj", "k_proj", "v_proj"):
        if parts[2] == "kernel" and a.ndim == 3:
            return a.reshape(a.shape[0], a.shape[1] * a.shape[2])
        if parts[2] == "bias" and a.ndim == 2:
            return a.reshape(-1)
    if key == "attn.o_proj.kernel" and a.ndim == 3:
        return a.reshape(a.shape[0] * a.shape[1], a.shape[2])
    return a


def params_from_jax(tree, cfg):
    """JAX ``CausalLMModel`` tree (nested numpy dicts) -> port state dict
    for a model of config ``cfg``."""
    tree = dict(tree)
    layers = []
    if "layers" in tree:  # scanned: every leaf has a leading layer axis
        stacked = {}
        _flatten(tree.pop("layers"), "", stacked)
        layers = [{k: v[i] for k, v in stacked.items()} for i in range(cfg.num_layers)]
    else:
        for i in range(cfg.num_layers):
            flat = {}
            _flatten(tree.pop(f"layer_{i}"), "", flat)
            layers.append(flat)
    out = {}
    top = {}
    _flatten(tree, "", top)
    for k, v in top.items():
        out[k] = _tensor(v)
    for i, flat in enumerate(layers):
        for k, v in flat.items():
            out[f"layers.{i}.{k}"] = _tensor(_layer_leaf(k, v))
    return out
