"""Whole fp32 parameters, gradients and optimizer state of a training
engine, across ZeRO shards.

Port of ``deepspeed_tpu/utils/tensor_fragment.py`` (reference
``deepspeed/utils/tensor_fragment.py``: ``safe_get_full_fp32_param`` :123,
``safe_get_full_grad`` :147, ``safe_get_full_optimizer_state`` :135 and the
``safe_set_*`` writers). In the JAX package every tensor is a global
logical array; in the port a ZeRO stage >= 1 engine holds this rank's shard
of each master tensor, and ZeRO-Offload this rank's partition on the host,
and under tensor parallelism its tensor shard, so each getter gathers the
shard to the whole tensor (a collective: every rank of the data-parallel
and tensor groups calls it) and each setter writes this rank's slice. ``key``: the state-dict key (``layers.0.attn.q_proj.kernel``);
the JAX package's ``/``-joined paths are accepted too. Results are fp32
CPU tensors.
"""

import torch

from ..runtime.zero.sharding import shard, unshard
from .logging import logger

_STATE_KEYS = {"exp_avg": "mu", "exp_avg_sq": "nu"}


def _key(engine, key):
    names = engine.param_stream._shapes if engine.param_stream is not None else engine.master
    if key in names:
        return key
    dotted = key.replace("/", ".")
    if dotted in names:
        return dotted
    raise KeyError(f"no parameter {key!r}")


def _whole(engine, key, t, which):
    """Over the data axes, then over ``tensor`` (a tensor-parallel shard)."""
    t = engine._tp_whole(key, unshard(t.detach(), engine._specs[which][key]))
    return t.to("cpu", torch.float32, copy=True)


def _stream_state(engine, key):
    """(block name, range, shape) of ``key`` in the ZeRO-Infinity store."""
    ps = engine.param_stream
    for name, keys in ps._block_keys.items():
        if key in keys:
            b = ps.store.blocks[name]
            i = b["keys"].index(key)
            return name, b["ranges"][i], b["shapes"][i]
    raise KeyError(key)


def safe_get_full_fp32_param(engine, key):
    """The whole fp32 master tensor ``key`` (every tier)."""
    key = _key(engine, key)
    if engine.param_stream is not None:
        name, (a, e), shape = _stream_state(engine, key)
        return engine.param_stream.store.state(name)[0][a:e].view(shape).clone()
    if engine.host_opt is not None:
        part = engine.host_opt.state_tensors()[0][key]
        return _whole(engine, key, part, "offload")
    return _whole(engine, key, engine.master[key], "master")


@torch.no_grad()
def safe_set_full_fp32_param(engine, key, value):
    """Write the whole fp32 master tensor ``key``: this rank keeps its
    slice, and the compute copy follows."""
    key = _key(engine, key)
    value = torch.as_tensor(value, dtype=torch.float32).cpu()
    if engine.param_stream is not None:
        name, (a, e), shape = _stream_state(engine, key)
        if tuple(value.shape) != tuple(shape):
            raise ValueError(f"value shape {tuple(value.shape)} != param shape {tuple(shape)}")
        master, m, v = engine.param_stream.store.state(name)
        master[a:e].copy_(value.reshape(-1))
        engine.param_stream.store.set_state(name, master, m, v)
        return
    if engine.host_opt is not None:
        master, mu, nu = engine.host_opt.state_tensors()
        mine = shard(value, engine._specs["offload"][key])
        if tuple(mine.shape) != tuple(master[key].shape):
            raise ValueError(f"value shape {tuple(value.shape)} does not fit param {key}")
        master[key] = mine
        names = list(master)
        engine.host_opt.load_state(master, dict(zip(names, mu)), dict(zip(names, nu)), engine.host_opt.t)
        if engine._offload_sharded:
            engine._offload_gather()
        return
    mine = shard(engine._tp_slice(key, value), engine._specs["master"][key])
    if tuple(mine.shape) != tuple(engine.master[key].shape):
        raise ValueError(f"value shape {tuple(value.shape)} does not fit param {key}")
    engine.master[key].copy_(mine)


def safe_get_full_grad(engine, key):
    """The accumulated gradient of ``key`` between the facade's
    ``forward``/``backward`` and ``step`` (None, with a warning, when no
    accumulator is live: ``train_batch`` consumes its gradients within the
    step, as the reference's are only there between backward and step)."""
    key = _key(engine, key)
    acc = getattr(engine, "_grad_acc", None)
    if not acc:
        logger.warning("safe_get_full_grad: no gradient accumulator is live (train_batch consumes its "
                       "gradients); use the forward/backward/step facade to inspect them")
        return None
    g = acc[list(engine.master).index(key)]
    if engine.zero_stage >= 2:
        return _whole(engine, key, g, "grad")
    return g.detach().to("cpu", torch.float32, copy=True)


def safe_get_full_optimizer_state(engine, key, state_key):
    """The whole optimizer moment ``state_key`` (``exp_avg`` or
    ``exp_avg_sq``) of ``key``."""
    key = _key(engine, key)
    attr = _STATE_KEYS.get(state_key)
    if attr is None:
        raise KeyError(f"unknown optimizer state key {state_key!r}; valid: {sorted(_STATE_KEYS)}")
    if engine.param_stream is not None:
        name, (a, e), shape = _stream_state(engine, key)
        flat = engine.param_stream.store.state(name)[1 if attr == "mu" else 2]
        return flat[a:e].view(shape).clone()
    if engine.host_opt is not None:
        master, mu, nu = engine.host_opt.state_tensors()
        part = (mu if attr == "mu" else nu)[list(master).index(key)]
        return _whole(engine, key, part, "offload")
    if not hasattr(engine.optimizer, attr):
        raise KeyError(f"the {type(engine.optimizer).__name__} optimizer keeps no {state_key}")
    t = getattr(engine.optimizer, attr)[list(engine.master).index(key)]
    return _whole(engine, key, t, "master")
