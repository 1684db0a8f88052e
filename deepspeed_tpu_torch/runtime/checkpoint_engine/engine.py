"""Checkpoint save/load.

Port of ``deepspeed_tpu/runtime/checkpoint_engine/engine.py`` (analogue of
the reference ``deepspeed/runtime/checkpoint_engine/``: the pluggable
``CheckpointEngine`` ABC, a synchronous backend and async saves). The
backend is ``torch.save`` in place of Orbax (which imports JAX), on the
JAX package's layout:

    <save_dir>/<tag>/state/state.pt   the engine's state: tensors and plain numbers
    <save_dir>/<tag>/client_sd.json   everything else (counters, schedule, config)
    <save_dir>/latest                 the newest tag, written once the state is

A state holds tensors, plain numbers and lists or dicts of them only, so it
loads with ``torch.load(..., weights_only=True)``. Every tensor is copied to
the host before :func:`save_checkpoint` returns, so the steps that follow
an async save (``checkpoint.async_save``) cannot change what is being
written; the file is written, and ``latest`` moved, on a thread.
"""

import json
import os
import threading

import numpy as np
import torch

from ...utils.logging import logger

STATE_FILE = "state.pt"


class CheckpointEngine:
    """Pluggable backend ABC (reference ``checkpoint_engine.py:9``)."""

    def __init__(self, config_params=None):
        pass

    def create(self, tag):
        pass

    def save(self, state_dict, path):
        raise NotImplementedError

    def load(self, path, map_location=None):
        raise NotImplementedError

    def commit(self, tag):
        return True


class TorchCheckpointEngine(CheckpointEngine):
    """``torch.save`` into ``path/state.pt`` (written beside, then renamed
    into place); ``torch.load(weights_only=True)`` back."""

    def save(self, state_dict, path):
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save(state_dict, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))

    def load(self, path, map_location=None):
        return torch.load(os.path.join(path, STATE_FILE), map_location=map_location, weights_only=True)


def to_host(tree):
    """``tree`` with every tensor copied to the host (host tensors copied
    too): what a save writes no longer shares memory with the engine."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_host(v) for v in tree]
    return tree


def _latest_path(save_dir):
    return os.path.join(save_dir, "latest")


def get_latest_tag(load_dir):
    p = _latest_path(load_dir)
    if os.path.isfile(p):
        with open(p) as f:
            return f.read().strip()
    return None


# the in-flight async writer thread and its failure, if any
_pending_commit = None
_pending_error = None
_atexit_registered = False


def _drain_pending_at_exit():
    try:
        wait_pending_saves()
    except Exception as e:
        logger.error(f"async checkpoint failed during interpreter exit: {e!r}")


def wait_pending_saves():
    """Block until any in-flight async checkpoint is written and its
    'latest' pointer moved. Re-raises a failure of the background write: a
    lost checkpoint must not be discovered at restore time."""
    global _pending_commit, _pending_error
    if _pending_commit is not None:
        _pending_commit.join()
        _pending_commit = None
    if _pending_error is not None:
        err, _pending_error = _pending_error, None
        raise RuntimeError("async checkpoint save failed in the background") from err


def save_checkpoint(save_dir, tag, state, client_sd, save_latest=True, use_async=False):
    """Write ``state`` (tensors and plain numbers) and ``client_sd`` (JSON)
    under ``save_dir/tag``; then, with ``save_latest``, point ``latest``
    at the tag. ``use_async``: the file is written on a thread (the tensors
    are on the host before this returns)."""
    global _pending_commit
    wait_pending_saves()  # serialize with a previous in-flight save
    ckpt_dir = os.path.join(os.path.abspath(save_dir), str(tag))
    os.makedirs(ckpt_dir, exist_ok=True)
    engine = TorchCheckpointEngine()
    host_state = to_host(state)
    with open(os.path.join(ckpt_dir, "client_sd.json"), "w") as f:
        json.dump(_jsonable(client_sd), f, indent=2)

    # 'latest' moves only once the state file is in place, so a crash
    # mid-save never leaves it pointing at a partial checkpoint
    def finalize():
        engine.save(host_state, os.path.join(ckpt_dir, "state"))
        engine.commit(tag)
        if save_latest:
            tmp = _latest_path(save_dir) + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(tag))
            os.replace(tmp, _latest_path(save_dir))

    def finalize_capturing():
        global _pending_error
        try:
            finalize()
        except BaseException as e:  # surfaced by the next wait_pending_saves()
            _pending_error = e
            logger.error(f"async checkpoint commit for tag {tag} failed: {e!r}")

    if use_async:
        global _atexit_registered
        if not _atexit_registered:
            # a normal interpreter exit must not kill an in-flight write
            import atexit
            atexit.register(_drain_pending_at_exit)
            _atexit_registered = True
        _pending_commit = threading.Thread(target=finalize_capturing, daemon=True,
                                           name=f"ckpt-commit-{tag}")
        _pending_commit.start()
    else:
        finalize()


def load_checkpoint(load_dir, tag=None, map_location=None):
    """(state, client_sd) of ``load_dir/tag`` (``tag`` None: the one
    ``latest`` names), tensors on ``map_location``; (None, None) when there
    is no such checkpoint."""
    wait_pending_saves()
    load_dir = os.path.abspath(load_dir)
    if tag is None:
        tag = get_latest_tag(load_dir)
        if tag is None:
            logger.warning(f"no 'latest' file found in {load_dir}; cannot auto-resume")
            return None, None
    ckpt_dir = os.path.join(load_dir, str(tag))
    state_path = os.path.join(ckpt_dir, "state")
    if not os.path.isfile(os.path.join(state_path, STATE_FILE)):
        logger.warning(f"checkpoint {state_path} does not exist")
        return None, None
    state = TorchCheckpointEngine().load(state_path, map_location=map_location)
    client_sd = {}
    sd_path = os.path.join(ckpt_dir, "client_sd.json")
    if os.path.isfile(sd_path):
        with open(sd_path) as f:
            client_sd = json.load(f)
    return state, client_sd


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    return obj
