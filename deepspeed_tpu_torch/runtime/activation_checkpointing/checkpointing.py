"""Activation checkpointing API.

Port of ``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py``
(reference ``runtime/activation_checkpointing/checkpointing.py``:
``checkpoint`` :708, ``configure`` :789, ``is_configured`` :871,
``CheckpointFunction`` :474) for code written against the reference's
functional API; ``deepspeed_tpu_torch.models`` models take the
``activation_checkpointing`` config section instead (the engine sets their
remat policy).

``checkpoint(function, *args)`` is non-reentrant ``torch.utils.checkpoint``
(the engine differentiates with ``torch.autograd.grad``, which the
reentrant form does not support): full recompute, as ``jax.checkpoint``
without a policy. With ``cpu_checkpointing`` (``checkpoint_in_cpu``) it is
the JAX package's offload policy (``checkpointing.py:66-74``,
``save_and_offload_only_these_names`` of ``flash_out`` / ``flash_lse``):
everything is recomputed in the backward pass except the flash forward's
out and lse, which the forward copies to pinned host memory and the
recompute copies back instead of launching the kernel again
(:class:`HostResiduals`, read by ``ops/flash_attention.py``'s operator; the
checkpoint's own ``saved_tensors_hooks`` drop every other saved tensor).
The reference's other knobs have no counterpart on one device and are
accepted as no-ops with a warning: partitioning the saved activations,
contiguous buffers, a synchronize at the boundaries, profiling.
"""

import contextlib

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from ...ops.flash_attention import HOST_RESIDUALS
from ...utils.logging import logger

_config = {
    "partition_activations": False,
    "cpu_checkpointing": False,
    "number_checkpoints": None,
    "configured": False,
}


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None, checkpoint_in_cpu=None,
              synchronize=None, profile=None):
    """Record the reference knobs; the ones with no effect here warn.
    ``deepspeed_config``: dict (or object with ``raw_config``) whose
    ``activation_checkpointing`` section seeds the keyword defaults, as the
    reference reads its json."""
    _config["configured"] = True
    if deepspeed_config is not None:
        raw = getattr(deepspeed_config, "raw_config", deepspeed_config)
        sec = dict(dict(raw).get("activation_checkpointing", {}))
        if partition_activations is None:
            partition_activations = sec.get("partition_activations")
        if contiguous_checkpointing is None:
            contiguous_checkpointing = sec.get("contiguous_memory_optimization")
        if num_checkpoints is None:
            num_checkpoints = sec.get("number_checkpoints")
        if checkpoint_in_cpu is None:
            checkpoint_in_cpu = sec.get("cpu_checkpointing")
        if synchronize is None:
            synchronize = sec.get("synchronize_checkpoint_boundary")
        if profile is None:
            profile = sec.get("profile")
    if partition_activations is not None:
        _config["partition_activations"] = partition_activations
    if num_checkpoints is not None:
        _config["number_checkpoints"] = num_checkpoints
    if checkpoint_in_cpu:
        _config["cpu_checkpointing"] = True
    for name, val in (("partition_activations", partition_activations),
                      ("contiguous_checkpointing", contiguous_checkpointing),
                      ("synchronize", synchronize), ("profile", profile)):
        if val:
            logger.warning(f"activation checkpointing: {name} has no effect on one device; "
                           f"accepted as a no-op")


def is_configured():
    return _config["configured"]


def reset():
    _config["configured"] = False
    _config["cpu_checkpointing"] = False


class HostResiduals:
    """One checkpointed region's flash residuals in pinned host memory: the
    region's first run records each flash forward's (out, lse) to the host,
    every later run (the recompute) takes them back in the same order."""

    def __init__(self):
        self.saved, self.runs, self.replaying, self._next = [], 0, False, 0

    @contextlib.contextmanager
    def active(self):
        self.replaying, self._next = self.runs > 0, 0
        prev, HOST_RESIDUALS.active = getattr(HOST_RESIDUALS, "active", None), self
        try:
            yield
        finally:
            HOST_RESIDUALS.active = prev
            self.runs += 1

    def push(self, outputs):
        host = []
        for t in outputs:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
            h.copy_(t, non_blocking=True)  # the recompute's copy back follows it on the stream
            host.append(h)
        self.saved.append(tuple(host))

    def pop(self, device):
        host = self.saved[self._next]
        self._next += 1
        return tuple(h.to(device, non_blocking=True) for h in host)


def checkpoint(function, *args):
    """``function(*args)`` with its activations recomputed in the backward
    pass (non-reentrant ``torch.utils.checkpoint``); under
    ``cpu_checkpointing`` the flash forward's out and lse wait in pinned
    host memory instead of being recomputed."""
    if not _config["cpu_checkpointing"]:
        return _torch_checkpoint(function, *args, use_reentrant=False)
    residuals = HostResiduals()

    def run(*a):
        with residuals.active():
            return function(*a)
    return _torch_checkpoint(run, *args, use_reentrant=False)


def model_parallel_cuda_manual_seed(seed):
    """Reference RNG bookkeeping shim: one device has no model-parallel
    streams to seed; returns a ``torch.Generator`` seeded with ``seed`` for
    callers that want one."""
    return torch.Generator().manual_seed(int(seed))


class CheckpointFunction:
    """Reference-shaped alias: ``CheckpointFunction.apply(fn, *args)``."""

    @staticmethod
    def apply(function, *args):
        return checkpoint(function, *args)
