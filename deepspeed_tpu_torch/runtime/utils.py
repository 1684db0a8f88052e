"""Runtime utilities: memory reporting and gradient norms.

Port of ``deepspeed_tpu/runtime/utils.py`` (reference ``runtime/utils.py``:
``see_memory_usage`` :40, ``get_global_norm`` / ``clip_grad_norm_`` :385,
``memory_status``). The JAX file reads XLA's per-device memory stats; the
port reads ``torch.cuda``'s allocator counters, and the host's from
``psutil`` when it is installed. Norms accumulate in fp32 (fp64 on the CPU,
as ``runtime/optimizers.py::tensor_norms``).
"""

import gc

import torch

from .. import comm as dist
from ..utils.logging import logger
from .optimizers import tensor_norms


def _device_mem_line(i):
    gib = 2**30
    free, total = torch.cuda.mem_get_info(i)
    return (f"cuda:{i} allocated {torch.cuda.memory_allocated(i) / gib:.2f}GB "
            f"peak {torch.cuda.max_memory_allocated(i) / gib:.2f}GB "
            f"reserved {torch.cuda.memory_reserved(i) / gib:.2f}GB "
            f"free {free / gib:.2f}GB of {total / gib:.2f}GB")


def see_memory_usage(message, force=False, ranks=(0, )):
    """Log the cards' allocator counters and the host's memory (only with
    ``force``, and only on ``ranks``)."""
    if not force or dist.get_rank() not in ranks:
        return
    lines = [message]
    if torch.cuda.is_available():
        lines += ["  " + _device_mem_line(i) for i in range(torch.cuda.device_count())]
    else:
        lines.append("  no CUDA device: device memory not measured")
    try:
        import psutil
        vm = psutil.virtual_memory()
        lines.append(f"  host RSS {psutil.Process().memory_info().rss / 2**30:.2f}GB "
                     f"avail {vm.available / 2**30:.2f}GB ({vm.percent}% used)")
    except ImportError:
        pass
    logger.info("\n".join(lines))


def memory_status(msg="", reset_max=False):
    """The reference's alias for Megatron integrations: log, and with
    ``reset_max`` restart the peak counters."""
    see_memory_usage(msg or "memory_status", force=True)
    if reset_max:
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def get_global_norm(norm_list=None, tensors=None):
    """The L2 norm over a list of norms (the reference's form), or over
    the tensors of ``tensors`` (a tensor, or a dict or list of them)."""
    if tensors is not None:
        ts = _tensors(tensors)
        if not ts:
            return 0.0
        return float(torch.linalg.vector_norm(torch.stack(tensor_norms([t.float() for t in ts]))))
    return float(sum(float(n)**2 for n in norm_list))**0.5


def get_grad_norm(tree):
    """The global L2 norm of a gradient tree."""
    return get_global_norm(tensors=tree)


@torch.no_grad()
def clip_grad_norm_(tree, max_norm):
    """Scale the tensors of ``tree`` in place so their global norm is at
    most ``max_norm`` (coefficient ``min(1, max_norm / (norm + 1e-6))``, the
    engine's); returns the norm before clipping."""
    norm = get_grad_norm(tree)
    coef = min(1.0, max_norm / (norm + 1e-6))
    if coef < 1.0:
        for t in _tensors(tree):
            t.mul_(coef)
    return norm


def empty_cache():
    """Collect host garbage and return the caching allocator's free blocks
    to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
