"""Accelerator singleton dispatch (reference ``accelerator/real_accelerator.py``).
CUDA when a card is present, else the CPU."""

import os

ds_accelerator = None


def _detect():
    name = os.environ.get("DS_ACCELERATOR")
    if name:
        return name
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def get_accelerator():
    global ds_accelerator
    if ds_accelerator is not None:
        return ds_accelerator
    if _detect() == "cuda":
        from .cuda_accelerator import CUDA_Accelerator
        ds_accelerator = CUDA_Accelerator()
    else:
        from .cpu_accelerator import CPU_Accelerator
        ds_accelerator = CPU_Accelerator()
    return ds_accelerator


def set_accelerator(accel):
    global ds_accelerator
    ds_accelerator = accel


def is_current_accelerator_supported():
    return True


def resolve_device(device):
    """The engines' device: ``None`` means the CUDA card, and without one
    this raises. An engine never drops to the CPU unless the caller asks for
    it with ``device="cpu"``."""
    import torch
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the kernels' "
                           "plain versions on the host")
    return device
