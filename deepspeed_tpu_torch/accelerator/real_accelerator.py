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
