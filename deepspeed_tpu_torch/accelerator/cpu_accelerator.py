"""CPU accelerator: the host, where the tests run the kernels' plain versions."""

import os

import torch

from .abstract_accelerator import DeepSpeedAccelerator


class CPU_Accelerator(DeepSpeedAccelerator):

    def __init__(self):
        super().__init__()
        self._name = "cpu"
        self._communication_backend_name = "gloo"

    def device_name(self, device_index=None):
        return "cpu"

    def device(self, device_index=None):
        return torch.device("cpu")

    def device_count(self):
        return 1

    def synchronize(self, device_index=None):
        pass

    def memory_allocated(self, device_index=None):
        return 0

    def max_memory_allocated(self, device_index=None):
        return 0

    def total_memory(self, device_index=None):
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")

    def is_bf16_supported(self):
        return True

    def is_fp16_supported(self):
        return True

    def supported_dtypes(self):
        return [torch.float32, torch.bfloat16, torch.float16]

    def peak_flops(self, dtype=None):
        return 1e12  # nominal; keeps roofline math finite, never reported as a device number

    def peak_hbm_bandwidth(self):
        return 5e10
