"""CUDA accelerator (reference ``accelerator/cuda_accelerator.py``).

The peak figures are NVIDIA's H100 SXM datasheet numbers (dense, no
sparsity, at the 700 W limit). They bound roofline math only; a card set
below 700 W runs slower, so every measurement is reported beside the card's
own power limit."""

import torch

from .abstract_accelerator import DeepSpeedAccelerator

# dense tensor-core peaks, FLOP/s (H100 SXM datasheet)
_H100_PEAK_FLOPS = {
    torch.bfloat16: 989e12,
    torch.float16: 989e12,
    torch.int8: 1979e12,
    torch.float32: 67e12,  # outside the tensor cores
}
_H100_HBM_BYTES_PER_S = 3.35e12


class CUDA_Accelerator(DeepSpeedAccelerator):

    def __init__(self):
        super().__init__()
        self._name = "cuda"
        self._communication_backend_name = "nccl"

    def device_name(self, device_index=None):
        if device_index is None:
            return "cuda"
        return f"cuda:{device_index}"

    def device(self, device_index=None):
        return torch.device("cuda", device_index or 0)

    def device_count(self):
        return torch.cuda.device_count()

    def set_device(self, device_index):
        torch.cuda.set_device(device_index)

    def current_device(self):
        return torch.cuda.current_device()

    def synchronize(self, device_index=None):
        torch.cuda.synchronize(device_index)

    def manual_seed(self, seed):
        self._seed = seed
        torch.cuda.manual_seed(seed)

    def memory_allocated(self, device_index=None):
        return torch.cuda.memory_allocated(device_index)

    def max_memory_allocated(self, device_index=None):
        return torch.cuda.max_memory_allocated(device_index)

    def total_memory(self, device_index=None):
        return torch.cuda.get_device_properties(device_index or 0).total_memory

    def reset_peak_memory_stats(self, device_index=None):
        torch.cuda.reset_peak_memory_stats(device_index)

    def empty_cache(self):
        torch.cuda.empty_cache()

    def is_bf16_supported(self):
        return torch.cuda.is_bf16_supported()

    def is_fp16_supported(self):
        return True

    def supported_dtypes(self):
        return [torch.float32, torch.bfloat16, torch.float16, torch.int8]

    def is_triton_supported(self):
        return True

    def peak_flops(self, dtype=torch.bfloat16):
        return _H100_PEAK_FLOPS.get(dtype, _H100_PEAK_FLOPS[torch.bfloat16])

    def peak_hbm_bandwidth(self):
        return _H100_HBM_BYTES_PER_S

    def on_accelerator(self, tensor):
        return tensor.is_cuda
