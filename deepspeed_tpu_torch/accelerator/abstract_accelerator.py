"""Accelerator HAL.

PyTorch counterpart of ``deepspeed_tpu/accelerator/abstract_accelerator.py``
(reference ``accelerator/abstract_accelerator.py``, ``DeepSpeedAccelerator``).
Device, memory and synchronisation go through ``torch``; ``peak_flops`` and
``peak_hbm_bandwidth`` are datasheet figures used only for roofline bounds.
"""

import abc


class DeepSpeedAccelerator(abc.ABC):

    def __init__(self):
        self._name = None
        self._communication_backend_name = None
        self._seed = 0

    # Device APIs
    @abc.abstractmethod
    def device_name(self, device_index=None):
        ...

    @abc.abstractmethod
    def device(self, device_index=None):
        """The ``torch.device`` of this accelerator."""

    @abc.abstractmethod
    def device_count(self):
        ...

    def set_device(self, device_index):
        pass

    def current_device(self):
        return 0

    def current_device_name(self):
        return self.device_name(self.current_device())

    @abc.abstractmethod
    def synchronize(self, device_index=None):
        ...

    # RNG APIs
    def manual_seed(self, seed):
        self._seed = seed

    def initial_seed(self):
        return self._seed

    # Memory APIs
    @abc.abstractmethod
    def memory_allocated(self, device_index=None):
        ...

    @abc.abstractmethod
    def max_memory_allocated(self, device_index=None):
        ...

    @abc.abstractmethod
    def total_memory(self, device_index=None):
        ...

    def available_memory(self, device_index=None):
        return self.total_memory(device_index) - self.memory_allocated(device_index)

    def reset_peak_memory_stats(self, device_index=None):
        pass

    def empty_cache(self):
        pass

    # Dtype APIs
    @abc.abstractmethod
    def is_bf16_supported(self):
        ...

    @abc.abstractmethod
    def is_fp16_supported(self):
        ...

    @abc.abstractmethod
    def supported_dtypes(self):
        ...

    # Misc
    def communication_backend_name(self):
        return self._communication_backend_name

    def is_triton_supported(self):
        return False

    @abc.abstractmethod
    def peak_flops(self, dtype=None):
        """Peak dense FLOP/s for ``dtype`` (datasheet; roofline bounds only)."""

    @abc.abstractmethod
    def peak_hbm_bandwidth(self):
        """Peak device-memory bandwidth in bytes/s (datasheet; roofline bounds only)."""

    def on_accelerator(self, tensor):
        return False
