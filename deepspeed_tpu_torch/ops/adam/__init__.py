"""Host optimizers of the offload tiers (``cpu_adam``)."""

from .cpu_adam import DeepSpeedCPUAdagrad, DeepSpeedCPUAdam, cpu_adam_available, f32_to_bf16  # noqa: F401
