from .abstract_accelerator import DeepSpeedAccelerator  # noqa: F401
from .real_accelerator import get_accelerator, set_accelerator, is_current_accelerator_supported  # noqa: F401
