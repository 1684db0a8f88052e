"""NVMe swap tier: the ``aio`` config section, the rotating read window
and the ZeRO-Infinity optimizer swapper (port of
``deepspeed_tpu/runtime/swap_tensor/``)."""

from .aio_config import get_aio_config  # noqa: F401
from .optimizer_swapper import NVMeOffloadOptimizer  # noqa: F401
from .read_window import AioReadWindow  # noqa: F401
