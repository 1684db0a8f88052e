from .config import DeepSpeedInferenceConfig  # noqa: F401
from .engine import InferenceEngine  # noqa: F401
from .kv_cache import RadixPrefixCache, SlotKVCache  # noqa: F401
from .scheduler import DecodeScheduler, SchedulerHandle  # noqa: F401
