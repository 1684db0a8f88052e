from . import checkpointing  # noqa: F401
