"""Memory tiers: the device <-> host <-> NVMe streaming layer
(``streams.py``) that the ZeRO-Infinity parameter stream rides. Port of
``deepspeed_tpu/memory/``; its serving KV tier (``kv_tier.py``,
``prefix_store.py``, ``net_store.py``) is ROADMAP Queue 1 #8's next slice."""

from .streams import TRANSFER_POOL, LayerStreamExecutor  # noqa: F401


def __getattr__(name):
    # the read window lives under runtime/swap_tensor (as in the JAX
    # package); resolved lazily so this package stays a leaf
    if name == "AioReadWindow":
        from ..runtime.swap_tensor.read_window import AioReadWindow
        return AioReadWindow
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
