"""Memory tiers: the device <-> host <-> NVMe streaming layer
(``streams.py``) and the tiers built on it: the ZeRO-Infinity parameter
stream's transfers, the host prefix store (``prefix_store.py``), the
per-scheduler serving KV tier (``kv_tier.py``) and the networked store
shard (``net_store.py``). Port of ``deepspeed_tpu/memory/``.

Exports resolve lazily (PEP 562): ``streams`` must stay importable as a
LEAF module (``runtime/zero/offload.py`` pulls its transfer pool at import
time), so this package does not eagerly pull in ``prefix_store`` or
``kv_tier``, whose ``runtime`` imports would close the cycle.
"""

_EXPORTS = {
    "LayerStreamExecutor": "streams",
    "TRANSFER_POOL": "streams",
    "AioReadWindow": "..runtime.swap_tensor.read_window",
    "GlobalPrefixStore": "prefix_store",
    "PrefixEntry": "prefix_store",
    "KVTier": "kv_tier",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod if mod.startswith(".") else f".{mod}", __name__),
                   name)
