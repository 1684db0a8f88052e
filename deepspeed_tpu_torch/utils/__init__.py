"""Utilities: logging, the group registry (``groups``) and the whole-tensor
accessors across ZeRO shards (``tensor_fragment``, exported here; loaded on
first use, since the runtime it reads imports this package's logging)."""

_FRAGMENT = ("safe_get_full_fp32_param", "safe_set_full_fp32_param", "safe_get_full_grad",
             "safe_get_full_optimizer_state")
__all__ = list(_FRAGMENT)


def __getattr__(name):
    if name in _FRAGMENT:
        from . import tensor_fragment
        return getattr(tensor_fragment, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
