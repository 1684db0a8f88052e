"""``aio`` config section. Copy of
``deepspeed_tpu/runtime/swap_tensor/aio_config.py`` (reference
``runtime/swap_tensor/aio_config.py`` / ``constants.py``: AIO_BLOCK_SIZE ..
AIO_OVERLAP_EVENTS — same keys, same defaults).

``block_size``, ``thread_count`` and ``single_submit`` drive the native pool
directly. ``queue_depth`` and ``overlap_events`` are accepted for config
parity but advisory here: the pthread pool's request queue is unbounded and
read/write overlap comes from the dual read/write handles, not from a
libaio-style event window."""

AIO_BLOCK_SIZE = "block_size"
AIO_QUEUE_DEPTH = "queue_depth"
AIO_THREAD_COUNT = "thread_count"
AIO_SINGLE_SUBMIT = "single_submit"
AIO_OVERLAP_EVENTS = "overlap_events"

AIO_DEFAULTS = {
    AIO_BLOCK_SIZE: 1048576,
    AIO_QUEUE_DEPTH: 8,
    AIO_THREAD_COUNT: 1,
    AIO_SINGLE_SUBMIT: False,
    AIO_OVERLAP_EVENTS: True,
}


def get_aio_config(param_dict):
    """Merge the user ``aio`` section over reference defaults; unknown keys
    are rejected so config typos fail loudly."""
    user = dict(param_dict.get("aio") or {})
    unknown = set(user) - set(AIO_DEFAULTS)
    if unknown:
        raise ValueError(f"aio config: unknown keys {sorted(unknown)}; "
                         f"valid: {sorted(AIO_DEFAULTS)}")
    cfg = dict(AIO_DEFAULTS)
    cfg.update(user)
    return cfg
