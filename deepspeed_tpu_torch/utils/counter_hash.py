"""Counter-based 32-bit hashing in integer ops only.

The same functions take Python ints or int64 tensors holding uint32 values,
and give the same bits on the host and on the card: every product is split
so no int64 intermediate overflows, and nothing is floating point. The
scheduler's sampler draws its uniforms from them, the model's dropout its
masks (the JAX package's ``jax.random`` streams cannot be reproduced in
PyTorch, so the port keys its draws on counters instead).
"""

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B1


def mulmod32(x, c):
    """(x * c) mod 2^32 for x in [0, 2^32) (an int or an int64 tensor) and
    a constant c < 2^32, without an int64 overflow: x splits into 16-bit
    halves."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & M32


def mix32(h):
    """murmur3's 32-bit finalizer on uint32 values (ints or int64 tensors)."""
    h = h ^ (h >> 16)
    h = mulmod32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mulmod32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def seed_key(seed):
    """The root key of a seed (a Python int)."""
    return mix32(int(seed) & M32)


def fold_in(key, data):
    """A new key from ``key`` and an integer (a Python int), as
    ``jax.random.fold_in`` derives one: the engine folds in the step, then
    the micro-step; the model the layer, then the dropout site."""
    return mix32(key ^ mulmod32(int(data) & M32, GOLDEN))
