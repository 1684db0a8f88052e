"""Per-token-row int8 quantization of KV cache rows.

Port of ``deepspeed_tpu/ops/quantizer/__init__.py::quantize_kv_rows`` and
``dequantize_kv_rows``, the int8 paged KV tier of the continuous-batching
scheduler (``kv_cache_dtype: "int8"``). Same rounding as the JAX functions:
the scale is rounded to fp16 first and the rows are divided by it in fp32,
``torch.round`` rounds half to even as ``jnp.round`` does, so the int8
values and the scales are bitwise equal to the JAX package's, on the CPU and
on the card alike (every quotient divides by a tensor).
"""

import torch


def quantize_kv_rows(k, v, scale_dtype=torch.float16, group=None):
    """Joint symmetric int8 quantization of fresh K/V rows. ``k``/``v``:
    (B, heads, T, hd). ONE scale per (batch row, token), shared by K and V
    across every head: 2 bytes a cache row, so the int8 pool holds >= 1.9x
    the rows of a bf16 pool. Returns ``(kq, vq, scales (B, 1, T, 1))``, the
    scale layout mirroring the cache's so one indexed write stores all
    three. ``group``: the mesh axes the heads are split over (tensor
    parallelism): the row's amax is all-reduced with MAX over them, so
    every rank's scale is the one of all the heads (MAX is exact: the
    quantized rows are bitwise a whole model's)."""
    kf, vf = k.float(), v.float()
    amax = torch.maximum(kf.abs().amax(dim=(1, 3), keepdim=True),
                         vf.abs().amax(dim=(1, 3), keepdim=True))  # (B, 1, T, 1)
    if group is not None:
        from .. import comm as dist
        amax = dist.all_reduce(amax, dist.ReduceOp.MAX, group)
    # a tensor divisor: a CUDA tensor divided by a Python number is
    # multiplied by its fp32 reciprocal, which is not the division
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8).to(scale_dtype)
    s32 = scale.float()
    kq = torch.clamp(torch.round(kf / s32), -127, 127).to(torch.int8)
    vq = torch.clamp(torch.round(vf / s32), -127, 127).to(torch.int8)
    return kq, vq, scale


def dequantize_kv_rows(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_kv_rows` for the plain attention path:
    ``q`` (B, heads, S, hd) int8, ``scale`` (B, 1, S, 1) -> float rows. The
    paged kernels do this multiply in registers instead."""
    return (q.float() * scale.float()).to(dtype)
