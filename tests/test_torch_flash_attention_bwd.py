"""The port's differentiable flash attention (the ``flash_fwd`` operator,
plain versions on the CPU) against ``jax.vjp`` of the JAX package's Pallas
``flash_attention`` / ``flash_attention_with_lse`` (its ``_bwd_dq_kernel``
and ``_bwd_dkv_kernel`` in interpret mode on the CPU, as
``tests/unit/ops/test_flash_attention.py`` runs them), on the same numpy
inputs and cotangents: dq, dk and dv.

The CUDA kernels themselves cannot run here; ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py`` hold them against
``flash_attention_bwd_plain`` on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention_with_lse as jax_flash_lse
from deepspeed_tpu_torch.ops.flash_attention import (flash_attention, flash_attention_bwd_plain,
                                                     flash_attention_with_lse)

# fp32 on both sides: scores, exponentials and products in fp32, summed in
# other orders (blocked online kernels against direct matmuls); gradients of
# O(1) inputs agree to a few ulps of their largest entries
ATOL = 5e-5


def _inputs(B, H, Hkv, T, D, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, Hkv, T, D)).astype(np.float32) for _ in range(2))
    g_lse = rng.standard_normal((B, H, T)).astype(np.float32)
    return q, k, v, do, g_lse


def _torch(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def _np32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _port_grads(q, k, v, do, g_lse, causal, dtype=torch.float32):
    qt, kt, vt = (_torch(x, dtype).requires_grad_(True) for x in (q, k, v))
    if g_lse is None:
        out = flash_attention(qt, kt, vt, causal=causal)
        out.backward(_torch(do, dtype))
    else:
        out, lse = flash_attention_with_lse(qt, kt, vt, causal=causal)
        torch.autograd.backward([out, lse], [_torch(do, dtype), _torch(g_lse)])
    return [t.grad.float().numpy() for t in (qt, kt, vt)]


def _check(got, want):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL, err_msg=name)


# T=100 is not a multiple of the JAX block (64): the TPU kernels pad, the
# port masks the edges
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("T", [128, 100])
def test_gradients_match_jax(causal, g, T):
    B, H, D = 1, 4, 32
    q, k, v, do, _ = _inputs(B, H, H // g, T, D, seed=T + 10 * g + causal)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal, 64, 64), *map(jnp.asarray, (q, k, v)))
    _check(_port_grads(q, k, v, do, None, causal), vjp(jnp.asarray(do)))


@pytest.mark.parametrize("causal", [True, False])
def test_lse_cotangent_matches_jax(causal):
    """The lse cotangent folds into delta (delta - g_lse) on both sides."""
    q, k, v, do, g_lse = _inputs(1, 4, 2, 100, 32, seed=5 + causal)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash_lse(q, k, v, causal, 64, 64),
                     *map(jnp.asarray, (q, k, v)))
    _check(_port_grads(q, k, v, do, g_lse, causal), vjp((jnp.asarray(do), jnp.asarray(g_lse))))


# bf16, where the rounding points count: ds is rounded to bf16 before its
# products and p before dv's, on both sides.
#
# The plain backward alone, fed the JAX forward's own out and lse: it follows
# the TPU kernels' arithmetic, so each gradient is within rel L2 1e-3 of
# theirs (measured at most 1.7e-4 over these cases; with ds left unrounded
# dq and dk part by 2.4e-3 or more, with p left unrounded dv by 2.3e-3 or
# more), and within one bf16 ulp of the largest entry, 2^-7 max|JAX|.
BF16_BWD_REL_L2 = 1e-3


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("T", [128, 100])
@pytest.mark.parametrize("with_lse", [False, True])
def test_plain_backward_matches_jax_bf16(causal, g, T, with_lse):
    q, k, v, do, g_lse = _inputs(1, 4, 4 // g, T, 32, seed=T + 10 * g + causal)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)
    (out, lse), vjp = jax.vjp(lambda q, k, v: jax_flash_lse(q, k, v, causal, 64, 64),
                              bf(q), bf(k), bf(v))
    want = vjp((bf(do), jnp.asarray(g_lse) if with_lse else jnp.zeros_like(lse)))
    b16 = torch.bfloat16
    got = flash_attention_bwd_plain(_torch(q, b16), _torch(k, b16), _torch(v, b16),
                                    _torch(_np32(out), b16), _torch(_np32(lse)), _torch(do, b16),
                                    causal, None, _torch(g_lse) if with_lse else None)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float().numpy(), _np32(b)
        assert np.linalg.norm(a - b) <= BF16_BWD_REL_L2 * np.linalg.norm(b), name
        np.testing.assert_allclose(a, b, rtol=0, atol=2.0**-7 * np.abs(b).max(), err_msg=name)


# The Function end to end in bf16, each side on its own forward's out and
# lse: the JAX forward's online softmax rounds p at each row's running max,
# the port's at its final max, so out, delta and the gradients part a little
# further: within 2^-6 of max|JAX| (the bf16 rule of
# test_torch_decode_block.py; measured at most 6.5e-3 of it here).
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("T", [128, 100])
def test_gradients_match_jax_bf16(causal, g, T):
    q, k, v, do, _ = _inputs(1, 4, 4 // g, T, 32, seed=T + g)
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal, 64, 64), bf(q), bf(k), bf(v))
    got = _port_grads(q, k, v, do, None, causal, torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv"), got, vjp(bf(do))):
        b = _np32(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=2.0**-6 * np.abs(b).max(), err_msg=name)


def test_function_keeps_the_graph():
    """The output carries the backward node of the registered flash operator
    (``torch.ops.deepspeed_tpu_torch.flash_fwd``), so q, k and v get
    gradients (the kernel path once returned outputs with no grad_fn)."""
    q, k, v, do, _ = _inputs(1, 2, 2, 64, 16, seed=3)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out, lse = flash_attention_with_lse(qt, kt, vt)
    assert out.grad_fn is not None and lse.grad_fn is out.grad_fn
    assert type(out.grad_fn).__name__ == "GeneratedBackwardFor_deepspeed_tpu_torch_flash_fwd_defaultBackward"
    (out * torch.from_numpy(do)).sum().backward()
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0) for t in (qt, kt, vt))


def test_plain_backward_reads_lse_minus_inf_as_zero():
    """A row whose lse is -inf (it attended nothing) uses lse 0, as the
    TPU kernels do: its gradients are those of lse 0, finite."""
    q, k, v, do, _ = _inputs(1, 2, 2, 32, 16, seed=4)
    qt, kt, vt, dot = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash_attention_with_lse(qt, kt, vt)
    lse_inf, lse_zero = lse.clone(), lse.clone()
    lse_inf[0, 1, 3] = float("-inf")
    lse_zero[0, 1, 3] = 0.0
    a = flash_attention_bwd_plain(qt, kt, vt, out, lse_inf, dot)
    b = flash_attention_bwd_plain(qt, kt, vt, out, lse_zero, dot)
    for x, y in zip(a, b):
        assert torch.isfinite(x).all()
        torch.testing.assert_close(x, y, rtol=0, atol=0)
