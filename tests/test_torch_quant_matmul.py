"""The port's quant_matmul (plain version, CPU) against the JAX package's
Pallas quant_matmul (interpret mode on the CPU), on the same numpy inputs.

The CUDA kernel itself cannot run here; ``chip_smoke.py`` holds it against
this plain version on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.quant_matmul import quant_matmul as jax_qmm
from deepspeed_tpu_torch.ops.quant_matmul import quant_matmul, quant_matmul_plain


def _inputs(M, K, N, G, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    qw = rng.integers(-127, 128, (K, N)).astype(np.int8)
    scales = (rng.random((G, N)) * 0.02 + 0.001).astype(np.float32)
    return x, qw, scales


# (M, K, N, G): several 128-groups; one group over all of K (G=1, the
# quantize_params fallback when 128 does not divide K); M not a multiple of 8
CASES = [(16, 384, 256, 3), (8, 200, 128, 1), (13, 256, 384, 2), (5, 128, 64, 1)]


@pytest.mark.parametrize("M,K,N,G", CASES)
def test_plain_matches_jax(M, K, N, G):
    x, qw, scales = _inputs(M, K, N, G, seed=M + K)
    ref = np.asarray(jax_qmm(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(scales),
                             block_m=M, out_dtype=jnp.float32))
    out = quant_matmul(torch.from_numpy(x), torch.from_numpy(qw), torch.from_numpy(scales),
                       out_dtype=torch.float32).numpy()
    # fp32 on both sides; only the order of the K-sum differs (~K ulps of
    # the partial sums), far below the 1e-4 relative bound
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_cpu_tensor_takes_plain_version_without_counting():
    x, qw, scales = _inputs(8, 256, 128, 2, seed=3)
    before = quant_matmul.launches
    a = quant_matmul(torch.from_numpy(x), torch.from_numpy(qw), torch.from_numpy(scales))
    b = quant_matmul_plain(torch.from_numpy(x), torch.from_numpy(qw), torch.from_numpy(scales))
    assert torch.equal(a, b)
    assert quant_matmul.launches == before


def test_shape_errors():
    x, qw, scales = _inputs(8, 256, 128, 2, seed=4)
    with pytest.raises(ValueError, match="must divide"):
        quant_matmul(torch.from_numpy(x), torch.from_numpy(qw), torch.ones(3, 128))
    with pytest.raises(ValueError, match="!= qw K"):
        quant_matmul(torch.from_numpy(x[:, :128]), torch.from_numpy(qw), torch.from_numpy(scales))
