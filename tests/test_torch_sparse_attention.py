"""The port's block-sparse attention (``deepspeed_tpu_torch.ops.sparse_attention``,
plain versions on the CPU) against the JAX package's: every
``SparsityConfig``'s layout and the index tables bitwise; the forward's out
against ``make_block_sparse_attention`` (its Pallas ``_fwd_kernel`` in
interpret mode on the CPU, as ``tests/unit/ops/test_sparse_attention.py``
runs it) and its lse against a dense log-sum-exp under the layout's mask;
gradients against ``jax.vjp`` of the JAX kernels (``_bwd_dq_kernel``,
``_bwd_dkv_kernel``); the ragged tail, the fully masked row,
``SparseSelfAttention``'s cache and checks, and the errors. Inputs are
made with numpy from a seed at the JAX test's size (B 2, H 2, T 256, D 64,
block 32, and block 16).

The CUDA kernels cannot run here; ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py`` hold them against these plain versions
on the card."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.sparse_attention as jsa
from deepspeed_tpu.ops.sparse_attention.block_sparse_attention import _index_tables as jax_tables
import deepspeed_tpu_torch.ops.sparse_attention as tsa
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention import (
    BlockSparseAttentionFunction, _index_tables, block_sparse_attention_plain)

B, H, T, D = 2, 2, 256, 64

# fp32 on both sides: the same online softmax in the same table order, the
# products summed in other orders (Pallas interpret vs torch matmul)
ATOL_OUT = 2e-5
ATOL_GRAD = 5e-5


def _configs(block):
    """(name, JAX config, port config, causal), as the JAX test builds them."""
    specs = [
        ("fixed-uni", "FixedSparsityConfig", dict(num_local_blocks=2, attention="unidirectional")),
        ("fixed-bi", "FixedSparsityConfig", dict(num_local_blocks=2, attention="bidirectional",
                                                 horizontal_global_attention=True)),
        ("bigbird", "BigBirdSparsityConfig", dict(num_random_blocks=1, num_sliding_window_blocks=3,
                                                  num_global_blocks=1)),
        ("bslongformer", "BSLongformerSparsityConfig", dict(num_sliding_window_blocks=3,
                                                            global_block_indices=[0, 5])),
        ("variable", "VariableSparsityConfig", dict(num_random_blocks=1, local_window_blocks=[1, 2],
                                                    global_block_indices=[0])),
        ("sliding", "LocalSlidingWindowSparsityConfig", dict(num_sliding_window_blocks=3,
                                                             attention="unidirectional")),
        ("dense", "DenseSparsityConfig", {}),
    ]
    out = []
    for name, cls, kw in specs:
        jc, tc = getattr(jsa, cls)(H, block=block, **kw), getattr(tsa, cls)(H, block=block, **kw)
        out.append((name, jc, tc, getattr(jc, "attention", "bidirectional") == "unidirectional"))
    return out


CONFIG_NAMES = [c[0] for c in _configs(32)]


def _config(name, block):
    return next(c for c in _configs(block) if c[0] == name)


# ---------------------------------------------------------------------------
# layouts and index tables

LAYOUT_SPECS = [
    ("Dense", {}),
    ("Fixed", dict(attention="unidirectional")),
    ("Fixed", dict(num_local_blocks=4, num_global_blocks=2, attention="bidirectional",
                   horizontal_global_attention=True)),
    ("Fixed", dict(num_local_blocks=4, num_global_blocks=1, num_different_global_patterns=4)),
    ("Variable", dict(num_random_blocks=2, local_window_blocks=[1, 2, 4], global_block_indices=[0, 3],
                      global_block_end_indices=[2, 5], horizontal_global_attention=True)),
    ("Variable", dict(num_random_blocks=1, attention="unidirectional")),
    ("BigBird", {}),
    ("BigBird", dict(num_random_blocks=2, num_sliding_window_blocks=5, num_global_blocks=2,
                     attention="unidirectional")),
    ("BSLongformer", dict(global_block_indices=[0, 7], global_block_end_indices=[2, 9])),
    ("LocalSlidingWindow", {}),
    ("LocalSlidingWindow", dict(num_sliding_window_blocks=5, attention="bidirectional")),
]
# num_different_global_patterns > 1 needs different layouts per head; the
# sliding window has no such option
LAYOUT_CASES = [(cls, kw, per_head) for cls, kw in LAYOUT_SPECS for per_head in (False, True)
                if not (cls == "LocalSlidingWindow" and per_head)
                and not (kw.get("num_different_global_patterns", 1) > 1 and not per_head)]


def _layout_pair(cls, kw, per_head, seq_len, heads=4, block=16):
    name = cls + "SparsityConfig"
    if cls != "LocalSlidingWindow":
        kw = dict(kw, different_layout_per_head=per_head)
    return (getattr(jsa, name)(heads, block=block, **kw).make_layout(seq_len),
            getattr(tsa, name)(heads, block=block, **kw).make_layout(seq_len))


@pytest.mark.parametrize("seq_len", [256, 512])
@pytest.mark.parametrize("cls,kw,per_head", LAYOUT_CASES)
def test_layouts_bitwise_equal_jax(cls, kw, per_head, seq_len):
    want, got = _layout_pair(cls, kw, per_head, seq_len)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _random_layout(seed, heads=3, nb=8):
    """A layout with an empty row and an empty column in every head."""
    layout = (np.random.default_rng(seed).random((heads, nb, nb)) < 0.4).astype(np.int64)
    layout[:, 2, :] = 0
    layout[:, :, 5] = 0
    return layout


@pytest.mark.parametrize("cls,kw,per_head", LAYOUT_CASES[::2] + [("random", None, None)])
def test_index_tables_equal_jax(cls, kw, per_head):
    layout = _random_layout(1) if cls == "random" else _layout_pair(cls, kw, per_head, 256)[1]
    for got, want in zip(_index_tables(layout), jax_tables(layout)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# forward and gradients against the JAX kernels


def qkv(seed=0, t=T):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal((B, H, t, D)).astype(np.float32) for _ in range(3))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def _np32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _dense_lse(q, k, layout, block, causal, t):
    """log-sum-exp of each row's visible scores (float64), -inf where none."""
    mask = np.kron(layout, np.ones((block, block), dtype=bool)).astype(bool)[:, :t, :t]
    if causal:
        mask = mask & np.tril(np.ones((t, t), dtype=bool))[None]
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) / np.sqrt(D)
    s = np.where(mask[None], s, -np.inf)
    m = s.max(-1, keepdims=True)
    m_safe = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):
        return (m_safe + np.log(np.exp(s - m_safe).sum(-1, keepdims=True)))[..., 0]


def _port_forward(q, k, v, layout, block, causal, dtype=torch.float32):
    q_idx, q_cnt, _, _ = (torch.from_numpy(a) for a in _index_tables(layout))
    return block_sparse_attention_plain(_t(q, dtype), _t(k, dtype), _t(v, dtype), q_idx, q_cnt,
                                        block, causal)


@functools.lru_cache(maxsize=None)
def _jax_reference(name, block, bf16):
    """One ``jax.vjp`` of the JAX kernels per (config, block, dtype), shared
    by the forward and the gradient tests: (layout, causal, q, k, v, do,
    out, (dq, dk, dv)), numpy fp32."""
    _, _, tc, causal = _config(name, block)
    layout = tc.make_layout(T)
    q, k, v = qkv(5 if bf16 else 1)
    do = np.random.default_rng(11 if bf16 else 9).standard_normal((B, H, T, D)).astype(np.float32)
    cast = (lambda x: x.astype(jnp.bfloat16)) if bf16 else (lambda x: x)
    attend = jsa.make_block_sparse_attention(layout, block, causal=causal)
    out, vjp = jax.vjp(attend, *(cast(jnp.asarray(x)) for x in (q, k, v)))
    return layout, causal, q, k, v, do, _np32(out), tuple(_np32(g) for g in vjp(cast(jnp.asarray(do))))


@pytest.mark.parametrize("block", [32, 16])
@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_forward_matches_jax(name, block):
    layout, causal, q, k, v, _, want, _ = _jax_reference(name, block, False)
    out, lse = _port_forward(q, k, v, layout, block, causal)
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL_OUT, rtol=ATOL_OUT)
    np.testing.assert_allclose(lse.numpy(), _dense_lse(q, k, layout, block, causal, T), atol=2e-5,
                               rtol=0)


# bf16: both sides round p to bf16 at each kv block's running max, in the
# same table order; the outputs part by one bf16 ulp at the largest
# magnitude at most, 2^-7 of max|JAX| (test_torch_flash_attention_bwd.py's rule)
@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_forward_matches_jax_bf16(name):
    layout, causal, q, k, v, _, want, _ = _jax_reference(name, 32, True)
    out, lse = _port_forward(q, k, v, layout, 32, causal, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), want, rtol=0, atol=2.0**-7 * np.abs(want).max())
    rq, rk = (_np32(jnp.asarray(x, jnp.bfloat16)) for x in (q, k))
    np.testing.assert_allclose(lse.numpy(), _dense_lse(rq, rk, layout, 32, causal, T), atol=1e-4,
                               rtol=0)


def _port_grads(q, k, v, do, layout, block, causal, dtype=torch.float32):
    qt, kt, vt = (_t(x, dtype).requires_grad_(True) for x in (q, k, v))
    out = tsa.make_block_sparse_attention(layout, block, causal=causal)(qt, kt, vt)
    out.backward(_t(do, dtype))
    return out, [t.grad.float().numpy() for t in (qt, kt, vt)]


def _jax_grads(q, k, v, do, layout, block, causal, cast=lambda x: x):
    attend = jsa.make_block_sparse_attention(layout, block, causal=causal)
    _, vjp = jax.vjp(attend, *(cast(jnp.asarray(x)) for x in (q, k, v)))
    return [_np32(g) for g in vjp(cast(jnp.asarray(do)))]


@pytest.mark.parametrize("block", [32, 16])
@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_gradients_match_jax(name, block):
    layout, causal, q, k, v, do, _, want = _jax_reference(name, block, False)
    _, got = _port_grads(q, k, v, do, layout, block, causal)
    for tag, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, atol=ATOL_GRAD, rtol=ATOL_GRAD, err_msg=f"d{tag}")


# bf16 gradients: ds and p rounded to bf16 before their products on both
# sides, each side on its own forward's out (one bf16 ulp apart at most), so
# within 2^-6 of max|JAX| (test_torch_flash_attention_bwd.py's rule)
@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_gradients_match_jax_bf16(name):
    layout, causal, q, k, v, do, _, want = _jax_reference(name, 32, True)
    _, got = _port_grads(q, k, v, do, layout, 32, causal, torch.bfloat16)
    for tag, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=2.0**-6 * np.abs(b).max(), err_msg=f"d{tag}")


@pytest.mark.parametrize("block", [32, 16])
def test_ragged_tail_matches_jax(block):
    """T not a multiple of the block: JAX pads, the port masks; positions
    >= t leak into neither the output nor the gradients."""
    _, jc, tc, causal = _config("fixed-uni", block)
    t = T - 8
    layout = tc.make_layout(T)
    q, k, v = qkv(2, t=t)
    do = np.random.default_rng(4).standard_normal((B, H, t, D)).astype(np.float32)
    out, got = _port_grads(q, k, v, do, layout, block, causal)
    want = _np32(jsa.make_block_sparse_attention(layout, block, causal=True)(q, k, v))
    assert out.shape == (B, H, t, D)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=ATOL_OUT, rtol=ATOL_OUT)
    for tag, a, b in zip("qkv", got, _jax_grads(q, k, v, do, layout, block, causal)):
        np.testing.assert_allclose(a, b, atol=ATOL_GRAD, rtol=ATOL_GRAD, err_msg=f"d{tag}")


def test_fully_masked_row_outputs_zero():
    """A causal q-block row whose only active block lies in the future gets
    out 0 and lse -inf, and contributes nothing to the gradients (as in
    JAX); a kv block no query reads gets dk = dv = 0."""
    nb = T // 32
    layout = np.zeros((H, nb, nb), np.int64)
    layout[:, :, :] = np.eye(nb, dtype=np.int64)
    layout[:, 0, :] = 0
    layout[:, 0, nb - 1] = 1  # row 0 attends only the last (future) block
    q, k, v = qkv(7)
    out, lse = _port_forward(q, k, v, layout, 32, True)
    np.testing.assert_array_equal(out[:, :, :32].numpy(), 0.0)
    assert np.isneginf(lse[:, :, :32].numpy()).all() and np.isfinite(lse[:, :, 32:].numpy()).all()
    assert np.abs(out[:, :, 32:].numpy()).sum() > 0
    do = np.random.default_rng(8).standard_normal((B, H, T, D)).astype(np.float32)
    _, (dq, dk, dv) = _port_grads(q, k, v, do, layout, 32, True)
    np.testing.assert_array_equal(dq[:, :, :32], 0.0)
    np.testing.assert_array_equal(dk[:, :, :32], 0.0)  # kv block 0: read by nobody
    np.testing.assert_array_equal(dv[:, :, :32], 0.0)
    for tag, a, b in zip("qkv", (dq, dk, dv), _jax_grads(q, k, v, do, layout, 32, True)):
        np.testing.assert_allclose(a, b, atol=ATOL_GRAD, rtol=ATOL_GRAD, err_msg=f"d{tag}")


def test_random_layout_with_empty_rows_and_columns_matches_jax():
    """Blocks above the diagonal under causal, an empty q row and an empty
    kv column, different per head."""
    layout = _random_layout(3, heads=H)
    q, k, v = qkv(6)
    do = np.random.default_rng(2).standard_normal((B, H, T, D)).astype(np.float32)
    out, got = _port_grads(q, k, v, do, layout, 32, True)
    want = _np32(jsa.make_block_sparse_attention(layout, 32, causal=True)(q, k, v))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=ATOL_OUT, rtol=ATOL_OUT)
    for tag, a, b in zip("qkv", got, _jax_grads(q, k, v, do, layout, 32, True)):
        np.testing.assert_allclose(a, b, atol=ATOL_GRAD, rtol=ATOL_GRAD, err_msg=f"d{tag}")


# ---------------------------------------------------------------------------
# the module and the errors


def test_sparse_self_attention_module():
    cfg = tsa.BSLongformerSparsityConfig(H, block=32, num_sliding_window_blocks=3)
    ssa = tsa.SparseSelfAttention(cfg)
    assert isinstance(ssa, torch.nn.Module) and not list(ssa.parameters())
    q, k, v = (_t(x) for x in qkv(4))
    out = ssa(q, k, v)
    assert out.shape == (B, H, T, D)
    assert len(ssa._cache) == 1
    fn = ssa._cache[T]
    assert torch.equal(ssa(q, k, v), out)
    assert len(ssa._cache) == 1 and ssa._cache[T] is fn  # layout/tables/fn cached per seq_len
    assert fn.tables("cpu")[0] is fn.tables(torch.device("cpu"))[0]  # tables cached per device
    ssa(q[:, :, :128], k[:, :, :128], v[:, :, :128])
    assert sorted(ssa._cache) == [128, T]
    want = _np32(jsa.SparseSelfAttention(jsa.BSLongformerSparsityConfig(
        H, block=32, num_sliding_window_blocks=3))(*(jnp.asarray(x) for x in qkv(4))))
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL_OUT, rtol=ATOL_OUT)


def test_max_seq_length_is_checked():
    ssa = tsa.SparseSelfAttention(tsa.DenseSparsityConfig(H, block=32), max_seq_length=128)
    q = torch.zeros((1, H, 256, D))
    with pytest.raises(ValueError, match="exceeds max_seq_length 128"):
        ssa(q, q, q)
    assert not ssa._cache


def test_seq_len_must_divide_block():
    with pytest.raises(ValueError, match="multiple of block"):
        tsa.FixedSparsityConfig(2, block=32).make_layout(100)
    with pytest.raises(ValueError, match="multiple of block"):
        tsa.SparseSelfAttention(tsa.FixedSparsityConfig(H, block=32))(*(torch.zeros(1, H, 100, D),) * 3)


def test_make_block_sparse_attention_errors():
    layout = np.ones((H, 4, 4), np.int64)
    with pytest.raises(ValueError, match="layout must be"):
        tsa.make_block_sparse_attention(layout[0], 32)
    fn = tsa.make_block_sparse_attention(layout, 32)
    with pytest.raises(ValueError, match="layout built for 2 heads, got 3"):
        fn(*(torch.zeros(1, 3, 128, D),) * 3)
    with pytest.raises(ValueError, match="exceeds layout capacity 128"):
        fn(*(torch.zeros(1, H, 129, D),) * 3)
    with pytest.raises(ValueError, match="impl"):
        tsa.make_block_sparse_attention(layout, 32, impl="fast")


def test_function_keeps_the_graph():
    layout = np.ones((H, 2, 2), np.int64)
    qt = torch.randn(1, H, 64, D, requires_grad=True)
    out = tsa.make_block_sparse_attention(layout, 32)(qt, qt.detach(), qt.detach())
    assert type(out.grad_fn).__name__ == BlockSparseAttentionFunction.__name__ + "Backward"
    out.sum().backward()
    assert qt.grad is not None and torch.isfinite(qt.grad).all()


def test_plain_outputs_are_contiguous_at_a_ragged_tail():
    """The plain versions return what the kernels return: contiguous
    tensors, which the kernels take back (the backward kernels read the
    forward's lse)."""
    from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention import (
        _delta, block_sparse_bwd_dkv_plain, block_sparse_bwd_dq_plain)
    layout = np.ones((H, 4, 4), np.int64)
    q, k, v = (_t(x) for x in qkv(8, t=100))
    q_idx, q_cnt, kv_idx, kv_cnt = (torch.from_numpy(a) for a in _index_tables(layout))
    out, lse = block_sparse_attention_plain(q, k, v, q_idx, q_cnt, 32)
    delta = _delta(out, q)
    dq = block_sparse_bwd_dq_plain(q, k, v, q, lse, delta, q_idx, q_cnt, 32)
    dk, dv = block_sparse_bwd_dkv_plain(q, k, v, q, lse, delta, kv_idx, kv_cnt, 32)
    for t in (out, lse, dq, dk, dv):
        assert t.is_contiguous() and t.shape[2] == 100
