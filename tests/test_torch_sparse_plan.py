"""The block-sparse kernels' work plan (``WorkPlan`` in
``deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention``): the
forward, dq and dk/dv kernels cut a walk longer than the chunk length at
fixed table positions, run the pieces on separate CTAs and merge them in
piece order (dq on the forward's plan of the q table). Here, on the CPU: the plan covers every (head, row, table position)
exactly once in table order, no piece is longer than the chunk, only rows
longer than the chunk are split, and the plan does not depend on the batch;
the plain versions, which follow the plan and merge as the kernels do, agree
with the JAX kernels (``jax.vjp`` of ``make_block_sparse_attention``, Pallas
in interpret mode) with global rows and columns split into 3 or more pieces,
at blocks 16 and 32, fp32 and bf16; and the split plan agrees with the
one-piece plan. Inputs are made with numpy from a seed (B 2, H 2, T 256,
D 64, as ``test_torch_sparse_attention.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.sparse_attention as jsa
import deepspeed_tpu_torch.ops.sparse_attention as tsa
from deepspeed_tpu_torch.ops.sparse_attention.block_sparse_attention import (
    CHUNK, WorkPlan, _index_tables, block_sparse_attention_plain, block_sparse_bwd_dkv_plain,
    block_sparse_bwd_dq_plain)

B, H, T, D = 2, 2, 256, 64

# the tolerances of test_torch_sparse_attention.py's test_forward_matches_jax
# and test_gradients_match_jax (fp32), and of their bf16 forms
ATOL_OUT = 2e-5
ATOL_GRAD = 5e-5
# split plan against one-piece plan, fp32: the same products, the walk's
# online softmax (or sum) carried through the merge instead of straight on;
# they part by float32 rounding only
SPLIT_ATOL = 2e-6


def _layouts(block):
    """(name, layout, causal): BigBird with a global row and column (every
    block), and Fixed unidirectional, whose global columns are read by up to
    every later q block."""
    nb = T // block
    bigbird = tsa.BigBirdSparsityConfig(H, block=block, num_random_blocks=1, num_sliding_window_blocks=3,
                                        num_global_blocks=1).make_layout(T)
    fixed = tsa.FixedSparsityConfig(H, block=block, num_local_blocks=2,
                                    attention="unidirectional").make_layout(T)
    assert bigbird[:, 0].sum(-1).max() == nb and fixed.sum(-2).max() >= nb // 2
    return {"bigbird": (bigbird, False), "fixed-uni": (fixed, True)}


# chunk lengths that cut the longest walks into 3 or more pieces
SMALL_CHUNK = {16: 5, 32: 2}


def _check_cover(plan, cnt):
    """Every (head, row, table position) exactly once, in table order."""
    rows, n = cnt.shape[0] * cnt.shape[1], cnt.reshape(-1)
    seen = {r: [] for r in range(rows)}
    for x, start, length, split in plan.items[np.lexsort((plan.items[:, 1], plan.items[:, 0]))]:
        seen[int(x)].append((int(start), int(length), int(split)))
    for r in range(rows):
        pieces = seen[r]
        assert pieces, f"row {r} has no item"
        pos = [p for start, length, _ in pieces for p in range(start, start + length)]
        assert pos == list(range(n[r])), f"row {r}: positions {pos} of {n[r]}"
        if len(pieces) > 1:  # a split row: consecutive pieces at multiples of the chunk
            sid = pieces[0][2]
            assert sid >= 0 and all(p[2] == sid for p in pieces)
            assert [p[0] for p in pieces] == [i * plan.chunk for i in range(len(pieces))]
            first, count = plan.splits[sid]
            assert count == len(pieces)
        else:
            assert pieces[0][2] == -1


@pytest.mark.parametrize("chunk", [None, 1, 3, 8, 64])
@pytest.mark.parametrize("block", [16, 32])
def test_plan_covers_every_position_once_in_order(block, chunk):
    for layout, _ in _layouts(block).values():
        _, q_cnt, _, kv_cnt = _index_tables(layout)
        for cnt in (q_cnt, kv_cnt):
            plan = WorkPlan(cnt, chunk)
            _check_cover(plan, cnt)
            assert plan.items.dtype == np.int32 and plan.splits.dtype == np.int32
            assert plan.items[:, 2].max() <= plan.chunk  # no piece longer than the chunk
            assert (np.diff(plan.items[:, 2]) <= 0).all()  # longest first
            # the split rows' partials are numbered in (head, row) order, back to back
            assert plan.splits[:, 0].tolist() == (np.cumsum(plan.splits[:, 1]) - plan.splits[:, 1]).tolist()
            assert plan.n_partials == int(plan.splits[:, 1].sum())


@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_only_rows_longer_than_the_chunk_are_split(block):
    layout = tsa.BigBirdSparsityConfig(4, block=block).make_layout(4096 if block >= 64 else 2048)
    _, q_cnt, _, kv_cnt = _index_tables(layout)
    for cnt in (q_cnt, kv_cnt):
        plan = WorkPlan(cnt, CHUNK[block])
        split_rows = sorted({int(x) for x, _, _, s in plan.items if s >= 0})
        assert split_rows == np.nonzero(cnt.reshape(-1) > CHUNK[block])[0].tolist()
        assert len(plan.items) == sum(max(1, -(-int(c) // CHUNK[block])) for c in cnt.reshape(-1))
    one = WorkPlan(q_cnt)  # chunk None: one piece a row, whatever its length
    assert len(one.splits) == 0 and len(one.items) == q_cnt.size and one.n_partials == 0


def test_plan_depends_on_the_layout_alone():
    """The plan a layout's attention function caches is built once, from the
    layout; batches of 1 and 3 run the same plan (and the same bits for the
    entries they share)."""
    layout, causal = _layouts(16)["bigbird"]
    attn = tsa.make_block_sparse_attention(layout, 16, causal=causal)
    plans = attn.plans
    items = [p.items.copy() for p in plans]
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.standard_normal((3, H, T, D)).astype(np.float32))
    out3 = attn(x, x, x)
    out1 = attn(x[1:2], x[1:2], x[1:2])
    assert attn.plans is plans and all(np.array_equal(p.items, i) for p, i in zip(plans, items))
    again = WorkPlan(_index_tables(layout)[1], CHUNK[16])
    assert np.array_equal(again.items, plans[0].items) and np.array_equal(again.splits, plans[0].splits)
    assert torch.equal(out3[1:2], out1)


def test_workspace_is_sized_by_the_split_rows():
    layout, _ = _layouts(16)["bigbird"]
    _, q_cnt, _, _ = _index_tables(layout)
    plan = WorkPlan(q_cnt, SMALL_CHUNK[16])
    pieces = sum(-(-int(c) // SMALL_CHUNK[16]) for c in q_cnt.reshape(-1) if c > SMALL_CHUNK[16])
    assert plan.workspace_floats(3, 16, D + 2) == pieces * 3 * 16 * (D + 2)
    assert WorkPlan(q_cnt).workspace_floats(3, 16, D + 2) == 0


@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_dq_workspace_is_pieces_by_batch_by_block_by_head_dim(block):
    """dq takes the forward's plan, and its partials are a plain sum: D
    floats a row of every piece of a split row, no softmax state."""
    layout = tsa.BigBirdSparsityConfig(4, block=block).make_layout(4096 if block >= 64 else 2048)
    _, q_cnt, _, _ = _index_tables(layout)
    attn = tsa.make_block_sparse_attention(layout, block, causal=False)
    plan = attn.plans[0]
    assert np.array_equal(plan.items, WorkPlan(q_cnt, CHUNK[block]).items)
    pieces = sum(-(-int(c) // CHUNK[block]) for c in q_cnt.reshape(-1) if c > CHUNK[block])
    assert pieces > 0 and plan.n_partials == pieces
    assert plan.workspace_floats(2, block, 128) == pieces * 2 * block * 128


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def _np32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_reference(name, block, bf16):
    """(layout, causal, q, k, v, do, out, (dq, dk, dv)) of the JAX kernels
    through ``jax.vjp``, numpy fp32."""
    layout, causal = _layouts(block)[name]
    r = np.random.default_rng(21 + block + bf16)
    q, k, v, do = (r.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(4))
    cast = (lambda x: x.astype(jnp.bfloat16)) if bf16 else (lambda x: x)
    attend = jsa.make_block_sparse_attention(layout, block, causal=causal)
    out, vjp = jax.vjp(attend, *(cast(jnp.asarray(x)) for x in (q, k, v)))
    return layout, causal, q, k, v, do, _np32(out), tuple(_np32(g) for g in vjp(cast(jnp.asarray(do))))


def _split_attention(layout, block, causal, chunk):
    """The port's attention function with both plans cut every ``chunk``
    positions; asserts that some walk is cut into 3 or more pieces."""
    attn = tsa.make_block_sparse_attention(layout, block, causal=causal)
    _, q_cnt, _, kv_cnt = attn.np_tables
    attn.plans = (WorkPlan(q_cnt, chunk), WorkPlan(kv_cnt, chunk))
    assert max(int(p.splits[:, 1].max(initial=0)) for p in attn.plans) >= 3
    return attn


def _port(attn, q, k, v, do, dtype):
    qt, kt, vt = (_t(x, dtype).requires_grad_(True) for x in (q, k, v))
    out = attn(qt, kt, vt)
    out.backward(_t(do, dtype))
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in (qt, kt, vt)]


@pytest.mark.parametrize("name", ["bigbird", "fixed-uni"])
@pytest.mark.parametrize("block", [16, 32])
def test_split_walks_match_jax(name, block):
    """fp32: the split forward and dk/dv (and dq) against the JAX kernels,
    within test_forward_matches_jax's and test_gradients_match_jax's
    tolerances."""
    layout, causal, q, k, v, do, want, grads = _jax_reference(name, block, False)
    attn = _split_attention(layout, block, causal, SMALL_CHUNK[block])
    out, got = _port(attn, q, k, v, do, torch.float32)
    np.testing.assert_allclose(out, want, atol=ATOL_OUT, rtol=ATOL_OUT)
    for tag, a, b in zip("qkv", got, grads):
        np.testing.assert_allclose(a, b, atol=ATOL_GRAD, rtol=ATOL_GRAD, err_msg=f"d{tag}")


@pytest.mark.parametrize("block", [16, 32])
def test_split_walks_match_jax_bf16(block):
    """bf16: each piece rounds p at its own running max, so the outputs part
    from JAX's by one bf16 ulp at the largest magnitude at most (2^-7 of
    max|JAX|), the gradients by 2^-6 (test_torch_sparse_attention.py's bf16
    rules)."""
    layout, causal, q, k, v, do, want, grads = _jax_reference("bigbird", block, True)
    attn = _split_attention(layout, block, causal, SMALL_CHUNK[block])
    out, got = _port(attn, q, k, v, do, torch.bfloat16)
    np.testing.assert_allclose(out, want, rtol=0, atol=2.0**-7 * np.abs(want).max())
    for tag, a, b in zip("qkv", got, grads):
        np.testing.assert_allclose(a, b, rtol=0, atol=2.0**-6 * np.abs(b).max(), err_msg=f"d{tag}")


@pytest.mark.parametrize("name", ["bigbird", "fixed-uni"])
@pytest.mark.parametrize("block", [16, 32])
def test_split_plan_matches_one_piece_plan(name, block):
    """fp32: out, lse, dq, dk and dv of the split plan within SPLIT_ATOL of
    the one-piece plan's; a one-piece plan is today's walk (the merge of one
    piece is exact), bitwise the plan-free call's."""
    layout, causal = _layouts(block)[name]
    r = np.random.default_rng(block)
    q, k, v, do = (torch.from_numpy(r.standard_normal((B, H, T, D)).astype(np.float32)) for _ in range(4))
    q_idx, q_cnt, kv_idx, kv_cnt = (torch.from_numpy(a) for a in _index_tables(layout))
    split = (WorkPlan(q_cnt.numpy(), SMALL_CHUNK[block]), WorkPlan(kv_cnt.numpy(), SMALL_CHUNK[block]))
    whole = (WorkPlan(q_cnt.numpy()), WorkPlan(kv_cnt.numpy()))
    res = []
    for plans in (split, whole):
        out, lse = block_sparse_attention_plain(q, k, v, q_idx, q_cnt, block, causal, plan=plans[0])
        delta = (do * out).sum(-1)
        dq = block_sparse_bwd_dq_plain(q, k, v, do, lse, delta, q_idx, q_cnt, block, causal, plan=plans[0])
        res.append((out, lse, dq, *block_sparse_bwd_dkv_plain(q, k, v, do, lse, delta, kv_idx, kv_cnt,
                                                              block, causal, plan=plans[1])))
    for tag, a, b in zip(("out", "lse", "dq", "dk", "dv"), *res):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=SPLIT_ATOL, err_msg=tag)
    out, lse = block_sparse_attention_plain(q, k, v, q_idx, q_cnt, block, causal)
    delta = (do * out).sum(-1)
    default = (out, lse, block_sparse_bwd_dq_plain(q, k, v, do, lse, delta, q_idx, q_cnt, block, causal))
    assert all(torch.equal(a, b) for a, b in zip(default, res[1][:3]))  # None: one piece a row


def test_plan_must_fit_the_table():
    layout, causal = _layouts(32)["bigbird"]
    q_idx, q_cnt, kv_idx, kv_cnt = (torch.from_numpy(a) for a in _index_tables(layout))
    x = torch.zeros((1, H, T, D))
    with pytest.raises(ValueError, match="does not fit"):
        block_sparse_attention_plain(x, x, x, q_idx, q_cnt, 32, causal, plan=WorkPlan(q_cnt[:1].numpy()))
