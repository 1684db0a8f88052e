"""The port's ring attention (``deepspeed_tpu_torch/ops/ring_attention.py``)
against the JAX package's (``deepspeed_tpu/ops/pallas/ring_attention.py``),
fp32 on the CPU.

The JAX side runs as ``tests/unit/ops/test_ring_attention.py`` runs it:
``ring_attention_local`` and the zig-zag schedule inside ``shard_map`` on
the conftest's CPU devices, the Pallas flash kernels in interpret mode.
The port's side runs in gloo worlds of 2 and 4
(``tests/torch_dist_workers.py::ring_world``), each rank on its chunk of
the same q, k, v, the flash kernels' plain versions standing in. Causal
and full, GQA (4 query heads on 2 kv heads), zig-zag and unbalanced:
outputs within ``FWD_TOL`` and the gradients of ``sum(out * w)`` in q, k
and v within ``GRAD_TOL`` of one whole-sequence flash call, and of JAX's
ring for the cases of ``JAX_CASES`` (its interpret-mode kernels take
10-30 s a case); zig-zag within ``FWD_TOL`` of unbalanced; the relayout
puts chunks i and 2n-1-i on rank i and its inverse restores the input
bitwise. ``_merge`` with a nonzero
lse cotangent (a loss on the merged lse) against JAX's ``_merge`` through
``jax.grad``, and against one attention over the union of the keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from deepspeed_tpu.ops.pallas import ring_attention as jra
from deepspeed_tpu.ops.pallas.flash_attention import flash_attention_with_lse as jax_flash_lse
from deepspeed_tpu_torch.ops import ring_attention as ra
from deepspeed_tpu_torch.ops.flash_attention import flash_attention, flash_attention_with_lse

from . import torch_dist_workers as workers
from .torch_dist_workers import run_world

B, H, T, D = 1, 4, 256, 64
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
CASES = {"causal_unbalanced": ("mha", True, "unbalanced"), "causal_zigzag": ("mha", True, "zigzag"),
         "full": ("mha", False, "zigzag"), "gqa_zigzag": ("gqa", True, "zigzag"),
         "gqa_unbalanced": ("gqa", True, "unbalanced")}
JAX_CASES = {2: ("causal_zigzag", "full", "gqa_unbalanced"), 4: ("causal_unbalanced", "gqa_zigzag")}


def _inputs(seed, hkv):
    r = np.random.default_rng(seed)
    f = np.float32
    return {"q": r.standard_normal((B, H, T, D)).astype(f), "k": r.standard_normal((B, hkv, T, D)).astype(f),
            "v": r.standard_normal((B, hkv, T, D)).astype(f), "w": r.standard_normal((B, H, T, D)).astype(f)}


INPUTS = {"mha": _inputs(1, H), "gqa": _inputs(2, 2),
          "relayout": np.arange(B * H * T * D, dtype=np.float32).reshape(B, H, T, D)}


def _jax_ring(n, key, causal, schedule):
    """JAX's out and gradients of sum(out * w) over a seq mesh of ``n``."""
    x = {k: jnp.asarray(v) for k, v in INPUTS[key].items()}
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(n), ("seq", ))
    spec = P(None, None, "seq", None)

    def local(q, k, v):
        if schedule == "zigzag" and causal:
            qz, kz, vz = (jra._zigzag_relayout(t, "seq", n) for t in (q, k, v))
            out = jra.zigzag_ring_attention_local(qz, kz, vz, "seq", block_q=64, block_kv=64)
            return jra._zigzag_relayout(out, "seq", n, inverse=True)
        return jra.ring_attention_local(q, k, v, "seq", causal, block_q=64, block_kv=64)

    fn = jax.shard_map(local, mesh=mesh, in_specs=(spec, ) * 3, out_specs=spec, check_vma=False)
    out = fn(x["q"], x["k"], x["v"])
    grads = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * x["w"]), argnums=(0, 1, 2))(x["q"], x["k"], x["v"])
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_forward_and_backward(n, tmp_path):
    """Every case of ``CASES`` at seq ``n``: each rank's chunk of the output
    and of dq, dk, dv against one flash call over the whole sequence, and
    those of ``JAX_CASES`` against JAX's ring at the same mesh; zig-zag
    within ``FWD_TOL`` of unbalanced."""
    ranks = run_world(workers.ring_world, n, tmp_path, INPUTS, CASES)
    got = {name: [np.concatenate([r[name][i] for r in ranks], axis=2) for i in range(4)] for name in CASES}
    for name, (key, causal, schedule) in CASES.items():
        x = INPUTS[key]
        leaves = [torch.from_numpy(x[t]).requires_grad_(True) for t in "qkv"]
        out = flash_attention(*leaves, causal=causal)
        (out * torch.from_numpy(x["w"])).sum().backward()
        refs = [("dense", [out.detach().numpy()] + [t.grad.numpy() for t in leaves])]
        if name in JAX_CASES[n]:
            refs.append(("JAX", _jax_ring(n, key, causal, schedule)))
        for what, want in refs:
            for tag, g, w in zip(("out", "dq", "dk", "dv"), got[name], want):
                tol = FWD_TOL if tag == "out" else GRAD_TOL
                np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=f"{name} {tag} vs {what}")
    for a, b in (("causal_zigzag", "causal_unbalanced"), ("gqa_zigzag", "gqa_unbalanced")):
        np.testing.assert_allclose(got[a][0], got[b][0], atol=FWD_TOL, err_msg=f"{a} vs {b}")
    # the relayout: rank i holds chunks (i, 2n-1-i); the inverse is the identity
    x = INPUTS["relayout"]
    c = T // (2 * n)
    chunks = x.reshape(B, H, 2 * n, c, D)
    for i, r in enumerate(ranks):
        z, back = r["relayout"]
        np.testing.assert_array_equal(z[:, :, :c], chunks[:, :, i])
        np.testing.assert_array_equal(z[:, :, c:], chunks[:, :, 2 * n - 1 - i])
        np.testing.assert_array_equal(back, x[:, :, i * 2 * c:(i + 1) * 2 * c])


def test_merge_carries_the_lse_cotangent():
    """Two flash calls over disjoint key halves merged by ``_merge``: the
    output and the lse equal one attention over all keys, and the
    gradients of a loss on both (a nonzero lse cotangent through the
    merge weights and into the flash backward's delta) equal JAX's
    ``_merge`` over its ``flash_attention_with_lse`` through ``jax.grad``;
    a side that attended nothing (lse -inf) passes no NaN."""
    x = INPUTS["gqa"]
    r = np.random.default_rng(5)
    wl = r.standard_normal((B, H, T)).astype(np.float32)
    half = T // 2

    def torch_loss(q, k, v):
        o1, l1 = flash_attention_with_lse(q, k[:, :, :half], v[:, :, :half], causal=False)
        o2, l2 = flash_attention_with_lse(q, k[:, :, half:], v[:, :, half:], causal=False)
        out, lse = ra._merge(o1, l1, o2, l2)
        return out, lse, (out * torch.from_numpy(x["w"])).sum() + (lse * torch.from_numpy(wl)).sum()

    leaves = [torch.from_numpy(x[t]).requires_grad_(True) for t in "qkv"]
    out, lse, loss = torch_loss(*leaves)
    loss.backward()
    ref, ref_lse = flash_attention_with_lse(*(torch.from_numpy(x[t]) for t in "qkv"), causal=False)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), atol=FWD_TOL)
    np.testing.assert_allclose(lse.detach().numpy(), ref_lse.numpy(), atol=FWD_TOL, rtol=FWD_TOL)

    def jax_loss(q, k, v):
        o1, l1 = jax_flash_lse(q, k[:, :, :half], v[:, :, :half], False, 64, 64, None)
        o2, l2 = jax_flash_lse(q, k[:, :, half:], v[:, :, half:], False, 64, 64, None)
        o, lse = jra._merge(o1, l1, o2, l2)
        return jnp.sum(o * x["w"]) + jnp.sum(lse * wl)

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(jnp.asarray(x[t]) for t in "qkv"))
    for tag, t, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"d{tag}")
    # one side empty: the merge is the other side, and gradients stay finite
    o = torch.from_numpy(x["q"]).requires_grad_(True)
    l1 = torch.zeros((B, H, T), requires_grad=True)
    empty = torch.full((B, H, T), float("-inf"))
    m_out, m_lse = ra._merge(o, l1, torch.zeros_like(o), empty)
    (m_out.sum() + m_lse.sum()).backward()
    np.testing.assert_array_equal(m_out.detach().numpy(), x["q"])
    assert torch.isfinite(o.grad).all() and torch.isfinite(l1.grad).all()
    both, both_lse = ra._merge(torch.zeros_like(o), empty, torch.zeros_like(o), empty)
    assert torch.equal(both, torch.zeros_like(both)) and torch.isinf(both_lse).all()


def test_group_of_one_and_schedule_names():
    """Without a seq group the ring is one flash call; an unknown schedule
    raises."""
    q, k, v = (torch.from_numpy(INPUTS["gqa"][t]) for t in "qkv")
    for schedule in ("zigzag", "unbalanced"):
        assert torch.equal(ra.ring_attention(q, k, v, schedule=schedule), flash_attention(q, k, v))
    with pytest.raises(ValueError, match="'zigzag' or 'unbalanced'"):
        ra.ring_attention(q, k, v, schedule="striped")
    assert ra._zigzag_mapping(2) == jra._zigzag_mapping(2) and \
        ra._zigzag_mapping(4, inverse=True) == jra._zigzag_mapping(4, inverse=True)
