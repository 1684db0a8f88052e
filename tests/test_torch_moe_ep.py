"""Expert parallelism across ranks: gloo worlds of 2 and 4 on the CPU
(``tests/torch_dist_workers.py``; each world under its own deadline).

Serving (``tiny-moe``, fp32, kernel injection: the plain versions of the
paged kernels here): at ep 2 and ep 4 every rank's greedy ``generate()``
rows, greedy and sampled scheduler streams with their logits, a radix hit
and int8-KV streams are bitwise the one-rank engine's, as the JAX package
asserts for its own expert axis (``tests/unit/inference/test_moe_decode.py``);
six experts over ep 4 serve replicated, bitwise too, with the JAX engine's
warning; and at top 3 (three terms a token: the combine's order shows).

Training (``tiny-moe``, fp32): the one-rank engine's losses are within
rtol 1e-4 of the JAX engine's on the same weights
(``tests/unit/test_models.py``'s tolerance), and at ep 2, ep 4 and ep 2 x
data 2 every rank's within rtol 1e-4 of the one-rank engine's, also at
``moe_capacity_factor`` 0.5 where tokens drop, with each layer's
drop fraction equal to the one-rank engine's and the global gradient norm
within rtol 1e-4 of it (AdamW would hide an expert gradient scaled by a
constant, such as one averaged twice); the dense parameters end
bitwise equal on every rank and each expert's on its data replicas.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.models as jm
from deepspeed_tpu.comm import comm as jcomm

from . import torch_dist_workers as workers
from .torch_dist_workers import run_world, serve_run, train_run
from .torch_port_helpers import numpy_params, to_numpy

SERVE = {"dtype": "float32", "kernel_inject": True, "max_out_tokens": 128}
PROMPTS = [[int(t) for t in np.random.default_rng(s).integers(0, 256, n)] for s, n in ((1, 21), (2, 5), (3, 37))]
NEW = 6
TRAIN = {"train_batch_size": 16, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
         "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}}, "steps_per_print": 10**9}
STEPS = 3


def _tree(num_experts=4, seed=11):
    return to_numpy(numpy_params(jm.get_model("tiny-moe", max_seq_len=128, num_experts=num_experts), seed))


def _same_streams(got, want):
    assert len(got) == len(want)
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt == wt
        np.testing.assert_array_equal(gl, wl)


def test_serving_across_expert_ranks_is_bitwise_one_rank(tmp_path):
    """ep 4, ep 2 (x data 2) and the replicated fallback at top 2; and ep 4
    at top 3, where a token sums three experts' outputs, so a combine in
    another order would show (two terms add the same either way)."""
    trees = {4: _tree(4), 6: _tree(6)}
    cases = [({"expert": 4}, {"num_experts": 4}, 4), ({"expert": 2}, {"num_experts": 4}, 4),
             ({"expert": 4}, {"num_experts": 6}, 6), ({"expert": 4}, {"num_experts": 4, "moe_top_k": 3}, 4)]
    want = {}
    for _, kw, E in cases:
        key = (E, kw.get("moe_top_k", 2))
        if key not in want:
            want[key] = serve_run("tiny-moe", trees[E], SERVE, PROMPTS, NEW, kw)
    assert want[4, 2]["radix_hit"] and want[4, 2]["desc"] == " moe[4e top2] ep=1"
    ranks = run_world(workers.serve_world, 4, tmp_path, "tiny-moe", trees, SERVE, PROMPTS, NEW, cases)
    for rank, got in enumerate(ranks):
        for (layout, kw, E), out in zip(cases, got):
            ep, k = layout["expert"], kw.get("moe_top_k", 2)
            if E % ep == 0:
                n = E // ep
                assert out["local_experts"] == ((rank // (4 // ep)) * n, n)
                assert out["desc"] == f" moe[{E}e top{k}] ep={ep} (expert-sharded, all-gather combine)"
                assert not out["warnings"]
            else:  # the replicated fallback, loudly
                assert out["local_experts"] is None
                assert out["desc"] == (f" moe[{E}e top{k}] ep={ep} (REPLICATED experts: num_experts={E} "
                                       f"doesn't divide the expert degree)")
                assert any(f"mesh expert={ep} but num_experts={E}" in w for w in out["warnings"])
            ref = want[E, k]
            assert out["generate"] == ref["generate"]
            assert out["radix_hit"]
            _same_streams(out["streams"], ref["streams"])
            _same_streams(out["int8_streams"], ref["int8_streams"])


def _jax_losses(tree, capacity_factor):
    jcomm._state["mesh"] = None
    model = jm.get_model("tiny-moe", dtype=jnp.float32, attention_impl="flash",
                         moe_capacity_factor=capacity_factor)
    engine, *_ = deepspeed_tpu.initialize(model=model, config=dict(TRAIN),
                                          model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
    batch = _batch()
    return [float(engine.train_batch(batch=batch)) for _ in range(STEPS)]


def _batch():
    return {"input_ids": np.random.default_rng(5).integers(0, 256, (16, 32)).astype(np.int32)}


@pytest.mark.parametrize("world,layouts", [(2, ((2, 1), )), (4, ((4, 1), (2, 2)))])
def test_training_across_expert_ranks_matches_one_rank_and_jax(tmp_path, world, layouts):
    tree = _tree()
    cases, want = [], {}
    for cf in (1.25, 0.5):
        want[cf] = train_run("tiny-moe", tree, TRAIN, _batch(), STEPS, {"moe_capacity_factor": cf})
        if world == 2:  # one rank against JAX once; the worlds against one rank
            np.testing.assert_allclose(want[cf]["losses"], _jax_losses(tree, cf), rtol=1e-4)
        for ep, data in layouts:
            cases.append(({**TRAIN, "mesh": {"expert_parallel_size": ep, "data_parallel_size": data}},
                          {"moe_capacity_factor": cf}))
    assert want[0.5]["drop_frac"].min() > 0  # tokens drop at capacity factor 0.5
    ranks = run_world(workers.train_world, world, tmp_path, "tiny-moe", tree, _batch(), STEPS, cases)
    for i, (config, kw) in enumerate(cases):
        cf, ep = kw["moe_capacity_factor"], config["mesh"]["expert_parallel_size"]
        data = world // ep
        for rank in range(world):
            got = ranks[rank][i]
            assert got["dp"] == world
            np.testing.assert_allclose(got["losses"], want[cf]["losses"], rtol=1e-4)
            # Adam hides a gradient scaled by a constant; the global norm does not
            np.testing.assert_allclose(got["grad_norms"], want[cf]["grad_norms"], rtol=1e-4)
            np.testing.assert_array_equal(got["drop_frac"], want[cf]["drop_frac"])
            e = rank // data  # this rank's index on the expert axis
            assert got["local_experts"] == (e * (4 // ep), 4 // ep)
            # replicas: the dense tensors on every rank, the experts on the data group
            for k, v in got["master"].items():
                peers = range(world) if ".moe.experts." not in k else range(e * data, (e + 1) * data)
                for r in peers:
                    np.testing.assert_array_equal(ranks[r][i]["master"][k], v)
