"""Tensor parallelism across ranks: gloo worlds of 2 and 4 on the CPU
(``tests/torch_dist_workers.py``; each world spawns once for its cases,
under its own deadline). The plain versions of the kernels stand in for
the kernels here.

Serving (the bitwise all-gather layout, ``TransformerConfig.bitwise_tp``):
at tp 2 every rank's ``generate()`` rows (greedy and sampled), the
scheduler's greedy and sampled streams with their logits, a radix hit,
the int8-KV streams, a speculative scheduler's streams and logits, a
long-context stream chained over two extents and the prefill logits are
bitwise the one-rank engine's, on ``tiny`` in fp32 and
``tiny-gpt2`` in int8 (per projection: the fused decode layer is off at
tp > 1, and the tp 1 reference runs it off too); the port's tp 1 greedy
``generate()`` rows, greedy streams on both pools and speculative streams
equal the JAX engine's at tp 1, logits within 1e-4 of max|ref| (``tests/test_torch_scheduler.py``'s bound; JAX's
own tp 2 speculative check fails in the reference, ROADMAP Queue 3). Head
counts tp does not divide (``hidden_size=96, num_heads=6,
num_kv_heads=3``) serve REPLICATED with the JAX warning and ready line,
bitwise too. ``tiny-moe`` at expert 2 x tensor 2 (world 4) is bitwise the
one-rank engine.

Training (Megatron rules, fp32, AdamW, clip 1.0, three steps): tp 2 and
tp 2 x dp 2 at ZeRO stages 0-3 (at tp 2 x dp 2, stage 3 also at the
default persistence threshold and at 64), tp 4 x stage 1
(``num_kv_heads=4``) and
``tiny-moe`` at expert 2 x tensor 2: every rank's losses and global
gradient norms within rtol 2e-4 of the one-rank engine's and of the JAX
engine at the same tensor degree (``tests/unit/test_models.py`` holds its
own tp 2 to 1e-4), the gathered masters bitwise the same on every rank and
within 1e-4 of the one-rank engine's (a tenth of an AdamW step at lr 1e-3:
an element whose gradient is near zero moves by up to lr on a reordered
sum);
a remat policy and dropout at tp 2 within the same bound, every dropout
mask bitwise the one drawn at tp 1, and the gradients of the tensors kept
whole over ``tensor`` bitwise equal on the ranks of a tensor group; a
checkpoint saved at tp 2 (stage 3) resumes at tp 1 x dp 2 with its master
bitwise.

The region operators' forward and backward, and each ``sharded_*``
wrapper against its unsharded call, run on a world of 2.
"""

import jax
import jax.numpy as jnp
import numpy as np

import deepspeed_tpu
import deepspeed_tpu.models as jm
from deepspeed_tpu.comm import comm as jcomm

from . import torch_dist_workers as workers
from .torch_dist_workers import run_world, tp_serve_run, zero_run
from .torch_port_helpers import numpy_params, to_numpy

SERVE = {"kernel_inject": True, "max_out_tokens": 128, "fused_decode_block": False}
PROMPTS = [[int(t) for t in np.random.default_rng(s).integers(0, 256, n)] for s, n in ((1, 21), (2, 5), (3, 37))]
NEW = 6
TRAIN = {"train_batch_size": 16, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
         "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}}, "steps_per_print": 10**9}
STEPS = 3
RTOL = 2e-4
ODD = {"hidden_size": 96, "num_heads": 6, "num_kv_heads": 3}  # kv heads 3 % 2 != 0


def _tree(name, seed=0, **kw):
    return to_numpy(numpy_params(jm.get_model(name, dtype=jnp.float32, attention_impl="flash", **kw), seed))


def _batch():
    return {"input_ids": np.random.default_rng(1).integers(0, 256, (16, 64)).astype(np.int32)}


def _zero(stage, tp=1, threshold=0, **extra):
    """The config at ``stage`` and tensor degree ``tp``; ``threshold`` None
    leaves the stage-3 persistence threshold at its default."""
    mesh = {"tensor_parallel_size": tp} if tp > 1 else {}
    keep = {} if threshold is None else {"stage3_param_persistence_threshold": threshold}
    return {**TRAIN, "mesh": {**mesh, **extra.pop("mesh", {})},
            "zero_optimization": {"stage": stage, **keep}, **extra}


def _same(got, want, what=""):
    """Nested results bitwise equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


BITWISE = ("generate", "sampled", "streams", "int8_streams", "radix_hit", "prefill_logits", "spec", "long")

# ---------------------------------------------------------------------------
# the region operators and the sharded wrappers


def test_region_operators_and_sharded_wrappers(tmp_path):
    rng = np.random.default_rng(4)
    f32 = np.float32
    inputs = {"x": rng.standard_normal((2, 3, 5)).astype(f32), "g": rng.standard_normal((3, 5)).astype(f32),
              "attn": {"q": rng.standard_normal((2, 4, 128, 16)).astype(f32),
                       "k": rng.standard_normal((2, 2, 128, 16)).astype(f32),
                       "v": rng.standard_normal((2, 2, 128, 16)).astype(f32),
                       "qd": rng.standard_normal((3, 4, 16)).astype(f32),
                       "qs": rng.standard_normal((3, 4, 5, 16)).astype(f32),
                       "kc": rng.standard_normal((3, 2, 256, 16)).astype(f32),
                       "vc": rng.standard_normal((3, 2, 256, 16)).astype(f32),
                       "ends": np.array([40, 256, 9], np.int32)}}
    ranks = run_world(workers.tp_ops_world, 2, tmp_path, inputs)
    x, g = inputs["x"], inputs["g"]
    for rank, out in enumerate(ranks):
        # copy: identity forward, the gradients summed backward
        np.testing.assert_array_equal(out["copy"][0], x[rank])
        np.testing.assert_array_equal(out["copy"][1], g + g)
        # reduce: the sum forward, the gradient as it is backward
        np.testing.assert_array_equal(out["reduce"][0], x[0] + x[1])
        np.testing.assert_array_equal(out["reduce"][1], g)
        # gather: the concatenation in rank order forward, this rank's slice back
        np.testing.assert_array_equal(out["gather"][0], np.concatenate([x[0], x[1]], -1))
        np.testing.assert_array_equal(out["gather"][1], g)
        for name in ("flash", "paged_decode", "paged_span", "extent_decode", "extent_span"):
            sharded, whole = out[name]
            np.testing.assert_array_equal(sharded, whole, err_msg=name)
        assert "do not divide the tensor degree 2" in out["odd_heads"]


# ---------------------------------------------------------------------------
# serving


def _jax_serving(name, tree, prompts):
    """The JAX engine at tp 1 (per projection, the scheduler settings of
    ``serve_streams``): greedy ``generate()`` rows of the first two
    prompts, and the greedy streams with their logits on a full-precision
    pool, an int8 KV pool and a speculative scheduler's."""
    from deepspeed_tpu.telemetry import set_sink
    out = {}
    for key, kw in (("streams", {}), ("int8_streams", {"kv_cache_dtype": "int8"}), ("spec", {"spec_tokens": 3})):
        jcomm._state["mesh"] = None
        set_sink(None)
        config = {"dtype": "float32", "continuous_batching": {"enabled": True, "num_slots": 4,
                                                              "collect_logits": True}}
        eng = deepspeed_tpu.init_inference(jm.get_model(name, max_seq_len=128), config=config, params=tree)
        sched = eng.scheduler(prefill_chunk=16, **kw)
        hs = [sched.submit(p, max_new_tokens=NEW) for p in prompts]
        out[key] = [(h.result().tolist(), h.result_logits()) for h in hs]
    out["generate"] = [np.asarray(r).tolist() for r in eng.generate(prompts[:2], max_new_tokens=NEW)]
    return out


def _near_jax(got, want):
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-4 * np.abs(wl).max())


def test_serving_tp2_is_bitwise_tp1(tmp_path):
    """tiny fp32, tiny-gpt2 int8 and the replicated fallback at tp 2 on a
    world of 2, against the one-rank engine (and tiny's against JAX)."""
    trees = {"tiny": _tree("tiny"), "gpt2": _tree("tiny-gpt2"), "odd": _tree("tiny", **ODD)}
    fp32, int8 = {"dtype": "float32"}, {"dtype": "int8"}
    seq, odd_kw = {"max_seq_len": 128}, {"max_seq_len": 128, **ODD}
    cases = [({"tensor": 2}, "tiny", seq, "tiny", fp32, True), ({"tensor": 2}, "tiny", odd_kw, "odd", fp32, True),
             ({"tensor": 2}, "tiny-gpt2", seq, "gpt2", int8, True)]
    want = [tp_serve_run(name, trees[key], {**SERVE, **over}, PROMPTS, NEW, kw)
            for _, name, kw, key, over, _ in cases]
    assert want[0]["desc"] == "tp=1" and want[0]["radix_hit"]
    assert want[2]["desc"] == "tp=1 int8_fused_qkv=on"
    # the port's tp 1 against JAX's: greedy generate() and streams, the int8
    # KV pool and the speculative path (the port's sampling draws from its
    # own counter hash, not jax.random: sampled streams are held tp 1 only)
    jax_ref = _jax_serving("tiny", trees["tiny"], PROMPTS)
    assert want[0]["generate"] == jax_ref["generate"]
    for key in ("streams", "int8_streams", "spec"):
        _near_jax(want[0][key][:3], jax_ref[key])
    ranks = run_world(workers.tp_serve_world, 2, tmp_path, trees, SERVE, PROMPTS, NEW, cases)
    for rank in range(2):
        tiny, odd, g = ranks[rank]
        for k in BITWISE:
            _same(tiny[k], want[0][k], f"tiny rank {rank} {k}")
            _same(odd[k], want[1][k], f"odd rank {rank} {k}")
            _same(g[k], want[2][k], f"tiny-gpt2 int8 rank {rank} {k}")
        assert tiny["desc"] == "tp=2 (bitwise all-gather layout, kv_heads sharded /2)"
        assert tiny["local_heads"] == (2, 1) and tiny["bitwise"] and not tiny["warnings"]
        assert tiny["long_extents"] > 0  # the extent modes ran on this rank's kv heads
        assert g["desc"].startswith("tp=2 (bitwise all-gather layout, kv_heads sharded /2) int8_fused_qkv=off ")
        assert "component boundaries" in g["desc"] and not g["fused"]
        assert any("fused-qkv decode disabled under tensor parallelism" in w for w in g["warnings"])
        # the replicated fallback, loudly
        assert odd["desc"] == ("tp=2 (REPLICATED fallback: num_heads=6/kv_heads=3 don't divide the "
                               "tensor degree)")
        assert odd["local_heads"] == (6, 3) and not odd["bitwise"]
        assert any("mesh tensor=2 but head counts (num_heads=6, kv_heads=3) don't divide it" in w
                   for w in odd["warnings"])


def test_serving_moe_expert2_tensor2_is_bitwise_one_rank(tmp_path):
    tree = _tree("tiny-moe", seed=11)
    cfg = {**SERVE, "dtype": "float32"}
    want = tp_serve_run("tiny-moe", tree, cfg, PROMPTS, NEW, {"max_seq_len": 128}, spec=False)
    ranks = run_world(workers.tp_serve_world, 4, tmp_path, {"t": tree}, cfg, PROMPTS, NEW,
                      [({"expert": 2, "tensor": 2}, "tiny-moe", {"max_seq_len": 128}, "t", {}, False)])
    for rank, (got, ) in enumerate(ranks):
        for k in BITWISE[:-2]:
            _same(got[k], want[k], f"rank {rank} {k}")
        assert got["desc"] == ("tp=2 (bitwise all-gather layout, kv_heads sharded /2) moe[4e top2] ep=2 "
                               "(expert-sharded, all-gather combine)")


# ---------------------------------------------------------------------------
# training


def _jax_run(name, tree, config, **model_kw):
    jcomm._state["mesh"] = None
    model = jm.get_model(name, dtype=jnp.float32, attention_impl="flash", **model_kw)
    engine, *_ = deepspeed_tpu.initialize(model=model, config=config,
                                          model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
    batch, out = _batch(), {"losses": [], "norms": []}
    for _ in range(STEPS):
        out["losses"].append(float(engine.train_batch(batch=batch)))
        out["norms"].append(float(engine._last_metrics["grad_norm"]))
    return out


def _check_runs(ranks, idx, ref, jax_ref, what):
    for i in idx:
        for rank, res in enumerate(ranks):
            got = res["runs"][i]
            # the grad norm first: a gradient off by a constant factor shows
            # there at the first step (AdamW hides it from the first loss)
            for key in ("norms", "losses"):
                np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, err_msg=f"{what} case {i} {key}")
                if jax_ref is not None:
                    np.testing.assert_allclose(got[key], jax_ref[key], rtol=RTOL,
                                               err_msg=f"{what} case {i} {key} vs JAX")
            for k, whole in got["master"].items():
                want = ref["master"][k]
                if ".moe.experts." in k and whole.shape != want.shape:  # this rank's experts
                    n = whole.shape[0]
                    want = want[got["rank"]["expert"] * n:(got["rank"]["expert"] + 1) * n]
                else:  # gathered whole over data and tensor, bitwise on every rank
                    np.testing.assert_array_equal(whole, ranks[0]["runs"][i]["master"][k], err_msg=k)
                # AdamW steps an element whose gradient is near zero by anything
                # up to lr (1e-3) on a reordered sum: a tenth of a step
                np.testing.assert_allclose(whole, want, rtol=RTOL, atol=1e-4, err_msg=k)


def test_training_tp2_stages_dropout_and_checkpoint(tmp_path):
    """World 2 at tp 2: stages 0-3, a remat policy, dropout, a stage-3
    checkpoint resumed at tp 1 x dp 2; the probes at tp 2 and at tp 1."""
    tree, batch = _tree("tiny"), _batch()
    ref = zero_run("tiny", tree, _zero(0), batch, STEPS, {})
    drop_ref = zero_run("tiny", tree, _zero(0), batch, STEPS, {"dropout": 0.1})
    jax_ref = _jax_run("tiny", tree, _zero(0, tp=2))
    ck = str(tmp_path / "ck")
    remat = {"activation_checkpointing": {"policy": "nothing_saveable"}}
    cases = [(_zero(s, tp=2), {}, None, None) for s in range(4)] + [
        (_zero(0, tp=2, **remat), {}, None, None),
        (_zero(0, tp=2), {"dropout": 0.1}, None, None),
        (_zero(3, tp=2), {}, None, (ck, "save")),
        (_zero(0), {}, None, (ck, "load"))]
    probes = [(_zero(0, tp=2), {"dropout": 0.1})]
    tp1 = workers.tp_train_probe("tiny", tree, _zero(0), batch, {"dropout": 0.1})
    ranks = run_world(workers.tp_train_world, 2, tmp_path, "tiny", tree, batch, STEPS, cases, probes)
    _check_runs(ranks, range(5), ref, jax_ref, "tiny tp 2")
    _check_runs(ranks, [5], drop_ref, None, "tiny tp 2 dropout")
    for rank, res in enumerate(ranks):
        runs = res["runs"]
        assert all("tensor" not in str(r["specs"]) for r in runs[:4])  # the master is the tensor shard
        saved, resumed = runs[6], runs[7]
        for k, whole in saved["master"].items():
            np.testing.assert_array_equal(resumed["loaded"][k], whole, err_msg=k)
        assert all(np.isfinite(resumed["losses"])) and resumed["losses"][0] < saved["losses"][-1]
        (tp2, ) = res["probes"]
        assert tp2["tp_rank"] == rank and tp2["local"] == (2, 1, 64)
        # every mask drawn at tp 2 is the one drawn at tp 1 for the same element
        assert len(tp2["masks"]) == len(tp1["masks"]) == 2 * 2
        for (k2, s2, m2), (k1, s1, m1) in zip(tp2["masks"], tp1["masks"]):
            assert (k2, s2) == (k1, s1)
            np.testing.assert_array_equal(m2, m1)
    # tensors whole over tensor: the same gradient on both ranks of the group
    g0, g1 = (r["probes"][0]["grads"] for r in ranks)
    assert g0 and set(g0) == set(g1) and all("norm" in k for k in g0)
    for k in g0:
        np.testing.assert_array_equal(g0[k], g1[k], err_msg=k)


def test_training_tp2_dp2_stages(tmp_path):
    """World 4 at tp 2 x dp 2: stages 0-3 with every tensor streamed, and
    stage 3 at the default persistence threshold (every tensor persists,
    gathered over data from its master while it stays the tensor shard) and
    at threshold 64 (the norm scales persist, the matrices stream:
    llama3-8b's split)."""
    tree, batch = _tree("tiny"), _batch()
    ref = zero_run("tiny", tree, _zero(0), batch, STEPS, {})
    jax_ref = _jax_run("tiny", tree, _zero(0, tp=2))
    jax_default = _jax_run("tiny", tree, _zero(3, tp=2, threshold=None))
    jax_split = _jax_run("tiny", tree, _zero(3, tp=2, threshold=64))
    cases = [(_zero(s, tp=2), {}, None, None) for s in range(4)] + [
        (_zero(3, tp=2, threshold=None), {}, None, None), (_zero(3, tp=2, threshold=64), {}, None, None)]
    ranks = run_world(workers.tp_train_world, 4, tmp_path, "tiny", tree, batch, STEPS, cases, [])
    _check_runs(ranks, range(4), ref, jax_ref, "tiny tp 2 x dp 2")
    _check_runs(ranks, [4], ref, jax_default, "tiny tp 2 x dp 2, stage 3 default threshold")
    _check_runs(ranks, [5], ref, jax_split, "tiny tp 2 x dp 2, stage 3 threshold 64")
    for rank, res in enumerate(ranks):
        runs = res["runs"]
        assert runs[0]["rank"]["dp"] == rank // 2
        assert any("data" in str(sp) for sp in runs[3]["specs"].values())
        for i in (4, 5):  # every master split over data, none over tensor
            assert all("data" in str(sp) and "tensor" not in str(sp) for sp in runs[i]["specs"].values())


def test_training_tp4_stage1_and_moe_expert2_tensor2(tmp_path):
    kv4 = {"num_kv_heads": 4}
    tree, moe, batch = _tree("tiny", **kv4), _tree("tiny-moe"), _batch()
    ref = zero_run("tiny", tree, _zero(0), batch, STEPS, kv4)
    jax_ref = _jax_run("tiny", tree, _zero(1, tp=4), **kv4)
    ranks = run_world(workers.tp_train_world, 4, tmp_path, "tiny", tree, batch, STEPS,
                      [(_zero(1, tp=4), kv4, None, None)], [(_zero(1, tp=4), kv4)])
    _check_runs(ranks, [0], ref, jax_ref, "tiny tp 4 stage 1")
    assert [r["probes"][0]["local"] for r in ranks] == [(1, 1, 32)] * 4
    moe_ref = zero_run("tiny-moe", moe, _zero(0), batch, STEPS, {})
    jax_moe = _jax_run("tiny-moe", moe, _zero(0, tp=2, mesh={"expert_parallel_size": 2}))
    moe_ranks = run_world(workers.tp_train_world, 4, tmp_path, "tiny-moe", moe, batch, STEPS,
                          [(_zero(s, tp=2, mesh={"expert_parallel_size": 2}), {}, None, None) for s in (0, 3)], [])
    _check_runs(moe_ranks, [0, 1], moe_ref, jax_moe, "tiny-moe expert 2 x tensor 2")


def test_training_tp_refusals(tmp_path):
    """Head counts tp does not divide raise in training (the JAX package
    pads unevenly); the offload tiers raise at tp > 1."""
    off = {**_zero(0, tp=2), "zero_optimization": {"stage": 0, "offload_optimizer": {"device": "cpu"}}}
    got = run_world(workers.tp_refusals_world, 2, tmp_path, _tree("tiny", **ODD), _batch(),
                    [(_zero(0, tp=2), ODD), (off, ODD)])
    for odd, offload in got:
        assert "tensor degree 2 must divide num_heads=6, kv_heads=3" in odd
        assert "offload tiers at tensor_parallel_size=2" in offload and "#7.2" in offload
