"""Pipeline parallelism across ranks: gloo worlds of 2 and 4 on the CPU
(``tests/torch_dist_workers.py``; each world spawns once for its cases,
under its own deadline), fp32, the plain versions of the kernels standing
in for the kernels. The JAX engine runs in this process on the conftest's
CPU devices with ``tests/unit/test_pipeline.py``'s batch shapes and the
same weights (``models/convert.py::params_from_jax``).

- The schedules on a toy stack (``x = tanh(x @ w_i)``) at pipe 2 and 4:
  ``spmd_pipeline``'s stream, its aux sum and its gradients, and
  ``spmd_pipeline_1f1b``'s loss and gradients, equal a sequential apply
  (JAX ``test_spmd_pipeline_matches_sequential`` / ``_grad_``); each
  stage's in-flight microbatches under 1F1B reach JAX's ring bound
  ``min(M, 2 (S - 1 - s) + 1)``, under fill-drain all M.
- Training (AdamW, clip 1.0, three steps; ``RTOL`` the JAX tests' 2e-4):
  every rank's losses and grad norms within ``RTOL`` of the JAX engine at
  the same pipe degree and of the port's pp 1, at pipe 2 (both schedules,
  ``auto`` with an attention mask), pipe 4, pipe 2 x ZeRO 1, 2 and 3 (dp
  2), pipe 2 x tp 2 and tiny-moe at pipe 2 x ep 2 (the MoE aux loss at
  coefficient 1.0: stage 0's layer gradients within ``GRAD_REL`` relative
  L2 of pp 1's, so an aux gradient that never crosses the stage boundary
  fails); 1F1B bitwise fill-drain; the replicated tensors bitwise on every
  stage; dropout at pp 2 within ``RTOL`` of pp 1 with dropout, and two
  seeds differ; ``eval_batch``; a pp 2 checkpoint resumes at pp 2 with the
  next step bitwise and loads at pp 1 with the master bitwise;
  ``save_16bit_model`` writes every stage's tensors in the one-stage order.
- Refusals under ``pipe``: 1F1B with fp16, with tp 2 and with an MoE
  model, the offload tiers, an unknown schedule, a depth the degree does
  not divide, the forward/backward/step facade.
"""

import jax
import jax.numpy as jnp
import numpy as np

import deepspeed_tpu
import deepspeed_tpu.models as jm
from deepspeed_tpu.comm import comm as jcomm

from . import torch_dist_workers as workers
from .torch_dist_workers import pipe_run, run_world
from .torch_port_helpers import numpy_params, to_numpy

TRAIN = {"train_batch_size": 16, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
         "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}}, "steps_per_print": 10**9}
STEPS = 3
RTOL = 2e-4
# stage 0's layer gradients at pipe 2 x ep 2 against pp 1: sound 5.1e-8;
# with the last stage's aux cotangent kept out of the activation gradient it
# sends back, 1.3e-2 (its grad norms then 1.0e-2 off pp 1's)
GRAD_REL = 1e-4


def _tree(name, seed=0, **kw):
    return to_numpy(numpy_params(jm.get_model(name, dtype=jnp.float32, attention_impl="flash", **kw), seed))


def _batches():
    ids = np.random.default_rng(1).integers(0, 256, (16, 64)).astype(np.int32)
    mask = np.ones((16, 64), bool)
    mask[:, 48:] = False  # a padded tail (tests/unit/test_pipeline.py)
    return {"plain": {"input_ids": ids}, "masked": {"input_ids": ids, "attention_mask": mask}}


def _cfg(pp=1, schedule=None, **extra):
    mesh = {**({"pipeline_parallel_size": pp} if pp > 1 else {}), **extra.pop("mesh", {})}
    out = {**TRAIN, "mesh": mesh, **extra}
    if schedule is not None:
        out["pipeline"] = {"schedule": schedule}
    return out


def _jax_run(name, tree, config, batch, **model_kw):
    jcomm._state["mesh"] = None
    model = jm.get_model(name, dtype=jnp.float32, attention_impl="flash", **model_kw)
    engine, *_ = deepspeed_tpu.initialize(model=model, config=config,
                                          model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
    out = {"losses": [], "norms": []}
    for _ in range(STEPS):
        out["losses"].append(float(engine.train_batch(batch=batch)))
        out["norms"].append(float(engine._last_metrics["grad_norm"]))
    return out


def _close(got, refs, what):
    for name, ref in refs.items():
        for key in ("norms", "losses"):
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, err_msg=f"{what} {key} vs {name}")


def _replicated_equal(runs, i):
    """The tensors every stage holds (embed, head) bitwise across ranks."""
    shared = set.intersection(*(set(r["runs"][i]["own"]) for r in runs))
    assert shared and not any(k.startswith("layers.") for k in shared)
    for k in shared:
        for r in runs[1:]:
            np.testing.assert_array_equal(r["runs"][i]["own"][k], runs[0]["runs"][i]["own"][k], err_msg=k)


def _whole(runs, i):
    """Case ``i``'s master over the pipe stages (each layer from its stage)."""
    out = {}
    for r in runs:
        out.update(r["runs"][i]["own"])
    return out


# ---------------------------------------------------------------------------
# the schedules


def test_schedules_match_sequential_apply(tmp_path):
    import torch
    rng = np.random.default_rng(0)
    for world, L, M in ((2, 4, 3), (4, 8, 6)):
        w = (rng.standard_normal((L, 8, 8)) * 0.3).astype(np.float32)
        xs = rng.standard_normal((M, 2, 8)).astype(np.float32)
        ranks = run_world(workers.pipe_toy_world, world, tmp_path, w, xs)
        wt = [torch.from_numpy(w[i]).requires_grad_(True) for i in range(L)]
        x = torch.from_numpy(xs).requires_grad_(True)
        per = L // world
        h, aux = x, torch.zeros(())
        for i in range(L):
            h = torch.tanh(h @ wt[i])
            if (i + 1) % per == 0:  # a stage's aux: the mean of its output, each microbatch
                aux = aux + sum(h[m].mean() for m in range(M))
        g_plain = torch.autograd.grad((h ** 2).sum(), wt + [x], retain_graph=True)
        g_aux = torch.autograd.grad((h ** 2).sum() + aux, wt + [x], retain_graph=True)
        g_head = torch.autograd.grad((h ** 2).sum() / 4, wt + [x])
        for res in ranks:
            s = res["stage"]
            for with_aux, g in ((False, g_plain), (True, g_aux)):
                got = res["fill_drain"][with_aux]
                np.testing.assert_allclose(got["stream"], h.detach().numpy(), atol=1e-5)
                np.testing.assert_allclose(got["aux"], float(aux.detach()) if with_aux else 0.0, rtol=1e-5, atol=1e-6)
                for j, gj in enumerate(got["grads"]):
                    np.testing.assert_allclose(gj, g[s * per + j].numpy(), atol=1e-5)
                np.testing.assert_allclose(got["dx"], g[-1].numpy(), atol=1e-5)
            got = res["1f1b"]
            np.testing.assert_allclose(got["loss"], float((h.detach() ** 2).sum() / 4), rtol=1e-5)
            for j, gj in enumerate(got["grads"]):
                np.testing.assert_allclose(gj, g_head[s * per + j].numpy(), atol=1e-5)
            np.testing.assert_allclose(got["dx"], g_head[-1].numpy(), atol=1e-5)
            assert res["in_flight"] == {"fill_drain": M, "1f1b": min(M, 2 * (world - 1 - s) + 1)}, (world, s)


# ---------------------------------------------------------------------------
# training


def test_pipe2_schedules_mask_dropout_checkpoint_and_refusals(tmp_path):
    trees, batches = {"tiny": _tree("tiny"), "tiny3": _tree("tiny", num_layers=3)}, _batches()
    ck = str(tmp_path / "ck")
    cases = [
        dict(name="tiny", tree="tiny", config=_cfg(2, "fill_drain"), batch="plain", steps=STEPS, eval_rows=8,
             save16=str(tmp_path / "fp16")),
        dict(name="tiny", tree="tiny", config=_cfg(2, "1f1b"), batch="plain", steps=STEPS),
        dict(name="tiny", tree="tiny", config=_cfg(2), batch="masked", steps=STEPS),
        dict(name="tiny", tree="tiny", config=_cfg(2), batch="plain", steps=STEPS, model_kw={"dropout": 0.1}),
        dict(name="tiny", tree="tiny", config=_cfg(2, seed=7), batch="plain", steps=STEPS,
             model_kw={"dropout": 0.1}),
        dict(name="tiny", tree="tiny", config=_cfg(2, "1f1b"), batch="plain", steps=STEPS - 1, ckpt=(ck, "save")),
        dict(name="tiny", tree="tiny", config=_cfg(2, "fill_drain"), batch="plain", steps=1, ckpt=(ck, "load")),
    ]
    refusals = [
        (_cfg(2, "1f1b", fp16={"enabled": True}), {}),
        (_cfg(2, "zigzag"), {}),
        (_cfg(2), {"num_layers": 3}),
        (_cfg(2, zero_optimization={"stage": 2, "offload_optimizer": {"device": "cpu"}}), {}),
        (_cfg(2, zero_optimization={"stage": 3, "offload_param": {"device": "cpu"}}), {}),
        (_cfg(2, "fill_drain"), {}),  # builds; its facade refuses
    ]
    ranks = run_world(workers.pipe_world, 2, tmp_path, trees, batches, cases, refusals)
    plain, masked = batches["plain"], batches["masked"]
    pp1 = pipe_run("tiny", trees["tiny"], _cfg(), plain, STEPS, eval_rows=8)
    pp1_mask = pipe_run("tiny", trees["tiny"], _cfg(), masked, STEPS)
    pp1_drop = pipe_run("tiny", trees["tiny"], _cfg(), plain, STEPS, {"dropout": 0.1})
    jax_pp2 = _jax_run("tiny", trees["tiny"], _cfg(2), plain)
    jax_mask = _jax_run("tiny", trees["tiny"], _cfg(2), masked)
    for r, res in enumerate(ranks):
        runs = res["runs"]
        assert [c["stage"] for c in runs] == [r] * len(cases)
        _close(runs[0], {"pp 1": pp1, "JAX pipe 2": jax_pp2}, f"rank {r} fill_drain")
        np.testing.assert_allclose(runs[0]["eval"], pp1["eval"], rtol=RTOL)
        # 1F1B is bitwise fill-drain: losses, norms and every tensor
        assert runs[1]["losses"] == runs[0]["losses"] and runs[1]["norms"] == runs[0]["norms"]
        for k, v in runs[0]["own"].items():
            np.testing.assert_array_equal(runs[1]["own"][k], v, err_msg=k)
        assert [p["schedule"] for p in runs[0]["pipe"]] == ["fill_drain"] * STEPS
        assert [p["schedule"] for p in runs[1]["pipe"]] == ["1f1b"] * STEPS
        # gas 2 microbatches: in flight min(M, 2 (S - 1 - s) + 1) under 1F1B, all under fill-drain
        assert runs[0]["pipe"][0]["max_in_flight"] == 2 and runs[1]["pipe"][0]["max_in_flight"] == min(2, 3 - 2 * r)
        # auto with an attention mask takes fill-drain (the JAX rule)
        assert [p["schedule"] for p in runs[2]["pipe"]] == ["fill_drain"] * STEPS
        _close(runs[2], {"pp 1": pp1_mask, "JAX pipe 2": jax_mask}, f"rank {r} masked")
        _close(runs[3], {"pp 1 with dropout": pp1_drop}, f"rank {r} dropout")
        assert runs[3]["pipe"][0]["schedule"] == "1f1b"
        assert not np.allclose(runs[3]["losses"], runs[4]["losses"])  # two seeds differ
        assert not np.allclose(runs[3]["losses"], pp1["losses"])  # dropout is on
        # the resume at pp 2: its step is the uninterrupted run's third, bitwise
        assert runs[6]["losses"] == runs[0]["losses"][2:]
        for k, v in runs[0]["own"].items():
            np.testing.assert_array_equal(runs[6]["own"][k], v, err_msg=k)
        msgs = res["refusals"]
        assert "NotImplementedError" in msgs[0] and "fp16" in msgs[0]
        assert "ValueError" in msgs[1] and "pipeline.schedule" in msgs[1]
        assert "ValueError" in msgs[2] and "num_layers=3" in msgs[2]
        assert "offload_optimizer does not yet compose with pipeline_parallel_size" in msgs[3]
        assert "offload_param does not compose with pipeline_parallel_size" in msgs[4]
        assert "RuntimeError" in msgs[5] and "train_batch" in msgs[5]
    for i in range(len(cases)):
        _replicated_equal(ranks, i)
    # the pp 2 checkpoint loads at pp 1 (world 1): the master bitwise
    loaded = pipe_run("tiny", trees["tiny"], _cfg(), plain, 0, ckpt=(ck, "load"))["loaded"]
    saved = _whole(ranks, 5)
    assert list(loaded) == list(pp1["own"]) and set(saved) == set(loaded)
    for k, v in saved.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)
    # save_16bit_model: every stage's tensors (fp32 compute here) in the one-stage key order
    import torch
    sd = torch.load(str(tmp_path / "fp16" / "pytorch_model.bin"), weights_only=True)
    final = _whole(ranks, 0)
    assert list(sd) == list(pp1["own"])
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), final[k], err_msg=k)


def test_pipe4_pipe2_zero_and_pipe2_tp2(tmp_path):
    deep = {"num_layers": 4}
    trees, batches = {"tiny": _tree("tiny"), "deep": _tree("tiny", **deep)}, _batches()
    zero = lambda stage: {"zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 0}}
    cases = [
        dict(name="tiny", tree="deep", config=_cfg(4, "fill_drain"), batch="plain", steps=STEPS, model_kw=deep),
        dict(name="tiny", tree="deep", config=_cfg(4, "1f1b"), batch="plain", steps=STEPS, model_kw=deep),
        dict(name="tiny", tree="tiny", config=_cfg(2, **zero(3)), batch="plain", steps=STEPS),
        dict(name="tiny", tree="tiny", config=_cfg(2, **zero(1)), batch="plain", steps=STEPS),
        dict(name="tiny", tree="tiny", config=_cfg(2, **zero(2)), batch="plain", steps=STEPS),
        dict(name="tiny", tree="tiny", config=_cfg(2, mesh={"tensor_parallel_size": 2}), batch="plain",
             steps=STEPS),
    ]
    refusals = [(_cfg(2, "1f1b", mesh={"tensor_parallel_size": 2}), {})]
    ranks = run_world(workers.pipe_world, 4, tmp_path, trees, batches, cases, refusals)
    plain = batches["plain"]
    pp1 = pipe_run("tiny", trees["tiny"], _cfg(), plain, STEPS)
    pp1_deep = pipe_run("tiny", trees["deep"], _cfg(), plain, STEPS, deep)
    jax_pp4 = _jax_run("tiny", trees["deep"], _cfg(4), plain, **deep)
    jax_z3 = _jax_run("tiny", trees["tiny"], _cfg(2, **zero(3)), plain)
    jax_tp = _jax_run("tiny", trees["tiny"], _cfg(2, mesh={"tensor_parallel_size": 2}), plain)
    for r, res in enumerate(ranks):
        runs = res["runs"]
        assert [c["stage"] for c in runs] == [r, r, r // 2, r // 2, r // 2, r // 2]
        _close(runs[0], {"pp 1": pp1_deep, "JAX pipe 4": jax_pp4}, f"rank {r} pipe 4")
        assert runs[1]["losses"] == runs[0]["losses"] and runs[1]["norms"] == runs[0]["norms"]
        for k, v in runs[0]["own"].items():
            np.testing.assert_array_equal(runs[1]["own"][k], v, err_msg=k)
        assert runs[1]["pipe"][0]["max_in_flight"] == min(2, 2 * (3 - r) + 1)
        _close(runs[2], {"pp 1": pp1, "JAX pipe 2 x ZeRO 3": jax_z3}, f"rank {r} pipe 2 x dp 2 ZeRO 3")
        _close(runs[3], {"pp 1": pp1}, f"rank {r} pipe 2 x dp 2 ZeRO 1")
        _close(runs[4], {"pp 1": pp1}, f"rank {r} pipe 2 x dp 2 ZeRO 2")
        _close(runs[5], {"pp 1": pp1, "JAX pipe 2 x tp 2": jax_tp}, f"rank {r} pipe 2 x tp 2")
        assert runs[5]["pipe"][0]["schedule"] == "fill_drain"  # auto under tp
        assert "NotImplementedError" in res["refusals"][0] and "tensor/sequence" in res["refusals"][0]
    _replicated_equal(ranks, 0)


def test_pipe2_moe_expert2_aux_loss(tmp_path):
    kw = {"moe_aux_loss_coef": 1.0}
    trees, batches = {"tiny": _tree("tiny"), "moe": _tree("tiny-moe", **kw)}, _batches()
    cases = [dict(name="tiny-moe", tree="moe", config=_cfg(2, mesh={"expert_parallel_size": 2}), batch="plain",
                  steps=STEPS, model_kw=kw, capture=True)]
    refusals = [(_cfg(2, "1f1b"), {"num_experts": 4})]
    ranks = run_world(workers.pipe_world, 4, tmp_path, trees, batches, cases, refusals)
    plain = batches["plain"]
    pp1 = pipe_run("tiny-moe", trees["moe"], _cfg(), plain, STEPS, kw, capture=True)
    jax_ref = _jax_run("tiny-moe", trees["moe"], _cfg(2, mesh={"expert_parallel_size": 2}), plain, **kw)
    for r, res in enumerate(ranks):
        got = res["runs"][0]
        assert got["stage"] == r // 2 and got["pipe"][0]["schedule"] == "fill_drain"
        _close(got, {"pp 1": pp1, "JAX pipe 2 x ep 2": jax_ref}, f"rank {r} tiny-moe")
        assert "NotImplementedError" in res["refusals"][0] and "MoE aux" in res["refusals"][0]
        if got["stage"] != 0:
            continue
        # stage 0's layer gradients (every tensor but this rank's experts) against pp 1's
        keys = [k for k in got["grads"] if k.startswith("layers.0.") and ".experts." not in k]
        assert any("router" in k or "gate" in k for k in keys), keys
        a = np.concatenate([got["grads"][k].ravel() for k in keys])
        b = np.concatenate([pp1["grads"][k].ravel() for k in keys])
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel < GRAD_REL, rel
