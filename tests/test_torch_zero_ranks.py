"""ZeRO stages 1-3 and the offload tiers across ranks: gloo worlds of 2
and 4 on the CPU (``tests/torch_dist_workers.py``; each world spawns once
for all its cases, under its own deadline), ``tiny`` and ``tiny-moe`` in
fp32, global batch 16 (micro 4 x gas 2 x 2 ranks, or micro 2 x 4), AdamW,
clip 1.0, three steps. ``stage3_param_persistence_threshold`` is 0 (stage 3
gathers every tensor a block at a time) unless a case says otherwise: the
default 10^5 (every ``tiny`` tensor persists: gathered whole once a
micro-step from its sharded master) and 64 (llama3-8b's split at the
default: the norm scales persist, the matrices stream):

- stages 1-3: every rank's losses and global gradient norms within rtol
  2e-4 of the same world's stage 0 and of the JAX engine at that stage
  (``deepspeed_tpu.initialize`` on the conftest's CPU mesh; the JAX test's
  bound, ``tests/unit/test_engine.py:49-58``), the masters of stages 2 and
  3 within it of stage 0's (a gradient off by a constant factor cancels in
  AdamW's update and under the clip, but not in the norm); stage 1
  bitwise stage 0 (losses, norms and masters: the gradient is reduced and
  normed whole, then sliced);
- the gathered master bitwise the same on every rank, and each rank's
  shard bitwise its slice of it (member order of the spec's axes);
- ``tiny-moe`` at expert 2 x data 2, stage 3 (experts shard over ``data``,
  the rest over expert x data);
- ZeRO-Offload (cpu and nvme) and ZeRO-Infinity (cpu) at world 2 against
  their own world-1 runs within the same bound; ZeRO-Offload's host holds
  this rank's partition (half the elements of the divisible tensors), the
  streamed tier every parameter;
- a checkpoint saved at stage 3 on world 2 resumes at stage 0 on world 2:
  the loaded master bitwise the stage-3 master gathered.
"""

import jax
import jax.numpy as jnp
import numpy as np

import deepspeed_tpu
import deepspeed_tpu.models as jm
from deepspeed_tpu.comm import comm as jcomm

from . import torch_dist_workers as workers
from .torch_dist_workers import run_world, zero_run
from .torch_port_helpers import numpy_params, to_numpy

TRAIN = {"train_batch_size": 16, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
         "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}}, "steps_per_print": 10**9}
STEPS = 3
RTOL = 2e-4


def _zero(stage, threshold=0, **extra):
    """The config at ``stage``; ``threshold`` None leaves the persistence
    threshold at its default."""
    keep = {} if threshold is None else {"stage3_param_persistence_threshold": threshold}
    return {**TRAIN, "zero_optimization": {"stage": stage, **keep, **extra}}


def _tree(name):
    return to_numpy(numpy_params(jm.get_model(name, dtype=jnp.float32, attention_impl="flash"), 0))


def _batch():
    return {"input_ids": np.random.default_rng(1).integers(0, 256, (16, 64)).astype(np.int32)}


def _jax_run(name, tree, stage, threshold=0):
    """The JAX engine's losses and global gradient norms over ``STEPS``."""
    jcomm._state["mesh"] = None
    model = jm.get_model(name, dtype=jnp.float32, attention_impl="flash")
    engine, *_ = deepspeed_tpu.initialize(model=model, config=_zero(stage, threshold),
                                          model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
    batch, out = _batch(), {"losses": [], "norms": []}
    for _ in range(STEPS):
        out["losses"].append(float(engine.train_batch(batch=batch)))
        out["norms"].append(float(engine._last_metrics["grad_norm"]))
    return out


def _my_slice(whole, spec, rank, mesh):
    """This rank's part of ``whole`` under ``spec`` (member order: the
    index linearized over the entry's axes in the order given)."""
    for d, entry in enumerate(spec or ()):
        axes = [] if entry is None else ([entry] if isinstance(entry, str) else list(entry))
        axes = [a for a in axes if mesh.get(a, 1) > 1]
        if not axes:
            continue
        idx, n = 0, 1
        for a in axes:
            idx, n = idx * mesh[a] + rank[a], n * mesh[a]
        step = whole.shape[d] // n
        whole = np.take(whole, np.arange(idx * step, (idx + 1) * step), axis=d)
    return whole


def _check_case(ranks, i, stage, mesh, jax_ref, name, base=0):
    """Case ``i`` of each rank, run at ``stage``, against case ``base``
    (stage 0 on the same world) and the JAX engine's ``jax_ref``."""
    for res in ranks:
        got, ref = res[i], res[base]
        for what in ("losses", "norms"):
            np.testing.assert_allclose(got[what], ref[what], rtol=RTOL, err_msg=f"{name} stage {stage} {what}")
            if jax_ref is not None:
                np.testing.assert_allclose(got[what], jax_ref[what], rtol=RTOL,
                                           err_msg=f"{name} stage {stage} {what} vs JAX")
        for k, whole in got["master"].items():
            expert = ".moe.experts." in k
            peers = [r for r in range(len(ranks)) if not expert or ranks[r][i]["rank"]["expert"] ==
                     got["rank"]["expert"]]
            for r in peers:  # the whole tensor, bitwise on every replica
                np.testing.assert_array_equal(ranks[r][i]["master"][k], whole)
            spec = got["specs"][k]
            if stage:
                assert spec != ref["specs"][k] or whole.size < len(ranks), (k, spec)
            if stage >= 2:
                np.testing.assert_allclose(whole, ref["master"][k], rtol=RTOL, atol=1e-6,
                                           err_msg=f"{name} stage {stage} master {k}")
            np.testing.assert_array_equal(got["own"][k], _my_slice(whole, spec, got["rank"], mesh))
        if stage == 1:  # stage 0's arithmetic, sliced
            assert got["losses"] == ref["losses"] and got["norms"] == ref["norms"]
            for k in ref["master"]:
                np.testing.assert_array_equal(got["master"][k], ref["master"][k])


def _check_stages(ranks, first, mesh, jax_refs, name):
    """Stages 0-3 at ``first`` .. ``first + 3`` of each rank's cases."""
    for stage in range(4):
        _check_case(ranks, first + stage, stage, mesh, jax_refs.get(stage), name, base=first)


def test_world2_stages_offload_tiers_and_checkpoint(tmp_path):
    tree, batch = _tree("tiny"), _batch()
    jax_refs = {s: _jax_run("tiny", tree, s) for s in (1, 2, 3)}
    jax_default = _jax_run("tiny", tree, 3, threshold=None)
    ck = str(tmp_path / "ck")
    tiers = [(_zero(0, offload_optimizer={"device": "cpu"}), {}, None, None),
             (_zero(0, offload_optimizer={"device": "nvme", "nvme_path": str(tmp_path / "nvme")}), {}, None, None),
             (_zero(3, offload_param={"device": "cpu"}), {}, None, None)]
    cases = [(_zero(s), {}, None, None) for s in range(4)] + tiers + [
        (_zero(3), {}, None, (ck, "save")), (_zero(0), {}, None, (ck, "load")),
        (_zero(3, threshold=None), {}, None, None)]
    one = [zero_run("tiny", tree, config, batch, STEPS, kw, mesh, c) for config, kw, mesh, c in tiers]
    ranks = run_world(workers.zero_world, 2, tmp_path, "tiny", tree, batch, STEPS, cases)
    _check_stages(ranks, 0, {"data": 2}, jax_refs, "tiny, world 2")
    # the default threshold: every tensor persists, gathered from its sharded master
    _check_case(ranks, 9, 3, {"data": 2}, jax_default, "tiny, world 2, default threshold")
    assert all(any(e is not None for e in sp) for sp in ranks[0][9]["specs"].values())
    for rank, res in enumerate(ranks):
        for i, ref in enumerate(one):
            got = res[4 + i]
            for what in ("losses", "norms"):
                np.testing.assert_allclose(got[what], ref[what], rtol=RTOL, err_msg=f"tier {i} {what}")
            for k, whole in got["master"].items():
                np.testing.assert_allclose(whole, ref["master"][k], rtol=RTOL, atol=1e-6, err_msg=k)
                np.testing.assert_array_equal(whole, ranks[0][4 + i]["master"][k])
        for i in (0, 1):  # ZeRO-Offload: the host partition
            got = res[4 + i]
            part = sum(v.size for v in got["own"].values())
            assert got["host_n"] == part < one[i]["host_n"], (got["host_n"], one[i]["host_n"])
            for k, whole in got["master"].items():
                np.testing.assert_array_equal(got["own"][k], _my_slice(whole, got["specs"][k], got["rank"],
                                                                       {"data": 2}))
        assert res[6]["host_n"] == one[2]["host_n"] == sum(v.size for v in res[6]["master"].values())
        saved, resumed = res[7], res[8]
        for k, whole in saved["master"].items():
            np.testing.assert_array_equal(resumed["loaded"][k], whole)
        assert all(np.isfinite(resumed["losses"])) and resumed["losses"][0] < saved["losses"][-1]


def test_world4_stages_dense(tmp_path):
    dense, batch = _tree("tiny"), _batch()
    jax_dense = {s: _jax_run("tiny", dense, s) for s in (1, 2, 3)}
    jax_split = _jax_run("tiny", dense, 3, threshold=64)
    dense_ranks = run_world(workers.zero_world, 4, tmp_path, "tiny", dense, batch, STEPS,
                            [(_zero(s), {}, None, None) for s in range(4)] + [(_zero(3, 64), {}, None, None)])
    _check_stages(dense_ranks, 0, {"data": 4}, jax_dense, "tiny, world 4")
    # the norm scales persist (64 elements, master split 4 ways), the matrices stream
    _check_case(dense_ranks, 4, 3, {"data": 4}, jax_split, "tiny, world 4, threshold 64")
    assert dense_ranks[0][4]["specs"]["final_norm.scale"] == ("data", )


def test_world4_moe_stage3(tmp_path):
    moe, batch = _tree("tiny-moe"), _batch()
    jax_moe = _jax_run("tiny-moe", moe, 3)
    ep = {"mesh": {"expert_parallel_size": 2}}
    moe_ranks = run_world(workers.zero_world, 4, tmp_path, "tiny-moe", moe, batch, STEPS,
                          [({**_zero(s), **ep}, {}, None, None) for s in (0, 3)])
    _check_case(moe_ranks, 1, 3, {"expert": 2, "data": 2}, jax_moe, "tiny-moe, expert 2 x data 2")
    for rank, res in enumerate(moe_ranks):
        got = res[1]
        assert got["rank"]["expert"] == rank // 2 and got["rank"]["data"] == rank % 2
        for k, whole in got["master"].items():
            spec = got["specs"][k]
            if ".moe.experts." in k:  # the local experts, over data only
                assert "expert" not in str(spec) and "data" in str(spec), (k, spec)
            elif whole.ndim == 2:
                assert ("expert", "data") in spec, (k, spec)
