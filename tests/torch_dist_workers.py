"""Multi-rank worlds for the port's tests: gloo process groups on the CPU.

:func:`run_world` starts ``world`` processes (``spawn``) that meet through
a ``file://`` store under the test's temporary directory (no port is
bound), runs one of this module's worker functions in each with one torch
thread, and returns every rank's result. The world runs under its own
deadline: past it every child is killed and the test fails. This module
imports torch and the port only (never JAX), so a child starts quickly.
"""

import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

WORLD_DEADLINE_S = 120


def _child(rank, world, store, target, args, out, threads):
    torch.set_num_threads(threads)
    try:
        import deepspeed_tpu_torch.comm as dist
        dist.init_distributed(device="cpu", init_method=f"file://{store}", rank=rank, world_size=world,
                              verbose=False)
        result = ("ok", globals()[target](rank, world, *args))
        dist.destroy_process_group()
    except BaseException:
        result = ("err", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)


def run_world(target, world, tmp_path, *args, timeout=WORLD_DEADLINE_S, threads=1):
    """``target(rank, world, *args)`` on each rank of a gloo world of
    ``world``; returns the ranks' results in rank order."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    tag = f"{target.__name__}_{world}_{time.monotonic_ns()}"
    store = os.path.join(str(tmp_path), f"{tag}.store")
    outs = [os.path.join(str(tmp_path), f"{tag}.rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_child, args=(r, world, store, target.__name__, args, outs[r], threads),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    if any(p.is_alive() for p in procs):
        for p in procs:
            p.kill()
            p.join()
        pytest.fail(f"{target.__name__}: a world of {world} did not finish within {timeout} s")
    results = []
    for r, out in enumerate(outs):
        if not os.path.exists(out):
            pytest.fail(f"{target.__name__}: rank {r} exited with code {procs[r].exitcode} and no result")
        with open(out, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            pytest.fail(f"{target.__name__}: rank {r} failed:\n{value}")
        results.append(value)
    return results


# ---------------------------------------------------------------------------
# comm


def comm_world(rank, world, inputs, cases, meshes):
    """Each case ``(name, kwargs)`` of :mod:`deepspeed_tpu_torch.comm` on
    this rank's input under the mesh (expert 2, data world / 2), and every
    rank's groups under each mesh of ``meshes``."""
    import deepspeed_tpu_torch.comm as dist
    out = {"world_size": dist.get_world_size(), "rank": dist.get_rank()}
    dist.initialize_mesh(expert=2)
    x = torch.from_numpy(inputs[rank])
    for i, (name, kw) in enumerate(cases):
        out[i] = getattr(dist, name)(x, **kw).numpy()
    ints = torch.from_numpy(inputs["ints"][rank])
    for op in ("band", "bor", "bxor"):
        out[op] = dist.all_reduce(ints, op=op).numpy()
    out["host_broadcast"] = dist.host_broadcast({"r": np.array([rank, 10 * rank])}, src=1)
    out["host_allgather"] = dist.host_allgather({"r": np.array([rank, 10 * rank]), "s": [np.float32(rank)]})
    dist.barrier()
    # the AllToAll function's backward sends each chunk's gradient home
    xg = x.clone().requires_grad_(True)
    y = dist.AllToAll.apply(xg, dist.DATA_AXIS, 0, 1)
    (y * torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape)).sum().backward()
    out["a2a_grad"] = xg.grad.numpy()
    groups = {}
    for shape in meshes:
        mesh = dist.initialize_mesh(**shape)
        groups[tuple(sorted(shape.items()))] = {
            "ranks": mesh.ranks.copy(),
            "groups": {axes: mesh.group_ranks(axes) for axes in ("expert", "data", ("expert", "data"))}}
        dist.barrier(dist.DATA_AXIS)
    out["groups"] = groups
    return out


# ---------------------------------------------------------------------------
# training


def train_run(name, tree, config, batch, steps, model_kw):
    """``steps`` of ``train_batch`` on the global ``batch`` (every rank gets
    it whole and trains on its rows); returns the losses, the global
    gradient norms, the master tensors and the MoE layers' last drop
    fractions."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import get_model
    from deepspeed_tpu_torch.models.convert import params_from_jax
    model = get_model(name, dtype=torch.float32, attention_impl="flash", **model_kw)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params_from_jax(tree, model.cfg),
                                                config=dict(config), device="cpu")
    losses, norms = [], []
    for _ in range(steps):
        losses.append(float(engine.train_batch(batch=batch)))
        norms.append(engine._last_metrics["grad_norm"])
    last = getattr(engine.module, "last_moe", None)
    return {"losses": losses, "grad_norms": norms, "master": {k: v.detach().numpy().copy() for k, v in engine.master.items()},
            "drop_frac": None if last is None else last["drop_frac"].numpy(),
            "local_experts": getattr(engine.module.cfg, "moe_local_experts", None),
            "dp": engine.dp_world_size()}


def train_world(rank, world, name, tree, batch, steps, cases):
    """:func:`train_run` for each ``(config, model_kw)`` of ``cases``."""
    return [train_run(name, tree, config, batch, steps, model_kw) for config, model_kw in cases]


# ---------------------------------------------------------------------------
# serving


def serve_streams(eng, prompts, max_new, kv_cache_dtype="auto"):
    """Greedy and sampled streams with their logits through a fresh
    scheduler, then the first prompt again (a radix hit)."""
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    sched = DecodeScheduler(eng, num_slots=4, prefill_chunk=16, collect_logits=True,
                            kv_cache_dtype=kv_cache_dtype)
    hs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
    hs += [sched.submit(prompts[0], max_new_tokens=max_new, do_sample=True, temperature=0.9, top_k=20,
                        seed=7)]
    out = [(h.result().tolist(), h.result_logits()) for h in hs]
    hit = sched.submit(prompts[0], max_new_tokens=max_new)
    out.append((hit.result().tolist(), hit.result_logits()))
    return out, sched.radix is not None and sched.radix.hits > 0


def serve_run(name, tree, config, prompts, max_new, model_kw):
    """An engine on ``tree``: its greedy ``generate()`` rows and
    :func:`serve_streams` on a full-precision and an int8 KV pool, with
    the engine's expert layout and its REPLICATED warnings."""
    import logging
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import get_model
    from deepspeed_tpu_torch.models.convert import params_from_jax
    from deepspeed_tpu_torch.utils.logging import logger
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger.addHandler(handler)
    try:
        model = get_model(name, **model_kw)
        eng = deepspeed_tpu_torch.init_inference(model, config=dict(config), params=params_from_jax(tree, model.cfg),
                                                 device="cpu")
    finally:
        logger.removeHandler(handler)
    streams, hit = serve_streams(eng, prompts, max_new)
    int8_streams, _ = serve_streams(eng, prompts, max_new, kv_cache_dtype="int8")
    return {"generate": [r.tolist() for r in eng.generate(prompts[:2], max_new_tokens=max_new)],
            "streams": streams, "int8_streams": int8_streams, "radix_hit": hit,
            "local_experts": eng.model_config.moe_local_experts, "desc": eng._moe_desc(),
            "warnings": [m for m in records if "REPLICATED" in m]}


def serve_world(rank, world, name, trees, config, prompts, max_new, cases):
    """:func:`serve_run` for each ``(mesh layout, model_kw, tree key)`` of
    ``cases``."""
    import deepspeed_tpu_torch.comm as dist
    out = []
    for layout, model_kw, key in cases:
        dist.initialize_mesh(**layout)
        out.append(serve_run(name, trees[key], config, prompts, max_new, model_kw))
    return out


# ---------------------------------------------------------------------------
# ZeRO stages and the offload tiers across ranks


def zero_run(name, tree, config, batch, steps, model_kw, mesh=None, ckpt=None):
    """``steps`` of ``train_batch`` on the global ``batch`` under
    ``config``; returns the losses, the global gradient norms (before the
    clip), every master tensor gathered whole
    (``utils.tensor_fragment``), this rank's own part of each (its shard on
    the device, or its host partition under ZeRO-Offload) and the host
    partition's size. ``ckpt``: (directory, "save" or "load"): save after
    the steps, or load before them (and return the loaded master)."""
    import deepspeed_tpu_torch
    import deepspeed_tpu_torch.comm as dist
    from deepspeed_tpu_torch.models import get_model
    from deepspeed_tpu_torch.models.convert import params_from_jax
    from deepspeed_tpu_torch.utils import safe_get_full_fp32_param
    if mesh is not None:
        dist.initialize_mesh(**mesh)
    model = get_model(name, dtype=torch.float32, attention_impl="flash", **model_kw)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params_from_jax(tree, model.cfg),
                                                config=dict(config), device="cpu")
    out = {}
    if ckpt is not None and ckpt[1] == "load":
        engine.load_checkpoint(ckpt[0])
        out["loaded"] = {k: safe_get_full_fp32_param(engine, k).numpy() for k in _master_keys(engine)}
    out["losses"], out["norms"] = [], []
    for _ in range(steps):
        out["losses"].append(float(engine.train_batch(batch=batch)))
        out["norms"].append(float(engine._last_metrics["grad_norm"]))
    if ckpt is not None and ckpt[1] == "save":
        engine.save_checkpoint(ckpt[0])
    keys = _master_keys(engine)
    out["master"] = {k: safe_get_full_fp32_param(engine, k).numpy() for k in keys}
    if engine.host_opt is not None:
        own = engine.host_opt.state_tensors()[0]
        out["host_n"] = engine.host_opt.n
        out["specs"] = engine._specs["offload"]
    elif engine.param_stream is not None:
        own, out["host_n"], out["specs"] = {}, engine.param_stream.store.num_params(), None
    else:
        own, out["specs"] = engine.master, engine._specs["master"]
    out["own"] = {k: v.detach().numpy().copy() for k, v in own.items()}
    out["rank"] = {"data": dist.get_rank(dist.DATA_AXIS), "expert": dist.get_rank(dist.EXPERT_AXIS),
                   "dp": dist.get_rank(dist.DP_AXES)}
    return out


def _master_keys(engine):
    return list(engine.param_stream._shapes) if engine.param_stream is not None else list(engine.master)


def zero_world(rank, world, name, tree, batch, steps, cases):
    """:func:`zero_run` for each ``(config, model_kw, mesh, ckpt)`` of
    ``cases``, in order (a checkpoint saved by one case loads in a later
    one)."""
    return [zero_run(name, tree, config, batch, steps, model_kw, mesh, ckpt)
            for config, model_kw, mesh, ckpt in cases]


def zero_helpers_world(rank, world):
    """Under the mesh (expert 2, data 2): the group API's answers; each of
    a few specs' ``shard`` of a whole tensor and its ``unshard``; and at
    stage 3 on ``tiny``, ``utils.tensor_fragment``'s setter and getters."""
    import deepspeed_tpu_torch
    import deepspeed_tpu_torch.comm as dist
    from deepspeed_tpu_torch.models import get_model
    from deepspeed_tpu_torch.runtime.zero.sharding import shard, unshard
    from deepspeed_tpu_torch.utils import (groups, safe_get_full_fp32_param, safe_set_full_fp32_param,
                                           safe_get_full_grad, safe_get_full_optimizer_state)
    dist.initialize_mesh(expert=2, data=2)
    out = {"groups": {
        "dp": groups.get_data_parallel_group(), "edp": groups.get_expert_data_parallel_group(),
        "ep": groups.get_expert_parallel_group(), "mp": groups.get_model_parallel_group(),
        "sp": groups.get_sequence_parallel_group(), "pp": groups.get_pipeline_parallel_group(),
        "dp_size": groups.get_data_parallel_world_size(), "edp_size": groups.get_expert_data_parallel_world_size(),
        "ep_size": groups.get_expert_parallel_world_size(), "mp_size": groups.get_model_parallel_world_size(),
        "sp_size": groups.get_sequence_parallel_world_size(), "pp_size": groups.get_pipeline_parallel_world_size(),
        "dp_rank": groups.get_data_parallel_rank(), "ep_rank": groups.get_expert_parallel_rank(),
        "edp_rank": groups.get_expert_data_parallel_rank(), "world": groups.get_world_size()}}
    whole = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    specs = {"whole": (None, None), "data": ("data", None), "expert_dim1": (None, "expert"),
             "expert_data": (("expert", "data"), None), "data_expert_dim1": (None, ("data", "expert")),
             "two_dims": ("expert", "data"), "tensor_axis": ("tensor", "data")}
    out["shards"] = {}
    for name, spec in specs.items():
        part = shard(whole, spec)
        out["shards"][name] = (whole.numpy(), part.numpy().copy(), unshard(part, spec).numpy())
    model = get_model("tiny", dtype=torch.float32, attention_impl="flash")
    config = {"train_batch_size": 16, "gradient_accumulation_steps": 1, "steps_per_print": 10**9,
              "mesh": {"expert_parallel_size": 2},
              "zero_optimization": {"stage": 3, "stage3_param_persistence_threshold": 0}}
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=config, device="cpu")
    key = "layers.1.mlp.up_proj.kernel"
    value = torch.arange(64 * 128, dtype=torch.float32).reshape(64, 128) / 1000.0
    safe_set_full_fp32_param(engine, key, value)
    batch = {"input_ids": np.random.default_rng(2).integers(0, 256, (16, 32))}
    frag = {"value": value.numpy(), "set_then_get": safe_get_full_fp32_param(engine, key).numpy(),
            "shard_shape": tuple(engine.master[key].shape),
            "sharded": bool(engine._specs["master"][key] != (None, None))}
    frag["no_grad_outside_facade"] = safe_get_full_grad(engine, key)
    engine.train_batch(batch=batch)
    frag["exp_avg_sq"] = safe_get_full_optimizer_state(engine, key, "exp_avg_sq").numpy()
    mine = {k: v[dist.get_rank(dist.DP_AXES) * 4:(dist.get_rank(dist.DP_AXES) + 1) * 4] for k, v in batch.items()}
    engine.forward(mine)
    frag["grad"] = safe_get_full_grad(engine, key).numpy()
    out["fragment"] = frag
    return out
