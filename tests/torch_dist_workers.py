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
