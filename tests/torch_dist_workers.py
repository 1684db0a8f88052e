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
    # ppermute_autograd over ("data", "expert") (members 0, 2, 1, 3): the
    # gradient each member's output receives is its rank + 1
    xg = x.clone().requires_grad_(True)
    y = dist.ppermute_autograd(xg, [(0, 3), (3, 1), (1, 0)], ("data", "expert"))
    (y * (dist.get_rank() + 1)).sum().backward()
    out["ppermute_grad"] = xg.grad.numpy()
    out["ppermute_one"] = dist.ppermute(x, [(0, 0)], "pipe") is x  # a group of one returns its input
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


def zero_run(name, tree, config, batch, steps, model_kw, mesh=None, ckpt=None, eval_rows=None):
    """``steps`` of ``train_batch`` on the global ``batch`` under
    ``config``; returns the losses, the global gradient norms (before the
    clip), every master tensor gathered whole
    (``utils.tensor_fragment``), this rank's own part of each (its shard on
    the device, or its host partition under ZeRO-Offload) and the host
    partition's size. ``ckpt``: (directory, "save" or "load"): save after
    the steps, or load before them (and return the loaded master).
    ``eval_rows``: also the ``eval_batch`` loss of the batch's first rows."""
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
                   "dp": dist.get_rank(dist.DP_AXES), "seq": dist.get_rank(dist.SEQ_AXIS)}
    if eval_rows is not None:
        out["eval"] = float(engine.eval_batch({k: v[:eval_rows] for k, v in batch.items()}))
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


# ---------------------------------------------------------------------------
# tensor parallelism


def tp_serve_run(name, tree, config, prompts, max_new, model_kw, spec=True):
    """An engine on the whole ``tree`` under the live mesh: ``generate()``
    greedy and sampled rows with the first rows' prefill logits, the
    scheduler streams of :func:`serve_streams` (greedy, sampled, a radix
    hit) on a full-precision and an int8 KV pool, a speculative scheduler's
    streams and logits and a long-context scheduler's (a 100-token prompt
    chained over two 64-row extents) (``spec``), the ready line's tensor
    part, the REPLICATED warnings and the local head counts."""
    import logging
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
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
    out = {"generate": [r.tolist() for r in eng.generate(prompts[:2], max_new_tokens=max_new)],
           "sampled": [r.tolist() for r in eng.generate(prompts[:2], max_new_tokens=max_new, do_sample=True,
                                                        temperature=0.8, top_k=20, seed=3)],
           "streams": streams, "int8_streams": int8_streams, "radix_hit": hit,
           "desc": eng._tp_desc() + eng._moe_desc(), "warnings": [m for m in records if "REPLICATED" in m
                                                                  or "fused-qkv" in m],
           "local_heads": (eng.model_config.local_heads, eng.model_config.local_kv_heads),
           "bitwise": eng.model_config.bitwise_tp, "fused": bool(eng._fused_decode_eligible())}
    ids = torch.tensor([list(prompts[0][:8])] * 2)
    with torch.no_grad():
        out["prefill_logits"] = eng.module.apply_with_cache(eng.net, ids, eng._init_cache(2, 64), 0)[0].float().numpy()
    if spec:
        sched = DecodeScheduler(eng, num_slots=4, prefill_chunk=16, collect_logits=True, spec_tokens=3)
        hs = [sched.submit(p, max_new_tokens=max_new) for p in prompts]
        hs.append(sched.submit(prompts[0], max_new_tokens=max_new, do_sample=True, temperature=0.9, seed=5))
        out["spec"] = [(h.result().tolist(), h.result_logits()) for h in hs]
        sched = DecodeScheduler(eng, num_slots=4, max_len=64, prefill_chunk=16, collect_logits=True, max_extents=2)
        long = [int(t) for t in np.random.default_rng(9).integers(0, eng.model_config.vocab_size, 100)]
        hs = [sched.submit(long, max_new_tokens=24), sched.submit(prompts[1], max_new_tokens=max_new)]
        out["long"] = [(h.result().tolist(), h.result_logits()) for h in hs]
        out["long_extents"] = int(sum(sched.ext_forwards.values()))
    return out


def tp_serve_world(rank, world, trees, config, prompts, max_new, cases):
    """:func:`tp_serve_run` for each ``(mesh layout, model name, model_kw,
    tree key, config overrides, spec)`` of ``cases``."""
    import deepspeed_tpu_torch.comm as dist
    out = []
    for layout, name, model_kw, key, over, spec in cases:
        dist.initialize_mesh(**layout)
        out.append(tp_serve_run(name, trees[key], {**config, **over}, prompts, max_new, model_kw, spec))
    return out


def tp_refusals_world(rank, world, tree, batch, cases):
    """Each ``(config, model_kw)`` of ``cases`` must refuse to build an
    engine: the messages, in order."""
    out = []
    for config, model_kw in cases:
        try:
            zero_run("tiny", tree, config, batch, 1, model_kw)
            out.append(None)
        except (ValueError, NotImplementedError) as e:
            out.append(str(e))
    return out


def tp_train_probe(name, tree, config, batch, model_kw):
    """One facade micro-step on this rank's rows under ``config``: the
    accumulated gradients of the tensors the model keeps whole over
    ``tensor`` (norm scales, biases of row-parallel projections), every
    dropout mask the step drew (key, shape, mask), the local model's head
    counts and this rank's tensor index."""
    import deepspeed_tpu_torch
    import deepspeed_tpu_torch.comm as dist
    import deepspeed_tpu_torch.models.transformer as tr
    from deepspeed_tpu_torch.models import get_model
    from deepspeed_tpu_torch.models.convert import params_from_jax
    model = get_model(name, dtype=torch.float32, attention_impl="flash", **model_kw)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params_from_jax(tree, model.cfg),
                                                config=dict(config), device="cpu")
    masks, draw = [], tr.dropout_mask

    def record(key, shape, rate, device, seq=None):
        m = draw(key, shape, rate, device, seq)
        masks.append((int(key), tuple(shape), m.numpy().copy()))
        return m

    tr.dropout_mask = record
    try:
        micro = engine.train_micro_batch_size_per_gpu()
        r = dist.get_rank(dist.DP_AXES)
        engine.forward({k: v[r * micro:(r + 1) * micro] for k, v in batch.items()})
    finally:
        tr.dropout_mask = draw
    whole = [k for k, d in engine._tp_dims.items() if d is None] if engine._tp > 1 else list(engine.master)
    grads = dict(zip(engine.master, engine._grad_acc))
    return {"grads": {k: grads[k].numpy().copy() for k in whole}, "masks": masks,
            "tp_rank": dist.get_rank(dist.TENSOR_AXIS),
            "local": (engine.module.cfg.local_heads, engine.module.cfg.local_kv_heads, engine.module.cfg.local_ffn)}


def tp_train_world(rank, world, name, tree, batch, steps, cases, probes):
    """:func:`zero_run` for each case of ``cases`` (as :func:`zero_world`),
    then :func:`tp_train_probe` for each ``(config, model_kw)`` of
    ``probes``."""
    return {"runs": [zero_run(name, tree, config, batch, steps, model_kw, mesh, ckpt)
                     for config, model_kw, mesh, ckpt in cases],
            "probes": [tp_train_probe(name, tree, config, batch, model_kw) for config, model_kw in probes]}


def tp_ops_world(rank, world, inputs):
    """The region operators' forward and backward over ``tensor`` (the
    whole world), and each ``sharded_*`` wrapper against its unsharded
    call, on this rank."""
    import deepspeed_tpu_torch.comm as dist
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention, sharded_flash_attention
    dist.initialize_mesh(tensor=world)
    x = torch.from_numpy(inputs["x"][rank]).requires_grad_(True)
    g = torch.from_numpy(inputs["g"])
    out = {}
    for name, fn in (("copy", dist.copy_to_region), ("reduce", dist.reduce_from_region),
                     ("gather", dist.gather_from_region)):
        y = fn(x)
        gy = g if name != "gather" else torch.cat([g] * world, dim=-1)
        (dx, ) = torch.autograd.grad(y, x, gy)
        out[name] = (y.detach().numpy().copy(), dx.numpy().copy())
    a = inputs["attn"]
    q, k, v = (torch.from_numpy(a[n]) for n in ("q", "k", "v"))
    out["flash"] = (sharded_flash_attention(q, k, v).numpy(), flash_attention(q, k, v).numpy())
    qd, kc, vc = (torch.from_numpy(a[n]) for n in ("qd", "kc", "vc"))
    start, ends = torch.zeros(qd.shape[0], dtype=torch.int32), torch.from_numpy(a["ends"])
    ext = torch.arange(qd.shape[0], dtype=torch.int32)[:, None]
    qs = torch.from_numpy(a["qs"])
    base = ends - qs.shape[2]
    out["paged_decode"] = (da.sharded_paged_decode_attention(qd, kc, vc, start, ends).numpy(),
                           da.paged_decode_attention(qd, kc, vc, start, ends).numpy())
    out["paged_span"] = (da.sharded_paged_span_attention(qs, kc, vc, start, base).numpy(),
                         da.paged_span_attention(qs, kc, vc, start, base).numpy())
    out["extent_decode"] = (da.sharded_extent_paged_decode_attention(qd, kc, vc, start, ends, ext).numpy(),
                            da.extent_paged_decode_attention(qd, kc, vc, start, ends, ext).numpy())
    out["extent_span"] = (da.sharded_extent_paged_span_attention(qs, kc, vc, start, base, ext).numpy(),
                          da.extent_paged_span_attention(qs, kc, vc, start, base, ext).numpy())
    try:
        da.sharded_paged_decode_attention(qd[:, :3], kc[:, :1], vc[:, :1], start, ends)
        out["odd_heads"] = None
    except ValueError as e:
        out["odd_heads"] = str(e)
    return out


# ---------------------------------------------------------------------------
# pipeline parallelism


def pipe_toy_world(rank, world, w, xs):
    """The schedules of ``runtime/pipe/schedule.py`` over a ``pipe`` group
    of the world on a toy stack (``x = tanh(x @ w[i])``, the stage's share
    of the layers): :func:`spmd_pipeline`'s stream, its aux sum (with aux:
    a stage's aux is the mean of its output) and the gradients of
    ``sum(stream ** 2) + aux`` w.r.t. the stage's layers and the stream,
    without aux and with it; :func:`spmd_pipeline_1f1b` with the head
    ``sum(y ** 2) / 2`` over ``loss_denom`` 2: the loss and the gradients;
    each schedule's largest in-flight count on this stage."""
    import deepspeed_tpu_torch.comm as dist
    from deepspeed_tpu_torch.runtime.pipe import schedule as sch
    dist.initialize_mesh(pipe=world)
    s, per = dist.get_rank(dist.PIPE_AXIS), w.shape[0] // world
    local = [torch.from_numpy(w[i]).requires_grad_(True) for i in range(s * per, (s + 1) * per)]
    x = torch.from_numpy(xs).requires_grad_(True)

    def stage_fn(ws, h, m):
        for wi in ws:
            h = torch.tanh(h @ wi)
        return h

    out = {"stage": s, "fill_drain": {}}
    for with_aux in (False, True):
        fn = (lambda ws, h, m: (lambda y: (y, y.mean()))(stage_fn(ws, h, m))) if with_aux else stage_fn
        res = sch.spmd_pipeline(fn, local, x, with_aux=with_aux)
        stream, aux = res if with_aux else (res, torch.zeros(()))
        grads = torch.autograd.grad((stream ** 2).sum() + aux, local + [x])
        out["fill_drain"][with_aux] = {"stream": stream.detach().numpy(), "aux": float(aux.detach()),
                                       "grads": [g.numpy() for g in grads[:-1]], "dx": grads[-1].numpy()}
    head = lambda hp, y, m: (y ** 2).sum() / 2
    loss, sg, _, dxs = sch.spmd_pipeline_1f1b(stage_fn, head, local, [], x.detach(), loss_denom=2.0)
    out["1f1b"] = {"loss": float(loss), "grads": [g.numpy() for g in sg], "dx": dxs.numpy()}
    out["in_flight"] = {}
    for name, fn in (("fill_drain", sch.fill_drain), ("1f1b", sch.one_f_one_b)):
        st = sch._FnStage(stage_fn, local, x.detach(), dist.PIPE_AXIS, loss_head=head)
        fn(st, xs.shape[0], (tuple(xs.shape[1:]), x.dtype, x.device))
        out["in_flight"][name] = st.max_in_flight
    return out


def pipe_run(name, tree, config, batch, steps, model_kw=None, mesh=None, ckpt=None, eval_rows=None,
             capture=False, save16=None):
    """``steps`` of ``train_batch`` on the global ``batch`` under
    ``config``: the losses, the grad norms, this rank's master tensors
    (``own``: a pipe stage holds its layers and the replicated tensors),
    its pipe stage, each step's schedule and largest in-flight count, with
    ``eval_rows`` the ``eval_batch`` loss of those rows, with ``capture``
    the first step's gradients summed over the data-parallel ranks (before
    the unscale and the clip). ``ckpt``: (directory, "save" or "load"), as
    :func:`zero_run`; ``save16``: a directory for ``save_16bit_model``
    after the steps."""
    import deepspeed_tpu_torch
    import deepspeed_tpu_torch.comm as dist
    from deepspeed_tpu_torch.models import get_model
    from deepspeed_tpu_torch.models.convert import params_from_jax
    if mesh is not None:
        dist.initialize_mesh(**mesh)
    model = get_model(name, dtype=torch.float32, attention_impl="flash", **(model_kw or {}))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params_from_jax(tree, model.cfg),
                                                config=dict(config), device="cpu")
    out = {"stage": engine._stage, "pipe": [], "grads": None}
    if capture:
        reduce = engine._reduce_grads

        def grab(grads, loss):
            loss = reduce(grads, loss)
            if out["grads"] is None:
                out["grads"] = {k: g.numpy().copy() for k, g in zip(engine.master, grads)}
            return loss

        engine._reduce_grads = grab
    if ckpt is not None and ckpt[1] == "load":
        engine.load_checkpoint(ckpt[0])
        out["loaded"] = {k: v.detach().numpy().copy() for k, v in engine.master.items()}
    out["losses"], out["norms"] = [], []
    for _ in range(steps):
        out["losses"].append(float(engine.train_batch(batch=batch)))
        out["norms"].append(float(engine._last_metrics["grad_norm"]))
        out["pipe"].append(getattr(engine, "last_pipe", None))
    if ckpt is not None and ckpt[1] == "save":
        engine.save_checkpoint(ckpt[0])
    out["own"] = {k: v.detach().numpy().copy() for k, v in engine.master.items()}
    if save16 is not None:
        engine.save_16bit_model(save16)
    if eval_rows is not None:
        out["eval"] = float(engine.eval_batch({k: v[:eval_rows] for k, v in batch.items()}))
    return out


def pipe_refusals(name, tree, batch, cases):
    """Each ``(config, model_kw)`` of ``cases``: the message of the error
    ``initialize`` or the facade raises (None: neither did)."""
    out = []
    for config, model_kw in cases:
        try:
            import deepspeed_tpu_torch
            from deepspeed_tpu_torch.models import get_model
            model = get_model(name, dtype=torch.float32, attention_impl="flash", **model_kw)
            engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=dict(config), device="cpu")
            engine.forward({k: v[:engine.train_micro_batch_size_per_gpu()] for k, v in batch.items()})
            out.append(None)
        except (ValueError, NotImplementedError, RuntimeError) as e:
            out.append(f"{type(e).__name__}: {e}")
    return out


def pipe_world(rank, world, trees, batches, cases, refusals=()):
    """:func:`pipe_run` for each case of ``cases`` (a dict of its keyword
    arguments, ``tree`` and ``batch`` naming entries of ``trees`` and
    ``batches``), in order; then :func:`pipe_refusals` of ``refusals``."""
    runs = []
    for case in cases:
        kw = dict(case)
        runs.append(pipe_run(kw.pop("name"), trees[kw.pop("tree")], kw.pop("config"), batches[kw.pop("batch")],
                             **kw))
    return {"runs": runs, "refusals": pipe_refusals("tiny", trees["tiny"], batches["plain"], refusals)
            if refusals else []}


# ---------------------------------------------------------------------------
# sequence parallelism


def ring_world(rank, world, inputs, cases):
    """The port's ring attention over ``seq`` on this rank's chunk of each
    case's q, k, v: ``cases`` maps a name to (inputs key, causal,
    schedule); returns each case's chunk of (out, dq, dk, dv) of ``sum(out
    * w)``; and the zig-zag relayout of ``inputs["relayout"]``'s chunk
    with its round trip."""
    import deepspeed_tpu_torch.comm as dist
    from deepspeed_tpu_torch.ops import ring_attention as ra
    dist.initialize_mesh(seq=world)
    out = {}
    for name, (key, causal, schedule) in cases.items():
        q, k, v, w = (torch.from_numpy(inputs[key][x]) for x in "qkvw")
        Tc = q.shape[2] // world
        rows = slice(rank * Tc, (rank + 1) * Tc)
        leaves = [t[:, :, rows].clone().requires_grad_(True) for t in (q, k, v)]
        o = ra.ring_attention(*leaves, causal=causal, schedule=schedule)
        (o * w[:, :, rows]).sum().backward()
        out[name] = [o.detach().numpy()] + [t.grad.numpy() for t in leaves]
    x = torch.from_numpy(inputs["relayout"])
    Tc = x.shape[2] // world
    z = ra._zigzag_relayout(x[:, :, rank * Tc:(rank + 1) * Tc], dist.SEQ_AXIS, world)
    out["relayout"] = (z.numpy(), ra._zigzag_relayout(z, dist.SEQ_AXIS, world, inverse=True).numpy())
    return out


def seq_ops_world(rank, world, inputs):
    """The seq axis's operators on this rank: ``seq_sharded_span_attention``
    (paged and extent, bf16 and int8 KV, a lossy window) against the
    unsharded call, ``all_gather_autograd`` and the all-to-all over
    ``seq`` forward and backward, and the head tiling."""
    import deepspeed_tpu_torch.comm as dist
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops.quantizer import quantize_kv_rows
    dist.initialize_mesh(seq=world)
    a = {k: torch.from_numpy(v) for k, v in inputs.items()}
    out = {}
    q, kc, vc, start, base = a["q"], a["kc"], a["vc"], a["start"], a["base"]
    B = q.shape[0]  # the paged modes read the pool's first B rows; the extent modes all of it
    out["paged"] = (da.seq_sharded_span_attention(q, kc[:B], vc[:B], start, base).numpy(),
                    da.paged_span_attention(q, kc[:B], vc[:B], start, base).numpy())
    kq, vq, sc = quantize_kv_rows(kc, vc)
    out["paged_int8"] = (
        da.seq_sharded_span_attention(q, kq[:B], vq[:B], start, base, k_scale=sc[:B], v_scale=sc[:B]).numpy(),
        da.paged_span_attention(q, kq[:B], vq[:B], start, base, k_scale=sc[:B], v_scale=sc[:B]).numpy())
    ext, sink, win = a["ext"], a["sink"], a["win"]
    out["extent"] = (da.seq_sharded_span_attention(q, kc, vc, start, base, ext=ext).numpy(),
                     da.extent_paged_span_attention(q, kc, vc, start, base, ext).numpy())
    out["extent_lossy_int8"] = (
        da.seq_sharded_span_attention(q, kq, vq, start, base, k_scale=sc, v_scale=sc, ext=ext, sink=sink,
                                      window=win).numpy(),
        da.extent_paged_span_attention(q, kq, vq, start, base, ext, k_scale=sc, v_scale=sc, sink=sink,
                                       window=win).numpy())
    try:
        da.seq_sharded_span_attention(q[:, :, :world + 1], kc[:B], vc[:B], start, base)
    except ValueError as e:
        out["odd_width"] = str(e)
    x = a["x"][rank].clone().requires_grad_(True)  # (2, 3, 5): gathered on dim 1
    y = dist.all_gather_autograd(x, dist.SEQ_AXIS, 1)
    (y * a["g"]).sum().backward()
    out["gather"] = (y.detach().numpy(), x.grad.numpy())
    h = a["h"][rank].clone().requires_grad_(True)  # (B, heads, Tc, D): heads to seq and back
    t = dist.AllToAll.apply(h, dist.SEQ_AXIS, 1, 2)
    back = dist.AllToAll.apply(t, dist.SEQ_AXIS, 2, 1)
    (t * (rank + 1)).sum().backward()
    out["a2a"] = (t.detach().numpy(), back.detach().numpy(), h.grad.numpy())
    out["tiling"] = [dist.attention_partition_axes(b, n) for b, n in ((2, 4), (2, 3))]
    return out


def seq_train_world(rank, world, trees, batches, cases):
    """Each case ``(kind, kwargs)`` in order: ``"zero"`` runs
    :func:`zero_run`, ``"pipe"`` :func:`pipe_run`, ``"refuse"`` builds the
    engine, takes one step and returns the error's message (None when
    neither raised; ``loss_fn`` a bare loss function in place of the
    model). ``tree`` and ``batch`` name entries of ``trees`` and
    ``batches``."""
    runs = []
    for kind, case in cases:
        kw = dict(case)
        name, tree, batch = kw.pop("name", "tiny"), trees[kw.pop("tree")], batches[kw.pop("batch")]
        if kind == "zero":
            runs.append(zero_run(name, tree, kw.pop("config"), batch, kw.pop("steps"), kw.pop("model_kw", {}),
                                 **kw))
        elif kind == "pipe":
            runs.append(pipe_run(name, tree, kw.pop("config"), batch, kw.pop("steps"), **kw))
        else:
            try:
                import deepspeed_tpu_torch
                from deepspeed_tpu_torch.models import get_model
                model = get_model(name, dtype=torch.float32, attention_impl="flash", **kw.get("model_kw", {}))
                if kw.get("loss_fn"):
                    model = lambda p, b: torch.zeros(())  # noqa: E731  a bare loss function
                engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=dict(kw["config"]), device="cpu")
                engine.train_batch(batch=batch)
                runs.append(None)
            except (ValueError, NotImplementedError, RuntimeError) as e:
                runs.append(f"{type(e).__name__}: {e}")
    return runs


def seq_serve_run(eng, prompts, sched_kw):
    """Greedy and sampled streams with their logits through a fresh
    scheduler, and its seq-parallel shape: (shards, wide chunk) and the
    widths dispatched."""
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    sched = DecodeScheduler(eng, num_slots=4, collect_logits=True, **sched_kw)
    hs = [sched.submit(p, max_new_tokens=24) for p in prompts]
    hs.append(sched.submit(prompts[0], max_new_tokens=24, temperature=0.8, top_k=20, seed=7, do_sample=True))
    streams = [(h.result().tolist(), np.stack(h.result_logits())) for h in hs]
    return {"streams": streams, "shape": (sched._seq_shards, sched._seq_chunk),
            "widths": sorted({c for c, _ in sched.dispatched})}


def seq_serve_world(rank, world, name, tree, config, prompts, cases):
    """:func:`seq_serve_run` for each scheduler setting of ``cases`` on an
    engine over the mesh ``seq = world``."""
    import deepspeed_tpu_torch
    import deepspeed_tpu_torch.comm as dist
    from deepspeed_tpu_torch.models import get_model
    from deepspeed_tpu_torch.models.convert import params_from_jax
    dist.initialize_mesh(seq=world)
    model = get_model(name, max_seq_len=128)
    eng = deepspeed_tpu_torch.init_inference(model, config=dict(config), params=params_from_jax(tree, model.cfg),
                                             device="cpu")
    return [seq_serve_run(eng, prompts, kw) for kw in cases]


# ---------------------------------------------------------------------------
# serving across ranks: the gateway on rank 0, the other ranks following

_MADE = []  # every request this process's schedulers made, in order


def _record_requests():
    """Record every request the port's schedulers make in this process."""
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    if getattr(DecodeScheduler._make_request, "recorded", False):
        return
    real = DecodeScheduler._make_request

    def make(self, *args, **kwargs):
        req = real(self, *args, **kwargs)
        _MADE.append(req)
        return req
    make.recorded = True
    DecodeScheduler._make_request = make


def sse(port, prompt, max_new, disconnect_after=None):
    """One streaming completion: (status, token ids). ``disconnect_after``:
    close the connection once that many tokens arrived."""
    import http.client
    import json
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    toks = []
    try:
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": [int(t) for t in prompt], "max_tokens": max_new, "stream": True}))
        resp = conn.getresponse()
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: {"):
                toks += json.loads(line[6:])["choices"][0]["token_ids"]
                if disconnect_after is not None and len(toks) >= disconnect_after:
                    break
        return resp.status, toks
    finally:
        conn.close()


def gateway_rank_case(rank, name, tree, config, mesh, prompts, max_new, replicas, plant):
    """One engine over ``mesh``: on rank 0 a gateway with ``replicas``
    serving every prompt as a concurrent SSE stream, then a stream whose
    client disconnects after 2 tokens (the replica's steps slowed so it is
    still decoding), then, after ``plant``, one more request; on the other
    ranks :func:`~deepspeed_tpu_torch.serving.gateway.follow` (with
    ``plant``, skipping the first cancel rank 0 sends). Returns this rank's
    requests as (rid, tokens, cancelled) and what it saw."""
    import threading
    import deepspeed_tpu_torch
    import deepspeed_tpu_torch.comm as dist
    from deepspeed_tpu_torch.models import get_model
    from deepspeed_tpu_torch.models.convert import params_from_jax
    from deepspeed_tpu_torch.serving import Gateway, Replica, follow
    _record_requests()
    del _MADE[:]
    dist.initialize_mesh(**mesh)
    model = get_model(name, max_seq_len=128)
    cfg = {**config, "continuous_batching": {**config["continuous_batching"], "replicas": replicas}}
    eng = deepspeed_tpu_torch.init_inference(model, config=cfg, params=params_from_jax(tree, model.cfg), device="cpu")
    out = {}
    if rank != 0:
        if plant:
            real = Replica._apply
            skipped = []

            def apply(self, reqs, call):
                if call[0] == "cancel" and not skipped:
                    skipped.append(call[1])
                    return
                real(self, reqs, call)
            Replica._apply = apply
        try:
            out["rc"] = follow(eng)
        except RuntimeError as e:
            out["error"] = str(e)
        finally:
            if plant:
                Replica._apply = real
    else:
        gw = Gateway(eng, port=0, request_timeout_s=60.0, drain_timeout_s=60.0)
        try:
            gw.start_background()
            streams = [None] * len(prompts)

            def client(i):
                streams[i] = sse(gw.port, prompts[i], max_new)
            threads = [threading.Thread(target=client, args=(i, )) for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            out["streams"] = streams
            out["dispatched"] = [r.dispatched for r in gw.replicas]
            rep = gw.replicas.replicas[0]
            real_step = rep.step

            def slow():
                n = real_step()
                time.sleep(0.05)
                return n
            rep.step = slow
            if replicas > 1:
                gw.replicas.drain(1)  # the long stream lands on replica 0
            out["disconnected"] = sse(gw.port, prompts[0], 100, disconnect_after=2)
            deadline = time.monotonic() + 30
            while (gw._active or rep.scheduler.cache.active_slots) and time.monotonic() < deadline:
                time.sleep(0.01)
            out["freed"] = not gw._active and rep.scheduler.cache.active_slots == 0
            if plant:
                out["after"] = sse(gw.port, prompts[1], max_new)
        finally:
            out["drained"] = gw.close(60)
        out["fatal"] = gw._fatal
        out["stats"] = dict(gw.stats)
    out["reqs"] = [(r.rid, list(r.out), r.cancelled) for r in _MADE]
    return out


def gateway_ranks_world(rank, world, trees, cases):
    """:func:`gateway_rank_case` for each ``(model name, tree key, config,
    mesh, prompts, max_new, replicas, plant)`` of ``cases``."""
    return [gateway_rank_case(rank, name, trees[key], config, mesh, prompts, max_new, replicas, plant)
            for name, key, config, mesh, prompts, max_new, replicas, plant in cases]
