"""The port's MoE (``deepspeed_tpu_torch/moe``, the MoE branch of
``models/transformer.py``) on one rank, against the JAX package on the same
numpy inputs and weights (``params_from_jax``):

- the gate: dispatch masks bitwise, combine weights, aux loss and drop
  fraction within 1e-6, at top 1 and 2, with tied logits and with tokens
  dropped at capacity factor 0.5; the serving weights within 1e-6;
- the MoE layer's output and its gradients (input, router and experts,
  through output and aux loss) against ``jax.vjp`` at fp32 within 1e-5 of
  the largest magnitude;
- ``tiny-moe`` training losses under a remat policy within rtol 1e-4 of the
  JAX engine's (``tests/unit/test_models.py``'s tolerance);
- greedy ``generate()`` tokens equal and scheduler tokens equal with step
  logits within 1e-4 of max|ref| (fp32, per-projection path, tp 1);
- the int8 tree: ``quantize_params`` bitwise JAX's, expert leaves (L, E, K,
  N) carried across by ``params_from_jax``;
- per-layer routed-token counts equal JAX's, summing to top-k times the
  live columns, and the scheduler's ``serving/expert_dispatch_tokens``;
- the port against itself: a request's stream and logits bitwise the same
  alone and beside others;
- the fused gate's MoE reason and the ready line's ``moe[...]`` part word
  for word the JAX engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.models as jm
import deepspeed_tpu_torch
import deepspeed_tpu_torch.models as tm
from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu.moe import sharded_moe as jgate
from deepspeed_tpu.moe.layer import MoE as JaxMoE
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.moe import sharded_moe as tgate
from deepspeed_tpu_torch.moe.layer import MoE

from .torch_port_helpers import numpy_params, to_numpy

PROMPTS = [[5, 6, 7, 8, 9], [10, 11, 12], [int(t) for t in np.resize(np.arange(3, 40), 70)]]


def _logits(N=24, E=4, seed=0):
    x = np.random.default_rng(seed).standard_normal((N, E)).astype(np.float32)
    x[3] = [1.0, 1.0, 0.5, 0.5]  # ties: the lowest index wins each round
    x[7] = [0.25, 0.25, 0.25, 0.25]
    x[8:16, 2] += 3.0  # a crowded expert: drops at low capacity
    return x


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_gating_matches_jax(k, cf):
    x = _logits()
    jd, jc, ja, jf = (np.asarray(a) for a in jgate.top_k_gating(jnp.asarray(x), k, cf))
    td, tc, ta, tf = (t.numpy() for t in tgate.top_k_gating(torch.from_numpy(x), k, cf))
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-6)
    if cf == 0.5:
        assert tf > 0  # tokens dropped


@pytest.mark.parametrize("k", [1, 2])
def test_serving_weights_match_jax(k):
    x = _logits()
    want = np.asarray(jgate.top_k_serving_weights(jnp.asarray(x), k))
    got = tgate.top_k_serving_weights(torch.from_numpy(x), k).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert ((got > 0).sum(-1) == k).all()


def _layer_params(cfg, seed):
    rng = np.random.default_rng(seed)
    H, F, E = cfg.hidden_size, cfg.ffn_size, cfg.num_experts
    return {"gate": (0.3 * rng.standard_normal((H, E))).astype(np.float32),
            "experts": {n: (0.1 * rng.standard_normal(s)).astype(np.float32)
                        for n, s in (("gate_proj", (E, H, F)), ("up_proj", (E, H, F)),
                                     ("down_proj", (E, F, H)))}}


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_layer_output_and_grads_match_jax_vjp(cf):
    jcfg = jm.get_model("tiny-moe", dtype=jnp.float32, moe_capacity_factor=cf).cfg
    tcfg = tm.get_model("tiny-moe", dtype=torch.float32, moe_capacity_factor=cf).cfg
    p = _layer_params(jcfg, 1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, jcfg.hidden_size)).astype(np.float32)
    dout = rng.standard_normal(x.shape).astype(np.float32)
    daux = np.float32(1.7)

    (jout, jaux), vjp = jax.vjp(lambda p, x: JaxMoE(jcfg).apply({"params": p}, x),
                                jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    jgp, jgx = vjp((jnp.asarray(dout), jnp.asarray(daux)))

    tp = {"gate": torch.from_numpy(p["gate"]).requires_grad_(True),
          **{f"experts.{n}": torch.from_numpy(v).requires_grad_(True) for n, v in p["experts"].items()}}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux, drop = torch.func.functional_call(MoE(tcfg), tp, (tx, ))
    (out * torch.from_numpy(dout)).sum().add(aux * float(daux)).backward()

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    close(out.detach().numpy(), jout)
    close(aux.detach().numpy(), jaux)
    close(tx.grad.numpy(), jgx)
    close(tp["gate"].grad.numpy(), jgp["gate"])
    for n in ("gate_proj", "up_proj", "down_proj"):
        close(tp[f"experts.{n}"].grad.numpy(), jgp["experts"][n])
    if cf == 0.5:
        assert float(drop) > 0


TRAIN = {"train_batch_size": 16, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
         "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
         "activation_checkpointing": {"policy": "nothing_saveable"}, "steps_per_print": 10**9}


def test_engine_losses_match_jax():
    """tiny-moe, fp32, each block under the nothing_saveable checkpoint (the
    aux loss leaves the checkpoint as an output): 4 steps within rtol 1e-4
    of the JAX engine's."""
    jmod = jm.get_model("tiny-moe", dtype=jnp.float32, attention_impl="flash")
    tree = numpy_params(jmod, 0)
    batch = {"input_ids": np.random.default_rng(1).integers(0, 256, (16, 64)).astype(np.int32)}
    jcomm._state["mesh"] = None
    je, *_ = deepspeed_tpu.initialize(model=jmod, config=dict(TRAIN),
                                      model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
    want = [float(je.train_batch(batch=batch)) for _ in range(4)]
    model = tm.get_model("tiny-moe", dtype=torch.float32, attention_impl="flash")
    te, *_ = deepspeed_tpu_torch.initialize(model=model, config=dict(TRAIN), device="cpu",
                                            model_parameters=params_from_jax(to_numpy(tree), model.cfg))
    got = [float(te.train_batch(batch=batch)) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    assert te.module.last_moe["drop_frac"].shape == (2, )


def _tree(seed=10):
    return numpy_params(jm.get_model("tiny-moe", max_seq_len=128), seed=seed)


def _config(collect=False, **cfg):
    return {"dtype": "float32", "max_out_tokens": 128,
            "continuous_batching": {"enabled": True, "num_slots": 4, "collect_logits": collect}, **cfg}


def _port(collect=False, **cfg):
    from deepspeed_tpu_torch.telemetry import set_sink
    set_sink(None)  # each engine builds its own sink from its config
    tmod = tm.get_model("tiny-moe", max_seq_len=128)
    return deepspeed_tpu_torch.init_inference(tmod, config=_config(collect, **cfg), device="cpu",
                                              params=params_from_jax(to_numpy(_tree()), tmod.cfg))


def _jax(collect=False, **cfg):
    from deepspeed_tpu.telemetry import set_sink
    jcomm._state["mesh"] = None
    set_sink(None)
    return deepspeed_tpu.init_inference(jm.get_model("tiny-moe", max_seq_len=128),
                                        config=_config(collect, **cfg), params=_tree())


def test_generate_and_scheduler_match_jax():
    je, te = _jax(collect=True), _port(collect=True)
    want = [r.tolist() for r in je.generate(PROMPTS[:2], max_new_tokens=8)]
    assert [r.tolist() for r in te.generate(PROMPTS[:2], max_new_tokens=8)] == want
    jh = [je.scheduler().submit(p, max_new_tokens=8) for p in PROMPTS]
    th = [te.scheduler().submit(p, max_new_tokens=8) for p in PROMPTS]
    for j, t in zip(jh, th):
        assert t.result().tolist() == j.result().tolist()
        jl, tl = j.result_logits(), t.result_logits()
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4 * np.abs(jl).max())


def test_int8_tree_matches_jax():
    """quantize_params on each side, the JAX tree carried across: every
    leaf bitwise (int8 weights, fp32 scales, the router in bf16)."""
    jmod = jm.get_model("tiny-moe")
    tree = to_numpy(_tree())
    tmod = tm.get_model("tiny-moe", int8_weights=True)
    want = params_from_jax(to_numpy(jmod.quantize_params(tree)), tmod.cfg)
    got = tm.get_model("tiny-moe").quantize_params(params_from_jax(tree, tm.get_model("tiny-moe").cfg))
    assert set(got) == set(want) == set(tmod.param_shapes())
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert want["layers.1.moe.experts.down_proj_q"].shape == (4, 128, 64)
    assert want["layers.1.moe.experts.down_proj_scale"].shape == (4, 1, 64)


def test_expert_counts_match_jax():
    """Routed-token counts of one slot-pool step (rows of 4, 7 and 0 live
    columns) equal JAX's, and each layer's sum is top-k x live columns."""
    jmod = jm.get_model("tiny-moe", dtype=jnp.float32, max_seq_len=128)
    tmod = tm.get_model("tiny-moe", dtype=torch.float32, max_seq_len=128)
    tree = _tree()
    ids = np.random.default_rng(3).integers(0, 256, (3, 8)).astype(np.int32)
    lens, spans = np.array([0, 5, 9], np.int32), np.array([4, 7, 0], np.int32)
    pos = lens[:, None] + np.arange(8)[None, :]
    _, _, want = jmod.apply_with_cache(tree, jnp.asarray(ids), jmod.init_cache(3, 64), 0,
                                       position_ids=jnp.asarray(pos), write_index=jnp.asarray(lens),
                                       q_spans=jnp.asarray(spans), expert_stats=True)
    params = params_from_jax(to_numpy(tree), tmod.cfg)
    _, _, got = tmod.apply_with_cache(params, torch.as_tensor(ids).long(), tmod.init_cache(3, 64), 0,
                                      position_ids=torch.as_tensor(pos).long(),
                                      write_index=torch.as_tensor(lens).long(),
                                      q_spans=torch.as_tensor(spans).long(), expert_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.sum(-1) == 2 * spans.sum()).all()
    with pytest.raises(NotImplementedError, match="#9"):
        tmod.apply_with_cache(params, torch.as_tensor(ids).long(), tmod.init_cache(3, 64), 0,
                              expert_ops=({}, ))


def test_scheduler_expert_telemetry(tmp_path):
    """With telemetry on, every live column of every chunk and decode
    forward is routed to top-k experts in each layer (K = 1, no prefix
    cache: nothing past a budget, no cached tokens)."""
    te = _port(telemetry={"enabled": True, "output_path": str(tmp_path)})
    sched = te.scheduler(steps_per_sync=1, prefix_cache=False)
    for p in PROMPTS:
        sched.submit(p, max_new_tokens=6).result()
    live = sum(len(p) + 6 - 1 for p in PROMPTS)
    want = 2 * te.model_config.num_layers * live
    assert sched.expert_dispatch_tokens == want
    assert te.telemetry.counter_total("serving/expert_dispatch_tokens") == want
    te.telemetry.flush()
    assert "serving/expert_load_balance" in (tmp_path / "telemetry.jsonl").read_text()


def test_rows_are_batch_independent():
    """A request alone and beside two others: tokens and logits bitwise."""
    te = _port(collect=True)
    together = [te.scheduler().submit(p, max_new_tokens=6) for p in PROMPTS]
    together = [(h.result().tolist(), h.result_logits()) for h in together]
    for p, (tokens, logits) in zip(PROMPTS, together):
        h = _port(collect=True).scheduler().submit(p, max_new_tokens=6)
        assert h.result().tolist() == tokens
        np.testing.assert_array_equal(h.result_logits(), logits)


def test_fused_gate_reason_and_ready_line_match_jax():
    cfg = {"dtype": "int8", "kernel_inject": True, "max_out_tokens": 128}
    jcomm._state["mesh"] = None
    je = deepspeed_tpu.init_inference(jm.get_model("tiny-moe", max_seq_len=128), config=dict(cfg),
                                      params=_tree())
    tmod = tm.get_model("tiny-moe", max_seq_len=128)
    te = deepspeed_tpu_torch.init_inference(tmod, config=dict(cfg), device="cpu",
                                            params=params_from_jax(to_numpy(_tree()), tmod.cfg))
    jr = [r for r in je._fused_decode_eligible().reasons if "num_experts" in r]
    tr = [r for r in te._fused_decode_eligible().reasons if "num_experts" in r]
    assert tr == jr and len(tr) == 1
    assert te._moe_desc() == " moe[4e top2] ep=1"
    assert te._moe_desc() in je._shard_desc()
    assert not te.scheduler()._fused_block
    out = te.generate(PROMPTS[:2], max_new_tokens=4)
    assert all(len(r) == 4 for r in out)
    with pytest.raises(NotImplementedError, match="#9"):
        deepspeed_tpu_torch.init_inference(
            tm.get_model("tiny-moe"), device="cpu",
            config={"continuous_batching": {"expert_offload": {"enabled": True}}})
