"""Sequence parallelism across ranks: gloo worlds of 2 and 4 on the CPU
(``tests/torch_dist_workers.py``; each world spawns once for its cases,
under its own deadline), fp32, the plain versions of the kernels standing
in. The JAX engine runs in this process on the conftest's CPU devices at
the same mesh (``tests/unit/test_sequence_parallel.py``'s settings: the
seq axis, the rest data) on the same weights (``params_from_jax``).

Training (``tiny``, AdamW, clip 1.0, three steps, (16, 128) batches so the
flash path runs; ``RTOL`` the JAX tests' 2e-4): every rank's losses and
global grad norms within ``RTOL`` of the port's sp 1 and of the JAX engine
at the same mesh, the gathered masters within ``RTOL`` / ``MASTER_ATOL`` of
sp 1's and bitwise on every rank:
- world 2: sp 2 Ulysses (all-to-all of q, k, v), ring zig-zag and
  unbalanced, ZeRO 1-3 (stage 3 at threshold 0 and under ring), a remat
  policy over the ring, dropout (every seq chunk draws the whole
  sequence's masks: within ``RTOL`` of sp 1 with dropout), an attention
  mask (the plain path, the key mask gathered over ``seq``), learned
  positions (``tiny-gpt2``), an MoE model (capacity gating in the global
  token order over ``seq``), ``eval_batch``, and a stage-3 checkpoint
  saved at sp 2 loaded at dp 2 bitwise;
- world 4: sp 4 Ulysses (2 kv heads on 4 ranks: k/v gathered over
  ``seq``), ring zig-zag and unbalanced, heads sp 4 does not divide (6
  heads: the sequence gathered), dp 2 x sp 2 at stages 0, 2 and 3, sp 2 x
  tp 2 Ulysses and ring, ``tiny-moe`` at expert 2 x seq 2, pipe 2 x sp 2
  under fill-drain (``auto`` picks it; 1F1B refuses seq, as in JAX).

Serving: the scheduler's sequence-parallel prefill at seq 2 and 4 (wide
chunks of 32 and 64 columns, the span attention's query columns split over
``seq``): greedy and sampled streams, tokens and logits, bitwise the
one-rank scheduler's at the base chunk, on the bf16 and int8 KV pools and
over a 2-extent chain; ``seq_sharded_span_attention`` (paged and extent,
bf16 and int8, a lossy window) bitwise the unsharded call.

Refusals: the offload tiers at sp > 1, a bare loss function, a sequence
the degree does not divide, 1F1B under seq, and the seq-parallel prefill
at tp > 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.models as jm
import deepspeed_tpu_torch
from deepspeed_tpu.comm import comm as jcomm
from deepspeed_tpu_torch.models import get_model
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.transformer import dropout_mask

from . import torch_dist_workers as workers
from .torch_dist_workers import run_world, zero_run
from .torch_port_helpers import numpy_params, to_numpy

TRAIN = {"train_batch_size": 16, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
         "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}}, "steps_per_print": 10**9}
STEPS = 3
RTOL = 2e-4
# AdamW steps an element whose gradient is near zero by anything up to lr
# (1e-3) on a reordered sum: a tenth of a step
MASTER_ATOL = 1e-4
ODD = {"hidden_size": 96, "num_heads": 6, "num_kv_heads": 3}
RING = {"sequence_parallel_impl": "ring"}
UNBALANCED = {**RING, "ring_schedule": "unbalanced"}
DEADLINE_S = 300


def _tree(name, **kw):
    return to_numpy(numpy_params(jm.get_model(name, dtype=jnp.float32, attention_impl="flash", **kw), 0))


def _batches():
    ids = np.random.default_rng(1).integers(0, 256, (16, 128)).astype(np.int32)
    mask = np.ones((16, 128), bool)
    mask[:, 100:] = False
    return {"plain": {"input_ids": ids}, "masked": {"input_ids": ids, "attention_mask": mask}}


def _cfg(sp=1, stage=0, threshold=0, **mesh):
    return {**TRAIN, "mesh": {**({"sequence_parallel_size": sp} if sp > 1 else {}), **mesh},
            "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": threshold}}


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


def _check(ranks, idx, ref, jax_ref, what, masters=True):
    """Run ``idx`` of every rank: norms and losses within ``RTOL`` of
    ``ref`` (the port's sp 1) and ``jax_ref``, the masters within ``RTOL``
    of sp 1's and bitwise on every rank."""
    for rank, res in enumerate(ranks):
        got = res[idx]
        for key in ("norms", "losses"):
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL, err_msg=f"{what} rank {rank} {key}")
            if jax_ref is not None:
                np.testing.assert_allclose(got[key], jax_ref[key], rtol=RTOL,
                                           err_msg=f"{what} rank {rank} {key} vs JAX")
        if masters and "master" in got:
            for k, whole in got["master"].items():
                want = ref["master"][k]
                if ".moe.experts." in k and whole.shape != want.shape:  # this rank's experts
                    n = whole.shape[0]
                    want = want[got["rank"]["expert"] * n:(got["rank"]["expert"] + 1) * n]
                else:  # gathered whole over data, bitwise on every rank
                    np.testing.assert_array_equal(whole, ranks[0][idx]["master"][k], err_msg=f"{what} {k}")
                if k.endswith("k_proj.bias"):
                    # its gradient is zero in exact arithmetic (a softmax row
                    # ignores a shift common to its keys), so AdamW steps the
                    # rounding noise of either sum by up to lr a step
                    continue
                np.testing.assert_allclose(whole, want, rtol=RTOL, atol=MASTER_ATOL, err_msg=f"{what} {k}")


def _zero(tree, config, batch="plain", name="tiny", **kw):
    return ("zero", {"name": name, "tree": tree, "config": config, "batch": batch, "steps": STEPS, **kw})


def test_dropout_masks_of_a_chunk_are_the_whole_sequences():
    """``dropout_mask`` of chunk s of n draws the whole sequence's mask at
    the chunk's rows."""
    whole = dropout_mask(12345, (3, 64, 16), 0.3, "cpu")
    for n in (2, 4):
        for s in range(n):
            part = dropout_mask(12345, (3, 64 // n, 16), 0.3, "cpu", seq=(s, n))
            assert torch.equal(part, whole[:, s * 64 // n:(s + 1) * 64 // n])


def test_training_sp2(tmp_path):
    trees = {"tiny": _tree("tiny"), "gpt2": _tree("tiny-gpt2"), "moe": _tree("tiny-moe")}
    batches = _batches()
    plain = batches["plain"]
    ref = zero_run("tiny", trees["tiny"], _cfg(), plain, STEPS, {}, eval_rows=8)
    drop_ref = zero_run("tiny", trees["tiny"], _cfg(), plain, STEPS, {"dropout": 0.1})
    mask_ref = zero_run("tiny", trees["tiny"], _cfg(), batches["masked"], STEPS, {})
    gpt2_ref = zero_run("tiny-gpt2", trees["gpt2"], _cfg(), plain, STEPS, {})
    moe_ref = zero_run("tiny-moe", trees["moe"], _cfg(), plain, STEPS, {})
    jax_ulysses = _jax_run("tiny", trees["tiny"], _cfg(2), plain)
    jax_ring = _jax_run("tiny", trees["tiny"], _cfg(2), plain, **RING)
    jax_zero3 = _jax_run("tiny", trees["tiny"], _cfg(2, 3), plain)
    jax_moe = _jax_run("tiny-moe", trees["moe"], _cfg(2), plain)
    ck = str(tmp_path / "ck")
    remat = {"activation_checkpointing": {"policy": "nothing_saveable"}}
    cases = [_zero("tiny", _cfg(2), eval_rows=8),                                        # 0 Ulysses
             _zero("tiny", _cfg(2), model_kw=RING),                                      # 1 ring zig-zag
             _zero("tiny", _cfg(2, 1)), _zero("tiny", _cfg(2, 2)), _zero("tiny", _cfg(2, 3)),  # 2-4
             _zero("tiny", _cfg(2, 3), model_kw=RING),                                   # 5
             _zero("tiny", {**_cfg(2), **remat}, model_kw=RING),                         # 6
             _zero("tiny", _cfg(2), model_kw={"dropout": 0.1}),                          # 7
             _zero("tiny", _cfg(2), batch="masked"),                                     # 8
             _zero("gpt2", _cfg(2), name="tiny-gpt2"),                                   # 9
             _zero("moe", _cfg(2), name="tiny-moe"),                                     # 10
             _zero("tiny", _cfg(2, 3), ckpt=(ck, "save")),                               # 11
             _zero("tiny", _cfg(1, 3, data_parallel_size=2), ckpt=(ck, "load")),         # 12
             ("refuse", {"tree": "tiny", "batch": "plain", "config": {
                 **_cfg(2), "zero_optimization": {"stage": 0, "offload_optimizer": {"device": "cpu"}}}}),
             ("refuse", {"tree": "tiny", "batch": "plain", "config": _cfg(2), "loss_fn": True}),
             ("refuse", {"tree": "tiny", "batch": "odd", "config": _cfg(2)}),
             _zero("tiny", _cfg(2), model_kw=UNBALANCED)]                                # 16
    batches["odd"] = {"input_ids": plain["input_ids"][:, :127]}
    ranks = run_world(workers.seq_train_world, 2, tmp_path, trees, batches, cases, timeout=DEADLINE_S)
    _check(ranks, 0, ref, jax_ulysses, "sp 2 Ulysses")
    _check(ranks, 1, ref, jax_ring, "sp 2 ring")
    for i in (2, 3):
        _check(ranks, i, ref, jax_ulysses, f"sp 2 stage {i - 1}")
    _check(ranks, 4, ref, jax_zero3, "sp 2 stage 3")
    _check(ranks, 5, ref, jax_zero3, "sp 2 ring stage 3")
    _check(ranks, 6, ref, jax_ring, "sp 2 ring under nothing_saveable")
    _check(ranks, 7, drop_ref, None, "sp 2 dropout")
    _check(ranks, 8, mask_ref, None, "sp 2 attention mask")
    _check(ranks, 9, gpt2_ref, None, "sp 2 tiny-gpt2")
    _check(ranks, 10, moe_ref, jax_moe, "sp 2 tiny-moe")
    _check(ranks, 16, ref, jax_ring, "sp 2 ring unbalanced")
    for rank, res in enumerate(ranks):
        assert res[0]["rank"]["seq"] == rank and res[0]["rank"]["dp"] == 0
        np.testing.assert_allclose(res[0]["eval"], ref["eval"], rtol=RTOL)
        assert all("seq" not in str(sp) for sp in res[4]["specs"].values())  # seq ranks hold replicas
        for k, whole in res[11]["master"].items():
            np.testing.assert_array_equal(res[12]["loaded"][k], whole, err_msg=k)
        offload, bare, odd = res[13:16]
        assert offload.startswith("NotImplementedError") and "#7.4" in offload
        assert bare.startswith("ValueError") and "seq_shard" in bare
        assert odd.startswith("ValueError") and "does not split over sequence_parallel_size=2" in odd


def test_training_sp4_dp_tp_moe_pipe(tmp_path):
    trees = {"tiny": _tree("tiny"), "odd": _tree("tiny", **ODD), "moe": _tree("tiny-moe")}
    batches = _batches()
    plain = batches["plain"]
    ref = zero_run("tiny", trees["tiny"], _cfg(), plain, STEPS, {})
    odd_ref = zero_run("tiny", trees["odd"], _cfg(), plain, STEPS, ODD)
    moe_ref = zero_run("tiny-moe", trees["moe"], _cfg(), plain, STEPS, {})
    jax_sp4 = _jax_run("tiny", trees["tiny"], _cfg(4), plain, **RING)
    jax_tp = _jax_run("tiny", trees["tiny"], _cfg(2, tensor_parallel_size=2), plain)
    pipe = {"pipeline_parallel_size": 2}
    cases = [_zero("tiny", _cfg(4)), _zero("tiny", _cfg(4), model_kw=RING),                    # 0, 1
             _zero("odd", _cfg(4), model_kw=ODD),                                              # 2
             _zero("tiny", _cfg(2, 0, data_parallel_size=2)), _zero("tiny", _cfg(2, 2, data_parallel_size=2)),
             _zero("tiny", _cfg(2, 3, data_parallel_size=2)),                                  # 3-5
             _zero("tiny", _cfg(2, tensor_parallel_size=2)),                                   # 6
             _zero("tiny", _cfg(2, tensor_parallel_size=2), model_kw=RING),                    # 7
             _zero("moe", _cfg(2, expert_parallel_size=2), name="tiny-moe"),                   # 8
             ("pipe", {"tree": "tiny", "batch": "plain", "config": _cfg(2, **pipe), "steps": STEPS}),  # 9
             ("refuse", {"tree": "tiny", "batch": "plain",
                         "config": {**_cfg(2, **pipe), "pipeline": {"schedule": "1f1b"}}}),
             _zero("tiny", _cfg(4), model_kw=UNBALANCED)]                                      # 11
    ranks = run_world(workers.seq_train_world, 4, tmp_path, trees, batches, cases, timeout=DEADLINE_S)
    _check(ranks, 0, ref, None, "sp 4 Ulysses")
    _check(ranks, 1, ref, jax_sp4, "sp 4 ring")
    _check(ranks, 2, odd_ref, None, "sp 4, heads it does not divide")
    for i in (3, 4, 5):
        _check(ranks, i, ref, None, f"dp 2 x sp 2 case {i}")
    _check(ranks, 6, ref, jax_tp, "sp 2 x tp 2 Ulysses")
    _check(ranks, 7, ref, jax_tp, "sp 2 x tp 2 ring")
    _check(ranks, 8, moe_ref, None, "tiny-moe expert 2 x seq 2")
    _check(ranks, 9, ref, None, "pipe 2 x sp 2", masters=False)
    _check(ranks, 11, ref, jax_sp4, "sp 4 ring unbalanced")
    for rank, res in enumerate(ranks):
        assert res[3]["rank"] == {"data": rank // 2, "expert": 0, "dp": rank // 2, "seq": rank % 2}
        assert all(p["schedule"] == "fill_drain" for p in res[9]["pipe"])
        assert res[10].startswith("NotImplementedError") and "sequence parallelism" in res[10]


PROMPTS = [[int(t) for t in np.resize(np.arange(3, 40), 100)], [int(t) for t in np.arange(5, 45)]]
SERVE = {"dtype": "float32", "decode_block_kv": 32, "kernel_inject": True,
         "continuous_batching": {"enabled": True, "num_slots": 4, "collect_logits": True}}
SCHED = [{"max_len": 128, "prefill_chunk": 16, "seq_parallel_min_tokens": 32},
         {"max_len": 128, "prefill_chunk": 16, "seq_parallel_min_tokens": 32, "kv_cache_dtype": "int8"},
         {"max_len": 32, "prefill_chunk": 16, "max_extents": 4, "seq_parallel_min_tokens": 32}]


@pytest.mark.parametrize("n", [2, 4])
def test_seq_parallel_prefill_bitwise_one_rank(n, tmp_path):
    """The wide chunk is 16 n columns (the default degree, the seq axis,
    times the 16-column chunk), split over ``seq``; every rank's streams, tokens and logits, equal the
    one-rank scheduler's at the base 16-column chunk, on each pool."""
    tree = _tree("tiny", max_seq_len=128)
    model = get_model("tiny", max_seq_len=128)
    eng = deepspeed_tpu_torch.init_inference(model, config=SERVE, params=params_from_jax(tree, model.cfg),
                                             device="cpu")
    base = [{k: v for k, v in kw.items() if k != "seq_parallel_min_tokens"} for kw in SCHED]
    want = [workers.seq_serve_run(eng, PROMPTS, kw) for kw in base]
    ranks = run_world(workers.seq_serve_world, n, tmp_path, "tiny", tree, SERVE, PROMPTS, SCHED,
                      timeout=DEADLINE_S)
    for rank, res in enumerate(ranks):
        for i, (got, ref) in enumerate(zip(res, want)):
            assert got["shape"] == (n, 16 * n), got["shape"]
            assert got["shape"][1] in got["widths"] and 16 in ref["widths"]
            for j, ((tok, lg), (rtok, rlg)) in enumerate(zip(got["streams"], ref["streams"])):
                assert tok == rtok, f"rank {rank} case {i} stream {j}"
                np.testing.assert_array_equal(lg, rlg, err_msg=f"rank {rank} case {i} stream {j}")


def test_seq_sharded_span_attention_and_seq_operators(tmp_path):
    rng = np.random.default_rng(3)
    f = np.float32
    B, H, nkv, Tq, S, D = 3, 4, 2, 8, 64, 16
    inputs = {"q": rng.standard_normal((B, H, Tq, D)).astype(f),
              "kc": rng.standard_normal((2 * B, nkv, S, D)).astype(f),
              "vc": rng.standard_normal((2 * B, nkv, S, D)).astype(f),
              "start": np.array([0, 3, 10], np.int32), "base": np.array([20, 70, 40], np.int32),
              "ext": np.array([[0, 3], [1, 4], [2, 5]], np.int32),
              "sink": np.array([4, 0, 2], np.int32), "win": np.array([16, 0, 24], np.int32),
              "x": rng.standard_normal((2, 2, 3, 5)).astype(f), "g": rng.standard_normal((2, 6, 5)).astype(f),
              "h": rng.standard_normal((2, 2, 4, 6, 3)).astype(f)}
    ranks = run_world(workers.seq_ops_world, 2, tmp_path, inputs)
    x, g, h = inputs["x"], inputs["g"], inputs["h"]
    for rank, out in enumerate(ranks):
        for name in ("paged", "paged_int8", "extent", "extent_lossy_int8"):
            sharded, whole = out[name]
            np.testing.assert_array_equal(sharded, whole, err_msg=name)
        assert "must divide by the seq axis size 2" in out["odd_width"]
        y, gx = out["gather"]
        np.testing.assert_array_equal(y, np.concatenate([x[0], x[1]], axis=1))
        np.testing.assert_array_equal(gx, 2 * g[:, rank * 3:(rank + 1) * 3])  # both ranks' gradients summed
        t, back, gh = out["a2a"]
        # heads split over seq, chunks concatenated in rank order; and back
        np.testing.assert_array_equal(t, np.concatenate([h[0][:, rank * 2:(rank + 1) * 2],
                                                         h[1][:, rank * 2:(rank + 1) * 2]], axis=2))
        np.testing.assert_array_equal(back, h[rank])
        # the gradient of rank r's output (r + 1) goes back to its sender's heads
        want = np.concatenate([np.full((2, 2, 6, 3), 1.0, f), np.full((2, 2, 6, 3), 2.0, f)], axis=1)
        np.testing.assert_array_equal(gh, want)
        assert out["tiling"] == [((), ("seq", )), ((), ())]


def test_seq_refusals_in_process():
    """The seq-parallel prefill at tp > 1 raises the JAX model's error;
    ring attention needs the flash path (the JAX config check)."""
    from deepspeed_tpu_torch.models.transformer import CausalLMModel, TransformerConfig
    with pytest.raises(ValueError, match="requires attention_impl='flash'"):
        TransformerConfig(sequence_parallel_impl="ring")
    cfg = TransformerConfig(vocab_size=256, hidden_size=64, num_layers=1, num_heads=4, num_kv_heads=2,
                            max_seq_len=128, attention_impl="flash", tp_shard=(0, 2))
    model = CausalLMModel(cfg)
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="tensor parallelism of 1"):
        model.apply_with_cache(model.init_params(0), torch.zeros((1, 2), dtype=torch.long), model.init_cache(1, 64), 0,
                               position_ids=torch.zeros((1, 2), dtype=torch.long), write_index=z, q_spans=z + 2,
                               seq_shard=True)
