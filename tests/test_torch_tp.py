"""Tensor parallelism in one process: what needs no second rank.

- the region operators and the ``sharded_*`` wrappers are the identity
  (their unsharded call) without a process group;
- :func:`tp_shard_params` cuts each rank's shard by ``tp_rules()``: the
  shards fit the rank's module exactly, concatenate back to the whole
  tensor, and an int8 kernel's scale columns travel with its columns (the
  JAX trees of ``tiny``, ``tiny-gpt2`` and ``tiny-moe``, float and int8);
- the vocab-parallel cross entropy at one rank equals the chunked cross
  entropy (loss and both gradients) within fp32 rounding;
- the model config's tensor checks, the training config's tensor axis and
  ``mpu``, and the gateway's refusal above tp 1.
"""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

import deepspeed_tpu.models as jm
import deepspeed_tpu_torch.comm as dist
from deepspeed_tpu_torch.models import get_model
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.transformer import (TransformerConfig, chunked_cross_entropy, embed_lookup,
                                                    tp_dims, tp_shard_params, vocab_parallel_cross_entropy)
from deepspeed_tpu_torch.ops import decode_attention as da
from deepspeed_tpu_torch.ops.flash_attention import flash_attention, sharded_flash_attention
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, DeepSpeedConfigError

from .torch_port_helpers import numpy_params, to_numpy


def test_region_operators_are_the_identity_for_one_rank():
    x = torch.randn(3, 4, requires_grad=True)
    g = torch.randn(3, 4)
    for op in (dist.copy_to_region, dist.reduce_from_region, dist.gather_from_region):
        y = op(x)
        assert y is x  # no operation at all: the tp 1 program is unchanged
        (dx, ) = torch.autograd.grad(y, x, g)
        assert torch.equal(dx, g)


def test_sharded_wrappers_are_the_unsharded_call_for_one_rank():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=gen) for s in ((1, 4, 128, 16), (1, 2, 128, 16), (1, 2, 128, 16)))
    assert torch.equal(sharded_flash_attention(q, k, v), flash_attention(q, k, v))
    qd, kc, vc = torch.randn(2, 4, 16), torch.randn(2, 2, 256, 16), torch.randn(2, 2, 256, 16)
    start, ends = torch.zeros(2, dtype=torch.int32), torch.tensor([7, 200], dtype=torch.int32)
    assert torch.equal(da.sharded_paged_decode_attention(qd, kc, vc, start, ends),
                       da.paged_decode_attention(qd, kc, vc, start, ends))


# int8 weights serve only, always in the bitwise layout
CASES = [(name, "float32", bitwise) for name in ("tiny", "tiny-gpt2", "tiny-moe") for bitwise in (False, True)]
CASES += [("tiny", "int8", True), ("tiny-gpt2", "int8", True)]


@pytest.mark.parametrize("name,dtype,bitwise", CASES)
def test_tp_shard_params_cut_each_rank_by_the_rules(name, dtype, bitwise):
    """Two ranks' shards of the JAX tree: each fits its rank's module, and
    the shards concatenate (along the rule's dim) to the whole tensor."""
    int8 = dtype == "int8"
    whole = get_model(name, dtype=torch.float32, max_seq_len=128)
    params = params_from_jax(to_numpy(numpy_params(jm.get_model(name, dtype=jnp.float32, max_seq_len=128), 3)),
                             whole.cfg)
    if int8:
        whole = type(whole)(dataclasses.replace(whole.cfg, int8_weights=True, dtype=torch.bfloat16))
        params = whole.quantize_params(params)
    shards = []
    for i in range(2):
        local = type(whole)(dataclasses.replace(whole.cfg, tp_shard=(i, 2), bitwise_tp=bitwise))
        part = tp_shard_params(params, local)
        shapes = local.param_shapes()
        assert set(part) == set(shapes)
        for k, v in part.items():
            assert tuple(v.shape) == shapes[k][0], (k, tuple(v.shape), shapes[k][0])
        shards.append(part)
        local.bind(part)  # strict: every key and shape
    dims = tp_dims(type(whole)(dataclasses.replace(whole.cfg, tp_shard=(0, 2), bitwise_tp=bitwise)),
                   {k: tuple(v.shape) for k, v in params.items()})
    split = {k for k, d in dims.items() if d is not None}
    for k, v in params.items():
        d = dims[k]
        joined = v if d is None else torch.cat([shards[0][k], shards[1][k]], dim=d)
        assert torch.equal(joined, torch.as_tensor(v)), k
    # what splits: the column-parallel kernels (and their int8 scales), the
    # vocab; row-parallel kernels only outside the bitwise layout
    for k in split:
        assert any(s in k for s in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "embed", "logits",
                                    "lm_head", "o_proj", "down_proj")), k
    assert any(k.endswith("q_proj.kernel_scale") for k in split) == int8
    assert any("o_proj" in k or "down_proj" in k for k in split) == (not bitwise)


def test_vocab_parallel_ce_at_one_rank_is_the_chunked_ce():
    cfg = TransformerConfig(vocab_size=96, hidden_size=16, num_layers=1, num_heads=2)
    gen = torch.Generator().manual_seed(1)
    h = torch.randn(2, 10, 16, generator=gen, dtype=torch.float64).float().requires_grad_(True)
    w = torch.randn(96, 16, generator=gen).requires_grad_(True)
    labels = torch.randint(0, 96, (2, 10), generator=gen)
    valid = torch.rand(2, 10, generator=gen) > 0.2
    a = chunked_cross_entropy(h, w, labels, valid, chunk=4, transpose=True)
    b = vocab_parallel_cross_entropy(h, w, labels, valid, cfg, chunk=4, transpose=True)
    ga = torch.autograd.grad(a, (h, w))
    gb = torch.autograd.grad(b, (h, w))
    torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-5)
    for x, y in zip(gb, ga):  # exp(l - lse) against softmax: fp32 rounding
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
    ids = torch.randint(0, 96, (2, 5))
    assert torch.equal(embed_lookup(w, ids, cfg), w[ids])


def test_model_config_tensor_checks():
    base = get_model("tiny").cfg  # 4 heads, 2 kv heads, ffn 128
    with pytest.raises(ValueError, match="must divide num_heads=4, kv_heads=2"):
        dataclasses.replace(base, tp_shard=(0, 4))
    with pytest.raises(ValueError, match="int8_fused_qkv"):
        dataclasses.replace(base, tp_shard=(0, 2), int8_weights=True, int8_fused_qkv=True)
    cfg = dataclasses.replace(base, tp_shard=(1, 2))
    assert (cfg.local_heads, cfg.local_kv_heads, cfg.local_ffn, cfg.tp_vocab) == (2, 1, 64, True)
    assert cfg.tp_mode == "reduce" and dataclasses.replace(cfg, bitwise_tp=True).tp_mode == "gather"
    assert base.tp_mode is None
    assert not dataclasses.replace(base, vocab_size=255, tp_shard=(0, 2)).tp_vocab  # stays whole


def test_training_config_tensor_axis_and_mpu():
    # the tensor axis is ported; the data axis is what tensor x expert leave
    cfg = DeepSpeedConfig({"train_batch_size": 16, "mesh": {"tensor_parallel_size": 2}}, world_size=8)
    assert cfg.mesh.data_parallel_size == 4 and cfg.train_micro_batch_size_per_gpu == 4
    with pytest.raises(DeepSpeedConfigError, match="not divisible by tp"):
        DeepSpeedConfig({"train_batch_size": 16, "mesh": {"tensor_parallel_size": 2}}, world_size=1)
    # the pipe and sequence axes build (data = world / (tp x pp x sp))
    cfg = DeepSpeedConfig({"train_batch_size": 16, "mesh": {"pipeline_parallel_size": 2, "tensor_parallel_size": 2}},
                          world_size=8)
    assert cfg.mesh.data_parallel_size == 2 and cfg.train_micro_batch_size_per_gpu == 8
    cfg = DeepSpeedConfig({"train_batch_size": 16, "mesh": {"sequence_parallel_size": 2, "tensor_parallel_size": 2}},
                          world_size=8)
    assert cfg.mesh.data_parallel_size == 2 and cfg.train_micro_batch_size_per_gpu == 8

    class MPU:  # the reference's model-parallel unit: dp from the combined group
        def get_data_parallel_world_size(self):
            return 4

    cfg = DeepSpeedConfig({"train_batch_size": 16, "mesh": {"expert_parallel_size": 2,
                                                            "tensor_parallel_size": 2}}, mpu=MPU(), world_size=8)
    assert cfg.mpu is not None and cfg.mesh.data_parallel_size == 2


def test_gateway_refuses_tensor_parallelism(monkeypatch):
    """The gateway serves tp > 1 from rank 0 (``tests/test_torch_gateway_ranks.py``);
    what it refuses across ranks: serving on another rank (that rank is
    told to follow rank 0), and phase roles (ROADMAP #9.1)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.scheduler import DecodeScheduler
    from deepspeed_tpu_torch.serving import gateway
    from deepspeed_tpu_torch.serving.replica import Replica, ReplicaSet
    monkeypatch.setattr(gateway.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(gateway.dist, "get_rank", lambda group=None: 1)
    with pytest.raises(ValueError, match="rank 1 runs deepspeed_tpu_torch.serving.gateway.follow"):
        gateway.Gateway(object())
    monkeypatch.undo()
    eng = deepspeed_tpu_torch.init_inference(
        "tiny", config={"dtype": "float32", "continuous_batching": {"enabled": True, "num_slots": 2,
                                                                     "hierarchical_kv": {"enabled": True}}},
        device="cpu")
    primary = eng.scheduler()
    fleet = ReplicaSet([Replica(0, primary, scope="replica0"),
                        Replica(1, DecodeScheduler(eng, **primary._init_kwargs), scope="replica1")])
    with pytest.raises(NotImplementedError, match="#9.1, its leftover"):
        fleet.set_role(0, "prefill")
