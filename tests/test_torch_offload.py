"""ZeRO-Offload in the port (``runtime/zero/offload.py``,
``runtime/swap_tensor/``) and its native host code (``ops/adam/cpu_adam.py``,
``ops/aio``) against the JAX package: the C AdamW / Adam / Adagrad steps
bitwise the JAX package's ``DeepSpeedCPUAdam`` on the same arrays and
within 1e-6 of their plain torch versions; the host bf16 cast bitwise
torch's; aio round trips; a failed C build raising; the offloaded engine
against the JAX offload engine and the port's on-device AdamW; the NVMe
tier bitwise the host tier; checkpoints across every pair of tiers; the
fp16 overflow skip; the facade refused."""

import ctypes
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import get_model as jax_get_model
from deepspeed_tpu.ops.adam import cpu_adam as jax_cpu_adam
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops import aio, build
from deepspeed_tpu_torch.ops.adam import cpu_adam as ca

from .torch_port_helpers import numpy_params, port_engine, to_numpy, token_batch

N = 4099  # odd: every vector loop has a tail


def _arrays(seed, bf16_grad, N=N):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(N).astype(np.float32)
    m = (0.1 * rng.standard_normal(N)).astype(np.float32)
    v = np.abs(0.01 * rng.standard_normal(N)).astype(np.float32)
    g = rng.standard_normal(N).astype(np.float32)
    if bf16_grad:  # representable in bf16: both sides read the same values
        g = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
    return p, m, v, g


@pytest.mark.parametrize("adamw_mode", [True, False])
@pytest.mark.parametrize("bf16_grad", [False, True])
@pytest.mark.parametrize("n", [N, 2 * ca.SPLIT + 3])
def test_cpu_adam_bitwise_jax_and_close_to_plain(adamw_mode, bf16_grad, n):
    """One piece, and several stepped on pool threads (the JAX build's
    OpenMP loop against the port's split): the same bits."""
    import ml_dtypes
    kw = dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.05, adamw_mode=adamw_mode)
    jopt, opt = jax_cpu_adam.DeepSpeedCPUAdam(**kw), ca.DeepSpeedCPUAdam(**kw)
    assert jax_cpu_adam.cpu_adam_available()
    p, m, v, g = _arrays(0, bf16_grad, n)
    jp, jm, jv = p.copy(), m.copy(), v.copy()
    tp, tm, tv = (torch.from_numpy(x.copy()) for x in (p, m, v))
    pp, pm, pv = (torch.from_numpy(x.copy()) for x in (p, m, v))
    jg = g.astype(ml_dtypes.bfloat16) if bf16_grad else g
    tg = torch.from_numpy(g).to(torch.bfloat16) if bf16_grad else torch.from_numpy(g)
    for step in (1, 2, 3):
        jopt.step(jp, jm, jv, jg, step, grad_coef=0.75)
        opt.step(tp, tm, tv, tg, step, grad_coef=0.75)
        ca.adamw_step_plain(pp, pm, pv, tg, step, 1e-2, (0.9, 0.95), 1e-8, 0.05, 0.75, adamw_mode)
    for got, ref, plain in ((tp, jp, pp), (tm, jm, pm), (tv, jv, pv)):
        assert np.array_equal(got.numpy(), ref), "C step differs from the JAX package's"
        # within 1e-6 of the tensor's scale (the C loop contracts to FMAs)
        torch.testing.assert_close(got, plain, rtol=0, atol=1e-6 * float(plain.abs().max()))


def test_cpu_adagrad_bitwise_jax_and_close_to_plain():
    lib = jax_cpu_adam._build_lib()
    p, m, _, g = _arrays(1, False)
    acc = np.abs(m)
    jp, jacc = p.copy(), acc.copy()
    tp, tacc = torch.from_numpy(p.copy()), torch.from_numpy(acc.copy())
    pp, pacc = torch.from_numpy(p.copy()), torch.from_numpy(acc.copy())
    fp = ctypes.POINTER(ctypes.c_float)
    opt = ca.DeepSpeedCPUAdagrad(lr=1e-2, eps=1e-10, weight_decay=0.01)
    for _ in range(3):
        lib.ds_adagrad_step(jp.ctypes.data_as(fp), jacc.ctypes.data_as(fp), g.ctypes.data_as(fp), N,
                            1e-2, 1e-10, 0.01, 0.5)
        opt.step(tp, tacc, torch.from_numpy(g), grad_coef=0.5)
        ca.adagrad_step_plain(pp, pacc, torch.from_numpy(g), 1e-2, 1e-10, 0.01, 0.5)
    assert np.array_equal(tp.numpy(), jp) and np.array_equal(tacc.numpy(), jacc)
    torch.testing.assert_close(tp, pp, rtol=0, atol=1e-6 * float(pp.abs().max()))


def test_f32_to_bf16_bitwise_torch():
    rng = np.random.default_rng(2)
    special = np.array([0.0, -0.0, 1.0, 1.00390625, 1.01171875, -1.00390625, 3.4e38, -3.4e38, 1e-40,
                        -1e-40, np.inf, -np.inf, np.nan, -np.nan], np.float32)
    ties = (np.arange(1, 200, dtype=np.uint32) << 16 | 0x8000).view(np.float32)  # exact halfway
    x = torch.from_numpy(np.concatenate([special, ties, rng.standard_normal(5000).astype(np.float32)]))
    x[7] = torch.from_numpy(np.array([0x7FC12345], np.uint32).view(np.float32))[0]  # NaN with a payload
    got = ca.f32_to_bf16(x)
    assert torch.equal(got.view(torch.int16), x.to(torch.bfloat16).view(torch.int16))
    assert torch.equal(got.view(torch.int16), ca.f32_to_bf16_plain(x).view(torch.int16))


@pytest.mark.parametrize("which", ["cpu_adam", "aio"])
def test_failed_build_raises(which, monkeypatch, tmp_path):
    """A bad compiler raises with its output; nothing falls back."""
    mod = ca if which == "cpu_adam" else aio
    monkeypatch.setattr(mod, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    with pytest.raises(RuntimeError, match="C compiler"):
        mod.load_library()
    bad = tmp_path / "cc"
    bad.write_text("#!/bin/sh\necho 'cc: error: planted failure' >&2\nexit 1\n")
    bad.chmod(0o755)
    monkeypatch.setenv("CC", str(bad))
    with pytest.raises(RuntimeError, match="planted failure"):
        mod.load_library()
    assert (ca.cpu_adam_available() if which == "cpu_adam" else aio.aio_available()) is False
    with pytest.raises(RuntimeError):
        ca.DeepSpeedCPUAdam() if which == "cpu_adam" else aio.AsyncIOHandle()


# ---------------------------------------------------------------------------
# aio


def test_aio_roundtrip_offsets_and_blocks(tmp_path):
    h = aio.AsyncIOHandle(block_size=4096, thread_count=3)
    path = str(tmp_path / "f")
    data = torch.arange(10000, dtype=torch.float32)
    h.sync_pwrite(data, path)
    tail = torch.full((77, ), 7.0)
    h.sync_pwrite(tail, path, file_offset=4 * 10000)
    back = torch.empty(10077)
    h.sync_pread(back, path)
    assert torch.equal(back[:10000], data) and torch.equal(back[10000:], tail)
    mid = torch.empty(100)
    h.sync_pread(mid, path, file_offset=4 * 500)
    assert torch.equal(mid, data[500:600])
    assert h.bytes_written == 4 * 10077 and h.bytes_read == 4 * (10077 + 100)
    h.close()


def test_aio_missing_file_raises_and_handle_survives(tmp_path):
    h = aio.AsyncIOHandle()
    with pytest.raises(OSError):
        h.sync_pread(torch.empty(16), str(tmp_path / "missing"))
    h.sync_pwrite(torch.ones(16), str(tmp_path / "ok"))
    out = torch.empty(16)
    h.sync_pread(out, str(tmp_path / "ok"))
    assert torch.equal(out, torch.ones(16))
    with pytest.raises(ValueError, match="contiguous"):
        h.async_pread(torch.empty(4, 4).t(), str(tmp_path / "ok"))


def test_aligned_buffers_take_o_direct(tmp_path):
    buf = aio.aligned_empty(3 * 1024 + 5)
    assert buf.data_ptr() % aio.ALIGN == 0 and buf.numel() == 3 * 1024 + 5
    buf.copy_(torch.arange(buf.numel(), dtype=torch.float32))
    h = aio.AsyncIOHandle(block_size=1 << 20)
    h.sync_pwrite(buf, str(tmp_path / "d"))
    back = aio.aligned_empty(buf.numel())
    h.sync_pread(back, str(tmp_path / "d"))
    assert torch.equal(back, buf)
    st = h.io_stats()
    nbytes = 4 * buf.numel()
    assert st["direct_write"] + st["buffered_write"] == nbytes
    assert st["direct_read"] + st["buffered_read"] == nbytes
    if st["direct_write"]:  # the file system took O_DIRECT: the aligned bulk went through it
        assert st["direct_write"] == nbytes - nbytes % aio.ALIGN


# ---------------------------------------------------------------------------
# the offloaded engine

CONFIG = {
    "train_batch_size": 16,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-2, "weight_decay": 0.01}},
    "gradient_clipping": 1.0,
    "steps_per_print": 10**9,
}


# the master comparisons across implementations: at lr 1e-2 and eps 1e-8
# an element whose gradient is within rounding of zero and of eps (a tied
# embedding row no token of the batch uses) steps by the rounding's sign,
# up to 3e-4 apart after one step; eps 1e-6 keeps Adam conditioned there
MASTER_CONFIG = {**CONFIG, "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01,
                                                                     "eps": 1e-6}}}


def _offload(device="cpu", tmp=None, base=CONFIG, **over):
    off = {"device": device}
    if device == "nvme":
        off["nvme_path"] = str(tmp)
    return {**base, "zero_optimization": {"offload_optimizer": off}, **over}


def _tree(seed=0):
    return numpy_params(jax_get_model("tiny", dtype=jnp.float32), seed)


def _losses(engine, steps=4):
    return [float(engine.train_batch(batch=token_batch(100 + i % 2, n=16, T=32))) for i in range(steps)]


def _master(engine):
    if engine.host_opt is not None:
        return engine.host_opt.state_tensors()[0]
    return {k: v.detach().clone() for k, v in engine.master.items()}


def test_offload_matches_jax_offload_engine():
    """Port ZeRO-Offload against the JAX offload engine on the same weights:
    losses within rtol 1e-4 over 4 steps, masters within 1e-5."""
    tree = _tree()
    jm = jax_get_model("tiny", dtype=jnp.float32, attention_impl="flash")
    import jax
    je, *_ = deepspeed_tpu.initialize(model=jm, model_parameters=jax.tree_util.tree_map(jnp.asarray, tree),
                                      config={**MASTER_CONFIG, "zero_optimization": {
                                          "stage": 2, "offload_optimizer": {"device": "cpu"}}})
    want = _losses(je)
    engine = port_engine("tiny", tree, _offload(base=MASTER_CONFIG))
    got = _losses(engine)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    jmaster = {}
    for path in je.host_opt._leaf_paths:
        node = jmaster
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = je.host_opt.get_full("master", path)
    ref = params_from_jax(jmaster, engine.module.cfg)
    mine = _master(engine)
    for k in ref:
        torch.testing.assert_close(mine[k], ref[k], rtol=0, atol=1e-5)


def test_offload_matches_on_device_adamw():
    tree = _tree(1)
    dev, off = port_engine("tiny", tree, MASTER_CONFIG), port_engine("tiny", tree, _offload(base=MASTER_CONFIG))
    np.testing.assert_allclose(_losses(off), _losses(dev), rtol=1e-5)
    a, b = _master(off), _master(dev)
    for k in b:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=1e-5)
    assert off.optimizer is None and off.host_opt.num_params() == sum(v.numel() for v in b.values())
    assert all(v.dtype == torch.float32 for v in off.params.values())  # the compute dtype here


def test_nvme_tier_bitwise_host_tier(tmp_path):
    """Masters, moments and losses of the NVMe tier are bitwise the host
    tier's, twice over (the order of the threads' work changes no bit)."""
    tree = _tree(2)
    host = port_engine("tiny", tree, _offload())
    ref = _losses(host, 3)
    ref_state = host.host_opt.state_tensors()
    for run in range(2):
        nv = port_engine("tiny", tree, _offload("nvme", tmp_path / f"run{run}"))
        assert _losses(nv, 3) == ref
        got = nv.host_opt.state_tensors()
        for k in ref_state[0]:
            assert torch.equal(got[0][k], ref_state[0][k]), k
        for a, b in zip(got[1] + got[2], ref_state[1] + ref_state[2]):
            assert torch.equal(a, b)
        io = nv.host_opt.io_stats()
        assert io["bytes_read"] > 0 and io["bytes_written"] > 0


def test_nvme_unpipelined_bitwise(tmp_path):
    tree = _tree(2)
    over = {"pipeline_read": True, "pipeline_write": True}
    cfg = _offload("nvme", tmp_path / "a")
    cfg["zero_optimization"]["offload_optimizer"].update(over)
    a = port_engine("tiny", tree, cfg)
    b = port_engine("tiny", tree, _offload("nvme", tmp_path / "b"))
    assert _losses(a, 2) == _losses(b, 2)
    assert all(torch.equal(x, y) for x, y in zip(_master(a).values(), _master(b).values()))


def _tier_config(tier, tmp):
    return CONFIG if tier == "none" else _offload(tier, tmp)


@pytest.mark.parametrize("src", ["none", "cpu", "nvme"])
@pytest.mark.parametrize("dst", ["none", "cpu", "nvme"])
def test_checkpoint_restores_across_tiers(src, dst, tmp_path):
    """A checkpoint saved by any tier restores into any other: the master
    and the moments load, and training continues as it would have (bitwise
    within a tier; across the on-device and the host AdamW within 1e-5)."""
    tree = _tree(3)
    a = port_engine("tiny", tree, _tier_config(src, tmp_path / "a"))
    _losses(a, 2)
    a.save_checkpoint(str(tmp_path / "ckpt"), tag="t")
    want = _losses(a, 2)
    b = port_engine("tiny", _tree(4), _tier_config(dst, tmp_path / "b"))
    load_dir, client = b.load_checkpoint(str(tmp_path / "ckpt"), tag="t")
    assert load_dir is not None and b.global_steps == 2 and b.step_count == 2
    got = _losses(b, 2)
    if (src == "none") == (dst == "none"):
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_load_without_optimizer_states_zeroes_the_moments(tmp_path):
    tree = _tree(3)
    a = port_engine("tiny", tree, _offload())
    _losses(a, 2)
    a.save_checkpoint(str(tmp_path), tag="t")
    b = port_engine("tiny", _tree(4), _offload())
    b.load_checkpoint(str(tmp_path), tag="t", load_optimizer_states=False)
    assert b.host_opt.t == 0 and float(b.host_opt.m.abs().max()) == 0.0
    for k, v in _master(a).items():
        assert torch.equal(_master(b)[k], v)


def test_fp16_overflow_skips_the_host_step():
    tree = _tree(5)
    engine = port_engine("tiny", tree, _offload(fp16={"enabled": True, "initial_scale_power": 120}))
    before = engine.host_opt.master.clone()
    for skipped in (1, 2):  # the scaler's hysteresis (2) halves the scale at the second
        engine.train_batch(batch=token_batch(0, n=16, T=32))
        assert engine.skipped_steps == skipped and engine.step_count == 0 and engine._last_metrics["overflow"]
        assert torch.equal(engine.host_opt.master, before) and engine.host_opt.t == 0
    assert engine.loss_scale() < 2.0**120


def test_facade_and_other_optimizers_refused(tmp_path):
    engine = port_engine("tiny", _tree(), _offload())
    with pytest.raises(RuntimeError, match="facade"):
        engine.forward(token_batch(0, n=8, T=32))
    with pytest.raises(ValueError, match="does not compose with offload_optimizer"):
        port_engine("tiny", _tree(), _offload(optimizer={"type": "Lamb", "params": {"lr": 1e-3}}))
    with pytest.raises(ValueError, match="nvme_path"):
        deepspeed_tpu_torch.initialize(model=deepspeed_tpu_torch.models.get_model("tiny"), device="cpu",
                                       config={**CONFIG, "zero_optimization": {"offload_optimizer":
                                                                               {"device": "nvme"}}})


def test_bf16_grads_ship_at_the_compute_dtype():
    """bf16 compute: the device keeps bf16 weights and gradients, the host
    fp32 master; the loss falls."""
    from deepspeed_tpu_torch.models import get_model
    model = get_model("tiny", dtype=torch.bfloat16, attention_impl="flash")
    engine = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params_from_jax(to_numpy(_tree(6)), model.cfg),
        config=_offload(bf16={"enabled": True}), device="cpu")[0]
    losses = _losses(engine, 3)
    assert losses[-1] < losses[0]
    assert engine.host_opt.dev_grad.dtype == torch.bfloat16 and engine.host_opt.master.dtype == torch.float32
    assert all(v.dtype == torch.bfloat16 for v in engine.params.values())
    assert os.path.exists(build._host_paths(ca.SOURCE, ca.FLAGS)[1])


# ---------------------------------------------------------------------------
# cpu_checkpointing


def test_cpu_checkpointing_keeps_the_flash_residuals_on_the_host(monkeypatch):
    """The functional ``checkpoint`` under ``cpu_checkpointing`` (the JAX
    package's offload policy): the backward recomputes everything but the
    flash forward, whose (out, lse) come back from host memory; gradients
    bitwise those of the plain recompute and of no checkpoint."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ck
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 128, 16, generator=gen).requires_grad_(True) for _ in range(3))
    w = torch.randn(16, 16, generator=gen).requires_grad_(True)

    def fn(q, k, v, w):
        return (fa.flash_attention(torch.tanh(q @ w), k, v) @ w).square().sum()

    want = fn(q, k, v, w)
    g_want = torch.autograd.grad(want, (q, k, v, w))
    calls, real = [], fa.flash_attention_plain
    monkeypatch.setattr(fa, "flash_attention_plain", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    for cpu, runs in ((False, 2), (True, 1)):
        ck.reset()
        ck.configure(deepspeed_config={"activation_checkpointing": {"cpu_checkpointing": cpu}})
        calls.clear()
        got = ck.checkpoint(fn, q, k, v, w)
        grads = torch.autograd.grad(got, (q, k, v, w))
        assert torch.equal(got, want) and all(torch.equal(a, b) for a, b in zip(grads, g_want))
        assert len(calls) == runs, (cpu, calls)
    ck.reset()
    assert getattr(fa.HOST_RESIDUALS, "active", None) is None


def test_offload_first_step_masters_part_by_an_ulp_of_their_own():
    """ZeRO-Offload's first bf16 step against the on-device AdamW (the
    comparison ``chip_smoke.py``'s ``OFFLOAD_MASTER_REL`` gate makes, here at
    tiny-gpt2 on the host, at its lr 3e-4): the gradient the C AdamW reads,
    times its coefficient, is bitwise the device step's (both norm the
    gradient per tensor, then over the tensors, for the clipping
    coefficient); the masters part by a few ulps of the step's operands
    (the master before and after, the move), where the C code's fp32
    rounding order (DeepSpeed's ``cpu_adam``: reciprocal bias corrections,
    FMA contraction) and the ``_foreach`` ops' round apart. The gate reads
    such a part over the update's largest magnitude, so one ulp of a norm
    scale at 1.0 reads ~4e-4, above its 1e-4, whenever a scale parts on a
    run: a difference by design, set by the masters' magnitudes; its worst
    element's gradient is far above eps."""
    from deepspeed_tpu_torch.models import get_model as port_get_model
    config = {"train_micro_batch_size_per_gpu": 2, "bf16": {"enabled": True}, "gradient_clipping": 1.0,
              "optimizer": {"type": "AdamW", "params": {"lr": 3e-4, "weight_decay": 0.01}}}
    host = port_get_model("tiny-gpt2").init_params(0)
    batch = {"input_ids": np.random.default_rng(0).integers(0, 256, (2, 64))}

    def engine(extra):
        model = port_get_model("tiny-gpt2", attention_impl="flash", scan_layers=False)
        eng, *_ = deepspeed_tpu_torch.initialize(model=model, model_parameters={k: v.clone() for k, v in host.items()},
                                                 config={**config, **extra}, device="cpu")
        return eng

    dev = engine({})
    before = {k: v.detach().clone() for k, v in dev.master.items()}
    seen, real = {}, dev.optimizer.step
    dev.optimizer.step = lambda params, grads, lr: seen.update(g=[g.clone() for g in grads]) or real(params, grads, lr)
    loss_dev = float(dev.train_batch(batch=batch))
    after = {k: v.detach().clone() for k, v in dev.master.items()}
    off = engine({"zero_optimization": {"offload_optimizer": {"device": "cpu"}}})
    coef, real_range = [], off.host_opt._step_range
    off.host_opt._step_range = lambda a, b, c, lr: coef.append(c) or real_range(a, b, c, lr)
    assert float(off.train_batch(batch=batch)) == loss_dev
    assert off.host_opt.grad_host.dtype == torch.bfloat16 and len(set(coef)) == 1
    shipped = off.host_opt.views(off.host_opt.grad_host)
    master = off.host_opt.state_tensors()[0]
    upd = max(float((after[k] - before[k]).abs().max()) for k in after)
    worst = (0.0, None)
    for k, g in zip(after, seen["g"]):
        assert torch.equal(shipped[k].float() * torch.tensor(coef[0], dtype=torch.float32), g), k
        # the step's operands: the master before and after, and the move
        mag = torch.maximum(torch.maximum(before[k].abs(), after[k].abs()), (after[k] - before[k]).abs())
        part = (master[k] - after[k]).abs()
        assert bool((part <= 4 * (torch.nextafter(mag, torch.tensor(float("inf"))) - mag)).all()), k
        i = int(part.argmax())
        worst = max(worst, (float(part.reshape(-1)[i]) / upd, float(g.reshape(-1)[i])), key=lambda w: w[0])
    unit = (torch.nextafter(torch.tensor(1.0), torch.tensor(2.0)) - 1.0).item() / upd
    assert any(bool((v == 1.0).any()) for k, v in before.items() if k.endswith("norm.scale"))
    # the gate's reading: a few ulps of a master near 1.0 at most, set by
    # where the masters are, not by gradients near eps
    assert worst[0] <= 4 * unit and unit > 1e-4 and abs(worst[1]) > 100 * 1e-8
