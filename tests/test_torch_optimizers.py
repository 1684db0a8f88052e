"""The port's optimizers against the JAX package: each optimizer type
against the optax transformation the JAX engine builds for it
(``_configure_optimizer_inner``), over 6 steps at changing learning rates;
LAMB's trust ratio on a scanned tree (one leaf a stacked per-layer weight)
and an unscanned one; each type's ``initialize`` → ``train_batch``
trajectory against the JAX engine; a client ``torch.optim.SGD`` against a
client ``optax.sgd``; ``state_dict`` round trips."""

import copy
import types

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import get_model as jax_get_model
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig
from deepspeed_tpu.runtime.engine import DeepSpeedEngine as JaxEngine
from deepspeed_tpu_torch.models import get_model
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import DynamicLossScaler
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer, norm_groups

from .torch_port_helpers import jax_engine, numpy_params, port_engine, to_numpy, token_batch

OPTIMIZERS = {
    "adam_l2": {"type": "Adam", "params": {"lr": 1e-3, "betas": [0.8, 0.95], "eps": 1e-6,
                                           "weight_decay": 0.1, "adam_w_mode": False}},
    "adagrad": {"type": "Adagrad", "params": {"lr": 1e-2, "eps": 1e-8}},
    "adagrad_init": {"type": "Adagrad", "params": {"lr": 1e-2, "initial_accumulator_value": 0.1}},
    "lamb": {"type": "Lamb", "params": {"lr": 1e-3, "betas": [0.8, 0.95], "weight_decay": 0.01}},
    "lamb_min_coeff": {"type": "Lamb", "params": {"lr": 1e-3, "min_coeff": 5.0}},
    "sgd": {"type": "SGD", "params": {"lr": 1e-2}},
    "sgd_momentum": {"type": "SGD", "params": {"lr": 1e-2, "momentum": 0.9}},
    "sgd_nesterov": {"type": "SGD", "params": {"lr": 1e-2, "momentum": 0.9, "nesterov": True}},
    "lion": {"type": "Lion", "params": {"lr": 1e-4, "betas": [0.9, 0.99], "weight_decay": 0.1}},
}
LRS = [1e-3 * (1 + i) for i in range(6)]


def _jax_tx(section):
    """The optax transformation the JAX engine builds for ``section``, at
    the learning rates ``LRS`` by update count."""
    stub = types.SimpleNamespace(_config=JaxConfig({"train_batch_size": 8, "optimizer": section},
                                                   world_size=1),
                                 lr_schedule_fn=lambda n: jnp.asarray(LRS)[n])
    return JaxEngine._configure_optimizer_inner(stub, None)


def _run_both(section, jax_tree, port_named, scanned=False, steps=6, seed=1):
    """``steps`` updates of the JAX tree through optax and of the port's
    tensors through ``build_optimizer``, on the same gradients (given for
    the port's layout; :func:`_to_jax_layout` maps them onto the JAX tree)."""
    rng = np.random.default_rng(seed)
    tx = _jax_tx(section)
    p_ref = {k: jnp.asarray(v) for k, v in jax_tree.items()}
    state = tx.init(p_ref)
    params = {k: torch.from_numpy(v.copy()) for k, v in port_named.items()}
    cfg = DeepSpeedConfig({"train_batch_size": 8, "optimizer": section})
    opt = build_optimizer(cfg.optimizer, params, scanned=scanned)
    for lr in LRS[:steps]:
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in port_named.items()}
        upd, state = tx.update(_to_jax_layout(grads, jax_tree), state, p_ref)
        p_ref = optax.apply_updates(p_ref, upd)
        opt.step(list(params.values()), [torch.from_numpy(grads[k]) for k in params], lr)
    assert opt.count == steps
    return _from_jax_layout(p_ref, port_named), params


def _to_jax_layout(port, jax_tree):
    """Port-named arrays onto the JAX tree's leaves: ``layers.{i}.name``
    stacks into the leaf ``layers.name`` of a scanned tree."""
    out = {}
    for k in jax_tree:
        if k in port:
            out[k] = jnp.asarray(port[k])
        else:  # a stacked leaf "layers.<rest>"
            rest = k.split(".", 1)[1]
            L = jax_tree[k].shape[0]
            out[k] = jnp.asarray(np.stack([port[f"layers.{i}.{rest}"] for i in range(L)]))
    return out


def _from_jax_layout(tree, port_named):
    out = {}
    for k in port_named:
        if k in tree:
            out[k] = np.asarray(tree[k])
        else:
            _, i, rest = k.split(".", 2)
            out[k] = np.asarray(tree[f"layers.{rest}"])[int(i)]
    return out


def _unscanned(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


SHAPES = {"embed.embedding": (11, 6), "layers.0.attn.q.kernel": (6, 6), "layers.0.norm.scale": (6, ),
          "layers.1.attn.q.kernel": (6, 6), "layers.1.norm.scale": (6, ), "layers.2.attn.q.kernel": (6, 6),
          "layers.2.norm.scale": (6, ), "final_norm.scale": (6, )}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    named = _unscanned(SHAPES)
    want, got = _run_both(OPTIMIZERS[name], named, named)
    for k in named:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("section", ["lamb", "lamb_min_coeff"])
def test_lamb_on_a_scanned_tree(section):
    """optax takes the trust ratio per leaf: on a scanned tree a leaf stacks
    every layer's weight, so the port's per-layer tensors of one name share
    one norm (``norm_groups``). Without the grouping they would not match."""
    named = _unscanned(SHAPES)
    jax_tree = {"embed.embedding": named["embed.embedding"], "final_norm.scale": named["final_norm.scale"],
                "layers.attn.q.kernel": np.stack([named[f"layers.{i}.attn.q.kernel"] for i in range(3)]),
                "layers.norm.scale": np.stack([named[f"layers.{i}.norm.scale"] for i in range(3)])}
    assert norm_groups(list(named)) == [[0], [1, 3, 5], [2, 4, 6], [7]]
    want, got = _run_both(OPTIMIZERS[section], jax_tree, named, scanned=True)
    # XLA rounds the stacked leaves' updates in other places than on the
    # unstacked ones (1-3 fp32 ulps at |p| ~ 1-2 after 6 steps, whichever
    # way the port sums the group's norm): atol 4e-7, rtol as above
    for k in named:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-6, atol=4e-7, err_msg=k)
    _, per_tensor = _run_both(OPTIMIZERS[section], jax_tree, named, scanned=False)
    assert any(not np.allclose(per_tensor[k].numpy(), want[k], rtol=1e-6, atol=4e-7)
               for k in named if k.startswith("layers."))


CONFIG = {
    "train_batch_size": 16,
    "gradient_accumulation_steps": 2,
    "gradient_clipping": 1.0,
    "scheduler": {"type": "WarmupLR", "params": {"warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3,
                                                 "warmup_num_steps": 3}},
    "steps_per_print": 10**9,
}


@pytest.mark.parametrize("name,scan", [("adam_l2", True), ("adagrad", True), ("lamb", True),
                                       ("lamb", False), ("sgd_momentum", True), ("lion", True)])
def test_engine_trajectory_matches_jax(name, scan):
    jm = jax_get_model("tiny", dtype=jnp.float32, attention_impl="flash", scan_layers=scan)
    tree = numpy_params(jm, 0)
    cfg = {**CONFIG, "optimizer": OPTIMIZERS[name]}
    batch = token_batch(1)
    je = jax_engine("tiny", tree, cfg, scan_layers=scan)
    want = [float(je.train_batch(batch=batch)) for _ in range(4)]
    engine = port_engine("tiny", tree, cfg, scan_layers=scan)
    got = [float(engine.train_batch(batch=batch)) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert engine.step_count == 4 and engine.optimizer.count == 4


@pytest.mark.parametrize("form", ["callable", "instance"])
def test_client_sgd_matches_jax_client_optax_sgd(form):
    tree = numpy_params(jax_get_model("tiny", dtype=jnp.float32), 3)
    cfg = {k: v for k, v in CONFIG.items() if k != "scheduler"}
    batch = token_batch(2)
    je = jax_engine("tiny", tree, cfg, optimizer=optax.sgd(0.05, momentum=0.9))
    want = [float(je.train_batch(batch=batch)) for _ in range(4)]
    model = get_model("tiny", dtype=torch.float32, attention_impl="flash")
    params = {k: v.requires_grad_(True) for k, v in params_from_jax(to_numpy(tree), model.cfg).items()}
    if form == "callable":
        client = lambda ps: torch.optim.SGD(ps, lr=0.05, momentum=0.9)  # noqa: E731
    else:
        client = torch.optim.SGD(list(params.values()), lr=0.05, momentum=0.9)
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, model_parameters=params, optimizer=client,
                                                config=dict(cfg), device="cpu")
    got = [float(engine.train_batch(batch=batch)) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert engine.get_lr() == [0.05]


def test_client_optimizer_over_other_tensors_raises():
    model = get_model("tiny", dtype=torch.float32)
    other = torch.optim.SGD([torch.zeros(3, requires_grad=True)], lr=0.1)
    with pytest.raises(ValueError, match="master tensors"):
        deepspeed_tpu_torch.initialize(model=model, optimizer=other, config={"train_batch_size": 4},
                                       device="cpu")


@pytest.mark.parametrize("name", ["adamw", "adagrad", "lamb", "sgd_momentum", "lion", "client"])
def test_state_dict_round_trip(name):
    """Two steps, the state through ``state_dict`` / ``load_state_dict``
    into a fresh optimizer over copies of the tensors, then a third step on
    both: bitwise equal tensors."""
    named = _unscanned(SHAPES, seed=4)
    rng = np.random.default_rng(5)
    grads = [[torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in SHAPES.values()]
             for _ in range(3)]

    def build(params):
        if name == "client":
            return build_optimizer(None, params, client=lambda ps: torch.optim.Adam(ps, lr=1e-3))
        section = {"type": "AdamW", "params": {"lr": 1e-3}} if name == "adamw" else OPTIMIZERS[name]
        return build_optimizer(DeepSpeedConfig({"train_batch_size": 8, "optimizer": section}).optimizer,
                               params)

    a = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in named.items()}
    opt_a = build(a)
    for g in grads[:2]:
        opt_a.step(list(a.values()), g, 1e-2)
    sd = copy.deepcopy(opt_a.state_dict())  # a snapshot, as a checkpoint holds
    b = {k: v.detach().clone().requires_grad_(True) for k, v in a.items()}
    opt_b = build(b)
    opt_b.load_state_dict(sd)
    assert opt_b.count == 2
    opt_a.step(list(a.values()), grads[2], 1e-2)
    opt_b.step(list(b.values()), grads[2], 1e-2)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("name", ["adam_l2", "lamb", "sgd_nesterov", "lion"])
def test_chunked_update_is_bitwise(name, monkeypatch):
    """An update a chunk of tensors at a time (``CHUNK_ELEMS``) gives the
    bits of one over the whole list."""
    from deepspeed_tpu_torch.runtime import optimizers
    named = _unscanned(SHAPES, seed=6)
    out = []
    for chunk in (optimizers.CHUNK_ELEMS, 40):
        monkeypatch.setattr(optimizers, "CHUNK_ELEMS", chunk)
        tensors = [torch.from_numpy(v) for v in named.values()]
        assert len(list(optimizers._Optimizer._chunks(tensors))) == (1 if chunk > 40 else 7)
        out.append(_run_both(OPTIMIZERS[name], named, named)[1])
    for k in named:
        assert torch.equal(out[0][k], out[1][k]), k


def test_tensor_norms_accumulate_in_fp64_on_the_host():
    """PyTorch's fp32 norm on the CPU sums in one pass; the engine's clip
    norm and LAMB's trust ratio go through ``tensor_norms`` instead."""
    from deepspeed_tpu_torch.runtime.optimizers import tensor_norms
    x = torch.from_numpy((np.random.default_rng(0).standard_normal(1 << 24) * 0.02 + 0.01).astype(np.float32))
    exact = float(torch.linalg.vector_norm(x.double()))
    assert abs(float(torch._foreach_norm([x])[0]) - exact) > 1e-4 * exact
    got = tensor_norms([x, x[:5]])
    assert got[0].dtype == torch.float32 and abs(float(got[0]) - exact) <= 1e-7 * exact
    assert float(got[1]) == pytest.approx(float(torch.linalg.vector_norm(x[:5].double())), rel=1e-7)


def test_loss_scale_state_round_trip():
    scaler = DynamicLossScaler(init_scale=2**8, scale_window=3, delayed_shift=2)
    s = scaler.init_state()
    for overflow in (False, True, True, False):
        s = scaler.update(s, overflow)
    d = s.to_dict()
    assert all(isinstance(v, (int, float)) for v in d.values())
    assert type(s).from_dict(d) == s
