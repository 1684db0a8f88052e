"""The port's ``comm`` (``torch.distributed``, gloo on the CPU) against the
JAX package's ``comm`` under ``shard_map`` on the conftest's CPU devices,
on the same numpy inputs (``tests/torch_dist_workers.py``; each world under
its own deadline):

- in a world of 4 with the mesh (expert 2, data 2): all_reduce (sum, max,
  min, avg, product), all_gather (tiled on two axes, untiled), reduce_scatter,
  all_to_all_single (its split- and concat-axis semantics), broadcast,
  reduce, ppermute (a swap, a partial permutation) and the rings
  send_recv_next / send_recv_prev on every rank against the JAX device of
  the same index, within
  1e-6 (the JAX product is exp(sum(log|x|)): 1e-5); the bitwise reductions,
  which JAX refuses, against numpy; host_broadcast and host_allgather; the
  ``AllToAll`` function's gradient; ppermute and the rings over a group
  whose member order is not the global ranks' (("data", "expert")), and
  ``ppermute_autograd``'s gradient there (the inverse permutation), against
  numpy;
- the mesh's rank grid and each rank's groups equal JAX's device grid for
  (expert 2, data 2) and (data 4);
- a world of one: no group, every collective returns its input;
- tiny dense training at data 2: every rank's losses within rtol 1e-5 of the
  one-rank engine's and of the JAX engine's, parameters bitwise equal on
  both ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
import deepspeed_tpu.comm as jdist
import deepspeed_tpu.models as jm
import deepspeed_tpu_torch.comm as tdist
from deepspeed_tpu.comm import comm as jcomm

from . import torch_dist_workers as workers
from .torch_dist_workers import run_world, train_run
from .torch_port_helpers import numpy_params, to_numpy

CASES = [
    ("all_reduce", {}),
    ("all_reduce", {"group": "data", "op": "max"}),
    ("all_reduce", {"group": "expert", "op": "min"}),
    ("all_reduce", {"group": ("expert", "data"), "op": "avg"}),
    ("all_reduce", {"group": "data", "op": "prod"}),
    ("all_gather", {"group": "data"}),
    ("all_gather", {"group": ("expert", "data"), "axis": 1}),
    ("all_gather", {"group": ("expert", "data"), "tiled": False}),
    ("reduce_scatter", {"group": "expert"}),
    ("reduce_scatter", {"group": ("expert", "data"), "scatter_dimension": 1}),
    ("all_to_all_single", {"group": "data", "split_axis": 0, "concat_axis": 1}),
    ("all_to_all_single", {"group": "expert", "split_axis": 1, "concat_axis": 0}),
    ("broadcast", {"src": 1, "group": "data"}),
    ("reduce", {"group": "expert"}),
    ("ppermute", {"perm": [(0, 1), (1, 0)], "group": "data"}),
    ("ppermute", {"perm": [(1, 0)], "group": "expert"}),
    ("send_recv_next", {"group": "data"}),
    ("send_recv_prev", {"group": "expert"}),
]
# point-to-point over a group whose member order is not the global ranks'
# order: ("data", "expert") under (expert 2, data 2) orders ranks 0, 2, 1, 3
# (JAX's ppermute takes one axis: held against numpy)
P2P_ORDER = [0, 2, 1, 3]
P2P_CASES = [
    ("send_recv_next", {"group": ("data", "expert")}, [(i, (i + 1) % 4) for i in range(4)]),
    ("send_recv_prev", {"group": ("data", "expert")}, [(i, (i - 1) % 4) for i in range(4)]),
    ("ppermute", {"perm": [(0, 3), (3, 1), (1, 0)], "group": ("data", "expert")}, [(0, 3), (3, 1), (1, 0)]),
]
MESHES = [{"expert": 2, "data": 2}, {"data": 4}]


def _inputs():
    rng = np.random.default_rng(0)
    out = {r: (0.5 + rng.random((4, 8))).astype(np.float32) for r in range(4)}
    out["ints"] = {r: rng.integers(0, 256, (5, )).astype(np.int64) for r in range(4)}
    return out


def _jax_case(name, kw, xs):
    """Each of 4 devices' output of ``jdist.<name>(x, **kw)`` under the
    mesh (expert 2, data 2)."""
    mesh = jcomm.initialize_mesh(expert=2, data=2, devices=jax.devices()[:4])
    spec = P(("expert", "data"))
    fn = jax.shard_map(lambda v: getattr(jdist, name)(v[0], **kw)[None], mesh=mesh, in_specs=spec,
                       out_specs=spec, check_vma=False)
    out = np.asarray(fn(jnp.asarray(np.stack([xs[r] for r in range(4)]))))
    jcomm._state["mesh"] = None
    return out


def _jax_groups(shape, axes):
    """{rank: its group's ranks over ``axes``} of JAX's mesh ``shape`` on 4
    CPU devices, in the order of the index linearized over ``axes``."""
    mesh = jcomm.initialize_mesh(**shape, devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    names = list(mesh.axis_names)
    jcomm._state["mesh"] = None
    out = {}
    for r in range(4):
        at = dict(zip(names, (int(i[0]) for i in np.nonzero(ids == r))))
        sub = ids[tuple(slice(None) if a in axes else at[a] for a in names)]
        kept = [a for a in names if a in axes]
        out[r] = [int(d) for d in np.transpose(sub, [kept.index(a) for a in axes]).reshape(-1)]
    return ids, out


def test_collectives_and_mesh_match_jax(tmp_path):
    xs = _inputs()
    ranks = run_world(workers.comm_world, 4, tmp_path, xs, CASES + [c[:2] for c in P2P_CASES], MESHES)
    for j, (name, kw, perm) in enumerate(P2P_CASES):
        for i, r in enumerate(P2P_ORDER):  # member i is rank r
            src = [a for a, b in perm if b == i]
            want = xs[P2P_ORDER[src[0]]] if src else np.zeros_like(xs[r])
            np.testing.assert_array_equal(ranks[r][len(CASES) + j], want, err_msg=f"{name} {kw} rank {r}")
    for r, got in enumerate(ranks):
        # ppermute_autograd's backward is the inverse permutation: each
        # member's gradient goes back to its source (member 2 sent nothing)
        i = P2P_ORDER.index(r)
        dst = {0: 3, 3: 1, 1: 0}.get(i)
        want = np.zeros((4, 8), np.float32) if dst is None else np.full((4, 8), P2P_ORDER[dst] + 1, np.float32)
        np.testing.assert_array_equal(got["ppermute_grad"], want)
        assert got["ppermute_one"] is True
    for i, (name, kw) in enumerate(CASES):
        want = _jax_case(name, kw, xs)
        tol = 1e-5 if kw.get("op") == "prod" else 1e-6
        for r in range(4):
            np.testing.assert_allclose(ranks[r][i], want[r], rtol=tol, atol=0, err_msg=f"{name} {kw} rank {r}")
    ints = np.stack([xs["ints"][r] for r in range(4)])
    for r, got in enumerate(ranks):
        assert got["world_size"] == 4 and got["rank"] == r
        np.testing.assert_array_equal(got["band"], np.bitwise_and.reduce(ints))
        np.testing.assert_array_equal(got["bor"], np.bitwise_or.reduce(ints))
        np.testing.assert_array_equal(got["bxor"], np.bitwise_xor.reduce(ints))
        np.testing.assert_array_equal(got["host_broadcast"]["r"], [1, 10])
        np.testing.assert_array_equal(got["host_allgather"]["r"], [[q, 10 * q] for q in range(4)])
        np.testing.assert_array_equal(got["host_allgather"]["s"][0], np.arange(4, dtype=np.float32))
        # d(sum(y * w))/dx with y = all_to_all(x) over data (split 0,
        # concat 1): chunk j of x went to member j, and comes back as
        # that member's column block of w for this rank's index
        w = np.arange(32, dtype=np.float32).reshape(2, 16)
        j = r % 2
        np.testing.assert_array_equal(got["a2a_grad"], np.concatenate([w[:, 8 * j:8 * j + 8]] * 2))
    for shape in MESHES:
        key = tuple(sorted(shape.items()))
        for axes in ("expert", "data", ("expert", "data")):
            ax = (axes, ) if isinstance(axes, str) else axes
            ids, want = _jax_groups(shape, ax)
            for r in range(4):
                np.testing.assert_array_equal(ranks[r]["groups"][key]["ranks"], ids)
                assert ranks[r]["groups"][key]["groups"][axes] == want[r], (shape, axes, r)


def test_world_of_one_returns_inputs():
    x = torch.arange(6.0).reshape(2, 3)
    assert not tdist.is_initialized() and tdist.get_world_size() == 1 and tdist.get_rank() == 0
    assert tdist.all_reduce(x) is x and tdist.all_gather(x, group="data") is x
    assert tdist.all_gather(x, tiled=False).shape == (1, 1, 1, 1, 2, 3)
    assert tdist.reduce_scatter(x) is x and tdist.all_to_all_single(x, group="expert") is x
    assert tdist.broadcast(x) is x and tdist.all_reduce_autograd(x) is x
    tree = {"a": np.ones(2)}
    assert tdist.host_broadcast(tree) is tree
    np.testing.assert_array_equal(tdist.host_allgather(tree)["a"], np.ones((1, 2)))
    cl = tdist.configure(enabled=True)
    tdist.all_reduce(x, group="data")
    assert "all_reduce" in tdist.log_summary() and cl.comms_dict["all_reduce"]
    tdist.configure(enabled=False)


TRAIN = {"train_batch_size": 16, "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
         "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}}, "steps_per_print": 10**9}


def test_data_parallel_training_matches_one_rank_and_jax(tmp_path):
    jmod = jm.get_model("tiny", dtype=jnp.float32, attention_impl="flash")
    tree = numpy_params(jmod, 0)
    batch = {"input_ids": np.random.default_rng(1).integers(0, 256, (16, 64)).astype(np.int32)}
    jcomm._state["mesh"] = None
    je, *_ = deepspeed_tpu.initialize(model=jmod, config=dict(TRAIN),
                                      model_parameters=jax.tree_util.tree_map(jnp.asarray, tree))
    jax_losses = [float(je.train_batch(batch=batch)) for _ in range(3)]
    one = train_run("tiny", to_numpy(tree), TRAIN, batch, 3, {})
    ranks = run_world(workers.train_world, 2, tmp_path, "tiny", to_numpy(tree), batch, 3, [(TRAIN, {})])
    for got in (r[0] for r in ranks):
        assert got["dp"] == 2
        np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
        np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-5)
        for k, v in got["master"].items():
            np.testing.assert_array_equal(v, ranks[0][0]["master"][k])
