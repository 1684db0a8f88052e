"""Communication layer on ``torch.distributed``.

Port of ``deepspeed_tpu/comm/comm.py`` (reference ``deepspeed/comm/comm.py``:
``init_distributed`` :526, ``all_reduce`` :444, ``all_gather_into_tensor``
:290, ``reduce_scatter_tensor`` :273, ``all_to_all_single`` :324). The JAX
package names its groups by mesh axis and runs its collectives inside
``shard_map``; here every process is one rank and the collectives run
eagerly on its tensors:

- :func:`init_distributed` starts the default process group on the
  accelerator's backend (NCCL on the card; gloo only when the caller asks
  for the CPU), with rank, world size and rendezvous from the arguments or
  the environment;
- :func:`initialize_mesh` lays the ranks out as the JAX package lays out
  its devices, ``(pipe, expert, data, seq, tensor)`` from outer to inner,
  so rank r holds what JAX device r holds; a group is a mesh axis name or
  a tuple of them, and its members are ordered by their index linearized
  over those axes in the order given (JAX's ``axis_index``);
- with no process group, or a group of one, every collective returns its
  input (what the JAX collectives do without a mesh); ``group=None`` is
  every rank (JAX's ``WORLD`` axes, and ``pipe`` where the mesh splits it);
- :func:`ppermute` (and :func:`send_recv_next` / :func:`send_recv_prev`,
  its rings) is the point-to-point exchange the pipeline runs between its
  stages (the JAX ``comm.py:467-488``, ``lax.ppermute``): every send and
  receive of one exchange is posted together and waited on before use;
- :func:`all_reduce_autograd`, :class:`AllToAll` and
  :func:`ppermute_autograd` are the differentiable forms the MoE layer,
  the data-parallel loss and the pipeline use;
  :func:`copy_to_region`, :func:`reduce_from_region` and
  :func:`gather_from_region` are the tensor-parallel ones (Megatron's f
  and g, and the all-gather of a column-parallel output), which GSPMD
  inserts by itself in the JAX package. Each is the identity for a group
  of one, so a tp 1 program runs no extra operation.

Sequence parallelism runs over the ``seq`` axis: ring attention
(``ops/ring_attention.py``) rotates K/V with :func:`ppermute_autograd`, the
Ulysses head scatter is :class:`AllToAll` over ``seq``, a K/V gather that
sums its gradient back is :func:`all_gather_autograd`, and
:func:`attention_partition_axes` gives the JAX package's head tiling
(tensor-major over ``(tensor, seq)``). On a gloo group a CUDA tensor's
all-to-all stages through host memory, as :func:`ppermute` does (logged as
``all_to_all_host_staged``).

While a telemetry sink is live, ``barrier``, ``host_broadcast`` and
``host_allgather`` run inside the overlap tracker's ``track_host``
(``comm/overlap.py``; the JAX ``comm.py:236-244``).

Threads of one process that run collectives at the same time (the serving
fleet's replicas across ranks) each take a group scope: a set of process
groups of their own, made on every rank at set-up
(:func:`build_group_scope`) and entered per thread (:func:`group_scope`),
so their collectives never interleave on one group.
:func:`all_gather_object` exchanges picklable host objects.
"""

import datetime
import math
import os
import threading
from contextlib import contextmanager, nullcontext

import numpy as np
import torch
import torch.distributed as tdist

from ..utils.logging import logger
from .overlap import get_overlap_tracker

# ---------------------------------------------------------------------------
# canonical mesh axis names (process-group equivalents)
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"
DATA_AXIS = "data"
SEQ_AXIS = "seq"
TENSOR_AXIS = "tensor"
MESH_AXES = (PIPE_AXIS, EXPERT_AXIS, DATA_AXIS, SEQ_AXIS, TENSOR_AXIS)

# non-expert parameters are data-parallel over expert x data (reference
# expert-data-parallel group, utils/groups.py:202); expert parameters over
# data only
DP_AXES = (EXPERT_AXIS, DATA_AXIS)

WORLD = DP_AXES + (SEQ_AXIS, TENSOR_AXIS)


class ReduceOp:
    SUM = "sum"
    PRODUCT = "prod"
    MIN = "min"
    MAX = "max"
    AVG = "avg"
    BAND = "band"
    BOR = "bor"
    BXOR = "bxor"
    UNUSED = "unused"


_TORCH_OPS = {
    ReduceOp.SUM: tdist.ReduceOp.SUM,
    ReduceOp.PRODUCT: tdist.ReduceOp.PRODUCT,
    ReduceOp.MIN: tdist.ReduceOp.MIN,
    ReduceOp.MAX: tdist.ReduceOp.MAX,
    ReduceOp.BAND: tdist.ReduceOp.BAND,
    ReduceOp.BOR: tdist.ReduceOp.BOR,
    ReduceOp.BXOR: tdist.ReduceOp.BXOR,
}

_state = {"mesh": None, "comms_logger": None}
_scope = threading.local()  # the group scope of this thread (group_scope)


class Mesh:
    """The rank grid of :func:`initialize_mesh`: ``shape`` maps each axis
    name to its size, ``ranks`` is the (pipe, expert, data, seq, tensor)
    array of global ranks. Process groups are built on first use of a
    group, by every rank (``torch.distributed.new_group`` is collective
    over the default group)."""

    def __init__(self, shape):
        self.shape = dict(zip(MESH_AXES, shape))
        self.ranks = np.arange(math.prod(shape)).reshape(shape)
        self._groups = {}

    @property
    def size(self):
        return int(self.ranks.size)

    def coords(self, rank=None):
        """{axis: index} of ``rank`` (this process by default)."""
        rank = get_rank() if rank is None else rank
        idx = np.unravel_index(rank, self.ranks.shape)
        return {a: int(i) for a, i in zip(MESH_AXES, idx)}

    def group_ranks(self, axes, rank=None):
        """The global ranks of ``rank``'s group over ``axes``, ordered by
        their index linearized over ``axes`` in the given order."""
        axes = _axes(axes)
        coords = self.coords(rank)
        sub = self.ranks[tuple(slice(None) if a in axes else coords[a] for a in MESH_AXES)]
        kept = [a for a in MESH_AXES if a in axes]  # sub's axis order
        sub = np.transpose(sub, [kept.index(a) for a in axes])
        return [int(r) for r in sub.reshape(-1)]

    def group_size(self, axes):
        return math.prod(self.shape[a] for a in _axes(axes))

    def process_group(self, axes):
        """This rank's ``ProcessGroup`` over ``axes`` (None for a group of
        one). The first call for a set of axes builds every group of that
        partition, on every rank, in one fixed order. Inside
        :func:`group_scope` it is the scope's group, which
        :func:`build_group_scope` made."""
        axes = _axes(axes)
        if self.group_size(axes) == 1:
            return None
        scope = getattr(_scope, "name", None)
        if scope is not None:
            pg = self._groups.get((scope, axes))
            if pg is None:
                raise RuntimeError(f"group scope {scope!r} has no process group over {axes}: "
                                   f"build_group_scope must make it on every rank before the scope is used")
            return pg
        if axes not in self._groups:
            if self.group_size(axes) == self.size and list(self.group_ranks(axes)) == list(range(self.size)):
                self._groups[axes] = tdist.group.WORLD
            else:
                self._groups[axes] = self._new_groups(axes)
        return self._groups[axes]

    def _new_groups(self, axes):
        """Every group of the partition over ``axes``, made in one fixed
        order (``new_group`` is collective over the world); returns this
        rank's."""
        seen, mine = set(), None
        for r in range(self.size):
            members = tuple(self.group_ranks(axes, r))
            if members in seen:
                continue
            seen.add(members)
            pg = tdist.new_group(list(members))
            if get_rank() in members:
                mine = pg
        return mine


# ---------------------------------------------------------------------------
# init / world queries


def _env_int(*names):
    for n in names:
        if os.environ.get(n) not in (None, ""):
            return int(os.environ[n])
    return None


def init_distributed(dist_backend=None,
                     auto_mpi_discovery=True,
                     distributed_port=29500,
                     verbose=True,
                     timeout=None,
                     init_method=None,
                     dist_init_required=None,
                     config=None,
                     rank=-1,
                     world_size=-1,
                     device=None):
    """Start the default process group (reference ``comm.py:526``).

    ``device``: None means the card (the NCCL backend; raises without a
    card), ``"cpu"`` the gloo backend; ``dist_backend`` names a backend
    outright. ``rank``/``world_size``: from the arguments, else ``RANK`` /
    ``WORLD_SIZE`` (or the OpenMPI, MPICH and Slurm variables), else a
    world of one. ``init_method``: from the argument, else ``tcp://
    MASTER_ADDR:MASTER_PORT`` when ``MASTER_ADDR`` is set; a world of one
    needs none (an in-process store). A group someone else started is
    taken as it is."""
    if tdist.is_initialized():
        return
    if rank is None or rank < 0:
        rank = _env_int("RANK", *(("OMPI_COMM_WORLD_RANK", "PMI_RANK", "SLURM_PROCID")
                                  if auto_mpi_discovery else ()))
    if world_size is None or world_size < 0:
        world_size = _env_int("WORLD_SIZE", *(("OMPI_COMM_WORLD_SIZE", "PMI_SIZE", "SLURM_NTASKS")
                                              if auto_mpi_discovery else ()))
    if init_method is None and os.environ.get("MASTER_ADDR"):
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', distributed_port)}"
    if (rank is not None or init_method is not None) and world_size is None:
        raise RuntimeError("Partial distributed env: found a rank or a rendezvous address but no world "
                           "size. Set WORLD_SIZE (or pass world_size=) alongside RANK and MASTER_ADDR.")
    world_size = 1 if world_size is None else int(world_size)
    rank = 0 if rank is None else int(rank)
    if dist_backend is None:
        from ..accelerator import resolve_device
        dev = resolve_device(device)
        if dev.type == "cuda":
            from ..accelerator.cuda_accelerator import CUDA_Accelerator
            dist_backend = CUDA_Accelerator().communication_backend_name()
        else:
            from ..accelerator.cpu_accelerator import CPU_Accelerator
            dist_backend = CPU_Accelerator().communication_backend_name()
    if dist_backend == "nccl":
        torch.cuda.set_device(get_local_rank())
    kw = {"backend": dist_backend, "rank": rank, "world_size": world_size}
    if timeout is not None:
        kw["timeout"] = timeout if isinstance(timeout, datetime.timedelta) else \
            datetime.timedelta(seconds=float(timeout))
    if init_method is None:
        if world_size != 1:
            raise RuntimeError(f"a world of {world_size} needs init_method= (or MASTER_ADDR/MASTER_PORT)")
        kw["store"] = tdist.HashStore()
    else:
        kw["init_method"] = init_method
    if verbose:
        logger.info(f"Initializing torch.distributed: backend={dist_backend} rank={rank} "
                    f"world_size={world_size} init_method={init_method or 'in-process store'}")
    tdist.init_process_group(**kw)


def is_initialized():
    return tdist.is_initialized()


def is_available():
    return tdist.is_available()


def _axes(group):
    if group is None:  # every rank: JAX's WORLD axes, and pipe where the mesh splits it
        mesh = _state["mesh"]
        return MESH_AXES if mesh is not None and mesh.shape[PIPE_AXIS] > 1 else WORLD
    if isinstance(group, str):
        return (group, )
    return tuple(group)


def _pg(group):
    """(ProcessGroup or None, size) of ``group``: an axis name or tuple of
    them over the mesh, or a ``ProcessGroup``. None and size 1 without a
    process group."""
    if not tdist.is_initialized():
        return None, 1
    if isinstance(group, tdist.ProcessGroup):
        return group, tdist.get_world_size(group)
    if group is None and _state["mesh"] is None:
        n = tdist.get_world_size()
        return (tdist.group.WORLD if n > 1 else None), n
    mesh = get_mesh()
    axes = _axes(group)
    return mesh.process_group(axes), mesh.group_size(axes)


def get_world_size(group=None):
    """Ranks in the default group, or in ``group`` (axis names)."""
    if group is None:
        return tdist.get_world_size() if tdist.is_initialized() else 1
    return _pg(group)[1]


def get_rank(group=None):
    """This process's rank, or its index in ``group``."""
    if not tdist.is_initialized():
        return 0
    if group is None:
        return tdist.get_rank()
    if isinstance(group, tdist.ProcessGroup):
        return tdist.get_rank(group)
    axes = _axes(group)
    return get_mesh().group_ranks(axes).index(tdist.get_rank())


def get_local_rank():
    return _env_int("LOCAL_RANK") or 0


def get_process_count():
    return get_world_size()


def _tracked_host(op_name):
    """The overlap tracker's realized/exposed bracket of a synchronous
    host-context collective while a telemetry sink is live, else a no-op
    context."""
    from ..telemetry import get_sink
    sink = get_sink()
    if sink is not None and sink.enabled:
        return get_overlap_tracker().track_host(op_name)
    return nullcontext()


def barrier(group=None):
    pg, n = _pg(group)
    if n > 1:
        with _tracked_host("barrier"):
            tdist.barrier(group=pg)


def monitored_barrier(group=None, timeout=None, wait_all_ranks=False):
    barrier(group)


def destroy_process_group(group=None):
    """Tear down the default group (and the mesh's groups with it)."""
    _state["mesh"] = None
    if tdist.is_initialized():
        tdist.destroy_process_group()


def get_global_rank(group=None, group_rank=0):
    pg, _ = _pg(group)
    return get_rank() if pg is None else tdist.get_global_rank(pg, group_rank)


# ---------------------------------------------------------------------------
# mesh management


def initialize_mesh(pipe=1, expert=1, data=None, seq=1, tensor=1, devices=None):
    """Lay the world's ranks out as the mesh (axis order outer -> inner:
    pipe, expert, data, seq, tensor), exactly JAX's device reshape, and
    install it. ``data`` None takes what the other axes leave."""
    if devices is not None:
        raise ValueError("the port's mesh is a grid of ranks (one card each); devices= has no meaning")
    n = get_world_size()
    fixed = pipe * expert * seq * tensor
    if data is None:
        if n % fixed != 0:
            raise ValueError(f"world size {n} not divisible by pipe*expert*seq*tensor={fixed}")
        data = n // fixed
    if pipe * expert * data * seq * tensor != n:
        raise ValueError(f"mesh {pipe}x{expert}x{data}x{seq}x{tensor} != {n} ranks")
    mesh = Mesh((pipe, expert, data, seq, tensor))
    _state["mesh"] = mesh
    return mesh


def set_mesh(mesh):
    _state["mesh"] = mesh


def get_mesh():
    if _state["mesh"] is None:
        initialize_mesh()
    return _state["mesh"]


def has_mesh():
    return _state["mesh"] is not None


def new_group(ranks=None, axis_name=None):
    """A mesh axis (``axis_name``), as in the JAX package, or the
    ``ProcessGroup`` of ``ranks`` (collective: every rank calls it)."""
    if axis_name is not None:
        return axis_name
    if ranks is None:
        raise ValueError("new_group needs ranks= or axis_name=")
    return tdist.new_group(list(ranks))


# ---------------------------------------------------------------------------
# comms logging


def configure(deepspeed_config=None, enabled=None, prof_all=None, prof_ops=None, verbose=None):
    from ..utils.comms_logging import CommsLogger
    cfg = getattr(deepspeed_config, "comms_logger", None) if deepspeed_config is not None else None
    logger_ = CommsLogger(cfg)
    if enabled is not None:
        logger_.enabled = enabled
    if verbose is not None:
        logger_.verbose = verbose
    if prof_all is not None:
        logger_.prof_all = prof_all
    if prof_ops is not None:
        logger_.prof_ops = prof_ops
    _state["comms_logger"] = logger_
    return logger_


def get_comms_logger():
    return _state["comms_logger"]


def log_summary():
    if _state["comms_logger"] is not None:
        return _state["comms_logger"].log_all()
    return None


def _record(op_name, tensor, group):
    """One call of ``op_name`` on ``tensor``: into the comms logger, and
    into the telemetry sink as ``comm/{op}/{group}/bytes``."""
    cl = _state["comms_logger"]
    from ..telemetry import get_sink
    sink = get_sink()
    if not ((cl is not None and cl.enabled) or (sink is not None and sink.enabled)):
        return
    size = tensor.numel() * tensor.element_size() if isinstance(tensor, torch.Tensor) else 0
    if cl is not None and cl.enabled:
        cl.append(op_name, str(group), size)
    if sink is not None and sink.enabled:
        gname = "_".join(group) if isinstance(group, (tuple, list)) else str(group)
        sink.counter(f"comm/{op_name}/{gname}/bytes", size)


def _group_name(group):
    return group if isinstance(group, tdist.ProcessGroup) else _axes(group)


# ---------------------------------------------------------------------------
# collectives (eager; each returns a new tensor)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, async_op=False):
    """Reduce over ``group`` (reference ``comm.py:444``). Every op of
    :class:`ReduceOp` but ``UNUSED``; ``AVG`` is the sum over the group's
    size, as JAX's ``pmean`` (gloo has no average)."""
    _record("all_reduce", tensor, _group_name(group))
    if op not in _TORCH_OPS and op != ReduceOp.AVG:
        raise ValueError(f"Unsupported reduce op {op}")
    pg, n = _pg(group)
    if n == 1:
        return tensor
    out = tensor.clone().contiguous()
    tdist.all_reduce(out, op=_TORCH_OPS[ReduceOp.SUM if op == ReduceOp.AVG else op], group=pg)
    return out / n if op == ReduceOp.AVG else out


def inference_all_reduce(tensor, op=ReduceOp.SUM, group=None):
    return all_reduce(tensor, op=op, group=group)


def _members_sorted(group):
    """(members in member order, the same sorted) of an axis-name group
    whose members are not in increasing global-rank order, else None:
    torch numbers a process group's ranks by global rank, the mesh by the
    group's axes in the order given."""
    if isinstance(group, tdist.ProcessGroup) or not tdist.is_initialized():
        return None
    if group is None and _state["mesh"] is None:
        return None
    members = get_mesh().group_ranks(_axes(group))
    srt = sorted(members)
    return None if srt == members else (members, srt)


def _gather_list(tensor, pg, n, group=None):
    """Every member's ``tensor``, in member order."""
    parts = [torch.empty_like(tensor) for _ in range(n)]
    tdist.all_gather(parts, tensor.contiguous(), group=pg)
    order = _members_sorted(group)
    if order is not None:
        members, srt = order
        parts = [parts[srt.index(m)] for m in members]
    return parts


def _group_shape(group):
    """The sizes of ``group``'s axes, outer first."""
    if isinstance(group, tdist.ProcessGroup):
        return (get_world_size(group), )
    if not tdist.is_initialized():
        return tuple(1 for _ in _axes(group))
    if group is None and _state["mesh"] is None:
        return (get_world_size(), )
    mesh = get_mesh()
    return tuple(mesh.shape[a] for a in _axes(group))


def all_gather(tensor, group=None, axis=0, tiled=True):
    """Gather every member's ``tensor`` along ``axis`` in member order
    (reference ``all_gather_into_tensor``, ``comm.py:290``): concatenated
    when ``tiled``, else stacked in new leading group axes at ``axis``
    (one a mesh axis of the group, outer first, as JAX's nested gathers)."""
    _record("all_gather", tensor, _group_name(group))
    pg, n = _pg(group)
    if n == 1:
        if tiled:
            return tensor
        out = tensor
        for _ in _group_shape(group):
            out = out.unsqueeze(axis)
        return out
    parts = _gather_list(tensor, pg, n, group)
    if tiled:
        return torch.cat(parts, dim=axis)
    out = torch.stack(parts, dim=axis)
    return out.reshape(out.shape[:axis] + _group_shape(group) + out.shape[axis + 1:])


all_gather_into_tensor = all_gather


def reduce_scatter(tensor, op=ReduceOp.SUM, group=None, scatter_dimension=0, tiled=True):
    """Reduce over ``group``, then member i keeps chunk i of
    ``scatter_dimension`` (reference ``comm.py:273``); untiled, that
    dimension's size is the group's and it is dropped."""
    _record("reduce_scatter", tensor, _group_name(group))
    pg, n = _pg(group)
    d = scatter_dimension
    if tensor.shape[d] % n != 0 or (not tiled and tensor.shape[d] != n):
        raise ValueError(f"reduce_scatter: dimension {d} of {tuple(tensor.shape)} does not split "
                         f"over {n} members")
    if n == 1:
        return tensor if tiled else tensor.squeeze(d)
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        full = all_reduce(tensor, op, group)
        out = full.chunk(n, dim=d)[get_rank(group)]
    else:
        moved = tensor.movedim(d, 0).contiguous()
        order = _members_sorted(group)
        if order is not None:  # process-group rank i (global srt[i]) gets its member's chunk
            members, srt = order
            chunks = moved.chunk(n)
            moved = torch.cat([chunks[members.index(g)] for g in srt])
        out = torch.empty((moved.shape[0] // n, ) + moved.shape[1:], dtype=tensor.dtype, device=tensor.device)
        # reduce_scatter_single is reduce_scatter_tensor's newer name
        rs = getattr(tdist, "reduce_scatter_single", None) or tdist.reduce_scatter_tensor
        rs(out, moved, op=tdist.ReduceOp.SUM, group=pg)
        if op == ReduceOp.AVG:
            out = out / n
        out = out.movedim(0, d)
    return out if tiled else out.squeeze(d)


reduce_scatter_tensor = reduce_scatter


def _all_to_all_raw(tensor, pg, n, split_axis, concat_axis, tiled, group=None):
    """The exchange itself. A gloo group runs it as point-to-point sends and
    receives in one ``batch_isend_irecv`` (gloo has no all-to-all on some
    builds), with a CUDA tensor staged through host memory (gloo's
    point-to-point takes host tensors)."""
    gloo = tdist.get_backend(pg) == "gloo"
    staged = gloo and tensor.is_cuda
    if staged:
        _record("all_to_all_host_staged", tensor, _group_name(group))
    wire = tensor.detach().cpu() if staged else tensor
    if tiled:
        chunks = [c.contiguous() for c in wire.chunk(n, dim=split_axis)]
    else:
        chunks = [c.contiguous() for c in wire.unbind(split_axis)]
    recv = [torch.empty_like(c) for c in chunks]
    if gloo:
        who = pg if group is None else group  # member order: the group's (the world's: its ranks)
        me, members = get_rank(who), _members(who)
        recv[me] = chunks[me]
        ops = [tdist.P2POp(tdist.isend, chunks[j], members[j], pg) for j in range(n) if j != me]
        ops += [tdist.P2POp(tdist.irecv, recv[j], members[j], pg) for j in range(n) if j != me]
        for work in tdist.batch_isend_irecv(ops):
            work.wait()
    else:
        tdist.all_to_all(recv, chunks, group=pg)
    out = torch.cat(recv, dim=concat_axis) if tiled else torch.stack(recv, dim=concat_axis)
    return out.to(tensor.device) if staged else out


def all_to_all_single(tensor, group=None, split_axis=0, concat_axis=0, tiled=True):
    """All-to-all over one mesh axis (reference ``comm.py:324``, JAX's
    ``all_to_all``): ``split_axis`` splits into one chunk per member, chunk
    j goes to member j, and the chunks received are concatenated along
    ``concat_axis`` in member order. Untiled, ``split_axis``'s size is the
    group's, it is dropped, and the chunks stack on a new ``concat_axis``."""
    axes = _axes(group) if not isinstance(group, tdist.ProcessGroup) else (group, )
    if len(axes) != 1:
        raise ValueError("all_to_all runs over exactly one axis")
    _record("all_to_all", tensor, _group_name(group))
    pg, n = _pg(group)
    if tensor.shape[split_axis] % n != 0 or (not tiled and tensor.shape[split_axis] != n):
        raise ValueError(f"all_to_all: dimension {split_axis} of {tuple(tensor.shape)} does not "
                         f"split over {n} members")
    if n == 1:
        return tensor if tiled else tensor.squeeze(split_axis).unsqueeze(concat_axis)
    return _all_to_all_raw(tensor, pg, n, split_axis, concat_axis, tiled, group)


all_to_all = all_to_all_single


def broadcast(tensor, src=0, group=None):
    """Member ``src``'s ``tensor`` on every member of ``group``."""
    _record("broadcast", tensor, _group_name(group))
    pg, n = _pg(group)
    if n == 1:
        return tensor
    out = tensor.clone().contiguous()
    order = _members_sorted(group)
    tdist.broadcast(out, src=order[0][src] if order is not None else tdist.get_global_rank(pg, src), group=pg)
    return out


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None):
    """The all-reduce, on every member (the JAX package's form)."""
    return all_reduce(tensor, op=op, group=group)


def _members(group):
    """The global ranks of this rank's ``group``, in member order."""
    if isinstance(group, tdist.ProcessGroup):
        return tdist.get_process_group_ranks(group)
    if group is None and _state["mesh"] is None:
        return list(range(tdist.get_world_size()))
    return get_mesh().group_ranks(_axes(group))


def _check_perm(perm, n):
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or \
            not all(0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute: {perm} is not a partial permutation of {n} members "
                         f"(each source and each destination once, indices below {n})")
    return perm


def ppermute(tensor, perm, group=PIPE_AXIS):
    """Point-to-point exchange over ``group`` (the JAX ``comm.py:467``,
    ``lax.ppermute``; the reference's pipeline p2p, ``runtime/pipe/p2p.py``).
    ``perm``: (source, destination) pairs of member indices in the group's
    member order (``Mesh.group_ranks``, not torch's sorted order): member
    ``s`` sends ``tensor`` to member ``d``, and each member returns what its
    source sent, or zeros when no member sends to it. Every member calls it
    with a tensor of the same shape and dtype.

    Every send and receive of the exchange is posted in one
    ``batch_isend_irecv`` on global ranks and waited on before the result
    is used, so no ring order can deadlock. A gloo group stages a CUDA
    tensor through host memory (its point-to-point ops take host tensors
    only; the staged bytes are logged as ``ppermute_host_staged``); NCCL
    takes the device tensor. A group of one returns its input."""
    _record("ppermute", tensor, _group_name(group))
    pg, n = _pg(group)
    if n == 1:
        return tensor
    perm = _check_perm(perm, n)
    me, members = get_rank(group), _members(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if src and src[0] == me:  # a member that sends to itself
        return tensor.clone()
    staged = tensor.is_cuda and tdist.get_backend(pg) == "gloo"
    if staged:
        _record("ppermute_host_staged", tensor, _group_name(group))
    wire = tensor.detach().contiguous()
    wire = wire.cpu() if staged else wire
    recv = torch.empty_like(wire) if src else None
    ops = [tdist.P2POp(tdist.isend, wire, members[d], pg) for d in dst]
    ops += [tdist.P2POp(tdist.irecv, recv, members[s], pg) for s in src]
    if ops:
        for work in tdist.batch_isend_irecv(ops):
            work.wait()
    if recv is None:
        return torch.zeros_like(tensor)
    return recv.to(tensor.device) if staged else recv


def send_recv_next(tensor, group=PIPE_AXIS):
    """Shift +1 along a ring: member i's ``tensor`` arrives at member i + 1
    (the last member's at member 0)."""
    n = get_world_size(group)
    return ppermute(tensor, [(i, (i + 1) % n) for i in range(n)], group=group)


def send_recv_prev(tensor, group=PIPE_AXIS):
    """Shift -1 along a ring: member i's ``tensor`` arrives at member i - 1."""
    n = get_world_size(group)
    return ppermute(tensor, [(i, (i - 1) % n) for i in range(n)], group=group)


# ---------------------------------------------------------------------------
# host-side exchange (control plane)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def host_broadcast(in_tree, src=0):
    """A picklable tree (numpy leaves) from rank ``src`` to every rank."""
    if get_world_size() == 1:
        return in_tree
    box = [in_tree]
    with _tracked_host("host_broadcast"):
        tdist.broadcast_object_list(box, src=src)
    return box[0]


def build_group_scope(name, groups):
    """Make a scope ``name`` of process groups of its own, one over each
    group of ``groups`` (axis names or tuples of them; None is every rank),
    on the live mesh. Collective: every rank calls it with the same
    arguments in the same order, at set-up. Threads that run collectives
    at the same time each take a scope (:func:`group_scope`), so their
    collectives never interleave on one group."""
    mesh = get_mesh()
    for group in groups:
        axes = _axes(group)
        if mesh.group_size(axes) > 1 and (name, axes) not in mesh._groups:
            mesh._groups[(name, axes)] = mesh._new_groups(axes)


@contextmanager
def group_scope(name):
    """Within the block, this thread's collectives run on the process groups
    of scope ``name`` (:func:`build_group_scope`); None leaves the mesh's
    own groups."""
    prev = getattr(_scope, "name", None)
    _scope.name = name
    try:
        yield
    finally:
        _scope.name = prev


def all_gather_object(obj, group=None):
    """Every member's picklable ``obj``, in member order (torch's
    ``all_gather_object`` on the group; gloo stages it in host memory)."""
    pg, n = _pg(group)
    if n == 1:
        return [obj]
    out = [None] * n
    with _tracked_host("all_gather_object"):
        tdist.all_gather_object(out, obj, group=pg)
    order = _members_sorted(group)
    if order is not None:
        members, srt = order
        out = [out[srt.index(m)] for m in members]
    return out


def host_allgather(in_tree):
    """Every rank's tree, each leaf stacked on a new leading rank axis."""
    if get_world_size() == 1:
        return _tree_map(lambda x: np.asarray(x)[None], in_tree)
    trees = [None] * get_world_size()
    with _tracked_host("host_allgather"):
        tdist.all_gather_object(trees, in_tree)
    return _tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), trees[0], *trees[1:])


# ---------------------------------------------------------------------------
# differentiable forms


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose backward is the sum of the members'
    gradients (every member's output depends on every member's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ReduceOp.SUM, ctx.group), None


def all_reduce_autograd(tensor, group=None):
    """:func:`all_reduce` (sum) that carries a gradient."""
    if _pg(group)[1] == 1:
        return tensor
    return _AllReduceSum.apply(tensor, group)


class AllToAll(torch.autograd.Function):
    """The reference's ``_AllToAll`` (``sharded_moe.py:90``): the forward
    is :func:`all_to_all_single` over one axis, the backward the all-to-all
    with the split and concat axes swapped, so each chunk's gradient goes
    back to the member that sent it."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return all_to_all_single(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return all_to_all_single(g.contiguous(), group, concat_axis, split_axis), None, None, None


class _PPermute(torch.autograd.Function):
    """:func:`ppermute` whose backward is the inverse permutation (JAX's
    ``ppermute`` transpose): each member's gradient goes back to its
    source, and a member no one sent to passes no gradient on."""

    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.args = ([(d, s) for s, d in perm], group)
        return ppermute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        inverse, group = ctx.args
        return ppermute(g.contiguous(), inverse, group), None, None


def ppermute_autograd(tensor, perm, group=PIPE_AXIS):
    """:func:`ppermute` that carries a gradient."""
    if _pg(group)[1] == 1:
        return tensor
    return _PPermute.apply(tensor, _check_perm(perm, _pg(group)[1]), group)


class _AllGatherSum(torch.autograd.Function):
    """All-gather along an axis forward; the backward sums the members'
    gradients and keeps this member's slice (every member's output read
    every member's input)."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.args = (group, axis, x.shape[axis])
        return all_gather(x.contiguous(), group=group, axis=axis)

    @staticmethod
    def backward(ctx, g):
        group, axis, n = ctx.args
        total = all_reduce(g.contiguous(), ReduceOp.SUM, group)
        return total.narrow(axis, get_rank(group) * n, n).contiguous(), None, None


def all_gather_autograd(tensor, group=SEQ_AXIS, axis=0):
    """:func:`all_gather` (tiled along ``axis``, member order) that carries
    a gradient: each member's slice of the summed gradient flows back."""
    if _pg(group)[1] == 1:
        return tensor
    return _AllGatherSum.apply(tensor, group, axis)


def attention_partition_axes(batch_size, num_heads):
    """The JAX package's placement of an attention over (B, H, T, D)
    tensors (``comm.py:120-142``): batch over the data axes, heads over
    ``(tensor, seq)``, tensor-major (a tensor rank's heads split again over
    ``seq``, the only order one all-to-all over ``seq`` reaches from the
    Megatron layout). Returns ``(dp_axes, head_axes)``; an axis group is
    empty when the mesh does not divide its dim."""
    if not has_mesh():
        return (), ()
    shape = get_mesh().shape
    dp = tuple(a for a in DP_AXES if shape[a] > 1)
    if dp and batch_size % math.prod(shape[a] for a in dp):
        dp = ()
    head = tuple(a for a in (TENSOR_AXIS, SEQ_AXIS) if shape[a] > 1)
    if head and num_heads % math.prod(shape[a] for a in head):
        head = ()
    return dp, head


# ---------------------------------------------------------------------------
# tensor-parallel regions (Megatron's f and g)


class _CopyToRegion(torch.autograd.Function):
    """Identity forward; the backward sums the members' gradients (each
    member's column-parallel shard saw the whole input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ReduceOp.SUM, ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    """Sum of the members' partial outputs forward (a row-parallel
    product); the backward hands every member the whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromRegion(torch.autograd.Function):
    """All-gather on the last axis forward (a concatenation, in member
    order); the backward keeps this member's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return all_gather(x.contiguous(), group=group, axis=x.dim() - 1)

    @staticmethod
    def backward(ctx, g):
        i = get_rank(ctx.group)
        return g[..., i * ctx.n:(i + 1) * ctx.n].contiguous(), None


def copy_to_region(x, group=TENSOR_AXIS):
    """Enter a tensor-parallel region: ``x`` as it is, its gradient summed
    over ``group`` (identity for a group of one)."""
    if _pg(group)[1] == 1:
        return x
    return _CopyToRegion.apply(x, group)


def reduce_from_region(x, group=TENSOR_AXIS):
    """Leave a row-parallel region: the sum of the members' ``x``, its
    gradient passed through (identity for a group of one)."""
    if _pg(group)[1] == 1:
        return x
    return _ReduceFromRegion.apply(x, group)


def gather_from_region(x, group=TENSOR_AXIS):
    """Leave a column-parallel region: every member's ``x`` concatenated on
    the last axis in member order, the gradient sliced back (identity for a
    group of one). No arithmetic: the result is bitwise the columns a
    whole product would give."""
    if _pg(group)[1] == 1:
        return x
    return _GatherFromRegion.apply(x, group)
