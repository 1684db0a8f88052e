"""``deepspeed_tpu_torch.comm``: collectives over the mesh's process groups.

Usable as ``import deepspeed_tpu_torch.comm as dist`` for reference API
parity (``deepspeed/comm/__init__.py``).
"""
from .comm import (  # noqa: F401
    ReduceOp, Mesh, AllToAll, init_distributed, is_initialized, is_available, get_world_size, get_rank,
    get_local_rank, get_process_count, get_global_rank, barrier, monitored_barrier, destroy_process_group,
    all_reduce, all_reduce_autograd, inference_all_reduce, all_gather, all_gather_into_tensor, reduce_scatter,
    reduce_scatter_tensor, all_to_all, all_to_all_single, broadcast, reduce, initialize_mesh, get_mesh,
    set_mesh, has_mesh, new_group, configure, get_comms_logger, log_summary, host_broadcast, host_allgather,
    copy_to_region, reduce_from_region, gather_from_region, ppermute, ppermute_autograd, send_recv_next,
    send_recv_prev, all_gather_autograd, attention_partition_axes, build_group_scope, group_scope,
    all_gather_object,
    PIPE_AXIS, EXPERT_AXIS, DATA_AXIS, SEQ_AXIS, TENSOR_AXIS, DP_AXES, MESH_AXES, WORLD)
from .overlap import CommOverlapTracker, get_overlap_tracker  # noqa: F401
