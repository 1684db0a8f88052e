"""Parallel group registry.

Port of ``deepspeed_tpu/utils/groups.py`` (reference ``deepspeed/utils/
groups.py``: expert, data and model groups, :46, :59, :108, :202). A
group is a mesh axis name or a tuple of them (``comm``): this module keeps
the reference's names and answers "which group do I reduce over" for the
engine and the MoE layers. World sizes come from
``comm.get_world_size(axes)``, ranks from ``comm.get_rank(axes)``; without
a process group every size is 1 and every rank 0.
"""

from ..comm import comm as dist
from .logging import log_dist

# expert-group name -> the axis it names (the reference keys its dict of
# groups by "ep_size_{N}")
_EXPERT_PARALLEL_GROUP = {}
_mpu = None


def initialize(ep_size=1, mpu=None):
    """Reference ``groups.initialize``: expert parallelism is the
    ``expert`` mesh axis, whose size the mesh fixes."""
    global _mpu
    _mpu = mpu
    _create_expert_and_data_parallel(ep_size)


def _create_expert_and_data_parallel(expert_parallel_size_):
    name = f"ep_size_{expert_parallel_size_}"
    if name not in _EXPERT_PARALLEL_GROUP:
        mesh_ep = dist.get_mesh().shape[dist.EXPERT_AXIS] if dist.has_mesh() else 1
        if expert_parallel_size_ not in (1, mesh_ep):
            log_dist(f"Requested ep_size={expert_parallel_size_} but mesh expert axis is {mesh_ep}; "
                     f"collectives run over the mesh axis", [0])
        _EXPERT_PARALLEL_GROUP[name] = dist.EXPERT_AXIS
    return _EXPERT_PARALLEL_GROUP[name]


def _get_max_expert_size():
    return max([int(name.split("_")[-1]) for name in _EXPERT_PARALLEL_GROUP] or [1])


def get_expert_parallel_group(group_name=None):
    return dist.EXPERT_AXIS


def get_expert_data_parallel_group(group_name=None):
    return dist.DATA_AXIS


def get_data_parallel_group():
    """The data-parallel group of the non-expert parameters: expert x data."""
    return dist.DP_AXES


def get_model_parallel_group():
    return dist.TENSOR_AXIS


get_tensor_model_parallel_group = get_model_parallel_group


def get_sequence_parallel_group():
    return dist.SEQ_AXIS


def get_pipeline_parallel_group():
    return dist.PIPE_AXIS


def get_expert_parallel_world_size(group_name=None):
    return dist.get_world_size(dist.EXPERT_AXIS)


def get_expert_data_parallel_world_size(group_name=None):
    return dist.get_world_size(dist.DATA_AXIS)


def get_data_parallel_world_size():
    return dist.get_world_size(dist.DP_AXES)


def get_model_parallel_world_size():
    return dist.get_world_size(dist.TENSOR_AXIS)


get_tensor_model_parallel_world_size = get_model_parallel_world_size


def get_model_parallel_rank():
    """This rank's index over ``tensor`` (the shard of the column- and
    row-parallel tensors it holds)."""
    return dist.get_rank(dist.TENSOR_AXIS)


get_tensor_model_parallel_rank = get_model_parallel_rank


def get_sequence_parallel_world_size():
    return dist.get_world_size(dist.SEQ_AXIS)


def get_pipeline_parallel_world_size():
    return dist.get_world_size(dist.PIPE_AXIS)


def get_data_parallel_rank():
    """This rank's index in the expert x data group (shards a dataset per
    data-parallel rank). ``tensor`` is not in it: the ranks of a tensor
    group see the same rows."""
    return dist.get_rank(dist.DP_AXES)


def get_expert_parallel_rank(group_name=None):
    return dist.get_rank(dist.EXPERT_AXIS)


def get_expert_data_parallel_rank(group_name=None):
    return dist.get_rank(dist.DATA_AXIS)


def get_world_size():
    return dist.get_world_size()
