"""Process-group query API (counterpart of ``deepspeed_tpu/utils/
groups.py``, the reference ``deepspeed/utils/groups.py``).

Module-level wrappers over the job's :class:`~deepspeed_tpu_torch.
parallel.topology.MeshTopology`. The groups are ``torch.distributed``
process groups, and the ranks are this device's ranks within them.
"""

from deepspeed_tpu_torch.parallel import topology as _topo
from deepspeed_tpu_torch.parallel.topology import (  # noqa: F401
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_PIPE,
    AXIS_SEQ,
)


def _t():
    t = _topo.get_topology(create_if_missing=False)
    if t is None:
        raise RuntimeError(
            "mesh topology not initialized: call deepspeed_tpu_torch."
            "initialize() or deepspeed_tpu_torch.parallel.topology."
            "set_topology() first")
    return t


def initialize(topology=None, axis_sizes=None):
    """Create and register the job's topology (reference
    ``groups.initialize``)."""
    if topology is None:
        topology = _topo.MeshTopology(axis_sizes=axis_sizes)
    _topo.set_topology(topology)
    return topology


def get_data_parallel_group():
    return _t().get_data_parallel_group()


def get_data_parallel_world_size():
    return _t().get_data_parallel_world_size()


def get_data_parallel_rank():
    """This device's rank in its data-parallel group."""
    import torch.distributed as dist

    return dist.get_rank(get_data_parallel_group())


def get_model_parallel_group():
    return _t().get_model_parallel_group()


def get_model_parallel_world_size():
    return _t().get_model_parallel_world_size()


def get_model_parallel_rank():
    """This device's rank along the tp axis."""
    return _t().get_model_parallel_rank()


def get_tensor_parallel_group():
    return _t().get_tensor_parallel_group()


def get_tensor_parallel_world_size():
    return _t().get_tensor_parallel_world_size()


def get_tensor_parallel_rank():
    """This device's rank in its tensor-parallel group."""
    return _t().get_tensor_parallel_rank()


def get_expert_parallel_group(name=None):
    return _t().get_expert_parallel_group()


def get_expert_parallel_world_size(name=None):
    return _t().get_expert_parallel_world_size()


def get_expert_data_parallel_group(name=None):
    return _t().group(AXIS_DATA)


def get_expert_data_parallel_world_size(name=None):
    return _t().axis_size(AXIS_DATA)


def get_pipe_parallel_group():
    return _t().get_pipe_parallel_group()


def get_pipe_parallel_world_size():
    return _t().get_pipe_parallel_world_size()


def get_sequence_parallel_group():
    return _t().get_sequence_parallel_group()


def get_sequence_parallel_world_size():
    return _t().get_sequence_parallel_world_size()


def get_slice_parallel_group():
    return _t().get_model_parallel_group()


def get_max_expert_size():
    return _t().get_expert_parallel_world_size()
