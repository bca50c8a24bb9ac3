"""Process topology and the job's mesh (counterpart of
``deepspeed_tpu/parallel``)."""

from deepspeed_tpu_torch.parallel.topology import (  # noqa: F401
    AXIS_ALIASES,
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_PIPE,
    AXIS_SEQ,
    AXIS_TP,
    CANONICAL_AXIS_ORDER,
    MeshTopology,
    PipeDataParallelTopology,
    PipeModelDataParallelTopology,
    ProcessTopology,
    get_topology,
    normalize_axis_dict,
    reset_topology,
    resolve_tp_topology,
    set_topology,
)
