"""Tensor-parallel policies and layers (counterpart of
``deepspeed_tpu/module_inject``)."""

from deepspeed_tpu_torch.module_inject.layers import (  # noqa: F401
    ColumnParallelLinear,
    RowParallelLinear,
    TensorParallel,
    column_parallel_linear,
    copy_to_tp,
    gather_from_tp,
    injected_mlp,
    row_parallel_linear,
    tp_all_reduce,
)
from deepspeed_tpu_torch.module_inject.policies import (  # noqa: F401
    AUTO_POLICY,
    COLUMN,
    REPLICATE,
    ROW,
    VOCAB,
    TPPolicy,
    decode_cache_specs,
    family_for,
    gather_params_with_policy,
    get_tp_policy,
    register_tp_policy,
    shard_params_with_policy,
    specs_from_policy,
)
