"""Tensor-parallel policies (counterpart of ``deepspeed_tpu/
module_inject``). The column- and row-parallel layers (``layers.py``)
come with the multi-GPU slice's tensor-parallel part ([7b])."""

from deepspeed_tpu_torch.module_inject.policies import (  # noqa: F401
    COLUMN,
    REPLICATE,
    ROW,
    VOCAB,
    TPPolicy,
    family_for,
    get_tp_policy,
    register_tp_policy,
)
