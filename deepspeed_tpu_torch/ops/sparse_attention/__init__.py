"""Block-sparse attention (counterpart of
``deepspeed_tpu/ops/sparse_attention/``)."""

from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, DenseSparsityConfig,
    FixedSparsityConfig, LocalSlidingWindowSparsityConfig, SparsityConfig,
    VariableSparsityConfig)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (
    SparseAttentionUtils, SparseSelfAttention)

__all__ = [
    "SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig",
    "VariableSparsityConfig", "BigBirdSparsityConfig",
    "BSLongformerSparsityConfig", "LocalSlidingWindowSparsityConfig",
    "SparseSelfAttention", "SparseAttentionUtils",
]
