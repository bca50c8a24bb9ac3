"""Activation checkpointing of the transformer blocks (counterpart of the
policy in ``deepspeed_tpu/models/gpt2.py:_remat_block`` and of
``deepspeed_tpu/models/remat_utils.py``).

Two policies, as in the JAX model:

- ``"full"``: ``torch.utils.checkpoint`` (non-reentrant) around each
  block; backward re-runs the whole block, flash forward included;
- ``"dots"``: selective checkpointing. The JAX GPT-2 saves the matmul
  outputs (``checkpoint_dots``) and the flash residuals named
  ``flash_*`` and recomputes the elementwise chains (LayerNorm, GELU,
  residual adds, casts). Here :func:`dots_policy` saves the outputs of the
  aten matrix products and of the attention kernels' forward ops,
  ``deepspeed_tpu_torch::flash_fwd`` and ``::block_sparse_fwd`` (O and
  lse), so backward launches no second attention forward. The JAX BERT's
  "dots" is ``checkpoint_dots`` alone and runs its sparse forward kernel
  again in backward; saving O and lse (a ``[B, S, C]`` tensor and ``[B, H,
  S]`` fp32 a layer) is the port's choice, since that forward is a
  kernel's whole run.

The host-offload (``cpu_checkpointing``) and ``partition_activations``
knobs of the JAX helpers come with the offload and multi-GPU slices.
"""

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

# register the deepspeed_tpu_torch::flash_fwd and ::block_sparse_fwd ops
import deepspeed_tpu_torch.ops.flash_attention  # noqa: F401
import deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel  # noqa

REMAT_POLICIES = ("full", "dots")

_aten = torch.ops.aten
SAVED_OPS = frozenset({
    _aten.mm.default, _aten.addmm.default, _aten.bmm.default,
    _aten.baddbmm.default, torch.ops.deepspeed_tpu_torch.flash_fwd.default,
    torch.ops.deepspeed_tpu_torch.block_sparse_fwd.default,
})


def dots_policy(ctx, op, *args, **kwargs):
    """Save matmul and attention-forward outputs; recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def checkpointed(fn, *args, policy="full"):
    """``fn(*args)`` under activation checkpointing with ``policy``."""
    if policy == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              dots_policy))
    raise ValueError(f"remat_policy {policy!r} not in {REMAT_POLICIES}")
