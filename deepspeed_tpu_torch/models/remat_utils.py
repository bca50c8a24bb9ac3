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

Under tensor parallelism the row-parallel sums (and BERT's gather of
split heads before a whole projection) run inside each block: ``"dots"``
saves their outputs too (the custom ops ``deepspeed_tpu_torch::
tp_all_reduce`` and ``::tp_all_gather``), so a block's recompute issues
no collective; a plain ``torch.distributed`` collective would run again
at every recompute under that policy. ``"full"`` re-runs the block, its sums
included: 2 all-reduces a block more a step.

``partition_activations`` (``checkpointed(..., partition=tp)``, JAX
``saved_block_input``'s ``P(data, model, None)``): the block input that
the checkpoint keeps for its recompute is held as this tp rank's ``T /
tp`` rows, a copy, and the rows are all-gathered (one tiled all-gather
over the tp group) when the recompute unpacks it. The checkpoint saves
its inputs outside its own saved-tensor hooks, so an outer pair of hooks
packs that input alone. A block input whose ``T`` does not divide stays
whole. The host-offload ``cpu_checkpointing`` knob comes with the offload
slice.
"""

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from deepspeed_tpu_torch import comm
# register the deepspeed_tpu_torch::flash_fwd, ::block_sparse_fwd,
# ::tp_all_reduce and ::tp_all_gather ops
import deepspeed_tpu_torch.module_inject.layers  # noqa: F401
import deepspeed_tpu_torch.ops.flash_attention  # noqa: F401
import deepspeed_tpu_torch.ops.sparse_attention.block_sparse_kernel  # noqa

REMAT_POLICIES = ("full", "dots")

_aten = torch.ops.aten
SAVED_OPS = frozenset({
    _aten.mm.default, _aten.addmm.default, _aten.bmm.default,
    _aten.baddbmm.default, torch.ops.deepspeed_tpu_torch.flash_fwd.default,
    torch.ops.deepspeed_tpu_torch.block_sparse_fwd.default,
    torch.ops.deepspeed_tpu_torch.tp_all_reduce.default,
    torch.ops.deepspeed_tpu_torch.tp_all_gather.default,
})


def dots_policy(ctx, op, *args, **kwargs):
    """Save matmul and attention-forward outputs; recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _partitioned_rows(tp):
    """Saved-tensor hooks keeping this tp rank's rows (dim 1) of a
    ``[B, T, C]`` tensor and all-gathering them at unpack, contiguous as
    the tensor was saved: a strided input would change the ops a block's
    recompute runs (RMSNorm's elementwise output keeps its input's
    strides, and a projection of a strided input copies it first), which
    the ``"dots"`` policy's selective checkpoint replays by count."""
    def pack(t):
        if t.dim() != 3 or t.shape[1] % tp.size:
            return t, False
        k = t.shape[1] // tp.size
        return t.narrow(1, tp.rank * k, k).clone(), True

    def unpack(packed):
        t, rows = packed
        return (comm.all_gather(t, group=tp.group, axis=1,
                                tiled=True).contiguous() if rows else t)

    return torch.autograd.graph.saved_tensors_hooks(pack, unpack)


def checkpointed(fn, *args, policy="full", partition=None):
    """``fn(*args)`` under activation checkpointing with ``policy``;
    ``partition`` (a tp group's ``TensorParallel`` of more than one
    rank): the saved ``[B, T, C]`` input as this rank's rows (module
    docstring)."""
    if policy == "full":
        context = {}
    elif policy == "dots":
        context = {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, dots_policy)}
    else:
        raise ValueError(f"remat_policy {policy!r} not in {REMAT_POLICIES}")
    if partition is None:
        return checkpoint(fn, *args, use_reentrant=False, **context)
    with _partitioned_rows(partition):
        return checkpoint(fn, *args, use_reentrant=False, **context)
