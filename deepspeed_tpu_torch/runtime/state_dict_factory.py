"""Fused-QKV reshaping for tensor parallelism (counterpart of the
``shard_qkv_for_tp`` / ``merge_qkv_tp_shards`` pair of
``deepspeed_tpu/runtime/state_dict_factory.py``, the reference
``MegatronSDLoader`` merge and split).

A fused QKV projection concatenates Q, K and V along its output features.
A tp rank must hold heads of all three, so the split takes EACH of Q, K
and V apart (a plain split of the fused dim would give rank 0 all of Q
and half of K). ``out_axis`` is the output-feature dim: the last one of a
flax ``Dense`` kernel ``[in, 3C]``, dim 0 of an ``nn.Linear`` weight
``[3C, in]`` and of a bias.

The checkpoint loaders of the JAX module come with the checkpoint slice
([12.1]).
"""

import torch


def shard_qkv_for_tp(fused: torch.Tensor, tp_size: int, rank: int,
                     out_axis: int = -1) -> torch.Tensor:
    """Rank ``rank``'s slice of a fused QKV tensor: its ``1/tp_size`` of
    each of Q, K and V, concatenated in that order."""
    qkv = fused.chunk(3, dim=out_axis)
    return torch.cat([x.chunk(tp_size, dim=out_axis)[rank] for x in qkv],
                     dim=out_axis)


def merge_qkv_tp_shards(shards, out_axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`shard_qkv_for_tp`: the per-rank fused shards (in
    rank order) back into the whole fused tensor."""
    per_rank = [s.chunk(3, dim=out_axis) for s in shards]
    return torch.cat([torch.cat([r[i] for r in per_rank], dim=out_axis)
                      for i in range(3)], dim=out_axis)
