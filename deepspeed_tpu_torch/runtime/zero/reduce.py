"""Bucketed gradient reduction (counterpart of ``deepspeed_tpu/runtime/
zero/reduce.py``).

The reference reduces gradients in fixed-byte buckets (its IPG buckets,
``reduce_bucket_size``). :func:`bucket_by_bytes` builds the JAX package's
buckets: the leaves walked in REVERSE order (backward produces the last
layers' gradients first), fp32 wire bytes, a leaf larger than the budget
in a bucket of its own. Each bucket is one flat operand and one
collective.

Where a gradient goes depends on its :class:`~deepspeed_tpu_torch.
runtime.zero.partition.ShardPlan`: a whole tensor is all-reduced, a split
one reduce-scattered so that each rank keeps the shard it owns. A
bucket's split tensors are laid out rank-major (:func:`pack_rows`): row
i holds every tensor's shard i, each moved to put its split dim first, so
one ``reduce_scatter`` of the flat bucket leaves each rank exactly its
shards, and one ``all_gather`` of the shards rebuilds the bucket
(:func:`unpack_full`).

The wire tier is full width (``comm_dtype="none"``); the int8 tier comes
with the compressed-collectives slice.
"""

from typing import List, Sequence

import torch

from deepspeed_tpu_torch import comm as dist

DEFAULT_BUCKET_BYTES = 16 * 1024 * 1024
_COMPRESSED = "the compressed-collectives slice ([9])"


def _numel(leaf) -> int:
    numel = getattr(leaf, "numel", None)
    return int(numel()) if callable(numel) else int(leaf.size)


def bucket_by_bytes(leaves: Sequence, bucket_bytes: int) -> List[List[int]]:
    """Leaf indices in buckets of at most ``bucket_bytes`` fp32 bytes,
    walking the leaves in reverse (module docstring). ``leaves`` are
    tensors or anything with a ``size``."""
    budget = max(1, int(bucket_bytes))
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i in reversed(range(len(leaves))):
        nbytes = _numel(leaves[i]) * 4
        if cur and cur_bytes + nbytes > budget:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def _moved_shard_shape(plan):
    """A shard's shape with its split dim first."""
    rest = [s for i, s in enumerate(plan.shape) if i != plan.dim]
    return (plan.shape[plan.dim] // plan.n, *rest)


def pack_rows(tensors, plans) -> torch.Tensor:
    """``[n, k]``: row i is every tensor's shard i, flattened with its
    split dim first (the layout of a reduce-scatter's input and an
    all-gather's output)."""
    n = plans[0].n
    return torch.cat([t.movedim(p.dim, 0).reshape(n, -1)
                      for t, p in zip(tensors, plans)], dim=1)


def unpack_row(row, plans):
    """Each tensor's shard (a view of ``row``) from one packed row."""
    out, off = [], 0
    for p in plans:
        k = p.shard_numel
        out.append(row[off:off + k].view(_moved_shard_shape(p))
                   .movedim(0, p.dim))
        off += k
    return out


def pack_shards(shards, plans) -> torch.Tensor:
    """The flat row of this rank's shards (an all-gather's input)."""
    return torch.cat([s.movedim(p.dim, 0).reshape(-1)
                      for s, p in zip(shards, plans)])


def unpack_full(rows, plans):
    """Each whole tensor from the gathered ``[n, k]`` rows."""
    out, off = [], 0
    for p in plans:
        k = p.shard_numel
        moved = _moved_shard_shape(p)
        full = rows[:, off:off + k].reshape((p.n * moved[0],) + moved[1:])
        out.append(full.movedim(0, p.dim))
        off += k
    return out


class GradScale:
    """The mean over a group's ``n`` members in the reference's two
    orders: post-scaling (the default) divides by ``predivide`` before
    the sum and multiplies by ``predivide / n`` after; ``prescale``
    divides by ``n`` before the sum."""

    def __init__(self, prescale: bool = False, predivide: float = 1.0):
        self.prescale = bool(prescale)
        self.predivide = float(predivide)

    def before(self, t, n):
        if self.prescale:
            t.mul_(1.0 / n)
        elif self.predivide != 1.0:
            t.mul_(1.0 / self.predivide)
        return t

    def after(self, t, n):
        if not self.prescale and self.predivide != n:
            t.mul_(self.predivide / n)
        return t


def all_reduce_flat(tensors, group, scale=None):
    """Mean of ``tensors`` over ``group`` (the sum with ``scale`` None):
    one all-reduce of their flat concatenation; returns views of the
    reduced buffer."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    n = dist.get_world_size(group)
    if scale is not None:
        scale.before(flat, n)
    dist.all_reduce(flat, group=group)
    if scale is not None:
        scale.after(flat, n)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def reduce_scatter_flat(tensors, plans, scale: GradScale):
    """Mean of ``tensors`` over their plans' group, each rank keeping its
    shards: one reduce-scatter of the rank-major bucket; returns the
    shards (views of one buffer)."""
    rows = pack_rows([t.float() for t in tensors], plans)
    n = plans[0].n
    scale.before(rows, n)
    row = rows.new_empty(rows.shape[1])
    dist.reduce_scatter(rows.reshape(-1), group=plans[0].group, output=row)
    scale.after(row, n)
    return unpack_row(row, plans)


def all_gather_flat(shards, plans):
    """Each whole tensor from every rank's shards: one all-gather."""
    n = plans[0].n
    flat = pack_shards(shards, plans)
    rows = flat.new_empty((n, flat.numel()))
    dist.all_gather_base(rows, flat, group=plans[0].group)
    return unpack_full(rows, plans)


def reduce_gradients(grads, group, comm_dtype: str = "none",
                     bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                     mean: bool = True, prescale: bool = False,
                     predivide: float = 1.0):
    """Reduce a list of gradients over ``group`` in byte-budget buckets,
    one all-reduce a bucket; returns fp32 tensors in the input order (the
    mean with ``mean``, else the sum)."""
    if comm_dtype == "int8":
        raise NotImplementedError(
            f"comm_dtype 'int8' is not ported yet: it comes with "
            f"{_COMPRESSED} of the PyTorch port")
    if comm_dtype not in ("none", None):
        raise ValueError(
            f"comm_dtype must be 'none' or 'int8' here (got {comm_dtype!r}); "
            "the 1-bit tier carries error feedback in optimizer state — use "
            "the 1-bit optimizer family")
    scale = GradScale(prescale, predivide) if mean else None
    out = [None] * len(grads)
    for bucket in bucket_by_bytes(grads, bucket_bytes):
        views = all_reduce_flat([grads[i] for i in bucket], group, scale)
        for i, v in zip(bucket, views):
            out[i] = v
    return out


__all__ = ["DEFAULT_BUCKET_BYTES", "GradScale", "all_gather_flat",
           "all_reduce_flat", "bucket_by_bytes", "pack_rows", "pack_shards",
           "reduce_gradients", "reduce_scatter_flat", "unpack_full",
           "unpack_row"]
