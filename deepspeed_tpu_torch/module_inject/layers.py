"""Tensor-parallel layers (counterpart of ``deepspeed_tpu/module_inject/
layers.py``, the reference ``LinearLayer`` / ``LinearAllreduce``).

The JAX module runs each layer under ``shard_map`` over the ``tp`` mesh
axis, one controller for every shard. Here every tp rank is one process
holding its own shards, so the functions below take THIS rank's shards in
the port's ``[out, in]`` layout and issue the row-parallel sum through
``comm.all_reduce`` on the tp group:

- a column-parallel weight ``[out/tp, in]`` (with its bias ``[out/tp]``)
  gives this rank's slice of the output features, with no collective;
- a row-parallel weight ``[out, in/tp]`` takes this rank's slice of the
  input features, and the partial products are summed over the group;
  the row bias (whole on every rank) is added ONCE, after the sum, as
  ``LinearAllreduce`` does: added before it, every rank's copy would be
  summed too.

Gradients cross the group through Megatron's f/g pair, where the JAX
module leaves them to ``psum``'s transpose: :func:`copy_to_tp` (f: the
identity forward, a sum of the input's gradient backward) sits before
each column-parallel layer, :func:`tp_all_reduce` (g, Megatron's
``reduce_from_tp``: the sum forward, the identity backward) after each
row-parallel one, and
:func:`gather_from_tp` (a tiled all-gather forward, this rank's slice of
the gradient backward) after the vocab-parallel head and after split
heads that feed a whole projection, and :func:`scatter_to_tp` (the rank's
slice forward, the all-gathered gradient backward) where a replicated
tensor meets a split one. Every collective
is out of place: autograd may have saved the tensor an in-place sum would
overwrite. g's sum and the gather are the custom ops ``deepspeed_tpu_torch::
tp_all_reduce`` and ``::tp_all_gather``, so the "dots" remat policy saves
their outputs by op (``models/remat_utils.py``) and a block's recompute
issues no collective.

:class:`TensorParallel` names a rank's place in its tp group; the models
hold one (or None) and :class:`ColumnParallelLinear` /
:class:`RowParallelLinear` hold the shards.
"""

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from deepspeed_tpu_torch import comm


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place in its tp group: ``group`` (a process group),
    ``size`` ranks, this one ``rank``; ``specs`` maps each parameter name
    of the whole model to its ``PartitionSpec`` over the tp axis (None:
    replicated)."""

    group: object
    size: int
    rank: int
    specs: dict = dataclasses.field(default_factory=dict)

    def split(self, name: str) -> Optional[int]:
        """The dim of parameter ``name`` split over tp, or None."""
        spec = self.specs.get(name)
        if spec is None:
            return None
        return next(i for i, e in enumerate(spec) if e is not None)


def _check_tier(comm_dtype):
    if comm_dtype == "int8":
        raise NotImplementedError(
            "tp_all_reduce(comm_dtype='int8') is not ported yet: it comes "
            "with the compressed-collectives slice ([9]) of the PyTorch "
            "port")
    if comm_dtype not in ("none", "", None):
        raise ValueError(
            f"tp collective tier must be 'none' or 'int8', got "
            f"{comm_dtype!r} (the 1-bit tier is error-feedback-stateful "
            "and gradient-only)")


def _alone(group) -> bool:
    return group is None or comm.get_world_size(group) <= 1


@torch.library.custom_op("deepspeed_tpu_torch::tp_all_reduce",
                         mutates_args=())
def tp_all_reduce_op(x: torch.Tensor, group_name: str) -> torch.Tensor:
    """The sum of ``x`` over the process group registered as
    ``group_name`` (an op takes no group object), into a new tensor."""
    group = torch.distributed.distributed_c10d._resolve_process_group(
        group_name)
    return comm.all_reduce(x.clone(), group=group)


@tp_all_reduce_op.register_fake
def _tp_all_reduce_fake(x, group_name):
    return torch.empty_like(x)


def _sum_backward(ctx, grad):
    return grad, None


tp_all_reduce_op.register_autograd(_sum_backward)


def tp_all_reduce(x, group, comm_dtype: str = "none"):
    """g: the sum of ``x`` over the tp process ``group``, into a new
    tensor whose gradient passes through unchanged; ``x`` itself in a
    group of one. ``"none"`` is a plain sum; ``"int8"`` (the JAX
    package's EQuARX tier) comes with the compressed collectives."""
    _check_tier(comm_dtype)
    if _alone(group):
        return x
    return tp_all_reduce_op(x, group.group_name)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return comm.all_reduce(grad.clone(), group=ctx.group), None


def copy_to_tp(x, group):
    """f: ``x`` itself forward; backward, its gradient summed over the tp
    ``group`` (each rank's column slice saw all of ``x``)."""
    if _alone(group):
        return x
    return _CopyToTP.apply(x, group)


@torch.library.custom_op("deepspeed_tpu_torch::tp_all_gather",
                         mutates_args=())
def tp_all_gather_op(x: torch.Tensor, group_name: str,
                     dim: int) -> torch.Tensor:
    """Every member's ``x`` of the process group registered as
    ``group_name``, concatenated along ``dim``."""
    group = torch.distributed.distributed_c10d._resolve_process_group(
        group_name)
    return comm.all_gather(x, group=group, axis=dim, tiled=True)


@tp_all_gather_op.register_fake
def _tp_all_gather_fake(x, group_name, dim):
    group = torch.distributed.distributed_c10d._resolve_process_group(
        group_name)
    shape = list(x.shape)
    shape[dim] *= comm.get_world_size(group)
    return x.new_empty(shape)


def _gather_setup(ctx, inputs, output):
    x, group_name, dim = inputs
    group = torch.distributed.distributed_c10d._resolve_process_group(
        group_name)
    ctx.dim, ctx.rank, ctx.k = dim, comm.get_rank(group), x.shape[dim]


def _slice_backward(ctx, grad):
    return grad.narrow(ctx.dim, ctx.rank * ctx.k, ctx.k), None, None


tp_all_gather_op.register_autograd(_slice_backward,
                                   setup_context=_gather_setup)


def gather_from_tp(x, group, dim: int = -1):
    """Every tp rank's ``x`` concatenated along ``dim`` (the vocab-
    parallel head's logits, the heads' outputs before a whole
    projection); backward, this rank's slice of the gradient (every
    rank holds the same gradient of the whole). The custom op
    ``deepspeed_tpu_torch::tp_all_gather``, so the "dots" remat policy
    saves its output as it saves g's."""
    if _alone(group):
        return x
    return tp_all_gather_op(x, group.group_name, dim % x.dim())


class _ScatterToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group = group
        k = x.shape[0] // size
        return x.narrow(0, rank * k, k)

    @staticmethod
    def backward(ctx, grad):
        return (comm.all_gather(grad.contiguous(), group=ctx.group,
                                tiled=True), None, None, None)


def scatter_to_tp(x, tp: "TensorParallel"):
    """This tp rank's ``1 / tp.size`` of ``x`` along dim 0 (Megatron's
    scatter, the inverse pair of :func:`gather_from_tp`): forward a view
    of the rank's slice; backward, every rank's slice of the gradient
    all-gathered, so every rank holds the whole gradient of ``x``, a
    tensor replicated over the group (the MLM head's ``decoder_bias``
    under a split vocabulary)."""
    if _alone(tp.group):
        return x
    return _ScatterToTP.apply(x, tp.group, tp.rank, tp.size)


_ACTIVATIONS = {
    "gelu": lambda h: F.gelu(h, approximate="tanh"),
    "gelu_exact": F.gelu,
    "relu": F.relu,
    "silu": F.silu,
    "identity": lambda h: h,
}


def column_parallel_linear(x, w, b=None, group=None):
    """Reference ``LinearLayer``: ``x @ w.T + b`` with this rank's
    ``[out/tp, in]`` weight: this rank's slice of the output features, no
    collective forward (feed it a row-parallel partner or an all-gather);
    backward, ``x``'s gradient is summed over the tp ``group``
    (:func:`copy_to_tp`)."""
    return F.linear(copy_to_tp(x, group), w, b)


def row_parallel_linear(x, w, b=None, group=None, comm_dtype="none"):
    """Reference ``LinearAllreduce``: this rank's input slice ``x [...,
    in/tp]`` times its ``[out, in/tp]`` weight, summed over the tp
    ``group`` (:func:`tp_all_reduce`), then the (whole) bias."""
    y = tp_all_reduce(F.linear(x, w), group, comm_dtype)
    return y if b is None else y + b


def injected_mlp(x, w_in, b_in, w_out, b_out, group=None,
                 activation: str = "gelu", comm_dtype: str = "none"):
    """The column -> row MLP: ``act(x @ w_in.T + b_in) @ w_out.T`` summed
    over ``group``, plus ``b_out`` after the sum: ONE collective per MLP.
    ``w_in`` / ``b_in`` are this rank's column shards, ``w_out`` its row
    shard."""
    h = _ACTIVATIONS[activation](column_parallel_linear(x, w_in, b_in,
                                                        group))
    return row_parallel_linear(h, w_out, b_out, group, comm_dtype)


class ColumnParallelLinear(nn.Module):
    """This rank's ``[out/tp, in]`` slice of a linear layer (and its
    ``[out/tp]`` bias): ``forward(x, dtype)`` computes its slice of the
    output features in ``dtype`` (the weights cast at each use, as the
    models' dense layers do), summing ``x``'s gradient over ``tp.group``
    in backward."""

    def __init__(self, in_features: int, out_features: int,
                 tp: TensorParallel, bias: bool = True, device=None):
        super().__init__()
        if out_features % tp.size:
            raise ValueError(f"{out_features} output features do not split "
                             f"over {tp.size} tp ranks")
        self.in_features, self.out_features = in_features, out_features
        self.tp = tp
        local = out_features // tp.size
        self.weight = nn.Parameter(torch.empty(local, in_features,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty(local, device=device))
                     if bias else None)

    def forward(self, x, dtype=None):
        dtype = dtype or x.dtype
        return column_parallel_linear(
            x, self.weight.to(dtype),
            None if self.bias is None else self.bias.to(dtype),
            self.tp.group)


class RowParallelLinear(nn.Module):
    """This rank's ``[out, in/tp]`` slice of a linear layer and its whole
    ``[out]`` bias: ``forward(x, dtype)`` takes this rank's input slice
    and returns the whole output, summed over ``tp.group``."""

    def __init__(self, in_features: int, out_features: int,
                 tp: TensorParallel, bias: bool = True, device=None):
        super().__init__()
        if in_features % tp.size:
            raise ValueError(f"{in_features} input features do not split "
                             f"over {tp.size} tp ranks")
        self.in_features, self.out_features = in_features, out_features
        self.tp = tp
        self.weight = nn.Parameter(torch.empty(
            out_features, in_features // tp.size, device=device))
        self.bias = (nn.Parameter(torch.empty(out_features, device=device))
                     if bias else None)

    def forward(self, x, dtype=None):
        dtype = dtype or x.dtype
        return row_parallel_linear(
            x, self.weight.to(dtype),
            None if self.bias is None else self.bias.to(dtype),
            self.tp.group)


def column_projections(layers, x, dtype):
    """``x`` through each column projection of ``layers`` in ``dtype``
    (with its bias, where it has one); under tp one f (:func:`copy_to_tp`)
    for the group, where the projections are :class:`ColumnParallelLinear`
    slices (plain ``nn.Linear`` layers are whole on every rank)."""
    if isinstance(layers[0], ColumnParallelLinear):
        x = copy_to_tp(x, layers[0].tp.group)
    return [F.linear(x, layer.weight.to(dtype),
                     None if layer.bias is None else layer.bias.to(dtype))
            for layer in layers]


def vocab_parallel_lookup(table, ids, tp: Optional[TensorParallel],
                          dtype=None):
    """Rows of the embedding ``table`` for ``ids``, cast to ``dtype``
    (None: the table's). Under a ``tp`` that splits the vocabulary
    (``table`` is this rank's contiguous rows), each rank looks the ids up
    in its rows, zeros elsewhere, and :func:`tp_all_reduce` sums the one
    real row per token, exactly."""
    if tp is None:
        rows = table[ids]
        return rows if dtype is None else rows.to(dtype)
    n = table.shape[0]
    local = ids - tp.rank * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    if dtype is not None:
        rows = rows.to(dtype)
    return tp_all_reduce(torch.where(inside[..., None], rows, 0), tp.group)


__all__ = ["ColumnParallelLinear", "RowParallelLinear", "TensorParallel",
           "column_parallel_linear", "column_projections", "copy_to_tp",
           "gather_from_tp", "injected_mlp", "row_parallel_linear",
           "scatter_to_tp", "tp_all_reduce", "vocab_parallel_lookup"]
