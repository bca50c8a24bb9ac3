"""ZeRO layouts (counterpart of ``deepspeed_tpu/runtime/zero/
partition.py``).

The JAX package expresses ZeRO as GSPMD shardings: where each array lives
on the mesh. The port keeps the same rule and the same one authority,
:class:`SpecLayout`, and turns each answer into a :class:`ShardPlan`:
which dim of the tensor is split, over which process group, and which
slice this rank holds.

- **stage 1**: optimizer state and the fp32 master update split over the
  ZeRO axes (``data x fsdp x expert``, by :meth:`SpecLayout.opt_spec`);
  parameters replicated;
- **stage 2**: the same split, and gradients reduce-scattered to their
  owner every micro-step;
- **stage 3**: parameters split too (:meth:`SpecLayout.param_spec`),
  gathered before each use.

Sharding rule: shard the largest dim divisible by the ZeRO axes' product
(the first such dim on a tie); parameters smaller than
``param_persistence_threshold`` stay replicated at stage 3; with
``hierarchical_gather`` (ZeRO++ hpZ) stage-3 parameters split over the
non-data ZeRO axes only. Batches split over ``data x expert`` only.

Layouts differ between the packages: a flax ``Dense`` kernel is ``[in,
out]`` and an ``nn.Linear`` weight ``[out, in]``. A plan is computed on
the JAX order of the shape (the ``nn.Linear`` weight reversed) and mapped
back, so both packages split the same logical dim, ties included
(:func:`dense_weights`).

Under tensor parallelism the module holds this rank's tp slices (``[out /
tp, in]`` and the like), where the JAX layout speaks of whole tensors
with a ``tp`` entry. Each plan is computed on the global JAX-order shape
and the tensor's tp base spec (the module's ``param_specs``), then applied
to the local slice: ZeRO takes a dim tp leaves, whose size the slice
shares with the whole tensor, so each rank's shard shape is the JAX
layout's addressable shard.

One departure: on a world of one rank, SpecLayout replicates everything
(no axis is larger than 1), where a plan keeps the stage's split as one
shard of the whole tensor over a group of one. The stage's collectives
then run, over that group, as they do on more ranks; the layout and its
specs are SpecLayout's.
"""

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from deepspeed_tpu_torch.parallel.topology import (AXIS_DATA, AXIS_EXPERT,
                                                   AXIS_FSDP, AXIS_SEQ,
                                                   AXIS_TP, axis_spec_entry,
                                                   resolve_axis_name)

ZERO_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_EXPERT)
BATCH_AXES = (AXIS_DATA, AXIS_EXPERT)


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s shape: one entry per dim, each
    None (replicated), an axis name, or a tuple of axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def hierarchical_param_axes(zero_axes: Sequence[str] = ZERO_AXES
                            ) -> Tuple[str, ...]:
    """The ZeRO axes an hpZ parameter shard spans: all but ``data``."""
    return tuple(a for a in zero_axes if a != AXIS_DATA)


def _shardable_dim(shape: Tuple[int, ...], axis_size: int,
                   taken: Sequence[Optional[str]]) -> Optional[int]:
    """Largest dim divisible by axis_size and not already sharded."""
    best, best_size = None, 0
    for i, d in enumerate(shape):
        if (taken[i] is None and d % axis_size == 0 and d >= axis_size
                and d > best_size):
            best, best_size = i, d
    return best


def zero_partition_spec(shape: Tuple[int, ...], mesh,
                        data_axes: Optional[Sequence[str]] = None,
                        base_spec: Optional[P] = None,
                        persistence_threshold: int = 0) -> P:
    """PartitionSpec sharding ``shape`` over the (flattened) ZeRO axes,
    layered on ``base_spec`` (tp/expert specs); ``base_spec`` unchanged
    when the tensor is below the persistence threshold or no dim divides.
    ``mesh`` is anything with a ``shape`` mapping of axis sizes (the
    port's :class:`~deepspeed_tpu_torch.parallel.topology.MeshTopology`).
    """
    if data_axes is None:
        data_axes = ZERO_AXES
    entries = list(base_spec) if base_spec is not None else []
    entries += [None] * (len(shape) - len(entries))
    used = {a for e in entries
            for a in (e if isinstance(e, tuple) else (e,)) if a}
    data_axes = [a for a in data_axes
                 if mesh.shape.get(a, 1) > 1 and a not in used]
    if not data_axes:
        return base_spec if base_spec is not None else P()
    axis_size = int(np.prod([mesh.shape[a] for a in data_axes]))
    if int(np.prod(shape)) < max(persistence_threshold, axis_size):
        return P(*entries) if base_spec is not None else P()
    dim = _shardable_dim(shape, axis_size, entries)
    if dim is None:
        return P(*entries) if base_spec is not None else P()
    entries[dim] = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
    return P(*entries)


def dense_weights(module) -> set:
    """Names (as in ``module.named_parameters()``) of the ``nn.Linear``
    weights and their column- and row-parallel slices: ``[out, in]``
    here, ``[in, out]`` in the JAX package."""
    from torch import nn

    from deepspeed_tpu_torch.module_inject.layers import (
        ColumnParallelLinear, RowParallelLinear)

    dense = (nn.Linear, ColumnParallelLinear, RowParallelLinear)
    names = set()
    for prefix, sub in module.named_modules():
        if isinstance(sub, dense):
            names.add(f"{prefix}.weight" if prefix else "weight")
    return names


class ShardPlan:
    """Where one tensor lives: its full ``shape``, its ``spec`` (the
    port's dim order), the split ``dim`` (None: whole on every rank), the
    group's ``axes`` and process ``group`` (None without a process
    group), ``n`` members, and this rank's shard ``index``."""

    __slots__ = ("shape", "spec", "dim", "axes", "group", "n", "index")

    def __init__(self, shape, spec=P(), dim=None, axes=(), group=None, n=1,
                 index=0):
        self.shape = tuple(int(s) for s in shape)
        self.spec = spec
        self.dim = dim
        self.axes = tuple(axes)
        self.group = group
        self.n = int(n)
        self.index = int(index)

    @property
    def sharded(self) -> bool:
        return self.dim is not None

    @property
    def tp_split(self) -> bool:
        """Whether the tensor is a tp slice (its spec names ``tp``)."""
        return any(AXIS_TP == a for e in self.spec if e is not None
                   for a in (e if isinstance(e, tuple) else (e,)))

    @property
    def shard_shape(self) -> Tuple[int, ...]:
        if not self.sharded:
            return self.shape
        s = list(self.shape)
        s[self.dim] //= self.n
        return tuple(s)

    @property
    def shard_numel(self) -> int:
        return int(np.prod(self.shard_shape))

    def local(self, full):
        """This rank's slice of ``full`` (a view), or ``full``."""
        if not self.sharded:
            return full
        k = self.shape[self.dim] // self.n
        return full.narrow(self.dim, self.index * k, k)

    def same_layout(self, other: "ShardPlan") -> bool:
        """Both whole, or both the same slice over the same group."""
        if not (self.sharded or other.sharded):
            return True
        return (self.sharded and other.sharded and self.dim == other.dim
                and self.axes == other.axes and self.n == other.n
                and self.index == other.index)

    def __repr__(self):
        return (f"ShardPlan(shape={self.shape}, spec={self.spec}, "
                f"dim={self.dim}, axes={self.axes}, n={self.n}, "
                f"index={self.index})")


class SpecLayout:
    """The one authority over the ``data x fsdp x tp`` layout of a mesh
    (the JAX package's class): tp base specs per parameter family from a
    ``module_inject`` policy, ZeRO layered on the ``data x fsdp x expert``
    axes, batches over ``data x expert`` only. ``mesh`` is a
    :class:`~deepspeed_tpu_torch.parallel.topology.MeshTopology`."""

    def __init__(self, mesh, policy="auto", tp_axis: str = AXIS_TP,
                 zero_axes: Sequence[str] = ZERO_AXES,
                 batch_axes: Sequence[str] = BATCH_AXES,
                 persistence_threshold: int = 0,
                 hierarchical_gather: bool = False):
        forbidden = {tp_axis, AXIS_FSDP} & set(batch_axes)
        if forbidden:
            raise ValueError(
                f"batch_axes {tuple(batch_axes)} must not contain the "
                f"tp/fsdp axes {sorted(forbidden)}: they shard weights, "
                "never the batch dimension")
        self.mesh = mesh
        self.tp_axis = resolve_axis_name(mesh, tp_axis)
        self.zero_axes = tuple(zero_axes)
        self.batch_axes = tuple(batch_axes)
        self.persistence_threshold = int(persistence_threshold)
        self.hierarchical_gather = bool(hierarchical_gather)
        self._policy = policy

    @property
    def hierarchical_active(self) -> bool:
        """hpZ in effect: requested, and a non-data ZeRO axis is above 1."""
        if not self.hierarchical_gather:
            return False
        return any(self.mesh.shape.get(a, 1) > 1
                   for a in hierarchical_param_axes(self.zero_axes))

    # -- policy / families ------------------------------------------------
    @property
    def policy(self):
        from deepspeed_tpu_torch.module_inject.policies import get_tp_policy

        if isinstance(self._policy, str) or self._policy is None:
            self._policy = get_tp_policy(self._policy or "auto")
        return self._policy

    @property
    def tp_size(self) -> int:
        return int(self.mesh.shape.get(self.tp_axis, 1))

    def family_of(self, path: str, shape: Tuple[int, ...] = ()) -> str:
        from deepspeed_tpu_torch.module_inject.policies import family_for

        return family_for(path, shape, self.policy)

    # -- ZeRO layering ----------------------------------------------------
    def _param_axes(self):
        return hierarchical_param_axes(self.zero_axes) \
            if self.hierarchical_active else self.zero_axes

    def param_spec(self, shape, base_spec=None, stage: int = 3) -> P:
        """Final spec of a parameter under ``stage`` (tp + ZeRO-3)."""
        if stage >= 3:
            return zero_partition_spec(
                tuple(shape), self.mesh, data_axes=self._param_axes(),
                base_spec=base_spec,
                persistence_threshold=self.persistence_threshold)
        return base_spec if base_spec is not None else P()

    def opt_spec(self, shape, base_spec=None, stage: int = 1) -> P:
        """Final spec of an optimizer-state leaf under ``stage``."""
        if stage >= 1:
            return zero_partition_spec(tuple(shape), self.mesh,
                                       data_axes=self.zero_axes,
                                       base_spec=base_spec)
        return base_spec if base_spec is not None else P()

    def _plan(self, shape, jax_shape, spec: P, axes, threshold: int,
              transposed: bool, split: bool) -> ShardPlan:
        """The plan of ``spec`` (JAX dim order, of the whole tensor's
        ``jax_shape``) for a tensor of the port's (local) ``shape``;
        ``split``: the stage splits this kind of tensor."""
        entries = list(spec) + [None] * (len(jax_shape) - len(spec))
        zero = [i for i, e in enumerate(entries) if e is not None
                and set(e if isinstance(e, tuple) else (e,))
                <= set(self.zero_axes)]
        active = tuple(a for a in axes if self.mesh.shape.get(a, 1) > 1)
        if zero:
            dim = zero[0]
            e = entries[dim]
            active = e if isinstance(e, tuple) else (e,)
        elif split and not active and jax_shape \
                and int(np.prod(jax_shape)) >= max(threshold, 1):
            # a world of one: the whole tensor as one shard
            dim = _shardable_dim(jax_shape, 1, entries)
        else:
            dim = None
        if transposed:
            entries = entries[::-1]
            dim = None if dim is None else len(shape) - 1 - dim
        spec = P(*entries) if any(entries) else P()
        if dim is None:
            return ShardPlan(shape, spec)
        group = n = index = None
        ranks = self.mesh.group_ranks(active)
        n = len(ranks)
        index = ranks.index(self.mesh.rank)
        if getattr(self.mesh, "_groups", None):
            group = self.mesh.group(active)
        return ShardPlan(shape, spec, dim, active, group, n, index)

    def _jax_order(self, shape, base, transposed):
        """The whole tensor's shape in JAX order, and its tp base spec,
        for a local slice of the port's ``shape`` whose base spec (the
        port's order) is ``base``."""
        if base is not None:
            shape = [s * self.tp_size if e is not None else s
                     for s, e in zip(shape, base)]
        if transposed:
            return tuple(shape)[::-1], (None if base is None
                                        else P(*tuple(base)[::-1]))
        return tuple(shape), base

    def param_plan(self, shape, stage: int,
                   transposed: bool = False, base=None) -> ShardPlan:
        """The parameter's plan at ``stage``: ``shape`` the port's local
        shape, ``base`` its tp base spec (None: replicated)."""
        jax_shape, jbase = self._jax_order(shape, base, transposed)
        return self._plan(shape, jax_shape,
                          self.param_spec(jax_shape, jbase, stage),
                          self._param_axes(), self.persistence_threshold,
                          transposed, stage >= 3)

    def opt_plan(self, shape, stage: int,
                 transposed: bool = False, base=None) -> ShardPlan:
        """The optimizer state's plan, as :meth:`param_plan`."""
        jax_shape, jbase = self._jax_order(shape, base, transposed)
        return self._plan(shape, jax_shape,
                          self.opt_spec(jax_shape, jbase, stage),
                          self.zero_axes, 0, transposed, stage >= 1)

    def shardings(self, module, stage: int):
        """``(param_plans, opt_plans)``: ``{name: ShardPlan}`` for every
        trainable parameter of ``module`` (the JAX method's pair of
        sharding trees). Above tp 1 the module holds its tp slices and
        gives their base specs (``module.param_specs()``, as the JAX
        engine asks a model that has them)."""
        dense = dense_weights(module)
        specs = module.param_specs() if self.tp_size > 1 else {}
        params, opts = {}, {}
        for name, p in module.named_parameters():
            if not p.requires_grad:
                continue
            shape = tuple(getattr(p, "ds_shape", p.shape))
            t = name in dense and len(shape) == 2
            base = specs.get(name)
            params[name] = self.param_plan(shape, stage, t, base)
            opts[name] = self.opt_plan(shape, stage, t, base)
        return params, opts

    # -- batch ------------------------------------------------------------
    def batch_spec(self, ndim: int = 2,
                   shape: Optional[Tuple[int, ...]] = None) -> P:
        """Leading dim over ``batch_axes``; with sequence parallelism
        active dim 1 over ``seq``. Dims not divisible by their axis
        product stay unsharded (requires ``shape``)."""
        entries = [None] * ndim
        entries[0] = axis_spec_entry(self.mesh, self.batch_axes,
                                     shape[0] if shape is not None else None)
        if ndim >= 2:
            entries[1] = axis_spec_entry(
                self.mesh, (AXIS_SEQ,),
                shape[1] if shape is not None else None)
        return P(*entries)

    def batch_sharding(self, ndim: int = 2,
                       shape: Optional[Tuple[int, ...]] = None
                       ) -> ShardPlan:
        """The plan of a batch array: its rows over the batch axes."""
        spec = self.batch_spec(ndim, shape)
        if spec[0] is None:
            return ShardPlan(shape or (0,) * ndim, spec)
        axes = spec[0] if isinstance(spec[0], tuple) else (spec[0],)
        ranks = self.mesh.group_ranks(axes)
        group = (self.mesh.group(axes)
                 if getattr(self.mesh, "_groups", None) else None)
        return ShardPlan(shape, spec, 0, axes, group, len(ranks),
                         ranks.index(self.mesh.rank))

    # -- identity ---------------------------------------------------------
    def describe(self) -> Dict:
        """JSON-safe identity of this layout: the axis roles and one
        canonical spec per parameter family at the live tp size (the
        port's ``[out, in]`` dim order)."""
        tp = self.tp_size
        col = spec_entries(P(self.tp_axis, None) if tp > 1 else None)
        row = spec_entries(P(None, self.tp_axis) if tp > 1 else None)
        families = {
            "embedding": spec_entries(P(self.tp_axis, None) if tp > 1
                                      else None),
            "attn_qkv": col, "attn_proj": row, "mlp_in": col,
            "mlp_out": row, "norm": spec_entries(None),
        }
        return {
            "policy": getattr(self.policy, "name", "auto"),
            "tp_axis": self.tp_axis,
            "tp_size": tp,
            "zero_axes": list(self.zero_axes),
            "batch_axes": list(self.batch_axes),
            "hierarchical_gather": self.hierarchical_active,
            "families": families,
        }


def default_layout(mesh, policy="auto",
                   persistence_threshold: int = 0) -> SpecLayout:
    """The default SpecLayout of a mesh."""
    return SpecLayout(mesh, policy=policy,
                      persistence_threshold=persistence_threshold)


def spec_entries(spec) -> list:
    """JSON-safe form of a PartitionSpec: one entry per dim, None, an
    axis name, or a list of axis names."""
    if spec is None:
        return []
    out = []
    for e in spec:
        if e is None:
            out.append(None)
        elif isinstance(e, (tuple, list)):
            out.append([str(a) for a in e])
        else:
            out.append(str(e))
    return out


def batch_sharding(mesh, data_axes: Optional[Sequence[str]] = None,
                   ndim: int = 2, shape: Optional[Tuple[int, ...]] = None
                   ) -> ShardPlan:
    """The plan of a batch array under the default layout (or one whose
    batch axes are ``data_axes``)."""
    layout = SpecLayout(mesh) if data_axes is None \
        else SpecLayout(mesh, batch_axes=tuple(data_axes))
    return layout.batch_sharding(ndim=ndim, shape=shape)


__all__ = ["BATCH_AXES", "ZERO_AXES", "P", "PartitionSpec", "ShardPlan",
           "SpecLayout", "batch_sharding", "default_layout",
           "dense_weights", "hierarchical_param_axes", "spec_entries",
           "zero_partition_spec"]
