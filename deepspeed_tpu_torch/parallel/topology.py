"""Process topology over ``torch.distributed`` (counterpart of
``deepspeed_tpu/parallel/topology.py``).

:class:`ProcessTopology` and its pipe/model/data subclasses are the JAX
package's pure index arithmetic, copied: rank 0 is coordinate (0, ..., 0)
and the last axis varies fastest.

:class:`MeshTopology` is where the two packages part. The JAX one owns a
``jax.sharding.Mesh`` driven by one controller; here every rank is one
process (one card, or one CPU rank under gloo), placed on the canonical
axes ``pipe > data > fsdp > expert > seq > tp`` in row-major order, and a
"group" is a ``torch.distributed`` process group. At construction, when a
process group is running, every rank creates the groups of every axis
subset that can be active, in the same order on every rank (as
``torch.distributed.new_group`` requires); :meth:`MeshTopology.group`
resolves an axis name or a tuple of axis names to this rank's group.

The port runs the ``data``, ``fsdp`` and ``tp`` axes: training on
``data x fsdp x tp``, inference and serving on ``data x tp``
(:func:`resolve_tp_topology`). A ``pipe``, ``expert`` or ``seq`` axis
above 1 raises :class:`NotImplementedError` naming the slice that brings
it (:func:`check_ported_axes`).

A ``dcn`` section (``dcn_axis_sizes``) splits each axis into a slow
factor across nodes and a fast one within a node, as the JAX package's
multi-slice mesh does: ranks are ordered dcn-major, so rank ``r`` sits on
node ``r // LOCAL_WORLD_SIZE`` and the dcn factor of every axis is its
outermost index (the order JAX's ``_hybrid_device_mesh`` gives a CPU test
mesh).
"""

import os

import collections
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger

AXIS_PIPE = "pipe"
AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_EXPERT = "expert"
AXIS_SEQ = "seq"
AXIS_TP = "tp"
# deprecated alias: the pre-3-axis-mesh name of the tp axis
AXIS_MODEL = AXIS_TP

CANONICAL_AXIS_ORDER = (AXIS_PIPE, AXIS_DATA, AXIS_FSDP, AXIS_EXPERT,
                        AXIS_SEQ, AXIS_TP)

AXIS_ALIASES = {"model": AXIS_TP}

# the axes of a later slice of the port, and that slice
UNPORTED_AXES = {
    AXIS_PIPE: "the pipeline slice ([11])",
    AXIS_EXPERT: "the MoE slice ([12.6])",
    AXIS_SEQ: "the sequence-parallel slice ([12.7])",
}


def normalize_axis_dict(axis_sizes: Dict[str, int]) -> Dict[str, int]:
    """Fold alias axis names ("model" -> "tp") into canonical ones,
    rejecting a dict that names both an alias and its target with
    different sizes."""
    out: Dict[str, int] = {}
    for name, size in (axis_sizes or {}).items():
        canon = AXIS_ALIASES.get(name, name)
        if canon in out and int(out[canon]) != int(size):
            raise ValueError(
                f"mesh axis {canon!r} given twice (via alias {name!r}) "
                f"with conflicting sizes {out[canon]} and {size}")
        out[canon] = int(size)
    return out


class ProcessTopology:
    """Cartesian topology mapping ranks <-> axis coordinates (the JAX
    package's class, the reference ``runtime/pipe/topology.py:9``)."""

    def __init__(self, axes: Sequence[str], dims: Sequence[int]):
        if len(axes) != len(dims):
            raise ValueError(f"{len(axes)} axes but {len(dims)} dims")
        self.axes = list(axes)
        self.dims = list(dims)
        self.ProcessCoord = collections.namedtuple("ProcessCoord", self.axes)
        self.mapping = {}
        ranges = [range(d) for d in self.dims]
        for global_rank, coord in enumerate(itertools.product(*ranges)):
            key = dict(zip(self.axes, coord))
            self.mapping[self.ProcessCoord(**key)] = global_rank

    def get_rank(self, **coord_kwargs) -> int:
        if len(coord_kwargs) != len(self.axes):
            raise ValueError(
                f"get_rank() does not support slices, got {coord_kwargs}")
        key = self.ProcessCoord(**coord_kwargs)
        if key not in self.mapping:
            raise ValueError(f"coord {coord_kwargs} not in topology")
        return self.mapping[key]

    def get_axis_names(self) -> List[str]:
        return self.axes

    def get_rank_repr(self, rank, omit_axes=(AXIS_DATA, AXIS_PIPE),
                      inner_sep="_", outer_sep="-"):
        omit_axes = list(omit_axes)
        axes = [a for a in self.get_axis_names() if a not in omit_axes]
        names = []
        for ax in axes:
            ax_rank = getattr(self.get_coord(rank=rank), ax)
            names.append(f"{ax}{inner_sep}{ax_rank:02d}")
        return outer_sep.join(names)

    def get_dim(self, axis: str) -> int:
        if axis not in self.axes:
            return 0
        return self.dims[self.axes.index(axis)]

    def get_coord(self, rank: int):
        for coord, idx in self.mapping.items():
            if idx == rank:
                return coord
        raise ValueError(f"rank {rank} not in topology")

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """Groups of ranks that communicate along ``axis``."""
        if axis not in self.axes:
            return []
        other_axes = [a for a in self.axes if a != axis]
        lists = []
        ranges = [range(self.get_dim(a)) for a in other_axes]
        for combo in itertools.product(*ranges):
            other_keys = dict(zip(other_axes, combo))
            lists.append([self.get_rank(**other_keys, **{axis: i})
                          for i in range(self.get_dim(axis))])
        return lists

    def filter_match(self, **filter_kwargs) -> List[int]:
        """All ranks whose coordinates match the given axis values."""

        def _matches(coord):
            return all(getattr(coord, k) == v
                       for k, v in filter_kwargs.items())

        return [self.mapping[c] for c in sorted(self.mapping,
                                                key=self.mapping.get)
                if _matches(c)]

    def get_axis_list(self, axis: str, idx: int) -> List[int]:
        return self.filter_match(**{axis: idx})

    @property
    def world_size(self) -> int:
        return int(np.prod(self.dims)) if self.dims else 1

    def __str__(self):
        return f"ProcessTopology(axes={self.axes}, dims={self.dims})"


class PipeDataParallelTopology(ProcessTopology):
    """Reference ``topology.py:232``: pipe outer, data inner."""

    def __init__(self, num_pp, num_dp):
        super().__init__(axes=[AXIS_PIPE, AXIS_DATA], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """Reference ``topology.py:243``: pipe > data > model (the reference's
    literal ``model`` coordinate name)."""

    def __init__(self, num_pp, num_mp, num_dp):
        super().__init__(axes=[AXIS_PIPE, AXIS_DATA, "model"],
                         dims=[num_pp, num_dp, num_mp])


def _normalize_axis_sizes(axis_sizes: Dict[str, int],
                          n_devices: int) -> Dict[str, int]:
    """Resolve the -1 (fill) entry and check the product against
    ``n_devices``."""
    axis_sizes = normalize_axis_dict(axis_sizes)
    unknown = set(axis_sizes) - set(CANONICAL_AXIS_ORDER)
    if unknown:
        raise ValueError(
            f"Unknown mesh axis name(s) {sorted(unknown)}; valid axes are "
            f"{list(CANONICAL_AXIS_ORDER)} (alias: model -> tp)")
    sizes = {a: int(axis_sizes.get(a, 1)) for a in CANONICAL_AXIS_ORDER}
    fill_axes = [a for a, s in sizes.items() if s == -1]
    if len(fill_axes) > 1:
        raise ValueError(
            f"At most one mesh axis may be -1 (fill); got {fill_axes}")
    fixed = int(np.prod([s for s in sizes.values() if s != -1]))
    if fill_axes:
        if n_devices % fixed != 0:
            raise ValueError(
                f"Device count {n_devices} not divisible by fixed axes "
                f"product {fixed}")
        sizes[fill_axes[0]] = n_devices // fixed
    total = int(np.prod(list(sizes.values())))
    if total != n_devices:
        raise ValueError(
            f"Mesh axis sizes {sizes} multiply to {total}, but {n_devices} "
            "devices are present")
    return sizes


def check_ported_axes(axis_sizes: Dict[str, int]):
    """Raise for an axis this port does not run yet."""
    for axis, where in UNPORTED_AXES.items():
        if int(axis_sizes.get(axis, 1)) > 1:
            raise NotImplementedError(
                f"mesh axis {axis!r} of size {axis_sizes[axis]} is not "
                f"ported yet: it comes with {where} of the PyTorch port")


def dcn_factors(sizes: Dict[str, int],
                dcn_axis_sizes: Optional[Dict[str, int]]) -> Dict[str, int]:
    """Each canonical axis's dcn factor (1 where none is given), with the
    JAX mesh's errors: an unknown axis, a factor below 1, a size the
    factor does not divide."""
    dcn_axis_sizes = normalize_axis_dict(dcn_axis_sizes or {})
    unknown = set(dcn_axis_sizes) - set(CANONICAL_AXIS_ORDER)
    if unknown:
        raise ValueError(
            f"unknown dcn axis names {sorted(unknown)}; valid axes: "
            f"{list(CANONICAL_AXIS_ORDER)}")
    bad = {a: v for a, v in dcn_axis_sizes.items() if int(v) < 1}
    if bad:
        raise ValueError(f"dcn factors must be >= 1; got {bad}")
    dcn = {a: int(dcn_axis_sizes.get(a, 1)) for a in CANONICAL_AXIS_ORDER}
    if any(v > 1 for v in dcn.values()):
        for a in CANONICAL_AXIS_ORDER:
            if sizes[a] % dcn[a] != 0:
                raise ValueError(
                    f"mesh axis {a!r} size {sizes[a]} not divisible by its "
                    f"dcn factor {dcn[a]}")
    return dcn


def _dcn_major_mapping(topology: "ProcessTopology", sizes, dcn):
    """coordinate -> rank with the dcn factors outermost: along each axis
    ``coord = dcn_index * ici + ici_index``, and the rank is the dcn
    indices' row-major index times the ranks a node, plus the ici
    indices' row-major index within the node."""
    ici = [sizes[a] // dcn[a] for a in CANONICAL_AXIS_ORDER]
    dcn_dims = [dcn[a] for a in CANONICAL_AXIS_ORDER]
    per_node = int(np.prod(ici))
    mapping = {}
    for coord in topology.mapping:
        node = int(np.ravel_multi_index(
            [c // i for c, i in zip(coord, ici)], dcn_dims))
        local = int(np.ravel_multi_index(
            [c % i for c, i in zip(coord, ici)], ici))
        mapping[coord] = node * per_node + local
    local_world = os.environ.get("LOCAL_WORLD_SIZE")
    if local_world is not None and int(local_world) != per_node:
        raise ValueError(
            f"mesh.dcn {dcn} puts {per_node} ranks on a node (the axes' "
            f"ici factors), but LOCAL_WORLD_SIZE is {local_world}: the "
            f"declared dcn layout would cross nodes on ici axes")
    return mapping


def _active_subsets(active: Sequence[str]):
    """Every subset of the active axes, in one order for every rank."""
    for k in range(len(active) + 1):
        yield from itertools.combinations(active, k)


class MeshTopology:
    """Named-axis topology of the job: one rank per process, ranks in
    row-major canonical axis order (dcn-major under ``dcn_axis_sizes``,
    module docstring).

    ``world_size`` and ``rank`` default to the running process group's
    (1 and 0 without one); pass them to compute coordinates and comm
    lists with no process group. The groups exist only while a process
    group runs, and are built here, on every rank in one order; a mesh of
    one rank (``world_size=1``) under a larger group is this rank alone,
    with no groups.
    """

    def __init__(self, axis_sizes: Optional[Dict[str, int]] = None,
                 world_size: Optional[int] = None,
                 rank: Optional[int] = None,
                 dcn_axis_sizes: Optional[Dict[str, int]] = None):
        import torch.distributed as dist

        running = dist.is_available() and dist.is_initialized()
        if world_size is None:
            world_size = dist.get_world_size() if running else 1
        if rank is None:
            rank = dist.get_rank() if running else 0
        axis_sizes = dict(axis_sizes or {})
        axis_sizes.setdefault(AXIS_DATA, -1)
        sizes = _normalize_axis_sizes(axis_sizes, int(world_size))
        check_ported_axes(sizes)
        self.axis_sizes = sizes
        self.dcn_axis_sizes = dcn_factors(sizes, dcn_axis_sizes)
        self.rank = int(rank)
        self.topology = ProcessTopology(
            axes=list(CANONICAL_AXIS_ORDER),
            dims=[sizes[a] for a in CANONICAL_AXIS_ORDER])
        if any(v > 1 for v in self.dcn_axis_sizes.values()):
            self.topology.mapping = _dcn_major_mapping(
                self.topology, sizes, self.dcn_axis_sizes)
        self.coord = self.topology.get_coord(self.rank)
        # axis subset (canonical order, size > 1 axes only) -> this rank's
        # process group over it
        self._groups = {}
        if running and dist.get_world_size() == self.world_size:
            self._build_groups(dist)
        elif running and self.world_size != 1:
            raise ValueError(
                f"mesh {self.shape} spans {self.world_size} ranks but "
                f"the process group has {dist.get_world_size()}")

    def _build_groups(self, dist):
        world = list(range(self.world_size))
        for subset in _active_subsets(self.active_axes):
            mine = None
            for ranks in self.comm_lists(subset):
                pg = (dist.group.WORLD if ranks == world
                      else dist.new_group(ranks))
                if self.rank in ranks:
                    mine = pg
            self._groups[subset] = mine

    # ------------------------------------------------------------------
    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size (``jax.sharding.Mesh.shape``'s mapping)."""
        return dict(self.axis_sizes)

    @property
    def active_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in CANONICAL_AXIS_ORDER
                     if self.axis_sizes[a] > 1)

    @property
    def world_size(self) -> int:
        return self.topology.world_size

    def axis_size(self, axis) -> int:
        """Size of one axis, or the product over a tuple of axes."""
        if isinstance(axis, str):
            return self.axis_sizes.get(AXIS_ALIASES.get(axis, axis), 1)
        return int(np.prod([self.axis_size(a) for a in axis]))

    def _subset(self, axes) -> Tuple[str, ...]:
        if isinstance(axes, str):
            axes = (axes,)
        axes = {AXIS_ALIASES.get(a, a) for a in axes}
        unknown = axes - set(CANONICAL_AXIS_ORDER)
        if unknown:
            raise ValueError(f"unknown mesh axis name(s) {sorted(unknown)}")
        return tuple(a for a in self.active_axes if a in axes)

    def comm_lists(self, axes) -> List[List[int]]:
        """The rank lists that communicate over ``axes`` together: ranks
        whose coordinates agree on every other axis, in rank order."""
        axes = self._subset(axes)
        others = [a for a in CANONICAL_AXIS_ORDER if a not in axes]
        lists = []
        for combo in itertools.product(
                *(range(self.axis_sizes[a]) for a in others)):
            lists.append(self.topology.filter_match(**dict(zip(others,
                                                                combo))))
        return lists

    def group_ranks(self, axes) -> List[int]:
        """This rank's comm list over ``axes``."""
        return next(r for r in self.comm_lists(axes) if self.rank in r)

    def group(self, axes):
        """This rank's process group over an axis name or a tuple of axis
        names (axes of size 1 add nothing; none active: this rank alone)."""
        if not self._groups:
            raise RuntimeError(
                "MeshTopology has no process groups: call "
                "deepspeed_tpu_torch.comm.init_distributed() before "
                "building it")
        return self._groups[self._subset(axes)]

    # ------------------------------------------------------------------
    # group-query API (reference deepspeed/utils/groups.py surface)
    def get_data_parallel_world_size(self) -> int:
        """Batch-parallel world: data x expert (fsdp shards weights and
        optimizer state, never the batch)."""
        return self.axis_sizes[AXIS_DATA] * self.axis_sizes[AXIS_EXPERT]

    def get_model_parallel_world_size(self) -> int:
        return self.axis_sizes[AXIS_TP]

    def get_tensor_parallel_world_size(self) -> int:
        return self.axis_sizes[AXIS_TP]

    def get_tensor_parallel_rank(self) -> int:
        """This rank's index along the tp axis (its rank in the tp
        group)."""
        return int(getattr(self.coord, AXIS_TP))

    def get_model_parallel_rank(self) -> int:
        return self.get_tensor_parallel_rank()

    def get_fsdp_world_size(self) -> int:
        return self.axis_sizes[AXIS_FSDP]

    def get_pipe_parallel_world_size(self) -> int:
        return self.axis_sizes[AXIS_PIPE]

    def get_expert_parallel_world_size(self) -> int:
        return self.axis_sizes[AXIS_EXPERT]

    def get_sequence_parallel_world_size(self) -> int:
        return self.axis_sizes[AXIS_SEQ]

    def get_slice_parallel_world_size(self) -> int:
        return self.get_model_parallel_world_size()

    def get_data_parallel_group(self):
        """Batch and gradient math span data x expert."""
        return self.group((AXIS_DATA, AXIS_EXPERT))

    def get_fsdp_group(self):
        return self.group(AXIS_FSDP)

    def get_model_parallel_group(self):
        return self.group(AXIS_TP)

    def get_tensor_parallel_group(self):
        return self.group(AXIS_TP)

    def get_pipe_parallel_group(self):
        return self.group(AXIS_PIPE)

    def get_expert_parallel_group(self):
        return self.group(AXIS_EXPERT)

    def get_sequence_parallel_group(self):
        return self.group(AXIS_SEQ)

    def __repr__(self):
        live = {a: s for a, s in self.axis_sizes.items() if s > 1}
        return (f"MeshTopology({live or {AXIS_DATA: 1}}, "
                f"world_size={self.world_size})")


def resolve_axis_name(mesh, axis: str) -> str:
    """The name ``axis`` goes by on this mesh: the port's meshes carry the
    canonical names, so an alias resolves to its canonical axis."""
    names = tuple(getattr(mesh, "shape", {}) or ())
    if axis in names:
        return axis
    return AXIS_ALIASES.get(axis, axis)


def axis_spec_entry(mesh, axes: Sequence[str],
                    dim_size: Optional[int] = None):
    """One PartitionSpec entry sharding a dim over the active subset of
    ``axes``: None when no axis is active or ``dim_size`` is not
    divisible by their product."""
    shape = mesh.shape
    active = tuple(a for a in axes if shape.get(a, 1) > 1)
    if not active:
        return None
    size = int(np.prod([shape[a] for a in active]))
    if dim_size is not None and dim_size % size != 0:
        return None
    return active if len(active) > 1 else active[0]


# ----------------------------------------------------------------------
# the job's topology (reference deepspeed/utils/groups.py module state)
_WORLD_TOPOLOGY: Optional[MeshTopology] = None


def set_topology(topo: MeshTopology):
    global _WORLD_TOPOLOGY
    if _WORLD_TOPOLOGY is not None and _WORLD_TOPOLOGY is not topo:
        logger.info(f"Replacing global mesh topology with {topo}")
    _WORLD_TOPOLOGY = topo


def get_topology(create_if_missing: bool = True) -> Optional[MeshTopology]:
    global _WORLD_TOPOLOGY
    if _WORLD_TOPOLOGY is None and create_if_missing:
        _WORLD_TOPOLOGY = MeshTopology()
    return _WORLD_TOPOLOGY


def reset_topology():
    global _WORLD_TOPOLOGY
    _WORLD_TOPOLOGY = None


def rank_local_mesh() -> MeshTopology:
    """A mesh of this rank alone, whatever the running world: no groups,
    no collective. The one explicit way to ask for a rank-local
    inference engine while a process group is up
    (``init_inference(..., mesh=rank_local_mesh())``): the serving
    fleet's one-process replicas are built so."""
    return MeshTopology(axis_sizes={AXIS_DATA: 1}, world_size=1, rank=0)


def resolve_tp_topology(tp_size: int) -> MeshTopology:
    """The serving engines' mesh (reference ``_create_model_parallel_
    group``, JAX ``MeshTopology(axis_sizes={"tp": tp_size})``): the job's
    topology when its tp axis already has ``tp_size`` ranks, else a
    ``{"tp": tp_size}`` mesh over the whole world, made the job's. The
    ranks the tp axis leaves fill ``data`` (``data = world / tp_size``):
    tp groups are contiguous ranks, data groups strided, the order of the
    training mesh. A world that ``tp_size`` does not divide raises the
    JAX mesh's error.

    One process per rank: above 1, a process group must run
    (``comm.init_distributed``), since every tp rank holds one shard. At
    ``tp_size`` 1 with no group the mesh is this rank alone; under a
    group of W ranks it is ``data = W``, as in JAX (a rank-local engine
    asks for :func:`rank_local_mesh`)."""
    import torch.distributed as dist

    tp_size = int(tp_size)
    if tp_size > 1 and not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"tensor_parallel.tp_size {tp_size} needs a process group "
            f"of {tp_size} ranks, one a shard: call deepspeed_tpu_torch"
            f".comm.init_distributed() on every rank first")
    existing = get_topology(create_if_missing=False)
    if existing is not None and existing.axis_size(AXIS_TP) == tp_size:
        return existing
    topo = MeshTopology(axis_sizes={AXIS_TP: tp_size})
    set_topology(topo)
    return topo
