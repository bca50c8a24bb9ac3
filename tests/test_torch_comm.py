"""The port's ``comm`` and topology against the JAX package's, on the CPU.

- ``ProcessTopology`` (and its pipe/model/data subclasses): coordinates,
  comm lists, ``filter_match`` and rank names equal the JAX classes';
- ``MeshTopology``: axis sizes (the -1 fill, the ``model`` alias), the
  rank <-> coordinate map, the data-parallel worlds and each axis
  subset's comm lists equal the JAX mesh's; bad products, unknown axes
  and conflicting aliases fail in both; the axes of later slices raise;
- every collective on 4 spawned gloo ranks (``tests/torch_ranks.py``) on a
  ``{"data": 2, "fsdp": 2}`` mesh, with ``group=`` None, an axis name and
  a tuple, against numpy: each ``ReduceOp``, gathers, reduce-scatters,
  all-to-all, broadcast, ``ppermute`` on a ring, rooted ops, send/recv;
  ``init_distributed`` is idempotent;
- the comms logger and the compressed collectives raise, naming their
  slices.
"""

import os

import jax
import numpy as np
import pytest

from deepspeed_tpu.parallel import topology as jax_topo
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.parallel import topology as port_topo
from tests import torch_ranks

TOPOLOGIES = [(["pipe", "data"], [2, 3]), (["pipe", "data", "model"],
                                            [2, 2, 2]),
              (["a", "b", "c"], [1, 3, 2]), (["x"], [5])]


@pytest.mark.parametrize("axes,dims", TOPOLOGIES,
                         ids=["-".join(map(str, d)) for _, d in TOPOLOGIES])
def test_process_topology_matches_jax(axes, dims):
    ours = port_topo.ProcessTopology(axes, dims)
    ref = jax_topo.ProcessTopology(axes, dims)
    assert ours.world_size == ref.world_size
    assert {tuple(k): v for k, v in ours.mapping.items()} == \
        {tuple(k): v for k, v in ref.mapping.items()}
    for rank in range(ref.world_size):
        assert tuple(ours.get_coord(rank)) == tuple(ref.get_coord(rank))
        assert ours.get_rank_repr(rank) == ref.get_rank_repr(rank)
        assert ours.get_rank_repr(rank, omit_axes=()) == \
            ref.get_rank_repr(rank, omit_axes=())
    for axis in axes + ["missing"]:
        assert ours.get_axis_comm_lists(axis) == \
            ref.get_axis_comm_lists(axis)
        assert ours.get_dim(axis) == ref.get_dim(axis)
        for i in range(ours.get_dim(axis)):
            assert ours.get_axis_list(axis, i) == ref.get_axis_list(axis, i)
    assert ours.filter_match(**{axes[0]: 0}) == ref.filter_match(
        **{axes[0]: 0})
    if len(axes) > 1:  # a slice is not a rank, in both
        for topo in (ours, ref):
            with pytest.raises(ValueError, match="slices"):
                topo.get_rank(**{axes[0]: 0})


def test_pipe_topologies_match_jax():
    for cls, args in (("PipeDataParallelTopology", (2, 3)),
                      ("PipeModelDataParallelTopology", (2, 2, 3))):
        ours = getattr(port_topo, cls)(*args)
        ref = getattr(jax_topo, cls)(*args)
        assert ours.get_axis_names() == ref.get_axis_names()
        assert [ours.get_axis_comm_lists(a) for a in ours.axes] == \
            [ref.get_axis_comm_lists(a) for a in ref.axes]


def _jax_mesh(sizes):
    return jax_topo.MeshTopology(axis_sizes=sizes, devices=jax.devices()[:4])


def _jax_comm_lists(mesh, axes):
    """Ranks agreeing on every axis outside ``axes`` (the JAX mesh's
    pure rank arithmetic)."""
    t = mesh.topology
    others = [a for a in t.axes if a not in axes]
    lists = {}
    for rank in range(t.world_size):
        c = t.get_coord(rank)
        lists.setdefault(tuple(getattr(c, a) for a in others), []).append(
            rank)
    return sorted(lists.values())


MESHES = [{"data": 4}, {"data": 2, "fsdp": 2}, {"fsdp": 2},
          {"data": -1, "fsdp": 4}, {"model": 1, "data": 4}]


@pytest.mark.parametrize("sizes", MESHES, ids=[str(m) for m in MESHES])
def test_mesh_topology_matches_jax(sizes):
    ref = _jax_mesh(sizes)
    for rank in range(4):
        ours = port_topo.MeshTopology(axis_sizes=sizes, world_size=4,
                                      rank=rank)
        assert ours.axis_sizes == ref.axis_sizes
        assert ours.world_size == ref.world_size == 4
        assert ours.topology.mapping.keys() == ref.topology.mapping.keys()
        assert ours.topology.mapping == ref.topology.mapping
        assert tuple(ours.coord) == tuple(ref.topology.get_coord(rank))
        for name in ("data_parallel", "model_parallel", "tensor_parallel",
                     "fsdp", "pipe_parallel", "expert_parallel",
                     "sequence_parallel", "slice_parallel"):
            method = f"get_{name}_world_size"
            assert getattr(ours, method)() == getattr(ref, method)(), method
        for axes in (("data",), ("fsdp",), ("data", "fsdp"),
                     ("data", "expert"), ()):
            assert sorted(ours.comm_lists(axes)) == \
                _jax_comm_lists(ref, axes), axes
            assert rank in ours.group_ranks(axes)
            assert ours.axis_size(axes) == int(np.prod(
                [ref.axis_size(a) for a in axes]))
        assert repr(ours) == repr(ref)


@pytest.mark.parametrize("sizes", [{"data": 3}, {"data": -1, "fsdp": -1},
                                   {"data": -1, "fsdp": 3}, {"rows": 4},
                                   {"model": 2, "tp": 4}],
                         ids=["product", "two-fills", "fill", "unknown",
                              "alias"])
def test_bad_meshes_fail_in_both(sizes):
    with pytest.raises(ValueError):
        _jax_mesh(sizes)
    with pytest.raises(ValueError):
        port_topo.MeshTopology(axis_sizes=sizes, world_size=4)


@pytest.mark.parametrize("sizes,where", [
    ({"data": 2, "tp": 2}, None), ({"data": 2, "model": 2}, None),
    ({"pipe": 2, "data": 2}, r"\[11\]"), ({"expert": 2, "data": 2},
                                          r"\[12.6\]"),
    ({"seq": 4}, r"\[12.7\]")], ids=["tp", "model", "pipe", "expert", "seq"])
def test_axes_of_later_slices_raise(sizes, where):
    """pipe / expert / seq raise in the mesh itself, naming their slices;
    tp (tensor-parallel serving and training) runs, as in JAX."""
    ref = _jax_mesh(sizes)  # the JAX package runs them
    if where is None:
        ours = port_topo.MeshTopology(axis_sizes=sizes, world_size=4,
                                      rank=3)
        assert ours.axis_sizes == ref.axis_sizes
        assert ours.get_tensor_parallel_world_size() == 2
        assert ours.get_tensor_parallel_rank() == \
            ref.topology.get_coord(3).tp
        port_topo.check_ported_axes(ours.axis_sizes)  # training takes it
        return
    with pytest.raises(NotImplementedError, match=where):
        port_topo.MeshTopology(axis_sizes=sizes, world_size=4)


def test_dcn_section_raises():
    """A dcn section raises only where JAX's mesh does (a factor that
    does not divide its axis); factors of 1 cross nothing."""
    with pytest.raises(ValueError, match="not divisible by its dcn"):
        port_topo.MeshTopology(axis_sizes={"data": 4}, world_size=4,
                               dcn_axis_sizes={"data": 3})
    for dcn in ({"data": 2}, {"data": 1}):
        port_topo.MeshTopology(axis_sizes={"data": 4}, world_size=4,
                               dcn_axis_sizes=dcn)


def test_groups_need_a_process_group():
    topo = port_topo.MeshTopology(axis_sizes={"data": 2}, world_size=2)
    with pytest.raises(RuntimeError, match="init_distributed"):
        topo.group("data")


def test_later_slices_raise_and_no_group_answers():
    """The comms logger is ported: configure / log_summary work (a
    non-list prof_ops fails the config as JAX's does); the compressed
    collectives still raise; no group answers the world of one."""
    import pydantic
    import deepspeed_tpu.runtime.config as jax_config
    from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

    port_topo.reset_topology()
    comm.configure(enabled=True, prof_ops=["all_reduce"], prof_all=False)
    try:
        assert comm.log_summary() == {}
    finally:
        comm.configure(enabled=False, prof_ops=[], prof_all=True)
    for make in (DeepSpeedConfig, jax_config.DeepSpeedConfig):
        with pytest.raises(pydantic.ValidationError, match="prof_ops"):
            make({"train_batch_size": 1, "comms_logger": {"prof_ops": 5}})
    with pytest.raises(NotImplementedError, match=r"compressed-collectives"):
        comm.quantized_all_reduce(np.zeros(4))
    with pytest.raises(NotImplementedError, match=r"compressed-collectives"):
        comm.onebit_all_reduce(np.zeros(4), np.zeros(4))
    assert not comm.has_quantized_all_reduce()
    assert comm.has_all_gather_into_tensor() and comm.has_allgather_base()
    assert comm.has_reduce_scatter_tensor() and comm.has_reduce_scatter_base()
    assert not comm.is_initialized()
    assert comm.get_rank() == 0 and comm.get_world_size() == 1
    with pytest.raises(RuntimeError, match="init_distributed"):
        comm.all_reduce(np.zeros(1))
    assert comm.device_backend("xla", "cpu") == "gloo"
    assert comm.device_backend(None, None) == "nccl"
    assert comm.device_backend("gloo", None) == "gloo"


def test_mpi_discovery_maps_the_scheduler_environment(monkeypatch):
    # a private copy of the environment: what mpi_discovery writes there
    # goes with it
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(OMPI_COMM_WORLD_RANK="3", OMPI_COMM_WORLD_SIZE="4",
               OMPI_COMM_WORLD_LOCAL_RANK="1")
    monkeypatch.setattr(os, "environ", env)
    assert comm.mpi_discovery(distributed_port=1234, verbose=False)
    assert (env["RANK"], env["WORLD_SIZE"], env["LOCAL_RANK"],
            env["MASTER_PORT"]) == ("3", "4", "1", "1234")


# ---------------------------------------------------------------------------
# the collectives on 4 gloo ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return torch_ranks.cached(
        tmp_path_factory, "collectives",
        lambda d: torch_ranks.run_ranks(torch_ranks.collectives, 4,
                                        d / "collectives"))


def x(rank):
    return np.arange(24, dtype=np.float32).reshape(4, 6) + 10 * rank


# data x fsdp = 2 x 2: rank = 2 * data + fsdp
GROUPS = {None: lambda r: [0, 1, 2, 3], "data": lambda r: [r % 2, r % 2 + 2],
          "fsdp": lambda r: [r - r % 2, r - r % 2 + 1],
          "data+fsdp": lambda r: [0, 1, 2, 3]}
REDUCE = {"SUM": np.sum, "AVG": np.mean, "MAX": np.max, "MIN": np.min,
          "PRODUCT": np.prod}


def test_init_distributed_is_idempotent(ranks):
    for rank, r in enumerate(ranks):
        assert r["idempotent"]
        assert (r["rank"], r["world"]) == (rank, 4)
        assert r["coord"] == (0, rank // 2, rank % 2, 0, 0, 0)


@pytest.mark.parametrize("group", list(GROUPS), ids=str)
def test_group_membership(ranks, group):
    for rank, r in enumerate(ranks):
        members = GROUPS[group](rank)
        assert r[f"ranks/{group}"] == members
        assert r[f"group_rank/{group}"] == members.index(rank)
        assert r[f"group_size/{group}"] == len(members)


@pytest.mark.parametrize("group,op", [(g, o) for g in GROUPS for o in REDUCE],
                         ids=[f"{g}-{o}" for g in GROUPS for o in REDUCE])
def test_all_reduce(ranks, group, op):
    for rank, r in enumerate(ranks):
        vals = np.stack([x(m) / 10 + 1 for m in GROUPS[group](rank)])
        np.testing.assert_allclose(r[f"all_reduce/{op}/{group}"],
                                   REDUCE[op](vals, axis=0), rtol=1e-6)


@pytest.mark.parametrize("group", list(GROUPS), ids=str)
def test_gathers_and_scatters(ranks, group):
    for rank, r in enumerate(ranks):
        members = GROUPS[group](rank)
        n, i = len(members), members.index(rank)
        xs = [x(m) for m in members]
        np.testing.assert_array_equal(r[f"all_gather/{group}"],
                                      np.stack(xs))
        np.testing.assert_array_equal(r[f"all_gather_tiled1/{group}"],
                                      np.concatenate(xs, axis=1))
        np.testing.assert_allclose(r[f"reduce_scatter/{group}"],
                                   np.split(sum(xs), n, axis=0)[i])
        np.testing.assert_allclose(
            r[f"reduce_scatter_avg1/{group}"],
            np.split(np.mean([v[:, :4] for v in xs], axis=0), n, axis=1)[i],
            rtol=1e-6)
        np.testing.assert_array_equal(
            r[f"all_to_all/{group}"],
            np.concatenate([np.split(v, n, axis=0)[i] for v in xs], axis=1))
        np.testing.assert_array_equal(r[f"broadcast/{group}"], xs[-1])


@pytest.mark.parametrize("group", list(GROUPS), ids=str)
def test_ppermute(ranks, group):
    for rank, r in enumerate(ranks):
        members = GROUPS[group](rank)
        n, i = len(members), members.index(rank)
        np.testing.assert_array_equal(r[f"ppermute_ring/{group}"],
                                      x(members[(i - 1) % n]))
        np.testing.assert_array_equal(
            r[f"ppermute_pair/{group}"],
            x(members[0]) if i == 1 else np.zeros((4, 6)))


def test_world_collectives(ranks):
    everyone = np.stack([x(m) for m in range(4)])
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["all_gather_base"], everyone.ravel())
        np.testing.assert_array_equal(r["reduce_scatter_untiled"],
                                      everyone.sum(0)[rank])
        np.testing.assert_array_equal(r["scatter"], x(3) + 100 * rank)
        np.testing.assert_array_equal(
            r["send_recv"], x(0) if rank == 3 else np.zeros((4, 6)))
    np.testing.assert_array_equal(ranks[2]["reduce"], everyone.sum(0))
    np.testing.assert_array_equal(ranks[1]["gather"], everyone)
    assert all(r["gather"] is None for i, r in enumerate(ranks) if i != 1)


def test_collectives_are_counted(ranks):
    for r in ranks:
        c = r["counts"]
        # + inference_all_reduce and reduce_gradients' two buckets; + the
        # untiled and the base reduce-scatter
        assert c["all_reduce"] == len(GROUPS) * len(REDUCE) + 3
        assert c["all_gather"] == 2 * len(GROUPS) + 1
        assert c["reduce_scatter"] == 2 * len(GROUPS) + 2
        assert c["ppermute"] == 2 * len(GROUPS)
        assert c["barrier"] == 2


def test_rank_to_rank_and_helpers(ranks):
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(
            r["isend_irecv"], x(1) if rank == 2 else np.zeros((4, 6)))
        fsdp = GROUPS["fsdp"](rank)
        np.testing.assert_array_equal(r["inference_all_reduce"],
                                      sum(x(m) for m in fsdp))
        data = GROUPS["data"](rank)
        np.testing.assert_array_equal(
            r["reduce_scatter_base"],
            np.split(sum(x(m) for m in data), 2)[data.index(rank)])
        # groups: the data-parallel group is data x expert
        assert r["groups"] == (2, data.index(rank), 1, 1, data)
        mean = np.mean([x(m) for m in data], axis=0)
        np.testing.assert_allclose(r["reduce_gradients"][0], mean[:2])
        np.testing.assert_allclose(r["reduce_gradients"][1], mean[2:])


def test_package_resolves_zero_and_comm():
    import deepspeed_tpu_torch

    assert deepspeed_tpu_torch.comm.all_reduce is comm.all_reduce
    assert deepspeed_tpu_torch.zero.GatheredParameters.__name__ == \
        "GatheredParameters"
    assert deepspeed_tpu_torch.init_distributed.__doc__
