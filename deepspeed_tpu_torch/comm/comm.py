"""deepspeed_tpu_torch.comm: the communication facade over
``torch.distributed`` (counterpart of ``deepspeed_tpu/comm/comm.py``).

The JAX package has one controller driving every device: its collectives
are traced ``lax`` ops bound to mesh axis names, and ``get_rank()`` is the
HOST's rank. The port runs one process per device (one card, or one CPU
rank under gloo), so ``get_rank()`` is the device's rank and every
collective is a ``torch.distributed`` call that each rank of the group
makes. What a caller sees stays the same:

- ``group=`` is a mesh axis name, a tuple of axis names (resolved through
  the job's :class:`~deepspeed_tpu_torch.parallel.topology.MeshTopology`,
  as JAX's ``_resolve_group``), a ``ProcessGroup``, or None for the world;
- ``all_gather``, ``reduce_scatter`` and ``all_to_all_single`` take the
  JAX arguments (``axis``/``tiled``, ``split_axis``/``concat_axis``) and
  return new tensors; ``all_reduce``, ``broadcast``, ``reduce`` and
  ``scatter`` work in place, as ``torch.distributed`` does, and return the
  tensor;
- ``src``/``dst``/``perm`` indices are ranks WITHIN the group (mesh
  indices along the group's axes), as in JAX;
- ``ReduceOp.AVG`` is a sum divided by the group's size on every backend.

The gather and scatter collectives use the list forms
(``torch.distributed.all_gather`` / ``reduce_scatter``), which every
supported torch version has without a deprecation.

``counts`` tallies each collective launched, by name (``chip_smoke.py``
holds a ZeRO step's counts to its plan). The comms logger
(:data:`comms_logger`, ``configure``, ``log_summary``; the
``comms_logger`` config section) records each op's size, latency and
bandwidth when enabled (``@timed_op``; off, a wrapped op costs one
attribute read). The compressed collectives (``quantized_all_reduce``,
``onebit_all_reduce``) come with the compressed-collectives slice and
raise.
"""

import collections
import contextlib
import datetime
import functools
import inspect
import os
import threading
import time
from enum import Enum
from typing import Optional, Sequence, Union

import torch

from deepspeed_tpu_torch.comm.backend import TorchBackend
from deepspeed_tpu_torch.utils.comms_logging import CommsLogger
from deepspeed_tpu_torch.utils.logging import logger

Group = Union[None, str, Sequence[str], "torch.distributed.ProcessGroup"]

_COMPRESSED = "the compressed-collectives slice ([9])"


class ReduceOp(Enum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    BAND = 4
    BOR = 5
    BXOR = 6
    AVG = 7
    UNUSED = 8


_backend: Optional[TorchBackend] = None
# collectives launched, by name
counts = collections.Counter()


def reset_counts():
    counts.clear()


comms_logger = CommsLogger()
_in_op = threading.local()
# {op: {"count", "operand_bytes"}} of the collectives launched while a
# tally() is open (telemetry's step cost), else None
_tally = None


@contextlib.contextmanager
def tally():
    """Count the logged collectives launched inside the block and their
    operand bytes, by op: ``{op: {"count", "operand_bytes"}}``."""
    global _tally
    prev, _tally = _tally, {}
    try:
        yield _tally
    finally:
        _tally = prev


def timed_op(func):
    """Reference ``@timed_op`` (``comm/comm.py:111``): when the comms
    logger is enabled and profiles this op (``prof_all``, the call's
    ``prof`` or its ``log_name`` in ``prof_ops``), record its message
    size, group size and latency. The latency of a CUDA tensor's op is
    timed with CUDA events (waited on: the logger's one sync); on the
    CPU with the host clock. An op called inside another logged op is
    not recorded twice."""
    sig = inspect.signature(func)

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if (_tally is None and not comms_logger.enabled) or \
                getattr(_in_op, "active", False):
            return func(*args, **kwargs)
        bound = sig.bind_partial(*args, **kwargs).arguments
        tensor = bound.get("tensor")
        if tensor is None:
            tensor = bound.get("output_tensor")
        size = (tensor.numel() * tensor.element_size()
                if isinstance(tensor, torch.Tensor) else 0)
        if _tally is not None:
            entry = _tally.setdefault(func.__name__,
                                      {"count": 0, "operand_bytes": 0})
            entry["count"] += 1
            entry["operand_bytes"] += size
        log_name = bound.get("log_name", func.__name__)
        if not comms_logger.enabled or not (
                comms_logger.prof_all or bound.get("prof", False)
                or log_name in comms_logger.prof_ops):
            _in_op.active = True
            try:
                return func(*args, **kwargs)
            finally:
                _in_op.active = False
        n = _size(_resolve_group(bound.get("group"))) if is_initialized() \
            else 1
        cuda = isinstance(tensor, torch.Tensor) and tensor.is_cuda
        _in_op.active = True
        try:
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                result = func(*args, **kwargs)
                end.record()
                end.synchronize()
                latency = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                result = func(*args, **kwargs)
                latency = time.perf_counter() - t0
        finally:
            _in_op.active = False
        comms_logger.append(func.__name__, log_name, latency, size, n)
        return result

    return wrapper


def _dist():
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no process group: call deepspeed_tpu_torch.comm."
            "init_distributed() first")
    return dist


def _torch_op(op: ReduceOp):
    import torch.distributed as dist

    ops = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
           ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
           ReduceOp.MIN: dist.ReduceOp.MIN, ReduceOp.MAX: dist.ReduceOp.MAX,
           ReduceOp.BAND: dist.ReduceOp.BAND, ReduceOp.BOR: dist.ReduceOp.BOR,
           ReduceOp.BXOR: dist.ReduceOp.BXOR}
    if op not in ops:
        raise NotImplementedError(f"ReduceOp {op} is not supported")
    return ops[op]


def _resolve_group(group: Group):
    """A ProcessGroup: the world for None, the topology's group for an
    axis name or a tuple of them, else ``group`` itself."""
    dist = _dist()
    if group is None:
        return dist.group.WORLD
    if isinstance(group, str) or (isinstance(group, (tuple, list))
                                  and all(isinstance(a, str) for a in group)):
        from deepspeed_tpu_torch.parallel import topology as topo

        t = topo.get_topology(create_if_missing=False)
        if t is None:
            raise ValueError(
                f"comm op with group={group!r} and no mesh topology set: "
                "pass a ProcessGroup, or call set_topology() / "
                "deepspeed_tpu_torch.initialize(mesh=...) first")
        return t.group(group)
    return group


def _size(pg) -> int:
    return _dist().get_world_size(pg)


def _global(pg, group_rank: int) -> int:
    """Global rank of ``group_rank`` in ``pg``."""
    dist = _dist()
    if pg is None or pg is dist.group.WORLD:
        return int(group_rank)
    return dist.get_global_rank(pg, int(group_rank))


# ----------------------------------------------------------------------
# init / identity
_SCHEDULER_ENV_KEYS = (
    # (rank, size) pairs per launcher family, most specific first
    ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"),   # OpenMPI
    ("MV2_COMM_WORLD_RANK", "MV2_COMM_WORLD_SIZE"),     # MVAPICH2
    ("PMI_RANK", "PMI_SIZE"),                           # MVAPICH/Hydra/PMI
    ("SLURM_PROCID", "SLURM_NTASKS"),                   # srun
)


def mpi_discovery(distributed_port=29500, verbose=True) -> bool:
    """Map a scheduler-launched process's identity into the
    RANK/WORLD_SIZE/LOCAL_RANK/MASTER_ADDR/MASTER_PORT environment (the
    JAX package's version, with no mpi4py). Returns True when a
    scheduler's environment was found."""
    env = os.environ
    for rank_key, size_key in _SCHEDULER_ENV_KEYS:
        if rank_key in env and size_key in env:
            rank, size = int(env[rank_key]), int(env[size_key])
            break
    else:
        return False
    env.setdefault("RANK", str(rank))
    env.setdefault("WORLD_SIZE", str(size))
    local = env.get("OMPI_COMM_WORLD_LOCAL_RANK",
                    env.get("MV2_COMM_WORLD_LOCAL_RANK",
                            env.get("SLURM_LOCALID", "0")))
    env.setdefault("LOCAL_RANK", local)
    if "MASTER_ADDR" not in env:
        addr = env.get("SLURM_LAUNCH_NODE_IPADDR")
        if addr is None and "SLURM_JOB_NODELIST" in env:
            nodelist = env["SLURM_JOB_NODELIST"]
            if not any(c in nodelist for c in "[],"):
                addr = nodelist
        if addr:
            env["MASTER_ADDR"] = addr
    env.setdefault("MASTER_PORT", str(distributed_port))
    if verbose:
        logger.info(
            f"mpi_discovery: rank={rank} world_size={size} "
            f"local_rank={local} master={env.get('MASTER_ADDR')}:"
            f"{env['MASTER_PORT']}")
    return True


def device_backend(dist_backend="xla", device=None) -> str:
    """The process-group backend: ``"xla"`` (the JAX package's default)
    or None means the device's own, NCCL for the card (``device=None``)
    and gloo for ``device="cpu"``."""
    if dist_backend not in (None, "xla"):
        return dist_backend
    return "gloo" if torch.device(device or "cuda").type == "cpu" \
        else "nccl"


def init_distributed(dist_backend="xla",
                     auto_mpi_discovery=True,
                     distributed_port=29500,
                     verbose=True,
                     timeout=None,
                     init_method=None,
                     dist_init_required=None,
                     config=None,
                     rank=-1,
                     world_size=-1,
                     device=None):
    """Start the job's process group (reference ``comm/comm.py:598``).

    Rank and world size come from ``rank``/``world_size``, else from
    ``RANK``/``WORLD_SIZE`` (a scheduler's through :func:`mpi_discovery`),
    else 0 and 1. The rendezvous is ``init_method`` (``tcp://`` or
    ``file://``), else ``MASTER_ADDR``/``MASTER_PORT``; a world of one
    with neither runs on an in-process store. On the card the backend is
    NCCL and ``torch.cuda.set_device(LOCAL_RANK)`` runs first; on the CPU
    (``device="cpu"``) gloo. Idempotent: a running process group is kept.
    """
    global _backend
    import torch.distributed as dist

    if dist.is_initialized():
        if _backend is None:
            _backend = TorchBackend()
        return _backend
    if (auto_mpi_discovery and "WORLD_SIZE" not in os.environ
            and world_size <= 0):
        mpi_discovery(distributed_port=distributed_port, verbose=verbose)
    n_procs = world_size if world_size > 0 else int(
        os.environ.get("WORLD_SIZE", 1))
    proc_id = rank if rank >= 0 else int(os.environ.get("RANK", 0))
    backend = device_backend(dist_backend, device)
    if backend == "nccl":
        from deepspeed_tpu_torch.accelerator import resolve_device

        resolve_device("cuda")  # raises without a card
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kwargs = {"backend": backend, "rank": proc_id, "world_size": n_procs}
    if timeout is not None:
        kwargs["timeout"] = (timeout if isinstance(timeout,
                                                   datetime.timedelta)
                             else datetime.timedelta(seconds=timeout))
    if init_method is None and "MASTER_ADDR" in os.environ:
        port = os.environ.get("MASTER_PORT", str(distributed_port))
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{port}"
    if init_method is not None:
        kwargs["init_method"] = init_method
    elif n_procs == 1:
        kwargs["store"] = dist.HashStore()
    else:
        raise RuntimeError(
            f"init_distributed: {n_procs} processes requested but no "
            "rendezvous (pass init_method= or set MASTER_ADDR)")
    dist.init_process_group(**kwargs)
    _backend = TorchBackend()
    if verbose:
        logger.info(f"Initialized torch.distributed ({backend}): rank "
                    f"{dist.get_rank()} of {dist.get_world_size()}")
    return _backend


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def destroy_process_group():
    """End the process group, and the topology whose groups it held."""
    global _backend
    import torch.distributed as dist

    from deepspeed_tpu_torch.parallel import topology as topo

    if dist.is_initialized():
        dist.destroy_process_group()
    _backend = None
    topo.reset_topology()


def get_rank(group: Group = None) -> int:
    """This DEVICE's rank (one process per device): in the world, or
    within ``group``. 0 without a process group."""
    if not is_initialized():
        return 0
    return _dist().get_rank(_resolve_group(group))


def get_world_size(group: Group = None) -> int:
    """Ranks in ``group`` (the world for None); without a process group,
    the topology's world, else 1."""
    if not is_initialized():
        from deepspeed_tpu_torch.parallel import topology as topo

        t = topo.get_topology(create_if_missing=False)
        if group is None or t is None:
            return t.world_size if t is not None else 1
        return t.axis_size(group)
    return _size(_resolve_group(group))


def get_local_rank(group: Group = None) -> int:
    """Rank within the host (``LOCAL_RANK``): the card this process
    drives."""
    return int(os.environ.get("LOCAL_RANK", 0))


def get_global_rank(group: Group = None, group_rank: int = 0) -> int:
    if not is_initialized():
        return group_rank
    return _global(_resolve_group(group), group_rank)


def get_all_ranks_from_group(group: Group = None):
    if not is_initialized():
        return list(range(get_world_size(group)))
    return _dist().get_process_group_ranks(_resolve_group(group))


# ----------------------------------------------------------------------
# collectives
@timed_op
def all_reduce(tensor, op=ReduceOp.SUM, group: Group = None, async_op=False,
               prof=False, log_name="all_reduce", debug=None):
    """Reduce ``tensor`` over the group IN PLACE and return it (the work
    handle with ``async_op``, except for AVG, whose division follows)."""
    dist = _dist()
    pg = _resolve_group(group)
    counts["all_reduce"] += 1
    work = dist.all_reduce(tensor, op=_torch_op(op), group=pg,
                           async_op=async_op)
    if op == ReduceOp.AVG:
        if async_op:
            raise NotImplementedError("all_reduce(op=AVG, async_op=True)")
        tensor.div_(_size(pg))
    return work if async_op else tensor


def inference_all_reduce(tensor, op=ReduceOp.SUM, group: Group = None,
                         async_op=False, prof=False,
                         log_name="inference_all_reduce", debug=None):
    return all_reduce(tensor, op=op, group=group, async_op=async_op)


@timed_op
def all_gather(tensor, group: Group = None, async_op=False, prof=False,
               log_name="all_gather", debug=None, axis=0, tiled=False):
    """Every member's ``tensor`` stacked on a new ``axis``, or with
    ``tiled`` concatenated along ``axis`` (``lax.all_gather``'s
    semantics); returns a new tensor."""
    dist = _dist()
    pg = _resolve_group(group)
    n = _size(pg)
    x = tensor.movedim(axis, 0) if tiled else tensor
    x = x.contiguous()
    out = x.new_empty((n,) + tuple(x.shape))
    counts["all_gather"] += 1
    dist.all_gather(list(out.unbind(0)), x, group=pg)
    if tiled:
        return out.reshape((n * x.shape[0],) + tuple(x.shape[1:])) \
            .movedim(0, axis)
    return out.movedim(0, axis)


@timed_op
def all_gather_base(output_tensor=None, tensor=None, group: Group = None,
                    **kw):
    """Flat all-gather: the members' ``tensor`` concatenated along dim 0,
    written into ``output_tensor`` when given (its ``numel`` is the
    group's size times ``tensor``'s) and returned."""
    if tensor is None:
        tensor, output_tensor = output_tensor, None
    if output_tensor is None:
        return all_gather(tensor, group=group, tiled=True)
    dist = _dist()
    pg = _resolve_group(group)
    n = _size(pg)
    if output_tensor.numel() != n * tensor.numel():
        raise ValueError(f"all_gather_base: output of {output_tensor.numel()}"
                         f" elements for {n} x {tensor.numel()}")
    counts["all_gather"] += 1
    dist.all_gather(list(output_tensor.view(n, -1).unbind(0)),
                    tensor.contiguous().view(-1), group=pg)
    return output_tensor


def has_all_gather_into_tensor() -> bool:
    return True


def has_reduce_scatter_tensor() -> bool:
    return True


def has_allgather_base() -> bool:
    return True


def has_reduce_scatter_base() -> bool:
    return True


@timed_op
def reduce_scatter(tensor, op=ReduceOp.SUM, group: Group = None,
                   async_op=False, prof=False, log_name="reduce_scatter",
                   debug=None, axis=0, tiled=True, output=None):
    """Reduce over the group, then keep this member's shard of ``axis``
    (``lax.psum_scatter``: ``tiled`` keeps the axis at 1/n of its size,
    untiled drops it, which needs its size to be n). SUM or AVG.
    ``output`` receives the shard when given (``axis`` 0, tiled)."""
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise NotImplementedError(f"reduce_scatter with {op}")
    dist = _dist()
    pg = _resolve_group(group)
    n = _size(pg)
    x = tensor.movedim(axis, 0).contiguous()
    if x.shape[0] % n or (not tiled and x.shape[0] != n):
        raise ValueError(f"reduce_scatter: axis {axis} of size "
                         f"{x.shape[0]} over {n} members (tiled={tiled})")
    if output is None:
        output = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    counts["reduce_scatter"] += 1
    dist.reduce_scatter(output, list(x.chunk(n)), op=dist.ReduceOp.SUM,
                        group=pg)
    if op == ReduceOp.AVG:
        output.div_(n)
    out = output.movedim(0, axis)
    return out if tiled else out.squeeze(axis)


def reduce_scatter_base(tensor, group: Group = None, **kw):
    return reduce_scatter(tensor, group=group, tiled=True, **kw)


@timed_op
def all_to_all_single(tensor, group: Group = None, async_op=False,
                      prof=False, log_name="all_to_all_single", debug=None,
                      split_axis=0, concat_axis=0):
    """All-to-all over the group (``lax.all_to_all``, tiled): chunk i of
    ``split_axis`` goes to member i, and the chunks received are
    concatenated along ``concat_axis`` in member order."""
    dist = _dist()
    pg = _resolve_group(group)
    n = _size(pg)
    x = tensor.movedim(split_axis, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"all_to_all_single: axis {split_axis} of size "
                         f"{x.shape[0]} over {n} members")
    out = torch.empty_like(x)
    counts["all_to_all"] += 1
    dist.all_to_all_single(out, x, group=pg)
    pieces = out.view((n, x.shape[0] // n) + tuple(x.shape[1:])) \
        .movedim(1, split_axis + 1)
    return torch.cat(list(pieces.unbind(0)), dim=concat_axis)


all_to_all = all_to_all_single


@timed_op
def broadcast(tensor, src: int = 0, group: Group = None, async_op=False,
              prof=False, log_name="broadcast", debug=None):
    """``tensor`` of group member ``src`` on every member, in place."""
    dist = _dist()
    pg = _resolve_group(group)
    counts["broadcast"] += 1
    work = dist.broadcast(tensor, src=_global(pg, src), group=pg,
                          async_op=async_op)
    return work if async_op else tensor


@timed_op
def reduce(tensor, dst: int = 0, op=ReduceOp.SUM, group: Group = None,
           async_op=False, prof=False, log_name="reduce", debug=None):
    """Reduce onto group member ``dst`` (in place there; other members'
    ``tensor`` is left unspecified, as in ``torch.distributed``)."""
    dist = _dist()
    pg = _resolve_group(group)
    counts["reduce"] += 1
    dist.reduce(tensor, dst=_global(pg, dst), op=_torch_op(op), group=pg)
    if op == ReduceOp.AVG and dist.get_rank(pg) == dst:
        tensor.div_(_size(pg))
    return tensor


@timed_op
def gather(tensor, gather_list=None, dst: int = 0, group: Group = None,
           **kw):
    """Every member's ``tensor`` stacked on group member ``dst`` (into
    ``gather_list`` when given); None on the other members."""
    dist = _dist()
    pg = _resolve_group(group)
    out = None
    if dist.get_rank(pg) == dst and gather_list is None:
        out = tensor.new_empty((_size(pg),) + tuple(tensor.shape))
        gather_list = list(out.unbind(0))
    counts["gather"] += 1
    dist.gather(tensor.contiguous(), gather_list=gather_list
                if dist.get_rank(pg) == dst else None,
                dst=_global(pg, dst), group=pg)
    if dist.get_rank(pg) != dst:
        return None
    return out if out is not None else gather_list


@timed_op
def scatter(tensor, scatter_list=None, src: int = 0, group: Group = None,
            **kw):
    """Group member ``src``'s ``scatter_list[i]`` into member i's
    ``tensor``, in place."""
    dist = _dist()
    pg = _resolve_group(group)
    counts["scatter"] += 1
    dist.scatter(tensor, scatter_list=scatter_list
                 if dist.get_rank(pg) == src else None,
                 src=_global(pg, src), group=pg)
    return tensor


@timed_op
def send(tensor, dst: int, group: Group = None, tag: int = 0):
    """Point-to-point send to group member ``dst``."""
    dist = _dist()
    pg = _resolve_group(group)
    counts["send"] += 1
    dist.send(tensor.contiguous(), dst=_global(pg, dst), group=pg, tag=tag)


@timed_op
def recv(tensor, src: int, group: Group = None, tag: int = 0):
    """Point-to-point receive from group member ``src`` into ``tensor``."""
    dist = _dist()
    pg = _resolve_group(group)
    counts["recv"] += 1
    dist.recv(tensor, src=_global(pg, src), group=pg, tag=tag)
    return tensor


def isend(tensor, dst: int, group: Group = None, tag: int = 0):
    dist = _dist()
    pg = _resolve_group(group)
    counts["send"] += 1
    return dist.isend(tensor.contiguous(), dst=_global(pg, dst), group=pg,
                      tag=tag)


def irecv(tensor, src: int, group: Group = None, tag: int = 0):
    dist = _dist()
    pg = _resolve_group(group)
    counts["recv"] += 1
    return dist.irecv(tensor, src=_global(pg, src), group=pg, tag=tag)


@timed_op
def ppermute(tensor, perm, group: Group = None, prof=False,
             log_name="ppermute", debug=None):
    """Collective permute (``lax.ppermute``): ``perm`` holds (src, dst)
    pairs of group members; each member returns what its source sent,
    zeros where none did. One ``batch_isend_irecv`` a call."""
    dist = _dist()
    pg = _resolve_group(group)
    me = dist.get_rank(pg)
    out = torch.zeros_like(tensor)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(tensor)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, tensor.contiguous(),
                                  _global(pg, dst), group=pg))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, _global(pg, src),
                                  group=pg))
    counts["ppermute"] += 1
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


@timed_op
def barrier(group: Group = None, async_op=False, device_ids=None):
    dist = _dist()
    counts["barrier"] += 1
    return dist.barrier(group=_resolve_group(group), async_op=async_op)


def monitored_barrier(group: Group = None, timeout=None,
                      wait_all_ranks=False):
    """A barrier that names the ranks that missed it (gloo); NCCL has no
    monitored barrier, so there it is a plain one."""
    dist = _dist()
    pg = _resolve_group(group)
    if dist.get_backend(pg) != "gloo":
        return barrier(group=pg)
    if timeout is not None and not isinstance(timeout, datetime.timedelta):
        timeout = datetime.timedelta(seconds=timeout)
    counts["barrier"] += 1
    return dist.monitored_barrier(group=pg, timeout=timeout,
                                  wait_all_ranks=wait_all_ranks)


# ----------------------------------------------------------------------
# later slices
def quantized_all_reduce(tensor, group: Group = None, comm_dtype="int8",
                         **kw):
    raise NotImplementedError(
        f"quantized_all_reduce is not ported yet: it comes with "
        f"{_COMPRESSED} of the PyTorch port")


def onebit_all_reduce(tensor, error, group: Group = None, **kw):
    raise NotImplementedError(
        f"onebit_all_reduce is not ported yet: it comes with {_COMPRESSED}"
        " of the PyTorch port")


def has_quantized_all_reduce() -> bool:
    """The compressed wire tiers are not ported yet."""
    return False


def configure(deepspeed_config=None, enabled=None, prof_all=None,
              prof_ops=None, verbose=None, debug=None):
    """Configure comms logging (reference ``comm/comm.py:137``): from a
    parsed config's ``comms_config`` (the ``comms_logger`` section), then
    the keyword overrides."""
    if deepspeed_config is not None:
        comms_logger.configure(deepspeed_config.comms_config)
    if enabled is not None:
        comms_logger.enabled = enabled
    if prof_all is not None:
        comms_logger.prof_all = prof_all
    if prof_ops is not None:
        comms_logger.prof_ops = prof_ops
    if verbose is not None:
        comms_logger.verbose = verbose
    if debug is not None:
        comms_logger.debug = debug


def log_summary(show_straggler=False):
    """Print (rank 0) and return the per-op table: count, total and mean
    latency, algorithmic and bus bandwidth, by message size."""
    return comms_logger.log_all(print_log=True,
                                show_straggler=show_straggler)
