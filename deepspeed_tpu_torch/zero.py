"""User-facing ``deepspeed_tpu_torch.zero`` namespace (counterpart of
``deepspeed_tpu/zero.py``, the reference ``deepspeed.zero``).

- :class:`Init`: partitions a model's parameters for ZeRO-3.
  ``Init(config_dict_or_path=ds_config).materialize(model)`` replaces
  each parameter that the stage splits by this rank's shard, on the
  host, and returns the model; ``initialize`` then keeps those shards.
  On a mesh with a ``tp`` axis the model is first cut to this rank's tp
  slice (its ``with_tensor_parallel``), a new model: use the one
  ``materialize`` returns.
  The model exists whole on the host first: the port's models draw their
  weights at construction, and the JAX package's jit-sharded init has no
  counterpart here. The context-manager form is kept so reference-shaped
  code runs; entering it partitions nothing.
- :class:`GatheredParameters`: the reference's torch form. Inside the
  block the given parameters are whole over the ZeRO axes (under tp,
  this rank's tp slice whole: the gathers run at its tp coordinate); on
  exit, with a ``modifier_rank``, that rank's values are broadcast and
  written back to every rank's shards (and the engine's fp32 masters);
  a tp slice is broadcast from the rank at ``modifier_rank``'s ZeRO
  coordinates and this rank's tp coordinate.
- :func:`register_external_parameter`: a no-op, as in the JAX package:
  the engine's gather units hold every parameter a block reads.
"""

from typing import Optional

import torch

from deepspeed_tpu_torch.runtime.zero.stage import (ZeroParamStatus,
                                                    shard_module)
from deepspeed_tpu_torch.utils.logging import logger


class Init:
    """Stage-3 partitioning of a built model (module docstring)."""

    def __init__(self, module=None, config_dict_or_path=None, mesh=None,
                 stage: int = 3, config=None, **unused):
        if config is not None and config_dict_or_path is None:
            config_dict_or_path = config  # the reference's older spelling
        self.config = config_dict_or_path
        self.stage = stage
        self._topo = mesh
        if unused:
            logger.warning(f"zero.Init: ignoring {sorted(unused)}")
        if module is not None:
            self.materialize(module)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _layout(self):
        from deepspeed_tpu_torch.parallel.topology import (MeshTopology,
                                                           get_topology)
        from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
        from deepspeed_tpu_torch.runtime.zero.partition import SpecLayout

        topo = self._topo
        if isinstance(topo, dict):
            topo = MeshTopology(axis_sizes=topo)
        if topo is None:
            topo = get_topology()
        config = DeepSpeedConfig(self.config)
        zc = config.zero_config
        return SpecLayout(topo,
                          policy=config.tensor_parallel_config.get(
                              "policy", "auto"),
                          persistence_threshold=zc.param_persistence_threshold,
                          hierarchical_gather=zc.hierarchical_gather)

    def materialize(self, model):
        """``model`` with every parameter the stage splits replaced by
        this rank's shard (on the host), cut to this rank's tp slice first
        on a ``tp`` mesh; returns it."""
        from deepspeed_tpu_torch.module_inject.layers import TensorParallel

        layout = self._layout()
        topo = layout.mesh
        if layout.tp_size > 1 and getattr(model, "tp", None) is None:
            model = model.with_tensor_parallel(
                TensorParallel(group=topo.get_tensor_parallel_group(),
                               size=layout.tp_size,
                               rank=topo.get_tensor_parallel_rank()),
                policy=layout.policy)
        params, _ = layout.shardings(model, self.stage)
        return shard_module(model, params)


class GatheredParameters:
    """Whole parameters inside the block (reference
    ``zero.GatheredParameters``)::

        with deepspeed_tpu_torch.zero.GatheredParameters(
                list(engine.module.parameters()), modifier_rank=0):
            if comm.get_rank() == 0:
                engine.module.model.wte[0] = 0.0

    ``params``: a parameter or an iterable of them. Stage-3 shards
    (parameters tagged by the engine or :class:`Init`) are gathered in
    place, the others are whole already. ``modifier_rank=None`` reads
    only; with a rank, that rank's values are broadcast on exit and
    re-sharded into every rank's shards and masters. Every rank must
    enter the block."""

    def __init__(self, params, modifier_rank: Optional[int] = None,
                 fwd_module=None, enabled: bool = True):
        del fwd_module
        if isinstance(params, torch.Tensor):
            params = [params]
        self.params = [p for p in params if p is not None]
        self.modifier_rank = modifier_rank
        self.enabled = enabled
        self._shards = {}

    def __enter__(self):
        if not self.enabled:
            return None
        from deepspeed_tpu_torch.runtime.zero.reduce import all_gather_flat

        for p in self.params:
            plan = getattr(p, "ds_plan", None)
            if plan is not None and plan.sharded:
                self._shards[id(p)] = p.data
                p.data = all_gather_flat([p.data], [plan])[0].contiguous()
                p.ds_status = ZeroParamStatus.AVAILABLE
        return None

    def __exit__(self, exc_type, exc, tb):
        if not self.enabled:
            return False
        from deepspeed_tpu_torch import comm as dist

        for p in self.params:
            plan = getattr(p, "ds_plan", None)
            if self.modifier_rank is not None and dist.is_initialized():
                dist.broadcast(p.data, *_modifier(plan, self.modifier_rank))
                master = getattr(p, "ds_master", None)
                if master is not None:
                    master.copy_(p.ds_opt_plan.local(p.data))
            if id(p) in self._shards:
                shard = self._shards.pop(id(p))
                if self.modifier_rank is not None:
                    shard.copy_(plan.local(p.data))
                p.data = shard
                p.ds_status = ZeroParamStatus.NOT_AVAILABLE
        return False


def _modifier(plan, modifier_rank):
    """``(src, group)`` of a modifier's broadcast: the world from
    ``modifier_rank``, or for a tp slice the ranks at this rank's tp
    coordinate, from the one at ``modifier_rank``'s other coordinates."""
    from deepspeed_tpu_torch.parallel.topology import (AXIS_TP,
                                                       get_topology)

    topo = get_topology(create_if_missing=False)
    if plan is None or not plan.tp_split or topo is None:
        return modifier_rank, None
    others = tuple(a for a in topo.active_axes if a != AXIS_TP)
    coord = topo.topology.get_coord(modifier_rank)._asdict()
    coord[AXIS_TP] = topo.get_tensor_parallel_rank()
    src = topo.topology.get_rank(**coord)
    return topo.group_ranks(others).index(src), topo.group(others)


def register_external_parameter(module, parameter) -> None:
    """A no-op kept for the reference's API (module docstring)."""
    del module, parameter


class ZeroParamType:
    NORMAL = 1
    PARTITIONED = 2
    REMOTE = 3


__all__ = ["GatheredParameters", "Init", "ZeroParamStatus", "ZeroParamType",
           "register_external_parameter"]
