"""Serving layer: continuous batching over a paged KV-cache block pool,
and the serving fleet in front of it (counterpart of
``deepspeed_tpu/serving``, exporting the same names).

- :class:`~deepspeed_tpu_torch.serving.engine.ServingEngine` — the device
  runtime on the card: bucketed prefill (the flash kernel), the
  fixed-slot decode step (the paged decode kernels), the fast path, and
  the migration seams;
- :class:`~deepspeed_tpu_torch.serving.scheduler.
  ContinuousBatchingScheduler`, :class:`~deepspeed_tpu_torch.serving.
  blocks.BlockManager`, :class:`~deepspeed_tpu_torch.serving.request.
  Request` — the host policy under it;
- :class:`~deepspeed_tpu_torch.serving.router.ReplicaRouter` +
  :class:`~deepspeed_tpu_torch.serving.health.ReplicaHealth` — N replicas
  behind one front door: health-aware routing, failover with
  deduplicated replay, the degradation ladder; :mod:`~deepspeed_tpu_torch.
  serving.migration` moves live KV state between replicas;
- the fleet tier — :class:`~deepspeed_tpu_torch.serving.router.
  FleetManager` over the :class:`~deepspeed_tpu_torch.serving.router.
  ReplicaFactory` seam, the SLO error-budget :mod:`~deepspeed_tpu_torch.
  serving.autoscaler`, :mod:`~deepspeed_tpu_torch.serving.replay` and
  :class:`~deepspeed_tpu_torch.serving.capacity.CapacityModel`;
- :class:`~deepspeed_tpu_torch.serving.gateway.ServingGateway` +
  :mod:`~deepspeed_tpu_torch.serving.tenancy` — the HTTP/SSE front door.

Every module but the engine is host code without torch; ``ServingEngine``
resolves on first touch (the engine imports the inference engine, whose
config imports this package).
"""

from deepspeed_tpu_torch.serving.autoscaler import Autoscaler, BudgetWindow
from deepspeed_tpu_torch.serving.blocks import BlockManager
from deepspeed_tpu_torch.serving.capacity import CapacityModel
from deepspeed_tpu_torch.serving.config import (FleetConfig, GatewayConfig,
                                                GatewayTenantConfig,
                                                MigrationConfig,
                                                ReplayConfig,
                                                RouterConfig, ServingConfig,
                                                SloClassConfig,
                                                SpeculativeConfig,
                                                bucket_for, resolve_buckets)
from deepspeed_tpu_torch.serving.gateway import ServingGateway
from deepspeed_tpu_torch.serving.health import (DEAD, DEGRADED, DRAINING,
                                                HEALTHY, TRIPPED,
                                                ReplicaHealth)
from deepspeed_tpu_torch.serving.migration import Migrator, resolve_migration
from deepspeed_tpu_torch.serving.prefix_cache import PrefixCache
from deepspeed_tpu_torch.serving.replay import (Arrival, HttpReplayDriver,
                                                ReplayClock, TraceReplayer,
                                                burst_trace, diurnal_trace,
                                                load_trace, save_trace,
                                                synthesize_trace)
from deepspeed_tpu_torch.serving.request import (FINISHED, QUEUED, RUNNING,
                                                 SHED, Request)
from deepspeed_tpu_torch.serving.router import (CallableReplicaFactory,
                                                FleetManager, ReplicaFactory,
                                                ReplicaRouter, RouterRequest)
from deepspeed_tpu_torch.serving.scheduler import \
    ContinuousBatchingScheduler
from deepspeed_tpu_torch.serving.spec_decode import (DraftModelProposer,
                                                     PromptLookupProposer,
                                                     Proposer,
                                                     build_proposer)
from deepspeed_tpu_torch.serving.tenancy import (Tenant, TenantTable,
                                                 TokenBucket)

__all__ = ["Arrival", "Autoscaler", "BlockManager", "BudgetWindow",
           "CallableReplicaFactory", "CapacityModel",
           "ContinuousBatchingScheduler",
           "DraftModelProposer", "FleetConfig", "FleetManager",
           "GatewayConfig", "GatewayTenantConfig", "HttpReplayDriver",
           "MigrationConfig", "Migrator", "resolve_migration",
           "PrefixCache", "PromptLookupProposer",
           "Proposer", "ReplayClock", "ReplayConfig", "ReplicaFactory",
           "ReplicaHealth",
           "ReplicaRouter", "Request", "RouterConfig", "RouterRequest",
           "ServingConfig", "ServingEngine", "ServingGateway",
           "SloClassConfig", "SpeculativeConfig",
           "Tenant", "TenantTable", "TokenBucket",
           "TraceReplayer", "bucket_for", "build_proposer", "burst_trace",
           "diurnal_trace", "load_trace", "resolve_buckets", "save_trace",
           "synthesize_trace",
           "QUEUED", "RUNNING", "FINISHED", "SHED",
           "HEALTHY", "DEGRADED", "TRIPPED", "DEAD", "DRAINING"]


def __getattr__(name):
    if name == "ServingEngine":
        from deepspeed_tpu_torch.serving.engine import ServingEngine

        return ServingEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
