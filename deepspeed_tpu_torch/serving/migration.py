"""Live KV-block migration: move a sequence's committed state between
replicas instead of replaying its work (copy of
``deepspeed_tpu/serving/migration.py``).

The paged pool makes this cheap to say and do: a sequence's KV is a set
of pool blocks named by its block table, so migration is a block-granular
transfer plus a table rewrite — ``ServingEngine.export_sequence`` gathers
the covered blocks' rows (every cache leaf: int8 side pools and their
scales ride the same indices), ``import_sequence`` allocates blocks on
the target, copies the rows onto exactly the pool rows every later
step addresses through the rewritten table, and splices the request
into a free slot mid-stream — NO prefill, counters intact, greedy
continuation equal to never having moved.

:class:`Migrator` is the host-side orchestrator (this module never
imports torch — the device work lives behind the engine seams) and the one
place the move is observed: a ``migrate`` span inside the request's
existing trace and the ``ds_migration_*`` metric family. Three consumers
sit above it:

- router failover — a tripped/stalled replica whose pool is still
  readable migrates its in-flight work instead of replaying it (and
  ``do_sample`` requests with a delivered prefix stop shedding, because
  their KV moves with them); a hard crash keeps the replay path;
- fleet drain — ``start_drain`` migrates in-flight work to survivors,
  demoting ``drain_timeout_steps`` from the plan to the fallback;
- rebalance — the fleet manager migrates work off the most fragmented
  replica when the ``kv_fragmentation`` gauge crosses the configured
  threshold.

Failure contract (chaos-proven): any fault between export and the
target's table commit leaves the source untouched and the target's
allocation released — the caller falls back to replay with exactly-once
delivery. The move is committed only when :meth:`Migrator.migrate`
returns a result.
"""

import time
from typing import Any, Dict, Optional

from deepspeed_tpu_torch.runtime.resilience.chaos import raise_if
from deepspeed_tpu_torch.serving.config import MigrationConfig
from deepspeed_tpu_torch.telemetry.registry import NULL_REGISTRY
from deepspeed_tpu_torch.telemetry.tracing import NULL_TRACER, to_ns

__all__ = ["Migrator", "resolve_migration"]


def resolve_migration(config) -> Optional[MigrationConfig]:
    """Normalize a ``serving.migration`` value (None / dict /
    :class:`MigrationConfig`) — None means migration does not exist and
    every consumer keeps its pre-migration behavior."""
    if config is None:
        return None
    if isinstance(config, MigrationConfig):
        return config
    return MigrationConfig(**dict(config))


class Migrator:
    """One migration primitive: ``export → transfer → import → detach``,
    observed as one ``migrate`` span and one ``ds_migration_attempts``
    sample per call. Host-only — both replicas' device work happens
    behind their own engine seams, so this object is safe to hold in the
    torch-free router/fleet layer."""

    #: attempt outcomes (the ``outcome`` label of
    #: ``ds_migration_attempts_total``); everything except ``ok`` also
    #: bumps ``ds_migration_fallbacks_total`` — the caller replays.
    OUTCOMES = ("ok", "no_surface", "export_none", "import_none", "error")

    def __init__(self, config=None, tracer=None, metrics=None,
                 clock=time.monotonic):
        self.config = resolve_migration(config)
        self._tracer = tracer if tracer is not None else NULL_TRACER
        self._metrics = metrics if metrics is not None else NULL_REGISTRY
        self.clock = clock

    # ---- consumer gates (config absent/disabled => everything off) ----
    @property
    def enabled(self) -> bool:
        return self.config is not None and self.config.enabled

    def allows(self, consumer: str) -> bool:
        """Whether ``consumer`` (``failover`` | ``drain`` |
        ``rebalance``) may migrate."""
        return self.enabled and bool(getattr(self.config, consumer, False))

    # ------------------------------------------------------------------
    def migrate(self, source, target, request_id: str, *,
                import_id: Optional[str] = None,
                deadline_ms: Optional[float] = None,
                stream=None, trace=None, parent=None,
                import_trace: Optional[Dict] = None,
                src: Any = None, dst: Any = None,
                reason: str = "failover") -> Optional[Dict]:
        """Move one in-flight sequence from ``source`` to ``target``.

        Returns ``{"request", "blocks", "wire_bytes", "stall_ms",
        "outcome"}`` on success (``request`` is the target-side
        :class:`~deepspeed_tpu_torch.serving.request.Request`, already live in
        a decode slot), or None when the move could not happen — export
        declined (source has no migratable state or no export surface),
        import declined (target cannot land it), or a fault fired
        mid-transfer. None ALWAYS means the target holds nothing and the
        source was not detached: the caller's replay path stays correct.

        ``trace``/``parent`` attach the ``migrate`` span to the
        request's existing client trace; ``src``/``dst`` label the span
        with replica identities; ``import_id`` renames the request on
        the target (the router's per-attempt proxy ids)."""
        t0 = self.clock()
        outcome, export, req = "ok", None, None
        try:
            exporter = getattr(source, "export_sequence", None)
            if exporter is None:
                outcome = "no_surface"
            else:
                export = exporter(request_id)
                if export is None:
                    outcome = "export_none"
            if export is not None:
                # the wire: host-to-host block rows in flight (the chaos
                # flaky-transfer seam fires here, between export and the
                # target's import)
                raise_if("serving.migration.transfer", detail=request_id)
                req = target.import_sequence(
                    export, deadline_ms=deadline_ms, stream=stream,
                    request_id=import_id, trace=import_trace)
                if req is None:
                    outcome = "import_none"
        except Exception:
            # export crash, transfer fault, or import fault past the
            # commit seam: the target released its allocation on the way
            # out and the source's committed state is untouched
            outcome, req = "error", None
        if req is not None:
            # commit point: the target owns the sequence — detach the
            # source copy (host-only bookkeeping, cannot fail partway)
            detach = getattr(source, "migrate_out", None)
            if detach is not None:
                detach(request_id)
        t1 = self.clock()
        stall_ms = round(1e3 * max(t1 - t0, 0.0), 3)
        blocks = int(export["blocks"]) if export else 0
        wire = int(export["wire_bytes"]) if export else 0
        m = self._metrics
        m.counter("ds_migration_attempts_total", ("outcome",)).labels(
            outcome=outcome).inc()
        if req is None:
            m.counter("ds_migration_fallbacks_total").inc()
        else:
            m.counter("ds_migration_blocks_moved_total").inc(blocks)
            m.counter("ds_migration_wire_bytes_total").inc(wire)
        m.histogram("ds_migration_stall_ms").observe(stall_ms)
        if trace is not None:
            self._tracer.record_span(
                "migrate", trace, to_ns(t0), to_ns(t1), parent=parent,
                request_id=request_id, src=src, dst=dst, reason=reason,
                outcome=outcome, blocks=blocks, wire_bytes=wire)
        if req is None:
            return None
        return {"request": req, "blocks": blocks, "wire_bytes": wire,
                "stall_ms": stall_ms, "outcome": outcome}
