"""Labeled metric registry: the live half of the metrics plane (copy of
``deepspeed_tpu/telemetry/registry.py``).

The event stream and span traces are post-hoc artifacts:
a fleet operator can replay what happened but cannot *watch* a running
process. This module is the scrapeable surface — a process-local
registry of Counter / Gauge / Histogram families with bounded label
cardinality, rendered as Prometheus text by ``telemetry/prom.py`` and
served by the serving gateway's ``GET /metrics``. The router, fleet
manager, migrator and gateway feed the registry their ``telemetry=``
object carries (``.metrics``), or the inert :data:`NULL_REGISTRY`.

Design rules, all load-bearing:

- **Host-only** (no torch): the serving policy tier, the
  router/fleet layer and the report tooling instrument through this
  module, so it must import anywhere in milliseconds.
- **Every metric name is registered in :data:`NAMES`** — an
  AST-readable literal table, same convention as
  ``telemetry/events.KINDS``/``SPANS``; an unregistered name raises
  :class:`MetricError` at its first use: it would be a series no
  dashboard or alert rule ever looks for.
- **Bounded label cardinality**: a family accepts at most
  ``max_label_sets`` distinct label sets; excess observations fold into
  one ``{"overflow": "true"}`` series (and are counted) instead of
  growing without bound — a request-id accidentally used as a label
  must degrade the metric, never OOM the process.
- **Deterministic snapshots**: families and series render sorted, no
  wall-clock timestamps — two identical runs under fake clocks produce
  byte-identical exposition text (test-pinned).
- Histograms reuse the mergeable fixed-bucket
  :class:`~deepspeed_tpu_torch.telemetry.metrics.Histogram`, so a
  scraped histogram merges exactly into the capacity model's curves
  (``serving/capacity.fit_snapshot``).
"""

import threading
from typing import Dict, Optional, Sequence, Tuple

from deepspeed_tpu_torch.telemetry.metrics import MS_BOUNDS, Histogram

# ---------------------------------------------------------------------------
# The metric-name registry (the JAX package's table, kept a pure
# literal). One entry per family: type + help text.
# Naming follows Prometheus conventions: `ds_` namespace, `_total` for
# counters, an explicit unit suffix on histograms/byte gauges.

NAMES = {
    # -- process / training engine (fed by the telemetry manager) --
    "ds_steps_total": (
        "counter", "optimizer/decode step boundaries observed"),
    "ds_steps_per_sec": (
        "gauge", "step rate over the last boundary interval"),
    "ds_samples_total": (
        "counter", "training samples consumed at step boundaries"),
    "ds_exposed_comm_fraction": (
        "gauge", "per-step exposed-communication fraction "
                 "(label source: profiled|static_estimate)"),
    "ds_compiles_total": (
        "counter", "compiles per watchdog family"),
    "ds_retraces_after_warmup_total": (
        "counter", "post-warmup retraces per watchdog family "
                   "(a recompile storm burns these)"),
    "ds_compile_seconds_total": (
        "counter", "cumulative trace+backend compile seconds per family"),
    "ds_device_bytes_in_use": (
        "gauge", "device memory in use at the last step boundary"),
    "ds_device_peak_bytes": (
        "gauge", "peak device memory observed"),
    "ds_host_rss_bytes": (
        "gauge", "host process RSS at the last memory sample"),
    "ds_events_total": (
        "counter", "telemetry events emitted, by kind"),
    "ds_flightrec_dumps_total": (
        "counter", "flight-recorder dumps written, by trigger reason"),
    "ds_scrapes_total": (
        "counter", "/metrics scrapes served by this process"),
    # -- serving engine + scheduler --
    "ds_serving_ttft_ms": (
        "histogram", "time to first token per finished request (ms)"),
    "ds_serving_queue_ms": (
        "histogram", "submit -> decode-slot admission wait (ms)"),
    "ds_serving_decode_ms": (
        "histogram", "decode segment per request: first token -> "
                     "finish (ms)"),
    "ds_serving_requests_total": (
        "counter", "terminal requests, by outcome (finished|shed)"),
    "ds_serving_tokens_total": (
        "counter", "generated tokens delivered by finished requests"),
    "ds_serving_queue_depth": (
        "gauge", "admission queue depth at the last decode step"),
    "ds_serving_slots_busy": (
        "gauge", "busy decode slots at the last decode step"),
    "ds_serving_slots_total": (
        "gauge", "decode slots this engine schedules over"),
    "ds_kv_pool_blocks": (
        "gauge", "KV pool blocks by tier: free = reclaimable (free "
                 "list + evictable cached), cached = prefix-cache "
                 "indexed (live or evictable), used = holding live "
                 "sequences; the garbage block is excluded"),
    "ds_kv_pool_occupancy": (
        "gauge", "fraction of usable KV blocks holding live sequences"),
    "ds_kv_pool_fragmentation": (
        "gauge", "1 - committed tokens / allocated block capacity "
                 "(internal fragmentation of live blocks)"),
    "ds_prefix_cache_hit_rate": (
        "gauge", "prompt tokens served from the radix prefix cache over "
                 "the stats window"),
    "ds_spec_draft_tokens_total": (
        "counter", "speculative tokens proposed"),
    "ds_spec_accepted_tokens_total": (
        "counter", "speculative tokens the verify oracle accepted"),
    "ds_spec_acceptance_rate": (
        "gauge", "accepted/proposed speculative tokens over the stats "
                 "window"),
    # -- router / fleet --
    "ds_replica_health": (
        "gauge", "one-hot replica health (labels replica, state): 1 for "
                 "the replica's current state, 0 otherwise"),
    "ds_fleet_replicas": (
        "gauge", "replica count by health state"),
    "ds_fleet_active_replicas": (
        "gauge", "replicas currently taking traffic (HEALTHY+DEGRADED)"),
    "ds_fleet_parked_replicas": (
        "gauge", "drained engines parked warm by the autoscaler"),
    "ds_fleet_draining_replicas": (
        "gauge", "replicas mid-drain"),
    "ds_fleet_overload": (
        "gauge", "router overload score (0..1) at the last fleet step"),
    "ds_fleet_load": (
        "gauge", "per-replica load over routable replicas "
                 "((busy+queued)/slots)"),
    "ds_slo_budget_remaining": (
        "gauge", "slow-window SLO error budget remaining (label slo: "
                 "ttft|shed); 1.0 = untouched, 0.0 = spent"),
    "ds_slo_burn_rate": (
        "gauge", "SLO error-budget burn rate (labels slo, window: "
                 "fast|slow); 1.0 = spending exactly the budget"),
    "ds_fleet_scale_events_total": (
        "counter", "autoscaler scaling actions executed, by action"),
    "ds_migration_attempts_total": (
        "counter", "live KV migration attempts, by outcome (ok|"
                   "no_surface|export_none|import_none|error)"),
    "ds_migration_fallbacks_total": (
        "counter", "migrations that fell through to replay/drain-wait"),
    "ds_migration_blocks_moved_total": (
        "counter", "KV pool blocks moved by committed migrations"),
    "ds_migration_wire_bytes_total": (
        "counter", "bytes of KV rows (all cache leaves) moved by "
                   "committed migrations"),
    "ds_migration_stall_ms": (
        "histogram", "host walltime of one migration attempt, export "
                     "through source detach"),
    # -- gateway (HTTP/SSE front door) --
    "ds_gateway_requests_total": (
        "counter", "HTTP requests by tenant and outcome (ok|rejected|"
                   "shed|error); unknown tenants fold into overflow"),
    "ds_gateway_rejects_total": (
        "counter", "requests refused at the front door by tenant and "
                   "reason (auth|rate|tokens|inflight|overload|"
                   "bad_request|too_large)"),
    "ds_gateway_inflight": (
        "gauge", "requests currently admitted through the gateway and "
                 "not yet finished, by tenant"),
    "ds_gateway_ttft_ms": (
        "histogram", "submit -> first SSE token flushed to the client, "
                     "by tenant (gateway-observed TTFT)"),
    "ds_gateway_tokens_total": (
        "counter", "generated tokens delivered to clients, by tenant"),
    "ds_gateway_stream_sheds_total": (
        "counter", "SSE streams terminated early by tenant and cause "
                   "(backend_shed|slow_reader|disconnect)"),
    "ds_gateway_budget_remaining": (
        "gauge", "per-tenant SLO error budget remaining (1.0 = "
                 "untouched, 0.0 = spent)"),
}

# the label set a family folds excess cardinality into
OVERFLOW_LABELS = (("overflow", "true"),)


class MetricError(ValueError):
    """Misuse of the registry (unregistered name, type conflict,
    inconsistent label names)."""


def _label_key(label_names: Sequence[str],
               labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    if set(labels) != set(label_names):
        raise MetricError(
            f"labels {sorted(labels)} do not match declared label names "
            f"{sorted(label_names)}")
    return tuple((k, str(labels[k])) for k in sorted(label_names))


class _Instrument:
    """One series (one label set) of a family."""

    __slots__ = ("family", "value", "hist")

    def __init__(self, family):
        self.family = family
        self.value = 0.0
        self.hist = (Histogram(family.bounds)
                     if family.type == "histogram" else None)

    def inc(self, n: float = 1.0):
        if self.family.type == "gauge":
            with self.family.lock:
                self.value += float(n)
            return self
        if self.family.type != "counter":
            raise MetricError(f"{self.family.name} is a "
                              f"{self.family.type}; inc() needs a "
                              "counter or gauge")
        if n < 0:
            raise MetricError(f"counter {self.family.name} cannot "
                              "decrease")
        with self.family.lock:
            self.value += float(n)
        return self

    def dec(self, n: float = 1.0):
        return self.inc(-float(n))

    def set(self, v: float):
        if self.family.type != "gauge":
            raise MetricError(f"{self.family.name} is a "
                              f"{self.family.type}; set() needs a gauge")
        with self.family.lock:
            self.value = float(v)
        return self

    def observe(self, v: float):
        if self.hist is None:
            raise MetricError(f"{self.family.name} is a "
                              f"{self.family.type}; observe() needs a "
                              "histogram")
        with self.family.lock:
            self.hist.observe(v)
        return self


class _NullInstrument:
    """Inert instrument: the disabled-metrics fast path. Every mutator
    is a no-op returning self, so call sites stay unconditional."""

    def inc(self, n=1.0):
        return self

    def dec(self, n=1.0):
        return self

    def set(self, v):
        return self

    def observe(self, v):
        return self

    def labels(self, **kv):
        return self


_NULL_INSTRUMENT = _NullInstrument()


class MetricFamily:
    """One named metric with its declared label names; holds one
    :class:`_Instrument` per observed label set (bounded)."""

    def __init__(self, registry, name: str, mtype: str, help_text: str,
                 label_names: Sequence[str], bounds, max_label_sets: int):
        self.registry = registry
        self.name = name
        self.type = mtype
        self.help = help_text
        self.label_names = tuple(label_names)
        self.bounds = list(bounds) if bounds is not None else None
        self.max_label_sets = int(max_label_sets)
        self.dropped_label_sets = 0
        self.lock = registry._lock
        self._series: Dict[Tuple, _Instrument] = {}
        if not self.label_names:
            # unlabeled family: the one series exists up front so a
            # scrape before the first observation still shows it at 0
            self._series[()] = _Instrument(self)

    def labels(self, **kv) -> _Instrument:
        key = _label_key(self.label_names, kv)
        with self.lock:
            inst = self._series.get(key)
            if inst is None:
                if len(self._series) >= self.max_label_sets:
                    # cardinality bound: fold into the overflow series
                    self.dropped_label_sets += 1
                    inst = self._series.get(OVERFLOW_LABELS)
                    if inst is None:
                        inst = self._series[OVERFLOW_LABELS] = \
                            _Instrument(self)
                    return inst
                inst = self._series[key] = _Instrument(self)
        return inst

    # unlabeled convenience: family acts as its own single instrument
    def _solo(self) -> _Instrument:
        if self.label_names:
            raise MetricError(
                f"{self.name} declares labels {self.label_names}; use "
                f".labels(...)")
        return self._series[()]

    def inc(self, n: float = 1.0):
        return self._solo().inc(n)

    def dec(self, n: float = 1.0):
        return self._solo().dec(n)

    def set(self, v: float):
        return self._solo().set(v)

    def observe(self, v: float):
        return self._solo().observe(v)

    def snapshot(self) -> Dict:
        with self.lock:
            series = []
            for key in sorted(self._series):
                inst = self._series[key]
                row: Dict = {"labels": dict(key)}
                if inst.hist is not None:
                    h = inst.hist
                    row.update({
                        "bounds": list(h.bounds),
                        "counts": list(h.counts),
                        "count": h.count, "sum": h.total,
                        "min": h.min, "max": h.max,
                    })
                else:
                    row["value"] = inst.value
                series.append(row)
            out = {"type": self.type, "help": self.help,
                   "label_names": list(self.label_names),
                   "series": series}
            if self.dropped_label_sets:
                out["dropped_label_sets"] = self.dropped_label_sets
            return out


class MetricRegistry:
    """The per-process (or per-test) family registry. Thread-safe: the
    scrape thread snapshots while engines observe."""

    def __init__(self, max_label_sets: int = 64):
        self._lock = threading.RLock()
        self.max_label_sets = int(max_label_sets)
        self._families: Dict[str, MetricFamily] = {}

    # ------------------------------------------------------------------
    def _family(self, name: str, mtype: str,
                label_names: Sequence[str], bounds=None,
                help_text: Optional[str] = None,
                max_label_sets: Optional[int] = None) -> MetricFamily:
        if name not in NAMES:
            raise MetricError(
                f"metric name {name!r} is not registered in "
                f"telemetry/registry.NAMES — add it there")
        reg_type, reg_help = NAMES[name]
        if mtype != reg_type:
            raise MetricError(
                f"{name!r} is registered as a {reg_type}, requested as "
                f"a {mtype}")
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = MetricFamily(
                    self, name, mtype, help_text or reg_help,
                    label_names, bounds,
                    max_label_sets or self.max_label_sets)
                self._families[name] = fam
            elif tuple(label_names) != fam.label_names:
                raise MetricError(
                    f"{name!r} was declared with label names "
                    f"{fam.label_names}, now requested with "
                    f"{tuple(label_names)}")
            return fam

    def counter(self, name: str, labels: Sequence[str] = (),
                **kw) -> MetricFamily:
        return self._family(name, "counter", labels, **kw)

    def gauge(self, name: str, labels: Sequence[str] = (),
              **kw) -> MetricFamily:
        return self._family(name, "gauge", labels, **kw)

    def histogram(self, name: str, labels: Sequence[str] = (),
                  bounds: Optional[Sequence[float]] = None,
                  **kw) -> MetricFamily:
        return self._family(name, "histogram", labels,
                            bounds=list(bounds or MS_BOUNDS), **kw)

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict:
        """Deterministic plain-dict view of every family (sorted; no
        timestamps) — the exposition renderer's, the flight recorder's
        and ``fit_snapshot``'s single input format."""
        with self._lock:
            names = sorted(self._families)
        return {name: self._families[name].snapshot() for name in names}

    def expose(self) -> str:
        """OpenMetrics/Prometheus text for the current state."""
        from deepspeed_tpu_torch.telemetry.prom import render_exposition

        return render_exposition(self.snapshot())


class _NullRegistry:
    """Inert registry: ``counter``/``gauge``/``histogram`` hand back a
    shared no-op instrument, so instrumentation sites run unconditional
    and the disabled path costs one attribute read + one call."""

    enabled = False

    def counter(self, name, labels=(), **kw):
        return _NULL_INSTRUMENT

    def gauge(self, name, labels=(), **kw):
        return _NULL_INSTRUMENT

    def histogram(self, name, labels=(), bounds=None, **kw):
        return _NULL_INSTRUMENT

    def snapshot(self):
        return {}

    def expose(self):
        return ""


MetricRegistry.enabled = True
NULL_REGISTRY = _NullRegistry()

__all__ = ["NAMES", "MetricRegistry", "MetricFamily", "MetricError",
           "NULL_REGISTRY", "OVERFLOW_LABELS"]
