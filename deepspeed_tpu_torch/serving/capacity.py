"""Per-replica capacity model: latency-vs-load curves and sizing (copy
of ``deepspeed_tpu/serving/capacity.py``).

Pure host-side (no torch, no clock reads). Fits two things from observed
serving evidence, bucketed by per-replica load:

- **TTFT / queue-wait p95 curves** — one fixed-bucket
  :class:`~deepspeed_tpu_torch.telemetry.metrics.Histogram` per load bucket
  (constant memory over any run length; models from two runs or two
  replicas :meth:`merge` exactly, the histogram's contract);
- **sustainable token throughput** — tokens generated per simulated
  second at each load level, so "how many replicas does this offered
  load need at this SLO" has a measured answer:
  :meth:`fleet_size_for`.

*Load* is the replica's queue-pressure fraction — ``(slots_busy +
queue_depth) / slots_total`` from the public ``gauges()`` payload — so
1.0 means every decode slot busy and nothing queued, 2.0 means a full
queue one slot-generation deep, and so on. Buckets cover [0, max_load)
plus an overflow bucket.

Evidence arrives two ways: live feeding (:meth:`observe` /
:meth:`observe_gauges`, the trace-replay path) or a telemetry event
stream (:meth:`fit_events`: per-step load from ``serving``/
``step.gauges`` events, latencies from ``serving``/``request.finish``
records and ``span`` ``queue`` legs with step attribution).
"""

import math
from typing import Dict, Iterable, List, Optional

from deepspeed_tpu_torch.telemetry.metrics import MS_BOUNDS, Histogram

# millisecond-scale geometric ladder: 2**-6 .. 2**25 ms (~15 us .. ~9 h)
# — the telemetry-wide shared ladder, so the metric registry's latency
# histograms merge exactly into these curves (fit_snapshot)
_MS_BOUNDS = MS_BOUNDS


def _gauge_value(snapshot: Dict, name: str) -> float:
    """First unlabeled-series value of a gauge family in a registry
    snapshot (0.0 when absent)."""
    for row in (snapshot.get(name) or {}).get("series", []):
        if row.get("value") is not None:
            return float(row["value"])
    return 0.0


def _histogram_from_row(row: Dict) -> Optional[Histogram]:
    """Reconstruct a mergeable Histogram from one snapshot series row
    (bounds + per-bucket counts + count/sum/min/max)."""
    bounds = row.get("bounds")
    counts = row.get("counts")
    if not bounds or counts is None:
        return None
    h = Histogram(bounds)
    if len(counts) != len(h.counts):
        return None
    h.counts = [int(c) for c in counts]
    h.count = int(row.get("count") or sum(h.counts))
    h.total = float(row.get("sum") or 0.0)
    h.min = row.get("min")
    h.max = row.get("max")
    if h.count and h.max is None:
        # parsed-scrape rows carry no extremes: the top non-empty
        # bucket's bound is the honest stand-in (percentile clamps on
        # max, which must not be None while counts exist)
        top = max(i for i, c in enumerate(h.counts) if c)
        h.max = float(bounds[min(top, len(bounds) - 1)])
        h.min = 0.0
    return h


class CapacityModel:
    def __init__(self, n_buckets: int = 8, max_load: float = 2.0):
        if n_buckets <= 0 or max_load <= 0:
            raise ValueError("CapacityModel needs n_buckets > 0 and "
                             f"max_load > 0, got {n_buckets}/{max_load}")
        self.n_buckets = int(n_buckets)
        self.max_load = float(max_load)
        # n_buckets over [0, max_load) + one overflow bucket
        self._ttft: List[Histogram] = [Histogram(_MS_BOUNDS)
                                       for _ in range(self.n_buckets + 1)]
        self._queue: List[Histogram] = [Histogram(_MS_BOUNDS)
                                        for _ in range(self.n_buckets + 1)]
        self._tokens: List[float] = [0.0] * (self.n_buckets + 1)
        self._secs: List[float] = [0.0] * (self.n_buckets + 1)

    # ------------------------------------------------------------------
    def bucket(self, load: float) -> int:
        i = int(max(0.0, float(load)) / self.max_load * self.n_buckets)
        return min(i, self.n_buckets)

    def bucket_load(self, i: int) -> float:
        """Representative (midpoint) load of bucket ``i``."""
        width = self.max_load / self.n_buckets
        return (i + 0.5) * width

    @staticmethod
    def load_of(gauges: dict) -> float:
        """The load definition, from a public ``gauges()`` payload."""
        slots = max(1, int(gauges.get("slots_total", 0) or 1))
        busy = int(gauges.get("slots_busy", 0))
        depth = int(gauges.get("queue_depth", 0))
        return (busy + depth) / slots

    # ------------------------------------------------------------------
    # evidence
    def observe(self, load: float, *, ttft_ms: Optional[float] = None,
                queue_ms: Optional[float] = None, tokens: float = 0.0,
                secs: float = 0.0) -> None:
        i = self.bucket(load)
        if ttft_ms is not None:
            self._ttft[i].observe(ttft_ms)
        if queue_ms is not None:
            self._queue[i].observe(queue_ms)
        self._tokens[i] += float(tokens)
        self._secs[i] += float(secs)

    def observe_gauges(self, gauges: dict, *, tokens: float = 0.0,
                       secs: float = 0.0) -> float:
        """Per-step feeding from a live replica: attributes this step's
        generated ``tokens`` over ``secs`` simulated seconds to the load
        the gauges show. Returns the load (callers often want it)."""
        load = self.load_of(gauges)
        self.observe(load, tokens=tokens, secs=secs)
        return load

    def fit_events(self, events: Iterable[dict]) -> int:
        """Fit from a telemetry event stream (the offline path): builds
        a step -> load map from ``serving``/``step.gauges``, then
        attributes ``request.finish`` TTFT/queue latencies and token
        throughput — and ``span`` ``queue`` legs carrying a ``step``
        attribute — to the load at their step. Returns the number of
        observations consumed."""
        events = list(events)
        load_at: Dict[int, float] = {}
        for e in events:
            if e.get("kind") == "serving" and e.get("name") == "step.gauges" \
                    and e.get("step") is not None:
                load_at[int(e["step"])] = self.load_of(e.get("data") or {})
        if not load_at:
            return 0
        steps = sorted(load_at)

        def nearest(step):
            if step in load_at:
                return load_at[step]
            prior = [s for s in steps if s <= step]
            return load_at[prior[-1] if prior else steps[0]]

        used = 0
        for e in events:
            kind, name, data = e.get("kind"), e.get("name"), \
                e.get("data") or {}
            step = e.get("step")
            if kind == "serving" and name == "request.finish" \
                    and step is not None:
                load = nearest(int(step))
                tps = data.get("tokens_per_sec")
                toks = data.get("new_tokens") or 0
                self.observe(
                    load, ttft_ms=data.get("ttft_ms"),
                    queue_ms=data.get("queue_ms"), tokens=toks,
                    secs=(toks / tps) if (tps and toks) else 0.0)
                used += 1
            elif kind == "span" and name == "queue" \
                    and data.get("step") is not None:
                load = nearest(int(data["step"]))
                dur_ms = max(0, int(data.get("end_ns", 0))
                             - int(data.get("start_ns", 0))) / 1e6
                self.observe(load, queue_ms=dur_ms)
                used += 1
        return used

    def fit_snapshot(self, snapshot: Dict, *,
                     load: Optional[float] = None) -> int:
        """Fit from a metric-registry snapshot (the live metrics plane's
        format: ``MetricRegistry.snapshot()``, a flight-recorder
        snapshot ring entry, or a parsed scrape) instead of raw events.
        The registry's ``ds_serving_ttft_ms``/``ds_serving_queue_ms``
        histograms share the capacity ladder (``telemetry.metrics.
        MS_BOUNDS``) so their counts merge EXACTLY into the load
        bucket's curve. ``load`` defaults to the snapshot's own queue/
        slot gauges. Feed each snapshot once (the registry is
        cumulative — delta successive snapshots externally, or fit the
        final one). Returns observations consumed."""
        if load is None:
            load = self.load_of({
                "queue_depth": _gauge_value(snapshot,
                                            "ds_serving_queue_depth"),
                "slots_busy": _gauge_value(snapshot,
                                           "ds_serving_slots_busy"),
                "slots_total": _gauge_value(snapshot,
                                            "ds_serving_slots_total"),
            })
        i = self.bucket(load)
        used = 0
        for metric, target in (("ds_serving_ttft_ms", self._ttft),
                               ("ds_serving_queue_ms", self._queue)):
            for row in (snapshot.get(metric) or {}).get("series", []):
                if not row.get("count"):
                    continue
                h = _histogram_from_row(row)
                if h is None or h.bounds != target[i].bounds:
                    continue  # foreign ladder: no exact merge exists
                target[i].merge(h)
                used += h.count
        return used

    def merge(self, other: "CapacityModel") -> "CapacityModel":
        if (self.n_buckets, self.max_load) != (other.n_buckets,
                                               other.max_load):
            raise ValueError("cannot merge capacity models with different "
                             "bucket ladders")
        for i in range(self.n_buckets + 1):
            self._ttft[i].merge(other._ttft[i])
            self._queue[i].merge(other._queue[i])
            self._tokens[i] += other._tokens[i]
            self._secs[i] += other._secs[i]
        return self

    # ------------------------------------------------------------------
    # curves
    def ttft_p95_at(self, load: float) -> Optional[float]:
        return self._ttft[self.bucket(load)].percentile(95)

    def queue_p95_at(self, load: float) -> Optional[float]:
        return self._queue[self.bucket(load)].percentile(95)

    def throughput_at(self, load: float) -> Optional[float]:
        """Tokens per simulated second observed at ``load`` (None with
        no time attributed to that bucket)."""
        i = self.bucket(load)
        return self._tokens[i] / self._secs[i] if self._secs[i] > 0 \
            else None

    def curve(self) -> List[dict]:
        """The fitted table, one row per bucket with data — what the
        bench series and report render."""
        out = []
        for i in range(self.n_buckets + 1):
            if not (self._ttft[i].count or self._queue[i].count
                    or self._secs[i] > 0):
                continue
            out.append({
                "load": round(self.bucket_load(i), 3)
                if i < self.n_buckets else f">={self.max_load}",
                "ttft_ms_p95": self._ttft[i].percentile(95),
                "queue_ms_p95": self._queue[i].percentile(95),
                "tokens_per_sec": round(self._tokens[i] / self._secs[i], 2)
                if self._secs[i] > 0 else None,
                "requests": self._ttft[i].count,
            })
        return out

    # ------------------------------------------------------------------
    # sizing
    def sustainable_tokens_per_sec(
            self, ttft_p95_ms: float = 0.0,
            queue_p95_ms: float = 0.0) -> Optional[float]:
        """Highest per-replica throughput observed at any load level
        whose latency percentiles meet the SLO (0 = that target is
        unconstrained). None when no bucket has both throughput data and
        an SLO-clean latency reading."""
        best = None
        for i in range(self.n_buckets + 1):
            if self._secs[i] <= 0:
                continue
            ttft = self._ttft[i].percentile(95)
            queue = self._queue[i].percentile(95)
            if ttft_p95_ms > 0 and (ttft is None or ttft > ttft_p95_ms):
                continue
            if queue_p95_ms > 0 and (queue is None or queue > queue_p95_ms):
                continue
            rate = self._tokens[i] / self._secs[i]
            if best is None or rate > best:
                best = rate
        return best

    def fleet_size_for(self, load_tokens_per_sec: float, slo: dict,
                       *, min_size: int = 1,
                       max_size: Optional[int] = None) -> int:
        """Smallest fleet that serves ``load_tokens_per_sec`` within the
        SLO (``{"ttft_p95_ms": ..., "queue_p95_ms": ...}``; omitted keys
        are unconstrained), from the fitted per-replica sustainable
        rate. With no usable evidence the honest answer is the floor —
        the caller sizes from budget burn instead."""
        slo = slo or {}
        per = self.sustainable_tokens_per_sec(
            float(slo.get("ttft_p95_ms") or 0.0),
            float(slo.get("queue_p95_ms") or 0.0))
        if not per or per <= 0:
            n = min_size
        else:
            n = max(min_size, math.ceil(float(load_tokens_per_sec) / per))
        return min(n, max_size) if max_size else n
