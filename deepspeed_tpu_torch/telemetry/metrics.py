"""Small fixed-bucket histogram for telemetry aggregates (copy of
``deepspeed_tpu/telemetry/metrics.py``).

The report tool needs p50/p95 over span durations and request latencies
without retaining every observation (a long serving run emits millions
of spans). A :class:`Histogram` holds a FIXED geometric bucket ladder —
the bounds never grow with the data, so memory is constant and two
histograms over the same ladder merge exactly. Percentiles come back as
the upper bound of the bucket the rank falls in (a known, bounded
overestimate of at most one bucket ratio — 2x on the default ladder),
which is the honest trade for constant memory.

Host-only: no torch, so it loads anywhere.
"""

from typing import Iterable, List, Optional, Sequence

# default ladder: powers of two from 1 to 2**47 (~1.4e14). In
# nanoseconds that spans 1ns .. ~39 hours — every span duration the
# tracer can emit lands inside it.
DEFAULT_BOUNDS = tuple(1 << i for i in range(48))

# shared millisecond-scale geometric ladder: 2**-6 .. 2**25 ms
# (~15 us .. ~9 h). ONE definition consumed by both the capacity
# model's latency curves and the metric registry's latency histograms,
# so a scraped registry snapshot merges EXACTLY into the capacity
# model (`CapacityModel.fit_snapshot` requires equal bounds).
MS_BOUNDS = tuple(2.0 ** i for i in range(-6, 26))


class Histogram:
    """Counting histogram over fixed ``bounds`` (ascending upper bucket
    bounds; values above the last bound land in an overflow bucket)."""

    def __init__(self, bounds: Optional[Sequence[float]] = None):
        self.bounds: List[float] = list(
            DEFAULT_BOUNDS if bounds is None else bounds)
        if any(b >= a for b, a in zip(self.bounds, self.bounds[1:])
               ) or not self.bounds:
            raise ValueError("histogram bounds must be non-empty and "
                             "strictly ascending")
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value) -> None:
        v = float(value)
        lo, hi = 0, len(self.bounds)
        while lo < hi:  # first bound >= v (bisect_left on bounds)
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def observe_many(self, values: Iterable) -> None:
        for v in values:
            self.observe(v)

    def percentile(self, q: float) -> Optional[float]:
        """Upper bound of the bucket holding the ``q``-th percentile
        observation (None when empty). Exact-extreme clamps: p100 is the
        true max and any percentile never exceeds it."""
        if self.count == 0:
            return None
        rank = max(1, int(-(-q / 100.0 * self.count // 1)))  # ceil
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                bound = (self.bounds[i] if i < len(self.bounds)
                         else self.max)
                return float(min(bound, self.max))
        return float(self.max)

    def merge(self, other: "Histogram") -> "Histogram":
        if self.bounds != other.bounds:
            raise ValueError("cannot merge histograms with different "
                             "bucket ladders")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        for v in (other.min, other.max):
            if v is not None:
                self.min = v if self.min is None else min(self.min, v)
                self.max = v if self.max is None else max(self.max, v)
        return self

    def summary(self, scale: float = 1.0, ndigits: int = 3) -> dict:
        """JSON-safe aggregate (values multiplied by ``scale`` — e.g.
        1e-6 renders nanosecond observations as milliseconds)."""
        if self.count == 0:
            return {"count": 0}

        def s(v):
            return None if v is None else round(v * scale, ndigits)

        return {
            "count": self.count,
            "mean": s(self.total / self.count),
            "p50": s(self.percentile(50)),
            "p95": s(self.percentile(95)),
            "p99": s(self.percentile(99)),
            "min": s(self.min),
            "max": s(self.max),
        }
