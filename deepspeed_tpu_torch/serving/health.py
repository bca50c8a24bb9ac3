"""Per-replica health: a state machine over signals the telemetry
stream already carries (copy of ``deepspeed_tpu/serving/health.py``).

Pure host-side policy (no torch imports — same contract as the
scheduler): the router holds one :class:`ReplicaHealth` per replica and
feeds it exactly four kinds of evidence, none of which require reaching
into the replica's internals:

- **step outcomes** — an exception from ``submit()``/``step()`` is a
  failure; a clean step is a success (resets the consecutive-failure
  count);
- **stall verdicts** — host-observed step wall time past the configured
  timeout (the hang-watchdog signal at router granularity) trips the
  breaker immediately: a wedged collective does not get
  ``failure_threshold`` chances;
- **crash verdicts** — an exception whose ``replica_dead`` attribute is
  true (e.g. :class:`~deepspeed_tpu_torch.runtime.resilience.chaos.
  ReplicaCrashed`) is unrecoverable: the replica goes ``DEAD`` and never
  comes back without an explicit :meth:`reactivate`;
- **telemetry aggregates** — TTFT p95 / shed rate from the replica's own
  ``stats()`` window soft-degrade a replica (still routable, but only
  after every HEALTHY peer), with hysteresis so a borderline replica
  does not flap.

States::

    HEALTHY <-> DEGRADED          (soft telemetry signals, hysteresis)
       |            |
       +--- trip ---+---> TRIPPED ---(backoff elapses)---> half-open probe
                            |  ^                               |
                            |  +------- probe failed ----------+
                            |  (backoff doubles: retry_io's series)
                            +--> DEAD  (crash, or > max_trips)

    DRAINING                      (rolling restart: no new work, in-flight
                                   finishes; reactivate() -> HEALTHY)

The breaker's half-open schedule is the same exponential series the
JAX package's checkpoint retry helper walks (``retry_io``: ``base * 2**(n-1)``)
— :func:`probe_backoff` is that formula, named.
"""

import time
from typing import Callable, Optional

HEALTHY = "healthy"
DEGRADED = "degraded"
TRIPPED = "tripped"
DEAD = "dead"
DRAINING = "draining"

STATES = (HEALTHY, DEGRADED, TRIPPED, DEAD, DRAINING)


def probe_backoff(base_secs: float, trips: int) -> float:
    """Half-open probe delay after the ``trips``-th breaker trip — the
    ``retry_io`` exponential series (``base * 2**(trips-1)``)."""
    return float(base_secs) * (2 ** max(0, int(trips) - 1))


class ReplicaHealth:
    def __init__(self, config, replica_id: int = 0, clock=time.monotonic,
                 emit: Optional[Callable] = None):
        self.config = config
        self.replica_id = int(replica_id)
        self.clock = clock
        self._emit = emit
        self.state = HEALTHY
        self.consecutive_failures = 0
        self.trips = 0            # lifetime breaker trips (stats; a probe
        #                           close does NOT erase the history)
        self.trip_streak = 0      # trips since the last close — drives the
        #                           backoff series and the DEAD gate
        self.next_probe_ts = 0.0  # earliest half-open probe after a trip
        self.probing = False      # a half-open probe request is in flight
        self.last_reason: Optional[str] = None

    # ------------------------------------------------------------------
    def _set_state(self, new: str, reason: str):
        if new == self.state:
            return
        old, self.state, self.last_reason = self.state, new, reason
        if self._emit is not None:
            self._emit("replica.state", replica=self.replica_id,
                       from_state=old, to_state=new, reason=reason)

    @property
    def routable(self) -> bool:
        """May receive regular traffic (probes are separate: a TRIPPED
        replica takes exactly one request once its backoff elapses)."""
        return self.state in (HEALTHY, DEGRADED)

    @property
    def alive(self) -> bool:
        return self.state != DEAD

    # ------------------------------------------------------------------
    # breaker / hard signals
    def can_probe(self, now: float) -> bool:
        return (self.state == TRIPPED and not self.probing
                and now >= self.next_probe_ts)

    def begin_probe(self):
        self.probing = True
        if self._emit is not None:
            self._emit("breaker.probe", replica=self.replica_id,
                       trips=self.trips)

    def probe_success(self):
        """The half-open probe request finished: close the breaker and
        reset the backoff series (a recovered replica starts clean —
        but ``trips`` keeps the lifetime count for stats)."""
        self.probing = False
        self.trip_streak = 0
        self.consecutive_failures = 0
        self._set_state(HEALTHY, "probe_success")
        if self._emit is not None:
            self._emit("breaker.close", replica=self.replica_id)

    def probe_inconclusive(self):
        """The probe request was shed by replica-side admission policy
        (deadline, queue) — no verdict either way; allow another probe."""
        self.probing = False

    def record_success(self):
        self.consecutive_failures = 0

    def record_failure(self, reason: str = "failure"):
        if self.state == DEAD:
            return
        self.consecutive_failures += 1
        if self.probing or (self.consecutive_failures
                            >= self.config.failure_threshold):
            self.trip(reason)

    def record_stall(self, reason: str = "stall"):
        """A stall verdict is definitive — trip now, don't count to
        ``failure_threshold`` while requests sit behind a wedged step."""
        self.trip(reason)

    def record_crash(self, reason: str = "crash"):
        self.probing = False
        self._set_state(DEAD, reason)

    def trip(self, reason: str):
        if self.state in (DEAD, DRAINING):
            return
        self.probing = False
        self.consecutive_failures = 0
        self.trips += 1
        self.trip_streak += 1
        # dedicated event: a re-trip while already TRIPPED (failed
        # half-open probe) changes no state, so state-change events
        # alone undercount breaker activity
        if self._emit is not None:
            self._emit("breaker.trip", replica=self.replica_id,
                       trips=self.trips, reason=reason)
        if self.trip_streak > self.config.max_trips:
            self._set_state(DEAD, f"max_trips:{reason}")
            return
        self.next_probe_ts = self.clock() + probe_backoff(
            self.config.probe_backoff_secs, self.trip_streak)
        self._set_state(TRIPPED, reason)

    # ------------------------------------------------------------------
    # soft signals (telemetry aggregates), with hysteresis
    def observe(self, ttft_p95_ms=None, shed_rate=None):
        if self.state not in (HEALTHY, DEGRADED):
            return
        c = self.config
        checks = []
        if c.degraded_ttft_ms > 0 and ttft_p95_ms is not None:
            checks.append((float(ttft_p95_ms), c.degraded_ttft_ms))
        if c.degraded_shed_rate > 0 and shed_rate is not None:
            checks.append((float(shed_rate), c.degraded_shed_rate))
        if not checks:
            return
        if any(v > thr for v, thr in checks):
            self._set_state(DEGRADED, "telemetry")
        elif self.state == DEGRADED and all(
                v <= thr * c.degraded_exit_fraction for v, thr in checks):
            self._set_state(HEALTHY, "recovered")

    # ------------------------------------------------------------------
    # rolling restarts
    def start_drain(self):
        """No-op on an already-DRAINING replica (a repeated drain call —
        an operator retry, or the fleet manager re-evaluating — must not
        reset drain bookkeeping or cancel an open probe verdict), and on
        a DEAD one (there is nothing left to drain; ``reactivate`` is
        the only door back)."""
        if self.state in (DRAINING, DEAD):
            return
        self.probing = False
        self._set_state(DRAINING, "drain")

    def reactivate(self):
        """The drained/restarted replica is back: clean slate (an
        explicit operator action — lifetime count included)."""
        self.consecutive_failures = 0
        self.trips = 0
        self.trip_streak = 0
        self.probing = False
        self._set_state(HEALTHY, "reactivate")
