"""Tenant identity, quotas and SLO accounting for the serving gateway
(copy of ``deepspeed_tpu/serving/tenancy.py``).

Pure host-side policy (no torch): a :class:`TenantTable` resolves
an API key to a :class:`Tenant`, and each tenant carries its own
token buckets (requests/s and tokens/s), concurrent-inflight quota,
SLO class (priority + deadline defaults), deterministic trace-sampling
accumulator and sliding-window error budget. All timing reads the
injected clock — the trace-replay harness runs the whole
admission plane on simulated time.

Admission outcomes are strings the gateway maps to HTTP statuses::

    ""          admitted
    "rate"      request token bucket empty        -> 429 + Retry-After
    "tokens"    generation token bucket empty     -> 429 + Retry-After
    "inflight"  max_inflight concurrent requests  -> 429 + Retry-After
"""

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from deepspeed_tpu_torch.serving.config import (GatewayConfig,
                                          GatewayTenantConfig,
                                          SloClassConfig)

ANONYMOUS = "anonymous"


class TokenBucket:
    """Classic token bucket on an injectable clock. ``rate <= 0`` means
    unlimited (every take succeeds, nothing is tracked). ``burst <= 0``
    sizes the bucket at one second of the rate, minimum 1."""

    def __init__(self, rate: float, burst: float = 0.0,
                 clock=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else max(self.rate, 1.0)
        self.clock = clock
        self.level = self.burst
        self._last = clock()

    def _refill(self, now: float):
        self.level = min(self.burst,
                         self.level + max(now - self._last, 0.0) * self.rate)
        self._last = now

    def ask(self, n: float = 1.0) -> float:
        """Refill, then return 0.0 when ``n`` tokens are available or the
        seconds until they would be. Does not deduct."""
        if self.rate <= 0:
            return 0.0
        self._refill(self.clock())
        if self.level >= n:
            return 0.0
        return (n - self.level) / self.rate

    def take(self, n: float = 1.0):
        if self.rate <= 0:
            return
        self.level -= n


class Tenant:
    """One tenant's live quota/SLO state. Thread-safe: the gateway's
    handler threads admit/release concurrently with the step loop
    recording outcomes."""

    def __init__(self, cfg: GatewayTenantConfig, slo: SloClassConfig,
                 clock=time.monotonic, budget_window: int = 256):
        self.name = cfg.name
        self.cfg = cfg
        self.slo = slo
        self.slo_class = cfg.slo_class
        self.priority = slo.priority
        self.deadline_ms = cfg.deadline_ms or slo.deadline_ms
        self.clock = clock
        self.req_bucket = TokenBucket(cfg.requests_per_sec,
                                      cfg.burst_requests, clock)
        self.tok_bucket = TokenBucket(cfg.tokens_per_sec,
                                      cfg.burst_tokens, clock)
        self.inflight = 0
        self._window: deque = deque(maxlen=int(budget_window))
        self._sample_acc = 0.0
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def admit(self, est_tokens: float = 0.0) -> Tuple[str, float]:
        """One admission attempt: ``("", 0.0)`` admits (quota charged,
        inflight incremented — pair with :meth:`release`), otherwise
        ``(reason, retry_after_secs)`` with nothing charged."""
        with self._lock:
            if (self.cfg.max_inflight
                    and self.inflight >= self.cfg.max_inflight):
                return "inflight", 0.0
            wait = self.req_bucket.ask(1.0)
            if wait > 0.0:
                return "rate", wait
            if est_tokens > 0.0:
                wait = self.tok_bucket.ask(float(est_tokens))
                if wait > 0.0:
                    return "tokens", wait
            self.req_bucket.take(1.0)
            if est_tokens > 0.0:
                self.tok_bucket.take(float(est_tokens))
            self.inflight += 1
            return "", 0.0

    def release(self):
        with self._lock:
            self.inflight = max(self.inflight - 1, 0)

    # ------------------------------------------------------------------
    def sample_trace(self) -> bool:
        """Deterministic rate-proportional sampling: an accumulator, not
        a PRNG, so replays are bit-reproducible."""
        rate = self.cfg.trace_sample_rate
        if rate <= 0.0:
            return False
        with self._lock:
            self._sample_acc += rate
            if self._sample_acc >= 1.0 - 1e-9:
                self._sample_acc -= 1.0
                return True
        return False

    # ------------------------------------------------------------------
    def record_outcome(self, shed: bool, ttft_ms: Optional[float] = None):
        """Burn the error budget: a request violates the SLO when it was
        shed, or when the class has a TTFT target and missed it."""
        bad = bool(shed)
        if not bad and self.slo.ttft_ms > 0 and ttft_ms is not None:
            bad = ttft_ms > self.slo.ttft_ms
        with self._lock:
            self._window.append(1 if bad else 0)

    def budget_remaining(self) -> float:
        """1.0 = untouched, 0.0 = spent: the bad fraction over the
        window, normalized by the class' allowed ``error_budget``."""
        with self._lock:
            if not self._window:
                return 1.0
            bad_frac = sum(self._window) / len(self._window)
        budget = self.slo.error_budget
        if budget <= 0.0:
            return 0.0 if bad_frac > 0 else 1.0
        return max(0.0, min(1.0, 1.0 - bad_frac / budget))


class TenantTable:
    """API key -> :class:`Tenant` resolution for one gateway. With no
    configured tenants the gateway is open: :meth:`resolve` maps ANY
    key (or none) to a quota-free anonymous tenant at ``best_effort``."""

    def __init__(self, config: GatewayConfig, clock=time.monotonic):
        self.config = config
        self.clock = clock
        self.tenants: List[Tenant] = []
        self._by_key: Dict[str, Tenant] = {}
        for row in config.tenants:
            tenant = Tenant(row, getattr(config, row.slo_class),
                            clock=clock, budget_window=config.budget_window)
            self.tenants.append(tenant)
            self._by_key[row.api_key] = tenant
        self._anonymous: Optional[Tenant] = None
        if not self.tenants:
            anon = GatewayTenantConfig(name=ANONYMOUS, api_key=ANONYMOUS)
            self._anonymous = Tenant(anon, config.best_effort, clock=clock,
                                     budget_window=config.budget_window)
            self.tenants.append(self._anonymous)

    @property
    def open(self) -> bool:
        return self._anonymous is not None

    def resolve(self, api_key: Optional[str]) -> Optional[Tenant]:
        if self._anonymous is not None:
            return self._anonymous
        if not api_key:
            return None
        return self._by_key.get(api_key)
