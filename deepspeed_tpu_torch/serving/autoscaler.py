"""SLO error-budget autoscaler policy for the replica fleet (copy of
``deepspeed_tpu/serving/autoscaler.py``).

Pure host-side policy (no torch, no clock reads — every timestamp and
step count is injected, so the trace-replay harness drives it
deterministically under fake clocks). The policy half of the fleet
manager: :class:`~deepspeed_tpu_torch.serving.router.FleetManager` feeds it
per-step evidence and executes whatever it decides through the router's
``start_drain``/``reactivate`` seams.

The SRE framing, concretely:

- **error budgets** — each SLO target defines an *allowed* failure
  rate. ``target_shed_rate`` allows that fraction of submits to shed;
  ``target_ttft_p95_ms`` allows 5% of finished requests over the target
  (that IS the p95 semantic, read as a budget).
- **burn rate** — observed failure rate over allowed rate, per sliding
  step window. Burn 1.0 = spending the budget exactly as fast as it
  refills; 2.0 = the budget is gone in half the window.
- **two windows** — a short *fast* window catches an overload spike
  early (scale up on ``burn_rate_fast``); a long *slow* window is the
  budget-remaining accounting and the scale-down quiet gate (you only
  shrink a fleet whose long-horizon budget is intact).
- **hysteresis + cooldowns** — scale-up is eager (one cooldown);
  scale-down needs ``scale_down_quiet_steps`` *consecutive* quiet steps
  (low load and fast burns within budget) plus its own cooldown, so a
  diurnal shoulder never flaps the fleet.

Queue pressure (the router's overload score) is a leading indicator
that triggers growth before any budget actually burns —
``scale_up_load`` — and gates shrinking — ``scale_down_load``.
"""

import dataclasses
from collections import deque
from typing import Dict, Iterable, Optional

from deepspeed_tpu_torch.serving.config import FleetConfig

SCALE_UP = "up"
SCALE_DOWN = "down"

# the p95 semantic as an error budget: 5% of requests may exceed the
# p95 target before the budget burns at exactly rate 1.0
TTFT_P95_ALLOWED = 0.05


class BudgetWindow:
    """One SLO error budget over a sliding window of per-step samples.

    Each step contributes ``(good, bad)`` counts; the burn rate is the
    window's bad fraction over the allowed fraction. Steps with no
    traffic contribute nothing (an idle fleet neither burns nor refills
    evidence)."""

    def __init__(self, window_steps: int, allowed_rate: float):
        self.window = deque(maxlen=int(window_steps))
        self.allowed = float(allowed_rate)

    def observe(self, good: int, bad: int) -> None:
        self.window.append((int(good), int(bad)))

    @property
    def rate(self) -> Optional[float]:
        good = sum(g for g, _ in self.window)
        bad = sum(b for _, b in self.window)
        total = good + bad
        return bad / total if total else None

    def burn_rate(self) -> Optional[float]:
        """Observed/allowed failure rate (None with no samples). An
        allowed rate of zero makes any failure an infinite burn — the
        strictest budget, not a crash."""
        rate = self.rate
        if rate is None:
            return None
        if self.allowed <= 0:
            return float("inf") if rate > 0 else 0.0
        return rate / self.allowed

    def remaining(self) -> Optional[float]:
        """Fraction of the window's budget left (clamped at 0)."""
        burn = self.burn_rate()
        if burn is None:
            return None
        return max(0.0, round(1.0 - burn, 4))


@dataclasses.dataclass
class Decision:
    action: str            # SCALE_UP | SCALE_DOWN
    reason: str            # "ttft_burn" | "shed_burn" | "load" | "quiet"
    step: int
    burn: Optional[float] = None
    overload: float = 0.0


class Autoscaler:
    """The decision policy. Call :meth:`observe_requests` with every
    terminal request record (finished AND shed — submit-time sheds
    included), :meth:`observe_step` once per router step, then
    :meth:`decide`. Stateless about the fleet itself: the caller says
    what the current size and bounds allow."""

    def __init__(self, config: FleetConfig):
        if isinstance(config, dict):
            config = FleetConfig(**config)
        self.config: FleetConfig = config
        c = config
        # fast windows drive scale-up; slow windows gate scale-down and
        # report budget remaining
        self._ttft_fast = BudgetWindow(c.fast_window_steps,
                                       TTFT_P95_ALLOWED)
        self._ttft_slow = BudgetWindow(c.slow_window_steps,
                                       TTFT_P95_ALLOWED)
        self._shed_fast = BudgetWindow(c.fast_window_steps,
                                       c.target_shed_rate)
        self._shed_slow = BudgetWindow(c.slow_window_steps,
                                       c.target_shed_rate)
        # per-step accumulators, flushed into the windows at observe_step
        self._ttft_pending = [0, 0]    # good, over-target
        self._shed_pending = [0, 0]    # finished, shed
        self._quiet_steps = 0
        self._last_scale_step: Optional[int] = None
        self._last_overload = 0.0
        self._step = 0

    # ------------------------------------------------------------------
    # evidence
    def observe_requests(self, records: Iterable[dict]) -> None:
        """Feed terminal request records (``RouterRequest.record()`` /
        ``Request.record()`` payloads: ``state``, ``ttft_ms``)."""
        c = self.config
        for r in records:
            if r.get("state") == "shed":
                self._shed_pending[1] += 1
                continue
            self._shed_pending[0] += 1
            ttft = r.get("ttft_ms")
            if c.target_ttft_p95_ms > 0 and ttft is not None:
                over = float(ttft) > c.target_ttft_p95_ms
                self._ttft_pending[1 if over else 0] += 1

    def observe_step(self, overload: float) -> None:
        """Close the step: flush pending request evidence into the burn
        windows and advance the quiet streak."""
        self._step += 1
        for w in (self._ttft_fast, self._ttft_slow):
            w.observe(*self._ttft_pending)
        for w in (self._shed_fast, self._shed_slow):
            w.observe(*self._shed_pending)
        self._ttft_pending = [0, 0]
        self._shed_pending = [0, 0]
        self._last_overload = float(overload)
        if (overload <= self.config.scale_down_load
                and not self._burning(fast=True)):
            self._quiet_steps += 1
        else:
            self._quiet_steps = 0

    # ------------------------------------------------------------------
    # policy
    def _burns(self, fast: bool) -> Dict[str, Optional[float]]:
        c = self.config
        out = {}
        if c.target_ttft_p95_ms > 0:
            out["ttft"] = (self._ttft_fast if fast
                           else self._ttft_slow).burn_rate()
        if c.target_shed_rate > 0:
            out["shed"] = (self._shed_fast if fast
                           else self._shed_slow).burn_rate()
        return out

    def _burning(self, fast: bool) -> bool:
        thr = self.config.burn_rate_fast if fast else 1.0
        return any(b is not None and b >= thr
                   for b in self._burns(fast).values())

    def _cooled(self, steps: int) -> bool:
        return (self._last_scale_step is None
                or self._step - self._last_scale_step >= steps)

    def decide(self, active: int, *, can_grow: bool = True,
               can_shrink: bool = True,
               overload: Optional[float] = None) -> Optional[Decision]:
        """One decision per call (the fleet manager calls once per
        step, after :meth:`observe_step`). ``overload`` defaults to the
        value the last :meth:`observe_step` saw."""
        c = self.config
        if overload is None:
            overload = self._last_overload
        if can_grow and active < c.max_replicas \
                and self._cooled(c.scale_up_cooldown_steps):
            burns = self._burns(fast=True)
            hot = [(k, b) for k, b in burns.items()
                   if b is not None and b >= c.burn_rate_fast]
            if hot:
                name, burn = max(hot, key=lambda kv: kv[1])
                return self._mark(Decision(SCALE_UP, f"{name}_burn",
                                           self._step, burn=burn,
                                           overload=overload))
            if overload >= c.scale_up_load:
                return self._mark(Decision(SCALE_UP, "load", self._step,
                                           overload=overload))
        if can_shrink and active > c.min_replicas \
                and self._quiet_steps >= c.scale_down_quiet_steps \
                and self._cooled(c.scale_down_cooldown_steps) \
                and not self._burning(fast=False):
            return self._mark(Decision(SCALE_DOWN, "quiet", self._step,
                                       overload=overload))
        return None

    def _mark(self, decision: Decision) -> Decision:
        self._last_scale_step = self._step
        self._quiet_steps = 0
        return decision

    # ------------------------------------------------------------------
    def budget_remaining(self) -> Dict[str, Optional[float]]:
        """Slow-window budget remaining per enabled SLO (the number the
        fleet gauge event and ``FleetManager.stats()`` surface)."""
        c = self.config
        out: Dict[str, Optional[float]] = {}
        if c.target_ttft_p95_ms > 0:
            out["ttft"] = self._ttft_slow.remaining()
        if c.target_shed_rate > 0:
            out["shed"] = self._shed_slow.remaining()
        return out

    def burn_rates(self) -> Dict[str, Dict[str, Optional[float]]]:
        """Fast- and slow-window burn rates per enabled SLO —
        ``{"ttft": {"fast": ..., "slow": ...}, ...}`` (values None with
        no window evidence). The internal numbers the scale-up policy
        acts on, made externally visible: the metrics plane exports
        them as ``ds_slo_burn_rate{slo,window}`` gauges."""
        fast, slow = self._burns(fast=True), self._burns(fast=False)
        return {name: {"fast": fast.get(name), "slow": slow.get(name)}
                for name in fast}
