"""Step sentinel (counterpart of
``deepspeed_tpu/runtime/resilience/sentinel.py``): NaN/Inf and loss-spike
detection beyond the fp16 path.

The fp16 overflow machinery already skips bad steps — but only when fp16
loss scaling is on. bf16/fp32 runs would have no protection:
a NaN storm silently corrupts the weights and every checkpoint after it.
The sentinel watches the per-step loss at each optimizer boundary and
applies the configured policy (``resilience.sentinel.policy``):

- ``warn``     — loud log + fault event, training continues;
- ``skip``     — the grads NaN/Inf check is force-enabled in the
  engine's step (the same ``has_inf_or_nan`` → skip-update path fp16
  overflow uses, so a skipped step leaves the trajectory identical to an
  fp16 overflow skip: params/optimizer untouched, ``global_step+1``,
  ``skipped_steps+1``); the host-side sentinel reports the trip;
- ``abort``    — raise :class:`SentinelAbort` out of ``engine.step()``
  (a supervisor restarts from the last verified-good checkpoint);
- ``rollback`` — restore the last verified-good checkpoint in place and
  report how many optimizer steps the data pipeline must fast-forward.

Host-sync discipline: reading a device loss forces a sync, which would
drain the launch queue. The sentinel therefore holds each boundary's
loss for ``sync_lag`` further boundaries before fetching it — by then the
value has long materialized and ``float()`` is free. ``sync_lag: 0``
checks immediately (tests / tight safety); engines that already fetched
the loss (``train_batch`` returns a float) feed the synced value in
directly so no second fetch ever happens.
"""

import math
from collections import deque
from typing import Callable, Optional

from deepspeed_tpu_torch.utils.logging import logger


class SentinelAbort(RuntimeError):
    """Raised out of ``engine.step()`` under ``policy: abort`` (and when
    ``rollback`` exhausts ``max_rollbacks``)."""


class StepSentinel:
    """Boundary-loss monitor. ``on_trip(step, value, reason)`` is invoked
    for every detection; policy dispatch lives in the resilience manager
    (rollback needs the engine)."""

    def __init__(self, config, on_trip: Optional[Callable] = None):
        self.config = config
        self.on_trip = on_trip or (lambda step, value, reason: None)
        self._window = deque(maxlen=max(1, int(config.loss_window)))
        self._pending = deque()   # (step, device-or-host loss)
        self._last_judged = None  # a boundary is judged at most ONCE
        self.trips = []           # (step, value, reason)

    # ------------------------------------------------------------------
    def observe(self, step: int, loss):
        """Record a boundary's loss (device array or scalar) and check
        any entries older than ``sync_lag`` boundaries."""
        if loss is None:
            return
        self._pending.append((int(step), loss))
        while len(self._pending) > max(0, int(self.config.sync_lag)):
            s, v = self._pending.popleft()
            self._check(s, v)

    def observe_value(self, step: int, value: float):
        """Feed an already-synced loss (e.g. ``train_batch``'s float) —
        replaces this boundary's lagged entry entirely (the same step
        must never be judged twice)."""
        step = int(step)
        if self._pending:
            self._pending = deque((s, v) for s, v in self._pending
                                  if s != step)
        self._check(step, value)

    def drain(self):
        """Force-check everything pending (end of run / before abort)."""
        while self._pending:
            s, v = self._pending.popleft()
            self._check(s, v)

    def reset(self):
        """Forget history (after a rollback the restored trajectory must
        not be judged against the diverged window — and its rewound step
        numbers must be judgeable again)."""
        self._pending.clear()
        self._window.clear()
        self._last_judged = None

    # ------------------------------------------------------------------
    def _check(self, step: int, value):
        if self._last_judged is not None and step <= self._last_judged:
            # the synced path (observe_value) and the lagged queue can
            # both see a boundary with sync_lag=0 — one verdict per step
            return
        self._last_judged = step
        try:
            v = float(value)
        except (TypeError, ValueError):
            return
        if not math.isfinite(v):
            self._trip(step, v, "nonfinite")
            return
        factor = float(self.config.loss_spike_factor)
        if (factor > 0 and len(self._window) >= int(self.config.min_history)):
            # median baseline: one early outlier in the window must not
            # drag the threshold up (a mean would let the next spike hide
            # behind the last one)
            ordered = sorted(self._window)
            mid = len(ordered) // 2
            baseline = (ordered[mid] if len(ordered) % 2
                        else (ordered[mid - 1] + ordered[mid]) / 2.0)
            if v > factor * max(abs(baseline), 1e-8):
                self._trip(step, v, "loss_spike")
                return
        self._window.append(v)

    def _trip(self, step: int, value, reason: str):
        self.trips.append((step, value, reason))
        logger.warning(
            f"[resilience] SENTINEL TRIP at step {step}: loss={value} "
            f"({reason}); policy={self.config.policy!r}")
        self.on_trip(step, value, reason)
