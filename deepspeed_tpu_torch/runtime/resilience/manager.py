"""Resilience manager (counterpart of
``deepspeed_tpu/runtime/resilience/manager.py``) — the per-engine facade
over the fault-tolerance layer, with the telemetry manager's contract:
construction is cheap, it is off by default, and a disabled manager is a
single bool check on the hot path (an engine dispatches the same aten ops
with it off as without it).

Pieces:

1. **checkpoint integrity** — :meth:`wrap_checkpoint_engine` threads the
   engine's checkpoint tier through
   :class:`~deepspeed_tpu_torch.runtime.resilience.integrity.ResilientCheckpointEngine`
   (manifest commit, verify-on-load, retry, retention);
2. **step sentinel** — NaN/Inf + loss-spike detection at every optimizer
   boundary with policy ``warn | skip | abort | rollback``
   (:mod:`~deepspeed_tpu_torch.runtime.resilience.sentinel`); ``skip``
   turns the fp16-style overflow check on in the engine's step
   (:attr:`sentinel_in_graph`), so a skipped step matches an fp16
   overflow skip bit for bit;
3. **hang watchdog** — background stall detector with stack dump +
   clean abort (:mod:`~deepspeed_tpu_torch.runtime.resilience.watchdog`);
4. faults land as ``fault`` telemetry events (when telemetry is on) and
   in a local ring buffer either way — the tail the watchdog dumps.
"""

import contextlib
from collections import deque
from typing import Callable, Optional

from deepspeed_tpu_torch.runtime.resilience.sentinel import (
    SentinelAbort, StepSentinel)
from deepspeed_tpu_torch.runtime.resilience.watchdog import HangWatchdog
from deepspeed_tpu_torch.utils.logging import log_dist, logger


def _as_config(config):
    """Accept a parsed ResilienceConfig, a raw dict, or None."""
    if config is None:
        config = {}
    if isinstance(config, dict):
        from deepspeed_tpu_torch.runtime.config import ResilienceConfig

        config = ResilienceConfig(**config)
    return config


def fast_forward(data_iter, n_batches: int) -> int:
    """Advance a batch iterator past ``n_batches`` MICRO-batches (the
    data-pipeline half of a rollback: the restored step counter is behind
    the stream — pass the rollback info's ``micro_batches_to_replay``).
    Returns how many batches were actually consumed."""
    consumed = 0
    sentinel = object()
    for _ in range(max(0, int(n_batches))):
        if next(data_iter, sentinel) is sentinel:
            break
        consumed += 1
    return consumed


class Resilience:
    def __init__(self, config=None, telemetry=None, name: str = "engine",
                 serving: bool = False):
        self.config = _as_config(config)
        self.enabled = bool(self.config.enabled)
        self.name = name
        self.serving = bool(serving)
        self.telemetry = telemetry
        self.fault_tail = deque(maxlen=128)
        self._closing = False
        self.sentinel: Optional[StepSentinel] = None
        self.watchdog: Optional[HangWatchdog] = None
        self.rollbacks = 0
        # user hook called after each sentinel rollback with an info dict
        # ({"restored_tag", "restored_step", "failed_step",
        #   "steps_to_replay", "micro_batches_to_replay"}) — the place to
        # fast-forward a data iterator the engine does not own:
        # fast_forward(data_iter, info["micro_batches_to_replay"])
        # (iterators yield MICRO-batches; steps_to_replay counts
        # optimizer steps, gas micro-batches each)
        self.on_rollback: Optional[Callable] = None
        self._engine = None
        self._rollback_dir = None
        if not self.enabled:
            return
        if self.config.sentinel.enabled:
            self.sentinel = StepSentinel(self.config.sentinel,
                                         on_trip=self._handle_trip)
        wd = self.config.watchdog
        if wd.enabled:
            self.watchdog = HangWatchdog(
                timeout_secs=wd.timeout_secs, poll_secs=wd.poll_secs,
                dump_dir=wd.dump_dir, abort=wd.abort,
                exit_code=wd.exit_code, name=name,
                tail_fn=self.tail, emit=self.emit_fault,
                flush=self._flush_telemetry,
                # serving: an idle gap between requests is healthy — the
                # stall timer only runs while a request is in flight
                # (training step cadence is continuous, so any gap counts)
                idle_ok=self.serving)

    # ------------------------------------------------------------------
    # fault event plumbing
    def emit_fault(self, event_name: str, step: Optional[int] = None,
                   **data):
        event = {"name": event_name, "step": step, **data}
        self.fault_tail.append(event)
        if self.telemetry is not None:
            self.telemetry.emit("fault", event_name, step=step, data=data)

    def tail(self, n: int = 50):
        """Recent events for the watchdog dump: the telemetry tail when
        telemetry is live, this manager's fault tail otherwise."""
        if self.telemetry is not None and getattr(self.telemetry, "enabled",
                                                  False):
            tele_tail = self.telemetry.tail(n)
            if tele_tail:
                return tele_tail
        return list(self.fault_tail)[-n:]

    def _flush_telemetry(self):
        if self.telemetry is not None:
            self.telemetry.flush()

    # ------------------------------------------------------------------
    # piece 1: checkpoint integrity
    def wrap_checkpoint_engine(self, inner):
        """Thread a checkpoint engine through the integrity layer (no-op
        when resilience or its checkpoint integrity is off)."""
        if not self.enabled or not self.config.checkpoint.integrity:
            return inner
        from deepspeed_tpu_torch.runtime.resilience.integrity import (
            ResilientCheckpointEngine)

        return ResilientCheckpointEngine(inner, self.config.checkpoint,
                                         emit=self.emit_fault)

    def note_save_dir(self, save_dir: str):
        """Remember where checkpoints go (the rollback target when
        ``resilience.checkpoint.rollback_dir`` is not pinned)."""
        self._rollback_dir = save_dir

    # ------------------------------------------------------------------
    # piece 2: step sentinel
    @property
    def sentinel_in_graph(self) -> bool:
        """``policy: skip`` runs the fp16-style grads NaN/Inf check in
        the step regardless of precision mode — the only change to the
        step resilience can make, and only under this policy."""
        return (self.enabled and self.sentinel is not None
                and self.config.sentinel.policy == "skip")

    def _handle_trip(self, step: int, value, reason: str):
        policy = self.config.sentinel.policy
        self.emit_fault("sentinel.trip", step=step, loss=value,
                        reason=reason, policy=policy)
        if self._closing:
            # close-time drain: surface the trip loudly (event + the
            # sentinel's own warning) but never abort or roll back a
            # teardown in progress
            return
        if policy == "warn":
            return
        if policy == "skip":
            # the step's check already refused the update for nonfinite
            # grads; a loss *spike* has finite grads — nothing in the step
            # to skip, so it degrades to the warn above (documented)
            return
        if policy == "abort":
            self._flush_telemetry()
            raise SentinelAbort(
                f"sentinel abort at step {step}: loss={value} ({reason}) — "
                "restart and resume from the last verified-good checkpoint")
        if policy == "rollback":
            self._rollback(step, value, reason)

    def _rollback(self, step: int, value, reason: str):
        engine = self._engine
        save_dir = self.config.checkpoint.rollback_dir or self._rollback_dir
        if engine is None or save_dir is None:
            logger.warning(
                "[resilience] sentinel policy is 'rollback' but no "
                "checkpoint directory is known (no save_checkpoint yet and "
                "no resilience.checkpoint.rollback_dir) — degrading to "
                "warn for this trip")
            self.emit_fault("sentinel.rollback_unavailable", step=step,
                            reason=reason)
            return
        self.rollbacks += 1
        limit = int(self.config.sentinel.max_rollbacks)
        if limit > 0 and self.rollbacks > limit:
            self._flush_telemetry()
            raise SentinelAbort(
                f"sentinel rolled back {self.rollbacks - 1}x already "
                f"(max_rollbacks={limit}) and tripped again at step {step} "
                f"({reason}) — the divergence is persistent; aborting")
        tag, _ = engine.load_checkpoint(save_dir)
        if tag is None:
            self._flush_telemetry()
            raise SentinelAbort(
                f"sentinel rollback at step {step} found no checkpoint in "
                f"{save_dir!r}")
        self.sentinel.reset()  # the restored trajectory starts fresh
        restored_step = engine.global_steps
        replay = max(0, step - restored_step)
        try:
            gas = int(engine.gradient_accumulation_steps())
        except Exception:
            gas = 1
        info = {"restored_tag": str(tag), "restored_step": restored_step,
                "failed_step": step,
                "steps_to_replay": replay,
                # what a batch ITERATOR must skip: the failed trajectory
                # consumed gas micro-batches per optimizer step — pass
                # THIS to fast_forward(data_iter, n)
                "micro_batches_to_replay": replay * max(1, gas)}
        self.emit_fault("sentinel.rollback", step=step, loss=value,
                        reason=reason, **info)
        log_dist(
            f"[resilience] ROLLBACK: step {step} tripped the sentinel "
            f"({reason}); restored {tag!r} at step {restored_step} — "
            f"fast-forward the data pipeline {info['steps_to_replay']} "
            f"optimizer step(s) = {info['micro_batches_to_replay']} "
            "micro-batch(es)", ranks=[0])
        if self.on_rollback is not None:
            self.on_rollback(info)
        return info

    # ------------------------------------------------------------------
    # step-boundary hook (one call per optimizer step, from the engines)
    def on_step_boundary(self, engine, step: int, loss=None):
        if not self.enabled:
            return
        self._engine = engine
        if self.watchdog is not None:
            self.watchdog.start()
            self.watchdog.notify(step)
        if self.sentinel is not None:
            self.sentinel.observe(step, loss)

    def observe_synced_loss(self, step: int, value: float):
        """Engines that already fetched the loss (``train_batch`` returns
        a float) hand it over so the sentinel never forces a second
        device sync."""
        if self.enabled and self.sentinel is not None:
            self.sentinel.observe_value(step, value)

    def drain_sentinel(self):
        """Force-check every pending lagged loss NOW. Called before a
        checkpoint save (a still-unjudged NaN boundary must not become a
        verified-good checkpoint) and at close (the final boundary's loss
        would otherwise never be judged)."""
        if self.enabled and self.sentinel is not None:
            self.sentinel.drain()

    def serving_request_begin(self):
        """Serving engines: a request entered the engine — the watchdog
        stall timer runs until the matching :meth:`serving_heartbeat`."""
        if self.enabled and self.watchdog is not None:
            self.watchdog.start()
            self.watchdog.busy_begin()

    @contextlib.contextmanager
    def watchdog_suspended(self):
        """Pause the hang watchdog for a known-long non-step phase (a
        checkpoint save to a slow blob store can legitimately outlast the
        step timeout; killing the job mid-save would abort the very write
        that makes restarts safe)."""
        wd = self.watchdog if self.enabled else None
        if wd is not None:
            wd.suspend()
        try:
            yield
        finally:
            if wd is not None:
                wd.resume()

    def serving_step_progress(self):
        """Serving engines: a decode step completed (tokens observed on
        the host) without finishing any request — refresh the stall timer
        so a server saturated with long generations is never judged hung
        between completions. Touch only: brackets and arming untouched."""
        if self.enabled and self.watchdog is not None:
            self.watchdog.touch()

    def serving_request_abandon(self):
        """A request raised before completing: clear its busy bracket so
        the idle server is not later judged hung by a leaked counter."""
        if self.enabled and self.watchdog is not None:
            self.watchdog.busy_end()

    def serving_heartbeat(self, count: int):
        """Serving engines: request completion feeds the watchdog (a hung
        generate step is a hung collective too; idle gaps between
        requests do not count as stalls)."""
        if self.enabled and self.watchdog is not None:
            self.watchdog.start()
            self.watchdog.notify(count)
            self.watchdog.busy_end()

    # ------------------------------------------------------------------
    def summary(self):
        return {
            "enabled": self.enabled,
            "sentinel_trips": list(getattr(self.sentinel, "trips", [])),
            "rollbacks": self.rollbacks,
            "watchdog_fired": bool(getattr(self.watchdog, "fired", False)),
            "faults": list(self.fault_tail),
        }

    def close(self):
        # judge any still-pending lagged losses first — loudly (event +
        # warning) but without abort/rollback side effects mid-teardown
        self._closing = True
        try:
            self.drain_sentinel()
        finally:
            self._closing = False
        if self.watchdog is not None:
            self.watchdog.stop()
        self._engine = None
