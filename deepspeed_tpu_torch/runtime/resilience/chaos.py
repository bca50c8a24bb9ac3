"""Deterministic fault injectors for the resilience test harness
(counterpart of ``deepspeed_tpu/runtime/resilience/chaos.py``).

Production code never fails on purpose; proving the degradation paths
(checkpoint retry, fallback-to-last-good, sentinel trip, watchdog dump,
failover, migration) therefore needs seams where faults can be injected
*deterministically*. This module is that seam:

- :func:`io_errors` — arm transient failures at a named injection point
  (the resilient checkpoint engine calls :func:`raise_if` at
  ``ckpt.save``, ``ckpt.load`` and ``ckpt.commit``; the serving engine at
  ``serving.spec_commit``, ``serving.migration.export`` and
  ``serving.migration.commit``, the migrator at
  ``serving.migration.transfer``); "fail the Nth call, M times" is exact.
- :func:`corrupt_checkpoint` / :func:`truncate_file` — flip bytes in (or
  cut) a committed checkpoint file: the failures integrity verification
  exists to catch.
- :func:`nan_batches` / :func:`poison_batch` — NaN-poison one batch's
  float leaf (the first step of a NaN storm, as the gradients see it).
- :func:`send_sigterm` / :func:`preempt_at_step` — a real SIGTERM to this
  process, now or at a chosen step (a preemption notice).
- :class:`ChaosReplica` — replica-level faults for the multi-replica
  serving router: crash at decode step N (:class:`ReplicaCrashed`),
  transient flaky step/submit, stall, slow decode, a crash between
  export and import.
- :class:`FlakyFactory` — faults at the fleet manager's
  ``ReplicaFactory`` scale-up seam: N failed builds (the autoscaler's
  exponential-backoff food), injectable build stalls.
- :func:`simulate_stall` — block the calling thread (a hung step, as the
  host observes it).

All injectors are process-local and OFF by default;
:func:`raise_if` costs one module-level ``if`` when nothing is armed.
"""

import os
import signal
import threading
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

_LOCK = threading.Lock()
_FAULTS: Dict[str, "_IOFault"] = {}


class ChaosIOError(OSError):
    """The injected transient error (an OSError subclass so retry paths
    treat it exactly like a real flaky transport)."""


class _IOFault:
    def __init__(self, at_call: int, times: int, exc: type):
        self.at_call = int(at_call)   # 1-indexed call number to start failing
        self.times = int(times)       # how many consecutive calls fail
        self.exc = exc
        self.calls = 0                # calls observed at this point
        self.raised = 0               # failures actually injected

    def should_raise(self) -> bool:
        self.calls += 1
        if self.at_call <= self.calls < self.at_call + self.times:
            self.raised += 1
            return True
        return False


def io_errors(point: str, at_call: int = 1, times: int = 1,
              exc: type = ChaosIOError) -> "_Armed":
    """Arm ``times`` consecutive failures at injection ``point`` starting
    with its ``at_call``-th call (1-indexed). Returns a context manager /
    handle; the fault also disarms process-wide via :func:`clear`.

    Known points: ``"ckpt.save"``, ``"ckpt.load"``, ``"ckpt.commit"``,
    ``"serving.spec_commit"``,
    ``"serving.migration.export"``, ``"serving.migration.transfer"``,
    ``"serving.migration.commit"``.
    """
    fault = _IOFault(at_call, times, exc)
    with _LOCK:
        _FAULTS[point] = fault
    return _Armed(point, fault)


class _Armed:
    def __init__(self, point: str, fault: _IOFault):
        self.point = point
        self.fault = fault

    @property
    def raised(self) -> int:
        return self.fault.raised

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        with _LOCK:
            if _FAULTS.get(self.point) is self.fault:
                del _FAULTS[self.point]
        return False


def raise_if(point: str, detail: str = ""):
    """Injection hook — called at each named seam of the serving engine
    and the migrator. No-op unless a fault is armed at ``point``."""
    if not _FAULTS:  # fast path: chaos never armed in production
        return
    with _LOCK:
        fault = _FAULTS.get(point)
        if fault is None:
            return
        fire = fault.should_raise()
    if fire:
        raise fault.exc(
            f"chaos: injected IO error at {point!r}"
            + (f" ({detail})" if detail else "")
            + f" [call {fault.calls}]")


def clear():
    """Disarm every injector (test teardown)."""
    with _LOCK:
        _FAULTS.clear()


# ----------------------------------------------------------------------
# replica-level injectors (multi-replica serving front door)
class ReplicaCrashed(RuntimeError):
    """Fatal replica death (SIGKILLed engine process, unrecoverable
    device error). Routers treat any exception whose ``replica_dead``
    attribute is true as unrecoverable: the replica goes DEAD instead of
    merely tripping its breaker."""

    replica_dead = True


class ChaosReplica:
    """Deterministic replica-level fault injection for the serving
    router: wraps anything with the ``ServingEngine`` surface,
    delegating transparently until the armed fault fires.

    - ``crash_at_step=N`` — the Nth ``step()`` call (1-indexed, and every
      call after it) raises :class:`ReplicaCrashed` BEFORE the wrapped
      engine runs: the replica died mid-decode with requests in flight.
    - ``fail_step_at=N, fail_step_times=M`` — M consecutive ``step()``
      calls starting at the Nth raise transient :class:`ChaosIOError`
      (a flaky interconnect: the breaker's consecutive-failure food).
    - ``fail_submit_at=N, fail_submit_times=M`` — same, for ``submit()``
      (a flaky admission RPC; the router retries on another replica).
    - ``stall_at_step=N, stall_secs=S`` — the Nth step blocks for S
      seconds before running (a wedged collective, as the router's
      host-side stall timer observes it).
    - ``slow_decode_secs=S`` — EVERY step takes S extra seconds (a
      thermally-throttled or mis-sharded replica: the soft DEGRADED
      signal, not a trip).
    - ``crash_between_draft_and_commit=N`` — the Nth ``step()`` runs the
      wrapped engine with a one-shot :class:`ReplicaCrashed` armed at
      the serving engine's ``"serving.spec_commit"`` seam: a
      speculative-decoding replica dies AFTER the verify dispatch but
      BEFORE any token of the window commits — the hardest failover
      moment, where the exactly-once splice must see zero speculative
      tokens (the fault is armed only around this one delegated call,
      so a co-resident replica stepping through the same seam is never
      hit).
    - ``crash_during_migration=N`` — the Nth ``export_sequence()`` call
      (one-shot) performs the REAL export, then raises
      :class:`ReplicaCrashed`: the source dies between export and the
      target's table commit — the hardest migration moment, where the
      move must abort with the target's allocation released and the
      orchestrator falls back to replay with exactly-once delivery.
      The replica is dead from that point (later ``step()`` calls
      crash, as a killed process would).
    - ``flaky_transfer_at=N, flaky_transfer_times=M`` — M consecutive
      migrations starting with the Nth export lose their wire transfer:
      a one-shot transient :class:`ChaosIOError` armed at the
      ``"serving.migration.transfer"`` seam right after each export, so
      the fault lands between export and import — source untouched, the
      caller retries or replays.

    ``sleep`` is injectable so host-side tests drive stalls through a
    fake clock instead of wall time.
    """

    def __init__(self, replica, crash_at_step: int = 0,
                 fail_step_at: int = 0, fail_step_times: int = 1,
                 fail_submit_at: int = 0, fail_submit_times: int = 1,
                 stall_at_step: int = 0, stall_secs: float = 0.0,
                 slow_decode_secs: float = 0.0,
                 crash_between_draft_and_commit: int = 0,
                 crash_during_migration: int = 0,
                 flaky_transfer_at: int = 0, flaky_transfer_times: int = 1,
                 sleep=time.sleep):
        self.replica = replica
        self.crash_at_step = int(crash_at_step)
        self.crash_between_draft_and_commit = int(
            crash_between_draft_and_commit)
        self.fail_step_at = int(fail_step_at)
        self.fail_step_times = int(fail_step_times)
        self.fail_submit_at = int(fail_submit_at)
        self.fail_submit_times = int(fail_submit_times)
        self.stall_at_step = int(stall_at_step)
        self.stall_secs = float(stall_secs)
        self.slow_decode_secs = float(slow_decode_secs)
        self.crash_during_migration = int(crash_during_migration)
        self.flaky_transfer_at = int(flaky_transfer_at)
        self.flaky_transfer_times = int(flaky_transfer_times)
        self.sleep = sleep
        self.steps = 0
        self.submits = 0
        self.migration_exports = 0

    def submit(self, *args, **kwargs):
        self.submits += 1
        if (self.fail_submit_at and self.fail_submit_at <= self.submits
                < self.fail_submit_at + self.fail_submit_times):
            raise ChaosIOError(
                f"chaos: flaky submit [call {self.submits}]")
        return self.replica.submit(*args, **kwargs)

    def step(self):
        self.steps += 1
        if self.crash_at_step and self.steps >= self.crash_at_step:
            raise ReplicaCrashed(
                f"chaos: replica crashed at step {self.steps}")
        if (self.fail_step_at and self.fail_step_at <= self.steps
                < self.fail_step_at + self.fail_step_times):
            raise ChaosIOError(f"chaos: flaky step [call {self.steps}]")
        if self.stall_at_step and self.steps == self.stall_at_step \
                and self.stall_secs:
            self.sleep(self.stall_secs)
        if self.slow_decode_secs:
            self.sleep(self.slow_decode_secs)
        if (self.crash_between_draft_and_commit
                and self.steps >= self.crash_between_draft_and_commit):
            # one-shot, scoped to THIS delegated call: the wrapped
            # engine's raise_if("serving.spec_commit") fires between its
            # verify dispatch and commit loop
            with io_errors("serving.spec_commit", at_call=1,
                           exc=ReplicaCrashed):
                return self.replica.step()
        return self.replica.step()

    def __getattr__(self, name):
        # gauges/stats/pending/buckets/telemetry/... delegate untouched.
        # getattr-first keeps hasattr() semantics honest: a wrapped
        # replica WITHOUT the migration surface must still read as not
        # having one (the router's migrate-vs-replay probe depends on it)
        attr = getattr(self.replica, name)
        if name == "export_sequence" and (self.crash_during_migration
                                          or self.flaky_transfer_at):
            def export(request_id):
                self.migration_exports += 1
                n = self.migration_exports
                out = attr(request_id)
                if n == self.crash_during_migration:
                    # the export left the process; the process died —
                    # the fault lands between export and the target's
                    # table commit, and the replica stays dead
                    self.crash_at_step = max(1, self.steps)
                    raise ReplicaCrashed(
                        f"chaos: replica crashed mid-migration "
                        f"[export {n}]")
                if (self.flaky_transfer_at and self.flaky_transfer_at
                        <= n < self.flaky_transfer_at
                        + self.flaky_transfer_times):
                    # scoped one-shot: the orchestrator's very next
                    # "serving.migration.transfer" seam is THIS move's
                    io_errors("serving.migration.transfer", at_call=1)
                return out

            return export
        return attr


class FlakyFactory:
    """Deterministic faults for the fleet manager's ``ReplicaFactory``
    seam: wraps a factory (or a zero-arg builder callable); the first
    ``fail_times`` ``build()`` calls raise transient
    :class:`ChaosIOError` (the autoscaler must back off exponentially,
    not hammer), and ``stall_secs`` blocks before every build through
    the injectable ``sleep`` (a cold container pull, as the fleet
    observes it — drive it with a fake clock in tests)."""

    def __init__(self, factory, fail_times: int = 0,
                 stall_secs: float = 0.0, sleep=time.sleep):
        self.factory = factory
        self.fail_times = int(fail_times)
        self.stall_secs = float(stall_secs)
        self.sleep = sleep
        self.builds = 0     # build() calls observed
        self.failures = 0   # failures actually injected

    @property
    def warm(self) -> bool:
        return bool(getattr(self.factory, "warm", False))

    def build(self):
        self.builds += 1
        if self.stall_secs:
            self.sleep(self.stall_secs)
        if self.builds <= self.fail_times:
            self.failures += 1
            raise ChaosIOError(
                f"chaos: replica factory failed [build {self.builds}]")
        build = getattr(self.factory, "build", None)
        return build() if build is not None else self.factory()


# ----------------------------------------------------------------------
# post-commit corruption (bitrot / partial upload)
def corrupt_checkpoint(tag_dir: str, filename: Optional[str] = None,
                       offset: int = 0, nbytes: int = 8) -> str:
    """Flip ``nbytes`` bytes of one payload file inside a committed
    checkpoint tag directory (the largest file when ``filename`` is not
    given — the array payload, where silent corruption hurts most).
    Returns the path corrupted."""
    if filename is not None:
        target = os.path.join(tag_dir, filename)
    else:
        candidates = []
        for base, _, files in os.walk(tag_dir):
            for fn in files:
                if fn.startswith("."):
                    continue  # never the integrity manifest itself
                p = os.path.join(base, fn)
                candidates.append((os.path.getsize(p), p))
        if not candidates:
            raise FileNotFoundError(f"no files to corrupt under {tag_dir}")
        target = max(candidates)[1]
    size = os.path.getsize(target)
    if size == 0:
        raise ValueError(f"cannot corrupt empty file {target}")
    offset = min(max(0, offset), max(0, size - nbytes))
    with open(target, "r+b") as f:
        f.seek(offset)
        chunk = f.read(nbytes)
        f.seek(offset)
        f.write(bytes((b ^ 0xFF) for b in chunk))
        f.flush()
        os.fsync(f.fileno())
    return target


def truncate_file(path: str, keep_bytes: int = 0):
    """Simulate a crash mid-write: keep only the first ``keep_bytes``."""
    with open(path, "r+b") as f:
        f.truncate(int(keep_bytes))


# ----------------------------------------------------------------------
# NaN gradients at step K
def _leaves(tree):
    """Leaves of a batch in the JAX package's flatten order (dict keys
    sorted, sequences in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def _is_float(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    return np.asarray(leaf).dtype.kind == "f"


def nan_batches(batches: Iterable, at: int, leaf_index: int = 0):
    """Yield from ``batches``, replacing the ``at``-th batch's (0-indexed)
    ``leaf_index``-th float leaf with NaNs (a tensor stays a tensor, an
    array an array). Gradients of that micro-step are NaN — exactly what
    the step sentinel must catch."""
    for i, batch in enumerate(batches):
        if i == at:
            poisoned, float_seen = [], 0
            for leaf in _leaves(batch):
                if _is_float(leaf):
                    if float_seen == leaf_index:
                        leaf = (torch.full_like(leaf, float("nan"))
                                if isinstance(leaf, torch.Tensor)
                                else np.full_like(np.asarray(leaf), np.nan))
                    float_seen += 1
                poisoned.append(leaf)
            batch = _rebuild(batch, iter(poisoned))
        yield batch


def poison_batch(batch, leaf_index: int = 0):
    """NaN-poison one batch directly (the single-batch form of
    :func:`nan_batches`)."""
    return next(nan_batches([batch], at=0, leaf_index=leaf_index))


# ----------------------------------------------------------------------
# preemption + stall
def send_sigterm():
    """Deliver a real SIGTERM to this process (a preemption notice)."""
    os.kill(os.getpid(), signal.SIGTERM)


def preempt_at_step(at_step: int, deliver=send_sigterm):
    """Arm a deterministic preemption: returns a ``tick()`` to call once
    per optimizer step; the ``at_step``-th call (1-indexed) delivers the
    preemption notice (default: a real SIGTERM; pass another callable for
    signal-free tests). ``tick`` returns True on the call that fired;
    ``tick.state`` exposes ``{"calls", "fired"}``."""
    state = {"calls": 0, "fired": False}

    def tick() -> bool:
        state["calls"] += 1
        if state["calls"] == int(at_step) and not state["fired"]:
            state["fired"] = True
            deliver()
            return True
        return False

    tick.state = state
    return tick


def simulate_stall(seconds: float):
    """Block the calling thread (a hung collective, as the host observes
    it): step-boundary progress stops while the watchdog keeps polling."""
    time.sleep(float(seconds))
