"""Pre-fault flight recorder (counterpart of
``deepspeed_tpu/telemetry/flightrec.py``): the last N seconds of context,
on disk.

The JSONL sink records everything but lands wherever the run's
telemetry dir is; when a watchdog kills the process or a breaker trips
mid-incident, the question is always "what was happening in the 30 s
before" — and the answer should be one self-contained directory, not a
grep over a multi-gigabyte stream. The recorder keeps a bounded
in-memory ring of recent telemetry events (spans ride the same stream
as ``span``-kind events) plus periodic metric-registry snapshots,
continuously armed, and dumps them **atomically** to
``<dump_dir>/flightrec-<ts>/`` when something goes wrong:

- any ``fault`` event (sentinel trip/rollback, checkpoint fallback,
  watchdog fire — the resilience layer routes them all through the
  telemetry stream),
- a router ``breaker.trip``,
- SIGTERM (preemption), via a chained signal handler,
- or an explicit :meth:`dump` call.

Dump layout::

    flightrec-<ts>/
      meta.json        # reason, trigger event, counters, wall ts
      events.jsonl     # the event ring, oldest first (spans included)
      snapshots.jsonl  # metric-registry snapshots ring
      metrics.prom     # exposition text at dump time (registry armed)

Atomicity: everything is written into a ``.tmp`` sibling and the
directory is ``os.replace``d into place — a crash mid-dump leaves a
``.tmp`` orphan, never a half-readable dump. Dumps are bounded
(``max_dumps`` per process) so a fault storm cannot fill the disk.

Host-only; exception-isolated — recording and dumping never raise into
the step or serving loop. The dump layout is the JAX package's, so either
package's ``load_dump`` reads the other's dumps.
"""

import json
import os
import signal
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from deepspeed_tpu_torch.telemetry.events import dumps as event_dumps
from deepspeed_tpu_torch.utils.logging import logger

# telemetry event (kind, name-prefix) pairs that trigger a dump; the
# recorder's own marker events are excluded by the flightrec. prefix
# check so a dump can never re-trigger itself
TRIGGER_KINDS = ("fault",)
TRIGGER_EVENTS = (("router", "breaker.trip"),)


def is_trigger(kind: str, name: str) -> bool:
    if str(name).startswith("flightrec."):
        return False
    if kind in TRIGGER_KINDS:
        return True
    return any(kind == k and name == n for k, n in TRIGGER_EVENTS)


class FlightRecorder:
    def __init__(self, dump_dir: str, *, events: int = 512,
                 snapshots: int = 64, max_dumps: int = 4):
        self.dump_dir = dump_dir
        self.max_dumps = int(max_dumps)
        self.dumps: List[str] = []
        self._events = deque(maxlen=int(events))
        self._snapshots = deque(maxlen=max(0, int(snapshots)))
        # reentrant: a SIGTERM handler runs in the main thread between
        # bytecodes — if it fires while that same thread holds the lock
        # inside record_event, dump() must still be able to take it (a
        # plain Lock would deadlock the process at the exact moment the
        # recorder exists for)
        self._lock = threading.RLock()
        self._seq = 0

    # ------------------------------------------------------------------
    # recording (hot path: one deque append under a lock)
    def record_event(self, event: Dict) -> None:
        with self._lock:
            self._events.append(event)

    def record_snapshot(self, step: Optional[int],
                        snapshot: Dict) -> None:
        if self._snapshots.maxlen == 0:
            return
        with self._lock:
            self._snapshots.append({"step": step, "snapshot": snapshot})

    def tail(self, n: int = 50) -> List[Dict]:
        with self._lock:
            return list(self._events)[-n:]

    # ------------------------------------------------------------------
    def dump(self, reason: str, registry=None,
             trigger: Optional[Dict] = None) -> Optional[str]:
        """Write the rings to a fresh ``flightrec-<ts>`` directory.
        Returns the final path, or None (dump budget spent, or IO
        failed — never raises)."""
        try:
            with self._lock:
                if len(self.dumps) >= self.max_dumps:
                    return None
                events = list(self._events)
                snapshots = list(self._snapshots)
                self._seq += 1
                seq = self._seq
            ts = int(time.time())
            final = os.path.join(self.dump_dir,
                                 f"flightrec-{ts}-{seq}")
            tmp = final + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            meta = {
                "reason": reason,
                "wall_ts": ts,
                "events": len(events),
                "snapshots": len(snapshots),
                "trigger": trigger,
                "last_step": next(
                    (e.get("step") for e in reversed(events)
                     if e.get("step") is not None), None),
            }
            self._write(os.path.join(tmp, "meta.json"),
                        json.dumps(meta, indent=2, sort_keys=True) + "\n")
            self._write(os.path.join(tmp, "events.jsonl"),
                        "".join(event_dumps(e) + "\n" for e in events))
            self._write(
                os.path.join(tmp, "snapshots.jsonl"),
                "".join(json.dumps(s, sort_keys=True) + "\n"
                        for s in snapshots))
            if registry is not None:
                try:
                    self._write(os.path.join(tmp, "metrics.prom"),
                                registry.expose())
                except Exception:  # noqa: BLE001 — partial dump > none
                    pass
            os.replace(tmp, final)
            with self._lock:
                self.dumps.append(final)
            logger.warning(f"flight recorder: dumped {len(events)} "
                           f"event(s) + {len(snapshots)} snapshot(s) to "
                           f"{final} (reason: {reason})")
            return final
        except Exception as e:  # noqa: BLE001 — never raise into a step
            logger.warning(f"flight recorder: dump failed ({e})")
            return None

    @staticmethod
    def _write(path: str, text: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())


def load_dump(path: str) -> Dict:
    """Read one ``flightrec-<ts>`` directory back (report-tool side)."""
    out: Dict = {"path": path, "meta": {}, "events": [], "snapshots": []}
    meta = os.path.join(path, "meta.json")
    if os.path.isfile(meta):
        with open(meta, encoding="utf-8") as f:
            out["meta"] = json.load(f)
    for key, fname in (("events", "events.jsonl"),
                       ("snapshots", "snapshots.jsonl")):
        p = os.path.join(path, fname)
        if not os.path.isfile(p):
            continue
        with open(p, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out[key].append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    prom = os.path.join(path, "metrics.prom")
    if os.path.isfile(prom):
        with open(prom, encoding="utf-8") as f:
            out["metrics_text"] = f.read()
    return out


def find_dumps(dir_path: str) -> List[str]:
    """Completed ``flightrec-*`` dump dirs under ``dir_path``, oldest
    first (``.tmp`` orphans from a crash mid-dump are excluded)."""
    if not os.path.isdir(dir_path):
        return []
    return sorted(
        os.path.join(dir_path, d) for d in os.listdir(dir_path)
        if d.startswith("flightrec-") and not d.endswith(".tmp")
        and os.path.isdir(os.path.join(dir_path, d)))


def arm_sigterm(callback):
    """Chain ``callback`` in front of the current SIGTERM disposition
    (preemption is a dump trigger). Returns a zero-arg ``disarm``
    callable — ``Telemetry.close()`` MUST call it so a closed
    recorder's handler becomes an inert pass-through (the chain link
    stays installed but drops its strong reference to the callback, so
    multi-lifecycle processes neither re-dump stale rings on SIGTERM
    nor leak every Telemetry ever built). Returns None where handlers
    cannot be installed (non-main thread) — the recorder still works
    for every other trigger."""
    state = {"cb": callback}
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _handler(signum, frame):
            cb = state.get("cb")
            if cb is not None:
                try:
                    cb()
                except Exception:  # noqa: BLE001
                    pass
            if callable(prev) and prev not in (signal.SIG_IGN,
                                               signal.SIG_DFL):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _handler)

        def disarm():
            state["cb"] = None

        return disarm
    except (ValueError, OSError):  # not the main thread
        return None


__all__ = ["FlightRecorder", "load_dump", "find_dumps", "arm_sigterm",
           "is_trigger", "TRIGGER_KINDS", "TRIGGER_EVENTS"]
