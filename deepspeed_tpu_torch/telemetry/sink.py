"""Telemetry sinks: rank-0-gated JSON-lines file + monitor bridge (copy
of ``deepspeed_tpu/telemetry/sink.py``).

The JSONL sink is the durable artifact ``tools/telemetry_report.py``
consumes; the monitor bridge forwards numeric telemetry scalars into the
``MonitorMaster`` fan-out (tb/wandb/csv) so telemetry series land next to
the training curves without a second writer stack. Rank 0 is
``torch.distributed``'s rank where a process group runs (the JAX
package's ``jax.process_index()``), else 0.
"""

import os
from typing import Optional

from deepspeed_tpu_torch.telemetry.events import dumps, segment_paths
from deepspeed_tpu_torch.utils.logging import logger


def process_rank() -> int:
    """This process's rank in the running process group, else 0."""
    import sys

    dist = getattr(sys.modules.get("torch"), "distributed", None)
    if dist is not None and dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


# per-path shared writer state for THIS process: the first open of a
# path truncates (a re-run must not append to the previous run's events
# — telemetry_report would silently aggregate two runs into one table)
# and PURGES any rotated segments a previous run left behind (the
# segment-aware readers would merge them in otherwise); later opens of
# the same path in the same process SHARE the one file object and size
# counter (several engines sharing one dir produce one combined stream,
# and rotation stays coherent — a sibling sink can never keep writing
# through a stale fd into a renamed segment)
_OPEN_STATES = {}


class JsonlSink:
    """JSONL writer, active on process 0 only (the same rank-0 gating the
    monitor writers use). Truncate-per-run (see ``_OPEN_STATES``); opens
    lazily and line-buffers so a crash loses at most the in-flight line.

    With ``rotate_bytes > 0`` the sink is size-bounded: once the live
    file reaches the threshold it is rotated to ``<path>.1`` (existing
    segments shift ``.k`` -> ``.k+1``; at most ``rotate_keep`` rotated
    segments are retained, the oldest dropped) and a fresh live file
    opens — a long serving run can never grow the event file without
    bound. ``events.load_all_events`` reads the segments back in order,
    so the report/export tools see one stream."""

    def __init__(self, path: str, rotate_bytes: int = 0,
                 rotate_keep: int = 4):
        self.path = path
        self.rotate_bytes = int(rotate_bytes)
        self.rotate_keep = max(1, int(rotate_keep))
        self.rotations = 0
        self.enabled = process_rank() == 0
        self._attached = False
        if self.enabled:
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            except OSError as e:
                logger.warning(f"telemetry: cannot create sink dir for "
                               f"{path!r} ({e}); JSONL sink disabled")
                self.enabled = False

    def _state(self):
        """The path's shared writer state, opening it on first use."""
        state = _OPEN_STATES.get(self.path)
        if state is None or state["f"] is None:
            fresh = state is None  # first open this process: truncate
            if fresh:
                # a previous RUN's rotated segments must not leak into
                # this run's segment-aware readers
                for seg in segment_paths(self.path):
                    if seg != self.path:
                        os.remove(seg)
            f = open(self.path, "w" if fresh else "a", buffering=1)
            state = {"f": f, "size": 0 if fresh else f.tell(), "refs": 0}
            _OPEN_STATES[self.path] = state
        if not self._attached:
            state["refs"] += 1
            self._attached = True
        return state

    def write(self, event: dict):
        if not self.enabled:
            return
        try:
            state = self._state()
            line = dumps(event) + "\n"
            state["f"].write(line)
            state["size"] += len(line)
            if self.rotate_bytes > 0 and state["size"] >= self.rotate_bytes:
                self._rotate(state)
        except OSError as e:  # disk full mid-run: disable, never raise
            logger.warning(f"telemetry: write to {self.path!r} failed "
                           f"({e}); JSONL sink disabled")
            self.close()

    def _rotate(self, state):
        """Close the full live file, shift it into the numbered segment
        chain, reopen fresh — through the SHARED state, so every sink on
        this path follows the new live file. Any OSError here disables
        this sink exactly like a failed write (the disk-full contract)."""
        state["f"].close()
        state["f"] = None
        oldest = f"{self.path}.{self.rotate_keep}"
        if os.path.exists(oldest):
            os.remove(oldest)
        for k in range(self.rotate_keep - 1, 0, -1):
            seg = f"{self.path}.{k}"
            if os.path.exists(seg):
                os.replace(seg, f"{self.path}.{k + 1}")
        os.replace(self.path, f"{self.path}.1")
        state["f"] = open(self.path, "w", buffering=1)
        state["size"] = 0
        self.rotations += 1

    def flush(self):
        state = _OPEN_STATES.get(self.path)
        if self._attached and state is not None and state["f"] is not None:
            state["f"].flush()

    def close(self):
        state = _OPEN_STATES.get(self.path)
        if self._attached and state is not None:
            state["refs"] -= 1
            self._attached = False
            if state["refs"] <= 0 and state["f"] is not None:
                # last writer gone: close the shared file (the path stays
                # registered, so a later sink REOPENS in append mode)
                state["f"].close()
                state["f"] = None
        # a closed sink stays closed — late events (e.g. another engine's
        # compiles fanning out through the global watchdog) must not
        # silently reopen the file
        self.enabled = False



# numeric fields worth mirroring into the monitor writers, per event kind
# (full events always go to the JSONL sink; the monitor gets the scalar
# series a dashboard actually plots)
_MONITOR_FIELDS = {
    "memory": ("bytes_in_use", "peak_bytes_in_use", "host_rss_bytes"),
    "compile": ("compile_secs", "trace_secs"),
    "wallclock": None,  # every timer mean
    "step_cost": ("flops", "collective_operand_bytes",
                  "temp_size_in_bytes"),
}


class MonitorBridge:
    """Forward telemetry events to a ``MonitorMaster`` as
    ``(tag, value, step)`` scalars under the ``Telemetry/`` namespace."""

    def __init__(self, monitor):
        self.monitor = monitor

    @property
    def enabled(self) -> bool:
        return self.monitor is not None and getattr(self.monitor, "enabled",
                                                    False)

    def write(self, event: dict):
        if not self.enabled or event["kind"] not in _MONITOR_FIELDS:
            return
        step = event.get("step")
        if step is None:
            return
        fields = _MONITOR_FIELDS[event["kind"]]
        data = event.get("data", {})
        items = data.items() if fields is None else (
            (k, data[k]) for k in fields if k in data)
        out = []
        for key, value in items:
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                out.append((f"Telemetry/{event['kind']}/{key}",
                            float(value), step))
        if out:
            self.monitor.write_events(out)
