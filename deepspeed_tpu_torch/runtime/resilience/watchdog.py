"""Hang watchdog (counterpart of
``deepspeed_tpu/runtime/resilience/watchdog.py``): detect stalled step
progress, dump, abort cleanly.

A stuck collective (dead peer host, wedged NCCL link) hangs a job
*silently*: the host blocks in a device wait, no exception ever fires,
and the job burns its reservation until a human notices. The watchdog is
a daemon thread that watches host-observable step progress
(``notify(step)`` at every optimizer boundary) and, when no boundary
lands for ``timeout_secs``:

1. dumps every Python thread's stack plus the telemetry event tail to
   ``<dump_dir>/watchdog_dump_<ts>.txt`` (and the log), so the stall is
   diagnosable post-mortem;
2. emits a ``fault`` telemetry event and flushes the sink;
3. aborts: SIGTERM first (lets signal / atexit hooks react if the
   process is not fully wedged), then ``os._exit(exit_code)`` after a
   short grace — the supervisor/scheduler restarts the job, which resumes
   from the last verified-good checkpoint.

Arming: the timer starts at the FIRST ``notify`` — the kernel builds
and first launches before step 1 can never trip it. ``abort: false``
(tests, notebooks) stops after the dump.
"""

import os
import signal
import sys
import threading
import time
import traceback
from typing import Callable, Optional

from deepspeed_tpu_torch.utils.logging import logger


def format_all_stacks() -> str:
    """Every live thread's Python stack (the hung collective shows up as
    the main thread blocked in a device wait)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sorted(sys._current_frames().items()):
        out.append(f"--- thread {names.get(ident, '?')} (ident {ident}) ---")
        out.append("".join(traceback.format_stack(frame)).rstrip())
    return "\n".join(out)


class HangWatchdog:
    def __init__(self, *, timeout_secs: float, poll_secs: float = 0.0,
                 dump_dir: str = "./resilience", abort: bool = True,
                 exit_code: int = 43, grace_secs: float = 2.0,
                 name: str = "engine", on_dump: Optional[Callable] = None,
                 tail_fn: Optional[Callable] = None,
                 emit: Optional[Callable] = None,
                 flush: Optional[Callable] = None,
                 idle_ok: bool = False):
        self.timeout_secs = float(timeout_secs)
        self.poll_secs = float(poll_secs) if poll_secs and poll_secs > 0 \
            else min(max(self.timeout_secs / 4.0, 0.05), 10.0)
        self.dump_dir = dump_dir
        self.abort = bool(abort)
        self.exit_code = int(exit_code)
        self.grace_secs = float(grace_secs)
        self.name = name
        self.on_dump = on_dump          # (dump_text, path) -> None
        self.tail_fn = tail_fn          # () -> list of recent events
        self._emit = emit or (lambda event_name, **data: None)
        self._flush = flush or (lambda: None)
        # idle_ok: a quiet period with NO work in flight is healthy (a
        # serving engine between requests) — the timer only runs while
        # busy_begin()..busy_end() brackets something. Training mode
        # (idle_ok=False) treats ANY gap in step progress as a stall.
        self.idle_ok = bool(idle_ok)
        self.fired = False
        self.last_step = None
        self._busy = 0
        self._suspended = 0
        self._last_progress = None      # monotonic ts; None = not armed
        self._stop = threading.Event()
        self._thread = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name=f"ds-hang-watchdog[{self.name}]",
            daemon=True)
        self._thread.start()

    def notify(self, step: Optional[int] = None):
        """Step-boundary heartbeat: cheap (a lock + two stores). The
        first call arms the timer."""
        with self._lock:
            self._last_progress = time.monotonic()
            if step is not None:
                self.last_step = int(step)

    def suspend(self):
        """Pause the stall timer (a known-long non-step phase: checkpoint
        save/restore IO can legitimately exceed the step timeout)."""
        with self._lock:
            self._suspended += 1

    def resume(self):
        with self._lock:
            self._suspended = max(0, self._suspended - 1)
            self._last_progress = time.monotonic()  # fresh window

    def touch(self):
        """Refresh the stall timer on host-observable sub-step progress
        (a serving decode step that produced tokens without finishing any
        request). Unlike :meth:`notify` this never ARMS the watchdog — a
        long first request (kernel builds) must stay untripped."""
        with self._lock:
            if self._last_progress is not None:
                self._last_progress = time.monotonic()

    def busy_begin(self):
        """Work started (a serving request was accepted): the stall timer
        runs until the matching :meth:`busy_end`. Does NOT arm an unarmed
        watchdog — the first request carries the kernel builds, and the
        'initial compiles can never trip it' guarantee must hold for
        serving exactly as it does for training (arming happens at the
        first COMPLETED request, via :meth:`notify`)."""
        with self._lock:
            self._busy += 1
            if self._last_progress is not None:
                self._last_progress = time.monotonic()

    def busy_end(self):
        with self._lock:
            self._busy = max(0, self._busy - 1)
            if self._last_progress is not None:
                self._last_progress = time.monotonic()

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=self.poll_secs * 2 + 1.0)
        self._thread = None

    # ------------------------------------------------------------------
    def _run(self):
        while not self._stop.wait(self.poll_secs):
            with self._lock:
                last = self._last_progress
                busy = self._busy
                suspended = self._suspended
            if last is None or self.fired:
                continue  # not armed yet (still compiling step 1)
            if suspended > 0:
                # long checkpoint IO etc.: healthy, keep the timer based
                with self._lock:
                    self._last_progress = time.monotonic()
                continue
            if self.idle_ok and busy == 0:
                # serving engine between requests: healthy, keep the
                # timer re-based so the NEXT request gets a full window
                with self._lock:
                    self._last_progress = time.monotonic()
                continue
            stalled = time.monotonic() - last
            if stalled >= self.timeout_secs:
                self._fire(stalled)
                if self.abort:
                    return

    def _fire(self, stalled_secs: float):
        self.fired = True
        lines = [
            f"HANG WATCHDOG [{self.name}]: no step-boundary progress for "
            f"{stalled_secs:.1f}s (timeout {self.timeout_secs:.1f}s, last "
            f"completed step {self.last_step}). A stalled collective or "
            "dead peer host is the usual cause.",
            "",
            "=== python stacks ===",
            format_all_stacks(),
        ]
        tail = []
        if self.tail_fn is not None:
            try:
                tail = list(self.tail_fn() or [])
            except Exception:
                tail = []
        if tail:
            lines += ["", "=== telemetry event tail ==="]
            lines += [repr(e) for e in tail]
        dump = "\n".join(lines)
        path = None
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(
                self.dump_dir, f"watchdog_dump_{int(time.time())}.txt")
            with open(path, "w") as f:
                f.write(dump + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:
            logger.warning(f"[resilience] watchdog dump file failed ({e}); "
                           "dump goes to the log only")
        logger.error(dump if path is None
                     else f"{lines[0]} Full dump: {path}")
        try:
            self._emit("watchdog.hang", stalled_secs=round(stalled_secs, 1),
                       timeout_secs=self.timeout_secs,
                       last_step=self.last_step, dump_path=path)
            self._flush()
        except Exception:
            pass
        if self.on_dump is not None:
            try:
                self.on_dump(dump, path)
            except Exception:
                pass
        if self.abort:
            self._abort()

    def _abort(self):
        logger.error(
            f"[resilience] watchdog aborting: SIGTERM now, hard exit "
            f"({self.exit_code}) in {self.grace_secs:.1f}s — restart and "
            "resume from the last verified-good checkpoint")
        try:
            os.kill(os.getpid(), signal.SIGTERM)
        except OSError:
            pass
        time.sleep(self.grace_secs)
        os._exit(self.exit_code)
