"""Span-based causal tracing over the telemetry event stream (copy of
``deepspeed_tpu/telemetry/tracing.py``).

Every span carries a ``trace`` id shared by causally-related work, its
own ``span`` id, an optional ``parent`` span id, and monotonic
``start_ns``/``end_ns`` bounds. A serving request is one trace: submit
-> queue -> admission -> prefill -> decode -> finish/shed, and behind
the multi-replica router one ``attempt`` subtree per replica dispatch,
so a failover or a live migration CONTINUES the same trace on the
survivor instead of starting a new one.

- **Spans are emitted at END, as completed records.** There is no live
  context to propagate through the scheduler or across replicas — just
  timestamps the request bookkeeping already carries, converted at emit
  time. A crash mid-span loses exactly that span, nothing dangles.
- **Exception-isolated**: ``record_span`` never raises into the serving
  loop; a broken sink degrades tracing, not serving.
- **No host syncs, no device work**: span bookkeeping reads
  ``monotonic_ns`` and calls the emit callable.
- Span *names* are literals from :data:`telemetry.events.SPANS`; *ids*
  are process-local counters — cheap, deterministic under fake clocks.

Two trace shapes ride the stream: serving request traces (above) and
training step traces (:class:`StepTrace`: one trace per optimizer step
with ``data`` / ``fwd_bwd`` / ``optimizer`` children and the exposed-comm
attribute). Host-only (no torch), so the serving policy tier loads it
anywhere.
"""

import contextlib
import itertools
import time
from typing import Callable, Dict, List, Optional

from deepspeed_tpu_torch.telemetry.events import SPANS

_span_ids = itertools.count(1)
_trace_ids = itertools.count(1)


def monotonic_ns() -> int:
    return time.monotonic_ns()


def to_ns(monotonic_secs: float) -> int:
    """Monotonic seconds (the request/scheduler timestamp base — real or
    fake clock) -> integer nanoseconds on the span timebase."""
    return int(monotonic_secs * 1e9)


class SpanHandle:
    """An OPEN span: holds ids + start; ``end()`` emits the record."""

    __slots__ = ("tracer", "name", "trace", "span", "parent", "start_ns",
                 "attrs", "_done")

    def __init__(self, tracer, name, trace, span, parent, start_ns, attrs):
        self.tracer = tracer
        self.name = name
        self.trace = trace
        self.span = span
        self.parent = parent
        self.start_ns = start_ns
        self.attrs = attrs
        self._done = False

    def end(self, end_ns: Optional[int] = None, **attrs):
        if self._done:  # idempotent: double-ends must not double-emit
            return
        self._done = True
        self.attrs.update(attrs)
        self.tracer._emit(self.name, self.trace, self.span, self.parent,
                          self.start_ns,
                          monotonic_ns() if end_ns is None else int(end_ns),
                          self.attrs)


class Tracer:
    """Span recorder over one telemetry ``emit`` callable. Disabled
    tracers are inert attribute bags — every public method is a
    two-instruction early return, so the hot paths can call them
    unconditionally."""

    def __init__(self, emit: Optional[Callable] = None, enabled: bool = True,
                 step_of: Optional[Callable] = None):
        self._emit_fn = emit
        self.enabled = bool(enabled) and emit is not None
        # optional current-step provider so span events land next to the
        # right step counter in the stream
        self._step_of = step_of
        self.dropped = 0
        # lifetime spans successfully emitted: the bench series' window
        # accounting (the manager's in-memory tail is a bounded ring —
        # counting there undercounts any non-trivial window)
        self.emitted = 0

    # ------------------------------------------------------------------
    def new_trace(self, hint: Optional[str] = None) -> str:
        """Fresh trace id. ``hint`` (a request id, a step counter) makes
        the id human-greppable in the raw JSONL."""
        n = next(_trace_ids)
        return f"t{n}-{hint}" if hint else f"t{n}"

    def _emit(self, name, trace, span, parent, start_ns, end_ns, attrs):
        try:
            data = {"trace": trace, "span": span, "parent": parent,
                    "start_ns": int(start_ns), "end_ns": int(end_ns)}
            if attrs:
                data.update(attrs)
            step = self._step_of() if self._step_of is not None else None
            self._emit_fn("span", name, step=step, data=data)
            self.emitted += 1
        except Exception:  # noqa: BLE001 — tracing must never break a step
            self.dropped += 1

    def record_span(self, name: str, trace: str, start_ns: int,
                    end_ns: int, parent: Optional[str] = None,
                    **attrs) -> Optional[str]:
        """Emit one COMPLETED span retroactively from timestamps the
        caller already holds. Returns the span id (None when disabled)."""
        if not self.enabled:
            return None
        span = f"s{next(_span_ids)}"
        self._emit(name, trace, span, parent, start_ns, end_ns, attrs)
        return span

    def begin(self, name: str, trace: str, parent: Optional[str] = None,
              start_ns: Optional[int] = None, **attrs) -> Optional[SpanHandle]:
        """Open a span whose end is not yet known (e.g. an ``attempt``
        that outlives the current call). Returns None when disabled —
        callers keep the handle-or-None and call ``end()`` through
        :func:`end_span`."""
        if not self.enabled:
            return None
        return SpanHandle(self, name, trace, f"s{next(_span_ids)}", parent,
                          monotonic_ns() if start_ns is None
                          else int(start_ns), dict(attrs))

    @contextlib.contextmanager
    def span(self, name: str, trace: str, parent: Optional[str] = None,
             **attrs):
        """Context-managed span around a host-side block."""
        handle = self.begin(name, trace, parent=parent, **attrs)
        try:
            yield handle
        finally:
            if handle is not None:
                handle.end()


def end_span(handle: Optional[SpanHandle], end_ns: Optional[int] = None,
             **attrs) -> None:
    """``handle.end(...)`` that tolerates the disabled-tracer None."""
    if handle is not None:
        handle.end(end_ns=end_ns, **attrs)


def span_id(handle: Optional[SpanHandle]) -> Optional[str]:
    return None if handle is None else handle.span


# shared inert instance for components built without telemetry
NULL_TRACER = Tracer(emit=None, enabled=False)

_NULL_CTX = contextlib.nullcontext()


class StepTrace:
    """Per-optimizer-step phase accounting for the training engines.

    The engine brackets host-observable phases (``data`` fetch, the
    ``fwd_bwd`` dispatch, the ``optimizer`` apply) with :meth:`phase`;
    at the step boundary the telemetry manager calls :meth:`flush`,
    which emits one ``step`` root span covering first-phase-start ->
    boundary plus one child span per recorded phase, all under a fresh
    per-step trace id. With tracing off, ``phase`` is one attribute read
    returning a shared nullcontext — no clock reads, no allocation.

    Phase durations are HOST-side dispatch walltimes: under CUDA's async
    launches a phase that merely enqueues device work reads as cheap
    unless a fence the step already has (the fp16 overflow read, a
    collective's host staging) serializes it. That is by design — adding
    ``torch.cuda.synchronize()`` to make the numbers "device-true" would
    break the no-added-host-syncs contract; the device-true comm/compute
    split is the exposed-comm attribute's job.
    """

    def __init__(self, tracer: Tracer, rank: int = 0):
        self.tracer = tracer
        self.enabled = tracer.enabled
        self.rank = rank
        self._phases: List[tuple] = []

    @contextlib.contextmanager
    def _phase_cm(self, name: str, attrs: Dict):
        t0 = monotonic_ns()
        try:
            yield
        finally:
            self._phases.append((name, t0, monotonic_ns(), attrs))

    def phase(self, name: str, **attrs):
        """Bracket one host-side phase of the current step."""
        if not self.enabled:
            return _NULL_CTX
        return self._phase_cm(name, attrs)

    def mark(self, name: str, start_ns: int, end_ns: int, **attrs) -> None:
        """Record an already-timed phase (callers that can't hold a
        context manager open across their control flow)."""
        if self.enabled:
            self._phases.append((name, int(start_ns), int(end_ns), attrs))

    def flush(self, step: int, **step_attrs) -> Optional[str]:
        """Emit the step's root span + phase children and reset. No-op
        (returns None) when nothing was recorded — engines that never
        bracket phases (the serving decode loop) emit no empty steps."""
        if not self.enabled or not self._phases:
            self._phases = []
            return None
        phases, self._phases = self._phases, []
        trace = self.tracer.new_trace(hint=f"step{step}-r{self.rank}")
        start = min(t0 for _, t0, _, _ in phases)
        root = self.tracer.record_span(
            "step", trace, start, monotonic_ns(), step=int(step),
            **step_attrs)
        for name, t0, t1, attrs in phases:
            self.tracer.record_span(name, trace, t0, t1, parent=root,
                                    **attrs)
        return trace


def trace_ctx(trace: str, parent: Optional[str] = None,
              **attrs) -> Dict:
    """The cross-component trace context: what the router hands each
    replica (via ``Request.trace``) so replica-side spans join the
    client's trace under the current attempt span."""
    return {"trace": trace, "parent": parent, **attrs}


__all__ = ["SPANS", "Tracer", "StepTrace", "SpanHandle", "NULL_TRACER",
           "end_span", "span_id", "to_ns", "monotonic_ns", "trace_ctx"]
