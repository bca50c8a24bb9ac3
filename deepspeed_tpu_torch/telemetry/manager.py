"""Telemetry manager: the per-engine facade over the collectors
(counterpart of ``deepspeed_tpu/telemetry/manager.py``).

Construction is cheap and disabled by default: a disabled ``Telemetry``
is a few attribute reads on the hot path (``watch_jit`` returns the
callable unchanged, ``on_step_boundary`` is one bool check,
``step_trace.phase`` a shared nullcontext), and an engine dispatches the
same aten ops with it off as with it absent.

Collectors on the card:

1. **kernel-build and signature watches** — ``compile_watch`` hears
   every ``nvcc`` build (or library found built) of ``csrc/``, and
   :class:`~deepspeed_tpu_torch.telemetry.jit_watch.WatchedFunction`
   wraps the engines' step, forward and decode callables: a new call
   signature is a ``compile`` event (``retrace: true`` after
   ``warmup_steps``; a loud warning after ``recompile_warn_after``).
2. **step cost, once a signature** — FLOPs by ``FlopCounterMode`` with
   the port's kernels' formulas, and the collective bytes of the step's
   comm plan: a ``step_cost`` event, mirrored into the comms logger.
3. **device memory** — ``torch.cuda.memory_allocated`` /
   ``max_memory_allocated`` / ``memory_reserved`` every ``sample_every``
   boundaries: allocator counters, no sync.
4. **trace windows** — ``torch.profiler`` (CUDA activity) started and
   stopped around exactly ``trace.num_steps`` steps, its Chrome trace
   written under ``trace.dir``, markers in the event stream, then the
   profiled exposed-comm reading.

No collector adds a ``torch.cuda.synchronize()`` or reads a device
value: they read clocks and allocator counters at the fences the step
already has (JAX's "no added host syncs" contract).
"""

import contextlib
import os
import time
from collections import deque
from typing import Dict, Optional

from deepspeed_tpu_torch.telemetry import compile_watch
from deepspeed_tpu_torch.telemetry.events import make_event
from deepspeed_tpu_torch.telemetry.jit_watch import WatchedFunction
from deepspeed_tpu_torch.telemetry.registry import NULL_REGISTRY
from deepspeed_tpu_torch.telemetry.sink import (JsonlSink, MonitorBridge,
                                                process_rank)
from deepspeed_tpu_torch.telemetry.tracing import (NULL_TRACER, StepTrace,
                                                   Tracer)
from deepspeed_tpu_torch.utils.logging import log_dist, logger


def _as_config(config):
    """Accept a parsed TelemetryConfig, a raw dict, or None."""
    if config is None:
        config = {}
    if isinstance(config, dict):
        from deepspeed_tpu_torch.runtime.config import TelemetryConfig

        config = TelemetryConfig(**config)
    return config


class Telemetry:
    def __init__(self, config=None, monitor=None, name: str = "engine"):
        self.config = _as_config(config)
        self.enabled = bool(self.config.enabled)
        self.name = name
        self.warm = False
        self._sink: Optional[JsonlSink] = None
        self._bridge: Optional[MonitorBridge] = None
        self._compile_totals: Dict[str, Dict] = {}
        self._steps_seen = 0
        self._peak_bytes_seen = 0
        self._profiler = None
        self._trace_done = False
        self._trace_count = 0
        self._storm_warned = set()
        # the latest step cost per watched family: the static
        # exposed-comm estimate's input
        self._latest_costs: Dict[str, Dict] = {}
        self._exposed_cache = None
        self.tracer = NULL_TRACER
        self.step_trace = StepTrace(NULL_TRACER)
        self.metrics = NULL_REGISTRY
        self._metrics_server = None
        self._metrics_file = None
        self._last_boundary_ns = None
        self._rank = 0
        # the recent events (the resilience watchdog's dump tail)
        self._tail = deque(maxlen=256)
        self._recorder = None
        self._sigterm_disarm = None
        if not self.enabled:
            return
        self._rank = process_rank()
        if self.config.jsonl:
            self._sink = JsonlSink(
                os.path.join(self.config.dir, "telemetry.jsonl"),
                rotate_bytes=self.config.rotate_bytes,
                rotate_keep=self.config.rotate_keep)
        self._bridge = MonitorBridge(monitor)
        if self.config.tracing.enabled:
            self.tracer = Tracer(self.emit,
                                 step_of=lambda: self._steps_seen)
            self.step_trace = StepTrace(self.tracer, rank=self._rank)
        if self.config.compile_watchdog:
            # the kernels this process built (or found built) before the
            # engine existed, then every later build as it happens
            for label, per in compile_watch.snapshot()["by_label"].items():
                self.emit("compile", label, step=0, source="kernel_build",
                          compile_secs=round(per["secs"], 6),
                          n_compiles=per["compiles"],
                          cache_hits=per["cache_hits"],
                          before_engine=True)
            compile_watch.subscribe(self._on_kernel_build)
        if (self.config.metrics_port is not None
                or self.config.metrics_file):
            from deepspeed_tpu_torch.telemetry.registry import MetricRegistry

            self.metrics = MetricRegistry()
            self._metrics_file = self.config.metrics_file
            if self.config.metrics_port is not None:
                try:
                    from deepspeed_tpu_torch.telemetry.prom import \
                        MetricsServer

                    self._metrics_server = MetricsServer(
                        self.metrics, port=self.config.metrics_port,
                        host=self.config.metrics_host)
                    log_dist(f"telemetry: metrics endpoint at "
                             f"{self._metrics_server.url}", ranks=[0])
                except OSError as e:
                    logger.warning(
                        f"telemetry: cannot bind metrics endpoint on "
                        f"{self.config.metrics_host}:"
                        f"{self.config.metrics_port} ({e}); registry "
                        f"stays live, endpoint disabled")
        # flight recorder: continuously armed ring of recent events +
        # metric snapshots, dumped on fault / breaker / SIGTERM triggers
        fr = self.config.flight_recorder
        if fr.enabled:
            from deepspeed_tpu_torch.telemetry.flightrec import (
                FlightRecorder, arm_sigterm, is_trigger)

            self._recorder = FlightRecorder(
                fr.dump_dir or self.config.dir, events=fr.events,
                snapshots=fr.snapshots, max_dumps=fr.max_dumps)
            self._is_trigger = is_trigger
            if fr.on_sigterm:
                self._sigterm_disarm = arm_sigterm(
                    lambda: self._flight_dump("sigterm", trigger=None))

    # ------------------------------------------------------------------
    # event plumbing
    def emit(self, kind: str, name: str, step: Optional[int] = None,
             data: Optional[Dict] = None, **fields):
        if not self.enabled:
            return
        payload = dict(data or {})
        payload.update(fields)
        event = make_event(kind, name, step, self._rank, payload)
        self._tail.append(event)
        if self._sink is not None:
            self._sink.write(event)
        if self._bridge is not None:
            self._bridge.write(event)
        if self.metrics is not NULL_REGISTRY:
            self.metrics.counter("ds_events_total", ("kind",)).labels(
                kind=kind).inc()
        if self._recorder is not None:
            self._recorder.record_event(event)
            if self._is_trigger(kind, name):
                self._flight_dump(f"{kind}:{name}", trigger=event)

    def _flight_dump(self, reason: str, trigger=None):
        """One flight-recorder dump (fault event, breaker trip, SIGTERM,
        or an explicit call). Flushes the JSONL sink first so the dump's
        event tail and the sink agree, then records the dump itself as a
        ``flightrec.dump`` fault event (excluded from re-triggering)."""
        if self._recorder is None:
            return None
        self.flush()
        registry = self.metrics if self.metrics is not NULL_REGISTRY \
            else None
        path = self._recorder.dump(reason, registry=registry,
                                   trigger=trigger)
        if path is not None:
            self.metrics.counter(
                "ds_flightrec_dumps_total", ("reason",)).labels(
                    reason=reason.split(":", 1)[0]).inc()
            self.emit("fault", "flightrec.dump", step=self._steps_seen,
                      reason=reason, path=path)
            self.flush()
        return path

    def tail(self, n: int = 50):
        """The most recent ``n`` events (empty when disabled) — the
        resilience watchdog's hang dump reads them."""
        return list(self._tail)[-n:]

    # ------------------------------------------------------------------
    # collectors 1+2: signature watch + once-a-signature step cost
    def watch_jit(self, fn, name: str, cost_fn=None, name_of=None):
        """Route an engine callable through the signature watch; the
        callable itself when telemetry (or both collectors) is off."""
        if not self.enabled or not (self.config.compile_watchdog
                                    or self.config.hlo_cost):
            return fn
        return WatchedFunction(fn, name, self, cost_fn=cost_fn,
                               name_of=name_of)

    @staticmethod
    def _family(name: str) -> str:
        return name.split("[", 1)[0]

    def record_compile(self, watched, *, trace_secs: float,
                       compile_secs: float, cost: Optional[Dict] = None):
        name = watched.name
        family = self._family(name)
        totals = self._compile_totals.setdefault(
            family, {"compiles": 0, "trace_secs": 0.0, "compile_secs": 0.0,
                     "retraces_after_warm": 0})
        retrace = totals["compiles"] > 0
        totals["compiles"] += 1
        totals["trace_secs"] += trace_secs
        totals["compile_secs"] += compile_secs
        if retrace and self.warm:
            totals["retraces_after_warm"] += 1
        m = self.metrics
        m.counter("ds_compiles_total", ("family",)).labels(
            family=family).inc()
        m.counter("ds_compile_seconds_total", ("family",)).labels(
            family=family).inc(trace_secs + compile_secs)
        if retrace and self.warm:
            m.counter("ds_retraces_after_warmup_total",
                      ("family",)).labels(family=family).inc()
        if self.config.compile_watchdog:
            self.emit("compile", name, step=self._steps_seen,
                      trace_secs=round(trace_secs, 6),
                      compile_secs=round(compile_secs, 6),
                      n_compiles=totals["compiles"], retrace=retrace,
                      after_warmup=self.warm)
            if (retrace and self.warm and totals["retraces_after_warm"]
                    >= self.config.recompile_warn_after
                    and family not in self._storm_warned):
                self._storm_warned.add(family)
                logger.warning(
                    f"telemetry: RECOMPILE STORM — {family!r} has "
                    f"recompiled {totals['retraces_after_warm']}x after "
                    f"warmup (latest: {name!r}, trace {trace_secs:.2f}s + "
                    f"backend {compile_secs:.2f}s). Shapes or static "
                    "arguments are changing across steps; every occurrence "
                    "stalls the pipeline for the full compile time.")
        if self.config.hlo_cost and cost is not None:
            self._latest_costs[family] = cost
            self._exposed_cache = None
            self.emit("step_cost", name, step=self._steps_seen, **cost)
            self._mirror_to_comms_logger(name, cost)

    def _mirror_to_comms_logger(self, name: str, cost: Dict):
        """The step's planned collectives beside the facade-level ops in
        ``comm.log_summary()``."""
        from deepspeed_tpu_torch.comm.comm import comms_logger

        if not comms_logger.enabled:
            return
        from deepspeed_tpu_torch import comm

        world = comm.get_world_size() if comm.is_initialized() else 1
        for op, entry in (cost.get("collectives") or {}).items():
            comms_logger.append(op, f"plan:{name}:{op}", 0.0,
                                entry["operand_bytes"], world)

    def _on_kernel_build(self, label: str, secs: float, cache_hit: bool):
        self.emit("compile", label, step=self._steps_seen,
                  source="kernel_build", compile_secs=round(secs, 6),
                  cache_hit=bool(cache_hit), after_warmup=self.warm)

    # ------------------------------------------------------------------
    # collector 3: device memory (allocator counters: no sync)
    def _sample_memory(self, step: int):
        import torch

        data = {"source": "host"}
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            data = {"bytes_in_use": int(torch.cuda.memory_allocated()),
                    "peak_bytes_in_use": int(
                        torch.cuda.max_memory_allocated()),
                    "bytes_reserved": int(torch.cuda.memory_reserved()),
                    "bytes_limit": int(torch.cuda.get_device_properties(
                        torch.cuda.current_device()).total_memory),
                    "source": "torch.cuda"}
        try:
            import resource

            data["host_rss_bytes"] = 1024 * int(resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss)
        except (ImportError, OSError):
            pass
        self._peak_bytes_seen = max(self._peak_bytes_seen,
                                    int(data.get("peak_bytes_in_use", 0)))
        m = self.metrics
        if "bytes_in_use" in data:
            m.gauge("ds_device_bytes_in_use").set(data["bytes_in_use"])
        m.gauge("ds_device_peak_bytes").set(self._peak_bytes_seen)
        if "host_rss_bytes" in data:
            m.gauge("ds_host_rss_bytes").set(data["host_rss_bytes"])
        self.emit("memory", self.name, step=step, **data)

    # ------------------------------------------------------------------
    # collector 4: torch.profiler trace windows
    def _maybe_trace(self, step: int):
        """Boundary-counted window: the capture starts at the first
        boundary with ``step >= start_step`` and stops after
        ``num_steps`` further boundaries, so exactly ``num_steps`` steps
        are traced."""
        tr = self.config.trace
        if tr.num_steps <= 0 or self._trace_done:
            return
        if self._profiler is None and step > max(tr.start_step, 1):
            self._trace_done = True
            self.emit("trace_window", self.name, step=step, action="missed",
                      start_step=tr.start_step, num_steps=tr.num_steps)
            return
        if self._profiler is not None:
            self._trace_count += 1
            if self._trace_count < tr.num_steps:
                return
            try:
                path = self._stop_profiler(step)
                self.emit("trace_window", self.name, step=step,
                          action="stop", dir=tr.dir, trace=path,
                          num_steps=tr.num_steps)
                log_dist(f"telemetry: stopped torch.profiler trace after "
                         f"{tr.num_steps} step(s) -> {path}", ranks=[0])
                self._measure_exposed_comm(step, tr)
            except Exception as e:
                self.emit("trace_window", self.name, step=step,
                          action="stop_failed", error=str(e)[:200])
            self._trace_done = True
        elif step >= tr.start_step:
            try:
                import torch

                os.makedirs(tr.dir, exist_ok=True)
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                self._profiler = torch.profiler.profile(activities=acts)
                self._profiler.start()
                self._trace_count = 0
                self.emit("trace_window", self.name, step=step,
                          action="start", dir=tr.dir,
                          start_step=tr.start_step, num_steps=tr.num_steps)
                log_dist(f"telemetry: torch.profiler trace started at step "
                         f"{step} for {tr.num_steps} step(s) -> {tr.dir}",
                         ranks=[0])
            except Exception as e:
                self._profiler = None
                self._trace_done = True
                self.emit("trace_window", self.name, step=step,
                          action="start_failed", error=str(e)[:200])

    def _stop_profiler(self, step: int) -> str:
        prof, self._profiler = self._profiler, None
        prof.stop()
        path = os.path.join(self.config.trace.dir,
                            f"{self.name}-r{self._rank}-step{step}.json")
        prof.export_chrome_trace(path)
        return path

    def _measure_exposed_comm(self, step: int, tr):
        """After a window closes: the measured exposed-comm share from
        its CUDA kernels, or the reason it cannot be measured (the
        static estimate stays the only source, labeled as such)."""
        if not (self.tracer.enabled and self.config.tracing.exposed_comm):
            return
        from deepspeed_tpu_torch.telemetry import exposed_comm as xc

        measured, reason = xc.from_profiler_dir(tr.dir)
        if measured is None:
            self.emit("trace_window", self.name, step=step,
                      action="exposed_comm_unavailable", reason=reason)
            return
        now = time.monotonic_ns()
        window_ns = measured.get("busy_ns") or 0
        self.tracer.record_span(
            "exposed_comm", self.tracer.new_trace(hint=f"profile{step}"),
            now - window_ns, now, window_steps=tr.num_steps,
            window_end_step=step, **measured)
        self.metrics.gauge("ds_exposed_comm_fraction", ("source",)).labels(
            source=str(measured.get("source", "profiled"))).set(
                measured.get("exposed_comm_fraction") or 0.0)

    def exposed_comm_estimate(self) -> Optional[Dict]:
        """Static per-step exposed-comm estimate from the costliest step
        cost seen so far (by FLOPs); recomputed only when a cost lands."""
        if not (self.tracer.enabled and self.config.tracing.exposed_comm
                and self._latest_costs):
            return None
        if self._exposed_cache is not None:
            return self._exposed_cache
        from deepspeed_tpu_torch.telemetry import exposed_comm as xc

        cost = max(self._latest_costs.values(),
                   key=lambda c: c.get("flops") or 0.0)
        peak = self.config.tracing.peak_tflops or xc.default_peak_tflops()
        self._exposed_cache = xc.static_estimate(
            cost, self.config.tracing.ici_gbps, peak,
            axis_gbps=self.config.tracing.axis_gbps)
        return self._exposed_cache

    def annotation(self, name: str):
        """Profiler range for a host-side phase (``record_function``, an
        NVTX-style range in the window's trace)."""
        if not self.enabled or self.config.trace.num_steps <= 0:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    # ------------------------------------------------------------------
    # step-boundary hook (one call per optimizer step, from the engines)
    def on_step_boundary(self, global_step: int, samples: Optional[int] = None,
                         micro_steps: Optional[int] = None):
        if not self.enabled:
            return
        step = int(global_step)
        self._steps_seen = step
        if not self.warm and step >= self.config.warmup_steps:
            self.warm = True
        xc = self.exposed_comm_estimate() or {}
        step_fields = {"samples": samples, "micro_steps": micro_steps}
        if xc:
            step_fields["exposed_comm_fraction"] = \
                xc.get("exposed_comm_fraction")
            step_fields["exposed_comm_source"] = xc.get("source")
        self.emit("step", self.name, step=step, **step_fields)
        m = self.metrics
        if m is not NULL_REGISTRY:
            now_ns = time.monotonic_ns()
            m.counter("ds_steps_total").inc()
            if samples:
                m.counter("ds_samples_total").inc(int(samples))
            if self._last_boundary_ns is not None \
                    and now_ns > self._last_boundary_ns:
                m.gauge("ds_steps_per_sec").set(
                    round(1e9 / (now_ns - self._last_boundary_ns), 4))
            self._last_boundary_ns = now_ns
            if xc:
                m.gauge("ds_exposed_comm_fraction", ("source",)).labels(
                    source=str(xc.get("source"))).set(
                        xc.get("exposed_comm_fraction") or 0.0)
        if self.step_trace.enabled:
            self.step_trace.flush(step, **xc)
        if (self.config.memory
                and step % max(1, self.config.sample_every) == 0):
            self._sample_memory(step)
        if step % max(1, self.config.sample_every) == 0:
            if self._recorder is not None and m is not NULL_REGISTRY:
                self._recorder.record_snapshot(step, m.snapshot())
            if self._metrics_file and m is not NULL_REGISTRY:
                self._write_metrics_file()
        self._maybe_trace(step)

    def _write_metrics_file(self):
        """Atomic exposition dump to ``telemetry.metrics_file``; an IO
        failure disables the file, not the run."""
        from deepspeed_tpu_torch.telemetry.prom import write_textfile

        try:
            write_textfile(self._metrics_file, self.metrics.expose())
        except OSError as e:
            logger.warning(f"telemetry: metrics_file write failed "
                           f"({e}); disabling the textfile dump")
            self._metrics_file = None

    # ------------------------------------------------------------------
    def wallclock(self, means_ms: Dict[str, float],
                  step: Optional[int] = None):
        """Timer means (ms) at a report boundary: the legacy rank-0 line
        (``wall_clock_breakdown``), and a ``wallclock`` event when
        telemetry is on."""
        if not means_ms:
            return
        line = " | ".join(f"{k}: {v:.2f}" for k, v in means_ms.items())
        log_dist(f"time (ms) | {line}", ranks=[0])
        self.emit("wallclock", self.name, step=step,
                  data={k: round(float(v), 4) for k, v in means_ms.items()})

    def summary(self) -> Dict:
        return {
            "per_function": {k: dict(v)
                             for k, v in self._compile_totals.items()},
            "global": compile_watch.snapshot(),
            "peak_bytes_in_use": self._peak_bytes_seen,
            "steps": self._steps_seen,
        }

    def flush(self):
        if self._sink is not None:
            self._sink.flush()

    def close(self):
        if self._profiler is not None:
            try:
                self._stop_profiler(self._steps_seen)
            except Exception:
                self._profiler = None
        if self.enabled and self.config.compile_watchdog:
            compile_watch.unsubscribe(self._on_kernel_build)
        if self._metrics_file and self.metrics is not NULL_REGISTRY:
            self._write_metrics_file()
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        if self._sigterm_disarm is not None:
            # a closed recorder must not re-dump its stale ring on a
            # later SIGTERM (nor keep this manager alive via the chain)
            self._sigterm_disarm()
            self._sigterm_disarm = None
        if self._sink is not None:
            self._sink.close()
