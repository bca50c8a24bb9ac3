"""Multi-tenant HTTP/SSE front door for the serving stack (copy of
``deepspeed_tpu/serving/gateway.py``).

:class:`ServingGateway` wraps ANY ``submit()/step()/drain()`` backend —
a ``FleetManager``, a ``ReplicaRouter`` or a bare ``ServingEngine`` —
behind a stdlib :class:`http.server.ThreadingHTTPServer` (the
metrics-server pattern: daemon threads, ephemeral ``port=0``,
deterministic ``close()``):

- ``POST /v1/generate`` — JSON in, SSE token stream out (``event:
  token`` per generated token, a terminal ``event: done`` carrying the
  backend record, or a typed ``event: error`` when the request was shed
  mid-stream); ``"stream": false`` selects a non-streaming JSON reply.
- ``GET /healthz`` — backend liveness + gauges.
- ``GET /metrics`` — the existing exposition, mounted on the same port.

Tenancy rides ``serving.gateway``: API-key identity, token-bucket rate
limits and inflight quotas (``tenancy.py``), SLO classes mapped onto the
scheduler's priority floor and deadline defaults. Overload answers 429/
503 with ``Retry-After`` instead of hanging sockets. Delivery is
decoupled from the step loop by a BOUNDED per-connection send queue: the
stream callback (step thread) never blocks — a slow reader overflows its
own queue and sheds that request only, via the backend ``cancel()``
seam, drained at the next :meth:`ServingGateway.step`.

Pure host code: never imports torch and reads only the injected
clock — the trace-replay harness runs the whole front door on
simulated time, bit-deterministically.
"""

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from deepspeed_tpu_torch.serving.config import GatewayConfig
from deepspeed_tpu_torch.serving.tenancy import Tenant, TenantTable
from deepspeed_tpu_torch.telemetry.registry import NULL_REGISTRY
from deepspeed_tpu_torch.telemetry.prom import CONTENT_TYPE
from deepspeed_tpu_torch.telemetry.tracing import (NULL_TRACER, end_span, span_id,
                                             to_ns, trace_ctx)

GENERATE_ROUTE = "/v1/generate"

# admission reason -> HTTP status
_REASON_STATUS = {
    "auth": 401, "forbidden": 403, "bad_request": 400, "too_large": 413,
    "sampling_invalid": 400,
    "rate": 429, "tokens": 429, "inflight": 429, "overload": 503,
    "backend_shed": 503,
}


def _validate_sampling(body: dict) -> Optional[str]:
    """Range-check the keyed-sampling fields of a parsed request body.
    Returns a reject reason or None. Checked at the DOOR so an
    out-of-range temperature answers a typed 400, not a backend shed
    deep in the step loop."""
    if "do_sample" in body and not isinstance(body["do_sample"], bool):
        return "sampling_invalid"
    seed = body.get("seed")
    if seed is not None and (not isinstance(seed, int)
                             or isinstance(seed, bool) or seed < 0):
        return "sampling_invalid"
    temp = body.get("temperature")
    if temp is not None and (not isinstance(temp, (int, float))
                             or isinstance(temp, bool) or temp <= 0):
        return "sampling_invalid"
    top_k = body.get("top_k")
    if top_k is not None and (not isinstance(top_k, int)
                              or isinstance(top_k, bool) or top_k < 0):
        return "sampling_invalid"
    top_p = body.get("top_p")
    if top_p is not None and (not isinstance(top_p, (int, float))
                              or isinstance(top_p, bool)
                              or not 0.0 <= top_p <= 1.0):
        return "sampling_invalid"
    return None


class _NullTelemetry:
    enabled = False

    def emit(self, *a, **k):
        pass


class _Stream:
    """Per-request delivery state shared between the step thread (the
    stream callback producing) and the handler thread (consuming)."""

    def __init__(self, request_id: str, maxsize: int):
        self.request_id = request_id
        self.q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self.first_ts: Optional[float] = None
        self.tokens = 0
        self.overflow = False
        self.closed = False


class ServingGateway:
    """The HTTP/SSE front door. Construct over a backend, ``start()``,
    then drive the backend loop through :meth:`step`/:meth:`drain` (or
    set ``serving.gateway.pump`` to own a daemon step loop)."""

    def __init__(self, backend, config=None, *, telemetry=None,
                 clock=time.monotonic):
        if isinstance(config, GatewayConfig):
            self.config = config
        else:
            self.config = GatewayConfig(**(config or {}))
        self.backend = backend
        self.clock = clock
        self.telemetry = (telemetry
                          or getattr(backend, "telemetry", None)
                          or _NullTelemetry())
        self._metrics = getattr(self.telemetry, "metrics", None) \
            or NULL_REGISTRY
        self._tracer = getattr(self.telemetry, "tracer", None) \
            or NULL_TRACER
        self.tenants = TenantTable(self.config, clock=clock)
        self._routerlike = (hasattr(backend, "overload")
                            or hasattr(backend, "router"))
        self._lock = threading.Lock()
        self._streams: Dict[str, _Stream] = {}
        self._cancels: List[Tuple[str, str]] = []
        self._count = 0
        self._step_count = 0
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._pump_thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._running = False
        # per-tenant counters for stats()/bench (metrics may be off)
        self._counts: Dict[str, Dict[str, int]] = {}

    # ------------------------------------------------------------------
    # lifecycle
    def start(self) -> "ServingGateway":
        if self._server is not None:
            return self
        server = ThreadingHTTPServer((self.config.host, self.config.port),
                                     _Handler)
        server.daemon_threads = True
        server.gateway = self
        self._server = server
        self._running = True
        self._thread = threading.Thread(target=server.serve_forever,
                                        name="ds-gateway", daemon=True)
        self._thread.start()
        if self.config.pump:
            self._pump_thread = threading.Thread(
                target=self._pump, name="ds-gateway-pump", daemon=True)
            self._pump_thread.start()
        return self

    @property
    def port(self) -> int:
        return self._server.server_address[1] if self._server else 0

    @property
    def url(self) -> str:
        return f"http://{self.config.host}:{self.port}"

    def close(self):
        self._running = False
        self._wake.set()
        if self._pump_thread is not None:
            self._pump_thread.join(2.0)
            self._pump_thread = None
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(2.0)
            self._thread = None

    def destroy(self):
        self.close()
        backend_destroy = getattr(self.backend, "destroy", None)
        if backend_destroy is not None:
            backend_destroy()

    def submit(self, prompt, **kwargs):
        """Direct Python-path passthrough — the backend surface stays
        reachable behind the gateway (no quotas, no HTTP)."""
        return self.backend.submit(prompt, **kwargs)

    # ------------------------------------------------------------------
    # step loop
    def step(self):
        """Drain deferred cancels (slow readers / disconnects, queued by
        handler threads where touching the scheduler would race the step
        loop), then advance the backend one step."""
        self._drain_cancels()
        self._step_count += 1
        return self.backend.step()

    def drain(self, max_steps: Optional[int] = None):
        self._drain_cancels()
        return self.backend.drain(max_steps)

    @property
    def pending(self) -> bool:
        return bool(getattr(self.backend, "pending", False))

    def _pump(self):
        while self._running:
            self._wake.wait(self.config.poll_secs)
            self._wake.clear()
            while self._running and (self.pending or self._cancels):
                self.step()

    def _drain_cancels(self):
        with self._lock:
            pending, self._cancels = self._cancels, []
        cancel = getattr(self.backend, "cancel", None)
        for request_id, reason in pending:
            if cancel is not None:
                cancel(request_id, reason)

    def _request_cancel(self, request_id: str, reason: str):
        with self._lock:
            self._cancels.append((request_id, reason))
        self._wake.set()

    # ------------------------------------------------------------------
    # accounting
    def _emit(self, name: str, **data):
        if getattr(self.telemetry, "enabled", False):
            self.telemetry.emit("gateway", name, step=self._step_count,
                                **data)

    def _bump(self, tenant: str, key: str, n: int = 1):
        with self._lock:
            row = self._counts.setdefault(tenant, {})
            row[key] = row.get(key, 0) + n

    def _reject(self, tenant_name: str, reason: str, status: int,
                trace=None):
        self._bump(tenant_name, "rejected")
        self._bump(tenant_name, f"http_{status}")
        self._metrics.counter("ds_gateway_requests_total",
                              labels=("tenant", "outcome")) \
            .labels(tenant=tenant_name, outcome="rejected").inc()
        self._metrics.counter("ds_gateway_rejects_total",
                              labels=("tenant", "reason")) \
            .labels(tenant=tenant_name, reason=reason).inc()
        self._emit("request.rejected", tenant=tenant_name, reason=reason,
                   status=status)
        if trace is not None:
            tid, root = trace
            now_ns = to_ns(self.clock())
            self._tracer.record_span("shed", tid, now_ns, now_ns,
                                     parent=span_id(root), reason=reason,
                                     tenant=tenant_name)
            end_span(root, end_ns=now_ns, status=status)

    def _finish(self, tenant: Tenant, stream: _Stream, outcome: str,
                reason: str = "", ttft_ms: Optional[float] = None,
                trace=None, status: int = 200):
        """Exactly-once terminal accounting for an admitted request."""
        if stream.closed:
            return
        stream.closed = True
        with self._lock:
            self._streams.pop(stream.request_id, None)
        tenant.release()
        shed = outcome != "ok"
        tenant.record_outcome(shed, ttft_ms)
        self._bump(tenant.name, outcome)
        if not shed:
            self._bump(tenant.name, "finished")
        self._metrics.counter("ds_gateway_requests_total",
                              labels=("tenant", "outcome")) \
            .labels(tenant=tenant.name, outcome=outcome).inc()
        if stream.tokens:
            self._metrics.counter("ds_gateway_tokens_total",
                                  labels=("tenant",)) \
                .labels(tenant=tenant.name).inc(stream.tokens)
        if shed and reason:
            self._metrics.counter("ds_gateway_stream_sheds_total",
                                  labels=("tenant", "cause")) \
                .labels(tenant=tenant.name, cause=reason).inc()
        self._gauge_tenant(tenant)
        self._emit("request.finished", tenant=tenant.name, outcome=outcome,
                   reason=reason, request_id=stream.request_id,
                   tokens=stream.tokens, ttft_ms=ttft_ms,
                   budget_remaining=round(tenant.budget_remaining(), 6))
        if trace is not None:
            tid, root = trace
            end_span(root, end_ns=to_ns(self.clock()), status=status,
                     outcome=outcome, tokens=stream.tokens)

    def _gauge_tenant(self, tenant: Tenant):
        self._metrics.gauge("ds_gateway_inflight", labels=("tenant",)) \
            .labels(tenant=tenant.name).set(tenant.inflight)
        self._metrics.gauge("ds_gateway_budget_remaining",
                            labels=("tenant",)) \
            .labels(tenant=tenant.name).set(tenant.budget_remaining())

    def stats(self) -> dict:
        """Per-tenant gateway counters + budget remaining (host-side,
        independent of the metrics plane being armed)."""
        with self._lock:
            counts = {t: dict(row) for t, row in self._counts.items()}
        out = {"tenants": {}}
        for tenant in self.tenants.tenants:
            row = counts.get(tenant.name, {})
            row["inflight"] = tenant.inflight
            row["budget_remaining"] = round(tenant.budget_remaining(), 6)
            row["slo_class"] = tenant.slo_class
            out["tenants"][tenant.name] = row
        return out

    # ------------------------------------------------------------------
    # admission (handler thread)
    def _next_id(self) -> str:
        with self._lock:
            self._count += 1
            return f"gw-{self._count}"

    def authenticate(self, api_key: Optional[str]):
        """(tenant, error reason) — exactly one side is set."""
        if self.tenants.open:
            return self.tenants.resolve(None), ""
        if not api_key:
            return None, "auth"
        tenant = self.tenants.resolve(api_key)
        if tenant is None:
            return None, "forbidden"
        return tenant, ""

    def admit(self, tenant: Tenant, body: dict):
        """Quota + backend admission for a parsed, authenticated request.
        Returns ``(handle, stream, trace, retry_after, reason)`` —
        ``handle`` is None when rejected."""
        t0 = self.clock()
        trace = None
        if self._tracer.enabled and tenant.sample_trace():
            tid = self._tracer.new_trace(hint=tenant.name)
            root = self._tracer.begin("gateway", tid, start_ns=to_ns(t0),
                                      tenant=tenant.name,
                                      route=GENERATE_ROUTE)
            trace = (tid, root)
            self._tracer.record_span("auth", tid, to_ns(t0), to_ns(t0),
                                     parent=span_id(root),
                                     tenant=tenant.name)
        max_new = int(body.get("max_new_tokens", 0) or 0)
        overload = getattr(self.backend, "overload", None)
        threshold = self.config.overload_reject_threshold
        if (threshold > 0 and overload is not None
                and overload() >= threshold):
            self._reject(tenant.name, "overload", 503, trace)
            return None, None, None, self.config.retry_after_secs, \
                "overload"
        reason, wait = tenant.admit(est_tokens=float(max_new))
        if trace is not None:
            self._tracer.record_span("quota", trace[0], to_ns(t0),
                                     to_ns(self.clock()),
                                     parent=span_id(trace[1]),
                                     tenant=tenant.name,
                                     outcome=reason or "ok")
        if reason:
            self._reject(tenant.name, reason, 429, trace)
            return None, None, None, \
                max(wait, self.config.retry_after_secs), reason
        request_id = str(body.get("request_id") or self._next_id())
        stream = _Stream(request_id, self.config.send_queue_tokens)
        kwargs: Dict[str, Any] = {
            "max_new_tokens": max_new,
            "request_id": request_id,
            "deadline_ms": float(body.get("deadline_ms")
                                 or tenant.deadline_ms),
            "stream": self._make_stream_cb(tenant, stream),
        }
        if "eos_token_id" in body:
            kwargs["eos_token_id"] = int(body["eos_token_id"])
        if body.get("do_sample"):
            # keyed sampling rides through verbatim: the seed IS the
            # reproducibility contract, so the gateway must not rewrite
            # or default it — the serving config owns knob defaults
            kwargs["do_sample"] = True
            if body.get("seed") is not None:
                kwargs["seed"] = int(body["seed"])
            if body.get("temperature") is not None:
                kwargs["temperature"] = float(body["temperature"])
            if body.get("top_k") is not None:
                kwargs["top_k"] = int(body["top_k"])
            if body.get("top_p") is not None:
                kwargs["top_p"] = float(body["top_p"])
        if self._routerlike:
            kwargs["priority"] = tenant.priority
        elif trace is not None:
            # bare-engine backend: its serve/decode spans join the
            # gateway trace (router backends manage their own trace)
            kwargs["trace"] = trace_ctx(trace[0],
                                        parent=span_id(trace[1]))
        with self._lock:
            self._streams[request_id] = stream
        handle = self.backend.submit(body["prompt"], **kwargs)
        if getattr(handle, "state", "") == "shed":
            # backend admission control said no (queue full / duplicate
            # id / inflight-token cap): surface it as 503, not a hang
            self._finish(tenant, stream, "shed",
                         reason=getattr(handle, "finish_reason", "")
                         or "backend_shed", trace=trace, status=503)
            return None, None, None, self.config.retry_after_secs, \
                "backend_shed"
        self._gauge_tenant(tenant)
        self._bump(tenant.name, "admitted")
        if body.get("do_sample"):
            # per-tenant replay breakdown: how much of this tenant's
            # admitted traffic is keyed-sampled (stats()/bench read it)
            self._bump(tenant.name, "sampled")
        self._wake.set()
        return handle, stream, trace, 0.0, ""

    def _make_stream_cb(self, tenant: Tenant, stream: _Stream):
        def on_token(req, token: int, done: bool):
            if stream.closed or stream.overflow:
                return
            if stream.first_ts is None:
                # step-thread clock read: deterministic under the
                # replay harness' simulated time
                stream.first_ts = self.clock()
            try:
                stream.q.put_nowait(("token", int(token)))
                stream.tokens += 1
                if done:
                    stream.q.put_nowait(("done",))
            except queue.Full:
                # slow reader: shed THIS request only — never block the
                # step loop. The cancel drains at the next gateway step.
                stream.overflow = True
                self._request_cancel(stream.request_id, "slow_reader")
        return on_token

    def observe_ttft(self, tenant: Tenant, stream: _Stream,
                     submit_ts: float) -> Optional[float]:
        if stream.first_ts is None:
            return None
        return 1e3 * max(stream.first_ts - submit_ts, 0.0)


def _sse(event: str, data: dict) -> bytes:
    return (f"event: {event}\ndata: {json.dumps(data, sort_keys=True)}"
            f"\n\n").encode("utf-8")


class _Handler(BaseHTTPRequestHandler):
    server_version = "ds-gateway/1.0"

    # ------------------------------------------------------------------
    def log_message(self, fmt, *args):  # silenced: telemetry covers it
        pass

    @property
    def gw(self) -> ServingGateway:
        return self.server.gateway

    def _json(self, status: int, payload: dict, headers=()):
        body = json.dumps(payload, sort_keys=True).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _error(self, status: int, reason: str, tenant: str = "unknown",
               retry_after: float = 0.0):
        headers = []
        if status in (429, 503):
            secs = max(retry_after, self.gw.config.retry_after_secs)
            headers.append(("Retry-After", str(max(1, round(secs)))))
        self._json(status, {"error": {"status": status, "reason": reason,
                                      "tenant": tenant}}, headers)

    # ------------------------------------------------------------------
    def do_GET(self):
        gw = self.gw
        if self.path in ("/metrics", "/"):
            gw._metrics.counter("ds_scrapes_total").inc()
            body = gw._metrics.expose().encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path == "/healthz":
            backend = gw.backend
            payload = {"status": "ok", "pending": bool(gw.pending)}
            overload = getattr(backend, "overload", None)
            if overload is not None:
                payload["overload"] = round(float(overload()), 6)
            gauges = (getattr(backend, "fleet_gauges", None)
                      or getattr(backend, "gauges", None))
            if gauges is not None:
                payload["gauges"] = gauges()
            self._json(200, payload)
            return
        self._json(404, {"error": {"status": 404, "reason": "not_found"}})

    # ------------------------------------------------------------------
    def do_POST(self):
        if self.path != GENERATE_ROUTE:
            self._json(404, {"error": {"status": 404,
                                       "reason": "not_found"}})
            return
        gw = self.gw
        api_key = self._api_key()
        tenant, err = gw.authenticate(api_key)
        label = tenant.name if tenant is not None else "unknown"
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = -1
        if length <= 0:
            gw._reject(label, "bad_request", 400)
            self._error(400, "bad_request", label)
            return
        if length > gw.config.max_body_bytes:
            gw._reject(label, "too_large", 413)
            self._error(413, "too_large", label)
            return
        if tenant is None:
            status = _REASON_STATUS[err]
            gw._reject(label, err, status)
            self._error(status, err, label)
            return
        raw = self.rfile.read(length)
        body = self._parse(raw)
        if body is None:
            gw._reject(tenant.name, "bad_request", 400)
            self._error(400, "bad_request", tenant.name)
            return
        samp_err = _validate_sampling(body)
        if samp_err is not None:
            gw._reject(tenant.name, samp_err, 400)
            self._error(400, samp_err, tenant.name)
            return
        handle, stream, trace, retry_after, reason = gw.admit(tenant, body)
        if handle is None:
            self._error(_REASON_STATUS.get(reason, 429), reason,
                        tenant.name, retry_after)
            return
        submit_ts = gw.clock()
        if body.get("stream", True):
            self._stream_sse(gw, tenant, handle, stream, trace, submit_ts)
        else:
            self._respond_json(gw, tenant, handle, stream, trace,
                               submit_ts)

    # ------------------------------------------------------------------
    def _api_key(self) -> Optional[str]:
        auth = self.headers.get("Authorization") or ""
        if auth.startswith("Bearer "):
            return auth[len("Bearer "):].strip()
        return self.headers.get("X-API-Key")

    def _parse(self, raw: bytes) -> Optional[dict]:
        try:
            body = json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            return None
        if not isinstance(body, dict):
            return None
        prompt = body.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) for t in prompt)):
            return None
        mnt = body.get("max_new_tokens", 0)
        if not isinstance(mnt, int) or mnt < 0:
            return None
        return body

    # ------------------------------------------------------------------
    def _pull(self, gw: ServingGateway, handle, stream: _Stream):
        """Yield queue items; on quiet polls, fall back to the handle's
        terminal state (a shed mid-decode emits no done marker)."""
        while True:
            try:
                yield stream.q.get(timeout=gw.config.poll_secs)
                continue
            except queue.Empty:
                pass
            if stream.overflow:
                yield ("error", "slow_reader")
                return
            state = getattr(handle, "state", "")
            if state == "shed" and stream.q.empty():
                yield ("error", getattr(handle, "finish_reason", "")
                       or "shed")
                return
            if state == "finished" and stream.q.empty():
                yield ("done",)
                return
            if not gw._running:
                yield ("error", "shutdown")
                return

    def _record_of(self, handle) -> dict:
        rec = getattr(handle, "record", None)
        if not callable(rec):
            return {}
        # the ("done",) marker is enqueued MID-step by the stream
        # callback; the backend marks the request terminal at the END of
        # that same step (router harvest). Wait it out — bounded — so
        # the record this response carries is the final one, not a
        # mid-harvest snapshot with state still "running".
        pause = threading.Event()
        for _ in range(2000):
            if getattr(handle, "state", "finished") in ("finished",
                                                        "shed"):
                break
            pause.wait(0.005)
        return rec()

    def _observe_ttft(self, gw, tenant, stream, submit_ts):
        ttft_ms = gw.observe_ttft(tenant, stream, submit_ts)
        if ttft_ms is not None:
            gw._metrics.histogram("ds_gateway_ttft_ms",
                                  labels=("tenant",)) \
                .labels(tenant=tenant.name).observe(ttft_ms)
        return ttft_ms

    def _stream_sse(self, gw, tenant, handle, stream, trace, submit_ts):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream; charset=utf-8")
        self.send_header("Cache-Control", "no-store")
        self.send_header("X-Request-Id", stream.request_id)
        self.send_header("Connection", "close")
        self.end_headers()
        index = 0
        try:
            for item in self._pull(gw, handle, stream):
                if item[0] == "token":
                    self.wfile.write(_sse("token", {
                        "token": item[1], "index": index,
                        "request_id": stream.request_id}))
                    self.wfile.flush()
                    index += 1
                elif item[0] == "done":
                    ttft = self._observe_ttft(gw, tenant, stream,
                                              submit_ts)
                    record = self._record_of(handle)
                    if record.get("ttft_ms") is None and ttft is not None:
                        # backends that don't stamp timestamps (or use a
                        # different timebase) still report the gateway-
                        # observed TTFT, read on the step thread
                        record["ttft_ms"] = round(ttft, 3)
                    self.wfile.write(_sse("done", record))
                    self.wfile.flush()
                    gw._finish(tenant, stream, "ok", ttft_ms=ttft,
                               trace=trace)
                    return
                else:  # ("error", reason)
                    reason = item[1]
                    self.wfile.write(_sse("error", {
                        "reason": reason,
                        "request_id": stream.request_id}))
                    self.wfile.flush()
                    ttft = self._observe_ttft(gw, tenant, stream,
                                              submit_ts)
                    gw._finish(tenant, stream, "shed", reason=reason,
                               ttft_ms=ttft, trace=trace)
                    return
        except (BrokenPipeError, ConnectionError, OSError):
            # client went away mid-stream: cancel through the backend
            # seam so the slot and its KV blocks are released
            gw._request_cancel(stream.request_id, "disconnect")
            ttft = gw.observe_ttft(tenant, stream, submit_ts)
            gw._finish(tenant, stream, "shed", reason="disconnect",
                       ttft_ms=ttft, trace=trace)

    def _respond_json(self, gw, tenant, handle, stream, trace, submit_ts):
        tokens: List[int] = []
        outcome, reason = "ok", ""
        for item in self._pull(gw, handle, stream):
            if item[0] == "token":
                tokens.append(item[1])
            elif item[0] == "done":
                break
            else:
                outcome, reason = "shed", item[1]
                break
        ttft = self._observe_ttft(gw, tenant, stream, submit_ts)
        record = self._record_of(handle)
        if record.get("ttft_ms") is None and ttft is not None:
            record["ttft_ms"] = round(ttft, 3)
        payload = {"request_id": stream.request_id,
                   "state": "finished" if outcome == "ok" else "shed",
                   "reason": reason, "tokens": tokens, "record": record}
        gw._finish(tenant, stream, outcome, reason=reason, ttft_ms=ttft,
                   trace=trace)
        self._json(200, payload)
