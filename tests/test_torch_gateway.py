"""The port's HTTP/SSE gateway and its tenancy against the JAX
package's, both on loopback (``127.0.0.1``, port 0), every server shut
down in a ``finally``.

- ``TokenBucket`` / ``Tenant`` / ``TenantTable``: the same admissions,
  waits, budgets and trace sampling under one fake clock;
- one scripted session through each gateway over the same fake backend:
  SSE tokens and their ``done`` record, the JSON reply, 401 without a
  key, 403 for an unknown one, 429 with ``Retry-After`` over a tenant's
  quota, 400 and 404, ``/healthz``, and ``/metrics`` (its content type
  and the exposition text of a recording registry) — the same statuses,
  payloads and per-tenant counters;
- the tiny fp32 GPT-2 behind ``init_serving``'s gateway block: SSE
  tokens equal a direct submit's and the JAX gateway's;
- a seeded trace replayed over HTTP (``HttpReplayDriver``): the JAX
  package's report and token streams.
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.serving import config as jax_config
from deepspeed_tpu.serving import gateway as jax_gateway
from deepspeed_tpu.serving import replay as jax_replay
from deepspeed_tpu.serving import request as jax_rq
from deepspeed_tpu.serving import tenancy as jax_tenancy
from deepspeed_tpu.telemetry import registry as jax_registry
from deepspeed_tpu.telemetry import tracing as jax_tracing
from deepspeed_tpu_torch.serving import (config, gateway, replay, request,
                                         tenancy)
from deepspeed_tpu_torch.telemetry import prom, registry, tracing
from tests import torch_fleet_fakes as ff
from tests.test_torch_gpt2 import jax_engine, port_model

PKGS = {
    "jax": types.SimpleNamespace(
        config=jax_config, gateway=jax_gateway, tenancy=jax_tenancy,
        registry=jax_registry, tracing=jax_tracing, replay=jax_replay,
        fakes=ff.fakes(jax_rq)),
    "port": types.SimpleNamespace(
        config=config, gateway=gateway, tenancy=tenancy, registry=registry,
        tracing=tracing, replay=replay, fakes=ff.fakes(request)),
}

TENANTS = [
    {"name": "acme", "api_key": "acme-key", "slo_class": "gold",
     "requests_per_sec": 1000.0},
    {"name": "spam", "api_key": "spam-key", "slo_class": "best_effort",
     "requests_per_sec": 1.0, "burst_requests": 1.0,
     "trace_sample_rate": 1.0},
]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread while a test of this file runs: the test
    workers share the machine's cores, and the tiny model's ops spend
    more on waking threads than on work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(fn):
    return fn(PKGS["port"]), fn(PKGS["jax"])


def _stepped(gw, fn):
    """``fn()`` on a client thread while this thread steps the gateway's
    backend (the real engines are stepped from one thread only)."""
    out = []
    client = threading.Thread(target=lambda: out.append(fn()), daemon=True)
    client.start()
    deadline = time.monotonic() + 60
    while client.is_alive() and time.monotonic() < deadline:
        if gw.pending:
            gw.step()
        else:
            time.sleep(0.005)
    client.join(5)
    assert not client.is_alive()
    return out[0]


def _real_session(name, params):
    serving = {"block_size": 8, "decode_slots": 2, "prompt_buckets": [16],
               "default_max_new_tokens": 6,
               "gateway": {"tenants": TENANTS}}
    clk = ff.Clock()
    if name == "jax":
        ie = jax_engine(seed=1, serving=serving)[0]
        gw = deepspeed_tpu.init_serving(ie, clock=clk)
        cls = jax_gateway.ServingGateway
    else:
        ie = deepspeed_tpu_torch.init_inference(
            port_model(params), dtype="fp32", device="cpu", serving=serving)
        gw = deepspeed_tpu_torch.init_serving(ie, clock=clk)
        cls = gateway.ServingGateway
    assert isinstance(gw, cls)
    try:
        prompt = [5, 6, 7, 8]
        direct = gw.submit(prompt, max_new_tokens=6)
        gw.drain()
        sse = _stepped(gw, lambda: _call(
            gw.url, "/v1/generate", {"prompt": prompt, "max_new_tokens": 6},
            key="acme-key"))
        toks = [json.loads(line[6:])["token"]
                for line in sse[3].splitlines()
                if line.startswith("data: ") and '"token"' in line]
        return (direct.tokens, toks, sse[0],
                _call(gw.url, "/v1/generate", {"prompt": [1]})[0],
                _stepped(gw, lambda: _call(
                    gw.url, "/v1/generate",
                    {"prompt": [1], "max_new_tokens": 1},
                    key="spam-key"))[0],
                _call(gw.url, "/v1/generate", {"prompt": [2]},
                      key="spam-key")[0],
                _call(gw.url, "/metrics")[1])
    finally:
        gw.close()


def test_real_engine_streams_like_direct_submit_and_jax():
    params = jax_engine(seed=1)[1]
    port = _real_session("port", params)
    ref = _real_session("jax", params)
    assert port == ref
    direct, toks, *statuses, ctype = port
    assert len(direct) == 6 and toks == direct
    assert statuses == [200, 401, 200, 429]
    assert ctype == prom.CONTENT_TYPE


def test_tenancy_decides_like_jax():
    def run(pkg):
        clk = ff.Clock()
        gcfg = pkg.config.GatewayConfig(tenants=[
            {"name": "a", "api_key": "ka", "requests_per_sec": 2.0,
             "tokens_per_sec": 10.0, "max_inflight": 2,
             "trace_sample_rate": 0.4},
            {"name": "b", "api_key": "kb", "slo_class": "batch",
             "burst_tokens": 3.0, "tokens_per_sec": 1.0}],
            budget_window=4)
        table = pkg.tenancy.TenantTable(gcfg, clock=clk)
        log = [table.open, table.resolve("nope"), table.resolve(None)]
        for step in range(12):
            for key, est in (("ka", 4.0), ("kb", 2.0)):
                t = table.resolve(key)
                log.append((t.name, t.priority, t.admit(est),
                            t.sample_trace(), t.inflight))
                if step % 3 == 0:
                    t.release()
                t.record_outcome(shed=step % 4 == 0,
                                 ttft_ms=10.0 * step)
                log.append(t.budget_remaining())
            clk.advance(0.3)
        bucket = pkg.tenancy.TokenBucket(2.0, burst=4.0, clock=clk)
        for n in (4.0, 1.0, 3.0):
            log.append(bucket.ask(n))
            bucket.take(n)
        return log

    port, ref = _both(run)
    assert port == ref


class Armed(ff.Recorder):
    """A recording telemetry object with a live metric registry and a
    span tracer, so the gateways' metrics and spans land somewhere."""

    def __init__(self, pkg):
        super().__init__()
        self.metrics = pkg.registry.MetricRegistry()
        self.tracer = pkg.tracing.Tracer(
            emit=lambda kind, name, step=None, data=None:
            self.emit(kind, name, step=step, **(data or {})))


def _backend(pkg):
    f = pkg.fakes

    class Backend(f.FakeReplica):
        @property
        def pending(self):
            return bool(self.queue or self.running)

        def drain(self, max_steps=None):
            while self.pending:
                self.step()
            return []

    return Backend(slots=4, queue_cap=16)


def _call(url, path, body=None, key=None, raw=None):
    """One HTTP call: (status, content type, headers that matter, body
    lines) — SSE bodies as their ``event``/``data`` lines."""
    headers = {"Content-Type": "application/json"}
    if key:
        headers["Authorization"] = f"Bearer {key}"
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode("utf-8"))
    req = urllib.request.Request(url + path, data=data, headers=headers,
                                 method="GET" if data is None else "POST")
    try:
        resp = urllib.request.urlopen(req, timeout=30)
    except urllib.error.HTTPError as e:
        resp = e
    with resp:
        text = resp.read().decode("utf-8")
        kept = {k: resp.headers.get(k) for k in ("Retry-After",)}
        status = resp.status if hasattr(resp, "status") else resp.code
        return status, resp.headers.get("Content-Type"), kept, text


def _session(pkg):
    clk = ff.Clock()
    tel = Armed(pkg)
    gw = pkg.gateway.ServingGateway(
        _backend(pkg), {"tenants": TENANTS, "pump": True, "poll_secs": 0.01},
        telemetry=tel, clock=clk).start()
    try:
        out = [
            _call(gw.url, "/v1/generate", {"prompt": [5, 6, 7],
                                           "max_new_tokens": 4,
                                           "request_id": "s1"},
                  key="acme-key"),
            _call(gw.url, "/v1/generate", {"prompt": [9], "max_new_tokens": 3,
                                           "stream": False,
                                           "request_id": "s2"},
                  key="acme-key"),
            _call(gw.url, "/v1/generate", {"prompt": [1]}),
            _call(gw.url, "/v1/generate", {"prompt": [1]}, key="who"),
            _call(gw.url, "/v1/generate", {"prompt": [1, 2],
                                           "max_new_tokens": 2,
                                           "request_id": "s3"},
                  key="spam-key"),
            _call(gw.url, "/v1/generate", {"prompt": [3]}, key="spam-key"),
            _call(gw.url, "/v1/generate", None, key="acme-key",
                  raw=b"{not json"),
            _call(gw.url, "/nope"),
            _call(gw.url, "/healthz"),
        ]
        clk.advance(1.0)
        out.append(_call(gw.url, "/v1/generate",
                         {"prompt": [6], "max_new_tokens": 2,
                          "request_id": "s4"}, key="spam-key"))
        # the handler threads account a request just after its last byte
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not all(
                gw.stats()["tenants"][t].get("ok") == 2
                for t in ("acme", "spam")):
            time.sleep(0.01)
        metrics = _call(gw.url, "/metrics")
        return out, metrics, gw.stats()
    finally:
        gw.close()


def test_gateway_session_matches_jax():
    port, ref = _both(_session)
    assert port == ref
    calls, metrics, stats = port
    statuses = [c[0] for c in calls]
    assert statuses == [200, 200, 401, 403, 200, 429, 400, 404, 200, 200]
    sse = calls[0][3]
    toks = [json.loads(line[6:])["token"] for line in sse.splitlines()
            if line.startswith("data: ") and '"token"' in line]
    assert toks == [ff.greedy([5, 6, 7], i) for i in range(4)]
    assert calls[0][1].startswith("text/event-stream")
    assert int(calls[5][2]["Retry-After"]) >= 1
    assert metrics[0] == 200 and metrics[1] == prom.CONTENT_TYPE
    assert 'ds_gateway_rejects_total{reason="rate",tenant="spam"} 1' \
        in metrics[3]
    assert stats["tenants"]["spam"]["http_429"] == 1


def _http_replay(pkg):
    """One seeded trace replayed over real HTTP through ``HttpReplayDriver``
    into the gateway (two tenants sharing prompt prefixes), on the
    replay clock."""
    replay = pkg.replay
    clk = replay.ReplayClock()
    trace = replay.synthesize_trace(
        6.0, seed=23, base_rate=2.0, diurnal_fraction=0.5,
        diurnal_period_secs=6.0, tenants=2, shared_fraction=1.0,
        shared_prefix_len=3, prompt_len_mean=5.0, prompt_len_max=10,
        gen_mean=3.0, gen_max=6)
    gw = pkg.gateway.ServingGateway(
        _backend(pkg), {"tenants": [
            {"name": "t1", "api_key": "t1-key", "slo_class": "gold"},
            {"name": "t2", "api_key": "t2-key"}]}, clock=clk).start()
    try:
        rep = replay.TraceReplayer(replay.HttpReplayDriver(gw), trace, clk,
                                   step_secs=0.05, seed=31, vocab_size=97,
                                   max_steps=20000)
        report = rep.run()
        return report, [(h.state, list(h.tokens)) for h in rep.handles]
    finally:
        gw.close()


def test_http_replay_matches_jax():
    port, ref = _both(_http_replay)
    assert port == ref
    report, handles = port
    assert report["requests"] > 5 and report["incomplete"] == 0
    assert set(report["tenants"]) == {"t1", "t2"}
    assert all(state == "finished" for state, _ in handles)
