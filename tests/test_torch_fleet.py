"""The port's serving fleet against the JAX package's.

Every host decision of the fleet is policy, so each scripted scenario
runs through both packages — the same fake replicas (or ``ChaosReplica``
wrapping them), one fake clock, a recording ``telemetry=`` object — and
the two must agree EXACTLY: the event streams (names and payloads),
``stats()``, gauges, health states and every client's token stream.

- config: the ``router``/``fleet``/``replay``/``migration``/``gateway``
  blocks accept and refuse the same values and resolve the same fields;
- ``ReplicaHealth``, the autoscaler's budgets and decisions, the
  capacity model's fits, the trace generators' arrivals;
- ``ReplicaRouter``: routing, failover with deduplicated replay (crash,
  flaky submit and steps, stall), the degradation ladder, migration on
  a breaker trip and its fallbacks, drains, cancel, deadlines, sampled
  prefixes; a tensor-parallel replica is refused;
- ``FleetManager`` under a burst trace through ``TraceReplayer``: scale
  up through a flaky factory, drains, parks, rebalance;
- the whole slice through ``init_serving`` on the tiny fp32 GPT-2 with
  ``router``, ``migration`` and ``fleet`` on: two replicas, a
  ``ReplayClock``, one ``burst_trace`` and one ``ChaosReplica`` crash
  give the JAX stack's tokens, sheds and counters;
- ``deepspeed_tpu_torch.serving`` exports the JAX package's names.
"""

import json
import types

import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.runtime.resilience import chaos as jax_chaos
from deepspeed_tpu.serving import autoscaler as jax_autoscaler
from deepspeed_tpu.serving import capacity as jax_capacity
from deepspeed_tpu.serving import config as jax_config
from deepspeed_tpu.serving import health as jax_health
from deepspeed_tpu.serving import replay as jax_replay
from deepspeed_tpu.serving import request as jax_rq
from deepspeed_tpu.serving import router as jax_router
from deepspeed_tpu_torch.runtime.resilience import chaos
from deepspeed_tpu_torch.serving import (autoscaler, capacity, config,
                                         health, replay, request, router)
from tests import torch_fleet_fakes as ff
from tests.test_torch_gpt2 import jax_engine, port_model

PKGS = {
    "jax": types.SimpleNamespace(
        chaos=jax_chaos, autoscaler=jax_autoscaler, capacity=jax_capacity,
        config=jax_config, health=jax_health, replay=jax_replay,
        rq=jax_rq, router=jax_router, fakes=ff.fakes(jax_rq)),
    "port": types.SimpleNamespace(
        chaos=chaos, autoscaler=autoscaler, capacity=capacity,
        config=config, health=health, replay=replay, rq=request,
        router=router, fakes=ff.fakes(request)),
}


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
    """``fn(pkg)`` through each package; returns (port, jax)."""
    out = {}
    for name in ("jax", "port"):
        try:
            out[name] = fn(PKGS[name])
        finally:
            PKGS[name].chaos.clear()
    return out["port"], out["jax"]


# ---------------------------------------------------------------------------
# the whole slice through init_serving, on the tiny GPT-2
# ---------------------------------------------------------------------------
SLICE_SERVING = {
    "block_size": 8, "decode_slots": 3, "prompt_buckets": [16],
    "max_queue_depth": 3, "default_max_new_tokens": 6,
    "sampling": {},
    "router": {"replicas": 2, "failure_threshold": 2},
    "migration": {},
    "fleet": {"min_replicas": 1, "max_replicas": 3,
              "target_ttft_p95_ms": 1000.0, "fast_window_steps": 4,
              "scale_up_cooldown_steps": 3, "scale_down_quiet_steps": 40,
              "scale_down_cooldown_steps": 40},
}


@pytest.fixture(scope="module")
def slice_engine():
    """The JAX inference engine of the slice and its weights."""
    return jax_engine(seed=1, serving=SLICE_SERVING)


def _slice(pkg_name, jax_ie, params):
    """Two replicas on the same weights behind init_serving's fleet, the
    second crashing at its 4th step; the replayer's hook migrates
    replica 0's work at the 8th step, mid-decode. The burst sheds some
    requests (queue full, then the ladder's tier sheds) and scales the
    fleet up through the factory."""
    is_jax = pkg_name == "jax"
    pkg = PKGS[pkg_name]
    clk = pkg.replay.ReplayClock()

    if is_jax:
        from deepspeed_tpu.serving.engine import ServingEngine
        init = deepspeed_tpu.init_serving
        ie = jax_ie
    else:
        from deepspeed_tpu_torch.serving.engine import ServingEngine
        init = deepspeed_tpu_torch.init_serving
        ie = deepspeed_tpu_torch.init_inference(
            port_model(params), dtype="fp32", device="cpu",
            serving=SLICE_SERVING)
    # every replica wraps the one inference engine (its weights), each
    # with its own pools and scheduler
    engines = [ServingEngine(ie, clock=clk) for _ in range(2)]
    engines[1] = pkg.chaos.ChaosReplica(engines[1], crash_at_step=4)
    fm = init(None, replicas=engines, clock=clk,
              factory=lambda: ServingEngine(ie, clock=clk))
    assert isinstance(fm, pkg.router.FleetManager)
    trace = pkg.replay.burst_trace(6, seed=2, base_rate=1.5,
                                   bursts=[(1, 2, 6.0)], prompt_len_mean=6,
                                   prompt_len_max=12, gen_mean=5,
                                   gen_max=6, sampled_fraction=0.3,
                                   temperature=0.8)
    moved = []

    def hook(rep, done):
        if rep.steps == 8:
            moved.append(fm.router.migrate_work(0, "rebalance"))

    rep = pkg.replay.TraceReplayer(fm, trace, clk, step_secs=0.25, seed=3,
                                   vocab_size=256, max_steps=400,
                                   on_step=hook)
    out = rep.run()
    st = fm.stats()
    return {"tokens": [(h.request_id, h.state, h.finish_reason, h.tokens)
                       for h in rep.handles],
            "shed": sorted(h.request_id for h in rep.handles
                           if h.state == "shed"),
            "moved": moved, "report": out,
            "counters": {k: st[k] for k in ("scale_ups", "scale_downs",
                                            "parks", "factory_builds",
                                            "drain_migrations")},
            "router": {k: st["router"][k] for k in
                       ("failovers", "migrations", "deduped_tokens",
                        "replay_divergence", "finished", "shed",
                        "shed_reasons", "replica_states")}}


def test_whole_slice_serves_like_jax(slice_engine):
    ref = _slice("jax", *slice_engine)
    port = _slice("port", *slice_engine)
    r = port["router"]
    assert r["failovers"] > 0 and r["migrations"] > 0
    assert r["deduped_tokens"] > 0 and r["replay_divergence"] == 0
    assert port["counters"]["scale_ups"] > 0
    assert port == ref, json.dumps({"port": port, "jax": ref}, default=str)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
BLOCKS = {
    "router": [{}, {"replicas": 3, "ladder_enter": [0.5, 0.6],
                    "ladder_exit": [0.2, 0.3], "stall_timeout_secs": 2.0},
               {"replicas": 0}, {"ladder_enter": [0.5], "ladder_exit": []},
               {"ladder_enter": [0.5, 0.6], "ladder_exit": [0.6, 0.1]},
               {"ladder_enter": [0.9, 0.5], "ladder_exit": [0.1, 0.2]},
               {"enabled": False}],
    "fleet": [{}, {"min_replicas": 2, "max_replicas": 2},
              {"min_replicas": 3, "max_replicas": 2},
              {"scale_down_load": 0.9, "scale_up_load": 0.8},
              {"rebalance_fragmentation": 1.5}, {"drain_timeout_steps": -1},
              {"factory_backoff_steps": 0}],
    "replay": [{}, {"step_secs": 0.0}, {"vocab_size": 1},
               {"trace_path": "t.jsonl", "seed": 4, "max_steps": 9}],
    "migration": [{}, {"failover": False, "max_requests_per_sweep": 2},
                  {"max_requests_per_sweep": -1}],
    "gateway": [{}, {"port": 70000}, {"poll_secs": 0.0},
                {"tenants": [{"name": "a", "api_key": "k"},
                             {"name": "a", "api_key": "j"}]},
                {"tenants": [{"name": "a", "api_key": "k",
                              "slo_class": "platinum"}]},
                {"tenants": [{"name": "a", "api_key": "k",
                              "trace_sample_rate": 2.0}]},
                {"tenants": [{"name": "a", "api_key": ""}]},
                {"gold": {"priority": -1}},
                {"tenants": [{"name": "a", "api_key": "k",
                              "slo_class": "gold", "requests_per_sec": 2,
                              "max_inflight": 3}], "pump": True}],
}
CASES = [(k, i) for k, vs in BLOCKS.items() for i in range(len(vs))]


def _resolve(pkg, serving):
    try:
        return ("ok", pkg.config.ServingConfig(**serving).model_dump())
    except (ValueError, NotImplementedError) as e:
        return ("refused", type(e).__name__, str(e).split("\n")[1:3])


@pytest.mark.parametrize("key,i", CASES, ids=[f"{k}{i}" for k, i in CASES])
def test_fleet_blocks_resolve_like_jax(key, i):
    serving = {key: BLOCKS[key][i]}
    if key == "fleet":
        serving["router"] = {}
    port, ref = _both(lambda pkg: _resolve(pkg, serving))
    assert port == ref


def test_fleet_needs_a_router_like_jax():
    port, ref = _both(lambda pkg: _resolve(pkg, {"fleet": {}}))
    assert port == ref and port[0] == "refused"
    port, ref = _both(lambda pkg: _resolve(
        pkg, {"fleet": {}, "router": {"enabled": False}}))
    assert port == ref and port[0] == "refused"


# ---------------------------------------------------------------------------
# health, autoscaler, capacity, trace generators
# ---------------------------------------------------------------------------
def _health_walk(pkg):
    clk = ff.Clock()
    events = []
    cfg = pkg.config.RouterConfig(failure_threshold=2, max_trips=3,
                                  probe_backoff_secs=0.5,
                                  degraded_ttft_ms=100.0,
                                  degraded_shed_rate=0.2)
    h = pkg.health.ReplicaHealth(cfg, 0, clk,
                                 emit=lambda n, **d: events.append((n, d)))
    log = []
    ops = [("failure",), ("success",), ("failure",), ("failure",),
           ("probe?",), ("advance", 0.6), ("probe?",), ("begin",),
           ("failure",), ("advance", 2.0), ("begin",), ("probe_ok",),
           ("observe", 150.0, 0.0), ("observe", 60.0, 0.0),
           ("observe", 40.0, 0.0), ("observe", 10.0, 0.5),
           ("observe", 10.0, 0.01), ("stall",), ("advance", 9.0),
           ("begin",), ("inconclusive",), ("drain",), ("failure",),
           ("reactivate",), ("stall",), ("advance", 99.0), ("begin",),
           ("stall",), ("crash",), ("reactivate",)]
    for op in ops:
        name = op[0]
        if name == "failure":
            h.record_failure("f")
        elif name == "success":
            h.record_success()
        elif name == "advance":
            clk.advance(op[1])
        elif name == "probe?":
            log.append(h.can_probe(clk()))
        elif name == "begin":
            h.begin_probe()
        elif name == "probe_ok":
            h.probe_success()
        elif name == "inconclusive":
            h.probe_inconclusive()
        elif name == "observe":
            h.observe(ttft_p95_ms=op[1], shed_rate=op[2])
        elif name == "stall":
            h.record_stall("stall")
        elif name == "crash":
            h.record_crash("crash")
        elif name == "drain":
            h.start_drain()
        elif name == "reactivate":
            h.reactivate()
        log.append((name, h.state, h.trips, h.consecutive_failures,
                    h.routable, h.alive, h.probing))
    return log, events, [pkg.health.probe_backoff(0.5, n) for n in range(6)]


def test_health_walks_like_jax():
    port, ref = _both(_health_walk)
    assert port == ref
    states = {entry[1] for entry in port[0] if isinstance(entry, tuple)}
    assert states >= {"healthy", "degraded", "tripped", "dead",
                      "draining"}


def _autoscale_walk(pkg):
    cfg = pkg.config.FleetConfig(
        min_replicas=1, max_replicas=3, target_ttft_p95_ms=200.0,
        target_shed_rate=0.05, fast_window_steps=4, slow_window_steps=16,
        scale_up_cooldown_steps=2, scale_down_cooldown_steps=3,
        scale_down_quiet_steps=3)
    sc = pkg.autoscaler.Autoscaler(cfg)
    rng = np.random.default_rng(3)
    active, log = 1, []
    for step in range(60):
        phase = (step // 15) % 2
        recs = [{"state": "shed" if rng.random() < 0.3 * phase else
                 "finished", "ttft_ms": float(rng.gamma(2.0, 60 + 200 *
                                                        phase))}
                for _ in range(int(rng.integers(0, 4)))]
        sc.observe_requests(recs)
        overload = float(min(1.0, 0.2 + 0.7 * phase * rng.random()))
        sc.observe_step(overload)
        d = sc.decide(active, overload=overload)
        if d is not None:
            active += 1 if d.action == "up" else -1
            d = vars(d)
        log.append((step, d, sc.budget_remaining(), sc.burn_rates()))
    win = pkg.autoscaler.BudgetWindow(8, 0.1)
    for good, bad in ((5, 0), (3, 2), (0, 4), (9, 0)):
        win.observe(good, bad)
        log.append((win.rate, win.burn_rate(), win.remaining()))
    return log, active


def test_autoscaler_decides_like_jax():
    port, ref = _both(_autoscale_walk)
    assert port == ref
    assert any(entry[1] is not None for entry in port[0][:60])


def _capacity_fit(pkg):
    model = pkg.capacity.CapacityModel()
    rng = np.random.default_rng(7)
    for _ in range(300):
        load = float(rng.random() * 1.5)
        model.observe(load, ttft_ms=float(20 + 400 * load ** 2
                                          + rng.random() * 10),
                      queue_ms=float(100 * load), tokens=float(
                          rng.integers(0, 40)), secs=0.25)
    other = pkg.capacity.CapacityModel()
    other.observe(0.3, ttft_ms=50.0, tokens=10.0, secs=1.0)
    model.merge(other)
    slo = {"ttft_p95_ms": 200.0}
    return (model.curve(), model.sustainable_tokens_per_sec(200.0, 80.0),
            [model.fleet_size_for(x, slo, max_size=8)
             for x in (0.0, 10.0, 100.0, 1e4)],
            model.ttft_p95_at(0.5), model.throughput_at(0.9),
            model.load_of({"slots_busy": 3, "queue_depth": 2,
                           "slots_total": 4}))


def test_capacity_fits_like_jax():
    port, ref = _both(_capacity_fit)
    assert port == ref
    assert port[0]


TRACES = {
    "diurnal": lambda r: r.diurnal_trace(
        40, seed=3, base_rate=1.5, peak_fraction=0.6, period_secs=20,
        tenants=3, shared_fraction=0.5, shared_prefix_len=4,
        priorities=3),
    "burst": lambda r: r.burst_trace(
        30, seed=5, base_rate=0.8, bursts=[(5, 4, 6.0)],
        prompt_len_mean=5, prompt_len_max=8, gen_mean=4, gen_max=6,
        deadline_ms=2000.0),
    "sampled": lambda r: r.synthesize_trace(
        20, seed=11, base_rate=2.0, sampled_fraction=0.5,
        temperature=0.8, top_p=0.9),
}


@pytest.mark.parametrize("name", list(TRACES))
def test_trace_generators_give_jax_arrivals(name, tmp_path):
    def run(pkg):
        trace = TRACES[name](pkg.replay)
        path = str(tmp_path / f"{id(pkg)}.jsonl")
        pkg.replay.save_trace(path, trace)
        back = pkg.replay.load_trace(path)
        assert [a.to_json() for a in back] == [a.to_json() for a in trace]
        return [a.to_json() for a in trace], open(path).read()

    port, ref = _both(run)
    assert port == ref and len(port[0]) > 5


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------
def _router(pkg, replicas, clock, tel, migration=None, **cfg):
    cfg.setdefault("probe_backoff_secs", 0.5)
    return pkg.router.ReplicaRouter(
        replicas, config=pkg.config.RouterConfig(**cfg), clock=clock,
        telemetry=tel, migration=migration)


def _collect(rt, handles, tel, streamed):
    return {"events": tel.events, "stats": rt.stats(),
            "gauges": rt.fleet_gauges(),
            "handles": [(h.request_id, h.state, h.finish_reason, h.tokens,
                         h.attempt, h.replica) for h in handles],
            "streamed": streamed,
            "health": [(h.state, h.trips, h.consecutive_failures)
                       for h in rt.health]}


def _stream_log(streamed):
    def cb(h, tok, done):
        streamed.append((h.request_id, int(tok), bool(done)))
    return cb


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 200, int(rng.integers(2, 9)))]
            for _ in range(n)]


def _scenario_crash(pkg):
    f, clk, tel, streamed = pkg.fakes, ff.Clock(), ff.Recorder(), []
    reps = [f.FakeReplica(slots=2),
            pkg.chaos.ChaosReplica(f.FakeReplica(slots=2), crash_at_step=3),
            f.FakeReplica(slots=1)]
    rt = _router(pkg, reps, clk, tel)
    hs = [rt.submit(p, max_new_tokens=6, request_id=f"r{i}",
                    stream=_stream_log(streamed))
          for i, p in enumerate(_prompts(7))]
    rt.step()
    hs.append(rt.submit([5, 6, 7], max_new_tokens=0, request_id="late",
                        stream=_stream_log(streamed)))
    rt.drain(max_steps=60)
    return _collect(rt, hs, tel, streamed)


def _scenario_flaky(pkg):
    f, clk, tel, streamed = pkg.fakes, ff.Clock(), ff.Recorder(), []
    reps = [pkg.chaos.ChaosReplica(f.FakeReplica(), fail_submit_at=1,
                                   fail_submit_times=2),
            pkg.chaos.ChaosReplica(f.FakeReplica(), fail_step_at=2,
                                   fail_step_times=4)]
    rt = _router(pkg, reps, clk, tel, failure_threshold=2, max_failovers=3)
    hs = []
    for i, p in enumerate(_prompts(6, seed=1)):
        hs.append(rt.submit(p, max_new_tokens=5, request_id=f"q{i}",
                            stream=_stream_log(streamed)))
        rt.step()
        clk.advance(0.4)
    rt.drain(max_steps=80)
    clk.advance(5.0)
    hs.append(rt.submit([1, 2], max_new_tokens=3, request_id="probe"))
    rt.drain(max_steps=20)
    return _collect(rt, hs, tel, streamed)


def _scenario_stall(pkg):
    f, clk, tel, streamed = pkg.fakes, ff.Clock(), ff.Recorder(), []
    stall = pkg.chaos.ChaosReplica(f.FakeReplica(), stall_at_step=2,
                                   stall_secs=3.0, sleep=clk.advance)
    rt = _router(pkg, [stall, f.FakeReplica()], clk, tel,
                 stall_timeout_secs=1.0)
    hs = [rt.submit(p, max_new_tokens=5, request_id=f"s{i}",
                    deadline_ms=4500.0 if i == 0 else 0.0,
                    stream=_stream_log(streamed))
          for i, p in enumerate(_prompts(4, seed=2))]
    rt.drain(max_steps=40)
    return _collect(rt, hs, tel, streamed)


def _scenario_ladder(pkg):
    f, clk, tel, streamed = pkg.fakes, ff.Clock(), ff.Recorder(), []
    a, b = f.GaugeStub(depth=0, cap=10), f.GaugeStub(depth=0, cap=10)
    rt = _router(pkg, [a, b], clk, tel, ladder_dwell_steps=2,
                 clamp_max_new_tokens=2)
    hs = []
    for step, depth in enumerate([0, 8, 16, 19, 20, 20, 12, 9, 4, 0, 0, 0]):
        a.depth = b.depth = depth // 2
        rt.step()
        for prio, plen in ((0, 3), (1, 12), (2, 4)):
            hs.append(rt.submit(list(range(1, plen + 1)),
                                max_new_tokens=6 if prio else 0,
                                priority=prio, request_id=f"l{step}.{prio}",
                                stream=_stream_log(streamed)))
    a.depth = b.depth = 0
    rt.drain(max_steps=60)
    return _collect(rt, hs, tel, streamed)


def _scenario_migration(pkg):
    f, clk, tel, streamed = pkg.fakes, ff.Clock(), ff.Recorder(), []
    src = pkg.chaos.ChaosReplica(f.MigratableReplica(slots=3),
                                 fail_step_at=3, fail_step_times=9)
    crashy = pkg.chaos.ChaosReplica(f.MigratableReplica(slots=2),
                                    crash_during_migration=1)
    flaky = pkg.chaos.ChaosReplica(f.MigratableReplica(slots=2),
                                   flaky_transfer_at=1,
                                   flaky_transfer_times=1)
    dst = f.MigratableReplica(slots=4)
    rt = _router(pkg, [src, crashy, flaky, dst], clk, tel,
                 migration={"max_requests_per_sweep": 0},
                 failure_threshold=1)
    hs = [rt.submit(p, max_new_tokens=7, request_id=f"m{i}",
                    stream=_stream_log(streamed))
          for i, p in enumerate(_prompts(9, seed=3))]
    rt.step()
    rt.step()
    moved = [rt.migrate_work(1, "rebalance", consumer="rebalance"),
             rt.migrate_work(2, "drain")]
    rt.drain(max_steps=60)
    out = _collect(rt, hs, tel, streamed)
    out["moved"] = moved
    return out


def _scenario_lifecycle(pkg):
    f, clk, tel, streamed = pkg.fakes, ff.Clock(), ff.Recorder(), []
    reps = [f.FakeReplica(), f.FakeReplica(), f.FakeReplica()]
    rt = _router(pkg, reps, clk, tel)
    hs = [rt.submit(p, max_new_tokens=6, request_id=f"c{i}",
                    deadline_ms=1500.0 * (i % 2),
                    stream=_stream_log(streamed))
          for i, p in enumerate(_prompts(6, seed=4))]
    rt.step()
    rt.start_drain(0)
    rt.start_drain(0)
    log = [rt.cancel("c1"), rt.cancel("c1"), rt.cancel("nope")]
    clk.advance(1.0)
    rt.step()
    rt.yield_work(1, "yield")
    try:
        rt.reactivate(2)
    except ValueError as e:
        log.append(str(e))
    hs.append(rt.submit([3, 4], request_id="c0"))   # duplicate id
    clk.advance(1.0)
    rt.drain(max_steps=30)
    rt.reactivate(0, replica=f.FakeReplica())
    log.append(rt.add_replica(f.FakeReplica(slots=1)))
    hs += [rt.submit(p, max_new_tokens=3, request_id=f"d{i}")
           for i, p in enumerate(_prompts(3, seed=5))]
    rt.drain(max_steps=30)
    log.append([rt.assigned(i) for i in range(len(rt.replicas))])
    out = _collect(rt, hs, tel, streamed)
    out["log"] = log
    out["cancelled"] = [r.cancelled for r in reps]
    return out


def _scenario_sampling(pkg):
    f, clk, tel, streamed = pkg.fakes, ff.Clock(), ff.Recorder(), []
    reps = [pkg.chaos.ChaosReplica(f.FakeReplica(sampling=True),
                                   crash_at_step=2),
            f.FakeReplica(sampling=True), f.FakeReplica()]
    rt = _router(pkg, reps, clk, tel)
    hs = [rt.submit(p, max_new_tokens=5, request_id=f"k{i}",
                    do_sample=True, seed=i if i % 2 else None,
                    temperature=0.7, stream=_stream_log(streamed))
          for i, p in enumerate(_prompts(4, seed=6))]
    rt.drain(max_steps=30)
    return _collect(rt, hs, tel, streamed)


SCENARIOS = {"crash": _scenario_crash, "flaky": _scenario_flaky,
             "stall": _scenario_stall, "ladder": _scenario_ladder,
             "migration": _scenario_migration,
             "lifecycle": _scenario_lifecycle,
             "sampling": _scenario_sampling}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_router_decides_like_jax(name):
    port, ref = _both(SCENARIOS[name])
    assert port == ref
    st = port["stats"]
    assert st["replay_divergence"] == 0
    # every client stream is each position exactly once, in order
    streamed = {}
    for rid, tok, _ in port["streamed"]:
        streamed.setdefault(rid, []).append(tok)
    handles = {}
    for rid, _, _, tokens, _, _ in port["handles"]:
        handles.setdefault(rid, tokens)   # a duplicate id's handle is 2nd
    for rid, toks in streamed.items():
        assert toks == handles[rid]
    if name in ("crash", "flaky", "stall"):
        assert st["failovers"] > 0
    if name in ("crash", "stall"):
        assert st["deduped_tokens"] > 0
    if name == "migration":
        assert st["migrations"] > 0 and st["failovers"] > 0
    if name == "ladder":
        assert st["tier_transitions"] >= 2


def test_tensor_parallel_replica_is_refused():
    """A bare tp engine on one rank is refused, pointing at the group
    proxy (serving/group_replica.py) that routes tp replicas."""
    class TpReplica:
        engine = types.SimpleNamespace(mp_world_size=2)

    with pytest.raises(ValueError, match="GroupReplica"):
        router.ReplicaRouter([TpReplica()])
    rt = router.ReplicaRouter([PKGS["port"].fakes.FakeReplica()])
    with pytest.raises(ValueError, match="GroupReplica"):
        rt.add_replica(TpReplica())


# ---------------------------------------------------------------------------
# the fleet manager under a trace
# ---------------------------------------------------------------------------
FLEET_CFG = {"min_replicas": 1, "max_replicas": 3,
             "target_ttft_p95_ms": 800.0, "target_shed_rate": 0.05,
             "fast_window_steps": 4, "slow_window_steps": 32,
             "scale_up_cooldown_steps": 2, "scale_down_cooldown_steps": 6,
             "scale_down_quiet_steps": 6, "factory_backoff_steps": 2,
             "rebalance_fragmentation": 0.5, "rebalance_cooldown_steps": 5}


def _fleet_replay(pkg):
    f, tel = pkg.fakes, ff.Recorder()
    clk = pkg.replay.ReplayClock()
    rt = pkg.router.ReplicaRouter(
        [f.FragStub(frag=0.7, slots=2, queue_cap=4)],
        config={"failure_threshold": 3}, clock=clk, telemetry=tel,
        migration={})
    factory = pkg.chaos.FlakyFactory(
        pkg.router.CallableReplicaFactory(
            lambda: f.MigratableReplica(slots=2, queue_cap=4)),
        fail_times=1)
    cap = pkg.capacity.CapacityModel()
    fm = pkg.router.FleetManager(rt, factory=factory, config=FLEET_CFG,
                                 capacity=cap)
    trace = pkg.replay.burst_trace(30, seed=5, base_rate=0.8,
                                   bursts=[(4, 6, 6.0), (20, 3, 4.0)],
                                   prompt_len_mean=5, prompt_len_max=8,
                                   gen_mean=4, gen_sigma=0.3, gen_max=6)
    rep = pkg.replay.TraceReplayer(fm, trace, clk, step_secs=0.25, seed=9,
                                   max_steps=3000)
    out = rep.run()
    manual = [fm.scale_up("manual"), fm.scale_down(reason="manual")]
    fm.drain(max_steps=50)
    return {"report": out, "slo": rep.report({"ttft_p95_ms": 800.0}),
            "events": tel.events, "stats": fm.stats(), "manual": manual,
            "tokens": [(h.request_id, h.state, h.tokens)
                       for h in rep.handles],
            "curve": cap.curve(), "factory": factory.builds}


def test_fleet_manager_replays_like_jax():
    port, ref = _both(_fleet_replay)
    assert port == ref
    st = port["stats"]
    assert st["factory_failures"] == 1 and st["factory_builds"] >= 1
    assert st["scale_ups"] >= 1 and st["scale_downs"] >= 1
    assert st["rebalances"] >= 1
    assert st["router"]["replay_divergence"] == 0
    for rid, state, tokens in port["tokens"]:
        assert state in ("finished", "shed")


def test_serving_package_exports_jax_names():
    import deepspeed_tpu.serving as jax_serving
    import deepspeed_tpu_torch.serving as port_serving

    assert sorted(port_serving.__all__) == sorted(jax_serving.__all__)
    for name in port_serving.__all__:
        assert getattr(port_serving, name) is not None, name
