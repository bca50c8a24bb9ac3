"""The telemetry slice against the JAX package's.

- the ``telemetry`` section and the monitor / comms-logger keys: JAX's
  defaults and validation;
- the tiny GPT-2 training engine (3 steps) and the tiny serving engine
  (4 requests behind a one-replica router, so requests carry traces),
  both packages with the same ``telemetry`` section: event kinds and
  names in order (JAX's ``<unlabeled>`` helper compiles, which an eager
  port has no counterpart of, left out), a step's ``step`` span and its
  phase spans, the ``request.*`` records, the ``step.gauges`` keys, the
  registry's metric names and label sets, ``model_time`` events, and
  JSONL rotation with its segments; values that are times by presence
  and type only;
- ``tools/telemetry_report.py`` renders the port's JSONL;
- zero overhead: with telemetry off, and with it absent, a training step
  and a serving step dispatch the aten ops of the parent commit's
  engines (pinned digests); with it on, no ``synchronize``, ``.item()``
  or ``.cpu()`` is added;
- the signature watch: a new batch shape after warm-up is a ``compile``
  event with ``retrace: true``, and the storm warning fires;
- ``step_cost`` FLOPs of a GPT-2 step: exactly the matmul count the
  model implies (the attention kernels' formulas included), within 1 %
  of ``bench.py``'s 6N + 6·L·T·C;
- exposed comm: JAX's interval tests on the port's copy, the static
  estimate equal to JAX's, the profiled source from a Chrome trace;
- the comms logger: a ZeRO-2 step on 2 gloo ranks logs the op counts of
  ``comm.counts`` and of the stage's plan;
- the csv monitor writes JAX's rows; a missing ``tensorboardX`` warns
  and disables its writer.
"""

import hashlib
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.parallel.topology import MeshTopology, reset_topology
from deepspeed_tpu.runtime import config as jax_config_mod
from deepspeed_tpu.telemetry import exposed_comm as jax_xc
from deepspeed_tpu.telemetry import prom as jax_prom
from deepspeed_tpu.telemetry import sink as jax_sink
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.monitor import monitor as port_monitor
from deepspeed_tpu_torch.parallel import topology as port_topo
from deepspeed_tpu_torch.runtime import config as port_config_mod
from deepspeed_tpu_torch.telemetry import exposed_comm as xc
from deepspeed_tpu_torch.telemetry import prom as port_prom
from deepspeed_tpu_torch.telemetry import sink as port_sink
from deepspeed_tpu_torch.telemetry.events import load_all_events
from deepspeed_tpu_torch.utils.params import training_model_from_jax
from tests.test_torch_gpt2 import jax_engine, port_model
from tests.test_torch_tensor_parallel import (flax_params, ranks,  # noqa
                                              weights, wide3, wide3_flax)
from tests.test_torch_training import (batches, bench_config, jax_config,
                                       port_config)

SERVE = {"block_size": 8, "decode_slots": 2, "prompt_buckets": [16],
         "default_max_new_tokens": 5}
PROMPTS = [[5, 17, 42, 7], [1, 2, 3], [9, 8, 7, 6, 5, 4], [11, 12]]
TIME_FIELDS = {"ts", "queue_ms", "ttft_ms", "tokens_per_sec", "ms",
               "compile_secs", "trace_secs", "start_ns", "end_ns",
               "host_rss_bytes"}


def _tel(d, **kw):
    return {"enabled": True, "dir": str(d), "tracing": {"enabled": True},
            "metrics_file": os.path.join(str(d), "metrics.prom"), **kw}


def _events(d):
    return load_all_events(os.path.join(str(d), "telemetry.jsonl"))


def _stream(events):
    """(kind, name) in order, JAX's unlabeled helper compiles left out."""
    return [(e["kind"], e["name"]) for e in events
            if not (e["kind"] == "compile" and e["name"] == "<unlabeled>")]


class _Warnings(logging.Handler):
    """The port's logger's warnings (it does not propagate to root)."""

    def __enter__(self):
        self.lines = []
        self.setLevel(logging.WARNING)
        logging.getLogger("deepspeed_tpu_torch").addHandler(self)
        return self

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __exit__(self, *exc):
        logging.getLogger("deepspeed_tpu_torch").removeHandler(self)

    @property
    def text(self):
        return "\n".join(self.lines)


def _families(text, parse):
    """Registry metric names -> their label-name sets."""
    return {name: sorted({tuple(sorted(row["labels"])) for row in
                          fam["series"]})
            for name, fam in parse(text).items()}


# ---------------------------------------------------------------------------
# the streams of both packages
# ---------------------------------------------------------------------------
def _train(pkg, d, params):
    cfg = {**bench_config(), "telemetry": _tel(d)}
    if pkg == "jax":
        reset_topology()
        topo = MeshTopology(axis_sizes={"data": 1},
                            devices=jax.devices()[:1])
        engine, *_ = deepspeed_tpu.initialize(
            model=jax_gpt2.GPT2ForTraining(jax_config()),
            model_parameters=params, mesh=topo, config=cfg)
    else:
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=training_model_from_jax(params, port_config()),
            config=cfg, device="cpu")
    for ids in batches(3):
        loss = engine({"input_ids": ids})
        engine.backward(loss)
        engine.step()
    engine.destroy()
    with open(os.path.join(str(d), "metrics.prom")) as f:
        return _events(d), f.read()


def _serve(pkg, d, params):
    """4 requests behind a one-replica router on a fake clock."""
    if pkg == "jax":
        from deepspeed_tpu.serving.engine import ServingEngine
        from deepspeed_tpu.serving.replay import ReplayClock
        from deepspeed_tpu.serving.router import ReplicaRouter
        ie, _ = jax_engine(seed=1, serving=SERVE, telemetry=_tel(d))
        ie.params = jax.tree_util.tree_map(jnp.asarray, params)
    else:
        from deepspeed_tpu_torch.serving.engine import ServingEngine
        from deepspeed_tpu_torch.serving.replay import ReplayClock
        from deepspeed_tpu_torch.serving.router import ReplicaRouter
        port_topo.reset_topology()
        ie = deepspeed_tpu_torch.init_inference(
            port_model(params), dtype="fp32", device="cpu", serving=SERVE,
            telemetry=_tel(d))
    clk = ReplayClock()
    srv = ServingEngine(ie, clock=clk)
    rt = ReplicaRouter([srv], clock=clk)
    hs = [rt.submit(p, max_new_tokens=5, request_id=f"q{i}")
          for i, p in enumerate(PROMPTS)]
    while rt.pending:
        clk.advance(0.05)
        rt.step()
    ids = np.asarray([PROMPTS[0]])
    ie.forward(ids if pkg == "jax" else torch.from_numpy(ids))
    ie.generate(ids if pkg == "jax" else torch.from_numpy(ids),
                max_new_tokens=3)
    ie.telemetry.flush()
    stats = srv.stats()
    tokens = [h.tokens for h in hs]
    ie.destroy()
    with open(os.path.join(str(d), "metrics.prom")) as f:
        return _events(d), f.read(), stats, tokens


@pytest.fixture(scope="module")
def train_params():
    model = jax_gpt2.GPT2ForTraining(jax_config())
    return jax.device_get(model.init(jax.random.PRNGKey(0),
                                     jnp.asarray(batches(1)[0]))["params"])


@pytest.fixture(scope="module")
def trained(tmp_path_factory, train_params):
    return {pkg: _train(pkg, tmp_path_factory.mktemp(f"train-{pkg}"),
                        train_params) for pkg in ("jax", "port")}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    _, params = jax_engine(seed=1)
    return {pkg: _serve(pkg, tmp_path_factory.mktemp(f"serve-{pkg}"),
                        params) for pkg in ("jax", "port")}


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
def test_config_defaults_match_jax():
    for cls in ("TelemetryConfig", "CommsLoggerConfig", "MonitorConfig",
                "TelemetryTraceConfig", "TelemetryTracingConfig"):
        jax_cfg = getattr(jax_config_mod, cls)().model_dump()
        port_cfg = getattr(port_config_mod, cls)().model_dump()
        assert port_cfg == jax_cfg, cls


@pytest.mark.parametrize("block", [
    {"sample_every": 0}, {"warmup_steps": -1}, {"recompile_warn_after": 0},
    {"rotate_bytes": -1}, {"rotate_keep": 0}, {"metrics_port": 70000},
    {"trace": {"num_steps": -1}}, {"tracing": {"ici_gbps": -1.0}},
    {"tracing": {"axis_gbps": {"data": 0.0}}},
    {"flight_recorder": {"events": 0}}])
def test_config_errors_match_jax(block):
    with pytest.raises(ValueError) as jax_err:
        jax_config_mod.TelemetryConfig(**block)
    with pytest.raises(ValueError) as port_err:
        port_config_mod.TelemetryConfig(**block)
    first = str(jax_err.value).splitlines()
    assert [line for line in str(port_err.value).splitlines()
            if "errors.pydantic" not in line] == \
        [line for line in first if "errors.pydantic" not in line]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def test_training_stream_matches_jax(trained):
    assert _stream(trained["port"][0]) == _stream(trained["jax"][0])


def _by_kind(events, kind):
    return [e for e in events if e["kind"] == kind]


def test_step_spans_and_fields_match_jax(trained):
    for pkg in ("jax", "port"):
        events = trained[pkg][0]
        spans = _by_kind(events, "span")
        roots = [s for s in spans if s["name"] == "step"]
        assert [r["data"]["step"] for r in roots] == [1, 2, 3]
        for root in roots:
            kids = [s["name"] for s in spans
                    if s["data"].get("parent") == root["data"]["span"]]
            assert kids == ["fwd_bwd", "optimizer"], pkg
    for kind in ("step", "step_cost", "memory", "compile"):
        jax_keys = [sorted(e["data"]) for e in _by_kind(trained["jax"][0],
                                                        kind)
                    if e["name"] != "<unlabeled>"]
        port_keys = [sorted(e["data"]) for e in _by_kind(trained["port"][0],
                                                         kind)]
        if kind == "step":
            assert port_keys == jax_keys
        else:  # the port's collectors carry their own fields
            assert len(port_keys) == len(jax_keys)
    for e in _by_kind(trained["port"][0], "step"):
        assert e["data"]["exposed_comm_source"] == "static_estimate"


# JAX's CPU backend counts its live arrays as device bytes; the port on
# the host has no device allocator to read (phase 15 holds the gauge on
# the card)
HOST_ONLY = {"ds_device_bytes_in_use"}


def test_training_registry_matches_jax(trained):
    jax_fams = _families(trained["jax"][1], jax_prom.parse_exposition)
    port_fams = _families(trained["port"][1], port_prom.parse_exposition)
    assert port_fams == {k: v for k, v in jax_fams.items()
                         if k not in HOST_ONLY}


# ---------------------------------------------------------------------------
# serving and inference
# ---------------------------------------------------------------------------
def test_serving_stream_matches_jax(served):
    assert served["port"][3] == served["jax"][3]  # the same tokens
    assert _stream(served["port"][0]) == _stream(served["jax"][0])


def _timeless(data):
    return {k: (type(v).__name__ if k in TIME_FIELDS else v)
            for k, v in data.items()}


@pytest.mark.parametrize("name", ["request.queued", "request.finish",
                                  "step.gauges"])
def test_serving_records_match_jax(served, name):
    jax_ev, port_ev = ([_timeless(e["data"]) for e in served[pkg][0]
                        if e["name"] == name] for pkg in ("jax", "port"))
    assert port_ev == jax_ev


def test_request_spans_match_jax(served):
    def tree(events):
        spans = _by_kind(events, "span")
        names = {s["data"]["span"]: s["name"] for s in spans}
        return sorted((s["name"], names.get(s["data"].get("parent")))
                      for s in spans)
    assert tree(served["port"][0]) == tree(served["jax"][0])
    assert {"serve", "queue", "prefill", "decode", "request", "attempt",
            "deliver"} <= {n for n, _ in tree(served["port"][0])}


def test_model_time_events_match_jax(served):
    jax_ev, port_ev = ([(e["name"], sorted(e["data"]))
                        for e in served[pkg][0] if e["kind"] == "model_time"]
                       for pkg in ("jax", "port"))
    assert port_ev == jax_ev == [("forward", ["ms"]), ("generate", ["ms"])]


def test_serving_registry_matches_jax(served):
    jax_fams = _families(served["jax"][1], jax_prom.parse_exposition)
    port_fams = _families(served["port"][1], port_prom.parse_exposition)
    assert port_fams == {k: v for k, v in jax_fams.items()
                         if k not in HOST_ONLY}


def test_finish_records_match_stats(served):
    """TTFT and queue wait in ``request.finish`` are the records that
    ``stats()`` aggregates."""
    events, _, stats, _ = served["port"]
    ttfts = [e["data"]["ttft_ms"] for e in events
             if e["kind"] == "serving" and e["name"] == "request.finish"]
    assert stats["finished"] == len(ttfts) == len(PROMPTS)
    assert stats["ttft_ms_p50"] == float(np.percentile(ttfts, 50))


def test_jsonl_rotation_matches_jax(tmp_path):
    event = {"ts": 1.0, "kind": "step", "name": "engine", "step": 1,
             "rank": 0, "data": {"samples": 8}}
    out = {}
    for name, mod in (("jax", jax_sink), ("port", port_sink)):
        path = str(tmp_path / name / "telemetry.jsonl")
        for run in range(2):  # a second run truncates and purges
            mod._OPEN_STATES.pop(path, None)
            sink = mod.JsonlSink(path, rotate_bytes=300, rotate_keep=2)
            for i in range(20 + run):
                sink.write({**event, "step": i})
            sink.close()
        segs = sorted(os.listdir(tmp_path / name))
        out[name] = (segs, [e["step"] for e in load_all_events(path)])
    assert out["port"] == out["jax"]
    assert len(out["port"][0]) == 3


def test_report_tool_renders_the_port_jsonl(trained, served, tmp_path):
    from tools.telemetry_report import render

    path = tmp_path / "telemetry.jsonl"
    with open(path, "w") as f:
        for e in trained["port"][0] + served["port"][0]:
            f.write(json.dumps(e) + "\n")
    text = render(str(path))
    assert "engine.fused_step" in text and "serving" in text


# ---------------------------------------------------------------------------
# zero overhead
# ---------------------------------------------------------------------------
class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _digest(ops):
    return len(ops), hashlib.sha256("\n".join(ops).encode()).hexdigest()[:16]


def _train_ops(extra):
    torch.manual_seed(0)
    model = port_gpt2.GPT2ForTraining(port_gpt2.GPT2Config.tiny(
        dtype=torch.float32))
    conf = {"train_batch_size": 2, "fused_step": True,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}, **extra}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model,
                                                     config=conf,
                                                     device="cpu")
    batch = {"input_ids": torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 16)))}
    engine.train_batch(batch=batch)
    with OpLog() as log:
        engine.train_batch(batch=batch)
    engine.destroy()
    return _digest(log.ops)


def _serve_ops(extra):
    torch.manual_seed(0)
    model = port_gpt2.GPT2LMHeadModel(port_gpt2.GPT2Config.tiny(
        dtype=torch.float32))
    port_topo.reset_topology()
    srv = deepspeed_tpu_torch.init_serving(
        model, dtype="fp32", device="cpu",
        serving={"block_size": 8, "decode_slots": 2, "prompt_buckets": [16]},
        **extra)
    srv.submit([5, 17, 42, 7], max_new_tokens=4)
    srv.submit([1, 2, 3], max_new_tokens=4)
    with OpLog() as log:
        for _ in range(3):
            srv.step()
    return _digest(log.ops)


# the parent commit's engines (e9db9e0) under the same two functions
PARENT_TRAIN_OPS = (446, "100f452ba1d6f04b")
PARENT_SERVE_OPS = (976, "65cc682b23ec03a1")


@pytest.mark.parametrize("extra", [{}, {"telemetry": {"enabled": False}}],
                         ids=["absent", "off"])
def test_telemetry_off_dispatches_the_parents_ops(extra):
    assert _train_ops(extra) == PARENT_TRAIN_OPS
    assert _serve_ops(extra) == PARENT_SERVE_OPS


def test_engines_free_without_the_cycle_collector():
    """With telemetry off, dropping an engine frees it at once: the
    watched callables it keeps are unbound functions, so no reference
    cycle holds its weights and optimizer state until a collection."""
    import gc
    import weakref

    torch.manual_seed(0)
    cfg = port_gpt2.GPT2Config.tiny(dtype=torch.float32)
    batch = {"input_ids": torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 16)))}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=port_gpt2.GPT2ForTraining(cfg), device="cpu",
        config={**bench_config(), "zero_optimization": {"stage": 0}})
    engine.backward(engine(batch))
    engine.step()
    ie = deepspeed_tpu_torch.init_inference(
        port_gpt2.GPT2LMHeadModel(cfg), dtype="fp32", device="cpu",
        serving={"block_size": 8, "decode_slots": 2,
                 "prompt_buckets": [16]})
    ie.forward(torch.tensor([[1, 2, 3]]))
    srv = deepspeed_tpu_torch.init_serving(ie)
    srv.submit([1, 2, 3], max_new_tokens=2)
    srv.drain()
    refs = [weakref.ref(x) for x in (engine, ie, srv)]
    gc.collect()
    gc.disable()
    try:
        del engine, ie, srv
        assert [r() is None for r in refs] == [True, True, True]
    finally:
        gc.enable()


def test_telemetry_on_adds_no_host_sync(tmp_path, monkeypatch):
    """``synchronize``, ``.item()`` and ``.cpu()`` calls of a training
    step and a serving step, telemetry on (first and later signatures)
    against off."""
    calls = []
    for name in ("item", "cpu"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append("synchronize"))

    def count(fn, extra):
        calls.clear()
        fn(extra)
        return list(calls)

    on = {"telemetry": _tel(tmp_path)}
    assert count(_train_ops, on) == count(_train_ops, {})
    assert count(_serve_ops, on) == count(_serve_ops, {})


# ---------------------------------------------------------------------------
# the signature watch
# ---------------------------------------------------------------------------
def test_new_shape_after_warmup_is_a_retrace(tmp_path, train_params):
    cfg = {**bench_config(), "telemetry": _tel(
        tmp_path, warmup_steps=1, recompile_warn_after=1)}
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=training_model_from_jax(train_params, port_config()),
        config=cfg, device="cpu")
    ids = batches(2)
    with _Warnings() as warned:
        for step in range(3):
            batch = ids[0] if step < 2 else ids[1][:, :8]
            engine.backward(engine({"input_ids": batch}))
            engine.step()
    engine.destroy()
    compiles = [e["data"] for e in _events(tmp_path)
                if e["kind"] == "compile"
                and e["name"] == "engine.fused_step"]
    assert [c["retrace"] for c in compiles] == [False, True]
    assert compiles[1]["after_warmup"] is True
    assert "RECOMPILE STORM" in warned.text


# ---------------------------------------------------------------------------
# step cost
# ---------------------------------------------------------------------------
def test_step_cost_flops_are_6n_plus_attention(tmp_path):
    """The GPT-2 bench step's FLOPs at a width where the parameters
    without a matmul (positions, biases, norms) are under 1 % of N."""
    cfg = port_gpt2.GPT2Config.tiny(dtype=torch.float32, vocab_size=4096,
                                    n_embd=128, n_head=2, n_positions=32,
                                    remat=True, remat_policy="dots")
    torch.manual_seed(0)
    model = port_gpt2.GPT2ForTraining(cfg)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, device="cpu",
        config={**bench_config(), "telemetry": _tel(tmp_path)})
    B, T = 2, cfg.n_positions
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T))
    engine.backward(engine({"input_ids": ids}))
    engine.step()
    engine.destroy()
    flops = next(e["data"]["flops"] for e in _events(tmp_path)
                 if e["kind"] == "step_cost")
    n = sum(p.numel() for p in model.parameters())
    no_matmul = sum(p.numel() for name, p in model.named_parameters()
                    if p.dim() == 1 or "wpe" in name)
    attention = 6 * cfg.n_layer * T * cfg.n_embd
    assert flops == B * T * (6 * (n - no_matmul) + attention)
    bench = B * T * (6 * n + attention)
    assert abs(flops / bench - 1) < 0.01


# ---------------------------------------------------------------------------
# exposed comm
# ---------------------------------------------------------------------------
def test_interval_math_matches_jax():
    assert xc.merge_intervals([(5, 10), (0, 6), (20, 30)]) == \
        [(0, 10), (20, 30)]
    assert xc.total_ns([(0, 10), (5, 15)]) == 15
    assert xc.overlap_ns([(0, 10)], [(5, 20)]) == 5
    assert xc.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    out = xc.exposed_fraction([(0, 10), (20, 30)], [(5, 25)])
    assert out == jax_xc.exposed_fraction([(0, 10), (20, 30)], [(5, 25)])
    assert out["exposed_comm_fraction"] == round(10 / 30, 4)


COSTS = [{"collective_operand_bytes": 9e9, "flops": 275e12},
         {"collective_operand_bytes": 10_000_000, "flops": 1e12,
          "collective_bytes_per_axis": {"data": 8_000_000,
                                        "fsdp": 1_000_000,
                                        "data+fsdp": 1_000_000}},
         {}]


@pytest.mark.parametrize("cost", COSTS)
@pytest.mark.parametrize("axis_gbps", [None, {"data": 10.0, "fsdp": 100.0}])
def test_static_estimate_matches_jax(cost, axis_gbps):
    assert xc.static_estimate(cost, 90.0, 275.0, axis_gbps=axis_gbps) == \
        jax_xc.static_estimate(cost, 90.0, 275.0, axis_gbps=axis_gbps)


def test_profiled_source_reads_a_chrome_trace(tmp_path):
    measured, reason = xc.from_profiler_dir(str(tmp_path))
    assert measured is None and "no Chrome trace" in reason
    kernel = {"cat": "kernel", "ph": "X"}
    trace = {"traceEvents": [
        {**kernel, "name": "ampere_gemm", "ts": 5.0, "dur": 20.0},
        {**kernel, "name": "ncclDevKernel_AllReduce", "ts": 0.0,
         "dur": 10.0},
        {**kernel, "name": "ncclDevKernel_AllReduce", "ts": 20.0,
         "dur": 10.0},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 99.0}]}
    with open(tmp_path / "a.json", "w") as f:
        json.dump(trace, f)
    measured, reason = xc.from_profiler_dir(str(tmp_path))
    assert reason is None and measured["source"] == "profiled"
    assert measured["exposed_comm_ns"] == 10_000
    assert measured["exposed_comm_fraction"] == round(10 / 30, 4)
    trace["traceEvents"] = trace["traceEvents"][:1]
    with open(tmp_path / "a.json", "w") as f:
        json.dump(trace, f)
    measured, reason = xc.from_profiler_dir(str(tmp_path))
    assert measured is None and "no collective kernel" in reason


# ---------------------------------------------------------------------------
# comms logger, monitors
# ---------------------------------------------------------------------------
def test_zero2_step_logs_the_plans_collectives(ranks):
    """``tests/torch_ranks.py:comms_log`` in the 2-rank tensor-parallel
    spawn."""
    for res in ranks(2):
        logged, counts, plan = res["comms_log"]
        by_op = {}
        for name, n in logged.items():  # the record names are the ops'
            op = name.replace("_base", "")
            by_op[op] = by_op.get(op, 0) + n
        assert by_op == {k: v for k, v in counts.items() if v} == plan


def test_csv_monitor_writes_jax_rows(tmp_path):
    from deepspeed_tpu.monitor import monitor as jax_monitor

    events = [("Train/Samples/train_loss", 2.5, 8),
              ("Train/Samples/lr", 0.001, 8),
              ("Train/Samples/train_loss", 2.25, 16)]
    rows = {}
    for name, mod, cfg_mod in (("jax", jax_monitor, jax_config_mod),
                               ("port", port_monitor, port_config_mod)):
        cfg = cfg_mod.MonitorConfig(csv_monitor={
            "enabled": True, "output_path": str(tmp_path / name)})
        master = mod.MonitorMaster(cfg)
        master.write_events(events)
        out = tmp_path / name / "DeepSpeedJobName"
        rows[name] = {f: (out / f).read_text() for f in os.listdir(out)}
    assert rows["port"] == rows["jax"] and len(rows["port"]) == 2


def test_missing_tensorboardx_warns_and_disables(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_tbx(name, *a, **k):
        if name == "tensorboardX":
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tbx)
    cfg = port_config_mod.MonitorConfig(tensorboard={"enabled": True},
                                        csv_monitor={"enabled": False})
    with _Warnings() as warned:
        master = port_monitor.MonitorMaster(cfg)
    assert not master.tb_monitor.enabled and not master.enabled
    assert "tensorboardX not available" in warned.text
