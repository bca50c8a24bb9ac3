"""The port's resilience layer against the JAX package's, on the CPU.

- integrity: a manifest the port writes verifies with JAX's
  ``verify_tag_dir`` and JAX's with the port's; on the same corrupted or
  truncated bytes both raise the same error, naming the same file; the
  fallback chain, IO retry, retention and the ``latest`` pointer;
- the step sentinel: the same loss sequences trip both packages' managers
  at the same steps with the same reasons under each policy, and a
  rollback of a real engine restores its parameters bit for bit;
- the hang watchdog and the flight recorder: a stall fires the watchdog
  (abort off) within its timeout, progress keeps it quiet, and JAX's
  ``load_dump`` reads the port's dump;
- the data cursor: JAX's batch order, and a resumed sequence.

Engines here are the port's tiny GPT-2 on the CPU, in fp32 (a batch
carries a float ``loss_weight`` so ``chaos.poison_batch`` can make its
loss NaN); everything compared with JAX is host code.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.runtime import dataloader as jax_dl
from deepspeed_tpu.runtime.config import ResilienceConfig as JaxResilienceCfg
from deepspeed_tpu.runtime.resilience import integrity as jax_integrity
from deepspeed_tpu.runtime.resilience import manager as jax_manager
from deepspeed_tpu.runtime.resilience import sentinel as jax_sentinel
from deepspeed_tpu.runtime.resilience import topology as jax_topology
from deepspeed_tpu.telemetry import flightrec as jax_flightrec
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.runtime import dataloader as port_dl
from deepspeed_tpu_torch.runtime.config import ResilienceConfig
from deepspeed_tpu_torch.runtime.resilience import chaos
from deepspeed_tpu_torch.runtime.resilience import integrity
from deepspeed_tpu_torch.runtime.resilience import manager
from deepspeed_tpu_torch.runtime.resilience import sentinel
from deepspeed_tpu_torch.runtime.resilience import topology
from deepspeed_tpu_torch.runtime.resilience.watchdog import HangWatchdog
from deepspeed_tpu_torch.telemetry import flightrec

B, T = 2, 16


class WeightedGPT2(port_gpt2.GPT2ForTraining):
    """The tiny GPT-2 whose loss is scaled by the batch's float
    ``loss_weight`` (a data leaf ``chaos.poison_batch`` can poison)."""

    def forward(self, batch):
        return super().forward(batch) * batch["loss_weight"].mean()


def batch(seed):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 256, (B, T)).astype(np.int32),
            "loss_weight": np.ones(1, np.float32)}


def engine(resilience=None, **extra):
    cfg = {"train_micro_batch_size_per_gpu": B,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "gradient_clipping": 1.0, "fused_step": True,
           "steps_per_print": 10_000, **extra}
    if resilience is not None:
        cfg["resilience"] = resilience
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=WeightedGPT2(port_gpt2.GPT2Config.tiny(dtype=torch.float32,
                                                     n_layer=1)),
        config=cfg, device="cpu")
    return eng


def step(eng, b):
    loss = eng(b)
    eng.backward(loss)
    eng.step()
    return float(loss)


def resilient(**ckpt):
    return {"enabled": True,
            "checkpoint": {"retry_backoff_secs": 0.0, **ckpt},
            "sentinel": {"enabled": False}, "watchdog": {"enabled": False}}


@pytest.fixture(autouse=True)
def _clear_chaos():
    yield
    chaos.clear()


# ---------------------------------------------------------------------------
# (e) integrity against JAX's code
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def committed(tmp_path_factory):
    """Two committed tags of a port engine with integrity on, and the
    engine's parameters at each."""
    d = tmp_path_factory.mktemp("integrity")
    eng = engine(resilient())
    saved = {}
    for tag in ("t1", "t2"):
        step(eng, batch(len(saved)))
        eng.save_checkpoint(str(d), tag=tag)
        saved[tag] = {k: v.clone() for k, v in
                      eng.module_state_dict().items()}
    return d, saved


def test_manifests_verify_across_packages(committed, tmp_path):
    d, _ = committed
    port_tag = str(d / "t2")
    assert jax_integrity.verify_tag_dir(port_tag) == "ok"
    assert integrity.verify_tag_dir(port_tag) == "ok"
    jax_tag = str(tmp_path / "j")
    shutil.copytree(port_tag, jax_tag)
    os.remove(os.path.join(jax_tag, integrity.MANIFEST_NAME))
    assert integrity.verify_tag_dir(jax_tag) == "unverified"
    jax_integrity.write_manifest(jax_tag)
    assert integrity.verify_tag_dir(jax_tag) == "ok"
    mine = json.load(open(os.path.join(port_tag, integrity.MANIFEST_NAME)))
    theirs = json.load(open(os.path.join(jax_tag, integrity.MANIFEST_NAME)))
    assert mine["files"] == theirs["files"]
    assert jax_integrity.read_verified(str(d)) == ["t1", "t2"]


@pytest.mark.parametrize("fault", ["corrupt", "truncate", "missing"])
def test_damage_raises_the_same_error_in_both(committed, tmp_path, fault):
    d, _ = committed
    tag = str(tmp_path / "t")
    shutil.copytree(str(d / "t1"), tag)
    if fault == "corrupt":
        path = chaos.corrupt_checkpoint(tag, offset=200)
    elif fault == "truncate":
        path = os.path.join(tag, "optimizer.npz")
        chaos.truncate_file(path, keep_bytes=100)
    else:
        path = os.path.join(tag, "engine.json")
        os.remove(path)
    errors = []
    for mod in (integrity, jax_integrity):
        with pytest.raises(mod.CheckpointCorruptionError) as err:
            mod.verify_tag_dir(tag)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    assert repr(os.path.basename(path)) in errors[0]


def test_fallback_to_the_newest_verified_tag(committed, tmp_path):
    d, saved = committed
    root = tmp_path / "root"
    shutil.copytree(str(d), str(root))
    bad = chaos.corrupt_checkpoint(str(root / "t2"))
    eng = engine(resilient())
    tag, _ = eng.load_checkpoint(str(root))
    assert tag == "t1"
    got = eng.module_state_dict()
    assert all(torch.equal(got[k], v) for k, v in saved["t1"].items())
    fault = eng.resilience.fault_tail[-1]
    assert fault["name"] == "ckpt.fallback" and fault["to_tag"] == "t1"
    assert os.path.basename(bad) in fault["error"]
    with pytest.raises(integrity.CheckpointCorruptionError,
                       match=repr(os.path.basename(bad))):
        eng.load_checkpoint(str(root), tag="t2")


def test_save_retries_a_transient_io_error(tmp_path):
    eng = engine(resilient(retries=3))
    step(eng, batch(0))
    with chaos.io_errors("ckpt.save", at_call=1, times=2) as armed:
        eng.save_checkpoint(str(tmp_path), tag="t")
    assert armed.raised == 2
    retries = [f for f in eng.resilience.fault_tail
               if f["name"] == "ckpt.retry"]
    assert [f["attempt"] for f in retries] == [1, 2]
    assert integrity.verify_tag_dir(str(tmp_path / "t")) == "ok"


def test_retention_never_strands_latest(tmp_path):
    eng = engine(resilient(keep_last_n=1))
    for tag, latest in (("t1", True), ("t2", True), ("t3", False)):
        step(eng, batch(0))
        eng.save_checkpoint(str(tmp_path), tag=tag, save_latest=latest)
    # t3 is the newest verified tag, t2 the one `latest` names
    assert integrity.available_tags(str(tmp_path)) == ["t2", "t3"]
    assert open(tmp_path / "latest").read() == "t2"
    assert engine(resilient()).load_checkpoint(str(tmp_path))[0] == "t2"


def test_latest_survives_a_crash_mid_save(tmp_path):
    eng = engine(resilient(retries=1))
    step(eng, batch(0))
    eng.save_checkpoint(str(tmp_path), tag="t1")
    step(eng, batch(1))
    with chaos.io_errors("ckpt.commit", at_call=1, times=5):
        with pytest.raises(chaos.ChaosIOError):
            eng.save_checkpoint(str(tmp_path), tag="t2")
    assert open(tmp_path / "latest").read() == "t1"
    assert not os.path.exists(tmp_path / "latest.tmp")
    assert engine(resilient()).load_checkpoint(str(tmp_path))[0] == "t1"


def test_topology_manifests_validate_across_packages(tmp_path):
    """With ``elasticity.enabled`` the tag carries ``topology.json``,
    which JAX's diff accepts against itself (the tensor names are the
    file's); a shape change is fatal in both packages."""
    eng = engine(elasticity={"enabled": True})
    step(eng, batch(0))
    eng.attach_data_loader(port_dl.DeepSpeedDataLoader(np.arange(10), 2))
    eng.save_checkpoint(str(tmp_path), tag="t")
    saved = jax_topology.read_topology_manifest(str(tmp_path / "t"))
    assert saved["data_pipeline"]["dataset_len"] == 10
    assert saved["rng"] == [int(x) for x in eng._current_rng()]
    names = {k.split("/")[0] + "/" + k.split("/")[1]
             for k in saved["tensors"]}
    assert {"params/wte", "opt_state/.step",
            "opt_state/.exp_avg"} <= names
    current = eng.describe_topology(include_data=False)
    assert not jax_topology.diff_topology(saved, current)["fatal"]
    bad = json.loads(json.dumps(current))
    bad["tensors"]["params/wte"]["shape"] = [1, 1]
    for mod in (topology, jax_topology):
        with pytest.raises(mod.TopologyShiftError, match="params/wte"):
            mod.validate_reshard(saved, bad, "t")


# ---------------------------------------------------------------------------
# (f) the step sentinel
# ---------------------------------------------------------------------------
SEQUENCES = {
    "nan": [2.0, 2.1, float("nan"), 1.9, 2.0],
    "spike": [2.0, 2.1, 1.9, 2.0, 9.5, 2.0],
    "lag": [2.0, float("inf"), 2.0, 2.0],
}


class StubEngine:
    """What the managers' rollback reads of an engine: the restored tag
    and step, and the accumulation factor."""

    def __init__(self, tag="t1", restored=1, gas=2):
        self.global_steps = 0
        self.loads = []
        self._tag, self._restored, self._gas = tag, restored, gas

    def load_checkpoint(self, load_dir):
        self.loads.append(load_dir)
        self.global_steps = self._restored
        return self._tag, {}

    def gradient_accumulation_steps(self):
        return self._gas


def drive(mod, cfg_cls, policy, losses, lag):
    res = mod.Resilience(cfg_cls(
        enabled=True, watchdog={"enabled": False},
        sentinel={"policy": policy, "loss_spike_factor": 3.0,
                  "min_history": 2, "sync_lag": lag},
        checkpoint={"rollback_dir": "/ckpt"}))
    eng, infos, raised = StubEngine(), [], None
    res.on_rollback = infos.append
    try:
        for i, loss in enumerate(losses, start=1):
            res.on_step_boundary(eng, i, loss=loss)
        res.drain_sentinel()
    except Exception as e:  # noqa: BLE001 — compared across packages
        raised = (type(e).__name__, str(e))
    faults = [{k: v for k, v in f.items() if k != "loss"}
              for f in res.fault_tail]
    return res.sentinel.trips, faults, infos, raised, eng.loads


@pytest.mark.parametrize("policy", ["warn", "skip", "abort", "rollback"])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_sentinel_trips_like_jax(policy, name):
    lag = 1 if name == "lag" else 0
    got = drive(manager, ResilienceConfig, policy, SEQUENCES[name], lag)
    want = drive(jax_manager, JaxResilienceCfg, policy, SEQUENCES[name], lag)
    assert repr(got) == repr(want)
    assert got[0]  # every sequence trips
    if policy == "rollback":
        assert got[2][0]["micro_batches_to_replay"] == \
            want[2][0]["micro_batches_to_replay"] > 0


def test_sentinel_lag_judges_each_boundary_once():
    for mod in (sentinel, jax_sentinel):
        trips = []
        cfg = ResilienceConfig().sentinel.model_copy(update={"sync_lag": 2})
        s = mod.StepSentinel(cfg, on_trip=lambda *a: trips.append(a[:2]))
        s.observe(1, 1.0)
        s.observe(2, float("nan"))
        assert trips == []
        s.observe_value(2, float("nan"))
        s.observe(3, 1.0)
        s.observe(4, 1.0)
        s.drain()
        assert [t[0] for t in trips] == [2]


def test_rollback_restores_the_saved_parameters(tmp_path):
    eng = engine({"enabled": True, "watchdog": {"enabled": False},
                  "sentinel": {"policy": "rollback", "sync_lag": 0}})
    infos = []
    eng.resilience.on_rollback = infos.append
    for i in range(2):
        step(eng, batch(i))
    eng.save_checkpoint(str(tmp_path))
    saved = {k: v.clone() for k, v in eng.module_state_dict().items()}
    step(eng, batch(2))
    poisoned = list(chaos.nan_batches([batch(3)], at=0))[0]
    assert np.isnan(poisoned["loss_weight"]).all()
    assert np.isnan(step(eng, poisoned))
    assert eng.global_steps == 2
    got = eng.module_state_dict()
    assert all(torch.equal(got[k], v) for k, v in saved.items())
    # JAX's manager, handed an engine that restores the same tag and step
    jax_res = jax_manager.Resilience(JaxResilienceCfg(
        enabled=True, watchdog={"enabled": False},
        sentinel={"policy": "rollback"}))
    jax_res._engine = StubEngine("global_step2", restored=2, gas=1)
    jax_res.note_save_dir(str(tmp_path))
    want = jax_res._rollback(4, float("nan"), "nonfinite")
    assert infos == [want]
    assert want["micro_batches_to_replay"] == 2
    assert np.isfinite(step(eng, batch(4)))
    names = [f["name"] for f in eng.resilience.fault_tail]
    assert names == ["ckpt.verified", "sentinel.trip", "sentinel.rollback"]


# ---------------------------------------------------------------------------
# (g) the hang watchdog and the flight recorder
# ---------------------------------------------------------------------------
def test_watchdog_fires_on_a_stall_and_not_on_progress(tmp_path):
    tail = [{"name": "step", "step": 7}]
    quiet = HangWatchdog(timeout_secs=0.3, poll_secs=0.05, abort=False,
                         dump_dir=str(tmp_path / "quiet"))
    quiet.start()
    for i in range(8):
        quiet.notify(i)
        time.sleep(0.05)
    quiet.stop()
    assert not quiet.fired
    wd = HangWatchdog(timeout_secs=0.3, poll_secs=0.05, abort=False,
                      dump_dir=str(tmp_path), tail_fn=lambda: tail)
    wd.start()
    wd.notify(7)
    chaos.simulate_stall(0.6)
    wd.stop()
    assert wd.fired and wd.last_step == 7
    (dump,) = [f for f in os.listdir(tmp_path) if f.startswith("watchdog")]
    text = open(tmp_path / dump).read()
    assert "=== python stacks ===" in text and repr(tail[0]) in text


def test_flight_recorder_dump_reads_in_jax(tmp_path):
    eng = engine({"enabled": True, "sentinel": {"policy": "warn",
                                                "sync_lag": 0},
                  "watchdog": {"timeout_secs": 0.3, "abort": False,
                               "dump_dir": str(tmp_path / "wd")}},
                 telemetry={"enabled": True, "dir": str(tmp_path),
                            "flight_recorder": {"enabled": True,
                                                "on_sigterm": False}})
    step(eng, batch(0))
    step(eng, chaos.poison_batch(batch(1)))  # a fault event: a dump
    chaos.simulate_stall(0.6)  # armed at the first boundary: it fires
    assert eng.resilience.watchdog.fired
    assert os.listdir(tmp_path / "wd")
    dumps = flightrec.find_dumps(str(tmp_path))
    assert dumps == jax_flightrec.find_dumps(str(tmp_path))
    # one dump a trigger (a slow step under load may fire the watchdog
    # before the stall: its dump is then the first)
    by_reason = {}
    for path in dumps:
        d = jax_flightrec.load_dump(path)
        assert d == flightrec.load_dump(path)
        by_reason[d["meta"]["reason"]] = d
    assert set(by_reason) == {"fault:sentinel.trip", "fault:watchdog.hang"}
    for reason, d in by_reason.items():
        kinds = [(e["kind"], e["name"]) for e in d["events"]]
        assert ("step", "engine") in kinds
        assert kinds[-1] == tuple(reason.split(":"))
    assert eng.resilience.summary()["watchdog_fired"]
    assert sorted(eng.resilience.summary()) == sorted(
        jax_manager.Resilience().summary())
    eng.destroy()


def test_preempt_at_step_delivers_once():
    seen = []
    tick = chaos.preempt_at_step(2, deliver=lambda: seen.append(1))
    assert [tick() for _ in range(4)] == [False, True, False, False]
    assert seen == [1] and tick.state == {"calls": 4, "fired": True}


# ---------------------------------------------------------------------------
# (h) the data cursor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, False),
                                               (True, True)])
def test_data_loader_order_and_cursor_match_jax(shuffle, drop_last):
    data = {"x": np.arange(22 * 3).reshape(22, 3),
            "y": np.arange(22)}
    kw = dict(batch_size=4, shuffle=shuffle, seed=5,
              dataloader_drop_last=drop_last)

    def stream(mod, n, state=None):
        loader = mod.DeepSpeedDataLoader(data, **kw)
        if state is not None:
            loader.load_state_dict(state)
        it = mod.RepeatingLoader(loader)
        out = [next(it)["y"].tolist() for _ in range(n)]
        return out, loader.state_dict()

    want, want_state = stream(jax_dl, 9)
    got, got_state = stream(port_dl, 9)
    assert got == want and got_state == want_state
    head, state = stream(port_dl, 4)
    tail, _ = stream(port_dl, 5, state)
    assert head + tail == want
    jax_tail, _ = stream(jax_dl, 5, state)
    assert jax_tail == tail


def test_initialize_builds_the_loader():
    data = {"input_ids": np.random.default_rng(0).integers(
        0, 256, (8, T)).astype(np.int32),
        "loss_weight": np.ones((8, 1), np.float32)}
    eng, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=WeightedGPT2(port_gpt2.GPT2Config.tiny(dtype=torch.float32,
                                                     n_layer=1)),
        config={"train_micro_batch_size_per_gpu": B,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
                "dataloader_drop_last": True},
        training_data=data, device="cpu")
    assert isinstance(loader, port_dl.DeepSpeedDataLoader) and len(loader) == 4
    assert eng.train_batch(iter(loader)) > 0
    assert eng.describe_topology()["data_pipeline"]["offset"] == B


def test_nebula_mirror_serves_a_lost_fast_tier(tmp_path):
    """The ``nebula`` section's tiered engine publishes the staged tag
    atomically, mirrors it to the durable path and loads from the mirror
    when the fast tier lost a file."""
    mirror = tmp_path / "mirror"
    eng = engine(nebula={"enabled": True,
                         "persistent_storage_path": str(mirror),
                         "persistent_time_interval": 0})
    step(eng, batch(0))
    eng.save_checkpoint(str(tmp_path / "fast"), tag="t")
    assert sorted(os.listdir(mirror / "t")) == sorted(
        os.listdir(tmp_path / "fast" / "t"))
    assert not os.listdir(tmp_path / "fast" / ".staging")
    saved = {k: v.clone() for k, v in eng.module_state_dict().items()}
    os.remove(tmp_path / "fast" / "t" / "module.npz")
    other = engine(nebula={"enabled": True,
                           "persistent_storage_path": str(mirror)})
    assert other.load_checkpoint(str(tmp_path / "fast"))[0] == "t"
    got = other.module_state_dict()
    assert all(torch.equal(got[k], v) for k, v in saved.items())
