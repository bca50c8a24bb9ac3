"""Tensor-parallel replicas behind the router: rank groups driven by a
controller (``deepspeed_tpu_torch/serving/group_replica.py``).

4 gloo ranks make two tp=2 replicas behind ``init_serving(replicas=
[engine])`` with rank 0 the controller (``tests/torch_ranks.py:
group_replicas``, the last program of the 4-rank tensor-parallel spawn
of ``tests/test_torch_tensor_parallel.py``). The same scenarios run here
in one process on two tp=1 replicas of the same weights, whose router
and fleet decisions ``tests/test_torch_fleet.py`` holds to JAX's:

- the fleet slice: least-loaded routing, replica 1 crashing at its 4th
  step (failover replay), replica 0's work migrating at the replayer's
  8th step, and a factory scale-up (onto the crashed replica's ranks,
  idle again): the same decisions (fleet and router stats, router and
  fleet events), token streams, and ``replay_divergence`` 0;
- a drain with live migration on bf16 and on int8 pools: the same
  decisions and tokens; the group's wire bytes are the one-process
  replica's (every rank's chunk counted), and rank r's chunk holds the
  heads ``[r * H / 2, (r + 1) * H / 2)`` of the one-process rows;
- a killed group is marked DEAD within the router's timeout (2 s), its
  work finishes on the other group, and no rank hangs (the spawn's hard
  timeout is the guard);
- a factory with no idle group left fails as a factory without capacity
  does in JAX's fleet manager: the same ``factory.failed`` event and
  counters.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.serving import router as jax_router
from deepspeed_tpu_torch.models.gpt2 import GPT2Config
from deepspeed_tpu_torch.parallel import topology as port_topo
from deepspeed_tpu_torch.serving import router as port_router
from deepspeed_tpu_torch.serving.engine import ServingEngine
from deepspeed_tpu_torch.serving.group_replica import GroupReplicaFactory
from deepspeed_tpu_torch.serving.replay import ReplayClock
from tests import torch_ranks
from tests.test_torch_tensor_parallel import (flax_params, ranks,  # noqa
                                              weights, wide3, wide3_flax)
from tests.torch_fleet_fakes import Recorder, fakes
from tests.torch_ranks import (FLEET_SLICE, MIGRATE_SERVING, _tiny_model,
                               fleet_slice, migrate_pools)

# the int8 pools' engine is fp32 (its codes match the one-process ones
# exactly); bf16 rows differ by a few bf16 ulps, tp=2 against tp=1
KV_TOL = {"bf16": 0.0625, "int8": 1e-5}


def _canon(result, key):
    """Events sorted within each router step: the router harvests a
    step's finished requests from a set, whose order follows the
    process's string hashing, so two processes may list one step's
    finishes in different orders."""
    if key != "events":
        return result[key]
    return sorted(result[key], key=lambda e: (
        -1 if e[2] is None else e[2], e[0], e[1], repr(sorted(e[3].items()))))


def _one_process(weights):
    """The scenarios on two tp=1 replicas of the same weights."""
    port_topo.reset_topology()
    out = {}
    clk = ReplayClock()
    ie = deepspeed_tpu_torch.init_inference(
        _tiny_model(weights), dtype="fp32", device="cpu",
        serving=FLEET_SLICE)
    front = deepspeed_tpu_torch.init_serving(
        None, replicas=[ServingEngine(ie, clock=clk) for _ in range(2)],
        clock=clk, factory=lambda: ServingEngine(ie, clock=clk))
    out["slice"] = fleet_slice(front, clk)
    for name, dtype, kv in (("bf16", torch.bfloat16, ""),
                            ("int8", torch.float32, "int8")):
        clk = ReplayClock()
        ie = deepspeed_tpu_torch.init_inference(
            _tiny_model(weights, dtype=dtype),
            dtype="bf16" if kv == "" else "fp32", device="cpu",
            serving={**MIGRATE_SERVING, "kv_cache_dtype": kv})
        front = deepspeed_tpu_torch.init_serving(
            None, replicas=[ServingEngine(ie, clock=clk) for _ in range(2)],
            clock=clk)
        out[f"migrate-{name}"] = migrate_pools(front, group=False)
    return out


@pytest.fixture(scope="module")
def one_process(tmp_path_factory, weights):
    return torch_ranks.cached(tmp_path_factory, "group-replicas-tp1",
                              lambda d: _one_process(weights))


@pytest.fixture(scope="module")
def groups(ranks):
    res = ranks(4)
    assert all("group_replicas" in r for r in res)
    return res[0]["group_replicas"]


@pytest.mark.parametrize("key", ["tokens", "moved", "report", "counters",
                                 "router", "events"])
def test_fleet_slice_decides_like_one_process(groups, one_process, key):
    assert _canon(groups["slice"], key) == _canon(one_process["slice"], key)


def test_fleet_slice_replays_exactly_and_scales_onto_the_idle_group(groups):
    st = groups["slice"]
    assert st["router"]["replay_divergence"] == 0
    assert st["router"]["failovers"] > 0 and st["router"]["migrations"] > 0
    assert st["counters"]["factory_builds"] == 1
    assert st["router"]["replica_states"] == ["healthy", "healthy"]


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("key", ["tokens", "stats", "moved", "wire",
                                 "events"])
def test_migration_decides_like_one_process(groups, one_process, pool, key):
    assert _canon(groups[f"migrate-{pool}"], key) == \
        _canon(one_process[f"migrate-{pool}"], key)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_each_rank_moves_its_heads(groups, one_process, pool):
    """Rank r's chunk is heads [r H / 2, (r + 1) H / 2) of every pool of
    the one-process rows (pools ``[blocks, rows, H, D]``, scale pools
    ``[blocks, rows, H]``); the chunks' bytes add up to the wire bytes."""
    chunks = groups[f"migrate-{pool}"]["chunks"]
    (rows, dtypes), = one_process[f"migrate-{pool}"]["chunks"]
    assert len(chunks) == 2
    wire = sum(sum(r.nbytes for r in c[0]) for c in chunks)
    assert wire == groups[f"migrate-{pool}"]["wire"][1]
    for r, (shard, shard_dtypes) in enumerate(chunks):
        assert shard_dtypes == dtypes
        for part, whole, dtype in zip(shard, rows, dtypes):
            h = whole.shape[2] // 2
            want, got = whole[:, :, r * h:(r + 1) * h], part
            if dtype == "bfloat16":  # the int16 bits of bf16 rows
                want, got = (torch.from_numpy(np.ascontiguousarray(x))
                             .view(torch.bfloat16).float().numpy()
                             for x in (want, got))
            np.testing.assert_allclose(got.astype(np.float32),
                                       want.astype(np.float32),
                                       atol=KV_TOL[pool], rtol=0)
            other = whole[:, :, (1 - r) * h:(2 - r) * h]
            if dtype == "bfloat16":
                other = torch.from_numpy(np.ascontiguousarray(other)).view(
                    torch.bfloat16).float().numpy()
            # and not the other rank's heads
            assert (np.abs(got.astype(np.float32) - want).max()
                    < np.abs(got.astype(np.float32) - other).max())


def test_wire_bytes_int8_to_bf16(groups):
    """int8 codes plus an fp32 scale a row against bf16: (D + 4) / (2 D),
    at the tiny model's D = 16."""
    d = GPT2Config.tiny().n_embd // GPT2Config.tiny().n_head
    ratio = groups["migrate-int8"]["wire"][1] / groups["migrate-bf16"][
        "wire"][1]
    assert ratio == (d + 4) / (2 * d)


def test_a_killed_group_is_dead_within_the_timeout(groups):
    killed = groups["killed"]
    assert killed["states"] == ["healthy", "dead"]
    assert killed["secs"] < 2.0 + 1.0
    assert killed["failovers"] > 0
    assert all(state == "finished" and len(toks) == 6
               for _, state, toks in killed["tokens"])


class _NoIdleWorld:
    groups = [[0, 1], [2, 3]]
    states = ["active", "active"]
    tp = 2


def _fleet_without_capacity(router, rq, factory):
    tel = Recorder()
    rt = router.ReplicaRouter([fakes(rq).FakeReplica(slots=1)],
                              clock=lambda: 0.0, telemetry=tel)
    fm = router.FleetManager(rt, factory=factory,
                             config={"min_replicas": 1, "max_replicas": 3})
    fm.scale_up("manual")
    st = fm.stats()
    return ([(k, n) for k, n, _, _ in tel.events],
            {k: st[k] for k in ("factory_failures", "factory_builds",
                                "scale_ups")})


def test_no_idle_group_fails_like_a_factory_without_capacity():
    import deepspeed_tpu.serving.request as jax_rq
    import deepspeed_tpu_torch.serving.request as port_rq

    class _JaxFull(jax_router.ReplicaFactory):
        def build(self):
            raise RuntimeError("no capacity")

    want = _fleet_without_capacity(jax_router, jax_rq, _JaxFull())
    got = _fleet_without_capacity(port_router, port_rq,
                                  GroupReplicaFactory(_NoIdleWorld()))
    assert got == want and got[1]["factory_failures"] == 1
    with pytest.raises(RuntimeError, match="no idle rank group"):
        GroupReplicaFactory(_NoIdleWorld()).build()
