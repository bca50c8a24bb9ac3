"""The port's serving layer against the JAX package's.

- Greedy tokens of the port's ServingEngine under staggered continuous
  batching equal the JAX ``InferenceEngine.generate`` tokens of each
  request (tiny model, float32, same weights).
- The port's host layer (block manager + scheduler) makes the same
  decisions as the JAX one on the same request stream.
- The serving fleet's blocks resolve as in JAX, and ``init_serving``
  builds the router from them (the fleet itself:
  ``tests/test_torch_fleet.py``; the fast-path knobs:
  ``tests/test_torch_serving_fast.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.serving.blocks import BlockManager as JaxBlockManager
from deepspeed_tpu.serving.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving.request import Request as JaxRequest
from deepspeed_tpu.serving.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler)
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.serving.blocks import BlockManager
from deepspeed_tpu_torch.serving.config import ServingConfig
from deepspeed_tpu_torch.serving.request import FINISHED, SHED, Request
from deepspeed_tpu_torch.serving.router import ReplicaRouter
from deepspeed_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
from tests.test_torch_gpt2 import jax_engine, port_model

_SERVING = {"block_size": 8, "decode_slots": 3}


def test_staggered_serving_matches_jax_generate():
    engine, params = jax_engine(seed=1)
    srv = deepspeed_tpu_torch.init_serving(
        port_model(params), dtype="fp32", device="cpu", serving=_SERVING)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, n) for n in (5, 11, 3, 8, 16)]
    news = [6, 4, 5, 3, 4]
    reqs = [srv.submit(prompts[0], max_new_tokens=news[0]),
            srv.submit(prompts[1], max_new_tokens=news[1])]
    srv.step()
    srv.step()
    reqs += [srv.submit(prompts[2], max_new_tokens=news[2]),
             srv.submit(prompts[3], max_new_tokens=news[3])]
    srv.step()
    reqs.append(srv.submit(prompts[4], max_new_tokens=news[4]))
    srv.drain()
    for req, p, n in zip(reqs, prompts, news):
        assert req.state == FINISHED, (req.state, req.finish_reason)
        ref = engine.generate(jnp.asarray(p[None]), max_new_tokens=n)
        assert req.tokens == [int(t) for t in ref[0, len(p):]], \
            req.request_id
    assert srv.block_mgr.num_free == srv.num_blocks - 1
    assert not srv.pending
    stats = srv.stats()
    assert stats["finished"] == 5 and stats["shed"] == 0
    assert stats["ttft_ms_p50"] is not None


def _drive(sched_cls, mgr_cls, cfg_cls, req_cls, seed, prefix_cls=None):
    """A random stream of submits, admissions and finishes; returns every
    decision the host layer made. With ``prefix_cls`` (a PrefixCache
    class) admission matches cached prefixes (the prompts
    ``range(n)`` share theirs), every admitted prompt is indexed and its
    copy-on-write confirmed as the engine does, and random speculative
    windows open, commit and drop on running requests; the log then also
    holds the match results, the grants and drops, and the pool's
    refcounts, free and cached counts after every step."""
    cfg = cfg_cls(block_size=4, decode_slots=3, max_queue_depth=4,
                  num_blocks=14, max_inflight_tokens=80)
    mgr = mgr_cls(14, 4, 8)
    prefix = prefix_cls(mgr) if prefix_cls is not None else None
    kw = {"prefix_cache": prefix} if prefix is not None else {}
    sched = sched_cls(cfg, mgr, 32, clock=lambda: 0.0, **kw)
    rng = np.random.default_rng(seed)
    log = []
    for i in range(40):
        if rng.random() < 0.6:
            req = req_cls(prompt=list(range(int(rng.integers(1, 28)))),
                          max_new_tokens=int(rng.integers(1, 12)),
                          request_id=f"r{i}")
            log.append(("submit", sched.submit(req), req.finish_reason))
        admitted, shed = sched.admit()
        log += [("admit", slot, r.request_id, table.tolist())
                for slot, r, table in admitted]
        if prefix is not None:
            for slot, r, table in admitted:
                log.append(("match", r.request_id, r.prefix_hit_tokens,
                            r.blocks_shared, r.cached_len, r.cow,
                            sched.speculative_budget(r, 3)))
                mgr.cow_done(r.request_id)
                log.append(("insert", prefix.insert(r.prompt, table)))
            running = sched.running()
            if running and rng.random() < 0.5:
                _, req = running[int(rng.integers(len(running)))]
                n = int(rng.integers(1, 33))
                try:
                    log.append(("speculate", req.request_id,
                                mgr.speculate(req.request_id, n)))
                except (RuntimeError, ValueError) as e:
                    log.append(("speculate", req.request_id, type(e)))
                keep = int(rng.integers(0, n + 1))
                log.append(("commit", req.request_id,
                            mgr.commit_speculative(req.request_id, keep)
                            if rng.random() < 0.7
                            else mgr.drop_speculative(req.request_id),
                            mgr.owned(req.request_id)))
        running = sched.running()
        if running and rng.random() < 0.5:
            slot, req = running[int(rng.integers(len(running)))]
            sched.finish(req, "max_tokens")
            log.append(("finish", slot, req.request_id, mgr.num_free))
        if prefix is not None:
            log.append(("pool", mgr.num_free, mgr.num_cached,
                        sorted(mgr._ref.items()), list(mgr._evictable),
                        mgr.evictions))
    log.append(("end", len(sched.queue), sched.committed_tokens,
                sched.stats))
    if prefix is not None:
        log.append(("prefix", prefix.stats, len(prefix)))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_layer_decides_like_jax(seed):
    ours = _drive(ContinuousBatchingScheduler, BlockManager, ServingConfig,
                  Request, seed)
    ref = _drive(JaxScheduler, JaxBlockManager, JaxServingConfig,
                 JaxRequest, seed)
    assert ours == ref


def test_sampled_request_sheds_like_jax():
    cfg = ServingConfig(block_size=4, decode_slots=1)
    sched = ContinuousBatchingScheduler(cfg, BlockManager(9, 4, 8), 32)
    req = Request(prompt=[1, 2], max_new_tokens=2, do_sample=True, seed=3)
    assert not sched.submit(req)
    assert (req.state, req.finish_reason) == (SHED, "sampling_unsupported")


@pytest.mark.parametrize("knob", [
    {"router": {"replicas": 2}}, {"fleet": {}},
    {"gateway": {}}, {"migration": {}}, {"replay": {}},
    {"migration": {"enabled": True}},
])
def test_unported_serving_knobs_raise(knob):
    """The fleet's blocks are ported: each resolves to JAX's fields, and
    a fleet block without a router is refused as JAX refuses it."""
    def resolve(cls):
        try:
            return cls(**knob).model_dump()
        except ValueError as e:
            return str(e).split("\n")[1]

    ours, ref = resolve(ServingConfig), resolve(JaxServingConfig)
    assert ours == ref
    assert isinstance(ours, str) == ("fleet" in knob)


def test_bucket_legacy_generate_is_ported():
    """Padded generate() carries it: on by default, as in JAX, and either
    value is accepted."""
    assert ServingConfig().bucket_legacy_generate is True
    assert JaxServingConfig().bucket_legacy_generate is True
    for value in (True, False):
        assert ServingConfig(bucket_legacy_generate=value) \
            .bucket_legacy_generate is value


def test_unported_knob_raises_through_init_serving():
    """A router block makes init_serving build the router's replicas."""
    model = deepspeed_tpu_torch.models.gpt2.GPT2LMHeadModel(
        deepspeed_tpu_torch.models.gpt2.GPT2Config.tiny())
    front = deepspeed_tpu_torch.init_serving(
        model, device="cpu", serving={**_SERVING, "router": {}})
    assert isinstance(front, ReplicaRouter) and len(front.replicas) == 2


@pytest.mark.parametrize("key,value", [
    ("telemetry", {"enabled": True}), ("quant", {}),
    ("moe", {"enabled": True}), ("checkpoint", "/x"),
    ("dtype", "int8"),
])
def test_unported_inference_keys_raise(key, value):
    if key in ("telemetry", "checkpoint"):
        # ported (with the resilience and checkpoint keys): accepted and
        # resolved as the JAX config resolves them
        from deepspeed_tpu.inference.config import \
            DeepSpeedInferenceConfig as JaxInferenceConfig

        assert getattr(DeepSpeedInferenceConfig(**{key: value}),
                       key) == value
        for good in ({"telemetry": {"flight_recorder": {"enabled": True}}},
                     {"resilience": {"enabled": True}},
                     {"checkpoint": "/x", "base_dir": "/y"},
                     {"save_mp_checkpoint_path": "/z"},
                     {"ckpt_config": {"a": 1}}):
            port = DeepSpeedInferenceConfig(**good)
            jax = JaxInferenceConfig(**good)
            for name in ("telemetry", "resilience", "checkpoint",
                         "base_dir", "save_mp_checkpoint_path",
                         "checkpoint_config"):
                assert getattr(port, name) == getattr(jax, name), \
                    (good, name)
        with pytest.raises(ValueError, match="policy"):
            DeepSpeedInferenceConfig(
                resilience={"sentinel": {"policy": "nope"}})
        return
    with pytest.raises(NotImplementedError, match="slice"):
        DeepSpeedInferenceConfig(**{key: value})


def test_migration_seams_raise():
    model = deepspeed_tpu_torch.models.gpt2.GPT2LMHeadModel(
        deepspeed_tpu_torch.models.gpt2.GPT2Config.tiny(dtype=torch.float32))
    srv = deepspeed_tpu_torch.init_serving(model, device="cpu",
                                           serving=_SERVING)
    # ported (tests/test_torch_migration.py): nothing to move is a None
    assert srv.export_sequence("r0") is None
    assert srv.import_sequence(None) is None


def test_serving_needs_a_serving_block():
    model = deepspeed_tpu_torch.models.gpt2.GPT2LMHeadModel(
        deepspeed_tpu_torch.models.gpt2.GPT2Config.tiny(dtype=torch.float32))
    with pytest.raises(ValueError, match="serving"):
        deepspeed_tpu_torch.init_serving(model, device="cpu")
