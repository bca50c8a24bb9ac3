"""The port's live KV migration seams against the JAX engine's, on the
tiny fp32 GPT-2 (both packages on the same weights).

- ``export_sequence``: the same counters (``blocks``, ``length``,
  ``tokens``, ``last_token``, ``wire_bytes``) and the same rows, layer by
  layer, within 1e-5, over fp32 and int8 pools;
- ``import_sequence``: the moved request resumes with NO prefill or
  chunk call and finishes with the never-migrated run's tokens, each
  post-move token streamed once; ``migrate_out`` detaches the source
  without a shed;
- refusals as in JAX: unknown, queued, mismatched (block size, pool
  dtype, layout), duplicate and full;
- the chaos seams: a commit fault releases the target's blocks and the
  source finishes in place; ``serving.migration.export`` and
  ``serving.spec_commit`` fire where JAX's do;
- the wire format: bf16 rows travel as their int16 bits (2 bytes an
  element) and land bit for bit; int8 rows cost (D + 4) / (4 D) of fp32.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.runtime.resilience import chaos as jax_chaos
from deepspeed_tpu.serving import request as jax_request
from deepspeed_tpu.serving.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving.engine import ServingEngine as JaxServingEngine
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.runtime.resilience import chaos
from deepspeed_tpu_torch.serving.config import ServingConfig
from deepspeed_tpu_torch.serving.engine import ServingEngine
from deepspeed_tpu_torch.serving import request as port_request
from deepspeed_tpu_torch.serving.migration import Migrator
from deepspeed_tpu_torch.serving.request import FINISHED, RUNNING, SHED
from tests.test_torch_gpt2 import jax_engine, port_model

_SERVING = {"block_size": 8, "decode_slots": 2, "prompt_buckets": [16],
            "default_max_new_tokens": 6}
_PROMPT = [5, 17, 42, 7, 8, 9, 10, 11, 12]
COUNTERS = ("request_id", "prompt", "tokens", "max_new_tokens", "length",
            "last_token", "blocks", "wire_bytes", "block_size",
            "kv_cache_dtype", "do_sample", "sampling")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread while a test of this file runs: the test
    workers share the machine's cores, and the tiny model's ops spend
    more on waking threads than on work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def engines():
    """One JAX and one port inference engine on the same weights; each
    test builds its serving engines over them with its own block."""
    jax_ie, params = jax_engine(seed=1)
    port_ie = deepspeed_tpu_torch.init_inference(
        port_model(params), dtype="fp32", device="cpu")
    return jax_ie, port_ie


@pytest.fixture(autouse=True)
def _no_chaos_leak():
    yield
    chaos.clear()
    jax_chaos.clear()


def _serving(ie, serving, cls, n=1, **kw):
    """``n`` serving engines over inference engine ``ie`` under the
    ``serving`` block (swapped in for their construction only)."""
    cfg_cls = JaxServingConfig if cls is JaxServingEngine else ServingConfig
    ie._serving_cfg = cfg_cls(**serving)
    try:
        return [cls(ie, **kw) for _ in range(n)]
    finally:
        ie._serving_cfg = None


def _never_moved(srv):
    r = srv.submit(_PROMPT, max_new_tokens=6)
    srv.drain()
    return r.tokens


def _jax_rows(srv, export):
    """The JAX export's rows by (pool name, layer): its leaves stack the
    layers on axis 0 ([L, B, bs, H, D])."""
    paths = jax.tree_util.tree_flatten_with_path(srv.cache)[0]
    out = {}
    for (path, _), chunks in zip(paths, export["rows"]):
        (r,) = chunks
        for layer in range(r.shape[0]):
            out[path[-1].key, layer] = r[layer]
    return out


def _port_rows(srv, export):
    names = ["key_pool", "value_pool", "key_scale", "value_scale"]
    L = srv.engine.model_config.n_layer
    return {(names[i // L], i % L): r
            for i, r in enumerate(export["rows"])}


@pytest.mark.parametrize("kv", ["", "int8"])
def test_export_matches_jax(engines, kv):
    serving = {**_SERVING, "kv_cache_dtype": kv}
    out = {}
    for ie, cls in zip(engines, (JaxServingEngine, ServingEngine)):
        (srv,) = _serving(ie, serving, cls)
        r = srv.submit(_PROMPT, max_new_tokens=6, request_id="m")
        for _ in range(3):
            srv.step()
        out[cls] = srv, srv.export_sequence("m")
    (jsrv, jref), (psrv, ours) = out[JaxServingEngine], out[ServingEngine]
    assert {k: ours[k] for k in COUNTERS} == {k: jref[k] for k in COUNTERS}
    assert ours["blocks"] == 2
    assert ours["length"] == len(_PROMPT) + len(ours["tokens"]) - 1
    jrows, prows = _jax_rows(jsrv, jref), _port_rows(psrv, ours)
    assert sorted(jrows) == sorted(prows)
    for key, want in jrows.items():
        got = prows[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if got.dtype == np.int8:
            # codes may differ by one where round-off flips a tie
            # (tests/test_torch_serving_fast.py); the first layer's K/V
            # are the same in both packages
            diff = np.abs(got.astype(np.int32) - want)
            assert diff.max() <= (0 if key[1] == 0 else 1), key
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                       err_msg=str(key))


def test_import_resumes_with_no_prefill_like_jax(engines):
    out = {}
    for ie, cls in zip(engines, (JaxServingEngine, ServingEngine)):
        src, dst = _serving(ie, _SERVING, cls, n=2)
        ref = _never_moved(src)
        r = src.submit(_PROMPT, max_new_tokens=6, request_id="m")
        for _ in range(3):
            src.step()
        export = src.export_sequence("m")
        streamed = []
        calls = []
        if cls is ServingEngine:
            for name in ("_prefill", "_chunk_call"):
                real = getattr(dst, name)
                setattr(dst, name, lambda *a, _r=real, _n=name:
                        calls.append(_n) or _r(*a))
        r2 = dst.import_sequence(
            export, stream=lambda q, t, d: streamed.append((t, d)))
        assert src.migrate_out("m") and not src.migrate_out("m")
        assert (r.state, r.finish_reason) == (SHED, "migrated")
        dst.drain()
        assert r2.state == FINISHED and r2.tokens == ref
        assert r.tokens + [t for t, _ in streamed] == ref
        assert [d for _, d in streamed] == [False] * (len(streamed) - 1) \
            + [True]
        if cls is ServingEngine:
            assert calls == []
            assert dst.sched.stats["migrated_in"] == 1
        else:
            assert not dst._prefill_fns and not dst._chunk_fns
        keys = ("finished", "shed", "migrated_in", "migrated_out")
        out[cls] = (ref, r.tokens, r2.tokens,
                    {k: src.stats()[k] for k in keys},
                    {k: dst.stats()[k] for k in keys},
                    src.gauges(), dst.gauges())
    assert out[ServingEngine] == out[JaxServingEngine]


def _refusals(ie, cls):
    src, dst = _serving(ie, _SERVING, cls, n=2)
    (other,) = _serving(ie, {**_SERVING, "block_size": 16}, cls)
    (quant,) = _serving(ie, {**_SERVING, "kv_cache_dtype": "int8"}, cls)
    log = [src.export_sequence("nope")]
    r = src.submit(_PROMPT, max_new_tokens=6)
    src.submit([1, 2, 3], max_new_tokens=2)
    queued = src.submit([4, 5, 6], max_new_tokens=2)
    src.step()
    log.append(queued.state)
    log.append(src.export_sequence(queued.request_id))
    export = src.export_sequence(r.request_id)
    log += [other.import_sequence(export), quant.import_sequence(export),
            dst.import_sequence(None)]
    first = dst.import_sequence(export)
    log += [first.request_id, dst.import_sequence(export),
            dst.import_sequence(export, request_id="fill-1").request_id,
            dst.import_sequence(export, request_id="fill-2")]
    log.append({k: v for k, v in dst.gauges().items()})
    return log


def test_refusals_match_jax(engines):
    # the ids compared come from each package's per-process counter:
    # start both at 0, whatever earlier tests in this process submitted
    port_request._ids = itertools.count()
    ours = _refusals(engines[1], ServingEngine)
    jax_request._ids = itertools.count()
    ref = _refusals(engines[0], JaxServingEngine)
    assert ours == ref
    assert [ours[i] for i in (0, 2, 3, 4, 5, 7, 9)] == [None] * 7


def test_layout_mismatch_is_refused(engines):
    src, dst = _serving(engines[1], _SERVING, ServingEngine, n=2)
    src.submit(_PROMPT, max_new_tokens=6, request_id="m")
    src.step()
    export = src.export_sequence("m")
    bad = dict(export, layout=[export["layout"][0] + 1]
               + export["layout"][1:])
    free = dst.block_mgr.num_free
    assert dst.import_sequence(bad) is None
    assert dst.block_mgr.num_free == free


def test_commit_fault_releases_the_target(engines):
    src, dst = _serving(engines[1], _SERVING, ServingEngine, n=2)
    ref = _never_moved(src)
    r = src.submit(_PROMPT, max_new_tokens=6, request_id="m")
    for _ in range(3):
        src.step()
    free, pools = dst.block_mgr.num_free, [p.clone()
                                           for p in dst.cache.pools()]
    chaos.io_errors("serving.migration.commit", at_call=1)
    assert Migrator({}).migrate(src, dst, "m") is None
    assert dst.block_mgr.num_free == free
    assert dst.gauges()["slots_busy"] == 0
    # block 0, the garbage block, is never written
    for before, after in zip(pools, dst.cache.pools()):
        assert torch.equal(before[0], after[0])
    assert r.state == RUNNING
    src.drain()
    assert r.state == FINISHED and r.tokens == ref


def test_export_seam_and_chaos_replica(engines):
    (srv,) = _serving(engines[1], _SERVING, ServingEngine)
    srv.submit(_PROMPT, max_new_tokens=6, request_id="m")
    srv.step()
    with chaos.io_errors("serving.migration.export", at_call=1):
        with pytest.raises(chaos.ChaosIOError):
            srv.export_sequence("m")
    crashy = chaos.ChaosReplica(srv, crash_during_migration=1)
    with pytest.raises(chaos.ReplicaCrashed):
        crashy.export_sequence("m")
    with pytest.raises(chaos.ReplicaCrashed):
        crashy.step()
    assert srv.export_sequence("m")["blocks"] == 2


def test_spec_commit_seam_keeps_host_state(engines):
    """A crash between the verify forward and the commit emits nothing:
    the request's tokens and length are the pre-step ones."""
    serving = {**_SERVING, "speculative": {"num_speculative_tokens": 2}}
    (srv,) = _serving(engines[1], serving, ServingEngine)
    r = srv.submit(_PROMPT, max_new_tokens=6)
    srv.step()
    before = (list(r.tokens), r.length, srv._step_count)
    crashy = chaos.ChaosReplica(srv, crash_between_draft_and_commit=1)
    with pytest.raises(chaos.ReplicaCrashed):
        crashy.step()
    assert (list(r.tokens), r.length, srv._step_count) == before


def test_cancel_and_gauges_match_jax(engines):
    out = []
    for ie, cls in zip(engines, (JaxServingEngine, ServingEngine)):
        (srv,) = _serving(ie, _SERVING, cls)
        reqs = [srv.submit(_PROMPT[:n], max_new_tokens=5,
                           request_id=f"c{n}") for n in (3, 5, 9)]
        srv.step()
        g1 = srv.gauges()
        log = [srv.cancel("c5"), srv.cancel("c9"), srv.cancel("c9"),
               srv.cancel("nope")]
        srv.drain()
        out.append((g1, log, srv.gauges(),
                    [(r.state, r.finish_reason, r.tokens) for r in reqs],
                    {k: srv.stats()[k] for k in ("finished", "shed",
                                                 "shed_reasons")}))
    assert out[1] == out[0]


def test_bf16_rows_travel_as_int16_bits():
    torch.manual_seed(0)
    model = GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.bfloat16))
    ie = deepspeed_tpu_torch.init_inference(model, dtype="bf16",
                                            device="cpu")
    src, dst = _serving(ie, _SERVING, ServingEngine, n=2)
    src.submit(_PROMPT, max_new_tokens=6, request_id="m")
    for _ in range(3):
        src.step()
    export = src.export_sequence("m")
    assert set(export["dtypes"]) == {"bfloat16"}
    assert all(r.dtype == np.int16 for r in export["rows"])
    cfg = ie.model_config
    elems = 2 * cfg.n_layer * export["blocks"] * 8 * cfg.n_head \
        * cfg.head_dim
    assert export["wire_bytes"] == 2 * elems
    r2 = dst.import_sequence(export)
    table = dst.block_mgr.owned(r2.request_id)[:export["blocks"]]
    src_table = src.block_mgr.owned("m")[:export["blocks"]]
    for a, b in zip(src.cache.pools(), dst.cache.pools()):
        assert torch.equal(a[src_table].view(torch.int16),
                           b[table].view(torch.int16))
    src.migrate_out("m")
    dst.drain()
    assert r2.state == FINISHED and len(r2.tokens) == 6


def test_int8_wire_bytes(engines):
    sizes = {}
    for kv in ("", "int8"):
        (srv,) = _serving(engines[1], {**_SERVING, "kv_cache_dtype": kv},
                          ServingEngine)
        srv.submit(_PROMPT, max_new_tokens=6, request_id="m")
        srv.step()
        sizes[kv] = srv.export_sequence("m")["wire_bytes"]
    D = engines[1].model_config.head_dim
    # int8 codes plus an fp32 scale a row, against fp32 rows
    assert sizes["int8"] * 4 * D == sizes[""] * (D + 4)
