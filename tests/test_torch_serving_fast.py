"""The port's serving fast path against the JAX package's.

On the CPU at a tiny size (``GPT2Config.tiny``, float32, block size 8),
the same numpy inputs and weights go through both packages:

- the row-wise int8 codec matches bit for bit (codes and scales, zero
  rows and exact .5 ties included);
- the int8 paged attention's plain version matches the Pallas kernel in
  interpret mode at rtol/atol 2e-5;
- the host layer (block manager with refcounts, COW and the speculative
  ledger, radix prefix cache, scheduler admission) makes the JAX layer's
  decisions on a seeded random stream, and the proposers propose the
  same tokens;
- the JAX ``ServingEngine`` and the port's serve one request stream with
  the prefix cache, chunked prefill, int8 KV, speculative decoding and
  all four together: equal greedy tokens, per-request counters and block
  manager state; under int8 KV equal pools.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models.decode_utils import (
    cache_attn_mask as jax_cache_attn_mask)
from deepspeed_tpu.ops import decode_attention as jax_decode
from deepspeed_tpu.ops.attention import (
    attention_reference as jax_attention_reference)
from deepspeed_tpu.ops.quantizer import quantize_rowwise as jax_quantize
from deepspeed_tpu.serving.blocks import BlockManager as JaxBlockManager
from deepspeed_tpu.serving.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving.engine import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving.prefix_cache import PrefixCache as JaxPrefixCache
from deepspeed_tpu.serving.request import Request as JaxRequest
from deepspeed_tpu.serving.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler)
from deepspeed_tpu.serving.spec_decode import (
    DraftModelProposer as JaxDraftModelProposer)
from deepspeed_tpu.serving.spec_decode import (
    PromptLookupProposer as JaxPromptLookupProposer)
from deepspeed_tpu.utils.compat import tpu_interpret_mode
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.ops.decode_attention import (
    GARBAGE_BLOCK, decode_attention_paged_int8,
    decode_attention_paged_int8_reference, gather_paged_cache_int8)
from deepspeed_tpu_torch.ops.quantizer import (dequantize_rowwise,
                                               quantize_rowwise)
from deepspeed_tpu_torch.serving.blocks import BlockManager
from deepspeed_tpu_torch.serving.config import ServingConfig
from deepspeed_tpu_torch.serving.prefix_cache import PrefixCache
from deepspeed_tpu_torch.serving.request import FINISHED, Request
from deepspeed_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
from deepspeed_tpu_torch.serving.spec_decode import (DraftModelProposer,
                                                     PromptLookupProposer)
from tests.test_torch_gpt2 import jax_engine, port_model
from tests.test_torch_serving import _drive

# the paged attention tolerance the JAX package's own int8 test pins
# (tests/unit/test_decode_attention.py:336): the same int8 rows and scales
# in another fp32 summation order
INT8_TOL = dict(rtol=2e-5, atol=2e-5)
_BASE = {"block_size": 8, "decode_slots": 3}
_SPEC = {"speculative": {"num_speculative_tokens": 3}}
_DRAFT = {"speculative": {"num_speculative_tokens": 3,
                          "proposer": "draft_model"}}
_ALL = {"prefix_cache": True, "prefill_chunk_tokens": 8,
        "kv_cache_dtype": "int8", **_DRAFT}


# ---------------------------------------------------------------------------
# codec and int8 paged attention
# ---------------------------------------------------------------------------
def test_quantize_rowwise_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 4, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                        # all-zero row: scale 1
    # absmax 127 makes the scale exactly 1: every x.5 is a tie, which
    # both round half to even
    x[1, 2, 3] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5, 3.0,
                  4.5, -4.5, 5.5, 6.25, -7.75, 0.0, 8.5, -9.5]
    q, s = quantize_rowwise(torch.from_numpy(x))
    jq, js = jax_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[0, 0, 0, 0] == 1.0 and not q[0, 0, 0].any()
    assert q[1, 2, 3, 1:5].tolist() == [2, -4, 0, 0]   # half to even
    back = dequantize_rowwise(q, s)
    assert (back - torch.from_numpy(x)).abs().max() <= s.max() / 2


def _int8_paged_inputs(lengths, tq, bs=32, mb=4, H=2, D=64, seed=0):
    """The JAX test's setup (``tests/unit/test_decode_attention.py``):
    random pools quantized row-wise, per-row permuted block tables
    covering ``length + tq``; unallocated entries name the garbage
    block."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    nb = 1 + B * mb
    kp = rng.normal(size=(nb, bs, H, D)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, H, D)).astype(np.float32)
    tables = np.full((B, mb), GARBAGE_BLOCK, np.int32)
    free = list(rng.permutation(np.arange(1, nb)))
    for b, ln in enumerate(lengths):
        need = max(1, -(-(ln + tq) // bs))
        tables[b, :need] = [free.pop() for _ in range(need)]
    q = rng.normal(size=(B, tq, H, D)).astype(np.float32)
    (kq, ks), (vq, vs) = (map(np.array, jax_quantize(jnp.asarray(p)))
                          for p in (kp, vp))
    return q, kq, vq, ks, vs, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("lengths,tq", [([0, 5], 1), ([7, 63], 1),
                                        ([60, 30], 4),
                                        ([0, 23, 57], 5),   # verify shapes
                                        ([0], 80),    # a first chunk
                                        ([40], 70)])  # starts in a block
def test_paged_int8_matches_pallas(lengths, tq):
    arrays = _int8_paged_inputs(lengths, tq, seed=sum(lengths) + tq)
    with tpu_interpret_mode():
        ref = jax_decode.decode_attention_paged_int8(
            *map(jnp.asarray, arrays))
    ported = [torch.from_numpy(a) for a in arrays]
    out = decode_attention_paged_int8_reference(*ported)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **INT8_TOL)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        decode_attention_paged_int8(*ported).numpy(), out.numpy())


@pytest.mark.parametrize("tq,dtype,bs,source", [
    (1, torch.bfloat16, 16, "decode_paged_int8"),        # decode
    (5, torch.bfloat16, 16, "decode_paged_int8"),        # verify
    (7, torch.bfloat16, 16, "decode_paged_int8"),        # below the rule
    (8, torch.bfloat16, 16, "decode_paged_int8_sm90"),   # at it
    (136, torch.bfloat16, 16, "decode_paged_int8_sm90"),  # a last chunk
    (256, torch.bfloat16, 16, "decode_paged_int8_sm90"),  # a full chunk
    (256, torch.bfloat16, 128, "decode_paged_int8_sm90"),  # blocks of 2 x 64
    (256, torch.float32, 16, "decode_paged_int8"),       # fp32 q
    (256, torch.bfloat16, 48, "decode_paged_int8"),      # 48 does not divide 64
    (256, torch.bfloat16, 1, "decode_paged_int8"),       # rows below 128 bytes
])
def test_paged_int8_launch_takes_the_rule_s_source(tq, dtype, bs, source):
    """``_paged_int8_launch`` (what :func:`decode_attention_paged_int8`
    runs on the card) with ``load`` patched to a stub library: one call of
    the source ``int8_source`` names from the shapes alone (the tensor
    cores for bf16 chunks of at least ``TC_MIN_ROWS`` rows at a block size
    that divides 64 or is a multiple of it, the split decode otherwise),
    with as many arguments as its ctypes signature and C declaration; the
    split decode on a grid of ``decode_splits`` splits with the module's
    ``PAGED_MIN_SPLIT_KEYS`` and the (device, stream) workspace, the
    tensor-core source with none. The launch is counted under its
    source."""
    from deepspeed_tpu_torch.ops import decode_attention as da
    from tests.test_torch_ops import _c_arity

    calls = []

    class Lib:
        def __init__(self, src):
            self.src = src

        def __getattr__(self, fn):
            def call(*args):
                calls.append((self.src, fn, args))
                return 0
            return call

    assert da.TC_MIN_ROWS == 8
    B, H, D, NB, MB = 1, 12, 64, 65, 1024 // bs
    q = torch.zeros((B, tq, H, D), dtype=dtype)
    pool = torch.zeros((NB, bs, H, D), dtype=torch.int8)
    scales = torch.zeros((NB, bs, H, 1))
    tables = torch.ones((B, MB), dtype=torch.int32)
    lengths = torch.tensor([384], dtype=torch.int32)
    wrapper = da.decode_attention_paged_int8
    with mock.patch.object(da, "load", lambda src, sigs: Lib(src)), \
            mock.patch.object(da, "_stream", lambda t: 5), \
            mock.patch.object(da, "_sm_count", lambda dev: 132), \
            mock.patch.object(da, "_WORKSPACE", {}), \
            mock.patch.object(wrapper, "launches", 0), \
            mock.patch.object(wrapper, "source_launches", {}):
        da._paged_int8_launch(q, pool, pool, scales, scales, tables, lengths,
                              0.125)
        assert wrapper.launches == 1
        assert wrapper.source_launches == {source: 1}
        splits = wrapper.last_splits
        workspace = da._WORKSPACE.get((q.device, 5))
    assert da.int8_source(dtype, tq, D, bs) == source
    (src, fn, args), = calls
    sigs = {"decode_paged_int8": da._PAGED_INT8_SIG,
            "decode_paged_int8_sm90": da._PAGED_INT8_SM90_SIG}[source]
    assert src == source and fn == f"ds_{source}"
    assert len(args) == len(sigs[fn][0]) == _c_arity(source)
    if source == "decode_paged_int8_sm90":
        assert splits is None and workspace is None
        assert args[8:15] == (B, tq, H, D, NB, bs, MB)
    else:
        ws, tickets = workspace
        assert splits == da.decode_splits(B, H, tq, MB * bs, 132,
                                          da.PAGED_MIN_SPLIT_KEYS)
        assert args[8:10] == (ws.data_ptr(), tickets.data_ptr())
        assert args[10:20] == (int(dtype == torch.bfloat16), B, tq, H, D,
                               NB, bs, MB, splits, da.PAGED_MIN_SPLIT_KEYS)


def test_paged_int8_matches_dense_dequant_oracle():
    """Against the JAX package's dense oracle (gather-dequantize, masked
    attention), and the garbage block never contributes."""
    q, kq, vq, ks, vs, tables, lens = _int8_paged_inputs([3, 40], 3, seed=7)
    S = tables.shape[1] * kq.shape[1]
    kd, vd = (jax_decode.gather_paged_cache_int8(
        jnp.asarray(p), jnp.asarray(s), jnp.asarray(tables))
        for p, s in ((kq, ks), (vq, vs)))
    ref = jax_attention_reference(
        jnp.asarray(q).transpose(0, 2, 1, 3), kd.transpose(0, 2, 1, 3),
        vd.transpose(0, 2, 1, 3), mask=jax_cache_attn_mask(
            S, jnp.asarray(lens), 3), causal=False).transpose(0, 2, 1, 3)
    np.testing.assert_array_equal(
        gather_paged_cache_int8(*map(torch.from_numpy,
                                     (kq, ks, tables))).numpy(),
        np.asarray(kd))
    args = [q, kq, vq, ks, vs, tables, lens]
    out = decode_attention_paged_int8_reference(*map(torch.from_numpy, args))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **INT8_TOL)
    args[1][GARBAGE_BLOCK] = 127
    args[3][GARBAGE_BLOCK] = np.nan
    poisoned = decode_attention_paged_int8_reference(
        *map(torch.from_numpy, args))
    np.testing.assert_array_equal(out.numpy(), poisoned.numpy())


# ---------------------------------------------------------------------------
# host layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_host_layer_decides_like_jax(seed):
    ours = _drive(ContinuousBatchingScheduler, BlockManager, ServingConfig,
                  Request, seed, prefix_cls=PrefixCache)
    ref = _drive(JaxScheduler, JaxBlockManager, JaxServingConfig,
                 JaxRequest, seed, prefix_cls=JaxPrefixCache)
    assert ours == ref
    kinds = {entry[0] for entry in ours}
    assert {"match", "speculate", "commit", "pool"} <= kinds
    assert any(e[0] == "match" and e[5] is not None for e in ours)  # COW
    assert any(e[0] == "speculate" and e[2] and isinstance(e[2], list)
               for e in ours)                                  # a grant


def _contexts(seed):
    rng = np.random.default_rng(seed)
    motif = [int(t) for t in rng.integers(1, 50, 3)]
    return [[int(t) for t in rng.integers(1, 50, n)] for n in (2, 9, 30)] \
        + [motif * 4 + [motif[0]], [7] * 6, motif * 2 + [1, 2]]


@pytest.mark.parametrize("kw", [{}, {"min_ngram": 2, "max_ngram": 4},
                                {"window": 8}])
def test_prompt_lookup_proposes_like_jax(kw):
    ours, ref = PromptLookupProposer(**kw), JaxPromptLookupProposer(**kw)
    for i, ctx in enumerate(_contexts(3)):
        for k in (1, 3, 5):
            a = ours.propose(Request(prompt=ctx[:4], tokens=ctx[4:]), k)
            b = ref.propose(JaxRequest(prompt=ctx[:4], tokens=ctx[4:]), k)
            assert a == b, (i, k)


@pytest.fixture(scope="module")
def jax_setup():
    """One tiny JAX engine and its weights for the whole file (each
    serving configuration swaps the engine's serving block), and the
    port's inference engine on the same weights."""
    engine, params = jax_engine(seed=1)
    port_engine = deepspeed_tpu_torch.init_inference(
        port_model(params), dtype="fp32", device="cpu")
    return engine, params, port_engine


def test_draft_model_proposer_like_jax(jax_setup):
    """A callable draft and an inference engine as the draft: the port's
    InferenceEngine proposes the JAX engine's greedy tokens."""
    engine, params, port_engine = jax_setup

    def draft(ctx, k):
        return [(sum(ctx) + i) % 50 for i in range(k)]

    for window in (0, 5):
        ours = DraftModelProposer(draft, context_window=window)
        ref = JaxDraftModelProposer(draft, context_window=window)
        for ctx in _contexts(4):
            assert ours.propose(Request(prompt=ctx), 3) == \
                ref.propose(JaxRequest(prompt=ctx), 3)
    ctx = _contexts(5)[1]
    assert DraftModelProposer(port_engine).propose(Request(prompt=ctx), 4) \
        == JaxDraftModelProposer(engine).propose(JaxRequest(prompt=ctx), 4)


# ---------------------------------------------------------------------------
# the serving engines
# ---------------------------------------------------------------------------
def _stream():
    """A shared 16-token system prompt (2 blocks): ``a`` (+3, a partial
    tail) is served alone first; then ``c`` extends ``a``'s prompt
    inside its partial last block (copy-on-write), ``m`` tiles a motif
    (prompt lookup proposes), ``u`` shares nothing."""
    rng = np.random.default_rng(0)
    system = rng.integers(1, 256, 16)
    motif = rng.integers(1, 256, 4)
    a = np.concatenate([system, rng.integers(1, 256, 3)])
    return [a, np.concatenate([system, rng.integers(1, 256, 9)]),
            np.concatenate([a, rng.integers(1, 256, 2)]),
            np.concatenate([system, np.tile(motif, 3)]), np.tile(motif, 4)]


def _serve(srv):
    prompts = _stream()
    reqs = [srv.submit(prompts[0], max_new_tokens=6, request_id="a")]
    srv.drain()
    reqs += [srv.submit(p, max_new_tokens=6, request_id=rid)
             for rid, p in zip("bcmu", prompts[1:])]
    srv.drain()
    return reqs


def _fields(req):
    return (req.state, req.tokens, req.prefix_hit_tokens, req.blocks_shared,
            req.prefill_chunks, req.cow, req.draft_tokens,
            req.accepted_tokens)


def _block_state(mgr):
    return (mgr.num_free, mgr.num_cached, list(mgr._free),
            list(mgr._evictable), sorted(mgr._cached), mgr._ref,
            mgr._owned, mgr.evictions)


def _jax_pools(cache):
    """The JAX cache's per-layer pools (stacked on the layer axis)."""
    attn = cache["transformer"]["h"]["block"]["attn"]
    return {k: np.asarray(attn[k]) for k in
            ("key_pool", "value_pool", "key_scale", "value_scale")}


@pytest.mark.parametrize("extra", [
    {"prefix_cache": True}, {"prefill_chunk_tokens": 8},
    {"kv_cache_dtype": "int8"}, _SPEC, _DRAFT, _ALL],
    ids=["prefix", "chunked", "int8", "speculative", "speculative_draft",
         "all"])
def test_fast_path_serves_like_jax(jax_setup, extra):
    """``speculative`` proposes by prompt lookup, which a random model
    rarely confirms; ``speculative_draft`` and ``all`` propose through
    one shared draft, the port's greedy ``generate()`` on the target's
    weights, so drafts are mostly accepted (all of them over bf16/fp32
    pools, not all over int8 ones)."""
    engine, params, port_engine = jax_setup

    def draft(ctx, k):
        out = port_engine.generate([list(ctx)], max_new_tokens=k)
        return out[0, len(ctx):].tolist()

    serving = {**_BASE, **extra}
    engine._serving_cfg = JaxServingConfig(**serving)
    try:
        jsrv = JaxServingEngine(engine, draft_model=draft)
        ref = _serve(jsrv)
    finally:
        engine._serving_cfg = None
    srv = deepspeed_tpu_torch.init_serving(
        port_model(params), dtype="fp32", device="cpu", serving=serving,
        draft_model=draft)
    written = []   # (K or V, codes, scales) of every int8 pool write
    quantize = port_gpt2.quantize_rowwise

    def recorded(x):
        codes, scales = quantize(x)
        written.append((x, codes, scales))
        return codes, scales

    with mock.patch.object(port_gpt2, "quantize_rowwise", recorded):
        ours = _serve(srv)
    assert [_fields(r) for r in ours] == [_fields(r) for r in ref]
    assert all(r.state == FINISHED and len(r.tokens) == 6 for r in ours)
    assert _block_state(srv.block_mgr) == _block_state(jsrv.block_mgr)
    assert not srv.pending and not srv._prefilling
    by_id = {r.request_id: r for r in ours}
    if extra.get("prefix_cache"):
        assert all(by_id[r].prefix_hit_tokens >= 16 for r in "bcm")
        assert by_id["c"].cow is not None and by_id["u"].cow is None
        assert srv.stats()["prefix_cache"]["hits"] >= 3
    if extra.get("prefill_chunk_tokens"):
        assert max(r.prefill_chunks for r in ours) >= 3
    if "speculative" in extra:
        spec = srv.stats()["speculative"]
        assert spec == jsrv.stats()["speculative"]
        assert spec["draft_tokens"] > 0
        if spec["proposer"] == "draft_model":
            assert spec["accepted_tokens"] > spec["draft_tokens"] // 2
    if extra.get("kv_cache_dtype"):
        _check_int8_pools(srv.cache, _jax_pools(jsrv.cache), written)
    else:
        assert not written


# how far from the midpoint of two neighbouring codes, in units of the
# scale, an x / scale may lie where the two packages' codes differ: fp32
# round-off of x / scale (|x / scale| <= 127, a few 1e-7 relative through
# one layer's sums: ~1e-5), with a margin of ten
TIE = 1e-4


def _check_int8_pools(cache, ref, written):
    """The port's int8 pools against the JAX cache's, past the garbage
    block (which the two read differently: ROADMAP Queue 3).

    The quantizer is no cause of a difference: on every K/V the port
    quantized on the way (``written``) the JAX quantizer gives the same
    codes and scales bit for bit. Layer 0's K and V are the same in both
    packages, so its codes are equal and its scales within 1e-6. Deeper
    layers' K and V come through the first layer's attention and MLP,
    whose fp32 sums XLA and PyTorch take in different orders: there a
    code differs by one on at most 1e-3 of the codes, scales agree to
    1e-5, and every differing code is a tie that round-off flips — the
    port's x / scale lies within TIE of the midpoint of the two codes."""
    x, codes, scales = (torch.cat([w[j].reshape(-1, w[j].shape[-1])
                                   for w in written]).numpy()
                        for j in range(3))
    jq, js = jax_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(codes, np.asarray(jq))
    np.testing.assert_array_equal(scales, np.asarray(js))
    ratio = {(s.tobytes(), c.tobytes()): r for s, c, r in
             zip(scales, codes, x / scales)}

    pools = {"key": (cache.keys, cache.key_scales),
             "value": (cache.values, cache.value_scales)}
    for name, layers in pools.items():
        for i, (pool, scale) in enumerate(zip(*layers)):
            ours, ours_s = pool.numpy()[1:], scale.numpy()[1:]
            want = ref[f"{name}_pool"][i][1:]
            np.testing.assert_allclose(ours_s, ref[f"{name}_scale"][i][1:],
                                       rtol=1e-6 if i == 0 else 1e-5)
            diff = np.abs(ours.astype(np.int32) - want)
            if i == 0:
                np.testing.assert_array_equal(ours, want)
            assert diff.max() <= 1 and diff.sum() <= 1e-3 * diff.size, \
                (name, i, diff.sum())
            for *row, d in zip(*np.nonzero(diff)):
                r = ratio[ours_s[tuple(row)].tobytes(),
                          ours[tuple(row)].tobytes()][d]
                mid = (int(ours[tuple(row)][d]) + int(want[tuple(row)][d])) / 2
                assert abs(r - mid) <= TIE, (name, i, row, d, r, mid)


def test_fast_path_knobs_accepted():
    cfg = ServingConfig(**_BASE, **_ALL)
    assert cfg.prefix_cache and cfg.prefill_chunk_tokens == 8
    assert cfg.kv_cache_dtype == "int8"
    assert cfg.speculative.num_speculative_tokens == 3
    assert cfg.speculative.proposer == "draft_model"
    assert ServingConfig(**_SPEC).speculative.proposer == "prompt_lookup"
    assert cfg.speculative.model_dump() == \
        JaxServingConfig(**_BASE, **_ALL).speculative.model_dump()


@pytest.mark.parametrize("bad", [
    {"speculative": {}, "do_sample": True},
    {"kv_cache_dtype": "fp8"}, {"prefill_chunk_tokens": -1},
    {"speculative": {"num_speculative_tokens": 0}},
    {"speculative": {"proposer": "oracle"}}])
def test_fast_path_knobs_validated_like_jax(bad):
    with pytest.raises(ValueError):
        JaxServingConfig(**bad)
    with pytest.raises(ValueError):
        ServingConfig(**bad)
