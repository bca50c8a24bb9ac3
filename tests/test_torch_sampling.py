"""Keyed reproducible sampling in the port against the JAX package.

- The keyed PRNG: ``fold_in_key`` and ``keyed_sample`` give the JAX
  package's pinned vectors; threefry's random bits and the uniforms equal
  ``jax.random``'s bit for bit (partitionable lowering), the gumbels to
  2 ulps at the scale of the logits.
- ``keyed_filter_logits`` equals the JAX filter on the knob grid, and
  ``keyed_sample`` emits the JAX tokens on 64 rows of GPT-2's vocabulary
  with mixed greedy and sampled rows.
- On a tiny GPT-2 (weights carried across by ``params_from_jax``):
  ``generate(do_sample=True, seed=...)`` emits the JAX engine's tokens;
  the serving engine, under the JAX test's staggered mix, emits each
  request's ``generate`` stream and the JAX serving engine's tokens, and
  the same stream again under another mix and through chunked prefill;
  keyed requests on the serving fast path (prefix cache, chunked prefill,
  int8 KV, all three) give the JAX engine's tokens, prefix hits and chunk
  counts; the shed reasons and config errors are the JAX package's.

Everything runs on the CPU in float32 (JAX in ``threefry_partitionable``
mode inside ``keyed_sample``, as the JAX package draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.ops import sampling as jax_sampling
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving.blocks import BlockManager as JaxBlockManager
from deepspeed_tpu.serving.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving.request import Request as JaxRequest
from deepspeed_tpu.serving.scheduler import (
    ContinuousBatchingScheduler as JaxScheduler)
from deepspeed_tpu_torch.ops import sampling
from deepspeed_tpu_torch.serving.blocks import BlockManager
from deepspeed_tpu_torch.serving.config import ServingConfig
from deepspeed_tpu_torch.serving.engine import ServingEngine
from deepspeed_tpu_torch.serving.request import FINISHED, Request
from deepspeed_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
from tests.test_torch_gpt2 import jax_engine, port_model
from tests.test_torch_serving_fast import _stream

_SERVING = {"block_size": 8, "decode_slots": 3}
_SAMP = {**_SERVING, "sampling": {"enabled": True}}
KEYS = ((0, 0), (7, 5), (123456789, 1000))
GPT2_VOCAB = 50257


# ---------------------------------------------------------------------------
# the keyed PRNG
# ---------------------------------------------------------------------------
def test_fold_in_key_pin():
    """The JAX package's pin (``tests/unit/test_sampling.py``), and the
    fold-in of tensor positions equals JAX's key by key."""
    assert sampling.fold_in_key(7, 5).tolist() == [3583082021, 1947592014]
    keys = sampling.fold_in_key(torch.tensor([7, 7, 8]),
                                torch.tensor([5, 6, 5]))
    for (s, p), k in zip(((7, 5), (7, 6), (8, 5)), keys.tolist()):
        assert k == [int(v) for v in np.asarray(jax_sampling.fold_in_key(
            s, p))]
    assert keys[0].tolist() != keys[1].tolist() != keys[2].tolist()


def test_keyed_sample_pin():
    """Six positions of seed 11 over one row: the JAX package's tokens."""
    row = np.random.default_rng(0).standard_normal(32).astype(np.float32)
    toks = sampling.keyed_sample(torch.from_numpy(np.tile(row, (6, 1))),
                                 np.full(6, 11), np.arange(6), np.ones(6),
                                 np.ones(6), np.zeros(6), np.zeros(6))
    assert toks.tolist() == [2, 7, 22, 24, 2, 26]


@pytest.mark.parametrize("n", [1, 31, GPT2_VOCAB])
def test_random_bits_uniforms_gumbels_match_jax(n):
    """Bits and uniforms bit for bit; the gumbels -log(-log(u)) within 2
    ulps of max(|g|, 1): the two libraries' logs may round the inner
    log's result differently by an ulp, and near g = 0 that ulp of the
    inner value (~1) is what the outer log passes on."""
    tiny = np.finfo(np.float32).tiny
    for seed, pos in KEYS:
        key = jax_sampling.fold_in_key(seed, pos)
        with jax.threefry_partitionable(True):
            bits = np.asarray(jax.random.bits(key, (n,), jnp.uint32))
            uni = np.asarray(jax.random.uniform(key, (n,), jnp.float32,
                                                minval=tiny, maxval=1.0))
            gum = np.asarray(jax.random.gumbel(key, (n,), jnp.float32))
        ours = sampling.random_bits(sampling.fold_in_key(seed, pos), n)
        np.testing.assert_array_equal(ours.numpy(), bits.astype(np.int64))
        u = sampling.uniform(ours)
        np.testing.assert_array_equal(u.numpy().view(np.int32),
                                      uni.view(np.int32))
        g = sampling.gumbel(u).numpy()
        ulp = np.spacing(np.maximum(np.abs(gum), 1.0).astype(np.float32))
        assert (np.abs(g - gum) <= 2 * ulp).all(), (seed, pos)


def _jax_filter(rows, t, k, p):
    return np.asarray(jax.vmap(lambda r: jax_sampling.keyed_filter_logits(
        r, jnp.float32(t), jnp.int32(k), jnp.float32(p)))(rows))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_keyed_filter_logits_matches_jax(seed):
    """The knob grid temperature {0.7, 1.3} x top_k {0, 7} x top_p {0,
    0.9} on four rows of 64 logits from ``default_rng(seed)``: equal."""
    rows = np.random.default_rng(seed).standard_normal((4, 64)).astype(
        np.float32)
    for t in (0.7, 1.3):
        for k in (0, 7):
            for p in (0.0, 0.9):
                ours = sampling.keyed_filter_logits(
                    torch.from_numpy(rows), np.full(4, t), np.full(4, k),
                    np.full(4, p)).numpy()
                np.testing.assert_array_equal(ours, _jax_filter(rows, t, k,
                                                                p))


def test_keyed_filter_logits_gpt2_vocab_tail():
    """At GPT-2's vocabulary the same grid agrees on every logit both
    keep, with the same values; the kept sets may differ only in the deep
    tail of top_p = 0 (a threshold of 1.0, where the float32 running sum
    of 50257 probabilities reaches 1.0 at a point set by the summation
    order, which differs between XLA's CPU scan and torch's cumsum, as it
    does between XLA's own backends). Those tokens carry at most 1e-4 of
    the mass together."""
    for seed in range(4):
        rows = (3 * np.random.default_rng(seed).standard_normal(
            (2, GPT2_VOCAB))).astype(np.float32)
        for t in (0.7, 1.3):
            for k in (0, 7):
                for p in (0.0, 0.9):
                    ours = sampling.keyed_filter_logits(
                        torch.from_numpy(rows), np.full(2, t),
                        np.full(2, k), np.full(2, p)).numpy()
                    ref = _jax_filter(rows, t, k, p)
                    both = np.isfinite(ours) & np.isfinite(ref)
                    np.testing.assert_array_equal(ours[both], ref[both])
                    differ = np.isfinite(ours) != np.isfinite(ref)
                    if differ.any():
                        assert p == 0.0, (seed, t, k, p)
                        z = np.where(np.isfinite(ours) | np.isfinite(ref),
                                     rows / t, -np.inf)
                        prob = np.exp(z - z.max(-1, keepdims=True))
                        prob /= prob.sum(-1, keepdims=True)
                        assert (prob * differ).sum(-1).max() < 1e-4


def test_keyed_sample_matches_jax_mixed_rows():
    """64 rows of GPT-2's vocabulary, mixed greedy and sampled rows with
    mixed seeds, positions and knobs: the JAX tokens."""
    rng = np.random.default_rng(5)
    n = 64
    logits = (3 * rng.standard_normal((n, GPT2_VOCAB))).astype(np.float32)
    seeds = rng.integers(0, 2 ** 32, n)
    pos = rng.integers(0, 1024, n)
    flags = rng.integers(0, 2, n)
    temps = rng.choice([0.7, 1.0, 1.3], n)
    top_ks = rng.choice([0, 7, 50], n)
    top_ps = rng.choice([0.0, 0.9], n)
    ref = np.asarray(jax_sampling.keyed_sample(
        logits, seeds.astype(np.uint32), pos, flags, temps, top_ks, top_ps))
    ours = sampling.keyed_sample(torch.from_numpy(logits), seeds, pos, flags,
                                 temps, top_ks, top_ps)
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(ours.numpy()[flags == 0],
                                  logits[flags == 0].argmax(-1))
    # the draw runs only for flagged rows: none flagged is the argmax
    greedy = sampling.keyed_sample(torch.from_numpy(logits), seeds, pos,
                                   np.zeros(n), temps, top_ks, top_ps)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


# ---------------------------------------------------------------------------
# generate(seed=) and the serving engine on a tiny GPT-2
# ---------------------------------------------------------------------------
KNOBS = (dict(seed=101, temperature=0.8, top_p=0.9),
         dict(seed=303, temperature=1.3, top_k=7),
         dict(seed=404))


@pytest.fixture(scope="module")
def engines():
    engine, params = jax_engine(seed=1, serving=_SAMP)
    port = deepspeed_tpu_torch.init_inference(
        port_model(params), dtype="fp32", device="cpu", serving=_SAMP)
    return engine, port, params


def _new(out, prompt_len):
    return [[int(t) for t in row[prompt_len:]] for row in np.asarray(out)]


@pytest.mark.parametrize("knobs", KNOBS)
def test_keyed_generate_matches_jax(engines, knobs):
    engine, port, _ = engines
    ids = np.random.default_rng(2).integers(1, 256, (2, 6))
    ref = engine.generate(jnp.asarray(ids), max_new_tokens=6,
                          do_sample=True, **knobs)
    ours = port.generate(torch.from_numpy(ids), max_new_tokens=6,
                         do_sample=True, **knobs)
    assert _new(ours, 6) == _new(ref, 6)
    greedy = port.generate(torch.from_numpy(ids), max_new_tokens=6)
    assert _new(ours, 6) != _new(greedy, 6)


def test_keyed_generate_eos_and_greedy_seed(engines):
    """After eos a row repeats it, as in JAX; a seed with do_sample off is
    the greedy stream."""
    engine, port, _ = engines
    ids = np.random.default_rng(3).integers(1, 256, (2, 5))
    first = _new(port.generate(torch.from_numpy(ids), max_new_tokens=6,
                               do_sample=True, seed=9), 5)
    eos = first[0][1]
    ref = engine.generate(jnp.asarray(ids), max_new_tokens=6, do_sample=True,
                          seed=9, eos_token_id=eos)
    ours = _new(port.generate(torch.from_numpy(ids), max_new_tokens=6,
                              do_sample=True, seed=9, eos_token_id=eos), 5)
    assert ours == _new(ref, 5)
    assert ours[0][1:] == [eos] * 5
    assert (_new(port.generate(torch.from_numpy(ids), max_new_tokens=4,
                               seed=9), 5)
            == _new(port.generate(torch.from_numpy(ids), max_new_tokens=4),
                    5))


def _staggered(srv, prompts):
    """The JAX test's staggered mix: two sampled and one greedy request
    around two steps, then two more sampled ones, then a drain."""
    reqs = [srv.submit(prompts[0], max_new_tokens=5, do_sample=True,
                       **KNOBS[0]),
            srv.submit(prompts[1], max_new_tokens=4)]
    srv.step()
    srv.step()
    reqs.append(srv.submit(prompts[2], max_new_tokens=5, do_sample=True,
                           **KNOBS[1]))
    reqs.append(srv.submit(prompts[3], max_new_tokens=3, do_sample=True,
                           **KNOBS[2]))
    srv.drain()
    return reqs


def test_staggered_serving_matches_generate_and_jax(engines):
    """The port's serving engine under JAX's staggered mix: each sampled
    request emits its own ``generate(seed=)`` stream, the greedy one the
    greedy stream, all equal to the JAX serving engine's tokens; the same
    sampled request later, beside another neighbour, repeats its
    stream."""
    engine, port, _ = engines
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 256, n) for n in (5, 11, 3, 8)]
    srv = ServingEngine(port)
    reqs = _staggered(srv, prompts)
    jax_reqs = _staggered(JaxServingEngine(engine), prompts)
    for req, ref, p, kn in zip(reqs, jax_reqs, prompts,
                               (KNOBS[0], None, KNOBS[1], KNOBS[2])):
        assert req.state == FINISHED, (req.state, req.finish_reason)
        assert req.tokens == ref.tokens, req.request_id
        out = port.generate(torch.from_numpy(p[None]),
                            max_new_tokens=req.max_new_tokens,
                            do_sample=kn is not None, **(kn or {}))
        assert req.tokens == _new(out, len(p))[0], req.request_id
    again = srv.submit(prompts[0], max_new_tokens=5, do_sample=True,
                       **KNOBS[0])
    srv.submit(prompts[3], max_new_tokens=6)
    srv.drain()
    assert again.tokens == reqs[0].tokens


def test_chunked_prefill_samples_like_whole_prompt(engines):
    """A sampled request through 4-token prefill chunks draws its first
    token at the same absolute position as whole-prompt prefill."""
    _, _, params = engines
    prompt = np.random.default_rng(4).integers(1, 256, 11)
    tokens = []
    for extra in ({}, {"prefill_chunk_tokens": 4}):
        srv = deepspeed_tpu_torch.init_serving(
            port_model(params), dtype="fp32", device="cpu",
            serving={**_SAMP, **extra})
        req = srv.submit(prompt, max_new_tokens=5, do_sample=True,
                         **KNOBS[0])
        srv.drain()
        assert req.state == FINISHED
        tokens.append(req.tokens)
    assert req.prefill_chunks == 3
    assert tokens[0] == tokens[1]


# 4 of the fast-path stream's 5 requests sample (``m``, the motif prompt,
# is greedy)
FAST_KNOBS = {"a": KNOBS[0], "b": KNOBS[1], "c": KNOBS[2], "u": KNOBS[0]}


def _keyed_fast_stream(srv):
    """``tests/test_torch_serving_fast.py``'s stream (``a`` alone, then
    ``b c m u``) with 4 of 5 requests sampled."""
    prompts = _stream()

    def submit(rid, p):
        kw = dict(do_sample=True, **FAST_KNOBS[rid]) \
            if rid in FAST_KNOBS else {}
        return srv.submit(p, max_new_tokens=6, request_id=rid, **kw)

    reqs = [submit("a", prompts[0])]
    srv.drain()
    reqs += [submit(rid, p) for rid, p in zip("bcmu", prompts[1:])]
    srv.drain()
    return reqs


@pytest.mark.parametrize("extra", [
    {"prefix_cache": True}, {"prefill_chunk_tokens": 8},
    {"kv_cache_dtype": "int8"},
    {"prefix_cache": True, "prefill_chunk_tokens": 8,
     "kv_cache_dtype": "int8"}], ids=["prefix", "chunked", "int8", "all"])
def test_keyed_fast_path_matches_jax(engines, extra):
    """Keyed sampling on the serving fast path: the port's engine gives
    the JAX engine's tokens, prefix hits and prefill chunk counts, and
    not every sampled stream is its greedy one."""
    engine, _, params = engines
    serving = {**_SAMP, **extra}
    saved = engine._serving_cfg
    engine._serving_cfg = JaxServingConfig(**serving)
    try:
        ref = _keyed_fast_stream(JaxServingEngine(engine))
    finally:
        engine._serving_cfg = saved
    srv = deepspeed_tpu_torch.init_serving(port_model(params), dtype="fp32",
                                           device="cpu", serving=serving)
    ours = _keyed_fast_stream(srv)

    def fields(req):
        return (req.request_id, req.state, req.tokens, req.prefix_hit_tokens,
                req.prefill_chunks)

    assert [fields(r) for r in ours] == [fields(r) for r in ref]
    assert all(r.state == FINISHED for r in ours)
    greedy = [srv.submit(p, max_new_tokens=6) for p in _stream()]
    srv.drain()
    assert any(r.tokens != g.tokens for r, g in zip(ours, greedy)
               if r.request_id in FAST_KNOBS)


def _shed_stream(sched_cls, blocks_cls, cfg_cls, req_cls, serving):
    cfg = cfg_cls(**serving)
    sched = sched_cls(cfg, blocks_cls(17, 8, 4), 32)
    stream = [dict(do_sample=True, seed=3), dict(do_sample=True),
              dict(do_sample=True, seed=3, temperature=0.0),
              dict(do_sample=True, seed=3, top_p=1.5),
              dict(do_sample=True, seed=-1), dict(do_sample=False, seed=3),
              dict(do_sample=True, seed=5, top_k=4)]
    out = []
    for i, kw in enumerate(stream):
        req = req_cls(prompt=[1, 2, 3], max_new_tokens=2,
                      request_id=f"r{i}", **kw)
        sched.submit(req)
        out.append((req.state, req.finish_reason, req.temperature,
                    req.top_k, req.top_p))
    return out


@pytest.mark.parametrize("serving", [
    _SERVING, _SAMP,
    {**_SERVING, "sampling": {"default_temperature": 0.5,
                              "default_top_k": 3, "default_top_p": 0.8}},
    {**_SERVING, "sampling": {"enabled": False}},
])
def test_sampling_admission_matches_jax(serving):
    """sampling_unsupported, sampling_unseeded and sampling_invalid shed
    the same requests as in the JAX scheduler, and admitted requests carry
    the same resolved knobs."""
    ours = _shed_stream(ContinuousBatchingScheduler, BlockManager,
                        ServingConfig, Request, serving)
    ref = _shed_stream(JaxScheduler, JaxBlockManager, JaxServingConfig,
                       JaxRequest, serving)
    assert ours == ref


@pytest.mark.parametrize("extra", [
    {"do_sample": True},
    {"speculative": {"num_speculative_tokens": 3}},
    {"sampling": {"default_temperature": 0.0}},
    {"sampling": {"default_top_k": -1}},
    {"sampling": {"default_top_p": 2.0}},
])
def test_sampling_config_errors_match_jax(extra):
    """One sampling authority: the block with the engine-level do_sample
    or with speculative decoding raises the JAX package's ValueError, as
    do the block's out-of-range defaults; a disabled block composes."""
    kw = {"sampling": {"enabled": True}, **extra}
    if "sampling" in extra:
        kw["sampling"] = extra["sampling"]
    with pytest.raises(ValueError) as ours:
        ServingConfig(**kw)
    with pytest.raises(ValueError) as ref:
        JaxServingConfig(**kw)
    assert ours.value.errors()[0]["msg"] == ref.value.errors()[0]["msg"]
    ServingConfig(sampling={"enabled": False}, **{
        k: v for k, v in extra.items() if k != "sampling"})
