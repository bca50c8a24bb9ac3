"""The port's GPT-2 and inference engine against the JAX package.

The same weights (random numpy arrays from a fixed seed, in the flax
layout, converted with ``params_from_jax``) and the same token ids go
through ``deepspeed_tpu``'s model and engine and through the port's, on
the CPU in float32 (``GPT2Config.tiny``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.engine import sample_logits as jax_sample_logits
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxConfig
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JaxModel
from deepspeed_tpu.parallel.topology import reset_topology
from deepspeed_tpu_torch.inference.engine import filter_logits, sample_logits
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.utils.params import params_from_jax


def random_flax_params(tree, seed):
    """numpy weights in the flax tree's layout, spread wider than the
    init so greedy decoding does not just repeat the last token."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        std = 0.05 if name == "bias" else 0.3 if name in ("wte", "wpe") \
            else 0.15
        return (std * rng.normal(size=x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def jax_engine(seed=0, **kwargs):
    """The JAX package's tiny fp32 engine with :func:`random_flax_params`."""
    reset_topology()
    cfg = JaxConfig.tiny(dtype=jnp.float32)
    engine = deepspeed_tpu.init_inference(JaxModel(cfg), dtype="fp32",
                                          seed=seed, **kwargs)
    params = random_flax_params(jax.device_get(engine.params), seed)
    engine.params = jax.tree_util.tree_map(jnp.asarray, params)
    return engine, params


def port_model(params, **cfg_kw):
    cfg = GPT2Config.tiny(dtype=torch.float32, **cfg_kw)
    model = GPT2LMHeadModel(cfg)
    model.load_state_dict(params_from_jax(params, cfg))
    return model


@pytest.fixture(scope="module")
def engines():
    engine, params = jax_engine(seed=0)
    port = deepspeed_tpu_torch.init_inference(port_model(params),
                                              dtype="fp32", device="cpu")
    return engine, port, params


@pytest.mark.parametrize("scan_layers", [True, False])
def test_logits_match_jax(scan_layers):
    cfg = JaxConfig.tiny(dtype=jnp.float32, scan_layers=scan_layers)
    model = JaxModel(cfg)
    ids = np.random.default_rng(1).integers(0, 256, (2, 12))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(ids))["params"]
    params = random_flax_params(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                               shapes), seed=5)
    ref = model.apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        out = port_model(params)(torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("eos", [False, True])
def test_generate_greedy_matches_jax(engines, eos):
    engine, port, _ = engines
    ids = np.random.default_rng(2).integers(1, 256, (2, 7))
    kw = {}
    if eos:  # stop on a token row 0 emits mid-stream: rows pad with it
        first = engine.generate(jnp.asarray(ids), max_new_tokens=6)
        kw["eos_token_id"] = int(first[0, 9])
    ref = engine.generate(jnp.asarray(ids), max_new_tokens=6, **kw)
    out = port.generate(torch.from_numpy(ids), max_new_tokens=6, **kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert len(set(np.asarray(ref)[0, 7:].tolist())) > 1  # not one token


@pytest.mark.parametrize("top_k,top_p", [(5, 0.0), (0, 0.7), (8, 0.5)])
def test_sample_filtering_matches_jax(monkeypatch, top_k, top_p):
    """Temperature/top-k/top-p keep the same candidates with the same
    logits: the JAX sampler's categorical draw is intercepted to read the
    logits it samples from."""
    logits = np.random.default_rng(top_k).normal(size=(3, 40)) \
        .astype(np.float32) * 3
    seen = {}

    def capture(rng, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.zeros(lg.shape[:-1], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jax_sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0), 0.7, True,
                      top_k, top_p)
    ours = filter_logits(torch.from_numpy(logits), 0.7, top_k, top_p)
    np.testing.assert_array_equal(np.isfinite(ours.numpy()),
                                  np.isfinite(seen["logits"]))
    keep = np.isfinite(seen["logits"])
    np.testing.assert_allclose(ours.numpy()[keep], seen["logits"][keep],
                               rtol=1e-6)
    # draws land only on kept candidates
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = sample_logits(torch.from_numpy(logits), gen, 0.7, True, top_k,
                            top_p)
        assert keep[np.arange(3), tok.numpy()].all()


def test_cached_paths_match_full_forward(engines):
    """Append-cache and paged decode give the full forward's logits."""
    _, port, _ = engines
    model = port.module
    ids = torch.from_numpy(np.random.default_rng(4).integers(1, 256, (2, 9)))
    with torch.no_grad():
        full = model(ids)
        dm = port.mode_module(model.config.for_decode())
        cache = dm.new_cache(2)
        steps = [dm(ids[:, :6], cache=cache)]
        steps += [dm(ids[:, t:t + 1], cache=cache) for t in range(6, 9)]
        torch.testing.assert_close(torch.cat(steps, 1), full, atol=1e-5,
                                   rtol=1e-5)
        pm = port.mode_module(model.config.for_paged_decode(9, 8))
        pools = pm.new_cache(0)
        tables = torch.tensor([[3, 4, 0, 0], [1, 7, 0, 0]], dtype=torch.int32)
        pad = torch.zeros((2, 8), dtype=torch.long)
        pad[:, :5] = ids[:, :5]
        pre = pm(pad, cache=pools, paging={
            "block_tables": tables, "lengths": torch.zeros(2, dtype=torch.int32),
            "num_valid": torch.tensor([5, 5], dtype=torch.int32),
            "prefill": True})
        torch.testing.assert_close(pre[:, :5], full[:, :5], atol=1e-5,
                                   rtol=1e-5)
        step = pm(ids[:, 5:6], cache=pools, paging={
            "block_tables": tables, "lengths": torch.full((2,), 5,
                                                          dtype=torch.int32),
            "num_valid": torch.ones(2, dtype=torch.int32), "prefill": False})
        torch.testing.assert_close(step[:, 0], full[:, 5], atol=1e-5,
                                   rtol=1e-5)


def test_seeded_init_matches_jax_init_scales():
    a = GPT2LMHeadModel(GPT2Config.tiny(), seed=3).state_dict()
    b = GPT2LMHeadModel(GPT2Config.tiny(), seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert abs(a["wte"].std().item() - 0.02) < 0.002
    assert abs(a["wpe"].std().item() - 0.01) < 0.001
    assert torch.equal(a["h.0.ln_1.weight"], torch.ones(64))
    assert torch.equal(a["h.1.attn.c_attn.bias"], torch.zeros(192))


def test_unported_generate_options_raise(engines):
    """generate(attention_mask=) is ported (tests/test_torch_padded_
    generate.py): an all-real mask is the unpadded call, greedy or keyed,
    and a malformed mask raises the JAX package's ValueError, not
    NotImplementedError."""
    _, port, _ = engines
    ids = torch.ones((1, 4), dtype=torch.long)
    for kw in ({}, {"do_sample": True, "seed": 1}):
        assert torch.equal(
            port.generate(ids, max_new_tokens=2,
                          attention_mask=torch.ones(1, 4), **kw),
            port.generate(ids, max_new_tokens=2, **kw))
        with pytest.raises(ValueError, match="LEFT-padded"):
            port.generate(ids, max_new_tokens=2,
                          attention_mask=torch.tensor([[1, 1, 1, 0]]), **kw)
