"""Tensor-parallel inference and serving in the port against the JAX
package, on the CPU.

The JAX engines run in this process at ``tensor_parallel.tp_size`` 2 and
4 on the conftest's virtual CPU devices; the port runs on 2 and 4 gloo
ranks (``tests/torch_ranks.py:tensor_parallel``, one spawn a world size,
shared by the test workers), every rank calling ``init_inference`` /
``init_serving`` with the same arguments on a tiny fp32 GPT-2 (vocab 256,
width 64, 2 layers, 4 heads), its weights from ``random_flax_params``
carried across by ``params_from_jax``.

- (a) ``column_parallel_linear``, ``row_parallel_linear``,
  ``injected_mlp`` and the two layer modules on 2 and 4 ranks against
  the JAX functions on a tp mesh and the dense products, within 2e-5;
  the int8 tier raises naming [9].
- (b) each rank's ``c_attn`` slices are JAX's ``shard_qkv_for_tp``,
  transposed, and ``shard_for_rank``'s; ``param_shardings`` split the
  JAX engine's parameters on the same (logical) dims.
- (c)-(d) greedy ``generate`` at tp 2 and 4, keyed and padded at tp 2,
  paged serving (pools at 2 heads a rank) and keyed sampled serving at
  tp 2 give the JAX engine's tokens at the same tp.
- (e) the fast path at tp 2 (prefix cache + 8-token chunks + int8 KV;
  speculative k = 4) gives the port's tp 1 tokens and the JAX engine's
  at tp 2.
- (f) every rank returns the same tokens; 2 * n_layer all-reduces a
  forward plus the vocabulary's pair; at 3 heads over 2 ranks attention
  stays whole while the MLP splits, with the tokens of the port's tp 1
  and of the JAX engine at tp 2.
- (g) a world of 4 at tp 3 raises the JAX mesh's error (tp 2 there is
  ``data=2 x tp=2``: ``tests/test_torch_dp_inference.py``); an explicit
  one-rank mesh serves alone in a world of 4; tp 2 without a process
  group raises.
- The fused-QKV split and merge round trip, and sharding then merging a
  whole state dict.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxConfig
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JaxModel
from deepspeed_tpu.module_inject import injected_mlp as jax_mlp
from deepspeed_tpu.module_inject import column_parallel_linear as jax_column
from deepspeed_tpu.module_inject import row_parallel_linear as jax_row
from deepspeed_tpu.parallel.topology import MeshTopology as JaxMesh
from deepspeed_tpu.parallel.topology import reset_topology
from deepspeed_tpu.runtime import state_dict_factory as jax_sdf
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.utils.pytree import flatten_with_path_strings
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.module_inject import (decode_cache_specs,
                                               shard_params_with_policy,
                                               tp_all_reduce)
from deepspeed_tpu_torch.parallel import topology as port_topo
from deepspeed_tpu_torch.runtime.state_dict_factory import (
    merge_qkv_tp_shards, shard_qkv_for_tp)
from deepspeed_tpu_torch.utils.params import params_from_jax, shard_for_rank
from tests import torch_ranks
from tests.test_torch_gpt2 import jax_engine, random_flax_params
from tests.torch_ranks import (TP_FAST, TP_KNOBS, TP_PAGED, TP_SAMP, TP_SPEC,
                               tp_fast_stream, tp_generate_inputs)

WORLDS = (2, 4)
TOL = 2e-5


def _plain(tree):
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _layers():
    rng = np.random.default_rng(1)

    def arr(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    return {"x": arr(4, 64), "w_in": arr(64, 256, scale=0.05),
            "b_in": arr(256, scale=0.05), "w_out": arr(256, 64, scale=0.05),
            "b_out": arr(64, scale=0.05), "h": arr(4, 256)}


@pytest.fixture(scope="module")
def flax_params():
    return _plain(jax_engine(seed=0)[1])


@pytest.fixture(scope="module")
def weights(flax_params):
    return params_from_jax(flax_params, GPT2Config.tiny(dtype=torch.float32))


WIDE3 = dict(n_embd=96, n_head=3)


@pytest.fixture(scope="module")
def wide3_flax():
    """The 3-head model's flax params (width 96, so 3 heads of 32 do not
    divide over 2 ranks)."""
    reset_topology()
    eng = deepspeed_tpu.init_inference(
        JaxModel(JaxConfig.tiny(dtype=jnp.float32, **WIDE3)), dtype="fp32",
        seed=3)
    return _plain(random_flax_params(jax.device_get(eng.params), 3))


@pytest.fixture(scope="module")
def wide3(wide3_flax):
    return params_from_jax(wide3_flax,
                           GPT2Config.tiny(dtype=torch.float32, **WIDE3))


_RANKS = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights, wide3):
    """``world -> [rank results]`` of :func:`torch_ranks.tensor_parallel`,
    one spawn a world size for the whole run."""
    def get(world):
        if world not in _RANKS:
            from tests.test_torch_llama import weights as llama_weights

            # the tiny GQA Llama of tests/test_torch_dp_inference.py
            args = {"weights": weights, "wide3": wide3, "layers": _layers(),
                    "llama": {"kv": 2, "weights": llama_weights(2)}}
            _RANKS[world] = torch_ranks.cached(
                tmp_path_factory, f"tensor-parallel-{world}",
                lambda d: torch_ranks.run_ranks(torch_ranks.tensor_parallel,
                                                world, d / f"tp{world}",
                                                args))
        return _RANKS[world]
    return get


def _jax_generate(engine, ids, n, mask=None, **kw):
    out = engine.generate(jnp.asarray(ids), max_new_tokens=n,
                          attention_mask=None if mask is None
                          else jnp.asarray(mask), **kw)
    return np.asarray(out)[:, np.asarray(ids).shape[1]:].tolist()


def _jax_specs(engine):
    """``{port name: split dim in the port's order}`` of the JAX engine's
    ``param_shardings`` (the layer-stacked leaves unstacked; a Dense
    kernel's dims reversed)."""
    out = {}
    flat, _ = flatten_with_path_strings(engine.param_shardings)
    for path, sharding in flat:
        spec = tuple(sharding.spec)
        parts = path.split("/")
        if parts[0] == "transformer":
            parts = parts[1:]
        layers = [None]
        if parts[0] == "h":          # scanned: [layer, ...] leaves
            parts, layers = parts[2:], range(engine.model_config.n_layer)
            spec = spec[1:]
        elif parts[0].startswith("h_"):
            layers, parts = [int(parts[0][2:])], parts[1:]
        leaf = parts[-1]
        name = ".".join(parts[:-1] + [{"kernel": "weight", "scale": "weight"}
                                      .get(leaf, leaf)])
        dim = next((i for i, e in enumerate(spec) if e is not None), None)
        if dim is not None and leaf == "kernel":
            dim = 1 - dim
        for i in layers:
            out[name if i is None else f"h.{i}.{name}"] = dim
    return out


def _jax_serve(cfg, params, serving, run):
    """``run(srv)`` on a fresh JAX serving engine at tp 2."""
    reset_topology()
    srv = JaxServingEngine(deepspeed_tpu.init_inference(
        JaxModel(cfg), dtype="fp32", params=params, serving=serving,
        tensor_parallel={"tp_size": 2}))
    try:
        return run(srv)
    finally:
        srv.destroy()


def _one_request(prompt, **kw):
    def run(srv):
        req = srv.submit(prompt, **kw)
        srv.drain()
        return [int(t) for t in req.tokens]
    return run


def _jax_results(flax_params, wide3_flax):
    """The JAX engines' tokens and specs at tp 2 and 4, each engine used
    while its mesh is the job's."""
    greedy, keyed, (pad_ids, pad_mask) = tp_generate_inputs()
    cfg = JaxConfig.tiny(dtype=jnp.float32)
    out = {}
    for tp in WORLDS:
        reset_topology()
        eng = deepspeed_tpu.init_inference(
            JaxModel(cfg), dtype="fp32", params=flax_params,
            tensor_parallel={"tp_size": tp})
        assert eng.mp_world_size == tp
        out[tp] = {"greedy": _jax_generate(eng, greedy, 6),
                   "specs": _jax_specs(eng)}
        if tp == 2:
            out[tp]["keyed"] = _jax_generate(eng, keyed, 6, do_sample=True,
                                             **TP_KNOBS)
            out[tp]["padded"] = _jax_generate(eng, pad_ids, 6, pad_mask)
    out[2]["paged"] = _jax_serve(cfg, flax_params, TP_PAGED, _one_request(
        [11, 23, 42, 7], max_new_tokens=8))
    out[2]["sampled"] = _jax_serve(cfg, flax_params, TP_SAMP, _one_request(
        [5, 17, 42, 9], max_new_tokens=4, do_sample=True, seed=7,
        temperature=0.8, top_p=0.9))
    for key, serving in (("fast", TP_FAST), ("spec", TP_SPEC)):
        out[2][key] = _jax_serve(
            cfg, flax_params, serving,
            lambda srv: [[int(t) for t in r] for r in tp_fast_stream(srv)])
    reset_topology()
    eng3 = deepspeed_tpu.init_inference(
        JaxModel(JaxConfig.tiny(dtype=jnp.float32, **WIDE3)), dtype="fp32",
        params=wide3_flax, tensor_parallel={"tp_size": 2})
    out[2]["wide3"] = _jax_generate(eng3, greedy, 6)
    reset_topology()
    return out


@pytest.fixture(scope="module")
def jax_tp(tmp_path_factory, flax_params, wide3_flax):
    return torch_ranks.cached(tmp_path_factory, "tensor-parallel-jax",
                              lambda d: _jax_results(flax_params,
                                                     wide3_flax))


def _tp1(weights, serving):
    port_topo.reset_topology()
    model = GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32),
                            device="meta")
    model.load_state_dict(weights, assign=True)
    return deepspeed_tpu_torch.init_serving(model, dtype="fp32",
                                            device="cpu", serving=serving)


# ---------------------------------------------------------------------------
# (a) the layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
def test_layers_match_jax_and_dense(ranks, world):
    lay = _layers()
    mesh = JaxMesh(axis_sizes={"tp": world},
                   devices=jax.devices()[:world]).mesh
    x, w_in, b_in, w_out, b_out, h = (jnp.asarray(lay[k]) for k in (
        "x", "w_in", "b_in", "w_out", "b_out", "h"))
    column = np.asarray(jax_column(x, w_in, b_in, mesh))
    row = np.asarray(jax_row(h, w_out, b_out, mesh))
    mlp = np.asarray(jax_mlp(x, w_in, b_in, w_out, b_out, mesh))
    gelu = np.asarray(jax.nn.gelu(x @ w_in + b_in, approximate=True))
    np.testing.assert_allclose(column, lay["x"] @ lay["w_in"] + lay["b_in"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(mlp, gelu @ lay["w_out"] + lay["b_out"],
                               rtol=TOL, atol=TOL)
    res = [r["layers"] for r in ranks(world)]
    np.testing.assert_allclose(np.concatenate([r["column"] for r in res],
                                              axis=-1), column,
                               rtol=TOL, atol=TOL)
    for r in res:
        np.testing.assert_allclose(r["row"], row, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["row_nobias"], row - lay["b_out"],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["mlp"], mlp, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(r["modules"], mlp, rtol=TOL, atol=TOL)


def test_tp_all_reduce_tiers():
    x = torch.ones(3)
    assert tp_all_reduce(x, None) is x
    with pytest.raises(NotImplementedError, match=r"\[9\]"):
        tp_all_reduce(x, None, comm_dtype="int8")
    with pytest.raises(ValueError, match="'none' or 'int8'"):
        tp_all_reduce(x, None, comm_dtype="1bit")


# ---------------------------------------------------------------------------
# (b) slices and specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
def test_rank_slices_are_jax_shard_qkv(ranks, flax_params, weights, world):
    layer = flax_params["transformer"]["h"]["block"]["attn"]["c_attn"]
    for rank, res in enumerate(ranks(world)):
        for i in range(2):
            kernel = np.asarray(layer["kernel"][i])      # [C, 3C]
            bias = np.asarray(layer["bias"][i])
            want_w = jax_sdf.shard_qkv_for_tp(kernel, world, rank).T
            want_b = jax_sdf.shard_qkv_for_tp(bias, world, rank)
            local = res["local"]
            np.testing.assert_array_equal(
                local[f"h.{i}.attn.c_attn.weight"], want_w)
            np.testing.assert_array_equal(
                local[f"h.{i}.attn.c_attn.bias"], want_b)
        assert res["local"].keys() == res["shard_for_rank"].keys()
        for name, t in res["local"].items():
            np.testing.assert_array_equal(t, res["shard_for_rank"][name])
        assert res["mp_world_size"] == world


@pytest.mark.parametrize("world", WORLDS)
def test_tp_group_queries(ranks, world):
    """``utils.groups`` and ``comm`` answer from the engine's tp mesh."""
    for rank, res in enumerate(ranks(world)):
        assert res["groups"] == (world, rank, world, rank,
                                 list(range(world)), list(range(world)))


@pytest.mark.parametrize("world", WORLDS)
def test_param_shardings_match_jax(ranks, jax_tp, world):
    want = jax_tp[world]["specs"]
    got = {name: None if spec is None else
           next(i for i, e in enumerate(spec) if e is not None)
           for name, spec in ranks(world)[0]["specs"].items()}
    assert got == want
    assert {n for n, d in got.items() if d is not None} >= {
        "wte", "h.0.attn.c_attn.weight", "h.0.mlp.c_fc.weight",
        "h.1.attn.c_proj.weight", "h.1.mlp.c_proj.weight"}


# ---------------------------------------------------------------------------
# (c)-(d) generate and serving against the JAX engines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world,key", [(2, "greedy"), (4, "greedy"),
                                       (2, "keyed"), (2, "padded")])
def test_generate_matches_jax_engine(ranks, jax_tp, world, key):
    want = jax_tp[world][key]
    for res in ranks(world):
        assert res[key] == want


def test_paged_serving_matches_jax_tp2_with_sharded_pools(ranks, jax_tp):
    """``test_spec_layout.py``'s tp=2 paged serving: the JAX tokens, each
    rank's pools at 2 of the 4 heads, ``stats()["tp"]``."""
    for res in ranks(2):
        assert res["paged"] == jax_tp[2]["paged"]
        assert res["paged_pools"] and all(
            shape[2] == 2 for shape in res["paged_pools"])
        assert res["paged_stats_tp"] == 2
    specs = decode_cache_specs({"keys.0": (17, 8, 4, 16),
                                "key_scales.0": (17, 8, 4, 1),
                                "index": ()}, 2)
    assert specs == {"keys.0": (None, None, "tp", None),
                     "key_scales.0": (None, None, "tp", None),
                     "index": None}


def test_sampled_serving_matches_jax_tp2(ranks, jax_tp):
    """``test_sampling.py``'s keyed request on a tp=2 serving engine."""
    for res in ranks(2):
        assert res["sampled"] == jax_tp[2]["sampled"]


# ---------------------------------------------------------------------------
# (e)-(g)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key,serving", [("fast", TP_FAST),
                                         ("spec", TP_SPEC)])
def test_fast_path_matches_tp1(ranks, weights, key, serving):
    want = tp_fast_stream(_tp1(weights, serving))
    for res in ranks(2):
        assert res[key] == want
    if key == "fast":
        pools = ranks(2)[0]["fast_pools"]
        # int8 codes and their fp32 scales, 2 heads a rank
        assert {s[2] for s in pools} == {2} and len(pools) == 8


@pytest.mark.parametrize("key", ["fast", "spec"])
def test_fast_path_matches_jax_tp2(ranks, jax_tp, key):
    """Prefix cache + 8-token chunks + int8 KV, and speculative k = 4, on
    the JAX serving engine at tp 2: the same tokens."""
    for res in ranks(2):
        assert res[key] == jax_tp[2][key]


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_agree_and_reduce_twice_a_layer(ranks, world):
    res = ranks(world)
    for key in ("greedy", "keyed", "padded", "paged", "sampled", "fast",
                "spec", "wide3"):
        if key in res[0]:
            assert all(r[key] == res[0][key] for r in res), key
    # 2 * n_layer row-parallel sums and the vocab-parallel embedding's;
    # the head's logits all-gathered
    assert res[0]["forward_counts"] == {"all_reduce": 5, "all_gather": 1}


def test_heads_that_do_not_divide_keep_attention_whole(ranks, wide3):
    res = ranks(2)[0]["wide3"]
    assert res["shapes"]["h.0.attn.c_attn.weight"] == (288, 96)
    assert res["shapes"]["h.0.attn.c_proj.weight"] == (96, 96)
    assert res["shapes"]["h.0.mlp.c_fc.weight"] == (192, 96)
    assert res["shapes"]["h.0.mlp.c_proj.weight"] == (96, 192)
    assert res["cache_heads"] == 3
    port_topo.reset_topology()
    model = GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32, **WIDE3),
                            device="meta")
    model.load_state_dict(wide3, assign=True)
    tp1 = deepspeed_tpu_torch.init_inference(model, dtype="fp32",
                                             device="cpu")
    greedy = tp_generate_inputs()[0]
    out = tp1.generate(torch.from_numpy(greedy), max_new_tokens=6)
    assert res["greedy"] == out[:, greedy.shape[1]:].tolist()


def test_heads_that_do_not_divide_match_jax_tp2(ranks, jax_tp):
    """The 3-head model on the JAX engine at tp 2 (its attention wrappers
    take the plain call): the same tokens on every rank."""
    for res in ranks(2):
        assert res["wide3"]["greedy"] == jax_tp[2]["wide3"]


def test_tp2_on_a_world_of_4_names_the_fleet(ranks):
    """tp 2 on a world of 4 now runs as data=2 x tp=2; the refusal that
    stands is a world tp does not divide, with the JAX mesh's text."""
    from deepspeed_tpu.parallel.topology import MeshTopology

    with pytest.raises(ValueError) as jax_err:
        MeshTopology(axis_sizes={"tp": 3}, devices=jax.devices()[:4])
    for res in ranks(4):
        assert res["tp2_on_world4"] == str(jax_err.value)
        assert res["dp_tp2"]["shape"]["data"] == 2


def test_tp1_serves_alone_in_a_larger_world(ranks, weights):
    """An explicit one-rank mesh under a running group of 4 ranks: each
    rank serves the whole model alone, with the tokens of a group-less
    engine."""
    port_topo.reset_topology()
    model = GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32),
                            device="meta")
    model.load_state_dict(weights, assign=True)
    greedy = tp_generate_inputs()[0]
    want = deepspeed_tpu_torch.init_inference(
        model, dtype="fp32", device="cpu").generate(
            torch.from_numpy(greedy), max_new_tokens=6)
    for res in ranks(4):
        assert res["tp1_on_world4"] == (
            want[:, greedy.shape[1]:].tolist(), 1)


def test_tp_without_a_process_group_raises(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    model = GPT2LMHeadModel(GPT2Config.tiny(dtype=torch.float32))
    with pytest.raises(RuntimeError, match="init_distributed"):
        deepspeed_tpu_torch.init_inference(model, dtype="fp32", device="cpu",
                                           tensor_parallel={"tp_size": 2})


# ---------------------------------------------------------------------------
# the fused-QKV split and merge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
def test_merge_of_qkv_shards_is_the_whole_c_attn(weights, world):
    for name in ("h.0.attn.c_attn.weight", "h.1.attn.c_attn.bias"):
        full = weights[name]
        shards = [shard_qkv_for_tp(full, world, r, out_axis=0)
                  for r in range(world)]
        torch.testing.assert_close(merge_qkv_tp_shards(shards, out_axis=0),
                                   full, rtol=0, atol=0)
        flax = full.numpy().T if full.dim() == 2 else full.numpy()
        for r, shard in enumerate(shards):
            want = jax_sdf.shard_qkv_for_tp(flax, world, r)
            np.testing.assert_array_equal(
                shard.numpy(), want.T if full.dim() == 2 else want)
        np.testing.assert_array_equal(
            merge_qkv_tp_shards([s.T for s in shards]).numpy()
            if full.dim() == 2 else merge_qkv_tp_shards(shards).numpy(),
            jax_sdf.merge_qkv_tp_shards(
                [jax_sdf.shard_qkv_for_tp(flax, world, r)
                 for r in range(world)]))


@pytest.mark.parametrize("world", WORLDS)
def test_shard_then_merge_is_the_identity(weights, world):
    cfg = GPT2Config.tiny(dtype=torch.float32)
    specs = GPT2LMHeadModel(cfg, device="meta").tp_specs("auto", world)
    shards = [shard_for_rank(weights, cfg, r, world) for r in range(world)]
    again, _ = shard_params_with_policy(weights, "auto", 1, world,
                                        specs=specs)
    for name, t in again.items():
        torch.testing.assert_close(t, shards[1][name], rtol=0, atol=0)
    for name, full in weights.items():
        parts = [s[name] for s in shards]
        spec = specs[name]
        if spec is None:
            merged = parts[0]
            assert all(p is full for p in parts)
        else:
            dim = next(i for i, e in enumerate(spec) if e is not None)
            merged = (merge_qkv_tp_shards(parts, out_axis=dim)
                      if ".c_attn." in name else torch.cat(parts, dim=dim))
        torch.testing.assert_close(merged, full, rtol=0, atol=0)
