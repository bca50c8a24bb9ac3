"""Data-parallel inference on a ``data x tp`` mesh against the JAX engine.

The port runs ``init_inference(tensor_parallel={"tp_size": 2})`` on 4
gloo ranks (``data=2 x tp=2``) and at ``tp_size`` 1 on 2 ranks
(``data=2``): ``tests/torch_ranks.py:dp_inference``, inside the
tensor-parallel spawns of ``tests/test_torch_tensor_parallel.py`` (one
spawn a world size for the whole run). The JAX engine runs on the
conftest's 8 CPU devices at the same tp (``data`` fills the rest), on the
same weights and the same numpy prompts.

- greedy and keyed ``generate`` at B=4 and at B=3, which does not
  divide over ``data``; left-padded ``generate``, keyed too, and with
  prompt bucketing (a ``serving`` section); B=1 (one data rank has no
  real row): tokens equal JAX's, on every rank;
- ``forward`` logits within 1e-5 of JAX's, and bit-equal on every rank;
- each rank's kernel paths (the flash forward and the append decode,
  through their plain versions) saw at most its share of the rows:
  ``ceil(B / data)``;
- the serving engine on the mesh (every data group serves the same
  submits) gives the JAX serving engine's tokens at tp 2;
- the tiny GQA Llama at tp 2 on ``data=2``: tokens and logits as JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.models.gpt2 import GPT2Config as JaxConfig
from deepspeed_tpu.models.gpt2 import GPT2LMHeadModel as JaxModel
from deepspeed_tpu.parallel.topology import reset_topology
from tests import torch_ranks
from tests.test_torch_llama import weights as llama_weights
from tests.test_torch_tensor_parallel import (_jax_generate, _tp1,  # noqa
                                              flax_params, jax_tp, ranks,
                                              weights, wide3, wide3_flax)
from tests.torch_ranks import (DP_KNOBS, DP_SERVING, TP_PAGED, dp_inputs)

LOGITS_ATOL = 1e-5
CASES = ("greedy4", "greedy3", "keyed4", "keyed3", "padded3",
         "keyed_padded3", "one_row", "bucketed3")


def _jax_dp(flax_params):
    """The JAX engines' results at tp 2 and tp 1 on the 8 devices."""
    ids4, ids3, (pad, mask) = dp_inputs()
    cfg = JaxConfig.tiny(dtype=jnp.float32)
    out = {}
    for tp in (2, 1):
        reset_topology()
        eng = deepspeed_tpu.init_inference(
            JaxModel(cfg), dtype="fp32", params=flax_params,
            tensor_parallel={"tp_size": tp})
        res = {"data": eng.topo.axis_size("data"),
               "greedy4": _jax_generate(eng, ids4, 6),
               "greedy3": _jax_generate(eng, ids3, 6),
               "keyed4": _jax_generate(eng, ids4, 6, do_sample=True,
                                       **DP_KNOBS),
               "keyed3": _jax_generate(eng, ids3, 6, do_sample=True,
                                       **DP_KNOBS),
               "padded3": _jax_generate(eng, pad, 6, mask),
               "keyed_padded3": _jax_generate(eng, pad, 6, mask,
                                              do_sample=True, **DP_KNOBS),
               "one_row": _jax_generate(eng, ids3[:1], 6),
               "logits3": np.asarray(eng.forward(jnp.asarray(ids3)))}
        reset_topology()
        bucketed = deepspeed_tpu.init_inference(
            JaxModel(cfg), dtype="fp32", params=flax_params,
            serving=DP_SERVING, tensor_parallel={"tp_size": tp})
        res["bucketed3"] = _jax_generate(bucketed, pad, 6, mask)
        out[tp] = res
    reset_topology()
    lcfg = jax_llama.LlamaConfig.tiny(dtype=jnp.float32,
                                      num_key_value_heads=2)
    leng = deepspeed_tpu.init_inference(
        jax_llama.LlamaModel(lcfg), dtype="fp32", params=llama_weights(2),
        tensor_parallel={"tp_size": 2})
    out[2]["llama_greedy3"] = _jax_generate(leng, ids3, 6)
    out[2]["llama_logits3"] = np.asarray(leng.forward(jnp.asarray(ids3)))
    reset_topology()
    return out


@pytest.fixture(scope="module")
def jax_dp(tmp_path_factory, flax_params):
    return torch_ranks.cached(tmp_path_factory, "dp-inference-jax",
                              lambda d: _jax_dp(flax_params))


def _port(ranks, world):
    key = "dp_tp2" if world == 4 else "dp_tp1"
    return [r[key] for r in ranks(world)]


@pytest.mark.parametrize("world,tp", [(4, 2), (2, 1)])
def test_the_mesh_fills_data_like_jax(ranks, jax_dp, world, tp):
    """tp groups are contiguous ranks, data groups strided."""
    port = _port(ranks, world)
    for rank, res in enumerate(port):
        assert res["shape"]["tp"] == tp and res["shape"]["data"] == 2
        assert res["coord"] == (rank // tp, rank % tp)
    assert jax_dp[tp]["data"] == 8 // tp


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world,tp", [(4, 2), (2, 1)])
def test_generate_matches_jax_on_every_rank(ranks, jax_dp, world, tp, case):
    for res in _port(ranks, world):
        assert res[case] == jax_dp[tp][case], case


@pytest.mark.parametrize("world,tp", [(4, 2), (2, 1)])
def test_logits_match_jax_and_ranks_are_bit_equal(ranks, jax_dp, world, tp):
    port = _port(ranks, world)
    np.testing.assert_allclose(port[0]["logits3"], jax_dp[tp]["logits3"],
                               atol=LOGITS_ATOL, rtol=0)
    for res in port[1:]:
        assert np.array_equal(res["logits3"], port[0]["logits3"])


@pytest.mark.parametrize("world", [4, 2])
def test_each_rank_computes_only_its_rows(ranks, world):
    """ceil(B / data) rows at most (B=4 and B=3: 2, B=1: 1 with a copy on
    the rank that has no real row), and every call timed."""
    for res in _port(ranks, world):
        assert res["rows"] == [1, 2]
        assert res["model_times"] == 8


@pytest.mark.parametrize("world", [4, 2])
def test_serving_on_the_mesh_matches_jax(ranks, jax_tp, weights, world):
    """Every data group serves the same submit: JAX's tokens at tp 2, the
    port's group-less tokens at tp 1."""
    want = (jax_tp[2]["paged"] if world == 4 else
            _one_request_tp1(weights))
    for res in _port(ranks, world):
        assert res["served"] == want


def _one_request_tp1(weights):
    srv = _tp1(weights, TP_PAGED)
    req = srv.submit([11, 23, 42, 7], max_new_tokens=8)
    srv.drain()
    return req.tokens


def test_gqa_llama_matches_jax(ranks, jax_dp):
    for res in _port(ranks, 4):
        assert res["llama_greedy3"] == jax_dp[2]["llama_greedy3"]
        np.testing.assert_allclose(res["llama_logits3"],
                                   jax_dp[2]["llama_logits3"],
                                   atol=LOGITS_ATOL, rtol=0)
