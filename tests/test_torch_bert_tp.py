"""BERT under tensor parallelism in the port against the JAX package's, on
the CPU.

- Specs without weights: ``BertForMaskedLM.tp_specs`` equals JAX's
  ``specs_from_policy`` leaf for leaf (in the port's dim order) for every
  registered policy on the tiny model at tp 2 and 4, and for ``"auto"``
  and ``"bert"`` on BERT-large (4096 positions, on ``meta``): the
  vocabulary of 30522 splits at tp 2 and not at 4.
- Training: the port on 4 gloo ranks (programs on the ONE spawn of
  ``test_torch_tp_training.py``, ``tests/torch_ranks.py:bert_train``)
  against the JAX engine on 4 of the conftest's CPU devices, from the
  same weights (``bert_training_model_from_jax``) and global
  micro-batches (ids in [4, V), labels on 15 % of the tokens, -100
  elsewhere): the tiny fp32 BERT (``scan_layers=False`` on the JAX side,
  "dots" remat, Adam, clip 1.0), 3 steps. A ``{"tp": N}`` mesh fills
  ``data`` with the rest of the 4 ranks in both packages. Cases: the
  ``"auto"`` policy's mixed layout (split heads gathered before a whole
  ``output_dense``, the MLP whole), ``"bert"`` on ``{"data": 2, "tp":
  2}`` at ZeRO 0 and at ZeRO 3 with ``partition_activations``, ``{"fsdp":
  2, "tp": 2}`` at stage 2, the per-head ``fixed`` sparse section and
  ``bigbird`` with a padding mask (the masked path), ``{"tp": 4}`` (one
  head a rank, the vocabulary split 4 ways), a vocabulary of 258 (split
  at tp 2, whole at tp 4), 3 heads at tp 2 (attention whole on every
  rank, the MLP split), and ZeRO 3 on ``{"data": 2, "tp": 2}`` with 3
  rows a global micro-batch (rows that do not divide over ``data`` stay
  whole on every rank). After the steps, ``eval_batch`` on one more
  batch of the case's rows and on one of 3 rows (a last, partial batch)
  against JAX's ``eval_batch``. Tolerances are
  ``test_torch_tp_training.py``'s: losses, eval losses and pre-clip grad
  norms within 1e-5 relative; final parameters, gathered whole, 99.9 %
  within 1e-5 and all within ``2 * lr * steps``.
  Each rank's parameter and master shapes equal the JAX layout's shards
  (but for the 3-head case's attention: a deliberate difference), and
  each step's collectives equal the stage's plan plus the model's
  ``comm_plan``.
- On the same spawn (``torch_ranks.bert_tp_checks``):
  ``partition_activations`` bit-equal with one all-gather a layer a
  step; each rank's sparse layout the rows of its heads of the layout
  drawn at all heads; the ranks' losses and (a tp group's) decoder-bias
  gradients bit-equal; ``module_state_dict`` whole and re-sliced;
  ``eval_batch`` under ZeRO 3 and ``partition_activations`` against
  JAX's, and the state it leaves.
- In this process: ``shard_params_with_policy`` and
  ``gather_params_with_policy`` on BERT's separate query / key / value
  (no fused Q|K|V split), and the per-rank block lists of a whole model
  and a slice built in one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import deepspeed_tpu
from deepspeed_tpu.models import bert as jax_bert
from deepspeed_tpu.module_inject.policies import _POLICIES as JAX_POLICIES
from deepspeed_tpu.module_inject.policies import get_tp_policy as jax_policy
from deepspeed_tpu.module_inject.policies import specs_from_policy
from deepspeed_tpu.parallel.topology import MeshTopology as JaxMesh
from deepspeed_tpu.parallel.topology import reset_topology
from deepspeed_tpu.runtime.zero import partition as jax_part
from deepspeed_tpu.utils.pytree import flatten_with_path_strings
from deepspeed_tpu_torch.models import bert as port_bert
from deepspeed_tpu_torch.utils.params import bert_params_from_jax
from tests.test_torch_tp_training import tp_ranks
from tests.test_torch_zero import _mapped, _plain
from tests.torch_ranks import zero_config

LR, STEPS, RTOL = 6e-4, 3, 1e-5
T, SPARSE_T = 16, 64
FIXED = {"mode": "fixed", "block": 16, "different_layout_per_head": True,
         "num_local_blocks": 2, "num_global_blocks": 1,
         "attention": "bidirectional", "horizontal_global_attention": False,
         "num_different_global_patterns": 2}
BIGBIRD = {"mode": "bigbird", "block": 16, "num_random_blocks": 1,
           "num_sliding_window_blocks": 1, "num_global_blocks": 1,
           "different_layout_per_head": True}
# the layout checks' sections: at block 8 the fixed layout's 4 global
# patterns give each of the 4 heads its own rows
SPARSE = {"fixed": dict(FIXED, block=8, num_local_blocks=4,
                        num_different_global_patterns=4),
          "bigbird": BIGBIRD}
# name: (mesh, policy, ZeRO stage, model fields, sparse section, padding
# mask)
CASES = {
    "tp2-auto": ({"tp": 2}, "auto", 0, {}, None, False),
    "data2_tp2-bert-stage0": ({"data": 2, "tp": 2}, "bert", 0, {}, None,
                              False),
    "data2_tp2-bert-stage3-partition": (
        {"data": 2, "tp": 2}, "bert", 3, {"partition_activations": True},
        None, False),
    "fsdp2_tp2-bert-stage2": ({"fsdp": 2, "tp": 2}, "bert", 2, {}, None,
                              False),
    "tp2-fixed": ({"tp": 2}, "bert", 0, {}, FIXED, False),
    "tp2-bigbird-mask": ({"tp": 2}, "auto", 0, {}, BIGBIRD, True),
    "tp4-bert": ({"tp": 4}, "bert", 0, {}, None, False),
    "tp4-vocab258": ({"tp": 4}, "bert", 0, {"vocab_size": 258}, None,
                     False),
    "tp2-heads3": ({"tp": 2}, "bert", 0,
                   {"hidden_size": 96, "num_attention_heads": 3}, None,
                   False),
    "data2_tp2-bert-stage3-rows3": ({"data": 2, "tp": 2}, "bert", 3, {},
                                    None, False),
}
# the global micro-batch's rows where they are not 2 a data rank: 3 rows
# do not divide over data 2 and stay whole on every rank
ROWS = {"data2_tp2-bert-stage3-rows3": 3}
# eval_batch's rows besides the case's own: a last, partial batch
EVAL_ROWS = 3
SHAPE_CASES = ["tp2-auto", "data2_tp2-bert-stage3-partition",
               "fsdp2_tp2-bert-stage2", "tp4-bert", "tp4-vocab258"]
MODELS = {"base": {}, "vocab258": {"vocab_size": 258},
          "heads3": {"hidden_size": 96, "num_attention_heads": 3}}


def jax_config(**kw):
    return jax_bert.BertConfig.tiny(dtype=jnp.float32, scan_layers=False,
                                    **kw)


def bert_batches(rows, n, t=T, vocab=256, mask=False, seed=0):
    """``n`` global micro-batches of ``rows`` rows: ids, labels on 15 % of
    the tokens (-100 elsewhere), a padding mask on row 1."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(4, vocab, (rows, t)).astype(np.int32)
        labels = np.where(rng.random(ids.shape) < 0.15, ids,
                          -100).astype(np.int32)
        batch = {"input_ids": ids, "labels": labels}
        if mask:
            keep = np.ones_like(ids)
            keep[1, t // 2:] = 0
            batch["attention_mask"] = keep
        out.append(batch)
    return out


# bert_tp_checks' global micro-batches on {"data": 2, "tp": 2}
CHECK_BATCHES = bert_batches(4, 3, seed=7)


def case_run(name):
    """``(mesh, engine config, model fields, global batches, eval
    batches)`` of a case: ``STEPS`` training batches, and for
    ``eval_batch`` one more of the same rows and one of EVAL_ROWS."""
    mesh, policy, stage, fields, sparse, mask = CASES[name]
    zero = {"stage3_param_persistence_threshold": 0} if stage == 3 else {}
    config = {**zero_config(stage, optimizer="Adam", **zero),
              "tensor_parallel": {"policy": policy}}
    if sparse is not None:
        config["sparse_attention"] = sparse
    data = 4 // mesh.get("tp", 1) // mesh.get("fsdp", 1)
    shape = {"t": SPARSE_T if sparse else T,
             "vocab": fields.get("vocab_size", 256), "mask": mask}
    rows = ROWS.get(name, 2 * data)
    batches = bert_batches(rows, STEPS + 1, **shape)
    evals = batches[STEPS:] + bert_batches(EVAL_ROWS, 1, seed=1, **shape)
    return mesh, config, fields, batches[:STEPS], evals


_WEIGHTS = {}


def jax_weights(key):
    """The tiny JAX BERT's initial weights (plain numpy) of a model."""
    if key not in _WEIGHTS:
        model = jax_bert.BertForMaskedLM(jax_config(**MODELS[key]))
        _WEIGHTS[key] = _plain(jax.device_get(model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]))
    return _WEIGHTS[key]


def _key(fields):
    return ("vocab258" if "vocab_size" in fields else
            "heads3" if "num_attention_heads" in fields else "base")


def bert_programs():
    """This file's programs on the shared 4-rank spawn."""
    cases = {}
    for name in CASES:
        mesh, config, fields, batches, evals = case_run(name)
        cases[name] = {"mesh": mesh, "config": config, "batches": batches,
                       "evals": evals, "model": dict(fields),
                       "weights": jax_weights(_key(fields))}
    checks = {"weights": jax_weights("base"), "sparse": SPARSE,
              "seq": SPARSE_T, "batches": CHECK_BATCHES}
    from tests import torch_ranks

    return [("bert-train", torch_ranks.bert_train,
             {"cases": cases, "steps": STEPS}),
            ("bert-checks", torch_ranks.bert_tp_checks, checks)]


def jax_engine(mesh, config, fields):
    reset_topology()
    topo = JaxMesh(axis_sizes=mesh, devices=jax.devices()[:4])
    engine, *_ = deepspeed_tpu.initialize(
        model=jax_bert.BertForTraining(jax_config(
            remat=True, remat_policy="dots", **fields)),
        model_parameters=jax_weights(_key(fields)), mesh=topo,
        config=config)
    return engine


def jax_steps(engine, batches):
    """Losses and global grad norms of a training step on each batch."""
    losses, norms = [], []
    for batch in batches:
        loss = engine(batch)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
        norms.append(engine.get_global_grad_norm())
    return losses, norms


def jax_run(name):
    mesh, config, fields, batches, evals = case_run(name)
    engine = jax_engine(mesh, config, fields)
    losses, norms = jax_steps(engine, batches)
    evaluated = [float(engine.eval_batch(b)) for b in evals]
    return losses, norms, evaluated, jax.device_get(engine.state.params)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------
def port_name(path):
    """The port's name (``BertForMaskedLM``) of a JAX ``scan_layers=
    False`` tree path, and whether its spec is reversed (a Dense
    kernel)."""
    parts = path.split("/")
    if parts[1:2] == ["encoder"]:
        parts[2] = "layers." + parts[2][len("layer_"):]
    rev = parts[-1] == "kernel"
    parts[-1] = {"scale": "weight", "kernel": "weight"}.get(parts[-1],
                                                            parts[-1])
    return ".".join(parts), rev


_LEAVES = {}


def jax_leaves(large):
    if large not in _LEAVES:
        cfg = (jax_bert.BertConfig.bert_large(
            max_position_embeddings=4096, scan_layers=False) if large
            else jax_config())
        model = jax_bert.BertForMaskedLM(cfg)
        _LEAVES[large] = jax.eval_shape(
            lambda r: model.init(r, jnp.zeros((1, 8), jnp.int32))["params"],
            jax.random.PRNGKey(0))
    return _LEAVES[large]


SPEC_CASES = ([("tiny", p, t) for p in sorted(JAX_POLICIES) for t in (2, 4)]
              + [("large", p, t) for p in ("auto", "bert") for t in (2, 4)])


@pytest.mark.parametrize("size,policy,tp", SPEC_CASES,
                         ids=[f"{s}-{p}-tp{t}" for s, p, t in SPEC_CASES])
def test_tp_specs_match_jax_specs_from_policy(size, policy, tp):
    abstract = jax_leaves(size == "large")
    mesh = JaxMesh(axis_sizes={"tp": tp}, devices=jax.devices()[:tp]).mesh
    want = [("/".join(str(k.key) for k in path), spec) for path, spec in
            jax.tree_util.tree_flatten_with_path(
                specs_from_policy(jax_policy(policy), abstract, mesh),
                is_leaf=lambda x: x is None or isinstance(x, P))[0]]
    shapes, _ = flatten_with_path_strings(abstract)
    cfg = (port_bert.BertConfig.bert_large(max_position_embeddings=4096)
           if size == "large" else port_bert.BertConfig.tiny())
    got = port_bert.BertForMaskedLM(cfg, device="meta").tp_specs(policy, tp)
    assert len(got) == len(want) == len(shapes)
    split = set()
    for (path, spec), (_, leaf) in zip(want, shapes):
        name, rev = port_name(path)
        ndim = len(leaf.shape)
        mine = got[name]
        assert (None if mine is None else tuple(mine)) == (
            None if spec is None else _mapped(spec, rev, ndim)), name
        if mine is not None:
            split.add(name.rsplit(".", 2)[-2] if "layers" in name else name)
    vocab = "bert.word_embeddings" in split
    if policy in ("auto", "bert"):
        # 30522 splits 2 ways and not 4; the tiny 256 both
        assert vocab == (size == "tiny" or tp == 2)
        assert {"query", "key", "value"} <= split
        assert ({"output_dense", "intermediate", "output"} <= split) == (
            policy == "bert")


# ---------------------------------------------------------------------------
# training parity
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return tp_ranks(tmp_path_factory)


@pytest.mark.parametrize("case", list(CASES))
def test_training_matches_jax_engine(case, ranks):
    port = ranks["bert-train"]
    losses, norms, evaluated, params = jax_run(case)
    got = port[0][case]
    for r in port[1:]:  # every rank returns the same losses and norms
        for key in ("losses", "norms", "evals"):
            assert r[case][key] == got[key], key
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL)
    np.testing.assert_allclose(got["norms"], norms, rtol=RTOL)
    # eval_batch after the steps, on the case's rows and on EVAL_ROWS
    np.testing.assert_allclose(got["evals"], evaluated, rtol=RTOL)
    assert got["applied"]
    fields = CASES[case][3]
    want = bert_params_from_jax(params, port_bert.BertConfig.tiny(
        **{k: v for k, v in fields.items()
           if k != "partition_activations"}))
    diff = np.concatenate([np.abs(got["params"][f"model.{k}"] - v.numpy())
                           .ravel() for k, v in want.items()])
    assert (diff <= 1e-5).mean() >= 0.999
    assert diff.max() <= 2 * LR * STEPS
    for r in port:
        assert r[case]["counts"] == r[case]["plan"], case


@pytest.mark.parametrize("case", SHAPE_CASES)
def test_rank_shard_shapes_follow_the_layout(case, ranks):
    """Each rank's parameters and masters have the shard shapes of the
    JAX layout (tp base specs from the policy, ZeRO layered on them)."""
    mesh, config, *_ = case_run(case)
    stage = config["zero_optimization"]["stage"]
    topo = JaxMesh(axis_sizes=mesh, devices=jax.devices()[:4])
    layout = jax_part.SpecLayout(
        topo.mesh, policy=jax_policy(config["tensor_parallel"]["policy"]),
        persistence_threshold=0 if stage == 3 else 100_000)
    abstract = jax.eval_shape(lambda r: jax_bert.BertForMaskedLM(
        jax_config(**{k: v for k, v in CASES[case][3].items()
                      if k != "partition_activations"})).init(
        r, jnp.zeros((1, 8), jnp.int32))["params"], jax.random.PRNGKey(0))
    flat, _ = flatten_with_path_strings(abstract)
    for path, leaf in flat:
        shape = tuple(leaf.shape)
        name, rev = port_name(path)
        base = layout.base_spec(path, shape)
        specs = (layout.param_spec(shape, base, stage=stage),
                 layout.opt_spec(shape, base, stage=stage))
        pshard, oshard = (NamedSharding(topo.mesh, s).shard_shape(shape)
                          for s in specs)
        if rev:
            pshard, oshard = tuple(pshard[::-1]), tuple(oshard[::-1])
        for r in ranks["bert-train"]:
            got = r[case]
            assert got["param_shapes"][f"model.{name}"] == tuple(pshard), \
                name
            assert got["master_shapes"][f"model.{name}"] == \
                tuple(oshard), name


def test_indivisible_heads_keep_attention_whole(ranks):
    """3 heads at tp 2: q/k/v and ``output_dense`` whole on every rank
    (JAX's GSPMD splits their storage by columns: a deliberate
    difference), the MLP and the vocabulary split."""
    for r in ranks["bert-train"]:
        shapes = r["tp2-heads3"]["param_shapes"]
        p = "model.bert.encoder.layers.0."
        assert shapes[p + "attention.self.query.weight"] == (96, 96)
        assert shapes[p + "attention.output_dense.weight"] == (96, 96)
        assert shapes[p + "intermediate.weight"] == (64, 96)
        assert shapes[p + "output.weight"] == (96, 64)
        assert shapes["model.bert.word_embeddings"] == (128, 96)


def test_tp_group_decoder_bias_gradients_are_bit_equal(ranks):
    """Under a split vocabulary each rank adds only its slice of the
    replicated ``decoder_bias``; the all-gather of its gradient gives the
    ranks of a tp group the same whole gradient, bit for bit (rank r is
    tp rank r % tp)."""
    port = ranks["bert-train"]
    for case in ("data2_tp2-bert-stage0", "tp2-auto", "tp4-bert"):
        tp = CASES[case][0]["tp"]
        for rank, r in enumerate(port):
            lead = port[rank - rank % tp][case]["decoder_bias_grad"]
            got = r[case]["decoder_bias_grad"]
            assert got.shape == (256,) and np.abs(got).sum() > 0
            np.testing.assert_array_equal(got, lead)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def checks(ranks):
    return ranks["bert-checks"]


def test_partition_activations_is_bit_equal(checks):
    for r in checks:
        off, on = r["partition_False"], r["partition_True"]
        assert on["losses"] == off["losses"]
        layers = port_bert.BertConfig.tiny().num_hidden_layers
        assert on["counts"]["all_gather"] - off["counts"]["all_gather"] \
            == layers * len(on["losses"])
        assert on["plan"]["all_gather"] - off["plan"]["all_gather"] \
            == layers
        assert on["counts"]["all_reduce"] == off["counts"]["all_reduce"]


@pytest.mark.parametrize("mode", sorted(SPARSE))
def test_rank_layout_is_its_heads_of_the_whole_layout(checks, mode):
    """Drawn once at all 4 heads from the generator's first state (the
    random modes and per-head layouts included), rank r keeps rows
    [2r, 2r + 2)."""
    from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import \
        sparsity_config_from_dict

    section = dict(SPARSE[mode], attention="bidirectional")
    whole = sparsity_config_from_dict(section, 4).make_layout(SPARSE_T)
    assert (whole[:2] != whole[2:]).any()
    for rank, r in enumerate(checks):
        tp = rank % 2
        np.testing.assert_array_equal(r["layouts"][mode],
                                      whole[2 * tp:2 * tp + 2])
    # drawn at the rank's 2 heads instead, rank 1 would see other rows
    small = sparsity_config_from_dict(section, 2).make_layout(SPARSE_T)
    assert (small != whole[2:]).any()


def test_state_dict_is_whole_and_reslices(checks):
    whole = port_bert.BertForTraining(port_bert.BertConfig.tiny(),
                                      device="meta")
    for r in checks:
        sd = r["state_dict"]
        assert sd["shapes"] == {k: tuple(v.shape)
                                for k, v in whole.state_dict().items()}
        assert sd["zeroed"] == 0.0 and sd["reloaded"] == 0.0
        for key in ("word_embeddings", "query"):
            np.testing.assert_array_equal(sd[key],
                                          checks[0]["state_dict"][key])


def test_eval_batch_under_zero3_and_partitioned_activations(checks):
    """``eval_batch`` on ``{"data": 2, "tp": 2}`` at ZeRO 3 with
    ``partition_activations``, after one step: the JAX engine's
    ``eval_batch`` on the same weights, step and batch within 1e-5, on
    every rank; every parameter shard, master, optimizer slot, gradient
    and counter left as it was."""
    engine = jax_engine(
        {"data": 2, "tp": 2},
        {**zero_config(3, stage3_param_persistence_threshold=0),
         "tensor_parallel": {"policy": "bert"}},
        {"partition_activations": True})
    jax_steps(engine, CHECK_BATCHES[:1])
    want = float(engine.eval_batch(CHECK_BATCHES[1]))
    for r in checks:
        e = r["eval"]
        np.testing.assert_allclose(e["loss"], want, rtol=RTOL)
        assert e["params"] and e["masters"] and e["slots"] and e["grads"]
        assert e["counters"] == (1, 1)


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------
def test_policy_slicing_leaves_separate_qkv_alone():
    """BERT's query / key / value are sliced by plain chunks of their
    output rows (no per-Q/K/V fused split), and gathering the slices
    gives the whole state dict back."""
    from deepspeed_tpu_torch.module_inject import policies

    model = port_bert.BertForMaskedLM(port_bert.BertConfig.tiny(), seed=1)
    whole = model.state_dict()
    specs = model.tp_specs("bert", 2)
    slices = [policies.shard_params_with_policy(whole, "bert", r, 2,
                                                specs=specs)[0]
              for r in range(2)]
    name = "bert.encoder.layers.0.attention.self.value.weight"
    for r in range(2):
        torch.testing.assert_close(slices[r][name],
                                   whole[name][32 * r:32 * (r + 1)],
                                   rtol=0, atol=0)

    class Pair:  # the gather's all_gather over a "group" of two slices
        @staticmethod
        def all_gather(t, group=None):
            n = next(k for k, v in slices[0].items() if v is t)
            return torch.stack([s[n] for s in slices])

    import unittest.mock as mock
    with mock.patch("deepspeed_tpu_torch.comm.all_gather",
                    Pair.all_gather):
        back = policies.gather_params_with_policy(
            {k: v.contiguous() for k, v in slices[0].items()}, specs, None)
    for k, v in whole.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_slice_and_whole_model_keep_their_own_block_lists():
    """A whole model's layout (4 heads) and a rank's slice of it (2)
    build separate block lists in one process, each of its own rows."""
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bs

    section = tuple(sorted(dict(FIXED, block=16).items()))
    whole = port_bert._sparse_attn_for(section, 4, SPARSE_T)
    part = port_bert._sparse_attn_for(section, 4, SPARSE_T, heads=(2, 4))
    lw = bs.block_lists(whole._layout(SPARSE_T), "cpu")
    lp = bs.block_lists(part._layout(SPARSE_T), "cpu")
    assert lw is not lp
    assert lw.layout.shape[0] == 4 and lp.layout.shape[0] == 2
    torch.testing.assert_close(lp.layout, lw.layout[2:], rtol=0, atol=0)
