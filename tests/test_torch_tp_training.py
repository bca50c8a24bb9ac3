"""Tensor-parallel training in the port against the JAX package's, on the
CPU.

- Training: the port on 4 gloo ranks (``tests/torch_ranks.py``: one
  spawn runs every program of this file, shared by the test workers)
  against the JAX engine on 4 of the conftest's CPU devices, from the
  same weights and global micro-batches: the tiny fp32 GPT-2 (2 layers,
  width 64, 4 heads, vocab 256, ``scan_layers=False``, "dots" remat,
  AdamW, clip 1.0), 3 steps, on ``{"data": 2, "tp": 2}`` at ZeRO stages
  0-3 fused, stages 0 and 3 with 2 accumulation steps and LAMB at stage
  2, on ``{"fsdp": 2, "tp": 2}`` at stage 3, and on ``{"tp": 4}`` at
  stage 0 (one head a rank, the vocabulary split 4 ways: the
  vocab-parallel loss). Tolerances are ``test_torch_zero.py``'s: losses
  and pre-clip grad norms within 1e-5 relative; the final parameters,
  gathered whole from every rank's slices, 99.9 % within 1e-5 and all
  within ``2 * lr * steps``. Each rank's parameter and master shapes
  equal the JAX layout's shards, and the collectives each step launched
  equal the stage's plan plus the model's.
- On the same spawn: the f/g pair, the tiled gather and the
  vocab-parallel loss (dense and chunked head) on 2 ranks against the
  dense functions; ``partition_activations`` bit-equal to the run
  without it, with one all-gather a block a step; fp16 with an overflow
  in one tp rank's slice skips every rank; ``module_state_dict`` /
  ``load_module_state_dict``; ``zero.Init`` and ``GatheredParameters``
  under tp; the group queries; a model with no tensor-parallel form
  refused. The spawn also runs ``test_torch_bert_tp.py``'s programs.
  In this process: ``mesh.tp`` above 1 with no process group raises.
- ``mesh.dcn``: the port's rank -> coordinate map equals the device
  order of JAX's ``MeshTopology(dcn_axis_sizes=)`` on 8 CPU devices, and
  its errors are JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import NamedSharding

import deepspeed_tpu
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.parallel.topology import MeshTopology as JaxMesh
from deepspeed_tpu.parallel.topology import reset_topology
from deepspeed_tpu.runtime.zero import partition as jax_part
from deepspeed_tpu.utils.pytree import flatten_with_path_strings
from deepspeed_tpu_torch.models.gpt2 import GPT2Config
from deepspeed_tpu_torch.parallel import topology as port_topo
from deepspeed_tpu_torch.utils.params import params_from_jax
from tests import torch_ranks
from tests.test_torch_zero import _mapped, _plain, port_name
from tests.torch_ranks import zero_config

MESHES = {"data2_tp2": {"data": 2, "tp": 2},
          "fsdp2_tp2": {"fsdp": 2, "tp": 2}, "tp4": {"tp": 4}}
LR, STEPS, T, RTOL = 6e-4, 3, 16, 1e-5
THRESHOLD = 4096
RANKS_TIMEOUT = 900


def case_configs(mesh_name):
    zero = {"stage3_param_persistence_threshold": THRESHOLD}
    if mesh_name == "fsdp2_tp2":
        return {"stage3_fused": zero_config(3, **zero)}
    if mesh_name == "tp4":
        return {"stage0_fused": zero_config(0)}
    cases = {f"stage{s}_fused": zero_config(s, **zero) for s in range(4)}
    for s in (0, 3):
        cases[f"stage{s}_gas2"] = zero_config(s, gas=2, fused=False, **zero)
    cases["stage2_lamb"] = zero_config(2, optimizer="Lamb")
    return cases


ALL_CASES = [(m, c) for m in MESHES for c in case_configs(m)]


def jax_config(**kw):
    return jax_gpt2.GPT2Config.tiny(dtype=jnp.float32, scan_layers=False,
                                    **kw)


def global_batches(mesh, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (2 * mesh.get("data", 1), T))
            .astype(np.int32) for _ in range(n)]


_GPT2 = {}


def gpt2_params():
    """The tiny JAX GPT-2's initial weights (plain numpy)."""
    if not _GPT2:
        model = jax_gpt2.GPT2ForTraining(jax_config())
        _GPT2["params"] = _plain(jax.device_get(model.init(
            jax.random.PRNGKey(0), jnp.zeros((2, T), jnp.int32))["params"]))
    return _GPT2["params"]


@pytest.fixture(scope="module")
def jax_params():
    return gpt2_params()


def function_inputs():
    """Inputs of the f/g and loss checks (``torch_ranks._tp_functions``)."""
    rng = np.random.default_rng(5)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    labels = rng.integers(0, 16, 6)
    labels[2] = -100
    seq_labels = rng.integers(0, 16, (2, 7))
    seq_labels[:, -1] = -100
    return {"fg": {"x": f32(3, 5, 8), "w_in": f32(12, 8) / 3,
                   "w_out": f32(8, 12) / 3, "dy": f32(3, 5, 8),
                   "logits": f32(6, 16), "hidden": f32(2, 7, 8),
                   "wte": f32(16, 8)},
            "labels": labels, "seq_labels": seq_labels}


_PORT = {}


def tp_ranks(tmp_path_factory, jax_params=None):
    """Every program of this file and of ``test_torch_bert_tp.py`` on one
    spawn of 4 gloo ranks; ``{name: each rank's results}``."""
    if not _PORT:
        from tests.test_torch_bert_tp import bert_programs

        jax_params = gpt2_params() if jax_params is None else jax_params
        programs = [(f"train-{m}", torch_ranks.train, {
            "mesh": mesh, "cases": case_configs(m), "steps": STEPS,
            "batches": global_batches(mesh, 2 * STEPS),
            "weights": jax_params}) for m, mesh in MESHES.items()]
        programs.append(("checks", torch_ranks.tp_checks, {
            **function_inputs(), "weights": jax_params,
            "batches": global_batches(torch_ranks.TP_MESH, 3)}))
        programs += bert_programs()
        ranks = torch_ranks.cached(
            tmp_path_factory, "tp-training-ranks",
            lambda d: torch_ranks.run_ranks(
                torch_ranks.programs, 4, d / "tp-training", programs,
                timeout=RANKS_TIMEOUT))
        _PORT.update({name: [r[name] for r in ranks]
                      for name, _, _ in programs})
    return _PORT


def jax_run(mesh, config, jax_params):
    reset_topology()
    topo = JaxMesh(axis_sizes=mesh, devices=jax.devices()[:4])
    engine, *_ = deepspeed_tpu.initialize(
        model=jax_gpt2.GPT2ForTraining(jax_config(remat=True,
                                                  remat_policy="dots")),
        model_parameters=jax_params, mesh=topo, config=config)
    gas = config["gradient_accumulation_steps"]
    losses, norms = [], []
    for i, ids in enumerate(global_batches(mesh, 2 * STEPS)[:STEPS * gas]):
        loss = engine({"input_ids": ids})
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
        if (i + 1) % gas == 0:
            norms.append(engine.get_global_grad_norm())
    return losses, norms, jax.device_get(engine.state.params)


# ---------------------------------------------------------------------------
# training parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name,case", ALL_CASES,
                         ids=[f"{m}-{c}" for m, c in ALL_CASES])
def test_training_matches_jax_engine(mesh_name, case, jax_params,
                                     tmp_path_factory):
    ranks = tp_ranks(tmp_path_factory, jax_params)[f"train-{mesh_name}"]
    config = case_configs(mesh_name)[case]
    losses, norms, params = jax_run(MESHES[mesh_name], config, jax_params)
    got = ranks[0][case]
    for r in ranks[1:]:  # every rank returns the same loss and norm
        assert r[case]["losses"] == got["losses"]
        assert r[case]["norms"] == got["norms"]
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL)
    np.testing.assert_allclose(got["norms"], norms, rtol=RTOL)
    assert got["applied"]
    want = params_from_jax(params, GPT2Config.tiny())
    diff = np.concatenate([np.abs(got["params"][f"model.{k}"] - v.numpy())
                           .ravel() for k, v in want.items()])
    assert (diff <= 1e-5).mean() >= 0.999
    assert diff.max() <= 2 * LR * STEPS
    for r in ranks:
        assert r[case]["counts"] == r[case]["plan"], case


@pytest.fixture(scope="module")
def jax_leaves():
    model = jax_gpt2.GPT2ForTraining(jax_config())
    params = jax.eval_shape(lambda r: model.init(
        r, jnp.zeros((2, T), jnp.int32))["params"], jax.random.PRNGKey(0))
    flat, _ = flatten_with_path_strings(params)
    return [(path, tuple(leaf.shape)) for path, leaf in flat]


SHAPE_CASES = [("data2_tp2", "stage1_fused"), ("data2_tp2", "stage3_fused"),
               ("fsdp2_tp2", "stage3_fused"), ("tp4", "stage0_fused")]


@pytest.mark.parametrize("mesh_name,case", SHAPE_CASES,
                         ids=[f"{m}-{c}" for m, c in SHAPE_CASES])
def test_rank_shard_shapes_follow_the_layout(mesh_name, case, jax_params,
                                             jax_leaves, tmp_path_factory):
    """Each rank's parameters and masters have the shard shapes of the
    JAX layout (tp base specs from the policy, ZeRO layered on them)."""
    ranks = tp_ranks(tmp_path_factory, jax_params)[f"train-{mesh_name}"]
    stage = int(case[len("stage")])
    topo = JaxMesh(axis_sizes=MESHES[mesh_name], devices=jax.devices()[:4])
    layout = jax_part.SpecLayout(topo.mesh, persistence_threshold=THRESHOLD)
    for path, shape in jax_leaves:
        name, rev = port_name(path)
        base = layout.base_spec(path, shape)
        specs = (layout.param_spec(shape, base, stage=stage),
                 layout.opt_spec(shape, base, stage=stage))
        pshard, oshard = (NamedSharding(topo.mesh, s).shard_shape(shape)
                          for s in specs)
        if rev:
            pshard, oshard = tuple(pshard[::-1]), tuple(oshard[::-1])
        for r in ranks:
            assert r[case]["param_shapes"][name] == tuple(pshard), name
            assert r[case]["master_shapes"][name] == tuple(oshard), name
        if mesh_name == "tp4" and name.endswith("c_attn.weight"):
            assert _mapped(base, rev, 2) == ("tp", None)  # one head a rank


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def checks(tmp_path_factory, jax_params):
    return tp_ranks(tmp_path_factory, jax_params)["checks"]


def _leaves(*arrays):
    return [torch.from_numpy(a).clone().requires_grad_() for a in arrays]


@pytest.mark.parametrize("what", ["mlp", "gather", "xent", "chunked",
                                  "dense_head"])
def test_tp_functions_match_the_dense_ones(checks, what):
    """On each tp group of 2 ranks: outputs equal the dense function's,
    and each rank's gradients are the dense gradients' slices (the f/g
    pair sums the input's gradient where the dense function does)."""
    args = function_inputs()
    a = args["fg"]
    if what == "mlp":
        x, w_in, w_out = _leaves(a["x"], a["w_in"], a["w_out"])
        y = F.gelu(x @ w_in.T) @ w_out.T
        (y * torch.from_numpy(a["dy"])).sum().backward()
        want = [y, x.grad, w_in.grad, w_out.grad]
        cut = [None, None, 0, 1]
    elif what == "gather":
        (x,) = _leaves(a["x"])
        (x * torch.from_numpy(a["dy"])).sum().backward()
        want, cut = [x, x.grad], [None, -1]
    elif what == "xent":
        (logits,) = _leaves(a["logits"])
        labels = torch.from_numpy(args["labels"])
        loss = F.cross_entropy(logits, labels, ignore_index=-100)
        loss.backward()
        want, cut = [loss, logits.grad], [None, -1]
    else:
        hidden, wte = _leaves(a["hidden"], a["wte"])
        labels = torch.from_numpy(args["seq_labels"])
        loss = F.cross_entropy((hidden @ wte.T).reshape(-1, 16),
                               labels.reshape(-1), ignore_index=-100)
        loss.backward()
        want, cut = [loss, hidden.grad, wte.grad], [None, None, 0]
    for r in checks:
        got = r["functions"][what]
        for g, w, dim in zip(got, want, cut):
            w = w.detach()
            if dim is not None:
                w = w.chunk(2, dim)[r["tp_rank"]]
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-5, atol=1e-6)


def test_group_queries_on_a_training_mesh(checks):
    """``utils.groups`` on ``{"data": 2, "tp": 2}`` (rank = 2 * data +
    tp): the model- and tensor-parallel queries name the tp pair, the
    data-parallel ones the data pair."""
    for rank, r in enumerate(checks):
        tp, data = rank % 2, rank // 2
        pair = [2 * data, 2 * data + 1]
        assert r["groups"] == (2, tp, pair, 2, tp, pair, 2, [tp, tp + 2])


def test_models_without_a_tp_form_are_refused(checks):
    """A model with no ``with_tensor_parallel`` hook (a plain loss
    module) is refused at mesh.tp 2, the message naming the hook and the
    families that have it."""
    for r in checks:
        assert r["refused"].startswith("Probe has no tensor-parallel form")
        assert "with_tensor_parallel" in r["refused"]
        assert "BertForTraining" in r["refused"]


def test_tp_needs_a_process_group(monkeypatch):
    """mesh.tp above 1 with no process group (and no launcher's
    WORLD_SIZE) raises, as tensor-parallel inference does."""
    import os

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.gpt2 import GPT2ForTraining

    monkeypatch.setattr(comm, "is_initialized", lambda: False)
    monkeypatch.setattr(os, "environ", {k: v for k, v in os.environ.items()
                                        if k != "WORLD_SIZE"})
    with pytest.raises(RuntimeError, match="init_distributed"):
        deepspeed_tpu_torch.initialize(
            model=GPT2ForTraining(GPT2Config.tiny(), device="meta"),
            config={**zero_config(0), "mesh": {"tp": 2}}, device="cpu")


def test_partition_activations_is_bit_equal(checks):
    """Each rank keeps T / tp rows of each saved block input: the same
    losses bit for bit, n_layer all-gathers a step more, and the plan."""
    for r in checks:
        off, on = r["partition_False"], r["partition_True"]
        assert on["losses"] == off["losses"]
        assert on["counts"].get("all_gather", 0) == 2 * STEPS  # 2 layers
        assert off["counts"].get("all_gather", 0) == 0
        assert on["plan"]["all_gather"] == 2
        assert on["counts"]["all_reduce"] == off["counts"]["all_reduce"]


def test_one_tp_rank_overflow_skips_every_rank(checks):
    for r in checks:
        assert r["overflow"] == {"skipped": 1, "applied": False,
                                 "unchanged": True}


def test_state_dict_is_whole_and_reslices(checks, jax_params):
    """``module_state_dict`` gathers the whole tensors from the slices
    (the same on every rank); zeros loaded and the saved state reloaded
    re-slice into the parameters."""
    whole = params_from_jax(jax_params, GPT2Config.tiny())
    for r in checks:
        sd = r["state_dict"]
        assert sd["shapes"] == {f"model.{k}": tuple(v.shape)
                                for k, v in whole.items()}
        assert sd["zeroed"] == 0.0 and sd["reloaded"] == 0.0
        np.testing.assert_array_equal(sd["wte"], checks[0]["state_dict"]
                                      ["wte"])
        np.testing.assert_array_equal(sd["c_attn"], checks[0]["state_dict"]
                                      ["c_attn"])


def test_zero_init_and_gathered_parameters_under_tp(checks):
    """``zero.Init`` cuts the tp slice, then the ZeRO shard; an engine
    from it runs the step of an engine from the whole model. Inside
    ``GatheredParameters`` a tp-split parameter is its tp slice whole;
    a modifier's write reaches the slices of its tp coordinate."""
    from deepspeed_tpu_torch.runtime.state_dict_factory import \
        merge_qkv_tp_shards

    # the step's weights, whole: the tp slices seen inside (rank r is
    # tp rank r % 2)
    c_attn = merge_qkv_tp_shards([torch.from_numpy(checks[i]["zero_init"]
                                                   ["c_attn_inside"])
                                  for i in (0, 1)], out_axis=0).numpy()
    for r in checks:
        np.testing.assert_array_equal(
            r["zero_init"]["c_attn_inside"],
            checks[r["tp_rank"]]["zero_init"]["c_attn_inside"])
        z = r["zero_init"]
        assert z["init_shape"] == (96, 32)  # [3C / tp, C / data]
        (loss, norm), (whole_loss, whole_norm) = z["runs"]
        assert (loss, norm) == (whole_loss, whole_norm)
        assert z["inside"] == [(96, 64), (64,)]
        assert z["after"] == [(96, 32), (32,)]
        want = c_attn.copy()
        want[0, 0], want[32, 0] = -1.0, 8.0  # rank 0's and rank 1's write
        np.testing.assert_array_equal(z["c_attn"], want)
        # ln_f is whole over tp: rank 1's write, from the world
        assert z["ln_f"][0] == 3.0
        np.testing.assert_array_equal(z["ln_f"],
                                      checks[0]["zero_init"]["ln_f"])


# ---------------------------------------------------------------------------
# mesh.dcn
# ---------------------------------------------------------------------------
DCN_LAYOUTS = [({"data": 4, "tp": 2}, {"data": 2}),
               ({"data": 2, "fsdp": 2, "tp": 2}, {"fsdp": 2}),
               ({"data": 2, "tp": 4}, {"tp": 2, "data": 2}),
               ({"data": 8}, {"data": 4}),
               ({"data": 2, "model": 4}, {"model": 2})]


@pytest.mark.parametrize("sizes,dcn", DCN_LAYOUTS,
                         ids=["data", "fsdp", "tp-data", "data8", "model"])
def test_dcn_rank_order_matches_jax(sizes, dcn):
    ref = JaxMesh(axis_sizes=sizes, devices=jax.devices()[:8],
                  dcn_axis_sizes=dcn)
    devices = ref.mesh.devices
    for rank in range(8):
        ours = port_topo.MeshTopology(axis_sizes=sizes, world_size=8,
                                      rank=rank, dcn_axis_sizes=dcn)
        assert devices[tuple(ours.coord)].id == rank
    for axes in (("data",), ("tp",), ("data", "fsdp")):
        lists = ours.comm_lists(axes)
        assert sorted(map(sorted, lists)) == sorted(
            sorted(int(d.id) for d in group) for group in _jax_groups(
                devices, ref.mesh.axis_names, axes))


def _jax_groups(devices, names, axes):
    """The JAX mesh's device groups over ``axes``: devices that agree on
    every other axis."""
    keep = [i for i, n in enumerate(names) if n in axes]
    moved = np.moveaxis(devices, keep, list(range(len(keep))))
    return moved.reshape(int(np.prod(moved.shape[:len(keep)])), -1).T


@pytest.mark.parametrize("sizes,dcn", [
    ({"data": 4}, {"rows": 2}), ({"data": 4}, {"data": 0}),
    ({"data": 4, "tp": 2}, {"data": 3})], ids=["unknown", "below1",
                                               "divide"])
def test_dcn_errors_match_jax(sizes, dcn):
    with pytest.raises(ValueError) as want:
        JaxMesh(axis_sizes=sizes, devices=jax.devices()[:8],
                dcn_axis_sizes=dcn)
    with pytest.raises(ValueError) as got:
        port_topo.MeshTopology(axis_sizes=sizes, world_size=8,
                               dcn_axis_sizes=dcn)
    assert str(got.value) == str(want.value)


def test_dcn_needs_its_ranks_a_node(monkeypatch):
    """Under a launcher that names the ranks a node, the dcn factors must
    put that many ranks on each node."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    with pytest.raises(ValueError, match="LOCAL_WORLD_SIZE"):
        port_topo.MeshTopology(axis_sizes={"data": 8}, world_size=8,
                               dcn_axis_sizes={"data": 2})
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    port_topo.MeshTopology(axis_sizes={"data": 8}, world_size=8,
                           dcn_axis_sizes={"data": 2})
