"""The port's ZeRO against the JAX package's, on the CPU.

- ``SpecLayout``: every tiny GPT-2 parameter's parameter spec (stage 3)
  and optimizer-state spec (stage 1), and the shard shapes they give, on
  ``{"data": 4}`` and ``{"data": 2, "fsdp": 2}``, at persistence
  thresholds 0 and 10^5, with and without ``hierarchical_gather``,
  against the JAX ``SpecLayout`` on a 4-device mesh (a ``scan_layers=
  False`` JAX model; a flax ``Dense`` kernel is ``[in, out]``, an
  ``nn.Linear`` weight ``[out, in]``, so kernel specs are compared
  reversed); batch specs; ``bucket_by_bytes``.
- Training: the port on 4 gloo ranks (``tests/torch_ranks.py``: one
  spawn runs every program of this file, every case of both meshes
  included, shared by the test workers) against
  the JAX engine on a 4-device mesh of the conftest's CPU devices, from
  the same weights and global micro-batches: a tiny fp32 GPT-2 (2 layers,
  width 64, "dots" remat, AdamW, clip 1.0) at ZeRO stages 0-3, fused and
  with 2 accumulation steps, plus LAMB at stage 2 and (on ``data x
  fsdp``) stage 3 with ``hierarchical_gather``; 3 steps. Tolerances are
  ``test_torch_training.py``'s: losses of every micro-step and pre-clip
  grad norms within 1e-5 relative; final parameters 99.9 % within 1e-5
  and all within ``2 * lr * steps`` (Adam's sign flips near zero). Each
  rank's parameter and master shapes equal the JAX layout's shards, and
  the collectives each step launched equal the stage's plan.
- fp16 dynamic scaling where one rank's gradient alone overflows: every
  rank skips. ``zero.GatheredParameters`` with a ``modifier_rank`` write.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import deepspeed_tpu
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.parallel.topology import MeshTopology as JaxMesh
from deepspeed_tpu.parallel.topology import reset_topology
from deepspeed_tpu.runtime.zero import partition as jax_part
from deepspeed_tpu.runtime.zero import reduce as jax_reduce
from deepspeed_tpu.utils.pytree import flatten_with_path_strings
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2ForTraining
from deepspeed_tpu_torch.parallel.topology import MeshTopology
from deepspeed_tpu_torch.runtime.zero import partition as port_part
from deepspeed_tpu_torch.runtime.zero import reduce as port_reduce
from deepspeed_tpu_torch.utils.params import params_from_jax
from tests import torch_ranks
from tests.torch_ranks import zero_config

MESHES = {"data4": {"data": 4}, "data2_fsdp2": {"data": 2, "fsdp": 2}}
LR, STEPS, T, RTOL = 6e-4, 3, 16, 1e-5
# stage-3 persistence threshold of the training cases: the tiny model's
# weight matrices (4096 elements and up) split, its biases and norms stay
# whole
THRESHOLD = 4096


def case_configs(mesh_name):
    cases = {}
    for stage in range(4):
        zero = {"stage3_param_persistence_threshold": THRESHOLD}
        cases[f"stage{stage}_fused"] = zero_config(stage, **zero)
        cases[f"stage{stage}_gas2"] = zero_config(stage, gas=2, fused=False,
                                                  **zero)
    cases["stage2_lamb"] = zero_config(2, optimizer="Lamb")
    if mesh_name == "data2_fsdp2":
        cases["stage3_hpz"] = zero_config(
            3, stage3_param_persistence_threshold=THRESHOLD,
            hierarchical_gather=True)
    return cases


ALL_CASES = [(m, c) for m in MESHES for c in case_configs(m)]


def jax_config(**kw):
    """The JAX model unrolled (``scan_layers=False``): LAMB's trust ratio
    is one per parameter tensor, and a scanned model stacks every layer's
    tensor into one leaf, so its ratio would span the layers where the
    port's spans one."""
    return jax_gpt2.GPT2Config.tiny(dtype=jnp.float32, scan_layers=False,
                                    **kw)


def global_batches(mesh, n, seed=0):
    rows = 2 * mesh.get("data", 1)
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (rows, T)).astype(np.int32)
            for _ in range(n)]


def _plain(tree):
    """Nested plain dicts of numpy arrays: what a child unpickles without
    importing JAX."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def jax_params():
    model = jax_gpt2.GPT2ForTraining(jax_config())
    return _plain(jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.asarray(global_batches(MESHES["data4"],
                                                          1)[0]))["params"]))


_PORT = {}
# the one spawn of this file's programs runs them one after another
ZERO_RANKS_TIMEOUT = 900


def zero_ranks(tmp_path_factory, jax_params):
    """Every program of this file on one spawn of 4 gloo ranks: the
    training cases of each mesh, the overflow at stages 1 and 3 and
    ``GatheredParameters``; ``{name: each rank's results}``."""
    if not _PORT:
        programs = []
        for mesh_name, mesh in MESHES.items():
            programs.append((f"train-{mesh_name}", torch_ranks.train, {
                "mesh": mesh, "cases": case_configs(mesh_name),
                "steps": STEPS, "batches": global_batches(mesh, 2 * STEPS),
                "weights": jax_params}))
        for stage in (1, 3):
            programs.append((f"overflow-{stage}", torch_ranks.overflow,
                             {"stage": stage}))
        programs.append(("gathered", torch_ranks.gathered, {
            "weights": jax_params,
            "batches": global_batches(MESHES["data2_fsdp2"], 1)}))
        ranks = torch_ranks.cached(
            tmp_path_factory, "zero-ranks",
            lambda d: torch_ranks.run_ranks(
                torch_ranks.programs, 4, d / "zero", programs,
                timeout=ZERO_RANKS_TIMEOUT))
        _PORT.update({name: [r[name] for r in ranks]
                      for name, _, _ in programs})
    return _PORT


def port_runs(mesh_name, tmp_path_factory, jax_params):
    """Every training case of ``mesh_name`` on the 4 gloo ranks; each
    rank's results."""
    return zero_ranks(tmp_path_factory, jax_params)[f"train-{mesh_name}"]


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
    ranks = port_runs(mesh_name, tmp_path_factory, jax_params)
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


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------
def port_name(path):
    """The port's parameter name of a JAX ``scan_layers=False`` training
    tree path, and whether its spec is reversed (a Dense kernel)."""
    parts = path.split("/")
    leaf = {"scale": "weight", "kernel": "weight"}.get(parts[-1], parts[-1])
    if parts[0] in ("wte", "wpe"):
        return f"model.{parts[0]}", False
    if parts[0] == "ln_f":
        return f"model.ln_f.{leaf}", False
    i = parts[1][len("h_"):]
    mods = ".".join(parts[2:-1])
    return f"model.h.{i}.{mods}.{leaf}", parts[-1] == "kernel"


@pytest.fixture(scope="module")
def jax_leaves():
    model = jax_gpt2.GPT2ForTraining(jax_config())
    params = jax.eval_shape(lambda r: model.init(
        r, jnp.zeros((2, T), jnp.int32))["params"], jax.random.PRNGKey(0))
    flat, _ = flatten_with_path_strings(params)
    return [(path, tuple(leaf.shape)) for path, leaf in flat]


def _mapped(spec, reverse, ndim):
    entries = list(spec) + [None] * (ndim - len(spec))
    return tuple(entries[::-1] if reverse else entries)


def _jax_shards(mesh, threshold, hierarchical, jax_leaves):
    """``{port name: (param spec, opt spec, param shard, opt shard)}``
    from the JAX layout, in the port's dim order."""
    topo = JaxMesh(axis_sizes=mesh, devices=jax.devices()[:4])
    layout = jax_part.SpecLayout(topo.mesh, persistence_threshold=threshold,
                                 hierarchical_gather=hierarchical)
    out = {}
    for path, shape in jax_leaves:
        name, rev = port_name(path)
        ps, os_ = layout.param_spec(shape, stage=3), layout.opt_spec(shape)
        shard = [NamedSharding(topo.mesh, s).shard_shape(shape)
                 for s in (ps, os_)]
        out[name] = (_mapped(ps, rev, len(shape)), _mapped(os_, rev,
                                                           len(shape)),
                     *(tuple(s[::-1]) if rev else tuple(s) for s in shard))
    return out


LAYOUT_CASES = [(m, t, h) for m in MESHES for t in (0, 100_000)
                for h in (False, True)]


@pytest.mark.parametrize("mesh_name,threshold,hierarchical", LAYOUT_CASES,
                         ids=[f"{m}-t{t}-{'hpz' if h else 'flat'}"
                              for m, t, h in LAYOUT_CASES])
def test_spec_layout_matches_jax(mesh_name, threshold, hierarchical,
                                 jax_leaves):
    """Every rank's plans of every parameter: the JAX spec (mapped), and
    the JAX shard shape."""
    mesh = MESHES[mesh_name]
    want = _jax_shards(mesh, threshold, hierarchical, jax_leaves)
    model = GPT2ForTraining(GPT2Config.tiny(), device="meta")
    for rank in range(4):
        topo = MeshTopology(axis_sizes=mesh, world_size=4, rank=rank)
        layout = port_part.SpecLayout(topo, persistence_threshold=threshold,
                                      hierarchical_gather=hierarchical)
        params, opts = layout.shardings(model, stage=3)
        assert sorted(params) == sorted(want)
        for name, (pspec, ospec, pshard, oshard) in want.items():
            p, o = params[name], opts[name]
            assert (tuple(p.spec) or (None,) * len(p.shape)) == pspec, name
            assert (tuple(o.spec) or (None,) * len(o.shape)) == ospec, name
            assert (p.shard_shape, o.shard_shape) == (pshard, oshard), name
            assert p.index == (rank if p.n == 4 else
                               [0, 1, 0, 1][rank] if p.n == 2 else 0)
        jax_layout = jax_part.SpecLayout(JaxMesh(
            axis_sizes=mesh, devices=jax.devices()[:4]).mesh)
        for shape in ((8, T), (6, T), (8,), (4, 3, 2)):
            assert tuple(layout.batch_spec(len(shape), shape)) == tuple(
                jax_layout.batch_spec(len(shape), shape))
        assert layout.describe() == jax_part.SpecLayout(
            JaxMesh(axis_sizes=mesh, devices=jax.devices()[:4]).mesh,
            persistence_threshold=threshold,
            hierarchical_gather=hierarchical).describe()


def test_world_of_one_keeps_the_split_as_one_shard():
    """On one rank SpecLayout replicates everything; the plans keep the
    stage's split as one shard over a group of one (the stage-3
    persistence threshold still applies)."""
    model = GPT2ForTraining(GPT2Config.tiny(), device="meta")
    layout = port_part.SpecLayout(MeshTopology(world_size=1),
                                  persistence_threshold=1000)
    params, opts = layout.shardings(model, stage=3)
    c_proj = "model.h.0.attn.c_proj.weight"
    assert tuple(params[c_proj].spec) == ()
    # the tie of a square Dense: JAX's dim 0 is the port's dim 1
    assert (params[c_proj].dim, params[c_proj].n) == (1, 1)
    assert params["model.wte"].dim == 0
    assert not params["model.h.0.ln_1.weight"].sharded
    assert opts["model.h.0.ln_1.weight"].sharded
    for stage in (0, 1, 2):
        params, opts = layout.shardings(model, stage=stage)
        assert not any(p.sharded for p in params.values())
        assert all(o.sharded for o in opts.values()) == (stage > 0)


@pytest.mark.parametrize("budget", [1, 4096, 65_536, 300_000, 10 ** 9])
def test_bucket_by_bytes_matches_jax(budget, jax_leaves):
    shapes = [shape for _, shape in jax_leaves]
    jax_leaves_ = [jnp.zeros(s) for s in shapes]
    port = [torch.zeros(s) for s in shapes]
    assert port_reduce.bucket_by_bytes(port, budget) == \
        jax_reduce.bucket_by_bytes(jax_leaves_, budget)


def test_rank_major_packing_round_trips():
    """A reduce-scatter's packed rows hold each tensor's shard i in row
    i, whatever its split dim; ``unpack_full`` inverts the packing."""
    plans = [port_part.ShardPlan((4, 6), dim=1, n=2, index=i)
             for i in range(2)]
    plans3 = [port_part.ShardPlan((8, 3), dim=0, n=2, index=i)
              for i in range(2)]
    a, b = torch.randn(4, 6), torch.randn(8, 3)
    rows = port_reduce.pack_rows([a, b], [plans[0], plans3[0]])
    for i in range(2):
        sa, sb = port_reduce.unpack_row(rows[i], [plans[i], plans3[i]])
        torch.testing.assert_close(sa, plans[i].local(a))
        torch.testing.assert_close(sb, plans3[i].local(b))
    full = port_reduce.unpack_full(rows, [plans[0], plans3[0]])
    torch.testing.assert_close(full[0], a)
    torch.testing.assert_close(full[1], b)


def test_reduce_gradients_int8_is_a_later_slice():
    with pytest.raises(NotImplementedError, match="compressed-collectives"):
        port_reduce.reduce_gradients([torch.zeros(2)], None,
                                     comm_dtype="int8")
    with pytest.raises(ValueError, match="1-bit"):
        port_reduce.reduce_gradients([torch.zeros(2)], None,
                                     comm_dtype="1bit")


@pytest.mark.parametrize("mesh_name,stage", [(m, s) for m in MESHES
                                             for s in (1, 3)])
def test_rank_shard_shapes_follow_the_layout(mesh_name, stage, jax_params,
                                             jax_leaves, tmp_path_factory):
    """What each rank holds after training: its parameter shards (stage
    3) and its masters (the optimizer's shards) have the JAX layout's
    shard shapes at the cases' threshold."""
    ranks = port_runs(mesh_name, tmp_path_factory, jax_params)
    want = _jax_shards(MESHES[mesh_name], THRESHOLD, False, jax_leaves)
    for r in ranks:
        got = r[f"stage{stage}_fused"]
        for name, (_, _, pshard, oshard) in want.items():
            full = GPT2ForTraining(GPT2Config.tiny(), device="meta") \
                .get_parameter(name).shape
            assert got["param_shapes"][name] == (pshard if stage == 3
                                                 else tuple(full)), name
            assert got["master_shapes"][name] == oshard, name


# ---------------------------------------------------------------------------
# overflow and GatheredParameters
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def overflow_runs(tmp_path_factory, jax_params):
    runs = zero_ranks(tmp_path_factory, jax_params)
    return {stage: runs[f"overflow-{stage}"] for stage in (1, 3)}


@pytest.mark.parametrize("stage", [1, 3])
def test_one_rank_overflow_skips_every_rank(overflow_runs, stage):
    ranks = overflow_runs[stage]
    # rank 0 alone owns the element that overflowed (the [4, 8] weight
    # splits its 8 columns over 4 ranks)
    assert all(r["shard"] == (4, 2) for r in ranks)
    for r in ranks:
        assert r["skipped"] == (1, False)
        np.testing.assert_array_equal(r["w"], np.ones((4, 8)))
        assert not np.array_equal(r["w_after"], r["w"])  # next step runs
        assert r["loss_scale"] == 2.0 ** 16  # hysteresis 2: kept once
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["w_after"], ranks[0]["w_after"])


@pytest.fixture(scope="module")
def gathered_runs(tmp_path_factory, jax_params):
    return zero_ranks(tmp_path_factory, jax_params)["gathered"]


def test_gathered_parameters_write_back(gathered_runs, jax_params):
    whole = params_from_jax(jax_params, GPT2Config.tiny())
    wte = whole["wte"].numpy()
    full_shapes = [tuple(t.shape) for t in GPT2ForTraining(
        GPT2Config.tiny(), device="meta").parameters()]
    for r in gathered_runs:
        assert r["shards"] != full_shapes  # stage 3 at threshold 0
        assert r["inside"] == full_shapes
        assert r["after"] == r["shards"]
        np.testing.assert_array_equal(r["wte_inside"], wte)
        # rank 1's write, broadcast and re-sharded on every rank
        np.testing.assert_array_equal(r["wte_row0"], np.full(64, 7.0))
        np.testing.assert_array_equal(r["wte_rest"], wte[1:])
        np.testing.assert_array_equal(r["wte_row1_read_only"], wte[1])
        assert np.isfinite(r["loss"]) and r["step_applied"]
    assert len({r["loss"] for r in gathered_runs}) == 1


def test_load_module_state_dict_reshards(gathered_runs):
    for r in gathered_runs:
        assert r["zeroed"] == 0.0
        assert r["reloaded"] == 0.0


def test_stage3_frees_gathered_weights(gathered_runs):
    """Under "dots" remat no block's whole weights outlive its forward:
    after the forward only the root unit's gathered tensors live (the
    first gather; the LM head keeps ``wte`` for its backward), after the
    backward none, the recompute's gathers included."""
    for r in gathered_runs:
        fwd, bwd = r["alive_after_forward"], r["alive_after_backward"]
        # the root unit, then 2 blocks; the recompute adds 2 gathers
        assert len(fwd) == 3 and len(bwd) == 5
        assert fwd[0] > 0 and fwd[1:] == [0, 0]
        assert bwd == [0] * 5


@pytest.mark.parametrize("remat", ["full", None])
def test_stage3_matches_stage0_under_each_remat(gathered_runs, remat):
    for r in gathered_runs:
        (loss0, norm0), (loss3, norm3) = r[f"remat_{remat}"]
        np.testing.assert_allclose(loss3, loss0, rtol=1e-6)
        np.testing.assert_allclose(norm3, norm0, rtol=1e-5)


def test_zero_init_partitions_before_initialize(gathered_runs):
    for r in gathered_runs:
        assert r["init_shapes"] == r["shards"]
        (loss, norm), (whole_loss, whole_norm) = r["init_runs"]
        assert (loss, norm) == (whole_loss, whole_norm)


@pytest.mark.parametrize("policy", ["auto", "gpt2"])
def test_policy_families_and_tp_specs_match_jax(policy, jax_leaves):
    """``family_for`` and ``spec_for`` on the port's names and shapes
    against the JAX policy on its paths (a Dense kernel's spec
    reversed), at tp 1 (every spec replicated) and 2."""
    from deepspeed_tpu.module_inject import policies as jax_pol
    from deepspeed_tpu_torch.module_inject import policies as port_pol

    jp, pp = jax_pol.get_tp_policy(policy), port_pol.get_tp_policy(policy)
    families = set()
    for path, shape in jax_leaves:
        name, rev = port_name(path)
        pshape = shape[::-1] if rev else shape
        fam = port_pol.family_for(name, pshape, pp)
        assert fam == jax_pol.family_for(path, shape, jp), name
        families.add(fam)
        assert pp.spec_for(name, pshape, 1) is None
        want, got = jp.spec_for(path, shape, 2), pp.spec_for(name, pshape, 2)
        assert (got is None) == (want is None), name
        if want is not None:
            assert tuple(got) == _mapped(want, rev, len(shape)), name
    assert families == {"embedding", "attn_qkv", "attn_proj", "mlp_in",
                        "mlp_out", "norm", "other"}
