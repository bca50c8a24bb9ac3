"""Checkpoints of the port against the JAX package's, on the CPU.

Both packages write the same on-disk layout (``<dir>/latest`` and
``<dir>/<tag>/{module,optimizer,engine}.{npz,json}``), so a checkpoint
crosses between them both ways. Tolerances, with their reasons (those of
``test_torch_training.py``):

- losses and global gradient norms: 1e-5 relative — the same fp32 math
  summed in other orders;
- parameters after a resumed step: at least 99.9 % of the elements
  within 1e-5, every element within ``2 * lr * steps`` (Adam's sign flip
  on a near-zero gradient element);
- the same state saved by both packages: equal key sets, shapes, dtypes
  and sidecars; values within 1e-5 absolute (two AdamW steps of the same
  math: measured ~2e-6);
- a resume on the same package and layout: bit for bit; across ZeRO
  stages and tp degrees: the Adam state as loaded (``step`` and the
  whole slots) equal to the saved one, the next two losses within 1e-5
  relative, the parameters after them under the Adam rule above;
- the train -> serve handoff: JAX's logits within 1e-5, the same greedy
  tokens.

The 2-rank cases (ZeRO 2 -> 3, tp 2) run on one spawn of gloo ranks
(``tests/torch_ranks.py:checkpoint_reshard``), started in a background
thread when the module's first test runs.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import engine as jax_inference
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.parallel.topology import MeshTopology, reset_topology
from deepspeed_tpu_torch.checkpoint import DeepSpeedCheckpoint
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.runtime.resilience import topology
from deepspeed_tpu_torch.utils import params as P
from deepspeed_tpu_torch.utils.zero_to_fp32 import (
    get_fp32_state_dict_from_zero_checkpoint,
    load_state_dict_from_zero_checkpoint)
from tests import torch_ranks

B, T, LR = 2, 16, 6e-4
RTOL = 1e-5
_BACKGROUND = {}


def config(bf16=False, micro=B, **extra):
    """bench.py's engine keys at a tiny batch (``test_torch_training``'s
    ``bench_config``), with a warmup schedule so the lr scheduler's state
    travels too."""
    return {"train_micro_batch_size_per_gpu": micro,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": LR, "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR",
                          "params": {"warmup_num_steps": 4,
                                     "warmup_max_lr": LR}},
            "gradient_clipping": 1.0, "bf16": {"enabled": bf16},
            "fused_step": True, "zero_optimization": {"stage": 0},
            "steps_per_print": 10_000, **extra}


def batches(n, rows=B, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (rows, T)).astype(np.int32)
            for _ in range(n)]


def random_tree(model, seed=0):
    """A flax model's param tree (numpy) of its own shapes, from a numpy
    seed: LayerNorm / RMSNorm scales 1, biases 0, the rest N(0, 0.02)
    (``jax.eval_shape`` traces the init without compiling it)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))["params"]

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return np.ones(s.shape, s.dtype)
        if "bias" in name:
            return np.zeros(s.shape, s.dtype)
        return (0.02 * rng.standard_normal(s.shape)).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def weights():
    return random_tree(jax_gpt2.GPT2ForTraining(jax_gpt2.GPT2Config.tiny(
        dtype=jnp.float32)))


def jax_engine(weights, **kw):
    reset_topology()
    topo = MeshTopology(axis_sizes={"data": 1}, devices=jax.devices()[:1])
    engine, *_ = deepspeed_tpu.initialize(
        model=jax_gpt2.GPT2ForTraining(jax_gpt2.GPT2Config.tiny(
            dtype=jnp.float32)),
        model_parameters=weights, mesh=topo, config=config(**kw))
    return engine


def port_engine(weights, **kw):
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=P.training_model_from_jax(weights, port_gpt2.GPT2Config.tiny(
            dtype=torch.float32, remat=True, remat_policy="dots")),
        config=config(**kw), device="cpu")
    return engine


def step(engine, ids):
    loss = engine({"input_ids": ids})
    engine.backward(loss)
    engine.step()
    return float(loss), engine.get_global_grad_norm()


def assert_adam_close(got_tree, want_tree, steps):
    assert_adam_rule(P.params_from_jax(got_tree, port_gpt2.GPT2Config.tiny()),
                     P.params_from_jax(want_tree, port_gpt2.GPT2Config.tiny()),
                     steps)


def assert_adam_rule(got, want, steps):
    """``{name: tensor}`` dicts under the Adam rule (module docstring)."""
    assert set(got) == set(want)
    diff = torch.cat([(torch.as_tensor(got[k]) - torch.as_tensor(v))
                      .abs().flatten() for k, v in want.items()])
    assert (diff <= 1e-5).float().mean() >= 0.999
    assert diff.max() <= 2 * LR * steps


def port_tree(engine):
    return P.params_to_jax({k[len("model."):]: v for k, v in
                            engine.module_state_dict().items()},
                           engine.module.model.config)


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory, weights):
    """The 2-rank spawn (``torch_ranks.checkpoint_reshard``), shared by
    the test workers (``torch_ranks.cached``)."""
    def job(d):
        ckpt = str(d / "reshard-ckpt")
        out = torch_ranks.run_ranks(
            torch_ranks.programs, 2, d / "reshard",
            [("reshard", torch_ranks.checkpoint_reshard,
              {"weights": weights, "batches": batches(4, rows=2 * B, seed=7),
               "scheduler": config()["scheduler"],
               "dir": ckpt})])
        return {"ranks": [r["reshard"] for r in out], "dir": ckpt}

    def run():
        try:
            _BACKGROUND["ranks"] = torch_ranks.cached(
                tmp_path_factory, "checkpoint-reshard", job)
        except BaseException as e:  # raised in the test that needs it
            _BACKGROUND["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    _BACKGROUND["thread"] = thread
    yield
    thread.join()
    _BACKGROUND.clear()


@pytest.fixture(scope="module")
def fp32_runs(weights, tmp_path_factory):
    """JAX: 2 steps, save, step 3. The port: 2 steps from the same
    weights, save. Each package's step-3 result and tag."""
    d = tmp_path_factory.mktemp("fp32")
    ids = batches(3)
    jax_e = jax_engine(weights)
    for b in ids[:2]:
        step(jax_e, b)
    jax_e.save_checkpoint(str(d / "jax"), client_state={"epoch": 1})
    jax_third = step(jax_e, ids[2])
    port_e = port_engine(weights)
    for b in ids[:2]:
        step(port_e, b)
    port_e.save_checkpoint(str(d / "port"), client_state={"epoch": 1})
    return {"dir": d, "ids": ids, "jax_third": jax_third,
            "jax_params": jax.device_get(jax_e.state.params)}


# ---------------------------------------------------------------------------
# (a) cross-package resume, both ways
# ---------------------------------------------------------------------------
def test_port_resumes_a_jax_checkpoint(fp32_runs, weights):
    port_e = port_engine(weights)
    tag, client = port_e.load_checkpoint(str(fp32_runs["dir"] / "jax"))
    assert (tag, client) == ("global_step2", {"epoch": 1})
    assert (port_e.global_steps, port_e.micro_steps,
            port_e.global_samples) == (2, 2, 2 * B)
    assert port_e.lr_scheduler.last_batch_iteration == 1
    loss, norm = step(port_e, fp32_runs["ids"][2])
    np.testing.assert_allclose([loss, norm], fp32_runs["jax_third"],
                               rtol=RTOL)
    assert_adam_close(port_tree(port_e), fp32_runs["jax_params"], 3)


def test_jax_resumes_a_port_checkpoint(fp32_runs, weights):
    jax_e = jax_engine(weights)
    tag, client = jax_e.load_checkpoint(str(fp32_runs["dir"] / "port"))
    assert tag == "global_step2" and client == {"epoch": 1}
    loss, norm = step(jax_e, fp32_runs["ids"][2])
    np.testing.assert_allclose([loss, norm], fp32_runs["jax_third"],
                               rtol=RTOL)
    assert_adam_close(jax.device_get(jax_e.state.params),
                      fp32_runs["jax_params"], 3)


# ---------------------------------------------------------------------------
# (b) the same state saved by both packages
# ---------------------------------------------------------------------------
def _tag_files(d):
    out = {}
    for name in ("module", "optimizer", "engine"):
        with np.load(os.path.join(d, f"{name}.npz")) as z:
            out[name] = {k: z[k] for k in z.files}
        with open(os.path.join(d, f"{name}.json")) as f:
            out[name + ".json"] = json.load(f)
    return out


def assert_same_files(jax_dir, port_dir):
    want, got = _tag_files(jax_dir), _tag_files(port_dir)
    for name in ("module", "optimizer", "engine"):
        assert got[name + ".json"] == want[name + ".json"], name
        assert sorted(got[name]) == sorted(want[name]), name
        for k, v in want[name].items():
            assert got[name][k].shape == v.shape, k
            assert got[name][k].dtype == v.dtype, k
            np.testing.assert_allclose(got[name][k], v, atol=1e-5,
                                       rtol=0, err_msg=k)


def test_both_packages_write_the_same_files_fp32(fp32_runs):
    d = fp32_runs["dir"]
    for root in ("jax", "port"):
        assert open(d / root / "latest").read() == "global_step2"
    assert_same_files(d / "jax" / "global_step2", d / "port" / "global_step2")


def test_both_packages_write_the_same_files_bf16(weights, tmp_path):
    """``bf16.enabled``: both keep fp32 masters and moments in the file
    (no ``#dtype`` marker), and the same counters."""
    ids = batches(2)
    for name, make in (("jax", jax_engine), ("port", port_engine)):
        engine = make(weights, bf16=True)
        for b in ids:
            step(engine, b)
        engine.save_checkpoint(str(tmp_path / name), tag="t")
    assert_same_files(tmp_path / "jax" / "t", tmp_path / "port" / "t")
    files = _tag_files(tmp_path / "port" / "t")
    assert not any(k.endswith("#dtype") for k in files["module.json"])
    assert {v.dtype for v in files["module"].values()} == {np.dtype("float32")}


def test_bf16_leaves_carry_the_dtype_marker(tmp_path):
    """A bf16 tensor is stored as its uint16 view with JAX's marker; each
    package reads the other's."""
    from deepspeed_tpu.runtime.checkpoint_engine import checkpoint_engine \
        as jax_ce
    from deepspeed_tpu_torch.runtime.checkpoint_engine import \
        checkpoint_engine as port_ce

    x = torch.linspace(-3, 3, 12).reshape(3, 4).to(torch.bfloat16)
    port_ce.ArrayCheckpointEngine().save(
        {"a": {"b": x}, "none": None, "n": 3}, str(tmp_path / "p"))
    meta = json.load(open(tmp_path / "p.json"))
    assert meta == {"a/b#dtype": "bfloat16", "none#none": None, "n": 3}
    back = jax_ce.ArrayCheckpointEngine().load(str(tmp_path / "p"))
    assert str(back["a/b"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(back["a/b"], np.float32),
                                  x.float().numpy())
    jax_ce.ArrayCheckpointEngine().save(
        {"w": jnp.asarray(x.float().numpy(), jnp.bfloat16)},
        str(tmp_path / "j"))
    got = port_ce.ArrayCheckpointEngine().load(str(tmp_path / "j"))["w"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, x)


# ---------------------------------------------------------------------------
# (c) ZeRO and tp: save under one layout, load under another
# ---------------------------------------------------------------------------
def reshard_ranks():
    _BACKGROUND["thread"].join()
    if "error" in _BACKGROUND:
        raise _BACKGROUND["error"]
    return _BACKGROUND["ranks"]


def assert_adam_state_equal(got, want):
    """The loaded engine's Adam state (``step``, whole slots) equals the
    saving engine's, element for element."""
    assert got["step"] == want["step"]
    for k in ("exp_avg", "exp_avg_sq"):
        assert set(got[k]) == set(want[k]), k
        for name, v in want[k].items():
            assert np.array_equal(got[k][name], v), (k, name)


@pytest.mark.parametrize("case", ["zero2_to_zero3", "zero2_to_zero0",
                                  "tp2_to_tp1"])
def test_resume_across_layouts(case, weights):
    res = reshard_ranks()
    ranks, ckpt = res["ranks"], res["dir"]
    for key in ("z2", "z3", "tp2"):  # every rank sees the same losses
        assert ranks[0][key] == ranks[1][key], key
    out = ranks[0]
    if case == "zero2_to_zero3":
        assert out["z3_split"] and out["z3_tag"] == "global_step2"
        assert_adam_state_equal(out["z3_loaded"], out["z2_saved"])
        np.testing.assert_allclose(out["z3"], out["z2"][2:], rtol=RTOL)
        assert_adam_rule(out["z3_params"], out["z2_params"], steps=2)
        diff = topology.diff_topology(out["z2_topology"], out["z3_topology"])
        assert not diff["fatal"] and diff["changed"]["tensor_spec_changed"]
        return
    src = "z2" if case == "zero2_to_zero0" else "tp2"
    engine = port_engine(weights, micro=2 * B)
    engine.load_checkpoint(os.path.join(ckpt, src))
    opt = engine._opt_state
    assert_adam_state_equal(
        {"step": int(opt.step),
         **{k: {n: v.numpy() for n, v in
                engine._whole_slots(getattr(opt, k)).items()}
            for k in ("exp_avg", "exp_avg_sq")}},
        out[f"{src}_saved"])
    got = [step(engine, b)[0] for b in batches(4, rows=2 * B, seed=7)[2:]]
    np.testing.assert_allclose(got, out[src][2:], rtol=RTOL)
    assert_adam_rule({k: v.numpy() for k, v in
                      engine.module_state_dict().items()},
                     out[f"{src}_params"], steps=2)
    diff = topology.diff_topology(out[f"{src}_topology"],
                                  engine.describe_topology(include_data=False))
    assert not diff["fatal"] and diff["changed"]["tensor_spec_changed"]


# ---------------------------------------------------------------------------
# (d) the inverse maps
# ---------------------------------------------------------------------------
def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, path
    assert np.array_equal(a, b), path


@pytest.mark.parametrize("family,scan", [
    ("gpt2", True), ("gpt2", False), ("bert", True), ("bert", False),
    ("llama", True), ("llama_untied", False)])
def test_inverse_maps_round_trip(family, scan):
    """``x_to_jax(x_from_jax(tree)) == tree`` exactly."""
    from deepspeed_tpu.models import bert as jax_bert
    from deepspeed_tpu.models import llama as jax_llama
    from deepspeed_tpu_torch.models import bert as port_bert
    from deepspeed_tpu_torch.models import llama as port_llama

    if family == "gpt2":
        tree = random_tree(jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config.tiny(
            scan_layers=scan, dtype=jnp.float32)), seed=3)
        cfg = port_gpt2.GPT2Config.tiny(scan_layers=scan)
        back = P.params_to_jax(P.params_from_jax(tree, cfg), cfg)
    elif family == "bert":
        tree = random_tree(jax_bert.BertForMaskedLM(jax_bert.BertConfig.tiny(
            scan_layers=scan)), seed=3)
        cfg = port_bert.BertConfig.tiny(scan_layers=scan)
        back = P.bert_params_to_jax(P.bert_params_from_jax(tree, cfg), cfg)
    else:
        tie = family == "llama"
        tree = random_tree(jax_llama.LlamaModel(jax_llama.LlamaConfig.tiny(
            scan_layers=scan, tie_word_embeddings=tie)), seed=3)
        cfg = port_llama.LlamaConfig.tiny(scan_layers=scan,
                                          tie_word_embeddings=tie)
        back = P.llama_params_to_jax(P.llama_params_from_jax(tree, cfg), cfg)
    _tree_equal(tree, back)


# ---------------------------------------------------------------------------
# the offline readers and the load options
# ---------------------------------------------------------------------------
def test_offline_readers_match_jax(fp32_runs):
    from deepspeed_tpu.checkpoint import deepspeed_checkpoint as jax_dc

    root = str(fp32_runs["dir"] / "port")
    want = jax_dc.get_fp32_state_dict_from_zero_checkpoint(root)
    got = get_fp32_state_dict_from_zero_checkpoint(root)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    ckpt = DeepSpeedCheckpoint(root)
    assert ckpt.show_summary() == jax_dc.DeepSpeedCheckpoint(
        root).show_summary()
    model = port_gpt2.GPT2ForTraining(port_gpt2.GPT2Config.tiny(
        dtype=torch.float32), seed=9)
    load_state_dict_from_zero_checkpoint(model, root)
    sd = P.training_params_from_jax(model, ckpt.params_tree())
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_load_options_and_missing_tags(fp32_runs, weights, tmp_path):
    root = str(fp32_runs["dir"] / "port")
    engine = port_engine(weights)
    before = {k: v.clone() for k, v in engine.module_state_dict().items()}
    tag, client = engine.load_checkpoint(root, load_module_only=True)
    assert (tag, client, engine.global_steps) == ("global_step2", {}, 0)
    assert any(not torch.equal(v, before[k])
               for k, v in engine.module_state_dict().items())
    with pytest.raises(FileNotFoundError, match="'global_step2'"):
        engine.load_checkpoint(root, tag="global_step9")
    assert engine.load_checkpoint(str(tmp_path)) == (None, {})


# ---------------------------------------------------------------------------
# (i) the train -> serve handoff
# ---------------------------------------------------------------------------
def test_init_inference_serves_a_jax_checkpoint(fp32_runs):
    """``init_inference(checkpoint=)`` on a JAX-written save dir (its
    ``latest``) and on the tag dir itself: JAX's logits, and greedy
    tokens that are JAX's argmax at every position of the sequence they
    make (teacher-forced through the JAX model)."""
    root = str(fp32_runs["dir"] / "jax")
    tree = jax_inference.load_module_params(root)
    jmodel = jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config.tiny(
        dtype=jnp.float32))
    prompt = batches(1, seed=3)[0][:, :6]
    want = np.asarray(jmodel.apply({"params": tree}, jnp.asarray(prompt)))
    for ckpt in (root, os.path.join(root, "global_step2")):
        engine = deepspeed_tpu_torch.init_inference(
            port_gpt2.GPT2LMHeadModel(port_gpt2.GPT2Config.tiny(
                dtype=torch.float32), device="meta"),
            checkpoint=ckpt, dtype=torch.float32, device="cpu")
        got = engine(torch.from_numpy(prompt)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        tokens = engine.generate(prompt, max_new_tokens=4).numpy()
    forced = np.asarray(jmodel.apply({"params": tree},
                                     jnp.asarray(tokens[:, :-1])))
    np.testing.assert_array_equal(forced[:, 5:].argmax(-1), tokens[:, 6:])


def test_save_mp_checkpoint_and_load_checkpoint(fp32_runs, tmp_path):
    """``save_mp_checkpoint_path`` writes the cast weights in the JAX
    layout (bf16 leaves with the ``#dtype`` marker, which JAX's loader
    reads), and ``load_checkpoint`` swaps a served model's weights."""
    model = port_gpt2.GPT2LMHeadModel(port_gpt2.GPT2Config.tiny(
        dtype=torch.float32), seed=4)
    engine = deepspeed_tpu_torch.init_inference(
        model, dtype=torch.bfloat16, device="cpu",
        save_mp_checkpoint_path=str(tmp_path))
    assert open(tmp_path / "latest").read() == "inference"
    meta = json.load(open(tmp_path / "inference" / "module.json"))
    assert meta["params/wte#dtype"] == "bfloat16"
    tree = jax_inference.load_module_params(str(tmp_path))
    assert str(tree["wte"].dtype) == "bfloat16"
    np.testing.assert_array_equal(
        np.asarray(tree["wte"], np.float32),
        engine.module.wte.float().numpy())
    root = str(fp32_runs["dir"] / "jax")
    engine.load_checkpoint(root)
    want = P.params_from_jax(jax_inference.load_module_params(root),
                             port_gpt2.GPT2Config.tiny())
    for name, t in engine.module.state_dict().items():
        assert torch.equal(t, want[name].to(torch.bfloat16)), name
