"""The port's Llama family against the JAX package's, on the CPU.

The same numpy weights (the JAX model's own init, carried across by
``llama_params_from_jax``) and the same numpy inputs go through both
packages, at ``LlamaConfig.tiny`` in float32 (4 heads of 16; GQA at 2 KV
heads, and 1). Tolerances:

- RMSNorm, rotary, attention (MHA and GQA) and the model's logits
  (scanned and unrolled JAX trees, tied and separate heads): 1e-5, the
  same fp32 math in other summation orders;
- ``generate`` (greedy, unpadded and left-padded): the same tokens as the
  JAX engine's ``generate``;
- ``initialize(LlamaForTraining)``: 3 steps at ZeRO stage 0 (in this
  process) and stage 3 (2 gloo ranks on ``{"data": 2}``), each against
  the JAX engine's: losses within 1e-5 relative, step-1 gradients within
  1e-4 of ``jax.grad`` of the JAX loss;
- tensor parallelism at tp=2 on the same spawn (``tests/torch_ranks.py:
  llama``): ``generate`` and one training step against the JAX engine
  (tp=1 on the same weights: the same function), with KV heads that
  divide tp (2) and that do not (1: attention whole, the MLP split);
- HF loading: an HF-named ``.bin`` directory written by
  ``save_hf_llama`` from random weights, read by both packages'
  ``load_hf_llama`` (equal), by ``from_pretrained`` (logits within 1e-5
  of the JAX model's) and, where ``transformers`` is importable, by
  ``LlamaForCausalLM`` (logits within 3e-4: HF's rotary tables round
  otherwise);
- F3: both packages' GPT-2 with each ``attn_layout``, logits within 1e-5;
  ``init_serving`` refuses a Llama with the JAX engine's ``ValueError``.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.inference
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.parallel.topology import MeshTopology as JaxMesh
from deepspeed_tpu.parallel.topology import reset_topology
from deepspeed_tpu.runtime import state_dict_factory as jax_sdf
from deepspeed_tpu_torch.inference import from_pretrained
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.models import llama as port_llama
from deepspeed_tpu_torch.runtime import state_dict_factory as port_sdf
from deepspeed_tpu_torch.utils.params import (llama_params_from_jax,
                                              llama_training_model_from_jax,
                                              params_from_jax)
from tests import torch_ranks
from tests.torch_ranks import zero_config

T, NEW, STEPS, RTOL = 16, 8, 3, 1e-5


def jax_config(**kw):
    return jax_llama.LlamaConfig.tiny(dtype=jnp.float32, **kw)


def port_config(**kw):
    return port_llama.LlamaConfig.tiny(dtype=torch.float32, **kw)


def _plain(tree):
    """Nested plain dicts of numpy arrays (what a spawned rank unpickles
    without importing JAX)."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def weights(kv=None, scan=True, tie=False):
    """The JAX model's own init of a tiny config, as numpy."""
    model = jax_llama.LlamaModel(jax_config(num_key_value_heads=kv,
                                            scan_layers=scan,
                                            tie_word_embeddings=tie))
    return _plain(jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]))


def port_model(kv=None, scan=True, tie=False):
    cfg = port_config(num_key_value_heads=kv, tie_word_embeddings=tie)
    model = port_llama.LlamaModel(cfg, device="meta")
    model.load_state_dict(llama_params_from_jax(weights(kv, scan, tie), cfg),
                          assign=True)
    return model


def ids_of(rows, seed=0, length=T):
    return np.random.default_rng(seed).integers(1, 256, (rows, length))


def global_batches(rows, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (rows, T)).astype(np.int32)
            for _ in range(STEPS)]


# ---------------------------------------------------------------------------
# the config and the pieces
# ---------------------------------------------------------------------------
def test_config_fields_match_jax():
    """Every JAX field, with the JAX defaults (the dtype in torch's
    name); the members; ``cpu_checkpointing`` raises naming its item."""
    jf, pf = ({f.name: f.default for f in dataclasses.fields(c)}
              for c in (jax_llama.LlamaConfig, port_llama.LlamaConfig))
    assert sorted(jf) == sorted(pf)
    assert {k: v for k, v in jf.items() if k != "dtype"} == \
        {k: v for k, v in pf.items() if k != "dtype"}
    for kw in ({}, {"num_key_value_heads": 2}):
        j, p = jax_config(**kw), port_config(**kw)
        assert (j.kv_heads, j.head_dim) == (p.kv_heads, p.head_dim)
        assert p.for_decode(True).decode and p.for_decode(True).padded
    assert dataclasses.asdict(port_llama.LlamaConfig.llama2_7b()) == \
        dataclasses.asdict(port_llama.LlamaConfig())
    with pytest.raises(NotImplementedError, match=r"\[12\.8\]"):
        port_config(cpu_checkpointing=True)


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    want = jax_llama.RMSNorm(1e-5, jnp.float32).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
    norm = port_llama.RMSNorm(64, 1e-5, torch.float32)
    norm.weight.data = torch.from_numpy(scale)
    got = norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
def test_rope_matches_jax(per_row):
    """The fp32 tables and the rotation, at shared positions and at the
    per-row positions of a left-padded batch (deep into a 4096 window)."""
    x = np.random.default_rng(2).standard_normal((2, 6, 4, 16)).astype(
        np.float32)
    pos = np.arange(6) + 3000
    if per_row:
        pos = np.stack([pos, np.maximum(np.arange(6) - 2, 0)])
    jc, js = jax_llama.rope_frequencies(16, jnp.asarray(pos), 10000.0)
    pc, ps = port_llama.rope_frequencies(16, torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5)
    want = jax_llama.apply_rope(jnp.asarray(x), jc, js)
    got = port_llama.apply_rope(torch.from_numpy(x), pc, ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("kv", [4, 2], ids=["mha", "gqa"])
def test_attention_matches_jax(kv):
    """One attention layer on the same weights: query head h reads KV
    head h // (H / KV), as ``jnp.repeat`` expands them."""
    layer = weights(kv, scan=False)["layers_0"]["self_attn"]
    x = np.random.default_rng(3).standard_normal((2, T, 64)).astype(
        np.float32)
    want = jax_llama.LlamaAttention(jax_config(num_key_value_heads=kv)).apply(
        {"params": layer}, jnp.asarray(x))
    attn = port_llama.LlamaAttention(port_config(num_key_value_heads=kv),
                                      device="meta")
    attn.load_state_dict({f"{n}.weight": torch.from_numpy(v["kernel"].T.copy())
                          for n, v in layer.items()}, assign=True)
    step = {"key_valid": None, "rope": port_llama.rope_frequencies(
        16, torch.arange(T), 10000.0)}
    got = attn(torch.from_numpy(x), step=step)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv,scan,tie", [(None, True, False),
                                         (2, False, True)],
                         ids=["scanned-mha", "unrolled-gqa-tied"])
def test_logits_match_jax(kv, scan, tie):
    ids = ids_of(2)
    model = jax_llama.LlamaModel(jax_config(num_key_value_heads=kv,
                                            scan_layers=scan,
                                            tie_word_embeddings=tie))
    want = model.apply({"params": weights(kv, scan, tie)}, jnp.asarray(ids))
    port = port_model(kv, scan, tie)
    assert (port.lm_head.weight is port.embed_tokens) == tie
    with torch.no_grad():
        got = port(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------
def generate_inputs():
    """A 2 x 12 prompt and its left-padding mask (row 0: 5 pads)."""
    ids = ids_of(2, seed=4, length=12)
    mask = np.ones_like(ids)
    mask[0, :5] = 0
    return ids, mask


@functools.lru_cache(maxsize=None)
def jax_generate(kv):
    """The JAX engine's greedy and padded tokens on the kv config."""
    engine = deepspeed_tpu.init_inference(
        jax_llama.LlamaModel(jax_config(num_key_value_heads=kv)),
        params=weights(kv), dtype=jnp.float32)
    ids, mask = generate_inputs()
    return {"greedy": np.asarray(engine.generate(
        jnp.asarray(ids), max_new_tokens=NEW))[:, 12:].tolist(),
        "padded": np.asarray(engine.generate(
            jnp.asarray(ids), max_new_tokens=NEW,
            attention_mask=jnp.asarray(mask)))[:, 12:].tolist()}


@pytest.mark.parametrize("padded", [False, True], ids=["greedy", "padded"])
def test_generate_matches_jax(padded):
    engine = deepspeed_tpu_torch.init_inference(port_model(2), dtype="fp32",
                                                device="cpu")
    ids, mask = generate_inputs()
    got = torch_ranks._generate(engine, ids, NEW, mask if padded else None)
    assert got == jax_generate(2)["padded" if padded else "greedy"]
    with pytest.raises(ValueError, match="exceeds model window 64"):
        engine.generate(torch.from_numpy(ids), max_new_tokens=60)


def test_serving_refuses_llama_as_jax_does():
    serving = {"block_size": 16, "decode_slots": 2}
    with pytest.raises(ValueError) as want:
        deepspeed_tpu.init_serving(
            jax_llama.LlamaModel(jax_config()), params=weights(),
            dtype=jnp.float32, serving=serving)
    with pytest.raises(ValueError) as got:
        deepspeed_tpu_torch.init_serving(port_model(), dtype="fp32",
                                         device="cpu", serving=serving)
    assert str(got.value) == str(want.value)
    assert "for_paged_decode" in str(got.value)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
REMAT = dict(remat=True, remat_policy="dots")
ROWS = 4  # the global batch: stage 3's 2 ranks take 2 rows each


@functools.lru_cache(maxsize=None)
def jax_reference(kv):
    """The JAX training loss of the first batch and its ``jax.grad``, in
    the port's names."""
    model = jax_llama.LlamaForTraining(jax_config(num_key_value_heads=kv))
    ids = jnp.asarray(global_batches(ROWS)[0])
    loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, weights(kv)), (ids, ids))
    return float(loss), llama_params_from_jax(
        _plain(jax.device_get(grads)), port_config(num_key_value_heads=kv))


@functools.lru_cache(maxsize=None)
def jax_losses(kv):
    """The JAX engine's losses over the batches (bench.py's keys, "dots"
    remat, one device): ZeRO changes where the sums run, not what they
    compute (``tests/test_torch_zero.py`` holds the JAX stages to each
    other's numbers through the port), so both stages are held to it."""
    reset_topology()
    topo = JaxMesh(axis_sizes={"data": 1}, devices=jax.devices()[:1])
    config = zero_config(0)
    config["train_micro_batch_size_per_gpu"] = ROWS
    engine, *_ = deepspeed_tpu.initialize(
        model=jax_llama.LlamaForTraining(jax_config(num_key_value_heads=kv,
                                                    **REMAT)),
        model_parameters=weights(kv), mesh=topo, config=config)
    losses = []
    for ids in global_batches(ROWS):
        loss = engine({"input_ids": ids})
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
    return losses


def gpt2_weights():
    """The JAX tiny GPT-2's own init, as numpy (its "full"-remat plan)."""
    model = jax_gpt2.GPT2LMHeadModel(jax_gpt2.GPT2Config.tiny(
        dtype=jnp.float32))
    return _plain(jax.device_get(model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]))


def hold_grads(got, want):
    for name, g in want.items():
        np.testing.assert_allclose(np.asarray(got[f"model.{name}"]),
                                   g.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


TP_CASES = (2, 1)  # KV heads: divide tp = 2, and do not
# transformers' LlamaForCausalLM on an HF directory, in a process of its
# own (importing transformers takes ~15 s here); exit code 3 where
# transformers is not importable
HF_LOGITS = """
import sys
import numpy as np
import torch
try:
    import transformers
except ImportError:
    sys.exit(3)
torch.set_num_threads(2)
path, ids, out = sys.argv[1:]
model = transformers.LlamaForCausalLM.from_pretrained(
    path, torch_dtype=torch.float32)
with torch.no_grad():
    np.save(out, model(torch.from_numpy(np.load(ids))).logits.numpy())
"""
_BACKGROUND = {}


def hf_logits(directory, state, ids):
    """Write an HF directory of ``state`` under ``directory`` and run
    :data:`HF_LOGITS` on it: transformers' logits of ``ids``, or None."""
    path = str(directory / "hf-llama")
    port_sdf.save_hf_llama(path, port_config(num_key_value_heads=2), state)
    np.save(directory / "hf-ids.npy", ids)
    out = subprocess.run(
        [sys.executable, "-c", HF_LOGITS, path, str(directory / "hf-ids.npy"),
         str(directory / "hf-logits.npy")],
        env=dict(os.environ, USE_TF="0", USE_FLAX="0"), capture_output=True,
        text=True, timeout=600)
    if out.returncode == 3:
        return None
    assert out.returncode == 0, out.stderr
    return np.load(directory / "hf-logits.npy")


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """Started when this module's first test runs, so that they work
    while the JAX references compile, and shared by the test workers
    (``torch_ranks.cached``): ``tests/torch_ranks.py:llama`` on one spawn
    of 2 gloo ranks (ZeRO stage 3 on ``{"data": 2}``, then the tp=2
    cases), and :func:`hf_logits`."""
    ids, mask = generate_inputs()
    args = {"zero": {"kv": 2, "weights": weights(2),
                     "batches": global_batches(ROWS),
                     "config": zero_config(
                         3, stage3_param_persistence_threshold=0)},
            "tp": [{"kv": kv, "weights": weights(kv), "ids": ids,
                    "mask": mask, "new": NEW,
                    "batches": global_batches(ROWS)[:1],
                    "config": {**zero_config(0),
                               "train_micro_batch_size_per_gpu": ROWS},
                    "partition": kv == 2}
                   for kv in TP_CASES],
            "gpt2": gpt2_weights()}
    state = port_model(2).state_dict()
    jobs = {"ranks": lambda d: torch_ranks.run_ranks(
                torch_ranks.llama, 2, d / "llama", args),
            "hf": lambda d: hf_logits(d, state, ids_of(2, seed=5))}

    def run(name, job):
        try:
            _BACKGROUND[name] = torch_ranks.cached(
                tmp_path_factory, f"llama-{name}", job)
        except BaseException as e:  # raised in the tests that need it
            _BACKGROUND[f"{name}-error"] = e

    threads = [threading.Thread(target=run, args=item, daemon=True)
               for item in jobs.items()]
    for t in threads:
        t.start()
    _BACKGROUND["threads"] = threads
    yield
    for t in threads:  # no process outlives the module
        t.join()


def background_result(name):
    for t in _BACKGROUND["threads"]:
        t.join()
    if f"{name}-error" in _BACKGROUND:
        raise _BACKGROUND[f"{name}-error"]
    return _BACKGROUND[name]


def llama_ranks():
    """Each rank's results of ``tests/torch_ranks.py:llama``."""
    return background_result("ranks")


@pytest.mark.parametrize("stage", [0, 3])
def test_training_matches_jax_engine(stage):
    """3 steps of bench.py's keys (AdamW, clip 1.0, "dots" remat, fused
    step) on 4-row batches: stage 0 here, stage 3 on 2 gloo ranks of 2
    rows each with every weight split. Step-1 gradients, reduced and
    gathered by the stage."""
    if stage == 0:
        grads, losses, _, _ = torch_ranks._llama_train(
            llama_training_model_from_jax(
                weights(2), port_config(num_key_value_heads=2, **REMAT)),
            {**zero_config(0), "train_micro_batch_size_per_gpu": ROWS},
            None, global_batches(ROWS))
    else:
        ranks = llama_ranks()
        grads, losses, counts, plan = ranks[0]["zero"]
        assert counts == plan
        for r in ranks[1:]:
            assert r["zero"][1] == losses
            assert r["zero"][2] == r["zero"][3]  # collectives = the plan
    np.testing.assert_allclose(losses, jax_losses(2), rtol=RTOL)
    hold_grads(grads, jax_reference(2)[1])


@pytest.mark.parametrize("kv", TP_CASES, ids=["kv_split", "kv_whole"])
def test_tensor_parallel_matches_jax(kv):
    """tp=2: both ranks' tokens equal the JAX engine's, greedy and
    padded; one training step's loss and step-1 gradients equal the JAX
    loss and ``jax.grad``'s; collectives = the plan; with
    ``partition_activations`` the same loss and one all-gather a block.
    With 1 KV head attention stays whole on every rank and only the MLP
    and the vocabulary split."""
    ranks = [r[f"tp-kv{kv}"] for r in llama_ranks()]
    want = jax_generate(kv)
    loss, grads = jax_reference(kv)
    for r in ranks:
        assert r["greedy"] == want["greedy"]
        assert r["padded"] == want["padded"]
        assert r["counts"] == r["plan"]
        np.testing.assert_allclose(r["losses"], [loss], rtol=RTOL)
        hold_grads(r["grads"], grads)
    split_attn = any("self_attn" in n for n in ranks[0]["split"])
    assert split_attn == (kv == 2)
    if kv == 2:  # partition_activations: the same loss, one all-gather a
        for r in ranks:  # block (the saved inputs' rows), as planned
            losses, counts, plan = r["partitioned"]
            assert losses == r["losses"]
            assert counts == plan and plan["all_gather"] == 2
    assert ranks[0]["kv_heads"] == (kv // 2 if kv % 2 == 0 else kv)
    assert "embed_tokens" in ranks[0]["split"]
    assert any("mlp.down_proj" in n for n in ranks[0]["split"])


def test_full_remat_plans_count_the_recompute():
    """Under "full" remat a tp=2 step's recompute issues the attention's
    g again, not the MLP's (it ends the block, and the recompute stops
    once backward has what it needs): the collectives equal the plan, for
    Llama (its losses those of "dots") and for GPT-2."""
    for r in llama_ranks():
        losses, counts, plan = r["tp-kv2"]["full"]
        assert losses == r["tp-kv2"]["losses"]
        assert counts == plan
        losses, counts, plan = r["gpt2-full"]
        assert counts == plan


# ---------------------------------------------------------------------------
# HF checkpoints
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """An HF-named ``.bin`` Llama directory (GQA, random weights)."""
    cfg = port_config(num_key_value_heads=2)
    path = tmp_path_factory.mktemp("hf-llama")
    port_sdf.save_hf_llama(str(path), cfg, port_model(2).state_dict())
    return str(path)


def test_load_hf_llama_matches_jax(hf_dir):
    jcfg, jparams = jax_sdf.load_hf_llama(hf_dir)
    pcfg, state = port_sdf.load_hf_llama(hf_dir)
    fields = ("vocab_size", "hidden_size", "intermediate_size",
              "num_hidden_layers", "num_attention_heads", "kv_heads",
              "rope_theta", "rms_norm_eps", "max_position_embeddings",
              "tie_word_embeddings")
    assert [getattr(pcfg, f) for f in fields] == \
        [getattr(jcfg, f) for f in fields]
    want = llama_params_from_jax(jparams, pcfg)
    assert sorted(state) == sorted(want)
    for name, t in want.items():
        assert torch.equal(state[name], t), name


def test_from_pretrained_matches_jax(hf_dir):
    ids = ids_of(2, seed=5)
    jmodel, jparams, arch = deepspeed_tpu.inference.load_pretrained(hf_dir)
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(ids)))
    engine = from_pretrained(hf_dir, dtype=torch.float32, device="cpu")
    assert arch == "llama" and engine.policy.name == "llama"
    got = engine(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        source = port_model(2)(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, source, atol=1e-5, rtol=1e-5)


def test_from_pretrained_matches_transformers(hf_dir):
    """Against ``LlamaForCausalLM`` on the same files (run in the
    background, :func:`hf_logits`); skipped where transformers is not
    importable."""
    want = background_result("hf")
    if want is None:
        pytest.skip("transformers is not importable")
    ids = ids_of(2, seed=5)
    got = from_pretrained(hf_dir, dtype=torch.float32, device="cpu")(
        torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=3e-4)


def test_detect_arch_and_later_families():
    names = {"gpt2": "transformer.h.0.attn.c_attn.weight",
             "opt": "model.decoder.layers.0.self_attn.q_proj.weight",
             "bloom": "transformer.h.0.self_attention.query_key_value.weight",
             "llama": "model.layers.0.mlp.gate_proj.weight",
             "gptj": "transformer.h.0.mlp.fc_in.weight",
             "gpt-neo": "transformer.h.0.attn.attention.q_proj.weight",
             "gpt-neox": "gpt_neox.layers.0.attention.query_key_value.weight",
             "bert": "bert.encoder.layer.0.attention.self.query.weight",
             "clip": "vision_model.encoder.layers.0.mlp.fc1.weight",
             None: "something.else"}
    for arch, name in names.items():
        sd = {name: np.zeros(1)}
        assert port_sdf.detect_arch(sd) == jax_sdf.detect_arch(sd) == arch
    for arch, item in (("gpt2", "[12.1]"), ("gpt-neox", "[12.1]"),
                       ("clip", "[12.5]")):
        with pytest.raises(NotImplementedError, match=re_escape(item)):
            from_pretrained({names[arch]: np.zeros((2, 2))}, device="cpu")
    with pytest.raises(ValueError, match="unsupported architecture"):
        from_pretrained({"something.else": np.zeros(1)}, device="cpu")


def re_escape(text):
    import re

    return re.escape(text)


# ---------------------------------------------------------------------------
# F3: GPT-2's attn_layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
def test_gpt2_attn_layout_matches_jax(layout):
    """Both packages build GPT-2 with either layout and give the same
    logits; the port's value is inert (its attention reads [B, T, H, D]
    views either way)."""
    jcfg = jax_gpt2.GPT2Config.tiny(dtype=jnp.float32, attn_layout=layout)
    pcfg = port_gpt2.GPT2Config.tiny(dtype=torch.float32, attn_layout=layout)
    assert pcfg.attn_layout == jcfg.attn_layout == layout
    ids = ids_of(2, seed=6)
    jmodel = jax_gpt2.GPT2LMHeadModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    model = port_gpt2.GPT2LMHeadModel(pcfg, device="meta")
    model.load_state_dict(params_from_jax(_plain(jax.device_get(params)),
                                          pcfg), assign=True)
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
