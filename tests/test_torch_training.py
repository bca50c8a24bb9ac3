"""The port's training path against the JAX package's, on the CPU.

The same weights (the JAX model's own init, converted with
``params_from_jax``) and the same numpy batches go through
``deepspeed_tpu.initialize`` and ``deepspeed_tpu_torch.initialize`` with
the bench's optimizer, clipping and step keys, at ``GPT2Config.tiny`` in
float32. Tolerances, with their reasons:

- losses and global gradient norms: 1e-5 relative — the same fp32 math
  summed in other orders (measured agreement ~1e-6);
- parameters after three AdamW steps: at least 99.9 % of the elements
  within 1e-5, and every element within ``2 * lr * steps``. Adam divides
  ``m`` by ``sqrt(v)``: for a gradient element near zero, a rounding-level
  difference can flip its sign, and the step then moves that element by
  up to ``2 * lr`` in the other direction. That bound is the honest worst
  case; the 99.9 % clause keeps the check tight everywhere else;
- single ops (loss heads, optimizer updates, schedules): 1e-5 / 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import gpt2 as jax_gpt2
from deepspeed_tpu.ops import optimizer as jax_opt
from deepspeed_tpu.parallel.topology import MeshTopology, reset_topology
from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.runtime import utils as jax_utils
from deepspeed_tpu.runtime.fp16 import loss_scaler as jax_scaler
from deepspeed_tpu_torch.models import gpt2 as port_gpt2
from deepspeed_tpu_torch.ops import flash_attention as port_flash
from deepspeed_tpu_torch.ops import optimizer as port_opt
from deepspeed_tpu_torch.runtime import lr_schedules as port_lr
from deepspeed_tpu_torch.runtime import utils as port_utils
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                DeepSpeedConfigError)
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as port_scaler
from deepspeed_tpu_torch.utils.params import (params_from_jax,
                                              training_model_from_jax)

B, T, LR = 2, 16, 6e-4
RTOL = 1e-5


def bench_config(gas=1, fused=True):
    """bench.py's engine keys at a tiny batch, fp32."""
    return {"train_micro_batch_size_per_gpu": B,
            "gradient_accumulation_steps": gas,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": LR, "weight_decay": 0.1}},
            "gradient_clipping": 1.0,
            "bf16": {"enabled": False},
            "fused_step": fused,
            "zero_optimization": {"stage": 0},
            "steps_per_print": 10_000}


def batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (B, T)).astype(np.int32) for _ in range(n)]


def jax_config(**kw):
    return jax_gpt2.GPT2Config.tiny(dtype=jnp.float32, **kw)


def port_config(**kw):
    return port_gpt2.GPT2Config.tiny(dtype=torch.float32, **kw)


@pytest.fixture(scope="module")
def jax_params():
    model = jax_gpt2.GPT2ForTraining(jax_config())
    return jax.device_get(model.init(jax.random.PRNGKey(0),
                                     jnp.asarray(batches(1)[0]))["params"])


# ---------------------------------------------------------------------------
# whole steps: the engines side by side
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gas,fused", [(1, True), (2, False)],
                         ids=["fused_step", "gas2"])
def test_whole_step_matches_jax_engine(jax_params, gas, fused):
    """Three optimizer steps of the bench config (dots remat, AdamW,
    clip 1.0) from the same weights: losses of every micro-step, the
    pre-clip grad norm of every step and the final parameters agree."""
    reset_topology()
    topo = MeshTopology(axis_sizes={"data": 1}, devices=jax.devices()[:1])
    remat = dict(remat=True, remat_policy="dots")
    jax_engine, *_ = deepspeed_tpu.initialize(
        model=jax_gpt2.GPT2ForTraining(jax_config(**remat)),
        model_parameters=jax_params, mesh=topo,
        config=bench_config(gas, fused))
    port_engine, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=training_model_from_jax(jax_params, port_config(**remat)),
        config=bench_config(gas, fused), device="cpu")
    assert isinstance(opt, port_opt.FusedAdam) and loader is None \
        and sched is None
    losses, norms = [], []
    for i, ids in enumerate(batches(3 * gas)):
        pair = []
        for engine in (jax_engine, port_engine):
            loss = engine({"input_ids": ids})
            engine.backward(loss)
            engine.step()
            pair.append(float(loss))
        losses.append(pair)
        if (i + 1) % gas == 0:
            norms.append([jax_engine.get_global_grad_norm(),
                          port_engine.get_global_grad_norm()])
            assert port_engine.was_step_applied()
    losses, norms = np.array(losses), np.array(norms)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=RTOL)
    np.testing.assert_allclose(norms[:, 1], norms[:, 0], rtol=RTOL)
    assert port_engine.global_steps == 3
    assert port_engine.micro_steps == 3 * gas

    want = params_from_jax(jax.device_get(jax_engine.state.params),
                           port_config())
    got = port_engine.module_state_dict()
    diff = torch.cat([(got[f"model.{k}"] - v).abs().flatten()
                      for k, v in want.items()])
    assert (diff <= 1e-5).float().mean() >= 0.999
    assert diff.max() <= 2 * LR * 3


@pytest.mark.parametrize("policy", [None, "full", "dots"])
def test_gradients_match_jax_grad(jax_params, policy):
    """One backward of the training loss: every parameter's gradient,
    the tied ``wte`` one included (its lookup and LM-head parts summed),
    equals ``jax.grad`` of the JAX loss, under each remat policy. "dots"
    saves the flash forward's outputs: one forward per layer, as without
    remat; "full" runs it again in backward."""
    remat = {} if policy is None else dict(remat=True, remat_policy=policy)
    ids = batches(1, seed=3)[0]
    jax_model = jax_gpt2.GPT2ForTraining(jax_config(**remat))
    ref = jax.grad(jax_model.loss_fn)(jax.tree_util.tree_map(
        jnp.asarray, jax_params), (jnp.asarray(ids), jnp.asarray(ids)))
    model = training_model_from_jax(jax_params, port_config(**remat))
    calls = []
    plain = port_flash.flash_attention_reference

    def counted(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    with mock.patch.object(port_flash, "flash_attention_reference", counted):
        model({"input_ids": torch.from_numpy(ids)}).backward()
    n_layer = model.config.n_layer
    assert len(calls) == (2 * n_layer if policy == "full" else n_layer)
    want = params_from_jax(jax.device_get(ref), model.config)
    for name, p in model.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_train_batch_overflow_skip_and_state_dict(jax_params):
    """``train_batch`` runs the gas micro-steps and the step like the
    public seams do; an fp16 overflow (a static scale that turns the
    gradients inf) skips the update and leaves the weights as they were;
    ``load_module_state_dict`` restores a ``module_state_dict``."""
    ids = batches(2)

    def engine(**extra):
        return deepspeed_tpu_torch.initialize(
            model=training_model_from_jax(jax_params, port_config()),
            config={**bench_config(gas=2, fused=False), **extra},
            device="cpu")[0]

    seams, whole = engine(), engine()
    losses = []
    for x in ids:
        losses.append(float(seams({"input_ids": x})))
        seams.backward()
        seams.step()
    mean = whole.train_batch(data_iter=iter({"input_ids": x} for x in ids))
    np.testing.assert_allclose(mean, np.mean(losses), rtol=1e-6)
    assert whole.global_steps == 1 and whole.was_step_applied()
    for k, v in seams.module_state_dict().items():
        torch.testing.assert_close(whole.module_state_dict()[k], v, rtol=0,
                                   atol=0)

    skipped = engine(fp16={"enabled": True, "loss_scale": 1e38})
    before = skipped.module_state_dict()
    skipped.train_batch(batch={"input_ids": ids[0]})
    assert not skipped.was_step_applied() and skipped.get_skipped_steps() == 1
    for k, v in skipped.module_state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    skipped.load_module_state_dict(seams.module_state_dict())
    for k, v in seams.module_state_dict().items():
        torch.testing.assert_close(skipped.module_state_dict()[k], v,
                                   rtol=0, atol=0)


def test_first_loss_is_log_vocab(jax_params):
    model = training_model_from_jax(jax_params, port_config())
    with torch.no_grad():
        loss = model({"input_ids": torch.from_numpy(batches(1)[0])})
    assert abs(float(loss) - np.log(256)) < 0.1


# ---------------------------------------------------------------------------
# the LM-head cross-entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "chunked"])
def test_lm_head_loss_matches_jax(dense):
    """Loss and gradients (hidden, head weight) of the dense and the
    chunked head, ignored labels and a ragged last chunk included."""
    rng = np.random.default_rng(9)
    hidden = rng.normal(size=(2, 20, 32)).astype(np.float32)
    head = (0.2 * rng.normal(size=(64, 32))).astype(np.float32)
    labels = rng.integers(0, 64, (2, 20)).astype(np.int32)
    labels[0, :3] = -100
    kw = dict(dense_budget=10 ** 9 if dense else 0, chunk=8)

    def jax_loss(h, w):
        return jax_gpt2.lm_head_loss(h, w, jax_gpt2.shift_labels(
            jnp.asarray(labels)), **kw)

    ref_loss, ref_grads = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(head))
    h, w = (torch.from_numpy(a).requires_grad_() for a in (hidden, head))
    loss = port_gpt2.lm_head_loss(h, w, port_gpt2.shift_labels(
        torch.from_numpy(labels).long()), **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-6)
    for g, r in zip((h.grad, w.grad), ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-7)


def test_cross_entropy_all_ignored_is_zero():
    logits = torch.randn(1, 3, 5)
    labels = torch.full((1, 3), -100)
    assert float(port_gpt2.cross_entropy_loss(logits, labels)) == 0.0


def test_training_knobs_of_later_slices_raise():
    with pytest.raises(NotImplementedError, match="training-features"):
        port_config(dropout=0.1)
    with pytest.raises(NotImplementedError, match="training-features"):
        port_config(pld=True)
    with pytest.raises(ValueError, match="remat_policy"):
        port_config(remat=True, remat_policy="everything")


# ---------------------------------------------------------------------------
# optimizers, schedules, loss scaling, clipping
# ---------------------------------------------------------------------------
OPTIMIZERS = {
    "adamw": ("adamw", {"lr": 1e-2, "weight_decay": 0.1}),
    "adam_l2": ("adam", {"lr": 1e-2, "weight_decay": 0.1,
                         "adam_w_mode": False}),
    "adam_no_bias_correction": ("adam", {"lr": 1e-2,
                                         "bias_correction": False}),
    "sgd": ("sgd", {"lr": 0.1, "weight_decay": 0.01}),
    "sgd_nesterov": ("sgd", {"lr": 0.1, "momentum": 0.9, "nesterov": True}),
    "lamb": ("lamb", {"lr": 1e-2, "weight_decay": 0.01}),
}


@pytest.mark.parametrize("which", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(which):
    """Three updates from the same parameters and gradients."""
    name, kwargs = OPTIMIZERS[which]
    rng = np.random.default_rng(len(which))
    params = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in params]
             for _ in range(3)]
    jax_o = jax_opt.build_basic_optimizer(name, kwargs)
    port_o = port_opt.build_basic_optimizer(name, kwargs)
    jp = [jnp.asarray(p) for p in params]
    js = jax_o.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = port_o.init(tp)
    for step_grads in grads:
        jp, js = jax_o.update([jnp.asarray(g) for g in step_grads], js, jp)
        ts = port_o.update([torch.from_numpy(g) for g in step_grads], ts,
                           tp)
    assert ts.step == 3
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_one_bit_optimizers_raise():
    with pytest.raises(NotImplementedError, match="compressed-collectives"):
        port_opt.build_basic_optimizer("onebitadam", {})


SCHEDULES = {
    "LRRangeTest": {"lr_range_test_min_lr": 1e-3,
                    "lr_range_test_step_size": 10,
                    "lr_range_test_staircase": True},
    "OneCycle": {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                 "cycle_first_step_size": 20, "cycle_first_stair_count": 4,
                 "decay_step_size": 5, "decay_lr_rate": 0.1},
    "WarmupLR": {"warmup_max_lr": 1e-3, "warmup_num_steps": 30},
    "WarmupDecayLR": {"total_num_steps": 100, "warmup_max_lr": 1e-3,
                      "warmup_num_steps": 30, "warmup_type": "linear"},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_jax(name):
    jax_fn = jax_lr.get_lr_schedule_fn(name, SCHEDULES[name])
    port_fn = port_lr.get_lr_schedule_fn(name, SCHEDULES[name])
    steps = (0, 1, 7, 19, 20, 29, 30, 45, 60, 99, 100, 150)
    np.testing.assert_allclose([port_fn(s) for s in steps],
                               [float(jax_fn(s)) for s in steps], rtol=1e-5)
    sched = getattr(port_lr, name)(None, **SCHEDULES[name])  # class style
    for _ in range(8):
        sched.step()
    assert sched.get_lr() == [port_fn(7)]


def test_dynamic_loss_scale_matches_jax():
    kw = dict(dynamic=True, initial_scale=2.0 ** 8, scale_window=3,
              hysteresis=2, min_scale=1.0)
    jax_cfg, jax_state = jax_scaler.create_loss_scaler(**kw)
    port_cfg, port_state = port_scaler.create_loss_scaler(**kw)
    for overflow in (False, True, True, True, False, False, False, False,
                     True, False):
        jax_state = jax_scaler.update_scale(jax_cfg, jax_state,
                                            jnp.asarray(overflow))
        port_state = port_scaler.update_scale(port_cfg, port_state, overflow)
        assert port_state == (float(jax_state.loss_scale),
                              int(jax_state.good_steps),
                              int(jax_state.hysteresis))
    assert bool(port_scaler.has_inf_or_nan(
        [torch.ones(2), torch.tensor([1.0, float("inf")])]))
    assert not bool(port_scaler.has_inf_or_nan([torch.ones(3)]))


def test_clip_grad_norm_matches_jax():
    rng = np.random.default_rng(2)
    arrays = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (7,))]
    ref, ref_norm = jax_utils.clip_grad_norm_(
        [jnp.asarray(a) for a in arrays], 0.5)
    tensors, norm = port_utils.clip_grad_norm_(
        [torch.from_numpy(a.copy()) for a in arrays], 0.5)
    np.testing.assert_allclose(float(norm), float(ref_norm), rtol=1e-6)
    for got, want in zip(tensors, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
def test_config_batch_triangle():
    cfg = DeepSpeedConfig({"train_batch_size": 32,
                           "train_micro_batch_size_per_gpu": 8})
    assert (cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu,
            cfg.gradient_accumulation_steps) == (32, 8, 4)
    with pytest.raises(DeepSpeedConfigError, match="not equal"):
        DeepSpeedConfig({"train_batch_size": 32,
                         "train_micro_batch_size_per_gpu": 8,
                         "gradient_accumulation_steps": 2})
    with pytest.raises(DeepSpeedConfigError, match="unknown config key"):
        DeepSpeedConfig({"train_batch_size": 1, "no_such_key": 1})


@pytest.mark.parametrize("config,slice_name", [
    ({"mesh": {"tp": 2}}, "multi-GPU"),  # ported: parses (below)
    ({"zero_optimization": {"stage": 0,
                            "offload_optimizer": {"device": "cpu"}}},
     "offload"),
    ({"progressive_layer_drop": {"enabled": True}}, "training-features"),
    ({"compression_training": {}}, "training-features"),
    ({"flops_profiler": {"enabled": True}}, "training-features"),
    ({"telemetry": {"enabled": True}}, "telemetry"),
    ({"checkpoint": {"sharded": True}}, r"\[10b\]"),
    ({"checkpoint": {"async_save": True}}, r"\[10b\]"),
    ({"aot": {"enabled": True}}, r"aot decision \(\[10\]\)"),
    ({"tuning": {"enabled": True}}, "autotuning"),
])
def test_unported_config_keys_raise(config, slice_name):
    if slice_name == "multi-GPU":  # tensor-parallel training is ported
        assert DeepSpeedConfig({"train_batch_size": 1, **config}).mesh.tp == 2
        return
    if slice_name == "telemetry":
        # ported, with its resilience half: each key is accepted and
        # resolved as the JAX config resolves it
        from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxConfig

        assert DeepSpeedConfig({"train_batch_size": 1, **config}) \
            .telemetry_config.enabled
        for good in ({"telemetry": {"flight_recorder": {"enabled": True}}},
                     {"dump_state": True},
                     {"resilience": {"enabled": True,
                                     "sentinel": {"policy": "rollback"}}},
                     {"checkpoint": {"tag_validation": "fail"}},
                     {"nebula": {"enabled": True}},
                     {"elasticity": {"enabled": True}},
                     {"dataloader_drop_last": True}):
            port = DeepSpeedConfig({"train_batch_size": 1, **good})
            jax = JaxConfig({"train_batch_size": 1, **good})
            for attr in ("telemetry_config", "resilience_config",
                         "checkpoint_config", "nebula_config"):
                assert getattr(port, attr).model_dump() == \
                    getattr(jax, attr).model_dump(), (good, attr)
            for attr in ("dump_state", "elasticity_config",
                         "dataloader_drop_last",
                         "checkpoint_tag_validation_enabled",
                         "checkpoint_tag_validation_fail"):
                assert getattr(port, attr) == getattr(jax, attr), \
                    (good, attr)
        return
    with pytest.raises(NotImplementedError, match=slice_name):
        DeepSpeedConfig({"train_batch_size": 1, **config})
