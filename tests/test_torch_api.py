"""The port's API surface against the JAX package's: the same argv, the
same config dicts, the same JSON through the encoder and the same log
levels give the same results.

- ``__init__.py``: ``add_config_arguments``, ``default_inference_config``;
- ``runtime/lr_schedules.py``: ``add_tuning_arguments``,
  ``parse_arguments``, ``get_config_from_args``, ``get_lr_from_config``;
- ``runtime/config_utils.py``: ``get_scalar_param``, ``get_list_param``,
  ``get_dict_param``, ``ScientificNotationEncoder``;
- ``utils/logging.py``: ``warn_once``, ``print_rank_0``,
  ``get_current_level``, ``should_log_le``;
- ``inference/engine.py``: ``warn_inert_options``; the inference engine's
  ``profile_model_time`` / ``model_times`` / ``train`` / ``eval`` /
  ``destroy``;
- ``runtime/engine.py``: the training engine's remaining surface on the
  tiny fp32 BERT (one device, the same config and weights): the config
  getters, ``get_batch_info`` around ``set_train_batch_size`` and its
  error, ``describe_topology``, ``spec_layout``, ``train`` / ``eval``,
  ``allreduce_gradients``, ``destroy``, and ``eval_batch`` (its loss
  within 1e-5 of JAX's, every parameter, optimizer slot, gradient and
  counter of the port's engine bit-equal after it); the getters of
  unported slices raise naming the slice.
"""

import argparse
import json
import re
import sys

import pytest

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import engine as jax_engine_mod
from deepspeed_tpu.inference.config import \
    DeepSpeedInferenceConfig as JaxInferenceConfig
from deepspeed_tpu.runtime import config_utils as jax_cu
from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.utils import logging as jax_logging
from deepspeed_tpu_torch.inference import engine as engine_mod
from deepspeed_tpu_torch.inference.config import (UNPORTED,
                                                  DeepSpeedInferenceConfig)
from deepspeed_tpu_torch.runtime import config_utils as cu
from deepspeed_tpu_torch.runtime import lr_schedules as lr
from deepspeed_tpu_torch.utils import logging as port_logging

PKGS = {"jax": (deepspeed_tpu, jax_lr, jax_cu, jax_logging),
        "port": (deepspeed_tpu_torch, lr, cu, port_logging)}


def _both(fn):
    """``fn(package, lr_schedules, config_utils, logging)`` for each
    package."""
    return [fn(*PKGS[name]) for name in ("jax", "port")]


# ---------------------------------------------------------------------------
# argument parsers
# ---------------------------------------------------------------------------
CONFIG_ARGVS = ([], ["--deepspeed"],
                ["--deepspeed", "--deepspeed_config", "ds.json"],
                ["--deepscale", "--deepscale_config", "old.json",
                 "--deepspeed_mpi"])


@pytest.mark.parametrize("argv", CONFIG_ARGVS)
def test_add_config_arguments_matches_jax(argv):
    jax, port = _both(lambda pkg, *_: vars(pkg.add_config_arguments(
        argparse.ArgumentParser()).parse_args(argv)))
    assert port == jax


TUNING_ARGVS = {
    "none": [],
    "one_cycle": ["--lr_schedule", "OneCycle", "--cycle_max_lr", "0.3",
                  "--cycle_first_stair_count", "4"],
    "range_test": ["--lr_schedule", "LRRangeTest",
                   "--lr_range_test_staircase", "yes",
                   "--lr_range_test_step_size", "50"],
    "warmup": ["--lr_schedule", "WarmupLR", "--warmup_type", "linear",
               "--warmup_num_steps", "10"],
    "warmup_decay": ["--lr_schedule", "WarmupDecayLR",
                     "--total_num_steps", "99", "--warmup_max_lr", "0.02"],
    "unknown_schedule": ["--lr_schedule", "Cosine"],
    "extra_flags": ["--lr_schedule", "WarmupLR", "--foo", "1", "bar"],
}


@pytest.mark.parametrize("case", list(TUNING_ARGVS))
def test_tuning_arguments_match_jax(monkeypatch, case):
    """``parse_arguments`` on the same argv: the same args and unknown
    args, and ``get_config_from_args`` the same config or error; a parser
    given ``add_tuning_arguments`` parses the same."""
    argv = TUNING_ARGVS[case]
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)

    def run(_, sched, *rest):
        args, unknown = sched.parse_arguments()
        own, _ = sched.add_tuning_arguments(
            argparse.ArgumentParser()).parse_known_args(argv)
        return vars(args), unknown, vars(own), \
            sched.get_config_from_args(args)

    jax, port = _both(run)
    assert port == jax


LR_CONFIGS = (
    {"type": "OneCycle", "params": {"cycle_min_lr": 0.01,
                                    "cycle_max_lr": 0.4}},
    {"type": "OneCycle", "params": {}},
    {"type": "LRRangeTest", "params": {"lr_range_test_min_lr": 0.002}},
    {"type": "WarmupLR", "params": {"warmup_max_lr": 0.05}},
    {"type": "WarmupDecayLR", "params": {}},
    {"type": "Cosine", "params": {}},
    {"type": "WarmupLR"},
    {"params": {}},
)


@pytest.mark.parametrize("config", LR_CONFIGS)
def test_get_lr_from_config_matches_jax(config):
    jax, port = _both(lambda _, sched, *rest:
                      sched.get_lr_from_config(config))
    assert port == jax


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_default_inference_config_matches_jax():
    """The same values on every key both have; the JAX keys the port
    lacks are its unported sections."""
    jax, port = _both(lambda pkg, *_: pkg.default_inference_config())
    assert set(port) <= set(jax)
    assert set(jax) - set(port) <= set(UNPORTED) | {
        "base_dir", "checkpoint_config"}
    for key in port:
        if key == "dtype":
            assert str(port[key]) == f"torch.{jax[key].__name__}"
        else:
            assert port[key] == jax[key], key


PARAMS = {"lr": 0.1, "betas": [0.9, 0.99], "sub": {"a": 1}, "flag": False}


@pytest.mark.parametrize("fn", ["get_scalar_param", "get_list_param",
                                "get_dict_param"])
@pytest.mark.parametrize("key", ["lr", "betas", "sub", "flag", "missing"])
def test_get_param_matches_jax(fn, key):
    jax, port = _both(lambda _, __, utils, ___: getattr(utils, fn)(
        PARAMS, key, "default"))
    assert port == jax


DUMPS = ({"train_batch_size": 16, "optimizer": {"type": "Adam", "params": {
    "lr": 1e-5, "betas": [0.9, 0.999], "eps": 1e-8, "weight_decay": 0.01}},
    "fp16": {"enabled": True, "loss_scale_window": 1000,
             "initial_scale_power": 16.0}, "steps": 1e6},
    [0.5, 2e-4, 12345.0, True, None, "x"], 3.5e-9)


@pytest.mark.parametrize("obj", DUMPS)
@pytest.mark.parametrize("indent", [None, 2])
def test_scientific_notation_encoder_matches_jax(obj, indent):
    jax, port = _both(lambda _, __, utils, ___: json.dumps(
        obj, cls=utils.ScientificNotationEncoder, indent=indent))
    assert port == jax


# ---------------------------------------------------------------------------
# logging
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("level", ["debug", "info", "WARNING", "error",
                                   "critical"])
def test_log_levels_match_jax(level):
    jax, port = _both(lambda _, __, ___, log: (
        log.get_current_level(), log.should_log_le(level), log.LOG_LEVELS))
    assert port == jax


@pytest.mark.parametrize("bad", ["verbose", 10])
def test_should_log_le_errors_match_jax(bad):
    def run(_, __, ___, log):
        with pytest.raises(ValueError) as err:
            log.should_log_le(bad)
        return str(err.value)

    jax, port = _both(run)
    assert port == jax


def test_warn_once_and_print_rank_0_match_jax(monkeypatch, capsys):
    def run(_, __, ___, log):
        said = []
        monkeypatch.setattr(log.logger, "warning", said.append)
        for _ in range(3):
            log.warn_once("api parity: said once")
        log.warn_once("api parity: another")
        log.print_rank_0("api parity: rank 0 prints")
        return said, capsys.readouterr().out

    monkeypatch.delenv("RANK", raising=False)
    jax, port = _both(run)
    assert port == jax
    assert port[0] == ["api parity: said once", "api parity: another"]


INERT_KWARGS = dict(enable_cuda_graph=True, triangular_masking=False,
                    set_empty_params=True, training_mp_size=2,
                    return_tuple=False, min_out_tokens=4,
                    transposed_mode=True, replace_with_kernel_inject=False)


def test_warn_inert_options_matches_jax(monkeypatch):
    """The same keys named, in the same words, from the same config; a
    key set to its default is not named."""
    def notes(module, config):
        said = []
        monkeypatch.setattr(module, "log_dist",
                            lambda msg, ranks=None: said.append(msg))
        module.warn_inert_options(config)
        return said

    jax = notes(jax_engine_mod, JaxInferenceConfig(**INERT_KWARGS))
    port = notes(engine_mod, DeepSpeedInferenceConfig(**INERT_KWARGS))
    pattern = r"^inference config '(\w+)' has no effect on this backend: "
    names = [{re.match(pattern, m).group(1) for m in said}
             for said in (jax, port)]
    assert names[0] == names[1] == set(INERT_KWARGS) - {
        "replace_with_kernel_inject"}


# ---------------------------------------------------------------------------
# the training engine's remaining surface
# ---------------------------------------------------------------------------
API_ZERO = {"stage": 0, "reduce_bucket_size": 1234,
            "allgather_bucket_size": 5678, "overlap_comm": True,
            "sub_group_size": 99, "stage3_prefetch_bucket_size": 77,
            "stage3_max_live_parameters": 55,
            "stage3_max_reuse_distance": 44,
            "stage3_param_persistence_threshold": 33,
            "stage3_model_persistence_threshold": 22,
            "stage3_gather_16bit_weights_on_model_save": True,
            "round_robin_gradients": True, "contiguous_gradients": False,
            "reduce_scatter": False, "allgather_partitions": False,
            "load_from_fp32_weights": False, "elastic_checkpoint": True,
            "ignore_unused_parameters": False}
API_CONFIG = {
    "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 1,
    "optimizer": {"type": "Adam", "params": {"lr": 1e-4,
                                             "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 10}},
    "gradient_clipping": 1.0, "fused_step": True,
    "fp16": {"enabled": False, "loss_scale_window": 500,
             "initial_scale_power": 12, "hysteresis": 3,
             "min_loss_scale": 2},
    "zero_optimization": API_ZERO, "steps_per_print": 10_000}
GETTERS = ("optimizer_name", "optimizer_params", "scheduler_name",
           "scheduler_params", "dynamic_loss_scale",
           "dynamic_loss_scale_args", "zero_allgather_partitions",
           "zero_reduce_scatter", "zero_overlap_comm",
           "zero_contiguous_gradients", "zero_sub_group_size",
           "zero_prefetch_bucket_size", "zero_param_persistence_threshold",
           "zero_model_persistence_threshold", "zero_max_live_parameters",
           "zero_max_reuse_distance",
           "zero_gather_16bit_weights_on_model_save",
           "zero_ignore_unused_parameters", "zero_legacy_stage1",
           "zero_round_robin_gradients", "zero_elastic_checkpoint",
           "zero_load_from_fp32_weights", "zero_reduce_bucket_size",
           "zero_allgather_bucket_size", "zero_optimization_stage",
           "zero_optimization_partition_gradients",
           "zero_optimization_partition_weights", "get_batch_info",
           "dump_state", "elasticity_enabled", "use_node_local_storage")


def _bert_batch(seed, t=16):
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 256, (2, t)).astype(np.int32)
    labels = np.where(rng.random(ids.shape) < 0.15, ids, -100)
    return {"input_ids": ids, "labels": labels.astype(np.int32)}


@pytest.fixture(scope="module")
def engines():
    """``(jax engine, port engine)`` on the tiny fp32 BERT from the same
    weights and config, each after one step on the same batch."""
    import jax
    import jax.numpy as jnp
    import torch

    from deepspeed_tpu.models import bert as jax_bert
    from deepspeed_tpu.parallel.topology import MeshTopology, reset_topology
    from deepspeed_tpu_torch.models.bert import BertConfig
    from deepspeed_tpu_torch.utils.params import bert_training_model_from_jax

    jmodel = jax_bert.BertForTraining(jax_bert.BertConfig.tiny(
        dtype=jnp.float32, scan_layers=False))
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8), jnp.int32)))
    reset_topology()
    topo = MeshTopology(axis_sizes={"data": 1}, devices=jax.devices()[:1])
    jax_engine, *_ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=params["params"], mesh=topo,
        config=API_CONFIG)
    port_engine, *_ = deepspeed_tpu_torch.initialize(
        model=bert_training_model_from_jax(
            params, BertConfig.tiny(dtype=torch.float32, scan_layers=False)),
        config=API_CONFIG, device="cpu")
    for engine in (jax_engine, port_engine):
        engine.backward(engine(_bert_batch(0)))
        engine.step()
    return jax_engine, port_engine


@pytest.mark.parametrize("name", GETTERS)
def test_engine_getters_match_jax(engines, name):
    jax_engine, port_engine = engines
    assert getattr(port_engine, name)() == getattr(jax_engine, name)()


UNPORTED_GETTERS = {"zero_offload_param": "offload",
                    "zero_cpu_offload": "offload",
                    "eigenvalue_max_iter": "training-features",
                    "curriculum_learning_enabled": "training-features",
                    "get_pld_theta": "training-features",
                    "flops_profiler_enabled": "training-features"}


@pytest.mark.parametrize("name", sorted(UNPORTED_GETTERS))
def test_getters_of_unported_slices_raise(engines, name):
    with pytest.raises(NotImplementedError,
                       match=f"{name} .*{UNPORTED_GETTERS[name]} slice"):
        getattr(engines[1], name)()


def test_set_train_batch_size_matches_jax(engines):
    """Only the accumulation factor changes; a size the micro-batch does
    not divide raises JAX's error; the engines are restored."""
    out = []
    for engine in engines:
        before = engine.get_batch_info()
        engine.set_train_batch_size(6)
        after = engine.get_batch_info()
        with pytest.raises(Exception) as err:
            engine.set_train_batch_size(5)
        engine.set_train_batch_size(2)
        out.append((before, after, type(err.value).__name__,
                    str(err.value), engine.get_batch_info(),
                    engine._fused_step))
    assert out[1] == out[0]
    assert out[1][:2] == ((2, 2, 1), (6, 2, 3))


def test_describe_topology_matches_jax(engines):
    """The same mesh, world, stage, batch geometry, counters and key;
    the same tensors under the same names (the checkpoint file's, JAX's
    flax paths) with the same whole shapes, dtypes and specs."""
    jax_engine, port_engine = engines
    want = jax_engine.describe_topology(include_data=False)
    got = port_engine.describe_topology(include_data=False)
    for key in ("version", "mesh", "zero_stage", "batch", "counters",
                "format", "rng"):
        assert got[key] == want[key], key
    assert got["data_pipeline"] is None
    assert got["tensors"] == want["tensors"]


def test_spec_layout_matches_jax(engines):
    jax_engine, port_engine = engines
    want, got = jax_engine.spec_layout, port_engine.spec_layout
    assert dict(got.mesh.shape) == dict(want.mesh.shape)
    assert got.tp_size == want.tp_size == 1
    assert got.describe() == want.describe()


def test_train_eval_and_allreduce_match_jax(engines):
    for engine in engines:
        assert engine.eval() is engine and engine.module_train is False
        assert engine.train() is engine and engine.module_train is True
        assert engine.allreduce_gradients() is None
    assert engines[1].module.training


def test_eval_batch_matches_jax_and_leaves_the_state(engines):
    """``eval_batch``'s loss within 1e-5 of JAX's; the port's parameters,
    optimizer slots, gradients, loss scale and counters bit-equal after
    it."""
    import numpy as np
    import torch

    jax_engine, port_engine = engines
    batch = _bert_batch(1)
    params = {n: p.detach().clone()
              for n, p in port_engine.module.named_parameters()}
    state = [t.clone() if isinstance(t, torch.Tensor) else
             [x.clone() for x in t] if isinstance(t, list) else t
             for t in port_engine._opt_state]
    counters = (port_engine.global_steps, port_engine.micro_steps,
                port_engine.global_samples, port_engine.skipped_steps,
                port_engine._applied_steps, port_engine.loss_scale)
    got = float(port_engine.eval_batch(batch))
    want = float(jax_engine.eval_batch(batch))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for n, p in port_engine.module.named_parameters():
        assert torch.equal(p, params[n]) and p.grad is None, n
    for before, after in zip(state, port_engine._opt_state):
        if isinstance(before, list):
            assert all(torch.equal(a, b) for a, b in zip(after, before))
        else:
            assert after == before
    assert counters == (port_engine.global_steps, port_engine.micro_steps,
                        port_engine.global_samples,
                        port_engine.skipped_steps,
                        port_engine._applied_steps, port_engine.loss_scale)


def test_destroy_drops_the_optimizer_state():
    import torch

    from deepspeed_tpu_torch.models.bert import BertConfig, BertForTraining

    engine, *_ = deepspeed_tpu_torch.initialize(
        model=BertForTraining(BertConfig.tiny(dtype=torch.float32)),
        config=API_CONFIG, device="cpu")
    engine.destroy()
    assert engine._opt_state is None and engine._zero is None


def test_inference_model_times_match_jax():
    """Each forward is timed into the list ``model_times`` drains, in
    both packages; ``use_cuda_events`` warns; ``train`` / ``eval`` return
    the engine; the port times ``generate`` too and ``destroy`` drops
    the list."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from deepspeed_tpu.models import gpt2 as jax_gpt2
    from deepspeed_tpu_torch.models.gpt2 import (GPT2Config,
                                                 GPT2LMHeadModel)
    from deepspeed_tpu_torch.utils.params import params_from_jax

    cfg = jax_gpt2.GPT2Config.tiny(dtype=jnp.float32)
    jmodel = jax_gpt2.GPT2LMHeadModel(cfg)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 8), jnp.int32)))
    pcfg = GPT2Config.tiny()
    pmodel = GPT2LMHeadModel(pcfg, device="meta")
    pmodel.load_state_dict(params_from_jax(params, pcfg), assign=True)
    ids = np.array([[3, 1, 4, 1, 5]])
    out = []
    for engine in (deepspeed_tpu.init_inference(jmodel, params=params,
                                                dtype="fp32"),
                   deepspeed_tpu_torch.init_inference(pmodel, dtype="fp32",
                                                      device="cpu")):
        with pytest.warns(DeprecationWarning, match="use_cuda_events"):
            engine.profile_model_time(use_cuda_events=True)
        assert engine.model_profile_enabled
        assert engine.eval() is engine and engine.train() is engine
        engine.forward(ids)
        engine.forward_last(ids)
        times = engine.model_times()
        assert all(t > 0 for t in times)
        out.append((len(times), engine.model_times()))
    assert out[1] == out[0] == (2, [])
    engine.generate(ids, max_new_tokens=2)
    assert len(engine.model_times()) == 1
    engine.forward(ids)
    engine.destroy()
    assert engine.model_times() == []
