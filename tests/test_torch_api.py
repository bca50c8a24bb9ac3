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
- ``inference/engine.py``: ``warn_inert_options``.
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
