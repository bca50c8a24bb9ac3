"""Training configuration (counterpart of ``deepspeed_tpu/runtime/config.py``).

:class:`DeepSpeedConfig` parses the keys the training engine of this slice
implements: the batch triangle, ``optimizer``, ``scheduler``,
``gradient_clipping``, ``bf16``, ``fp16``, ``fused_step``,
``zero_optimization.stage`` (0 only), ``gradient_accumulation_steps``,
``steps_per_print`` and the ``sparse_attention`` section (handed to the
model's ``with_sparse_attention`` hook by the engine). A key the JAX
config accepts but this port does not implement yet raises
:class:`NotImplementedError` naming the slice of the port that brings it,
instead of being accepted and ignored; a key neither knows raises
:class:`DeepSpeedConfigError`.
"""

import json
import os
from typing import Any, Optional

from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config_utils import \
    dict_raise_error_on_duplicate_keys
from deepspeed_tpu_torch.runtime.precision_config import (BF16Config,
                                                          FP16Config)


class DeepSpeedConfigError(Exception):
    pass


_MULTI_GPU = "the multi-GPU slice"
_TRAINING_FEATURES = "the training-features slice"
# keys of the JAX training config, and the port's slice that will
# implement each (ROADMAP.md, Queue 1)
UNPORTED = {
    "mesh": _MULTI_GPU, "pipeline": "the pipeline slice",
    "tensor_parallel": _MULTI_GPU, "comm_quantization":
        "the compressed-collectives slice",
    "communication_data_type": _MULTI_GPU, "prescale_gradients": _MULTI_GPU,
    "gradient_predivide_factor": _MULTI_GPU, "disable_allgather": _MULTI_GPU,
    "sparse_gradients": _MULTI_GPU,
    "activation_checkpointing": _TRAINING_FEATURES,
    "progressive_layer_drop": _TRAINING_FEATURES,
    "curriculum_learning": _TRAINING_FEATURES,
    "data_efficiency": _TRAINING_FEATURES,
    "compression_training": _TRAINING_FEATURES,
    "quantize_training": _TRAINING_FEATURES,
    "eigenvalue": _TRAINING_FEATURES,
    "flops_profiler": _TRAINING_FEATURES,
    "amp": _TRAINING_FEATURES, "data_types": _TRAINING_FEATURES,
    "wall_clock_breakdown": "the telemetry slice",
    "memory_breakdown": "the telemetry slice",
    "telemetry": "the telemetry slice", "comms_logger": "the telemetry slice",
    "tensorboard": "the telemetry slice", "wandb": "the telemetry slice",
    "csv_monitor": "the telemetry slice",
    "resilience": "the resilience slice",
    "checkpoint": "the checkpoint slice", "nebula": "the checkpoint slice",
    "elasticity": "the checkpoint slice", "aot": "the checkpoint slice",
    "dataloader_drop_last": "the checkpoint slice",
    "tuning": "the autotuning slice", "autotuning": "the autotuning slice",
    "aio": "the offload slice",
    "zero_allow_untested_optimizer": _MULTI_GPU,
    "dump_state": "the telemetry slice",
}
_ZERO_KEYS_SLICE = {"offload_optimizer": "the offload slice",
                    "offload_param": "the offload slice"}
SUPPORTED = frozenset({
    C.TRAIN_BATCH_SIZE, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
    C.GRADIENT_ACCUMULATION_STEPS, C.OPTIMIZER, C.SCHEDULER,
    C.GRADIENT_CLIPPING, C.FP16, C.BF16, C.BFLOAT16, C.ZERO_OPTIMIZATION,
    C.FUSED_STEP, C.STEPS_PER_PRINT, C.SPARSE_ATTENTION})


def _resolve_batch_triangle(train_batch, micro_batch, gas, dp_world_size):
    """Resolve/validate train_batch = micro_batch * gas * dp_world (any
    two given determine the third; one given fills the others)."""
    tb, mb, g = train_batch, micro_batch, gas
    if tb is not None and mb is not None and g is not None:
        if tb != mb * g * dp_world_size:
            raise DeepSpeedConfigError(
                f"Check batch related parameters. train_batch_size is not "
                f"equal to micro_batch_per_gpu * gradient_acc_step * "
                f"world_size {tb} != {mb} * {g} * {dp_world_size}")
    elif tb is not None and mb is not None:
        g, rem = divmod(tb, mb * dp_world_size)
        if rem != 0:
            raise DeepSpeedConfigError(
                f"train_batch_size {tb} not divisible by micro_batch {mb} "
                f"* world size {dp_world_size}")
    elif tb is not None and g is not None:
        mb, rem = divmod(tb, g * dp_world_size)
        if rem != 0:
            raise DeepSpeedConfigError(
                f"train_batch_size {tb} not divisible by gas {g} * world "
                f"size {dp_world_size}")
    elif mb is not None and g is not None:
        tb = mb * g * dp_world_size
    elif tb is not None:
        g = 1
        mb, rem = divmod(tb, dp_world_size)
        if rem != 0:
            raise DeepSpeedConfigError(
                f"train_batch_size {tb} not divisible by world size "
                f"{dp_world_size}")
    elif mb is not None:
        g = 1
        tb = mb * dp_world_size
    else:
        raise DeepSpeedConfigError(
            "Either train_batch_size or train_micro_batch_size_per_gpu "
            "needs to be provided")
    for name, v in ((C.TRAIN_BATCH_SIZE, tb),
                    (C.TRAIN_MICRO_BATCH_SIZE_PER_GPU, mb),
                    (C.GRADIENT_ACCUMULATION_STEPS, g)):
        if v <= 0:
            raise DeepSpeedConfigError(f"{name} must be positive, got {v}")
    return tb, mb, g


def _check_keys(d):
    for key in d:
        if key in SUPPORTED:
            continue
        if key in UNPORTED:
            raise NotImplementedError(
                f"config key '{key}' is not ported yet: it comes with "
                f"{UNPORTED[key]} of the PyTorch port")
        raise DeepSpeedConfigError(f"unknown config key '{key}'")
    zero = dict(d.get(C.ZERO_OPTIMIZATION) or {})
    stage = zero.pop("stage", 0)
    if stage != 0:
        raise NotImplementedError(
            f"zero_optimization.stage {stage} is not ported yet: ZeRO "
            f"stages 1-3 come with {_MULTI_GPU} of the PyTorch port")
    if zero:
        key = next(iter(zero))
        raise NotImplementedError(
            f"zero_optimization.{key} is not ported yet: it comes with "
            f"{_ZERO_KEYS_SLICE.get(key, _MULTI_GPU)} of the PyTorch port")


class DeepSpeedConfig:
    """Parsed training config: a dict, a path to a JSON file, or None.
    ``world_size`` is the data-parallel world size of the batch
    arithmetic (1 on one card)."""

    def __init__(self, config: Any, world_size: Optional[int] = None):
        if isinstance(config, str):
            if not os.path.exists(config):
                raise DeepSpeedConfigError(
                    f"DeepSpeed config path does not exist: {config}")
            with open(config) as f:
                self._param_dict = json.load(
                    f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        elif isinstance(config, dict):
            self._param_dict = dict(config)
        elif config is None:
            self._param_dict = {}
        else:
            raise DeepSpeedConfigError(
                f"Expected a string path to a JSON file or a dict, got: "
                f"{type(config)}")
        d = self._param_dict
        _check_keys(d)

        self.fp16 = FP16Config(**d.get(C.FP16, {}))
        self.bf16 = BF16Config(**d.get(C.BF16, d.get(C.BFLOAT16, {})))
        if self.fp16.enabled and self.bf16.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")

        opt = d.get(C.OPTIMIZER) or {}
        self.optimizer_name = opt.get(C.TYPE)
        if self.optimizer_name:
            self.optimizer_name = self.optimizer_name.lower()
        self.optimizer_params = opt.get(C.OPTIMIZER_PARAMS, {}) if opt \
            else None
        sched = d.get(C.SCHEDULER)
        self.scheduler_name = sched.get(C.TYPE) if sched else None
        self.scheduler_params = (sched.get(C.SCHEDULER_PARAMS, {}) if sched
                                 else None)

        self.steps_per_print = d.get(C.STEPS_PER_PRINT,
                                     C.STEPS_PER_PRINT_DEFAULT)
        self.gradient_clipping = d.get(C.GRADIENT_CLIPPING,
                                       C.GRADIENT_CLIPPING_DEFAULT)
        # fuse forward, backward and the optimizer update into the
        # engine's forward call (gradient_accumulation_steps == 1 only)
        self.fused_step = bool(d.get(C.FUSED_STEP, False))
        # block-sparse attention section (mode, block, ...): the engine
        # hands it to the model's with_sparse_attention hook
        self.sparse_attention = d.get(C.SPARSE_ATTENTION)

        self.world_size = world_size or 1

        def given(key):
            v = d.get(key)
            return None if v == "auto" else v

        (self.train_batch_size, self.train_micro_batch_size_per_gpu,
         self.gradient_accumulation_steps) = _resolve_batch_triangle(
            given(C.TRAIN_BATCH_SIZE),
            given(C.TRAIN_MICRO_BATCH_SIZE_PER_GPU),
            given(C.GRADIENT_ACCUMULATION_STEPS), self.world_size)
