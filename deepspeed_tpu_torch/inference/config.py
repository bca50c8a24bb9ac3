"""Inference configuration (counterpart of
``deepspeed_tpu/inference/config.py``).

``dtype`` resolves to a torch dtype. The JAX config's keys that need no
unported slice are accepted under the same names, aliases and defaults:
``max_out_tokens``, ``tensor_parallel`` (``tp``, ``mp_size``),
``injection_policy`` (``injection_dict``, ``injection_policy_tuple``)
``telemetry`` and ``resilience`` (the training config's sections),
``checkpoint`` (with ``base_dir``) and ``save_mp_checkpoint_path`` take
effect, the rest are inert (the engine logs a note for each one set to
another value than its default, :data:`INERT`). Sections the port
does not implement yet raise :class:`NotImplementedError` naming the
slice of the port that brings them, instead of being accepted and
ignored.
"""

from typing import Any, Dict, Optional, Union

import torch
from pydantic import Field

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel

_DTYPE_MAP = {
    "fp32": torch.float32, "float32": torch.float32, "float": torch.float32,
    "fp16": torch.float16, "float16": torch.float16, "half": torch.float16,
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
}

# config keys the JAX inference config accepts, and the port's slice that
# will implement each (ROADMAP.md, Queue 1)
UNPORTED = {
    "tuning": "the autotuning slice",
    "quant": "the weight-only int8 slice",
    "zero": "the ZeRO-Inference slice",
    "moe": "the MoE slice",
}

# the JAX config's keys that are accepted and have no effect here, with
# the note the engine logs where one is set to another value than its
# default (the JAX engine's warn_inert_options)
INERT = {
    "replace_with_kernel_inject": "the port's kernels run on the card "
                                  "whatever it says",
    "enable_cuda_graph": "the port runs its kernels eagerly",
    "triangular_masking": "each model owns its masking (causal decoders "
                          "mask causally regardless)",
    "return_tuple": "forward returns the logits tensor",
    "replace_method": "no module is replaced",
    "transposed_mode": "weight layouts are canonical",
    "training_mp_size": "the weights come with the model, whole; the "
                        "engine slices them for tensor_parallel.tp_size",
    "set_empty_params": "the weights come with the model",
    "config": "the model carries its own config",
    "min_out_tokens": "no kernel workspace needs a floor here",
    "mpu": "the tp group is the process group's "
           "(deepspeed_tpu_torch.comm.init_distributed)",
    "ep_size": "MoE comes with the MoE slice",
    "ep_group": "MoE comes with the MoE slice",
    "ep_mp_group": "MoE comes with the MoE slice",
    "moe_experts": "MoE comes with the MoE slice",
    "moe_type": "MoE comes with the MoE slice",
}


def resolve_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower().replace("torch.", "").replace("jnp.", "")
        if key == "int8":
            raise NotImplementedError(
                "dtype int8 (weight-only quantization) is not ported yet: "
                "it comes with the weight-only int8 slice")
        if key in _DTYPE_MAP:
            return _DTYPE_MAP[key]
    raise ValueError(f"unknown inference dtype {dtype!r}")


class DeepSpeedTPConfig(DeepSpeedConfigModel):
    """The JAX config's ``tensor_parallel`` section: ``tp_size`` ranks,
    one process each, a tp group of the running process group (a world
    of ``data x tp_size`` ranks; ``mpu`` and ``tp_group`` are accepted as
    in JAX; the groups are the mesh's)."""

    enabled: bool = True
    tp_size: int = 1
    mpu: Optional[Any] = None
    tp_group: Optional[Any] = None


def _deprecated(new_param="", migrate=True):
    return {"deprecated": True, "new_param": new_param,
            "set_new_param": migrate}


class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    """Master inference config: the fields this slice implements and the
    JAX config's inert keys (:data:`INERT`)."""

    dtype: torch.dtype = torch.bfloat16
    # serving block (serving/config.ServingConfig): paged KV pool and
    # continuous batching, consumed by ServingEngine; None = no serving
    serving: Optional[Dict] = None
    # the unified telemetry event stream: the training config's
    # `telemetry` section (runtime/config.TelemetryConfig), parsed by the
    # engine's Telemetry manager
    telemetry: Dict = {}
    # the fault-tolerance layer (the training config's `resilience`
    # section, runtime/config.ResilienceConfig): the serving engines arm
    # its hang watchdog on request progress
    resilience: Dict = {}
    # a checkpoint DIRECTORY to serve (a training save_checkpoint layout
    # of either package, or a save_mp_checkpoint_path output), joined
    # onto base_dir when relative; save_mp_checkpoint_path writes the
    # dtype-converted weights there once at construction
    checkpoint: Optional[Union[str, Dict]] = None
    base_dir: str = ""
    save_mp_checkpoint_path: Optional[str] = None
    checkpoint_config: Optional[Dict] = Field(None, alias="ckpt_config")
    max_out_tokens: int = Field(1024, alias="max_tokens")
    tensor_parallel: DeepSpeedTPConfig = Field(DeepSpeedTPConfig(),
                                               alias="tp")
    replace_with_kernel_inject: bool = Field(False, alias="kernel_inject")
    enable_cuda_graph: bool = False
    triangular_masking: bool = Field(True, alias="tm")
    return_tuple: bool = True
    replace_method: str = Field("auto", json_schema_extra=_deprecated())
    transposed_mode: bool = False
    training_mp_size: int = 1
    set_empty_params: bool = False
    config: Optional[Dict] = Field(None, alias="args")
    # a policy name, a TPPolicy, the reference's {module: (row outputs,)}
    # dict or a bare tuple of row outputs (module_inject.get_tp_policy)
    injection_policy: Optional[Any] = Field(None, alias="injection_dict")
    injection_policy_tuple: Optional[tuple] = None
    min_out_tokens: int = Field(1, alias="min_tokens")
    # legacy fields: mp_size and mpu move into tensor_parallel as in the
    # JAX config; the MoE ones name moe.*, which is not ported, so they
    # stay where they are
    mp_size: int = Field(1, json_schema_extra=_deprecated(
        "tensor_parallel.tp_size"))
    mpu: Optional[Any] = Field(None, json_schema_extra=_deprecated(
        "tensor_parallel.mpu"))
    ep_size: int = Field(1, json_schema_extra=_deprecated("moe.ep_size",
                                                          False))
    ep_group: Optional[Any] = Field(None, alias="expert_group",
                                    json_schema_extra=_deprecated())
    ep_mp_group: Optional[Any] = Field(None, alias="expert_mp_group",
                                       json_schema_extra=_deprecated())
    moe_experts: list = Field([1], json_schema_extra=_deprecated(
        "moe.moe_experts", False))
    moe_type: str = Field("standard", json_schema_extra=_deprecated(
        "moe.type", False))

    def __init__(self, strict=False, **data):
        for key in UNPORTED:
            if key in data:
                raise NotImplementedError(
                    f"inference config key '{key}' is not ported yet: it "
                    f"comes with {UNPORTED[key]} of the PyTorch port")
        if data.get("telemetry"):
            # JAX's keys and checks, at parse time (the engine's manager
            # parses it again)
            from deepspeed_tpu_torch.runtime.config import TelemetryConfig

            TelemetryConfig(**data["telemetry"])
        if data.get("resilience"):
            from deepspeed_tpu_torch.runtime.config import ResilienceConfig

            ResilienceConfig(**data["resilience"])
        if "dtype" in data:
            data["dtype"] = resolve_dtype(data["dtype"])
        if "mp_size" in data and "tensor_parallel" not in data \
                and "tp" not in data:
            # the JAX config's path: mp_size -> tensor_parallel.tp_size
            data["tensor_parallel"] = {"tp_size": data.pop("mp_size")}
        super().__init__(strict=strict, **data)
        if self.tensor_parallel.tp_size < 1:
            raise ValueError(f"tensor_parallel.tp_size must be >= 1, got "
                             f"{self.tensor_parallel.tp_size}")

    def inert_notes(self):
        """``(key, why)`` for each inert key set to another value than
        its default."""
        fields = type(self).model_fields
        return [(key, why) for key, why in INERT.items()
                if key in self.model_fields_set
                and getattr(self, key) != fields[key].get_default()]
