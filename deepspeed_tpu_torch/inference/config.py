"""Inference configuration (counterpart of
``deepspeed_tpu/inference/config.py``).

``dtype`` resolves to a torch dtype. Sections the JAX package accepts but
this port does not implement yet raise :class:`NotImplementedError`
naming the slice of the port that brings them, instead of being accepted
and ignored.
"""

from typing import Dict, Optional

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
    "telemetry": "the telemetry slice",
    "resilience": "the resilience slice",
    "tuning": "the autotuning slice",
    "checkpoint": "the checkpoint slice",
    "save_mp_checkpoint_path": "the checkpoint slice",
    "quant": "the weight-only int8 slice",
    "zero": "the ZeRO-Inference slice",
    "moe": "the MoE slice",
    "injection_policy": "the multi-GPU slice",
    "tensor_parallel": "the multi-GPU slice",
    "tp": "the multi-GPU slice",
    "mp_size": "the multi-GPU slice",
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


class DeepSpeedInferenceConfig(DeepSpeedConfigModel):
    """Master inference config: the fields this slice implements."""

    dtype: torch.dtype = torch.bfloat16
    # serving block (serving/config.ServingConfig): paged KV pool and
    # continuous batching, consumed by ServingEngine; None = no serving
    serving: Optional[Dict] = None
    max_out_tokens: int = Field(1024, alias="max_tokens")

    def __init__(self, strict=False, **data):
        for key in UNPORTED:
            if key in data:
                raise NotImplementedError(
                    f"inference config key '{key}' is not ported yet: it "
                    f"comes with {UNPORTED[key]} of the PyTorch port")
        if "dtype" in data:
            data["dtype"] = resolve_dtype(data["dtype"])
        super().__init__(strict=strict, **data)
