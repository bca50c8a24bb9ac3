"""ZeRO configuration (counterpart of ``deepspeed_tpu/runtime/zero/
config.py``, the reference ``DeepSpeedZeroConfig``).

The same fields, aliases (``stage3_*``) and deprecated keys. The stages:

- stage 1: the fp32 master update and the optimizer state are split over
  the ZeRO axes (``data x fsdp``);
- stage 2: stage 1, and the gradients are reduce-scattered to their
  owner shard every micro-step;
- stage 3: stage 2, and the parameters themselves are split, gathered
  just before each use and freed after.

Offload (``offload_optimizer``, ``offload_param`` and the deprecated
``cpu_offload*`` keys) comes with the offload slice of the port: a section
that offloads to a device raises :class:`NotImplementedError` (``device:
"none"`` is accepted: it offloads nothing).
"""

from enum import Enum
from typing import Optional

from pydantic import Field, model_validator

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel

OFFLOAD_SLICE = "the offload slice"


class OffloadDeviceEnum(str, Enum):
    none = "none"
    cpu = "cpu"
    nvme = "nvme"


class DeepSpeedZeroOffloadParamConfig(DeepSpeedConfigModel):
    device: OffloadDeviceEnum = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = Field(5, ge=0)
    buffer_size: int = Field(100_000_000, ge=0)
    max_in_cpu: int = Field(1_000_000_000, ge=0)
    pin_memory: bool = False


class DeepSpeedZeroOffloadOptimizerConfig(DeepSpeedConfigModel):
    device: OffloadDeviceEnum = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = Field(4, ge=0)
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False

    @property
    def pipeline(self):
        return self.pipeline_read or self.pipeline_write


def _offloads(section) -> bool:
    if section is None:
        return False
    device = section.get("device", "none") if isinstance(section, dict) \
        else getattr(section, "device", "none")
    return str(getattr(device, "value", device)) != "none"


class DeepSpeedZeroConfig(DeepSpeedConfigModel):
    """``zero_optimization`` section."""

    stage: int = Field(0, ge=0, le=3)
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = Field(500_000_000, ge=0)
    allgather_partitions: bool = True
    allgather_bucket_size: int = Field(500_000_000, ge=0)
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    offload_param: Optional[DeepSpeedZeroOffloadParamConfig] = None
    offload_optimizer: Optional[DeepSpeedZeroOffloadOptimizerConfig] = None
    sub_group_size: int = Field(1_000_000_000, ge=0)
    cpu_offload_param: Optional[bool] = Field(
        None, json_schema_extra={"deprecated": True,
                                 "new_param": "offload_param",
                                 "set_new_param": False})
    cpu_offload_use_pin_memory: Optional[bool] = Field(
        None, json_schema_extra={"deprecated": True, "set_new_param": False})
    cpu_offload: Optional[bool] = Field(
        None, json_schema_extra={"deprecated": True,
                                 "new_param": "offload_optimizer",
                                 "set_new_param": False})
    prefetch_bucket_size: int = Field(
        50_000_000, ge=0, alias="stage3_prefetch_bucket_size")
    param_persistence_threshold: int = Field(
        100_000, ge=0, alias="stage3_param_persistence_threshold")
    model_persistence_threshold: int = Field(
        2**63 - 1, ge=0, alias="stage3_model_persistence_threshold")
    max_live_parameters: int = Field(
        1_000_000_000, ge=0, alias="stage3_max_live_parameters")
    max_reuse_distance: int = Field(
        1_000_000_000, ge=0, alias="stage3_max_reuse_distance")
    gather_16bit_weights_on_model_save: bool = Field(
        False, alias="stage3_gather_16bit_weights_on_model_save")
    stage3_gather_fp16_weights_on_model_save: bool = Field(
        False, json_schema_extra={
            "deprecated": True,
            "new_param": "gather_16bit_weights_on_model_save"})
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    round_robin_gradients: bool = False
    # ZeRO++ hpZ (arXiv:2306.10209): stage-3 parameter shards span the
    # non-data ZeRO axes only (fsdp), so the per-use gather stays inside
    # one data replica; optimizer state keeps the full data x fsdp split
    hierarchical_gather: bool = False

    @model_validator(mode="before")
    @classmethod
    def _offload_is_a_later_slice(cls, data):
        if not isinstance(data, dict):
            return data
        for key in ("offload_optimizer", "offload_param"):
            if _offloads(data.get(key)):
                raise NotImplementedError(
                    f"zero_optimization.{key} is not ported yet: it comes "
                    f"with {OFFLOAD_SLICE} of the PyTorch port")
        for key in ("cpu_offload", "cpu_offload_param"):
            if data.get(key):
                raise NotImplementedError(
                    f"zero_optimization.{key} is not ported yet: it comes "
                    f"with {OFFLOAD_SLICE} of the PyTorch port")
        return data
