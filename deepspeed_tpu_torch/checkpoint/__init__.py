"""Checkpoint tools (counterpart of ``deepspeed_tpu/checkpoint/``)."""

from deepspeed_tpu_torch.checkpoint.deepspeed_checkpoint import (
    DeepSpeedCheckpoint, convert_zero_checkpoint_to_fp32_state_dict,
    get_fp32_state_dict_from_zero_checkpoint)

__all__ = ["DeepSpeedCheckpoint",
           "get_fp32_state_dict_from_zero_checkpoint",
           "convert_zero_checkpoint_to_fp32_state_dict"]
