"""Alias package (reference ``deepspeed/ops/adam``): ``from
deepspeed_tpu_torch.ops.adam import FusedAdam``. ``DeepSpeedCPUAdam``
comes with the offload slice of the PyTorch port."""

from deepspeed_tpu_torch.ops.optimizer import FusedAdam

__all__ = ["FusedAdam"]
