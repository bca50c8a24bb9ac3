"""fp16 / bf16 config sections (counterpart of
``deepspeed_tpu/runtime/precision_config.py``). bf16 needs no loss
scaling; fp16 keeps dynamic or static loss scaling. ``amp`` comes with a
later slice."""

from pydantic import Field

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


class FP16Config(DeepSpeedConfigModel):
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = Field(0.0, ge=0.0)  # 0 -> dynamic
    initial_scale_power: int = Field(16, ge=0)
    loss_scale_window: int = Field(1000, ge=1)
    hysteresis: int = Field(2, ge=0)
    min_loss_scale: float = Field(1.0, ge=0.0)
    fp16_master_weights_and_grads: bool = False

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0.0

    @property
    def initial_dynamic_scale(self) -> float:
        return (2.0 ** self.initial_scale_power if self.dynamic_loss_scale
                else self.loss_scale)


class BF16Config(DeepSpeedConfigModel):
    enabled: bool = False
