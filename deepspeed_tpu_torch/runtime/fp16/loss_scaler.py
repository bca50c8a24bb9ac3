"""Loss scaling (counterpart of ``deepspeed_tpu/runtime/fp16/
loss_scaler.py``).

The JAX version keeps the scaler state on the device and branches with
``lax.cond`` inside the compiled step. Here the state is three host
numbers: the engine reads the overflow flag once per fp16 step (one
device-to-host sync, as the reference DeepSpeed does) and updates the
scale on the host. bf16 and fp32 training never check for overflow.
"""

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class LossScalerConfig:
    dynamic: bool = False
    scale_window: int = 1000
    scale_factor: float = 2.0
    min_scale: float = 1.0
    max_hysteresis: int = 2


class LossScaleState(NamedTuple):
    loss_scale: float
    good_steps: int   # steps since the last overflow
    hysteresis: int   # overflows still tolerated before the scale drops


def create_loss_scaler(static_loss_scale: float = 1.0,
                       dynamic: bool = False,
                       initial_scale: float = 2.0 ** 16,
                       scale_window: int = 1000,
                       scale_factor: float = 2.0,
                       min_scale: float = 1.0,
                       hysteresis: int = 2):
    """Returns ``(config, state)``."""
    config = LossScalerConfig(dynamic=dynamic, scale_window=scale_window,
                              scale_factor=scale_factor, min_scale=min_scale,
                              max_hysteresis=hysteresis)
    scale = initial_scale if dynamic else static_loss_scale
    return config, LossScaleState(float(scale), 0, hysteresis)


def has_inf_or_nan(tensors) -> torch.Tensor:
    """0-d bool tensor on the tensors' device: does any hold an inf or a
    NaN? (no host sync)."""
    tensors = list(tensors)
    if not tensors:
        return torch.tensor(False)
    flags = [(~torch.isfinite(t)).any() for t in tensors]
    return torch.stack(flags).any()


def update_scale(config: LossScalerConfig, state: LossScaleState,
                 overflow: bool) -> LossScaleState:
    """Post-step scale adjustment (reference
    ``DynamicLossScaler.update_scale``)."""
    if not config.dynamic:
        return state
    if overflow:
        hyst = state.hysteresis - 1
        scale = (max(state.loss_scale / config.scale_factor, config.min_scale)
                 if hyst <= 0 else state.loss_scale)
        return LossScaleState(scale, 0, max(hyst, 0))
    grow = (state.good_steps + 1) % config.scale_window == 0
    scale = state.loss_scale * config.scale_factor if grow \
        else state.loss_scale
    return LossScaleState(scale, state.good_steps + 1, config.max_hysteresis)
