"""Training engine (counterpart of ``deepspeed_tpu/runtime/engine.py``).

The JAX engine's seams, on one card (or the CPU when ``device="cpu"``):

- ``forward(batch)`` / ``engine(batch)`` runs the model's loss AND its
  backward, as the JAX engine's compiled micro step does (``:1052``). With
  ``fused_step`` (``gradient_accumulation_steps == 1``) it also applies
  the optimizer there (``:1014-1040``), so one call is a whole training
  step; otherwise gradients accumulate in the parameters' ``.grad``.
- ``backward(loss)`` is the accounting boundary (``:1322``): gradients
  already exist.
- ``step()`` applies the optimizer at the accumulation boundary when the
  step is not fused (``:1334``, ``:1165-1178``) and advances the counters
  and the lr scheduler.

:meth:`DeepSpeedEngine._apply_math` is ``apply_math`` (``:1122-1157``):
unscale (fp16), overflow check (fp16), global norm, clip, update, skip on
overflow, loss-scale update. Parameters are the fp32 masters and their
gradients arrive in fp32; the model computes in its own compute dtype.
Nothing in it reads a device value on the host unless fp16 loss scaling
asks for the overflow flag.

A ``sparse_attention`` section swaps the model onto block-sparse
attention through its ``with_sparse_attention`` hook (``:244-258``),
which keeps the model's parameters: here they exist before the hook runs.

Offload, the 1-bit optimizers, compression, MoQ, curriculum, PLD,
telemetry hooks and the flops profiler are config keys that raise at
parse time (``runtime/config.py``), naming their slice.
"""

from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.ops.optimizer import build_basic_optimizer
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (create_loss_scaler,
                                                          has_inf_or_nan,
                                                          update_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import (LRScheduler,
                                                      get_lr_schedule_fn)
from deepspeed_tpu_torch.runtime.utils import global_norm
from deepspeed_tpu_torch.utils.logging import log_dist, logger


class DeepSpeedEngine:
    def __init__(self, model=None, optimizer=None, lr_scheduler=None,
                 config=None, device=None):
        if model is None:
            raise ValueError("deepspeed_tpu_torch.initialize requires a "
                             "model")
        self._config = DeepSpeedConfig(config)
        self.device = resolve_device(device)
        self.fp16_enabled_ = self._config.fp16.enabled
        self.bf16_enabled_ = self._config.bf16.enabled

        if self._config.sparse_attention:
            if hasattr(model, "with_sparse_attention"):
                # the model keeps its parameters and routes its attention
                # through the block-sparse layout zoo
                model = model.with_sparse_attention(
                    self._config.sparse_attention)
            else:
                logger.warning(
                    "sparse_attention is configured but "
                    f"{type(model).__name__} exposes no "
                    "with_sparse_attention hook — training runs DENSE "
                    "attention (BertForTraining supports the section)")

        # the model's parameters are the fp32 masters
        self.module = model.to(self.device)
        self._params = [p for p in self.module.parameters()
                        if p.requires_grad]
        bad = sorted({str(p.dtype) for p in self._params
                      if p.dtype != torch.float32})
        if bad:
            raise ValueError(f"the engine trains fp32 master parameters; "
                             f"the model has {bad} ones")

        # --- optimizer ---
        if optimizer is not None:
            self.optimizer = optimizer
            if self._config.optimizer_name is not None:
                logger.warning("Both client optimizer and config optimizer "
                               "given; using client optimizer")
        else:
            self.optimizer = build_basic_optimizer(
                self._config.optimizer_name or "adam",
                self._config.optimizer_params or {})
        self._opt_state = self.optimizer.init(self._params)

        self._fused_step = self._config.fused_step
        if self._fused_step and self._config.gradient_accumulation_steps != 1:
            logger.warning("fused_step requires gradient_accumulation_steps"
                           "=1; disabling")
            self._fused_step = False

        # --- lr schedule ---
        if lr_scheduler is not None:
            self.lr_scheduler = lr_scheduler
            self._schedule_fn = getattr(lr_scheduler, "schedule_fn", None)
        elif self._config.scheduler_name:
            self._schedule_fn = get_lr_schedule_fn(
                self._config.scheduler_name,
                self._config.scheduler_params or {})
            self.lr_scheduler = LRScheduler(self._schedule_fn)
        else:
            self._schedule_fn = None
            self.lr_scheduler = None

        # --- loss scaling (fp16 only; bf16 needs none) ---
        fp16 = self._config.fp16
        self._scaler_config, self._loss_scaler = create_loss_scaler(
            static_loss_scale=(fp16.loss_scale if fp16.enabled
                               and not fp16.dynamic_loss_scale else 1.0),
            dynamic=fp16.enabled and fp16.dynamic_loss_scale,
            initial_scale=fp16.initial_dynamic_scale,
            scale_window=fp16.loss_scale_window,
            scale_factor=2.0,
            min_scale=fp16.min_loss_scale,
            hysteresis=fp16.hysteresis)

        # --- counters ---
        self.micro_steps = 0
        self.global_steps = 0
        self.global_samples = 0
        self.skipped_steps = 0
        self._applied_steps = 0  # apply_math calls: the schedule's step
        self._last_loss = None
        self._last_grad_norm = None
        self._last_overflow = None
        self.training_dataloader = None
        log_dist(f"DeepSpeedEngine configured: device={self.device} "
                 f"micro_batch={self.train_micro_batch_size_per_gpu()} "
                 f"gas={self.gradient_accumulation_steps()} "
                 f"fused_step={self._fused_step}", ranks=[0])

    # ------------------------------------------------------------------
    # the step
    def _to_device(self, batch):
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._to_device(v) for v in batch)
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(batch)
        if isinstance(batch, torch.Tensor):
            return batch.to(self.device, non_blocking=True)
        return batch

    def _loss_scale(self):
        return self._loss_scaler.loss_scale if self.fp16_enabled_ else 1.0

    def _lr(self):
        """lr of the update about to be applied."""
        if self._schedule_fn is not None:
            return float(self._schedule_fn(self._applied_steps))
        if self.lr_scheduler is not None:
            return float(self.lr_scheduler.get_lr()[0])
        return float(getattr(self.optimizer, "lr", 0.0))

    @torch.no_grad()
    def _apply_math(self):
        """Unscale → overflow check → clip → update → loss-scale update,
        on the gradients accumulated in the parameters; clears them."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params]
        if self.fp16_enabled_:
            torch._foreach_mul_(grads, 1.0 / self._loss_scale())
        # the one host sync of the step, and only under fp16
        overflow = (bool(has_inf_or_nan(grads)) if self.fp16_enabled_
                    else False)
        grad_norm = global_norm(grads)
        clip = self._config.gradient_clipping
        if clip and clip > 0:
            torch._foreach_mul_(grads, torch.clamp(clip / (grad_norm + 1e-6),
                                                   max=1.0))
        if not overflow:
            self._opt_state = self.optimizer.update(
                grads, self._opt_state, self._params, lr=self._lr())
        self._loss_scaler = update_scale(self._scaler_config,
                                         self._loss_scaler, overflow)
        self._applied_steps += 1
        self.skipped_steps += int(overflow)
        self.zero_grad()
        return overflow, grad_norm

    def forward(self, batch):
        """Loss of one micro-batch; its gradients are computed too (and,
        with ``fused_step``, applied). Returns the detached loss tensor."""
        batch = self._to_device(batch)
        loss = self.module(batch)
        gas = 1 if self._fused_step else self.gradient_accumulation_steps()
        (loss * (self._loss_scale() / gas)).backward()
        if self._fused_step:
            self._last_overflow, self._last_grad_norm = self._apply_math()
        self._last_loss = loss.detach()
        return self._last_loss

    __call__ = forward

    def backward(self, loss=None, allreduce_gradients=True,
                 release_loss=False):
        """Gradient accounting boundary: the gradients were produced with
        the loss in :meth:`forward`."""
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return ((self.micro_steps + 1)
                % self.gradient_accumulation_steps() == 0)

    def step(self, lr_kwargs=None):
        """Optimizer step at gradient-accumulation boundaries (applied in
        :meth:`forward` already with ``fused_step``)."""
        if self._last_loss is None:
            raise RuntimeError("step() called before any forward()")
        if self.is_gradient_accumulation_boundary():
            if not self._fused_step:
                self._last_overflow, self._last_grad_norm = \
                    self._apply_math()
            self.global_steps += 1
            self.global_samples += self.train_batch_size()
            if self.lr_scheduler is not None:
                self.lr_scheduler.step()
            self._report_progress()
        self.micro_steps += 1

    def train_batch(self, data_iter=None, batch=None):
        """``gas`` micro-steps and the optimizer step; returns the mean
        loss (one host sync, after the loop)."""
        losses = []
        for _ in range(self.gradient_accumulation_steps()):
            loss = self.forward(batch if batch is not None
                                else next(data_iter))
            self.backward(loss)
            self.step()
            losses.append(loss)
        return float(torch.stack(losses).mean())

    def _report_progress(self):
        if self.global_steps % self.steps_per_print() == 0:
            log_dist(f"step={self.global_steps}, "
                     f"skipped={self.get_skipped_steps()}, "
                     f"lr={self.get_lr()}, "
                     f"loss={float(self._last_loss):.6f}", ranks=[0])

    # ------------------------------------------------------------------
    # accessors (reference engine surface)
    def train_batch_size(self):
        return self._config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self._config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self._config.gradient_accumulation_steps

    def steps_per_print(self):
        return self._config.steps_per_print

    def zero_optimization_stage(self):
        return 0  # stages 1-3 come with the multi-GPU slice

    def zero_optimization(self):
        return False

    def fp16_enabled(self):
        return self.fp16_enabled_

    def bfloat16_enabled(self):
        return self.bf16_enabled_

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def get_lr(self):
        return [self._lr()]

    def get_global_grad_norm(self) -> Optional[float]:
        """Global (pre-clip) gradient norm of the last optimizer step."""
        norm = self._last_grad_norm
        return float(norm) if norm is not None else None

    @property
    def loss_scale(self):
        return self._loss_scale()

    def get_skipped_steps(self):
        return self.skipped_steps

    def was_step_applied(self) -> bool:
        """Whether the last optimizer step updated the weights (False:
        the fp16 overflow path skipped it)."""
        return not self._last_overflow

    def module_state_dict(self):
        """Host (CPU) copy of the model parameters."""
        return {k: v.detach().cpu()
                for k, v in self.module.state_dict().items()}

    def load_module_state_dict(self, state_dict, strict=True):
        """Copy ``state_dict`` into the live parameters, keeping their
        device and dtype; ``strict=False`` keeps entries it lacks."""
        self.module.load_state_dict(state_dict, strict=strict)

    def zero_grad(self):
        for p in self._params:
            p.grad = None
