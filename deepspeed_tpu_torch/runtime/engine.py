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

Data parallelism and ZeRO (``runtime/zero/``): with a ``mesh`` (the
``initialize`` argument or the config section), a ZeRO stage above 0, or
a process group already running, the engine runs one process per device
over ``torch.distributed`` (starting the group if none runs):

- ``engine(batch)`` takes the GLOBAL micro-batch, as the JAX engine does
  (``train_micro_batch_size_per_gpu x dp`` rows, ``_shard_batch``); each
  rank keeps its rows by ``SpecLayout.batch_spec`` (split over ``data x
  expert`` only: ranks that differ only in ``fsdp`` take the same rows);
- the loss it returns is the mean over the global micro-batch: each
  rank's mean, averaged over the data-parallel group. A model whose loss
  averages over labelled tokens only (``loss_tokens(batch)``: BERT's
  labels != -100) has each rank's mean weighted by its share of the
  global micro-batch's tokens times the number of row shards, which
  every rank counts from the global batch it was given, with no
  collective: the ranks' weighted means average to the global mean, as
  JAX's loss over the whole batch is, and so do their gradients. Rows
  that do not divide over ``data x expert`` stay whole on every rank
  (one shard: the loss is the model's own);
- gradients are mean-reduced over the ZeRO group and the optimizer runs
  on the stage's shards (:class:`~deepspeed_tpu_torch.runtime.zero.stage.
  ZeroPartition`): the global norm counts every element once, and an
  fp16 overflow on one rank skips the step on all of them.

With no process group and no mesh, at stage 0, the engine runs on its one
device as before, with no collective.

Tensor parallelism (a ``tp`` mesh axis above 1, alone or with ``data`` /
``fsdp`` and any ZeRO stage): every rank is one process and keeps its tp
slices of the weights. The engine hands the whole model to its
``with_tensor_parallel`` hook (the slices the ``tensor_parallel.policy``
gives, as ``InferenceEngine`` builds its model) before ZeRO lays the
slices out; a model already sliced (``zero.Init``) is kept. The ranks of
a tp group take the same rows; the loss is averaged over the batch axes
only; gradients are reduced over the ZeRO axes at this rank's tp
coordinate; the global norm (and ``get_global_grad_norm``), the fp16
overflow flag and LAMB's trust ratio are the whole model's
(:meth:`~deepspeed_tpu_torch.runtime.zero.stage.ZeroPartition.
norm_and_overflow`). ``module_state_dict`` gathers the whole tensors from
the ranks' slices; ``load_module_state_dict`` slices them again. A mesh
always builds a ZeroPartition (stage 0 included), so the group-less path
below never runs under tp.

The rest of the JAX engine's surface: ``eval_batch`` (the loss under
``torch.no_grad()``, touching no gradient, master, optimizer slot or
counter), ``train`` / ``eval``, ``set_train_batch_size`` (the
accumulation factor only), ``get_batch_info``, ``allreduce_gradients``
(a no-op, as in JAX: the reduction is the stage's), ``destroy``,
``spec_layout``, ``describe_topology`` and the config getters of the
ported keys. Getters of unported slices' keys raise naming the slice.

Telemetry (JAX's sites): the ``telemetry`` section's
``Telemetry(name="engine")`` watches the step callables' signatures
(``engine.micro_step`` / ``engine.fused_step`` / ``engine.apply_step``,
with a once-a-signature ``step_cost``), brackets each step's ``data``,
``fwd_bwd`` and ``optimizer`` phases in a step trace (host dispatch
times: telemetry adds no synchronize and reads no device value), and
takes ``on_step_boundary`` at each optimizer step; ``wall_clock_breakdown``
times forward / backward / step with synchronized timers and reports
their means every ``steps_per_print`` through ``telemetry.wallclock``,
``memory_breakdown`` logs ``see_memory_usage`` there, the monitor
writers (``tensorboard``, ``wandb``, ``csv_monitor``) get the
``Train/Samples/*`` series, and ``comms_logger`` configures the comm
facade's logger. ``destroy`` closes the telemetry.

Checkpoints (JAX's ``save_checkpoint`` / ``load_checkpoint``, with its
arguments and return values): ``<save_dir>/<tag>/`` holds ``module``,
``optimizer`` and ``engine`` as npz + json (``ArrayCheckpointEngine``),
in the JAX package's layout for the same config — the flax tree of the
model (``utils/params.py:training_params_to_jax``: stacked layers, Dense
kernels ``[in, out]``), Adam's ``opt_state/{step, exp_avg, exp_avg_sq}``
under the same paths, the loss-scale counters, ``global_step``,
``skipped_steps`` and ``rng``, and the engine's counters, lr scheduler
and ``client_state`` — so a checkpoint crosses between the packages both
ways. Rank 0 writes the whole tensors (ZeRO's split masters and slots,
and tp slices, are gathered first); ``latest`` is written atomically
after the commit. A load lays the whole tensors out for this engine's
stage, data world and tp degree, whatever the saving run's were. The
port runs no dropout, so it uses no random key: ``rng`` is carried and
advanced as JAX's micro step splits it (one ``split(key, 4)[0]`` a
micro step, computed when a checkpoint is written), so the saved key is
JAX's. The ``resilience`` section (``runtime/resilience``) adds
integrity manifests with a fallback chain, the step sentinel (its
``skip`` policy turns the overflow check on in :meth:`_apply_math`) and
the hang watchdog, at JAX's sites; ``elasticity.enabled`` writes the
topology manifest (:meth:`describe_topology`, with the data-pipeline
cursor and the key) into each tag. ``deepspeed_io`` builds the
``DeepSpeedDataLoader`` of global micro-batches (``initialize(
training_data=)``).

Offload, the 1-bit optimizers, compression, MoQ, curriculum, PLD and the
flops profiler are config keys that raise at parse time
(``runtime/config.py``), naming their slice.
"""

import os
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch import comm as dist
from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.module_inject.layers import TensorParallel
from deepspeed_tpu_torch.module_inject.policies import (
    gather_params_with_policy, shard_params_with_policy)
from deepspeed_tpu_torch.ops.optimizer import FusedLamb, build_basic_optimizer
from deepspeed_tpu_torch.ops.sampling import threefry_2x32
from deepspeed_tpu_torch.parallel import topology as topo_mod
from deepspeed_tpu_torch.parallel.topology import (AXIS_TP, MeshTopology,
                                                   normalize_axis_dict)
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine import (
    ArrayCheckpointEngine, TieredCheckpointEngine, atomic_write_text,
    flatten_tree, read_latest, unflatten_by_paths)
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                DeepSpeedConfigError)
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.fp16.loss_scaler import (create_loss_scaler,
                                                          has_inf_or_nan,
                                                          update_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import (LRScheduler,
                                                      get_lr_schedule_fn)
from deepspeed_tpu_torch.runtime.resilience.manager import Resilience
from deepspeed_tpu_torch.runtime.utils import global_norm
from deepspeed_tpu_torch.runtime.zero.partition import (BATCH_AXES,
                                                        SpecLayout,
                                                        spec_entries)
from deepspeed_tpu_torch.runtime.zero.reduce import (GradScale,
                                                     all_gather_flat)
from deepspeed_tpu_torch.runtime.zero.stage import ZeroPartition
from deepspeed_tpu_torch.monitor.monitor import MonitorMaster
from deepspeed_tpu_torch.telemetry.manager import Telemetry
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.params import (model_family,
                                              training_params_from_jax,
                                              training_params_to_jax)
from deepspeed_tpu_torch.utils.timer import (BACKWARD_GLOBAL_TIMER,
                                             FORWARD_GLOBAL_TIMER,
                                             STEP_GLOBAL_TIMER,
                                             SynchronizedWallClockTimer,
                                             ThroughputTimer)


class DeepSpeedEngine:
    def __init__(self, model=None, optimizer=None, lr_scheduler=None,
                 config=None, device=None, mesh=None,
                 dist_init_required=None, training_data=None,
                 collate_fn=None):
        if model is None:
            raise ValueError("deepspeed_tpu_torch.initialize requires a "
                             "model")
        self._config = DeepSpeedConfig(config)
        self.topology = self._init_topology(mesh, device, dist_init_required)
        self.device = resolve_device(device)
        self.fp16_enabled_ = self._config.fp16.enabled
        self.bf16_enabled_ = self._config.bf16.enabled
        if self._config.disable_allgather:
            logger.warning(
                "disable_allgather is accepted but INERT: ZeRO's gathers "
                "are the stage's plan (runtime/zero/stage.py); there is no "
                "hand-scheduled allgather to disable")

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

        self.tp = None
        if self.topology is not None and \
                self.topology.get_tensor_parallel_world_size() > 1:
            model = self._tensor_parallel(model)
            self.tp = model.tp

        bad = sorted({str(p.dtype) for p in model.parameters()
                      if p.requires_grad and p.dtype != torch.float32})
        if bad:
            raise ValueError(f"the engine trains fp32 master parameters; "
                             f"the model has {bad} ones")
        # the model's parameters are the fp32 masters (their shards under
        # ZeRO, which places them on the device itself)
        self._zero = None
        zc = self._config.zero_config
        stage3 = zc.stage >= 3
        # the layout of a run with no process group is a world of one
        self.spec_layout = SpecLayout(
            self.topology or MeshTopology(world_size=1, rank=0),
            policy=self._tp_policy(),
            persistence_threshold=(zc.param_persistence_threshold
                                   if stage3 else 0),
            hierarchical_gather=zc.hierarchical_gather and stage3)
        if self.topology is not None:
            if (zc.hierarchical_gather and stage3
                    and not self.spec_layout.hierarchical_active):
                logger.warning(
                    "zero_optimization.hierarchical_gather ignored: the "
                    "mesh has no secondary ZeRO axis (fsdp/expert) of size "
                    "> 1; parameters keep the flat data-axis partition")
            self._zero = ZeroPartition(
                model, self.spec_layout, zc.stage, self.device,
                GradScale(self._config.prescale_gradients,
                          self._config.gradient_predivide_factor),
                zc.reduce_bucket_size, zc.allgather_bucket_size)
        self.module = model.to(self.device)
        self._params = (self._zero.masters if self._zero is not None
                        else [p for p in self.module.parameters()
                              if p.requires_grad])

        # --- optimizer ---
        self._client_optimizer = optimizer is not None
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
        self.module_train = True
        # JAX's TrainState.rng (PRNGKey(0)), carried: advanced lazily by
        # one split a micro step since `_rng_micro` (_current_rng)
        self._rng = np.zeros(2, np.uint32)
        self._rng_micro = 0
        self.collate_fn = collate_fn
        self._elastic_loader = None
        self.training_dataloader = (self.deepspeed_io(training_data)
                                    if training_data is not None else None)

        # --- the telemetry slice (JAX engine's sites) ---
        self.wall_clock_breakdown_ = bool(self._config.wall_clock_breakdown)
        self.memory_breakdown_ = bool(self._config.memory_breakdown)
        self.timers = SynchronizedWallClockTimer()
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size(),
            steps_per_output=self.steps_per_print())
        self.monitor = MonitorMaster(self._config.monitor_config)
        self.telemetry = Telemetry(self._config.telemetry_config,
                                   monitor=self.monitor, name="engine")
        dist.configure(deepspeed_config=self._config)

        # --- checkpoints and resilience (JAX's sites) ---
        self.checkpoint_engine = ArrayCheckpointEngine()
        if self._config.nebula_config.enabled:
            self.checkpoint_engine = TieredCheckpointEngine(
                self._config.nebula_config, inner=self.checkpoint_engine)
        self.resilience = Resilience(self._config.resilience_config,
                                     telemetry=self.telemetry, name="engine")
        # policy "skip" runs the fp16-style overflow check in the step
        self._sentinel_skip = self.resilience.sentinel_in_graph
        self.checkpoint_engine = self.resilience.wrap_checkpoint_engine(
            self.checkpoint_engine)
        # the step callables, unbound (a bound method kept on the engine
        # would make a reference cycle that outlives a `del engine`)
        self._fwd_bwd = self.telemetry.watch_jit(
            DeepSpeedEngine._fwd_bwd_step, "engine.fused_step"
            if self._fused_step else "engine.micro_step",
            cost_fn=self._comm_plan)
        self._apply_step = self.telemetry.watch_jit(
            DeepSpeedEngine._apply_math, "engine.apply_step",
            cost_fn=self._comm_plan)
        log_dist(f"DeepSpeedEngine configured: device={self.device} "
                 f"zero_stage={self.zero_optimization_stage()} "
                 f"mesh={self.topology} "
                 f"micro_batch={self.train_micro_batch_size_per_gpu()} "
                 f"gas={self.gradient_accumulation_steps()} "
                 f"fused_step={self._fused_step}", ranks=[0])

    def _init_topology(self, mesh, device, dist_init_required):
        """The job's mesh, starting the process group when the run is
        data-parallel (module docstring); None on one device with no
        group. Re-resolves the batch triangle over its data-parallel
        world."""
        wanted = (mesh is not None or C.MESH in self._config._param_dict
                  or self._config.zero_enabled or dist.is_initialized())
        if not wanted and not dist_init_required:
            return None
        if isinstance(mesh, MeshTopology):
            sizes = mesh.axis_sizes
        else:
            sizes = normalize_axis_dict(
                dict(mesh) if mesh is not None
                else self._config.mesh.axis_sizes())
            topo_mod.check_ported_axes(sizes)
        if not dist.is_initialized():
            if dist_init_required is False:
                raise ValueError(
                    "this run needs a process group (a mesh or a ZeRO "
                    "stage above 0) and dist_init_required=False")
            tp = int(sizes.get(AXIS_TP, 1))
            if tp > 1 and "WORLD_SIZE" not in os.environ:
                raise RuntimeError(
                    f"mesh.tp {tp} needs a process group with a rank for "
                    f"each tp slice: call deepspeed_tpu_torch.comm."
                    f"init_distributed() on every rank first")
            dist.init_distributed(device=device)
        if isinstance(mesh, MeshTopology):
            topology = mesh
        else:
            topology = MeshTopology(
                axis_sizes=sizes,
                dcn_axis_sizes=self._config.mesh.dcn or None)
        topo_mod.set_topology(topology)
        self._config = DeepSpeedConfig(
            self._config._param_dict,
            world_size=topology.get_data_parallel_world_size())
        return topology

    def _tp_policy(self):
        return self._config.tensor_parallel_config.get("policy", "auto")

    def _tensor_parallel(self, model):
        """This rank's tp slice of ``model`` (module docstring)."""
        topo = self.topology
        size = topo.get_tensor_parallel_world_size()
        rank = topo.get_tensor_parallel_rank()
        sliced = getattr(model, "tp", None)
        if sliced is not None:
            if (sliced.size, sliced.rank) != (size, rank):
                raise ValueError(
                    f"the model is tp rank {sliced.rank} of {sliced.size}; "
                    f"this rank is tp rank {rank} of {size}")
            return model
        if not hasattr(model, "with_tensor_parallel"):
            raise NotImplementedError(
                f"{type(model).__name__} has no tensor-parallel form: "
                f"training at mesh.tp {size} runs a model with a "
                f"with_tensor_parallel hook (GPT2ForTraining, "
                f"LlamaForTraining, BertForTraining)")
        return model.with_tensor_parallel(
            TensorParallel(group=topo.get_tensor_parallel_group(),
                           size=size, rank=rank), policy=self._tp_policy())

    def _whole(self, tensors):
        """``{name: tensor}`` of this rank's tp slices, whole (every rank
        of the tp group must call); the dict itself at tp 1."""
        if self.tp is None:
            return tensors
        return gather_params_with_policy(tensors, self.module.param_specs(),
                                         self.tp.group)

    # ------------------------------------------------------------------
    # the step
    def _to_device(self, batch):
        """The batch on the device: this rank's rows of each array under a
        mesh (``SpecLayout.batch_spec``), sliced on the host."""
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._to_device(v) for v in batch)
        if isinstance(batch, np.ndarray):
            batch = torch.from_numpy(batch)
        if isinstance(batch, torch.Tensor):
            if self.topology is not None and batch.ndim >= 1:
                rows = self.spec_layout.batch_sharding(batch.ndim,
                                                       tuple(batch.shape))
                batch = rows.local(batch)
            return batch.to(self.device, non_blocking=True)
        return batch

    def _row_shards(self, batch) -> int:
        """How many row shards :meth:`_to_device` cuts the global
        micro-batch ``batch`` into: the batch plan's group, or 1 where the
        rows do not divide over ``data x expert`` and stay whole on every
        rank (a last, partial batch)."""
        if isinstance(batch, dict):
            batch = list(batch.values())
        if isinstance(batch, (tuple, list)):
            return max((self._row_shards(v) for v in batch), default=1)
        if (self.topology is None
                or not isinstance(batch, (np.ndarray, torch.Tensor))
                or batch.ndim < 1):
            return 1
        return self.spec_layout.batch_sharding(batch.ndim,
                                               tuple(batch.shape)).n

    def _local_loss(self, batch):
        """This rank's loss of the global micro-batch ``batch``: the
        model's loss of the rank's rows, weighted by their share of the
        labelled tokens where the model counts them and the rows are split
        (module docstring)."""
        count = getattr(self.module, "loss_tokens", None)
        shards = self._row_shards(batch) if count is not None else 1
        whole = count(batch) if shards > 1 else None
        batch = self._to_device(batch)
        loss = self.module(batch)
        if whole is None:
            return loss
        share = count(batch).to(loss.device) / whole.to(
            loss.device).clamp_min(1)
        return loss * (share * shards)

    def _batch_mean(self, loss):
        """The mean of the ranks' losses over the batch axes."""
        if self._zero is None:
            return loss
        return dist.all_reduce(loss.clone(), op=dist.ReduceOp.AVG,
                               group=self.topology.group(BATCH_AXES))

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
        on the step's gradients (the parameters' ``.grad``, or the ZeRO
        slots); clears them."""
        zero = self._zero
        if zero is not None:
            grads = zero.reduced_grads()
        else:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self._params]
        if self.fp16_enabled_:
            torch._foreach_mul_(grads, 1.0 / self._loss_scale())
        overflow = (has_inf_or_nan(grads)
                    if self.fp16_enabled_ or self._sentinel_skip else None)
        if zero is not None:
            # one all-reduce: the split slots' squares and the flag
            grad_norm, overflow = zero.norm_and_overflow(grads, overflow)
        else:
            grad_norm = global_norm(grads)
        # the one host sync of the step, and only under fp16 (or the
        # sentinel's skip policy)
        overflow = bool(overflow) if overflow is not None else False
        clip = self._config.gradient_clipping
        if clip and clip > 0:
            torch._foreach_mul_(grads, torch.clamp(clip / (grad_norm + 1e-6),
                                                   max=1.0))
        if not overflow:
            # LAMB's trust ratio needs whole norms of split masters
            kwargs = ({"norm_reduce": zero.norm_reduce} if zero is not None
                      and isinstance(self.optimizer, FusedLamb) else {})
            self._opt_state = self.optimizer.update(
                grads, self._opt_state, self._params, lr=self._lr(),
                **kwargs)
            if zero is not None:
                zero.write_back()
        self._loss_scaler = update_scale(self._scaler_config,
                                         self._loss_scaler, overflow)
        self._applied_steps += 1
        self.skipped_steps += int(overflow)
        self.zero_grad()
        return overflow, grad_norm

    def forward(self, batch):
        """Loss of one micro-batch; its gradients are computed too (and,
        with ``fused_step``, applied). Returns the detached loss tensor."""
        if self.wall_clock_breakdown_:
            self.timers(FORWARD_GLOBAL_TIMER).start()
            self.tput_timer.start()
        with self.telemetry.annotation("ds.fwd_bwd"), \
                self.telemetry.step_trace.phase("fwd_bwd"):
            self._last_loss = self._fwd_bwd(self, batch)
        if self.wall_clock_breakdown_:
            self.timers(FORWARD_GLOBAL_TIMER).stop()
        return self._last_loss

    __call__ = forward

    def _fwd_bwd_step(self, batch):
        """The micro-step: loss, backward, the ZeRO stage's reduction, the
        mean over the global micro-batch, and with ``fused_step`` the
        optimizer update."""
        loss = self._local_loss(batch)
        gas = 1 if self._fused_step else self.gradient_accumulation_steps()
        (loss * (self._loss_scale() / gas)).backward()
        loss = loss.detach()
        if self._zero is not None:
            self._zero.after_micro_step()
        # the mean over the global micro-batch
        loss = self._batch_mean(loss)
        if self._fused_step:
            self._last_overflow, self._last_grad_norm = self._apply_math()
        return loss

    def _comm_plan(self):
        """The collectives one optimizer step's plan launches, by op (the
        ZeRO stage's plus the model's tensor-parallel pairs); {} with no
        stage."""
        if self._zero is None:
            return {}
        plan = dict(self._zero.comm_plan(
            self.gradient_accumulation_steps(),
            recompute=bool(getattr(getattr(self.module, "config", None),
                                   "remat", False)),
            lamb=isinstance(self.optimizer, FusedLamb)))
        model_plan = getattr(self.module, "comm_plan", None)
        if self.tp is not None and model_plan is not None:
            mb = self.train_micro_batch_size_per_gpu()
            seq = getattr(getattr(self.module, "config", None),
                          "n_positions", None)
            if seq:
                for k, v in model_plan(mb, seq).items():
                    plan[k] = plan.get(k, 0) + v
        return plan

    def backward(self, loss=None, allreduce_gradients=True,
                 release_loss=False):
        """Gradient accounting boundary: the gradients were produced with
        the loss in :meth:`forward`."""
        if self.wall_clock_breakdown_:
            self.timers(BACKWARD_GLOBAL_TIMER).start()
            self.timers(BACKWARD_GLOBAL_TIMER).stop()
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return ((self.micro_steps + 1)
                % self.gradient_accumulation_steps() == 0)

    def step(self, lr_kwargs=None):
        """Optimizer step at gradient-accumulation boundaries (applied in
        :meth:`forward` already with ``fused_step``)."""
        if self._last_loss is None:
            raise RuntimeError("step() called before any forward()")
        at_boundary = self.is_gradient_accumulation_boundary()
        if at_boundary:
            if self.wall_clock_breakdown_:
                self.timers(STEP_GLOBAL_TIMER).start()
            with self.telemetry.annotation("ds.optimizer_step"), \
                    self.telemetry.step_trace.phase("optimizer"):
                if not self._fused_step:
                    self._last_overflow, self._last_grad_norm = \
                        self._apply_step(self)
            self.global_steps += 1
            self.global_samples += self.train_batch_size()
            if self.lr_scheduler is not None:
                self.lr_scheduler.step()
            if self.wall_clock_breakdown_:
                self.timers(STEP_GLOBAL_TIMER).stop()
            # telemetry step boundary: step / memory events and the trace
            # window, at the fences the step already has
            self.telemetry.on_step_boundary(
                self.global_steps, samples=self.global_samples,
                micro_steps=self.micro_steps + 1)
            self._report_progress()
        if self.wall_clock_breakdown_:
            self.tput_timer.stop(global_step=at_boundary)
        self.micro_steps += 1
        if at_boundary:
            # resilience boundary, after every counter has settled:
            # watchdog heartbeat + the sentinel's (lagged) loss check; a
            # trip applies the policy (abort raises, rollback restores the
            # last verified-good checkpoint in place)
            self.resilience.on_step_boundary(self, self.global_steps,
                                             loss=self._last_loss)

    @torch.no_grad()
    def eval_batch(self, batch):
        """The loss of one global micro-batch, as :meth:`forward` computes
        it, with no gradient: no gradient, master, optimizer slot, loss
        scale or counter changes (the JAX engine's ``eval_batch``)."""
        return self._batch_mean(self._local_loss(batch))

    def train_batch(self, data_iter=None, batch=None):
        """``gas`` micro-steps and the optimizer step; returns the mean
        loss (one host sync, after the loop)."""
        losses = []
        for _ in range(self.gradient_accumulation_steps()):
            if batch is not None:
                b = batch
            else:
                with self.telemetry.step_trace.phase("data"):
                    b = next(data_iter)
            loss = self.forward(b)
            self.backward(loss)
            self.step()
            losses.append(loss)
        return float(torch.stack(losses).mean())

    def _report_progress(self):
        if (self.wall_clock_breakdown_
                and self.global_steps % self.steps_per_print() == 0):
            # the breakdown's means route through the telemetry stream
            self.telemetry.wallclock(
                self.timers.get_mean(
                    [FORWARD_GLOBAL_TIMER, BACKWARD_GLOBAL_TIMER,
                     STEP_GLOBAL_TIMER], reset=True),
                step=self.global_steps)
        if self.global_steps % self.steps_per_print() == 0:
            log_dist(f"step={self.global_steps}, "
                     f"skipped={self.get_skipped_steps()}, "
                     f"lr={self.get_lr()}, "
                     f"loss={float(self._last_loss):.6f}", ranks=[0])
            if self.memory_breakdown_:
                from deepspeed_tpu_torch.utils.memory import see_memory_usage

                see_memory_usage(f"step={self.global_steps}", force=True)
        if self.monitor.enabled:
            self.monitor.write_events([
                ("Train/Samples/train_loss", float(self._last_loss),
                 self.global_samples),
                ("Train/Samples/lr", (self.get_lr() or [0.0])[0],
                 self.global_samples)])

    # ------------------------------------------------------------------
    # the JAX engine's remaining surface
    def train(self, mode=True):
        """Training mode flag (the JAX engine's; the module's own mode
        follows it)."""
        self.module_train = mode
        self.module.train(mode)
        return self

    def eval(self):
        return self.train(False)

    def set_train_batch_size(self, train_batch_size):
        """Change the global batch between steps by changing ONLY the
        gradient-accumulation factor (the micro-batch and the
        data-parallel world stay); the fused step stays on only at an
        accumulation factor of 1."""
        per_step = (self.train_micro_batch_size_per_gpu()
                    * (self.topology.get_data_parallel_world_size()
                       if self.topology is not None else 1))
        if train_batch_size % per_step != 0:
            raise DeepSpeedConfigError(
                f"train_batch_size {train_batch_size} is not divisible by "
                f"micro_batch x dp_world = {per_step}")
        self._config.train_batch_size = train_batch_size
        self._config.gradient_accumulation_steps = \
            train_batch_size // per_step
        self._fused_step = (self._config.fused_step
                            and self._config.gradient_accumulation_steps
                            == 1)

    def get_batch_info(self):
        return (self.train_batch_size(),
                self.train_micro_batch_size_per_gpu(),
                self.gradient_accumulation_steps())

    def allreduce_gradients(self, bucket_size=None):
        """A no-op, as in the JAX engine: the stage's plan reduces the
        gradients inside :meth:`forward` and :meth:`step`."""
        del bucket_size

    def destroy(self):
        """Drop the optimizer state and the ZeRO stage's plans and hooks
        (the JAX engine releases its compiled programs and state); the
        engine is not used after it."""
        if self._zero is not None:
            for hook in self._zero._hooks:
                hook.remove()
        self._zero = None
        self._opt_state = None
        self.resilience.close()
        self.telemetry.close()

    def describe_topology(self, include_tensors: bool = True,
                          include_data: bool = True) -> dict:
        """The engine's topology manifest (JAX's keys): the mesh and
        world, the ZeRO stage, the batch geometry, the counters, the
        data-pipeline cursor (``include_data``) and the carried key
        ``rng``; with ``include_tensors``, each tensor of the checkpoint
        file under JAX's names (``params/<flax path>``,
        ``opt_state/.step``, ``opt_state/.exp_avg/<flax path>``, ...)
        with its whole shape and dtype (``spec`` empty: the port's
        splits are its own). Written into every tag when
        ``elasticity.enabled``; the current side of the diff at load."""
        from deepspeed_tpu_torch.runtime.resilience.topology import (
            TOPOLOGY_MANIFEST_VERSION)

        layout = self.spec_layout
        mesh = layout.mesh
        manifest = {
            "version": TOPOLOGY_MANIFEST_VERSION,
            "mesh": {"axes": {a: int(n) for a, n in mesh.axis_sizes.items()},
                     "world_size": int(mesh.world_size),
                     "process_count": int(mesh.world_size)},
            "zero_stage": int(self.zero_optimization_stage()),
            "batch": {
                "train_batch_size": int(self.train_batch_size()),
                "micro_batch_per_gpu":
                    int(self.train_micro_batch_size_per_gpu()),
                "gradient_accumulation_steps":
                    int(self.gradient_accumulation_steps()),
                "dp_world_size": int(mesh.get_data_parallel_world_size())},
            "counters": {"global_steps": int(self.global_steps),
                         "micro_steps": int(self.micro_steps),
                         "global_samples": int(self.global_samples)},
            "format": "consolidated",
            "data_pipeline": (self._data_pipeline_state()
                              if include_data else None),
            "rng": [int(x) for x in self._current_rng()],
        }
        if include_tensors:
            manifest["tensors"] = self._tensor_manifest()
        return manifest

    def _tensor_manifest(self) -> dict:
        """``{name: {"shape", "dtype", "spec"}}`` of each tensor the
        checkpoint file holds, named and shaped as JAX names them, from
        whole shapes alone (no collective); each spec is the ZeRO / tp
        plan's (``[]`` replicated) laid out as the file lays its tensor."""
        meta = self._whole_meta()
        names = list(meta)
        planned = {e.name: e for e in (self._zero.entries
                                       if self._zero is not None else [])}
        # which parameter each file leaf holds: the file tree of
        # one-element tensors holding each parameter's index
        marks = flatten_tree(self._to_file_tree(
            {n: torch.full((1,) * meta[n].ndim, float(i))
             for i, n in enumerate(names)}))
        shapes = flatten_tree(self._to_file_tree(meta))
        slots = [k for k in ("exp_avg", "exp_avg_sq")
                 if getattr(self._opt_state, k, None) is not None]
        tensors = {}
        for path, mark in marks.items():
            name = names[int(mark.reshape(-1)[0])]
            e = planned.get(name)
            shape = [int(d) for d in shapes[path].shape]
            kernel = path.rsplit("/", 1)[-1] == "kernel"
            stacked = mark.ndim > meta[name].ndim
            for prefix, plan in [("params/", e and e.pplan)] + [
                    (f"opt_state/.{k}/", e and e.oplan) for k in slots]:
                tensors[prefix + path] = {
                    "shape": shape, "dtype": "float32",
                    "spec": _file_spec(spec_entries(plan.spec) if plan
                                       else [], meta[name].ndim, kernel,
                                       stacked)}
        tensors["opt_state/.step"] = {"shape": [], "dtype": "int32",
                                      "spec": []}
        return dict(sorted(tensors.items()))

    def _whole_meta(self) -> dict:
        """``{name: meta tensor}`` of the whole model's trained
        parameters (a family model is rebuilt on ``meta``; another model
        keeps its own shapes, whole under ZeRO)."""
        model = self.module
        if model_family(model) is not None:
            whole = type(model)(model.config, device="meta")
            return {n: p for n, p in whole.named_parameters()
                    if p.requires_grad}
        planned = {e.name: e for e in (self._zero.entries
                                       if self._zero is not None else [])}
        return {n: torch.empty(planned[n].pplan.shape if n in planned
                               else p.shape, device="meta")
                for n, p in model.named_parameters() if p.requires_grad}

    def _to_file_tree(self, named: dict):
        """The file's tree of ``named`` whole tensors: JAX's flax tree
        for a model family the JAX package has, the names themselves
        otherwise."""
        tree = training_params_to_jax(self.module, named)
        return dict(named) if tree is None else tree

    def _from_file_tree(self, tree) -> dict:
        """Whole tensors ``{name: tensor}`` from the file's tree."""
        if model_family(self.module) is not None:
            return training_params_from_jax(self.module, tree)
        return {k: torch.as_tensor(np.asarray(v))
                for k, v in flatten_tree(tree).items()}

    # ------------------------------------------------------------------
    # data loading (JAX's deepspeed_io / attach_data_loader)
    def deepspeed_io(self, dataset, batch_size=None, route=None,
                     pin_memory=True, data_sampler=None, collate_fn=None,
                     num_local_io_workers=None):
        """A loader of *global* micro-batches (micro_batch x dp_world
        samples a step), JAX's ``deepspeed_io``: the same sample order,
        cursor and ``dataloader_drop_last``."""
        dp = (self.topology.get_data_parallel_world_size()
              if self.topology is not None else 1)
        bs = batch_size or self.train_micro_batch_size_per_gpu() * dp
        return DeepSpeedDataLoader(
            dataset, batch_size=bs,
            collate_fn=collate_fn or self.collate_fn,
            data_sampler=data_sampler,
            dataloader_drop_last=self._config.dataloader_drop_last)

    def attach_data_loader(self, loader):
        """Attach the data pipeline whose cursor travels with checkpoints
        (the topology manifest records ``loader.state_dict()``)."""
        self._elastic_loader = loader

    def _data_pipeline_state(self):
        loader = self._elastic_loader or self.training_dataloader
        state_fn = getattr(loader, "state_dict", None)
        if state_fn is None:
            return None
        try:
            return state_fn()
        except Exception as e:  # a cursor is advisory; the save is not
            logger.warning(f"data pipeline state_dict failed ({e}); the "
                           "topology manifest carries no loader cursor")
            return None

    # ------------------------------------------------------------------
    # checkpoints (JAX engine :2305-2680)
    def _current_rng(self) -> np.ndarray:
        """JAX's TrainState.rng after this run's micro steps: one split a
        micro step since the key was last set (:func:`advance_key`)."""
        n = self.micro_steps - self._rng_micro
        if n > 0:
            self._rng = advance_key(self._rng, n)
            self._rng_micro = self.micro_steps
        return self._rng

    def _named_masters(self):
        """``[(name, master, ZeRO entry or None)]`` in the optimizer's
        order (its slots follow it)."""
        if self._zero is not None:
            return [(e.name, e.master, e) for e in self._zero.entries]
        return [(n, p, None) for n, p in self.module.named_parameters()
                if p.requires_grad]

    def _whole_slots(self, slots) -> dict:
        """``{name: whole slot}`` of one optimizer slot list: split ZeRO
        shards all-gathered, tp slices gathered (every rank must call)."""
        out = {}
        for (name, _, e), t in zip(self._named_masters(), slots):
            if e is not None and e.oplan.sharded:
                t = all_gather_flat([t], [e.oplan])[0]
            out[name] = t.detach()
        return {k: v.cpu() for k, v in self._whole(out).items()}

    def _load_slots(self, whole: dict, slots):
        """Copy whole slot values into this rank's slot tensors (its tp
        slice, then its ZeRO shard); no collective."""
        if self.tp is not None:
            specs = self.module.param_specs()
            whole, _ = shard_params_with_policy(
                whole, None, self.tp.rank, self.tp.size,
                specs={k: specs.get(k) for k in whole})
        for (name, _, e), t in zip(self._named_masters(), slots):
            v = torch.as_tensor(whole[name]).to(t.device, t.dtype)
            t.copy_(e.oplan.local(v) if e is not None else v)

    def _checkpoint_tag_validation(self, tag):
        """All ranks must agree on the tag (JAX ``:2437``)."""
        if not self._config.checkpoint_tag_validation_enabled \
                or dist.get_world_size() <= 1:
            return
        import hashlib

        h = int(hashlib.sha1(str(tag).encode()).hexdigest()[:8], 16)
        agreed = dist.all_reduce(
            torch.tensor([h, -h], dtype=torch.int64, device=self.device),
            op=dist.ReduceOp.MAX)
        if not (int(agreed[0]) == h and int(agreed[1]) == -h):
            msg = f"checkpoint tag {tag!r} differs across processes"
            if self._config.checkpoint_tag_validation_fail:
                raise RuntimeError(msg)
            logger.warning(msg)

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """Write ``<save_dir>/<tag>`` (default ``global_step<N>``) in
        JAX's layout (module docstring); every rank must call. Returns
        True."""
        # judge any sentinel-pending lagged losses now: an unchecked NaN
        # boundary must not become a verified-good checkpoint
        self.resilience.drain_sentinel()
        with self.resilience.watchdog_suspended():
            tracer = self.telemetry.tracer
            with tracer.span("ckpt_io", tracer.new_trace(hint="ckpt"),
                             action="save", tag=str(tag),
                             step=self.global_steps):
                return self._save_checkpoint_impl(save_dir, tag,
                                                  client_state, save_latest)

    def _save_checkpoint_impl(self, save_dir, tag, client_state,
                              save_latest):
        tag = tag or f"global_step{self.global_steps}"
        self._checkpoint_tag_validation(tag)
        ckpt_dir = os.path.join(save_dir, str(tag))
        self.checkpoint_engine.create(tag)
        engine_state = {
            "micro_steps": self.micro_steps,
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "lr_scheduler": (self.lr_scheduler.state_dict()
                             if self.lr_scheduler else None),
            "client_state": client_state or {},
        }
        # the whole tensors (collectives under ZeRO / tp: every rank)
        params = self.module_state_dict()
        opt = self._opt_state
        slots = {k: (self._whole_slots(getattr(opt, k))
                     if getattr(opt, k, None) is not None else None)
                 for k in ("exp_avg", "exp_avg_sq")}
        scaler = self._loss_scaler
        if dist.get_rank() == 0:
            module_state = {"params": self._to_file_tree(params)}
            optim_state = {
                "opt_state": {
                    "step": np.asarray(opt.step, np.int32),
                    **{k: (self._to_file_tree(v) if v is not None
                           else None) for k, v in slots.items()}},
                "host_optimizer": None,
                "loss_scale": np.asarray(scaler.loss_scale, np.float32),
                "good_steps": np.asarray(scaler.good_steps, np.int32),
                "hysteresis": np.asarray(scaler.hysteresis, np.int32),
                "global_step": np.asarray(self._applied_steps, np.int32),
                "skipped_steps": np.asarray(self.skipped_steps, np.int32),
                "rng": self._current_rng().copy(),
            }
            self.checkpoint_engine.save(module_state,
                                        os.path.join(ckpt_dir, "module"))
            self.checkpoint_engine.save(optim_state,
                                        os.path.join(ckpt_dir, "optimizer"))
            self.checkpoint_engine.save(engine_state,
                                        os.path.join(ckpt_dir, "engine"))
            if self.elasticity_enabled():
                # written before commit: hashed into the integrity
                # manifest and published with the tag
                from deepspeed_tpu_torch.runtime.resilience.topology import (
                    write_topology_manifest)

                write_topology_manifest(self.checkpoint_engine, ckpt_dir,
                                        self.describe_topology())
        self.checkpoint_engine.commit(tag)
        # "latest" moves only after the commit published the tag, and
        # the pointer write itself is atomic
        if dist.get_rank() == 0 and save_latest:
            atomic_write_text(os.path.join(save_dir, "latest"), str(tag))
        if dist.is_initialized():
            dist.barrier()
        self.resilience.note_save_dir(save_dir)
        log_dist(f"saved checkpoint {tag} to {save_dir}", ranks=[0])
        return True

    @staticmethod
    def _missing_tag_error(load_dir, tag, explicit):
        from deepspeed_tpu_torch.runtime.resilience.integrity import (
            missing_tag_error)

        via = (f"explicit tag {tag!r}" if explicit
               else f"'latest' points at {tag!r}")
        return missing_tag_error(load_dir, tag, via)

    def load_checkpoint(self, load_dir, tag=None, load_module_strict=True,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_only=False, custom_load_fn=None):
        """Restore from ``load_dir``; returns ``(tag, client_state)``, or
        ``(None, {})`` when there is no ``latest``. ``tag=None`` resumes
        from ``latest`` and — with resilience integrity on — walks the
        verified-good fallback chain when the pointed-at checkpoint is
        corrupt or missing. An explicit ``tag`` never falls back: a
        missing or corrupt explicit tag raises, naming the tags present.
        Every rank must call."""
        with self.resilience.watchdog_suspended():
            tracer = self.telemetry.tracer
            with tracer.span("ckpt_io", tracer.new_trace(hint="ckpt"),
                             action="load", tag=str(tag),
                             step=self.global_steps):
                return self._load_checkpoint_resolved(
                    load_dir, tag, load_module_strict=load_module_strict,
                    load_optimizer_states=load_optimizer_states,
                    load_lr_scheduler_states=load_lr_scheduler_states,
                    load_module_only=load_module_only)

    def _load_checkpoint_resolved(self, load_dir, tag, *,
                                  load_module_strict=True,
                                  load_optimizer_states=True,
                                  load_lr_scheduler_states=True,
                                  load_module_only=False):
        from deepspeed_tpu_torch.runtime.resilience.integrity import (
            CheckpointCorruptionError, read_verified)

        explicit = tag is not None
        if tag is None:
            tag = read_latest(load_dir)
            if tag is None:
                logger.warning(f"no 'latest' file at {load_dir}; nothing "
                               "loaded")
                return None, {}
        candidates = [str(tag)]
        if (not explicit and self.resilience.enabled
                and self._config.resilience_config.checkpoint.fallback):
            # previous verified-good tags, newest first
            candidates += [t for t in reversed(read_verified(load_dir))
                           if t not in candidates]
        multiproc = dist.get_world_size() > 1
        last_err = None
        for i, t in enumerate(candidates):
            ckpt_dir = os.path.join(load_dir, t)
            err = None
            if not multiproc or dist.get_rank() == 0:
                # verify before any bytes deserialize, so a corrupt
                # candidate never leaves the engine half-restored
                if not os.path.isdir(ckpt_dir):
                    err = self._missing_tag_error(load_dir, t, explicit)
                elif hasattr(self.checkpoint_engine, "verify"):
                    try:
                        self.checkpoint_engine.verify(ckpt_dir)
                    except CheckpointCorruptionError as e:
                        err = e
            if multiproc:
                # every rank agrees on the candidate before loading
                flag = torch.tensor([0 if err is None else 1],
                                    dtype=torch.int32, device=self.device)
                rejected = bool(dist.broadcast(flag, src=0)[0])
                if rejected and err is None:
                    err = CheckpointCorruptionError(
                        f"checkpoint {t!r} rejected by rank 0 "
                        "(verification failed there)")
            if err is not None:
                err.agreed_rejection = True
                last_err = err
                if i + 1 < len(candidates):
                    logger.warning(
                        f"[resilience] checkpoint {t!r} unusable ({err}); "
                        f"falling back to {candidates[i + 1]!r}")
                    continue
                raise err
            try:
                result = self._load_checkpoint_tag(
                    ckpt_dir, t, load_module_strict=load_module_strict,
                    load_optimizer_states=load_optimizer_states,
                    load_lr_scheduler_states=load_lr_scheduler_states,
                    load_module_only=load_module_only)
            except (CheckpointCorruptionError, OSError) as e:
                last_err = e
                if multiproc or i + 1 >= len(candidates):
                    raise
                logger.warning(
                    f"[resilience] checkpoint {t!r} failed mid-load ({e}); "
                    f"falling back to {candidates[i + 1]!r}")
                continue
            if i > 0:
                self.resilience.emit_fault(
                    "ckpt.fallback", from_tag=candidates[0], to_tag=t,
                    error=str(last_err)[:300])
                logger.warning(
                    f"[resilience] FALLBACK RESTORE: resumed from "
                    f"verified-good {t!r} instead of {candidates[0]!r}")
            return result
        raise last_err  # unreachable: the loop raised or returned

    def _validate_topology_for_load(self, manifest, ckpt_dir, *,
                                    params_only: bool):
        """Saved-vs-current topology diff, raising a structured
        :class:`TopologyShiftError` when resharding is impossible."""
        from deepspeed_tpu_torch.runtime.resilience.topology import (
            validate_reshard)

        saved, current = manifest, self.describe_topology(include_data=False)
        if params_only:
            saved = dict(manifest)
            saved["tensors"] = {
                k: v for k, v in (manifest.get("tensors") or {}).items()
                if k.startswith("params/")}
            current["tensors"] = {
                k: v for k, v in (current.get("tensors") or {}).items()
                if k.startswith("params/")}
        return validate_reshard(saved, current, ckpt_dir)

    def _load_checkpoint_tag(self, ckpt_dir, tag, *, load_module_strict=True,
                             load_optimizer_states=True,
                             load_lr_scheduler_states=True,
                             load_module_only=False):
        from deepspeed_tpu_torch.runtime.resilience.topology import (
            read_topology_manifest, topology_shifted)

        manifest = read_topology_manifest(ckpt_dir)
        diff = None
        if manifest is not None:
            diff = self._validate_topology_for_load(
                manifest, ckpt_dir,
                params_only=load_module_only or not load_optimizer_states)
        flat = self.checkpoint_engine.load(os.path.join(ckpt_dir, "module"))
        whole = self._from_file_tree(unflatten_by_paths(flat, "params/"))
        self.load_module_state_dict(whole, strict=load_module_strict)
        self.zero_grad()
        client_state = {}
        if not load_module_only:
            if load_optimizer_states:
                self._load_optimizer_file(ckpt_dir)
            engine_state = self.checkpoint_engine.load(
                os.path.join(ckpt_dir, "engine"))
            client_state = self._restore_engine_aux(
                engine_state, load_lr_scheduler_states)
        if manifest is not None:
            saved_mesh = manifest.get("mesh", {})
            self.telemetry.emit(
                "topology", "restore", step=self.global_steps,
                data={"tag": str(tag), "saved_mesh": saved_mesh.get("axes"),
                      "saved_world": saved_mesh.get("world_size"),
                      "current_mesh": dict(self.spec_layout.mesh.axis_sizes),
                      "current_world": int(self.spec_layout.mesh.world_size),
                      "resharded": bool(diff and topology_shifted(diff)),
                      "zero_stage_saved": manifest.get("zero_stage"),
                      "zero_stage_current":
                          int(self.zero_optimization_stage())})
        log_dist(f"loaded checkpoint {tag} from {ckpt_dir}", ranks=[0])
        return tag, client_state

    def _load_optimizer_file(self, ckpt_dir):
        """The optimizer file into the slots (whole, laid out for this
        engine), the loss-scale counters, the step counters and the key."""
        flat = self.checkpoint_engine.load(
            os.path.join(ckpt_dir, "optimizer"))
        tree = unflatten_by_paths(flat, "opt_state/")
        opt = self._opt_state
        for k in ("exp_avg", "exp_avg_sq"):
            slots = getattr(opt, k, None)
            if slots is not None:
                self._load_slots(self._from_file_tree(tree[k]), slots)
        self._opt_state = opt._replace(step=int(flat["opt_state/step"]))
        self._loss_scaler = self._loss_scaler._replace(
            loss_scale=float(flat["loss_scale"]),
            good_steps=int(flat["good_steps"]),
            hysteresis=int(flat["hysteresis"]))
        self._applied_steps = int(flat["global_step"])
        self.skipped_steps = int(flat["skipped_steps"])
        self._rng = np.asarray(flat["rng"], np.uint32).reshape(2).copy()

    def _restore_engine_aux(self, engine_state: dict,
                            load_lr_scheduler_states: bool) -> dict:
        """Counters, lr scheduler and client_state."""
        self.micro_steps = int(engine_state.get("micro_steps", 0))
        self.global_steps = int(engine_state.get("global_steps", 0))
        self.global_samples = int(engine_state.get("global_samples", 0))
        self._rng_micro = self.micro_steps
        if load_lr_scheduler_states and self.lr_scheduler is not None:
            lbi = engine_state.get("lr_scheduler/last_batch_iteration")
            if lbi is not None:
                self.lr_scheduler.load_state_dict(
                    {"last_batch_iteration": int(lbi)})
        return {k[len("client_state/"):]: v for k, v in engine_state.items()
                if k.startswith("client_state/")}

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
        return self._config.zero_optimization_stage

    def zero_optimization(self):
        return self._config.zero_enabled

    def zero_optimization_partition_gradients(self):
        return self.zero_optimization_stage() >= 2

    def zero_optimization_partition_weights(self):
        return self.zero_optimization_stage() >= 3

    def zero_reduce_bucket_size(self):
        return self._config.zero_config.reduce_bucket_size

    def zero_allgather_bucket_size(self):
        return self._config.zero_config.allgather_bucket_size

    def zero_param_persistence_threshold(self):
        return self._config.zero_config.param_persistence_threshold

    def zero_allow_untested_optimizer(self):
        return self._config.zero_allow_untested_optimizer

    def zero_allgather_partitions(self):
        return self._config.zero_config.allgather_partitions

    def zero_reduce_scatter(self):
        return self._config.zero_config.reduce_scatter

    def zero_overlap_comm(self):
        return self._config.zero_config.overlap_comm

    def zero_contiguous_gradients(self):
        return self._config.zero_config.contiguous_gradients

    def zero_sub_group_size(self):
        return self._config.zero_config.sub_group_size

    def zero_prefetch_bucket_size(self):
        return self._config.zero_config.prefetch_bucket_size

    def zero_model_persistence_threshold(self):
        return self._config.zero_config.model_persistence_threshold

    def zero_max_live_parameters(self):
        return self._config.zero_config.max_live_parameters

    def zero_max_reuse_distance(self):
        return self._config.zero_config.max_reuse_distance

    def zero_gather_16bit_weights_on_model_save(self):
        return self._config.zero_config.gather_16bit_weights_on_model_save

    def zero_ignore_unused_parameters(self):
        return self._config.zero_config.ignore_unused_parameters

    def zero_legacy_stage1(self):
        return self._config.zero_config.legacy_stage1

    def zero_round_robin_gradients(self):
        return self._config.zero_config.round_robin_gradients

    def zero_elastic_checkpoint(self):
        return self._config.zero_config.elastic_checkpoint

    def zero_load_from_fp32_weights(self):
        return self._config.zero_config.load_from_fp32_weights

    def optimizer_name(self):
        return (self.optimizer.__class__.__name__
                if self._client_optimizer else self._config.optimizer_name)

    def optimizer_params(self):
        return self._config.optimizer_params

    def scheduler_name(self):
        return self._config.scheduler_name

    def scheduler_params(self):
        return self._config.scheduler_params

    def dynamic_loss_scale(self):
        return self._config.fp16.loss_scale == 0

    def dynamic_loss_scale_args(self):
        f = self._config.fp16
        return {"init_scale": 2 ** f.initial_scale_power,
                "scale_window": f.loss_scale_window,
                "min_scale": f.min_loss_scale,
                "delayed_shift": f.hysteresis}

    def postscale_gradients(self):
        return not self._config.prescale_gradients

    def gradient_predivide_factor(self):
        return self._config.gradient_predivide_factor

    def communication_data_type(self):
        return self._config.communication_data_type

    def sparse_gradients_enabled(self):
        return self._config.sparse_gradients_enabled

    def fp16_enabled(self):
        return self.fp16_enabled_

    def bfloat16_enabled(self):
        return self.bf16_enabled_

    def gradient_clipping(self):
        return self._config.gradient_clipping

    def get_lr(self):
        return [self._lr()]

    def wall_clock_breakdown(self):
        return self.wall_clock_breakdown_

    def memory_breakdown(self):
        return self._config.memory_breakdown

    def dump_state(self):
        return self._config.dump_state

    def elasticity_enabled(self):
        return bool(self._config.elasticity_config.get("enabled", False))

    def use_node_local_storage(self):
        return self._config.use_node_local_storage

    def load_universal_checkpoint(self):
        return self._config.load_universal_checkpoint

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
        """Host (CPU) copy of the model's whole parameters; under ZeRO-3
        the split ones are gathered, under tp the slices (every rank must
        call)."""
        sd = self.module.state_dict()
        if self._zero is not None:
            entries = self._zero.entries
            for e, t in zip(entries, self._zero.gather_params(entries)):
                sd[e.name] = t
        return {k: v.detach().cpu() for k, v in self._whole(sd).items()}

    def load_module_state_dict(self, state_dict, strict=True):
        """Copy ``state_dict`` (whole tensors) into the live parameters,
        keeping their device and dtype, re-sharded under ZeRO (and into
        the masters; under tp, this rank's slices); ``strict=False`` keeps
        entries it lacks."""
        if self.tp is not None:
            specs = self.module.param_specs()
            state_dict, _ = shard_params_with_policy(
                state_dict, None, self.tp.rank, self.tp.size,
                specs={k: specs.get(k) for k in state_dict})
        if self._zero is None:
            self.module.load_state_dict(state_dict, strict=strict)
            return
        names = set(self.module.state_dict())
        missing = sorted(names - set(state_dict))
        unexpected = sorted(set(state_dict) - names)
        if strict and (missing or unexpected):
            raise RuntimeError(f"load_module_state_dict: missing keys "
                               f"{missing}, unexpected keys {unexpected}")
        params = {e.name for e in self._zero.entries}
        self._zero.load(state_dict)
        self.module.load_state_dict(
            {k: v for k, v in state_dict.items() if k not in params},
            strict=False)

    def gathered_grads(self):
        """``{name: whole gradient}`` of what the last backward left,
        reduced over the data-parallel ranks and gathered from the tp
        slices (every rank must call), for checks; the step applies none
        of it."""
        if self._zero is None:
            return {n: p.grad for n, p in self.module.named_parameters()
                    if p.requires_grad}
        self._zero.after_micro_step()
        return self._whole(self._zero.gather_grads())

    def zero_grad(self):
        for p in self.module.parameters():
            p.grad = None
        if self._zero is not None:
            self._zero.clear()


# getters of the JAX engine whose keys belong to unported slices: each
# raises naming its slice (``runtime/config.py`` refuses the keys too)
_UNPORTED_GETTERS = {
    "the offload slice": (
        "zero_cpu_offload", "zero_offload_param", "zero_offload_optimizer",
        "swap_tensor_config", "aio_config"),
    "the training-features slice": (
        "eigenvalue_verbose", "eigenvalue_max_iter", "eigenvalue_tol",
        "eigenvalue_stability", "eigenvalue_gas_boundary_resolution",
        "eigenvalue_layer_name", "eigenvalue_layer_num",
        "curriculum_learning_config", "curriculum_learning_enabled",
        "get_pld_theta", "flops_profiler_enabled",
        "flops_profiler_profile_step", "flops_profiler_module_depth",
        "flops_profiler_top_modules", "flops_profiler_detailed",
        "flops_profiler_output_file"),
}


def _unported_getter(name, where):
    def getter(self, *args, **kwargs):
        raise NotImplementedError(
            f"DeepSpeedEngine.{name} is not ported yet: it comes with "
            f"{where} of the PyTorch port")

    getter.__name__ = name
    return getter


for _where, _names in _UNPORTED_GETTERS.items():
    for _name in _names:
        setattr(DeepSpeedEngine, _name, _unported_getter(_name, _where))


def advance_key(key, n: int) -> np.ndarray:
    """``key`` (uint32[2]) after ``n`` of JAX's ``split(key, 4)[0]``: each
    is threefry2x32 of the counter (0, 0), here on Python ints (tens of
    microseconds a split, no tensor ops)."""
    k1, k2 = (int(x) for x in key)
    for _ in range(n):
        k1, k2 = threefry_2x32(k1, k2, 0, 0)
    return np.array([k1, k2], np.uint32)


def _file_spec(spec: list, ndim: int, kernel: bool, stacked: bool) -> list:
    """A parameter's spec entries (the port's dim order) in the file's
    layout: reversed for a flax Dense ``kernel``, a leading unsharded
    layer dim when stacked; ``[]`` (replicated) stays ``[]``."""
    if not spec:
        return []
    spec = list(spec) + [None] * (ndim - len(spec))
    return [None] * stacked + (spec[::-1] if kernel else spec)
