"""Training configuration (counterpart of ``deepspeed_tpu/runtime/config.py``).

:class:`DeepSpeedConfig` parses the keys the training engine implements:
the batch triangle, ``optimizer``, ``scheduler``, ``gradient_clipping``,
``bf16``, ``fp16``, ``fused_step``, ``zero_optimization`` (stages 0-3,
:class:`~deepspeed_tpu_torch.runtime.zero.config.DeepSpeedZeroConfig`),
the ``mesh`` section (``data``, ``fsdp`` and ``tp`` axes, ``model`` the
alias of ``tp``, and ``dcn``), the ``tensor_parallel`` section (its
``policy``: the tp base specs, as in the JAX engine), the gradient
reduction's ``prescale_gradients`` / ``gradient_predivide_factor``,
``communication_data_type`` (recorded, as the JAX engine does: gradients
reduce in fp32), ``disable_allgather`` (accepted and inert, as in JAX),
``sparse_gradients`` (recorded), ``zero_allow_untested_optimizer``,
``gradient_accumulation_steps``, ``steps_per_print``, the
``sparse_attention`` section (handed to the model's
``with_sparse_attention`` hook by the engine), and the telemetry slice's
keys: the ``telemetry`` section (:class:`TelemetryConfig`, with its
``trace``, ``tracing`` and ``flight_recorder`` blocks),
``wall_clock_breakdown``, ``memory_breakdown``, ``comms_logger``
(:class:`CommsLoggerConfig`) and the monitor writers ``tensorboard``,
``wandb`` and ``csv_monitor`` (:class:`MonitorConfig`), and the
checkpoint and resilience slice's keys: ``checkpoint``
(:class:`CheckpointConfig`), ``nebula`` (:class:`NebulaConfig`),
``resilience`` (:class:`ResilienceConfig`), ``dump_state``,
``dataloader_drop_last`` and ``elasticity`` (a dict whose ``enabled``
writes the topology manifest into every checkpoint), with the JAX
config's keys, defaults, validation and error texts. A key the JAX config
accepts but this port does not implement yet raises
:class:`NotImplementedError` naming the slice of the port that brings it,
instead of being accepted and ignored; a key neither knows raises
:class:`DeepSpeedConfigError`.

The batch triangle's world is the data-parallel one: ``world / (tp x
pipe x seq x fsdp)`` (fsdp splits weights, never the batch), the world
being the running process group's, else ``WORLD_SIZE``.
"""

import json
import os
from typing import Any, Dict, Optional

from pydantic import Field, model_validator

from deepspeed_tpu_torch.parallel.topology import check_ported_axes
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config_utils import (
    DeepSpeedConfigModel, dict_raise_error_on_duplicate_keys)
from deepspeed_tpu_torch.runtime.precision_config import (BF16Config,
                                                          FP16Config)
from deepspeed_tpu_torch.runtime.zero.config import DeepSpeedZeroConfig


class DeepSpeedConfigError(Exception):
    pass


_TRAINING_FEATURES = "the training-features slice"
# keys of the JAX training config, and the port's slice that will
# implement each (ROADMAP.md, Queue 1)
UNPORTED = {
    "pipeline": "the pipeline slice",
    "comm_quantization": "the compressed-collectives slice ([9])",
    "activation_checkpointing": _TRAINING_FEATURES,
    "progressive_layer_drop": _TRAINING_FEATURES,
    "curriculum_learning": _TRAINING_FEATURES,
    "data_efficiency": _TRAINING_FEATURES,
    "compression_training": _TRAINING_FEATURES,
    "quantize_training": _TRAINING_FEATURES,
    "eigenvalue": _TRAINING_FEATURES,
    "flops_profiler": _TRAINING_FEATURES,
    "amp": _TRAINING_FEATURES, "data_types": _TRAINING_FEATURES,
    "aot": "the checkpoint slice's aot decision ([10])",
    "tuning": "the autotuning slice", "autotuning": "the autotuning slice",
    "aio": "the offload slice",
}
# per-rank sharded and async checkpoints (ROADMAP [10b])
SHARDED_CHECKPOINTS = "the sharded-checkpoint slice ([10b])"
SUPPORTED = frozenset({
    C.TRAIN_BATCH_SIZE, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
    C.GRADIENT_ACCUMULATION_STEPS, C.OPTIMIZER, C.SCHEDULER,
    C.GRADIENT_CLIPPING, C.FP16, C.BF16, C.BFLOAT16, C.ZERO_OPTIMIZATION,
    C.FUSED_STEP, C.STEPS_PER_PRINT, C.SPARSE_ATTENTION, C.MESH,
    C.PRESCALE_GRADIENTS, C.GRADIENT_PREDIVIDE_FACTOR,
    C.COMMUNICATION_DATA_TYPE, C.DISABLE_ALLGATHER, C.SPARSE_GRADIENTS,
    C.ZERO_ALLOW_UNTESTED_OPTIMIZER, C.TENSOR_PARALLEL,
    C.WALL_CLOCK_BREAKDOWN, C.MEMORY_BREAKDOWN, C.TELEMETRY,
    C.COMMS_LOGGER, C.TENSORBOARD, C.WANDB, C.CSV_MONITOR, C.CHECKPOINT,
    C.NEBULA, C.RESILIENCE, C.DUMP_STATE, C.DATALOADER_DROP_LAST,
    C.ELASTICITY})


class CommsLoggerConfig(DeepSpeedConfigModel):
    """Reference ``deepspeed/comm/config.py``."""

    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: list = Field(default_factory=list)


class TensorBoardConfig(DeepSpeedConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


class WandbConfig(DeepSpeedConfigModel):
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed"


class CSVConfig(DeepSpeedConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


class MonitorConfig(DeepSpeedConfigModel):
    """Reference ``deepspeed/monitor/config.py`` (flattened sections)."""

    tensorboard: TensorBoardConfig = Field(default_factory=TensorBoardConfig)
    wandb: WandbConfig = Field(default_factory=WandbConfig)
    csv_monitor: CSVConfig = Field(default_factory=CSVConfig)

    @property
    def enabled(self):
        return (self.tensorboard.enabled or self.wandb.enabled
                or self.csv_monitor.enabled)


class TelemetryTraceConfig(DeepSpeedConfigModel):
    """``telemetry.trace``: a ``torch.profiler`` trace (CUDA activity)
    for exactly ``num_steps`` steps starting once ``start_step`` steps
    have completed (``num_steps == 0`` disables the window); the Chrome
    trace lands under ``dir``."""

    start_step: int = 0
    num_steps: int = 0
    dir: str = "./telemetry/trace"

    @model_validator(mode="after")
    def _check(self):
        if self.start_step < 0 or self.num_steps < 0:
            raise ValueError("telemetry.trace.start_step/num_steps must be "
                             ">= 0")
        return self


class TelemetryTracingConfig(DeepSpeedConfigModel):
    """``telemetry.tracing``: span-based causal tracing
    (``telemetry/tracing.py``) — serving request traces and training
    step-phase traces as ``span`` events, plus a per-step exposed-comm
    fraction. The rates keep the JAX names: on the card ``ici_gbps`` /
    ``axis_gbps`` price NVLink or the network a mesh axis rides, and
    ``peak_tflops`` is the card's dense peak (0 = the device default)."""

    enabled: bool = False
    exposed_comm: bool = True
    ici_gbps: float = 90.0
    peak_tflops: float = 0.0
    axis_gbps: Dict[str, float] = Field(default_factory=dict)

    @model_validator(mode="after")
    def _check(self):
        if self.ici_gbps < 0 or self.peak_tflops < 0:
            raise ValueError("telemetry.tracing.ici_gbps/peak_tflops must "
                             "be >= 0")
        for axis, rate in self.axis_gbps.items():
            if rate <= 0:
                raise ValueError(
                    f"telemetry.tracing.axis_gbps[{axis!r}] must be > 0")
        return self


class TelemetryFlightRecorderConfig(DeepSpeedConfigModel):
    """``telemetry.flight_recorder``: a bounded in-memory ring of recent
    telemetry events (spans included) + metric-registry snapshots,
    continuously armed while telemetry is on and dumped atomically to
    ``<dump_dir>/flightrec-<ts>/`` on fault events, breaker trips,
    SIGTERM, or an explicit call (``telemetry/flightrec.py``). Off by
    default; it changes host-side bookkeeping only."""

    enabled: bool = False
    events: int = 512
    snapshots: int = 64
    dump_dir: Optional[str] = None
    max_dumps: int = 4
    on_sigterm: bool = True

    @model_validator(mode="after")
    def _check(self):
        if self.events <= 0 or self.snapshots < 0 or self.max_dumps < 1:
            raise ValueError(
                "telemetry.flight_recorder needs events > 0, "
                "snapshots >= 0 and max_dumps >= 1")
        return self


class TelemetryConfig(DeepSpeedConfigModel):
    """``telemetry`` section: the unified observability event stream
    (``deepspeed_tpu_torch/telemetry/``), JAX's keys and defaults. Its
    collectors on the card: kernel-build and call-signature watches
    (``compile_watchdog``), the once-a-signature step cost
    (``hlo_cost``: FLOPs by ``FlopCounterMode``, collective bytes from
    the comm plan), ``torch.cuda`` memory samples every
    ``sample_every`` boundaries (``memory``) and ``torch.profiler``
    trace windows (``trace``). Events land in a rank-0 JSON-lines sink
    at ``<dir>/telemetry.jsonl``; render it with ``python
    tools/telemetry_report.py <path>``."""

    enabled: bool = False
    dir: str = "./telemetry"
    jsonl: bool = True
    rotate_bytes: int = 0
    rotate_keep: int = 4
    compile_watchdog: bool = True
    hlo_cost: bool = True
    memory: bool = True
    sample_every: int = 1
    warmup_steps: int = 1
    recompile_warn_after: int = 1
    metrics_port: Optional[int] = None
    metrics_host: str = "127.0.0.1"
    metrics_file: Optional[str] = None
    trace: TelemetryTraceConfig = Field(default_factory=TelemetryTraceConfig)
    tracing: TelemetryTracingConfig = Field(
        default_factory=TelemetryTracingConfig)
    flight_recorder: TelemetryFlightRecorderConfig = Field(
        default_factory=TelemetryFlightRecorderConfig)

    @model_validator(mode="after")
    def _check(self):
        if self.sample_every <= 0:
            raise ValueError("telemetry.sample_every must be positive")
        if self.warmup_steps < 0 or self.recompile_warn_after < 1:
            raise ValueError("telemetry.warmup_steps must be >= 0 and "
                             "recompile_warn_after >= 1")
        if self.rotate_bytes < 0 or self.rotate_keep < 1:
            raise ValueError("telemetry.rotate_bytes must be >= 0 and "
                             "rotate_keep >= 1")
        if self.metrics_port is not None and not (
                0 <= self.metrics_port <= 65535):
            raise ValueError("telemetry.metrics_port must be a valid "
                             "port (0 binds an ephemeral one) or absent")
        return self


class CheckpointConfig(DeepSpeedConfigModel):
    """``checkpoint`` section (JAX's ``CheckpointConfig``): tag
    validation across ranks; ``sharded`` and ``async_save`` (JAX's orbax
    tiers) raise naming ROADMAP item [10b]."""

    tag_validation: str = "Warn"
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: dict = Field(default_factory=dict)
    async_save: bool = False
    sharded: bool = False

    @model_validator(mode="after")
    def _check_tag_validation(self):
        normalized = self.tag_validation.capitalize()
        if normalized not in C.CHECKPOINT_TAG_VALIDATION_MODES:
            raise ValueError(
                f"checkpoint.tag_validation must be one of "
                f"{C.CHECKPOINT_TAG_VALIDATION_MODES}, "
                f"got {self.tag_validation!r}")
        if normalized != self.tag_validation:
            object.__setattr__(self, "tag_validation", normalized)
        for key in ("sharded", "async_save"):
            if getattr(self, key):
                raise NotImplementedError(
                    f"checkpoint.{key} is not ported yet: it comes with "
                    f"{SHARDED_CHECKPOINTS} of the PyTorch port")
        return self


class NebulaConfig(DeepSpeedConfigModel):
    """``nebula`` section: service-style tiered checkpointing — fast-tier
    commits + periodic durable mirror with version retention. Served by
    ``TieredCheckpointEngine``."""

    enabled: bool = False
    persistent_storage_path: Optional[str] = None
    persistent_time_interval: float = 100.0
    num_of_version_in_retention: int = 2
    enable_nebula_load: bool = True
    load_path: Optional[str] = None


class ResilienceCheckpointConfig(DeepSpeedConfigModel):
    """``resilience.checkpoint``: integrity manifests + fallback chain +
    IO retry + retention (``runtime/resilience/integrity.py``).

    - ``integrity``: write a per-file sha256 manifest as the ``commit()``
      step and record the tag verified-good.
    - ``verify_on_load``: re-check the manifest before any bytes
      deserialize; a mismatch raises ``CheckpointCorruptionError`` and
      (on a ``latest`` resume) falls back down the verified-good chain.
    - ``fallback``: enable the resume fallback chain
      (``latest`` → previous verified-good tags, newest first).
    - ``retries`` / ``retry_backoff_secs``: transient save/load IO errors
      retry with exponential backoff (``backoff * 2**attempt``).
    - ``keep_last_n``: retention over *verified* tags; ``0`` keeps all.
      The newest verified-good tag and the ``preempt`` tag are never
      deleted.
    - ``rollback_dir``: pins where ``sentinel.policy: rollback`` restores
      from (default: the last ``save_checkpoint`` directory).
    """

    integrity: bool = True
    verify_on_load: bool = True
    fallback: bool = True
    retries: int = 3
    retry_backoff_secs: float = 0.2
    keep_last_n: int = 0
    rollback_dir: Optional[str] = None

    @model_validator(mode="after")
    def _check(self):
        if self.retries < 0 or self.retry_backoff_secs < 0:
            raise ValueError("resilience.checkpoint.retries and "
                             "retry_backoff_secs must be >= 0")
        if self.keep_last_n < 0:
            raise ValueError("resilience.checkpoint.keep_last_n must be "
                             ">= 0 (0 keeps everything)")
        return self


class ResilienceSentinelConfig(DeepSpeedConfigModel):
    """``resilience.sentinel``: NaN/Inf + loss-spike detection at every
    optimizer boundary (``runtime/resilience/sentinel.py``).

    - ``policy``: ``warn`` (log + fault event) | ``skip`` (run the
      fp16-style grads NaN/Inf check in the step: a bad step is skipped
      exactly like an fp16 overflow) | ``abort`` (raise out of
      ``engine.step()``) | ``rollback`` (restore the last verified-good
      checkpoint in place).
    - ``loss_spike_factor``: trip when loss > factor x the trailing
      window's median (``0`` disables spike detection; nonfinite always
      trips).
    - ``loss_window`` / ``min_history``: trailing window size and the
      minimum samples before spike detection arms.
    - ``sync_lag``: boundaries to hold each loss before the host reads it
      (``0`` checks immediately at the cost of run-ahead).
    - ``max_rollbacks``: rollbacks tolerated before escalating to abort
      (``0`` = unlimited).
    """

    enabled: bool = True
    policy: str = "warn"
    loss_spike_factor: float = 0.0
    loss_window: int = 32
    min_history: int = 4
    sync_lag: int = 1
    max_rollbacks: int = 3

    @model_validator(mode="after")
    def _check(self):
        if self.policy not in ("warn", "skip", "abort", "rollback"):
            raise ValueError(
                "resilience.sentinel.policy must be one of warn/skip/"
                f"abort/rollback, got {self.policy!r}")
        if self.loss_window <= 0 or self.min_history < 1:
            raise ValueError("resilience.sentinel.loss_window must be > 0 "
                             "and min_history >= 1")
        if self.sync_lag < 0 or self.loss_spike_factor < 0 \
                or self.max_rollbacks < 0:
            raise ValueError("resilience.sentinel.sync_lag, "
                             "loss_spike_factor and max_rollbacks must be "
                             ">= 0")
        return self


class ResilienceWatchdogConfig(DeepSpeedConfigModel):
    """``resilience.watchdog``: background stall detector
    (``runtime/resilience/watchdog.py``). Arms at the first completed
    optimizer step; on ``timeout_secs`` without step progress it dumps
    every Python thread's stack + the telemetry event tail to
    ``dump_dir`` and (``abort``) SIGTERMs then hard-exits with
    ``exit_code`` so the supervisor restarts the job."""

    enabled: bool = True
    timeout_secs: float = 600.0
    poll_secs: float = 0.0  # 0 = auto (timeout/4, capped at 10s)
    dump_dir: str = "./resilience"
    abort: bool = True
    exit_code: int = 43

    @model_validator(mode="after")
    def _check(self):
        if self.timeout_secs <= 0 or self.poll_secs < 0:
            raise ValueError("resilience.watchdog.timeout_secs must be > 0 "
                             "and poll_secs >= 0")
        return self


class ResilienceConfig(DeepSpeedConfigModel):
    """``resilience`` section: the fault-tolerance layer
    (``deepspeed_tpu_torch/runtime/resilience/``). Off by default; with
    the block absent or disabled an engine dispatches the same ops as
    without it."""

    enabled: bool = False
    checkpoint: ResilienceCheckpointConfig = Field(
        default_factory=ResilienceCheckpointConfig)
    sentinel: ResilienceSentinelConfig = Field(
        default_factory=ResilienceSentinelConfig)
    watchdog: ResilienceWatchdogConfig = Field(
        default_factory=ResilienceWatchdogConfig)


class MeshConfig(DeepSpeedConfigModel):
    """Named mesh axis sizes (the JAX ``MeshConfig``): ``data`` may be -1
    (fill the world). ``model`` is the deprecated alias of ``tp``.
    Training runs ``data``, ``fsdp`` and ``tp``; ``pipe``, ``expert`` or
    ``seq`` above 1 raises naming its slice. ``dcn`` gives axes' factors
    across nodes; the mesh checks them (``MeshTopology``), as in JAX."""

    data: int = -1
    fsdp: int = 1
    tp: int = 1
    model: int = Field(1, json_schema_extra={"deprecated": "alias of tp"})
    pipe: int = 1
    expert: int = 1
    seq: int = 1
    axis_order: tuple = ("pipe", "data", "fsdp", "expert", "seq", "tp")
    dcn: dict = Field(default_factory=dict)

    @model_validator(mode="after")
    def _fold_model_alias(self):
        if self.model != 1:
            if self.tp not in (1, self.model):
                raise ValueError(
                    f"mesh names both tp={self.tp} and its deprecated "
                    f"alias model={self.model} with different sizes — "
                    "keep only tp")
            object.__setattr__(self, "tp", self.model)
        check_ported_axes(self.axis_sizes())
        return self

    def axis_sizes(self):
        return {"data": self.data, "fsdp": self.fsdp, "tp": self.tp,
                "pipe": self.pipe, "expert": self.expert, "seq": self.seq}


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


def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


class DeepSpeedConfig:
    """Parsed training config: a dict, a path to a JSON file, or None.
    ``world_size`` is the data-parallel world size of the batch
    arithmetic (default: the world over the non-data axes)."""

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
        self.zero_config = DeepSpeedZeroConfig(**d.get(C.ZERO_OPTIMIZATION,
                                                       {}))
        self.mesh = MeshConfig(**d.get(C.MESH, {}))
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
        # gradient reduction: the mean over the ZeRO group, pre- or
        # post-scaled as the reference does (runtime/zero/reduce.py)
        self.prescale_gradients = bool(d.get(C.PRESCALE_GRADIENTS, False))
        self.gradient_predivide_factor = float(
            d.get(C.GRADIENT_PREDIVIDE_FACTOR, 1.0))
        # recorded, as in the JAX engine: gradients reduce in fp32
        self.communication_data_type = d.get(C.COMMUNICATION_DATA_TYPE)
        self.disable_allgather = bool(d.get(C.DISABLE_ALLGATHER, False))
        self.sparse_gradients_enabled = bool(d.get(C.SPARSE_GRADIENTS,
                                                   False))
        self.zero_allow_untested_optimizer = bool(
            d.get(C.ZERO_ALLOW_UNTESTED_OPTIMIZER, False))
        # tp policy selection (the tp degree is mesh.tp), as in JAX
        self.tensor_parallel_config = d.get(C.TENSOR_PARALLEL, {})
        # the telemetry slice
        self.comms_config = CommsLoggerConfig(**d.get(C.COMMS_LOGGER, {}))
        self.monitor_config = MonitorConfig(
            tensorboard=d.get(C.TENSORBOARD, {}), wandb=d.get(C.WANDB, {}),
            csv_monitor=d.get(C.CSV_MONITOR, {}))
        self.telemetry_config = TelemetryConfig(**d.get(C.TELEMETRY, {}))
        self.wall_clock_breakdown = d.get(C.WALL_CLOCK_BREAKDOWN,
                                          C.WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.memory_breakdown = d.get(C.MEMORY_BREAKDOWN,
                                      C.MEMORY_BREAKDOWN_DEFAULT)
        # the checkpoint and resilience slice
        self.checkpoint_config = CheckpointConfig(**d.get(C.CHECKPOINT, {}))
        self.nebula_config = NebulaConfig(**d.get(C.NEBULA, {}))
        self.resilience_config = ResilienceConfig(**d.get(C.RESILIENCE,
                                                          {}))
        self.dump_state = d.get(C.DUMP_STATE, C.DUMP_STATE_DEFAULT)
        self.dataloader_drop_last = d.get(C.DATALOADER_DROP_LAST,
                                          C.DATALOADER_DROP_LAST_DEFAULT)
        self.elasticity_config = d.get(C.ELASTICITY, {})
        self.checkpoint_tag_validation_enabled = \
            self.checkpoint_config.tag_validation != "Ignore"
        self.checkpoint_tag_validation_fail = \
            self.checkpoint_config.tag_validation == "Fail"
        self.load_universal_checkpoint = self.checkpoint_config.load_universal
        self.use_node_local_storage = \
            self.checkpoint_config.use_node_local_storage

        if world_size is None:
            non_data = (self.mesh.tp * self.mesh.pipe * self.mesh.seq
                        * self.mesh.fsdp)
            world_size = max(1, _world_size() // max(1, non_data))
        self.world_size = world_size

        def given(key):
            v = d.get(key)
            return None if v == "auto" else v

        (self.train_batch_size, self.train_micro_batch_size_per_gpu,
         self.gradient_accumulation_steps) = _resolve_batch_triangle(
            given(C.TRAIN_BATCH_SIZE),
            given(C.TRAIN_MICRO_BATCH_SIZE_PER_GPU),
            given(C.GRADIENT_ACCUMULATION_STEPS), self.world_size)

    @property
    def zero_enabled(self) -> bool:
        return self.zero_config.stage > 0

    @property
    def zero_optimization_stage(self) -> int:
        return self.zero_config.stage
