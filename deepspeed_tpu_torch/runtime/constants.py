"""Config keys and defaults the training engine reads (the subset of
``deepspeed_tpu/runtime/constants.py`` this slice implements)."""

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

OPTIMIZER = "optimizer"
OPTIMIZER_PARAMS = "params"
TYPE = "type"

SCHEDULER = "scheduler"
SCHEDULER_PARAMS = "params"

STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

FP16 = "fp16"
BF16 = "bf16"
BFLOAT16 = "bfloat16"  # accepted alias of "bf16"

ZERO_OPTIMIZATION = "zero_optimization"
FUSED_STEP = "fused_step"
SPARSE_ATTENTION = "sparse_attention"
MESH = "mesh"
TENSOR_PARALLEL = "tensor_parallel"
PRESCALE_GRADIENTS = "prescale_gradients"
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
COMMUNICATION_DATA_TYPE = "communication_data_type"
DISABLE_ALLGATHER = "disable_allgather"
SPARSE_GRADIENTS = "sparse_gradients"
ZERO_ALLOW_UNTESTED_OPTIMIZER = "zero_allow_untested_optimizer"

WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False
MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False
TELEMETRY = "telemetry"
COMMS_LOGGER = "comms_logger"
TENSORBOARD = "tensorboard"
WANDB = "wandb"
CSV_MONITOR = "csv_monitor"

# the checkpoint and resilience slice
CHECKPOINT = "checkpoint"
LOAD_UNIVERSAL_CHECKPOINT = "load_universal"
LOAD_UNIVERSAL_CHECKPOINT_DEFAULT = False
USE_NODE_LOCAL_STORAGE_CHECKPOINT = "use_node_local_storage"
USE_NODE_LOCAL_STORAGE_CHECKPOINT_DEFAULT = False
CHECKPOINT_TAG_VALIDATION = "tag_validation"
CHECKPOINT_TAG_VALIDATION_DEFAULT = "Warn"
CHECKPOINT_TAG_VALIDATION_MODES = ["Warn", "Ignore", "Fail"]
NEBULA = "nebula"
RESILIENCE = "resilience"
DUMP_STATE = "dump_state"
DUMP_STATE_DEFAULT = False
DATALOADER_DROP_LAST = "dataloader_drop_last"
DATALOADER_DROP_LAST_DEFAULT = False
ELASTICITY = "elasticity"
