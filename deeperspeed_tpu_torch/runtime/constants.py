"""Config key names and defaults.

Counterpart of deeperspeed_tpu/runtime/constants.py, kept as this
package's own copy (the port imports nothing of the JAX package). Key
names match the reference JSON schema so the same config files parse;
runtime/config.py reads them and raises on the blocks the port does not
run yet.
"""

#############################################
# Batch size triple
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None

TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None

GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

#############################################
# Optimizer / scheduler
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_PARAMS = "params"
TYPE = "type"
LEGACY_FUSION = "legacy_fusion"
LEGACY_FUSION_DEFAULT = False

SCHEDULER = "scheduler"
SCHEDULER_PARAMS = "params"

ZERO_ALLOW_UNTESTED_OPTIMIZER = "zero_allow_untested_optimizer"
ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT = False

#############################################
# Precision (fp16 / bf16 / fp32)
#############################################
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False
# The fork supports {"fp16": {"type": "bfloat16"}}; we honor both that and a
# first-class "bf16" block.
FP16_TYPE = "type"
FP16_TYPE_DEFAULT = "fp16"
BFLOAT16 = "bf16"
BFLOAT16_ENABLED = "enabled"
BFLOAT16_ENABLED_DEFAULT = False
# keep fp32 master weights + fp32 optimizer states (default). Setting
# master_weights false under bf16 runs the MEMORY-LEAN mode: the optimizer
# updates the bf16 params directly with bf16-stored (fp32-arithmetic)
# moments — 4 bytes/param of state instead of 16
BFLOAT16_MASTER_WEIGHTS = "master_weights"
BFLOAT16_MASTER_WEIGHTS_DEFAULT = True
# dtype of the gradient-accumulation carry across gradient_accumulation_
# steps microbatches. Default (None) follows the grad storage dtype — bf16
# in masterless mode, where at high gas small per-microbatch contributions
# can round away against the growing accumulator. "fp32" accumulates in
# fp32 (+2 bytes/param transient) and casts back to the grad dtype after
# the scan.
BFLOAT16_GRAD_ACCUM_DTYPE = "grad_accum_dtype"
BFLOAT16_GRAD_ACCUM_DTYPE_DEFAULT = None

FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0  # 0 => dynamic

FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 32

FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000

FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2

FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1

PRECISION_FP16 = "fp16"
PRECISION_BF16 = "bfloat16"
PRECISION_FP32 = "fp32"

#############################################
# Gradient handling
#############################################
GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0

PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False

GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0

SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False

FP32_ALLREDUCE = "fp32_allreduce"
FP32_ALLREDUCE_DEFAULT = False

#############################################
# Communication
#############################################

ALLGATHER_SIZE = "allgather_size"
ALLGATHER_SIZE_DEFAULT = 500000000

#############################################
# Logging / misc
#############################################
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False

DUMP_STATE = "dump_state"
DUMP_STATE_DEFAULT = False

MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False

TENSORBOARD = "tensorboard"
TENSORBOARD_ENABLED = "enabled"
TENSORBOARD_ENABLED_DEFAULT = False
TENSORBOARD_OUTPUT_PATH = "output_path"
TENSORBOARD_OUTPUT_PATH_DEFAULT = ""
TENSORBOARD_JOB_NAME = "job_name"
TENSORBOARD_JOB_NAME_DEFAULT = "DeepSpeedJobName"

#############################################
# Progressive layer drop
#############################################
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
PLD_ENABLED = "enabled"

#############################################
# Pipeline
#############################################
PIPELINE = "pipeline"

#############################################
# Checkpoint
#############################################
CHECKPOINT = "checkpoint"
CHECKPOINT_TAG_VALIDATION = "tag_validation"
CHECKPOINT_TAG_VALIDATION_DEFAULT = "Warn"
CHECKPOINT_TAG_VALIDATION_MODES = ("Warn", "Ignore", "Fail")
# orbax per-shard parallel IO in the reference; refused by the port until
# sharded checkpoints are ported
CHECKPOINT_SHARDED_IO = "sharded_io"
CHECKPOINT_SHARDED_IO_DEFAULT = False

LOAD_FROM_FP32_WEIGHTS = "zero_load_from_fp32_weights"

#############################################
# Batch-size scheduler (fork extra)
#############################################
BATCH_SCHEDULER = "batch_scheduler"
BATCH_SCHEDULER_ENABLED = "enabled"

#############################################
# Gradient noise scale (fork extra)
#############################################
GRADIENT_NOISE_SCALE = "gradient_noise_scale"

#############################################
# Sparse attention
#############################################
SPARSE_ATTENTION = "sparse_attention"

#############################################
# Blocks enabled by their presence unless {"enabled": false}. The
# reference runs each through its own subsystem; runtime/config.py
# raises on every one the port does not run yet.
#############################################
STREAMING = "streaming"

SERVING = "serving"

MONITOR = "monitor"

RESILIENCE = "resilience"

DATAPIPE = "datapipe"

COMM = "comm"

MESH = "mesh"

LIFECYCLE = "lifecycle"

DISTRIBUTED = "distributed"

AUTOTUNE = "autotune"

PROVENANCE = "provenance"

#############################################
# Fused kernel selection (ops/kernel_config.py): mode "off" (plain
# PyTorch, default) | "fused" | "auto", plus per-surface booleans.
#############################################
KERNELS = "kernels"
KERNELS_MODE = "mode"
KERNELS_MODE_DEFAULT = "off"

#############################################
# ZeRO (the reference's zero/constants.py keys the port reads)
#############################################
ZERO_OPTIMIZATION = "zero_optimization"
ZERO_STAGE = "stage"
ZERO_OFFLOAD_OPTIMIZER = "offload_optimizer"
ZERO_OFFLOAD_PARAM = "offload_param"
ZERO_CPU_OFFLOAD = "cpu_offload"
ZERO_OFFLOAD_DEVICE = "device"
ZERO_OFFLOAD_DEVICE_NONE = "none"
MAX_STAGE_ZERO_OPTIMIZATION = 3

#############################################
# Other subsystems' blocks (reference: activation_checkpointing, aio,
# flops_profiler, elasticity); the port runs none of them yet
#############################################
ACTIVATION_CHECKPOINTING = "activation_checkpointing"
AIO = "aio"
FLOPS_PROFILER = "flops_profiler"
ELASTICITY = "elasticity"
