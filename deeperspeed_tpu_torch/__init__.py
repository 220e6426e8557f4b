"""deeperspeed_tpu_torch: the PyTorch/CUDA port of deeperspeed_tpu.

The JAX package ``deeperspeed_tpu`` is the reference; this package is its
counterpart on PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(sm_90a) where the reference has Pallas kernels. It keeps the reference's
module layout and names, so every module here has a twin of the same
path under ``deeperspeed_tpu/``.

Ported so far: continuous-batching serving of the GPT family
(``serving.ServingEngine`` over a paged KV cache), the GPT forward, loss
and KV-cache generation, training through ``initialize`` ->
``Engine.train_batch`` (``TrainingConfig``, Adam/AdamW, loss scaling,
clipping, LR schedules, gradient accumulation), the ``"kernels"``
selection switch, the CUDA kernels for LayerNorm, residual-add LayerNorm
and bias+GeLU forward and backward (``csrc/fused_blocks.cu``), flash and
short-sequence attention forward and backward (``csrc/flash_attention.cu``,
``csrc/supertile_attention.cu``) and the fused Adam update
(``csrc/fused_adam.cu``), BERT pretraining, checkpoints in the
reference's file format (``Engine.save_checkpoint``/``load_checkpoint``),
block-sparse attention (``csrc/sparse_attention.cu``), and data-parallel
training over ``torch.distributed`` ranks: the ``"mesh"`` block
(``sharding/``), ZeRO stages 1 and 2 (``runtime/zero/``) and the bucketed
gradient reducer with its int8 wire-format kernels (``runtime/comm/``,
``csrc/fused_quant.cu``), and ZeRO-Infinity: the streamed offload engine
(``runtime/offload/``; ``initialize`` builds it for a ``GPTConfig``) with
its host Adam and NVMe I/O in C++ (``csrc/host/``), and tensor and
sequence parallelism: Megatron's column/row splits over the mesh's
``model``/``tp`` axis (``parallel/tp.py``; ``models/gpt.py`` trains and
``ServingEngine`` serves on it) and ring and Ulysses attention over its
``seq``/``sp`` axis (``ops/ring_attention.py``), and pipeline
parallelism: ``PipelineModule`` and ``PipelineEngine`` over the mesh's
``pipe`` axis, one process a stage (``runtime/pipe/``, ``pipe/``;
``initialize`` builds the engine for a ``PipelineModule``), served
through ``serving.PipelineServingBridge``.

Entry points run on CUDA unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper takes its plain PyTorch version. This package
never imports ``jax`` or anything of ``deeperspeed_tpu``.
"""

__version__ = "0.1.0"

from .runtime import lr_schedules  # noqa: E402
from .runtime.config import (ConfigError, DeepSpeedConfig,  # noqa: E402
                             TrainingConfig)
from .ops.adam import DeepSpeedCPUAdam  # noqa: E402
from .runtime.engine import Engine, initialize  # noqa: E402
from .runtime.offload.streaming import (StreamConfig,  # noqa: E402
                                        StreamedOffloadEngine)
from .parallel.topology import (PipeDataParallelTopology,  # noqa: E402
                                PipeModelDataParallelTopology,
                                PipelineParallelGrid, ProcessTopology,
                                build_mesh)
from .runtime.pipe.engine import PipelineEngine  # noqa: E402
from .pipe import LayerSpec, PipelineModule, TiedLayerSpec  # noqa: E402
from .serving import (PipelineServingBridge, ServingConfig,  # noqa: E402
                      ServingEngine)


def add_config_arguments(parser):
    """Argparse flags of the reference's ``add_config_arguments``."""
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument(
        "--deepspeed", default=False, action="store_true",
        help="Enable DeepSpeed (helper flag for user code, no impact on "
             "library)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="DeepSpeed json config file.")
    group.add_argument(
        "--deepscale", default=False, action="store_true",
        help="Deprecated enable DeepSpeed (helper flag for user code)")
    group.add_argument("--deepscale_config", default=None, type=str,
                       help="Deprecated json config file.")
    group.add_argument(
        "--deepspeed_mpi", default=False, action="store_true",
        help="Run via MPI; discover ranks from the MPI environment.")
    return parser


__all__ = ["ConfigError", "DeepSpeedCPUAdam", "DeepSpeedConfig", "Engine",
           "LayerSpec", "PipeDataParallelTopology",
           "PipeModelDataParallelTopology", "PipelineEngine",
           "PipelineModule", "PipelineParallelGrid",
           "PipelineServingBridge", "ProcessTopology", "ServingConfig",
           "ServingEngine", "TiedLayerSpec", "StreamConfig", "StreamedOffloadEngine",
           "TrainingConfig", "__version__", "add_config_arguments",
           "build_mesh", "initialize", "lr_schedules"]
