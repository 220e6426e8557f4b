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
selection switch, and the CUDA kernels for LayerNorm and bias+GeLU
forward and backward (``csrc/fused_blocks.cu``) and flash attention
forward and backward (``csrc/flash_attention.cu``).

Entry points run on CUDA unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper takes its plain PyTorch version. This package
never imports ``jax`` or anything of ``deeperspeed_tpu``.
"""

__version__ = "0.1.0"

from .runtime import lr_schedules  # noqa: E402
from .runtime.config import (ConfigError, DeepSpeedConfig,  # noqa: E402
                             TrainingConfig)
from .runtime.engine import Engine, initialize  # noqa: E402
from .serving import ServingConfig, ServingEngine  # noqa: E402


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


__all__ = ["ConfigError", "DeepSpeedConfig", "Engine", "ServingConfig",
           "ServingEngine", "TrainingConfig", "__version__",
           "add_config_arguments", "initialize", "lr_schedules"]
