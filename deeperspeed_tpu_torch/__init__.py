"""deeperspeed_tpu_torch: the PyTorch/CUDA port of deeperspeed_tpu.

The JAX package ``deeperspeed_tpu`` is the reference; this package is its
counterpart on PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(sm_90a) where the reference has Pallas kernels. It keeps the reference's
module layout and names, so every module here has a twin of the same
path under ``deeperspeed_tpu/``.

Ported so far: continuous-batching serving of the GPT family
(``serving.ServingEngine`` over a paged KV cache), the GPT forward and
its KV-cache generation, the ``"kernels"`` selection switch, and the fused
LayerNorm and bias+GeLU forward kernels (``ops/fused_blocks.py``,
``csrc/fused_blocks.cu``).

Entry points run on CUDA unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper takes its plain PyTorch version. This package
never imports ``jax`` or anything of ``deeperspeed_tpu``.
"""

__version__ = "0.1.0"

from .serving import ServingConfig, ServingEngine  # noqa: E402

__all__ = ["ServingConfig", "ServingEngine", "__version__"]
