"""The public pipeline-parallelism namespace (the reference's
deeperspeed_tpu/pipe/__init__.py re-exports the runtime.pipe containers
the same way)."""

from ..runtime.pipe.module import LayerSpec, PipelineModule, TiedLayerSpec

__all__ = ["LayerSpec", "PipelineModule", "TiedLayerSpec"]
