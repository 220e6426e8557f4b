"""``runtime/pipe/``: the functional layer protocol (module.py) that the
tensor-parallel layers subclass. The pipeline engine, its schedule and
``PipelineModule`` are not ported yet (ROADMAP.md queue 1, item 11)."""

from .module import Embedding, FnLayer, Layer, Linear

__all__ = ["Embedding", "FnLayer", "Layer", "Linear"]
