"""Pipeline parallelism: the layer protocol and ``PipelineModule``
(module.py), the instruction schedules (schedule.py), the messages
between stages (p2p.py) and ``PipelineEngine`` (engine.py, imported
lazily, as the reference's). The single-program SPMD pipeline
(``make_spmd_pipeline``) is not ported yet (ROADMAP.md queue 1)."""

from .module import (
    Embedding,
    FnLayer,
    Layer,
    LayerSpec,
    Linear,
    PipelineModule,
    TiedLayerSpec,
)
from .schedule import (
    BackwardPass,
    DataParallelSchedule,
    ForwardPass,
    InferenceSchedule,
    LoadMicroBatch,
    OptimizerStep,
    PipeInstruction,
    PipeSchedule,
    RecvActivation,
    RecvGrad,
    ReduceGrads,
    ReduceTiedGrads,
    SendActivation,
    SendGrad,
    TrainSchedule,
)

__all__ = [
    "Layer",
    "FnLayer",
    "Linear",
    "Embedding",
    "LayerSpec",
    "TiedLayerSpec",
    "PipelineModule",
    "PipeSchedule",
    "TrainSchedule",
    "InferenceSchedule",
    "DataParallelSchedule",
    "PipeInstruction",
    "OptimizerStep",
    "ReduceGrads",
    "ReduceTiedGrads",
    "LoadMicroBatch",
    "ForwardPass",
    "BackwardPass",
    "SendActivation",
    "RecvActivation",
    "SendGrad",
    "RecvGrad",
    "PipelineEngine",
]


def __getattr__(name):
    # the engine imports runtime.engine, which imports this package's
    # siblings: a lazy import avoids the cycle
    if name == "PipelineEngine":
        from .engine import PipelineEngine

        return PipelineEngine
    raise AttributeError(name)
