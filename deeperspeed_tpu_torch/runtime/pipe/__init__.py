"""Pipeline parallelism: the layer protocol and ``PipelineModule``
(module.py), the instruction schedules (schedule.py), the messages
between stages (p2p.py), ``PipelineEngine`` (engine.py) and the
single-program SPMD pipeline (spmd.py: ``make_spmd_pipeline``,
``make_spmd_pipeline_train_step``), the last two imported lazily, as the
reference's."""

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
    "make_spmd_pipeline",
    "make_spmd_pipeline_train_step",
]


def __getattr__(name):
    # the engine imports runtime.engine, which imports this package's
    # siblings: a lazy import avoids the cycle
    if name == "PipelineEngine":
        from .engine import PipelineEngine

        return PipelineEngine
    if name in ("make_spmd_pipeline", "make_spmd_pipeline_train_step"):
        from . import spmd

        return getattr(spmd, name)
    raise AttributeError(name)
