"""``parallel/``: mesh axes over ``torch.distributed`` ranks.

Counterpart of the part of deeperspeed_tpu/parallel/ that expert
parallelism uses (topology.py: the axis names, ``build_mesh``,
``filter_spec``). Tensor parallelism (the reference's tp.py) and the
pipeline topology are not ported yet (ROADMAP.md queue 1)."""

from .topology import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
    PipeDataParallelTopology,
    PipeModelDataParallelTopology,
    PipelineParallelGrid,
    ProcessTopology,
    build_mesh,
    filter_spec,
    single_device_mesh,
)

__all__ = ["DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "PIPE_AXIS",
           "SEQ_AXIS", "PipeDataParallelTopology",
           "PipeModelDataParallelTopology", "PipelineParallelGrid",
           "ProcessTopology", "build_mesh", "filter_spec",
           "single_device_mesh"]
