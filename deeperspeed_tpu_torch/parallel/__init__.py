"""``parallel/``: mesh axes over ``torch.distributed`` ranks and tensor
parallelism.

Counterpart of deeperspeed_tpu/parallel/: topology.py (the axis names,
the process-topology coordinate math, ``build_mesh``, ``filter_spec``)
and tp.py (Megatron's column/row layers and their f/g collectives over
the mesh's tensor-parallel group, the mpu facade). ``build_mesh``'s
``pipe`` axis is the pipeline engine's (runtime/pipe/engine.py)."""

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
from .tp import (
    ColumnParallelLinear,
    ModelParallelUnit,
    ParallelMLP,
    RowParallelLinear,
    VocabParallelEmbedding,
    column_parallel_spec,
    copy_to_model_parallel_region,
    gather_from_model_parallel_region,
    reduce_from_model_parallel_region,
    row_parallel_spec,
    scatter_to_model_parallel_region,
    vocab_parallel_spec,
)

__all__ = ["DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "PIPE_AXIS",
           "SEQ_AXIS", "PipeDataParallelTopology",
           "PipeModelDataParallelTopology", "PipelineParallelGrid",
           "ProcessTopology", "build_mesh", "filter_spec",
           "single_device_mesh", "ColumnParallelLinear",
           "ModelParallelUnit", "ParallelMLP", "RowParallelLinear",
           "VocabParallelEmbedding", "column_parallel_spec",
           "copy_to_model_parallel_region",
           "gather_from_model_parallel_region",
           "reduce_from_model_parallel_region", "row_parallel_spec",
           "scatter_to_model_parallel_region", "vocab_parallel_spec"]
