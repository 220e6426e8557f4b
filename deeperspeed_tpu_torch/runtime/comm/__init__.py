"""``runtime/comm/``: bucketed, quantized gradient collectives.

Counterpart of deeperspeed_tpu/runtime/comm/, with its exports: the
``"comm"`` block (config.py), the bucket plan (bucketing.py), the
compressed wire formats, 24-bit and 1-bit (compressed.py), the
collectives over a process group (collectives.py), the ``GradReducer``
(reducer.py), the 1-bit optimizers (onebit.py) and their two-phase wire
path over a group (onebit_spmd.py), the backward-overlap schedule
(overlap.py) and the wire model (wiremodel.py)."""

from .bucketing import Bucket, BucketPlan, build_plan
from .compressed import (
    compress,
    compressed_all_reduce,
    compressed_all_reduce_tree,
    decompose,
    decompress,
    onebit_all_reduce,
    onebit_compress,
    reconstruct,
)
from .config import CommConfig
from .onebit import OnebitAdam, OnebitLamb
from .overlap import OverlapScheduler, overlap_fraction, resolve_overlap
from .reducer import GradReducer

__all__ = ["Bucket", "BucketPlan", "CommConfig", "GradReducer",
           "OnebitAdam", "OnebitLamb", "OverlapScheduler", "build_plan",
           "compress",
           "compressed_all_reduce", "compressed_all_reduce_tree",
           "decompose", "decompress", "onebit_all_reduce",
           "onebit_compress", "overlap_fraction", "reconstruct",
           "resolve_overlap"]
