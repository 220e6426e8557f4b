"""``runtime/comm/``: bucketed, quantized gradient collectives.

Counterpart of deeperspeed_tpu/runtime/comm/ for the data-parallel
reducer: the ``"comm"`` block (config.py), the bucket plan
(bucketing.py), the 24-bit compressed format (compressed.py), the
collectives over a process group (collectives.py) and the ``GradReducer``
(reducer.py). Not ported: overlap.py, wiremodel.py and the 1-bit
optimizers (ROADMAP.md queue 1, item 'runtime/comm/')."""

from .bucketing import Bucket, BucketPlan, build_plan
from .config import CommConfig
from .reducer import GradReducer

__all__ = ["Bucket", "BucketPlan", "CommConfig", "GradReducer",
           "build_plan"]
