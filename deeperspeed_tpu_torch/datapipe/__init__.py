"""datapipe: the streaming, prefetching, checkpointable input pipeline.

Counterpart of deeperspeed_tpu/datapipe/. Enabled by a ``"datapipe"``
config block (presence enables unless ``"enabled": false``). The engine
builds one :class:`DataPipe` at ``initialize``, pulls global batches from
it in ``train_batch``, carries its :class:`DataState` in every checkpoint
(the reference's keys, so each package resumes the other's), and restores
it on ``load_checkpoint``: the batch order is the same across a resume,
including one taken with batches staged in the prefetch queue.
"""

from .collator import SequencePacker, stack_collate
from .config import DataPipeConfig
from .curriculum import CurriculumStage, SeqLenCurriculum, batch_size_at
from .dataset import TokenShardDataset, epoch_order, order_fingerprint
from .pipeline import DataPipe, build_datapipe
from .prefetcher import AsyncPrefetcher
from .state import DataState

__all__ = [
    "AsyncPrefetcher",
    "CurriculumStage",
    "DataPipe",
    "DataPipeConfig",
    "DataState",
    "SeqLenCurriculum",
    "SequencePacker",
    "TokenShardDataset",
    "batch_size_at",
    "build_datapipe",
    "epoch_order",
    "order_fingerprint",
    "stack_collate",
]
