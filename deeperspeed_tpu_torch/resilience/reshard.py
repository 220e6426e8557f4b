"""Checkpoint remapping across layouts.

Counterpart of deeperspeed_tpu/resilience/reshard.py; ported so far:
``remap_data_state``, which ``Engine.load_checkpoint`` runs on a restored
datapipe ``DataState``. The rest of the module (the elastic reshard of
ZeRO shards and comm residuals) waits for the resilience runtime
(ROADMAP.md queue 1, item 'Resilience and multi-process runtime').
"""

from typing import Optional

from ..utils.logging import logger


def remap_data_state(state_dict: Optional[dict], saved_rows: Optional[int],
                     target_rows: int) -> Optional[dict]:
    """Remap a checkpointed ``DataState`` dict to the running global batch
    layout. Its counters are global (cursor and samples index the sample
    stream itself), so a resume under the same global batch is the
    identity. A changed row count still resumes the exact sample stream
    but re-bases the step-keyed schedules, which is worth a warning."""
    if state_dict is None:
        return None
    if saved_rows is not None and int(saved_rows) != int(target_rows):
        logger.warning(
            "datapipe: global batch rows changed %s -> %s across resume; "
            "the sample cursor resumes the exact stream, but step-keyed "
            "schedules (curriculum, batch-size ramps) now advance at the "
            "new per-step granularity", saved_rows, target_rows)
    return state_dict
