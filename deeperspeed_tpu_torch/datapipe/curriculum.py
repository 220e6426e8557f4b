"""Curriculum: the seq-len warmup composed with the batch-size warmup.

Counterpart of deeperspeed_tpu/datapipe/curriculum.py.
``SeqLenCurriculum`` has the shape of runtime/bs_schedules.py's
``BatchSizeScheduler``: piecewise-constant stages spread linearly over
``warmup_steps``, from ``start_seq_len`` to the full ``seq_len``.
``CurriculumStage`` applies both warmups to a produced batch without
changing its shape:

  * columns past the scheduled seq-len are overwritten with ``pad_id``;
  * rows past the scheduled batch size (from an attached
    ``BatchSizeScheduler``'s static schedule) are overwritten with
    ``pad_id``.

The model then sees the same array shape at every stage, and the loss
the same positions, as in the reference. Both reads are pure functions of
the DataState step, so a prefetched batch is shaped for the step that
consumes it and a resumed run masks the same way.
"""

from typing import List, Optional, Tuple

import numpy as np

__all__ = ["SeqLenCurriculum", "CurriculumStage", "batch_size_at"]


def batch_size_at(schedule: List[Tuple[int, int]], step: int) -> int:
    """Scheduled batch size at ``step`` from a BatchSizeScheduler's
    static ``schedule`` (the pure counterpart of its stateful
    ``get_current_batch_size``)."""
    bs = schedule[0][1]
    for start, stage_bs in schedule:
        if step >= start:
            bs = stage_bs
    return bs


class SeqLenCurriculum:
    def __init__(self, final_seq_len: int, start_seq_len: int,
                 warmup_steps: int = 1000, num_intervals: int = 4):
        self.final_seq_len = int(final_seq_len)
        self.start_seq_len = int(start_seq_len)
        self.warmup_steps = int(warmup_steps)
        self.schedule = self._build(max(int(num_intervals), 1))

    def _build(self, n: int) -> List[Tuple[int, int]]:
        stages: List[Tuple[int, int]] = []
        for i in range(n):
            frac = i / (n - 1) if n > 1 else 1.0
            step = round(frac * self.warmup_steps)
            sl = round(self.start_seq_len
                       + frac * (self.final_seq_len - self.start_seq_len))
            if not stages or stages[-1][1] != sl:
                stages.append((step, sl))
        return stages

    def seq_len_at(self, step: int) -> int:
        return batch_size_at(self.schedule, step)


class CurriculumStage:
    """Applies the seq-len and batch-size warmups to one token batch."""

    def __init__(self, curriculum: Optional[SeqLenCurriculum],
                 bs_schedule: Optional[List[Tuple[int, int]]] = None,
                 pad_id: int = 0):
        self.curriculum = curriculum
        self.bs_schedule = bs_schedule
        self.pad_id = int(pad_id)

    @property
    def active(self) -> bool:
        return self.curriculum is not None or self.bs_schedule is not None

    def plan(self, step: int, rows: int, seq_len: int) -> Tuple[int, int]:
        """(active_rows, active_seq_len) scheduled for ``step``."""
        active_rows = rows
        if self.bs_schedule:
            active_rows = min(rows, batch_size_at(self.bs_schedule, step))
        active_seq = seq_len
        if self.curriculum is not None:
            active_seq = min(seq_len, self.curriculum.seq_len_at(step))
        return active_rows, active_seq

    def apply(self, tokens: np.ndarray, step: int,
              segment_ids: Optional[np.ndarray] = None):
        """Mask inactive rows and columns to pad_id, shape unchanged. Only
        plain 2-D token batches are masked; anything else (tuples or
        dicts from a user collate_fn) passes through.

        For a packed batch pass its ``segment_ids`` too: every position
        masked to pad_id also gets segment id 0, and the return is the
        ``(tokens, segment_ids)`` pair."""
        maskable = (self.active and isinstance(tokens, np.ndarray)
                    and tokens.ndim == 2)
        if maskable:
            rows, width = tokens.shape
            active_rows, active_seq = self.plan(step, rows, width - 1)
            maskable = active_rows < rows or active_seq < width - 1
        if not maskable:
            return tokens if segment_ids is None else (tokens, segment_ids)
        out = np.array(tokens, copy=True)
        segs = (np.array(segment_ids, copy=True)
                if segment_ids is not None else None)
        if active_seq < width - 1:
            # width is seq_len + 1 (inputs and shifted targets): keep
            # active_seq + 1 tokens so the last target survives
            out[:, active_seq + 1:] = self.pad_id
            if segs is not None:
                segs[:, active_seq + 1:] = 0
        if active_rows < rows:
            out[active_rows:, :] = self.pad_id
            if segs is not None:
                segs[active_rows:, :] = 0
        return out if segs is None else (out, segs)
