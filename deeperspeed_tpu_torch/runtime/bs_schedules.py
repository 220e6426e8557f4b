"""Batch-size warmup scheduler.

Counterpart of deeperspeed_tpu/runtime/bs_schedules.py (the fork's
``BatchSizeScheduler``). Grows the batch size from
``ceil(final * min_batch_size_multiplier)`` to ``final_batch_size`` in
``num_intervals`` piecewise-constant stages spread linearly over
``warmup_num_steps`` steps, then holds. The engine tracks it and exposes
``current_batch_size()``; the datapipe reads its static ``schedule`` and
masks the inactive rows of each global batch, so the step's shapes stay
fixed.
"""

import math
from typing import List, Optional, Tuple


class BatchSizeScheduler:
    def __init__(
        self,
        final_batch_size: int,
        min_batch_size_multiplier: float = 0.01,
        warmup_num_steps: int = 1000,
        num_intervals: int = 4,
        last_batch_iteration: int = -1,
        deepspeed=None,
    ):
        self.final_batch_size = final_batch_size
        self.min_batch_size_multiplier = min_batch_size_multiplier
        self.warmup_num_steps = warmup_num_steps
        self.num_intervals = num_intervals
        self.last_batch_iteration = last_batch_iteration
        self.deepspeed = deepspeed
        self.schedule = self._build_schedule()
        self.current_batch_size: Optional[int] = None

    def _build_schedule(self) -> List[Tuple[int, int]]:
        """Sorted (start_step, batch_size) stages, deduped on batch size."""
        start = math.ceil(self.min_batch_size_multiplier
                          * self.final_batch_size)
        n = max(self.num_intervals, 1)
        stages: List[Tuple[int, int]] = []
        for i in range(n):
            frac = i / (n - 1) if n > 1 else 1.0
            step = round(frac * self.warmup_num_steps)
            bs = round(start + frac * (self.final_batch_size - start))
            if not stages or stages[-1][1] != bs:
                stages.append((step, bs))
        return stages

    def get_current_batch_size(self) -> int:
        bs = self.schedule[0][1]
        for step, stage_bs in self.schedule:
            if self.last_batch_iteration >= step:
                bs = stage_bs
        return bs

    def step(self, last_batch_iteration: Optional[int] = None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self.current_batch_size = self.get_current_batch_size()

    def state_dict(self) -> dict:
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd: dict):
        self.last_batch_iteration = sd["last_batch_iteration"]
        self.current_batch_size = self.get_current_batch_size()
