"""TensorBoard scalar monitor.

Counterpart of deeperspeed_tpu/utils/tensorboard.py: the summary writer
the ``"tensorboard"`` config block builds (Train/Samples/train_loss, lr
and loss_scale per step, as upstream DeepSpeed's engine writes them) and
the monitor's registry export writes through. It uses
``torch.utils.tensorboard`` where the ``tensorboard`` package imports,
else appends the same tag/step/value records to ``events.jsonl`` in the
run directory (``runs/<job_name>`` by default).
"""

import atexit
import json
import os
import time
from typing import Optional

from .logging import logger


class TensorBoardMonitor:
    """Usable bare or as a context manager (``with TensorBoardMonitor(...)
    as mon:``). An atexit hook flushes buffered scalars if a run dies
    before reaching close()."""

    def __init__(self, output_path: str = "", job_name: str = "DeepSpeedJobName",
                 enabled: bool = True):
        self.enabled = enabled
        self._writer = None
        self._jsonl = None
        self._closed = False
        if not enabled:
            return
        base = os.path.join(output_path or "runs", job_name)
        os.makedirs(base, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=base)
        except Exception as e:  # pragma: no cover - env without tensorboard
            path = os.path.join(base, "events.jsonl")
            logger.warning(
                "tensorboard unavailable (%s); writing JSONL scalars to %s",
                e, path,
            )
            self._jsonl = open(path, "a")
        atexit.register(self.flush)

    def add_scalar(self, tag: str, value, global_step: int):
        if not self.enabled:
            return
        value = float(value)
        if self._writer is not None:
            self._writer.add_scalar(tag, value, global_step)
        elif self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": value, "step": int(global_step),
                 "ts": time.time()}) + "\n")

    def write_scalars(self, scalars: dict, global_step: int):
        for tag, value in scalars.items():
            self.add_scalar(tag, value, global_step)

    def flush(self):
        if self._closed:
            return
        if self._writer is not None:
            self._writer.flush()
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self):
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self.flush)
        if self._writer is not None:
            self._writer.close()
        if self._jsonl is not None:
            self._jsonl.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
