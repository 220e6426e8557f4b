"""Named wall-clock timers.

Counterpart of deeperspeed_tpu/utils/timer.py's
``SynchronizedWallClockTimer``. "Synchronized" means that ``stop`` waits
for the device: with ``sync=True``, or when ``sync_with`` is a CUDA tensor,
it calls ``torch.cuda.synchronize()`` on that tensor's device before it
reads the clock (CUDA launches return before the work is done).
"""

import time

import torch


def _device_sync(x=None):
    if x is not None:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class SynchronizedWallClockTimer:
    """Named timers; elapsed() resets by default like the reference."""

    class Timer:
        def __init__(self, name):
            self.name_ = name
            self.elapsed_ = 0.0
            self.started_ = False
            self.start_time = time.time()

        def start(self, sync=False):
            if self.started_:
                raise RuntimeError(f"timer {self.name_} has already been started")
            if sync:
                _device_sync()
            self.start_time = time.time()
            self.started_ = True

        def safe_start(self, sync=False):
            """start() that recovers from a run which died between start and
            stop: the dangling interval is discarded, accumulated elapsed
            time from completed intervals is kept."""
            self.started_ = False
            self.start(sync=sync)

        def stop(self, sync=False, sync_with=None):
            if not self.started_:
                raise RuntimeError(f"timer {self.name_} is not started")
            if sync or sync_with is not None:
                _device_sync(sync_with)
            self.elapsed_ += time.time() - self.start_time
            self.started_ = False

        def reset(self):
            self.elapsed_ = 0.0
            self.started_ = False

        def elapsed(self, reset=True):
            started_ = self.started_
            if self.started_:
                self.stop()
            elapsed_ = self.elapsed_
            if reset:
                self.reset()
            if started_:
                self.start()
            return elapsed_

    def __init__(self):
        self.timers = {}

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = self.Timer(name)
        return self.timers[name]
