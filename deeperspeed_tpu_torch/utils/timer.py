"""Wall-clock and throughput timers.

Counterpart of deeperspeed_tpu/utils/timer.py's
``SynchronizedWallClockTimer`` and ``ThroughputTimer``. "Synchronized"
means that ``stop`` waits
for the device: with ``sync=True``, or when ``sync_with`` is a CUDA tensor,
it calls ``torch.cuda.synchronize()`` on that tensor's device before it
reads the clock (CUDA launches return before the work is done).
"""

import time

import torch

from .logging import log_dist


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

    def log(self, names, normalizer=1.0, reset=True, ranks=None):
        if normalizer <= 0.0:
            raise ValueError(f"normalizer must be > 0, got {normalizer}")
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed_time = (self.timers[name].elapsed(reset=reset)
                                * 1000.0 / normalizer)
                string += f" | {name}: {elapsed_time:.2f}"
        log_dist(string, ranks=ranks or [0])


class ThroughputTimer:
    """Samples per second over optimizer steps, from ``start_step`` on;
    logs every ``steps_per_output`` steps. Synchronizes the device only on
    the steps that report."""

    def __init__(self, batch_size, num_workers=1, start_step=2,
                 steps_per_output=50, monitor_memory=False, logging_fn=None):
        self.start_time = 0
        self.end_time = 0
        self.started = False
        self.batch_size = max(1, batch_size)
        self.num_workers = num_workers
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0
        self.step_elapsed_time = 0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or (lambda msg: log_dist(msg, ranks=[0]))
        self.initialized = False

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def start(self):
        self.initialized = True
        self.started = True
        if self.global_step_count >= self.start_step:
            self.start_time = time.time()

    def stop(self, global_step=False, report_speed=True, sync_with=None):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
        if self.start_time > 0:
            will_report = global_step and report_speed and (
                self.global_step_count % self.steps_per_output == 0)
            if will_report:
                _device_sync(sync_with)
            self.end_time = time.time()
            duration = self.end_time - self.start_time
            self.total_elapsed_time += duration
            self.step_elapsed_time += duration
            if will_report:
                self.logging(
                    "epoch={}/micro_step={}/global_step={}, "
                    "RunningAvgSamplesPerSec={:.6g}, CurrSamplesPerSec={:.6g}"
                    .format(self.epoch_count, self.micro_step_count,
                            self.global_step_count,
                            self.avg_samples_per_sec(),
                            self.batch_size
                            / max(self.step_elapsed_time, 1e-12)))
                self.step_elapsed_time = 0

    def avg_samples_per_sec(self):
        if self.global_step_count > self.start_step:
            samples_per_step = self.batch_size * self.num_workers
            total_step_offset = self.global_step_count - self.start_step
            avg_time_per_step = (self.total_elapsed_time
                                 / max(total_step_offset, 1))
            return samples_per_step / max(avg_time_per_step, 1e-12)
        return float("-inf")
