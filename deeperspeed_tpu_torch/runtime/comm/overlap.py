"""Backward-overlap collective scheduling.

Counterpart of deeperspeed_tpu/runtime/comm/overlap.py. Enabled by
``"comm": {"overlap": "auto"|"on"}`` (:func:`resolve_overlap`):

* ``train_batch``: every bucket's reduction is launched as soon as all of
  its leaves' gradients are final. The engine registers a hook on each
  param leaf for the last micro-batch's backward; the hook adds that
  micro-batch's gradient to the accumulation carry, and when a bucket's
  last leaf lands the bucket goes to the scheduler's comm thread, so
  buckets whose leaves finish early are on the wire while the rest of the
  backward still runs.
* ``backward()``/``step()``: ``GradReducer.reduce_dispatch(overlap=True)``
  hands every bucket to the comm thread at once and returns; the
  optimizer setup runs while they progress.

Either way the :class:`OverlapScheduler` keeps the in-flight buckets and
*drains* them at the accumulation boundary under one
``comm/overlap_window`` span: the comm time the schedule left exposed.
Each bucket runs the same wire math on the same inputs as the serialized
schedule, and only its own error-feedback residuals, in a fixed order on
one thread, so the result is bit-identical to ``overlap: off``. The comm
thread is the port's form of the reference's async dispatch: a
quantized wire is several dependent collectives (int8: an all-to-all, a
row sum, an all-gather), which one ``async_op`` handle cannot chain.

``comm/reduce`` spans carry ``overlapped: true|false``; under overlap they
record the launch, as the reference's do. :func:`overlap_fraction` turns
a pair of (merged) traces into the share of the serialized comm time the
schedule hid.
"""

import threading
from concurrent.futures import Future
from queue import SimpleQueue
from typing import Callable, Dict, List

from ...monitor.tracer import trace_span

__all__ = ["resolve_overlap", "OverlapScheduler", "reduce_span_stats",
           "overlap_fraction"]


def resolve_overlap(cfg, *, world: int, canonical: int = 0) -> bool:
    """Effective on/off decision for the ``overlap`` knob. ``auto``
    declines where there is nothing to overlap: a world of one or the
    canonical-slot elastic mode (its reduction is a gather and a fixed
    pairwise tree, not per-bucket collectives). ``on`` forces the
    scheduler even then: a no-op drain per boundary."""
    if cfg.overlap == "off":
        return False
    if cfg.overlap == "on":
        return True
    return world > 1 and not canonical


class OverlapScheduler:
    """Runs bucket reductions on one comm thread, in submission order, and
    drains them at the accumulation boundary.

    ``submit(fn, *args)`` queues ``fn(*args)`` and returns its
    ``Future``; ``note(futures, buckets)`` registers what is in flight;
    ``drain()`` waits for all of it under a ``comm/overlap_window`` span
    and re-raises the first failure. Every collective of the reduction
    runs on the comm thread, so no other collective may be issued on the
    same process group until ``drain()`` returns."""

    def __init__(self):
        self._pending: List[Future] = []
        self._buckets = 0
        self._queue: SimpleQueue = SimpleQueue()
        self._thread = None

    @property
    def pending_buckets(self) -> int:
        return self._buckets

    def _run(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            fut, fn, args = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args))
            except BaseException as e:  # handed to drain()
                fut.set_exception(e)

    def submit(self, fn: Callable, *args) -> Future:
        if self._thread is None:
            self._thread = threading.Thread(target=self._run,
                                            name="comm-overlap", daemon=True)
            self._thread.start()
        fut: Future = Future()
        self._queue.put((fut, fn, args))
        return fut

    def note(self, futures, buckets: int) -> None:
        """Register in-flight reductions (a Future or a list of them)."""
        if isinstance(futures, Future):
            futures = [futures]
        self._pending.extend(futures)
        self._buckets += int(buckets)

    def drain(self) -> list:
        """Wait for everything in flight (the accumulation boundary);
        returns the results in the order they were noted."""
        if not self._pending:
            return []
        pending, buckets = self._pending, self._buckets
        self._pending, self._buckets = [], 0
        with trace_span("comm/overlap_window", lane="comm",
                        buckets=buckets):
            return [f.result() for f in pending]

    def close(self) -> None:
        """Stop the comm thread (after a drain)."""
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join()
            self._thread = None


# --------------------------------------------------------------------------
# trace analysis: prove the overlap from merged Chrome-trace events
# --------------------------------------------------------------------------


def _events(trace) -> List[dict]:
    if isinstance(trace, dict):
        trace = trace.get("traceEvents", [])
    return [e for e in trace if isinstance(e, dict)]


def reduce_span_stats(trace) -> Dict[str, float]:
    """Aggregate the comm spans of one trace (a list of events or a
    ``{"traceEvents": ...}`` document; merged multi-process traces work
    the same). Returns ``reduce_ms`` (total ``comm/reduce`` duration),
    ``overlapped_spans`` / ``serial_spans`` (reduce spans by their
    ``overlapped`` arg), ``window_ms`` (total ``comm/overlap_window``
    duration: the exposed comm time under overlap) and ``windows``."""
    reduce_us = window_us = 0.0
    overlapped = serial = windows = 0
    for ev in _events(trace):
        if ev.get("ph") != "X":
            continue
        name = ev.get("name")
        dur = float(ev.get("dur", 0.0))
        if name == "comm/reduce":
            reduce_us += dur
            if (ev.get("args") or {}).get("overlapped"):
                overlapped += 1
            else:
                serial += 1
        elif name == "comm/overlap_window":
            window_us += dur
            windows += 1
    return {
        "reduce_ms": reduce_us / 1000.0,
        "window_ms": window_us / 1000.0,
        "overlapped_spans": overlapped,
        "serial_spans": serial,
        "windows": windows,
    }


def overlap_fraction(serial_trace, overlap_trace) -> float:
    """Fraction of serialized comm time the overlap schedule hid:
    ``1 - exposed / serialized``, clamped to [0, 1], where serialized is
    the ``comm/reduce`` total of an ``overlap: off`` run and exposed the
    ``comm/overlap_window`` total of the same workload with overlap on;
    0.0 when the serial trace carries no comm spans."""
    serial = reduce_span_stats(serial_trace)["reduce_ms"]
    if serial <= 0:
        return 0.0
    exposed = reduce_span_stats(overlap_trace)["window_ms"]
    return max(0.0, min(1.0, 1.0 - exposed / serial))
