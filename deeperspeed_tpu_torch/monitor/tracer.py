"""Structured step tracing: a thread-safe Chrome-trace event recorder.

Counterpart of deeperspeed_tpu/monitor/tracer.py, in the standard library
only, so the port's engines emit the same span, instant and counter names
as the reference. Spans, counters and instant events land in a bounded
ring buffer and serialize to the Chrome Trace Event JSON format (loadable
in Perfetto or ``chrome://tracing``). Spans are ``"X"`` (complete) events,
so ring eviction never orphans half a pair.

The hot-path contract: when no tracer is installed, ``trace_span`` returns
a shared no-op context manager and ``trace_instant``/``trace_counter``
return at once, so engines call the module-level helpers
unconditionally.

Timestamps are ``time.perf_counter()`` microseconds; ``pid`` is the OS pid
and ``tid`` is the real thread id or a named logical lane
(``lane="serving"``), one Perfetto track per subsystem.

Not ported yet: the flight-recorder sink, run contexts and the dropped-
event hook of the reference (they belong to the monitor slice).
"""

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

__all__ = [
    "Tracer",
    "get_tracer",
    "set_tracer",
    "trace_span",
    "trace_instant",
    "trace_counter",
]


class _NullSpan:
    """Shared no-op context manager for the tracer-disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **args):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """Context manager emitting one "X" (complete) event on exit."""

    __slots__ = ("_tracer", "_name", "_tid", "_args", "_t0")

    def __init__(self, tracer, name, tid, args):
        self._tracer = tracer
        self._name = name
        self._tid = tid
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def note(self, **args):
        """Attach args discovered mid-span; merged into the event at exit."""
        if self._args:
            self._args.update(args)
        else:
            self._args = args
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer._append({
            "name": self._name,
            "ph": "X",
            "ts": self._t0 * 1e6,
            "dur": (t1 - self._t0) * 1e6,
            "pid": self._tracer.pid,
            "tid": self._tid,
            **({"args": self._args} if self._args else {}),
        })
        return False


class Tracer:
    """Thread-safe span/counter/instant recorder with bounded memory."""

    def __init__(self, ring_size: int = 65536):
        if ring_size < 1:
            raise ValueError(f"ring_size must be >= 1, got {ring_size}")
        self.ring_size = ring_size
        self.pid = os.getpid()
        self._events: deque = deque(maxlen=ring_size)
        self._lock = threading.Lock()
        self._lanes: Dict[str, int] = {}
        self.dropped = 0  # events evicted by the ring

    def _append(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) == self.ring_size:
                self.dropped += 1
            self._events.append(ev)

    def _tid(self, lane: Optional[str]) -> int:
        if lane is None:
            return threading.get_ident() & 0x7FFFFFFF
        with self._lock:
            tid = self._lanes.get(lane)
            if tid is None:
                # small stable ids, separate from real thread idents
                tid = len(self._lanes) + 1
                self._lanes[lane] = tid
        return tid

    def span(self, name: str, lane: Optional[str] = None, **args) -> _Span:
        """``with tracer.span("fwd"): ...`` — one "X" event per exit."""
        return _Span(self, name, self._tid(lane), args)

    def instant(self, name: str, lane: Optional[str] = None, **args) -> None:
        self._append({
            "name": name,
            "ph": "i",
            "s": "t",  # thread-scoped instant
            "ts": time.perf_counter() * 1e6,
            "pid": self.pid,
            "tid": self._tid(lane),
            **({"args": args} if args else {}),
        })

    def counter(self, name: str, values, lane: Optional[str] = None) -> None:
        """Counter sample; ``values`` is a number or a dict of series."""
        if not isinstance(values, dict):
            values = {"value": values}
        self._append({
            "name": name,
            "ph": "C",
            "ts": time.perf_counter() * 1e6,
            "pid": self.pid,
            "tid": self._tid(lane),
            "args": {k: float(v) for k, v in values.items()},
        })

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def _metadata(self) -> List[dict]:
        """Perfetto display names for the process and the logical lanes."""
        with self._lock:
            lanes = dict(self._lanes)
        meta = [{"name": "process_name", "ph": "M", "pid": self.pid,
                 "tid": 0, "args": {"name": "deeperspeed_tpu_torch"}}]
        for lane, tid in sorted(lanes.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "pid": self.pid,
                         "tid": tid, "args": {"name": lane}})
        return meta

    def to_dict(self) -> dict:
        return {
            "traceEvents": self._metadata() + self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }

    def save(self, path: str) -> str:
        """Write the Perfetto-loadable JSON; returns ``path``."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
            f.write("\n")
        return path


# ------------------------------------------------------------------ #
# module-level tracer (what the engines call)
# ------------------------------------------------------------------ #

_GLOBAL: Optional[Tracer] = None


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install (or remove, with None) the process-global tracer; returns
    the previous one so callers can restore it."""
    global _GLOBAL
    prev = _GLOBAL
    _GLOBAL = tracer
    return prev


def get_tracer() -> Optional[Tracer]:
    return _GLOBAL


def trace_span(name: str, lane: Optional[str] = None, **args):
    """Span against the global tracer; a shared no-op when tracing is off."""
    t = _GLOBAL
    if t is None:
        return _NULL_SPAN
    return t.span(name, lane, **args)


def trace_instant(name: str, lane: Optional[str] = None, **args) -> None:
    t = _GLOBAL
    if t is not None:
        t.instant(name, lane, **args)


def trace_counter(name: str, values, lane: Optional[str] = None) -> None:
    t = _GLOBAL
    if t is not None:
        t.counter(name, values, lane)
