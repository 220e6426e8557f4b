"""Structured step tracing: a thread-safe Chrome-trace event recorder.

Counterpart of deeperspeed_tpu/monitor/tracer.py, in the standard library
only, so the port's engines emit the same span, instant and counter names
as the reference.

Spans, counters, and instant events land in a bounded ring buffer (a
``deque(maxlen=ring_size)`` — memory stays fixed no matter how long the
run) and serialize to the Chrome Trace Event JSON format, loadable in
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

Spans are emitted as ``"X"`` (complete) events rather than ``"B"``/``"E"``
pairs so ring-buffer eviction can never orphan half a pair; the schema
validator (``monitor/validate.py``) still checks B/E balance for traces
that carry them (e.g. hand-merged ones).

The hot-path contract: when no tracer is installed, ``trace_span`` returns
a shared no-op context manager and ``trace_instant``/``trace_counter``
return immediately — observability off means a dict lookup and a branch,
nothing else. Engines therefore call the module-level helpers
unconditionally.

Timestamps are ``time.perf_counter()`` microseconds (monotonic); ``pid``
is the OS pid, ``tid`` is either the real thread id or a named logical
lane (``lane="serving"``) so Perfetto renders one track per subsystem
(engine / pipeline stages / offload / serving) instead of interleaving
everything on the main thread's track.

Two run-scoped extras feed the cross-process story (monitor/aggregate):

  * every tracer snapshots a ``(wall, perf)`` clock anchor at
    construction and stamps it — with the run context (run_id / role /
    incarnation, see runctx.py) — into the saved trace's ``otherData``
    and process metadata, so per-process traces can be rebased onto one
    shared timeline and labeled per incarnation;
  * an optional ``flight`` sink (monitor/flight.py) receives every
    event inline as it is recorded, so a SIGKILLed process still
    leaves its last events on disk.

Ring eviction is no longer silent: the tracer counts drops, notifies an
``on_drop`` hook (the Monitor wires it to the ``monitor_dropped_events``
counter), and emits a rate-limited ``trace/dropped`` instant so the
timeline itself shows where history was lost; the total also rides in
the trace footer (``otherData.dropped_events``).
"""

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from .runctx import RunContext, clock_anchor, current as current_run

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
        """Attach args discovered mid-span (MFU, HBM watermarks — values
        that only exist once the work ran); merged into the "X" event at
        exit. Returns self so call sites can chain."""
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

    # at most one trace/dropped instant per this many seconds
    DROP_NOTE_INTERVAL_S = 1.0

    def __init__(self, ring_size: int = 65536, pid: Optional[int] = None,
                 flight=None, run_context: Optional[RunContext] = None,
                 on_drop: Optional[Callable[[int], None]] = None):
        if ring_size < 1:
            raise ValueError(f"ring_size must be >= 1, got {ring_size}")
        self.ring_size = ring_size
        self.pid = os.getpid() if pid is None else pid
        self._events: deque = deque(maxlen=ring_size)
        self._lock = threading.Lock()
        self._lanes: Dict[str, int] = {}
        self.dropped = 0  # events evicted by the ring
        self.flight = flight            # inline crash-proof sink
        self.run_context = (run_context if run_context is not None
                            else current_run())
        self.on_drop = on_drop
        self.clock = clock_anchor()     # (wall, perf) for trace merging
        self._last_drop_note = float("-inf")
        self._extra_meta: Dict[str, object] = {}

    # -------------------------------------------------------------- #
    # recording
    # -------------------------------------------------------------- #

    def _append(self, ev: dict) -> None:
        note = None
        with self._lock:
            if len(self._events) == self.ring_size:
                evicted = 1
                now = time.perf_counter()
                if now - self._last_drop_note >= self.DROP_NOTE_INTERVAL_S:
                    self._last_drop_note = now
                    evicted += 1  # the note itself evicts one more
                self.dropped += evicted
                if evicted == 2:
                    note = {
                        "name": "trace/dropped",
                        "ph": "i",
                        "s": "p",  # process-scoped: loss affects every lane
                        "ts": now * 1e6,
                        "pid": self.pid,
                        "tid": 0,
                        "args": {"dropped": self.dropped},
                    }
                    self._events.append(note)
                if self.on_drop is not None:
                    try:
                        self.on_drop(evicted)
                    except Exception:  # pragma: no cover - hook is advisory
                        pass
            self._events.append(ev)
        if note is not None and self.flight is not None:
            self.flight.append(note)
        if self.flight is not None:
            # inline, outside the ring lock: the flight ring has its
            # own; this is what makes the record survive a SIGKILL that
            # lands one instruction later
            self.flight.append(ev)

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

    # -------------------------------------------------------------- #
    # export
    # -------------------------------------------------------------- #

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def _metadata(self) -> List[dict]:
        """Perfetto display names for the logical lanes."""
        with self._lock:
            lanes = dict(self._lanes)
        rc = self.run_context
        proc = "deeperspeed_tpu_torch"
        if rc is not None and (rc.run_id or rc.role != "main"):
            proc = f"deeperspeed_tpu_torch:{rc.role}#{rc.incarnation}"
        meta = [{
            "name": "process_name",
            "ph": "M",
            "pid": self.pid,
            "tid": 0,
            "args": {"name": proc},
        }]
        for lane, tid in sorted(lanes.items(), key=lambda kv: kv[1]):
            meta.append({
                "name": "thread_name",
                "ph": "M",
                "pid": self.pid,
                "tid": tid,
                "args": {"name": lane},
            })
        return meta

    def set_metadata(self, key: str, value) -> None:
        """Stamp a JSON-ready blob into the saved trace's ``otherData``
        (e.g. the perf layer's compiled-cost table); last write wins."""
        with self._lock:
            self._extra_meta[key] = value

    def to_dict(self) -> dict:
        other = {"dropped_events": self.dropped, "clock": dict(self.clock)}
        with self._lock:
            other.update(self._extra_meta)
        if self.run_context is not None:
            other["run"] = self.run_context.as_args()
        return {
            "traceEvents": self._metadata() + self.events(),
            "displayTimeUnit": "ms",
            "otherData": other,
        }

    def save(self, path: str) -> str:
        """Write the Perfetto-loadable JSON; returns ``path``."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
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
