"""Unified telemetry: structured step tracing, a recompile watchdog, and
a Prometheus metrics endpoint.

Counterpart of deeperspeed_tpu/monitor/__init__.py: the same ``Monitor``,
config block, ``obs_dir`` layout, event, lane and metric names. One
``Monitor`` object owns the legs:

  * ``tracer``   — thread-safe Chrome-trace recorder (bounded ring);
    installed as the process-global tracer so ``trace_span("fwd")``
    works from every subsystem (engine, comm, serving); with a flight
    recorder (``obs_dir`` or ``flight_path``) every event also lands in
    a SIGKILL-proof mmap ring (flight.py);
  * ``watchdog`` — counts the distinct argument signatures of each
    watched entry point and fires (warn or raise) when one meets a new
    signature after warmup (watchdog.py);
  * ``registry`` — counters/gauges/histograms, served at ``/metrics``
    in Prometheus exposition format and exportable through
    ``TensorBoardMonitor``;
  * ``cost_index`` (``perf``, opt-in) — flops, bytes and peak memory of
    each entry point at each new signature, and the per-step MFU
    (perf.py); ``memwatch`` (on with tracing) — the CUDA allocator's
    watermarks and the near-OOM post-mortem (memwatch.py).

Lifecycle: ``init_monitor(config)`` builds + installs the process-global
monitor (engines pick it up automatically); ``shutdown_monitor()`` saves
the trace (if ``trace_path`` is set), stops the endpoint's thread,
closes the flight file and uninstalls. An ``atexit`` hook guarantees the
trace file exists even when a run crashes. Everything is off by default:
with no monitor installed, ``trace_span`` is a shared no-op and the
engines' telemetry branches cost one ``is None`` check.
"""

import atexit
import os
from contextlib import nullcontext
from typing import Optional, Union

from ..utils.logging import logger
from .config import MonitorConfig
from .flight import FlightRecorder
from .metrics import (
    MetricsRegistry,
    MetricsServer,
    export_to_tensorboard,
)
from .memwatch import MemWatch, aggregate_memory_stats, device_memory_stats
from .perf import CompiledCostIndex, platform_peaks
from .runctx import RunContext, current as current_run_context, ensure_run_id
from .tracer import (
    Tracer,
    get_tracer,
    set_tracer,
    trace_counter,
    trace_instant,
    trace_span,
)
from .validate import validate_events, validate_file
from .watchdog import RecompileError, RecompileWatchdog, SignatureCache

__all__ = [
    "Monitor",
    "MonitorConfig",
    "MetricsRegistry",
    "MetricsServer",
    "Tracer",
    "FlightRecorder",
    "RunContext",
    "RecompileError",
    "RecompileWatchdog",
    "SignatureCache",
    "CompiledCostIndex",
    "MemWatch",
    "aggregate_memory_stats",
    "device_memory_stats",
    "platform_peaks",
    "current_run_context",
    "ensure_run_id",
    "export_to_tensorboard",
    "get_monitor",
    "init_monitor",
    "shutdown_monitor",
    "get_tracer",
    "set_tracer",
    "trace_span",
    "trace_instant",
    "trace_counter",
    "validate_events",
    "validate_file",
]


class Monitor:
    """Tracer + watchdog + metrics registry/endpoint under one config."""

    def __init__(self, config: Union[MonitorConfig, dict, None] = None):
        cfg = (config if isinstance(config, MonitorConfig)
               else MonitorConfig.from_dict(config))
        self.config = cfg
        self.run_context = current_run_context()
        trace_path, flight_path = cfg.trace_path, cfg.flight_path
        if cfg.obs_dir:
            # run-scoped layout: one static config serves every
            # incarnation of every role without files clobbering
            stem = (f"{self.run_context.role}"
                    f".i{self.run_context.incarnation}")
            if trace_path is None:
                trace_path = os.path.join(cfg.obs_dir,
                                          f"{stem}.trace.json")
            if flight_path is None:
                flight_path = os.path.join(cfg.obs_dir,
                                           f"{stem}.flight.bin")
        self.trace_path = trace_path
        self.registry = MetricsRegistry()
        self.flight: Optional[FlightRecorder] = None
        if cfg.trace_enabled and flight_path is not None:
            self.flight = FlightRecorder(
                flight_path, capacity=cfg.flight_records,
                slot_bytes=cfg.flight_slot_bytes)
        if cfg.trace_enabled:
            dropped = self.registry.counter(
                "monitor_dropped_events",
                "Trace events evicted unread by the bounded ring.")
            self.tracer: Optional[Tracer] = Tracer(
                ring_size=cfg.ring_size, flight=self.flight,
                run_context=self.run_context,
                on_drop=lambda n: dropped.inc(n))
        else:
            self.tracer = None
        self.watchdog = RecompileWatchdog(mode=cfg.watchdog)
        # perf doctor legs: the cost index (opt-in — its live MFU readout
        # waits for the step's stop event inside the span, and a capture
        # runs its step under a dispatch mode) and the device-memory
        # watermark lane (near-free, defaults on with tracing)
        self.cost_index: Optional[CompiledCostIndex] = (
            CompiledCostIndex(registry=self.registry) if cfg.perf else None)
        self.memwatch: Optional[MemWatch] = (
            MemWatch(registry=self.registry,
                     near_oom_fraction=cfg.near_oom_fraction)
            if cfg.memwatch and cfg.trace_enabled else None)
        self.metrics_server: Optional[MetricsServer] = None
        if cfg.metrics_port is not None:
            self.metrics_server = MetricsServer(
                self.registry, port=cfg.metrics_port, host=cfg.metrics_host)
        self._prev_tracer = None
        self._started = False

    # -------------------------------------------------------------- #

    def start(self) -> "Monitor":
        if self._started:
            return self
        self._started = True
        if self.tracer is not None:
            self._prev_tracer = set_tracer(self.tracer)
        if self.metrics_server is not None:
            self.metrics_server.start()
            logger.info("monitor: metrics endpoint at %s",
                        self.metrics_server.url)
        atexit.register(self._atexit_save)
        return self

    def _atexit_save(self) -> None:
        # crash insurance: the trace survives a run that never reached
        # shutdown_monitor(); idempotent with an explicit save. (SIGKILL
        # skips this entirely — that is what the flight recorder is for.)
        try:
            if self.tracer is not None and self.trace_path:
                self.tracer.save(self.trace_path)
            if self.flight is not None:
                self.flight.flush()
        except Exception:  # pragma: no cover - interpreter teardown
            pass

    def save_trace(self, path: Optional[str] = None) -> Optional[str]:
        """Write the Chrome-trace JSON (to ``path`` or the configured
        ``trace_path``); returns the path written, or None."""
        if self.tracer is None:
            return None
        path = path or self.trace_path
        if not path:
            return None
        return self.tracer.save(path)

    def export_tensorboard(self, monitor, step: int) -> None:
        export_to_tensorboard(self.registry, monitor, step)

    def capture(self, name: str, signatures, device, *args):
        """An engine's hook around one call of entry ``name``: records the
        call's signature in ``signatures`` (the watchdog's and the cost
        index's count) and returns the cost index's capture of the call,
        a no-op context without ``perf``."""
        signatures.record(*args)
        if self.cost_index is None:
            return nullcontext()
        return self.cost_index.capture(name, signatures, device, args)

    def shutdown(self, save: bool = True) -> None:
        if not self._started:
            return
        self._started = False
        atexit.unregister(self._atexit_save)
        if save:
            self.save_trace()
        if self.metrics_server is not None:
            self.metrics_server.close()
        if self.flight is not None:
            self.flight.close()
        if self.tracer is not None and get_tracer() is self.tracer:
            set_tracer(self._prev_tracer)


# ------------------------------------------------------------------ #
# process-global monitor (what the engines pick up)
# ------------------------------------------------------------------ #

_MONITOR: Optional[Monitor] = None


def init_monitor(config: Union[MonitorConfig, dict, None]) -> Monitor:
    """Build + start + install the process-global Monitor. Re-initializing
    with a live monitor shuts the old one down first (its trace is
    saved)."""
    global _MONITOR
    if _MONITOR is not None:
        _MONITOR.shutdown()
    _MONITOR = Monitor(config).start()
    return _MONITOR


def get_monitor() -> Optional[Monitor]:
    return _MONITOR


def shutdown_monitor(save: bool = True) -> None:
    global _MONITOR
    if _MONITOR is not None:
        _MONITOR.shutdown(save=save)
        _MONITOR = None
