"""Monitor-block configuration.

Counterpart of deeperspeed_tpu/monitor/config.py: the same keys,
defaults and validation.

The telemetry counterpart of the ``"serving"`` block: a ``"monitor"``
block in the master JSON config (or a plain dict) builds a
``MonitorConfig``. Everything is off by default — tracing, the recompile
watchdog, and the metrics endpoint only exist when the block asks for
them, so the hot path pays nothing otherwise.

::

    "monitor": {
        "trace_path": "/tmp/step.trace.json",  # null = keep in memory
        "ring_size": 65536,                    # bounded event memory
        "watchdog": "warn",                    # off | warn | strict
        "metrics_port": 9184,                  # null = no endpoint; 0 = ephemeral
        "metrics_host": "127.0.0.1",
        "tb_export_interval": 0,               # steps; 0 = no TB export
        "flight_path": "/tmp/flight.bin",      # null = no flight recorder
        "flight_records": 2048,                # flight ring capacity
        "flight_slot_bytes": 512,              # fixed record size
        "obs_dir": null                        # derive per-incarnation paths
    }

``obs_dir`` is the run-scoped form: when set, ``trace_path`` and
``flight_path`` default to ``<obs_dir>/<role>.i<incarnation>.trace.json``
/ ``...flight.bin`` (role/incarnation from the DS_TPU_* run context, the reference's names), so
one static config block works across supervisor restarts and replica
fleets without incarnations overwriting each other's files.
"""

import dataclasses
from typing import Optional

from .watchdog import MODES

_KNOWN_KEYS = frozenset({
    "enabled", "trace_enabled", "trace_path", "ring_size", "watchdog",
    "metrics_port", "metrics_host", "tb_export_interval",
    "flight_path", "flight_records", "flight_slot_bytes", "obs_dir",
    "perf", "memwatch", "near_oom_fraction",
})


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    # master switch; runtime/config.py treats block presence as enabled
    # unless {"enabled": false}
    enabled: bool = True
    # span/counter/instant tracing into the ring buffer
    trace_enabled: bool = True
    # where Monitor.save_trace()/shutdown() write the Chrome-trace JSON;
    # None keeps events in memory for the caller to export
    trace_path: Optional[str] = None
    # ring-buffer capacity (events); memory stays bounded at ~200B/event
    ring_size: int = 65536
    # recompile watchdog mode: "off", "warn" (rank-0 warning + trace
    # instant), "strict" (raise RecompileError)
    watchdog: str = "warn"
    # Prometheus endpoint port; None disables the server, 0 binds an
    # ephemeral port (exposed as Monitor.metrics_server.port)
    metrics_port: Optional[int] = None
    metrics_host: str = "127.0.0.1"
    # export the metrics registry through TensorBoardMonitor every N
    # steps; 0 disables
    tb_export_interval: int = 0
    # crash-proof flight recorder (monitor/flight.py): None disables
    flight_path: Optional[str] = None
    flight_records: int = 2048
    flight_slot_bytes: int = 512
    # run-scoped output directory: derives trace_path/flight_path from
    # the process's role + incarnation when they are not set explicitly
    obs_dir: Optional[str] = None
    # perf doctor (monitor/perf.py): compiled-cost captures + live MFU
    # span args. Opt-in: the MFU readout syncs the step result inside
    # the train-batch span, an observer effect the default must not pay
    perf: bool = False
    # device-memory watermark lane (monitor/memwatch.py): ~free (CPU
    # reads {}; CUDA reads torch.cuda.memory_stats), so on by default
    # wherever tracing is on
    memwatch: bool = True
    # bytes_in_use/bytes_limit fraction that trips the near-OOM
    # post-mortem (top-K live buffers through the flight recorder)
    near_oom_fraction: float = 0.92

    def __post_init__(self):
        if self.ring_size < 1:
            raise ValueError(f"ring_size must be >= 1, got {self.ring_size}")
        if self.flight_records < 1:
            raise ValueError(
                f"flight_records must be >= 1, got {self.flight_records}")
        if self.flight_slot_bytes < 48:
            raise ValueError(
                f"flight_slot_bytes must be >= 48, got "
                f"{self.flight_slot_bytes}")
        if self.watchdog not in MODES:
            raise ValueError(
                f"watchdog must be one of {MODES}, got {self.watchdog!r}")
        if self.metrics_port is not None and not (
                0 <= int(self.metrics_port) <= 65535):
            raise ValueError(
                f"metrics_port must be 0..65535 or null, got "
                f"{self.metrics_port}")
        if self.tb_export_interval < 0:
            raise ValueError(
                f"tb_export_interval must be >= 0, got "
                f"{self.tb_export_interval}")
        if not (0.0 < self.near_oom_fraction <= 1.0):
            raise ValueError(
                f"near_oom_fraction must be in (0, 1], got "
                f"{self.near_oom_fraction}")

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "MonitorConfig":
        """Build from a ``"monitor"`` config block; unknown keys raise
        (same typo discipline as ServingConfig.from_dict)."""
        if d is None:
            return cls()
        unknown = set(d) - _KNOWN_KEYS
        if unknown:
            raise ValueError(
                f"unknown monitor config keys {sorted(unknown)}; known "
                f"keys are {sorted(_KNOWN_KEYS)}")
        return cls(**d)
