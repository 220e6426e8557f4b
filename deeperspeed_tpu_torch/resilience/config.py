"""Resilience-block configuration.

Counterpart of deeperspeed_tpu/resilience/config.py, whole: the same keys,
defaults, eager checks and unknown-key error.

The fault-tolerance counterpart of the ``"serving"``/``"monitor"``
blocks: a ``"resilience"`` block in the master JSON config (or a plain
dict) builds a ``ResilienceConfig``. Block presence enables the
subsystem unless ``{"enabled": false}``; everything stays off (and the
step loop pays nothing) without it.

::

    "resilience": {
        "save_dir": "/ckpts/run7",     # urgent/interval saves target
        "async_save": true,            # background writer thread
        "max_pending_saves": 2,        # bounded queue (backpressure)
        "save_interval_steps": 500,    # 0 = manual saves only
        "keep_last": 3,                # prune older committed tags; 0 = keep all
        "verify_on_load": true,        # manifest checksums at load
        "preemption_guard": true,      # SIGTERM/SIGINT -> urgent ckpt + exit
        "preemption_signals": ["SIGTERM", "SIGINT"],
        "preemption_exit_code": 86,    # sentinel the supervisor keys on
        "faults": null                 # fault-injection plan (drills/tests)
    }
"""

import dataclasses
import signal
from typing import Optional, Tuple

_KNOWN_KEYS = frozenset({
    "enabled", "save_dir", "async_save", "max_pending_saves",
    "save_interval_steps", "keep_last", "verify_on_load",
    "preemption_guard", "preemption_signals", "preemption_exit_code",
    "faults",
})

# distinct sentinel so the supervisor can tell "preempted, restart now"
# from "crashed, back off": outside both the 0-127 plain-exit range a
# shell maps real signals into (128+N) and small user codes
PREEMPTION_EXIT_CODE_DEFAULT = 86


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    # master switch; runtime/config.py treats block presence as enabled
    # unless {"enabled": false}
    enabled: bool = True
    # where urgent (preemption) and interval saves land; also adopted
    # from the first explicit save_checkpoint(save_dir) call
    save_dir: Optional[str] = None
    # hand the serialize+write to the background writer thread; the step
    # loop only blocks for the device->host snapshot
    async_save: bool = True
    # bounded writer queue: a submit past this many unwritten snapshots
    # blocks (backpressure) instead of accumulating host copies
    max_pending_saves: int = 2
    # automatic save every N optimizer steps; 0 = manual saves only
    save_interval_steps: int = 0
    # retention: after each commit keep only the newest N committed
    # tags (legacy/unknown dirs are never pruned); 0 = keep everything
    keep_last: int = 0
    # verify manifest checksums before trusting a tag at load
    verify_on_load: bool = True
    # install the SIGTERM/SIGINT handler (urgent checkpoint at the next
    # step boundary, serving drain, sentinel exit)
    preemption_guard: bool = True
    preemption_signals: Tuple[str, ...] = ("SIGTERM", "SIGINT")
    preemption_exit_code: int = PREEMPTION_EXIT_CODE_DEFAULT
    # fault-injection plan (resilience/faults.py) — drills and tests
    # only; merged with the DS_TPU_FAULTS env var (env wins)
    faults: Optional[dict] = None

    def __post_init__(self):
        if self.max_pending_saves < 1:
            raise ValueError(
                f"max_pending_saves must be >= 1, got {self.max_pending_saves}")
        if self.save_interval_steps < 0:
            raise ValueError(
                f"save_interval_steps must be >= 0, got "
                f"{self.save_interval_steps}")
        if self.keep_last < 0:
            raise ValueError(f"keep_last must be >= 0, got {self.keep_last}")
        if not (0 < int(self.preemption_exit_code) < 256):
            raise ValueError(
                f"preemption_exit_code must be in 1..255, got "
                f"{self.preemption_exit_code}")
        for name in self.preemption_signals:
            if not hasattr(signal, str(name)):
                raise ValueError(f"unknown signal name {name!r} in "
                                 f"preemption_signals")
        if self.faults is not None and not isinstance(self.faults, dict):
            raise ValueError('"faults" must be a dict (see resilience/'
                             'faults.py) or null')
        if self.faults is not None:
            from .faults import FaultPlan

            FaultPlan.from_dict(self.faults)  # validate eagerly

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ResilienceConfig":
        d = dict(d or {})
        unknown = set(d) - _KNOWN_KEYS
        if unknown:
            raise ValueError(
                f"unknown resilience config keys {sorted(unknown)}; "
                f"valid keys: {sorted(_KNOWN_KEYS)}")
        if "preemption_signals" in d:
            d["preemption_signals"] = tuple(d["preemption_signals"])
        return cls(**d)
