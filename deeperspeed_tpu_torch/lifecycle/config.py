"""Lifecycle configuration.

Counterpart of deeperspeed_tpu/lifecycle/config.py, whole: a
``"lifecycle"`` block in the master JSON config (or a plain dict) builds a
:class:`LifecycleConfig`, the policy of the train->serve control plane:
live re-mesh on pool-change signals and weight-version publishing and
rollout. Validated eagerly (unknown keys are errors) like every other
subsystem block, so a typo fails at config load, not mid-rollout.
"""

import dataclasses
import signal
from typing import Optional

__all__ = ["LifecycleConfig"]

# config keys (declared so the analysis linter can enumerate them)
ENABLED = "enabled"
ENABLED_DEFAULT = True
POOL_FILE = "pool_file"
REMESH_ENABLED = "remesh_enabled"
REMESH_ENABLED_DEFAULT = True
REMESH_SIGNAL = "remesh_signal"
REMESH_SIGNAL_DEFAULT = "SIGUSR1"
REMESH_DEBOUNCE_S = "remesh_debounce_s"
REMESH_DEBOUNCE_S_DEFAULT = 0.25
PUBLISH = "publish"
PUBLISH_DEFAULT = True
PUBLISH_INTERVAL_STEPS = "publish_interval_steps"
PUBLISH_INTERVAL_STEPS_DEFAULT = 0
KEEP_LIVE_VERSIONS = "keep_live_versions"
KEEP_LIVE_VERSIONS_DEFAULT = 2
ROLLOUT_POLL_INTERVAL_S = "rollout_poll_interval_s"
ROLLOUT_POLL_INTERVAL_S_DEFAULT = 0.5
DRAIN_TIMEOUT_S = "drain_timeout_s"
DRAIN_TIMEOUT_S_DEFAULT = 30.0

_KNOWN_KEYS = frozenset({
    ENABLED, POOL_FILE, REMESH_ENABLED, REMESH_SIGNAL, REMESH_DEBOUNCE_S,
    PUBLISH, PUBLISH_INTERVAL_STEPS, KEEP_LIVE_VERSIONS,
    ROLLOUT_POLL_INTERVAL_S, DRAIN_TIMEOUT_S,
})


@dataclasses.dataclass(frozen=True)
class LifecycleConfig:
    """The ``"lifecycle"`` block: re-mesh + weight-version policy."""

    enabled: bool = ENABLED_DEFAULT
    # surviving-pool device count file (the supervisor's --pool-file);
    # re-read when the re-mesh signal arrives. None = signal-only mode:
    # the sender must deliver the target via DS_TPU_POOL_FILE instead.
    pool_file: Optional[str] = None
    # live re-mesh: respond to the pool-change signal at step boundaries
    remesh_enabled: bool = REMESH_ENABLED_DEFAULT
    # signal name the supervisor sends the RUNNING trainer (SIGUSR1 by
    # convention; configurable for embedders that already use it)
    remesh_signal: str = REMESH_SIGNAL_DEFAULT
    # coalesce signal bursts: pool-file writes arriving closer together
    # than this resolve to one re-mesh at the next step boundary
    remesh_debounce_s: float = REMESH_DEBOUNCE_S_DEFAULT
    # weight versions: publish COMMITTED checkpoint tags as WeightVersion
    # records in the checkpoint dir's VERSIONS.json
    publish: bool = PUBLISH_DEFAULT
    # 0 = publish every committed save; N > 0 = only saves whose step is
    # a multiple of N (decouples rollout cadence from save cadence)
    publish_interval_steps: int = PUBLISH_INTERVAL_STEPS_DEFAULT
    # live window: versions routable (and prune-protected) at once
    keep_live_versions: int = KEEP_LIVE_VERSIONS_DEFAULT
    # controller: how often the serving side polls VERSIONS.json
    rollout_poll_interval_s: float = ROLLOUT_POLL_INTERVAL_S_DEFAULT
    # rolling update: per-replica drain budget before a forced restart
    drain_timeout_s: float = DRAIN_TIMEOUT_S_DEFAULT

    def __post_init__(self):
        if self.publish_interval_steps < 0:
            raise ValueError(
                "lifecycle.publish_interval_steps must be >= 0, got "
                f"{self.publish_interval_steps}")
        if self.keep_live_versions < 1:
            raise ValueError(
                "lifecycle.keep_live_versions must be >= 1, got "
                f"{self.keep_live_versions}")
        if self.remesh_debounce_s < 0:
            raise ValueError(
                "lifecycle.remesh_debounce_s must be >= 0, got "
                f"{self.remesh_debounce_s}")
        if self.rollout_poll_interval_s <= 0:
            raise ValueError(
                "lifecycle.rollout_poll_interval_s must be > 0, got "
                f"{self.rollout_poll_interval_s}")
        if self.drain_timeout_s <= 0:
            raise ValueError(
                "lifecycle.drain_timeout_s must be > 0, got "
                f"{self.drain_timeout_s}")
        self.signal_number()  # validates the name eagerly

    def signal_number(self) -> int:
        """The configured re-mesh signal as a number."""
        name = self.remesh_signal
        num = getattr(signal, name, None)
        if not isinstance(num, signal.Signals):
            raise ValueError(
                f"lifecycle.remesh_signal {name!r} is not a signal name "
                "(expected e.g. 'SIGUSR1')")
        return int(num)

    @staticmethod
    def from_dict(d: dict) -> "LifecycleConfig":
        if not isinstance(d, dict):
            raise ValueError(
                f"lifecycle config must be a dict, got {type(d).__name__}")
        unknown = set(d) - _KNOWN_KEYS
        if unknown:
            raise ValueError(
                f"unknown lifecycle config keys {sorted(unknown)}; "
                f"valid keys: {sorted(_KNOWN_KEYS)}")
        kwargs = {k: d[k] for k in d}
        return LifecycleConfig(**kwargs)
