"""Fault tolerance: async two-phase checkpointing, preemption handling,
fault injection, and auto-resume.

Counterpart of deeperspeed_tpu/resilience/, with the reference's export
list. Long runs must survive being killed at any instant:

  * ``manager.ResilienceManager`` — engine-facing composition: async
    (or sync) two-phase-commit saves, interval autosaves, the
    preemption protocol, telemetry.
  * ``manifest`` — per-file checksum manifests, COMMITTED markers, the
    staging-dir commit dance, and valid-tag discovery/fallback.
  * ``writer.AsyncCheckpointWriter`` — bounded-queue background writer.
  * ``preemption.PreemptionGuard`` — SIGTERM/SIGINT -> urgent
    checkpoint at the next step boundary -> serving drain -> sentinel
    exit.
  * ``faults`` — deterministic fault injection (raise / SIGKILL
    mid-save / corruption) for drills and tests.
  * ``supervisor`` — ``python -m deeperspeed_tpu_torch.resilience.supervisor
    -- <train cmd>``: restart on crash (exponential backoff, capped) or
    preemption (immediately), discovering the newest valid checkpoint
    and composing with ``elasticity/`` for resumes on a different
    world size.

Lifecycle mirrors the monitor: ``init_resilience(config)`` installs the
process-global manager; engines adopt it at init, serving engines
register for preemption drain. Without a ``"resilience"`` config block
nothing is installed and the hot path pays one ``is None`` check.
"""

from typing import Optional, Union

from .config import PREEMPTION_EXIT_CODE_DEFAULT, ResilienceConfig
from .faults import (
    FAULTS_ENV_VAR,
    FaultInjector,
    FaultPlan,
    InjectedFault,
    PoolEvent,
    SpotPoolSimulator,
    corrupt_file,
)
from .manifest import (
    COMMITTED_MARKER,
    MANIFEST_FILE,
    STAGING_SUFFIX,
    CheckpointCorruption,
    commit_checkpoint,
    find_latest_valid_tag,
    is_committed,
    resolve_load_tag,
    tag_status,
    verify_manifest,
    write_manifest,
)
from .manager import ResilienceManager
from .preemption import PreemptionGuard
from .reshard import (
    plans_reshardable,
    remap_data_state,
    reshard_comm_residuals,
    reshard_transform_residuals,
)
from .supervisor import Supervisor, SupervisorPolicy, compute_backoff
from .writer import AsyncCheckpointWriter, CheckpointWriteError

__all__ = [
    "AsyncCheckpointWriter",
    "CheckpointCorruption",
    "CheckpointWriteError",
    "COMMITTED_MARKER",
    "FAULTS_ENV_VAR",
    "FaultInjector",
    "FaultPlan",
    "InjectedFault",
    "MANIFEST_FILE",
    "PREEMPTION_EXIT_CODE_DEFAULT",
    "PoolEvent",
    "PreemptionGuard",
    "SpotPoolSimulator",
    "ResilienceConfig",
    "ResilienceManager",
    "STAGING_SUFFIX",
    "Supervisor",
    "SupervisorPolicy",
    "commit_checkpoint",
    "compute_backoff",
    "corrupt_file",
    "find_latest_valid_tag",
    "get_resilience_manager",
    "init_resilience",
    "is_committed",
    "plans_reshardable",
    "remap_data_state",
    "reshard_comm_residuals",
    "reshard_transform_residuals",
    "resolve_load_tag",
    "shutdown_resilience",
    "tag_status",
    "verify_manifest",
    "write_manifest",
]

_manager: Optional[ResilienceManager] = None


def get_resilience_manager() -> Optional[ResilienceManager]:
    """The process-global manager, or None when resilience is off."""
    return _manager


def init_resilience(
        config: Union[ResilienceConfig, dict, None]) -> ResilienceManager:
    """Build + install the process-global ResilienceManager (closing a
    previously installed one first, so signal handlers and writer
    threads never stack)."""
    global _manager
    cfg = (config if isinstance(config, ResilienceConfig)
           else ResilienceConfig.from_dict(config))
    if _manager is not None:
        _manager.close()
    _manager = ResilienceManager(cfg)
    return _manager


def shutdown_resilience() -> None:
    """Drain pending saves, uninstall handlers, drop the global."""
    global _manager
    if _manager is not None:
        _manager.close()
        _manager = None
