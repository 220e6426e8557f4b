"""Distributed-runtime configuration.

Counterpart of deeperspeed_tpu/distributed/config.py: the same keys,
defaults and errors. A ``"distributed"`` block in the master JSON config
(or a plain dict) builds a :class:`DistributedConfig`, the policy for the
multi-process runtime: how ``torch.distributed.init_process_group``
rendezvouses (coordinator address, process id/count, init timeout, retry
backoff; the heartbeat budget bounds how long a collective may wait on a
silent peer), which backend carries host tensors (``cpu_collectives``),
and where per-host rendezvous records live.

One departure: ``local_devices`` (simulated CPU devices inside one jax
process) has no PyTorch counterpart, since one process is one rank. The
port accepts only ``null`` or 1 and raises otherwise, naming the reason. Validated eagerly (unknown keys
are errors) like every other subsystem block, so a typo'd coordinator
address fails at config load, not after a 300 s rendezvous timeout.

Every shape field defaults to ``None`` = *discover from the
environment* (``DS_COORDINATOR_ADDRESS`` / ``DS_NUM_PROCESSES`` /
``DS_PROCESS_ID`` from the launcher, then the reference-compatible
``MASTER_ADDR``/``WORLD_SIZE``/``RANK``, then OpenMPI env — the
:func:`...utils.distributed.discover` chain), so one committed config
serves every host of the fleet.
"""

import dataclasses
from typing import Optional

__all__ = ["DistributedConfig"]

# config keys (declared so the analysis linter can enumerate them)
ENABLED = "enabled"
ENABLED_DEFAULT = True
COORDINATOR_ADDRESS = "coordinator_address"
NUM_PROCESSES = "num_processes"
PROCESS_ID = "process_id"
CPU_COLLECTIVES = "cpu_collectives"
CPU_COLLECTIVES_DEFAULT = "auto"
INIT_TIMEOUT_S = "init_timeout_s"
INIT_TIMEOUT_S_DEFAULT = 120.0
HEARTBEAT_TIMEOUT_S = "heartbeat_timeout_s"
HEARTBEAT_TIMEOUT_S_DEFAULT = 100.0
INIT_RETRIES = "init_retries"
INIT_RETRIES_DEFAULT = 3
RETRY_BACKOFF_S = "retry_backoff_s"
RETRY_BACKOFF_S_DEFAULT = 1.0
RENDEZVOUS_DIR = "rendezvous_dir"
LOCAL_DEVICES = "local_devices"

CPU_COLLECTIVES_CHOICES = ("auto", "gloo", "mpi", "off")

_KNOWN_KEYS = frozenset({
    ENABLED, COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID,
    CPU_COLLECTIVES, INIT_TIMEOUT_S, HEARTBEAT_TIMEOUT_S, INIT_RETRIES,
    RETRY_BACKOFF_S, RENDEZVOUS_DIR, LOCAL_DEVICES,
})


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """The ``"distributed"`` block: multi-host rendezvous policy."""

    enabled: bool = ENABLED_DEFAULT
    # "host:port" of the coordination service (process 0 binds it).
    # None = discover from the launcher/MPI environment; a bare host
    # (no ":") is rejected so a forgotten port fails loudly.
    coordinator_address: Optional[str] = None
    # global process count / this process's id; None = discover. Both
    # must come from the same source — a config pinning only one of the
    # pair is almost always a copy-paste error on a fleet.
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    # the process group's backend for host tensors: "auto" takes NCCL
    # when every rank has a card of its own and gloo otherwise (host
    # runs, or ranks sharing one card, which NCCL refuses); "gloo"/"mpi"
    # force a backend; "off" leaves the choice to the caller (NCCL on
    # the card, gloo on the host).
    cpu_collectives: str = CPU_COLLECTIVES_DEFAULT
    # rendezvous budget for ONE init_process_group attempt; the whole
    # fleet must arrive within it
    init_timeout_s: float = INIT_TIMEOUT_S_DEFAULT
    # how long a collective waits on a silent peer before the process
    # group gives up on it (the group's timeout after the rendezvous)
    heartbeat_timeout_s: float = HEARTBEAT_TIMEOUT_S_DEFAULT
    # transient-failure policy around the rendezvous: attempts beyond the
    # first wait retry_backoff_s * 2^(attempt-1) between tries (the
    # coordinator's socket may simply not be up yet on a cold fleet)
    init_retries: int = INIT_RETRIES_DEFAULT
    retry_backoff_s: float = RETRY_BACKOFF_S_DEFAULT
    # shared directory for per-host rendezvous records (host<k>.json:
    # pid, incarnation, epoch, status, clock anchor) + the fleet
    # supervisor's clock-offset ledger; None = no records written
    rendezvous_dir: Optional[str] = None
    # the reference's simulated CPU device count per process; here one
    # process is one rank, so only None or 1 is accepted
    local_devices: Optional[int] = None

    def __post_init__(self):
        if self.cpu_collectives not in CPU_COLLECTIVES_CHOICES:
            raise ValueError(
                "distributed.cpu_collectives must be one of "
                f"{list(CPU_COLLECTIVES_CHOICES)}, "
                f'got "{self.cpu_collectives}"')
        if (self.coordinator_address is not None
                and ":" not in self.coordinator_address):
            raise ValueError(
                "distributed.coordinator_address must be 'host:port', "
                f'got "{self.coordinator_address}"')
        if self.num_processes is not None and int(self.num_processes) < 1:
            raise ValueError(
                "distributed.num_processes must be >= 1, got "
                f"{self.num_processes}")
        if self.process_id is not None:
            if int(self.process_id) < 0:
                raise ValueError(
                    "distributed.process_id must be >= 0, got "
                    f"{self.process_id}")
            if (self.num_processes is not None
                    and int(self.process_id) >= int(self.num_processes)):
                raise ValueError(
                    f"distributed.process_id {self.process_id} out of "
                    f"range for num_processes {self.num_processes}")
        if (self.process_id is None) != (self.num_processes is None):
            raise ValueError(
                "distributed.process_id and distributed.num_processes "
                "must be pinned together (or both discovered from the "
                "environment)")
        if not (float(self.init_timeout_s) > 0):
            raise ValueError(
                "distributed.init_timeout_s must be > 0, got "
                f"{self.init_timeout_s}")
        if not (float(self.heartbeat_timeout_s) > 0):
            raise ValueError(
                "distributed.heartbeat_timeout_s must be > 0, got "
                f"{self.heartbeat_timeout_s}")
        if int(self.init_retries) < 1:
            raise ValueError(
                "distributed.init_retries must be >= 1, got "
                f"{self.init_retries}")
        if float(self.retry_backoff_s) < 0:
            raise ValueError(
                "distributed.retry_backoff_s must be >= 0, got "
                f"{self.retry_backoff_s}")
        if self.local_devices is not None and int(self.local_devices) < 1:
            raise ValueError(
                "distributed.local_devices must be >= 1, got "
                f"{self.local_devices}")
        if self.local_devices is not None and int(self.local_devices) != 1:
            raise ValueError(
                "distributed.local_devices simulates several CPU devices "
                "inside one jax process, which has no PyTorch "
                "counterpart: a process of the PyTorch package is one "
                f"rank; use null or 1 (got {self.local_devices}) and "
                "launch one process per rank")

    @staticmethod
    def from_dict(d: dict) -> "DistributedConfig":
        if not isinstance(d, dict):
            raise ValueError(
                f"distributed config must be a dict, got {type(d).__name__}")
        unknown = set(d) - _KNOWN_KEYS
        if unknown:
            raise ValueError(
                f"unknown distributed config keys {sorted(unknown)}; "
                f"valid keys: {sorted(_KNOWN_KEYS)}")
        return DistributedConfig(**{k: d[k] for k in d})
