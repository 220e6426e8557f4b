"""Per-host rendezvous records and the fleet clock handshake.

Counterpart of deeperspeed_tpu/distributed/rendezvous.py, whole: the same
record files, so each package reads the other's.

The fleet supervisor and every trainer process share one directory
(local disk on the localhost harness, NFS/GCS on a real fleet). Each
host owns exactly one file in it — ``host<k>.json`` — written
atomically, so readers never see a torn record:

* the **supervisor** stamps ``launched`` (with the launch epoch and its
  ``t_send`` wall clock) before exec'ing host k's trainer, and
  ``exited``/``crashed``/``preempted`` with the exit code after;
* the **trainer** (via :func:`..bootstrap.bootstrap`) overwrites it
  with ``ready`` once its process group is up, stamping its own
  clock anchor — which doubles as the ``t_remote`` of an NTP-style
  handshake: the supervisor's ``t_send`` (from the launched record it
  wrote) and its ``t_recv`` (when it observes the flip to ready)
  bracket the child's stamp, so
  :func:`...monitor.runctx.estimate_clock_offset` yields a per-host
  wall-clock offset without any extra channel.

:func:`write_offsets` persists those estimates as ``offsets.json``
keyed by host role — exactly the sidecar
:func:`...monitor.aggregate.merge_files` consumes to rebase per-host
trace lanes onto one fleet timeline.
"""

import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

__all__ = [
    "HostRecord",
    "record_path",
    "write_record",
    "read_record",
    "read_records",
    "wait_all_ready",
    "write_offsets",
    "read_offsets",
    "OFFSETS_FILE",
]

OFFSETS_FILE = "offsets.json"

_STATUSES = ("launched", "ready", "exited", "crashed", "preempted")


@dataclasses.dataclass(frozen=True)
class HostRecord:
    """One host's latest rendezvous state."""

    host: int                    # process id within the fleet
    pid: int = 0                 # OS pid of the trainer (0 = not spawned)
    incarnation: int = 0         # restarts of this host's logical slot
    epoch: int = 0               # fleet launch epoch (bumps per restart)
    role: str = "trainer"        # obs role lane (trainer.h<k>)
    status: str = "launched"     # launched|ready|exited|crashed|preempted
    exit_code: Optional[int] = None
    reason: Optional[str] = None  # crash/preempt cause, supervisor-stamped
    clock: Optional[Dict[str, float]] = None  # runctx.clock_anchor()
    wall: float = 0.0            # when this record was written

    def __post_init__(self):
        if self.status not in _STATUSES:
            raise ValueError(
                f"rendezvous status must be one of {_STATUSES}, "
                f"got {self.status!r}")
        if self.host < 0:
            raise ValueError(f"rendezvous host must be >= 0, got {self.host}")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v is not None}

    @staticmethod
    def from_dict(d: dict) -> "HostRecord":
        fields = {f.name for f in dataclasses.fields(HostRecord)}
        return HostRecord(**{k: d[k] for k in d if k in fields})


def record_path(dirpath: str, host: int) -> str:
    return os.path.join(dirpath, f"host{int(host)}.json")


def write_record(dirpath: str, rec: HostRecord) -> str:
    """Atomically (write + rename) persist ``rec`` as host<k>.json."""
    os.makedirs(dirpath, exist_ok=True)
    if not rec.wall:
        rec = dataclasses.replace(rec, wall=time.time())
    path = record_path(dirpath, rec.host)
    fd, tmp = tempfile.mkstemp(dir=dirpath, prefix=".rdzv.")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(rec.to_dict(), f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def read_record(dirpath: str, host: int) -> Optional[HostRecord]:
    try:
        with open(record_path(dirpath, host)) as f:
            return HostRecord.from_dict(json.load(f))
    except (OSError, json.JSONDecodeError, ValueError, TypeError):
        return None


def read_records(dirpath: str) -> List[HostRecord]:
    """All hosts' records, sorted by host id; unreadable files skipped."""
    out = []
    try:
        names = os.listdir(dirpath)
    except OSError:
        return out
    for name in names:
        if not (name.startswith("host") and name.endswith(".json")):
            continue
        try:
            host = int(name[4:-5])
        except ValueError:
            continue
        rec = read_record(dirpath, host)
        if rec is not None:
            out.append(rec)
    return sorted(out, key=lambda r: r.host)


def wait_all_ready(dirpath: str, hosts: int, epoch: int,
                   timeout_s: float = 60.0,
                   poll_s: float = 0.05) -> List[HostRecord]:
    """Block until every host of ``epoch`` reports ``ready`` (the
    coordinator's half of the restart barrier). Raises TimeoutError
    with the stragglers' current statuses."""
    deadline = time.monotonic() + timeout_s
    while True:
        recs = {r.host: r for r in read_records(dirpath)}
        ready = [recs.get(h) for h in range(hosts)]
        if all(r is not None and r.status == "ready" and r.epoch == epoch
               for r in ready):
            return [recs[h] for h in range(hosts)]
        if time.monotonic() > deadline:
            statuses = {h: (recs[h].status if h in recs else "missing")
                        for h in range(hosts)}
            raise TimeoutError(
                f"rendezvous epoch {epoch}: not all {hosts} hosts ready "
                f"within {timeout_s}s: {statuses}")
        time.sleep(poll_s)


def write_offsets(dirpath: str, offsets_by_role: Dict[str, float]) -> str:
    """Persist per-host clock offsets (seconds the host's wall clock is
    AHEAD of the supervisor's) keyed by role — the aggregator's
    ``offsets.json`` sidecar."""
    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, OFFSETS_FILE)
    fd, tmp = tempfile.mkstemp(dir=dirpath, prefix=".off.")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump({k: float(v) for k, v in offsets_by_role.items()}, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def read_offsets(dirpath: str) -> Dict[str, float]:
    try:
        with open(os.path.join(dirpath, OFFSETS_FILE)) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}
    return {str(k): float(v) for k, v in doc.items()
            if isinstance(v, (int, float))}
