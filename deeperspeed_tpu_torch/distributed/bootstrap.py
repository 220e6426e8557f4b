"""Multi-process bootstrap: bring up ``torch.distributed`` under policy.

Counterpart of deeperspeed_tpu/distributed/bootstrap.py, where
``jax.distributed.initialize`` becomes :func:`initialize_process_group`:
a ``TCPStore`` at the coordinator address (process 0 binds it) and
``torch.distributed.init_process_group`` over it, under the same retry,
backoff and timeout policy.

:func:`bootstrap` is the one place the runtime crosses from "a process"
to "process k of N": it resolves the fleet shape (config pins or the
launcher/MPI environment, :func:`..utils.distributed.discover`), joins
the process group, stamps the per-host run context (``role.h<proc>``, so
every host gets its own obs files), writes this host's rendezvous record
and emits a ``dist/init`` trace span carrying the resulting topology.

The backend: NCCL when every rank has a card of its own; gloo when the
ranks run on the host or share one card (NCCL refuses two ranks on one
device), in which case the comm layer stages CUDA tensors through pinned
host buffers (runtime/comm/collectives.py). Under ``cpu_collectives:
"auto"`` the ranks tell which by trading their card's identity through
the store. A rank that cannot join raises after ``init_retries``
attempts; nothing falls back to a world of one.

Idempotent: a second call (an engine re-init inside one process, or a
group that ``init_distributed`` or a launcher already made) returns the
existing topology and adopts the existing group.
"""

import dataclasses
import datetime
import os
import socket
import sys
import time
from typing import Dict, Optional

from ..utils.logging import logger
from .config import DistributedConfig

__all__ = [
    "ProcessTopology",
    "bootstrap",
    "current_topology",
    "initialize_process_group",
    "multiprocess_cpu_probe",
    "shutdown",
]

_state: Dict[str, object] = {"initialized": False, "topology": None}


@dataclasses.dataclass(frozen=True)
class ProcessTopology:
    """What :func:`bootstrap` established: one record per process."""

    process_id: int
    process_count: int
    local_devices: int
    global_devices: int
    coordinator_address: Optional[str] = None
    cpu_collectives: str = "off"

    @property
    def multihost(self) -> bool:
        return self.process_count > 1

    def host_role(self, base: str) -> str:
        """Per-host role label: ``trainer`` -> ``trainer.h1`` so each
        host's obs files (``<role>.i<inc>.trace.json``) are distinct."""
        from ..monitor.runctx import host_role

        return host_role(base, self.process_id, self.process_count)

    def as_args(self) -> Dict[str, object]:
        return {
            "process": self.process_id,
            "processes": self.process_count,
            "local_devices": self.local_devices,
            "global_devices": self.global_devices,
        }


def _device_identity() -> str:
    """This rank's card: its UUID where torch reports one, else the host
    name and the device index. Selects the card by ``LOCAL_RANK`` first."""
    import torch

    idx = int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count()
    props = torch.cuda.get_device_properties(idx)
    uuid = getattr(props, "uuid", None)
    if uuid is not None:
        return str(uuid)
    return f"{socket.gethostname()}:{getattr(props, 'pci_bus_id', idx)}"


def _choose_backend(choice: str, store, num_processes: int,
                    process_id: int) -> str:
    """The process group's backend (see the module docstring)."""
    import torch

    if choice in ("gloo", "mpi"):
        return choice
    if not torch.cuda.is_available():
        return "gloo"
    if choice == "off":
        return "nccl"
    store.set(f"ds_device/{process_id}", _device_identity())
    ids = {store.get(f"ds_device/{r}").decode()
           for r in range(num_processes)}
    return "nccl" if len(ids) == num_processes else "gloo"


def initialize_process_group(coordinator_address: str, num_processes: int,
                             process_id: int, *,
                             cpu_collectives: str = "auto",
                             init_timeout_s: float = 120.0,
                             heartbeat_timeout_s: float = 100.0,
                             init_retries: int = 3,
                             retry_backoff_s: float = 1.0) -> str:
    """``init_process_group`` over a ``TCPStore`` at
    ``coordinator_address`` under a retry + backoff policy: attempts
    beyond the first wait ``retry_backoff_s * 2^(attempt-1)``. Each
    attempt has ``init_timeout_s`` for the whole fleet to arrive; after
    the rendezvous a collective waits ``heartbeat_timeout_s`` on a silent
    peer. Returns the backend; raises after ``init_retries`` failed
    attempts."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("a default process group already exists; "
                           "bootstrap adopts it instead")
    host, port = coordinator_address.rsplit(":", 1)
    last: Optional[BaseException] = None
    for attempt in range(1, int(init_retries) + 1):
        store = None
        try:
            store = dist.TCPStore(
                host, int(port), int(num_processes),
                is_master=int(process_id) == 0,
                timeout=datetime.timedelta(seconds=float(init_timeout_s)),
                wait_for_workers=True)
            backend = _choose_backend(cpu_collectives, store,
                                      int(num_processes), int(process_id))
            if backend == "nccl":
                import torch

                torch.cuda.set_device(
                    int(os.environ.get("LOCAL_RANK", "0"))
                    % torch.cuda.device_count())
            dist.init_process_group(
                backend, store=store, rank=int(process_id),
                world_size=int(num_processes),
                timeout=datetime.timedelta(
                    seconds=float(heartbeat_timeout_s)))
            return backend
        except Exception as e:  # transient: coordinator not up yet, etc.
            last = e
            del store
            if attempt >= int(init_retries):
                break
            delay = float(retry_backoff_s) * (2.0 ** (attempt - 1))
            logger.warning(
                "init_process_group attempt %d/%d failed (%s); retrying "
                "in %.1fs", attempt, init_retries, e, delay)
            time.sleep(delay)
    raise RuntimeError(
        f"init_process_group failed after {init_retries} attempt(s): "
        f"{last}") from last


def current_topology() -> Optional[ProcessTopology]:
    """The topology :func:`bootstrap` established, or None."""
    return _state["topology"]  # type: ignore[return-value]


def bootstrap(cfg: Optional[DistributedConfig] = None,
              *, role: Optional[str] = None) -> ProcessTopology:
    """Establish the process topology for this run.

    Single-process (no fleet shape anywhere) is not an error: the
    returned topology has ``process_count == 1`` and nothing was
    initialized, so every config works unchanged on one card.
    """
    if _state["initialized"]:
        return _state["topology"]  # type: ignore[return-value]
    import torch.distributed as dist

    cfg = cfg or DistributedConfig()
    if not cfg.enabled:
        raise ValueError("bootstrap() called with a disabled config")

    from ..utils import distributed as _legacy

    if cfg.num_processes is not None:
        addr = cfg.coordinator_address
        if addr is None:
            raise ValueError(
                "distributed.num_processes pinned without "
                "coordinator_address (and no launcher environment)")
        shape = dict(coordinator_address=addr,
                     num_processes=int(cfg.num_processes),
                     process_id=int(cfg.process_id))
    else:
        shape = _legacy.discover()
        if shape is not None and cfg.coordinator_address is not None:
            shape["coordinator_address"] = cfg.coordinator_address

    if dist.is_initialized():
        # init_distributed (or an embedding application) already made the
        # default group: adopt it
        backend = "external"
        shape = dict(coordinator_address=(shape or {}).get(
            "coordinator_address"),
            num_processes=dist.get_world_size(),
            process_id=dist.get_rank())
    elif shape is None or int(shape["num_processes"]) <= 1:
        topo = ProcessTopology(
            process_id=0, process_count=1, local_devices=1,
            global_devices=1, coordinator_address=None,
            cpu_collectives="off")
        _state.update(initialized=True, topology=topo)
        return topo
    else:
        backend = initialize_process_group(
            shape["coordinator_address"], int(shape["num_processes"]),
            int(shape["process_id"]),
            cpu_collectives=cfg.cpu_collectives,
            init_timeout_s=cfg.init_timeout_s,
            heartbeat_timeout_s=cfg.heartbeat_timeout_s,
            init_retries=cfg.init_retries,
            retry_backoff_s=cfg.retry_backoff_s)
    _legacy._initialized = True

    n = int(shape["num_processes"])
    topo = ProcessTopology(
        process_id=int(shape["process_id"]), process_count=n,
        local_devices=1, global_devices=n,
        coordinator_address=(str(shape["coordinator_address"])
                             if shape["coordinator_address"] else None),
        cpu_collectives=backend)
    _state.update(initialized=True, topology=topo)

    # per-host run context: every process of the fleet keeps the run id
    # but gets its own role lane (trainer.h0, trainer.h1, ...)
    from ..monitor import runctx

    base_role = role or os.environ.get(runctx.ROLE_ENV, "trainer")
    if not base_role.endswith(f".h{topo.process_id}"):
        os.environ[runctx.ROLE_ENV] = runctx.host_role(
            base_role, topo.process_id, topo.process_count)

    # the fleet supervisor hands children the record directory via env;
    # a config pin wins when both are present
    rdzv_dir = cfg.rendezvous_dir or os.environ.get("DS_TPU_RENDEZVOUS_DIR")
    if rdzv_dir:
        from . import rendezvous

        rendezvous.write_record(
            rdzv_dir,
            rendezvous.HostRecord(
                host=topo.process_id, pid=os.getpid(),
                incarnation=runctx.current().incarnation,
                epoch=int(os.environ.get("DS_TPU_FLEET_EPOCH", "0")),
                role=os.environ[runctx.ROLE_ENV], status="ready",
                clock=runctx.clock_anchor()))

    emit_init_span()
    logger.info(
        "distributed bootstrap: process %d/%d, coordinator=%s, backend=%s",
        topo.process_id, topo.process_count, topo.coordinator_address,
        backend)
    return topo


def emit_init_span() -> None:
    """The ``dist/init`` span of the established topology, into the
    current tracer. The engine calls it again once its monitor is up,
    since a bootstrap that runs before the engine has no tracer yet."""
    topo = current_topology()
    if topo is None or not topo.multihost:
        return
    from ..monitor import trace_span

    with trace_span("dist/init", lane="dist",
                    coordinator=topo.coordinator_address,
                    cpu_collectives=topo.cpu_collectives, **topo.as_args()):
        pass


def shutdown() -> None:
    """Destroy the process group (subprocess drills/tests)."""
    if not _state["initialized"]:
        return
    import torch.distributed as dist

    try:
        if dist.is_initialized():
            dist.destroy_process_group()
    except Exception:
        pass
    from ..utils import distributed as _legacy

    _legacy._initialized = False
    _state.update(initialized=False, topology=None)


# ---------------------------------------------------------------------- #
# capability probe
# ---------------------------------------------------------------------- #

_PROBE_CHILD = r"""
import sys
rank = int(sys.argv[1]); port = sys.argv[2]
import torch, torch.distributed as dist
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
t = torch.full((1,), float(rank + 1))
dist.all_reduce(t)
assert float(t) == 3.0, float(t)
dist.destroy_process_group()
print("PROBE-OK", flush=True)
"""

_probe_cache: Dict[str, bool] = {}


def multiprocess_cpu_probe(timeout_s: float = 90.0) -> bool:
    """Can this torch build run a 2-process gloo all-reduce on localhost?

    Spawns two throwaway processes that rendezvous on a free port and sum
    across the process boundary. Cached per process.
    """
    if "ok" in _probe_cache:
        return _probe_cache["ok"]
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _PROBE_CHILD, str(r), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)
    ]
    ok = True
    deadline = time.monotonic() + timeout_s
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0,
                                               deadline - time.monotonic()))
            ok = ok and p.returncode == 0 and "PROBE-OK" in out
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            ok = False
    _probe_cache["ok"] = ok
    return ok


if __name__ == "__main__":
    sys.exit(0 if multiprocess_cpu_probe() else 1)
