"""Fleet supervisor: the multi-host launch story of the resilience layer.

Counterpart of deeperspeed_tpu/distributed/fleet.py, less the
``simulate_cpu_devices`` drill switch (a PyTorch process is one rank, so
``local_devices`` must be 1, see distributed/config.py).

:class:`~...resilience.supervisor.Supervisor` restarts ONE child; a
multi-host run is N children that must live and die *together*: a
process group cannot lose a rank, so restarting just the dead host would
strand the survivors at a collective. :class:`FleetSupervisor` owns that coordination:

* **launch** — spawns one trainer process per host with the rendezvous
  env (``DS_COORDINATOR_ADDRESS`` / ``DS_NUM_PROCESSES`` /
  ``DS_PROCESS_ID``) on a fresh coordinator port per epoch, per-host
  role/incarnation run context, and per-host ``launched`` rendezvous
  records carrying the handshake ``t_send``;
* **restart barrier** — on any non-zero child exit it classifies the
  cause (the preemption sentinel vs a crash; SIGKILL arrives as a
  negative returncode), stamps the dead host's record, tears the
  survivors down (SIGTERM, grace, SIGKILL), stamps THEIRS with reason
  ``fleet_restart``, then relaunches every host at epoch+1 from the
  newest valid checkpoint tag. Preemptions restart free; crashes pay
  exponential backoff and count against the cap — per host, the
  restart log preserves who actually died and why vs who was
  barrier-recycled;
* **cross-host pool growth** — with ``watch_pool`` the pool file holds
  the fleet's PROCESS count. A debounced change triggers a *planned*
  re-mesh transition: graceful fleet stop (reason ``pool_change``,
  zero crash-restarts), relaunch at the new process count. This is the
  growth path a live re-mesh cannot take (a process group's size is
  fixed when it forms; the fleet supervisor grows the process count),
  and checkpoint resharding (:mod:`...resilience.reshard`) carries
  optimizer/residual state across the world-size change;
* **clock offsets** — when a host's record flips ``launched``→``ready``
  the supervisor closes the NTP-style handshake
  (:func:`...monitor.runctx.estimate_clock_offset`) and persists
  per-role offsets for the trace aggregator.

Localhost drills run every "host" as a process on one machine (on the
CPU, or sharing one card over gloo): the same process-spanning code
paths as a real fleet, minus the machines.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..monitor.runctx import (
    INCARNATION_ENV,
    ROLE_ENV,
    clock_anchor,
    ensure_run_id,
    estimate_clock_offset,
    host_role,
)
from ..resilience.config import PREEMPTION_EXIT_CODE_DEFAULT
from ..resilience.manifest import find_latest_valid_tag
from ..resilience.supervisor import (
    POOL_FILE_ENV,
    RESTART_COUNT_ENV,
    RESTART_REASON_ENV,
    RESUME_DIR_ENV,
    RESUME_TAG_ENV,
    WORLD_SIZE_ENV,
    compute_backoff,
)
from ..utils.logging import logger
from . import rendezvous

__all__ = ["FleetPolicy", "FleetSupervisor", "classify_exit", "free_port"]

FLEET_EPOCH_ENV = "DS_TPU_FLEET_EPOCH"


def classify_exit(code: int, preempt_exit_code: int) -> str:
    """Exit-code taxonomy shared by the barrier and the restart log:
    ``done`` (0), ``preempted`` (the sentinel), ``crashed`` (anything
    else, including negative = killed by that signal)."""
    if code == 0:
        return "done"
    if code == int(preempt_exit_code):
        return "preempted"
    return "crashed"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class FleetPolicy:
    procs: int = 2                      # hosts (processes) to launch
    local_devices: int = 1              # ranks per host process (1)
    base_role: str = "trainer"          # runctx role (gets .h<k> suffix)
    coordinator_host: str = "127.0.0.1"
    checkpoint_dir: Optional[str] = None
    rendezvous_dir: Optional[str] = None
    restart_log: Optional[str] = None   # JSONL transition record
    max_restarts: int = 10              # crash restarts; preemptions free
    backoff_base: float = 0.2
    backoff_factor: float = 2.0
    backoff_max: float = 30.0
    preempt_exit_code: int = PREEMPTION_EXIT_CODE_DEFAULT
    # cross-host growth: pool file holds the fleet PROCESS count,
    # re-read while the fleet runs; a debounced change = planned re-mesh
    pool_file: Optional[str] = None
    watch_pool: bool = False
    pool_poll_interval_s: float = 0.25
    pool_debounce_s: float = 0.5
    term_grace_s: float = 10.0          # SIGTERM -> SIGKILL budget
    ready_timeout_s: float = 120.0      # barrier: fleet must re-arrive
    extra_env: Dict[str, str] = field(default_factory=dict)


class FleetSupervisor:
    """Coordinated restart/growth loop around N trainer processes."""

    def __init__(self, cmd: Sequence[str], policy: FleetPolicy):
        if not cmd:
            raise ValueError("fleet supervisor needs a command to run")
        if policy.procs < 1:
            raise ValueError(f"fleet needs >= 1 process, got {policy.procs}")
        if policy.local_devices != 1:
            raise ValueError(
                "FleetPolicy.local_devices must be 1: a process of the "
                "PyTorch package is one rank (got "
                f"{policy.local_devices})")
        self.cmd = list(cmd)
        self.policy = policy
        self.procs = int(policy.procs)
        self.epoch = 0
        self.crashes = 0          # crash barriers (drive backoff + cap)
        self.preemptions = 0
        self.remeshes = 0         # planned pool-change transitions
        self.history: List[Dict[int, int]] = []  # per-epoch exit codes
        self._incarnation = [0] * self.procs
        self._children: List[subprocess.Popen] = []
        self._t_send: Dict[int, float] = {}
        self._offsets: Dict[str, float] = {}
        self._offset_done: set = set()
        self._pool_mtime: Optional[float] = None
        self._pool_pending: Optional[tuple] = None
        ensure_run_id()

    # ------------------------------------------------------------------ #
    # bookkeeping
    # ------------------------------------------------------------------ #

    def _log_event(self, event: str, **fields) -> None:
        if not self.policy.restart_log:
            return
        rec = {"event": event, "wall": time.time(), "epoch": self.epoch,
               **fields}
        with open(self.policy.restart_log, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _resume_env(self) -> Dict[str, str]:
        env: Dict[str, str] = {}
        ckdir = self.policy.checkpoint_dir
        if ckdir:
            tag = find_latest_valid_tag(ckdir)
            if tag is not None:
                env[RESUME_TAG_ENV] = tag
                env[RESUME_DIR_ENV] = ckdir
        return env

    def _child_env(self, host: int, port: int, reason: str) -> dict:
        p = self.policy
        env = dict(os.environ)
        env.update(p.extra_env)
        env["DS_COORDINATOR_ADDRESS"] = f"{p.coordinator_host}:{port}"
        env["DS_NUM_PROCESSES"] = str(self.procs)
        env["DS_PROCESS_ID"] = str(host)
        env[ROLE_ENV] = p.base_role  # bootstrap appends .h<proc>
        env[INCARNATION_ENV] = str(self._incarnation[host])
        env[FLEET_EPOCH_ENV] = str(self.epoch)
        env[WORLD_SIZE_ENV] = str(self.procs * p.local_devices)
        env[RESTART_COUNT_ENV] = str(self.epoch)
        env[RESTART_REASON_ENV] = reason
        if p.pool_file:
            env[POOL_FILE_ENV] = p.pool_file
        if p.rendezvous_dir:
            env["DS_TPU_RENDEZVOUS_DIR"] = p.rendezvous_dir
        env.update(self._resume_env())
        return env

    # ------------------------------------------------------------------ #
    # launch / stop
    # ------------------------------------------------------------------ #

    def _launch_fleet(self, reason: str) -> None:
        p = self.policy
        port = free_port()
        self._children = []
        self._t_send = {}
        self._offset_done = set()
        for host in range(self.procs):
            if p.rendezvous_dir:
                self._t_send[host] = time.time()
                rendezvous.write_record(p.rendezvous_dir, rendezvous.HostRecord(
                    host=host, incarnation=self._incarnation[host],
                    epoch=self.epoch,
                    role=host_role(p.base_role, host, self.procs),
                    status="launched", clock=clock_anchor(),
                    wall=self._t_send[host]))
            child = subprocess.Popen(
                self.cmd, env=self._child_env(host, port, reason))
            self._children.append(child)
            if p.rendezvous_dir:
                rendezvous.write_record(p.rendezvous_dir, rendezvous.HostRecord(
                    host=host, pid=child.pid,
                    incarnation=self._incarnation[host], epoch=self.epoch,
                    role=host_role(p.base_role, host, self.procs),
                    status="launched", clock=clock_anchor(),
                    wall=self._t_send[host]))
        self._log_event("launch", procs=self.procs, port=port, reason=reason,
                        incarnations=list(self._incarnation),
                        world=self.procs * p.local_devices)
        logger.info("fleet epoch %d: launched %d process(es) on port %d "
                    "(%s)", self.epoch, self.procs, port, reason)

    def _harvest_offsets(self) -> None:
        """Close the launched->ready clock handshake for newly-ready
        hosts and persist offsets.json for the aggregator."""
        p = self.policy
        if not p.rendezvous_dir:
            return
        changed = False
        for rec in rendezvous.read_records(p.rendezvous_dir):
            if (rec.status != "ready" or rec.epoch != self.epoch
                    or rec.host in self._offset_done
                    or rec.host not in self._t_send):
                continue
            t_remote = (rec.clock or {}).get("wall", rec.wall)
            off = estimate_clock_offset(
                self._t_send[rec.host], t_remote, time.time())
            self._offsets[rec.role] = off
            self._offset_done.add(rec.host)
            changed = True
        if changed:
            rendezvous.write_offsets(p.rendezvous_dir, self._offsets)

    def _stop_survivors(self, dead_host: Optional[int], reason: str) -> None:
        """Coherent teardown of every still-running child."""
        p = self.policy
        live = [(h, c) for h, c in enumerate(self._children)
                if h != dead_host and c.poll() is None]
        for _, c in live:
            try:
                c.send_signal(signal.SIGTERM)
            except OSError:
                pass
        deadline = time.monotonic() + p.term_grace_s
        for h, c in live:
            try:
                c.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                c.kill()
                c.wait()
            if p.rendezvous_dir:
                rendezvous.write_record(p.rendezvous_dir, rendezvous.HostRecord(
                    host=h, pid=c.pid, incarnation=self._incarnation[h],
                    epoch=self.epoch,
                    role=host_role(p.base_role, h, self.procs),
                    status="exited", exit_code=c.returncode, reason=reason))
            self._log_event("exit", host=h, code=c.returncode, reason=reason)

    # ------------------------------------------------------------------ #
    # pool watching (cross-host growth)
    # ------------------------------------------------------------------ #

    def _read_pool(self) -> Optional[int]:
        p = self.policy
        if not p.pool_file:
            return None
        try:
            with open(p.pool_file) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def _poll_pool_change(self) -> Optional[int]:
        """Debounced pool-file watch. Returns the new process count once
        a change has held still for pool_debounce_s, else None."""
        p = self.policy
        if not (p.watch_pool and p.pool_file):
            return None
        try:
            mtime = os.stat(p.pool_file).st_mtime
        except OSError:
            return None
        if self._pool_mtime is None:
            self._pool_mtime = mtime
            return None
        if mtime != self._pool_mtime:
            self._pool_mtime = mtime
            self._pool_pending = (time.monotonic(), self._read_pool())
            return None
        if self._pool_pending is not None:
            t0, target = self._pool_pending
            if time.monotonic() - t0 >= p.pool_debounce_s:
                self._pool_pending = None
                if target is not None and target >= 1 and target != self.procs:
                    return target
        return None

    # ------------------------------------------------------------------ #
    # the loop
    # ------------------------------------------------------------------ #

    def run(self) -> int:
        """Run the fleet to completion. Returns the final exit code (0
        when every host exits 0 within the crash cap)."""
        p = self.policy
        self._launch_fleet(reason="start")
        while True:
            self._harvest_offsets()

            target = self._poll_pool_change()
            if target is not None:
                # planned cross-host re-mesh: coherent stop, relaunch at
                # the new process count — zero crash-restarts
                old = self.procs
                self._log_event("fleet_remesh", procs_from=old,
                                procs_to=target)
                logger.info("fleet: pool change %d -> %d process(es); "
                            "coordinated re-mesh restart", old, target)
                self._stop_survivors(None, reason="pool_change")
                self.history.append({h: (c.returncode if c.returncode is
                                         not None else 0)
                                     for h, c in enumerate(self._children)})
                self.remeshes += 1
                self.procs = target
                inc = max(self._incarnation) + 1
                self._incarnation = [inc] * self.procs
                self.epoch += 1
                self._launch_fleet(reason="pool_change")
                continue

            exited = [(h, c) for h, c in enumerate(self._children)
                      if c.poll() is not None]
            if not exited:
                time.sleep(p.pool_poll_interval_s)
                continue

            codes = {h: c.returncode for h, c in exited}
            if all(c.poll() is not None for c in self._children):
                if all(code == 0 for code in
                       (c.returncode for c in self._children)):
                    for h, c in enumerate(self._children):
                        self._log_event("exit", host=h, code=0,
                                        reason="done")
                    self.history.append(
                        {h: c.returncode
                         for h, c in enumerate(self._children)})
                    self._log_event("done", crashes=self.crashes,
                                    preemptions=self.preemptions,
                                    remeshes=self.remeshes)
                    return 0

            # someone died non-zero (or a mixed exit): pick the first
            # failed host as the barrier trigger
            trigger = next(((h, code) for h, code in codes.items()
                            if code != 0), None)
            if trigger is None:
                # some hosts done (exit 0) while others still run: keep
                # waiting; the process group keeps the fleet coherent
                time.sleep(p.pool_poll_interval_s)
                continue
            host, code = trigger
            cause = classify_exit(code, p.preempt_exit_code)
            if p.rendezvous_dir:
                rendezvous.write_record(p.rendezvous_dir, rendezvous.HostRecord(
                    host=host, pid=self._children[host].pid,
                    incarnation=self._incarnation[host], epoch=self.epoch,
                    role=host_role(p.base_role, host, self.procs),
                    status=cause, exit_code=code, reason=cause))
            self._log_event("exit", host=host, code=code, reason=cause)
            logger.warning("fleet epoch %d: host %d exited %d (%s); "
                           "restart barrier", self.epoch, host, code, cause)
            self._stop_survivors(host, reason="fleet_restart")
            self.history.append({h: c.returncode
                                 for h, c in enumerate(self._children)})
            self._log_event("barrier", trigger_host=host, cause=cause)

            if cause == "crashed":
                self.crashes += 1
                if self.crashes > p.max_restarts:
                    self._log_event("give_up", crashes=self.crashes)
                    logger.error("fleet: crash cap (%d) exceeded; giving "
                                 "up", p.max_restarts)
                    return code if code > 0 else 1
                delay = compute_backoff(self.crashes, p.backoff_base,
                                        p.backoff_factor, p.backoff_max)
                if delay > 0:
                    time.sleep(delay)
            else:
                self.preemptions += 1
            for h in range(self.procs):
                self._incarnation[h] += 1
            self.epoch += 1
            self._launch_fleet(reason=cause)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Multi-host fleet supervisor: coordinated restart "
        "barrier + cross-host pool growth around N trainer processes.")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=1)
    ap.add_argument("--checkpoint-dir")
    ap.add_argument("--rendezvous-dir")
    ap.add_argument("--restart-log")
    ap.add_argument("--pool-file")
    ap.add_argument("--watch-pool", action="store_true")
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- trainer command")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    policy = FleetPolicy(
        procs=args.procs, local_devices=args.local_devices,
        checkpoint_dir=args.checkpoint_dir,
        rendezvous_dir=args.rendezvous_dir, restart_log=args.restart_log,
        pool_file=args.pool_file, watch_pool=args.watch_pool,
        max_restarts=args.max_restarts)
    return FleetSupervisor(cmd, policy).run()


if __name__ == "__main__":
    sys.exit(main())
