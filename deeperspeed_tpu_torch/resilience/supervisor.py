"""Auto-resume supervisor: restart crashed/preempted training runs.

Counterpart of deeperspeed_tpu/resilience/supervisor.py, less the
``--simulate-cpu-devices`` drill switch (it exported ``JAX_PLATFORMS`` and
XLA's host device count; a PyTorch child is one rank whatever devices it
sees, so there is nothing to simulate).

::

    python -m deeperspeed_tpu_torch.resilience.supervisor \
        --checkpoint-dir /ckpts/run7 --max-restarts 20 \
        -- python train.py --deepspeed_config ds.json

The supervisor owns the restart policy so the trainer stays a plain
script:

  * exit 0                          -> done, exit 0.
  * the preemption sentinel (86 by  -> restart immediately; preemptions
    default, see config.py)            are routine on spot pools and do
                                       NOT count against the crash cap
                                       or grow the backoff.
  * anything else (crash, SIGKILL,  -> restart after exponential
    OOM, infra flake)                  backoff (base * factor^n, capped)
                                       until ``--max-restarts`` crashes.

Before each restart the supervisor discovers the newest VALID tag in
``--checkpoint-dir`` (manifest-verified; torn tags from the fatal
instant are skipped) and exports it as ``DS_TPU_RESUME_TAG`` /
``DS_TPU_RESUME_DIR`` — a trainer can simply call
``engine.load_checkpoint(os.environ["DS_TPU_RESUME_DIR"])`` at start,
and the latest-pointer fallback logic does the rest. ``DS_TPU_RESTART_
COUNT`` counts total restarts.

Elastic resume: with ``--elastic-config ds.json`` the supervisor reads
the config's ``elasticity`` block and exports the valid accelerator
counts as ``DS_TPU_ELASTIC_WORLD_SIZES``: a restart may land on a
different device count (the pool shrank or grew); elasticity picks the
batch geometry for whatever is available, and the engine's load carries
the checkpoint onto the new world (resilience/reshard.py).

The run loop is dependency-injectable (``run_fn``/``sleep_fn``) so the
backoff policy is unit-testable without subprocesses.
"""

import argparse
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

from ..monitor.runctx import (
    INCARNATION_ENV,
    ROLE_ENV,
    RUN_ID_ENV,
    ensure_run_id,
)
from ..utils.logging import logger
from .config import PREEMPTION_EXIT_CODE_DEFAULT
from .manifest import find_latest_valid_tag, tag_step

RESUME_TAG_ENV = "DS_TPU_RESUME_TAG"
RESUME_DIR_ENV = "DS_TPU_RESUME_DIR"
RESTART_COUNT_ENV = "DS_TPU_RESTART_COUNT"
RESTART_REASON_ENV = "DS_TPU_RESTART_REASON"
ELASTIC_WORLD_SIZES_ENV = "DS_TPU_ELASTIC_WORLD_SIZES"
WORLD_SIZE_ENV = "DS_TPU_WORLD_SIZE"
# exported so the child's lifecycle re-mesh hook re-reads the SAME pool
# file the supervisor watches when the re-mesh signal arrives
POOL_FILE_ENV = "DS_TPU_POOL_FILE"


def compute_backoff(failures: int, base: float, factor: float,
                    cap: float, jitter: float = 0.0,
                    rand: Optional[Callable[[], float]] = None) -> float:
    """Delay before restart number ``failures`` (1-based): base *
    factor^(failures-1), capped. ``jitter`` adds a bounded random
    fraction (delay * U[0, jitter]) so a fleet of supervisors killed by
    the same pool event does not restart in lockstep; the jittered delay
    still respects ``cap``. Pure (given ``rand``) so the policy is
    testable; jitter defaults off."""
    if failures <= 0:
        return 0.0
    delay = min(cap, base * factor ** (failures - 1))
    if jitter > 0.0:
        u = (rand or random.random)()
        delay = min(cap, delay * (1.0 + jitter * u))
    return delay


@dataclass
class SupervisorPolicy:
    max_restarts: int = 10  # crash restarts; preemptions are free
    backoff_base: float = 1.0
    backoff_factor: float = 2.0
    backoff_max: float = 60.0
    backoff_jitter: float = 0.0  # bounded fraction; see compute_backoff
    preempt_exit_code: int = PREEMPTION_EXIT_CODE_DEFAULT
    checkpoint_dir: Optional[str] = None
    elastic_config: Optional[str] = None
    verify_checksums: bool = True
    # elastic fleet: a file holding the surviving pool's device count,
    # re-read before every (re)start; the supervisor picks the largest
    # admissible elastic world size that fits and exports it
    pool_file: Optional[str] = None
    # lifecycle live re-mesh: watch the pool file WHILE the child runs
    # and signal the running trainer (remesh_signal) instead of waiting
    # for the next relaunch — the child's lifecycle.RemeshHook flips the
    # topology in process. Writes are debounced (a pool update must hold
    # still for pool_debounce_s) so an editor's write-rename or a burst
    # of shrink events resolves to one signal.
    watch_pool: bool = False
    pool_poll_interval_s: float = 0.25
    pool_debounce_s: float = 0.5
    remesh_signal: int = signal.SIGUSR1
    restart_log: Optional[str] = None  # JSONL transition record


class Supervisor:
    def __init__(self, cmd: Sequence[str], policy: SupervisorPolicy,
                 run_fn: Optional[Callable[[List[str], dict], int]] = None,
                 sleep_fn: Callable[[float], None] = time.sleep):
        if not cmd:
            raise ValueError("supervisor needs a command to run")
        self.cmd = list(cmd)
        self.policy = policy
        self._run_fn = run_fn or self._run_subprocess
        self._sleep_fn = sleep_fn
        self.restarts = 0  # total child launches minus one
        self.crashes = 0  # non-preemption failures (drives backoff/cap)
        self.history: List[int] = []  # child return codes, in order
        self.world_history: List[Optional[int]] = []  # world per launch
        self.remesh_signals = 0  # live re-mesh signals sent to children
        self._last_reason: Optional[str] = None  # why the NEXT launch is one
        # run-scoped observability: every incarnation of this run shares
        # one run_id; the child's role/incarnation label its trace lane
        self.run_id = ensure_run_id()

    def _run_subprocess(self, cmd: List[str], env: dict) -> int:
        """Default run_fn: Popen (not call) so the pool watcher can
        signal the RUNNING child for a live re-mesh."""
        proc = subprocess.Popen(cmd, env=env)
        stop = watcher = None
        if self.policy.watch_pool and self.policy.pool_file:
            stop = threading.Event()
            watcher = threading.Thread(
                target=self._watch_pool, args=(proc, stop), daemon=True)
            watcher.start()
        try:
            return proc.wait()
        finally:
            if stop is not None:
                stop.set()
                watcher.join(timeout=5.0)

    def _read_pool(self) -> Optional[int]:
        try:
            with open(self.policy.pool_file) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def _watch_pool(self, proc: "subprocess.Popen", stop: threading.Event
                    ) -> None:
        """Poll the pool file while the child runs; a debounced value
        change sends the re-mesh signal and records a ``remesh``
        transition (distinct from crash/preemption relaunches) in the
        restart log."""
        pol = self.policy
        last = self._read_pool()
        pending_val: Optional[int] = None
        pending_since = 0.0
        while not stop.wait(pol.pool_poll_interval_s):
            val = self._read_pool()
            if val is None or val == last:
                pending_val = None
                continue
            now = time.time()
            if val != pending_val:
                pending_val, pending_since = val, now  # (re)start debounce
                continue
            if now - pending_since < pol.pool_debounce_s:
                continue
            last, pending_val = val, None
            try:
                proc.send_signal(pol.remesh_signal)
            except OSError:
                return  # child already gone; run() handles the exit
            self.remesh_signals += 1
            logger.info(
                "supervisor: pool file now %d — sent signal %d for a "
                "live re-mesh (no restart)", val, int(pol.remesh_signal))
            self._log_event({"event": "remesh", "reason": "pool_change",
                             "pool": val,
                             "signal": int(pol.remesh_signal)})

    # ------------------------------------------------------------------ #

    def _child_env(self) -> dict:
        env = dict(os.environ)
        env[RESTART_COUNT_ENV] = str(self.restarts)
        env[RUN_ID_ENV] = self.run_id
        env.setdefault(ROLE_ENV, "trainer")
        env[INCARNATION_ENV] = str(self.restarts)
        if self._last_reason is not None:
            env[RESTART_REASON_ENV] = self._last_reason
        pol = self.policy
        resume_tag = None
        if pol.checkpoint_dir:
            tag = find_latest_valid_tag(
                pol.checkpoint_dir, verify_checksums=pol.verify_checksums)
            if tag is not None:
                resume_tag = tag
                env[RESUME_TAG_ENV] = tag
                env[RESUME_DIR_ENV] = pol.checkpoint_dir
                step = tag_step(tag)
                logger.info(
                    "supervisor: newest valid checkpoint is %r%s",
                    tag, f" (step {step})" if step is not None else "")
            else:
                env.pop(RESUME_TAG_ENV, None)
                env.pop(RESUME_DIR_ENV, None)
                if self.restarts:
                    logger.warning(
                        "supervisor: no valid checkpoint in %s; the "
                        "restart begins from scratch", pol.checkpoint_dir)
        sizes: List[int] = []
        if pol.elastic_config:
            sizes = self._elastic_world_sizes(pol.elastic_config)
            if sizes:
                env[ELASTIC_WORLD_SIZES_ENV] = ",".join(map(str, sizes))
                logger.info("supervisor: elastic world sizes %s", sizes)
        if pol.pool_file:
            # the child's lifecycle re-mesh hook reads the same pool file
            env[POOL_FILE_ENV] = pol.pool_file
        world = self._choose_world(sizes)
        self.world_history.append(world)
        if world is not None:
            env[WORLD_SIZE_ENV] = str(world)
        self._log_event({"event": "launch", "restart": self.restarts,
                         "reason": self._last_reason or "initial",
                         "world_size": world, "resume_tag": resume_tag})
        return env

    def _choose_world(self, sizes: List[int]) -> Optional[int]:
        """The largest admissible world size for the surviving pool:
        re-reads ``pool_file`` (an integer device count) before every
        launch, then picks ``max(s in sizes if s <= pool)``. Without a
        pool file the topology is whatever the launcher provides and the
        child self-selects via DS_TPU_ELASTIC_WORLD_SIZES."""
        pol = self.policy
        if pol.pool_file is None:
            return None
        try:
            with open(pol.pool_file) as f:
                pool = int(f.read().strip())
        except (OSError, ValueError) as e:
            logger.warning("supervisor: unreadable pool file %s (%s); "
                           "leaving world size unset", pol.pool_file, e)
            return None
        admissible = [s for s in sizes if s <= pool]
        if not admissible:
            logger.error(
                "supervisor: no admissible elastic world size fits the "
                "surviving pool of %d (valid: %s); launching without "
                "%s — the child will fail fast and the backoff retries "
                "while the pool recovers", pool, sizes, WORLD_SIZE_ENV)
            return None
        world = max(admissible)
        if pool != world:
            logger.info(
                "supervisor: pool of %d devices -> elastic world size %d",
                pool, world)
        return world

    def _log_event(self, record: dict) -> None:
        """Append one transition record to the restart JSONL log."""
        if self.policy.restart_log is None:
            return
        record = {"ts": time.time(), "run_id": self.run_id, **record}
        try:
            parent = os.path.dirname(self.policy.restart_log)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(self.policy.restart_log, "a") as f:
                f.write(json.dumps(record) + "\n")
        except OSError as e:  # advisory — never kill the run loop
            logger.warning("supervisor: could not append to restart log "
                           "%s: %s", self.policy.restart_log, e)

    @staticmethod
    def _elastic_world_sizes(config_path: str) -> List[int]:
        try:
            with open(config_path) as f:
                cfg = json.load(f)
            from ..elasticity import elastic_world_sizes

            return elastic_world_sizes(cfg)
        except Exception as e:  # noqa: BLE001 - advisory only
            logger.warning("supervisor: could not compute elastic world "
                           "sizes from %s: %s", config_path, e)
            return []

    # ------------------------------------------------------------------ #

    def run(self) -> int:
        pol = self.policy
        while True:
            rc = self._run_fn(self.cmd, self._child_env())
            self.history.append(rc)
            if rc == 0:
                logger.info("supervisor: run finished cleanly after %d "
                            "restart(s)", self.restarts)
                self._log_event({"event": "exit", "code": 0,
                                 "reason": "done",
                                 "restarts": self.restarts})
                return 0
            preempted = rc == pol.preempt_exit_code
            if preempted:
                delay = 0.0
                self._last_reason = "preemption"
                logger.warning(
                    "supervisor: child preempted (exit %d); restarting "
                    "immediately", rc)
            else:
                self.crashes += 1
                self._last_reason = "crash"
                if self.crashes > pol.max_restarts:
                    logger.error(
                        "supervisor: giving up after %d crash(es) "
                        "(max_restarts=%d); last exit code %d",
                        self.crashes, pol.max_restarts, rc)
                    self._log_event({"event": "exit", "code": rc,
                                     "reason": "gave_up",
                                     "crashes": self.crashes})
                    return rc
                delay = compute_backoff(
                    self.crashes, pol.backoff_base, pol.backoff_factor,
                    pol.backoff_max, pol.backoff_jitter)
                logger.warning(
                    "supervisor: child crashed (exit %d, crash %d/%d); "
                    "restarting in %.1fs", rc, self.crashes,
                    pol.max_restarts, delay)
            self._log_event({"event": "exit", "code": rc,
                             "reason": self._last_reason,
                             "crashes": self.crashes, "delay": delay})
            if delay > 0:
                self._sleep_fn(delay)
            self.restarts += 1


# --------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------- #


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m deeperspeed_tpu_torch.resilience.supervisor",
        description="Restart a training command on crash/preemption, "
                    "resuming from the newest valid checkpoint.")
    p.add_argument("--checkpoint-dir", default=None,
                   help="where the trainer saves; scanned for the newest "
                        "valid tag before each restart")
    p.add_argument("--max-restarts", type=int, default=10,
                   help="crash-restart cap (preemptions do not count)")
    p.add_argument("--backoff-base", type=float, default=1.0)
    p.add_argument("--backoff-factor", type=float, default=2.0)
    p.add_argument("--backoff-max", type=float, default=60.0)
    p.add_argument("--backoff-jitter", type=float, default=0.0,
                   help="bounded random backoff fraction (e.g. 0.5 adds "
                        "up to +50%%) so fleets do not restart in "
                        "lockstep")
    p.add_argument("--preempt-exit-code", type=int,
                   default=PREEMPTION_EXIT_CODE_DEFAULT,
                   help="sentinel exit code the preemption guard uses")
    p.add_argument("--elastic-config", default=None, metavar="DS_JSON",
                   help="master config with an elasticity block; exports "
                        "the valid world sizes to the child")
    p.add_argument("--pool-file", default=None, metavar="PATH",
                   help="file holding the surviving pool's device count; "
                        "re-read before every launch to pick the largest "
                        "admissible elastic world size")
    p.add_argument("--watch-pool", action="store_true",
                   help="watch --pool-file while the child runs and send "
                        "--remesh-signal on a (debounced) change so the "
                        "trainer re-meshes live instead of restarting")
    p.add_argument("--pool-debounce", type=float, default=0.5,
                   metavar="S", help="pool-file writes must hold still "
                                     "this long before the signal fires")
    p.add_argument("--pool-poll-interval", type=float, default=0.25,
                   metavar="S", help="pool-file polling period")
    p.add_argument("--remesh-signal", type=int,
                   default=int(signal.SIGUSR1),
                   help="signal number sent to the running child on a "
                        "pool change (default SIGUSR1)")
    p.add_argument("--restart-log", default=None, metavar="JSONL",
                   help="append one JSON record per launch/exit "
                        "transition (reason, world size, resume tag)")
    p.add_argument("--no-verify", action="store_true",
                   help="skip manifest checksum verification during "
                        "checkpoint discovery (size/presence only)")
    p.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="-- followed by the training command")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    cmd = list(args.cmd)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        build_parser().error("no training command given (put it after --)")
    policy = SupervisorPolicy(
        max_restarts=args.max_restarts,
        backoff_base=args.backoff_base,
        backoff_factor=args.backoff_factor,
        backoff_max=args.backoff_max,
        backoff_jitter=args.backoff_jitter,
        preempt_exit_code=args.preempt_exit_code,
        checkpoint_dir=args.checkpoint_dir,
        elastic_config=args.elastic_config,
        verify_checksums=not args.no_verify,
        pool_file=args.pool_file,
        watch_pool=args.watch_pool,
        pool_poll_interval_s=args.pool_poll_interval,
        pool_debounce_s=args.pool_debounce,
        remesh_signal=args.remesh_signal,
        restart_log=args.restart_log,
    )
    return Supervisor(cmd, policy).run()


if __name__ == "__main__":
    sys.exit(main())
