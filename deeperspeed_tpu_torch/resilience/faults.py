"""Deterministic fault injection for resilience drills and tests.

Counterpart of deeperspeed_tpu/resilience/faults.py, whole: the same
names, keys and ``DS_TPU_FAULTS`` spec parser. In the PyTorch package only
``on_decode_step`` is wired so far (the serving replica worker calls it
once per engine step); the training hooks (``on_step``,
``on_save_file_written``, ``after_commit``) and ``SpotPoolSimulator`` are
here for the resilience slice (ROADMAP item 9), which wires them into the
engine, the checkpoint writer and the supervisor.

A ``FaultPlan`` names WHERE to hurt the process; the ``FaultInjector``
holds the counters that decide WHEN. Faults come from the config block
(``"resilience": {"faults": {...}}``) and/or the ``DS_TPU_FAULTS`` env
var (JSON object, or ``k=v,k=v`` shorthand; env wins key-by-key) so a
drill script can arm a child trainer without touching its config.

Supported faults:

  * ``raise_at_step: N``      — raise ``InjectedFault`` at optimizer
    step N's boundary (generic crash).
  * ``sigkill_at_step: N``    — SIGKILL the process at step N's
    boundary (crash that skips every handler/atexit path).
  * ``sigkill_mid_save: K``   — SIGKILL while the K-th checkpoint file
    of the process's lifetime is being persisted, BEFORE the commit
    rename: the canonical "died mid-save" drill. The committed/latest
    state must be unaffected.
  * ``corrupt_after_save: "truncate" | "bitflip"`` — after a commit,
    damage one payload file in the published tag (simulated disk/bus
    corruption); the manifest check at load must catch it.
  * ``flag_file: path``       — one-shot latch: faults only fire while
    ``path`` does not exist, and the injector creates it just before
    firing. Lets a supervisor restart the SAME command line and have
    the second run proceed cleanly.

Serving-replica faults (fired from ``on_decode_step``, which a serving
replica worker calls once per engine step — the fleet drill's knobs):

  * ``replica_sigkill_at_decode: N`` — SIGKILL the replica process at
    its N-th decode step (mid-stream death; the router must requeue
    the replica's in-flight requests).
  * ``replica_stall_at_decode: N``  — from the N-th decode step on,
    ``on_decode_step`` returns ``"stall"`` and the worker stops
    stepping its engine while still heartbeating (a wedged-but-alive
    replica; the router's progress watchdog must catch it).
  * ``replica_slow_ms: K``          — sleep K ms inside every decode
    step (degraded replica for brownout drills).

Everything is deterministic — counters, not probabilities — so drills
are reproducible bit-for-bit.
"""

import dataclasses
import json
import os
import signal
import time
from typing import List, Optional, Sequence

from ..utils.logging import logger

FAULTS_ENV_VAR = "DS_TPU_FAULTS"

_CORRUPT_MODES = ("truncate", "bitflip")


class InjectedFault(RuntimeError):
    """Raised by ``raise_at_step`` — a reproducible generic crash."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    raise_at_step: Optional[int] = None
    sigkill_at_step: Optional[int] = None
    sigkill_mid_save: Optional[int] = None
    corrupt_after_save: Optional[str] = None
    flag_file: Optional[str] = None
    # serving-replica faults (see module docstring)
    replica_sigkill_at_decode: Optional[int] = None
    replica_stall_at_decode: Optional[int] = None
    replica_slow_ms: Optional[int] = None

    def __post_init__(self):
        for key in ("raise_at_step", "sigkill_at_step", "sigkill_mid_save",
                    "replica_sigkill_at_decode", "replica_stall_at_decode",
                    "replica_slow_ms"):
            v = getattr(self, key)
            if v is not None and int(v) < 1:
                raise ValueError(f"{key} must be >= 1, got {v}")
        if (self.corrupt_after_save is not None
                and self.corrupt_after_save not in _CORRUPT_MODES):
            raise ValueError(
                f"corrupt_after_save must be one of {_CORRUPT_MODES}, got "
                f"{self.corrupt_after_save!r}")

    @property
    def any_armed(self) -> bool:
        return any(getattr(self, f.name) is not None
                   for f in dataclasses.fields(self)
                   if f.name != "flag_file")

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "FaultPlan":
        d = dict(d or {})
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown fault keys {sorted(unknown)}; "
                             f"valid keys: {sorted(known)}")
        return cls(**d)


def _parse_env_spec(spec: str) -> dict:
    spec = spec.strip()
    if not spec:
        return {}
    if spec.startswith("{"):
        return json.loads(spec)
    out = {}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        v = v.strip()
        out[k] = int(v) if v.lstrip("-").isdigit() else v
    return out


def plan_from_config_and_env(config_faults: Optional[dict]) -> FaultPlan:
    merged = dict(config_faults or {})
    env = os.environ.get(FAULTS_ENV_VAR, "")
    if env:
        merged.update(_parse_env_spec(env))
    return FaultPlan.from_dict(merged)


def corrupt_file(path: str, mode: str = "truncate") -> None:
    """Damage one on-disk file in place (test/drill utility)."""
    if mode == "truncate":
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 0))
    elif mode == "bitflip":
        with open(path, "r+b") as f:
            f.seek(max(os.path.getsize(path) // 2 - 1, 0))
            byte = f.read(1) or b"\0"
            f.seek(-len(byte), os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0x40]))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")


def _sigkill() -> None:  # pragma: no cover - kills the test process
    os.kill(os.getpid(), signal.SIGKILL)


class FaultInjector:
    """Counters + trigger points for one process. All hooks are no-ops
    when the plan is empty, so production runs pay one attribute read."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._files_written = 0
        self.armed = plan.any_armed
        if self.armed:
            logger.warning("fault injection ARMED: %s", plan)

    # ---- one-shot latch ------------------------------------------- #

    def _latched_out(self) -> bool:
        """True when the one-shot flag file says faults already fired."""
        return (self.plan.flag_file is not None
                and os.path.exists(self.plan.flag_file))

    def _latch(self) -> None:
        if self.plan.flag_file is not None:
            parent = os.path.dirname(self.plan.flag_file)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(self.plan.flag_file, "w") as f:
                f.write("fired\n")
                f.flush()
                os.fsync(f.fileno())

    # ---- trigger points -------------------------------------------- #

    def on_step(self, global_step: int) -> None:
        """Step-boundary faults (called after each optimizer step)."""
        if not self.armed or self._latched_out():
            return
        if (self.plan.sigkill_at_step is not None
                and global_step == self.plan.sigkill_at_step):
            logger.warning("fault: SIGKILL at step %d", global_step)
            self._latch()
            _sigkill()
        if (self.plan.raise_at_step is not None
                and global_step == self.plan.raise_at_step):
            self._latch()
            raise InjectedFault(f"injected fault at step {global_step}")

    def on_decode_step(self, decode_step: int) -> Optional[str]:
        """Serving-replica trigger point, called by the replica worker
        once per engine step (1-based). Returns ``"stall"`` when the
        worker should stop stepping its engine (but keep heartbeating);
        ``replica_slow_ms`` sleeps here; ``replica_sigkill_at_decode``
        does not return."""
        if not self.armed:
            return None
        if self.plan.replica_slow_ms is not None:
            time.sleep(self.plan.replica_slow_ms / 1000.0)
        if self._latched_out():
            return None
        if (self.plan.replica_sigkill_at_decode is not None
                and decode_step >= self.plan.replica_sigkill_at_decode):
            logger.warning("fault: replica SIGKILL at decode step %d",
                           decode_step)
            self._latch()
            _sigkill()
        if (self.plan.replica_stall_at_decode is not None
                and decode_step >= self.plan.replica_stall_at_decode):
            # the caller keeps the wedge for the life of this process (a
            # stall is not a blip); the flag-file latch only stops a
            # RESTARTED replica from wedging again
            self._latch()
            return "stall"
        return None

    def on_save_file_written(self, path: str) -> None:
        """Called after each checkpoint payload file is written (still in
        the staging dir, before the commit rename)."""
        if not self.armed:
            return
        self._files_written += 1
        if (self.plan.sigkill_mid_save is not None
                and self._files_written >= self.plan.sigkill_mid_save
                and not self._latched_out()):
            logger.warning("fault: SIGKILL mid-save after writing %s", path)
            self._latch()
            _sigkill()

    def after_commit(self, ckpt_dir: str) -> None:
        """Called once per committed tag; corrupts one payload file when
        the plan asks for it (the NEXT load must detect and fall back)."""
        if (not self.armed or self.plan.corrupt_after_save is None
                or self._latched_out()):
            return
        from .manifest import MANIFEST_FILE, COMMITTED_MARKER

        for name in sorted(os.listdir(ckpt_dir)):
            full = os.path.join(ckpt_dir, name)
            if name in (MANIFEST_FILE, COMMITTED_MARKER):
                continue
            if os.path.isfile(full) and os.path.getsize(full) > 0:
                self._latch()
                corrupt_file(full, self.plan.corrupt_after_save)
                logger.warning("fault: %s-corrupted %s",
                               self.plan.corrupt_after_save, full)
                return


# ------------------------------------------------------------------- #
# spot-pool simulation (elastic drills)
# ------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class PoolEvent:
    """One spot-pool episode: the trainer is SIGKILLed at optimizer step
    ``kill_at_step``, after which the surviving pool holds
    ``pool_after`` devices (shrink OR grow — preempted capacity often
    comes back bigger)."""

    kill_at_step: int
    pool_after: int

    def __post_init__(self):
        if int(self.kill_at_step) < 1:
            raise ValueError(
                f"kill_at_step must be >= 1, got {self.kill_at_step}")
        if int(self.pool_after) < 1:
            raise ValueError(
                f"pool_after must be >= 1, got {self.pool_after}")


class SpotPoolSimulator:
    """Deterministic spot-pool driver for elastic fault drills.

    Owns the pool file the supervisor's ``--pool-file`` flag re-reads
    before every launch, and a fixed schedule of :class:`PoolEvent`
    episodes. Drill flow per supervised launch:

      1. ``child_faults()`` -> the ``DS_TPU_FAULTS`` dict arming the
         child's injector with this episode's ``sigkill_at_step``
         (None once the schedule is drained — the final child runs to
         completion).
      2. the child dies; the drill calls ``on_child_exit(rc)``, which
         advances the schedule and rewrites the pool file with the
         surviving device count, so the supervisor's next
         ``_choose_world`` sees the new pool.

    Everything is schedule-driven — no clocks, no probabilities — so a
    drill replays bit-for-bit."""

    def __init__(self, pool_file: str, initial_pool: int,
                 events: Sequence[PoolEvent]):
        self.pool_file = pool_file
        self.events = list(events)
        self.index = 0
        self.transitions: List[dict] = []  # one record per fired episode
        self._write_pool(int(initial_pool))

    @property
    def current_event(self) -> Optional[PoolEvent]:
        return (self.events[self.index]
                if self.index < len(self.events) else None)

    def _write_pool(self, n: int) -> None:
        parent = os.path.dirname(self.pool_file)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = self.pool_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{n}\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.pool_file)

    def read_pool(self) -> int:
        with open(self.pool_file) as f:
            return int(f.read().strip())

    def child_faults(self) -> Optional[dict]:
        """The DS_TPU_FAULTS plan for the current episode's child."""
        ev = self.current_event
        if ev is None:
            return None
        return {"sigkill_at_step": int(ev.kill_at_step)}

    def on_child_exit(self, rc: int) -> Optional[PoolEvent]:
        """Advance the schedule after a child death: rewrite the pool
        file with the episode's surviving device count and record the
        transition. A clean exit (rc == 0) never advances — the run
        outlived the schedule."""
        ev = self.current_event
        if ev is None or rc == 0:
            return None
        self.index += 1
        self._write_pool(int(ev.pool_after))
        self.transitions.append({
            "kill_at_step": int(ev.kill_at_step),
            "pool_after": int(ev.pool_after),
            "exit_code": int(rc),
        })
        logger.info(
            "spot-pool: episode %d fired (kill@%d, exit %d); surviving "
            "pool is %d device(s)", self.index, ev.kill_at_step, rc,
            ev.pool_after)
        return ev
