"""Run-scoped trace context: who is emitting, in which incarnation.

Counterpart of deeperspeed_tpu/monitor/runctx.py, the same names and
environment variables, so launchers of either package speak one
language.

A *run* is one logical training/serving job across every process it
spawns and every restart it survives. Three environment variables carry
the context, chosen so the existing process trees propagate them for
free (the supervisor's child env, the fleet's replica env, plain
``subprocess`` inheritance):

  * ``DS_TPU_RUN_ID``       — one id per run, minted once by whoever is
    at the top of the tree (supervisor, drill script, or the first
    ``ensure_run_id()`` caller) and inherited by everything below.
  * ``DS_TPU_ROLE``         — what this process is: ``trainer``,
    ``router``, ``replica-r1``, ... Free-form, but stable across
    restarts of the same logical process.
  * ``DS_TPU_INCARNATION``  — how many times this logical process has
    been (re)launched; the supervisor and the fleet stamp it so a
    killed replica's events are distinguishable from its replacement's.

``current()`` is cheap (three env reads) and never raises: outside any
run the context is ``run_id=None, role="main", incarnation=0``. The
tracer stamps the context into the trace footer and process metadata,
the flight recorder into its header, and the replica protocol into its
``ready`` event, so the aggregator can label per-process lanes and join
a rid's journey across processes and incarnations.

``estimate_clock_offset`` is the handshake math the aggregator's
cross-process timeline alignment rests on: an NTP-style symmetric-delay
estimate from one request/response round trip.
"""

import dataclasses
import os
import time
import uuid
from typing import Dict, Optional

__all__ = [
    "RUN_ID_ENV",
    "ROLE_ENV",
    "INCARNATION_ENV",
    "RunContext",
    "current",
    "ensure_run_id",
    "child_env",
    "host_role",
    "clock_anchor",
    "estimate_clock_offset",
]

RUN_ID_ENV = "DS_TPU_RUN_ID"
ROLE_ENV = "DS_TPU_ROLE"
INCARNATION_ENV = "DS_TPU_INCARNATION"


@dataclasses.dataclass(frozen=True)
class RunContext:
    run_id: Optional[str]
    role: str = "main"
    incarnation: int = 0

    def as_args(self) -> Dict[str, object]:
        """The stamp events/headers carry (run_id normalized to "")."""
        return {"run_id": self.run_id or "", "role": self.role,
                "incarnation": self.incarnation}


def current() -> RunContext:
    """The process's run context from the environment; never raises."""
    try:
        inc = int(os.environ.get(INCARNATION_ENV, "0"))
    except ValueError:
        inc = 0
    return RunContext(
        run_id=os.environ.get(RUN_ID_ENV) or None,
        role=os.environ.get(ROLE_ENV, "main"),
        incarnation=inc,
    )


def ensure_run_id() -> str:
    """Return the run id, minting one (and exporting it, so child
    processes inherit it) when this process is the top of the tree."""
    rid = os.environ.get(RUN_ID_ENV)
    if not rid:
        rid = f"run-{uuid.uuid4().hex[:12]}"
        os.environ[RUN_ID_ENV] = rid
    return rid


def child_env(role: str, incarnation: int,
              base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Env overlay for a child process: same run, its own role and
    incarnation. ``base`` defaults to a copy of os.environ."""
    env = dict(os.environ if base is None else base)
    env[RUN_ID_ENV] = ensure_run_id()
    env[ROLE_ENV] = role
    env[INCARNATION_ENV] = str(int(incarnation))
    return env


def host_role(base: str, process_id: int, process_count: int) -> str:
    """The per-host role lane of a multi-process run: ``base.h<proc>``
    when the run spans processes, ``base`` unchanged when it doesn't.
    Because obs files are named ``<role>.i<inc>.*``, this suffix is what
    gives every host its own trace/flight files with zero plumbing —
    and the aggregator's offsets sidecar keys on the same string."""
    if int(process_count) <= 1:
        return base
    return f"{base}.h{int(process_id)}"


def clock_anchor() -> Dict[str, float]:
    """A (wall, perf) clock pair sampled back-to-back. The tracer's
    timestamps are perf_counter-based (monotonic, process-local); the
    anchor lets the aggregator rebase them onto the shared wall clock:
    ``wall_us = ts + (wall - perf) * 1e6``."""
    return {"wall": time.time(), "perf": time.perf_counter()}


def estimate_clock_offset(t_send: float, t_remote: float,
                          t_recv: float) -> float:
    """NTP-style one-round-trip offset estimate: how far the remote
    wall clock is AHEAD of the local one, assuming symmetric transit.
    The local side records ``t_send`` before the request and ``t_recv``
    after the response; the remote stamps ``t_remote`` in between. The
    error is bounded by half the round-trip time."""
    return t_remote - (t_send + t_recv) / 2.0
