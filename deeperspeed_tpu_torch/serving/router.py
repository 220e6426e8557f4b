"""Fleet front-end: admission control, deadlines, health-checked
dispatch, and bounded failover over N replica workers (serving/fleet.py).

Counterpart of deeperspeed_tpu/serving/router.py, whole: the same
policies, names, metrics and trace instants. The router is pure host
Python; the replicas it drives hold the engines. One departure: a
replica's decode-progress window opens when it is given work while idle
(the reference also counts the idle time before, so a replica idle for
``progress_timeout_s`` is marked stalled as soon as it gets a request:
after one replica wedges, the healthy idle replicas that take its
requeued requests are marked stalled and restarted in turn, and
requests run past their deadlines).

The router is the layer that turns "a replica died" into "the client
never noticed". Requests flow through four gates:

  1. **Admission** — ``submit()`` either accepts or raises ``ShedError``
     with a retry-after hint. Two caps, both explicit: accepted-but-
     unfinished depth (``max_queue_depth``) and an in-flight token
     budget (``max_inflight_tokens``). The router NEVER queues
     unboundedly; overload is shed at the door, visible in
     ``serving_shed_total`` and ``serving/shed`` trace instants.
  2. **Deadlines** — wall-clock, enforced at the router against its own
     clock (``default_deadline_s`` or a per-request override). Distinct
     from the engine's progress-based ``request_timeout_s``: the engine
     protects itself from wedged requests, the router keeps promises to
     clients.
  3. **Health-checked dispatch** — each step the router runs two
     watchdogs per replica: a heartbeat age check (process/thread dead)
     and a decode-progress check (alive but wedged — the stall fault).
     An unhealthy replica's in-flight requests are requeued by rid and
     re-dispatched to healthy replicas with bounded retries and
     exponential backoff (``resilience.supervisor.compute_backoff``).
     Because a request's sampling seed rides in its dispatch spec (and
     every replica holds identical weights), the retried request
     regenerates token-identical output — greedy trivially, sampled via
     the per-(seed, position) key derivation in serving/engine.py.
  4. **Lifecycle** — ``drain_replica`` (stop dispatching, finish
     in-flight, requeue leftovers without retry penalty),
     ``rolling_restart`` (drain + restart one replica at a time; the
     fleet keeps serving), and supervisor-style crash restarts capped
     by ``replica_max_restarts``.

Terminal outcomes per accepted rid land in ``results()``; the invariant
the kill drill audits is that every accepted rid reaches one — finished
(length/eos), deadline ``timeout``, or ``failed`` after the retry
budget. Nothing is silently lost.
"""

import dataclasses
import threading
import time
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from ..monitor import get_monitor
from ..monitor.tracer import trace_instant, trace_span
from ..resilience.supervisor import compute_backoff
from .config import RouterConfig
from .engine import derive_request_seed
from .fleet import ReplicaUnavailableError
from .metrics import FleetMetrics
from .scheduler import FINISH_FAILED, FINISH_TIMEOUT

__all__ = ["ShedError", "FleetRouter", "RouterRequest"]

_TRACE_LANE = "router"


class ShedError(RuntimeError):
    """Structured admission rejection: the fleet is at capacity and the
    client should retry after ``retry_after_s`` rather than pile on."""

    def __init__(self, rid: str, reason: str, retry_after_s: float):
        super().__init__(
            f"request {rid} shed ({reason}); retry after "
            f"{retry_after_s:.3f}s")
        self.rid = rid
        self.reason = reason
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class RouterRequest:
    """Router-side record: the authoritative copy of a request. Survives
    any number of replica deaths — replicas only ever hold a copy."""

    rid: str
    spec: dict                       # the dispatch spec (incl. seed)
    cost_tokens: int                 # admission token-budget charge
    submit_t: float
    deadline_t: Optional[float]
    # crc32 of the prompt's head tokens; same-prefix requests share it,
    # and dispatch prefers the replica whose radix cache is warm for it
    prefix_key: Optional[int] = None
    attempts: int = 0                # dispatches so far
    not_before: float = 0.0          # backoff gate for re-dispatch
    assigned: Optional[str] = None   # replica name, while in flight
    # weight-version pin: set from the FIRST replica that serves the
    # request; failover retries only target replicas on the same
    # version, so the regenerated stream is token-identical. None =
    # unpinned (versionless replicas, or re-pinned after the version
    # lost its last replica).
    version: Optional[int] = None
    repins: int = 0                  # version pins abandoned (rare)
    first_t: Optional[float] = None
    finish_t: Optional[float] = None
    tokens: Optional[List[int]] = None
    finish_reason: Optional[str] = None

    @property
    def done(self) -> bool:
        return self.finish_reason is not None


class _ReplicaState:
    """Router-side view of one replica: health verdict, progress
    tracker, restart budget."""

    def __init__(self, replica, now: float):
        self.replica = replica
        self.healthy = True
        self.assigned: set = set()           # rids dispatched, unfinished
        self.last_progress = replica.progress
        self.progress_t = now                # when progress last moved
        self.failure_restarts = 0
        self.restart_at: Optional[float] = None   # pending crash restart

    @property
    def name(self) -> str:
        return self.replica.name


class FleetRouter:
    def __init__(self, replicas: Sequence[object],
                 rcfg: Optional[RouterConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None, base_seed: int = 0, slo=None):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        self.rcfg = rcfg or RouterConfig()
        self.clock = clock
        self.base_seed = base_seed
        now = clock()
        self._states = [_ReplicaState(r, now) for r in replicas]
        self._reqs: Dict[str, RouterRequest] = {}
        self._pending: "deque[str]" = deque()
        self._inflight_tokens = 0
        self._next_rid = 0
        # prefix_key -> replica name that last served it (warm cache)
        self._affinity: Dict[int, str] = {}
        if registry is None:
            mon = get_monitor()
            registry = mon.registry if mon is not None else None
        # slo: an SLOConfig (serving/config.py) — router-observed TTFT
        # and E2E latencies feed its burn-rate gauges
        self.metrics = FleetMetrics(clock=clock, registry=registry,
                                    slo=slo)

    # -- client surface ----------------------------------------------

    def submit(self, prompt: Sequence[int],
               max_new_tokens: Optional[int] = None,
               temperature: float = 0.0,
               request_id: Optional[str] = None,
               deadline_s: Optional[float] = None,
               seed: Optional[int] = None) -> str:
        """Admit or shed. Raises ``ShedError`` at capacity; otherwise
        returns the rid (dispatch happens on the next ``step()``)."""
        rid = request_id if request_id is not None \
            else f"fleet-{self._next_rid}"
        self._next_rid += 1
        if rid in self._reqs:
            raise ValueError(f"duplicate request id {rid!r}")
        now = self.clock()
        depth = self._accepted_unfinished()
        if depth >= self.rcfg.max_queue_depth:
            self._shed(rid, "queue_depth", depth)
        cost = len(prompt) + int(max_new_tokens or 0)
        if (self.rcfg.max_inflight_tokens is not None
                and self._inflight_tokens + cost
                > self.rcfg.max_inflight_tokens):
            self._shed(rid, "token_budget", depth)
        if deadline_s is None:
            deadline_s = self.rcfg.default_deadline_s
        # the seed is fixed HERE, not on the replica, so a failover
        # re-dispatch replays the identical sampling stream
        if seed is None:
            seed = derive_request_seed(self.base_seed, rid)
        spec = {"rid": rid, "prompt": list(int(t) for t in prompt),
                "max_new_tokens": max_new_tokens,
                "temperature": float(temperature), "seed": int(seed)}
        prefix_key = None
        if self.rcfg.prefix_affinity:
            head = spec["prompt"][:self.rcfg.affinity_prefix_len]
            prefix_key = zlib.crc32(
                ",".join(str(t) for t in head).encode("ascii"))
        self._reqs[rid] = RouterRequest(
            rid=rid, spec=spec, cost_tokens=cost, submit_t=now,
            deadline_t=(now + deadline_s) if deadline_s else None,
            prefix_key=prefix_key)
        self._pending.append(rid)
        self._inflight_tokens += cost
        self.metrics.record_accept()
        # router-side clock-zero for the request ledger (the engine-side
        # counterpart is req/submit, emitted at replica admission)
        trace_instant("req/accept", _TRACE_LANE, rid=rid,
                      cost_tokens=cost)
        return rid

    def result(self, rid: str) -> RouterRequest:
        return self._reqs[rid]

    def results(self) -> Dict[str, RouterRequest]:
        return dict(self._reqs)

    def outcomes(self) -> Dict[str, str]:
        """rid -> terminal reason, for finished requests only. The kill
        drill's zero-loss audit checks every accepted rid shows up."""
        return {rid: r.finish_reason for rid, r in self._reqs.items()
                if r.done}

    def unfinished(self) -> List[str]:
        return [rid for rid, r in self._reqs.items() if not r.done]

    # -- drive loop --------------------------------------------------

    def step(self) -> None:
        """One router turn: collect events, run watchdogs, enforce
        deadlines, dispatch. Non-blocking; call from a loop or use
        ``run_until_idle``."""
        now = self.clock()
        self._collect_events(now)
        self._check_health(now)
        self._enforce_deadlines(now)
        self._dispatch(now)
        self._export_gauges()

    def run_until_idle(self, timeout_s: float = 120.0) -> Dict[str, str]:
        """Step until every accepted request is terminal (or timeout —
        then remaining requests fail with ``failed`` so the audit still
        sees a terminal outcome, and the timeout is loud in metrics)."""
        deadline = time.monotonic() + timeout_s
        while self.unfinished():
            if time.monotonic() > deadline:
                for rid in self.unfinished():
                    self._finish_local(
                        self._reqs[rid], FINISH_FAILED, self.clock(),
                        note="router run_until_idle timeout")
                break
            self.step()
            time.sleep(self.rcfg.poll_interval_s)
        return self.outcomes()

    # -- lifecycle ---------------------------------------------------

    def drain_replica(self, name: str, timeout_s: float = 60.0) -> None:
        """Graceful: stop dispatching to the replica, let it finish its
        in-flight work, requeue whatever remains WITHOUT charging the
        retry budget (draining is not the request's fault)."""
        st = self._state(name)
        st.healthy = False   # no new dispatches
        with trace_span("serving/drain_replica", _TRACE_LANE,
                        replica=name):
            leftovers = st.replica.drain(timeout_s)
            self._collect_events(self.clock())
            for rid in list(st.assigned):
                if rid in leftovers or not self._reqs[rid].done:
                    self._requeue(self._reqs[rid], penalize=False)
            st.assigned.clear()

    def rolling_restart(self, timeout_s: float = 120.0) -> None:
        """Restart every replica one at a time; the rest of the fleet
        keeps serving throughout. Loses nothing: drained leftovers are
        requeued, and dispatch only ever targets healthy replicas."""
        for st in self._states:
            self.drain_replica(st.name, timeout_s)
            with trace_span("serving/rolling_restart", _TRACE_LANE,
                            replica=st.name):
                st.replica.restart()
            self._mark_restarted(st)

    def rolling_update(self, version: int, weights: Optional[dict] = None,
                       timeout_s: float = 120.0) -> None:
        """Roll the fleet onto a new weight version, one replica at a
        time. During the transition the fleet is MIXED-version: new
        requests pin to whichever version first serves them, and
        failover retries stay inside the pinned version — no request
        ever sees tokens from two weight sets. ``weights`` is the
        replica-side load payload (e.g. ``{"load_dir": ..., "tag":
        ...}``); replicas without a ``set_weights`` method are restarted
        as-is (version label only)."""
        for st in self._states:
            self.drain_replica(st.name, timeout_s)
            with trace_span("serving/rolling_restart", _TRACE_LANE,
                            replica=st.name):
                set_weights = getattr(st.replica, "set_weights", None)
                if set_weights is not None:
                    set_weights(weights, version)
                elif hasattr(st.replica, "version"):
                    st.replica.version = version
                st.replica.restart()
            self._mark_restarted(st)
            trace_instant("lifecycle/rollout", "lifecycle",
                          replica=st.name, version=int(version))
        if self.metrics.registry is not None:
            self.metrics.registry.counter(
                "lifecycle_rollout_total",
                "replica weight-version rollouts completed").inc()
            self.metrics.registry.gauge(
                "lifecycle_fleet_version",
                "newest weight version the fleet was rolled onto",
            ).set(float(version))

    def shutdown(self) -> None:
        """Stop every replica, side by side: a subprocess replica waits
        for its process to exit."""
        def stop(replica):
            try:
                replica.stop()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass

        threads = [threading.Thread(target=stop, args=(st.replica,))
                   for st in self._states]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    # -- internals ---------------------------------------------------

    def _state(self, name: str) -> _ReplicaState:
        for st in self._states:
            if st.name == name:
                return st
        raise KeyError(f"no replica named {name!r}")

    def _accepted_unfinished(self) -> int:
        return sum(1 for r in self._reqs.values() if not r.done)

    def _shed(self, rid: str, reason: str, depth: int) -> None:
        # hint grows with how far over capacity we are, so retrying
        # clients naturally spread out instead of hammering in sync
        retry_after_s = round(
            self.rcfg.poll_interval_s
            * max(1.0, depth / max(1, len(self._states))), 3)
        self.metrics.record_shed()
        trace_instant("serving/shed", _TRACE_LANE, rid=rid,
                      retry_after_s=retry_after_s)
        raise ShedError(rid, reason, retry_after_s)

    def _collect_events(self, now: float) -> None:
        for st in self._states:
            for ev in st.replica.poll_events():
                rid = ev.get("rid")
                rec = self._reqs.get(rid)
                if rec is None:
                    continue
                kind = ev.get("ev")
                if kind == "first":
                    if rec.first_t is None and not rec.done:
                        rec.first_t = now
                        self.metrics.record_ttft(now - rec.submit_t)
                elif kind == "fin":
                    if not rec.done:
                        rec.tokens = list(ev.get("tokens") or [])
                        self._finish_local(rec, ev.get("reason"), now)
                    st.assigned.discard(rid)
                elif kind == "err":
                    # submit bounced (draining race, bad spec): treat
                    # as a dispatch failure and retry elsewhere
                    st.assigned.discard(rid)
                    if not rec.done:
                        self._requeue(rec, penalize=True)

    def _check_health(self, now: float) -> None:
        for st in self._states:
            if st.restart_at is not None:
                if now >= st.restart_at:
                    self._crash_restart(st)
                continue
            if not st.healthy:
                continue   # draining — lifecycle owns this replica
            rep = st.replica
            if rep.progress != st.last_progress:
                st.last_progress = rep.progress
                st.progress_t = now
            cause = None
            if not rep.alive:
                cause = "dead"
            elif now - rep.heartbeat_t > self.rcfg.heartbeat_timeout_s:
                cause = "heartbeat"
            elif (st.assigned
                  and now - st.progress_t > self.rcfg.progress_timeout_s):
                cause = "stalled"
            if cause is not None:
                self._mark_down(st, cause, now)

    def _mark_down(self, st: _ReplicaState, cause: str,
                   now: float) -> None:
        st.healthy = False
        inflight = sorted(st.assigned)
        self.metrics.record_replica_down(st.name, cause, len(inflight))
        trace_instant("serving/replica_down", _TRACE_LANE,
                      replica=st.name, cause=cause,
                      inflight=len(inflight))
        # a stalled/heartbeat-lost replica may still hold the process —
        # kill it so the restart starts from a clean slate
        try:
            st.replica.kill()
        except Exception:  # noqa: BLE001 - it may already be gone
            pass
        for rid in inflight:
            rec = self._reqs[rid]
            if not rec.done:
                self._requeue(rec, penalize=True)
        st.assigned.clear()
        if (self.rcfg.replica_restart
                and st.failure_restarts < self.rcfg.replica_max_restarts):
            st.failure_restarts += 1
            delay = compute_backoff(
                st.failure_restarts, self.rcfg.retry_backoff_base_s,
                2.0, self.rcfg.retry_backoff_max_s)
            st.restart_at = now + delay
        # else: the replica stays down; dispatch routes around it

    def _crash_restart(self, st: _ReplicaState) -> None:
        with trace_span("serving/replica_restart", _TRACE_LANE,
                        replica=st.name):
            try:
                st.replica.restart()
            except Exception:  # noqa: BLE001 - retry on a later step
                if st.failure_restarts < self.rcfg.replica_max_restarts:
                    st.failure_restarts += 1
                    st.restart_at = self.clock() + compute_backoff(
                        st.failure_restarts,
                        self.rcfg.retry_backoff_base_s, 2.0,
                        self.rcfg.retry_backoff_max_s)
                else:
                    st.restart_at = None
                return
        self._mark_restarted(st)

    def _mark_restarted(self, st: _ReplicaState) -> None:
        now = self.clock()
        st.healthy = True
        st.restart_at = None
        st.last_progress = st.replica.progress
        st.progress_t = now

    def _requeue(self, rec: RouterRequest, penalize: bool) -> None:
        """Put an in-flight request back on the dispatch queue after its
        replica failed (penalize=True, charges the retry budget and
        backs off) or drained (penalize=False, immediate)."""
        now = self.clock()
        if penalize and rec.attempts > self.rcfg.retry_max:
            self._finish_local(rec, FINISH_FAILED, now,
                               note="retry budget exhausted")
            return
        if penalize:
            rec.not_before = now + compute_backoff(
                max(1, rec.attempts), self.rcfg.retry_backoff_base_s,
                2.0, self.rcfg.retry_backoff_max_s)
        else:
            rec.not_before = 0.0
        rec.assigned = None
        if rec.rid not in self._pending:
            self._pending.appendleft(rec.rid)
        # the ledger's retry-backoff bucket: [this instant -> the rid's
        # next serving/dispatch] is time the request sat out on purpose
        trace_instant("req/requeue", _TRACE_LANE, rid=rec.rid,
                      backoff_s=round(max(0.0, rec.not_before - now), 6),
                      penalize=bool(penalize))

    def _enforce_deadlines(self, now: float) -> None:
        for rec in self._reqs.values():
            if rec.done or rec.deadline_t is None or now < rec.deadline_t:
                continue
            if rec.assigned is not None:
                try:
                    self._state(rec.assigned).replica.cancel(
                        rec.rid, FINISH_TIMEOUT)
                except (ReplicaUnavailableError, KeyError):
                    pass
                self._state(rec.assigned).assigned.discard(rec.rid)
            if rec.rid in self._pending:
                self._pending.remove(rec.rid)
            self._finish_local(rec, FINISH_TIMEOUT, now,
                               note="router deadline")

    @staticmethod
    def _replica_version(st: _ReplicaState) -> Optional[int]:
        v = getattr(st.replica, "version", None)
        return int(v) if v is not None else None

    def _dispatch(self, now: float) -> None:
        healthy = [st for st in self._states if st.healthy
                   and st.replica.alive]
        if not healthy:
            return
        deferred = []
        while self._pending:
            rid = self._pending.popleft()
            rec = self._reqs[rid]
            if rec.done:
                continue
            if now < rec.not_before:
                deferred.append(rid)
                continue
            pool = healthy
            if rec.version is not None:
                pinned = [st for st in healthy
                          if self._replica_version(st) == rec.version]
                if pinned:
                    pool = pinned
                else:
                    # the pinned version lost its last healthy replica
                    # (rollout completed mid-retry): re-pin and
                    # REGENERATE — every token the client sees comes
                    # from one weight set, never a spliced stream
                    rec.repins += 1
                    trace_instant("lifecycle/repin", "lifecycle",
                                  rid=rid, version=rec.version)
                    if self.metrics.registry is not None:
                        self.metrics.registry.counter(
                            "lifecycle_repin_total",
                            "requests re-pinned after their weight "
                            "version lost its last replica").inc()
                    rec.version = None
            target = min(pool, key=lambda st: len(st.assigned))
            # prefix affinity: same-prefix traffic goes back to the
            # replica whose radix cache is warm for it, unless that
            # replica is more than affinity_load_slack requests above
            # the least-loaded choice (affinity must not build hot
            # spots, and never overrides health — it only picks WITHIN
            # the healthy pool)
            if rec.prefix_key is not None:
                warm_name = self._affinity.get(rec.prefix_key)
                if warm_name is not None and warm_name != target.name:
                    warm = next((st for st in pool
                                 if st.name == warm_name), None)
                    if warm is not None and (
                            len(warm.assigned) <= len(target.assigned)
                            + self.rcfg.affinity_load_slack):
                        target = warm
            try:
                target.replica.submit(rec.spec)
            except ReplicaUnavailableError:
                # replica died between the health check and the submit;
                # the next step's watchdog will mark it down
                deferred.append(rid)
                break
            rec.attempts += 1
            rec.assigned = target.name
            if rec.version is None:
                rec.version = self._replica_version(target)
            if rec.prefix_key is not None:
                self._affinity[rec.prefix_key] = target.name
            if not target.assigned:
                # an idle replica's progress window opens with its first
                # request: time spent idle is not a stall (the reference
                # counts it, and marks an idle replica stalled as soon as
                # it is given work after progress_timeout_s)
                target.last_progress = target.replica.progress
                target.progress_t = now
            target.assigned.add(rid)
            # the flow-arrow source: the aggregator pairs this with the
            # replica-side serving/admit carrying the same rid
            trace_instant("serving/dispatch", _TRACE_LANE, rid=rid,
                          replica=target.name, attempt=rec.attempts)
            if rec.attempts > 1:
                self.metrics.record_retry()
                trace_instant("serving/retry", _TRACE_LANE, rid=rid,
                              attempt=rec.attempts, replica=target.name)
        for rid in reversed(deferred):
            self._pending.appendleft(rid)

    def _finish_local(self, rec: RouterRequest, reason: str, now: float,
                      note: Optional[str] = None) -> None:
        rec.finish_reason = reason
        rec.finish_t = now
        if rec.tokens is None:
            rec.tokens = []
        self._inflight_tokens -= rec.cost_tokens
        self.metrics.record_outcome(reason, now - rec.submit_t)
        args = {"rid": rec.rid, "reason": reason}
        if note:
            args["note"] = note
        trace_instant("serving/finish", _TRACE_LANE, **args)

    def _export_gauges(self) -> None:
        for st in self._states:
            self.metrics.set_replica_gauges(
                st.name, st.healthy and st.replica.alive,
                len(st.assigned))
        self.metrics.set_load_gauges(self._accepted_unfinished(),
                                     self._inflight_tokens)
