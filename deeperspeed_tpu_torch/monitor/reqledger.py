"""Request-path doctor: per-request timelines, tail-latency attribution,
and a per-request cost ledger, reconstructed from trace events alone.

Counterpart of deeperspeed_tpu/monitor/reqledger.py.

A serving p99 is useless without knowing *which* requests were slow and
*where* their time went. This module joins the request-scoped events the
fleet already emits — ``req/submit`` / ``req/accept`` (clock zero),
``serving/dispatch`` / ``req/requeue`` (router hops), ``serving/admit``
/ ``serving/prefill`` / ``serving/preempt`` (engine lifecycle),
``serving/decode`` (batch participation via the ``rids`` arg),
``xla_compile`` (duration in args; one per CUDA kernel build in the
port), and ``serving/finish`` (token and
KV-occupancy totals) — into one ``RequestTimeline`` per rid, then
decomposes each request's TTFT and E2E wall-clock with the same
interval arithmetic ``monitor/goodput.py`` uses for run-level goodput.

Attribution is precedence-ordered so the buckets sum to the measured
wall by construction (each bucket is measured after subtracting every
higher one; the remainder is an explicit ``residual``, never silently
dropped):

  ====================  ===========================================
  ``compile``           ``xla_compile`` inside the window — split
                        out of the rid's own prefill first, then
                        whatever else fires on its serving process
  ``prefill``           the rid's own ``serving/prefill`` +
                        ``serving/prefill_chunk`` spans, compile time
                        removed (chunked prefill is own prefill,
                        spread across steps; other rids' chunks land
                        in ``hol_blocking`` like any other prefill)
  ``retry_backoff``     ``req/requeue`` -> next dispatch (failover
                        penalty holds + shed retry-after)
  ``router_queue``      ``req/accept`` -> first dispatch (admission
                        queueing at the router)
  ``preempt_gap``       ``serving/preempt`` -> next own admit (KV
                        pressure evicted the rid mid-decode)
  ``hol_blocking``      OTHER rids' prefill spans on the rid's
                        serving process — head-of-line blocking,
                        attributed per blocker rid
  ``decode``            ``serving/decode`` spans on the serving
                        process (own steps after admission; the
                        batch running ahead of you before it)
  ``sched_queue``       engine-side queue residency (submit ->
                        admit), dispatch -> replica-submit transit,
                        and ``serving/step`` span time not covered
                        by any of the above (scheduler bookkeeping,
                        backpressure polls)
  ``residual``          window time outside every bucket — host
                        gaps between steps; CI gates this < 5%
  ====================  ===========================================

The cost ledger counts what each request *consumed*, not just waited
on: prefill context tokens, generated tokens per dispatch attempt
(retry-wasted tokens are exact because failover replays are
token-identical — every token generated in a non-final attempt is
waste), device-time share (own prefill spans + ``dur/n_active`` of
each decode span the rid rode in), and KV block-seconds from the
scheduler's accrual (``serving/finish`` args). Costs aggregate per
replica and per lifecycle weight-version (``lifecycle/repin`` /
``lifecycle/rollout``) into ``cost_per_1k_tokens`` gauges.

Works on single-engine traces (scripts/serving_bench.py) and on merged
multi-source fleet traces (monitor/aggregate.py output, flight-recorder
recoveries included) — serving-side spans are matched per process id,
so one engine's decode is never charged to a request served elsewhere.
CLI: ``python -m deeperspeed_tpu_torch.monitor.slo``.
"""

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .goodput import (
    Interval,
    interval_measure,
    interval_subtract,
    interval_union,
    load_trace_events,
)

__all__ = [
    "ATTRIBUTION_BUCKETS",
    "DEFAULT_EXCLUDE_PREFIXES",
    "RequestTimeline",
    "TraceIndex",
    "interval_intersect",
    "build_index",
    "attribute_window",
    "request_cost",
    "build_ledger",
    "export_cost_gauges",
    "percentile",
]

# precedence order (highest first); "residual" is the explicit remainder
ATTRIBUTION_BUCKETS = (
    "compile", "prefill", "retry_backoff", "router_queue", "preempt_gap",
    "hol_blocking", "decode", "sched_queue", "residual",
)

_US = 1e-6  # trace ts/dur are microseconds


def interval_intersect(a: Sequence[Interval],
                       b: Sequence[Interval]) -> List[Interval]:
    """``a ∩ b`` for disjoint+sorted interval lists (interval_union
    both). Complements goodput's union/subtract/measure trio."""
    out: List[Interval] = []
    j = 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            lo, hi = max(s, b[k][0]), min(e, b[k][1])
            if hi > lo:
                out.append((lo, hi))
            if b[k][1] >= e:
                break
            k += 1
    return out


def _clip(ivs: Iterable[Interval], window: Interval) -> List[Interval]:
    return interval_intersect(interval_union(ivs), [window])


# ------------------------------------------------------------------ #
# timeline reconstruction
# ------------------------------------------------------------------ #


@dataclasses.dataclass
class RequestTimeline:
    """Every trace event that names one rid, in one place (ts in µs of
    the merged/rebased timeline)."""

    rid: str
    submit_ts: List[float] = dataclasses.field(default_factory=list)
    accept_ts: Optional[float] = None
    # (ts, replica, attempt) from the router; empty for single engines
    dispatches: List[Tuple[float, str, int]] = \
        dataclasses.field(default_factory=list)
    requeues: List[Tuple[float, float]] = \
        dataclasses.field(default_factory=list)      # (ts, backoff_s)
    admits: List[Tuple[float, object]] = \
        dataclasses.field(default_factory=list)      # (ts, pid)
    preempts: List[Tuple[float, object]] = \
        dataclasses.field(default_factory=list)      # (ts, pid)
    # (start, end, pid, ctx_len) own prefill spans. With chunked
    # prefill the engine emits one ``serving/prefill`` span only for the
    # FINAL chunk (the one that emits token 0), so first_token_ts and
    # the one-token-per-prefill-span cost invariant survive chunking
    prefills: List[Tuple[float, float, object, int]] = \
        dataclasses.field(default_factory=list)
    # (start, end, pid, tokens) own non-final ``serving/prefill_chunk``
    # spans — the rid's own prefill work, spread over engine steps
    chunks: List[Tuple[float, float, object, int]] = \
        dataclasses.field(default_factory=list)
    # (start, end, pid, n_active) decode spans the rid rode in
    decodes: List[Tuple[float, float, object, int]] = \
        dataclasses.field(default_factory=list)
    # (ts, reason, args) — engine finishes carry tokens/kv_block_s,
    # router finishes only (rid, reason)
    finishes: List[Tuple[float, str, dict]] = \
        dataclasses.field(default_factory=list)
    # (ts, accepted, k, emitted) ``spec/accept`` instants — one per
    # speculative round the rid rode in; ``emitted`` counts the tokens
    # the round actually appended (accepted drafts + bonus, truncated
    # at EOS/length), which is what keeps token accounting exact when
    # decode emits more than one token per span
    spec_accepts: List[Tuple[float, int, int, int]] = \
        dataclasses.field(default_factory=list)

    # -- derived ----------------------------------------------------- #

    @property
    def t0(self) -> Optional[float]:
        """Clock zero: the earliest submit/accept the trace saw."""
        cands = list(self.submit_ts)
        if self.accept_ts is not None:
            cands.append(self.accept_ts)
        return min(cands) if cands else None

    @property
    def first_token_ts(self) -> Optional[float]:
        """End of the first own prefill span — when token 0 existed."""
        return min((end for _s, end, _p, _c in self.prefills),
                   default=None)

    @property
    def end_ts(self) -> Optional[float]:
        return max((ts for ts, _r, _a in self.finishes), default=None)

    @property
    def engine_finish(self) -> Optional[dict]:
        """Args of the last engine-side finish (the one carrying
        ``tokens`` / ``kv_block_s``); None when only the router saw the
        request end (e.g. shed before admission)."""
        eng = [a for _ts, _r, a in self.finishes if "tokens" in a]
        return eng[-1] if eng else None

    @property
    def serving_pids(self) -> List[object]:
        """Processes that actually served the rid (admitted or
        prefilled it) — the only tracks whose decode/step/compile time
        can be charged to this request."""
        pids = {p for _ts, p in self.admits}
        pids.update(p for _s, _e, p, _c in self.prefills)
        pids.update(p for _s, _e, p, _c in self.chunks)
        return sorted(pids, key=repr)

    def ttft_window(self) -> Optional[Interval]:
        t0, t1 = self.t0, self.first_token_ts
        return (t0, t1) if t0 is not None and t1 is not None \
            and t1 > t0 else None

    def e2e_window(self) -> Optional[Interval]:
        t0, t1 = self.t0, self.end_ts
        return (t0, t1) if t0 is not None and t1 is not None \
            and t1 > t0 else None


@dataclasses.dataclass
class TraceIndex:
    """Per-pid span pools shared across all requests' attributions."""

    timelines: Dict[str, RequestTimeline]
    # pid -> [(start, end, rid)] every prefill span (HOL candidates)
    prefills_by_pid: Dict[object, List[Tuple[float, float, str]]]
    compiles_by_pid: Dict[object, List[Interval]]
    decodes_by_pid: Dict[object, List[Interval]]
    steps_by_pid: Dict[object, List[Interval]]
    # lifecycle joins for the cost ledger's per-version axis
    rollouts: List[Tuple[float, str, object]]    # (ts, replica, version)
    repins: Dict[str, object]                    # rid -> version
    # speculative decoding: per-round ``spec/draft`` / ``spec/verify``
    # instants as (ts, n_active, dur_us) — the draft-vs-verify split of
    # the decode bucket's device time
    spec_drafts: List[Tuple[float, int, float]] = \
        dataclasses.field(default_factory=list)
    spec_verifies: List[Tuple[float, int, float]] = \
        dataclasses.field(default_factory=list)


def _args(ev: dict) -> dict:
    a = ev.get("args")
    return a if isinstance(a, dict) else {}


def build_index(events: List[dict]) -> TraceIndex:
    """One pass over a (merged) event list -> TraceIndex."""
    tls: Dict[str, RequestTimeline] = {}
    prefills_by_pid: Dict[object, list] = {}
    compiles_by_pid: Dict[object, list] = {}
    decodes_by_pid: Dict[object, list] = {}
    steps_by_pid: Dict[object, list] = {}
    rollouts: List[Tuple[float, str, object]] = []
    repins: Dict[str, object] = {}
    spec_drafts: List[Tuple[float, int, float]] = []
    spec_verifies: List[Tuple[float, int, float]] = []

    def tl(rid) -> RequestTimeline:
        rid = str(rid)
        if rid not in tls:
            tls[rid] = RequestTimeline(rid=rid)
        return tls[rid]

    for ev in events:
        if not isinstance(ev, dict):
            continue
        name, ph, ts = ev.get("name"), ev.get("ph"), ev.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        pid = ev.get("pid")
        args = _args(ev)
        rid = args.get("rid")
        if name == "xla_compile":
            secs = args.get("seconds", 0.0)
            if isinstance(secs, (int, float)) and secs > 0:
                # the compile listener fires at compile END
                compiles_by_pid.setdefault(pid, []).append(
                    (ts - secs * 1e6, ts))
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur <= 0:
                continue
            start, end = ts, ts + dur
            if name == "serving/prefill" and rid is not None:
                tl(rid).prefills.append(
                    (start, end, pid, int(args.get("ctx_len", 0))))
                prefills_by_pid.setdefault(pid, []).append(
                    (start, end, str(rid)))
            elif name == "serving/prefill_chunk" and rid is not None:
                # a chunk forward is the rid's OWN prefill work and,
                # symmetrically, head-of-line blocking for everyone
                # else on the same track — so it joins the per-pid
                # prefill pool HOL attribution draws from
                tl(rid).chunks.append(
                    (start, end, pid, int(args.get("tokens", 0))))
                prefills_by_pid.setdefault(pid, []).append(
                    (start, end, str(rid)))
            elif name == "serving/decode":
                decodes_by_pid.setdefault(pid, []).append((start, end))
                riders = [r for r in
                          str(args.get("rids", "")).split(",") if r]
                n = int(args.get("n_active", len(riders)) or 1)
                for r in riders:
                    tl(r).decodes.append((start, end, pid, n))
            elif name == "serving/step":
                steps_by_pid.setdefault(pid, []).append((start, end))
            continue
        # instants
        if name == "req/submit" and rid is not None:
            tl(rid).submit_ts.append(ts)
        elif name == "req/accept" and rid is not None:
            t = tl(rid)
            t.accept_ts = ts if t.accept_ts is None \
                else min(t.accept_ts, ts)
        elif name == "serving/dispatch" and rid is not None:
            tl(rid).dispatches.append(
                (ts, str(args.get("replica", "?")),
                 int(args.get("attempt", 0))))
        elif name == "req/requeue" and rid is not None:
            tl(rid).requeues.append(
                (ts, float(args.get("backoff_s", 0.0) or 0.0)))
        elif name == "serving/admit" and rid is not None:
            tl(rid).admits.append((ts, pid))
        elif name == "serving/preempt" and rid is not None:
            tl(rid).preempts.append((ts, pid))
        elif name == "serving/finish" and rid is not None:
            tl(rid).finishes.append(
                (ts, str(args.get("reason", "?")), args))
        elif name == "lifecycle/rollout":
            rollouts.append((ts, str(args.get("replica", "?")),
                             args.get("version")))
        elif name == "lifecycle/repin" and rid is not None:
            repins[str(rid)] = args.get("version")
        elif name == "spec/draft":
            spec_drafts.append((ts, int(args.get("n_active", 0) or 0),
                                float(args.get("dur_us", 0.0) or 0.0)))
        elif name == "spec/verify":
            spec_verifies.append((ts, int(args.get("n_active", 0) or 0),
                                  float(args.get("dur_us", 0.0) or 0.0)))
        elif name == "spec/accept" and rid is not None:
            acc = int(args.get("accepted", 0) or 0)
            tl(rid).spec_accepts.append(
                (ts, acc, int(args.get("k", 0) or 0),
                 int(args.get("emitted", acc + 1) or (acc + 1))))

    for tline in tls.values():
        tline.dispatches.sort()
        tline.prefills.sort()
        tline.chunks.sort()
        tline.decodes.sort()
        tline.finishes.sort()
        tline.spec_accepts.sort()
    rollouts.sort()
    spec_drafts.sort()
    spec_verifies.sort()
    return TraceIndex(
        timelines=tls,
        prefills_by_pid=prefills_by_pid,
        compiles_by_pid=compiles_by_pid,
        decodes_by_pid=decodes_by_pid,
        steps_by_pid=steps_by_pid,
        rollouts=rollouts,
        repins=repins,
        spec_drafts=spec_drafts,
        spec_verifies=spec_verifies,
    )


# ------------------------------------------------------------------ #
# attribution
# ------------------------------------------------------------------ #


def _serving_pids(idx: TraceIndex, tline: RequestTimeline) -> List[object]:
    pids = tline.serving_pids
    if pids:
        return pids
    # never admitted anywhere (shed, or still queued at trace end):
    # charge engine-side time from every serving track, so a fleet-wide
    # stall still shows up instead of landing in residual
    return sorted(idx.steps_by_pid.keys(), key=repr)


def attribute_window(idx: TraceIndex, tline: RequestTimeline,
                     window: Interval) -> dict:
    """Decompose one request's window into ATTRIBUTION_BUCKETS (µs).

    Returns ``{"window_us", "buckets": {bucket: µs}, "blockers":
    {rid: µs}, "residual_fraction"}``; buckets + residual sum to the
    window by construction.
    """
    pids = _serving_pids(idx, tline)

    # own prefill = the final-chunk serving/prefill span(s) plus any
    # earlier serving/prefill_chunk spans: chunked prefill is still the
    # rid's own prefill time, just spread across engine steps instead
    # of one contiguous stall
    own_prefill = _clip([(s, e) for s, e, _p, _c in tline.prefills]
                        + [(s, e) for s, e, _p, _c in tline.chunks],
                        window)
    compile_all = _clip(
        [iv for p in pids for iv in idx.compiles_by_pid.get(p, [])],
        window)
    # compile inside the rid's own prefill is the cold-bucket tax the
    # request itself paid; it outranks "prefill" so warm and cold
    # prefills are distinguishable in the breakdown
    compile_u = interval_intersect(compile_all, own_prefill)
    prefill_u = interval_subtract(own_prefill, compile_u)
    higher = interval_union(own_prefill)

    def take(ivs: List[Interval]) -> List[Interval]:
        nonlocal higher
        got = interval_subtract(_clip(ivs, window), higher)
        higher = interval_union(higher + got)
        return got

    # requeue -> next dispatch: failover penalty hold / shed backoff
    retry_iv = []
    for ts, _backoff in tline.requeues:
        nxt = min((d for d, _r, _a in tline.dispatches if d > ts),
                  default=window[1])
        retry_iv.append((ts, nxt))
    retry_u = take(retry_iv)

    # router admission queueing: accept -> first dispatch
    router_u = take(
        [(tline.accept_ts, tline.dispatches[0][0])]
        if tline.accept_ts is not None and tline.dispatches else [])

    preempt_iv = []
    for ts, _pid in tline.preempts:
        nxt = min((a for a, _p in tline.admits if a > ts),
                  default=window[1])
        preempt_iv.append((ts, nxt))
    preempt_u = take(preempt_iv)

    # head-of-line: OTHER rids' prefills on this rid's serving tracks.
    # The union is exact; the per-blocker split re-intersects each
    # blocker's own spans, so concurrent blockers on different tracks
    # can jointly over-claim the union (noted, not hidden).
    remaining_before_hol = interval_subtract([window], higher)
    hol_spans = [(s, e, r) for p in pids
                 for s, e, r in idx.prefills_by_pid.get(p, [])
                 if r != tline.rid]
    hol_u = take([(s, e) for s, e, _r in hol_spans])
    blockers: Dict[str, float] = {}
    for s, e, r in hol_spans:
        got = interval_intersect(_clip([(s, e)], window),
                                 remaining_before_hol)
        if got:
            blockers[r] = blockers.get(r, 0.0) + interval_measure(got)

    compile_rest = take(
        [iv for p in pids for iv in idx.compiles_by_pid.get(p, [])])
    decode_u = take(
        [iv for p in pids for iv in idx.decodes_by_pid.get(p, [])])
    # scheduler queue: engine-side queue residency (submit -> first
    # admit — the wait for the next step to pick the request up),
    # dispatch -> replica-submit IPC transit, and serving/step span
    # time no higher bucket claimed (admission polls, backpressure
    # checks, bookkeeping). Lowest precedence: it mops up only what
    # nothing more specific explains — a replica prefilling someone
    # else during these windows already counted as hol_blocking.
    queue_iv = []
    if tline.submit_ts:
        first_admit = min((a for a, _p in tline.admits),
                          default=window[1])
        queue_iv.append((min(tline.submit_ts), first_admit))
    for d_ts, _rep, _att in tline.dispatches:
        landed = [s for s in tline.submit_ts if s > d_ts]
        landed += [a for a, _p in tline.admits if a > d_ts]
        queue_iv.append((d_ts, min(landed, default=window[1])))
    step_u = take(
        queue_iv
        + [iv for p in pids for iv in idx.steps_by_pid.get(p, [])])

    wall = window[1] - window[0]
    buckets = {
        "compile": interval_measure(compile_u)
        + interval_measure(compile_rest),
        "prefill": interval_measure(prefill_u),
        "retry_backoff": interval_measure(retry_u),
        "router_queue": interval_measure(router_u),
        "preempt_gap": interval_measure(preempt_u),
        "hol_blocking": interval_measure(hol_u),
        "decode": interval_measure(decode_u),
        "sched_queue": interval_measure(step_u),
    }
    buckets["residual"] = max(0.0, wall - sum(buckets.values()))
    return {
        "window_us": wall,
        "buckets": buckets,
        "blockers": dict(sorted(blockers.items(),
                                key=lambda kv: -kv[1])),
        "residual_fraction": (buckets["residual"] / wall
                              if wall > 0 else 0.0),
    }


# ------------------------------------------------------------------ #
# cost ledger
# ------------------------------------------------------------------ #


def request_cost(idx: TraceIndex, tline: RequestTimeline) -> dict:
    """What the request consumed, split by dispatch attempt.

    Token counting is exact, not sampled: every own prefill span emits
    one generated token (the scheduler prefills once per admission) and
    every decode participation emits one, so tokens-per-attempt is a
    pure event count; the final attempt must equal the engine finish's
    ``tokens`` arg. Failover replays are token-identical, so everything
    generated in a non-final attempt is retry waste.
    """
    if tline.dispatches:
        bounds = [d for d, _r, _a in tline.dispatches]
    else:
        bounds = [tline.t0 if tline.t0 is not None else 0.0]

    def attempt_of(ts: float) -> int:
        i = 0
        for k, b in enumerate(bounds):
            if ts >= b:
                i = k
        return i

    n_attempts = len(bounds)
    tokens = [0] * n_attempts
    prefill_ctx = [0] * n_attempts
    device_us = [0.0] * n_attempts
    for _s, end, _pid, ctx in tline.prefills:
        a = attempt_of(end)
        tokens[a] += 1
        prefill_ctx[a] += ctx
        device_us[a] += end - _s
    for s, e, _pid, _tok in tline.chunks:
        # non-final chunks consume device time but emit no token (the
        # final chunk's serving/prefill span carries that), and their
        # context tokens are already inside the final span's ctx_len
        device_us[attempt_of(e)] += e - s
    for s, e, _pid, n in tline.decodes:
        a = attempt_of(e)
        tokens[a] += 1
        device_us[a] += (e - s) / max(1, n)   # fair share of the batch
    # speculative rounds append more than one token per decode span:
    # the +1 above is the round's floor, spec/accept's ``emitted``
    # carries the rest, so spec-on attempts stay exactly counted
    for ts, _acc, _k, emitted in tline.spec_accepts:
        tokens[attempt_of(ts)] += max(0, emitted - 1)

    fin = tline.engine_finish or {}
    final_tokens = tokens[-1]
    total = sum(tokens)
    replica = tline.dispatches[-1][1] if tline.dispatches else "local"
    spec_drafted = sum(k for _ts, _a, k, _e in tline.spec_accepts)
    spec_accepted = sum(a for _ts, a, _k, _e in tline.spec_accepts)
    return {
        "spec_rounds": len(tline.spec_accepts),
        "spec_accept_rate": round(spec_accepted / spec_drafted, 6)
        if spec_drafted else 0.0,
        "attempts": n_attempts,
        "tokens_final": final_tokens,
        "tokens_total": total,
        "retry_wasted_tokens": total - final_tokens,
        "prefill_ctx_tokens": sum(prefill_ctx),
        "device_s": round(sum(device_us) * _US, 6),
        "kv_block_s": float(fin.get("kv_block_s", 0.0) or 0.0),
        "admissions": int(fin.get("admissions", len(tline.admits))
                          or len(tline.admits)),
        "preemptions": len(tline.preempts),
        "replica": replica,
        "version": _version_of(idx, tline, replica),
        "finish_tokens_reported": fin.get("tokens"),
        "finish_reason": (tline.finishes[-1][1]
                          if tline.finishes else None),
    }


def _version_of(idx: TraceIndex, tline: RequestTimeline,
                replica: str) -> str:
    """Weight-version axis: an explicit ``lifecycle/repin`` wins, else
    the latest rollout the serving replica had taken by dispatch time."""
    v = idx.repins.get(tline.rid)
    if v is not None:
        return str(v)
    t_ref = tline.dispatches[-1][0] if tline.dispatches else float("inf")
    best = None
    for ts, rep, ver in idx.rollouts:
        if rep == replica and ts <= t_ref:
            best = ver
    return str(best) if best is not None else "unversioned"


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); 0.0 on empty input —
    matches how the bench summarizes TTFT."""
    vs = sorted(values)
    if not vs:
        return 0.0
    k = max(0, min(len(vs) - 1,
                   math.ceil(q / 100.0 * len(vs)) - 1))
    return vs[k]


# ------------------------------------------------------------------ #
# the full report
# ------------------------------------------------------------------ #


DEFAULT_EXCLUDE_PREFIXES = ("warm-", "_warm")


def build_ledger(events_or_path, top_blockers: int = 5,
                 exclude_prefixes: Tuple[str, ...] =
                 DEFAULT_EXCLUDE_PREFIXES) -> dict:
    """Events (list / trace doc / path, flight.bin included) -> the
    request-path doctor report: per-rid attribution + cost, fleet
    percentiles, aggregate bucket totals, the p99 victim's breakdown,
    and per-replica / per-version unit economics.

    Rids under ``exclude_prefixes`` (by default the bench's ``warm-*``
    and the replica worker's ``_warm*`` compile-warmup requests) are
    dropped from the doctored population — but their prefill spans
    still count as HOL blockers, because a warmup prefill in front of
    real traffic is real blocking.
    """
    events = load_trace_events(events_or_path)
    idx = build_index(events)

    requests: Dict[str, dict] = {}
    ttfts: List[Tuple[float, str]] = []
    e2es: List[Tuple[float, str]] = []
    agg = {b: 0.0 for b in ATTRIBUTION_BUCKETS}
    blocker_totals: Dict[str, float] = {}

    for rid in sorted(idx.timelines):
        if any(rid.startswith(p) for p in exclude_prefixes):
            continue
        tline = idx.timelines[rid]
        row = {"rid": rid, "cost": request_cost(idx, tline)}
        w = tline.ttft_window()
        if w is not None:
            att = attribute_window(idx, tline, w)
            row["ttft_ms"] = round(att["window_us"] * 1e-3, 3)
            row["ttft"] = _ms_view(att)
            ttfts.append((att["window_us"], rid))
            for b, v in att["buckets"].items():
                agg[b] += v
            for r, v in att["blockers"].items():
                blocker_totals[r] = blocker_totals.get(r, 0.0) + v
        w = tline.e2e_window()
        if w is not None:
            att = attribute_window(idx, tline, w)
            row["e2e_ms"] = round(att["window_us"] * 1e-3, 3)
            row["e2e"] = _ms_view(att)
            e2es.append((att["window_us"], rid))
        requests[rid] = row

    def pct_block(samples: List[Tuple[float, str]]) -> dict:
        vals = [v * 1e-3 for v, _ in samples]
        return {"count": len(vals),
                "p50_ms": round(percentile(vals, 50), 3),
                "p90_ms": round(percentile(vals, 90), 3),
                "p99_ms": round(percentile(vals, 99), 3),
                "max_ms": round(max(vals), 3) if vals else 0.0}

    p99_victim = None
    if ttfts:
        # nearest-rank p99 of a bench-sized sample IS the max; name the
        # slowest request and say where its time went
        v_us, v_rid = max(ttfts)
        vb = requests[v_rid]["ttft"]["buckets"]
        dominant = max(vb, key=lambda b: 0.0 if b == "residual"
                       else vb[b])
        blk = requests[v_rid]["ttft"]["blockers"]
        p99_victim = {
            "rid": v_rid,
            "ttft_ms": round(v_us * 1e-3, 3),
            "dominant_bucket": dominant,
            "top_blocker": next(iter(blk), None),
        }

    # per-replica / per-version unit economics over completed requests
    econ: Dict[str, Dict[str, dict]] = {"replica": {}, "version": {}}
    total_dev_s = total_tok = 0
    for row in requests.values():
        c = row["cost"]
        if not c["tokens_final"]:
            continue
        total_dev_s += c["device_s"]
        total_tok += c["tokens_final"]
        for axis, key in (("replica", c["replica"]),
                          ("version", c["version"])):
            g = econ[axis].setdefault(
                key, {"requests": 0, "tokens": 0, "device_s": 0.0,
                      "retry_wasted_tokens": 0, "kv_block_s": 0.0})
            g["requests"] += 1
            g["tokens"] += c["tokens_final"]
            g["device_s"] = round(g["device_s"] + c["device_s"], 6)
            g["retry_wasted_tokens"] += c["retry_wasted_tokens"]
            g["kv_block_s"] = round(g["kv_block_s"] + c["kv_block_s"], 6)
    for axis in econ.values():
        for g in axis.values():
            g["cost_per_1k_tokens"] = round(
                1000.0 * g["device_s"] / g["tokens"], 6) \
                if g["tokens"] else 0.0

    worst_residual = max(
        (requests[r].get("ttft", {}).get("residual_fraction", 0.0)
         for r in requests), default=0.0)

    # speculative decoding: the draft-vs-verify split of decode device
    # time plus fleet and per-rid acceptance — accept_rate is what the
    # spec-on/spec-off routing decision and the bench's TPOT claim key
    # on, so it lives in the doctored report, not just engine metrics
    spec_drafted = spec_accepted = 0
    spec_per_rid: Dict[str, dict] = {}
    for rid, row in requests.items():
        tline = idx.timelines[rid]
        if not tline.spec_accepts:
            continue
        d = sum(k for _ts, _a, k, _e in tline.spec_accepts)
        a = sum(acc for _ts, acc, _k, _e in tline.spec_accepts)
        spec_drafted += d
        spec_accepted += a
        spec_per_rid[rid] = {
            "rounds": len(tline.spec_accepts),
            "accept_rate": round(a / d, 6) if d else 0.0,
        }
    speculative = {
        "rounds": len(idx.spec_drafts),
        "draft_ms": round(
            sum(d for _t, _n, d in idx.spec_drafts) * 1e-3, 3),
        "verify_ms": round(
            sum(d for _t, _n, d in idx.spec_verifies) * 1e-3, 3),
        "drafted": spec_drafted,
        "accepted": spec_accepted,
        "accept_rate": round(spec_accepted / spec_drafted, 6)
        if spec_drafted else 0.0,
        "per_rid": spec_per_rid,
    }
    return {
        "requests": requests,
        "ttft": pct_block(ttfts),
        "e2e": pct_block(e2es),
        "p99_victim": p99_victim,
        "buckets_total_ms": {b: round(v * 1e-3, 3)
                             for b, v in agg.items()},
        "top_blockers": [
            {"rid": r, "blocked_ms": round(v * 1e-3, 3)}
            for r, v in sorted(blocker_totals.items(),
                               key=lambda kv: -kv[1])[:top_blockers]],
        "worst_residual_fraction": round(worst_residual, 6),
        "cost_per_1k_tokens": round(
            1000.0 * total_dev_s / total_tok, 6) if total_tok else 0.0,
        "economics": econ,
        "speculative": speculative,
    }


def _ms_view(att: dict) -> dict:
    return {
        "buckets": {b: round(v * 1e-3, 3)
                    for b, v in att["buckets"].items()},
        "blockers": {r: round(v * 1e-3, 3)
                     for r, v in att["blockers"].items()},
        "residual_fraction": round(att["residual_fraction"], 6),
    }


def export_cost_gauges(report: dict, registry) -> None:
    """Push the ledger's unit-economics axes into a MetricsRegistry:
    ``cost_per_1k_tokens{replica=...}`` / ``{version=...}`` plus the
    fleet-wide value — the scrape-side face of the cost ledger."""
    if registry is None:
        return
    help_ = "Device-seconds consumed per 1k delivered tokens."
    registry.gauge("cost_per_1k_tokens", help_).set(
        report.get("cost_per_1k_tokens", 0.0))
    for axis in ("replica", "version"):
        for key, g in report.get("economics", {}).get(axis, {}).items():
            registry.gauge("cost_per_1k_tokens", help_,
                           labels={axis: key}).set(
                g["cost_per_1k_tokens"])
