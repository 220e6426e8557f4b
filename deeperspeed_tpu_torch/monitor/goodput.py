"""Goodput ledger: where a run's wall-clock actually went.

Counterpart of deeperspeed_tpu/monitor/goodput.py, with its own
``python -m`` entry.

The spot-pool story needs one headline number — the fraction of
wall-clock spent on productive steps versus everything a preemptible
fleet pays for the privilege: kernel builds (compiles), checkpoint saves, restart +
reshard downtime, input-pipeline stalls, and replayed steps. This
module classifies a run's wall-clock into those buckets from two
sources that already exist:

  * the supervisor's **restart log** (JSONL launch/exit transitions,
    wall-clock stamped) — child lifetimes and the downtime gaps
    between an exit and the next launch;
  * each incarnation's **trace events** (from its trace file, or
    recovered from its flight.bin when it was SIGKILLed) — span
    intervals classified by name.

Bucket rules, applied as *interval arithmetic* so nested spans are
never double-counted (a compile inside the first ``engine/train_batch``
span is compile time, not productive time):

  ====================  =============================================
  ``compile``           ``xla_compile`` instants (duration in args; the
                        port emits one per CUDA kernel build,
                        ops/op_builder.py)
  ``remesh``            ``lifecycle/remesh`` spans — live in-process
                        topology flips (the zero-restart elasticity
                        path pays a stall, not a relaunch)
  ``checkpoint``        ``resilience/write|snapshot|commit`` spans
  ``stall``             ``datapipe/wait`` spans
  ``rework``            train-step spans whose ``step`` arg was
                        already executed by an earlier incarnation —
                        the replay tax of checkpoint-interval resume
  ``productive``        remaining train/serving step span time
  ``restart``           gaps between a child's exit and the next
                        launch (supervisor backoff + spawn)
  ``other``             the remainder of each child's lifetime
                        (imports, engine build, resume/reshard)
  ====================  =============================================

Precedence within an incarnation: compile > remesh > checkpoint >
stall > rework > productive; each category is measured after subtracting the
higher ones, and ``other`` is the unclassified remainder, so the
buckets sum to measured wall-clock by construction — the drill audits
the sum against an independently measured wall time to within 5%.

``compute_goodput`` also exports ``goodput_fraction`` and
``goodput_seconds{bucket=...}`` gauges into a metrics registry and
emits a ``goodput/report`` trace instant, so dashboards and traces
carry the same number. CLI::

    python -m deeperspeed_tpu_torch.monitor.goodput \
        --restart-log restarts.jsonl --out goodput.json \
        trainer.i0.trace.json trainer.i1.flight.bin trainer.i2.trace.json
"""

import argparse
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import flight as flight_mod
from .tracer import trace_instant

__all__ = [
    "BUCKETS",
    "interval_union",
    "interval_subtract",
    "interval_measure",
    "parse_restart_log",
    "classify_incarnation",
    "compute_goodput",
    "main",
]

BUCKETS = ("productive", "rework", "compile", "remesh", "checkpoint",
           "stall", "restart", "other")

# span names whose time is the run's actual point: training or serving
# forward progress
PRODUCTIVE_SPANS = frozenset({
    "engine/train_batch", "pipe/train_batch",
    "serving/prefill", "serving/decode",
})
CHECKPOINT_SPANS = frozenset({
    "resilience/write", "resilience/snapshot", "resilience/commit",
})
REMESH_SPANS = frozenset({"lifecycle/remesh"})
STALL_SPANS = frozenset({"datapipe/wait"})
COMPILE_INSTANT = "xla_compile"

Interval = Tuple[float, float]


# ------------------------------------------------------------------ #
# interval arithmetic (pure, unit-tested)
# ------------------------------------------------------------------ #


def interval_union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, disjoint union of (start, end) intervals."""
    ivs = sorted((a, b) for a, b in intervals if b > a)
    out: List[Interval] = []
    for a, b in ivs:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def interval_subtract(a: Sequence[Interval],
                      b: Sequence[Interval]) -> List[Interval]:
    """``a - b`` where both are disjoint+sorted (use interval_union)."""
    out: List[Interval] = []
    j = 0
    for start, end in a:
        cur = start
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < end:
            bs, be = b[k]
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if cur >= end:
                break
            k += 1
        if cur < end:
            out.append((cur, end))
    return out


def interval_measure(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in intervals)


# ------------------------------------------------------------------ #
# sources
# ------------------------------------------------------------------ #


def parse_restart_log(log) -> List[dict]:
    """Restart-log records from a path or an already-parsed list."""
    if isinstance(log, (list, tuple)):
        return list(log)
    records = []
    with open(log) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def load_trace_events(path_or_events) -> List[dict]:
    """Events from a trace JSON path, a flight.bin path, a trace doc,
    or a raw event list — whatever an incarnation left behind."""
    if isinstance(path_or_events, list):
        return path_or_events
    if isinstance(path_or_events, dict):
        return path_or_events.get("traceEvents", [])
    path = path_or_events
    if flight_mod.is_flight_file(path):
        return flight_mod.recover(path).events
    with open(path) as f:
        doc = json.load(f)
    return doc.get("traceEvents", doc) if isinstance(doc, dict) else doc


def classify_incarnation(events: List[dict], prev_max_step: int,
                         ) -> Tuple[Dict[str, float], int]:
    """One incarnation's trace -> seconds per in-child bucket, plus the
    updated max step index seen (feeds the next incarnation's rework
    detection). Pure; the drill's synthetic-log test drives it."""
    compile_iv, remesh_iv, ckpt_iv, stall_iv = [], [], [], []
    prod_iv, rework_iv = [], []
    max_step = prev_max_step
    for ev in events:
        if not isinstance(ev, dict):
            continue
        name, ph, ts = ev.get("name"), ev.get("ph"), ev.get("ts")
        if not isinstance(ts, (int, float)):
            continue
        if name == COMPILE_INSTANT:
            secs = (ev.get("args") or {}).get("seconds", 0.0)
            if isinstance(secs, (int, float)) and secs > 0:
                # the listener fires when the compile ENDS
                compile_iv.append((ts - secs * 1e6, ts))
            continue
        if ph != "X":
            continue
        dur = ev.get("dur")
        if not isinstance(dur, (int, float)) or dur <= 0:
            continue
        iv = (ts, ts + dur)
        if name in REMESH_SPANS:
            remesh_iv.append(iv)
        elif name in CHECKPOINT_SPANS:
            ckpt_iv.append(iv)
        elif name in STALL_SPANS:
            stall_iv.append(iv)
        elif name in PRODUCTIVE_SPANS:
            step = (ev.get("args") or {}).get("step")
            if isinstance(step, (int, float)) and step <= prev_max_step:
                rework_iv.append(iv)        # replaying already-done work
            else:
                prod_iv.append(iv)
            if isinstance(step, (int, float)):
                max_step = max(max_step, int(step))
    compile_u = interval_union(compile_iv)
    remesh_u = interval_subtract(interval_union(remesh_iv), compile_u)
    higher = interval_union(compile_u + remesh_u)
    ckpt_u = interval_subtract(interval_union(ckpt_iv), higher)
    higher = interval_union(higher + ckpt_u)
    stall_u = interval_subtract(interval_union(stall_iv), higher)
    higher = interval_union(higher + stall_u)
    rework_u = interval_subtract(interval_union(rework_iv), higher)
    higher = interval_union(higher + rework_u)
    prod_u = interval_subtract(interval_union(prod_iv), higher)
    to_s = 1e-6
    return {
        "productive": interval_measure(prod_u) * to_s,
        "rework": interval_measure(rework_u) * to_s,
        "compile": interval_measure(compile_u) * to_s,
        "remesh": interval_measure(remesh_u) * to_s,
        "checkpoint": interval_measure(ckpt_u) * to_s,
        "stall": interval_measure(stall_u) * to_s,
    }, max_step


def compute_goodput(restart_log, traces: Sequence,
                    wall_s: Optional[float] = None,
                    registry=None, emit_trace: bool = True) -> dict:
    """The ledger: classify a run's wall-clock into BUCKETS.

    ``restart_log`` — supervisor JSONL (path or record list); may be
    None for a single-incarnation run. ``traces`` — one entry per
    incarnation, in launch order: a trace/flight path, a trace doc, or
    an event list. ``wall_s`` — independently measured run wall time;
    defaults to the restart log's first-launch-to-last-exit span.
    """
    records = parse_restart_log(restart_log) if restart_log else []
    launches = [r for r in records if r.get("event") == "launch"]
    exits = [r for r in records if r.get("event") == "exit"]
    lives: List[Tuple[float, float]] = []
    for launch, exit_ in zip(launches, exits):
        if "ts" in launch and "ts" in exit_:
            lives.append((launch["ts"], exit_["ts"]))
    gaps = [max(0.0, launches[i + 1]["ts"] - exits[i]["ts"])
            for i in range(min(len(exits), len(launches) - 1))
            if "ts" in launches[i + 1] and "ts" in exits[i]]
    if wall_s is None:
        if lives:
            wall_s = lives[-1][1] - lives[0][0]
        else:
            raise ValueError(
                "compute_goodput needs wall_s when there is no "
                "restart log to measure it from")

    buckets = {b: 0.0 for b in BUCKETS}
    buckets["restart"] = sum(gaps)
    incarnations = []
    max_step = -1
    for i, trace in enumerate(traces):
        events = load_trace_events(trace)
        inc, max_step = classify_incarnation(events, max_step)
        child_wall = (lives[i][1] - lives[i][0]) if i < len(lives) \
            else wall_s - buckets["restart"]
        classified = sum(inc.values())
        inc["other"] = max(0.0, child_wall - classified)
        inc["child_wall_s"] = child_wall
        incarnations.append(inc)
        for b, v in inc.items():
            if b in buckets:
                buckets[b] += v
    # harness time outside any child lifetime (spawn overhead, the
    # drill's own bookkeeping) lands in "other" so the ledger still
    # covers the measured wall-clock
    in_children = sum(b - a for a, b in lives) if lives else \
        sum(i["child_wall_s"] for i in incarnations)
    buckets["other"] += max(0.0, wall_s - in_children - buckets["restart"])

    accounted = sum(buckets.values())
    goodput = buckets["productive"] / wall_s if wall_s > 0 else 0.0
    report = {
        "wall_s": wall_s,
        "buckets": {b: round(v, 6) for b, v in buckets.items()},
        "goodput": round(goodput, 6),
        "accounted_s": round(accounted, 6),
        "accounted_fraction": round(accounted / wall_s, 6)
        if wall_s > 0 else 0.0,
        "incarnations": [
            {k: round(v, 6) for k, v in inc.items()}
            for inc in incarnations],
        "restarts": max(0, len(launches) - 1),
    }
    if registry is None:
        from . import get_monitor
        mon = get_monitor()
        registry = mon.registry if mon is not None else None
    if registry is not None:
        registry.gauge("goodput_fraction",
                       "Fraction of wall-clock spent on productive "
                       "steps.").set(goodput)
        for b, v in buckets.items():
            registry.gauge("goodput_seconds",
                           "Run wall-clock per goodput bucket.",
                           labels={"bucket": b}).set(v)
    if emit_trace:
        trace_instant("goodput/report", lane="run",
                      wall_s=round(wall_s, 3), goodput=round(goodput, 4))
    return report


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeperspeed_tpu_torch.monitor.goodput",
        description="Classify a run's wall-clock into goodput buckets "
                    "from its restart log and per-incarnation traces.")
    ap.add_argument("traces", nargs="+",
                    help="per-incarnation trace JSON / flight.bin, in "
                         "launch order")
    ap.add_argument("--restart-log", default=None,
                    help="supervisor --restart-log JSONL")
    ap.add_argument("--wall", type=float, default=None,
                    help="measured wall seconds (default: from the "
                         "restart log)")
    ap.add_argument("--out", default=None, help="write the JSON report")
    args = ap.parse_args(argv)
    report = compute_goodput(args.restart_log, args.traces,
                             wall_s=args.wall, emit_trace=False)
    for b in BUCKETS:
        v = report["buckets"][b]
        pct = 100.0 * v / report["wall_s"] if report["wall_s"] else 0.0
        print(f"  {b:<12} {v:>10.3f}s  {pct:5.1f}%")
    print(f"GOODPUT {report['goodput']:.4f} over {report['wall_s']:.2f}s "
          f"wall ({report['restarts']} restart(s), "
          f"{report['accounted_fraction']:.3f} accounted)")
    if args.out:
        parent = os.path.dirname(os.path.abspath(args.out))
        os.makedirs(parent, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
