"""Request-path doctor CLI: attribute serving tail latency from a trace.

Counterpart of deeperspeed_tpu/monitor/slo.py, with its own
``python -m`` entry.

Front-end over ``monitor/reqledger.py``: point it at a trace JSON, a
flight.bin, or a drill artifact directory and it prints, per latency
axis, the fleet percentiles, where the aggregate wall-clock went, the
p99 victim's own breakdown (with the blocker rid when head-of-line
blocking dominates), the top-K blocker requests fleet-wide, and the
per-replica / per-version cost-per-1k-tokens ledger::

    python -m deeperspeed_tpu_torch.monitor.slo traces/serving_bench_trace.json
    python -m deeperspeed_tpu_torch.monitor.slo --json doctor.json bench_obs/

Directory inputs pick the merged trace when one exists (the
``monitor/aggregate.py`` output is the richest view), else a single
trace/flight file; ambiguity is an error, not a guess.

``--max-residual`` turns the report into a gate: attribution must
explain at least ``1 - FRAC`` of every request's TTFT window (windows
shorter than ``--min-window-ms`` are exempt — a residual fraction of a
sub-millisecond window is noise, not a diagnosis). CI runs this over
the committed drill traces with ``--max-residual 0.05``: if the doctor
stops being able to account for where tail latency goes, the build
fails, not the postmortem. Exit 0 = report (and gate, if any) clean;
1 = gate violation; 2 = bad input.
"""

import argparse
import json
import os
import sys
from typing import List, Optional

from .reqledger import (
    ATTRIBUTION_BUCKETS,
    DEFAULT_EXCLUDE_PREFIXES,
    build_ledger,
)

__all__ = ["resolve_input", "format_report", "main"]


def resolve_input(path: str) -> str:
    """A trace file stays itself; a directory must resolve to exactly
    one trace (merged output preferred)."""
    if os.path.isfile(path):
        return path
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no such trace or directory: {path}")
    cands: List[str] = []
    for root, _dirs, files in os.walk(path):
        for f in sorted(files):
            if f.endswith(".json") and "trace" in f.lower() \
                    or f.endswith("flight.bin"):
                cands.append(os.path.join(root, f))
    merged = [c for c in cands if "merged" in os.path.basename(c)]
    if len(merged) == 1:
        return merged[0]
    if len(cands) == 1:
        return cands[0]
    if not cands:
        raise FileNotFoundError(
            f"{path}: no trace JSON or flight.bin found")
    raise ValueError(
        f"{path}: ambiguous — {len(cands)} trace candidates and no "
        f"single merged trace; pass one explicitly: {cands}")


def format_report(report: dict, top: int = 5) -> str:
    lines: List[str] = []
    for axis in ("ttft", "e2e"):
        p = report[axis]
        lines.append(
            f"{axis.upper():<5} n={p['count']:<4} "
            f"p50={p['p50_ms']:.1f}ms  p90={p['p90_ms']:.1f}ms  "
            f"p99={p['p99_ms']:.1f}ms  max={p['max_ms']:.1f}ms")
    total = sum(report["buckets_total_ms"].values()) or 1.0
    lines.append("TTFT wall-clock by bucket (all requests):")
    for b in ATTRIBUTION_BUCKETS:
        v = report["buckets_total_ms"].get(b, 0.0)
        lines.append(f"  {b:<14} {v:>10.1f}ms  {100.0 * v / total:5.1f}%")
    victim = report.get("p99_victim")
    if victim:
        row = report["requests"][victim["rid"]]["ttft"]
        desc = f"p99 victim {victim['rid']}: " \
               f"{victim['ttft_ms']:.1f}ms TTFT, dominated by " \
               f"{victim['dominant_bucket']}"
        if victim["top_blocker"]:
            desc += f" (top blocker: {victim['top_blocker']})"
        lines.append(desc)
        for b in ATTRIBUTION_BUCKETS:
            v = row["buckets"].get(b, 0.0)
            if v > 0:
                lines.append(f"    {b:<14} {v:>8.1f}ms")
    if report["top_blockers"]:
        lines.append("top blockers (HOL time inflicted fleet-wide):")
        for blk in report["top_blockers"][:top]:
            lines.append(f"  {blk['rid']:<12} {blk['blocked_ms']:.1f}ms")
    lines.append(
        f"cost: {report['cost_per_1k_tokens']:.3f} device-s per 1k "
        f"tokens fleet-wide")
    for axis in ("replica", "version"):
        groups = report["economics"].get(axis, {})
        if len(groups) > 1 or (groups and axis == "replica"):
            for key, g in sorted(groups.items()):
                lines.append(
                    f"  {axis}={key}: {g['cost_per_1k_tokens']:.3f}/1k "
                    f"over {g['tokens']} tok, "
                    f"{g['retry_wasted_tokens']} wasted, "
                    f"kv {g['kv_block_s']:.2f} blk-s")
    lines.append(
        f"worst residual: "
        f"{100.0 * report['worst_residual_fraction']:.2f}% of a "
        f"request's TTFT window unattributed")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeperspeed_tpu_torch.monitor.slo",
        description="Per-request tail-latency attribution + cost ledger "
                    "from a serving trace.")
    ap.add_argument("trace",
                    help="trace JSON / flight.bin / drill artifact dir")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the full report as JSON")
    ap.add_argument("--top", type=int, default=5,
                    help="top-K blocker rids to print (default 5)")
    ap.add_argument("--max-residual", type=float, default=None,
                    help="gate: fail when any request's unattributed "
                         "TTFT fraction exceeds this (CI uses 0.05)")
    ap.add_argument("--min-window-ms", type=float, default=1.0,
                    help="exempt TTFT windows shorter than this from "
                         "the residual gate (default 1.0)")
    ap.add_argument("--include-warmup", action="store_true",
                    help="keep warm-* compile-warmup rids in the "
                         "doctored population (excluded by default)")
    args = ap.parse_args(argv)

    try:
        src = resolve_input(args.trace)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    report = build_ledger(
        src, top_blockers=args.top,
        exclude_prefixes=(() if args.include_warmup
                          else DEFAULT_EXCLUDE_PREFIXES))
    if not report["requests"]:
        print(f"error: {src}: no request-scoped events (req/submit / "
              f"serving/*) in trace", file=sys.stderr)
        return 2
    print(f"request-path doctor: {src}")
    print(format_report(report, top=args.top))
    if args.json_out:
        parent = os.path.dirname(os.path.abspath(args.json_out))
        os.makedirs(parent, exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"wrote {args.json_out}")

    if args.max_residual is not None:
        floor_us = args.min_window_ms * 1e3
        bad = []
        for rid, row in sorted(report["requests"].items()):
            att = row.get("ttft")
            if att is None:
                continue
            window_us = row["ttft_ms"] * 1e3
            if window_us < floor_us:
                continue
            if att["residual_fraction"] > args.max_residual:
                bad.append((rid, att["residual_fraction"]))
        if bad:
            for rid, frac in bad:
                print(f"GATE: {rid}: {100.0 * frac:.2f}% of TTFT "
                      f"unattributed (> {100.0 * args.max_residual:.1f}%)",
                      file=sys.stderr)
            return 1
        print(f"gate OK: every TTFT >= {args.min_window_ms:g}ms is "
              f">= {100.0 * (1 - args.max_residual):.0f}% attributed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
