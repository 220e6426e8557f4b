"""Cross-process trace merge: one timeline for a whole run.

Counterpart of deeperspeed_tpu/monitor/aggregate.py, with its own
``python -m`` entry.

A run leaves telemetry scattered across processes and incarnations —
the router's trace, each replica worker's trace, the supervisor's
trainer traces, and ``flight.bin`` tails recovered from SIGKILLed
processes. This module merges them into ONE validator-clean Chrome
trace with:

  * **per-process lanes** — every source gets a synthetic pid and a
    ``process_name`` built from its run context
    (``router#0``, ``replica-r1#0 (flight)``, ``trainer#2``), so
    Perfetto shows one labeled track group per incarnation;
  * **clock alignment** — tracer timestamps are process-local
    ``perf_counter`` microseconds. Each trace/flight carries a
    ``(wall, perf)`` anchor pair (runctx.clock_anchor); events are
    rebased onto the shared wall clock, with optional per-source
    offsets from the fleet's NTP-style handshake
    (``runctx.estimate_clock_offset``) for hosts whose wall clocks
    disagree;
  * **flow arrows across hops** — for every request the router
    dispatched (``serving/dispatch`` instants, args rid/replica/
    attempt) the merger finds the matching replica-side admission
    (``serving/admit``) and emits a Chrome flow ``s``/``f`` pair, so a
    rid's journey — admit at the router, prefill/decode on a replica,
    retry on another after a kill — renders as arrows across lanes;
  * **flight recovery markers** — events recovered from a flight file
    join the timeline as first-class events, plus one
    ``flight/recovered`` instant summarizing what the post-mortem got
    back (count, torn records, source file).

Library surface: ``merge_files(paths, ...) -> (doc, stats)``. CLI::

    python -m deeperspeed_tpu_torch.monitor.aggregate --out merged.json \
        router.trace.json replica-r1.i0.flight.bin replica-r0.i0.trace.json

Sources are auto-detected (flight magic vs JSON). A source that is a
DIRECTORY expands to every ``*.trace.json`` / ``*.flight.bin`` inside
it — the multi-host shape, where each host's ``trainer.h<k>`` role
writes its own obs files into one shared directory — and an
``offsets.json`` sidecar in that directory (the fleet supervisor's
clock-offset ledger, keyed by host role) is applied automatically.
``--strict`` runs the schema validator in strict mode on the merged
result and exits non-zero on problems; ``--offsets offsets.json`` maps
source basenames OR host roles to handshake-measured clock offsets in
seconds (explicit values win over directory sidecars).
"""

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

from . import flight as flight_mod
from .validate import validate_events

__all__ = ["expand_sources", "load_source", "merge_sources",
           "merge_files", "main"]

OFFSETS_SIDECAR = "offsets.json"


def expand_sources(paths: List[str]) -> List[str]:
    """Expand directory sources into their obs files, sorted by name so
    per-host lanes come out in host order. Non-directories pass through
    unchanged (missing files fail later, loudly, in load_source)."""
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            names = sorted(os.listdir(p))
            out.extend(os.path.join(p, n) for n in names
                       if n.endswith(".trace.json")
                       or n.endswith(".flight.bin"))
        else:
            out.append(p)
    return out


def _sidecar_offsets(paths: List[str]) -> Dict[str, float]:
    """Clock offsets from offsets.json sidecars of directory sources
    (the fleet supervisor's handshake ledger, keyed by host role)."""
    out: Dict[str, float] = {}
    for p in paths:
        if not os.path.isdir(p):
            continue
        sidecar = os.path.join(p, OFFSETS_SIDECAR)
        try:
            with open(sidecar) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        for k, v in doc.items():
            if isinstance(v, (int, float)):
                out[str(k)] = float(v)
    return out

# events on these names seed flow arrows: dispatch is the source side,
# admit the target side, matched per (rid, attempt) ordering
_FLOW_SRC = "serving/dispatch"
_FLOW_DST = "serving/admit"


class Source:
    """One per-process input: parsed events + run/clock metadata."""

    def __init__(self, path: str, kind: str, events: List[dict],
                 run: Optional[dict], clock: Optional[dict],
                 torn: int = 0, recovered: int = 0):
        self.path = path
        self.kind = kind                      # "trace" | "flight"
        self.events = events
        self.run = run or {}
        self.clock = clock                    # {"wall": s, "perf": s}
        self.torn = torn
        self.recovered = recovered
        self.offset_us = 0.0                  # handshake adjustment

    @property
    def label(self) -> str:
        role = self.run.get("role") or os.path.basename(self.path)
        inc = self.run.get("incarnation", 0)
        tag = f"{role}#{inc}"
        return f"{tag} (flight)" if self.kind == "flight" else tag


def load_source(path: str) -> Source:
    """Parse one input file, auto-detecting flight vs Chrome-trace."""
    if flight_mod.is_flight_file(path):
        snap = flight_mod.recover(path)
        run = {k: snap.meta.get(k) for k in
               ("run_id", "role", "incarnation") if k in snap.meta}
        return Source(path, "flight", snap.events, run,
                      snap.meta.get("clock"), torn=snap.torn,
                      recovered=len(snap.events))
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        events = doc.get("traceEvents", [])
        other = doc.get("otherData", {})
        return Source(path, "trace", events, other.get("run"),
                      other.get("clock"))
    return Source(path, "trace", doc, None, None)


def _source_offset_us(src: Source) -> Optional[float]:
    """Rebase term turning a source's perf-us timestamps into wall-us:
    ``wall_us = ts + offset``. None when the source has no anchor."""
    if not src.clock or "wall" not in src.clock or "perf" not in src.clock:
        return None
    return ((src.clock["wall"] - src.clock["perf"]) * 1e6
            + src.offset_us)


def _stitch_flows(events: List[dict]) -> List[dict]:
    """Chrome flow s/f pairs from router dispatches to replica admits.

    Match key is (rid, attempt-order): the k-th dispatch of a rid pairs
    with the k-th admit of that rid at a LATER (aligned) timestamp on a
    DIFFERENT pid — retries therefore get their own arrow to the
    replica that actually served them."""
    dispatches: Dict[str, List[dict]] = {}
    admits: Dict[str, List[dict]] = {}
    for ev in events:
        name = ev.get("name")
        rid = (ev.get("args") or {}).get("rid")
        if rid is None:
            continue
        if name == _FLOW_SRC:
            dispatches.setdefault(str(rid), []).append(ev)
        elif name == _FLOW_DST:
            admits.setdefault(str(rid), []).append(ev)
    flows: List[dict] = []
    flow_id = 0
    for rid, srcs in sorted(dispatches.items()):
        cands = sorted(admits.get(rid, []), key=lambda e: e.get("ts", 0))
        used = [False] * len(cands)
        for src in sorted(srcs, key=lambda e: e.get("ts", 0)):
            match = None
            for i, dst in enumerate(cands):
                if used[i] or dst.get("pid") == src.get("pid"):
                    continue
                if dst.get("ts", 0) >= src.get("ts", 0):
                    match = i
                    break
            if match is None:
                continue
            used[match] = True
            dst = cands[match]
            flow_id += 1
            common = {"name": "run/rid_hop", "cat": "rid", "id": flow_id}
            flows.append({**common, "ph": "s", "ts": src["ts"],
                          "pid": src["pid"], "tid": src["tid"],
                          "args": {"rid": rid}})
            flows.append({**common, "ph": "f", "bp": "e", "ts": dst["ts"],
                          "pid": dst["pid"], "tid": dst["tid"],
                          "args": {"rid": rid}})
    return flows


def merge_sources(sources: List[Source]) -> Tuple[dict, dict]:
    """Merge parsed sources into one Chrome-trace doc. Returns
    ``(doc, stats)``; stats carries per-source event counts, recovery
    numbers, alignment info, and the flow-arrow count."""
    merged: List[dict] = []
    stats = {"sources": [], "flow_arrows": 0, "events": 0,
             "recovered_events": 0, "unaligned_sources": 0}
    offsets = [_source_offset_us(s) for s in sources]
    for pid, (src, off) in enumerate(zip(sources, offsets), start=1):
        aligned = off is not None
        if not aligned:
            stats["unaligned_sources"] += 1
        kept = 0
        last_ts = 0.0
        for ev in src.events:
            if not isinstance(ev, dict):
                continue
            if ev.get("ph") == "M":
                if ev.get("name") == "process_name":
                    continue       # replaced by the merged label below
                ev = dict(ev)
                ev["pid"] = pid
                merged.append(ev)
                continue
            ev = dict(ev)
            ev["pid"] = pid
            if aligned and isinstance(ev.get("ts"), (int, float)):
                ev["ts"] = ev["ts"] + off
            if isinstance(ev.get("ts"), (int, float)):
                last_ts = max(last_ts, ev["ts"])
            run_id = src.run.get("run_id")
            if run_id:
                args = dict(ev.get("args") or {})
                args.setdefault("run_id", run_id)
                ev["args"] = args
            merged.append(ev)
            kept += 1
        merged.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": src.label}})
        if src.kind == "flight":
            merged.append({
                "name": "flight/recovered", "ph": "i", "s": "p",
                "ts": last_ts, "pid": pid, "tid": 0,
                "args": {"count": src.recovered, "torn": src.torn,
                         "source": os.path.basename(src.path)},
            })
            stats["recovered_events"] += src.recovered
        stats["sources"].append({
            "path": src.path, "kind": src.kind, "label": src.label,
            "events": kept, "aligned": aligned, "torn": src.torn,
        })
        stats["events"] += kept
    # rebase the whole merged timeline to zero: wall-epoch microseconds
    # overflow Perfetto's niceties and the validator requires ts >= 0
    t0 = min((ev["ts"] for ev in merged
              if ev.get("ph") != "M"
              and isinstance(ev.get("ts"), (int, float))), default=0.0)
    for ev in merged:
        if ev.get("ph") != "M" and isinstance(ev.get("ts"), (int, float)):
            ev["ts"] = max(0.0, ev["ts"] - t0)
    flows = _stitch_flows(merged)
    stats["flow_arrows"] = len(flows) // 2
    merged.extend(flows)
    doc = {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {
            "merged_from": [os.path.basename(s.path) for s in sources],
            "run": next((s.run for s in sources if s.run.get("run_id")),
                        {}),
        },
    }
    return doc, stats


def merge_files(paths: List[str], out: Optional[str] = None,
                offsets_s: Optional[Dict[str, float]] = None,
                ) -> Tuple[dict, dict]:
    """Load, align, merge, and optionally write. ``offsets_s`` maps a
    source basename OR its run-context role to its handshake-measured
    wall-clock offset in seconds (how far that host's clock runs
    ahead). Directory entries in ``paths`` expand to their obs files,
    and their offsets.json sidecars merge in under explicit values."""
    offsets = _sidecar_offsets(paths)
    offsets.update(offsets_s or {})
    sources = [load_source(p) for p in expand_sources(paths)]
    for src in sources:
        if offsets:
            off = offsets.get(os.path.basename(src.path))
            if off is None:
                # multi-host ledgers key by role (trainer.h1), which
                # survives the per-incarnation file renames
                role = (src.run or {}).get("role")
                off = offsets.get(str(role or ""))
            if off is not None:
                # the source's clock runs `off` ahead: subtract to land
                # its events on the reference timeline
                src.offset_us = -off * 1e6
    doc, stats = merge_sources(sources)
    if out is not None:
        parent = os.path.dirname(os.path.abspath(out))
        os.makedirs(parent, exist_ok=True)
        with open(out, "w") as f:
            json.dump(doc, f)
            f.write("\n")
    return doc, stats


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeperspeed_tpu_torch.monitor.aggregate",
        description="Merge per-process Chrome traces and recovered "
                    "flight snapshots into one aligned timeline.")
    ap.add_argument("sources", nargs="+",
                    help="trace JSON and/or flight.bin files "
                         "(auto-detected), or obs directories that "
                         "expand to every trace/flight file inside")
    ap.add_argument("--out", required=True, help="merged trace path")
    ap.add_argument("--offsets", default=None, metavar="JSON",
                    help="file mapping source basename or host role -> "
                         "clock offset seconds (from the fleet clock "
                         "handshake)")
    ap.add_argument("--strict", action="store_true",
                    help="validate the merged trace in strict mode; "
                         "non-zero exit on problems")
    args = ap.parse_args(argv)
    offsets = None
    if args.offsets:
        with open(args.offsets) as f:
            offsets = {k: float(v) for k, v in json.load(f).items()}
    doc, stats = merge_files(args.sources, out=args.out,
                             offsets_s=offsets)
    for s in stats["sources"]:
        extras = "" if s["aligned"] else ", unaligned"
        if s["torn"]:
            extras += f", torn={s['torn']}"
        print(f"  {s['label']:<24} {s['events']:>6} events "
              f"[{s['kind']}{extras}]")
    print(f"wrote {args.out}: {stats['events']} events from "
          f"{len(stats['sources'])} sources, "
          f"{stats['recovered_events']} recovered from flight, "
          f"{stats['flow_arrows']} flow arrows")
    problems = validate_events(doc["traceEvents"], strict=args.strict)
    if problems:
        for p in problems:
            print(f"merged trace: {p}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
