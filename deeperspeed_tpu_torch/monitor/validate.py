"""Chrome-trace schema validator.

Counterpart of deeperspeed_tpu/monitor/validate.py: the same schemas,
prefixes and CLI.

Checks the invariants Perfetto/chrome://tracing rely on, so a bad trace
fails in CI instead of rendering as an empty timeline:

  * top level is a JSON event array or ``{"traceEvents": [...]}``;
  * every event is an object carrying ``ph``, ``pid``, ``tid`` (and
    ``name`` + numeric non-negative ``ts`` for non-metadata phases);
  * ``ph`` is a known phase; ``"X"`` events carry a numeric
    non-negative ``dur``;
  * ``"B"``/``"E"`` pairs balance per ``(pid, tid)`` track with proper
    LIFO nesting (an ``E`` must close the innermost open ``B`` of the
    same name);
  * named events with a registered arg schema (the serving fleet's
    ``serving/finish`` / ``serving/shed`` / ``serving/retry`` /
    ``serving/replica_down`` instants) carry their required args — a
    drill trace missing the rid/reason fields the zero-loss audit keys
    on fails here, not in a dashboard.

Strict mode adds name discipline: every non-metadata event must carry a
name under a registered subsystem prefix (``engine/``, ``serving/``,
``flight/``, ``goodput/``, ...) or be a known exact name
(``xla_compile``, ``recompile!``). Default (non-strict) keeps the
original behavior — unknown names pass, so ad-hoc spans in user code
stay legal; strict is what CI runs on merged drill traces, where an
unknown name means a producer and the schema drifted apart.

Used two ways: as a library (``validate_events`` / ``validate_file``,
the pytest round-trips a generated trace through it) and as a CLI::

    python -m deeperspeed_tpu_torch.monitor.validate [--strict] trace.json

exit 0 = valid, exit 1 = problems (one per line on stderr).
"""

import json
import sys
from typing import List

__all__ = ["validate_events", "validate_file", "main"]

# phases from the Trace Event Format spec; "M" (metadata) and "C"
# (counter) are what the tracer emits beyond spans/instants
KNOWN_PHASES = set("BEXiICMPSTFsftbenO(N)D{}v")

# named-event arg schemas: when an event with one of these names appears,
# its "args" object must carry the listed keys. These are the events the
# fleet drill's zero-request-loss audit and the retry/shed accounting
# join on, so a rename or dropped field breaks CI, not the postmortem.
EVENT_ARG_SCHEMAS = {
    "serving/finish": ("rid", "reason"),
    "serving/shed": ("rid", "retry_after_s"),
    "serving/retry": ("rid", "attempt", "replica"),
    "serving/replica_down": ("replica", "cause", "inflight"),
    # run-scoped observability (flight recorder / aggregate / goodput)
    "serving/dispatch": ("rid", "replica", "attempt"),
    # request-path doctor (monitor/reqledger.py): the per-rid timeline
    # is reconstructed by joining exactly these events — a dropped rid
    # or ts breaks attribution, so the schemas are load-bearing
    "serving/admit": ("rid", "slot", "ctx_len", "admissions"),
    "serving/prefill": ("rid", "ctx_len"),
    "serving/preempt": ("rid", "slot", "blocks_freed"),
    # prefix-radix KV reuse + chunked prefill: reuse hits are the
    # aggregator's flow-arrow source per rid, CoW splits audit the
    # exactly-once divergence invariant, and chunk spans are what the
    # reqledger splits across its prefill/hol_blocking buckets
    "kv/reuse": ("rid", "matched_tokens", "shared_blocks"),
    "kv/cow_split": ("rid", "block", "rows"),
    "serving/prefill_chunk": ("rid", "chunk", "tokens"),
    "req/submit": ("rid", "prompt_len"),
    "req/accept": ("rid", "cost_tokens"),
    "req/requeue": ("rid", "backoff_s"),
    "slo/violation": ("slo", "value_ms", "target_ms"),
    "trace/dropped": ("dropped",),
    "flight/recovered": ("count", "torn", "source"),
    "run/start": ("run_id", "role", "incarnation"),
    "run/preempt": ("signum",),
    "goodput/report": ("wall_s", "goodput"),
    # comm overlap scheduling: per-bucket reduce launches must say
    # whether they were overlapped, and every drain must say how many
    # buckets it waited on — overlap_fraction in BENCH_comm.json joins
    # on exactly these spans
    "comm/reduce": ("bucket", "mode"),
    "comm/overlap_window": ("buckets",),
    # perf doctor: compiled-cost captures, live per-step MFU, and the
    # device-memory watermark lane — PERF_LEDGER tooling and the
    # roofline readout join on these
    "perf/compiled": ("entry", "flops", "bytes", "peak_hbm"),
    "perf/step": ("entry", "mfu", "wall_ms", "verdict"),
    "mem/watermark": ("phase", "bytes_in_use", "peak_bytes"),
    "mem/postmortem": ("reason", "bytes_in_use", "buffers"),
    "mem/buffer": ("rank", "shape", "dtype", "nbytes", "sharding"),
    # sharding substrate: every mesh build announces its layout, and the
    # bench's placement audits record what actually sharded — BENCH_mesh
    # and post-hoc layout debugging join on these
    "mesh/build": ("axes", "devices"),
    "mesh/audit": ("tree", "sharded_frac", "digest"),
    # lifecycle control plane: every live re-mesh span names both
    # topologies (the goodput `remesh` bucket and the drill's audit
    # join on it); publishes/rollouts/repins carry the version so
    # mixed-version routing is reconstructible from the trace alone
    "lifecycle/remesh": ("world_from", "world_to"),
    "lifecycle/publish": ("version", "tag", "step"),
    "lifecycle/rollout": ("replica", "version"),
    "lifecycle/repin": ("rid", "version"),
    # speculative decoding (serving/spec): per-round draft/verify
    # dispatches carry their device-seconds so the reqledger can split
    # decode attribution into draft vs verify cost, and per-rid accept
    # instants are what acceptance-rate accounting joins on
    "spec/draft": ("n_active", "k", "dur_us"),
    "spec/verify": ("n_active", "k", "dur_us"),
    "spec/accept": ("rid", "accepted", "k", "emitted"),
    # multi-host runtime (distributed/): every process stamps its
    # topology at distributed init (the merged fleet timeline and
    # BENCH_multihost join per-host lanes on these). Fleet-side
    # coordination — rendezvous, restart barriers, pool growth — is
    # recorded in the supervisor's restart JSONL and the rendezvous
    # records, not as trace events (the supervisor owns no trace lane)
    "dist/init": ("process", "processes", "local_devices",
                  "global_devices"),
}

# strict-mode name discipline: one prefix per subsystem that emits
# events, plus the exact names outside any subsystem
KNOWN_EVENT_PREFIXES = (
    "engine/", "pipe/", "offload/", "comm/", "kernels/", "datapipe/",
    "resilience/", "serving/", "flight/", "run/", "goodput/", "trace/",
    "perf/", "mem/", "mesh/", "ablation/", "lifecycle/", "req/", "slo/",
    "kv/", "spec/", "dist/",
)
KNOWN_EVENT_NAMES = frozenset({
    "xla_compile", "recompile!", "process_name", "thread_name",
})


def _known_name(name) -> bool:
    return (isinstance(name, str)
            and (name in KNOWN_EVENT_NAMES
                 or name.startswith(KNOWN_EVENT_PREFIXES)))

_NUM = (int, float)


def _is_num(v) -> bool:
    return isinstance(v, _NUM) and not isinstance(v, bool)


def validate_events(events, strict: bool = False) -> List[str]:
    """Returns a list of problems; empty means the trace is valid.
    ``strict`` additionally rejects event names outside the registered
    subsystem prefixes / known exact names."""
    if not isinstance(events, list):
        return [f"traceEvents must be a list, got {type(events).__name__}"]
    errors: List[str] = []
    open_stacks = {}  # (pid, tid) -> [names of open B events]
    for i, ev in enumerate(events):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object "
                          f"({type(ev).__name__})")
            continue
        ph = ev.get("ph")
        if ph is None:
            errors.append(f"{where}: missing required field 'ph'")
            continue
        if not isinstance(ph, str) or ph not in KNOWN_PHASES:
            errors.append(f"{where}: unknown phase {ph!r}")
            continue
        for field in ("pid", "tid"):
            if field not in ev:
                errors.append(f"{where} (ph={ph}): missing required "
                              f"field {field!r}")
        if ph == "M":
            continue  # metadata: no ts/name requirements
        if "name" not in ev:
            errors.append(f"{where} (ph={ph}): missing required field "
                          f"'name'")
        elif strict and not _known_name(ev["name"]):
            errors.append(
                f"{where} (ph={ph}): unknown event name {ev['name']!r} "
                f"(strict mode requires a registered subsystem prefix)")
        ts = ev.get("ts")
        if ts is None:
            errors.append(f"{where} (ph={ph}): missing required field 'ts'")
        elif not _is_num(ts) or ts < 0:
            errors.append(f"{where} (ph={ph}): 'ts' must be a "
                          f"non-negative number, got {ts!r}")
        schema = EVENT_ARG_SCHEMAS.get(ev.get("name"))
        if schema is not None:
            args = ev.get("args")
            if not isinstance(args, dict):
                errors.append(f"{where}: {ev.get('name')!r} requires an "
                              f"'args' object with {sorted(schema)}")
            else:
                missing = [k for k in schema if k not in args]
                if missing:
                    errors.append(f"{where}: {ev.get('name')!r} args "
                                  f"missing {missing}")
        if ph == "X":
            dur = ev.get("dur")
            if dur is None:
                errors.append(f"{where}: 'X' event missing 'dur'")
            elif not _is_num(dur) or dur < 0:
                errors.append(f"{where}: 'dur' must be a non-negative "
                              f"number, got {dur!r}")
        if ph in ("B", "E"):
            track = (ev.get("pid"), ev.get("tid"))
            stack = open_stacks.setdefault(track, [])
            name = ev.get("name")
            if ph == "B":
                stack.append(name)
            else:
                if not stack:
                    errors.append(f"{where}: 'E' with no open 'B' on "
                                  f"track pid={track[0]} tid={track[1]}")
                elif stack[-1] != name:
                    errors.append(
                        f"{where}: 'E' for {name!r} does not close the "
                        f"innermost open 'B' ({stack[-1]!r}) on track "
                        f"pid={track[0]} tid={track[1]}")
                    stack.pop()
                else:
                    stack.pop()
    for (pid, tid), stack in open_stacks.items():
        for name in stack:
            errors.append(f"unbalanced 'B' event {name!r} never closed "
                          f"on track pid={pid} tid={tid}")
    return errors


def validate_file(path: str, strict: bool = False) -> List[str]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        return [f"cannot read {path}: {e}"]
    except json.JSONDecodeError as e:
        return [f"{path} is not valid JSON: {e}"]
    if isinstance(doc, dict):
        if "traceEvents" not in doc:
            return [f"{path}: object form must carry 'traceEvents'"]
        doc = doc["traceEvents"]
    return validate_events(doc, strict=strict)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    strict = False
    if "--strict" in argv:
        strict = True
        argv = [a for a in argv if a != "--strict"]
    if len(argv) != 1 or argv[0] in ("-h", "--help"):
        print(__doc__, file=sys.stderr)
        return 2
    errors = validate_file(argv[0], strict=strict)
    if errors:
        for e in errors:
            print(e, file=sys.stderr)
        print(f"{argv[0]}: INVALID ({len(errors)} problem(s))",
              file=sys.stderr)
        return 1
    print(f"{argv[0]}: OK{' (strict)' if strict else ''}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
