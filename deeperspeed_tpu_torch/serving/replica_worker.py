"""Subprocess replica runner: one ServingEngine behind a line-JSON pipe.

Counterpart of deeperspeed_tpu/serving/replica_worker.py, with the same
protocol.

``python -m deeperspeed_tpu_torch.serving.replica_worker --spec spec.json``
builds a GPT from the spec (config kwargs + init seed, drawn through a
``torch.Generator`` on the spec's device: every replica of a fleet holds
the same bytes, which is what makes cross-replica retries
token-identical) and serves requests over a newline-delimited JSON
protocol:

parent -> child (stdin)::

    {"op": "submit", "rid": ..., "prompt": [...],
     "max_new_tokens": N, "temperature": T, "seed": S}
    {"op": "cancel", "rid": ..., "reason": "timeout"}
    {"op": "drain"}          # reject new work, finish what's in flight
    {"op": "stop"}           # graceful exit

child -> parent (stdout; logs go to stderr, stdout is protocol-only)::

    {"ev": "ready", "nvcc_s": ...}                   # engine warm
    {"ev": "hb", "progress": N, "inflight": [...],
     "draining": bool, "launches": {...}}            # every loop turn
    {"ev": "first", "rid": ...}                      # first token out
    {"ev": "fin", "rid": ..., "tokens": [...], "reason": ...}
    {"ev": "err", "rid": ..., "error": ...}          # submit rejected

``launches`` counts the fused LN and bias+GeLU kernel launches since the
warmup; ``nvcc_s`` is the seconds this process spent in ``nvcc`` (0 when
every kernel loaded from ``build/kernels/``, as a fleet whose parent
built them expects).

The spec's keys: ``gpt`` (GPTConfig kwargs; ``dtype`` a name such as
``"bfloat16"``, default ``"float32"``), ``init_seed``, ``device``
(default ``"cuda"``; the CPU tests pass ``"cpu"``), ``weights``
(``{"load_dir", "tag"}``: a checkpoint whose module tree replaces the
init), ``serving`` (the serving block; its ``"fleet"`` sub-block is the
router's and is ignored here), ``kernels`` (the kernels block), ``monitor``,
``warm`` (default true), ``poll_interval_s`` and ``faults``. An engine that
fails to build (a kernel that does not load, no CUDA device) raises: the
process exits non-zero with the traceback on stderr.

The worker is where the fleet drill's faults land: it calls
``FaultInjector.on_decode_step`` once per engine step, so
``DS_TPU_FAULTS='{"replica_sigkill_at_decode": 12}'`` kills THIS replica
mid-decode and ``replica_stall_at_decode`` wedges it (alive and
heartbeating, emitting no tokens): the two failure modes the router's
watchdogs must distinguish.
"""

import argparse
import json
import os
import queue
import sys
import threading
import time
from typing import Optional, Sequence

WARM_RID = "_warm"   # internal warmup request, never reported

_DTYPES = ("float32", "bfloat16", "float16")


def _emit(obj: dict) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def _stdin_reader(q: "queue.Queue[Optional[dict]]") -> None:
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            q.put(json.loads(line))
        except json.JSONDecodeError:
            print(f"replica_worker: bad op line {line!r}", file=sys.stderr)
    q.put(None)   # EOF: parent is gone -> orderly exit


def _load_weights(params, weights: dict):
    """Replace init params with a published checkpoint's module tree.

    ``weights`` is the pointer ``SubprocessReplica.set_weights`` pushes:
    ``{"load_dir", "tag"}`` naming a trainer checkpoint (either package's
    files: checkpoint/serialization reads both). Every replica pinned to
    the same version loads the same bytes, which keeps version-pinned
    failover retries token-identical. Each leaf keeps the init's dtype
    and device."""
    import numpy as np
    import torch

    from ..checkpoint.serialization import load_tree, model_state_filename

    path = os.path.join(str(weights["load_dir"]), str(weights["tag"]),
                        model_state_filename())
    module = load_tree(path)["module"]

    def assign(dst, src, prefix):
        if set(dst) != set(src):
            raise ValueError(
                f"{path}: module keys {sorted(src)} at {prefix or '/'} do "
                f"not match the model's {sorted(dst)}")
        out = {}
        for k, v in dst.items():
            if isinstance(v, dict):
                out[k] = assign(v, src[k], f"{prefix}{k}/")
                continue
            leaf = src[k]
            t = leaf if isinstance(leaf, torch.Tensor) else \
                torch.from_numpy(np.asarray(leaf))
            if tuple(t.shape) != tuple(v.shape):
                raise ValueError(f"{path}: {prefix}{k} has shape "
                                 f"{tuple(t.shape)}, the model "
                                 f"{tuple(v.shape)}")
            out[k] = t.to(device=v.device, dtype=v.dtype)
        return out

    return assign(params, module, "")


def build_engine(spec: dict):
    """GPT + ServingEngine from a replica spec: init from ``init_seed``
    through a ``torch.Generator`` on the spec's device, so every replica
    holds the same weights. A ``weights`` block swaps in a published
    checkpoint (the same determinism, anchored to the checkpoint's
    bytes)."""
    import torch

    from ..models.gpt import GPTConfig, init_params
    from ..ops import kernel_config
    from .config import ServingConfig
    from .engine import ServingEngine

    device = spec.get("device", "cuda")
    gpt_kwargs = dict(spec.get("gpt") or {})
    dtype = gpt_kwargs.get("dtype", "float32")
    if dtype not in _DTYPES:
        raise ValueError(f"gpt.dtype must be one of {_DTYPES}, got {dtype!r}")
    gpt_kwargs["dtype"] = getattr(torch, dtype)
    cfg = GPTConfig(**gpt_kwargs)
    if spec.get("kernels") is not None:
        kernel_config.configure(**kernel_config.validate(spec["kernels"]))
    gen = torch.Generator(device=device).manual_seed(
        int(spec.get("init_seed", 0)))
    params = init_params(gen, cfg, device=device,
                         dtype=None if cfg.dtype == torch.float32
                         else cfg.dtype)
    if spec.get("weights"):
        params = _load_weights(params, spec["weights"])
    scfg = ServingConfig.from_dict(
        {k: v for k, v in (spec.get("serving") or {}).items()
         if k != "fleet"})
    return ServingEngine(cfg, params, scfg, device=device)


def _launch_counters():
    from ..ops import fused_blocks as fb

    return {"ln_fwd": fb.ln_fwd, "bias_gelu_fwd": fb.bias_gelu_fwd}


def serve(spec: dict, injector=None) -> int:
    from ..monitor import init_monitor, shutdown_monitor
    from ..monitor.runctx import current as current_run
    from ..ops import op_builder
    from ..utils.logging import logger
    from .engine import EngineDrainingError

    # stdout carries the protocol only
    for h in logger.handlers:
        if hasattr(h, "setStream"):
            h.setStream(sys.stderr)
    run_ctx = current_run()
    if spec.get("monitor"):
        # before build_engine so the warmup is traced; with an obs_dir the
        # paths derive from DS_TPU_ROLE/INCARNATION set by the parent
        # fleet, and the flight recorder makes this worker's tail survive
        # the drill's SIGKILL
        init_monitor(spec["monitor"])

    eng = build_engine(spec)
    if injector is None:
        from ..resilience.faults import FaultInjector, \
            plan_from_config_and_env

        injector = FaultInjector(plan_from_config_and_env(
            spec.get("faults")))

    if spec.get("warm", True):
        # run the decode path and the smallest prefill once up front so
        # fault step counts and health timings hit a warm engine; the
        # sampled path too
        rid = eng.submit([1, 2, 3], max_new_tokens=2, request_id=WARM_RID)
        eng.submit([4, 5, 6], max_new_tokens=2, temperature=0.5,
                   request_id=WARM_RID + "2")
        eng.run()
        if eng.get(rid).state != "finished":
            raise RuntimeError("replica warmup request did not finish")
    counters = _launch_counters()
    for fn in counters.values():
        fn.launches = 0

    ops: "queue.Queue[Optional[dict]]" = queue.Queue()
    threading.Thread(target=_stdin_reader, args=(ops,), daemon=True).start()
    _emit({"ev": "ready", "run_id": run_ctx.run_id, "role": run_ctx.role,
           "incarnation": run_ctx.incarnation, "wall_t": time.time(),
           "nvcc_s": sum(i["seconds"]
                         for i in op_builder.build_info.values())})

    poll_s = float(spec.get("poll_interval_s", 0.002))
    decode_i = 0
    stalled = False
    draining = False
    stopping = False
    first_sent = set()
    reported = set()
    tracked = []   # rids in submission order, for first/fin scans

    while True:
        while True:
            try:
                op = ops.get_nowait()
            except queue.Empty:
                break
            if op is None or op.get("op") == "stop":
                stopping = True
                break
            kind = op.get("op")
            if kind == "submit":
                try:
                    if draining:
                        raise EngineDrainingError("replica draining")
                    eng.submit(op["prompt"],
                               max_new_tokens=op.get("max_new_tokens"),
                               temperature=op.get("temperature", 0.0),
                               request_id=op["rid"],
                               seed=op.get("seed"))
                    tracked.append(op["rid"])
                except Exception as e:  # noqa: BLE001 - reported upstream
                    _emit({"ev": "err", "rid": op.get("rid"),
                           "error": f"{type(e).__name__}: {e}"})
            elif kind == "cancel":
                eng.cancel(op["rid"], op.get("reason", "timeout"))
            elif kind == "drain":
                draining = True
            elif kind == "clock":
                # NTP-style handshake leg: echo the parent's t0 with our
                # wall time so it can estimate this host's clock offset
                _emit({"ev": "clock", "t0": op.get("t0"),
                       "t_child": time.time()})
            else:
                print(f"replica_worker: unknown op {op!r}", file=sys.stderr)
        if stopping:
            break

        if eng.has_work() and not stalled:
            decode_i += 1
            verdict = injector.on_decode_step(decode_i)
            if verdict == "stall":
                stalled = True
            else:
                eng.step()
        else:
            time.sleep(poll_s)

        # report first tokens and finishes in submission order
        for rid in tracked:
            req = eng.get(rid)
            if rid not in first_sent and req.first_token_t is not None:
                first_sent.add(rid)
                _emit({"ev": "first", "rid": rid})
            if rid not in reported and req.state == "finished":
                reported.add(rid)
                _emit({"ev": "fin", "rid": rid, "tokens": req.output,
                       "reason": req.finish_reason})
        inflight = [r for r in tracked if r not in reported]
        _emit({"ev": "hb", "progress": int(eng.metrics.total_generated),
               "inflight": inflight, "draining": draining,
               "launches": {k: fn.launches for k, fn in counters.items()}})
        if draining and not inflight and not eng.has_work():
            break

    shutdown_monitor(save=True)   # graceful exits write the full trace
    _emit({"ev": "bye"})
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeperspeed_tpu_torch.serving.replica_worker")
    ap.add_argument("--spec", required=True,
                    help="JSON replica spec: {gpt: {...GPTConfig kwargs}, "
                         "init_seed, device, weights, serving: {...}, "
                         "kernels, monitor, warm, poll_interval_s, faults}")
    args = ap.parse_args(argv)
    with open(args.spec) as f:
        spec = json.load(f)
    return serve(spec)


if __name__ == "__main__":
    sys.exit(main())
