"""Measured confirmation of the cost model's ranking.

Counterpart of deeperspeed_tpu/autotune/confirm.py. The static model earns
trust by being checked, not believed: a spread of the ranking (the top-K
with pairwise-distinct predictions, plus the predicted-worst) is re-run
through the real engine, ``train_batch`` steps on the synthetic token
stream, median step time over the post-warmup steps, and the predicted
order is held against the measured one with Spearman's rank correlation.

``select_spread``, ``spearman``, ``rank_correlation`` and
``_token_stream`` are the reference's as they are. The reference runs its
8 virtual devices in one process; a world of N in the port is N rank
processes, so :func:`confirm_candidates` starts them itself, one start a
candidate (``torch.multiprocessing.start_processes`` with the caller's
start method), joined over a ``FileStore`` in a temporary directory: NCCL
where each rank has a card, gloo where the ranks share one (or run on the
CPU). A candidate that fails keeps an ``"error"`` entry and ranks last.
"""

import json
import os
import statistics
import tempfile
import time
from typing import Dict, List, Optional, Sequence

from .costmodel import CandidatePrice, build_candidate_engine
from .space import LayoutCandidate, ModelSpec, resolve_block

__all__ = ["confirm_candidates", "rank_correlation", "select_spread",
           "spearman"]

# how long a rank waits for the others at the rendezvous and in a
# collective
RANK_TIMEOUT_S = 600


def select_spread(
    ranked: Sequence[CandidatePrice],
    k: int = 4,
    resolution_s: float = 5e-4,
) -> List[CandidatePrice]:
    """Pick up to ``k`` candidates with pairwise-distinct predicted costs
    (fastest first), always keeping the predicted-best and the
    predicted-worst. Near-ties are skipped on purpose: a rank check over
    candidates the model itself calls equal would measure scheduler
    noise, not the model."""
    sel: List[CandidatePrice] = []
    last = None
    for p in ranked:
        if last is None or p.predicted_step_s - last >= resolution_s:
            sel.append(p)
            last = p.predicted_step_s
        if len(sel) >= k:
            break
    if ranked and ranked[-1].name not in {p.name for p in sel}:
        sel.append(ranked[-1])
    return sel


def _ranks(xs: Sequence[float]) -> List[float]:
    """Average ranks (ties share their mean rank)."""
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    ranks = [0.0] * len(xs)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and xs[order[j + 1]] == xs[order[i]]:
            j += 1
        mean = (i + j) / 2.0 + 1.0
        for k in range(i, j + 1):
            ranks[order[k]] = mean
        i = j + 1
    return ranks


def spearman(xs: Sequence[float], ys: Sequence[float]) -> float:
    """Spearman rank correlation (Pearson over average ranks)."""
    if len(xs) != len(ys) or len(xs) < 2:
        return 0.0
    rx, ry = _ranks(xs), _ranks(ys)
    n = len(xs)
    mx = sum(rx) / n
    my = sum(ry) / n
    cov = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    vx = sum((a - mx) ** 2 for a in rx)
    vy = sum((b - my) ** 2 for b in ry)
    if vx == 0 or vy == 0:
        return 0.0
    return cov / (vx * vy) ** 0.5


def _layout_from_price(price: CandidatePrice, world: int) -> LayoutCandidate:
    extents = resolve_block(price.detail["mesh"], world)
    return LayoutCandidate(
        name=price.name, axes=tuple(extents.items()),
        zero_stage=int(price.detail.get("zero_stage", 1)))


def _token_stream(model: ModelSpec, rows: int, steps: int, seed: int = 0):
    import numpy as np

    rs = np.random.RandomState(seed)
    base = rs.randint(0, model.vocab,
                      size=(rows * steps, model.seq + 1)).astype(np.int32)
    base[:, 1::2] = base[:, :-1:2]  # learnable periodic structure
    return base


def _rank(rank: int, world: int, tmp: str, job: dict) -> None:
    """One rank of a candidate's measured run (started by
    ``confirm_candidates``): joins the world, trains ``warmup + steps``
    steps and writes ``rank{rank}.json`` under ``tmp``: the losses, each
    step's seconds, the kernel launches, the peak device bytes, the cost
    the monitor's live cost index recorded for the first step (what the
    planning capture is held against) and the placement audits of the
    params and the optimizer state."""
    import datetime

    import torch
    import torch.distributed as dist

    from ..monitor import init_monitor, shutdown_monitor
    from ..monitor.config import MonitorConfig
    from ..sharding.audit import audit_tree, placements, tree_digest
    from .capture import kernel_launches

    device = job["device"]
    backend = "gloo"
    if device == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(rank % cards)
        if cards >= world:
            backend = "nccl"
    # the ranks share this host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    # the live cost index records the first step (a warmup step); no
    # tracing and no watchdog, so the timed steps pay only its MFU readout
    mon = init_monitor(MonitorConfig(perf=True, trace_enabled=False,
                                     watchdog="off"))
    try:
        model = ModelSpec(**job["model"])
        layout = LayoutCandidate(job["name"], tuple(
            (a, int(n)) for a, n in job["axes"]), job["zero_stage"])
        engine = build_candidate_engine(
            model, layout, world, micro=job["micro"], gas=job["gas"],
            comm_block=job["comm"], kernels=job["kernels"], device=device,
            seed=job["seed"])
        rows = (engine.train_micro_batch_size_per_gpu() * job["gas"]
                * engine.data_parallel_size)
        n = job["steps"] + job["warmup"]
        data = _token_stream(model, rows, n, job["seed"])
        before = kernel_launches()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        losses, seconds = [], []
        for i in range(n):
            batch = data[i * rows:(i + 1) * rows]
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            seconds.append(time.perf_counter() - t0)
        after = kernel_launches()
        live = mon.cost_index.get("engine/train_step")
        state = placements(engine, "state")
        params = placements(engine, "params")
        audit = {"params": audit_tree(engine.params, engine.mesh, params),
                 "param_specs": {k: v["spec"] for k, v in tree_digest(
                     engine.params, params, engine.mesh).items()}}
        for key, tree in (("master", engine.master),
                          ("exp_avg", engine.opt_state.exp_avg),
                          ("exp_avg_sq", engine.opt_state.exp_avg_sq)):
            if tree is not None:
                audit[key] = audit_tree(tree, engine.mesh, state)
        report = {
            "losses": losses,
            "seconds": seconds,
            "launches": {k: after[k] - before[k] for k in after},
            "peak_bytes": (torch.cuda.max_memory_allocated()
                           if device == "cuda" else None),
            "backend": backend,
            "live_cost": {"flops": live.flops, "bytes": live.bytes_accessed,
                          "error": live.error},
            "audit": audit,
        }
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        shutdown_monitor(save=False)
        dist.destroy_process_group()


def run_ranks(job: dict, world: int, start_method: str = "spawn"
              ) -> List[dict]:
    """Start ``world`` rank processes of ``job`` (see ``_rank``) and
    return their reports, in rank order; a rank that raises raises
    here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(world, tmp, job), nprocs=world,
                           start_method=start_method, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append(json.load(f))
    return out


def confirm_candidates(
    prices: Sequence[CandidatePrice],
    model: ModelSpec,
    world: int,
    *,
    steps: int = 6,
    warmup: int = 2,
    micro: int = 2,
    gas: int = 1,
    seed: int = 0,
    log=None,
    kernels: Optional[dict] = None,
    device: Optional[str] = None,
    start_method: str = "spawn",
) -> List[Dict[str, object]]:
    """Short measured runs for each candidate, ``world`` rank processes
    each (on the card unless ``device="cpu"``); returns one entry per
    candidate with predicted and measured cost side by side, plus each
    run's first and last losses, the kernel launches summed over its
    ranks, the largest rank's peak device bytes, each rank's live cost of
    its first step and rank 0's placement audits."""
    import torch

    device = device or "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("confirm_candidates runs on CUDA unless given "
                           "device='cpu', and no CUDA device is available")
    out: List[Dict[str, object]] = []
    for price in prices:
        entry: Dict[str, object] = {
            "name": price.name,
            "predicted_step_s": round(price.predicted_step_s, 9),
        }
        try:
            layout = _layout_from_price(price, world)
            job = {"name": layout.name, "axes": list(layout.axes),
                   "zero_stage": layout.zero_stage,
                   "model": model.as_dict(), "micro": micro, "gas": gas,
                   "comm": price.detail.get("comm"), "kernels": kernels,
                   "steps": steps, "warmup": warmup, "seed": seed,
                   "device": device}
            ranks = run_ranks(job, world, start_method)
            # a step ends when its slowest rank ends
            step_s = [max(r["seconds"][i] for r in ranks)
                      for i in range(warmup, warmup + steps)]
            entry["step_ms"] = round(statistics.median(step_s) * 1e3, 3)
            entry["final_loss"] = round(ranks[0]["losses"][-1], 6)
            entry["first_loss"] = ranks[0]["losses"][0]
            entry["rank_losses"] = [r["losses"] for r in ranks]
            entry["launches"] = {k: sum(r["launches"][k] for r in ranks)
                                 for k in ranks[0]["launches"]}
            peaks = [r["peak_bytes"] for r in ranks]
            entry["peak_bytes"] = (max(peaks) if None not in peaks
                                   else None)
            entry["live_cost"] = [r["live_cost"] for r in ranks]
            entry["audit"] = ranks[0]["audit"]
            entry["backend"] = ranks[0]["backend"]
        except Exception as e:  # noqa: BLE001 - a candidate that cannot
            # run is itself a finding; keep it visible, rank it last
            entry["error"] = f"{type(e).__name__}: {e}"
        if log is not None:
            log(f"confirm {entry['name']}: "
                f"{entry.get('step_ms', 'FAILED')} ms")
        out.append(entry)
    return out


def rank_correlation(
    confirmed: Sequence[Dict[str, object]],
) -> Optional[float]:
    """Spearman between predicted and measured cost over the entries that
    actually ran (None with fewer than 2)."""
    ran = [e for e in confirmed if "step_ms" in e]
    if len(ran) < 2:
        return None
    return spearman([float(e["predicted_step_s"]) for e in ran],
                    [float(e["step_ms"]) for e in ran])
