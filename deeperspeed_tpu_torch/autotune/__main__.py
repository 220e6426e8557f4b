"""``python -m deeperspeed_tpu_torch.autotune``: search the knob space.

Counterpart of deeperspeed_tpu/autotune/__main__.py, with the same
arguments and stages:

.. code-block:: console

    $ python -m deeperspeed_tpu_torch.autotune --devices 2 --vocab 50304 \
          --n-layer 12 --n-head 12 --d-model 768 --seq 2048 --out tuned.json
    space  : 6 layout x 13 comm x 3 kernel x 32 serving candidates (hash …)
             on h100, gloo
    price  : dp2                       634.353 ms
    price  : fsdp2_zero3                 0.000 ms  INFEASIBLE: engine …
    confirm: spearman(predicted, measured) = 0.8
    best   : dp2+int8_b1mb (predicted 266.574 ms, measured 1122.732 ms)
    emitted: tuned.json

Stages: enumerate (space.py, through the port's own validators) -> price
the layouts (costmodel.py: a capture of each candidate's step on the meta
device, the wire model, the memory fit; infeasible candidates reported
with reasons) -> the comm variants on the winner -> the kernel routes on
that -> the serving buckets -> confirm a spread of the layout ranking
(confirm.py: real ``train_batch`` steps, ``--devices`` rank processes) ->
emit the winning blocks with a provenance record (provenance.py).

``--devices N`` is the world to tune for: N ranks, on the visible cards
(sharing them, over gloo, when N exceeds them) or with ``--device cpu``
on the host. Nothing is re-executed. The emitted config is round-tripped
through the port's ``TrainingConfig`` and ``verify_provenance`` before it
is written, and refused if either changes or rejects it.
"""

import argparse
import json

# the kernel route the layouts and comm variants are priced and confirmed
# under: the port's production setting (ops/kernel_config.py)
SEARCH_KERNELS = {"mode": "auto"}


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m deeperspeed_tpu_torch.autotune",
        description="Cost-model config search: mesh layouts, comm modes, "
                    "kernel routes, serving buckets.")
    ap.add_argument("--devices", type=int, default=8,
                    help="world size to tune for (ranks)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the ranks run and what the prices are for "
                         "(default: the card)")
    ap.add_argument("--quick", action="store_true",
                    help="small space for a smoke run: dp/fsdp layouts, "
                         "stage 1, two comm variants")
    ap.add_argument("--top-k", type=int, default=4)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--micro", type=int, default=2)
    ap.add_argument("--gas", type=int, default=1)
    ap.add_argument("--no-confirm", action="store_true",
                    help="rank only; skip the measured confirmation runs")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="override a card's memory capacity (GiB)")
    ap.add_argument("--max-candidates", type=int, default=0,
                    help="cap priced layout candidates (0 = no cap); "
                         "skipped candidates are reported, not dropped")
    ap.add_argument("--max-tp", type=int, default=None,
                    help="cap the tensor-parallel extent")
    ap.add_argument("--max-sp", type=int, default=None,
                    help="cap the sequence-parallel extent")
    ap.add_argument("--comm-buckets", default=None,
                    help="comma-separated bucket_mb grid override, e.g. "
                         "'25' to price one bucket size per mode")
    ap.add_argument("--out", default=None,
                    help="write the winning config JSON here")
    ap.add_argument("--report", default=None,
                    help="write the full search report JSON here")
    ap.add_argument("--draft-ks", default="0,4",
                    help="comma list of speculative draft_k values to "
                         "explore (0 = plain decode); each k > 0 adds a "
                         "_spec{k} serving variant priced with its "
                         "drafter pool and weights")
    ap.add_argument("--spec-accept", type=float, default=0.7,
                    help="modeled per-token draft/target agreement used "
                         "to price speculative serving variants")
    # model facts (defaults: the reference's tiny model)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--n-layer", type=int, default=2)
    ap.add_argument("--n-head", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--seq", type=int, default=32)
    return ap.parse_args(argv)


def _enumerate_space(args, model, budget):
    from .space import (enumerate_comm_variants, enumerate_kernel_routes,
                        enumerate_mesh_layouts, enumerate_serving_buckets,
                        kv_pool_bytes, space_hash)

    if args.quick:
        layouts = enumerate_mesh_layouts(
            args.devices, model, max_tp=1, max_sp=1, zero_stages=(1,))
        comms = enumerate_comm_variants(
            modes=("fp32",), bucket_mbs=(25.0,), overlaps=("off",))
    else:
        layouts = enumerate_mesh_layouts(args.devices, model,
                                         max_tp=args.max_tp,
                                         max_sp=args.max_sp)
        if args.comm_buckets:
            comms = enumerate_comm_variants(bucket_mbs=tuple(
                float(x) for x in args.comm_buckets.split(",")))
        else:
            comms = enumerate_comm_variants()
    routes = enumerate_kernel_routes()
    # double the KV pool until it crosses the memory budget: the serving
    # frontier is explored past feasibility on every platform, so the
    # cost model always has an infeasible candidate to report
    max_seq = max(model.seq, 64)
    min_pool = kv_pool_bytes(model, 16, 8 * (max_seq // 16) + 1)
    doublings = 1
    while (min_pool * (2 ** doublings) <= budget["hbm_bytes"]
           and doublings < 24):
        doublings += 1
    draft_ks = tuple(int(x) for x in
                     str(getattr(args, "draft_ks", "0")).split(",") if x)
    servings = enumerate_serving_buckets(model, pool_doublings=doublings,
                                         draft_ks=draft_ks or (0,))
    return {
        "layouts": layouts, "comms": comms, "routes": routes,
        "servings": servings,
        "hash": space_hash(args.devices, model, layouts, comms, routes,
                           servings),
    }


def run_search(args, log=print, start_method: str = "spawn"):
    """The whole pipeline; returns the report dict (json-ready).
    ``start_method`` starts the confirm stage's rank processes."""
    import torch

    from ..monitor.perf import platform_peaks
    from ..runtime.config import TrainingConfig
    from .capture import sandboxed_cost_index
    from .confirm import (_layout_from_price, confirm_candidates,
                          rank_correlation, select_spread)
    from .costmodel import (capture_rank, effective_micro, platform_budget,
                            price_comm_variants, price_kernel_routes,
                            price_layout, price_serving, rank_candidates)
    from .provenance import make_provenance, verify_provenance
    from .space import ModelSpec

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("autotune: --device cuda (the default) and no CUDA "
                         "device is available; pass --device cpu")
    model = ModelSpec(vocab=args.vocab, n_layer=args.n_layer,
                      n_head=args.n_head, d_model=args.d_model,
                      seq=args.seq)
    budget = platform_budget(hbm_gb=args.hbm_gb,
                             peaks=platform_peaks(args.device),
                             world=args.devices)
    space = _enumerate_space(args, model, budget)
    layouts, comms = space["layouts"], space["comms"]
    log(f"space  : {len(layouts)} layout x {len(comms)} comm x "
        f"{len(space['routes'])} kernel x {len(space['servings'])} serving "
        f"candidates (hash {space['hash']}) on {budget['source']}, "
        f"{budget['transport']}")

    skipped = []
    if args.max_candidates and len(layouts) > args.max_candidates:
        skipped = [{"name": c.name, "reason":
                    f"skipped: --max-candidates {args.max_candidates} cap"}
                   for c in layouts[args.max_candidates:]]
        layouts = layouts[:args.max_candidates]
        log(f"cap    : pricing {len(layouts)} of "
            f"{len(layouts) + len(skipped)} layouts "
            f"({len(skipped)} skipped, reported below)")

    # stage A: price every layout (no comm block)
    index = sandboxed_cost_index()
    kw = dict(micro=args.micro, gas=args.gas, index=index)
    prices = []
    for lc in layouts:
        p, _ = price_layout(lc, model, args.devices, budget,
                            kernels=SEARCH_KERNELS, **kw)
        prices.append(p)
        log(f"price  : {p.name:<24} {p.predicted_step_s * 1e3:8.3f} ms"
            + ("" if p.feasible else f"  INFEASIBLE: {p.reason}"))
    ranked, pruned = rank_candidates(prices)
    if not ranked:
        raise SystemExit("autotune: no feasible layout candidate "
                         f"(pruned: {[p.reason for p in pruned]})")

    # stage B: comm variants on the winning layout
    best_layout = next(lc for lc in layouts if lc.name == ranked[0].name)
    comm_prices = price_comm_variants(best_layout, comms, model,
                                      args.devices, budget,
                                      kernels=SEARCH_KERNELS, **kw)
    comm_ranked, comm_pruned = rank_candidates(comm_prices)
    for p in comm_prices:
        log(f"comm   : {p.name:<32} {p.predicted_step_s * 1e3:8.3f} ms"
            + ("" if p.feasible else f"  INFEASIBLE: {p.reason}"))
    if not comm_ranked:
        raise SystemExit("autotune: no feasible comm variant "
                         f"(pruned: {[p.reason for p in comm_pruned]})")

    # stage C: kernel routes, each a capture of the winner's step
    winner_comm = next(c for c in comms if comm_ranked[0].name
                       == f"{best_layout.name}+{c.name}")
    kernel_prices = price_kernel_routes(space["routes"], best_layout,
                                        winner_comm, model, args.devices,
                                        budget, **kw)
    kernel_ranked, kernel_pruned = rank_candidates(kernel_prices)
    for p in kernel_prices:
        log(f"kernels: {p.name:<32} {p.predicted_step_s * 1e3:8.3f} ms"
            + ("" if p.feasible else f"  INFEASIBLE: {p.reason}"))

    # stage D: serving shape buckets (analytic pool/bucket model;
    # speculative variants priced at the modeled acceptance)
    serving_prices = [price_serving(s, model, budget,
                                    accept_rate=args.spec_accept)
                      for s in space["servings"]]
    serving_ranked, serving_pruned = rank_candidates(serving_prices)
    for p in serving_pruned:
        log(f"pruned : {p.name}: {p.reason}")

    all_pruned = pruned + comm_pruned + kernel_pruned + serving_pruned

    # confirm: measured runs over a top-K spread of distinct predicted
    # tiers from the layout ranking; the predicted-worst rides along so
    # the correlation has range
    confirm_set = select_spread(ranked, k=max(1, args.top_k))
    confirmed, corr = [], None
    if not args.no_confirm:
        confirmed = confirm_candidates(
            confirm_set, model, args.devices, steps=args.steps,
            warmup=args.warmup, micro=args.micro, gas=args.gas, log=log,
            kernels=SEARCH_KERNELS, device=args.device,
            start_method=start_method)
        corr = rank_correlation(confirmed)
        log(f"confirm: spearman(predicted, measured) = {corr}")
        # each rank's planning capture (rank 0's priced the candidate)
        # beside what the live cost index recorded for that rank's first
        # step of the run
        by_name = {p.name: p for p in confirm_set}
        for e in confirmed:
            e["captured_cost"] = []
            for r, live in enumerate(e.get("live_cost", ())):
                rec = (index.get(e["name"]) if r == 0 else capture_rank(
                    model, _layout_from_price(by_name[e["name"]],
                                              args.devices),
                    args.devices, budget, r, micro=args.micro,
                    gas=args.gas, kernels=SEARCH_KERNELS, index=index))
                e["captured_cost"].append({"flops": rec.flops,
                                           "bytes": rec.bytes_accessed})
                log(f"capture: {e['name']:<16} rank {r} flops "
                    f"{rec.flops:.6g} planned / {live['flops']:.6g} live, "
                    f"bytes {rec.bytes_accessed:.6g} / {live['bytes']:.6g}")

    # emit: winning blocks + provenance, round-tripped through the
    # runtime's validation before anything is written
    winner = comm_ranked[0]
    best_serving = serving_ranked[0] if serving_ranked else None
    micro_eff = effective_micro(best_layout, args.devices, args.micro)
    config = {
        "train_micro_batch_size_per_gpu": micro_eff,
        "gradient_accumulation_steps": args.gas,
        "train_batch_size": micro_eff * args.gas * best_layout.dp_size,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "mesh": winner.detail["mesh"],
        "zero_optimization": {"stage": winner.detail["zero_stage"]},
        "kernels": kernel_ranked[0].detail["kernels"],
        "steps_per_print": 10 ** 9,
    }
    if winner.detail.get("comm"):
        config["comm"] = winner.detail["comm"]
    if best_serving is not None:
        config["serving"] = dict(best_serving.detail["serving"],
                                 enabled=False)
    measured = next((e.get("step_ms") for e in confirmed
                     if e["name"] in (winner.name, ranked[0].name)), None)
    config["provenance"] = make_provenance(
        config, space_hash=space["hash"], platform=budget["source"],
        devices=args.devices, predicted_step_s=winner.predicted_step_s,
        measured_step_ms=measured, rank_correlation=corr)

    before = json.dumps(config, sort_keys=True)
    TrainingConfig(config, world_size=best_layout.dp_size)  # must load
    after = json.dumps(config, sort_keys=True)
    if before != after:
        raise SystemExit("autotune: emitted config was mutated by "
                         "runtime validation; refusing to emit")
    ok, why = verify_provenance(config)
    if not ok:
        raise SystemExit(f"autotune: self-check failed: {why}")

    report = {
        "world": args.devices,
        "platform": budget["source"],
        "model": model.as_dict(),
        "space_hash": space["hash"],
        "space_sizes": {
            "layouts": len(layouts) + len(skipped), "comms": len(comms),
            "kernel_routes": len(space["routes"]),
            "servings": len(space["servings"]),
        },
        "ranking": [p.as_dict() for p in ranked],
        "comm_ranking": [p.as_dict() for p in comm_ranked],
        "kernel_ranking": [p.as_dict() for p in kernel_ranked],
        "serving_ranking": [p.as_dict() for p in serving_ranked],
        "pruned": [{"name": p.name, "kind": p.kind, "reason": p.reason}
                   for p in all_pruned] + skipped,
        "confirm": {
            "k": len(confirm_set),
            "entries": confirmed,
            "rank_correlation": corr,
        },
        "best": {
            "name": winner.name,
            "predicted_step_s": round(winner.predicted_step_s, 9),
            "measured_step_ms": measured,
            "config": config,
        },
    }
    return report


def main(argv=None):
    args = _parse_args(argv)
    report = run_search(args)
    best = report["best"]
    print(f"best   : {best['name']} "
          f"(predicted {best['predicted_step_s'] * 1e3:.3f} ms, "
          f"measured {best['measured_step_ms']} ms)")
    print(f"pruned : {len(report['pruned'])} candidate(s) with stated "
          f"reasons")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(best["config"], f, indent=1, sort_keys=True)
        print(f"emitted: {args.out}")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
        print(f"report : {args.report}")


if __name__ == "__main__":
    main()
