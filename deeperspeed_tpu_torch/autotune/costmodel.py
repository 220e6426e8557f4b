"""Static candidate pricing: rank configs without running them on the card.

Counterpart of deeperspeed_tpu/autotune/costmodel.py, with the same terms
one for one, every one attributable in the emitted ``components`` dict:

  * **Captured cost** of the candidate's real step: the port's engine is
    built for the candidate through ``initialize`` on the ``meta`` device
    over a ``PlanningMesh`` and one rank's ``_train_step`` is captured
    there (:mod:`.capture`): its ``flops`` and ``bytes_accessed``, counted
    op by op as the live cost index counts them (monitor/perf.py), and its
    peak bytes from the live tensors. The roofline max of compute and
    memory floors is the base step time. The reference's ZeRO >= 2 clamp
    rides on top as it is: a ZeRO >= 2 candidate's compute and memory are
    clamped to its same-mesh stage-1 sibling's (ZeRO shards storage, never
    the math), and it pays an explicit re-gather wire term.
  * **Modeled wire traffic**: runtime/comm/wiremodel.py prices the
    reducer's :class:`BucketPlan` (mode bits x padded elements x ring
    factor) plus two collective launches a bucket; a 2-D data mesh pays
    one launch a phase per sharded axis; tensor- and sequence-parallel
    layouts pay their per-layer activation collectives. One term is the
    port's own: a live sp axis pays the engine's grad sum over it.
  * **Memory fit**: the per-rank peak bytes (and a serving KV pool)
    against the card's memory, shared between the ranks on one card.
    Infeasible candidates keep their price and gain ``feasible=False`` and
    a stated ``reason``: REPORTED, never dropped. A candidate the engine
    refuses (ZeRO stage 3 for a loss callable, ROADMAP.md section 3) is
    infeasible with the refusal's words.

Repriced for the H100 (no TPU number is carried over): the roofline peaks
are the card's row of monitor/perf.py's ``PLATFORM_PEAKS`` (the fp32 rate,
since the candidate engines compute in fp32, as the reference's do),
shared by the ranks on one card, and the wire rate and per-collective
launch overhead are those of the transport the candidate's ranks will
use (:data:`TRANSPORTS`): NCCL over NVLink where each rank has a card,
gloo through pinned host copies where ranks share one. Kernel routes are
priced by capturing the step under each route
(:func:`price_kernel_routes`).
"""

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from ..monitor.perf import PLATFORM_PEAKS, platform_peaks
from ..runtime.comm import wiremodel
from .capture import aot_capture, sandboxed_cost_index
from .space import (CommCandidate, LayoutCandidate, ModelSpec,
                    ServingCandidate, resolve_block)

__all__ = [
    "CandidatePrice",
    "TRANSPORTS",
    "build_candidate_engine",
    "capture_rank",
    "effective_micro",
    "platform_budget",
    "price_comm_variants",
    "price_kernel_routes",
    "price_layout",
    "price_serving",
    "rank_candidates",
]

# The collectives of a candidate's ranks: the rate at which a rank's
# ring-model bytes (wiremodel.dense_wire_bytes of an fp32 all-reduce) pass
# and the fixed time of one collective.
TRANSPORTS: Dict[str, Dict[str, object]] = {
    # NCCL over NVLink 4 on a node of H100s, one rank a card: the spec
    # row's one-way rate (PLATFORM_PEAKS["h100"]["ici_gbps"]), not
    # measured. The spec gives no per-collective overhead and no run has
    # measured one, so it is left unpriced (None): a candidate whose step
    # launches collectives over NCCL comes back infeasible, saying so.
    "nccl": {"wire_gbps": PLATFORM_PEAKS["h100"]["ici_gbps"],
             "launch_overhead_s": None,
             "source": "spec row of the NVIDIA H100 80GB HBM3 (NVLink 4), "
                       "not measured; launch overhead not measured"},
    # gloo between ranks sharing one card, each collective staged through
    # pinned host buffers (runtime/comm/collectives.Transport): measured
    # by chip_smoke.py phase 25 (two ranks; the median all_reduce_sum of
    # one fp32 element, 0.961 ms, and the ring-model bytes of a 64 MiB one
    # over its seconds) on an NVIDIA H100 80GB HBM3, 700.00 W
    "gloo": {"wire_gbps": 2.52, "launch_overhead_s": 9.61e-4,
             "source": "chip_smoke.py phase 25 on an NVIDIA H100 80GB HBM3, "
                       "700.00 W (two ranks, host-staged gloo)"},
}


@dataclasses.dataclass
class CandidatePrice:
    """One priced candidate: kept whether or not it is feasible."""

    name: str
    kind: str  # "layout" | "comm" | "kernels" | "serving"
    feasible: bool = True
    reason: str = ""  # stated pruning reason when infeasible
    predicted_step_s: float = 0.0
    flops: float = 0.0            # per rank, from the capture
    bytes_accessed: float = 0.0   # per rank
    peak_hbm_bytes: float = 0.0   # per rank
    wire_bytes: float = 0.0       # per rank, modeled
    launches: float = 0.0
    components: Dict[str, float] = dataclasses.field(default_factory=dict)
    detail: Dict[str, object] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["predicted_step_s"] = round(self.predicted_step_s, 9)
        return d


def platform_budget(
    hbm_gb: Optional[float] = None,
    peaks: Optional[dict] = None,
    *,
    world: int = 1,
) -> Dict[str, object]:
    """Roofline, capacity and wire numbers for ``world`` ranks on this
    platform (``peaks``: a PLATFORM_PEAKS row with its ``source``, default
    the current device's), spread over the visible cards. Ranks that
    outnumber the cards share them: their collectives run on gloo through
    the host, and each one's budget is its share of a card (its memory,
    and its flops and bandwidth: the card runs every sharing rank's step).
    ``hbm_gb`` overrides a card's capacity (the tests force the memory
    frontier onto tiny models with it)."""
    import torch

    p = dict(peaks or platform_peaks())
    src = str(p.get("source", "cpu"))
    on_card = src != "cpu"
    cards = torch.cuda.device_count() if on_card else 0
    transport = "nccl" if on_card and cards >= world else "gloo"
    share = math.ceil(world / cards) if on_card and cards else 1
    if torch.cuda.is_available() and on_card:
        capability = torch.cuda.get_device_capability(0)
    else:
        capability = (9, 0) if src == "h100" else None
    t = TRANSPORTS[transport]
    hbm = hbm_gb if hbm_gb is not None else p.get("hbm_gib", 1.0)
    return {
        "source": src,
        "peak_flops": (p.get("peak_tflops_fp32", p["peak_tflops"]) * 1e12
                       / share),
        "peak_bw": p["peak_gbps"] * 1e9 / share,
        "ici_bw": float(t["wire_gbps"]) * 1e9,
        "hbm_bytes": hbm * (1 << 30) / share,
        "launch_overhead_s": t["launch_overhead_s"],
        "transport": transport,
        "transport_source": t["source"],
        "ranks_per_card": share,
        "plan_device": "cuda" if on_card else "cpu",
        "capability": capability,
    }


def effective_micro(layout: LayoutCandidate, world: int, micro: int) -> int:
    """Per-rank microbatch holding the GLOBAL token count constant across
    layouts: a tp8 mesh has dp_size 1, so its microbatch is 8x the dp8
    microbatch; otherwise candidates would be priced on different
    workloads and the ranking would be meaningless."""
    return micro * (world // layout.dp_size)


def _train_config(model: ModelSpec, layout: LayoutCandidate, world: int,
                  micro: int, gas: int, comm_block: Optional[dict],
                  kernels: Optional[dict] = None) -> dict:
    micro = effective_micro(layout, world, micro)
    cfg = {
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": gas,
        "train_batch_size": micro * gas * layout.dp_size,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "zero_optimization": {"stage": layout.zero_stage},
        "mesh": layout.block(),
        "steps_per_print": 10 ** 9,
    }
    if comm_block is not None:
        cfg["comm"] = dict(comm_block)
    if kernels is not None:
        cfg["kernels"] = dict(kernels)
    return cfg


def gpt_config(model: ModelSpec, layout: LayoutCandidate):
    """The GPT-NeoX-style model of ``model`` in fp32, as the reference's
    candidate engines build it; a live sp axis takes ring attention (the
    port's context-parallel path), every other layout ``attn_impl``
    "auto" (the flash kernel on a Hopper card)."""
    import torch

    from ..models.gpt import GPTConfig

    return GPTConfig(vocab_size=model.vocab, n_layer=model.n_layer,
                     n_head=model.n_head, n_kv_head=model.n_kv_head,
                     d_model=model.d_model, max_seq=model.seq, remat=False,
                     dtype=torch.float32, rotary=True,
                     attn_impl="ring" if layout.extents()["sp"] > 1
                     else "auto")


def build_candidate_engine(model: ModelSpec, layout: LayoutCandidate,
                           world: int, *, micro: int = 2, gas: int = 1,
                           comm_block: Optional[dict] = None,
                           kernels: Optional[dict] = None,
                           device: Optional[str] = None, seed: int = 0,
                           rank: int = 0):
    """A real engine for ``layout``, from the reference's ``_train_config``
    blocks (plus the ``"kernels"`` block the run takes), with no
    ``monitor`` or ``resilience`` block. On ``device="meta"`` it is rank
    ``rank`` of the layout planned in this process (``PlanningMesh``; no
    process group, shapes only, no process-global state adopted); else
    this process is one rank of an initialized world of ``world`` ranks
    (confirm.py), its weights drawn from ``seed``."""
    import torch

    from ..models import gpt
    from ..runtime.engine import initialize
    from ..sharding import mesh as mesh_lib

    extents = resolve_block(layout.block(), world)
    gcfg = gpt_config(model, layout)
    if device == "meta":
        mesh = mesh_lib.PlanningMesh(extents, rank=rank)
        params = _meta_params(gpt.param_shapes(gcfg))
    else:
        mesh = mesh_lib.from_config(layout.block())
        params = gpt.init_params(seed, gcfg, device=device,
                                 dtype=torch.float32)
    _, _, loss_fn, specs = gpt.make_gpt(gcfg, mesh)
    engine, _, _, _ = initialize(
        model=loss_fn, model_parameters=params,
        config=_train_config(model, layout, world, micro, gas, comm_block,
                             kernels),
        device=device, mesh=mesh, param_specs=specs)
    return engine


def _meta_params(shapes):
    import torch

    if isinstance(shapes, dict):
        return {k: _meta_params(v) for k, v in shapes.items()}
    return torch.empty(shapes, dtype=torch.float32, device="meta")


class _Step:
    """One rank's ``_train_step`` of a planning engine on a meta batch of
    the global shape; ``_cache_size`` is the engine's step signatures (a
    real ``train_batch`` would grow them)."""

    def __init__(self, engine, model: ModelSpec):
        import torch

        self.engine = engine
        rows = (engine.train_micro_batch_size_per_gpu()
                * engine.gradient_accumulation_steps()
                * engine.data_parallel_size)
        self.batch = engine._place_batch(torch.empty(
            (rows, model.seq + 1), dtype=torch.int64, device="meta"))

    def _cache_size(self) -> int:
        return self.engine._step_sigs._cache_size()

    def resident(self) -> dict:
        """The state a step reads and writes in place (its arguments)."""
        e = self.engine
        return {"params": e.params, "master": e.master,
                "opt_state": e.opt_state, "comm": e._comm_state,
                "batch": self.batch}

    def __call__(self, state):
        e = self.engine
        return e._train_step(self.batch, e.gradient_accumulation_steps())


def capture_step(name: str, engine, model: ModelSpec, budget: dict,
                 index=None):
    """The capture (:func:`.capture.aot_capture`) of one rank's step of a
    planning ``engine``, routed for the budget's platform under the
    engine's ``"kernels"`` block (or the process's, without one)."""
    from ..ops import kernel_config

    step = _Step(engine, model)
    blk = engine._config.kernels_params or {}
    with kernel_config.planning(budget["plan_device"], budget["capability"]):
        with kernel_config.override(**blk):
            return aot_capture(name, step, (step.resident(),), index=index)


def capture_rank(model: ModelSpec, layout: LayoutCandidate, world: int,
                 budget: Dict[str, object], rank: int, *, micro: int = 2,
                 gas: int = 1, comm_block: Optional[dict] = None,
                 kernels: Optional[dict] = None, index=None):
    """The capture of rank ``rank``'s step of ``layout``. ``price_layout``
    prices rank 0's; the ranks of a layout can differ (under sp's causal
    ring, rank 0 also masks the newer chunk that the others see whole)."""
    engine = build_candidate_engine(model, layout, world, micro=micro,
                                    gas=gas, comm_block=comm_block,
                                    kernels=kernels, device="meta",
                                    rank=rank)
    return capture_step(f"{layout.name}@rank{rank}", engine, model, budget,
                        index)


def price_layout(
    layout: LayoutCandidate,
    model: ModelSpec,
    world: int,
    budget: Dict[str, object],
    *,
    micro: int = 2,
    gas: int = 1,
    comm: Optional[CommCandidate] = None,
    kernels: Optional[dict] = None,
    index=None,
    name: Optional[str] = None,
    keep_engine: bool = False,
):
    """Price one (layout[, comm][, kernels]) candidate from a capture of
    its step on the meta device. Returns ``(CandidatePrice,
    engine_or_None)``, as the reference does: the planning engine comes
    back only with ``keep_engine=True``."""
    comm_block = comm.block if comm is not None else None
    if name is None:
        name = layout.name if comm is None else f"{layout.name}+{comm.name}"
    price = CandidatePrice(
        name=name, kind="layout" if comm is None else "comm",
        detail={"mesh": layout.block(), "zero_stage": layout.zero_stage,
                **({"comm": comm_block} if comm is not None else {})})
    idx = index if index is not None else sandboxed_cost_index()
    try:
        engine = build_candidate_engine(model, layout, world, micro=micro,
                                        gas=gas, comm_block=comm_block,
                                        kernels=kernels, device="meta")
    except Exception as e:  # noqa: BLE001 - report, never crash the sweep
        price.feasible = False
        price.reason = f"engine construction failed: {type(e).__name__}: {e}"
        return price, None

    rec = capture_step(name, engine, model, budget, idx)
    if rec is None or rec.error is not None:
        price.feasible = False
        price.reason = (f"capture failed: "
                        f"{rec.error if rec else 'no record'}")
        return price, engine if keep_engine else None

    price.flops = rec.flops
    price.bytes_accessed = rec.bytes_accessed
    price.peak_hbm_bytes = rec.peak_bytes

    # ZeRO >= 2 clamp, the reference's term: its XLA cost priced a
    # ZeRO-sharded program per shard. ZeRO shards storage, never the math:
    # each rank still runs the whole forward and backward on its rows, so
    # compute and memory are clamped to the same-mesh stage-1 sibling's
    # capture (cached in the index by mesh name). The peak is not clamped:
    # sharded residency is the whole point.
    if layout.zero_stage >= 2:
        dense = dataclasses.replace(
            layout, name=layout.name.rsplit("_zero", 1)[0], zero_stage=1)
        ref = idx.get(dense.name)
        if ref is None or ref.error is not None:
            try:
                ref = capture_step(dense.name, build_candidate_engine(
                    model, dense, world, micro=micro, gas=gas,
                    comm_block=comm_block, kernels=kernels, device="meta"),
                    model, budget, idx)
            except Exception:  # noqa: BLE001 - no ref, keep raw capture
                ref = None
        if ref is not None and ref.error is None:
            price.flops = max(price.flops, ref.flops)
            price.bytes_accessed = max(price.bytes_accessed,
                                       ref.bytes_accessed)
            price.detail["zero_dense_ref"] = dense.name

    # wire model: the reducer's real plan when a comm block rides along,
    # else one dense fp32 all-reduce of the whole gradient tree
    grad_elements = model.param_count()
    ccfg = engine._config.comm_config()
    if ccfg is not None:
        wire = wiremodel.wire_summary(engine.comm.plan, ccfg,
                                      engine.comm.world, grad_elements)
    else:
        wire = wiremodel.wire_summary(None, None, layout.dp_size,
                                      grad_elements)
    price.wire_bytes = wire["wire_bytes_per_device"]
    price.launches = wire["collective_launches"]
    price.detail["wire"] = wire

    ext = layout.extents()

    # a 2-D data mesh (dp x fsdp both > 1) reduces gradients in one phase
    # per sharded axis: the same bytes, one extra dispatch a collective
    n_data_axes = (1 if ext["dp"] > 1 else 0) + (1 if ext["fsdp"] > 1 else 0)
    if n_data_axes > 1:
        price.launches *= n_data_axes
        price.detail["data_axes"] = n_data_axes

    # ZeRO re-materialization traffic: stage 3 all-gathers the sharded
    # params for the forward and again for the backward; stage 2 gathers
    # the updated shard once a step
    if layout.zero_stage >= 2 and ext["fsdp"] > 1:
        gathers = 2.0 if layout.zero_stage >= 3 else 1.0
        zb = (gathers * model.param_count() * 4
              * wiremodel.ring_factor(ext["fsdp"]))
        price.wire_bytes += zb
        price.launches += gathers
        price.detail["zero_gather"] = {"launches": gathers, "bytes": zb}

    # activation collectives on the model-parallel axes: tp's per-layer
    # all-reduces (2 forward + 2 backward, Megatron) and sp's ring
    # attention permutes ((sp - 1) forward, ~2x for the backward), every
    # layer, every step
    rows = effective_micro(layout, world, micro)
    act_bytes = 0.0
    act_launches = 0.0
    if ext["tp"] > 1:
        n = 4.0 * model.n_layer
        act_launches += n
        act_bytes += (n * rows * model.seq * model.d_model * 4
                      * 2 * wiremodel.ring_factor(ext["tp"]))
    if ext["sp"] > 1:
        n = 3.0 * (ext["sp"] - 1) * model.n_layer
        act_launches += n
        act_bytes += (n * rows * (model.seq / ext["sp"])
                      * 2 * model.kv_heads * model.head_dim * 4)
    price.launches += act_launches
    price.detail["act"] = {"launches": act_launches, "bytes": act_bytes}

    # the port's own term: its engine sums every grad over a live sp axis
    # (Engine._sum_over_sp, one flat fp32 all-reduce), which GSPMD folds
    # into the reference's program and its model does not price
    sp_bytes = sp_launches = 0.0
    if ext["sp"] > 1:
        sp_launches = 1.0
        sp_bytes = float(wiremodel.dense_wire_bytes(grad_elements,
                                                    ext["sp"]))
        price.detail["sp_grad_sum"] = {"launches": sp_launches,
                                       "bytes": sp_bytes}

    compute_s = price.flops / budget["peak_flops"]
    memory_s = price.bytes_accessed / budget["peak_bw"]
    wire_s = (price.wire_bytes + act_bytes + sp_bytes) / budget["ici_bw"]
    n_launches = price.launches + sp_launches
    overhead = budget["launch_overhead_s"]
    launch_s = n_launches * overhead if overhead is not None else 0.0
    if overhead is None and n_launches:
        price.feasible = False
        price.reason = (
            f"{budget['transport']} launch overhead not measured: "
            f"{n_launches:g} collective launches a step left unpriced")
    price.components = {
        "compute_s": compute_s, "memory_s": memory_s,
        "wire_s": wire_s, "launch_s": launch_s,
    }
    price.predicted_step_s = max(compute_s, memory_s) + wire_s + launch_s

    if rec.peak_bytes > budget["hbm_bytes"]:
        price.feasible = False
        price.reason = ((price.reason + "; ") if price.reason else "") + (
            f"HBM: per-rank footprint {rec.peak_bytes / (1 << 30):.3f} "
            f"GiB exceeds {budget['hbm_bytes'] / (1 << 30):.3f} GiB "
            f"({budget['source']}, {budget['ranks_per_card']} rank(s) a "
            f"card)")
    return price, engine if keep_engine else None


def price_comm_variants(
    layout: LayoutCandidate,
    comms: Sequence[CommCandidate],
    model: ModelSpec,
    world: int,
    budget: Dict[str, object],
    *,
    micro: int = 2,
    gas: int = 1,
    kernels: Optional[dict] = None,
    index=None,
) -> List[CandidatePrice]:
    """Price every comm variant on a fixed layout (an engine a variant:
    the quantize and pack work lands in the captured cost, the wire in the
    model)."""
    return [price_layout(layout, model, world, budget, micro=micro,
                         gas=gas, comm=c, kernels=kernels, index=index)[0]
            for c in comms]


def price_kernel_routes(
    routes: Sequence[dict],
    layout: LayoutCandidate,
    comm: Optional[CommCandidate],
    model: ModelSpec,
    world: int,
    budget: Dict[str, object],
    *,
    micro: int = 2,
    gas: int = 1,
    index=None,
) -> List[CandidatePrice]:
    """Price each ``"kernels"`` block on the chosen layout and comm
    variant by capturing the step under it: under ``"off"`` the plain
    ops' aten work is counted, under ``"auto"``/``"fused"`` the kernels'
    declared work where the budget's platform routes them (the reference's
    fixed route factors and its interpret-mode verdict do not apply)."""
    out = []
    for blk in routes:
        mode = blk.get("mode", "off")
        p, _ = price_layout(layout, model, world, budget, micro=micro,
                            gas=gas, comm=comm, kernels=blk, index=index,
                            name=f"kernels_{mode}")
        p.kind = "kernels"
        p.detail["kernels"] = dict(blk)
        out.append(p)
    return out


def price_serving(
    cand: ServingCandidate,
    model: ModelSpec,
    budget: Dict[str, object],
    *,
    dtype_bytes: int = 4,
    accept_rate: float = 0.7,
) -> CandidatePrice:
    """Price a serving shape analytically, as the reference does: the KV
    pool and the resident params must fit; among the fits, prefer the
    cheaper decode (a speculative variant's modeled round speedup at
    ``accept_rate``), then the tighter bucket grid (less prefill padding),
    then the larger pool. A speculative variant adds the drafter's
    resident weights to the memory gate (its pool is already inside
    ``cand.kv_pool_bytes``): a round of K+1 drafter steps (each
    ``n_drafter/n_layer`` of a target step) plus one verify emits
    ``1 + sum(p^i, i=1..K)`` tokens."""
    params = model.param_bytes(dtype_bytes)
    spec = (cand.block.get("speculative")
            if isinstance(cand.block, dict) else None) or None
    spec_speedup, drafter_params = 1.0, 0
    if spec:
        K = int(spec.get("draft_k", 4))
        n_d = int((spec.get("drafter") or {}).get(
            "n_layer", max(1, model.n_layer // 4)))
        ratio = n_d / float(model.n_layer)
        p = min(max(float(accept_rate), 0.0), 1.0)
        emitted = 1.0 + sum(p ** i for i in range(1, K + 1))
        round_cost = (K + 1) * ratio + 1.0   # in target-step units
        spec_speedup = emitted / round_cost
        # truncated drafter: its layers are resident copies of the
        # target's first n_d; layer params dominate, embeddings shared
        drafter_params = int(params * ratio)
    need = cand.kv_pool_bytes + params + drafter_params
    price = CandidatePrice(
        name=cand.name, kind="serving",
        peak_hbm_bytes=float(need),
        detail={"serving": dict(cand.block),
                "prefill_buckets": list(cand.prefill_buckets),
                "kv_pool_bytes": cand.kv_pool_bytes,
                "param_bytes": params,
                "drafter_param_bytes": drafter_params})
    # waste proxy: mean padded fraction if prompts land uniformly in
    # [1, max bucket]; a finer grid scores lower
    buckets = sorted(cand.prefill_buckets)
    prev, waste = 0, 0.0
    for b in buckets:
        waste += (b - (prev + b + 1) / 2.0) * (b - prev)
        prev = b
    span = buckets[-1] if buckets else 1
    waste_frac = waste / (span * span) if span else 0.0
    pool_tokens = (int(cand.block["num_blocks"])
                   * int(cand.block["block_size"]))
    price.components = {"waste_frac": round(waste_frac, 6),
                        "pool_tokens": float(pool_tokens),
                        "decode_cost": round(1.0 / spec_speedup, 6)}
    if spec:
        price.components["spec_speedup"] = round(spec_speedup, 6)
        price.components["spec_accept_rate_assumed"] = float(accept_rate)
    price.predicted_step_s = (1.0 / spec_speedup + waste_frac
                              + 1.0 / (1.0 + pool_tokens))
    if need > budget["hbm_bytes"]:
        price.feasible = False
        price.reason = (
            f"HBM: KV pool {cand.kv_pool_bytes / (1 << 30):.3f} GiB + "
            f"params {(params + drafter_params) / (1 << 30):.3f} GiB "
            f"exceeds {budget['hbm_bytes'] / (1 << 30):.3f} GiB "
            f"({budget['source']})")
    return price


def rank_candidates(
    prices: Sequence[CandidatePrice],
) -> Tuple[List[CandidatePrice], List[CandidatePrice]]:
    """Split into (ranked feasible, pruned): pruned candidates all carry a
    non-empty ``reason`` and stay in every report."""
    feasible = sorted((p for p in prices if p.feasible),
                      key=lambda p: (p.predicted_step_s, p.name))
    pruned = [p for p in prices if not p.feasible]
    for p in pruned:
        if not p.reason:
            raise ValueError(f"pruned candidate {p.name} has no stated "
                             f"reason")
    return feasible, pruned
