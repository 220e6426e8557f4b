"""The admissible config space, enumerated through the port's own validators.

Counterpart of deeperspeed_tpu/autotune/space.py, this package's own copy
(the reference's module imports no jax): the same candidates, names,
order and ``space_hash`` for the same arguments. Every candidate has
already passed the validation the engine applies at load time: mesh
layouts go through :func:`..sharding.config.resolve_extents`, comm
variants through :class:`..runtime.comm.config.CommConfig`, kernel routes
through ``ops.kernel_config.validate`` and serving buckets through
:class:`..serving.config.ServingConfig`. The tuner therefore cannot
propose a config the runtime would reject, and anything the runtime would
reject is not part of the space (never a "pruned" candidate).

Admissibility here is *structural* (divisibility, validator rules).
Feasibility (does it fit in the card's memory, does the engine run it)
is priced later by :mod:`.costmodel`, which keeps infeasible candidates
visible with a stated reason instead of dropping them.
"""

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple

from ..ops import kernel_config as _kernel_config
from ..runtime.comm.config import MODES as COMM_MODES
from ..runtime.comm.config import CommConfig
from ..serving.config import ServingConfig
from ..sharding.config import CANONICAL_AXES, resolve_extents

__all__ = [
    "CommCandidate",
    "LayoutCandidate",
    "ModelSpec",
    "ServingCandidate",
    "enumerate_comm_variants",
    "enumerate_kernel_routes",
    "enumerate_mesh_layouts",
    "enumerate_serving_buckets",
    "kv_pool_bytes",
    "resolve_block",
    "space_hash",
]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """The handful of model facts admissibility + pricing need.

    Deliberately NOT a GPTConfig: the enumerator stays importable without
    building a model, so ``space_hash`` and the provenance check run
    anywhere.
    """

    vocab: int = 256
    n_layer: int = 2
    n_head: int = 4
    d_model: int = 64
    seq: int = 32
    n_kv_head: int = 0  # 0 => n_head (classic MHA)
    dtype_bytes: int = 2  # bf16 activations / KV cache

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head or self.n_head

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    def param_count(self) -> int:
        """Transformer parameter count (embeddings + blocks + head)."""
        d, v, ff = self.d_model, self.vocab, 4 * self.d_model
        kv_dim = self.kv_heads * self.head_dim
        per_layer = (
            d * (d + 2 * kv_dim)  # qkv projection (GQA-aware)
            + d * d               # attn output
            + 2 * d * ff          # mlp in/out
            + 4 * d               # two layernorms (scale + bias)
        )
        return v * d + self.n_layer * per_layer + d * v + 2 * d

    def param_bytes(self, dtype_bytes: Optional[int] = None) -> int:
        return self.param_count() * (dtype_bytes or self.dtype_bytes)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class LayoutCandidate:
    """One admissible (mesh layout, ZeRO stage) point.

    ``name`` follows mesh_bench's convention: the >1 axis extents joined
    in canonical order ("dp2_fsdp4"), with a ``_zero{stage}`` suffix for
    stages above 1 ("dp2_fsdp4_zero2").
    """

    name: str
    axes: Tuple[Tuple[str, int], ...]  # full canonical extents, resolved
    zero_stage: int = 1

    def block(self) -> Dict[str, int]:
        """The ``"mesh"`` config block (only >1 extents, like configs/)."""
        b = {a: n for a, n in self.axes if n > 1}
        return b or {"dp": 1}

    def extents(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def dp_size(self) -> int:
        """Batch-sharded world: dp × fsdp extents."""
        e = self.extents()
        return e["dp"] * e["fsdp"]


@dataclasses.dataclass(frozen=True)
class CommCandidate:
    """One admissible comm variant; ``block`` of None means "no comm block"
    (the engine's plain fp32 psum path, no reducer)."""

    name: str
    block: Optional[Dict[str, object]] = None


@dataclasses.dataclass(frozen=True)
class ServingCandidate:
    """One admissible serving shape: the validated block plus the derived
    bucket set and KV-pool size the cost model prices."""

    name: str
    block: Dict[str, object]
    prefill_buckets: Tuple[int, ...]
    kv_pool_bytes: int


def resolve_block(block: Optional[dict], world: int) -> Dict[str, int]:
    """Resolve a ``"mesh"`` block to full canonical extents for ``world``.

    Delegates to :func:`..sharding.config.resolve_extents`: the block
    passes :meth:`MeshConfig.from_dict` (unknown keys, bad extents and
    multiple ``-1`` raise exactly as they would at config load) and the
    single ``-1`` is inferred exactly as ``sharding.mesh.from_config``
    would, without a process group."""
    return resolve_extents(block, world)


def _layout_name(extents: Dict[str, int], zero_stage: int) -> str:
    parts = [f"{a}{n}" for a, n in extents.items() if n > 1]
    name = "_".join(parts) or "dp1"
    if zero_stage > 1:
        name += f"_zero{zero_stage}"
    return name


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_mesh_layouts(
    world: int,
    model: Optional[ModelSpec] = None,
    *,
    max_tp: Optional[int] = None,
    max_sp: Optional[int] = None,
    zero_stages: Sequence[int] = (1, 2, 3),
) -> List[LayoutCandidate]:
    """All structurally admissible (layout, ZeRO stage) candidates.

    A factorization ``dp × fsdp × tp × sp == world`` is admissible when

      * the resulting block passes :class:`MeshConfig` validation;
      * ``tp`` divides both ``model.n_head`` and ``model.d_model`` (the
        megatron column/row splits need whole heads and even rows);
      * ``sp`` divides ``model.seq`` (ring/Ulysses shard the sequence).

    ZeRO stages: a layout with ``fsdp == 1`` has nothing to shard the
    optimizer over, so only stage 1 is admitted; ``fsdp > 1`` admits every
    requested stage. Candidates come back in a deterministic order —
    fewest parallel axes first, then by name — so ``max_candidates``-style
    truncation upstream is reproducible.
    """
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    model = model or ModelSpec()
    out: List[LayoutCandidate] = []
    seen = set()
    for dp in _divisors(world):
        for fsdp in _divisors(world // dp):
            rem = world // (dp * fsdp)
            for tp in _divisors(rem):
                sp = rem // tp
                if max_tp is not None and tp > max_tp:
                    continue
                if max_sp is not None and sp > max_sp:
                    continue
                if tp > 1 and (model.n_head % tp or model.d_model % tp):
                    continue
                if sp > 1 and model.seq % sp:
                    continue
                block = {a: n for a, n in
                         zip(CANONICAL_AXES, (dp, fsdp, tp, sp)) if n > 1}
                # the validator is the source of truth for admissibility
                extents = resolve_block(block, world)
                key = tuple(extents.items())
                if key in seen:
                    continue
                seen.add(key)
                stages = tuple(zero_stages) if fsdp > 1 else (1,)
                for stage in stages:
                    out.append(LayoutCandidate(
                        name=_layout_name(extents, stage),
                        axes=tuple(extents.items()),
                        zero_stage=int(stage)))
    out.sort(key=lambda c: (sum(1 for _, n in c.axes if n > 1),
                            c.zero_stage, c.name))
    return out


def enumerate_comm_variants(
    *,
    modes: Sequence[str] = ("fp32", "bf16", "int8", "lossless"),
    bucket_mbs: Sequence[float] = (0.05, 1.0, 25.0),
    overlaps: Sequence[str] = ("off",),
    include_none: bool = True,
) -> List[CommCandidate]:
    """Admissible ``"comm"`` blocks (each validated via CommConfig) plus,
    optionally, the no-comm-block baseline."""
    for m in modes:
        if m not in COMM_MODES:
            raise ValueError(f"unknown comm mode {m!r}; valid: {COMM_MODES}")
    out: List[CommCandidate] = []
    if include_none:
        out.append(CommCandidate(name="psum_fp32", block=None))
    for mode in modes:
        for mb in bucket_mbs:
            for ov in overlaps:
                block = {"mode": mode, "bucket_mb": float(mb), "overlap": ov}
                CommConfig.from_dict(block)  # raises on anything bogus
                name = f"{mode}_b{mb:g}mb" + ("" if ov == "off" else f"_{ov}")
                out.append(CommCandidate(name=name, block=block))
    return out


def enumerate_kernel_routes(
    routes: Sequence[str] = ("off", "fused", "auto"),
) -> List[Dict[str, object]]:
    """Admissible ``"kernels"`` blocks, validated through ops.kernel_config."""
    return [_kernel_config.validate({"mode": r}) for r in routes]


def kv_pool_bytes(model: ModelSpec, block_size: int, num_blocks: int) -> int:
    """Bytes for the paged KV pool (delegates to
    :meth:`ServingConfig.kv_pool_bytes` so serving/ owns the formula)."""
    sc = ServingConfig(block_size=block_size, num_blocks=num_blocks)
    return sc.kv_pool_bytes(model.n_layer, model.kv_heads, model.head_dim,
                            model.dtype_bytes)


def enumerate_serving_buckets(
    model: ModelSpec,
    *,
    num_slots: int = 8,
    max_seq_len: Optional[int] = None,
    block_sizes: Sequence[int] = (16, 32),
    pool_doublings: int = 4,
    draft_ks: Sequence[int] = (0,),
    drafter_layers: Optional[int] = None,
) -> List[ServingCandidate]:
    """Serving shape candidates over (block_size, num_blocks, draft_k).

    For each block size the pool is doubled from the minimum that can
    hold every decode slot at ``max_seq_len`` up through
    ``pool_doublings`` steps — deliberately overshooting so the HBM
    frontier is explored and the cost model always has an infeasible
    candidate to *report* (never to silently drop) on any platform.

    ``draft_ks`` adds speculative-decoding variants: ``0`` is the plain
    candidate, ``k > 0`` emits a ``_spec{k}`` variant whose block
    carries a ``"speculative"`` sub-block (truncated drafter of
    ``drafter_layers`` layers, defaulting to the engine's quarter-depth
    rule). A spec variant's ``kv_pool_bytes`` includes the drafter's
    own paged pool, so the HBM gate prices the pair, not just the
    target.
    """
    max_seq_len = max_seq_len or max(model.seq, 64)
    d_layers = (int(drafter_layers) if drafter_layers is not None
                else max(1, model.n_layer // 4))
    out: List[ServingCandidate] = []
    for bs in block_sizes:
        if max_seq_len % bs:
            continue
        min_blocks = num_slots * (max_seq_len // bs) + 1  # +1: null block
        blocks = min_blocks
        for _ in range(pool_doublings + 1):
            for k in draft_ks:
                block = {
                    "num_slots": num_slots,
                    "block_size": bs,
                    "num_blocks": int(blocks),
                    "max_seq_len": max_seq_len,
                }
                name = f"bs{bs}_nb{int(blocks)}"
                layers = model.n_layer
                if k:
                    block["speculative"] = {
                        "draft_k": int(k),
                        "drafter": {"n_layer": d_layers},
                    }
                    name += f"_spec{int(k)}"
                    layers = model.n_layer + d_layers  # target + drafter
                sc = ServingConfig.from_dict(block)  # validator gates
                out.append(ServingCandidate(
                    name=name,
                    block=block,
                    prefill_buckets=tuple(sc.prefill_buckets),
                    kv_pool_bytes=sc.kv_pool_bytes(
                        layers, model.kv_heads, model.head_dim,
                        model.dtype_bytes),
                ))
            blocks *= 2
    return out


def space_hash(
    world: int,
    model: ModelSpec,
    layouts: Sequence[LayoutCandidate],
    comms: Sequence[CommCandidate],
    kernel_routes: Sequence[dict],
    servings: Sequence[ServingCandidate] = (),
) -> str:
    """Deterministic fingerprint of the searched space.

    Canonical-JSON sha256 over every candidate's identity — two runs
    that searched different spaces can never share a hash, and the same
    space always reproduces it (sorted keys, no floats from timing).
    """
    doc = {
        "world": int(world),
        "model": model.as_dict(),
        "mesh": [
            {"name": c.name, "axes": list(c.axes), "zero": c.zero_stage}
            for c in layouts
        ],
        "comm": [{"name": c.name, "block": c.block} for c in comms],
        "kernels": [dict(sorted(k.items())) for k in kernel_routes],
        "serving": [{"name": s.name, "block": s.block} for s in servings],
    }
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]
