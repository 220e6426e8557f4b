"""Modeled wire traffic for a bucket plan: the comm half of the cost model.

Counterpart of deeperspeed_tpu/runtime/comm/wiremodel.py, this package's
own copy: the same functions, the same integers. It prices what the
reducer puts on the wire straight from the :class:`~.bucketing.BucketPlan`
the ``GradReducer`` executes and the bits-per-element matrix below:

============  ===============================  ====================
mode          wire format (two-phase)          ~bits per element
============  ===============================  ====================
fp32          fp32 reduce-scatter + all-gather 64
bf16          bf16 both phases                 32
int8          blockwise int8 + fp32 scales     16 + 64/block
compressed    fp16-mantissa + int8 blocks      48
lossless      byte-plane all_gather (exact)    32·w / 2 per phase
============  ===============================  ====================

``lossless`` is gather-based, so its cost grows with the world size (the
w-aware branch of :func:`plan_wire_bytes`); :func:`hier_wire_split` prices
the intra-host and cross-host hops of the two-level schedule separately.

Per-device bytes apply the ring factor ``2·(w−1)/w`` to the two-phase
bits, as the reference does, so :func:`plan_wire_bytes` is twice the
reducer's own per-bucket model (``GradReducer.total_wire_bytes``) for the
flat fp32, bf16 and int8 wires, up to each one's integer truncation: the
reference counts both phases in the bits and again in the factor. Launch counts are two collectives per
bucket. Pure host arithmetic.
"""

from typing import Dict, Optional

from .bucketing import BucketPlan
from .config import MODES, CommConfig

__all__ = [
    "dense_wire_bytes",
    "hier_wire_split",
    "mode_wire_bits",
    "plan_collective_launches",
    "plan_wire_bytes",
    "ring_factor",
    "wire_summary",
]


def mode_wire_bits(mode: str, block: int = 128, world: int = 2) -> float:
    """Total bits per gradient element across both collective phases."""
    if mode not in MODES:
        raise ValueError(f"unknown comm mode {mode!r}; valid: {list(MODES)}")
    if mode == "fp32":
        return 64.0
    if mode == "bf16":
        return 32.0
    if mode == "int8":
        # int8 payload both phases + one fp32 scale per block per phase
        return 16.0 + 64.0 / max(1, int(block))
    if mode == "lossless":
        # gather-based: w exact fp32 payloads, normalized by 2 phases to
        # fit the shared padded * bits/8 * 2 * ring_factor formula
        return 32.0 * max(2, int(world)) / 2.0
    return 48.0  # compressed: 24-bit (fp16 mantissa + int8 block exponent)


def ring_factor(world: int) -> float:
    """Fraction of the payload each device moves per phase on a ring."""
    w = max(1, int(world))
    return (w - 1) / w


def plan_wire_bytes(plan: BucketPlan, cfg: CommConfig, world: int) -> int:
    """Per-device bytes on the wire for one full reduction of ``plan``."""
    if world <= 1:
        return 0
    bits = mode_wire_bits(cfg.mode, cfg.block, world)
    padded = sum(b.padded for b in plan.buckets)
    return int(padded * bits / 8.0 * 2.0 * ring_factor(world))


def hier_wire_split(plan: BucketPlan, cfg: CommConfig, world: int,
                    intra_size: int) -> Dict[str, float]:
    """Per-device bytes of the two-level schedule, split by hop, for the
    two hierarchical modes ("int8" and "lossless"; the intra hops are fp32
    in both). Returns ``{"intra_bytes", "inter_bytes", "total_bytes"}``."""
    k = int(intra_size)
    if world <= 1 or k <= 1 or world % k:
        raise ValueError(
            f"hier_wire_split needs intra_size > 1 dividing world "
            f"(got intra_size={intra_size}, world={world})")
    if cfg.mode not in ("int8", "lossless"):
        raise ValueError(
            f'hier_wire_split applies to modes "int8" and "lossless", '
            f'got "{cfg.mode}"')
    nn = world // k
    fi = ring_factor(k)       # intra group ring fraction
    fx = ring_factor(nn)      # inter (cross-host) group fraction
    L = sum(b.padded for b in plan.buckets)
    chunk = L // k
    if cfg.mode == "lossless":
        intra = fi * (4.0 * chunk          # fp32 RS of my host's share
                      + 4.0 * L)           # fp32 AG rebuild
        inter = fx * (nn * 4.0 * chunk)    # byte-plane AG across hosts
    else:
        nb1 = chunk // cfg.block
        intra = fi * (4.0 * chunk                       # fp32 RS
                      + L + 4.0 * k * nb1)              # int8 AG rebuild
        inter = fx * (nn * (chunk + 4.0 * nb1))         # int8 AG + scales
    return {
        "intra_bytes": float(int(intra)),
        "inter_bytes": float(int(inter)),
        "total_bytes": float(int(intra + inter)),
    }


def plan_collective_launches(plan: BucketPlan, world: int) -> int:
    """Collective dispatches per reduction: reduce-scatter + all-gather
    per bucket."""
    if world <= 1:
        return 0
    return 2 * len(plan.buckets)


def dense_wire_bytes(n_elements: int, world: int,
                     bits_per_element: float = 64.0) -> int:
    """The no-reducer baseline: one unbucketed fp32 all-reduce of the
    whole gradient tree."""
    if world <= 1:
        return 0
    return int(n_elements * bits_per_element / 8.0 * 2.0 * ring_factor(world))


def wire_summary(plan: Optional[BucketPlan], cfg: Optional[CommConfig],
                 world: int, n_elements: int) -> Dict[str, float]:
    """Modeled bytes, launches and the ratio to the dense fp32 baseline,
    in one dict."""
    dense = dense_wire_bytes(n_elements, world)
    if plan is None or cfg is None:
        return {
            "mode": "psum_fp32",
            "wire_bytes_per_device": float(dense),
            "collective_launches": 1.0 if world > 1 else 0.0,
            "vs_dense_fp32": 1.0,
        }
    wire = plan_wire_bytes(plan, cfg, world)
    return {
        "mode": cfg.mode,
        "wire_bytes_per_device": float(wire),
        "collective_launches": float(plan_collective_launches(plan, world)),
        "vs_dense_fp32": (wire / dense) if dense else 0.0,
    }
