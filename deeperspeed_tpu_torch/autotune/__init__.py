"""``autotune/``: the config search over the port's knobs.

Counterpart of deeperspeed_tpu/autotune/: every performance knob (mesh
extents dp x fsdp x tp x sp, ZeRO stage, the comm block, the kernel
route, the serving shape buckets) is enumerable and priceable without
running a step on the card:

  * :mod:`.space`      -- the admissible space, enumerated through the
    port's own validators, so the tuner never proposes a config the
    engine would reject;
  * :mod:`.capture`    -- one rank's step of a candidate captured on the
    ``meta`` device (flops, bytes, peak bytes), with the no-pollution
    contract checked around it;
  * :mod:`.costmodel`  -- the reference's static ranking, repriced for
    the H100: the roofline over the captured cost, the wire model at the
    rate and launch cost of the ranks' transport, the memory fit;
    infeasible candidates pruned with a stated reason, never silently;
  * :mod:`.confirm`    -- short measured runs of a spread of the ranking
    in rank processes, and the Spearman rank correlation between the
    predicted and measured orders;
  * :mod:`.provenance` -- the knob fingerprint and ``"provenance"`` record
    emitted with a winning config.

CLI: ``python -m deeperspeed_tpu_torch.autotune --devices 2`` (see
``__main__.py``).
"""

from .capture import aot_capture, sandboxed_cost_index
from .confirm import (confirm_candidates, rank_correlation, select_spread,
                      spearman)
from .costmodel import (
    CandidatePrice,
    platform_budget,
    price_comm_variants,
    price_layout,
    price_serving,
    rank_candidates,
)
from .provenance import (
    PROVENANCE_REQUIRED_KEYS,
    TUNED_KEYS,
    knob_fingerprint,
    make_provenance,
    verify_provenance,
)
from .space import (
    CommCandidate,
    LayoutCandidate,
    ModelSpec,
    ServingCandidate,
    enumerate_comm_variants,
    enumerate_kernel_routes,
    enumerate_mesh_layouts,
    enumerate_serving_buckets,
    resolve_block,
    space_hash,
)

__all__ = [
    "CandidatePrice",
    "CommCandidate",
    "LayoutCandidate",
    "ModelSpec",
    "PROVENANCE_REQUIRED_KEYS",
    "ServingCandidate",
    "TUNED_KEYS",
    "aot_capture",
    "confirm_candidates",
    "enumerate_comm_variants",
    "enumerate_kernel_routes",
    "enumerate_mesh_layouts",
    "enumerate_serving_buckets",
    "knob_fingerprint",
    "make_provenance",
    "platform_budget",
    "price_comm_variants",
    "price_layout",
    "price_serving",
    "rank_candidates",
    "rank_correlation",
    "resolve_block",
    "sandboxed_cost_index",
    "select_spread",
    "spearman",
    "space_hash",
    "verify_provenance",
]
