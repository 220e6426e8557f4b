"""Comm-block configuration.

Counterpart of deeperspeed_tpu/runtime/comm/config.py, this package's own
copy: the same keys, defaults and errors. A ``"comm"`` block in the config
builds a ``CommConfig``; block presence enables the reducer unless
``{"enabled": false}``. Without it the engine's reducer runs the fp32
wire with these defaults.

::

    "comm": {
        "mode": "int8",          # fp32 | bf16 | int8 | compressed | lossless
        "bucket_mb": 25,         # flat bucket size bound (layer order)
        "block": 128,            # quantization block (int8/compressed)
        "error_feedback": true,  # persistent residuals for lossy modes
        "hierarchical": "auto",  # off | auto | on  (two-level schedule)
        "intra_size": null,      # ranks per host group (null = detect)
        "overlap": "off"         # off | auto | on  (backward overlap)
    }

``mode`` picks the per-bucket wire format (runtime/comm/reducer.py):
fp32 and bf16 all-reduce; int8 quantizes blocks of ``block`` values with
per-block fp32 scales (all-to-all of each rank's chunks, then all-gather
of the re-quantized partial sums); compressed ships fp16 mantissas with
per-block int8 exponents (24 bits an element) by all-gather; lossless
gathers each rank's exact fp32 bytes as byte planes and sums them in a
fixed pairwise tree. Lossy modes keep per-rank error-feedback residuals
(checkpointed), so the quantization error of one step is added back at
the next.

``overlap`` "on" launches each bucket's reduction on a comm thread as soon
as its gradients are final and drains them at the accumulation boundary
(runtime/comm/overlap.py), bit-identical to "off"; "auto" does so when
there are several ranks and no canonical slots.
"""

import dataclasses
from typing import Optional

MODES = ("fp32", "bf16", "int8", "compressed", "lossless")
HIERARCHICAL = ("off", "auto", "on")
OVERLAP = ("off", "auto", "on")

_KNOWN_KEYS = frozenset({
    "enabled", "mode", "bucket_mb", "block", "error_feedback",
    "hierarchical", "intra_size", "overlap",
})


@dataclasses.dataclass(frozen=True)
class CommConfig:
    # master switch; runtime/config.py treats block presence as enabled
    # unless {"enabled": false}
    enabled: bool = True
    # per-bucket reduction wire format (see the module docstring)
    mode: str = "fp32"
    # flat fp32 bucket size bound in MiB; leaves fill buckets greedily in
    # layer (tree-flatten) order and a leaf never splits across buckets,
    # so a single leaf larger than the bound gets its own bucket
    bucket_mb: float = 25.0
    # quantization block length for int8 per-block scales and the
    # compressed (24-bit) block exponents
    block: int = 128
    # persistent per-rank residuals: the quantization error of step t is
    # added back to the raw gradient at step t+1 before re-quantizing
    error_feedback: bool = True
    # two-level schedule (intra-host reduce-scatter in full precision,
    # inter-host gather quantized): "on" forces it, "auto" enables it when
    # the ranks span several hosts (distributed/topology.py), "off" never
    hierarchical: str = "off"
    # ranks per intra group for the hierarchical schedule; None detects
    # LOCAL_WORLD_SIZE; must divide the data-parallel world size
    intra_size: Optional[int] = None
    # backward-overlap collective scheduling (runtime/comm/overlap.py):
    # "on" always, "auto" with several ranks and no canonical slots
    overlap: str = "off"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(
                f'comm mode must be one of {list(MODES)}, got "{self.mode}"')
        if not (float(self.bucket_mb) > 0):
            raise ValueError(
                f"comm bucket_mb must be > 0, got {self.bucket_mb}")
        if int(self.block) < 8:
            raise ValueError(f"comm block must be >= 8, got {self.block}")
        if self.hierarchical not in HIERARCHICAL:
            raise ValueError(
                f"comm hierarchical must be one of {list(HIERARCHICAL)}, "
                f'got "{self.hierarchical}"')
        if self.intra_size is not None and int(self.intra_size) < 1:
            raise ValueError(
                f"comm intra_size must be >= 1, got {self.intra_size}")
        if self.overlap not in OVERLAP:
            raise ValueError(
                f"comm overlap must be one of {list(OVERLAP)}, "
                f'got "{self.overlap}"')

    @property
    def bucket_bytes(self) -> int:
        return int(float(self.bucket_mb) * 1024 * 1024)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "CommConfig":
        d = dict(d or {})
        unknown = set(d) - _KNOWN_KEYS
        if unknown:
            raise ValueError(
                f"unknown comm config keys {sorted(unknown)}; "
                f"valid keys: {sorted(_KNOWN_KEYS)}")
        return cls(**d)
