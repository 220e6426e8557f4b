"""Drafter-backed speculative decoding for the serving engine.

Counterpart of deeperspeed_tpu/serving/spec/. Enabled by the
``"speculative"`` sub-block of the serving config (see
serving/config.SpeculativeConfig; off by default). The engine meets
exactly three decode-path argument signatures (drafter decode, target
verify, fallback plain decode), and the emitted token stream is by
construction the one plain decode would produce: greedy identical (fp32;
near-ties may flip in bf16), sampled a pure function of (per-rid seed,
token index).
"""

from .runtime import SpecRuntime, truncated_drafter
from .steps import make_draft_step, make_verify_step

__all__ = [
    "SpecRuntime",
    "truncated_drafter",
    "make_draft_step",
    "make_verify_step",
]
