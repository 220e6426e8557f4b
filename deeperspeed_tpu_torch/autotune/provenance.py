"""Provenance records: proof a config's knobs came out of the tuner.

Counterpart of deeperspeed_tpu/autotune/provenance.py, copied as it is
(the reference's module imports no jax; the port keeps its own copy).

A config the autotuner emits carries a ``"provenance"`` block:

.. code-block:: json

    {"provenance": {
        "tool": "deeperspeed_tpu.autotune",
        "space_hash": "…",          # fingerprint of the searched space
        "knob_hash": "…",           # fingerprint of the tuned knob blocks
        "git_rev": "…", "platform": "cpu", "devices": 8,
        "predicted_step_s": 0.0123, "measured_step_ms": 14.1,
        "rank_correlation": 1.0}}

``knob_hash`` is a canonical-JSON sha256 over exactly the blocks the
tuner chose (:data:`TUNED_KEYS`). Hand-editing any tuned knob after the
fact breaks the hash, and the analysis gate
(the reference's ``analysis.provenance.check_config_provenance``)
turns that into an *error* finding — so a config cannot silently claim
"autotuned" while running hand-rolled knobs. Editing non-tuned keys
(batch sizes, optimizer, monitor…) does not disturb the hash; those are
the user's to own.

``TOOL_NAME`` stays the reference's: the shipped configs were signed
by its tuner, and the port's config accepts them as they are.
"""

import hashlib
import json
import subprocess
from typing import Dict, Optional, Tuple

__all__ = [
    "PROVENANCE_REQUIRED_KEYS",
    "TUNED_KEYS",
    "git_rev",
    "knob_fingerprint",
    "make_provenance",
    "verify_provenance",
]

# exactly the config blocks the tuner chooses; everything else in the
# config is user-owned and excluded from the fingerprint
TUNED_KEYS: Tuple[str, ...] = (
    "mesh", "zero_optimization", "comm", "kernels", "serving",
)

PROVENANCE_REQUIRED_KEYS: Tuple[str, ...] = (
    "tool", "space_hash", "knob_hash", "platform", "devices",
)

TOOL_NAME = "deeperspeed_tpu.autotune"


def knob_fingerprint(config: Dict[str, object]) -> str:
    """sha256 (hex, 16 chars) over the tuned knob blocks, canonical JSON."""
    knobs = {k: config[k] for k in TUNED_KEYS if k in config}
    blob = json.dumps(knobs, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def git_rev(default: str = "unknown") -> str:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10)
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else default
    except Exception:
        return default


def make_provenance(
    config: Dict[str, object],
    *,
    space_hash: str,
    platform: str,
    devices: int,
    predicted_step_s: Optional[float] = None,
    measured_step_ms: Optional[float] = None,
    rank_correlation: Optional[float] = None,
    rev: Optional[str] = None,
) -> Dict[str, object]:
    """The ``"provenance"`` block for ``config`` (knob hash computed here,
    so call this AFTER the tuned blocks are final)."""
    rec: Dict[str, object] = {
        "tool": TOOL_NAME,
        "space_hash": str(space_hash),
        "knob_hash": knob_fingerprint(config),
        "git_rev": rev if rev is not None else git_rev(),
        "platform": str(platform),
        "devices": int(devices),
    }
    if predicted_step_s is not None:
        rec["predicted_step_s"] = round(float(predicted_step_s), 9)
    if measured_step_ms is not None:
        rec["measured_step_ms"] = round(float(measured_step_ms), 6)
    if rank_correlation is not None:
        rec["rank_correlation"] = round(float(rank_correlation), 6)
    return rec


def verify_provenance(config: Dict[str, object]) -> Tuple[bool, str]:
    """Check a config's provenance claim. Returns ``(ok, detail)``.

    A config without a ``"provenance"`` key trivially verifies (nothing
    claimed). One WITH the key must be well-formed and its recorded
    ``knob_hash`` must match a fresh fingerprint of the tuned blocks —
    i.e. nobody hand-edited a tuned knob after the tuner signed it.
    """
    prov = config.get("provenance")
    if prov is None:
        return True, "no provenance claimed"
    if not isinstance(prov, dict):
        return False, f'"provenance" must be a dict, got {type(prov).__name__}'
    missing = [k for k in PROVENANCE_REQUIRED_KEYS if k not in prov]
    if missing:
        return False, f"provenance record missing keys {missing}"
    expect = knob_fingerprint(config)
    got = prov.get("knob_hash")
    if got != expect:
        return False, (
            f"knob_hash mismatch: provenance records {got!r} but the "
            f"config's tuned blocks {[k for k in TUNED_KEYS if k in config]} "
            f"hash to {expect!r} — a tuned knob was edited after the "
            f"autotuner signed this config (re-run the tuner or drop the "
            f'"provenance" block)')
    return True, "knob_hash verified"
