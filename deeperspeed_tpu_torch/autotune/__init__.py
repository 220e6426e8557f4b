"""The autotuner's provenance records (provenance.py). The search itself
(the rest of the reference's autotune/) is not ported yet (ROADMAP.md
section 1, item 12)."""

from .provenance import (PROVENANCE_REQUIRED_KEYS, TUNED_KEYS,
                         knob_fingerprint, make_provenance,
                         verify_provenance)

__all__ = ["PROVENANCE_REQUIRED_KEYS", "TUNED_KEYS", "knob_fingerprint",
           "make_provenance", "verify_provenance"]
