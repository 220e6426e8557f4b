"""Serving metrics: per-request TTFT/TPOT, queue depth, slot occupancy,
tokens/s.

Counterpart of the parts of deeperspeed_tpu/serving/metrics.py's
``ServingMetrics`` that the engine calls: the prefill/decode timers, the
record_* hooks and the summary. Collection is host-side (floats appended
to lists). Not ported yet: the Prometheus registry, the TensorBoard
export, ``SLOTracker`` and ``FleetMetrics``.
"""

import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..utils.timer import SynchronizedWallClockTimer

# timer names (appear in SynchronizedWallClockTimer.log output)
PREFILL_TIMER = "serving/prefill"
DECODE_TIMER = "serving/decode"


def _percentiles(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"p50": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
    a = np.asarray(xs, np.float64)
    return {
        "p50": float(np.percentile(a, 50)),
        "p99": float(np.percentile(a, 99)),
        "mean": float(a.mean()),
        "max": float(a.max()),
    }


class ServingMetrics:
    def __init__(self, num_slots: int,
                 clock: Callable[[], float] = time.monotonic):
        self.num_slots = num_slots
        self.clock = clock
        self.timers = SynchronizedWallClockTimer()
        self.ttft_s: List[float] = []
        self.tpot_s: List[float] = []
        self.queue_depth: List[int] = []
        self.occupancy: List[float] = []
        self.total_generated = 0
        self.decode_steps = 0
        self.prefills = 0
        self.preemptions = 0
        # prefix reuse / chunked prefill: admissions is every context
        # prefilled, prefill_tokens its token total; tokens_saved the
        # part served from the radix cache instead of recomputed
        self.admissions = 0
        self.prefill_tokens = 0
        self.reuse_hits = 0
        self.tokens_saved = 0
        self.cow_splits = 0
        self.prefill_chunks = 0
        self.chunk_tokens = 0
        self.finished: Dict[str, int] = {}
        self._start_t: Optional[float] = None
        self._end_t: Optional[float] = None

    # ------------------------------------------------------------ #
    # recording
    # ------------------------------------------------------------ #

    def record_prefill(self, now: float,
                       ttft_s: Optional[float] = None) -> None:
        """One prefill (it emits one token). ttft_s is set only for a
        request's FIRST admission — preemption re-prefills don't re-count
        time-to-first-token."""
        if self._start_t is None:
            self._start_t = now
        self.prefills += 1
        self.total_generated += 1
        if ttft_s is not None:
            self.ttft_s.append(ttft_s)
        self._end_t = now

    def record_reuse(self, matched: int, ctx_len: int) -> None:
        """One admission's prefix-cache outcome: ``matched`` of the
        ``ctx_len`` context tokens came out of the radix cache (0 on a
        miss — called for EVERY admission so the saved fraction has its
        denominator)."""
        self.admissions += 1
        self.prefill_tokens += ctx_len
        if matched > 0:
            self.reuse_hits += 1
            self.tokens_saved += matched

    def record_cow_split(self) -> None:
        """A matched boundary page copied into a private block."""
        self.cow_splits += 1

    def record_prefill_chunk(self, tokens: int) -> None:
        """One staged prompt-chunk forward (chunked/suffix prefill)."""
        self.prefill_chunks += 1
        self.chunk_tokens += tokens

    def record_decode_step(self, n_active: int, queue_depth: int,
                           now: float) -> None:
        if self._start_t is None:
            self._start_t = now
        self.decode_steps += 1
        self.total_generated += n_active
        self.queue_depth.append(queue_depth)
        self.occupancy.append(n_active / self.num_slots)
        self._end_t = now

    def record_preemption(self) -> None:
        self.preemptions += 1

    def record_finish(self, req, now: float) -> None:
        self.finished[req.finish_reason] = (
            self.finished.get(req.finish_reason, 0) + 1)
        self._end_t = now
        n = len(req.generated)
        if n > 1 and req.first_token_t is not None:
            self.tpot_s.append((now - req.first_token_t) / (n - 1))

    # ------------------------------------------------------------ #
    # reporting
    # ------------------------------------------------------------ #

    @property
    def elapsed_s(self) -> float:
        if self._start_t is None or self._end_t is None:
            return 0.0
        return max(self._end_t - self._start_t, 1e-9)

    def summary(self) -> Dict:
        occ = np.asarray(self.occupancy, np.float64)
        return {
            "requests_finished": int(sum(self.finished.values())),
            "finish_reasons": dict(self.finished),
            "tokens_generated": int(self.total_generated),
            "decode_steps": int(self.decode_steps),
            "prefills": int(self.prefills),
            "preemptions": int(self.preemptions),
            "elapsed_s": self.elapsed_s,
            "tokens_per_sec": self.total_generated / self.elapsed_s
            if self.elapsed_s else 0.0,
            "ttft_s": _percentiles(self.ttft_s),
            "tpot_s": _percentiles(self.tpot_s),
            "slot_occupancy": float(occ.mean()) if occ.size else 0.0,
            "queue_depth_max": int(max(self.queue_depth, default=0)),
            "prefix_reuse": {
                "admissions": int(self.admissions),
                "reuse_hits": int(self.reuse_hits),
                "reuse_hit_rate": (self.reuse_hits / self.admissions
                                   if self.admissions else 0.0),
                "prefill_tokens": int(self.prefill_tokens),
                "tokens_saved": int(self.tokens_saved),
                "tokens_saved_frac": (self.tokens_saved
                                      / self.prefill_tokens
                                      if self.prefill_tokens else 0.0),
                "cow_splits": int(self.cow_splits),
                "prefill_chunks": int(self.prefill_chunks),
                "chunk_tokens": int(self.chunk_tokens),
            },
        }
