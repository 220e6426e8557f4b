"""Serving metrics: per-request TTFT/TPOT, queue depth, slot occupancy,
tokens/s, and the SLO tracker.

Counterpart of deeperspeed_tpu/serving/metrics.py (``SLOTracker``,
``record_finish_outcome``, ``ServingMetrics``) with the reference's metric
names. Collection is host-side and allocation-light (floats appended to
lists); with a registry (the monitor's) every record_* hook also feeds the
Prometheus counters, gauges and histograms, and ``export`` writes the
running summary through a ``TensorBoardMonitor``. Not ported yet: the
speculative-decoding accounting (with speculative decoding) and
``FleetMetrics`` (with the fleet).
"""

import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..monitor.metrics import DEFAULT_LATENCY_BUCKETS, MetricsRegistry
from ..monitor.tracer import trace_instant
from ..utils.tensorboard import TensorBoardMonitor
from ..utils.timer import SynchronizedWallClockTimer

# timer names (appear in SynchronizedWallClockTimer.log output)
PREFILL_TIMER = "serving/prefill"
DECODE_TIMER = "serving/decode"


class SLOTracker:
    """Live SLO accounting against an ``SLOConfig`` (serving/config.py).

    Each observed latency is checked against its axis target
    (``ttft``/``tpot``/``e2e`` p99 bounds in ms); a breach emits an
    ``slo/violation`` trace instant and bumps the labeled violation
    counter, and every observation refreshes the burn-rate gauge:
    ``burn_rate = violating_fraction / error_budget``. 1.0 means the
    stream violates exactly as fast as a p99 promise allows; > 1.0
    means the error budget is burning down. A None/empty config makes
    every call a no-op, so both metrics classes embed one
    unconditionally."""

    def __init__(self, slo=None,
                 registry: Optional[MetricsRegistry] = None):
        self.slo = slo
        self.registry = registry
        # axis -> [observations, violations]
        self.counts: Dict[str, List[int]] = {}

    @property
    def enabled(self) -> bool:
        return self.slo is not None and bool(self.slo.targets())

    def observe(self, axis: str, seconds: float) -> bool:
        """Record one latency on ``axis``; returns True on violation."""
        if self.slo is None:
            return False
        target_ms = self.slo.targets().get(axis)
        if target_ms is None:
            return False
        value_ms = seconds * 1e3
        n = self.counts.setdefault(axis, [0, 0])
        n[0] += 1
        violated = value_ms > target_ms
        if violated:
            n[1] += 1
            trace_instant("slo/violation", lane="serving", slo=axis,
                          value_ms=round(value_ms, 3),
                          target_ms=target_ms)
        if self.registry is not None:
            if violated:
                self.registry.counter(
                    "slo_violations_total",
                    "Latency observations over their SLO target.",
                    labels={"slo": axis}).inc()
            self.registry.gauge(
                "slo_burn_rate",
                "Violating fraction / error budget (1.0 = burning "
                "exactly at the p99 promise).",
                labels={"slo": axis}).set(self.burn_rate(axis))
        return violated

    def burn_rate(self, axis: str) -> float:
        n = self.counts.get(axis)
        if not n or not n[0] or self.slo is None:
            return 0.0
        return (n[1] / n[0]) / self.slo.error_budget

    def summary(self) -> Dict[str, Dict]:
        if self.slo is None:
            return {}
        out = {}
        for axis, target_ms in self.slo.targets().items():
            obs, viol = self.counts.get(axis, [0, 0])
            out[axis] = {
                "target_ms": target_ms,
                "observations": obs,
                "violations": viol,
                "violation_rate": viol / obs if obs else 0.0,
                "burn_rate": round(self.burn_rate(axis), 4),
            }
        return out


def record_finish_outcome(registry: Optional[MetricsRegistry],
                          reason: str) -> None:
    """Bump the labeled per-attempt outcome counter. The label space is
    the union of engine finish reasons (``length``/``eos``/``timeout``)
    and router outcomes (``shed``/``retried``/``failed``), so one
    ``serving_finish_total`` series tells the whole admission-to-finish
    story; no-op without a registry."""
    if registry is None:
        return
    registry.counter(
        "serving_finish_total",
        "Per-attempt request outcomes (engine evictions + router "
        "shed/retry/failover), labeled by reason.",
        labels={"reason": str(reason)},
    ).inc()


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
                 clock: Callable[[], float] = time.monotonic,
                 monitor: Optional[TensorBoardMonitor] = None,
                 registry: Optional[MetricsRegistry] = None,
                 slo=None):
        self.num_slots = num_slots
        self.clock = clock
        self.monitor = monitor
        self.registry = registry
        self.slo_tracker = SLOTracker(slo, registry)
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
        if registry is not None:
            self._c_tokens = registry.counter(
                "serving_tokens_generated_total",
                "Tokens emitted (prefill first-tokens + decode tokens).")
            self._c_prefills = registry.counter(
                "serving_prefills_total", "Prefill launches (admissions).")
            self._c_decode = registry.counter(
                "serving_decode_steps_total", "Batched decode steps.")
            self._c_preempt = registry.counter(
                "serving_preemptions_total",
                "Requests preempted back to the queue.")
            self._g_queue = registry.gauge(
                "serving_queue_depth", "Requests waiting for admission.")
            self._g_active = registry.gauge(
                "serving_active_slots", "Slots currently running a request.")
            self._g_occ = registry.gauge(
                "serving_slot_occupancy",
                "Active slots / num_slots at the last decode step.")
            self._h_ttft = registry.histogram(
                "serving_ttft_seconds", "Time to first token.",
                buckets=DEFAULT_LATENCY_BUCKETS)
            self._h_tpot = registry.histogram(
                "serving_tpot_seconds", "Time per output token (per-request "
                "mean, recorded at finish).",
                buckets=DEFAULT_LATENCY_BUCKETS)

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
            self.slo_tracker.observe("ttft", ttft_s)
        self._end_t = now
        if self.registry is not None:
            self._c_prefills.inc()
            self._c_tokens.inc()
            if ttft_s is not None:
                self._h_ttft.observe(ttft_s)

    def record_reuse(self, matched: int, ctx_len: int) -> None:
        """One admission's prefix-cache outcome: ``matched`` of the
        ``ctx_len`` context tokens came out of the radix cache (0 on a
        miss — call this for EVERY admission so the saved fraction has
        its denominator)."""
        self.admissions += 1
        self.prefill_tokens += ctx_len
        if matched > 0:
            self.reuse_hits += 1
            self.tokens_saved += matched
            if self.registry is not None:
                self.registry.counter(
                    "serving_prefix_reuse_hits_total",
                    "Admissions that matched a cached prefix.").inc()
                self.registry.counter(
                    "serving_prefill_tokens_saved_total",
                    "Prompt tokens served from the prefix cache instead "
                    "of recomputed.").inc(matched)

    def record_cow_split(self) -> None:
        """A matched boundary page copied into a private block (exactly
        one per admission whose match ends mid-block)."""
        self.cow_splits += 1
        if self.registry is not None:
            self.registry.counter(
                "serving_kv_cow_splits_total",
                "Copy-on-write splits of shared boundary pages.").inc()

    def record_prefill_chunk(self, tokens: int) -> None:
        """One staged prompt-chunk forward (chunked/suffix prefill)."""
        self.prefill_chunks += 1
        self.chunk_tokens += tokens
        if self.registry is not None:
            self.registry.counter(
                "serving_prefill_chunks_total",
                "Staged prompt-chunk forwards.").inc()

    def record_decode_step(self, n_active: int, queue_depth: int,
                           now: float) -> None:
        if self._start_t is None:
            self._start_t = now
        self.decode_steps += 1
        self.total_generated += n_active
        self.queue_depth.append(queue_depth)
        self.occupancy.append(n_active / self.num_slots)
        self._end_t = now
        if self.registry is not None:
            self._c_decode.inc()
            self._c_tokens.inc(n_active)
            self._g_queue.set(queue_depth)
            self._g_active.set(n_active)
            self._g_occ.set(n_active / self.num_slots)

    def record_preemption(self) -> None:
        self.preemptions += 1
        if self.registry is not None:
            self._c_preempt.inc()

    def record_finish(self, req, now: float) -> None:
        self.finished[req.finish_reason] = (
            self.finished.get(req.finish_reason, 0) + 1)
        self._end_t = now
        n = len(req.generated)
        tpot = None
        if n > 1 and req.first_token_t is not None:
            tpot = (now - req.first_token_t) / (n - 1)
            self.tpot_s.append(tpot)
            self.slo_tracker.observe("tpot", tpot)
        if req.first_token_t is not None:
            # engine-side E2E: arrival to terminal (the router tracks
            # its own accept-to-terminal E2E for fleet serving)
            self.slo_tracker.observe("e2e", now - req.arrival_t)
        if self.registry is not None:
            self.registry.counter(
                "serving_requests_finished_total",
                "Finished requests by terminal reason.",
                labels={"reason": str(req.finish_reason)},
            ).inc()
            # one label space shared with the router layer, so engine
            # evictions and router outcomes (shed/retried/failed) land
            # in the same serving_finish_total series
            record_finish_outcome(self.registry, req.finish_reason)
            if tpot is not None:
                self._h_tpot.observe(tpot)

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
            "slo": self.slo_tracker.summary(),
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

    def export(self, step: int) -> None:
        """Push the running summary to the TensorBoard monitor (JSONL
        fallback included — see utils/tensorboard.py)."""
        if self.monitor is None:
            return
        s = self.summary()
        self.monitor.write_scalars(
            {
                "Serving/tokens_per_sec": s["tokens_per_sec"],
                "Serving/ttft_p50_s": s["ttft_s"]["p50"],
                "Serving/ttft_p99_s": s["ttft_s"]["p99"],
                "Serving/tpot_p50_s": s["tpot_s"]["p50"],
                "Serving/tpot_p99_s": s["tpot_s"]["p99"],
                "Serving/slot_occupancy": s["slot_occupancy"],
                "Serving/queue_depth": float(
                    self.queue_depth[-1] if self.queue_depth else 0),
                "Serving/preemptions": float(self.preemptions),
            },
            step,
        )
