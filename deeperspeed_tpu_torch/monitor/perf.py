"""Cost observability: where do the flops and bytes go?

Counterpart of deeperspeed_tpu/monitor/perf.py. The reference re-lowers
every jitted entry point and reads XLA's ``cost_analysis()`` and
``memory_analysis()``. The port runs eagerly, so it records each entry
point's cost during its first real call at a new argument signature (the
:class:`~.watchdog.SignatureCache` the recompile watchdog reads; a warm
call pays one comparison). A capture counts three things:

  * **flops and bytes** of every aten op, from a ``TorchDispatchMode``:
    flops by ``torch.utils.flop_counter``'s formulas (matmuls,
    convolutions, SDPA; elementwise ops count none, by that module's
    convention), bytes as the nbytes of each op's tensor inputs and
    outputs (views and ``empty`` allocations move none);
  * **the port's own kernels' declared work.** A ctypes launch is
    invisible to a dispatch mode, so each kernel wrapper declares its
    flops and bytes (:func:`declares`), and the aten ops of its plain
    version inside the wrapper are not counted again: a step counts the
    same work whether the kernel or the plain version runs. The
    attention wrappers declare the products of the score tiles they
    cover, as flop_counter counts SDPA (a causal mask does not halve the
    count; a sparse layout keeps only its blocks); the elementwise
    kernels (LN, add-LN, bias+GeLU, fused Adam, the wire rows) declare
    their bytes and no flops;
  * **peak memory**, from ``torch.cuda.max_memory_allocated`` around the
    capture (its peak statistic is reset when the capture starts).

``flops`` are model flops: work inside a checkpoint recomputation
(``torch.utils.checkpoint``'s non-reentrant recompute) is kept apart as
``recompute_flops``, so the kernel path and the plain path count the
same ``flops`` whichever ops the remat policy replays. MFU is ``flops``
over the span's time against the peak, as in the reference.

The peak table has one row for the card, the published peaks of the
NVIDIA H100 80GB HBM3 (SXM): 989 TFLOP/s dense bf16 on the tensor cores,
3.35 TB/s of HBM3 and 80 GiB; and the reference's nominal ``cpu`` row, so
MFU numbers exist on the CPU (and exercise the plumbing) without
pretending to mean anything.
"""

import dataclasses
import functools
import threading
from typing import Any, Dict, List, Optional

from ..utils.logging import logger
from .tracer import get_tracer, trace_instant

__all__ = [
    "PLATFORM_PEAKS",
    "CompiledCostIndex",
    "CostRecord",
    "declares",
    "io_bytes",
    "platform_peaks",
]

# ------------------------------------------------------------------ #
# platform peak table
# ------------------------------------------------------------------ #

# peak_tflops: dense bf16 matmul peak per card; peak_gbps: device-memory
# rate, the other roofline axis; hbm_gib: capacity; ici_gbps: card-to-card
# rate one way. Keys match as substrings of the lower-cased device name.
PLATFORM_PEAKS: Dict[str, Dict[str, Any]] = {
    # spec values of the NVIDIA H100 80GB HBM3 (SXM5): 989 TFLOP/s dense
    # bf16, 3.35 TB/s HBM3, NVLink 4 at 900 GB/s both ways
    "h100": {"peak_tflops": 989.0, "peak_gbps": 3350.0,
             "hbm_gib": 80.0, "ici_gbps": 450.0,
             "label": "spec values of the NVIDIA H100 80GB HBM3"},
    # nominal: keeps CPU MFU numbers finite and the plumbing testable
    "cpu": {"peak_tflops": 0.5, "peak_gbps": 50.0,
            "hbm_gib": 1.0, "ici_gbps": 10.0, "label": "nominal"},
}


def platform_peaks(device=None) -> Dict[str, Any]:
    """Peak table row for ``device`` (default: the current CUDA device
    where CUDA is available, else the CPU). A CUDA card the table does not
    name takes the H100 row (source ``cuda-default``)."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return dict(PLATFORM_PEAKS["cpu"], source="cpu")
    kind = torch.cuda.get_device_name(device).lower()
    for key, row in PLATFORM_PEAKS.items():
        if key != "cpu" and key in kind:
            return dict(row, source=key)
    return dict(PLATFORM_PEAKS["h100"], source="cuda-default")


# ------------------------------------------------------------------ #
# the capture: a dispatch mode plus the kernels' declarations
# ------------------------------------------------------------------ #

# open captures, innermost last (each one a _Tally)
_ACTIVE: List["_Tally"] = []
# > 0 while a declaring kernel wrapper runs: its plain version's aten ops
# are not counted again
_SUSPENDED = [0]
_PORT_NAMESPACE = "deeperspeed_tpu_torch"


def _recomputing() -> bool:
    """Inside torch.utils.checkpoint's (non-reentrant) recomputation."""
    import torch

    try:
        hooks = torch._C._autograd._top_saved_tensors_default_hooks(False)
    except Exception:  # pragma: no cover - API moved
        return False
    return hooks is not None and getattr(
        hooks[0], "__qualname__", "").startswith("_recomputation_hook")


class _Tally:
    def __init__(self):
        self.flops = 0.0
        self.recompute_flops = 0.0
        self.bytes = 0.0
        self.error: Optional[str] = None

    def add(self, flops: float, nbytes: float, recompute: bool) -> None:
        if recompute:
            self.recompute_flops += flops
        else:
            self.flops += flops
        self.bytes += nbytes


def declares(work):
    """Decorator for a kernel wrapper: while a capture is open, each call
    adds ``work(result, *args, **kwargs) -> (flops, bytes[,
    recompute_flops])`` to it (``flops`` taken as recompute work inside a
    checkpoint recomputation), and the aten ops run inside the call (the
    plain version's, on the CPU) are not counted. With no capture open
    the call costs one list check."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _ACTIVE or _SUSPENDED[0]:
                return fn(*args, **kwargs)
            _SUSPENDED[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                _SUSPENDED[0] -= 1
            recompute = _recomputing()
            for t in _ACTIVE:
                try:
                    flops, nbytes, *extra = work(out, *args, **kwargs)
                    t.add(float(flops), float(nbytes), recompute)
                    t.recompute_flops += float(sum(extra))
                except Exception as e:  # noqa: BLE001 - observability only
                    if t.error is None:
                        t.error = (f"{fn.__name__} work: "
                                   f"{type(e).__name__}: {e}")
            return out
        return wrapper
    return deco


def io_bytes(out, *args, **kwargs) -> int:
    """The bytes of every tensor a call reads and writes once: its tensor
    arguments and its tensor results (the kernels' byte bound)."""
    return _nbytes((args, kwargs, out))


def _nbytes(tree) -> int:
    import torch
    from torch.utils._pytree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _counting_mode(tally: _Tally):
    """A TorchDispatchMode adding each aten op's flops and bytes to
    ``tally`` (built on first use: the module imports without torch's
    dispatch machinery)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _Counting(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if (_SUSPENDED[0] or func.namespace == _PORT_NAMESPACE
                    or func.is_view
                    or func.__name__.startswith(("empty", "detach"))):
                # the port's custom ops run declaring wrappers
                return out
            try:
                count = flop_registry.get(func._overloadpacket)
                flops = (count(*args, **kwargs, out_val=out)
                         if count is not None else 0)
                tally.add(float(flops), float(_nbytes((args, kwargs, out))),
                          _recomputing())
            except Exception as e:  # noqa: BLE001 - observability only
                if tally.error is None:
                    tally.error = f"{func}: {type(e).__name__}: {e}"
            return out

    return _Counting()


class _Capture:
    """Context manager of one capture (see CompiledCostIndex.capture)."""

    def __init__(self, index, name, size, device, args):
        self.index, self.name, self.size = index, name, size
        self.device, self.args = device, args
        self.tally = _Tally()

    def __enter__(self):
        import torch

        self.cuda = (self.device is not None
                     and torch.device(self.device).type == "cuda")
        if self.cuda:
            if not _ACTIVE:
                torch.cuda.reset_peak_memory_stats(self.device)
            self.before = torch.cuda.memory_allocated(self.device)
        self.mode = _counting_mode(self.tally)
        _ACTIVE.append(self.tally)
        self.mode.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        import torch

        self.mode.__exit__(exc_type, exc, tb)
        _ACTIVE.remove(self.tally)
        rec = CostRecord(name=self.name, cache_size=self.size,
                         flops=self.tally.flops,
                         recompute_flops=self.tally.recompute_flops,
                         bytes_accessed=self.tally.bytes,
                         argument_bytes=float(_nbytes(self.args)),
                         error=self.tally.error)
        if exc is not None:
            rec.error = f"the captured call raised {exc_type.__name__}: {exc}"
        if self.cuda:
            peak = torch.cuda.max_memory_allocated(self.device)
            after = torch.cuda.memory_allocated(self.device)
            rec.peak_bytes = float(peak)
            rec.temp_bytes = float(max(0, peak - max(self.before, after)))
            rec.output_bytes = float(max(0, after - self.before))
        self.index._store(rec)
        return False


class _NullCapture:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCapture()


# ------------------------------------------------------------------ #
# the index
# ------------------------------------------------------------------ #


@dataclasses.dataclass
class CostRecord:
    """One captured entry point. ``flops`` are model flops (recomputation
    apart in ``recompute_flops``); ``bytes_accessed`` every op's tensor
    bytes; ``peak_bytes`` the device's peak allocated bytes during the
    capture; ``optimal_seconds`` the roofline floor against the peaks."""

    name: str
    flops: float = 0.0
    recompute_flops: float = 0.0
    bytes_accessed: float = 0.0
    optimal_seconds: float = 0.0
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    temp_bytes: float = 0.0
    peak_bytes: float = 0.0
    cache_size: Optional[int] = None
    captures: int = 0
    error: Optional[str] = None

    def as_args(self) -> Dict[str, float]:
        return {
            "entry": self.name,
            "flops": self.flops,
            "bytes": self.bytes_accessed,
            "peak_hbm": self.peak_bytes,
            "optimal_s": self.optimal_seconds,
        }


class CompiledCostIndex:
    """Live table of what every eager entry point costs.

    ``capture(name, signatures, device)`` wraps an entry point's call: a
    no-op while the entry's signature count is the one its record was
    taken at, a capture (see the module docstring) when it grew. Every
    capture emits a ``perf/compiled`` instant, refreshes the
    ``perf_flops`` / ``perf_bytes_accessed`` / ``perf_peak_hbm_bytes``
    gauges (labeled by entry), and stamps the whole table into the
    tracer's process metadata so a saved trace carries its own cost
    model."""

    def __init__(self, registry=None, peaks: Optional[Dict] = None,
                 emit: bool = True):
        self._lock = threading.Lock()
        self._records: Dict[str, CostRecord] = {}
        self._registry = registry
        self._peaks = peaks  # resolved on first use
        # emit=False keeps the index to itself: no trace instants, no gauge
        # refresh, no tracer-metadata stamp
        self._emit = bool(emit)

    # -- platform ---------------------------------------------------- #

    @property
    def peaks(self) -> Dict[str, Any]:
        if self._peaks is None:
            self._peaks = platform_peaks()
        return self._peaks

    @staticmethod
    def _world() -> int:
        try:
            import torch.distributed as dist

            if dist.is_available() and dist.is_initialized():
                return dist.get_world_size()
        except Exception:  # pragma: no cover - defensive
            pass
        return 1

    # -- capture ----------------------------------------------------- #

    def capture(self, name: str, signatures, device=None, args=()):
        """Context manager around one call of entry ``name``, whose
        :class:`~.watchdog.SignatureCache` has already recorded the
        call's signature. Captures when the entry has no record at the
        current signature count (or its last capture failed); else does
        nothing. ``args`` (optional) are the call's arguments, whose
        tensors make ``argument_bytes``."""
        size = signatures._cache_size()
        with self._lock:
            rec = self._records.get(name)
        if rec is not None and rec.error is None and rec.cache_size == size:
            return _NULL
        return _Capture(self, name, size, device, args)

    def _store(self, rec: CostRecord) -> None:
        peaks = self.peaks
        rec.optimal_seconds = max(
            rec.flops / (peaks["peak_tflops"] * 1e12),
            rec.bytes_accessed / (peaks["peak_gbps"] * 1e9))
        if rec.error is not None:
            logger.warning("perf: cost capture for %r failed: %s", rec.name,
                           rec.error)
        with self._lock:
            prev = self._records.get(rec.name)
            rec.captures = (prev.captures if prev else 0) + 1
            self._records[rec.name] = rec
        if rec.error is None and self._emit:
            trace_instant("perf/compiled", lane="perf", **rec.as_args())
            self._export_gauges(rec)
        if self._emit:
            self._stamp_metadata()

    def _export_gauges(self, rec: CostRecord) -> None:
        if self._registry is None:
            return
        lab = {"entry": rec.name}
        self._registry.gauge(
            "perf_flops", "compiled cost model: flops per execution",
            labels=lab).set(rec.flops)
        self._registry.gauge(
            "perf_bytes_accessed", "compiled cost model: bytes accessed "
            "per execution", labels=lab).set(rec.bytes_accessed)
        self._registry.gauge(
            "perf_peak_hbm_bytes", "compiled executable memory footprint "
            "(args+outputs+temps-aliased)", labels=lab).set(rec.peak_bytes)

    def _stamp_metadata(self) -> None:
        t = get_tracer()
        if t is None or not hasattr(t, "set_metadata"):
            return
        t.set_metadata("perf", self.summary())

    # -- queries ------------------------------------------------------ #

    def get(self, name: str) -> Optional[CostRecord]:
        with self._lock:
            return self._records.get(name)

    def records(self) -> Dict[str, CostRecord]:
        with self._lock:
            return dict(self._records)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """JSON-ready table (what the trace metadata carries)."""
        with self._lock:
            recs = list(self._records.values())
        return {
            r.name: {
                "flops": r.flops,
                "recompute_flops": r.recompute_flops,
                "bytes_accessed": r.bytes_accessed,
                "peak_hbm_bytes": r.peak_bytes,
                "optimal_seconds": r.optimal_seconds,
                "captures": r.captures,
                **({"error": r.error} if r.error else {}),
            }
            for r in recs
        }

    # -- live MFU / roofline ------------------------------------------ #

    def step_stats(self, name: str, wall_s: float,
                   comm_factor: float = 3.0) -> Optional[Dict[str, Any]]:
        """Measured-step verdict for entry ``name`` over ``wall_s``.

        MFU = model flops / wall / peak_tflops. The roofline verdict
        compares the two floor estimates (flops/peak_flops vs
        bytes/peak_bw): the larger names the bound; a measured wall
        ``comm_factor``x past BOTH floors means the time went somewhere
        the roofline cannot see — collectives when the process is one
        rank of several ("comm-bound"), host/dispatch overhead on one
        ("host-bound")."""
        rec = self.get(name)
        if rec is None or rec.error is not None or wall_s <= 0:
            return None
        peaks = self.peaks  # one card: a process of the port drives one
        peak_flops = peaks["peak_tflops"] * 1e12
        peak_bw = peaks["peak_gbps"] * 1e9
        tflops = rec.flops / wall_s / 1e12
        mfu = rec.flops / wall_s / peak_flops if peak_flops else 0.0
        est_compute = rec.flops / peak_flops if peak_flops else 0.0
        est_memory = rec.bytes_accessed / peak_bw if peak_bw else 0.0
        floor = max(est_compute, est_memory)
        if floor > 0 and wall_s > comm_factor * floor:
            verdict = "comm-bound" if self._world() > 1 else "host-bound"
        elif est_compute >= est_memory:
            verdict = "compute-bound"
        else:
            verdict = "memory-bound"
        stats = {
            "entry": name,
            "wall_ms": wall_s * 1e3,
            "mfu": mfu,
            "tflops": tflops,
            "verdict": verdict,
            "est_compute_ms": est_compute * 1e3,
            "est_memory_ms": est_memory * 1e3,
        }
        if self._registry is not None:
            lab = {"entry": name}
            self._registry.gauge(
                "perf_mfu", "measured model-flops utilization per step",
                labels=lab).set(mfu)
            self._registry.gauge(
                "perf_step_tflops", "measured tflops per step",
                labels=lab).set(tflops)
        return stats

    def note_step(self, name: str, wall_s: float) -> Optional[Dict[str, Any]]:
        """step_stats + a ``perf/step`` trace instant (the live per-step
        MFU lane)."""
        stats = self.step_stats(name, wall_s)
        if stats is not None:
            trace_instant(
                "perf/step", lane="perf", entry=name,
                mfu=round(stats["mfu"], 6),
                wall_ms=round(stats["wall_ms"], 3),
                tflops=round(stats["tflops"], 4),
                verdict=stats["verdict"])
        return stats


class StepTimer:
    """The device time of one span for the MFU readout: CUDA events
    recorded on the current stream at start and stop (no kernel launch,
    no sync inside the span), read after the stop event completes; the
    host clock on the CPU."""

    def __init__(self, device):
        import time

        import torch

        self._cuda = torch.device(device).type == "cuda"
        if self._cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._stop = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()

    def seconds(self) -> float:
        """Stop and return the span's seconds (waits for the stop event)."""
        import time

        if not self._cuda:
            return time.perf_counter() - self._t0
        self._stop.record()
        self._stop.synchronize()
        return self._start.elapsed_time(self._stop) / 1e3
