"""Device-memory watermark lane + near-OOM post-mortem.

Counterpart of deeperspeed_tpu/monitor/memwatch.py, on the CUDA caching
allocator's ledger (``torch.cuda.memory_stats``) in place of a TPU
device's ``memory_stats()``:

  * :func:`device_memory_stats` / :func:`aggregate_memory_stats` are the
    one normalized reader, with the reference's keys: ``bytes_in_use`` is
    ``allocated_bytes.all.current``, ``peak_bytes_in_use``
    ``allocated_bytes.all.peak``, ``bytes_limit`` the device's total
    memory, ``largest_free_block_bytes`` the largest inactive split the
    allocator holds and ``num_allocs`` ``allocation.all.allocated``.
    A CPU tensor's device (or a process without CUDA) reads ``{}``;
  * :class:`MemWatch` samples the ledger at phase boundaries — one
    ``mem/watermark`` instant plus gauges per sample, and a
    ``span.note(hbm_in_use=…, hbm_peak=…)`` helper so the train-batch /
    prefill / decode spans carry their watermark;
  * when ``bytes_in_use`` crosses ``near_oom_fraction`` of
    ``bytes_limit`` it fires a post-mortem: the top-K live CUDA tensors
    (shape / dtype / nbytes / device, found by walking the objects the
    garbage collector tracks) emitted as compact instants that ride the
    tracer's inline flight sink — so a process the allocator kills
    moments later still leaves an explanation in ``flight.bin``.

Reading the ledger is a host call (no kernel launch, no sync). On the CPU
stats are ``{}`` and watermarks zeros, so span args and trace schema stay
identical across devices.
"""

import gc
import threading
from typing import Any, Dict, List, Optional

from ..utils.logging import logger
from .tracer import trace_instant

__all__ = [
    "MemWatch",
    "aggregate_memory_stats",
    "device_memory_stats",
]

def _cuda_ready() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


def device_memory_stats(device=None) -> Dict[str, int]:
    """The CUDA allocator's ledger for ``device`` (default: the current
    CUDA device), normalized to the reference's int keys; ``{}`` for a
    CPU device, or when CUDA is absent or not yet initialized."""
    import torch

    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return {}
    if not _cuda_ready():
        return {}
    try:
        raw = torch.cuda.memory_stats(device)
        total = torch.cuda.get_device_properties(
            device if device is not None
            else torch.cuda.current_device()).total_memory
    except Exception:  # pragma: no cover - defensive
        return {}
    if not raw:
        return {}
    return {
        "bytes_in_use": int(raw.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(raw.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
        "largest_free_block_bytes": int(
            raw.get("inactive_split_bytes.all.current", 0)),
        "num_allocs": int(raw.get("allocation.all.allocated", 0)),
    }


def aggregate_memory_stats() -> Dict[str, int]:
    """Ledger summed across the process's CUDA devices; ``{}`` when none
    reads (so callers can distinguish "no ledger" from "zero bytes")."""
    import torch

    if not _cuda_ready():
        return {}
    total: Dict[str, int] = {}
    backed = False
    for i in range(torch.cuda.device_count()):
        s = device_memory_stats(torch.device("cuda", i))
        if not s:
            continue
        backed = True
        for k, v in s.items():
            if k == "largest_free_block_bytes":
                total[k] = max(total.get(k, 0), v)
            else:
                total[k] = total.get(k, 0) + v
    return total if backed else {}


class MemWatch:
    """Watermark sampler + near-OOM post-mortem (see module docstring).

    ``sample(phase)`` is the phase-boundary hook: one ``mem/watermark``
    instant (zeros on CPU — the lane exists on every device) plus the
    ``mem_bytes_in_use`` / ``mem_peak_bytes`` gauges, and the near-OOM
    trip check. ``annotate(span, phase)`` additionally stamps the
    enclosing span with ``hbm_in_use`` / ``hbm_peak`` args."""

    def __init__(self, registry=None, near_oom_fraction: float = 0.92,
                 top_k: int = 8):
        if not (0.0 < near_oom_fraction <= 1.0):
            raise ValueError(
                f"near_oom_fraction must be in (0, 1], got {near_oom_fraction}")
        self._registry = registry
        self.near_oom_fraction = near_oom_fraction
        self.top_k = top_k
        self._lock = threading.Lock()
        self._armed = True         # re-arms when usage falls back under
        self.postmortems = 0       # how many times the dump fired

    # -- sampling ----------------------------------------------------- #

    def sample(self, phase: str) -> Dict[str, int]:
        stats = aggregate_memory_stats()
        in_use = stats.get("bytes_in_use", 0)
        peak = stats.get("peak_bytes_in_use", 0)
        limit = stats.get("bytes_limit", 0)
        trace_instant("mem/watermark", lane="mem", phase=phase,
                      bytes_in_use=in_use, peak_bytes=peak,
                      **({"bytes_limit": limit} if limit else {}))
        if self._registry is not None:
            self._registry.gauge(
                "mem_bytes_in_use",
                "device allocator: live bytes across local devices",
            ).set(float(in_use))
            self._registry.gauge(
                "mem_peak_bytes",
                "device allocator: peak live bytes across local devices",
            ).set(float(peak))
        if limit > 0:
            frac = in_use / limit
            with self._lock:
                fire = self._armed and frac >= self.near_oom_fraction
                if fire:
                    self._armed = False
                elif frac < 0.75 * self.near_oom_fraction:
                    self._armed = True
            if fire:
                self.post_mortem(
                    reason=f"near-oom at {phase}: "
                           f"{frac:.1%} of bytes_limit", stats=stats)
        return stats

    def annotate(self, span, phase: str) -> Dict[str, int]:
        """sample() + watermark args on the enclosing span (works on the
        null span too — note() is a no-op there)."""
        stats = self.sample(phase)
        span.note(hbm_in_use=stats.get("bytes_in_use", 0),
                  hbm_peak=stats.get("peak_bytes_in_use", 0))
        return stats

    # -- post-mortem --------------------------------------------------- #

    def live_buffers(self, top_k: Optional[int] = None) -> List[Dict[str, Any]]:
        """Top-K live CUDA tensors by size: shape / dtype / nbytes /
        device (in the reference's ``sharding`` field). Tensors that share
        one storage are counted once, by their storage's bytes. Pure
        inspection — safe to call anywhere."""
        import torch

        rows: List[Dict[str, Any]] = []
        seen = set()
        for obj in gc.get_objects():
            try:
                # type(), not isinstance: a proxy's __class__ may warn
                if not issubclass(type(obj), torch.Tensor) or not obj.is_cuda:
                    continue
                storage = obj.untyped_storage()
                key = storage.data_ptr()
                if key in seen:
                    continue
                seen.add(key)
                rows.append({
                    "shape": "x".join(str(s) for s in obj.shape) or "scalar",
                    "dtype": str(obj.dtype).replace("torch.", ""),
                    "nbytes": int(storage.nbytes()),
                    "sharding": str(obj.device),
                })
            except Exception:  # freed or exotic mid-iteration
                continue
        rows.sort(key=lambda r: r["nbytes"], reverse=True)
        return rows[: top_k if top_k is not None else self.top_k]

    def post_mortem(self, reason: str,
                    stats: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
        """Dump the allocation picture into the trace. Each buffer is its
        own compact ``mem/buffer`` instant (small enough for one flight
        slot each — a 512 B slot cannot hold the whole table), headed by
        one ``mem/postmortem`` summary; the tracer's inline flight sink
        makes the dump SIGKILL-proof. Returns the payload for callers
        (tests, an OOM handler) that want it in hand."""
        if stats is None:
            stats = aggregate_memory_stats()
        buffers = self.live_buffers()
        payload = {
            "reason": reason,
            "bytes_in_use": stats.get("bytes_in_use", 0),
            "bytes_limit": stats.get("bytes_limit", 0),
            "live_buffers": len(buffers),
            "buffers": buffers,
        }
        trace_instant("mem/postmortem", lane="mem", reason=reason,
                      bytes_in_use=payload["bytes_in_use"],
                      bytes_limit=payload["bytes_limit"],
                      buffers=len(buffers))
        for rank, b in enumerate(buffers):
            trace_instant("mem/buffer", lane="mem", rank=rank,
                          shape=b["shape"], dtype=b["dtype"],
                          nbytes=b["nbytes"], sharding=b["sharding"])
        with self._lock:
            self.postmortems += 1
        logger.warning("memwatch: post-mortem (%s): %d live buffers, "
                       "%.2f GB in use", reason, len(buffers),
                       payload["bytes_in_use"] / 2**30)
        return payload
