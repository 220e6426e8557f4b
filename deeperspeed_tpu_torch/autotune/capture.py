"""Pricing a candidate's step without running it on the card.

Counterpart of deeperspeed_tpu/autotune/capture.py. The reference lowers
and compiles the jitted train step ahead of time and reads XLA's cost; it
never executes the step and never grows the jit's dispatch cache, which
is what makes tuning inside a live process safe. The port runs eagerly
(monitor/perf.py), so there is nothing to lower: :func:`aot_capture`
instead runs one rank's step on the ``meta`` device, where tensors have
shapes and no data, under the cost index's counting dispatch mode
(:meth:`~..monitor.perf.CompiledCostIndex.plan`). The candidate engine is
built there (``device="meta"``) over a ``sharding.mesh.PlanningMesh``,
whose collectives move nothing (the wire model prices them, as in the
reference), and ``ops.kernel_config.planning`` says which card the meta
tensors stand for, so the kernel routes and the kernels' declared work
are those of that card. Peak bytes come from the live tensors the dispatch
mode tracks: no allocator reads meta.

:func:`sandboxed_cost_index` is a ``CompiledCostIndex(registry=None,
emit=False)``: the same counting, no gauges, no trace instants, no tracer
metadata. One per search; throw it away.

The no-pollution contract, checked around every capture, raises as the
reference does when broken:

  * the candidate's own signature cache (``fn._cache_size()``, the
    counterpart of the reference's jit cache) and every
    :class:`~..monitor.watchdog.SignatureCache` the installed monitor's
    watchdog watches keep their sizes;
  * every kernel wrapper's launch counter keeps its count;
  * on the card, ``torch.cuda.memory_allocated()`` is unchanged;
  * no op of the capture touched a CUDA tensor.
"""

from typing import Callable, Dict, Optional, Tuple

from ..monitor.perf import RAN_ON_THE_CARD, CompiledCostIndex, CostRecord
from ..monitor.watchdog import _cache_size

__all__ = ["aot_capture", "kernel_launches", "sandboxed_cost_index"]


def sandboxed_cost_index(peaks: Optional[dict] = None) -> CompiledCostIndex:
    """A CompiledCostIndex that cannot touch the live process: no metrics
    registry (no gauges), ``emit=False`` (no trace instants, no
    tracer-metadata stamping)."""
    return CompiledCostIndex(registry=None, peaks=peaks, emit=False)


def kernel_launches() -> Dict[str, int]:
    """Every kernel wrapper's launch counter, by wrapper name."""
    from ..ops import (fused_adam, fused_blocks, fused_quant, flash_attention,
                       flash_static)
    from ..ops.sparse_attention import block_sparse

    fns = (fused_blocks.ln_fwd, fused_blocks.ln_bwd, fused_blocks.add_ln_fwd,
           fused_blocks.add_ln_bwd, fused_blocks.bias_gelu_fwd,
           fused_blocks.bias_gelu_bwd, flash_attention.flash_fwd,
           flash_attention.flash_bwd, flash_static.supertile_fwd,
           flash_static.supertile_bwd, fused_adam.fused_adam,
           fused_quant.quantize_rows, fused_quant.dequant_sum_rows,
           fused_quant.dequant_rows, block_sparse.sparse_fwd,
           block_sparse.sparse_bwd)
    return {fn.__name__: fn.launches for fn in fns}


def _watched_sizes() -> Dict[str, Optional[int]]:
    """The signature-cache sizes of the installed monitor's watchdog."""
    from ..monitor import get_monitor

    mon = get_monitor()
    wd = getattr(mon, "watchdog", None)
    if wd is None:
        return {}
    with wd._lock:
        fns = dict(wd._fns)
    return {name: _cache_size(fn) for name, fn in fns.items()}


def _card_bytes() -> Tuple[int, ...]:
    import torch

    if not torch.cuda.is_available():
        return ()
    return tuple(torch.cuda.memory_allocated(i)
                 for i in range(torch.cuda.device_count()))


def aot_capture(
    name: str,
    fn: Callable,
    args: Tuple = (),
    kwargs: Optional[dict] = None,
    *,
    index: Optional[CompiledCostIndex] = None,
) -> CostRecord:
    """Capture ``fn(*args, **kwargs)``'s cost without running it on the
    card: ``fn`` runs on meta tensors (``args``/``kwargs`` are its
    resident inputs, whose bytes make ``argument_bytes``). Checks the
    no-pollution contract (module docstring) and raises if it broke,
    rather than return a tainted record."""
    idx = index if index is not None else sandboxed_cost_index()
    before = (_cache_size(fn), _watched_sizes(), kernel_launches(),
              _card_bytes())
    rec = idx.plan(name, fn, args, kwargs)
    after = (_cache_size(fn), _watched_sizes(), kernel_launches(),
             _card_bytes())
    what = ("the candidate's signature cache", "the watchdog's signature "
            "caches", "the kernel launch counters", "the card's allocated "
            "bytes")
    for label, b, a in zip(what, before, after):
        if a != b:
            raise RuntimeError(
                f"aot_capture({name!r}) changed {label} ({b} -> {a}): the "
                f"capture ran the candidate instead of planning it; inside "
                f"a training process that would fire the watchdog or "
                f"spend the card")
    if rec is not None and RAN_ON_THE_CARD in (rec.error or ""):
        raise RuntimeError(f"aot_capture({name!r}): {rec.error}")
    return rec
