"""Recompile watchdog: catch a hot entry point that meets a new signature
after warmup.

Counterpart of deeperspeed_tpu/monitor/watchdog.py. The reference counts
the jit-cache entries of each watched function: a jitted hot function
quietly retracing (a shape or dtype leaked into the trace) is the failure
it names. The port runs eagerly and has no jit cache. Its counterpart is
the number of distinct argument signatures (the shape, dtype and device
of every tensor, the type of every other leaf) that a watched entry point
has been called with, which is what a jit cache counts. In the eager port
a new signature means new kernel plans (the ``lru_cache`` plans of
ops/fused_blocks.py and the attention ops) and, at first use, a kernel
build (ops/op_builder.py); a training step that sees a new sequence
length every few steps is the same fault as a retracing jit.

An entry point owns a :class:`SignatureCache`; ``record(*args)`` adds its
call's signature and says whether it was new. The cache answers
``_cache_size()`` as a jitted function does, so ``watch(name, cache)`` /
``observe(name)`` keep the reference's contract: the first observation
that finds a non-empty cache marks the entry WARM and records the
baseline; growth past it afterwards fires.

Each CUDA kernel build is the port's backend compile: ops/op_builder.py
calls :func:`note_compile`, which bumps the process-global compile count
and emits the reference's ``xla_compile`` instant on the ``compile``
lane, the name the goodput and request ledgers key on.

Firing emits a trace instant (``recompile!``) plus a rank-0 warning; in
``strict`` mode it raises :class:`RecompileError` instead.
"""

import threading
import time
from typing import Callable, Dict, List, Optional

from ..utils.logging import logger
from .runctx import current as current_run
from .tracer import trace_instant

__all__ = ["RecompileError", "RecompileWatchdog", "SignatureCache",
           "global_compile_events", "note_compile", "signature"]

MODES = ("off", "warn", "strict")

# process-global compile-event counter fed by note_compile (kernel builds)
_compile_events = 0
_last_compile_t: Optional[float] = None  # perf_counter of the newest one
_compile_lock = threading.Lock()


def note_compile(seconds: float, source: str = "") -> None:
    """One backend compile (a CUDA kernel build) took ``seconds``."""
    global _compile_events, _last_compile_t
    with _compile_lock:
        _compile_events += 1
        _last_compile_t = time.perf_counter()
    trace_instant("xla_compile", lane="compile", seconds=round(seconds, 4),
                  **({"source": source} if source else {}))


def global_compile_events() -> int:
    """Backend compiles (kernel builds) observed process-wide."""
    return _compile_events


def signature(tree):
    """A hashable signature of an argument tree: (shape, dtype, device) of
    every tensor, the type name of every other leaf; dicts by sorted key,
    lists and tuples in order."""
    if isinstance(tree, dict):
        return ("d",) + tuple((k, signature(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return ("l",) + tuple(signature(v) for v in tree)
    shape = getattr(tree, "shape", None)
    if shape is not None and hasattr(tree, "dtype"):
        return (tuple(shape), str(tree.dtype), str(getattr(tree, "device",
                                                           "")))
    return type(tree).__name__


class SignatureCache:
    """The distinct call signatures an eager entry point has seen (its
    jit-cache counterpart; see the module docstring)."""

    def __init__(self):
        self._seen = set()

    def record(self, *args, **kwargs) -> bool:
        """Add this call's signature; True when it is new."""
        sig = signature((args, kwargs))
        if sig in self._seen:
            return False
        self._seen.add(sig)
        return True

    def _cache_size(self) -> int:
        return len(self._seen)


def _cache_size(fn) -> Optional[int]:
    get = getattr(fn, "_cache_size", None)
    if get is None:
        return None
    try:
        return int(get())
    except Exception:  # pragma: no cover - defensive
        return None


class RecompileError(RuntimeError):
    """Raised in strict mode when a watched entry point meets a new
    signature after warmup."""


class RecompileWatchdog:
    def __init__(self, mode: str = "warn"):
        if mode not in MODES:
            raise ValueError(f"watchdog mode must be one of {MODES}, "
                             f"got {mode!r}")
        self.mode = mode
        self._lock = threading.Lock()
        self._fns: Dict[str, Callable] = {}
        self._baseline: Dict[str, Optional[int]] = {}  # None until warm
        self.fired: List[dict] = []  # one record per detected recompile

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    # -------------------------------------------------------------- #

    def watch(self, name: str, fn) -> None:
        """Register an entry point's :class:`SignatureCache` (or anything
        with ``_cache_size()``) under ``name`` (idempotent; re-registering
        a new object resets its warmup)."""
        with self._lock:
            if self._fns.get(name) is fn:
                return
            self._fns[name] = fn
            self._baseline[name] = None

    def watched(self) -> List[str]:
        with self._lock:
            return list(self._fns)

    def counts(self) -> Dict[str, Optional[int]]:
        """Current signature count per watched entry point."""
        with self._lock:
            fns = dict(self._fns)
        return {name: _cache_size(fn) for name, fn in fns.items()}

    def mark_warm(self, name: Optional[str] = None) -> None:
        """Snapshot current counts as the post-warmup baseline."""
        with self._lock:
            names = [name] if name is not None else list(self._fns)
            for n in names:
                self._baseline[n] = _cache_size(self._fns[n])

    def observe(self, name: Optional[str] = None,
                step: Optional[int] = None) -> List[str]:
        """Compare watched entry points' signature counts against their
        warm baselines; returns the names that grew (after firing the
        configured reaction for each). ``step`` is the caller's step
        counter, carried into the warning/instant."""
        if not self.enabled:
            return []
        with self._lock:
            items = ([(name, self._fns[name])] if name is not None
                     else list(self._fns.items()))
        recompiled = []
        for n, fn in items:
            size = _cache_size(fn)
            if size is None:
                continue
            base = self._baseline.get(n)
            if base is None:
                if size > 0:  # first signature = warmup, not a violation
                    with self._lock:
                        self._baseline[n] = size
                continue
            if size > base:
                with self._lock:
                    self._baseline[n] = size  # report each growth once
                recompiled.append(n)
                self._fire(n, base, size, step=step)
        return recompiled

    # -------------------------------------------------------------- #

    def _fire(self, name: str, baseline: int, size: int,
              step: Optional[int] = None) -> None:
        rc = current_run()
        since = (time.perf_counter() - _last_compile_t
                 if _last_compile_t is not None else None)
        record = {"name": name, "baseline": baseline, "cache_size": size,
                  "step": step, "run_id": rc.run_id,
                  "since_last_compile_s": since}
        self.fired.append(record)
        args = {"fn": name, "cache_size": size,
                "run_id": rc.run_id or "", "role": rc.role,
                "incarnation": rc.incarnation}
        if step is not None:
            args["step"] = step
        if since is not None:
            args["since_last_compile_s"] = round(since, 3)
        trace_instant("recompile!", lane="compile", **args)
        ctx = f" [run {rc.run_id}]" if rc.run_id else ""
        if step is not None:
            ctx += f" at step {step}"
        if since is not None:
            ctx += f", {since:.1f}s since the last kernel build"
        msg = (f"recompile watchdog: {name!r} met a new argument signature "
               f"after warmup ({baseline} -> {size} signatures){ctx}; a "
               f"shape/dtype is varying from call to call")
        if self.mode == "strict":
            raise RecompileError(msg)
        if _rank() == 0:
            logger.warning(msg)


def _rank() -> int:
    """This process's rank in an initialized torch.distributed world, else
    0."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0
