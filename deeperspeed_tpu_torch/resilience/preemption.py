"""Preemption guard: turn SIGTERM/SIGINT into an orderly exit.

Counterpart of deeperspeed_tpu/resilience/preemption.py, whole.

Spot and preemptible pools preempt with a signal and a short grace window. The guard's
handler does NOTHING dangerous in signal context — it sets a flag and
returns. The training loop notices the flag at the next step boundary
(``ResilienceManager.on_step_boundary``), takes an urgent checkpoint,
drains any live serving engines, and exits with a sentinel code the
auto-resume supervisor recognizes as "preempted: restart without
backoff, don't count it as a crash".

A second SIGINT while a preemption is already pending raises
``KeyboardInterrupt`` immediately — ctrl-C twice still means "now".
"""

import signal
import threading
from typing import Callable, Dict, Optional, Sequence

from ..monitor.tracer import trace_instant
from ..utils.logging import logger


class PreemptionGuard:
    def __init__(self, signals: Sequence[str] = ("SIGTERM", "SIGINT"),
                 on_request: Optional[Callable[[int], None]] = None):
        self._signal_names = tuple(signals)
        self._on_request = on_request
        self._requested = threading.Event()
        self._signum: Optional[int] = None
        self._prev: Dict[int, object] = {}
        self._installed = False

    # ---- lifecycle -------------------------------------------------- #

    def install(self) -> bool:
        """Install the handlers; returns False (with a warning) when not
        on the main thread, where CPython forbids signal.signal."""
        if self._installed:
            return True
        if threading.current_thread() is not threading.main_thread():
            logger.warning(
                "preemption guard not installed: signal handlers require "
                "the main thread")
            return False
        for name in self._signal_names:
            sig = getattr(signal, name)
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError) as e:  # pragma: no cover
                logger.warning("could not install handler for %s: %s",
                               name, e)
        self._installed = bool(self._prev)
        return self._installed

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # pragma: no cover
                pass
        self._prev.clear()
        self._installed = False

    # ---- signal context --------------------------------------------- #

    def _handler(self, signum, frame) -> None:
        if self._requested.is_set() and signum == signal.SIGINT:
            # second ctrl-C: the user means it
            raise KeyboardInterrupt
        self._signum = signum
        self._requested.set()
        # signal-safe work only: flag + (reentrant-safe) log; the trace
        # instant is a dict append under a non-reentrant path only if a
        # drop-note fires, which the guard tolerates (tracing is advisory)
        trace_instant("run/preempt", lane="run", signum=int(signum))
        logger.warning(
            "received %s: urgent checkpoint at the next step boundary, "
            "then exit (signal again with SIGINT to abort immediately)",
            signal.Signals(signum).name)
        if self._on_request is not None:
            self._on_request(signum)

    # ---- training-loop surface -------------------------------------- #

    @property
    def requested(self) -> bool:
        return self._requested.is_set()

    @property
    def signum(self) -> Optional[int]:
        return self._signum

    def request(self, signum: int = signal.SIGTERM) -> None:
        """Programmatic preemption (tests / external schedulers)."""
        self._signum = int(signum)
        self._requested.set()
        trace_instant("run/preempt", lane="run", signum=int(signum))

    def clear(self) -> None:
        self._requested.clear()
        self._signum = None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._requested.wait(timeout)
