"""Live re-mesh hook: pool-change signal -> a coordinated topology flip.

Counterpart of deeperspeed_tpu/lifecycle/remesh.py. The kill-free half of
elasticity: the supervisor (or an operator) sends ``SIGUSR1`` to the
RUNNING trainer; the handler only latches a flag (signal context does no
work); at the next optimizer-step boundary :meth:`RemeshHook.poll`
re-reads the pool file, picks the largest admissible elastic world size
that fits, and calls :meth:`Engine.remesh`: no checkpoint round trip, no
re-exec of the survivors.

Where the reference flips the devices of ONE process, a process of the
port is one rank, so a shrink is a step of every process together:

  * every boundary, each rank contributes (its latched-and-settled flag,
    the pool it read) to one small all-gather over the data-parallel
    group, so all ranks see the same answer at the same boundary even
    when the signal reached only one of them (the supervisor signals its
    own child) or reached them a step apart;
  * when any rank is ready, all of them take the smallest pool a ready
    rank read and choose the same world ``w``; ranks ``>= w`` retire
    with exit code 0 from inside ``Engine.remesh`` and the survivors
    form a new group (see ``Engine.remesh``).

A world of one rank runs no collective: its hook is the reference's.

Wiring: the resilience manager calls ``poll`` from its step-boundary hook
when a hook is attached (``attach_lifecycle``), so any engine with a
``resilience`` block gets live re-mesh by adding a ``lifecycle`` block; a
bare training loop can call ``hook.poll(engine)`` itself (on every rank,
at every boundary).

A pool *grow* beyond the processes alive cannot happen live (a process
group's size is fixed when it forms): ``choose_world`` caps at the
current world. Growth past that cap means adding *processes*, which is
the fleet supervisor's coordinated-restart path
(:class:`...distributed.fleet.FleetSupervisor` watching a pool file that
holds the PROCESS count): every host relaunches together at the new
process count and ``resilience/reshard.py`` carries residual state across
the world-size change. :func:`cross_host_growth_needed` is the predicate
both sides share.
"""

import os
import signal
import time
from typing import Optional

from ..resilience.supervisor import POOL_FILE_ENV
from ..utils.logging import logger
from .config import LifecycleConfig

__all__ = ["RemeshHook", "cross_host_growth_needed"]


def cross_host_growth_needed(pool: Optional[int],
                             device_cap: int) -> bool:
    """True when a pool target exceeds what the running processes can
    re-mesh to live: the point where elasticity must switch from the live
    flip to the fleet supervisor's coordinated process-count restart."""
    return pool is not None and int(pool) > int(device_cap)


class RemeshHook:
    """Latches the re-mesh signal and applies it at step boundaries."""

    def __init__(self, cfg: Optional[LifecycleConfig] = None,
                 pool_file: Optional[str] = None):
        self.cfg = cfg or LifecycleConfig()
        self.pool_file = (pool_file or self.cfg.pool_file
                          or os.environ.get(POOL_FILE_ENV))
        self._pending = 0
        self._signal_ts = 0.0
        self._prev_handler = None
        self._installed = False
        self.remeshes = 0        # applied flips
        self.last_world: Optional[int] = None

    # -------------------------------------------------------------- #
    # signal side (async-signal-safe: only sets flags)

    def install(self) -> "RemeshHook":
        """Register the signal handler (main thread only, per signal
        module rules). Idempotent."""
        if self._installed:
            return self
        try:
            self._prev_handler = signal.signal(
                self.cfg.signal_number(), self._on_signal)
        except ValueError:
            # not the main thread: signals can't be claimed here, but
            # request() / poll() still work for in-process controllers
            logger.warning(
                "lifecycle: cannot install the re-mesh signal handler "
                "off the main thread; use hook.request() instead")
            return self
        self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            signal.signal(self.cfg.signal_number(),
                          self._prev_handler or signal.SIG_DFL)
            self._installed = False

    def _on_signal(self, signum, frame) -> None:
        self._pending += 1
        self._signal_ts = time.time()

    def request(self) -> None:
        """Programmatic trigger (tests / same-process controllers)."""
        self._on_signal(None, None)

    @property
    def pending(self) -> bool:
        return self._pending > 0

    # -------------------------------------------------------------- #
    # step-boundary side

    def read_pool(self) -> Optional[int]:
        """The surviving pool's device count, or None when unreadable."""
        if not self.pool_file:
            return None
        try:
            with open(self.pool_file) as f:
                return int(f.read().strip())
        except (OSError, ValueError) as e:
            logger.warning("lifecycle: unreadable pool file %s (%s)",
                           self.pool_file, e)
            return None

    def choose_world(self, engine, pool: Optional[int] = None,
                     read: bool = True) -> Optional[int]:
        """Largest admissible elastic world size fitting the pool AND the
        processes alive (``engine.data_parallel_size``: one rank a
        process). ``pool`` is the pool to fit, read from the pool file
        unless given (``read=False`` takes ``pool`` as it is, None
        included)."""
        sizes = list(getattr(engine._config,
                             "elastic_valid_world_sizes", None) or [])
        if not sizes:
            logger.warning(
                "lifecycle: re-mesh signal with no elasticity block — "
                "no admissible world sizes, staying at %d",
                engine.data_parallel_size)
            return None
        cap = int(engine.data_parallel_size)
        if pool is None and read:
            pool = self.read_pool()
        if cross_host_growth_needed(pool, cap):
            logger.info(
                "lifecycle: pool target %s exceeds the %d process(es) "
                "alive — growth past the cap needs new PROCESSES "
                "(distributed.fleet coordinated restart); re-meshing "
                "to the live cap", pool, cap)
        if pool is not None:
            cap = min(cap, pool)
        admissible = [s for s in sizes if s <= cap]
        if not admissible:
            logger.error(
                "lifecycle: no elastic world size fits the pool of %s "
                "(valid: %s); keeping the current topology", pool, sizes)
            return None
        return max(admissible)

    def _settled(self) -> bool:
        """A latched signal whose pool writes have been quiet for the
        debounce window."""
        if not self._pending:
            return False
        return not (self.cfg.remesh_debounce_s > 0.0
                    and time.time() - self._signal_ts
                    < self.cfg.remesh_debounce_s)

    def poll(self, engine) -> bool:
        """Called at an optimizer-step boundary, on every rank. Applies at
        most one re-mesh; True when the topology changed (a retiring rank
        does not return: it exits inside ``engine.remesh``). Signal bursts
        within ``remesh_debounce_s`` coalesce: the flip waits for a
        boundary where the pool file has been quiet."""
        if not self.cfg.remesh_enabled:
            return False
        ready = self._settled()
        pool = self.read_pool() if ready else None
        if engine.data_parallel_size > 1:
            # one agreement a boundary: every rank takes the same decision
            ready, pool = engine.agree_remesh(ready, pool)
        if not ready:
            return False
        self._pending = 0
        world = self.choose_world(engine, pool, read=False)
        if world is None or world == engine.data_parallel_size:
            if world is not None:
                logger.info(
                    "lifecycle: pool change resolves to the current "
                    "world size (%d); nothing to do", world)
            return False
        engine.remesh(world)
        self.remeshes += 1
        self.last_world = world
        monitor = getattr(engine, "monitor", None)
        if monitor is not None:
            monitor.registry.counter(
                "lifecycle_remesh_total",
                "live re-mesh flips applied").inc()
            monitor.registry.gauge(
                "lifecycle_world_size",
                "data-parallel world size after the last re-mesh",
            ).set(float(world))
        return True
