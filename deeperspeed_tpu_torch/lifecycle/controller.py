"""Lifecycle controller: the train->serve control plane, assembled.

Counterpart of deeperspeed_tpu/lifecycle/controller.py. Three cooperating
pieces, each usable alone:

  * :class:`VersionPublisher`: trainer-side step-boundary hook. After
    each optimizer step it looks at the checkpoint directory's
    ``latest`` pointer; a tag it has never published that has reached
    COMMITTED becomes the next :class:`~.versions.WeightVersion`. Tags
    still staging (async writer in flight) are simply retried at the
    next boundary: the registry's two-phase-commit check is the gate,
    so a torn tag can never become a version. Under data parallelism
    only rank 0 publishes (one writer of ``VERSIONS.json``).
  * :class:`RolloutDriver`: serving-side watcher. Polls the registry
    (``VERSIONS.json`` is the only coupling between the two processes)
    and rolls the fleet onto each new live version via
    ``FleetRouter.rolling_update``: drain -> stage weights -> restart,
    one replica at a time, mixed-version routing in between.
  * :class:`LifecycleController`: binds a :class:`~.remesh.RemeshHook`
    and a publisher into one object the resilience manager polls
    (``attach_lifecycle``), plus the rollout driver when a router is
    given. This is what ``python -m deeperspeed_tpu_torch.lifecycle``
    drives.

The publisher and the driver never share memory: the trainer writes
``VERSIONS.json``, the serving host reads it, so the two halves survive
each other's restarts and run in separate processes.
"""

import threading
import time
from typing import Callable, Optional

from ..checkpoint.serialization import read_latest
from ..monitor import get_monitor, trace_instant
from ..utils.logging import log_dist, logger
from .config import LifecycleConfig
from .remesh import RemeshHook
from .versions import VersionRegistry, WeightVersion

__all__ = ["VersionPublisher", "RolloutDriver", "LifecycleController"]


class VersionPublisher:
    """Publishes freshly COMMITTED checkpoint tags as weight versions.

    A step-boundary hook (``poll(engine)``), polled by the resilience
    manager right after its interval autosave — so the tag a save just
    committed is visible the same boundary it lands.
    """

    def __init__(self, ckpt_dir: str,
                 cfg: Optional[LifecycleConfig] = None,
                 registry: Optional[VersionRegistry] = None):
        self.cfg = cfg or LifecycleConfig()
        self.registry = registry or VersionRegistry(
            ckpt_dir, keep_live=self.cfg.keep_live_versions)
        self.published = 0
        self._last_publish_step: Optional[int] = None
        # when set (by the operator or a drafter-distillation job),
        # every subsequent publish pairs this COMMITTED drafter tag
        # with the target tag — the record rolls out as one unit
        self.drafter_tag: Optional[str] = None

    def poll(self, engine=None) -> Optional[WeightVersion]:
        """Publish the ``latest`` tag if it is new and committed.
        Returns the fresh record, or None when there is nothing to do
        (no new tag, tag still staging, or inside the publish
        interval)."""
        if not self.cfg.publish:
            return None
        if engine is not None and getattr(
                getattr(engine, "mesh", None), "rank", 0) != 0:
            return None  # rank 0 is the registry's one writer
        tag = read_latest(self.registry.ckpt_dir)
        if not tag:
            return None
        if tag in {v.tag for v in self.registry.list()}:
            return None  # seen before (live OR retired): never re-mint
        step = (int(getattr(engine, "global_steps", 0))
                if engine is not None else None)
        if (step is not None
                and self.cfg.publish_interval_steps > 0
                and self._last_publish_step is not None
                and step - self._last_publish_step
                < self.cfg.publish_interval_steps):
            return None
        try:
            rec = self.registry.publish(tag, drafter=self.drafter_tag)
        except ValueError:
            # async writer still staging this tag, or it is torn; the
            # next boundary re-checks — commit is the publish gate
            return None
        self.published += 1
        self._last_publish_step = step
        trace_instant("lifecycle/publish", lane="lifecycle",
                      version=rec.version, tag=rec.tag, step=rec.step,
                      drafter=rec.drafter)
        mon = get_monitor()
        if mon is not None:
            mon.registry.counter(
                "lifecycle_publish_total",
                "checkpoint tags published as weight versions").inc()
            mon.registry.gauge(
                "lifecycle_latest_version",
                "newest published weight version").set(float(rec.version))
        log_dist(f"lifecycle: published weight version v{rec.version} "
                 f"(tag {rec.tag})", ranks=[0])
        return rec


class RolloutDriver:
    """Rolls a serving fleet onto new weight versions as they appear.

    ``weights_for(record)`` maps a version record to the payload handed
    to each replica's ``set_weights``; the default points subprocess
    workers at the published tag (``{"load_dir", "tag"}``).
    """

    def __init__(self, router, registry: VersionRegistry,
                 cfg: Optional[LifecycleConfig] = None,
                 weights_for: Optional[
                     Callable[[WeightVersion], Optional[dict]]] = None):
        self.router = router
        self.registry = registry
        self.cfg = cfg or LifecycleConfig()
        self._weights_for = weights_for or self._checkpoint_pointer
        self.applied: Optional[int] = None
        self.rollouts = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _checkpoint_pointer(self, rec: WeightVersion) -> dict:
        ptr = {"load_dir": self.registry.ckpt_dir, "tag": rec.tag}
        if rec.drafter is not None:
            # (target, drafter) pair: the worker loads both sides from
            # the same checkpoint dir, so a version's acceptance rate
            # is comparable across every replica serving it
            ptr["drafter_tag"] = rec.drafter
        return ptr

    def poll_once(self) -> Optional[WeightVersion]:
        """One registry check; rolls the fleet when a newer live
        version exists. Returns the version rolled onto, else None."""
        rec = self.registry.latest()
        if rec is None or rec.version == self.applied:
            return None
        log_dist(f"lifecycle: rolling fleet onto v{rec.version} "
                 f"(tag {rec.tag})", ranks=[0])
        self.router.rolling_update(
            rec.version, weights=self._weights_for(rec),
            timeout_s=self.cfg.drain_timeout_s)
        self.applied = rec.version
        self.rollouts += 1
        return rec

    # -- background watcher ------------------------------------------

    def start(self) -> "RolloutDriver":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="lifecycle-rollout", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 - keep watching
                logger.error("lifecycle: rollout failed (%s); will "
                             "retry on the next version", e)
            self._stop.wait(self.cfg.rollout_poll_interval_s)


class LifecycleController:
    """One object owning both halves of the control plane.

    Trainer side (on every rank): ``attach(engine)`` installs the re-mesh
    signal handler and registers this controller as a resilience step-boundary
    hook, so every optimizer step runs publish-then-remesh (publish
    first: the tag that predates a topology flip is still published
    under the old mesh, which keeps the serve side decoupled from the
    flip). Serving side: pass a router and call ``start_serving()``.
    """

    def __init__(self, ckpt_dir: str,
                 cfg: Optional[LifecycleConfig] = None,
                 router=None,
                 weights_for: Optional[
                     Callable[[WeightVersion], Optional[dict]]] = None):
        self.cfg = cfg or LifecycleConfig()
        self.registry = VersionRegistry(
            ckpt_dir, keep_live=self.cfg.keep_live_versions)
        self.remesh = RemeshHook(self.cfg)
        self.publisher = VersionPublisher(
            ckpt_dir, self.cfg, registry=self.registry)
        self.rollout = (RolloutDriver(router, self.registry, self.cfg,
                                      weights_for=weights_for)
                        if router is not None else None)

    # -- trainer side ------------------------------------------------

    def attach(self, engine) -> "LifecycleController":
        """Wire into a training engine: signal handler + step-boundary
        polling via the engine's resilience manager (or call
        ``poll(engine)`` manually from a bare loop)."""
        if self.cfg.remesh_enabled:
            self.remesh.install()
        mgr = getattr(engine, "_resilience", None)
        if mgr is not None and hasattr(mgr, "attach_lifecycle"):
            mgr.attach_lifecycle(self)
        else:
            logger.warning(
                "lifecycle: engine has no resilience manager; call "
                "controller.poll(engine) from the training loop")
        return self

    def poll(self, engine) -> None:
        """The step-boundary hook: publish, then apply any pending
        re-mesh."""
        self.publisher.poll(engine)
        self.remesh.poll(engine)

    # -- serving side ------------------------------------------------

    def start_serving(self) -> "LifecycleController":
        if self.rollout is None:
            raise RuntimeError(
                "no router was given to LifecycleController; rollouts "
                "need one")
        self.rollout.start()
        return self

    def wait_for_version(self, version: int,
                         timeout_s: float = 120.0) -> bool:
        """Block until the rollout driver has applied ``version`` (the
        drill's synchronization point between a publish and its serve-
        side effect)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if (self.rollout is not None
                    and self.rollout.applied is not None
                    and self.rollout.applied >= version):
                return True
            time.sleep(0.05)
        return False

    def close(self) -> None:
        if self.rollout is not None:
            self.rollout.stop()
        self.remesh.uninstall()
