"""ResilienceManager: the engine-facing composition of the subsystem.

Counterpart of deeperspeed_tpu/resilience/manager.py. One manager per
process (installed by ``init_resilience``, adopted by engines at init the
way the monitor is) binds the pieces together:

  * routes ``engine.save_checkpoint`` through the two-phase-commit
    writer: async (a device-to-host snapshot into pinned host buffers at
    the step boundary, serialize+fsync+commit on the writer thread) or
    sync, but ALWAYS atomic: a partial tag is never visible to a loader.
  * runs the step-boundary hook: fault injection, the preemption protocol
    (urgent checkpoint -> serving drain -> sentinel exit), interval
    autosaves.
  * records telemetry into the monitor registry when one is installed:
    ``resilience_saves_total`` / ``resilience_resume_total`` /
    ``resilience_preemption_total`` / ``resilience_fallback_total`` /
    ``resilience_corrupt_tags`` / ``resilience_restarts`` counters, the
    step-blocked-time gauge and the save-duration histogram, plus
    ``resilience/*`` trace spans and instants.

The manager does NOT own load-time validation: that lives in
``manifest.py`` and is wired into ``Engine.load_checkpoint``, so even runs
without a resilience block never load a torn checkpoint.

Not ported: the lifecycle hooks (``attach_lifecycle``'s consumers and
``lifecycle.versions.live_tags``) come with ``lifecycle/`` (ROADMAP.md
queue 1, item 9c). ``_prune`` treats the set of live tags as empty until
then; no lifecycle hook can be attached in this package yet, so no
result changes.
"""

import os
import shutil
import time
from typing import Optional

import torch

from ..monitor import get_monitor, trace_instant, trace_span
from ..utils.logging import log_dist, logger
from .config import ResilienceConfig
from .faults import FaultInjector, plan_from_config_and_env
from .manifest import (
    COMMITTED_MARKER,
    commit_checkpoint,
    find_latest_valid_tag,
    is_committed,
    list_tags,
    staging_dir_for,
    tag_step,
    write_manifest,
)
from .preemption import PreemptionGuard
from .writer import AsyncCheckpointWriter


def snapshot_to_host(tree):
    """A copy of ``tree`` whose tensors live in host memory (pinned when
    they come from the card): every device tensor is copied without
    blocking on the current stream, then one synchronize waits for all of
    them. Host tensors are cloned, so the training loop may write its
    own tensors in place while the writer thread serializes the copy.
    Dicts, lists, tuples and named tuples are rebuilt; other leaves pass
    through."""
    synced = []

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(walk(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, torch.Tensor):
            t = x.detach()
            if t.device.type == "cpu":
                return t.clone()
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            synced.append(t.device)
            return host
        return x

    out = walk(tree)
    for dev in set(synced):
        torch.cuda.synchronize(dev)
    return out


class ResilienceManager:
    def __init__(self, config: ResilienceConfig):
        self.cfg = config
        self.faults = FaultInjector(plan_from_config_and_env(config.faults))
        self.writer: Optional[AsyncCheckpointWriter] = (
            AsyncCheckpointWriter(max_pending=config.max_pending_saves)
            if config.async_save else None)
        self.guard: Optional[PreemptionGuard] = None
        if config.preemption_guard:
            self.guard = PreemptionGuard(signals=config.preemption_signals)
            self.guard.install()
        self.serving = []  # live serving engines to drain on preemption
        self.lifecycle = []  # step-boundary hooks (re-mesh, publish)
        self._save_dir = config.save_dir
        self._warned_multiprocess = False
        self._warned_no_save_dir = False
        self._closed = False
        self._resumed_tag: Optional[str] = None  # protected from pruning
        self._restart_noted = False

    # ------------------------------------------------------------------ #
    # telemetry helpers
    # ------------------------------------------------------------------ #

    def _registry(self):
        mon = get_monitor()
        return mon.registry if mon is not None else None

    def _inc(self, name: str, help_: str, labels=None) -> None:
        reg = self._registry()
        if reg is not None:
            reg.counter(name, help_, labels=labels).inc()

    # ------------------------------------------------------------------ #
    # save path
    # ------------------------------------------------------------------ #

    def note_save_dir(self, save_dir: str) -> None:
        """Adopt the save dir of an explicit save so urgent/interval
        saves have a target even without ``resilience.save_dir``."""
        if self.cfg.save_dir is None:
            self._save_dir = save_dir

    @property
    def save_dir(self) -> Optional[str]:
        return self._save_dir

    def handles_save(self) -> bool:
        """Resilience saves are single-process (the async writer and the
        commit rename assume one writer per directory); multi-process
        runs keep the engine's own save path and get a one-time
        warning."""
        if not self.cfg.enabled:
            return False
        dist = torch.distributed
        if (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            if not self._warned_multiprocess:
                self._warned_multiprocess = True
                logger.warning(
                    "resilience checkpointing is single-process only; "
                    "multi-process runs fall back to the legacy save path "
                    "(no async, no two-phase commit)")
            return False
        return True

    def save_checkpoint(self, engine, save_dir, tag, client_state,
                        save_latest=True) -> bool:
        """The resilience save: blocking device->host snapshot, then a
        two-phase-commit write, handed to the writer thread when async is
        on. Returns once the save is durably ACCEPTED (committed for sync;
        queued for async, where ``wait_for_pending_saves`` or the exit
        hook guarantees completion)."""
        t0 = time.monotonic()
        if self.writer is not None:
            self.writer.raise_pending_error()
        with trace_span("resilience/snapshot", lane="resilience",
                        step=engine.global_steps):
            with torch.no_grad():
                files = snapshot_to_host(engine._host_checkpoint_payload(
                    client_state=client_state))
        job = _SaveJob(self, save_dir, tag, files, save_latest)
        if self.writer is not None:
            mode = "async"
            self.writer.submit(job)  # blocks only on a full queue
        else:
            mode = "sync"
            job()
        blocked = time.monotonic() - t0
        reg = self._registry()
        if reg is not None:
            reg.counter("resilience_saves_total", "checkpoint saves",
                        labels={"mode": mode}).inc()
            reg.gauge("resilience_save_blocked_seconds",
                      "step-loop time blocked by the last save").set(blocked)
            if self.writer is not None:
                reg.gauge("resilience_queue_depth",
                          "checkpoint writes accepted but not finished"
                          ).set(self.writer.pending)
        log_dist(
            f"resilience: {mode} save of tag {tag} blocked the step loop "
            f"{blocked * 1e3:.1f} ms", ranks=[0])
        return True

    def _write_payload(self, save_dir, tag, files, save_latest) -> None:
        """Writer-thread body: staging-dir write + manifest + commit."""
        from ..checkpoint.serialization import save_tree
        from ..checkpoint.zero_to_fp32 import write_recovery_stub

        staging = staging_dir_for(save_dir, tag)
        shutil.rmtree(staging, ignore_errors=True)
        t0 = time.monotonic()
        with trace_span("resilience/write", lane="resilience"):
            for fname, tree in files.items():
                save_tree(os.path.join(staging, fname), tree)
                self.faults.on_save_file_written(fname)
            write_recovery_stub(staging)
        self._commit(save_dir, tag, save_latest=save_latest)
        reg = self._registry()
        if reg is not None:
            from ..monitor.metrics import DEFAULT_SAVE_BUCKETS

            reg.histogram("resilience_save_duration_seconds",
                          "write+commit wall time per checkpoint",
                          buckets=DEFAULT_SAVE_BUCKETS
                          ).observe(time.monotonic() - t0)

    def _commit(self, save_dir, tag, save_latest) -> None:
        from ..checkpoint.serialization import write_latest

        staging = staging_dir_for(save_dir, tag)
        final_dir = os.path.join(save_dir, str(tag))
        with trace_span("resilience/commit", lane="resilience"):
            write_manifest(staging)
            commit_checkpoint(staging, final_dir)
            if save_latest:
                write_latest(save_dir, str(tag))
        self.faults.after_commit(final_dir)
        if self.cfg.keep_last:
            self._prune(save_dir, keep=self.cfg.keep_last)

    def _prune(self, save_dir: str, keep: int) -> None:
        """Retention: drop the oldest COMMITTED tags past ``keep``.
        Legacy/unknown directories are never touched, and neither is the
        tag ``latest`` points at, the tag this run resumed from, nor the
        newest committed tag (an async save racing the interval autosave
        must never leave the directory empty of valid tags). The
        reference also protects the tags published as live weight
        versions (``lifecycle.versions.live_tags``); that module is not
        ported yet, so the set of live tags is empty here."""
        from ..checkpoint.serialization import read_latest

        committed = [t for t in list_tags(save_dir)
                     if is_committed(os.path.join(save_dir, t))]
        protected = {read_latest(save_dir), self._resumed_tag}
        if committed:
            protected.add(committed[0])  # newest committed
        for tag in committed[keep:]:
            if tag in protected:
                continue
            victim = os.path.join(save_dir, tag)
            logger.info("resilience: pruning old checkpoint %s "
                        "(keep_last=%d)", victim, keep)
            # drop the marker FIRST so a crash mid-delete leaves a
            # partial (skipped) dir, not a committed-looking torn one
            try:
                os.unlink(os.path.join(victim, COMMITTED_MARKER))
            except OSError:
                continue
            shutil.rmtree(victim, ignore_errors=True)

    def wait_for_pending_saves(self) -> None:
        if self.writer is not None:
            self.writer.wait()

    # ------------------------------------------------------------------ #
    # step-boundary protocol
    # ------------------------------------------------------------------ #

    def on_step_boundary(self, engine) -> None:
        """Called by the engine after every optimizer step: fault
        injection first (drills want the crash exactly where a real one
        lands), then preemption, then interval autosave, then the
        lifecycle hooks."""
        if self.faults.armed:
            self.faults.on_step(engine.global_steps)
        if self.guard is not None and self.guard.requested:
            self.handle_preemption(engine)  # raises SystemExit
        if (self.cfg.save_interval_steps
                and engine.global_steps > 0
                and engine.global_steps % self.cfg.save_interval_steps == 0):
            if self._save_dir is not None:
                engine.save_checkpoint(self._save_dir)
            elif not self._warned_no_save_dir:
                self._warned_no_save_dir = True
                logger.warning(
                    "resilience.save_interval_steps is set but no save "
                    "dir is known (set resilience.save_dir or call "
                    "save_checkpoint once); autosaves skipped")
        for hook in list(self.lifecycle):
            hook.poll(engine)

    def handle_preemption(self, engine) -> None:
        """The orderly-exit protocol: urgent checkpoint, drain pending
        writes, drain serving, exit with the sentinel code."""
        signum = self.guard.signum if self.guard is not None else None
        self._inc("resilience_preemption_total",
                  "preemption signals honored")
        logger.warning(
            "preemption (signal %s): urgent checkpoint at step %d, then "
            "exit %d", signum, engine.global_steps,
            self.cfg.preemption_exit_code)
        if self._save_dir is not None:
            try:
                engine.save_checkpoint(self._save_dir)
                self.wait_for_pending_saves()
            except Exception as e:  # noqa: BLE001 - exit anyway
                logger.error("urgent checkpoint failed: %s", e)
        else:
            logger.warning(
                "no save dir known for the urgent checkpoint (set "
                "resilience.save_dir); exiting without one")
        for srv in list(self.serving):
            try:
                leftover = srv.drain()
                if leftover:
                    logger.warning(
                        "serving drain: %d queued requests never admitted",
                        len(leftover))
            except Exception as e:  # noqa: BLE001
                logger.error("serving drain failed: %s", e)
        if getattr(engine, "datapipe", None) is not None:
            # stop the prefetch thread before exiting; staged batches are
            # recomputed from the checkpointed DataState on resume
            try:
                engine.datapipe.close()
            except Exception as e:  # noqa: BLE001
                logger.error("datapipe close failed: %s", e)
        if self.guard is not None:
            self.guard.uninstall()
        raise SystemExit(self.cfg.preemption_exit_code)

    # ------------------------------------------------------------------ #
    # load-side + serving hooks
    # ------------------------------------------------------------------ #

    def note_resumed(self, tag) -> None:
        self._inc("resilience_resume_total", "checkpoint resumes")
        self._resumed_tag = str(tag)
        step = tag_step(str(tag))
        log_dist(f"resilience: resumed from tag {tag}"
                 + (f" (step {step})" if step is not None else ""),
                 ranks=[0])

    def note_fallback(self, skipped_tag: Optional[str] = None) -> None:
        self._inc("resilience_fallback_total",
                  "loads that fell back past an invalid tag")
        if skipped_tag is not None:
            self._inc("resilience_corrupt_tags",
                      "checkpoint tags skipped as torn/corrupt at load")
            trace_instant("resilience/corrupt_tag", lane="resilience",
                          tag=str(skipped_tag))
            logger.warning(
                "resilience: skipped corrupt/torn checkpoint tag %r",
                skipped_tag)

    def note_restart_context(self) -> None:
        """Child-side record of a supervisor restart: when the process
        was (re)launched by the supervisor (DS_TPU_RESTART_COUNT > 0),
        bump ``resilience_restarts`` and drop a trace instant carrying
        the restart reason and the chosen elastic world size. Once per
        process: engine re-inits in one process do not re-count."""
        if self._restart_noted:
            return
        self._restart_noted = True
        try:
            count = int(os.environ.get("DS_TPU_RESTART_COUNT", "0"))
        except ValueError:
            count = 0
        if count <= 0:
            return
        reason = os.environ.get("DS_TPU_RESTART_REASON", "unknown")
        world = os.environ.get("DS_TPU_WORLD_SIZE")
        self._inc("resilience_restarts",
                  "supervisor restarts observed by this run")
        trace_instant("resilience/restart", lane="resilience",
                      count=count, reason=reason,
                      world_size=int(world) if world else None)
        log_dist(f"resilience: restart #{count} (reason: {reason}"
                 + (f", world size {world}" if world else "") + ")",
                 ranks=[0])

    def attach_serving(self, serving_engine) -> None:
        if serving_engine not in self.serving:
            self.serving.append(serving_engine)

    def attach_lifecycle(self, hook) -> None:
        """Register a lifecycle step-boundary hook (anything with a
        ``poll(engine)`` method); polled after fault/preemption/autosave
        handling."""
        if hook not in self.lifecycle:
            self.lifecycle.append(hook)

    # ------------------------------------------------------------------ #

    def discover_resume_tag(self, load_dir: Optional[str] = None
                            ) -> Optional[str]:
        """Newest valid tag in ``load_dir`` (defaults to the known save
        dir): what the supervisor exports to a restarted child."""
        load_dir = load_dir or self._save_dir
        if load_dir is None:
            return None
        return find_latest_valid_tag(
            load_dir, verify_checksums=self.cfg.verify_on_load)

    def close(self) -> None:
        """Uninstall handlers and stop the writer (draining first)."""
        if self._closed:
            return
        self._closed = True
        if self.guard is not None:
            self.guard.uninstall()
        if self.writer is not None:
            self.writer.close(wait=True)


class _SaveJob:
    """One queued write: binds the snapshot to its destination. A plain
    callable so the writer stays generic."""

    __slots__ = ("mgr", "save_dir", "tag", "files", "save_latest")

    def __init__(self, mgr, save_dir, tag, files, save_latest):
        self.mgr = mgr
        self.save_dir = save_dir
        self.tag = str(tag)
        self.files = files
        self.save_latest = save_latest

    def __call__(self) -> None:
        self.mgr._write_payload(self.save_dir, self.tag, self.files,
                                self.save_latest)
