"""Bounded-queue background checkpoint writer.

Counterpart of deeperspeed_tpu/resilience/writer.py, whole.

The async half of a resilience save: the engine snapshots device state
to pinned host buffers at the step boundary (one device-to-host copy
sweep), wraps the serialize+fsync+commit work in a callable job, and
hands it here. Training resumes immediately; the writer thread does the disk IO.

Durability properties:

  * the queue is BOUNDED (``max_pending``): a run that checkpoints
    faster than the disk drains blocks at ``submit`` instead of
    accumulating unbounded host snapshots.
  * the thread is a daemon, but an ``atexit`` hook drains the queue, so
    a clean interpreter exit never abandons an accepted save. (SIGKILL
    of course does — which is exactly what the two-phase commit in
    ``manifest.py`` protects against.)
  * a failed job parks its exception; the NEXT ``submit``/``wait`` call
    re-raises it as ``CheckpointWriteError`` on the training thread, so
    write errors surface where the user can see them instead of dying
    silently on a worker thread.
"""

import atexit
import queue
import threading
from typing import Callable, Optional

from ..utils.logging import logger


class CheckpointWriteError(RuntimeError):
    """A background checkpoint write failed (original error chained)."""


class AsyncCheckpointWriter:
    def __init__(self, max_pending: int = 2, name: str = "ckpt-writer"):
        self._q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue(
            maxsize=max_pending)
        self._error: Optional[BaseException] = None
        self._error_lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(
            target=self._loop, name=name, daemon=True)
        self._thread.start()
        atexit.register(self._drain_at_exit)

    # ---- worker ----------------------------------------------------- #

    def _loop(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            try:
                job()
            except BaseException as e:  # noqa: BLE001 - park ANY failure
                with self._error_lock:
                    self._error = e
                logger.error("async checkpoint write failed: %s", e)
            finally:
                self._q.task_done()

    # ---- producer surface ------------------------------------------- #

    def submit(self, job: Callable[[], None]) -> None:
        """Enqueue one write job. Blocks when ``max_pending`` snapshots
        are already waiting (bounded backpressure). Raises a parked
        error from an earlier failed write."""
        if self._closed:
            raise CheckpointWriteError("writer is closed")
        self.raise_pending_error()
        self._q.put(job)

    def wait(self) -> None:
        """Block until every accepted job has been written; re-raise a
        parked write error."""
        self._q.join()
        self.raise_pending_error()

    def raise_pending_error(self) -> None:
        with self._error_lock:
            err, self._error = self._error, None
        if err is not None:
            raise CheckpointWriteError(
                f"background checkpoint write failed: {err}") from err

    @property
    def pending(self) -> int:
        """Jobs accepted but not yet fully written (approximate)."""
        return int(self._q.unfinished_tasks)

    def close(self, wait: bool = True) -> None:
        """Drain (optionally) and stop the worker thread. Idempotent."""
        if self._closed:
            return
        self._closed = True
        if wait:
            try:
                self._q.join()
            except Exception:  # pragma: no cover - interpreter teardown
                pass
        self._q.put(None)
        self._thread.join(timeout=30.0)

    def _drain_at_exit(self) -> None:
        # clean-exit insurance: the daemon thread keeps running during
        # atexit, so joining the queue here finishes accepted saves
        # before the interpreter tears the thread down
        try:
            if not self._closed:
                self._q.join()
        except Exception:  # pragma: no cover
            pass
