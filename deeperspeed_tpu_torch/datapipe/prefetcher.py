"""Async double-buffered prefetcher.

Counterpart of deeperspeed_tpu/datapipe/prefetcher.py. One daemon
producer thread runs ``produce()`` (index gather, collation, curriculum
masking and, with ``stage_to_device``, the copy to the card) and parks
finished global batches in a bounded queue. The step loop's host work per
step is a queue pop; the ``wait`` it reports is the host time the step
sat starved for input (``datapipe_host_stall_seconds``).

The copy to the card from this thread is the pipe's business
(pipeline.py ``StagedBatch``): a pinned host buffer, the pipe's own CUDA
stream, and an event the consumer's stream waits on.

Error contract: a producer exception is parked and re-raised on the
consumer's next ``get()``, never swallowed by the thread. ``close()``
unblocks a producer waiting on a full queue.
"""

import queue
import threading
import time
from typing import Any, Callable, Tuple

__all__ = ["AsyncPrefetcher"]

_OK, _ERR = 0, 1


class AsyncPrefetcher:
    def __init__(self, produce: Callable[[], Any], depth: int = 2,
                 name: str = "datapipe-prefetch"):
        self._produce = produce
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    # ---- producer side ---------------------------------------------- #

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._produce()
            except BaseException as e:  # noqa: BLE001 - parked for consumer
                self._put((_ERR, e))
                return
            if not self._put((_OK, item)):
                return

    def _put(self, item) -> bool:
        """Bounded put that stays responsive to close()."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    # ---- consumer side ---------------------------------------------- #

    def get(self) -> Tuple[Any, float]:
        """(next item, seconds the caller blocked waiting for it)."""
        if self._stop.is_set():
            raise RuntimeError("prefetcher is closed")
        t0 = time.perf_counter()
        kind, item = self._q.get()
        wait = time.perf_counter() - t0
        if kind == _ERR:
            self._stop.set()
            raise item
        return item, wait

    @property
    def queued(self) -> int:
        return self._q.qsize()

    def close(self) -> None:
        """Stop the producer and drop staged batches. Safe to call twice;
        used on restore (staged batches predate the restored cursor) and
        at shutdown."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
