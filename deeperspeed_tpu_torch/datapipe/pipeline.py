"""DataPipe: the engine-facing composition of the input pipeline.

Counterpart of deeperspeed_tpu/datapipe/pipeline.py. One pipe per engine
binds:

  * a sample source: a ``TokenShardDataset`` built from
    ``datapipe.source``, or any indexable dataset handed to
    ``initialize(training_data=...)``;
  * the counter-based epoch order (``dataset.epoch_order``) and the
    explicit ``DataState`` cursor over it;
  * the curriculum stage (seq-len warmup composed with the batch-size
    schedule of runtime/bs_schedules.py) and the collator (stacking or
    ragged-document packing);
  * the prefetcher, whose producer thread also copies each batch to the
    card while the current step runs (``StagedBatch``);
  * the monitor: ``datapipe/wait`` trace spans, the
    ``datapipe_host_stall_seconds`` gauge and histogram, and the
    ``datapipe_batches_total``, ``datapipe_queue_depth`` and
    ``datapipe_epoch`` metrics, under the reference's names.

Device staging. The reference hands each batch to ``jax.device_put``
from the producer thread. Here the producer calls ``place_fn`` (the
engine's ``_place_batch``: this rank's rows, pinned, copied without
blocking) under the pipe's own CUDA stream and records an event after the
copy. The consumer makes its current stream wait on that event and marks
every staged tensor with ``record_stream`` on it, so the caching
allocator does not reuse a buffer while the step still reads it. A
missing wait would show as a batch of stale tokens, not as an error.

Determinism: ``_make_batch`` is a pure function of
``(DataState, dataset, config)``. The pipe's public state advances only
when the step loop consumes a batch, so the state a checkpoint captures
names exactly the next batch a resumed run produces; staged batches are
recomputed after a restore from the same counters.
"""

import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..monitor import get_monitor
from ..monitor.tracer import trace_span
from ..utils.logging import logger
from .collator import SequencePacker, stack_collate
from .config import (
    CURRICULUM_NUM_INTERVALS,
    CURRICULUM_START_SEQ_LEN,
    CURRICULUM_WARMUP_STEPS,
    DataPipeConfig,
)
from .curriculum import CurriculumStage, SeqLenCurriculum
from .dataset import TokenShardDataset, epoch_order, order_fingerprint
from .prefetcher import AsyncPrefetcher
from .state import DataState

__all__ = ["DataPipe", "build_datapipe"]


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


class StagedBatch:
    """A batch whose copy to the card was issued on the pipe's staging
    stream, with the event recorded after it. ``wait()`` (on the
    consumer's thread) orders the consumer's current stream after the
    copy and returns the batch."""

    __slots__ = ("batch", "event", "device")

    def __init__(self, batch, event, device):
        self.batch = batch
        self.event = event
        self.device = device

    def wait(self):
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        for t in _tensors(self.batch):
            if t.device.type == "cuda":
                t.record_stream(stream)
        return self.batch


def _default_place_fn(device):
    """Standalone staging (no engine supplying its ``_place_batch``): the
    whole batch, rows of the default mesh's rank, on ``device``."""
    from ..sharding import mesh as mesh_lib
    from ..sharding import rules

    mesh = mesh_lib.default_mesh()

    def place(batch):
        def leaf(x):
            if isinstance(x, dict):
                return {k: leaf(v) for k, v in x.items()}
            if isinstance(x, (tuple, list)):
                return type(x)(leaf(v) for v in x)
            t = torch.from_numpy(np.ascontiguousarray(x))
            if device.type == "cuda":
                t = t.pin_memory()
            return t.to(device, non_blocking=True)
        return leaf(rules.place_batch(mesh, batch))

    return place


class DataPipe:
    def __init__(
        self,
        dataset,
        cfg: DataPipeConfig,
        global_rows: int,
        place_fn: Optional[Callable[[Any], Any]] = None,
        bs_schedule: Optional[List[Tuple[int, int]]] = None,
        collate_fn: Optional[Callable] = None,
        device=None,
    ):
        if global_rows < 1:
            raise ValueError(f"global_rows must be >= 1, got {global_rows}")
        n = len(dataset)
        if not cfg.pack_sequences and global_rows > n:
            raise ValueError(
                f"global batch of {global_rows} rows exceeds the dataset "
                f"({n} samples); shrink the batch or add data")
        self.dataset = dataset
        self.cfg = cfg
        self.global_rows = int(global_rows)
        # where staged batches go: the card unless the caller says
        self.device = torch.device("cuda" if device is None else device)
        self._stream = None
        if cfg.stage_to_device:
            if self.device.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "datapipe stage_to_device stages onto CUDA unless "
                        "given device='cpu', and no CUDA device is "
                        "available")
                # the producer's own stream: the copy overlaps the step
                self._stream = torch.cuda.Stream(self.device)
            if place_fn is None:
                place_fn = _default_place_fn(self.device)
        self.place_fn = place_fn if cfg.stage_to_device else None
        self.collate_fn = collate_fn or stack_collate
        self.packer = (
            SequencePacker(cfg.seq_len, pad_id=cfg.pad_id, eos_id=cfg.eos_id)
            if cfg.pack_sequences else None)
        curriculum = None
        if cfg.curriculum is not None:
            cur = dict(cfg.curriculum)
            curriculum = SeqLenCurriculum(
                final_seq_len=cfg.seq_len,
                start_seq_len=int(cur.get(CURRICULUM_START_SEQ_LEN,
                                          cfg.seq_len)),
                warmup_steps=int(cur.get(CURRICULUM_WARMUP_STEPS, 1000)),
                num_intervals=int(cur.get(CURRICULUM_NUM_INTERVALS, 4)))
        self.stage = CurriculumStage(curriculum, bs_schedule=bs_schedule,
                                     pad_id=cfg.pad_id)
        self.state = DataState(
            seed=cfg.seed,
            fingerprint=self._fingerprint(cfg.seed, 0))
        self._order_cache: Tuple[Optional[tuple], Optional[np.ndarray]] = (
            None, None)
        self._prefetcher: Optional[AsyncPrefetcher] = None
        self._prod_state: DataState = self.state
        self.last_stall_seconds = 0.0
        if cfg.prefetch:
            self._start_prefetcher()

    # ---------------------------------------------------------------- #
    # deterministic production
    # ---------------------------------------------------------------- #

    def _identity(self) -> Optional[dict]:
        ident = getattr(self.dataset, "identity", None)
        return ident() if callable(ident) else None

    def _fingerprint(self, seed: int, epoch: int) -> str:
        return order_fingerprint(seed, epoch, len(self.dataset),
                                 shuffle=self.cfg.shuffle,
                                 identity=self._identity())

    def _order_for(self, seed: int, epoch: int) -> np.ndarray:
        # keyed by the state's seed, not the config's: a checkpoint
        # restored under another configured seed replays its own stream
        cached_key, order = self._order_cache
        if cached_key != (seed, epoch) or order is None:
            order = epoch_order(seed, epoch, len(self.dataset),
                                shuffle=self.cfg.shuffle)
            self._order_cache = ((seed, epoch), order)
        return order

    def _wrap_epoch(self, st: DataState) -> DataState:
        return DataState(
            epoch=st.epoch + 1, cursor=0, step=st.step,
            samples=st.samples, seed=st.seed,
            fingerprint=self._fingerprint(st.seed, st.epoch + 1))

    def _make_batch(self, st: DataState) -> Tuple[Any, DataState]:
        """Pure: (state) -> (collated, masked batch; state after it)."""
        rows = self.global_rows
        n = len(self.dataset)
        if self.packer is None and st.cursor + rows > n:
            st = self._wrap_epoch(st)  # drop the ragged tail
        order = self._order_for(st.seed, st.epoch)
        if self.packer is not None:
            # lazy: the packer pulls only the documents the batch uses
            docs = (self.dataset[int(i)] for i in order[st.cursor:])
            tokens, segs, used, offset = self.packer.pack(
                docs, rows, first_offset=st.offset)
            tokens, segs = self.stage.apply(tokens, st.step,
                                            segment_ids=segs)
            batch = {"tokens": tokens, "segment_ids": segs}
            next_st = DataState(
                epoch=st.epoch, cursor=st.cursor + used, step=st.step + 1,
                samples=st.samples + used, seed=st.seed,
                fingerprint=st.fingerprint, offset=offset)
            if next_st.cursor >= n:
                next_st = self._wrap_epoch(next_st)
            return batch, next_st
        idx = order[st.cursor:st.cursor + rows]
        samples = [self.dataset[int(i)] for i in idx]
        batch = self.stage.apply(self.collate_fn(samples), st.step)
        next_st = DataState(
            epoch=st.epoch, cursor=st.cursor + rows, step=st.step + 1,
            samples=st.samples + rows, seed=st.seed,
            fingerprint=st.fingerprint)
        return batch, next_st

    def _place(self, batch):
        """``place_fn`` on the staging stream when it targets the card
        (a ``StagedBatch``), else directly."""
        if self._stream is None:
            return self.place_fn(batch)
        with torch.cuda.stream(self._stream):
            placed = self.place_fn(batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return StagedBatch(placed, event, self.device)

    def _produce(self):
        """Producer body: the next batch from the producer cursor, staged
        on the device while the current step runs."""
        batch, next_st = self._make_batch(self._prod_state)
        self._prod_state = next_st
        placed = False
        if self.place_fn is not None:
            batch = self._place(batch)
            placed = True
        return batch, next_st, placed

    # ---------------------------------------------------------------- #
    # the step loop's view
    # ---------------------------------------------------------------- #

    def _start_prefetcher(self) -> None:
        self._prod_state = self.state
        self._prefetcher = AsyncPrefetcher(
            self._produce, depth=self.cfg.prefetch_depth)

    def next_global_batch(self) -> Tuple[Any, bool]:
        """The next global batch and whether it is already placed on the
        engine's device (the current stream then ordered after its copy).
        Blocks only while the host is behind; the wait is recorded as the
        step's host stall."""
        with trace_span("datapipe/wait", lane="datapipe",
                        step=self.state.step):
            if self._prefetcher is not None:
                (batch, next_st, placed), wait = self._prefetcher.get()
            else:
                t0 = time.perf_counter()
                batch, next_st, placed = self._produce()
                wait = time.perf_counter() - t0
        if isinstance(batch, StagedBatch):
            batch = batch.wait()
        self.state = next_st
        self.last_stall_seconds = wait
        self._record_metrics(wait)
        return batch, placed

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_global_batch()[0]

    @property
    def queued(self) -> int:
        """Staged global batches waiting in the prefetch queue."""
        return self._prefetcher.queued if self._prefetcher is not None else 0

    def _record_metrics(self, wait: float) -> None:
        mon = get_monitor()
        if mon is None:
            return
        from ..monitor.metrics import DEFAULT_STALL_BUCKETS

        reg = mon.registry
        reg.counter("datapipe_batches_total",
                    "global batches handed to the step loop").inc()
        reg.gauge("datapipe_host_stall_seconds",
                  "host time the last step blocked waiting on input"
                  ).set(wait)
        reg.histogram("datapipe_host_stall_seconds_hist",
                      "host-blocked time per step waiting on input",
                      buckets=DEFAULT_STALL_BUCKETS).observe(wait)
        reg.gauge("datapipe_queue_depth",
                  "staged global batches ready for the step loop").set(
            self.queued)
        reg.gauge("datapipe_epoch", "current dataset epoch").set(
            self.state.epoch)

    # ---------------------------------------------------------------- #
    # checkpointable state
    # ---------------------------------------------------------------- #

    def state_dict(self) -> dict:
        return self.state.to_dict()

    def load_state_dict(self, sd: dict) -> None:
        """Restore the iteration cursor. Staged batches are dropped and
        re-produced from the restored counters, which is what makes a
        resume bit-identical with batches in flight."""
        st = DataState.from_dict(sd)
        expect = self._fingerprint(st.seed, st.epoch)
        if st.fingerprint and st.fingerprint != expect:
            logger.warning(
                "datapipe: restored DataState fingerprint %s does not "
                "match this dataset/seed (%s) — the corpus, seed, or "
                "shuffle setting changed since the checkpoint; the "
                "resumed batch stream will NOT replay the original run",
                st.fingerprint, expect)
        self.state = DataState(
            epoch=st.epoch, cursor=st.cursor, step=st.step,
            samples=st.samples, seed=st.seed, fingerprint=expect,
            offset=st.offset)
        self._restart_production()

    def seed_step(self, step: int) -> None:
        """Align the curriculum and batch-size step with the engine's
        ``global_steps`` when a restored checkpoint carries no datapipe
        state. The batch stream still restarts from epoch 0."""
        self.state = DataState(
            epoch=self.state.epoch, cursor=self.state.cursor,
            step=int(step), samples=self.state.samples,
            seed=self.state.seed, fingerprint=self.state.fingerprint,
            offset=self.state.offset)
        self._restart_production()

    def _restart_production(self) -> None:
        """Drop staged batches and re-produce from the current state."""
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._start_prefetcher()
        else:
            self._prod_state = self.state

    def close(self) -> None:
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None


def build_datapipe(
    cfg: DataPipeConfig,
    dataset=None,
    global_rows: int = 1,
    place_fn=None,
    bs_schedule=None,
    collate_fn=None,
    device=None,
) -> DataPipe:
    """Build a DataPipe from the config block. ``dataset`` (an indexable
    of samples, e.g. ``initialize(training_data=...)``) wins over
    ``cfg.source``. ``device`` is where staged batches go (CUDA unless
    given)."""
    if dataset is None:
        if cfg.source is None:
            raise ValueError(
                'the "datapipe" block needs a "source" (token .npy file '
                "or shard directory) when initialize() gets no "
                "training_data")
        dataset = TokenShardDataset(cfg.source, cfg.seq_len)
    return DataPipe(dataset, cfg, global_rows, place_fn=place_fn,
                    bs_schedule=bs_schedule, collate_fn=collate_fn,
                    device=device)
