"""Optimizer state between host RAM and NVMe (the ZeRO-Infinity tier).

Counterpart of deeperspeed_tpu/runtime/offload/swapper.py, over numpy
buffers and the port's native I/O (ops/aio.py):

  * ``SwapBuffer`` / ``SwapBufferPool`` -- aligned staging buffers, tensors
    packed back to back at 512-byte offsets;
  * ``OptimizerStateSwapper`` -- one file per leaf holding its named state
    arrays packed contiguously, separate read and write queues;
  * ``PartitionedOptimizerSwapper`` -- read leaf, step, write leaf;
  * ``PipelinedOptimizerSwapper`` -- while leaf i steps on the host, leaf
    i+1 is read and leaf i-1 written.
"""

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...monitor import trace_span
from ...ops.aio import AsyncIOHandle, aligned_empty
from .aio_config import AioConfig

AIO_ALIGN = 512


def _aligned(n: int) -> int:
    return (n + AIO_ALIGN - 1) // AIO_ALIGN * AIO_ALIGN


def swap_path(folder: str, name: str) -> str:
    return os.path.join(folder, f"{name}.tensor.swp")


class SwapBuffer:
    """One aligned staging buffer; tensors are packed back to back at
    512-byte aligned offsets."""

    def __init__(self, nbytes: int):
        self.buffer = aligned_empty((nbytes,), np.uint8)
        self.nbytes = nbytes
        self.offset = 0
        self.tensors: Dict[str, Tuple[int, Tuple[int, ...], np.dtype]] = {}

    def reset(self):
        self.offset = 0
        self.tensors.clear()

    def has_space(self, nbytes: int) -> bool:
        return self.offset + _aligned(nbytes) <= self.nbytes

    def insert(self, name: str, arr: np.ndarray) -> np.ndarray:
        """Copy ``arr`` into the buffer; returns the staged view."""
        view = self.allocate(name, arr.shape, arr.dtype)
        np.copyto(view, arr)
        return view

    def allocate(self, name: str, shape, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        n = int(np.prod(shape)) * dtype.itemsize
        if not self.has_space(n):
            raise RuntimeError(
                f"swap buffer full ({self.offset}+{n} > {self.nbytes})")
        view = self.buffer[self.offset:self.offset + n].view(dtype).reshape(
            shape)
        self.tensors[name] = (self.offset, tuple(shape), dtype)
        self.offset += _aligned(n)
        return view

    def get(self, name: str) -> np.ndarray:
        off, shape, dtype = self.tensors[name]
        n = int(np.prod(shape)) * dtype.itemsize
        return self.buffer[off:off + n].view(dtype).reshape(shape)


class SwapBufferPool:
    """A fixed set of SwapBuffers handed out in turn."""

    def __init__(self, count: int, nbytes: int):
        self.buffers = [SwapBuffer(nbytes) for _ in range(count)]
        self.free: List[SwapBuffer] = list(self.buffers)

    def acquire(self) -> Optional[SwapBuffer]:
        return self.free.pop() if self.free else None

    def release(self, buf: SwapBuffer):
        buf.reset()
        self.free.append(buf)


class OptimizerStateSwapper:
    """Per-leaf optimizer-state files: each leaf's named state arrays packed
    contiguously in one file."""

    def __init__(self, aio_config: AioConfig, swap_folder: str):
        os.makedirs(swap_folder, exist_ok=True)
        self.swap_folder = swap_folder

        def handle():
            return AsyncIOHandle(
                block_size=aio_config.block_size,
                queue_depth=aio_config.queue_depth,
                single_submit=aio_config.single_submit,
                overlap_events=aio_config.overlap_events,
                thread_count=aio_config.thread_count)

        # separate read and write queues, so a read-ahead can be awaited
        # without draining the write-behind
        self.aio = handle()
        self.aio_w = handle()
        # leaf -> [(state name, shape, dtype, byte offset, nbytes)]
        self._layout: Dict[str, List[Tuple[str, Tuple[int, ...], np.dtype,
                                           int, int]]] = {}
        self._leaf_bytes: Dict[str, int] = {}

    def _path(self, leaf: str) -> str:
        return swap_path(self.swap_folder,
                         f"optstate_{leaf.replace('/', '_')}")

    def register_leaf(self, leaf: str, states: Dict[str, np.ndarray]):
        """Record the packed layout and write the initial state."""
        layout, off = [], 0
        for name, arr in states.items():
            layout.append((name, arr.shape, arr.dtype, off, arr.nbytes))
            off += _aligned(arr.nbytes)
        self._layout[leaf] = layout
        self._leaf_bytes[leaf] = off
        self.aio.sync_pwrite(self._pack(leaf, states), self._path(leaf), off)

    def _pack(self, leaf: str, states: Dict[str, np.ndarray]) -> np.ndarray:
        buf = aligned_empty((self._leaf_bytes[leaf],), np.uint8)
        for name, shape, dtype, off, n in self._layout[leaf]:
            np.copyto(buf[off:off + n].view(dtype).reshape(shape),
                      states[name])
        return buf

    def unpack(self, leaf: str, buf: np.ndarray) -> Dict[str, np.ndarray]:
        return {name: buf[off:off + n].view(dtype).reshape(shape)
                for name, shape, dtype, off, n in self._layout[leaf]}

    def leaf_names(self) -> List[str]:
        return list(self._layout)

    def leaf_bytes(self, leaf: str) -> int:
        return self._leaf_bytes[leaf]

    def swap_out(self, leaf: str, states: Dict[str, np.ndarray],
                 async_op=False):
        nbytes = self._leaf_bytes[leaf]
        with trace_span("offload/optstate_swap_out", lane="offload",
                        bytes=nbytes, async_op=async_op):
            buf = self._pack(leaf, states)
            if async_op:
                self.aio_w.async_pwrite(buf, self._path(leaf), nbytes)
                return buf  # the caller keeps it alive until wait()
            self.aio_w.sync_pwrite(buf, self._path(leaf), nbytes)
            return None

    def swap_in(self, leaf: str, async_op=False):
        nbytes = self._leaf_bytes[leaf]
        with trace_span("offload/optstate_swap_in", lane="offload",
                        bytes=nbytes, async_op=async_op):
            buf = aligned_empty((nbytes,), np.uint8)
            if async_op:
                self.aio.async_pread(buf, self._path(leaf), nbytes)
            else:
                self.aio.sync_pread(buf, self._path(leaf), nbytes)
            return buf  # unpack it (after wait() when async)

    def wait_reads(self):
        self.aio.wait()

    def wait(self):
        self.aio.wait()
        self.aio_w.wait()


class PartitionedOptimizerSwapper(OptimizerStateSwapper):
    """Synchronous: read leaf, step, write leaf."""

    def for_each_leaf(self, leaves: Sequence[str], step_fn):
        """``step_fn(leaf, states)`` mutates ``states`` in place."""
        for leaf in leaves:
            states = self.unpack(leaf, self.swap_in(leaf, async_op=False))
            step_fn(leaf, states)
            self.swap_out(leaf, states, async_op=False)


class PipelinedOptimizerSwapper(OptimizerStateSwapper):
    """Double-buffered: while leaf i steps on the host, leaf i+1 is read
    and leaf i-1 written, the native I/O threads overlapping both with
    the step."""

    def for_each_leaf(self, leaves: Sequence[str], step_fn):
        if not leaves:
            return
        pending_read = self.swap_in(leaves[0], async_op=True)
        write_keepalive = []
        for i, leaf in enumerate(leaves):
            self.wait_reads()  # read(i) done; write(i-1) still in flight
            states = self.unpack(leaf, pending_read)
            pending_read = (self.swap_in(leaves[i + 1], async_op=True)
                            if i + 1 < len(leaves) else None)
            with trace_span("offload/host_step", lane="offload", leaf=leaf):
                step_fn(leaf, states)  # overlaps read(i+1), write(i-1)
            write_keepalive.append(self.swap_out(leaf, states, async_op=True))
            if len(write_keepalive) > 2:
                # bound host memory: drain the write-behind first
                self.aio_w.wait()
                write_keepalive.clear()
        self.wait()
