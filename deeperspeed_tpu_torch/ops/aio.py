"""Async NVMe I/O over numpy buffers.

Counterpart of deeperspeed_tpu/ops/aio.py (``AsyncIOHandle``,
``aligned_empty``, ``parallel_copy``), the reference's ``aio_handle``:
block size, queue depth, single submit, overlap events and thread count,
``sync_pread``/``sync_pwrite``, ``async_pread``/``async_pwrite`` and
``wait``. The I/O runs in the port's copy of the native library
(csrc/host/ds_aio.cpp: kernel AIO with O_DIRECT where the file system
allows it, a thread pool of pread/pwrite otherwise), built with the host
compiler at first use (ops/op_builder.load_host).
"""

import ctypes
from typing import Optional

import numpy as np

from . import op_builder

_DEFAULT_BLOCK_SIZE = 1 << 20
_DEFAULT_QUEUE_DEPTH = 8
_ALIGN = 512  # O_DIRECT sector alignment (Worker::kAlign in the library)

_c = ctypes
_SIGNATURES = {
    "ds_aio_handle_new": ([_c.c_int] * 5, _c.c_void_p),
    "ds_aio_handle_free": ([_c.c_void_p], None),
    **{name: ([_c.c_void_p], _c.c_int) for name in (
        "ds_aio_get_block_size", "ds_aio_get_queue_depth",
        "ds_aio_get_single_submit", "ds_aio_get_overlap_events",
        "ds_aio_get_thread_count")},
    **{name: ([_c.c_void_p, _c.c_void_p, _c.c_char_p, _c.c_longlong],
              _c.c_longlong)
       for name in ("ds_aio_sync_pread", "ds_aio_sync_pwrite")},
    **{name: ([_c.c_void_p, _c.c_void_p, _c.c_char_p, _c.c_longlong],
              _c.c_int)
       for name in ("ds_aio_async_pread", "ds_aio_async_pwrite")},
    "ds_aio_wait": ([_c.c_void_p], _c.c_int),
    "ds_aio_aligned_alloc": ([_c.c_longlong], _c.c_void_p),
    "ds_aio_aligned_free": ([_c.c_void_p], None),
    "ds_aio_memcpy": ([_c.c_void_p, _c.c_void_p, _c.c_longlong, _c.c_int],
                      None),
}


def load_aio() -> ctypes.CDLL:
    """The native I/O library, built at first use."""
    return op_builder.load_host("ds_aio", _SIGNATURES)


def _contiguous(arr: np.ndarray) -> np.ndarray:
    if not arr.flags["C_CONTIGUOUS"]:
        raise ValueError("aio buffers must be C-contiguous")
    return arr


class AsyncIOHandle:
    """One I/O queue: a native thread pool with per-thread kernel AIO
    contexts."""

    def __init__(self, block_size: int = _DEFAULT_BLOCK_SIZE,
                 queue_depth: int = _DEFAULT_QUEUE_DEPTH,
                 single_submit: bool = False, overlap_events: bool = True,
                 thread_count: int = 1):
        self._lib = load_aio()
        self._h = self._lib.ds_aio_handle_new(
            int(block_size), int(queue_depth), int(single_submit),
            int(overlap_events), int(thread_count))
        if not self._h:
            raise RuntimeError("failed to create aio handle")

    def get_block_size(self) -> int:
        return self._lib.ds_aio_get_block_size(self._h)

    def get_queue_depth(self) -> int:
        return self._lib.ds_aio_get_queue_depth(self._h)

    def get_single_submit(self) -> bool:
        return bool(self._lib.ds_aio_get_single_submit(self._h))

    def get_overlap_events(self) -> bool:
        return bool(self._lib.ds_aio_get_overlap_events(self._h))

    def get_thread_count(self) -> int:
        return self._lib.ds_aio_get_thread_count(self._h)

    def _io(self, fn, buffer, filename, nbytes):
        buffer = _contiguous(buffer)
        n = buffer.nbytes if nbytes is None else nbytes
        return fn(self._h, _c.c_void_p(buffer.ctypes.data),
                  filename.encode(), n)

    def sync_pread(self, buffer: np.ndarray, filename: str,
                   nbytes: Optional[int] = None) -> int:
        got = self._io(self._lib.ds_aio_sync_pread, buffer, filename, nbytes)
        if got < 0:
            raise IOError(f"aio read failed: {filename}")
        return got

    def sync_pwrite(self, buffer: np.ndarray, filename: str,
                    nbytes: Optional[int] = None) -> int:
        got = self._io(self._lib.ds_aio_sync_pwrite, buffer, filename,
                       nbytes)
        if got < 0:
            raise IOError(f"aio write failed: {filename}")
        return got

    def async_pread(self, buffer: np.ndarray, filename: str,
                    nbytes: Optional[int] = None) -> None:
        if self._io(self._lib.ds_aio_async_pread, buffer, filename,
                    nbytes) != 0:
            raise IOError(f"aio async read submit failed: {filename}")

    def async_pwrite(self, buffer: np.ndarray, filename: str,
                     nbytes: Optional[int] = None) -> None:
        if self._io(self._lib.ds_aio_async_pwrite, buffer, filename,
                    nbytes) != 0:
            raise IOError(f"aio async write submit failed: {filename}")

    def wait(self) -> int:
        """Block until every outstanding async request is done; returns
        their count."""
        n = self._lib.ds_aio_wait(self._h)
        if n < 0:
            raise IOError("aio request failed")
        return n

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ds_aio_handle_free(h)
            self._h = None


def aligned_empty(shape, dtype=np.float32) -> np.ndarray:
    """A host buffer aligned for O_DIRECT, its capacity rounded up to the
    sector size so a kernel-AIO tail block stays in bounds (the base array
    lives on as ``arr.base``)."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    cap = (max(nbytes, 1) + _ALIGN - 1) // _ALIGN * _ALIGN
    raw = np.empty(cap + _ALIGN, dtype=np.uint8)
    offset = (-raw.ctypes.data) % _ALIGN
    return raw[offset:offset + nbytes].view(dtype).reshape(shape)


def parallel_copy(dst: np.ndarray, src: np.ndarray, threads: int = 4) -> None:
    """memcpy on ``threads`` native threads, without the GIL."""
    if dst.nbytes != src.nbytes:
        raise ValueError("size mismatch")
    load_aio().ds_aio_memcpy(_c.c_void_p(dst.ctypes.data),
                             _c.c_void_p(src.ctypes.data), dst.nbytes,
                             threads)
