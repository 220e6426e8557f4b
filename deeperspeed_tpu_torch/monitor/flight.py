"""Crash-proof flight recorder: the trace tail that survives SIGKILL.

Counterpart of deeperspeed_tpu/monitor/flight.py: the same file
format byte for byte, so each package recovers the other's
``flight.bin``.

The ring tracer keeps events in process memory, so a SIGKILLed trainer
or replica takes its last seconds of telemetry with it — exactly the
window a post-mortem needs. The flight recorder closes that gap: a
fixed-size file-backed mmap ring of CRC'd records, written inline by
the tracer on every event. mmap writes land in the kernel page cache
immediately, so even an abrupt SIGKILL (no atexit, no flush) leaves a
readable ``flight.bin`` holding the process's final events; only a
whole-machine power loss can take them.

Layout (little-endian)::

    header (4096 B): magic "DSFL" | version u32 | slot_size u32 |
                     capacity u32 | meta_len u32 | meta JSON
    slots  (capacity x slot_size):
                     seq u64 | payload_len u32 | crc32 u32 | payload

The header's meta JSON carries the run context (run_id / role /
incarnation, see runctx.py) and a (wall, perf) clock anchor so the
aggregator can place recovered events on the shared timeline. Each
record's payload is one Chrome-trace event as compact JSON. The seq
field is written LAST: a record torn mid-write (killed between bytes)
either keeps its old seq — stale but intact — or fails the CRC; either
way ``recover()`` never yields garbage. Recovery scans every slot,
drops CRC failures (reported as ``torn``), and returns the survivors
in append order.

Capacity is a ring: record N+capacity overwrites record N. The default
(2048 records x 512 B = 1 MiB) holds the last few thousand events —
minutes of steady-state tracing, which is the window that matters when
a process dies.
"""

import json
import mmap
import os
import struct
import threading
import zlib
from typing import List, Optional

from .runctx import clock_anchor, current

__all__ = ["FlightRecorder", "FlightSnapshot", "recover", "is_flight_file"]

MAGIC = b"DSFL"
VERSION = 1
HEADER_BYTES = 4096
_HEADER = struct.Struct("<4sIIII")          # magic, version, slot, cap, meta
_SLOT = struct.Struct("<QII")               # seq, payload_len, crc32
_SLOT_OVERHEAD = _SLOT.size

DEFAULT_RECORDS = 2048
DEFAULT_SLOT_BYTES = 512


class FlightSnapshot:
    """What ``recover()`` returns: the readable tail of a flight file."""

    def __init__(self, path: str, meta: dict, events: List[dict],
                 torn: int, last_seq: int):
        self.path = path
        self.meta = meta
        self.events = events
        self.torn = torn            # slots whose CRC failed (mid-write kill)
        self.last_seq = last_seq    # total records ever appended
        # records lost to ring overwrite (distinct from torn)
        self.overwritten = max(0, last_seq - len(events) - torn)


class FlightRecorder:
    """Bounded mmap ring of CRC'd trace events; safe under SIGKILL."""

    def __init__(self, path: str, capacity: int = DEFAULT_RECORDS,
                 slot_bytes: int = DEFAULT_SLOT_BYTES,
                 meta: Optional[dict] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if slot_bytes < _SLOT_OVERHEAD + 32:
            raise ValueError(f"slot_bytes must be >= {_SLOT_OVERHEAD + 32}, "
                             f"got {slot_bytes}")
        self.path = path
        self.capacity = capacity
        self.slot_bytes = slot_bytes
        self._lock = threading.Lock()
        self._seq = 0
        full_meta = {**current().as_args(), "pid": os.getpid(),
                     "clock": clock_anchor(), **(meta or {})}
        meta_blob = json.dumps(full_meta).encode("utf-8")
        if _HEADER.size + len(meta_blob) > HEADER_BYTES:
            meta_blob = json.dumps(current().as_args()).encode("utf-8")
        header = _HEADER.pack(MAGIC, VERSION, slot_bytes, capacity,
                              len(meta_blob)) + meta_blob
        header = header.ljust(HEADER_BYTES, b"\0")
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        size = HEADER_BYTES + capacity * slot_bytes
        # recreate from scratch: a flight file is per-(process,
        # incarnation); stale records from a previous life must not
        # masquerade as this one's
        self._fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_TRUNC)
        os.ftruncate(self._fd, size)
        self._mm = mmap.mmap(self._fd, size)
        self._mm[:HEADER_BYTES] = header
        self._closed = False

    # -------------------------------------------------------------- #

    def append(self, ev: dict) -> None:
        """Record one event inline. Never raises into the hot path: an
        oversized event is shrunk to its envelope rather than dropped."""
        if self._closed:
            return
        payload = json.dumps(ev, separators=(",", ":"),
                             default=str).encode("utf-8")
        limit = self.slot_bytes - _SLOT_OVERHEAD
        if len(payload) > limit:
            slim = {k: ev[k] for k in
                    ("name", "ph", "ts", "dur", "pid", "tid") if k in ev}
            slim["args"] = {"truncated": True}
            payload = json.dumps(slim, separators=(",", ":"),
                                 default=str).encode("utf-8")[:limit]
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        with self._lock:
            if self._closed:
                return
            self._seq += 1
            seq = self._seq
            off = HEADER_BYTES + ((seq - 1) % self.capacity) * self.slot_bytes
            mm = self._mm
            # payload + envelope first, seq LAST: a kill mid-write leaves
            # either the old (intact) record or a CRC failure, never a
            # plausible-looking hybrid
            mm[off + 8:off + _SLOT_OVERHEAD] = struct.pack(
                "<II", len(payload), crc)
            mm[off + _SLOT_OVERHEAD:off + _SLOT_OVERHEAD + len(payload)] = \
                payload
            mm[off:off + 8] = struct.pack("<Q", seq)

    @property
    def appended(self) -> int:
        return self._seq

    def flush(self) -> None:
        with self._lock:
            if not self._closed:
                self._mm.flush()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            try:
                self._mm.flush()
                self._mm.close()
            finally:
                os.close(self._fd)


# ------------------------------------------------------------------ #
# recovery
# ------------------------------------------------------------------ #


def is_flight_file(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(4) == MAGIC
    except OSError:
        return False


def recover(path: str) -> FlightSnapshot:
    """Read back whatever a (possibly SIGKILLed) process left behind.
    Tolerates a torn final record and a truncated file; raises only on
    a missing/garbled header."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < HEADER_BYTES:
        raise ValueError(f"{path}: too short to be a flight file")
    magic, version, slot_bytes, capacity, meta_len = _HEADER.unpack(
        raw[:_HEADER.size])
    if magic != MAGIC:
        raise ValueError(f"{path}: not a flight file (bad magic)")
    if version != VERSION:
        raise ValueError(f"{path}: unsupported flight version {version}")
    try:
        meta = json.loads(
            raw[_HEADER.size:_HEADER.size + meta_len].decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        meta = {}
    records = []
    torn = 0
    last_seq = 0
    for i in range(capacity):
        off = HEADER_BYTES + i * slot_bytes
        slot = raw[off:off + slot_bytes]
        if len(slot) < _SLOT_OVERHEAD:
            break  # file truncated mid-slot: everything past here is gone
        seq, plen, crc = _SLOT.unpack(slot[:_SLOT_OVERHEAD])
        if seq == 0:
            continue  # never written
        last_seq = max(last_seq, seq)
        payload = slot[_SLOT_OVERHEAD:_SLOT_OVERHEAD + plen]
        if (plen > slot_bytes - _SLOT_OVERHEAD or len(payload) < plen
                or (zlib.crc32(payload) & 0xFFFFFFFF) != crc):
            torn += 1
            continue
        try:
            ev = json.loads(payload.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            torn += 1
            continue
        if isinstance(ev, dict):
            records.append((seq, ev))
        else:
            torn += 1
    records.sort(key=lambda r: r[0])
    return FlightSnapshot(path, meta, [ev for _, ev in records],
                          torn, last_seq)
