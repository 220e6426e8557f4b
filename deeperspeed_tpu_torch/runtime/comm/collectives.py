"""The collectives of the mesh's axes over one process group.

The reference's collectives run inside ``shard_map`` over a mesh axis;
the port calls ``torch.distributed`` on the group the mesh gives, with the
backend the caller built the world with. NCCL takes CUDA tensors as they
are. gloo takes only host tensors, so where the group is gloo and a
tensor lies on CUDA (several ranks sharing one card, which NCCL refuses)
the payload is copied explicitly through a pinned host buffer, the
collective runs on the host copy, and the result is copied back to the
card. That is the transport, not a fallback: everything computed on the
payload (quantize, dequantize, sums) stays on the card. The copies are
blocking, so each pinned buffer, kept per shape and dtype, can be reused
at once.

Every function takes and returns tensors on the caller's device; with no
group (a world of one rank) each is the identity. Besides the data
axes' collectives, tensor parallelism (parallel/tp.py) uses the sum and
the gather, and ring attention (ops/ring_attention.py) the point-to-point
``ring_shift``.
"""

import functools
import time
from typing import Dict, Tuple

import torch
import torch.distributed as dist

__all__ = ["Transport"]


def _clocked(fn):
    """Count the collective's wall seconds in ``Transport.seconds``. A
    host-staged collective first waits for the card's stream (its copy
    would wait there anyway), so the seconds are the transfer's own."""
    @functools.wraps(fn)
    def call(self, t, *args, **kwargs):
        if self.group is None:
            return fn(self, t, *args, **kwargs)
        if self._stages(t):
            torch.cuda.current_stream(t.device).synchronize()
        t0 = time.perf_counter()
        try:
            return fn(self, t, *args, **kwargs)
        finally:
            self.seconds += time.perf_counter() - t0
    return call


class Transport:
    """Collectives over ``group`` (None: one rank, no collective)."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        self.backend = (dist.get_backend(group) if group is not None
                        else None)
        self._pinned: Dict[Tuple, torch.Tensor] = {}
        # bytes staged through host memory, both ways (read by the engine's
        # step breakdown), and the collectives' wall seconds
        self.staged_bytes = 0
        self.seconds = 0.0

    def _stages(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def _buffer(self, role: str, shape, dtype) -> torch.Tensor:
        key = (role, tuple(shape), dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _to_host(self, t: torch.Tensor, role: str) -> torch.Tensor:
        if not self._stages(t):
            return t.contiguous()
        buf = self._buffer(role, t.shape, t.dtype)
        buf.copy_(t)
        self.staged_bytes += t.numel() * t.element_size()
        return buf

    def _out(self, like: torch.Tensor, shape, role: str) -> torch.Tensor:
        if self._stages(like):
            return self._buffer(role, shape, like.dtype)
        return torch.empty(shape, dtype=like.dtype, device=like.device)

    def _back(self, out: torch.Tensor, device) -> torch.Tensor:
        if out.device == device:
            return out
        self.staged_bytes += out.numel() * out.element_size()
        return out.to(device)

    # ------------------------------------------------------------------ #

    @_clocked
    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum over the group, the same bits on every
        rank (a new tensor)."""
        if self.group is None:
            return t.clone()
        host = self._to_host(t, "ar")
        if host is t:
            host = t.clone()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=self.group)
        return host.to(t.device, copy=True)

    @_clocked
    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """(size, n) rows in: row j goes to rank j. Out: (size, n), row j
        the row rank j sent here."""
        if self.group is None:
            return t.clone()
        host = self._to_host(t, "a2a_in")
        out = self._out(t, t.shape, "a2a_out")
        dist.all_to_all_single(out, host, group=self.group)
        return self._back(out, t.device)

    @_clocked
    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked: (size, *t.shape), rank order."""
        if self.group is None:
            return t[None].clone()
        host = self._to_host(t.reshape(-1), "ag_in")
        out = self._out(t, (self.size * t.numel(),), "ag_out")
        dist.all_gather_into_tensor(out, host, group=self.group)
        return self._back(out, t.device).reshape((self.size,) + t.shape)

    @_clocked
    def gather(self, t: torch.Tensor, dst: int = 0):
        """Every rank's ``t`` stacked on group rank ``dst``: (size,
        *t.shape), rank order; None on the other ranks."""
        if self.group is None:
            return t[None].clone()
        host = self._to_host(t, "g_in")
        outs = ([torch.empty_like(host) for _ in range(self.size)]
                if self.rank == dst else None)
        dist.gather(host, gather_list=outs,
                    dst=dist.get_global_rank(self.group, dst),
                    group=self.group)
        if outs is None:
            return None
        return self._back(torch.stack(outs), t.device)

    @_clocked
    def reduce_scatter_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the group of the flat ``t``, chunk ``rank`` of
        ``size`` equal chunks."""
        if self.group is None:
            return t.clone()
        host = self._to_host(t.reshape(-1), "rs_in")
        out = self._out(t, (t.numel() // self.size,), "rs_out")
        dist.reduce_scatter_tensor(out, host, op=dist.ReduceOp.SUM,
                                   group=self.group)
        return self._back(out, t.device)

    @_clocked
    def ring_shift(self, t: torch.Tensor, step: int = 1) -> torch.Tensor:
        """Send ``t`` to the rank ``step`` places on along the group and
        receive from the rank ``step`` places back: the ring rotation of
        ring attention (``step`` -1 turns it the other way). Both go out
        together (``batch_isend_irecv``), so a ring of two ranks that
        send to each other cannot deadlock."""
        if self.group is None:
            return t.clone()
        host = self._to_host(t, "ring_in")
        out = self._out(t, t.shape, "ring_out")
        dst = dist.get_global_rank(self.group, (self.rank + step) % self.size)
        src = dist.get_global_rank(self.group, (self.rank - step) % self.size)
        ops = [dist.P2POp(dist.isend, host, dst, group=self.group),
               dist.P2POp(dist.irecv, out, src, group=self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return self._back(out, t.device)

    def barrier(self):
        if self.group is not None:
            dist.barrier(group=self.group)
