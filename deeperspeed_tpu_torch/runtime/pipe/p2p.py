"""Point-to-point messages between pipeline stages.

The port's own module: where the reference's single controller moves a
stage's output with a ``device_put`` between sub-meshes, each stage of
the port is a process, and an activation (or its gradient) travels as a
message over the process group of one pipe edge.

A message is a flat tree of tensors (one tensor, or a tuple or list of
tensors and Nones) in two sends: a small int64 header (the tree's kind,
each leaf's dtype and shape, the payload's bytes), then one uint8
payload holding every leaf's bytes. The header is read before each
receive, so the shapes may change from message to message (the serving
bridge's ``inference_batch`` grows S by one a token). The bytes travel
as bytes whatever the dtype, so gloo carries bf16 as it is.

Over gloo a CUDA leaf is copied to the host first; that copy is
synchronous, so the stream has finished writing the leaf before the send
reads it, and a received payload is copied back to the device. Over
NCCL the payload stays on the device. Sends are ``isend``: ``send``
returns a handle that keeps the buffers alive until ``wait``; receives
block. Messages on one edge and direction arrive in the order they were
sent, which is what pairs a stage's sends with its neighbour's receives
(the schedules' per-edge FIFO order).
"""

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Pending", "send", "recv", "broadcast", "wait_all",
           "HEADER_SLOTS"]

HEADER_SLOTS = 64
_KIND_TENSOR, _KIND_TUPLE, _KIND_LIST = 0, 1, 2
_NONE = -1
_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.float64,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool]
_CODE = {dt: i for i, dt in enumerate(_DTYPES)}


def _flatten(tree):
    if isinstance(tree, torch.Tensor):
        return _KIND_TENSOR, [tree]
    if isinstance(tree, (tuple, list)):
        for t in tree:
            if t is not None and not isinstance(t, torch.Tensor):
                raise TypeError(f"a pipe message holds tensors and Nones, "
                                f"not {type(t).__name__}")
        return (_KIND_TUPLE if isinstance(tree, tuple) else _KIND_LIST,
                list(tree))
    raise TypeError(f"a pipe message is a tensor or a tuple/list of "
                    f"tensors, not {type(tree).__name__}")


def _header(kind, leaves) -> torch.Tensor:
    h = [kind, len(leaves)]
    nbytes = 0
    for t in leaves:
        if t is None:
            h += [_NONE, 0]
            continue
        if t.dtype not in _CODE:
            raise TypeError(f"no pipe message code for {t.dtype}")
        h += [_CODE[t.dtype], t.dim(), *t.shape]
        nbytes += _padded(t.numel() * t.element_size())
    h = [nbytes] + h
    if len(h) > HEADER_SLOTS:
        raise ValueError(f"a pipe message of {len(leaves)} leaves needs a "
                         f"header of {len(h)} slots (at most "
                         f"{HEADER_SLOTS})")
    out = torch.zeros(HEADER_SLOTS, dtype=torch.int64)
    out[:len(h)] = torch.tensor(h, dtype=torch.int64)
    return out


def _parse(header: torch.Tensor):
    h = header.tolist()
    nbytes, kind, n = h[0], h[1], h[2]
    pos, specs = 3, []
    for _ in range(n):
        code, ndim = h[pos], h[pos + 1]
        pos += 2
        if code == _NONE:
            specs.append(None)
            continue
        specs.append((_DTYPES[code], tuple(h[pos:pos + ndim])))
        pos += ndim
    return nbytes, kind, specs


def _padded(n: int) -> int:
    """A leaf's bytes in the payload: rounded up to 8, so every leaf
    starts where its dtype may be viewed."""
    return -(-n // 8) * 8


def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _payload(leaves, host: bool, device) -> torch.Tensor:
    parts = []
    for t in leaves:
        if t is None or not t.numel():
            continue
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        parts.append(b)
        pad = _padded(b.numel()) - b.numel()
        if pad:
            parts.append(b.new_zeros(pad))
    if not parts:
        return torch.empty(0, dtype=torch.uint8,
                           device="cpu" if host else device)
    flat = torch.cat(parts) if len(parts) > 1 else parts[0].clone()
    # a synchronous copy: the stream has written every leaf when it ends
    return flat.cpu() if host else flat.to(device)


class Pending:
    """The work handles of one ``send`` and the buffers they read, kept
    until ``wait``."""

    def __init__(self, works, buffers):
        self.works = works
        self.buffers = buffers

    def wait(self):
        for w in self.works:
            w.wait()
        self.works, self.buffers = [], []


def send(tree, dst: int, group, device=None) -> Pending:
    """Start sending ``tree`` to global rank ``dst`` over ``group``."""
    kind, leaves = _flatten(tree)
    device = device or next((t.device for t in leaves if t is not None),
                            torch.device("cpu"))
    host = _staged(group)
    header = _header(kind, leaves)
    if not host:
        header = header.to(device)
    payload = _payload(leaves, host, device)
    works = [dist.isend(header, dst, group=group)]
    if payload.numel():
        works.append(dist.isend(payload, dst, group=group))
    return Pending(works, [header, payload])


def _unpack(payload, kind, specs, device):
    out, off = [], 0
    for spec in specs:
        if spec is None:
            out.append(None)
            continue
        dt, shape = spec
        n = int(np.prod(shape, dtype=np.int64)) * torch.empty(
            (), dtype=dt).element_size()
        t = payload[off:off + n].view(dt).reshape(shape)
        off += _padded(n)
        out.append(t.to(device) if t.device != torch.device(device)
                   else t)
    if kind == _KIND_TENSOR:
        return out[0]
    return tuple(out) if kind == _KIND_TUPLE else out


def recv(src: int, group, device):
    """Receive one message from global rank ``src`` over ``group``
    (blocking); its tensors on ``device``."""
    host = _staged(group)
    header = torch.empty(HEADER_SLOTS, dtype=torch.int64,
                         device="cpu" if host else device)
    dist.recv(header, src, group=group)
    nbytes, kind, specs = _parse(header.cpu())
    payload = torch.empty(nbytes, dtype=torch.uint8,
                          device="cpu" if host else device)
    if nbytes:
        dist.recv(payload, src, group=group)
    return _unpack(payload, kind, specs, device)


def broadcast(tree, src: int, group, device):
    """``tree`` of global rank ``src`` on every rank of ``group`` (the
    other ranks pass None)."""
    if group is None:
        return tree
    host = _staged(group)
    rank = dist.get_rank()
    if rank == src:
        kind, leaves = _flatten(tree)
        header = _header(kind, leaves)
    else:
        header = torch.empty(HEADER_SLOTS, dtype=torch.int64)
    if not host:
        header = header.to(device)
    dist.broadcast(header, src, group=group)
    nbytes, kind, specs = _parse(header.cpu())
    if rank == src:
        payload = _payload(leaves, host, device)
    else:
        payload = torch.empty(nbytes, dtype=torch.uint8,
                              device="cpu" if host else device)
    if nbytes:
        dist.broadcast(payload, src, group=group)
    if rank == src:
        return tree
    return _unpack(payload, kind, specs, device)


def wait_all(pending: List[Optional[Pending]]) -> None:
    for p in pending:
        if p is not None:
            p.wait()
    pending.clear()
