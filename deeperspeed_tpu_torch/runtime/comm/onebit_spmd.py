"""Multi-rank 1-bit Adam and LAMB: the wire path, over a process group.

Counterpart of deeperspeed_tpu/runtime/comm/onebit_spmd.py. Where
``runtime/comm/onebit.py``'s optimizers quantize the momentum in-state
(one program's view), this module is the multi-worker communication
pattern of the reference: after warmup each data-parallel rank updates
its momentum with its LOCAL gradients, 1-bit compresses it with worker
error feedback and sends sign chunk j to rank j, the "server" of that
chunk (all-to-all), which averages, re-compresses with SERVER error
feedback and all-gathers the result: about 2 x n/8 bytes on the wire a
rank instead of the ~2 x 4n of a ring fp32 all-reduce. Warmup steps run
exact data-parallel Adam (the fp32 mean of the grads).

The reference traces the step under ``shard_map`` over a mesh axis; here
every rank calls the step with the global batch (it takes its own block
of rows) over a ``torch.distributed`` group (a ``Transport``,
runtime/comm/collectives.py, or the group it wraps; None is one rank).
Each rank keeps its own rows of the error buffers: ``werr`` (n,) and
``serr`` (c,), the rows the reference shards over the data axis. The
phase is fixed per step function, as in the reference, which flips
functions at ``freeze_step``.
"""

from typing import Callable, List, NamedTuple

import torch

from .collectives import Transport
from .compressed import _l1_scale, _pack_signs, _transport, _unpack_signs

__all__ = ["OnebitCommState", "OnebitLambCommState",
           "onebit_all_reduce_2phase", "make_onebit_spmd_train_step",
           "make_onebit_lamb_spmd_train_step"]


class OnebitCommState(NamedTuple):
    """This rank's communication state: the momentum and variance (the
    same on every rank) and its rows of the worker and server
    error-feedback buffers."""
    m: torch.Tensor      # (n,) post-sync momentum
    v: torch.Tensor      # (n,) frozen after warmup
    werr: torch.Tensor   # (n,) worker error feedback
    serr: torch.Tensor   # (c,) server error feedback of this rank's chunk


def _chunk_len(n: int, W: int) -> int:
    """Per-server chunk length: ceil(n/W) rounded up to a byte of signs."""
    c = -(-n // W)
    return -(-c // 8) * 8


def _signed(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, scale, -scale)


def _mean_rows(rows: List[torch.Tensor]) -> torch.Tensor:
    """The mean of W equal-length rows, summed in rank order."""
    total = rows[0]
    for r in rows[1:]:
        total = total + r
    return total / len(rows)


def onebit_all_reduce_2phase(x: torch.Tensor, group, werr: torch.Tensor,
                             serr: torch.Tensor, W: int):
    """Two-phase error-compensated 1-bit mean over ``group``.

    x (n,) fp32 local value; werr (n,) worker error; serr (c,) server
    error of this rank's chunk. Returns (mean (n,), new_werr, new_serr),
    the mean the same bits on every rank. Wire a rank: n/8 bytes of signs
    each way plus 2W scales."""
    tr = _transport(group)
    n = x.shape[0]
    c = _chunk_len(n, W)
    corrected = x + werr
    xb = torch.nn.functional.pad(corrected, (0, W * c - n)).reshape(W, c)
    scales = torch.stack([_l1_scale(r) for r in xb])   # per-chunk L1 scale
    quant = _signed(xb, scales[:, None])
    new_werr = (xb - quant).reshape(-1)[:n]
    packed = torch.stack([_pack_signs(r)[0] for r in xb])  # (W, c/8)

    # phase 1: chunk j of every rank -> rank j ("server" for chunk j)
    recv = tr.all_to_all(packed)                           # (W, c/8)
    rscale = tr.all_to_all(scales.reshape(W, 1))[:, 0]     # (W,)
    server_avg = _mean_rows([_unpack_signs(recv[w], c) * rscale[w]
                             for w in range(W)])           # (c,)

    # phase 2: the server compresses its averaged chunk (server error
    # feedback, the reference's compensated server momentum) and
    # broadcasts it
    s_corr = server_avg + serr
    s_scale = _l1_scale(s_corr)
    new_serr = s_corr - _signed(s_corr, s_scale)
    s_packed, _ = _pack_signs(s_corr)
    all_packed = tr.all_gather(s_packed)                   # (W, c/8)
    all_scales = tr.all_gather(s_scale.reshape(1))[:, 0]   # (W,)
    full = torch.cat([_unpack_signs(all_packed[w], c) * all_scales[w]
                      for w in range(W)])[:n]
    return full, new_werr, new_serr


def tree_leaves(tree):
    """The leaves of nested dicts in sorted-key order: the order jax
    flattens (and ravels) a params tree, so the flat vector, its chunks
    and the per-leaf ratios line up with the reference's."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(first)}
    return fn(*trees)


def _flat(tree) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for t in tree_leaves(tree)])


def _unflat(flat: torch.Tensor, like):
    out, i = [], 0
    for t in tree_leaves(like):
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    it = iter(out)
    return tree_map(lambda _: next(it), like)


def _local_rows(batch, rank: int, W: int):
    """This rank's block of the global batch's rows (the reference's
    data-axis sharding of the batch)."""
    if isinstance(batch, dict):
        return {k: _local_rows(v, rank, W) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_local_rows(v, rank, W) for v in batch)
    rows = batch.shape[0] // W
    return batch[rank * rows:(rank + 1) * rows]


def _loss_and_grads(loss_fn, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    loss = loss_fn(live, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    it = iter(grads)
    return loss.detach().float(), tree_map(lambda _: next(it), params)


def _mean_loss(tr: Transport, loss: torch.Tensor) -> torch.Tensor:
    return tr.all_reduce_sum(loss.reshape(1))[0] / tr.size


def _init_state(params, W: int) -> OnebitCommState:
    n = sum(t.numel() for t in tree_leaves(params))
    dev = tree_leaves(params)[0].device
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    return OnebitCommState(
        m=zeros, v=zeros.clone(), werr=zeros.clone(),
        serr=torch.zeros(_chunk_len(n, W), dtype=torch.float32,
                         device=dev))


def make_onebit_spmd_train_step(loss_fn: Callable, optimizer, group,
                                phase: str):
    """(init_comm_state, step) for 1-bit data-parallel Adam over ``group``.

    ``optimizer`` supplies betas/eps/weight_decay (an OnebitAdam).
    ``phase`` is 'warmup' (the exact fp32 mean of the grads + full Adam)
    or 'compressed' (local momentum through the two-phase 1-bit exchange,
    the variance frozen). ``step(params, comm, batch, lr, step_idx)`` ->
    (params, comm, loss), every rank passing the global batch; step_idx
    is the 1-based global Adam step (it drives the bias correction)."""
    if phase not in ("warmup", "compressed"):
        raise ValueError(f"phase must be 'warmup'|'compressed', got {phase}")
    b1, b2 = optimizer.betas
    eps, wd = optimizer.eps, optimizer.weight_decay
    tr = _transport(group)
    W = tr.size
    freeze_t = float(max(getattr(optimizer, "freeze_step", 1), 1))

    def init_comm_state(params) -> OnebitCommState:
        return _init_state(params, W)

    @torch.no_grad()
    def _update(params, comm, g, lr, step_idx):
        p_flat = _flat(params)
        t = float(step_idx)
        bc1 = 1.0 - b1 ** t
        m, v, werr, serr = comm
        if phase == "warmup":
            g = tr.all_reduce_sum(g) / W
            m_new = b1 * m + (1.0 - b1) * g
            v_new = b2 * v + (1.0 - b2) * g * g
            v_hat = v_new / (1.0 - b2 ** t)
        else:
            m_local = b1 * m + (1.0 - b1) * g
            m_new, werr, serr = onebit_all_reduce_2phase(m_local, tr, werr,
                                                         serr, W)
            v_new = v  # frozen; its bias correction freezes with it
            v_hat = v_new / (1.0 - b2 ** freeze_t)
        upd = (m_new / bc1) / (torch.sqrt(v_hat) + eps)
        if wd:
            upd = upd + wd * p_flat
        new_flat = p_flat - lr * upd
        new_params = tree_map(lambda p, u: u.to(p.dtype), params,
                              _unflat(new_flat, params))
        return new_params, OnebitCommState(m_new, v_new, werr, serr)

    def step(params, comm: OnebitCommState, batch, lr, step_idx):
        loss, grads = _loss_and_grads(loss_fn, params,
                                      _local_rows(batch, tr.rank, W))
        new_params, comm = _update(params, comm, _flat(grads), float(lr),
                                   step_idx)
        return new_params, comm, _mean_loss(tr, loss)

    return init_comm_state, step


class OnebitLambCommState(NamedTuple):
    """The 1-bit LAMB wire state: OnebitCommState's fields plus the
    per-leaf LAMB scaling coefficients (live during warmup, FROZEN in the
    compressed phase: the reference's frozen lamb coefficients)."""
    m: torch.Tensor
    v: torch.Tensor
    werr: torch.Tensor
    serr: torch.Tensor
    ratios: torch.Tensor  # (n_leaves,) LAMB coefficients


def make_onebit_lamb_spmd_train_step(loss_fn: Callable, optimizer, group,
                                     phase: str):
    """The 1-bit LAMB wire path (the reference's
    ``make_onebit_lamb_spmd_train_step``).

    The same two-phase momentum wire as ``make_onebit_spmd_train_step``;
    the LAMB difference is the per-leaf trust ratio ||w|| / ||update||,
    LIVE during warmup and read from ``comm.ratios`` in the compressed
    phase (recomputing it from 1-bit momentum would feed quantization
    noise into the layer-wise learning rates). The caller carries
    ``comm.ratios`` across the phase flip. No bias correction, as the
    in-state OnebitLamb. ``step(params, comm, batch, lr, step_idx=None)``
    -> (params, comm, loss); step_idx is accepted for symmetry with the
    Adam wire and unused."""
    if phase not in ("warmup", "compressed"):
        raise ValueError(f"phase must be 'warmup'|'compressed', got {phase}")
    b1, b2 = optimizer.betas
    eps, wd = optimizer.eps, optimizer.weight_decay
    min_c = getattr(optimizer, "min_coeff", 0.01)
    max_c = getattr(optimizer, "max_coeff", 10.0)
    tr = _transport(group)
    W = tr.size

    def init_comm_state(params) -> OnebitLambCommState:
        base = _init_state(params, W)
        return OnebitLambCommState(
            *base, ratios=torch.ones(len(tree_leaves(params)),
                                     dtype=torch.float32,
                                     device=base.m.device))

    @torch.no_grad()
    def _update(params, comm, g, lr):
        m, v, werr, serr, ratios = comm
        if phase == "warmup":
            g = tr.all_reduce_sum(g) / W
            m_new = b1 * m + (1.0 - b1) * g
            v_new = b2 * v + (1.0 - b2) * g * g
        else:
            m_local = b1 * m + (1.0 - b1) * g
            m_new, werr, serr = onebit_all_reduce_2phase(m_local, tr, werr,
                                                         serr, W)
            v_new = v  # frozen
        upd_tree = _unflat(m_new / (torch.sqrt(v_new) + eps), params)
        new_leaves, live_ratios = [], []
        for i, (p, u) in enumerate(zip(tree_leaves(params),
                                       tree_leaves(upd_tree))):
            p32 = p.float()
            if wd:
                u = u + wd * p32
            w_norm = torch.sqrt(torch.sum(p32 * p32))
            u_norm = torch.sqrt(torch.sum(u * u))
            live = torch.where((w_norm > 0) & (u_norm > 0),
                               torch.clamp(w_norm / u_norm, min_c, max_c),
                               torch.ones_like(w_norm))
            ratio = live if phase == "warmup" else ratios[i]
            live_ratios.append(live)
            new_leaves.append((p32 - lr * ratio * u).to(p.dtype))
        it = iter(new_leaves)
        new_params = tree_map(lambda _: next(it), params)
        # warmup tracks the live ratios (the values frozen at the phase
        # flip); compressed keeps the frozen ones unchanged
        new_ratios = (torch.stack(live_ratios) if phase == "warmup"
                      else ratios)
        return new_params, OnebitLambCommState(m_new, v_new, werr, serr,
                                               new_ratios)

    def step(params, comm: OnebitLambCommState, batch, lr, step_idx=None):
        loss, grads = _loss_and_grads(loss_fn, params,
                                      _local_rows(batch, tr.rank, W))
        new_params, comm = _update(params, comm, _flat(grads), float(lr))
        return new_params, comm, _mean_loss(tr, loss)

    return init_comm_state, step
