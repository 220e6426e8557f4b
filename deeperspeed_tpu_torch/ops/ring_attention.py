"""Context / sequence parallelism: ring attention and Ulysses all-to-all.

Counterpart of deeperspeed_tpu/ops/ring_attention.py. Sequences are split
over the mesh's sequence-parallel axis (``seq`` on a legacy mesh, ``sp``
on a canonical one) in order: rank i of the axis holds tokens
``[i * S/P, (i + 1) * S/P)`` of every row. The reference writes both
strategies against a bare axis name inside ``shard_map``; the port's
functions take this rank's chunks and the axis's ``Transport``
(runtime/comm/collectives.py), and its collectives are autograd
Functions whose backward is the reference's transpose.

* ``ring_attention``: K/V chunks rotate around the axis (rank r sends to
  r + 1 and receives from r - 1, one ``ring_shift`` a step for K and V
  together; the backward rotates the other way) while each rank keeps
  its Q chunk, combining the chunks with the online-softmax recurrence
  of ``_chunk_attend``. Causal masking is chunk-granular, as the
  reference's: a source chunk older than the local Q chunk is fully
  visible, the diagonal chunk takes the triangular mask, a newer one is
  masked whole by the finite ``_NEG``. ``_chunk_attend`` is plain torch
  matmuls, as the reference's is plain ``einsum`` outside any kernel.
* ``ulysses_attention``: an all-to-all re-splits (B, S/P, H, Dh) into
  (B, S, H/P, Dh), attention runs over the full sequence on this rank's
  heads (``_local_causal_attention``: ``models.gpt.causal_attention``
  "auto", which on a Hopper card is the flash kernel, as the reference's
  calls its Pallas flash kernel), and an all-to-all splits it back.
* ``make_context_parallel_attention(mesh, strategy)`` binds either to the
  mesh's sequence-parallel group; it refuses a mesh without a live
  sequence axis, as the reference does.
"""

import math
from typing import Optional

import torch

from ..parallel.topology import DATA_AXIS, MODEL_AXIS, SEQ_AXIS

__all__ = ["ring_attention", "ulysses_attention",
           "make_context_parallel_attention"]

_NEG = -1e30  # finite -inf: keeps the online softmax free of NaNs on
              # fully-masked (newer) chunks


class _RingShift(torch.autograd.Function):
    """Rank r's tensor to rank r + step of the group; the backward sends
    the grad back the other way (the reference's ppermute transpose)."""

    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        return group.ring_shift(x.contiguous(), step)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.ring_shift(g.contiguous(), -ctx.step), None, None


class _AllToAll(torch.autograd.Function):
    """``(size, ...)`` blocks: block j goes to rank j, and block i of the
    result came from rank i. Its own adjoint."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x, group):
    shape = x.shape
    return group.all_to_all(x.contiguous().reshape(shape[0], -1)).reshape(
        shape)


def _chunk_attend(q, k, v, o, l, m, mask):
    """One online-softmax accumulation step.

    q (B,Sq,H,D); k,v (B,Sk,H,D); o (B,Sq,H,D) f32; l,m (B,H,Sq) f32;
    mask None | (Sq,Sk) bool."""
    dh = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    s = s / math.sqrt(dh)
    if mask is not None:
        s = torch.where(mask[None, None, :, :], s, _NEG)
    m_chunk = s.amax(dim=-1)  # (B,H,Sq)
    m_new = torch.maximum(m, m_chunk)
    p = torch.exp(s - m_new[..., None])
    # rows where everything so far (this chunk too) is masked: m_new == _NEG
    p = torch.where((m_new == _NEG)[..., None], 0.0, p)
    corr = torch.exp(m - m_new)
    corr = torch.where(m == _NEG, 0.0, corr)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v).float()
    o_new = o * corr.transpose(1, 2)[..., None] + pv
    return o_new, l_new, m_new


def ring_attention(q, k, v, group, causal: bool = True):
    """Attention over sequence chunks split over ``group`` (a Transport).

    q, k, v: this rank's chunks (B, S_local, H, Dh), the sequence split in
    rank order. Returns this rank's output chunk."""
    p_size, my = group.size, group.rank
    B, Sq, H, Dh = q.shape
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), _NEG, dtype=torch.float32, device=q.device)
    tri = (torch.ones(Sq, Sq, dtype=torch.bool, device=q.device).tril()
           if causal else None)
    none = (torch.zeros(Sq, Sq, dtype=torch.bool, device=q.device)
            if causal else None)
    kv = torch.stack([k, v])
    # after t rotations this rank holds the chunk rank (my - t) mod p
    # started with
    for t in range(p_size):
        src = (my - t) % p_size
        if not causal or src < my:
            mask = None          # fully visible
        elif src == my:
            mask = tri           # the diagonal: causal within the chunk
        else:
            mask = none          # newer: masked whole
        o, l, m = _chunk_attend(q, kv[0], kv[1], o, l, m, mask)
        if t + 1 < p_size:
            kv = _RingShift.apply(kv, group, 1)
    l = l.clamp_min(1e-30)  # fully-masked rows (none for causal chunks)
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def ulysses_attention(q, k, v, group, causal: bool = True, attn_fn=None):
    """DeepSpeed-Ulysses sequence parallelism over ``group``: this rank's
    chunks (B, S/P, H, Dh) -> all-to-all -> (B, S, H/P, Dh) -> attention
    over the full sequence -> all-to-all back. H must be a multiple of the
    group's size."""
    p_size = group.size
    B, Sl, H, Dh = q.shape
    if H % p_size:
        raise ValueError(
            f"Ulysses attention splits the {H} heads of this rank over the "
            f"{p_size} ranks of the sequence axis: not divisible (under "
            f"tensor parallelism the heads are already n_head / tp)")

    def to_heads(x):
        # head block j to rank j; the sequence chunks come back in order
        blocks = x.reshape(B, Sl, p_size, H // p_size, Dh).permute(
            2, 0, 1, 3, 4)
        got = _AllToAll.apply(blocks, group)  # (P, B, Sl, H/P, Dh)
        return got.permute(1, 0, 2, 3, 4).reshape(B, p_size * Sl,
                                                  H // p_size, Dh)

    def to_seq(x):
        blocks = x.reshape(B, p_size, Sl, H // p_size, Dh).permute(
            1, 0, 2, 3, 4)
        got = _AllToAll.apply(blocks, group)  # (P, B, Sl, H/P, Dh)
        return got.permute(1, 2, 0, 3, 4).reshape(B, Sl, H, Dh)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    if attn_fn is None:
        o = _local_causal_attention(qh, kh, vh, causal)
    else:
        o = attn_fn(qh, kh, vh)
    return to_seq(o)


def _local_causal_attention(q, k, v, causal: bool):
    """Attention on this rank's heads for the Ulysses path: causal goes
    through ``models.gpt.causal_attention`` "auto" (the flash kernel on a
    Hopper card, dense elsewhere); non-causal is dense."""
    if causal:
        from ..models.gpt import causal_attention

        return causal_attention(q, k, v, "auto")
    dh = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(dh)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def make_context_parallel_attention(
    mesh,
    strategy: str = "ring",
    causal: bool = True,
    batch_axis: Optional[str] = DATA_AXIS,
    head_axis: Optional[str] = MODEL_AXIS,
    seq_axis: str = SEQ_AXIS,
):
    """Ring or Ulysses attention over ``mesh``'s sequence axis: returns
    ``fn(q, k, v)`` taking and returning this rank's chunks (B/dp, S/sp,
    H/tp, Dh); the batch and head splits are the caller's (each rank
    passes its rows and heads). Axis names resolve through the rule
    table, so the legacy ``seq`` binds to a canonical mesh's ``sp``."""
    assert strategy in ("ring", "ulysses"), strategy
    from ..parallel.tp import axis_transport
    from ..sharding.rules import translate_spec

    spec = translate_spec((batch_axis, seq_axis, head_axis, None), mesh)
    resolved_seq = spec[1] if spec is not None else None
    if resolved_seq is None:
        # a user who asked for context parallelism gets it, or an error
        raise ValueError(
            f"{strategy} attention needs a mesh with a '{seq_axis}' (or "
            f"'sp') axis of size > 1; got mesh axes "
            f"{dict(mesh.shape) if mesh is not None else None}")
    group = axis_transport(mesh, resolved_seq)
    inner = ring_attention if strategy == "ring" else ulysses_attention

    def attend(q, k, v):
        return inner(q, k, v, group, causal=causal)

    return attend
