"""Block-sparse attention: the host half, the dense-mask reference and the
factory.

Counterpart of deeperspeed_tpu/ops/sparse_attention/kernels.py. The
reference computes block-sparse softmax(Q K^T * scale) V, with the fp32
logsumexp saved for a flash-2 backward, through two Pallas kernel pairs: a
streaming pair over a flat LUT (``_bs_fwd``/``_bs_bwd``) and a pair that
pins whole-S K and V in VMEM and walks 4 x 4 "super-tiles" through a bitmap
LUT (``_bs_fwd_res``/``_bs_bwd_res``), plus a ``split`` route that strips
strided global columns into a gathered dense pass. ``impl="auto"`` picks
among them with a TPU cost model (a 3 MB VMEM budget and ~6 us of scalar
work per loop iteration). On Hopper the four kernels are one hand-written
CUDA pair (``block_sparse.py`` over ``csrc/sparse_attention.cu``) that
walks each row's active blocks through CSR look-up tables built here, so
the routes and their cost model have no counterpart: every ``impl`` value
launches the one pair.

Here:
  ``build_lut``, ``layout_density``: the reference's exports.
  ``causal_layout``: the one causal filter, applied to the block layout
      before both CSR tables are built, so the dQ table and the dK/dV
      table can never disagree.
  ``build_csr_lut``: per head, the row offsets and active k-block ids of
      every q-block row, and the transposed table (the active q-blocks of
      every k-block) for dK/dV.
  ``build_groups``: the bf16 backward's work list. One warp of the CUDA
      kernel owns a 16-row tile; tiles of one head whose block lists are
      identical are grouped four at a time, so that the four warps of a
      thread block share every gathered tile, and the groups are ordered
      longest list first.
  ``SparseLut``: those tables for one (layout, block, causal), copied to a
      device once and kept there, so a call does no host work and no sync.
  ``block_sparse_attention_xla``: the dense-mask reference with the
      ``any_visible`` zero-row rule, in PyTorch.
  ``make_block_sparse_attention``: the factory, with the reference's
      arguments and errors; it returns a function on (B, S, H, Dh).
"""

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

NEG_INF = -1e30
IMPLS = ("auto", "resident", "stream", "split")


def build_lut(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """layout (H, nb, nb) 0/1 -> (cols (H, nb, width), counts (H, nb)).

    cols[h, qb, :counts[h, qb]] are the active k-block indices of q-block row
    qb (ascending); padding entries repeat the last valid index so kernel
    loads stay in bounds."""
    H, nb, _ = layout.shape
    counts = layout.sum(axis=2).astype(np.int32)
    width = max(1, int(counts.max()))
    cols = np.zeros((H, nb, width), np.int32)
    for h in range(H):
        for qb in range(nb):
            (idx,) = np.nonzero(layout[h, qb])
            if len(idx):
                cols[h, qb, : len(idx)] = idx
                cols[h, qb, len(idx):] = idx[-1]
    return cols, counts


def layout_density(layout: np.ndarray) -> float:
    return float(layout.mean())


def causal_layout(layout: np.ndarray, causal: bool) -> np.ndarray:
    """The (H, nb, nb) bool layout with, under ``causal``, every block above
    the diagonal dropped: the one causal filter both tables derive from."""
    lay = np.asarray(layout) != 0
    if causal:
        nb = lay.shape[1]
        lay = lay & np.tril(np.ones((nb, nb), bool))[None]
    return lay


def _csr(lay: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets (H * nb + 1,), ids (nnz,)) int32: row r of head h holds
    ids[offsets[h * nb + r]:offsets[h * nb + r + 1]], ascending."""
    H, nb, _ = lay.shape
    counts = lay.reshape(H * nb, nb).sum(axis=1)
    offsets = np.zeros(H * nb + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    ids = np.nonzero(lay.reshape(H * nb, nb))[1]
    return offsets.astype(np.int32), ids.astype(np.int32)


def build_csr_lut(layout: np.ndarray, causal: bool
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(row_offsets, row_cols, col_offsets, col_rows) of the causally
    filtered layout: the active k-blocks of each (head, q-block) for the
    forward and dQ, and the active q-blocks of each (head, k-block) for
    dK/dV. Offsets are (H * nb + 1,) int32, ids (nnz,) int32."""
    lay = causal_layout(layout, causal)
    row_offsets, row_cols = _csr(lay)
    col_offsets, col_rows = _csr(lay.transpose(0, 2, 1))
    return row_offsets, row_cols, col_offsets, col_rows


TILE_ROWS = 16    # rows of a warp's tile in the bf16 backward (mma's m16)
GROUP_TILES = 4   # tiles of a group: the warps of one thread block


def build_groups(lay: np.ndarray, block: int, offsets: np.ndarray,
                 ids: np.ndarray) -> np.ndarray:
    """The groups of the bf16 backward over the CSR table (``offsets``,
    ``ids``) of the (H, nb, nb) bool ``lay`` (``_csr(lay)``; the transposed
    layout and its table for dK/dV): (n, GROUP_TILES + 2) int32 rows of
    GROUP_TILES tile ids (h * nb * block / 16 + the tile's index in its
    head; -1 where a group has fewer tiles), then the offset and the length
    of the group's block list in ``ids``. The 16-row tiles of one head
    whose rows have identical lists are grouped in ascending order, every
    tile exactly once; the groups run longest list first (a stable sort),
    so the heaviest start in the first wave."""
    if block % TILE_ROWS:
        raise ValueError(f"groups take blocks that are a multiple of "
                         f"{TILE_ROWS}, got {block}")
    H, nb, _ = lay.shape
    per = block // TILE_ROWS
    ntiles = nb * per
    rows = []
    for h in range(H):
        lists: Dict[bytes, list] = {}
        for r in range(nb):
            lo, hi = int(offsets[h * nb + r]), int(offsets[h * nb + r + 1])
            entry = lists.setdefault(ids[lo:hi].tobytes(), [lo, hi - lo, []])
            first = h * ntiles + r * per
            entry[2].extend(range(first, first + per))
        for lo, n, tiles in lists.values():
            for i in range(0, len(tiles), GROUP_TILES):
                chunk = tiles[i:i + GROUP_TILES]
                rows.append(chunk + [-1] * (GROUP_TILES - len(chunk))
                            + [lo, n])
    groups = np.asarray(rows, np.int32).reshape(-1, GROUP_TILES + 2)
    return groups[np.argsort(-groups[:, -1], kind="stable")]


class DeviceLut(NamedTuple):
    """A ``SparseLut`` on one device: the filtered layout (H, nb, nb) bool
    (the plain versions expand it), the four CSR tables and the dQ and
    dK/dV groups of the bf16 backward (``build_groups``), int32."""
    layout: torch.Tensor
    row_offsets: torch.Tensor
    row_cols: torch.Tensor
    col_offsets: torch.Tensor
    col_rows: torch.Tensor
    q_groups: torch.Tensor
    kv_groups: torch.Tensor
    block: int


class SparseLut:
    """The CSR tables and the backward's groups of one (layout, block,
    causal), built on the host once and copied to each device at its first
    call. A block the kernels do not take gets no groups (the kernel
    wrappers refuse it)."""

    def __init__(self, layout: np.ndarray, block: int, causal: bool):
        self.block = int(block)
        self.causal = bool(causal)
        self.layout = causal_layout(layout, causal)
        self.active_blocks = int(self.layout.sum())
        self._tables = build_csr_lut(self.layout, False)
        row_offsets, row_cols, col_offsets, col_rows = self._tables
        if self.block % TILE_ROWS == 0:
            self.groups = (
                build_groups(self.layout, self.block, row_offsets, row_cols),
                build_groups(self.layout.transpose(0, 2, 1), self.block,
                             col_offsets, col_rows))
        else:
            empty = np.zeros((0, GROUP_TILES + 2), np.int32)
            self.groups = (empty, empty)
        self._on: Dict[torch.device, DeviceLut] = {}

    def on(self, device) -> DeviceLut:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        lut = self._on.get(device)
        if lut is None:
            lut = DeviceLut(
                torch.from_numpy(self.layout).to(device),
                *(torch.from_numpy(t).to(device)
                  for t in self._tables + self.groups),
                self.block)
            self._on[device] = lut
        return lut


def dense_mask(layout, block: int, S: int, causal: bool, device
               ) -> torch.Tensor:
    """The (H, S, S) bool mask of a block layout (numpy or tensor) cut to S,
    under ``causal`` also lower-triangular, built on ``device``."""
    if not isinstance(layout, torch.Tensor):
        layout = torch.from_numpy(np.asarray(layout) != 0)
    lay = layout.to(device=device, dtype=torch.bool)
    mask = lay.repeat_interleave(block, 1).repeat_interleave(block, 2)
    mask = mask[:, :S, :S]
    if causal:
        mask = mask & torch.ones(S, S, dtype=torch.bool, device=device).tril()
    return mask


def block_sparse_attention_xla(q, k, v, layout, block: int,
                               causal: bool = False, sm_scale: float = None,
                               key_padding_mask=None):
    """Dense-mask reference on (B, S, H, Dh), the counterpart of the
    reference's function of the same name: scores in q's dtype then fp32,
    masked to NEG_INF, plus the optional (B, S) additive
    ``key_padding_mask`` (0 keep / large negative drop, the reference
    softmax's 'add' mode); a key whose mask is <= NEG_INF / 2 counts as not
    visible, and a row with no visible key outputs 0."""
    B, S, H, Dh = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(Dh)
    mask = dense_mask(layout, block, S, causal, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    s = s.masked_fill(~mask[None], NEG_INF)
    visible = mask[None]  # (1, H, Sq, Sk)
    if key_padding_mask is not None:
        kpm = torch.as_tensor(key_padding_mask, device=q.device).float()
        s = s + kpm[:, None, None, :]
        visible = visible & (kpm > NEG_INF / 2)[:, None, None, :]
    # rows with no visible key: output 0 (the kernels' l == 0 rule)
    any_visible = visible.any(dim=-1)  # (B|1, H, Sq)
    p = torch.softmax(s, dim=-1)
    p = p.masked_fill(~any_visible[..., None], 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)


def make_block_sparse_attention(layout: np.ndarray, block: int,
                                causal: bool = False, sm_scale: float = None,
                                interpret: bool = False, impl: str = "auto"):
    """Block-sparse attention for a FIXED layout, differentiable.

    layout: (H, nb, nb) 0/1 numpy array; returns fn(q, k, v) on (B, S, H, Dh)
    with S == nb * block, raising the reference's errors on another head
    count or length. The CSR tables are built once here and copied to a
    device at its first call.

    ``impl`` keeps the reference's four values (auto, resident, stream,
    split). They name the reference's TPU routes, which differ only in how
    the TPU's VMEM holds K and V; on Hopper all four launch the one CUDA
    pair (``sparse_fwd``/``sparse_bwd``), which takes every layout. On a
    CPU tensor the pair's wrappers take their plain versions.
    ``interpret=True`` computes the plain versions on any device, the
    counterpart of the reference's interpret mode, which runs the kernels'
    semantics without the hardware."""
    from . import block_sparse

    layout = np.asarray(layout)
    H, nb, _ = layout.shape
    if impl not in IMPLS:
        raise ValueError(
            f"impl must be auto|resident|stream|split, got {impl!r}")
    lut = SparseLut(layout, block, causal)

    def checked(q, k, v):
        B, S, Hq, Dh = q.shape
        if Hq != H:
            raise ValueError(f"layout built for {H} heads, got {Hq}")
        if S != nb * block:
            raise ValueError(
                f"layout built for seq len {nb * block} (block {block}), got {S}"
            )
        scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(Dh)
        t = lambda x: x.transpose(1, 2).contiguous()
        o = block_sparse.sparse_attention_bhsd(
            t(q), t(k), t(v), lut.on(q.device), scale, causal,
            plain=interpret)
        return o.transpose(1, 2)

    return checked
