"""The host tables of the port's bf16 block-sparse backward
(deeperspeed_tpu_torch/ops/sparse_attention/kernels.py ``build_groups``):
for every family of the port's sparsity configs at blocks 16-128, causal
and not, the dQ groups (over the row table) and the dK/dV groups (over
the transposed table) cover every (query, key) pair of the causally
filtered layout exactly once, hold every 16-row tile exactly once, keep
one head and one block list per group, and run longest list first; the
bf16 forward walks the dQ groups, which cover every query tile once at
each length phase 11 runs, and its shared memory fits. The kernels
themselves are held to their plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 11)."""

import numpy as np
import pytest
import torch

from deeperspeed_tpu_torch.ops import sparse_attention as sa
from deeperspeed_tpu_torch.ops.sparse_attention import block_sparse, kernels

torch.set_num_threads(1)

H = 4
S = 1024
FAMILIES = {
    "dense": lambda b: sa.DenseSparsityConfig(num_heads=H, block=b),
    "fixed": lambda b: sa.FixedSparsityConfig(
        num_heads=H, block=b, different_layout_per_head=True,
        num_local_blocks=4, num_global_blocks=1,
        num_different_global_patterns=4),
    "fixed-uni": lambda b: sa.FixedSparsityConfig(
        num_heads=H, block=b, attention="unidirectional"),
    "variable": lambda b: sa.VariableSparsityConfig(
        num_heads=H, block=b, different_layout_per_head=True,
        num_random_blocks=1, local_window_blocks=[2, 3],
        global_block_indices=[0]),
    "bigbird": lambda b: sa.BigBirdSparsityConfig(
        num_heads=H, block=b, different_layout_per_head=True),
    "bslongformer": lambda b: sa.BSLongformerSparsityConfig(
        num_heads=H, block=b),
    "local": lambda b: sa.LocalSlidingWindowSparsityConfig(
        num_heads=H, block=b, num_sliding_window_blocks=3),
}


def _coverage(groups, ids, heads, nb, block):
    """How often the groups cover each (row, column) pair of each head,
    (heads, nb * block, nb * block), after checking that every tile
    appears once, each group keeps one head and ascending tiles, and the
    groups run longest list first."""
    ntiles = nb * block // kernels.TILE_ROWS
    n = nb * block
    cover = np.zeros((heads, n, n), np.int32)
    seen = []
    assert groups.dtype == np.int32
    assert groups.shape[1] == kernels.GROUP_TILES + 2
    assert np.all(np.diff(groups[:, -1]) <= 0)
    for row in groups:
        tiles = [int(t) for t in row[:kernels.GROUP_TILES] if t >= 0]
        assert tiles and tiles == sorted(tiles)
        assert list(row[len(tiles):kernels.GROUP_TILES]) == \
            [-1] * (kernels.GROUP_TILES - len(tiles))
        h = tiles[0] // ntiles
        assert all(t // ntiles == h for t in tiles)
        off, length = int(row[-2]), int(row[-1])
        for t in tiles:
            r0 = (t % ntiles) * kernels.TILE_ROWS
            for blk in ids[off:off + length]:
                cover[h, r0:r0 + kernels.TILE_ROWS,
                      blk * block:(blk + 1) * block] += 1
        seen.extend(tiles)
    assert sorted(seen) == list(range(heads * ntiles))
    return cover


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_groups_cover_the_filtered_layout_once(family, block, causal):
    lut = kernels.SparseLut(FAMILIES[family](block).make_layout(S), block,
                            causal)
    lay = lut.layout
    nb = lay.shape[1]
    expanded = np.kron(lay, np.ones((block, block), np.int32))
    row_offsets, row_cols, col_offsets, col_rows = kernels.build_csr_lut(
        lay, False)
    q_groups, kv_groups = lut.groups
    np.testing.assert_array_equal(
        q_groups, kernels.build_groups(lay, block, row_offsets, row_cols))
    cover = _coverage(q_groups, row_cols, H, nb, block)
    np.testing.assert_array_equal(cover, expanded)
    cover = _coverage(kv_groups, col_rows, H, nb, block)
    np.testing.assert_array_equal(cover, expanded.transpose(0, 2, 1))
    if causal:
        assert not np.triu(lay, 1).any()


def test_path_layout_groups_share_windows_and_run_globals_first():
    """The sparse training path's layout (fixed, block 16, 4 local blocks,
    1 global block, 4 global patterns, bidirectional): the four query
    blocks of a window share one list, so every dQ group holds four tiles;
    the key blocks of a window that no global row sees share one (groups
    of three), and a head's global key blocks, which every query block
    sees, share theirs and run first."""
    block, seq = 16, 1024
    cfg = sa.sparsity_config_from_dict(H, {
        "mode": "fixed", "block": block, "different_layout_per_head": True,
        "num_local_blocks": 4, "num_global_blocks": 1,
        "attention": "bidirectional", "horizontal_global_attention": False,
        "num_different_global_patterns": 4})
    lut = kernels.SparseLut(cfg.make_layout(seq), block, False)
    nb = seq // block
    q_groups, kv_groups = lut.groups
    assert len(q_groups) == H * nb // 4
    assert (q_groups[:, :4] >= 0).all()
    windows = nb // 4
    n_global = H * windows // 4          # 4 global key blocks a group
    assert len(kv_groups) == n_global + H * windows
    assert (kv_groups[:n_global, -1] == nb).all()
    assert (kv_groups[:n_global, :4] >= 0).all()
    assert (kv_groups[n_global:, -1] == 4).all()
    assert (kv_groups[n_global:, 3] == -1).all()


def test_device_lut_carries_the_groups():
    lut = kernels.SparseLut(FAMILIES["bigbird"](32).make_layout(256), 32,
                            True)
    dev = lut.on("cpu")
    assert dev.block == 32
    for got, want in zip((dev.q_groups, dev.kv_groups), lut.groups):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # a block the kernels do not take builds no groups (the wrappers raise)
    odd = kernels.SparseLut(FAMILIES["dense"](8).make_layout(64), 8, False)
    assert all(g.shape == (0, kernels.GROUP_TILES + 2) for g in odd.groups)
    with pytest.raises(ValueError, match="multiple of 16"):
        kernels.build_groups(odd.layout, 8, *kernels.build_csr_lut(
            odd.layout, False)[:2])


# the sparsity blocks and lengths chip_smoke.py's phase 11 runs the
# forward at (the path's S 4096, S 8192, and its small cases' 512 and 1024)
PHASE11_SEQS = (512, 1024, 4096, 8192)


@pytest.mark.parametrize("S", PHASE11_SEQS)
@pytest.mark.parametrize("block", [16, 32, 64, 128])
def test_forward_walk_covers_every_tile_once(block, S):
    """The bf16 forward walks the query groups (``lut.groups[0]``, on the
    card ``DeviceLut.q_groups``): at every block and S of phase 11, with
    the path's 16 heads, every (head, 16-row tile) is in exactly one
    group, and the group's list is each of its tiles' row of the CSR
    table, so each output row is written once, by one warp."""
    heads = 16
    for family in ("fixed", "bigbird"):
        lay = (sa.FixedSparsityConfig(num_heads=heads, block=block)
               if family == "fixed" else
               sa.BigBirdSparsityConfig(num_heads=heads, block=block))
        lut = kernels.SparseLut(lay.make_layout(S), block, False)
        row_offsets, row_cols, _, _ = kernels.build_csr_lut(lut.layout, False)
        q_groups = lut.groups[0]
        nb = S // block
        ntiles = S // kernels.TILE_ROWS
        tiles = q_groups[:, :kernels.GROUP_TILES]
        seen = np.sort(tiles[tiles >= 0])
        np.testing.assert_array_equal(seen, np.arange(heads * ntiles))
        for row in q_groups:
            off, n = int(row[-2]), int(row[-1])
            for t in row[:kernels.GROUP_TILES]:
                if t < 0:
                    continue
                h, r = divmod(int(t), ntiles)
                qb = r * kernels.TILE_ROWS // block
                lo, hi = row_offsets[h * nb + qb], row_offsets[h * nb + qb + 1]
                np.testing.assert_array_equal(row_cols[lo:hi],
                                              row_cols[off:off + n])


def test_forward_shared_memory_fits_every_admitted_length():
    """The bf16 forward's planned shared memory (its tiles and the
    group's list of S / block ids) fits a thread block's 227 KB at every
    block and head dim for S up to 65536, 8x phase 11's longest, and at
    phase 11's lengths two blocks fit an SM's 228 KB (the kernel's launch
    bound asks for two)."""
    for block in block_sparse.BLOCKS:
        for Dh in block_sparse.HEAD_DIMS:
            tiles = 5 * 64 * Dh * 2 + 4 * 64 * 4
            for S in range(block, 65536 + 1, block):
                plan = block_sparse.fwd_plan(S, block, Dh)
                assert plan["threads"] == 128
                assert plan["list_len"] == S // block
                assert plan["smem_bytes"] == tiles + 4 * (S // block)
                assert plan["fits"] and plan["smem_bytes"] <= 232448
            for S in PHASE11_SEQS:
                smem = block_sparse.fwd_plan(S, block, Dh)["smem_bytes"]
                assert 2 * (smem + 1024) <= 228 * 1024
