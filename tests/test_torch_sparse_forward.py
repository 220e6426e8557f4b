"""The bf16 block-sparse forward's walk (csrc/sparse_attention.cu,
``sparse_fwd_mma_kernel``) held against the reference on the CPU.

The CUDA kernel runs only on the card, so its order of work is emulated
here in plain torch: each query group of ``kernels.build_groups`` walks
its block list 64 keys a step, across block edges, with the online
softmax in fp32 (running max, row sum of the unrounded p) and, in bf16,
P rounded to bf16 before P V (the reference's cast, kernels.py:243-246).
The same seeded numpy inputs go through the reference's own sparse
forward: its streaming Pallas kernel in interpret mode, as
tests/test_sparse_attention.py runs it, or, for the key mask and empty
rows, which its kernels do not take, its dense-mask
``block_sparse_attention_xla``. Tolerances are the reference's flash
forward tolerances: 2e-3 with fp32 inputs, 2e-2 with bf16 ones. The
emulation is also held to the port's plain version, which the kernel is
held to on the card (tests/test_torch_cuda.py, chip_smoke.py phase 11).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops import sparse_attention as ref
from deeperspeed_tpu_torch.ops import sparse_attention as sa
from deeperspeed_tpu_torch.ops.sparse_attention import block_sparse, kernels

torch.set_num_threads(1)

STEP = 64  # keys a step of the kernel's walk
TOLS = {"float32": 2e-3, "bfloat16": 2e-2}


def emulate_fwd(q, k, v, lut, scale, kpm=None, round_p=False):
    """The kernel's walk on (B, H, S, Dh) fp32 tensors: (o, lse)."""
    B, H, S, Dh = q.shape
    ntiles = S // kernels.TILE_ROWS
    q_groups = lut.groups[0]
    _, row_cols, _, _ = kernels.build_csr_lut(lut.layout, False)
    o = torch.zeros_like(q)
    lse = torch.full((B, H, S), kernels.NEG_INF)
    for b in range(B):
        for grp in q_groups:
            tiles = [int(t) for t in grp[:kernels.GROUP_TILES] if t >= 0]
            h = tiles[0] // ntiles
            rows = torch.cat([torch.arange(16) + (t % ntiles) * 16
                              for t in tiles])
            off, n = int(grp[-2]), int(grp[-1])
            keys = torch.cat([torch.arange(lut.block) + int(i) * lut.block
                              for i in row_cols[off:off + n]]
                             ) if n else torch.zeros(0, dtype=torch.long)
            m = torch.full((len(rows),), kernels.NEG_INF)
            l = torch.zeros(len(rows))
            acc = torch.zeros(len(rows), Dh)
            for c0 in range(0, len(keys), STEP):
                pos = keys[c0:c0 + STEP]
                s = q[b, h, rows] @ k[b, h, pos].T * scale
                bias = torch.zeros(len(pos))
                if kpm is not None:
                    bias = torch.where(kpm[b, pos] > kernels.NEG_INF / 2,
                                       kpm[b, pos], -torch.inf)
                s = s + bias
                if lut.causal:
                    s = s.masked_fill(pos[None, :] > rows[:, None], -torch.inf)
                mx = torch.maximum(m, s.amax(dim=1))
                alpha = torch.exp(m - mx)
                p = torch.exp(s - mx[:, None])
                l = l * alpha + p.sum(dim=1)
                if round_p:
                    p = p.bfloat16().float()
                acc = acc * alpha[:, None] + p @ v[b, h, pos]
                m = mx
            alive = l > 0
            o[b, h, rows] = torch.where(alive[:, None],
                                        acc / l.clamp_min(1e-30)[:, None], 0.0)
            lse[b, h, rows] = torch.where(alive, m + torch.log(l.clamp_min(
                1e-30)), kernels.NEG_INF)
    return o, lse


def _inputs(seed, shape, dtype):
    """q, k, v (B, H, S, Dh) from seeded numpy, rounded to ``dtype``:
    numpy fp32 for the reference and fp32 torch tensors of the same
    values for the emulation."""
    rs = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        t = torch.from_numpy(rs.standard_normal(shape).astype(np.float32))
        if dtype == "bfloat16":
            t = t.bfloat16().float()
        out.append(t)
    return out


def _reference(q, k, v, layout, block, causal, dtype, kpm=None,
               interpret=True):
    """The reference's forward on (B, H, S, Dh) inputs: its Pallas kernel
    in interpret mode, or its dense-mask function; o (B, H, S, Dh)."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    args = [jnp.asarray(t.transpose(1, 2).numpy(), dtype=jd)
            for t in (q, k, v)]
    if interpret:
        fn = ref.make_block_sparse_attention(layout, block, causal=causal,
                                             interpret=True, impl="stream")
        out = fn(*args)
    else:
        out = ref.block_sparse_attention_xla(
            *args, layout, block, causal=causal,
            key_padding_mask=None if kpm is None else jnp.asarray(kpm.numpy()))
    return torch.from_numpy(np.array(out.astype(jnp.float32))).transpose(
        1, 2)


def _check(layout, block, causal, dtype, shape, kpm=None, interpret=True,
           seed=0):
    lut = kernels.SparseLut(layout, block, causal)
    q, k, v = _inputs(seed, shape, dtype)
    scale = shape[-1] ** -0.5
    o, lse = emulate_fwd(q, k, v, lut, scale, kpm,
                         round_p=dtype == "bfloat16")
    tol = TOLS[dtype]
    want = _reference(q, k, v, layout, block, causal, dtype, kpm, interpret)
    torch.testing.assert_close(o, want, atol=tol, rtol=tol)
    # the port's plain version, with the same rounding of P
    cast = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    po, plse = block_sparse.sparse_fwd_plain(
        q.to(cast), k.to(cast), v.to(cast), lut.layout, block, scale, causal,
        kpm)
    torch.testing.assert_close(o.to(cast).float(), po.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(lse, plse, atol=2e-3, rtol=2e-3)
    return o, lse


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_walk_matches_the_reference_kernel(causal, dtype):
    """Block 16 (four blocks a step, a step across block edges) against
    the reference's streaming kernel in interpret mode: BigBird with a
    random block per row, and causal Fixed windows of eight blocks plus a
    global column, so that lists run over two to four steps."""
    H, S, block = 2, 256, 16
    if causal:
        cfg = sa.FixedSparsityConfig(num_heads=H, block=block,
                                     num_local_blocks=8,
                                     attention="unidirectional")
    else:
        cfg = sa.BigBirdSparsityConfig(num_heads=H, block=block,
                                       different_layout_per_head=True,
                                       num_random_blocks=1)
    layout = cfg.make_layout(S)
    lists = kernels.causal_layout(layout, causal).sum(-1)
    assert lists.max() * block > 2 * STEP
    _check(layout, block, causal, dtype, (1, H, S, 64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_walk_with_a_key_mask_matches_the_reference(dtype):
    """Block 32 (two blocks a step) under a key mask that hides the last
    quarter of the keys and biases one, causal, windows of up to four
    blocks (two steps): the window rows at the end see no key, so o is 0
    and lse NEG_INF there."""
    H, S, block = 2, 512, 32
    layout = sa.LocalSlidingWindowSparsityConfig(
        num_heads=H, block=block, num_sliding_window_blocks=7,
        attention="unidirectional").make_layout(S)
    kpm = torch.zeros(2, S)
    kpm[:, 3 * S // 4:] = kernels.NEG_INF
    kpm[1, 5] = -2.5
    assert layout.sum(-1).max() * block > STEP
    o, lse = _check(layout, block, True, dtype, (2, H, S, 64), kpm,
                    interpret=False, seed=1)
    empty = lse <= kernels.NEG_INF / 2
    assert bool(empty.any())
    assert bool((o[empty] == 0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_walk_with_empty_rows_and_half_block_steps(dtype):
    """Block 128 (a step is half a block) over a layout with an empty
    block row and an empty row of one head, and block 16 at S 512 (whose
    lists reach 32 blocks), against the reference's dense-mask function:
    a row with no block gives o = 0 and lse = NEG_INF."""
    for block, S in ((128, 512), (16, 512)):
        nb = S // block
        layout = np.ones((2, nb, nb), np.int64)
        layout[:, 1] = 0
        layout[1, nb - 1] = 0
        o, lse = _check(layout, block, False, dtype, (1, 2, S, 64),
                        interpret=False, seed=2)
        assert bool((lse[:, :, block:2 * block] == kernels.NEG_INF).all())
        assert float(o[:, :, block:2 * block].abs().max()) == 0.0
