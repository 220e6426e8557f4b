"""The port's bias+GeLU kernels, as far as the CPU can reach them: the launch
plans of ``bias_gelu_fwd`` and ``bias_gelu_bwd`` over every width they
take, and a plain-torch emulation of what the CUDA kernels compute (the
tanh form through sigmoid(2 z), and db added in the kernels' fixed order:
each lane over its rows, the block's warps in a tree, the row groups'
partial rows by the reduction's groups and tree) against the JAX
reference's Pallas kernels in interpret mode.

The CUDA kernels themselves are held against their plain versions on the
card by tests/test_torch_cuda.py and by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops.pallas import fused_blocks as jax_fb
from deeperspeed_tpu_torch.ops import fused_blocks as fb

torch.set_num_threads(1)

SMS = fb.H100_SMS
ROWS = (1, 8, 37, 2048, 16384)
# GPT-NeoX-1.3B's FFN (tanh), BERT-large's FFN and MLM head (erf),
# GPT-NeoX-125M's FFN (data parallel), GPT-NeoX-20B's FFN, serving's decode
MODEL_SHAPES = ((2048, 8192), (8192, 4096), (4096, 1024), (16384, 3072),
                (2048, 24576), (8, 8192), (48, 24576))


def _vec(dtype):
    return 16 // torch.tensor([], dtype=dtype).element_size()


def _check_vector_plan(plan, R, F, dtype):
    """What every vector-route plan holds: whole warps of at most 256
    threads; strips of 32 lanes x its vectors covering the row with none
    empty; row groups that each get a row; at most 4 blocks an SM; and as
    many blocks as the SMs wherever the rows and strips allow."""
    nvec = F // _vec(dtype)
    nv, strips = plan["vectors_per_lane"], plan["strips"]
    warps, groups = plan["warps_per_block"], plan["row_groups"]
    assert nv == 1
    assert strips == -(-nvec // 32)
    assert plan["threads"] == 32 * warps and 1 <= warps <= 8
    assert 1 <= groups and (groups - 1) * warps < R
    assert plan["blocks"] == strips * groups
    assert plan["blocks"] <= max(4 * SMS, strips)
    assert plan["blocks"] >= min(SMS, strips * R), (R, F, plan)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bias_gelu_fwd_plan_covers_every_admitted_width(dtype):
    """bias_gelu_fwd_plan for every F up to GPT-NeoX-20B's 24576 at 1, 8,
    37, 2048 and 16384 rows: the vector route exactly where a row is whole
    16-byte vectors, with _check_vector_plan's launch; else the scalar
    grid-stride route, at most 32 blocks an SM, no more than the elements
    need."""
    vec = _vec(dtype)
    for F in range(1, 24577):
        for R in ROWS:
            plan = fb.bias_gelu_fwd_plan(R, F, dtype)
            if F % vec:
                assert plan["route"] == "scalar", (F, plan)
                assert plan["vectors_per_lane"] == 0
                assert plan["threads"] == 256
                assert plan["row_groups"] == plan["blocks"] == min(
                    -(-R * F // 256), 32 * SMS)
                continue
            assert plan["route"] == "vector", (F, plan)
            _check_vector_plan(plan, R, F, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bias_gelu_bwd_plan_covers_every_admitted_width(dtype):
    """bias_gelu_bwd_plan for every F up to 24576 at 1, 8, 37, 2048 and
    16384 rows: the vector route (no shared-memory cap) exactly where a
    row is whole 16-byte vectors, with _check_vector_plan's launch, one
    partial row a row group, at most 0.5 MB of them wherever one row group
    fits, and no dynamic shared memory; else the scalar route, one partial
    row a block of min(R, 2 an SM), F fp32 partials in shared memory
    within 227 KB. Both: the scratch the wrapper allocates is exactly the
    partial rows, and the reduction covers every column."""
    vec = _vec(dtype)
    for F in range(1, 24577):
        for R in ROWS:
            plan = fb.bias_gelu_bwd_plan(R, F, dtype)
            assert plan["partial_rows"] == plan["row_groups"] >= 1
            assert plan["scratch_floats"] == plan["partial_rows"] * F
            assert plan["reduce_blocks"] == -(-F // 8)
            if F % vec:
                assert plan["route"] == "scalar", (F, plan)
                assert plan["blocks"] == plan["partial_rows"] == min(
                    R, 2 * SMS)
                assert plan["smem_bytes"] == 4 * F <= 232448
                continue
            assert plan["route"] == "vector", (F, plan)
            assert plan["smem_bytes"] == 0
            assert plan["scratch_floats"] <= max(fb._BG_PART_FLOATS, F)
            _check_vector_plan(plan, R, F, dtype)


def test_bias_gelu_plans_at_the_model_shapes():
    """The model shapes take the vector route and fill the SMs, serving's
    8 decode rows and 48 rows of GPT-NeoX-20B's width too; the backward's
    partial rows stay within 0.5 MB where the first port's 264 blocks wrote
    8.7 MB at F 8192; rows off a 16-byte boundary or of an odd width take
    the scalar route; the SM count scales the grid."""
    bf16 = torch.bfloat16
    for R, F in MODEL_SHAPES:
        for plan in (fb.bias_gelu_fwd_plan(R, F, bf16),
                     fb.bias_gelu_bwd_plan(R, F, bf16)):
            assert plan["route"] == "vector"
            assert min(SMS, plan["strips"] * R) <= plan["blocks"] <= 4 * SMS
            assert plan["blocks"] >= 120, (R, F, plan)
    bwd = fb.bias_gelu_bwd_plan(2048, 8192, bf16)
    assert (bwd["strips"], bwd["warps_per_block"], bwd["row_groups"]) == (
        32, 8, 16)
    assert bwd["scratch_floats"] * 4 <= 1 << 19
    decode = fb.bias_gelu_fwd_plan(8, 8192, bf16)
    assert (decode["warps_per_block"], decode["row_groups"],
            decode["blocks"]) == (1, 8, 256)
    assert fb.bias_gelu_fwd_plan(2048, 8192, bf16, aligned=False)[
        "route"] == "scalar"
    assert fb.bias_gelu_bwd_plan(2048, 8191, bf16)["route"] == "scalar"
    assert fb.bias_gelu_bwd_plan(2048, 8188, torch.float32)["route"] == \
        "vector"
    assert fb.bias_gelu_fwd_plan(2048, 8192, bf16, n_sm=66)["blocks"] <= 264


# ------------------------------------------------------------------ #
# a plain-torch emulation of the kernels' arithmetic
# ------------------------------------------------------------------ #

def _constants(dtype):
    """csrc/fused_blocks.cu's constants, rounded to ``dtype`` (fp32, as
    there; fp64 for the formulas in exact arithmetic)."""
    exact = {"sig_a": -2.0 * 0.7978845608028654 * 1.4426950408889634,
             "sig_b": -2.0 * 0.7978845608028654 * 0.044715
                      * 1.4426950408889634,
             "dz_a": 2.0 * 0.7978845608028654,
             "dz_b": 6.0 * 0.7978845608028654 * 0.044715,
             "neg_half_log2e": -0.5 * 1.4426950408889634,
             "inv_sqrt2": 0.7071067811865476,
             "inv_sqrt_2pi": 0.3989422804014327}
    if dtype == torch.float64:
        return exact
    return {k: float(np.float32(v)) for k, v in exact.items()}


def emulate_gelu(u, approximate):
    """The kernels' per-element formulas on u (fp32, or fp64 with exact
    constants): (gelu(u), gelu'(u)). The tanh form through s = sigmoid(2
    z) = 1 / (1 + 2^(u (a + b u^2))): gelu = u s, gelu' = s + u (2 dz/du)
    s (1 - s); the erf form Phi(u) + u 2^(-u^2 log2(e) / 2) / sqrt(2 pi)."""
    c = _constants(u.dtype)
    if approximate:
        u2 = u * u
        s = 1.0 / (1.0 + torch.exp2(u * (c["sig_b"] * u2 + c["sig_a"])))
        grad = u * (c["dz_b"] * u2 + c["dz_a"]) * (s * (1.0 - s)) + s
        return u * s, grad
    phi = 0.5 * (1.0 + torch.erf(u * c["inv_sqrt2"]))
    grad = (u * c["inv_sqrt_2pi"] * torch.exp2(c["neg_half_log2e"] * u * u)
            + phi)
    return 0.5 * u * (1.0 + torch.erf(u * c["inv_sqrt2"])), grad


def _reduce_partial_rows(part):
    """reduce_partial_rows: group p adds partial rows p, p + 32, ... in
    order, then a tree halves the 32 group sums."""
    red = [torch.zeros(part.shape[1]) for _ in range(32)]
    for p in range(part.shape[0]):
        red[p % 32] = red[p % 32] + part[p]
    half = 16
    while half:
        for p in range(half):
            red[p] = red[p] + red[p + half]
        half //= 2
    return red[0]


def emulate_db(d, plan):
    """db of the fp32 dx rows ``d`` (R, F) in the order ``plan``'s
    launches add them. Vector route: warp w of row group g sums rows g W +
    w + k G W (W warps, G groups) in order; the block's warps are added in
    a tree, [half, n) onto [0, n - half) with half = ceil(n / 2); scalar
    route: block k sums rows k, k + blocks, ... in order. Then the
    reduction of the partial rows."""
    R = d.shape[0]
    if plan["route"] == "scalar":
        nb = plan["partial_rows"]
        part = []
        for blk in range(nb):
            acc = torch.zeros(d.shape[1])
            for r in range(blk, R, nb):
                acc = acc + d[r]
            part.append(acc)
        return _reduce_partial_rows(torch.stack(part))
    W, G = plan["warps_per_block"], plan["row_groups"]
    part = []
    for g in range(G):
        acc = []
        for w in range(W):
            a = torch.zeros(d.shape[1])
            for r in range(g * W + w, R, G * W):
                a = a + d[r]
            acc.append(a)
        n = W
        while n > 1:
            half = (n + 1) // 2
            for w in range(n - half):
                acc[w] = acc[w] + acc[w + half]
            n = half
        part.append(acc[0])
    return _reduce_partial_rows(torch.stack(part))


def _reference(x, b, g, approximate):
    """y, dx and db of the JAX reference's Pallas bias+GeLU in interpret
    mode (its kernels, one block of all the rows), in fp32."""
    jx, jb = jnp.asarray(x), jnp.asarray(b).reshape(1, -1)

    def fn(xx, bb):
        return jax_fb._bg(xx, bb, approximate, x.shape[0], True)
    y, vjp = jax.vjp(fn, jx, jb)
    dx, db = vjp(jnp.asarray(g))
    return (np.asarray(y), np.asarray(dx), np.asarray(db).reshape(-1))


@pytest.mark.parametrize("approximate", [True, False])
def test_emulated_kernels_match_the_pallas_reference(approximate):
    """The emulated per-element formulas and fixed-order db against the
    reference's kernels in interpret mode, fp32, on inputs with |x + b| up
    to 60 (where the sigmoid saturates) and near 0: y within 2e-5, dx and
    db within 2e-4 (the reference's gradient tolerance), no NaN; db in
    the order of the vector plans (one warp a row, and 8 warps of 6 rows
    in a tree) and of the scalar route."""
    rs = np.random.RandomState(11)
    R, F = 96, 256
    x = np.concatenate([rs.uniform(-60, 60, (R // 2, F)),
                        rs.randn(R // 2, F) * 2.0]).astype(np.float32)
    b = rs.randn(F).astype(np.float32)
    g = rs.randn(R, F).astype(np.float32)
    ry, rdx, rdb = _reference(x, b, g, approximate)
    u = torch.from_numpy(x) + torch.from_numpy(b)
    y, grad = emulate_gelu(u, approximate)
    d = torch.from_numpy(g) * grad
    assert bool(torch.isfinite(y).all() and torch.isfinite(d).all())
    np.testing.assert_allclose(y.numpy(), ry, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(d.numpy(), rdx, atol=2e-4, rtol=2e-4)
    plans = [fb.bias_gelu_bwd_plan(R, F, torch.float32),
             fb.bias_gelu_bwd_plan(R, F, torch.float32, n_sm=1),
             fb.bias_gelu_bwd_plan(R, F + 1, torch.float32)]
    assert [(p["route"], p["warps_per_block"], p["row_groups"])
            for p in plans] == [("vector", 1, 96), ("vector", 8, 2),
                                ("scalar", 8, 96)]
    for plan in plans:
        db = emulate_db(d, plan)
        assert bool(torch.isfinite(db).all())
        np.testing.assert_allclose(db.numpy(), rdb, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("approximate", [True, False])
def test_emulated_formulas_equal_the_plain_versions_in_fp64(approximate):
    """The sigmoid form is the reference's tanh form in exact arithmetic:
    in fp64, over u in [-60, 60], the emulation's gelu and gelu' equal the
    plain versions' (F.gelu and _gelu_grad_f32) to rounding."""
    u = torch.linspace(-60.0, 60.0, 240001, dtype=torch.float64)
    y, grad = emulate_gelu(u, approximate)
    torch.testing.assert_close(
        y, fb.bias_gelu_fwd_plain(u, torch.zeros(1, dtype=torch.float64),
                                  approximate), atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(grad, fb._gelu_grad_f32(u, approximate),
                               atol=1e-12, rtol=1e-12)
