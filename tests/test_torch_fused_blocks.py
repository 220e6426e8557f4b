"""The PyTorch port's fused LayerNorm and bias+GeLU, forward and
backward, against the JAX reference's Pallas kernels (run in interpret
mode on the CPU), and the port's "kernels" selection switch.

On the CPU the port's kernel wrappers take their plain PyTorch versions;
the CUDA kernels themselves are held against those plain versions on the
card by tests/test_torch_cuda.py and by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops import kernel_config as jax_kc
from deeperspeed_tpu.ops.pallas import fused_blocks as jax_fb
from deeperspeed_tpu_torch.ops import fused_blocks as fb
from deeperspeed_tpu_torch.ops import kernel_config as kc
from deeperspeed_tpu_torch.ops import op_builder

torch.set_num_threads(1)

TOLS = [("float32", 2e-5), ("bfloat16", 2e-2)]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype))
    t = torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype,tol", TOLS)
def test_layer_norm_matches_pallas_interpret(dtype, tol):
    rs = np.random.RandomState(0)
    jx, tx = _pair(rs.randn(4, 32, 96), dtype)
    jw, tw = _pair(rs.randn(96) * 0.1 + 1.0, "float32")
    jb, tb = _pair(rs.randn(96) * 0.1, "float32")
    with jax_kc.override(mode="fused"):
        ref = jax_fb.layer_norm(jx, jw, jb, 1e-5)
    for mode in ("off", "fused"):   # fused on a CPU tensor: plain version
        with kc.override(mode=mode):
            out = fb.layer_norm(tx, tw, tb, 1e-5)
        assert out.dtype == tx.dtype and out.shape == tx.shape
        np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)


def test_layer_norm_stats_match_pallas_kernel():
    """ln_fwd's fp32 mean and rstd are the Pallas forward's saved stats."""
    rs = np.random.RandomState(1)
    jx, tx = _pair(rs.randn(128, 64) * 3 + 1, "float32")
    jw, tw = _pair(rs.randn(64) * 0.1 + 1.0, "float32")
    jb, tb = _pair(rs.randn(64) * 0.1, "float32")
    y, mu, rstd = jax_fb._ln_fwd_call(jx, jw.reshape(1, -1), jb.reshape(1, -1),
                                      1e-5, 128, True)
    ty, tmu, trs = fb.ln_fwd(tx, tw, tb, 1e-5)
    np.testing.assert_allclose(_np(ty), _np(y), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(tmu), _np(mu)[0], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(trs), _np(rstd)[0], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_bias_gelu_matches_pallas_interpret(approximate, dtype, tol):
    rs = np.random.RandomState(2)
    jx, tx = _pair(rs.randn(8, 24, 64) * 2.0, dtype)
    jb, tb = _pair(rs.randn(64), dtype)
    with jax_kc.override(mode="fused"):
        ref = jax_fb.bias_gelu(jx, jb, approximate)
    for mode in ("off", "fused"):
        with kc.override(mode=mode):
            out = fb.bias_gelu(tx, tb, approximate)
        assert out.dtype == tx.dtype
        np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)
    # the kernel wrapper's CPU path (its plain version) on the 2-D view
    out2 = fb.bias_gelu_fwd(tx.reshape(-1, 64), tb, approximate)
    np.testing.assert_allclose(_np(out2).reshape(_np(ref).shape), _np(ref),
                               atol=tol, rtol=tol)


def _vjp_pair(jax_fn, torch_fn, jargs, targs, g):
    """(reference grads via jax.vjp, port grads via autograd) of the same
    cotangent; JAX under kernels mode fused (interpret-mode Pallas), the
    port under mode fused (its wrappers' plain forward and backward inside
    the dispatcher's autograd Function)."""
    with jax_kc.override(mode="fused"):
        _, vjp = jax.vjp(jax_fn, *jargs)
        ref = vjp(jnp.asarray(g).astype(jargs[0].dtype))
    leaves = [t.clone().requires_grad_() for t in targs]
    with kc.override(mode="fused"):
        out = torch_fn(*leaves)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves,
                              torch.from_numpy(g).to(out.dtype))
    return ref, got


@pytest.mark.parametrize("dtype,tol", TOLS)
def test_layer_norm_grads_match_pallas_interpret(dtype, tol):
    """ln_bwd_plain through the dispatcher's autograd against jax.vjp of
    the Pallas LayerNorm; the reference's own gradient tolerance is 10x
    its forward one (tests/test_fused_kernels.py)."""
    rs = np.random.RandomState(6)
    jx, tx = _pair(rs.randn(4, 32, 96) * 2 + 0.5, dtype)
    jw, tw = _pair(rs.randn(96) * 0.1 + 1.0, "float32")
    jb, tb = _pair(rs.randn(96) * 0.1, "float32")
    g = rs.randn(4, 32, 96).astype(np.float32)
    ref, got = _vjp_pair(lambda x, w, b: jax_fb.layer_norm(x, w, b, 1e-5),
                         lambda x, w, b: fb.layer_norm(x, w, b, 1e-5),
                         (jx, jw, jb), (tx, tw, tb), g)
    for name, a, r in zip(("dx", "dw", "db"), got, ref):
        assert a.dtype == (tx.dtype if name == "dx" else torch.float32)
        np.testing.assert_allclose(_np(a), _np(r), atol=10 * tol,
                                   rtol=10 * tol, err_msg=name)


@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_bias_gelu_grads_match_pallas_interpret(approximate, dtype, tol):
    """bias_gelu_bwd_plain through the dispatcher's autograd against
    jax.vjp of the Pallas bias+GeLU, tanh and erf forms; db comes back in
    the bias's dtype, as in the reference."""
    rs = np.random.RandomState(8)
    jx, tx = _pair(rs.randn(8, 24, 64) * 2.0, dtype)
    jb, tb = _pair(rs.randn(64), dtype)
    g = rs.randn(8, 24, 64).astype(np.float32)
    ref, got = _vjp_pair(lambda x, b: jax_fb.bias_gelu(x, b, approximate),
                         lambda x, b: fb.bias_gelu(x, b, approximate),
                         (jx, jb), (tx, tb), g)
    assert got[0].dtype == got[1].dtype == tx.dtype
    # db sums 192 rows of dx; in bf16 it is rounded once from fp32
    for a, r in zip(got, ref):
        np.testing.assert_allclose(_np(a), _np(r), atol=10 * tol,
                                   rtol=10 * tol)


def test_backward_plain_versions_match_the_kernel_math():
    """ln_bwd_plain and bias_gelu_bwd_plain equal autograd through the
    plain forwards (fp64 inputs, so the comparison is of the formulas)."""
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.randn(16, 40)).requires_grad_()
    w = torch.from_numpy(rs.randn(40)).requires_grad_()
    b = torch.from_numpy(rs.randn(40)).requires_grad_()
    g = torch.from_numpy(rs.randn(16, 40))
    x32 = x.detach()
    mu = x32.mean(-1)
    rstd = torch.rsqrt(((x32 - mu[:, None]) ** 2).mean(-1) + 1e-5)
    y = (x - x.mean(-1, keepdim=True)) * torch.rsqrt(
        ((x - x.mean(-1, keepdim=True)) ** 2).mean(-1, keepdim=True)
        + 1e-5) * w + b
    want = torch.autograd.grad(y, (x, w, b), g)
    got = fb.ln_bwd_plain(x32, w.detach(), mu, rstd, g)
    for a, r in zip(got, want):
        torch.testing.assert_close(a.double(), r, atol=1e-5, rtol=1e-5)
    for approximate in (True, False):
        y = torch.nn.functional.gelu(x + b, approximate="tanh" if approximate
                                     else "none")
        want = torch.autograd.grad(y, (x, b), g)
        got = fb.bias_gelu_bwd_plain(x32, b.detach(), g, approximate)
        for a, r in zip(got, want):
            torch.testing.assert_close(a.double(), r, atol=1e-5, rtol=1e-5)


def test_cpu_wrappers_take_plain_version_and_count_no_launch():
    before = (fb.ln_fwd.launches, fb.bias_gelu_fwd.launches,
              fb.ln_bwd.launches, fb.bias_gelu_bwd.launches)
    x = torch.randn(16, 32)
    w, b = torch.ones(32), torch.zeros(32)
    y, mu, rs = fb.ln_fwd(x, w, b, 1e-5)
    torch.testing.assert_close(y, fb.layer_norm(x, w, b, 1e-5))
    assert mu.shape == rs.shape == (16,)
    fb.bias_gelu_fwd(x, b, True)
    fb.ln_bwd(x, w, mu, rs, x)
    fb.bias_gelu_bwd(x, b, x, False)
    assert (fb.ln_fwd.launches, fb.bias_gelu_fwd.launches,
            fb.ln_bwd.launches, fb.bias_gelu_bwd.launches) == before


# ------------------------------------------------------------------ #
# the "kernels" switch
# ------------------------------------------------------------------ #


def test_kernel_config_surface_matches_reference():
    assert kc.MODES == jax_kc.MODES
    assert kc.SURFACES == jax_kc.SURFACES
    import dataclasses
    assert ([f.name for f in dataclasses.fields(kc.KernelsConfig)]
            == [f.name for f in dataclasses.fields(jax_kc.KernelsConfig)])
    assert kc.KernelsConfig() == kc.KernelsConfig(**dataclasses.asdict(
        jax_kc.KernelsConfig()))


@pytest.mark.parametrize("bad,match", [
    ({"mode": "turbo"}, "mode must be one of"),
    ({"modez": "auto"}, "unknown kernels config keys"),
    ({"fused_adam": "yes"}, "must be a bool"),
    ({"interpret": True}, "no interpret mode"),
])
def test_kernel_config_rejects_bad_blocks(bad, match):
    with pytest.raises(ValueError, match=match):
        kc.validate(bad)
    with pytest.raises(ValueError, match=match):
        kc.configure(**bad)
    assert kc.get() == kc.KernelsConfig()
    with pytest.raises(ValueError):
        kc.validate(["auto"])


def test_kernel_config_resolve_semantics():
    assert kc.validate({"mode": "auto"}) == {"mode": "auto"}
    assert kc.get().mode == "off"               # validate touches nothing
    for mode in kc.MODES:
        with kc.override(mode=mode):
            # no interpret mode: a CPU tensor never routes to a kernel
            assert kc.resolve("fused_blocks", "cpu") is False
            assert kc.resolve("fused_blocks", torch.device("cpu")) is False
    with kc.override(mode="fused"):
        assert kc.resolve("fused_blocks", "cuda") is True
        assert kc.get().mode == "fused"
        with kc.override(fused_blocks=False):
            assert kc.resolve("fused_blocks", "cuda") is False
    with kc.override(mode="off"):
        assert kc.resolve("fused_blocks", "cuda") is False
    assert kc.get() == kc.KernelsConfig()       # override restored
    with pytest.raises(ValueError, match="unknown kernel surface"):
        kc.resolve("flash", "cpu")


def test_build_directory_is_relative_to_the_package():
    import deeperspeed_tpu_torch
    from pathlib import Path

    root = Path(deeperspeed_tpu_torch.__file__).resolve().parent.parent
    assert op_builder.BUILD_DIR == root / "build" / "kernels"
    assert op_builder.CSRC_DIR == root / "deeperspeed_tpu_torch" / "csrc"
    path = op_builder.library_path("fused_blocks")
    assert path.parent == op_builder.BUILD_DIR
    assert path == op_builder.library_path("fused_blocks")  # stable name
    assert "compute_90a" in " ".join(op_builder.NVCC_FLAGS)


# ------------------------------------------------------------------ #
# the LN backwards' launch rule
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_bwd_plan_covers_every_admitted_width(dtype):
    """ln_bwd_plan for every width the LN backwards take (2 D fp32 within
    a block's shared memory) at ragged and path row counts: the rows route
    exactly where a row is whole 16-byte vectors, at most 1024 of them,
    with the fewest warps a row whose lanes hold it; whole teams in a
    512-thread block (256 at 4 vectors a lane); a block's shared memory
    (rows: w and the teams' tree, half the teams' column partials) within
    48 KB, 227 KB wide; one block an SM (rows; two wide), no more than the
    rows need, one partial row each; every column in a block of the
    reduction."""
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    for D in range(1, fb._SMEM_FLOATS // 2 + 1):
        for R in (1, 37, 8192):
            plan = fb.ln_bwd_plan(R, D, dtype)
            nvec = D // vec
            rows = D % vec == 0 and nvec <= 1024
            assert plan["route"] == ("rows" if rows else "wide"), (D, plan)
            assert plan["partial_rows"] == plan["blocks"] >= 1
            assert plan["reduce_blocks"] * 8 >= 2 * D
            if not rows:
                assert plan["blocks"] == min(R, 264)
                assert plan["smem_bytes"] == 8 * D <= 232448
                continue
            wpr, nv = plan["warps_per_row"], plan["vectors_per_lane"]
            assert nvec <= 32 * wpr * nv
            assert (wpr, nv) == next(p for p in fb._LN_ROWS_PAIRS
                                     if nvec <= 32 * p[0] * p[1])
            teams = plan["teams_per_block"]
            assert teams * wpr * 32 == plan["threads"] == (512 if nv == 2
                                                           else 256)
            # w to a 16-byte boundary, then half the teams' partials, 2 x 4
            # bytes a column of each thread
            tree = teams // 2 * 32 * wpr * nv * vec * 8
            assert plan["smem_bytes"] == -(-D // 4) * 16 + tree <= 48 * 1024
            assert plan["blocks"] == min(-(-R // teams), 132)


def test_ln_bwd_plan_at_the_model_widths():
    """The widths the models run: GPT-NeoX-125M (768), BERT-large (1024),
    GPT-NeoX-1.3B (2048) and GPT-NeoX-20B (6144) take the rows route;
    rows off a 16-byte boundary, or of an odd width, take the wide one."""
    bf16 = torch.bfloat16
    want = {768: (2, 2, 8), 1024: (2, 2, 8), 2048: (4, 2, 4), 6144: (8, 4, 1)}
    for D, (wpr, nv, teams) in want.items():
        plan = fb.ln_bwd_plan(8192, D, bf16)
        assert (plan["route"], plan["warps_per_row"], plan["vectors_per_lane"],
                plan["teams_per_block"]) == ("rows", wpr, nv, teams)
    assert fb.ln_bwd_plan(2048, 2048, bf16)["blocks"] == 132
    assert fb.ln_bwd_plan(2048, 6144, bf16, n_sm=66)["blocks"] == 66
    assert fb.ln_bwd_plan(2048, 2048, bf16, aligned=False)["route"] == "wide"
    assert fb.ln_bwd_plan(2048, 2047, bf16)["route"] == "wide"
    assert fb.ln_bwd_plan(2048, 2048, torch.float32)["warps_per_row"] == 8
    assert fb.ln_bwd_plan(2048, 6144, torch.float32)["route"] == "wide"


# ------------------------------------------------------------------ #
# the LN forwards' launch rule
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ln_fwd_plan_covers_every_admitted_width(dtype):
    """ln_fwd_plan for every width up to 9000 (the forwards take any D) at
    1, 8, 37 and 8192 rows: the rows route exactly where a row is whole
    16-byte vectors, at most 1024 of them, with the backward's pair (the
    fewest warps whose lanes hold the row); whole teams of whole warps in
    a block of at most 256 threads (the kernel's launch bound); no dynamic
    shared memory; one team a block while the rows are fewer than two
    blocks an SM (so few rows spread over the SMs), never more blocks than
    two an SM or than the rows need, and every row in some team's stride;
    the wide route one 256-thread block a row."""
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    slots = 2 * 132
    for D in range(1, 9001):
        for R in (1, 8, 37, 8192):
            plan = fb.ln_fwd_plan(R, D, dtype)
            nvec = D // vec
            rows = D % vec == 0 and nvec <= 1024
            assert plan["route"] == ("rows" if rows else "wide"), (D, plan)
            assert plan["smem_bytes"] == 0
            if not rows:
                assert (plan["threads"], plan["blocks"],
                        plan["warps_per_row"]) == (256, R, 0)
                continue
            wpr, nv = plan["warps_per_row"], plan["vectors_per_lane"]
            assert (wpr, nv) == next(p for p in fb._LN_ROWS_PAIRS
                                     if nvec <= 32 * p[0] * p[1])
            teams = plan["teams_per_block"]
            assert plan["threads"] == 32 * wpr * teams <= 256
            assert teams == min(256 // (32 * wpr), -(-R // slots))
            if R <= slots:
                assert teams == 1 and plan["blocks"] == R
            assert plan["blocks"] == min(-(-R // teams), slots)
            assert plan["blocks"] * teams >= min(R, slots * teams)


def test_ln_fwd_plan_at_the_model_widths():
    """The widths the models run take the rows route, serving's 8 decode
    rows one block each; rows off a 16-byte boundary, an odd width and
    rows wider than 1024 vectors take the wide one; the SM count scales
    the persistent grid."""
    bf16 = torch.bfloat16
    want = {768: (2, 2, 4), 1024: (2, 2, 4), 2048: (4, 2, 2), 6144: (8, 4, 1)}
    for D, (wpr, nv, teams) in want.items():
        plan = fb.ln_fwd_plan(8192, D, bf16)
        assert (plan["route"], plan["warps_per_row"], plan["vectors_per_lane"],
                plan["teams_per_block"], plan["blocks"]) == (
                    "rows", wpr, nv, teams, 264)
    decode = fb.ln_fwd_plan(8, 2048, bf16)
    assert (decode["blocks"], decode["threads"]) == (8, 128)
    assert fb.ln_fwd_plan(2048, 2048, bf16, n_sm=66)["blocks"] == 132
    assert fb.ln_fwd_plan(2048, 2048, bf16, aligned=False)["route"] == "wide"
    assert fb.ln_fwd_plan(2048, 2047, bf16)["route"] == "wide"
    assert fb.ln_fwd_plan(7, 8200, bf16)["route"] == "wide"
    assert fb.ln_fwd_plan(48, 6144, torch.float32)["route"] == "wide"
    assert fb.ln_fwd_plan(48, 4096, torch.float32)["warps_per_row"] == 8
