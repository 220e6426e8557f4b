"""The PyTorch port's fused LayerNorm and bias+GeLU against the JAX
reference's Pallas kernels (run in interpret mode on the CPU), and the
port's "kernels" selection switch.

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


def test_cpu_wrappers_take_plain_version_and_count_no_launch():
    before = (fb.ln_fwd.launches, fb.bias_gelu_fwd.launches)
    x = torch.randn(16, 32)
    w, b = torch.ones(32), torch.zeros(32)
    y, mu, rs = fb.ln_fwd(x, w, b, 1e-5)
    torch.testing.assert_close(y, fb.layer_norm(x, w, b, 1e-5))
    assert mu.shape == rs.shape == (16,)
    fb.bias_gelu_fwd(x, b, True)
    assert (fb.ln_fwd.launches, fb.bias_gelu_fwd.launches) == before


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
