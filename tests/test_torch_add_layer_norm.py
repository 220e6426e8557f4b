"""The PyTorch port's residual-add LayerNorm (the BERT post-LN add&norm),
forward and gradients, against the JAX reference's Pallas kernel ``_aln``
run in interpret mode on the CPU.

On the CPU the port's kernel wrappers take their plain versions; under
the port's kernels mode ``fused`` the dispatcher still goes through the
wrappers' autograd Function, so its forward and backward are both driven
here. The CUDA kernels are held against the same plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops import kernel_config as jax_kc
from deeperspeed_tpu.ops.pallas import fused_blocks as jax_fb
from deeperspeed_tpu_torch.ops import fused_blocks as fb
from deeperspeed_tpu_torch.ops import kernel_config as kc

torch.set_num_threads(1)

# the reference's tolerances (tests/test_fused_kernels.py): forward; the
# gradients take ten times these
TOLS = [("float32", 2e-5), ("bfloat16", 2e-2)]


def _pair(a: np.ndarray, dtype: str):
    j = jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype))
    t = torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", [(2, 16, 128), (37, 128)])
@pytest.mark.parametrize("dtype,tol", TOLS)
def test_add_layer_norm_matches_pallas_interpret(shape, dtype, tol):
    """Forward and the gradients to x, r, w and b, at the reference test's
    (2, 16, 128) and a ragged row count (37 rows, which the reference
    runs as one whole-R block)."""
    rs = np.random.RandomState(0)
    D = shape[-1]
    jx, tx = _pair(rs.randn(*shape), dtype)
    jr, tr = _pair(rs.randn(*shape), dtype)
    jw, tw = _pair(rs.randn(D) * 0.1 + 1.0, "float32")
    jb, tb = _pair(rs.randn(D) * 0.1, "float32")
    jg = rs.randn(*shape).astype(np.float32)

    def f(x, r, w, b):
        y = jax_fb.add_layer_norm(x, r, w, b, 1e-12)
        return jnp.sum(y.astype(jnp.float32) * jg)

    with jax_kc.override(mode="fused"):
        ref = jax_fb.add_layer_norm(jx, jr, jw, jb, 1e-12)
        gref = jax.grad(f, argnums=(0, 1, 2, 3))(jx, jr, jw, jb)

    leaves = [t.clone().requires_grad_() for t in (tx, tr, tw, tb)]
    with kc.override(mode="fused"):
        out = fb.add_layer_norm(*leaves, 1e-12)
        got = torch.autograd.grad((out.float() * torch.from_numpy(jg)).sum(),
                                  leaves)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    assert out.grad_fn is not None
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=tol)
    for a, r, name in zip(got, gref, ("dx", "dr", "dw", "db")):
        np.testing.assert_allclose(_np(a), _np(r), atol=10 * tol,
                                   rtol=10 * tol, err_msg=name)


def test_add_ln_kernel_pair_matches_pallas_calls():
    """The wrappers' plain versions against the reference's two Pallas
    calls directly: y, the fp32 mean and rstd of x + r, and ds, dw, db."""
    rs = np.random.RandomState(3)
    R, D = 256, 64
    jx, tx = _pair(rs.randn(R, D) * 2 + 0.5, "float32")
    jr, tr = _pair(rs.randn(R, D), "float32")
    jw, tw = _pair(rs.randn(D) * 0.1 + 1.0, "float32")
    jb, tb = _pair(rs.randn(D) * 0.1, "float32")
    jg, tg = _pair(rs.randn(R, D), "float32")
    y, mu, rstd = jax_fb._aln_fwd_call(jx, jr, jw.reshape(1, -1),
                                       jb.reshape(1, -1), 1e-12, 128, True)
    ty, tmu, trs = fb.add_ln_fwd(tx, tr, tw, tb, 1e-12)
    np.testing.assert_allclose(_np(ty), _np(y), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(tmu), _np(mu)[0], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(trs), _np(rstd)[0], atol=2e-5, rtol=2e-5)
    ds, ds2, dw, db = jax_fb._aln_vjp_bwd(
        1e-12, 128, True, (jx, jr, jw.reshape(1, -1), mu, rstd), jg)
    got = fb.add_ln_bwd(tx, tr, tw, tmu, trs, tg)
    for a, r in zip(got, (ds, dw[0], db[0])):
        np.testing.assert_allclose(_np(a), _np(r), atol=2e-4, rtol=2e-4)
    np.testing.assert_array_equal(_np(ds), _np(ds2))
    assert fb.add_ln_fwd.launches == 0 and fb.add_ln_bwd.launches == 0


def test_add_layer_norm_plain_path_is_the_reference_off_path():
    """Kernels off: the reference's ``_ln_ref(x + residual)``, the sum
    rounded in x's dtype."""
    rs = np.random.RandomState(4)
    jx, tx = _pair(rs.randn(8, 48), "bfloat16")
    jr, tr = _pair(rs.randn(8, 48), "bfloat16")
    jw, tw = _pair(rs.randn(48) * 0.1 + 1.0, "float32")
    jb, tb = _pair(rs.randn(48) * 0.1, "float32")
    ref = jax_fb.add_layer_norm(jx, jr, jw, jb, 1e-5)
    with kc.override(mode="off"):
        out = fb.add_layer_norm(tx, tr, tw, tb, 1e-5)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-2, rtol=2e-2)


def test_add_layer_norm_kernel_route_hands_mixed_dtypes_to_the_kernel_checks(
        monkeypatch):
    """On the kernel route the dispatcher never takes the plain path: a
    bf16 x with an fp32 residual reaches the wrapper, whose CUDA launch
    refuses it. The card is faked: the wrapper's CUDA branch (the launch's
    checks) runs on CPU tensors, and no kernel is built."""
    def no_build():
        raise AssertionError("the checks must refuse before any build")

    monkeypatch.setattr(fb, "_lib", no_build)
    monkeypatch.setattr(fb, "add_ln_fwd", lambda x, r, w, b, eps:
                        fb._ln_fwd_launch("add_ln_fwd", x, r, w, b, eps))
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(2, 8, 64).astype(np.float32))
    w, b = torch.ones(64), torch.zeros(64)
    with kc.override(mode="fused"):
        with pytest.raises(ValueError, match="r has dtype"):
            fb.add_layer_norm(x.bfloat16(), x, w, b, 1e-5)
        with pytest.raises(ValueError, match="r has dtype"):
            fb.add_layer_norm(x.bfloat16(), x[0], w, b, 1e-5)


def test_add_layer_norm_broadcast_residual_takes_the_kernel_route(
        monkeypatch):
    """A residual that broadcasts against x goes through the wrapper,
    expanded to x's shape; the output and the gradients to x, the residual
    (summed back over the broadcast axis), w and b match the reference's,
    which adds unfused there."""
    seen = []
    wrapper = fb.add_ln_fwd

    def spy(x, r, w, b, eps):
        seen.append(tuple(r.shape))
        return wrapper(x, r, w, b, eps)

    monkeypatch.setattr(fb, "add_ln_fwd", spy)
    rs = np.random.RandomState(6)
    shape, D = (3, 8, 64), 64
    jx, tx = _pair(rs.randn(*shape), "float32")
    jr, tr = _pair(rs.randn(8, D), "float32")
    jw, tw = _pair(rs.randn(D) * 0.1 + 1.0, "float32")
    jb, tb = _pair(rs.randn(D) * 0.1, "float32")
    jg = rs.randn(*shape).astype(np.float32)

    def f(x, r, w, b):
        return jnp.sum(jax_fb.add_layer_norm(x, r, w, b, 1e-12) * jg)

    with jax_kc.override(mode="fused"):
        ref = jax_fb.add_layer_norm(jx, jr, jw, jb, 1e-12)
        gref = jax.grad(f, argnums=(0, 1, 2, 3))(jx, jr, jw, jb)
    leaves = [t.clone().requires_grad_() for t in (tx, tr, tw, tb)]
    with kc.override(mode="fused"):
        out = fb.add_layer_norm(*leaves, 1e-12)
    assert seen == [(24, D)]
    got = torch.autograd.grad((out * torch.from_numpy(jg)).sum(), leaves)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5, rtol=2e-5)
    for a, leaf, r, name in zip(got, leaves, gref, ("dx", "dr", "dw", "db")):
        assert a.shape == leaf.shape, name
        np.testing.assert_allclose(_np(a), _np(r), atol=2e-4, rtol=2e-4,
                                   err_msg=name)
