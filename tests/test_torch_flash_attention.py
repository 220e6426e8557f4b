"""The PyTorch port's flash attention against the JAX reference's two
Pallas kernel pairs, run in interpret mode on the CPU: the streaming
``_flash_fwd``/``_flash_bwd`` (ops/pallas/flash_attention.py) and the
static-unrolled ``_fwd``/``_bwd`` (ops/pallas/flash_static.py).

On the CPU the port's kernel wrappers take their plain versions
(``flash_fwd_plain``/``flash_bwd_plain``); its autograd (the custom ops)
and the model-level dispatch are held against the reference here. The
CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py. Tolerances are the
reference's own tests': fp32 2e-3 forward and 5e-3 gradients
(tests/test_flash_attention.py), bf16 2e-2 and 5e-2
(tests/test_flash_static.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops.pallas import flash_attention as jax_fa
from deeperspeed_tpu.ops.pallas import flash_static as jax_fs
from deeperspeed_tpu_torch.models import gpt
from deeperspeed_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

TOL = {"float32": (2e-3, 5e-3), "bfloat16": (2e-2, 5e-2)}


def _inputs(shape, dtype, seed=0):
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(*shape).astype(np.float32) for _ in range(4)]
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(x, np.float32)


def _reference(kind, q, k, v, do, causal):
    """The reference kernel pair in interpret mode: (o, lse (B, H, S),
    (dq, dk, dv)) through its custom VJP."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    S = q.shape[2]
    if kind == "static":
        o, lse = jax_fs._fwd(q, k, v, scale, causal, True)
        fn = lambda a, b, c: jax_fs._flash_static(a, b, c, scale, causal,
                                                  True)
    else:
        # 128-row blocks, so S = 200 runs the ragged last block
        bq = bk = min(128, S)
        o, lse = jax_fa._flash_fwd(q, k, v, scale, causal, bq, bk, True)
        fn = lambda a, b, c: jax_fa._flash(a, b, c, scale, causal, bq, bk,
                                           True)
    _, vjp = jax.vjp(fn, q, k, v)
    return o, lse[:, :, 0, :], vjp(do)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [128, 256, 200])
@pytest.mark.parametrize("kind", ["stream", "static"])
def test_forward_and_grads_match_reference(kind, S, causal):
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs((1, 2, S, 64), "float32")
    o_ref, lse_ref, grads_ref = _reference(kind, jq, jk, jv, jdo, causal)
    ftol, gtol = TOL["float32"]
    o, lse = fa.flash_fwd(tq, tk, tv, 1 / 8, causal)
    np.testing.assert_allclose(_np(o), _np(o_ref), atol=ftol, rtol=ftol)
    np.testing.assert_allclose(_np(lse), _np(lse_ref), atol=ftol, rtol=ftol)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = fa.flash_attention_bhsd(*leaves, causal=causal)
    grads = torch.autograd.grad(out, leaves, tdo)
    np.testing.assert_allclose(_np(out), _np(o_ref), atol=ftol, rtol=ftol)
    for name, g, r in zip("qkv", grads, grads_ref):
        np.testing.assert_allclose(_np(g), _np(r), atol=gtol, rtol=gtol,
                                   err_msg=f"d{name}")
    # the backward wrapper on its own, from the reference's residuals
    direct = fa.flash_bwd(tq, tk, tv, torch.from_numpy(_np(o_ref)),
                          torch.from_numpy(_np(lse_ref)), tdo, 1 / 8, causal)
    for g, r in zip(direct, grads_ref):
        np.testing.assert_allclose(_np(g), _np(r), atol=gtol, rtol=gtol)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_matches_static_reference(causal):
    """bf16 rounds where the reference rounds: P before P V, dS before
    its two products."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs((1, 2, 128, 64),
                                                   "bfloat16", seed=1)
    o_ref, lse_ref, grads_ref = _reference("static", jq, jk, jv, jdo, causal)
    ftol, gtol = TOL["bfloat16"]
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = fa.flash_attention_bhsd(*leaves, causal=causal)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(o_ref), atol=ftol, rtol=ftol)
    for g, r in zip(torch.autograd.grad(out, leaves, tdo), grads_ref):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(g), _np(r), atol=gtol, rtol=gtol)


def test_custom_ops_and_counters():
    """The forward is one dispatcher op (what selective checkpointing
    keeps); on the CPU neither wrapper counts a launch."""
    before = (fa.flash_fwd.launches, fa.flash_bwd.launches)
    q = torch.randn(1, 1, 8, 64, requires_grad=True)
    o = fa.flash_attention_bhsd(q, q.detach(), q.detach())
    assert "flash_fwd" in type(o.grad_fn).__name__
    o.sum().backward()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == before
    assert fa.FLASH_FWD_OP is torch.ops.deeperspeed_tpu_torch.flash_fwd.default


@pytest.mark.parametrize("impl", ["auto", "pallas", "pallas_interpret",
                                  "xla"])
def test_model_dispatch_matches_dense_attention(impl):
    """Every attn_impl computes the same causal attention on (B, S, H, Dh);
    on the CPU "auto" takes the dense path and the "pallas" ones the flash
    path's plain version."""
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rs.randn(2, 40, 3, 64).astype(np.float32))
               for _ in range(3))
    ref = gpt.dense_causal_attention(q, k, v)
    out = gpt.causal_attention(q, k, v, impl)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="unknown attn_impl"):
        gpt.causal_attention(q, k, v, "splash")
    # the context-parallel impls are known and need make_gpt's mesh
    with pytest.raises(ValueError, match="needs a mesh"):
        gpt.causal_attention(q, k, v, "ring")


@pytest.mark.parametrize("dtype,head_dim,match", [
    (torch.float16, 64, "float32 or bfloat16"),
    (torch.float32, 80, "head_dim"),
])
def test_auto_on_hopper_takes_flash_and_raises_on_what_it_cannot_take(
        monkeypatch, dtype, head_dim, match):
    """Under "auto" a tensor on a Hopper card always goes to the flash
    path: an fp16 model or a head dim of 80 raises the kernel wrapper's
    check instead of falling back to dense attention. The CPU fakes only
    the device test; the stand-in for the launch runs the check the CUDA
    wrapper runs on the head-major tensors it is given."""
    routed = []

    def on_card(q, k, v, causal=True):
        routed.append(q.shape)
        t = q.transpose(1, 2).contiguous()
        fa._check("flash_fwd", (t, t, t), t)
        raise AssertionError("the check let through what the kernel "
                             "does not take")

    monkeypatch.setattr(gpt, "_auto_takes_flash", lambda device: True)
    monkeypatch.setattr(gpt, "flash_attention", on_card)
    q = torch.zeros(1, 16, 2, head_dim, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        gpt.causal_attention(q, q, q, "auto")
    assert routed == [q.shape]
    # "xla" stays the way to run such a model
    assert gpt.causal_attention(q.float(), q.float(), q.float(),
                                "xla").shape == q.shape
