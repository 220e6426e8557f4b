"""The PyTorch port's short-sequence (super-tile) attention against the JAX
reference's ``flash_attention_supertile_bhsd`` run in interpret mode on
the CPU: the kernel pair's plain versions, the differentiable entry point,
the port's shape gate, ``attention_dispatch`` and GPT's route into it.

On the CPU the wrappers take their plain versions; the CUDA kernels are
held against those on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.ops import kernel_config as jax_kc
from deeperspeed_tpu.ops.pallas import flash_static as jax_fs
from deeperspeed_tpu_torch.models import convert, gpt
from deeperspeed_tpu_torch.ops import flash_attention as fa
from deeperspeed_tpu_torch.ops import flash_static as fs
from deeperspeed_tpu_torch.ops import kernel_config as kc

torch.set_num_threads(1)

# the reference's super-tile tolerances (tests/test_fused_kernels.py)
FWD_TOL, GRAD_TOL, BF16_TOL = 2e-3, 5e-3, 3e-2
SHAPES = [(2, 2, 64, 16), (4, 1, 128, 32)]


def _inputs(shape, seed, dtype="float32"):
    rs = np.random.RandomState(seed)
    arrays = [rs.randn(*shape).astype(np.float32) for _ in range(4)]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_supertile_matches_reference(shape, causal):
    """Forward (o and lse) and the gradients of the port's plain pair and
    of its differentiable entry point, against the reference's interpreted
    kernels."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(shape, 0)
    scale = 1.0 / np.sqrt(shape[-1])
    ref = jax_fs.flash_attention_supertile_bhsd(jq, jk, jv, causal=causal,
                                                interpret=True)

    def loss(q, k, v):
        return jnp.sum(jax_fs.flash_attention_supertile_bhsd(
            q, k, v, causal=causal, interpret=True) * jg)

    gref = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)

    o, lse = fs.supertile_fwd_plain(tq, tk, tv, scale, causal)
    np.testing.assert_allclose(_np(o), _np(ref), atol=FWD_TOL, rtol=FWD_TOL)
    # the reference kernel's saved lse, through its own forward call
    B, H, S, Dh = shape
    G = jax_fs._supertile_group(B, H, S)
    pack = lambda x: x.reshape(B * H // G, G * S, Dh)  # noqa: E731
    _, jlse = jax_fs._st_fwd(pack(jq), pack(jk), pack(jv), scale, causal, S,
                             True)
    np.testing.assert_allclose(_np(lse), _np(jlse).reshape(B, H, S),
                               atol=FWD_TOL, rtol=FWD_TOL)
    grads = fs.supertile_bwd_plain(tq, tk, tv, o, lse, tg, scale, causal)
    for a, r, name in zip(grads, gref, "qkv"):
        np.testing.assert_allclose(_np(a), _np(r), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"d{name}")

    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = fs.flash_attention_supertile_bhsd(*leaves, causal=causal)
    got = torch.autograd.grad((out * tg).sum(), leaves)
    np.testing.assert_allclose(_np(out), _np(ref), atol=FWD_TOL, rtol=FWD_TOL)
    for a, r, name in zip(got, gref, "qkv"):
        np.testing.assert_allclose(_np(a), _np(r), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"d{name}")
    assert fs.supertile_fwd.launches == 0 and fs.supertile_bwd.launches == 0


def test_supertile_bf16_matches_reference():
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs((2, 2, 64, 16), 1, "bfloat16")
    ref = jax_fs.flash_attention_supertile_bhsd(jq, jk, jv, causal=True,
                                                interpret=True)
    out = fs.flash_attention_supertile_bhsd(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), atol=BF16_TOL,
                               rtol=BF16_TOL)


def test_supertile_gate():
    """The port's gate: the BERT-large shape in; S = 256 (the reference's
    bound is exclusive) and S = 204 (not a multiple of 8) out. The
    reference's packing and VMEM rules are dropped, so (2, 2, 200, 64),
    which it refuses for want of a legal packing, is admitted here."""
    ok = fs.supertile_geometry_ok
    assert ok(64, 16, 128, 64, torch.bfloat16)
    assert ok(2, 2, 64, 16, torch.float32)
    assert ok(1, 1, 248, 128, torch.float32)
    assert not ok(8, 8, 256, 64, torch.bfloat16)
    assert not ok(2, 2, 204, 64, torch.bfloat16)
    assert not ok(2, 2, 4, 64, torch.bfloat16)
    assert not ok(2, 2, 64, 12, torch.bfloat16)
    assert not ok(2, 2, 64, 136, torch.bfloat16)
    assert not ok(2, 2, 64, 64, torch.float16)
    assert ok(2, 2, 200, 64, torch.bfloat16)
    assert not jax_fs.supertile_geometry_ok(2, 2, 200, 64, 2)
    with pytest.raises(ValueError, match="does not take"):
        fs.flash_attention_supertile_bhsd(*[torch.zeros(1, 1, 256, 64)] * 3)


def test_attention_dispatch_routing(monkeypatch):
    """off / fused / auto on the CPU, and on a Hopper CUDA device (the
    device test faked: no card here)."""
    shape, long = (64, 16, 128, 64), (2, 16, 1024, 128)
    bf16 = torch.bfloat16
    with kc.override(mode="off"):
        assert fa.attention_dispatch(shape, bf16, "cpu") == "xla"
    with kc.override(mode="fused"):
        assert fa.attention_dispatch(shape, bf16, "cpu") == "supertile"
        assert fa.attention_dispatch(long, bf16, "cpu") == "xla"
        with kc.override(supertile=False):
            assert fa.attention_dispatch(shape, bf16, "cpu") == "xla"
    with kc.override(mode="auto"):
        assert fa.attention_dispatch(shape, bf16, "cpu") == "xla"
    monkeypatch.setattr(kc, "_is_hopper", lambda device: True)
    with kc.override(mode="auto"):
        assert fa.attention_dispatch(shape, bf16, "cuda") == "supertile"
        assert fa.attention_dispatch(long, bf16, "cuda") == "flash"
        # a shape the gate refuses still takes a kernel on Hopper
        assert fa.attention_dispatch((2, 2, 204, 64), bf16,
                                     "cuda") == "flash"
    with kc.override(mode="off"):
        assert fa.attention_dispatch(shape, bf16, "cuda") == "flash"


def test_gpt_short_sequence_takes_the_supertile_path(monkeypatch):
    """GPT at S = 64 under kernels ``fused``: causal attention goes through
    the super-tile path (its wrapper, plain on the CPU), and the logits
    agree with the reference's within 1e-4."""
    kw = dict(vocab_size=97, n_layer=2, n_head=4, d_model=64, max_seq=64,
              rotary=True, parallel_residual=True)
    jcfg = jax_gpt.GPTConfig(**kw, dtype=jnp.float32,
                             attn_impl="pallas_interpret")
    jinit, japply, _, _ = jax_gpt.make_gpt(jcfg)
    jparams = jinit(jax.random.PRNGKey(0))
    tokens = np.random.RandomState(5).randint(0, 97, (2, 64)).astype(np.int32)
    with jax_kc.override(mode="fused"):
        ref = japply(jparams, jnp.asarray(tokens))
    tcfg = gpt.GPTConfig(**kw, dtype=torch.float32,
                         attn_impl="pallas_interpret")
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")
    calls = []
    real = fs.supertile_fwd
    monkeypatch.setattr(fs, "supertile_fwd",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    with kc.override(mode="fused"):
        out = gpt.apply(tcfg, tparams, torch.from_numpy(tokens))
    assert calls == [(2, 4, 64, 16)] * kw["n_layer"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


# every (S, Dh) the gate admits
_ADMITTED = [(S, Dh) for S in range(8, fs.SUPERTILE_MAX_SEQ, 8)
             for Dh in range(8, fs.MAX_HEAD_DIM + 1, 8)]
_SM_SMEM, _BLOCK_RESERVED = 233472, 1024  # an H100 SM's shared memory


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_supertile_bwd_plan_fits_every_admitted_shape(dtype):
    """The backward's launch rule for every shape the gate admits: a
    block's shared memory within Hopper's 227 KB and whole warps, at most
    256 threads. bf16: one block a sequence and a warp per 16 rows up to
    S 128, four blocks above; no scratch; two blocks an SM at head dims up
    to 64 (the BERT shape's). fp32: the CUDA-core kernel's fp32 scratch for
    delta and, above one 64-key chunk, for dq."""
    for S, Dh in _ADMITTED:
        assert fs.supertile_geometry_ok(1, 1, S, Dh, dtype)
        plan = fs.bwd_plan(S, Dh, dtype)
        assert plan["smem_bytes"] <= fs.SMEM_PER_BLOCK, (S, Dh)
        assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 256
        if dtype == torch.float32:
            assert plan["route"] == "cuda_cores"
            assert plan["scratch_floats"] == S + (S * Dh if S > 64 else 0)
            continue
        assert plan["scratch_floats"] == 0
        if S <= 128:
            assert plan["route"] == "fused" and plan["blocks_per_seq"] == 1
            assert plan["threads"] == 32 * -(-S // 16)
        else:
            assert plan["route"] == "split" and plan["blocks_per_seq"] == 4
            assert plan["threads"] == 256
        if Dh <= 64:
            assert 2 * (plan["smem_bytes"] + _BLOCK_RESERVED) <= _SM_SMEM
    bert = fs.bwd_plan(128, 64, torch.bfloat16)
    assert (bert["route"], bert["smem_bytes"]) == ("fused", 99328)


def test_supertile_bwd_cpu_takes_plain_version_and_counts_no_launch():
    """On the CPU supertile_bwd is its plain version, launches nothing and
    allocates no scratch; the flash pair's plain backward is the same
    function."""
    (_, _, _, _), (tq, tk, tv, tg) = _inputs((2, 3, 40, 24), 2)
    o, lse = fs.supertile_fwd(tq, tk, tv, 0.2, True)
    before = (fs.supertile_fwd.launches, fs.supertile_bwd.launches)
    got = fs.supertile_bwd(tq, tk, tv, o, lse, tg, 0.2, True)
    want = fa.flash_bwd_plain(tq, tk, tv, o, lse, tg, 0.2, True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (fs.supertile_fwd.launches, fs.supertile_bwd.launches) == before
