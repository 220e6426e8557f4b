"""The port's fused Adam route against the JAX reference's Pallas kernel.

Under "kernels" mode ``fused`` the port's ``FusedAdam`` sends the update
through the kernel wrapper (ops/fused_adam.py), which takes its plain
version on a CPU tensor; the reference's ``FusedAdam(use_pallas=True)``
runs ``fused_adam_leaf`` in interpret mode. Both start from the same
numpy params, moments and grads and take 3 steps. fp32 storage must
agree within atol = rtol = 1e-6 (the reference's own tolerance for its
kernel, tests/test_fused_kernels.py) after each step, bf16 storage
within one bf16 ulp.

The reference's interpreted kernel rounds a few products differently
from its own XLA path (and from the port, which follows the XLA path's
order). In bf16 storage such a one-ulp difference is stored and carried
on by the next step, so each bf16 step starts the port from the
reference's state: every step's update is held to one ulp, not the sum
of three steps' roundings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops import adam as jax_adam
from deeperspeed_tpu_torch.ops import adam, fused_adam
from deeperspeed_tpu_torch.ops import kernel_config as kc

torch.set_num_threads(1)

# Pallas leaves (a legal row block each) and a 0-d leaf, which the
# reference's kernel cannot take and updates on its XLA path
SHAPES = {"w": (16, 128), "h": (8, 64), "b": (200,), "s": ()}
TOL = 1e-6


def _np_tree(rs, scale=1.0, positive=False):
    out = {}
    for k, s in SHAPES.items():
        x = np.asarray(rs.randn(*s) * scale, np.float32)
        out[k] = np.asarray(np.abs(x) if positive else x)
    return out


def _bf16_bits(x):
    """int32 positions of bf16 values on a monotone line (-0 == +0)."""
    if isinstance(x, torch.Tensor):
        bits = x.contiguous().view(torch.int16).numpy().astype(np.int32)
    else:
        bits = np.asarray(x).view(np.int16).astype(np.int32)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def _assert_agree(got, want, bf16):
    if bf16:
        assert got.dtype == torch.bfloat16
        assert str(np.asarray(want).dtype) == "bfloat16"
        ulps = np.abs(_bf16_bits(got) - _bf16_bits(want))
        assert ulps.max(initial=0) <= 1, ulps.max()
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("storage", ["fp32", "bf16_masterless",
                                     "fp32_master_bf16_cast"])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_route_matches_reference_pallas_kernel(storage, adam_w_mode,
                                                     monkeypatch):
    rs = np.random.RandomState(3)
    p0, m0 = _np_tree(rs), _np_tree(rs, 0.1)
    v0 = _np_tree(rs, 1e-3, positive=True)
    grads = [_np_tree(rs) for _ in range(3)]
    bf16 = storage == "bf16_masterless"
    cast = storage == "fp32_master_bf16_cast"
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    kw = dict(lr=1e-2, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.01,
              adam_w_mode=adam_w_mode)
    jopt = jax_adam.FusedAdam(**kw, state_dtype=jdt, use_pallas=True)
    topt = adam.FusedAdam(**kw, state_dtype=tdt)

    def jtree(t):
        return {k: jnp.asarray(x, jdt) for k, x in t.items()}

    def ttree(t):
        return {k: torch.from_numpy(x.copy()).to(tdt) for k, x in t.items()}

    jp = jtree(p0)
    jst = jax_adam.AdamState(jnp.zeros((), jnp.int32), jtree(m0), jtree(v0))
    tp = ttree(p0)
    tst = adam.AdamState(0, ttree(m0), ttree(v0))
    tcast = {k: torch.empty(s, dtype=torch.bfloat16)
             for k, s in SHAPES.items()} if cast else None

    calls = []

    def spy(*args, **kwargs):
        calls.append(len(args[0]))
        return fused_adam.fused_adam(*args, **kwargs)

    monkeypatch.setattr(adam, "fused_adam", spy)
    launches = fused_adam.fused_adam.launches
    with kc.override(mode="fused"):
        for g in grads:
            if cast:
                jp, jst, jcast = jopt.update(jtree(g), jst, jp,
                                             jnp.float32(1e-2),
                                             cast_dtype=jnp.bfloat16)
            else:
                jp, jst = jopt.update(jtree(g), jst, jp, jnp.float32(1e-2))
            tp, tst = topt.update(ttree(g), tst, tp, 1e-2, cast=tcast)
            assert tst.step == int(jst.step)
            for k in SHAPES:
                _assert_agree(tp[k], jp[k], bf16)
                _assert_agree(tst.exp_avg[k], jst.exp_avg[k], bf16)
                _assert_agree(tst.exp_avg_sq[k], jst.exp_avg_sq[k], bf16)
                if cast:
                    _assert_agree(tcast[k], jcast[k], bf16=True)
                    assert torch.equal(tcast[k], tp[k].to(torch.bfloat16))
            if bf16:
                for t, j in ((tp, jp), (tst.exp_avg, jst.exp_avg),
                             (tst.exp_avg_sq, jst.exp_avg_sq)):
                    for k in SHAPES:
                        t[k].copy_(torch.from_numpy(np.asarray(
                            j[k], np.float32)))
    # one wrapper call per step (one dtype combination), plain on the CPU
    assert calls == [len(SHAPES)] * 3
    assert fused_adam.fused_adam.launches == launches
    assert tst.step == 3


def test_grouping_gives_one_group_per_dtype_combination():
    """A tree of mixed storage: one group per (param, grad, exp_avg,
    exp_avg_sq, cast) combination, in leaf order, each leaf exactly once;
    the optimizer calls the wrapper once per group."""
    bf, f32 = torch.bfloat16, torch.float32
    combos = [(bf, bf, bf, None), (f32, f32, f32, bf), (bf, bf, f32, None),
              (f32, f32, f32, bf), (bf, bf, bf, None), (f32, f32, f32, None)]
    ps, gs, ms, vs, cs = [], [], [], [], []
    for i, (p, m, v, c) in enumerate(combos):
        ps.append(torch.ones(i + 1, dtype=p))
        gs.append(torch.ones(i + 1, dtype=p))
        ms.append(torch.zeros(i + 1, dtype=m))
        vs.append(torch.zeros(i + 1, dtype=v))
        cs.append(None if c is None else torch.empty(i + 1, dtype=c))
    groups = fused_adam.group_by_dtypes(ps, gs, ms, vs, cs)
    assert list(groups.values()) == [[0, 4], [1, 3], [2], [5]]
    assert sorted(i for idx in groups.values() for i in idx) == list(
        range(len(combos)))
    for key, idx in groups.items():
        assert all((ps[i].dtype, gs[i].dtype, ms[i].dtype, vs[i].dtype,
                    None if cs[i] is None else cs[i].dtype) == key
                   for i in idx)
    assert fused_adam.group_by_dtypes(ps, gs, ms, vs) == {
        (bf, bf, bf, bf, None): [0, 4], (f32, f32, f32, f32, None): [1, 3, 5],
        (bf, bf, bf, f32, None): [2]}


def test_optimizer_calls_the_wrapper_once_per_group(monkeypatch):
    """Mixed-dtype params under mode fused: each group goes to the
    wrapper once with exactly its leaves, and the results equal the
    plain update's (the wrapper's plain version on the CPU) bit for
    bit."""
    rs = np.random.RandomState(5)
    leaves = {"a": ((4, 3), torch.bfloat16), "b": ((7,), torch.float32),
              "c": ((), torch.bfloat16), "d": ((2, 5), torch.float32)}

    def tree(scale=1.0):
        return {k: torch.from_numpy(np.asarray(rs.randn(*s) * scale,
                                               np.float32)).to(d)
                for k, (s, d) in leaves.items()}

    p1, g = tree(), tree()
    p2 = {k: t.clone() for k, t in p1.items()}
    opt = adam.FusedAdam(lr=1e-2, betas=(0.9, 0.95), weight_decay=0.01)
    s1 = adam.AdamState(0, tree(0.1), {k: t.abs() for k, t in
                                       tree(1e-3).items()})
    s2 = adam.AdamState(0, {k: t.clone() for k, t in s1.exp_avg.items()},
                        {k: t.clone() for k, t in s1.exp_avg_sq.items()})
    seen = []

    def spy(ps, *args, **kwargs):
        seen.append([p.dtype for p in ps])
        return fused_adam.fused_adam(ps, *args, **kwargs)

    monkeypatch.setattr(adam, "fused_adam", spy)
    with kc.override(mode="fused"):
        opt.update(g, s1, p1)
    with kc.override(mode="off"):
        opt.update(g, s2, p2)
    assert seen == [[torch.bfloat16, torch.bfloat16],
                    [torch.float32, torch.float32]]
    for k in leaves:
        assert torch.equal(p1[k], p2[k])
        assert torch.equal(s1.exp_avg[k], s2.exp_avg[k])
        assert torch.equal(s1.exp_avg_sq[k], s2.exp_avg_sq[k])


def test_wrapper_refuses_devices_it_has_no_kernel_for():
    p = torch.ones(3, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_adam.fused_adam([p], [p], [p], [p], None,
                              *fused_adam.adam_scalars(1e-3, 1, 0.9, 0.95,
                                                       True),
                              b1=0.9, b2=0.95, eps=1e-8, wd=0.0,
                              adam_w=True)


def test_adam_scalars_are_the_reference_fp32_bias_corrections():
    for step in (1, 2, 10, 1000):
        lr, bc1, bc2 = fused_adam.adam_scalars(3e-4, step, 0.9, 0.95, True)
        assert lr.dtype == bc1.dtype == bc2.dtype == np.float32
        want1 = jnp.float32(1.0) - jnp.float32(0.9) ** jnp.float32(step)
        want2 = jnp.float32(1.0) - jnp.float32(0.95) ** jnp.float32(step)
        assert bc1 == np.float32(want1) and bc2 == np.float32(want2)
    assert fused_adam.adam_scalars(1e-3, 5, 0.9, 0.95, False)[1:] == (1, 1)
    assert jax.devices()[0].platform == "cpu"
