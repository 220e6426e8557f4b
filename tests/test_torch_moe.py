"""Mixture-of-Experts in the port (models/moe.py, the MoE GPT of
models/gpt.py) against the JAX reference (deeperspeed_tpu/models/moe.py)
on the same fp32 weights and inputs, in one process (world 1; the
data x expert mesh: tests/test_torch_moe_ep.py).

* ``moe_ffn`` for the dense, sorted and dropless dispatches, gates raw
  and renormalized: ``y`` within Y_RTOL/Y_ATOL, ``aux_loss`` and
  ``z_loss`` within AUX_RTOL, ``dropped_frac`` equal exactly (a count
  over the same assignments), and the grads of x and of every param
  within GRAD_RTOL/GRAD_ATOL of ``jax.grad``. The frameworks sum fp32 in
  other orders (measured: y within 4e-9, grads within 8e-7 of values
  around 1e-1);
* a skewed router forces drops: the same drops, the same outputs;
* the routing pieces bit for bit: ``router_topk``'s choices,
  ``sorted_assignments``, ``top_k_gating``'s one-hot dispatch and combine,
  and the (E, C, D) buffers that "dense" and "sorted" build by index equal
  the reference's one-hot einsum buffers;
* ``init_moe_params``, ``moe_param_specs``, the loss terms and the
  config against the reference's.

The MoE GPT, its serving and speculative verify:
tests/test_torch_moe_gpt.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.models import moe as jax_moe
from deeperspeed_tpu_torch.models import gpt, moe

torch.set_num_threads(1)

Y_RTOL, Y_ATOL = 1e-5, 1e-7
AUX_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 2e-6

E, K, D, F_, B, S = 4, 2, 16, 32, 2, 12
LEAVES = (("router", "wg"), ("experts", "wi"), ("experts", "bi"),
          ("experts", "wo"), ("experts", "bo"))


def _inputs(seed=0, skew=0.0):
    """Reference-initialized MoE params (biases made non-zero) and x."""
    cfg = jax_moe.MoEConfig(num_experts=E, top_k=K)
    p = jax_moe.init_moe_params(jax.random.PRNGKey(seed), D, F_, cfg)
    rs = np.random.RandomState(seed)
    p = jax.tree.map(lambda a: np.asarray(a) + 0.01 * rs.randn(*a.shape)
                     .astype(np.float32), p)
    if skew:
        # every token's top choice is expert 0: drops at any capacity
        p["router"]["wg"][:, 0] += skew
    x = rs.randn(B, S, D).astype(np.float32)
    x[..., 0] = np.abs(x[..., 0]) + 1.0
    w = rs.randn(B, S, D).astype(np.float32)
    return p, x, w


def _reference(p, x, w, kw):
    cfg = jax_moe.MoEConfig(num_experts=E, top_k=K, **kw)

    def f(params, xx):
        y, aux = jax_moe.moe_ffn(params, xx, cfg)
        return jnp.sum(y * w) + aux["aux_loss"] + aux["z_loss"], (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(x))
    grads = [np.asarray(gp[a][b]) for a, b in LEAVES] + [np.asarray(gx)]
    return (np.asarray(y), {k: np.asarray(v) for k, v in aux.items()},
            grads)


def _port(p, x, w, kw):
    cfg = moe.MoEConfig(num_experts=E, top_k=K, **kw)
    params = {a: {b: torch.tensor(v, requires_grad=True)
                  for b, v in sub.items()} for a, sub in p.items()}
    xt = torch.tensor(x, requires_grad=True)
    y, aux = moe.moe_ffn(params, xt, cfg)
    loss = (y * torch.tensor(w)).sum() + aux["aux_loss"] + aux["z_loss"]
    grads = torch.autograd.grad(
        loss, [params[a][b] for a, b in LEAVES] + [xt])
    return (y.detach().numpy(),
            {k: v.detach().numpy() for k, v in aux.items()},
            [g.numpy() for g in grads])


def _check(got, want):
    (gy, gaux, gg), (wy, waux, wg) = got, want
    np.testing.assert_allclose(gy, wy, rtol=Y_RTOL, atol=Y_ATOL)
    for k in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(gaux[k], waux[k], rtol=AUX_RTOL)
    assert gaux["dropped_frac"] == waux["dropped_frac"]
    for (a, b), g, r in zip(LEAVES + (("x", ""),), gg, wg):
        np.testing.assert_allclose(g, r, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"grad of {a}/{b}")


@pytest.mark.parametrize("impl", ["dense", "sorted", "dropless"])
@pytest.mark.parametrize("normalize", [False, True])
def test_moe_ffn_matches_reference(impl, normalize):
    p, x, w = _inputs()
    kw = dict(dispatch_impl=impl, normalize_gates=normalize)
    got, want = _port(p, x, w, kw), _reference(p, x, w, kw)
    _check(got, want)


@pytest.mark.parametrize("impl", ["dense", "sorted"])
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_skewed_router_forces_the_same_drops(impl, cf):
    p, x, w = _inputs(1, skew=4.0)
    kw = dict(dispatch_impl=impl, capacity_factor=cf)
    got, want = _port(p, x, w, kw), _reference(p, x, w, kw)
    assert got[1]["dropped_frac"] > 0.05
    _check(got, want)


def test_routing_pieces_bit_for_bit():
    rs = np.random.RandomState(3)
    T = B * S
    logits = rs.randn(T, E).astype(np.float32)
    logits[::5, 1] = logits[::5, 2]  # ties go to the lower index
    for normalize in (False, True):
        jp, ji, jg = jax_moe.router_topk(jnp.asarray(logits), K, normalize)
        tp, ti, tg = moe.router_topk(torch.tensor(logits), K, normalize)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
    idx = np.asarray(ji).astype(np.int64)
    for cap in (3, 5, 8, T):
        want = jax_moe.sorted_assignments(jnp.asarray(idx), cap, E)
        got = moe.sorted_assignments(torch.tensor(idx), cap, E)
        for g, r in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    cap = 5
    jd, jc, jaux = jax_moe.top_k_gating(jnp.asarray(logits), K, cap)
    td, tc, taux = moe.top_k_gating(torch.tensor(logits), K, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"])
    np.testing.assert_allclose(taux["top1_frac"].numpy(),
                               np.asarray(jaux["top1_frac"]), rtol=1e-6)
    # the index-built buffers are the one-hot einsum's
    xt = rs.randn(T, D).astype(np.float32)
    want = np.asarray(jnp.einsum("tec,td->ecd", jd, jnp.asarray(xt)))
    pos, _, _ = moe._choice_positions(torch.tensor(idx), E, None)
    for impl in ("dense", "sorted"):
        got = moe.expert_buffers(torch.tensor(xt), torch.tensor(idx), pos,
                                 cap, E, impl)
        np.testing.assert_array_equal(got.numpy(), want)


def test_losses_config_and_specs():
    rs = np.random.RandomState(4)
    logits = rs.randn(24, E).astype(np.float32)
    np.testing.assert_allclose(
        float(moe.router_z_loss(torch.tensor(logits))),
        float(jax_moe.router_z_loss(jnp.asarray(logits))), rtol=1e-6)
    mp, tf = rs.rand(E).astype(np.float32), rs.rand(E).astype(np.float32)
    np.testing.assert_allclose(
        float(moe.load_balancing_loss(torch.tensor(mp), torch.tensor(tf), E)),
        float(jax_moe.load_balancing_loss(jnp.asarray(mp), jnp.asarray(tf),
                                          E)), rtol=1e-6)
    for n, impl in ((8, "auto"), (16, "auto"), (8, "dropless")):
        assert (moe.MoEConfig(num_experts=n, dispatch_impl=impl)
                .resolved_dispatch_impl()
                == jax_moe.MoEConfig(num_experts=n, dispatch_impl=impl)
                .resolved_dispatch_impl())
    kw = dict(moe_num_experts=8, moe_top_k=1, moe_dispatch_impl="sorted")
    assert dataclasses.asdict(gpt.GPTConfig(**kw).moe) == \
        dataclasses.asdict(jax_gpt.GPTConfig(**kw).moe)
    assert gpt.GPTConfig().moe is None
    specs = moe.moe_param_specs()
    assert specs["experts"]["wi"] == ("expert", None, None)
    assert specs["router"]["wg"] == (None, None)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe_params(gen, D, F_, moe.MoEConfig(num_experts=E),
                            out_std=0.001)
    jp = jax_moe.init_moe_params(jax.random.PRNGKey(0), D, F_,
                                 jax_moe.MoEConfig(num_experts=E))
    for a, b in LEAVES:
        assert tuple(p[a][b].shape) == tuple(jp[a][b].shape)
    assert float(p["experts"]["bi"].abs().max()) == 0.0
    assert 0.0005 < float(p["experts"]["wo"].std()) < 0.002


def test_expert_mesh_axes_as_reference():
    """A legacy ``{data, expert}`` mesh: the batch splits over ``data``
    only and ZeRO shards over it, as the reference's rules say;
    ``build_mesh`` infers a -1 extent and lays the ranks out row-major
    (the reference's device order on a CPU mesh); ``filter_spec`` drops
    the axes a mesh lacks or holds at size 1; the pipeline axis is laid
    out as the reference's."""
    from jax.sharding import PartitionSpec as P

    from deeperspeed_tpu.parallel import topology as jax_topology
    from deeperspeed_tpu.sharding import rules as jax_rules
    from deeperspeed_tpu_torch.parallel import topology
    from deeperspeed_tpu_torch.sharding import rules

    for dims in ({"data": 2, "expert": 2}, {"expert": 4},
                 {"data": -1, "expert": 2}):
        mesh = topology.build_mesh(dims, world=4)
        jmesh = jax_topology.build_mesh(dims, devices=jax.devices()[:4])
        assert mesh.shape == dict(jmesh.shape)
        assert rules.batch_axes(mesh) == jax_rules.batch_axes(jmesh)
        assert rules.zero_axis(mesh) == jax_rules.zero_axis(jmesh)
        assert (rules.data_parallel_size(mesh)
                == jax_rules.data_parallel_size(jmesh))
        ids = np.vectorize(lambda d: d.id)(jmesh.devices)
        for r in range(4):
            c = mesh.coords(r)
            assert ids[tuple(c[a] for a in mesh.axis_names)] == r
        for spec in ((None, "expert", None), (("data", "expert"), None),
                     ("model", "data")):
            want = jax_topology.filter_spec(P(*spec), jmesh)
            assert topology.filter_spec(spec, mesh) == tuple(want)
    # the pipeline axis is ported (the pipeline engine): laid out as the
    # reference lays it out
    mesh = topology.build_mesh({"pipe": 2, "data": 2}, world=4)
    jmesh = jax_topology.build_mesh({"pipe": 2, "data": 2},
                                    devices=jax.devices()[:4])
    assert mesh.shape == dict(jmesh.shape)
    assert rules.data_parallel_size(mesh) == 2
    # the tensor axis is ported (tests/test_torch_topology.py)
    assert topology.build_mesh({"model": 2, "data": 2},
                               world=4).shape == {"model": 2, "data": 2}
    with pytest.raises(ValueError, match="require 8 devices"):
        topology.build_mesh({"data": 2, "expert": 4}, world=4)
    assert topology.ProcessTopology(["data"], [2]).world_size() == 2

