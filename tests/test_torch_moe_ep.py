"""Mixture-of-Experts with expert parallelism: ``moe_ffn`` over gloo
ranks (tests/torch_gloo_worker.py) against the JAX reference's on a CPU
device mesh of the same shape, from the same fp32 weights and inputs,
at ``{expert: 2}`` (2 ranks) and ``{data: 2, expert: 2}`` (4 ranks; each
rank holds its data rank's rows and 2 of the 4 experts): the dense
dispatch (capacity 1.25 and, forcing drops, 0.5) and dropless EP (buffer
factor 2.0, no drops, and 0.5, forcing drops) against the reference's
``moe_ffn`` on the whole batch over ``build_mesh`` of the same dims: y
within Y_RTOL/Y_ATOL, aux and z within AUX_RTOL, ``dropped_frac`` within
AUX_RTOL (XLA's fused mean differs by an ulp), the grads of every param
(the mean over the data ranks, each rank's expert chunk) and of x (each
rank's rows) within GRAD_RTOL/GRAD_ATOL of ``jax.grad`` of the global
loss; the dense leaves' grads agree exactly across the expert ranks.
The engine over the same meshes: tests/test_torch_moe_ep_train.py.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.models import moe as jax_moe
from deeperspeed_tpu.parallel import topology as jax_topology
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

Y_RTOL, Y_ATOL = 1e-5, 1e-7
AUX_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 2e-6

E, K, D, F_, B, S = 4, 2, 16, 32, 4, 8
CASES = [("dense", {"dispatch_impl": "dense"}),
         ("dense-drop", {"dispatch_impl": "dense", "capacity_factor": 0.5}),
         ("ep", {"dispatch_impl": "dropless", "ep_buffer_factor": 2.0}),
         ("ep-drop", {"dispatch_impl": "dropless",
                      "ep_buffer_factor": 0.5})]
MESHES = {2: {"expert": 2}, 4: {"data": 2, "expert": 2}}
LEAVES = (("router", "wg"), ("experts", "wi"), ("experts", "bi"),
          ("experts", "wo"), ("experts", "bo"))


def _ffn_data(d):
    p = jax_moe.init_moe_params(jax.random.PRNGKey(0), D, F_,
                                jax_moe.MoEConfig(num_experts=E, top_k=K))
    rs = np.random.RandomState(0)
    p = jax.tree.map(lambda a: np.asarray(a) + 0.01 * rs.randn(*a.shape)
                     .astype(np.float32), p)
    x = rs.randn(B, S, D).astype(np.float32)
    w = rs.randn(B, S, D).astype(np.float32)
    np.savez(d / "moe_ffn.npz", x=x, w=w, wg=p["router"]["wg"],
             **p["experts"])
    return p, x, w


_RUN = {}


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if not _RUN:
        for world, dims in MESHES.items():
            d = tmp_path_factory.mktemp(f"moe_ep{world}")
            _RUN[world] = {"dir": d, "inputs": _ffn_data(d)}
            cases = [(n, dict(kw, num_experts=E, top_k=K))
                     for n, kw in CASES]
            worker.spawn("moe_ffn_run", world, d, dims, cases)
            _RUN[world]["ranks"] = [_load(d / f"moe_ffn_rank{r}.pkl")
                                    for r in range(world)]
    return _RUN


def _jax_mesh(dims):
    n = int(np.prod(list(dims.values())))
    return jax_topology.build_mesh(dims, devices=jax.devices()[:n])


def _reference_ffn(p, x, w, kw, dims):
    cfg = jax_moe.MoEConfig(num_experts=E, top_k=K, **kw)
    mesh = _jax_mesh(dims)

    def f(params, xx):
        y, aux = jax_moe.moe_ffn(params, xx, cfg, mesh=mesh)
        return jnp.sum(y * w) + aux["aux_loss"] + aux["z_loss"], (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jax.tree.map(jnp.asarray, p),
                                          jnp.asarray(x))
    return (np.asarray(y), {k: float(v) for k, v in aux.items()},
            [np.asarray(gp[a][b]) for a, b in LEAVES], np.asarray(gx))


@pytest.mark.parametrize("world", sorted(MESHES))
@pytest.mark.parametrize("case", [c for c, _ in CASES])
def test_moe_ffn_matches_the_reference_global_result(run, world, case):
    dims = MESHES[world]
    p, x, w = run[world]["inputs"]
    y, aux, grads, gx = _reference_ffn(p, x, w, dict(CASES)[case], dims)
    if case.endswith("drop"):
        assert aux["dropped_frac"] > 0.05
    else:
        assert case == "dense" or aux["dropped_frac"] == 0.0
    dp, ep = dims.get("data", 1), dims["expert"]
    rows = B // dp
    ranks = run[world]["ranks"]
    for r, out in enumerate(ranks):
        got = out[case]
        d, j = divmod(r, ep)
        np.testing.assert_allclose(got["y"], y[d * rows:(d + 1) * rows],
                                   rtol=Y_RTOL, atol=Y_ATOL)
        for k in ("aux_loss", "z_loss", "dropped_frac"):
            np.testing.assert_allclose(got["aux"][k], aux[k],
                                       rtol=AUX_RTOL, err_msg=k)
        np.testing.assert_allclose(got["grads"][-1] / dp,
                                   gx[d * rows:(d + 1) * rows],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
        # the router's grad is whole and the same on every expert rank
        np.testing.assert_array_equal(got["grads"][0],
                                      ranks[d * ep][case]["grads"][0])
    for i, (a, b) in enumerate(LEAVES):
        for j in range(ep):
            mean = np.mean([ranks[d * ep + j][case]["grads"][i]
                            for d in range(dp)], axis=0)
            want = grads[i]
            if a == "experts":
                n = E // ep
                want = want[j * n:(j + 1) * n]
            np.testing.assert_allclose(mean, want, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=f"{a}/{b}")
