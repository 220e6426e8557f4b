"""The port's tensor-parallel layers (parallel/tp.py) over 2 gloo ranks
(tests/torch_gloo_worker.py) against the JAX reference's layers on a CPU
device mesh of the same shape, from the same fp32 weights and inputs.
Mirrors tests/test_tp.py:

* the column -> row pair, ``ParallelMLP``, a gathered column layer, a
  row layer taking a whole input, and ``VocabParallelEmbedding``: each
  output, and the grads of the input and of every param (gathered whole)
  for ``sum(out * w)``, within RTOL of ``jax.grad`` of the reference's;
* Megatron's f and g are autograd Functions for a reason: a plain
  differentiable all-reduce in place of g (its backward all-reduces too)
  gives the column layer's grads twice over, and the pair without f gives
  each rank only its share of the input's grad;
* the ``ModelParallelUnit`` answers from the mesh, its group the tp
  axis's process group.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from deeperspeed_tpu.parallel import (ColumnParallelLinear, ParallelMLP,
                                      RowParallelLinear,
                                      VocabParallelEmbedding, build_mesh)
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
DIMS = {"model": 2}
D, F, V = 16, 32, 50

_RUN = {}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if not _RUN:
        d = tmp_path_factory.mktemp("tp_layers")
        rs = np.random.RandomState(0)
        data = {
            "col_w": rs.normal(0, 0.3, (D, F)), "col_b": rs.normal(0, 0.1, F),
            "row_w": rs.normal(0, 0.3, (F, D)), "row_b": rs.normal(0, 0.1, D),
            "emb_w": rs.normal(0, 0.3, (V, D)), "x": rs.normal(size=(4, D)),
            "h": rs.normal(size=(4, F)), "w_out": rs.normal(size=(4, D)),
            "w_col": rs.normal(size=(4, F)),
            "w_emb": rs.normal(size=(2, 3, D)),
            "tok": np.array([[1, 4, 9], [0, 2, 49]])}
        data = {k: (v.astype(np.float32) if v.dtype.kind == "f" else v)
                for k, v in data.items()}
        np.savez(d / "tp_layers.npz", **data)
        worker.spawn("tp_layers_run", 2, d, DIMS)
        ranks = []
        for r in range(2):
            with open(os.path.join(d, f"tp_layers_rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        _RUN.update(data=data, ranks=ranks)
    return _RUN


def _mesh():
    return build_mesh(DIMS, devices=jax.devices()[:2])


def _place(mesh, params, specs):
    from jax.sharding import PartitionSpec as P

    return jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(
        mesh, P(*s))), params, specs,
        is_leaf=lambda s: isinstance(s, tuple) or s is None)


def _reference(name, data):
    """(out, {param grads}, x grad) of the reference's layer ``name``."""
    mesh = _mesh()
    col = {"w": data["col_w"], "b": data["col_b"]}
    row = {"w": data["row_w"], "b": data["row_b"]}
    if name == "pair":
        c = ColumnParallelLinear(D, F, mesh=mesh)
        r = RowParallelLinear(F, D, mesh=mesh)
        params = {"col": col, "row": row}
        specs = {"col": c.specs, "row": r.specs}
        fn = lambda p, x: r.apply(p["row"], c.apply(p["col"], x))  # noqa
        x, w = data["x"], data["w_out"]
    elif name == "mlp":
        m = ParallelMLP(D, F, mesh=mesh)
        params, specs = {"up": col, "down": row}, m.specs
        fn, x, w = m.apply, data["x"], data["w_out"]
    elif name == "gather_col":
        c = ColumnParallelLinear(D, F, gather_output=True, mesh=mesh)
        params, specs, fn = col, c.specs, c.apply
        x, w = data["x"], data["w_col"]
    elif name == "row_scatter":
        r = RowParallelLinear(F, D, input_is_parallel=False, mesh=mesh)
        params, specs, fn = row, r.specs, r.apply
        x, w = data["h"], data["w_out"]
    else:
        e = VocabParallelEmbedding(V, D, mesh=mesh)
        params, specs, fn = {"w": data["emb_w"]}, e.specs, e.apply
        x, w = data["tok"], data["w_emb"]
    params = _place(mesh, jax.tree.map(jnp.asarray, params), specs)

    def loss(p, x):
        return jnp.sum(fn(p, x) * w)

    out = jax.jit(fn)(params, jnp.asarray(x))
    if name == "emb":
        gp = jax.jit(jax.grad(loss))(params, jnp.asarray(x))
        gx = None
    else:
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params,
                                                         jnp.asarray(x))
    return np.asarray(out), gp, gx


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("name", ["pair", "mlp", "gather_col",
                                  "row_scatter", "emb"])
def test_layer_and_grads_match_reference(run, name):
    out, gp, gx = _reference(name, run["data"])
    want = _flat(gp)
    for rank in run["ranks"]:
        got = rank[name]
        np.testing.assert_allclose(got["y"], out, rtol=RTOL, atol=ATOL)
        assert set(got["grads"]) == set(want)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, want[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        if gx is not None:
            np.testing.assert_allclose(got["x_grad"], np.asarray(gx),
                                       rtol=RTOL, atol=ATOL)


def test_plain_all_reduce_in_place_of_g_double_counts(run):
    _, gp, gx = _reference("pair", run["data"])
    want = _flat(gp)
    for rank in run["ranks"]:
        plain = rank["plain_g"]
        # the forward is right ...
        np.testing.assert_allclose(plain["y"], rank["pair"]["y"],
                                   rtol=RTOL, atol=ATOL)
        # ... the backward all-reduces again: the column layer's grads
        # come back tp (2) times over
        for k in ("col/w", "col/b"):
            np.testing.assert_allclose(plain["grads"][k], 2 * want[k],
                                       rtol=RTOL, atol=ATOL)
        assert not np.allclose(plain["grads"]["col/w"], want["col/w"],
                               rtol=1e-2)


def test_the_pair_without_f_under_counts_the_input_grad(run):
    _, _, gx = _reference("pair", run["data"])
    ranks = run["ranks"]
    # each rank holds only its share; their sum is the grad f would give
    shares = [r["no_f"]["x_grad"] for r in ranks]
    assert not np.allclose(shares[0], np.asarray(gx), rtol=1e-2)
    np.testing.assert_allclose(shares[0] + shares[1], np.asarray(gx),
                               rtol=RTOL, atol=ATOL)


def test_model_parallel_unit(run):
    for r, rank in enumerate(run["ranks"]):
        mpu = rank["mpu"]
        assert (mpu["mp_rank"], mpu["mp_size"]) == (r, 2)
        assert (mpu["dp_rank"], mpu["dp_size"]) == (0, 1)
        assert mpu["mp_group_ranks"] == [0, 1]
