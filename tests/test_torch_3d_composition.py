"""3D composition of the port's SPMD pipeline (runtime/pipe/spmd.py):
the counterparts of tests/test_3d_composition.py's cases.

The reference runs pipe x data x model in one jitted program on a 2x2x2
CPU mesh; a 2x2x2 world of the port would be 8 gloo processes, so the
port runs ``{pipe: 2, model: 2}`` (the stage megatron-cut over the model
axis, its row-parallel sum through parallel/tp.py's f/g) and ``{pipe: 2,
data: 2}`` (the microbatch rows split over the data axis, the loss and
grads averaged over it) in one 4-rank spawn, and ``{pipe: 2}`` in one
2-rank spawn (tests/torch_gloo_worker.py). SGD over 5 steps, as the
reference's test (an update proportional to the gradient, so a dp- or
tp-scaled gradient shows): each run against the reference's program on a
CPU mesh of the same shape, and against the port's pipe-only run, at
rtol / atol 2e-5.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deeperspeed_tpu.ops.adam import FusedAdam as JaxAdam
from deeperspeed_tpu.ops.sgd import SGD as JaxSGD
from deeperspeed_tpu.parallel import build_mesh as jax_build_mesh
from deeperspeed_tpu.parallel.tp import (copy_to_tp_region,
                                         reduce_from_tp_region)
from deeperspeed_tpu.runtime.pipe.spmd import make_spmd_pipeline_train_step
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

PP = 2
D, F = 16, 32
M, MB = 4, 8
STEPS = 5
SGD_LR, ADAM_LR = 5e-2, 1e-2
RTOL = ATOL = 2e-5
MESHES = {"pipe_model": {"pipe": PP, "model": 2},
          "pipe_data": {"pipe": PP, "data": 2}}


def _init_params():
    rng = np.random.default_rng(0)
    return {
        "wi": (rng.normal(size=(PP, D, F)) * 0.2).astype(np.float32),
        "bi": np.zeros((PP, F), np.float32),
        "wo": (rng.normal(size=(PP, F, D)) * 0.2).astype(np.float32),
        "bo": np.zeros((PP, D), np.float32),
    }


def _data():
    rng = np.random.default_rng(1)
    return (rng.normal(size=(M, MB, D)).astype(np.float32),
            rng.normal(size=(M, MB, D)).astype(np.float32))


def _loss_fn(outputs, labels):
    return jnp.mean((outputs - labels) ** 2)


def _stage_fn(p, x):
    xin = copy_to_tp_region(x)
    h = jnp.tanh(xin @ p["wi"] + p["bi"])
    y = reduce_from_tp_region(h @ p["wo"])
    return x + y + p["bo"]


def _stage_fn_dense(p, x):
    h = jnp.tanh(x @ p["wi"] + p["bi"])
    return x + h @ p["wo"] + p["bo"]


PARAM_SPECS = {"wi": P("pipe", None, "model"), "bi": P("pipe", "model"),
               "wo": P("pipe", "model", None), "bo": P("pipe", None)}


def _port_case(name, mesh_name, opt, steps):
    dims = MESHES.get(mesh_name, {"pipe": PP})
    tp = "model" in dims
    mbs, labels = _data()
    return dict(name=name, mode="train", dims=dims,
                stage="tp" if tp else "dense",
                specs=worker.SPMD_3D_SPECS if tp else None,
                params=_init_params(), mbs=mbs, labels=labels, M=M,
                schedule="1f1b", remat=False, opt=opt,
                lr=SGD_LR if opt == "sgd" else ADAM_LR, steps=steps)


def _reference(mesh_name, opt, steps):
    dims = MESHES.get(mesh_name, {"pipe": PP})
    n = int(np.prod(list(dims.values())))
    mesh = jax_build_mesh(dims, devices=jax.devices()[:n])
    tp = "model" in dims
    params = jax.tree.map(jnp.asarray, _init_params())
    o = JaxSGD(lr=SGD_LR) if opt == "sgd" else JaxAdam(lr=ADAM_LR)
    lr = SGD_LR if opt == "sgd" else ADAM_LR
    state = o.init(params)
    step = make_spmd_pipeline_train_step(
        _stage_fn if tp else _stage_fn_dense, _loss_fn, o, num_stages=PP,
        micro_batches=M, mesh=mesh, remat=False,
        param_specs=PARAM_SPECS if tp else None, schedule="1f1b")
    x, y = (jnp.asarray(a) for a in _data())
    losses = []
    with mesh:
        for _ in range(steps):
            (params, state), loss = step(params, state, x, y, lr)
            losses.append(float(jax.device_get(loss)))
    return losses, jax.tree.map(np.asarray, jax.device_get(params))


_RUN = {}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if not _RUN:
        d4 = tmp_path_factory.mktemp("spmd3d_world4")
        cases4 = [_port_case(f"{m}/{o}", m, o, STEPS if o == "sgd" else 1)
                  for m in MESHES for o in ("sgd", "adam")]
        d2 = tmp_path_factory.mktemp("spmd3d_world2")
        cases2 = [_port_case("pipe/sgd", "pipe", "sgd", STEPS)]
        worker.spawn("spmd_runs", 4, d4, cases4)
        worker.spawn("spmd_runs", 2, d2, cases2)
        for d, world in ((d4, 4), (d2, 2)):
            for r in range(world):
                with open(d / f"spmd_rank{r}.pkl", "rb") as f:
                    for k, v in pickle.load(f).items():
                        _RUN.setdefault(k, []).append(v)
    return _RUN


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_3d_matches_pipe_only(run, mesh_name):
    """The model-axis psum and the data-axis mean restructure the math
    exactly: the 3D run follows the pipe-only trajectory, and each run
    follows the reference's program on its mesh."""
    ref, ref_params = _reference(mesh_name, "sgd", STEPS)
    ref_pp, _ = _reference("pipe", "sgd", STEPS)
    np.testing.assert_allclose(ref, ref_pp, rtol=RTOL, atol=ATOL)
    pipe_only = run["pipe/sgd"]
    for r in pipe_only:
        np.testing.assert_allclose(r["losses"], ref_pp, rtol=RTOL, atol=ATOL)
    for r in run[f"{mesh_name}/sgd"]:
        np.testing.assert_allclose(r["losses"], ref, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r["losses"], pipe_only[0]["losses"],
                                   rtol=RTOL, atol=ATOL)
        assert r["losses"][-1] < r["losses"][0], r["losses"]
        for k, v in ref_params.items():
            np.testing.assert_allclose(r["params"][k], v, rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_3d_param_shards_update_consistently(run, mesh_name):
    """After one Adam step the gathered params are finite, changed, the
    same on every rank and the reference's."""
    _, ref_params = _reference(mesh_name, "adam", 1)
    before = _init_params()
    got = run[f"{mesh_name}/adam"]
    for k in before:
        after = got[0]["params"][k]
        assert np.isfinite(after).all()
        if k == "wi":
            assert not np.allclose(after, before[k])
        for r in got[1:]:
            np.testing.assert_array_equal(r["params"][k], after)
        np.testing.assert_allclose(after, ref_params[k], rtol=1e-4,
                                   atol=1e-6)


def test_param_specs_must_lead_with_pipe():
    from deeperspeed_tpu_torch.ops.adam import FusedAdam
    from deeperspeed_tpu_torch.parallel import build_mesh
    from deeperspeed_tpu_torch.runtime.pipe import (
        make_spmd_pipeline_train_step as port_train_step)

    mesh = build_mesh(MESHES["pipe_model"], world=4)
    bad = dict(worker.SPMD_3D_SPECS, wi=(None, None, "model"))
    with pytest.raises(AssertionError, match="pipe"):
        port_train_step(worker.spmd_dense_stage, worker.spmd_mse,
                        FusedAdam(lr=1e-2), num_stages=PP, micro_batches=M,
                        mesh=mesh, param_specs=bad, schedule="1f1b",
                        device="cpu")
