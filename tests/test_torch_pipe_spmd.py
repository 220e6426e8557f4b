"""The port's single-program SPMD pipeline (runtime/pipe/spmd.py), one
gloo process a stage (tests/torch_gloo_worker.py, every case in one
2-rank spawn), against the reference's jitted pipeline on a 2-device CPU
mesh, from the same numpy-seeded fp32 weights: the counterparts of
tests/test_pipe_spmd.py's cases.

* the forward matches sequential stage execution (rtol 1e-5, atol 1e-6);
* the "1f1b" and "gpipe" train steps match the reference's step (loss
  rtol 1e-5, params rtol 1e-4 / atol 1e-6);
* training converges; bf16 microbatches through fp32 params give fp32
  outputs;
* 1F1B's saved-input ring stays flat in M (M 4 -> 32), gpipe's saved
  inputs grow;
* a mesh without a pipe axis and a missing schedule raise.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops import FusedAdam as JaxAdam
from deeperspeed_tpu.parallel import build_mesh as jax_build_mesh
from deeperspeed_tpu.runtime.pipe.spmd import (
    make_spmd_pipeline as jax_pipeline,
    make_spmd_pipeline_train_step as jax_train_step,
)
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

S, M, MB, D = 2, 4, 2, 8
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
CONVERGE_STEPS = 61


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(S, D, D)) * 0.4).astype(np.float32),
            "b": np.zeros((S, D), np.float32)}


def _data(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, MB, D)).astype(np.float32),
            rng.normal(size=(M, MB, D)).astype(np.float32))


def _converge_data():
    rs = np.random.RandomState(0)
    mbs = rs.randn(M, MB, D).astype(np.float32)
    target_w = rs.randn(D, D).astype(np.float32) * 0.3
    labels = np.tanh(np.tanh(mbs @ target_w) @ target_w).astype(np.float32)
    return mbs, labels


def _stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _loss_fn(outputs, labels):
    return jnp.mean((outputs - labels) ** 2)


def _jmesh():
    return jax_build_mesh({"pipe": S}, devices=jax.devices()[:S])


def _sequential(params, microbatches):
    outs = []
    for m in range(microbatches.shape[0]):
        x = microbatches[m]
        for s in range(S):
            x = _stage_fn(jax.tree.map(lambda p: p[s], params), x)
        outs.append(x)
    return jnp.stack(outs)


def _case(name, mode, **kw):
    mbs, labels = _data()
    return dict(dict(name=name, mode=mode, dims={"pipe": S}, stage="tanh",
                     params=_params(), mbs=mbs, labels=labels, M=M), **kw)


def _cases():
    cmbs, clabels = _converge_data()
    return [
        _case("fwd", "fwd"),
        _case("fwd_bf16", "fwd", bf16=True),
        _case("1f1b", "train", schedule="1f1b", opt="adam", lr=1e-2,
              steps=1),
        _case("gpipe", "train", schedule="gpipe", opt="adam", lr=1e-2,
              steps=1),
        _case("converge", "train", schedule="1f1b", opt="adam", lr=5e-3,
              steps=CONVERGE_STEPS, mbs=cmbs, labels=clabels),
        _case("memory", "memory"),
    ]


_RUN = {}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if not _RUN:
        d = tmp_path_factory.mktemp("spmd")
        worker.spawn("spmd_runs", S, d, _cases())
        for r in range(S):
            with open(d / f"spmd_rank{r}.pkl", "rb") as f:
                _RUN[r] = pickle.load(f)
    return _RUN


def test_spmd_forward_matches_sequential(run):
    mbs, _ = _data()
    ref = np.asarray(_sequential(jax.tree.map(jnp.asarray, _params()),
                                 jnp.asarray(mbs)))
    with _jmesh():
        jout = np.asarray(jax_pipeline(_stage_fn, num_stages=S,
                                       micro_batches=M, mesh=_jmesh())(
            jax.tree.map(jnp.asarray, _params()), jnp.asarray(mbs)))
    np.testing.assert_allclose(jout, ref, rtol=1e-5, atol=1e-6)
    for r in range(S):
        np.testing.assert_allclose(run[r]["fwd"]["out"], ref, rtol=1e-5,
                                   atol=1e-6)


def _reference_step(schedule, steps=1, lr=1e-2, data=None):
    mbs, labels = data or _data()
    params = jax.tree.map(jnp.asarray, _params())
    opt = JaxAdam(lr=lr)
    state = jax.jit(opt.init)(params)
    mesh = _jmesh()
    step = jax_train_step(_stage_fn, _loss_fn, opt, num_stages=S,
                          micro_batches=M, mesh=mesh, schedule=schedule)
    losses = []
    with mesh:
        for _ in range(steps):
            (params, state), loss = step(params, state, jnp.asarray(mbs),
                                         jnp.asarray(labels),
                                         jnp.float32(lr))
            losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params), \
        jax.tree.map(np.asarray, state.exp_avg)


def _check_step(got, schedule):
    losses, params, exp_avg = _reference_step(schedule)
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    for k in params:
        np.testing.assert_allclose(got["params"][k], params[k],
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL)
        np.testing.assert_allclose(got["exp_avg"][k], exp_avg[k],
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL)


def test_spmd_train_step_matches_unpipelined(run):
    """1f1b against plain autodiff through the sequential stages."""
    mbs, labels = _data()
    params = jax.tree.map(jnp.asarray, _params())

    def ref_loss(p):
        return _loss_fn(_sequential(p, jnp.asarray(mbs)), jnp.asarray(labels))

    ref_l, ref_g = jax.value_and_grad(ref_loss)(params)
    opt = JaxAdam(lr=1e-2)
    ref_params, _ = opt.update(ref_g, jax.jit(opt.init)(params), params,
                               lr=jnp.float32(1e-2))
    for r in range(S):
        got = run[r]["1f1b"]
        np.testing.assert_allclose(got["losses"][0], float(ref_l),
                                   rtol=LOSS_RTOL)
        for k in ref_params:
            np.testing.assert_allclose(got["params"][k],
                                       np.asarray(ref_params[k]),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL)


def test_spmd_training_converges(run):
    for r in range(S):
        losses = run[r]["converge"]["losses"]
        assert losses[-1] < losses[0] / 3, (losses[0], losses[-1])
    ref, _, _ = _reference_step("1f1b", steps=CONVERGE_STEPS, lr=5e-3,
                                data=_converge_data())
    np.testing.assert_allclose(run[0]["converge"]["losses"], ref,
                               rtol=1e-3)


def test_spmd_mixed_dtype_activations(run):
    """bf16 microbatches through fp32 params: the activations take the
    stage output's dtype, as the reference's."""
    mbs, _ = _data()
    with _jmesh():
        jout = jax_pipeline(_stage_fn, num_stages=S, micro_batches=M,
                            mesh=_jmesh())(
            jax.tree.map(jnp.asarray, _params()),
            jnp.asarray(mbs, jnp.bfloat16))
    assert jout.dtype == jnp.float32
    for r in range(S):
        got = run[r]["fwd_bf16"]
        assert got["dtype"] == "torch.float32"
        assert np.isfinite(got["out"]).all()
        np.testing.assert_allclose(got["out"], np.asarray(jout),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
def test_spmd_schedules_match_unpipelined(run, schedule):
    for r in range(S):
        _check_step(run[r][schedule], schedule)


def test_spmd_1f1b_activation_memory_flat_in_microbatches(run):
    """1F1B's saved-input ring holds O(stages) inputs: its bytes stay
    flat as M grows 4 -> 32; gpipe's saved inputs grow with M."""
    for r in range(S):
        got = run[r]["memory"]
        small, big = (got[f"1f1b/{m}"]["ring_bytes"] for m in (4, 32))
        assert 0 < small and big <= small * 2 + 64 * 1024, (small, big)
        g_small, g_big = (got[f"gpipe/{m}"]["saved_bytes"] for m in (4, 32))
        assert g_big >= 4 * g_small > 0, (g_small, g_big)


def test_spmd_requires_pipe_axis():
    from deeperspeed_tpu_torch.parallel import build_mesh
    from deeperspeed_tpu_torch.runtime.pipe import make_spmd_pipeline

    mesh = build_mesh({"data": 2}, world=2)
    with pytest.raises(AssertionError):
        make_spmd_pipeline(worker.spmd_tanh_stage, num_stages=2,
                           micro_batches=2, mesh=mesh, device="cpu")


def test_schedule_must_be_explicit():
    """No default schedule: the error names both and 1f1b's loss
    contract."""
    from deeperspeed_tpu_torch.ops.adam import FusedAdam
    from deeperspeed_tpu_torch.parallel import build_mesh
    from deeperspeed_tpu_torch.runtime.pipe import (
        make_spmd_pipeline_train_step)

    mesh = build_mesh({"pipe": S}, world=S)
    with pytest.raises(ValueError, match="explicit schedule") as e:
        make_spmd_pipeline_train_step(
            worker.spmd_tanh_stage, worker.spmd_mse, FusedAdam(lr=1e-2),
            num_stages=S, micro_batches=M, mesh=mesh, device="cpu")
    assert "gpipe" in str(e.value) and "per-microbatch" in str(e.value)
