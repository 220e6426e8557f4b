"""Mixture-of-Experts with expert parallelism through the engine: the
port over gloo ranks (tests/torch_gloo_worker.py) against the JAX
reference engine on a CPU device mesh of the same shape, from the same
fp32 weights and batches.

* ``initialize`` -> ``train_batch`` for 3 steps at ``{data: 2,
  expert: 2}`` under ZeRO 1 (a tiny MoE GPT, dense and dropless EP): each
  rank holds 2 of 4 experts, the losses within LOSS_RTOL and the params
  after the last step within PARAM_ATOL of the reference engine's on
  the same mesh (Adam turns ulp-level grad differences into visible
  weight moves: measured up to 1.7e-5);
* a checkpoint saved at world 4 (the expert leaves gathered whole, the
  reference's files) loads bit for bit into a world-1 port engine and
  into the reference engine;
* an MoE model with a ``"comm"`` block over 2 data ranks is refused with
  its reason; at one data rank it trains;
* a loss built without a mesh trains on the engine's 2 data ranks with
  the reference engine's losses (the engine's active mesh).
"""

import json
import os
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu
import deeperspeed_tpu_torch
from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.parallel import topology as jax_topology
from deeperspeed_tpu_torch.models import convert, gpt
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
PARAM_ATOL = 5e-5

MODEL = dict(vocab_size=61, n_layer=2, n_head=2, d_model=32, max_seq=16,
             moe_num_experts=4, attn_impl="xla")
IMPLS = ("dense", "dropless")


def _gpt_data(d):
    jcfg = jax_gpt.GPTConfig(**MODEL, dtype=jnp.float32)
    jparams = jax_gpt.make_gpt(jcfg)[0](jax.random.PRNGKey(1))
    tcfg = gpt.GPTConfig(**MODEL, dtype=torch.float32)
    torch.save(convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, "cpu"), d / "moe_params.pt")
    rs = np.random.RandomState(2)
    batches = np.stack([rs.randint(0, 61, (4, 17)).astype(np.int32)
                        for _ in range(worker.MOE_STEPS)])
    np.save(d / "moe_batches.npy", batches)
    (d / "moe_train.json").write_text(json.dumps(
        {"model": MODEL, "impls": list(IMPLS)}))
    return jparams, batches


_RUN = {}


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if not _RUN:
        for world in (4, 2):
            d = tmp_path_factory.mktemp(f"moe_train{world}")
            _RUN[world] = {"dir": d, "gpt": _gpt_data(d)}
        # the two worlds side by side (6 processes of one thread each)
        errors = []

        def dp():
            try:
                worker.spawn("moe_dp_run", 2, _RUN[2]["dir"])
            except Exception as e:  # re-raised below, in the test process
                errors.append(e)

        side = threading.Thread(target=dp)
        side.start()
        try:
            worker.spawn("moe_train_run", 4, _RUN[4]["dir"],
                         {"data": 2, "expert": 2})
        finally:
            side.join(timeout=300)
        assert not side.is_alive()
        if errors:
            raise errors[0]
    return _RUN


def _jax_mesh(dims):
    n = int(np.prod(list(dims.values())))
    return jax_topology.build_mesh(dims, devices=jax.devices()[:n])


def _reference_engine(impl, jparams, load_dir=None, dims=None):
    jcfg = jax_gpt.GPTConfig(**MODEL, moe_dispatch_impl=impl,
                             dtype=jnp.float32)
    mesh = _jax_mesh(dims or {"data": 2, "expert": 2})
    _, _, loss, specs = jax_gpt.make_gpt(jcfg, mesh)
    eng, _, _, _ = deeperspeed_tpu.initialize(
        model=loss, model_parameters=jparams, config=worker.moe_config(),
        mesh=mesh, param_specs=specs)
    if load_dir is not None:
        eng.load_checkpoint(load_dir)
    return eng


@pytest.mark.parametrize("impl", IMPLS)
def test_train_batch_matches_the_reference_engine(run, impl):
    jparams, batches = run[4]["gpt"]
    got = _load(run[4]["dir"] / "moe_train.pkl")[impl]
    assert got["local_experts"] == 2 and got["dp"] == 2
    eng = _reference_engine(impl, jparams)
    losses = [float(eng.train_batch(b)) for b in batches]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    want = convert._flatten(jax.tree.map(np.asarray, eng.state.params))
    assert set(got["params"]) == set(want)
    for n, g in got["params"].items():
        np.testing.assert_allclose(g, want[n], atol=PARAM_ATOL, err_msg=n)


def test_checkpoint_at_world_4_loads_at_world_1_and_in_reference(run):
    d = run[4]["dir"]
    saved = _load(d / "moe_train.pkl")["dense"]["params"]
    tcfg = gpt.GPTConfig(**MODEL, dtype=torch.float32)
    _, _, loss, specs = gpt.make_gpt(tcfg)
    eng, _, _, _ = deeperspeed_tpu_torch.initialize(
        model=loss, model_parameters=torch.load(d / "moe_params.pt"),
        config=worker.moe_config(), device="cpu", param_specs=specs)
    tag, _ = eng.load_checkpoint(os.fspath(d / "moe_ckpt"))
    assert tag is not None and eng.global_steps == worker.MOE_STEPS
    for n, t in convert._flatten(eng.params).items():
        np.testing.assert_array_equal(t.detach().numpy(), saved[n])
    jparams, _ = run[4]["gpt"]
    jeng = _reference_engine("dense", jparams, os.fspath(d / "moe_ckpt"),
                             {"data": 1})
    assert int(jeng.global_steps) == worker.MOE_STEPS
    flat = convert._flatten(jax.tree.map(np.asarray, jeng.state.params))
    assert set(flat) == set(saved)
    for n, r in saved.items():
        np.testing.assert_array_equal(flat[n], r, err_msg=n)


def test_comm_block_refused_over_data_ranks_accepted_at_one(run):
    """The reference's comm step runs an MoE loss per shard, the port's
    computes the global batch's: over 2 data ranks the pair is refused,
    naming why; at one data rank there is nothing to reduce, and the
    engine trains."""
    why = _load(run[4]["dir"] / "moe_train.pkl")["comm_refusal"]
    assert why is not None and "comm" in why and "per shard" in why
    tcfg = gpt.GPTConfig(**MODEL, dtype=torch.float32)
    _, _, loss, specs = gpt.make_gpt(tcfg)
    eng, _, _, _ = deeperspeed_tpu_torch.initialize(
        model=loss, model_parameters=torch.load(
            run[4]["dir"] / "moe_params.pt"),
        config=dict(worker.moe_config(), comm={"mode": "int8"}),
        device="cpu", param_specs=specs)
    batch = np.random.RandomState(3).randint(0, 61, (4, 17))
    assert np.isfinite(float(eng.train_batch(batch)))


def test_data_parallel_moe_takes_the_engines_mesh(run):
    """A loss built without a mesh (``make_gpt(cfg)``) on the engine's
    default mesh of 2 data ranks: its MoE layers take the engine's active
    mesh, so the routing is the global batch's, and the losses are the
    reference engine's on 2 data devices."""
    got = json.loads((run[2]["dir"] / "moe_dp.json").read_text())
    assert got["dp"] == 2
    jparams, batches = run[2]["gpt"]
    eng = _reference_engine("dense", jparams, dims={"data": 2})
    want = [float(eng.train_batch(b)) for b in batches]
    np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL)
