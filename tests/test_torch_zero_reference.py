"""The port's data-parallel engine against the reference's: a tiny GPT
(2 layers, d_model 64) trains 6 steps at ZeRO 1 on 2 gloo ranks
(tests/torch_gloo_worker.py) and on the reference engine over a 2-device
CPU mesh, from the same weights and batches, with no comm block, with
``"comm": {"mode": "fp32"}`` and with int8. The loss curves agree within
``LOSS_RTOL`` of tests/test_torch_training.py: fp32 on both sides, where
the frameworks sum in other orders and Adam turns ulp-level gradient
differences into visible weight moves; int8 adds the ulp-level FMA
differences of the reference's jitted row sums that
tests/test_torch_comm.py states."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import deeperspeed_tpu
from deeperspeed_tpu.ops import kernel_config as jax_kc
from tests import torch_gloo_worker as worker
from tests.test_torch_zero_training import _batches, spawn_training

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
COMMS = (None, "fp32", "int8")
_RUN = {}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if not _RUN:
        _RUN["ranks"], _RUN["jparams"], _RUN["jloss"] = spawn_training(
            tmp_path_factory.mktemp("zeroref"), [(1, c) for c in COMMS],
            False)
    return _RUN


@pytest.mark.parametrize("comm", COMMS)
def test_curves_match_the_reference_engine(run, comm):
    cfg = worker.train_config(1, None if comm is None else {"mode": comm})
    cfg["kernels"] = {"mode": "auto"}
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("data",))
    with jax_kc.override():
        jeng, _, _, _ = deeperspeed_tpu.initialize(
            model=run["jloss"], model_parameters=run["jparams"], config=cfg,
            mesh=mesh)
        jl = [float(jeng.train_batch(b)) for b in _batches()]
    assert jeng.data_parallel_size == 2
    for rank in run["ranks"]:
        np.testing.assert_allclose(rank[f"1/{comm}"]["losses"], jl,
                                   rtol=LOSS_RTOL)
