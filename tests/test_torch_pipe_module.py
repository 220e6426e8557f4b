"""The port's ``PipelineModule`` (runtime/pipe/module.py) against the JAX
reference's:

* each partition method (``uniform``, ``parameters``, ``type:<regex>``)
  gives the reference's ``parts`` on the same layer lists at 1-4 stages
  ("parameters" counts each layer's params from shapes, on the meta
  device);
* ``tied_stages`` and ``tied_owner_stage`` match;
* ``init_params(stages=...)`` draws a stage's layers as a full draw does;
* checkpoints cross: the port's one-stage engine loads the reference's
  2-stage layer files and ``pipeline_engine_states.msgpack`` (params and
  moments equal, the next step's loss within LOSS_RTOL), and the
  reference loads the port's.
"""

import jax
import numpy as np
import pytest
import torch

import deeperspeed_tpu_torch as pt
from deeperspeed_tpu.parallel import ColumnParallelLinear as RefColumn
from deeperspeed_tpu.parallel import ParallelMLP as RefMLP
from deeperspeed_tpu.runtime.pipe import Embedding as RefEmbedding
from deeperspeed_tpu.runtime.pipe import LayerSpec as RefSpec
from deeperspeed_tpu.runtime.pipe import Linear as RefLinear
from deeperspeed_tpu.runtime.pipe import PipelineModule as RefModule
from deeperspeed_tpu_torch.parallel import ColumnParallelLinear, ParallelMLP
from deeperspeed_tpu_torch.runtime.pipe import (Embedding, LayerSpec, Linear,
                                                PipelineModule)
from tests import test_torch_pipe_engine as eng_test
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

LOSS_RTOL = 1e-5


def _lists():
    """(name, reference layers, port layers) of the partition cases."""
    return {
        "mlp": ([RefSpec(RefLinear, 8, 16), RefSpec(jax.nn.relu),
                 RefSpec(RefLinear, 16, 16), RefSpec(jax.nn.relu),
                 RefSpec(RefLinear, 16, 4)],
                [LayerSpec(Linear, 8, 16), torch.relu,
                 LayerSpec(Linear, 16, 16), torch.relu,
                 LayerSpec(Linear, 16, 4)]),
        "mixed": ([RefSpec(RefEmbedding, 50, 8), RefSpec(RefLinear, 8, 32),
                   RefSpec(jax.nn.relu), RefSpec(RefLinear, 32, 8),
                   RefSpec(RefMLP, 8, 64), RefSpec(RefColumn, 8, 24),
                   RefSpec(RefLinear, 24, 2, bias=False)],
                  [LayerSpec(Embedding, 50, 8), LayerSpec(Linear, 8, 32),
                   torch.relu, LayerSpec(Linear, 32, 8),
                   LayerSpec(ParallelMLP, 8, 64),
                   LayerSpec(ColumnParallelLinear, 8, 24),
                   LayerSpec(Linear, 24, 2, bias=False)]),
    }


PARTITIONS = [(name, method, stages)
              for name in ("mlp", "mixed", "bert")
              for method in ("uniform", "parameters", "type:linear")
              for stages in (1, 2, 3, 4)
              if not (name == "bert" and method == "type:linear")]


def _modules(name, method, stages):
    if name == "bert":
        ref = eng_test.reference_module("bert", 1)
        port = worker.pipe_module("bert", 1)
        ref_layers, port_layers = ref._orig, port._orig
        if method == "type:linear":
            method = "type:transformer"
    else:
        ref_layers, port_layers = _lists()[name]
    return (RefModule(ref_layers, num_stages=stages,
                      partition_method=method),
            PipelineModule(port_layers, num_stages=stages,
                           partition_method=method))


@pytest.mark.parametrize("name,method,stages", PARTITIONS)
def test_partitions_equal_reference(name, method, stages):
    ref, port = _modules(name, method, stages)
    assert port.parts == ref.parts
    for s in range(stages):
        assert (list(port.stage_layer_indices(s))
                == list(ref.stage_layer_indices(s)))


@pytest.mark.parametrize("stages", [1, 2, 3])
def test_tied_stages_and_owner_equal_reference(stages):
    from deeperspeed_tpu.runtime.pipe import TiedLayerSpec as RefTied

    ref = eng_test.reference_module("bert", stages)
    port = worker.pipe_module("bert", stages)
    assert port.tied_specs == ref.tied_specs
    for key in ref.tied_specs:
        assert port.tied_stages(key) == ref.tied_stages(key)
        assert port.tied_owner_stage(key) == ref.tied_owner_stage(key)
    assert isinstance(ref._layer_specs[0], RefTied)
    if stages > 1:
        assert port.tied_stages("embed") == [0, stages - 1]


def test_stage_init_draws_as_full_init():
    mod = worker.pipe_module("bert", 2)
    full = mod.init_params(11)
    part = mod.init_params(11, stages=[1])
    assert part["layers"][0] is None and part["layers"][1] is None
    for i in mod.stage_layer_indices(1):
        a, b = full["layers"][i], part["layers"][i]
        if a is not None:
            for k in a:
                assert torch.equal(a[k], b[k])
    assert torch.equal(full["tied"]["embed"]["w"], part["tied"]["embed"]["w"])


def _ref_steps(eng, batches):
    return [float(eng.train_batch(iter(mbs))) for mbs in batches]


def test_port_loads_reference_two_stage_checkpoint(tmp_path):
    case = dict(kind="mlp", dims={"pipe": 2},
                config=eng_test._config(micro=4, gas=2))
    ref = eng_test.reference_engine(case)
    batches = worker.pipe_batches("mlp", 3, 2, 4)
    _ref_steps(ref, batches[:2])
    ref.save_checkpoint(str(tmp_path))
    port = pt.initialize(model=worker.pipe_module("mlp", 1),
                         config=case["config"], device="cpu", rng=3)[0]
    path, _ = port.load_checkpoint(str(tmp_path))
    assert path is not None and port.global_steps == 2
    got = dict(eng_test._leaves(worker._host_tree(port.stage_params())))
    for k, v in eng_test._leaves(eng_test.reference_params(ref)):
        np.testing.assert_array_equal(got[k], v)
    # the moments came across layer by layer
    m = worker._host_tree(port.opt_state.exp_avg)
    want = jax.device_get(ref.stage_opt[1].exp_avg["layers"][4]["w"])
    np.testing.assert_array_equal(m["layers"]["00004"]["w"], want)
    loss = float(port.train_batch(iter(batches[2])))
    np.testing.assert_allclose(loss, _ref_steps(ref, batches[2:])[0],
                               rtol=LOSS_RTOL)


def test_reference_loads_port_checkpoint(tmp_path):
    case = dict(kind="bert", dims={"pipe": 1},
                config=eng_test._config(micro=2, gas=2))
    ref = eng_test.reference_engine(case)
    init = eng_test.reference_params(ref)
    port = worker.pipe_engine(case, None, init)
    batches = worker.pipe_batches("bert", 3, 2, 2)
    port_losses = [float(port.train_batch(iter(mbs)))
                   for mbs in batches[:2]]
    np.testing.assert_allclose(port_losses, _ref_steps(ref, batches[:2]),
                               rtol=LOSS_RTOL)
    port.save_checkpoint(str(tmp_path))
    back = eng_test.reference_engine(case)
    path, _ = back.load_checkpoint(str(tmp_path))
    assert path is not None and back.global_steps == 2
    got = dict(eng_test._leaves(eng_test.reference_params(back)))
    for k, v in eng_test._leaves(worker._host_tree(port.stage_params())):
        np.testing.assert_array_equal(got[k], v)
    np.testing.assert_allclose(_ref_steps(back, batches[2:]),
                               [float(port.train_batch(iter(batches[2])))],
                               rtol=LOSS_RTOL)


def test_wall_clock_breakdown_names_every_phase():
    cfg = dict(eng_test._config(), wall_clock_breakdown=True)
    eng = pt.initialize(model=worker.pipe_module("mlp", 1), config=cfg,
                        device="cpu")[0]
    eng.train_batch(iter(worker.pipe_batches("mlp", 1, 2, 4)[0]))
    msg = eng._log_phase_breakdown()
    for phase in ("fwd:", "bwd:", "comms:", "step:", "other:"):
        assert phase in msg


@pytest.mark.parametrize("padded_old,padded_new", [(128, 128), (128, 256),
                                                   (256, 128)])
def test_reshard_transform_residuals_matches_reference(padded_old,
                                                       padded_new):
    from deeperspeed_tpu.resilience import reshard as jrs
    from deeperspeed_tpu_torch.resilience import reshard as prs

    def plan(padded, lengths=(100, 100), mode="int8"):
        return {"mode": mode, "world": padded // 64, "block": 32,
                "hier_k": 0, "canonical": 0, "error_feedback": True,
                "bucket_lengths": list(lengths),
                "bucket_padded": [padded] * len(lengths)}

    rs = np.random.RandomState(padded_old + padded_new)
    e = np.zeros((2, padded_old), np.float32)
    e[:, :100] = rs.randn(2, 100)
    saved = [{"e": e[0]}, {"e": e[1]}]
    for buckets in (saved, {"0": saved[0], "1": saved[1]}):
        for target in (plan(padded_new), plan(padded_new, (99, 100)),
                       plan(padded_new, mode="bf16")):
            got = prs.reshard_transform_residuals(
                buckets, plan(padded_old), target)
            want = jrs.reshard_transform_residuals(
                buckets, plan(padded_old), target)
            assert (got is None) == (want is None)
            for g, w in zip(got or [], want or []):
                np.testing.assert_array_equal(g["e"], w["e"])
