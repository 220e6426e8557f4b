"""LAMB where a rank keeps part of a leaf: the port's ``FusedLamb`` and
``OnebitLamb`` sum each leaf's squared partial norms over the group its
parts lie over (ops/lamb.py ``whole_norms``; the engine sets the groups),
so the trust ratio is the whole leaf's, as GSPMD's full-tensor reductions
give the reference.

A tiny GPT trains 5 steps on 2 gloo ranks (tests/torch_gloo_worker.py,
one spawn for every case) and on the reference's engine over a CPU mesh
of the same shape, from the same fp32 weights and batches: FusedLamb
under ZeRO 1 and ZeRO 2 at ``{data: 2}`` and on model-axis cuts at
``{model: 2}``, and 1-bit LAMB's warmup (exact LAMB with whole-leaf
ratios) under ZeRO 2 and at ``{model: 2}``, held to the reference's
engine at world 1 without param specs (the reference cannot build 1-bit
LAMB's state under specs: its frozen ratios are scalars that the
state's sharding rules would split). Losses within LOSS_RTOL and
every leaf within LEAF_RTOL relative L2, as tests/test_torch_pipe_engine
.py holds the pipeline. The same runs with the groups dropped (each rank
takes the norms of its own part) fail those limits.
"""

import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu
from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.parallel import topology as jax_topology
from deeperspeed_tpu_torch.models import convert, gpt
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
LEAF_RTOL = 1e-4
STEPS = 5
MODEL = dict(vocab_size=64, n_layer=2, n_head=4, d_model=32, max_seq=16,
             ce_chunk=8, attn_impl="xla")
LAMB = {"type": "Lamb", "params": {"lr": 1e-2, "weight_decay": 0.01}}
ONEBIT_LAMB = {"type": "OneBitLamb",
               "params": {"lr": 1e-2, "weight_decay": 0.01,
                          "freeze_step": 1000}}
# name -> (mesh dims, ZeRO stage, optimizer block)
CASES = {
    "lamb_zero1": ({"data": 2}, 1, LAMB),
    "lamb_zero2": ({"data": 2}, 2, LAMB),
    "lamb_tp2": ({"model": 2}, 1, LAMB),
    "onebit_lamb_zero2": ({"data": 2}, 2, ONEBIT_LAMB),
    "onebit_lamb_tp2": ({"model": 2}, 1, ONEBIT_LAMB),
}
LOCAL = ("lamb_zero2", "lamb_tp2")

_RUN = {}


def _jax_mesh(dims):
    n = int(np.prod(list(dims.values())))
    return jax_topology.build_mesh(dims, devices=jax.devices()[:n])


def _reference(name, jparams, batches):
    dims, zero, block = CASES[name]
    if block["type"] == "OneBitLamb":
        dims = {"data": 1}
    mesh = _jax_mesh(dims)
    jcfg = jax_gpt.GPTConfig(**MODEL, dtype=jnp.float32)
    _, _, loss, specs = jax_gpt.make_gpt(jcfg, mesh)
    eng, _, _, _ = deeperspeed_tpu.initialize(
        model=loss, model_parameters=jparams,
        config=worker.lamb_config(zero, block), mesh=mesh,
        param_specs=None if block["type"] == "OneBitLamb" else specs)
    losses = [float(eng.train_batch(b)) for b in batches[:STEPS]]
    return losses, jax.tree.map(np.asarray, eng.state.params)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if not _RUN:
        d = tmp_path_factory.mktemp("lamb")
        jparams = jax_gpt.init_params(jax.random.PRNGKey(5), jax_gpt.GPTConfig(
            **MODEL, dtype=jnp.float32))
        tcfg = gpt.GPTConfig(**MODEL, dtype=torch.float32)
        torch.save(convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                           tcfg, "cpu"), d / "tp_params.pt")
        rs = np.random.RandomState(6)
        batches = np.stack([rs.randint(0, MODEL["vocab_size"],
                                       (4, MODEL["max_seq"] + 1))
                            .astype(np.int32) for _ in range(STEPS)])
        np.save(d / "tp_batches.npy", batches)
        cases = [(n, dims, zero, block, False, STEPS)
                 for n, (dims, zero, block) in CASES.items()]
        cases += [(f"{n}_local", CASES[n][0], CASES[n][1], CASES[n][2],
                   True, STEPS) for n in LOCAL]
        # the ranks work while this process runs the reference's engines
        errors = []

        def spawn():
            try:
                worker.spawn("lamb_runs", 2, d, MODEL, cases)
            except BaseException as e:  # re-raised below, in the test
                errors.append(e)

        ranks = threading.Thread(target=spawn)
        ranks.start()
        ref, world1 = {}, None
        for n, (_, _, block) in CASES.items():
            if block["type"] == "OneBitLamb":
                # one world-1 run serves both 1-bit cases
                world1 = world1 or _reference(n, jparams, batches)
                ref[n] = world1
            else:
                ref[n] = _reference(n, jparams, batches)
        ranks.join()
        if errors:
            raise errors[0]
        with open(d / "lamb.pkl", "rb") as f:
            _RUN["port"] = pickle.load(f)
        _RUN["ref"] = ref
    return _RUN


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float64)
    return out


def _worst(port_params, ref_params):
    got, want = _flat(port_params), _flat(ref_params)
    assert set(got) == set(want)
    return max((float(np.linalg.norm(got[k] - want[k])
                      / max(np.linalg.norm(want[k]), 1e-30)), k)
               for k in want)


@pytest.mark.parametrize("name", list(CASES))
def test_lamb_on_partial_leaves_matches_reference(run, name):
    got = run["port"][name]
    ref_losses, ref_params = run["ref"][name]
    # every rank keeps parts of some leaves, each with its group
    assert got["group_sizes"] == [2]
    if CASES[name][1] == 2:
        assert got["zero_sharded"] > 0
    np.testing.assert_allclose(got["losses"], ref_losses, rtol=LOSS_RTOL)
    worst = _worst(got["params"], ref_params)
    assert worst[0] <= LEAF_RTOL, worst
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.parametrize("name", LOCAL)
def test_shard_local_norms_miss_the_reference(run, name):
    """Without the groups each rank's ratio is its part's: the run leaves
    the reference's limits."""
    got = run["port"][f"{name}_local"]
    ref_losses, ref_params = run["ref"][name]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                        ref_losses))
    worst = _worst(got["params"], ref_params)
    assert loss_rel > LOSS_RTOL or worst[0] > LEAF_RTOL, (loss_rel, worst)
