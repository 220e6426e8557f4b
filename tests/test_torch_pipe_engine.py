"""The port's PipelineEngine (runtime/pipe/engine.py), one gloo process a
stage (tests/torch_gloo_worker.py), against the JAX reference's engine on
a CPU device mesh of the same shape, from the same fp32 weights carried
across (models/convert.from_jax_pipeline_params):

* ``{pipe: 2}`` and ``{pipe: 4}`` (two interior stages, each receiving
  and sending activations and grads) with an MLP and with a tied
  embedding, 4 small ``DeepSpeedTransformerLayer``s and the tied head;
  ``{pipe: 2, data: 2}`` plain and with a ``"comm"`` int8 block;
  ``{pipe: 2, model: 2}`` with ``ParallelMLP`` under Adam and under LAMB
  (its trust ratio over each cut leaf's whole norms): every step's loss
  within LOSS_RTOL of the reference's
  on every rank, every leaf within LEAF_RTOL relative L2 after STEPS
  steps;
* the fp16 dynamic scaler under a loss that overflows skips the same
  steps and reaches the same scale as the reference's (the explode case
  of tests/test_pipe.py), the params untouched;
* ``eval_batch`` and ``inference_batch`` match the reference's;
* a save at 2 stages loads into a 1-stage port engine bit for bit (and
  its next step matches the reference's), and into the reference's
  2-stage engine; ``save_fp16_model`` gathers every stage's params; the
  int8 case's error-feedback residuals resume from its save.

The ranks of each world size run in one spawn, shared by the cases.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu as ds
from deeperspeed_tpu.parallel import ParallelMLP, build_mesh
from deeperspeed_tpu.runtime.pipe import (Embedding, LayerSpec, Linear,
                                          PipelineModule, TiedLayerSpec)
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
LEAF_RTOL = 1e-4
STEPS = 3
ADAM = {"type": "Adam", "params": {"lr": 1e-2}}
LAMB = {"type": "Lamb", "params": {"lr": 1e-2, "weight_decay": 0.01}}


def _config(micro=4, gas=2, optimizer=ADAM, **extra):
    return dict({"train_micro_batch_size_per_gpu": micro,
                 "gradient_accumulation_steps": gas, "steps_per_print": 1000,
                 "optimizer": optimizer, "zero_optimization": {"stage": 0}},
                **extra)


EXPLODE_CONFIG = {"train_batch_size": 2, "train_micro_batch_size_per_gpu": 2,
                  "steps_per_print": 1000,
                  "fp16": {"enabled": True, "loss_scale": 0,
                           "initial_scale_power": 32},
                  "optimizer": {"type": "Adam", "params": {"lr": 1e-3}}}

CASES = {
    2: [dict(name="mlp", kind="mlp", dims={"pipe": 2}, config=_config(),
             steps=STEPS, eval=True, save=True),
        dict(name="bert", kind="bert", dims={"pipe": 2},
             config=_config(micro=2), steps=STEPS),
        dict(name="explode", kind="mlp", dims={"pipe": 2},
             config=EXPLODE_CONFIG, steps=3, explode=True)],
    4: [dict(name="dp", kind="mlp", dims={"pipe": 2, "data": 2},
             config=_config(), steps=STEPS),
        dict(name="dp_int8", kind="mlp", dims={"pipe": 2, "data": 2},
             config=_config(comm={"mode": "int8", "bucket_mb": 0.0001}),
             steps=STEPS, reload=True),
        dict(name="tp", kind="tp", dims={"pipe": 2, "data": 1, "model": 2},
             config=_config(micro=2), steps=STEPS),
        dict(name="tp_lamb", kind="tp",
             dims={"pipe": 2, "data": 1, "model": 2},
             config=_config(micro=2, optimizer=LAMB), steps=STEPS),
        dict(name="mlp_pipe4", kind="mlp", dims={"pipe": 4},
             config=_config(), steps=STEPS),
        dict(name="bert_pipe4", kind="bert", dims={"pipe": 4},
             config=_config(micro=2), steps=STEPS)],
}
ALL = [c for cases in CASES.values() for c in cases]


def _mse(y, t):
    return jnp.mean((y.astype(jnp.float32) - t.astype(jnp.float32)) ** 2)


def _explode(y, t):
    return jnp.mean((y - t) ** 2) * 1e30


def _xent(logits, labels):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None], axis=-1))


def reference_module(kind, stages, explode=False):
    """The reference's PipelineModule of a case (worker.pipe_module's
    twin)."""
    from deeperspeed_tpu.ops.transformer import (DeepSpeedTransformerConfig,
                                                 DeepSpeedTransformerLayer)

    if kind == "bert":
        conf = DeepSpeedTransformerConfig(
            **worker.pipe_transformer_config(False))
        layers = ([TiedLayerSpec("embed", Embedding, worker.PIPE_V,
                                 worker.PIPE_D)]
                  + [LayerSpec(DeepSpeedTransformerLayer, conf)
                     for _ in range(4)]
                  + [TiedLayerSpec("embed", Embedding, worker.PIPE_V,
                                   worker.PIPE_D,
                                   forward_fn=lambda p, x: x @ p["w"].T)])
        return PipelineModule(layers, num_stages=stages, loss_fn=_xent,
                              partition_method="uniform")
    if kind == "tp":
        # the reference's pipeline places every param whole on its stage
        # mesh: the MLP's math is the whole one
        layers = [LayerSpec(ParallelMLP, 16, 32) for _ in range(2)]
        return PipelineModule(layers, num_stages=stages, loss_fn=_mse,
                              partition_method="uniform")
    layers = [LayerSpec(Linear, 8, 16), LayerSpec(jax.nn.relu),
              LayerSpec(Linear, 16, 16), LayerSpec(jax.nn.relu),
              LayerSpec(Linear, 16, 4)]
    return PipelineModule(layers, num_stages=stages,
                          loss_fn=_explode if explode else _mse,
                          seed_layers=True, partition_method="uniform")


def reference_engine(case, stages=None):
    dims = dict(case["dims"])
    if stages is not None:
        dims = {"pipe": stages}
    n = int(np.prod(list(dims.values())))
    if "data" not in dims:
        dims = dict(dims, data=1)
    mesh = build_mesh(dims, devices=jax.devices()[:n])
    mod = reference_module(case["kind"], dims["pipe"],
                           explode=case.get("explode", False))
    eng, _, _, _ = ds.initialize(model=mod, config=case["config"], mesh=mesh)
    return eng


def reference_params(eng):
    """The reference engine's params as one module dict of numpy."""
    mod = eng.module
    layers = [None] * mod.num_layers()
    tied = {}
    for s, sp in enumerate(eng.stage_params):
        host = jax.tree.map(np.asarray, jax.device_get(sp))
        for i in mod.stage_layer_indices(s):
            if host["layers"][i] is not None:
                layers[i] = host["layers"][i]
        for k, v in host["tied"].items():
            tied.setdefault(k, v)
    return {"layers": layers, "tied": tied}


def _rows(case, eng):
    return case["config"]["train_micro_batch_size_per_gpu"] * eng.dp_world_size


def reference_run(case, tmp):
    """Build the reference's engine, write its initial params for the
    ranks, train it; its readings."""
    eng = reference_engine(case)
    init = reference_params(eng)
    with open(os.path.join(tmp, f"{case['name']}_init.pkl"), "wb") as f:
        pickle.dump(init, f)
    gas = case["config"].get("gradient_accumulation_steps", 1)
    out = {"init": init, "losses": [], "grad_norms": [], "scales": [],
           "engine": eng}
    for mbs in worker.pipe_batches(case["kind"], case["steps"], gas,
                                   _rows(case, eng)):
        out["losses"].append(float(eng.train_batch(iter(mbs))))
        out["grad_norms"].append(float(eng.get_global_grad_norm()))
        out["scales"].append(float(eng.loss_scale_value))
    out["skipped"] = eng.skipped_steps
    out["params"] = reference_params(eng)
    if case.get("eval"):
        mbs = worker.pipe_batches(case["kind"], 1, gas, _rows(case, eng),
                                  seed=7)[0]
        out["eval"] = float(eng.eval_batch(iter(mbs)))
        out["inference"] = np.asarray(eng.inference_batch(mbs[0][0]))
    return out


_RUN = {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if not _RUN:
        for world, cases in CASES.items():
            d = tmp_path_factory.mktemp(f"pipe_world{world}")
            refs = {c["name"]: reference_run(c, str(d)) for c in cases}
            worker.spawn("pipe_runs", world, d, cases)
            ranks = []
            for r in range(world):
                with open(d / f"pipe_rank{r}.pkl", "rb") as f:
                    ranks.append(pickle.load(f))
            for c in cases:
                _RUN[c["name"]] = dict(
                    ref=refs[c["name"]], dir=str(d), case=c,
                    ranks=[rk[c["name"]] for rk in ranks])
    return _RUN


def merged_params(ranks):
    """The whole module's params from the ranks at data 0 and model 0,
    each stage's slots from its own rank."""
    out = None
    for r in ranks:
        if any(v for a, v in r["coords"].items() if a != "pipe"):
            continue
        p = r["params"]
        if out is None:
            out = {"layers": list(p["layers"]), "tied": dict(p["tied"])}
        for i, v in enumerate(p["layers"]):
            if v is not None:
                out["layers"][i] = v
        for k, v in p["tied"].items():
            out["tied"].setdefault(k, v)
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix.rstrip("/"), np.asarray(tree, np.float64)


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", [c["name"] for c in ALL
                                  if not c.get("explode")])
def test_losses_and_leaves_match_reference(runs, name):
    run = runs[name]
    ref = run["ref"]
    for r in run["ranks"]:
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norms"], ref["grad_norms"],
                                   rtol=10 * LOSS_RTOL)
    got = dict(_leaves(merged_params(run["ranks"])))
    want = dict(_leaves(ref["params"]))
    assert set(got) == set(want)
    worst = max((rel_l2(got[k], want[k]), k) for k in want)
    assert worst[0] <= LEAF_RTOL, worst
    # training moved the params
    init = dict(_leaves(ref["init"]))
    assert max(rel_l2(want[k], init[k]) for k in want) > 10 * LEAF_RTOL


def test_dynamic_loss_scale_skips_as_reference(runs):
    run = runs["explode"]
    ref = run["ref"]
    assert ref["skipped"] >= 2 and ref["scales"][-1] < 2.0 ** 32
    for r in run["ranks"]:
        assert r["skipped"] == ref["skipped"]
        assert r["scales"] == ref["scales"]
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=LOSS_RTOL)
    got = dict(_leaves(merged_params(run["ranks"])))
    for k, v in _leaves(ref["init"]):
        np.testing.assert_array_equal(got[k], v)


def test_eval_and_inference_match_reference(runs):
    run = runs["mlp"]
    ref = run["ref"]
    for r in run["ranks"]:
        np.testing.assert_allclose(r["eval"], ref["eval"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["inference"], ref["inference"],
                                   rtol=1e-5, atol=1e-6)


def test_two_stage_save_loads_at_one_stage_and_in_reference(runs):
    import deeperspeed_tpu_torch as pt

    run = runs["mlp"]
    case, ref = run["case"], run["ref"]
    ckpt = os.path.join(run["dir"], "mlp_ckpt")
    saved = dict(_leaves(merged_params(run["ranks"])))
    # the port at one stage (this process, world 1)
    one = pt.initialize(model=worker.pipe_module("mlp", 1),
                        config=case["config"], device="cpu", rng=5)[0]
    path, _ = one.load_checkpoint(ckpt)
    assert path is not None and one.global_steps == STEPS
    assert int(one.opt_state.step) == STEPS
    got = dict(_leaves(worker._host_tree(one.stage_params())))
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k], v)
    # the next step from the loaded optimizer state, as the reference's
    gas = case["config"]["gradient_accumulation_steps"]
    nxt = worker.pipe_batches("mlp", STEPS + 1, gas, 4)[STEPS]
    loss = float(one.train_batch(iter(nxt)))
    want = float(ref["engine"].train_batch(iter(nxt)))
    np.testing.assert_allclose(loss, want, rtol=LOSS_RTOL)
    # the whole model in the compute dtype, gathered to pipe rank 0
    from deeperspeed_tpu_torch.checkpoint.serialization import load_tree

    fp16 = load_tree(os.path.join(run["dir"], "mlp_fp16",
                                  "model_fp16.msgpack"))
    got = dict(_leaves(fp16))
    assert set(got) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k], v)
    # the reference's 2-stage engine loads the port's save
    back = reference_engine(case)
    path, _ = back.load_checkpoint(ckpt)
    assert path is not None and back.global_steps == STEPS
    got = dict(_leaves(reference_params(back)))
    for k, v in saved.items():
        np.testing.assert_array_equal(got[k], v)


def test_comm_residuals_resume_from_a_save(runs):
    for r in runs["dp_int8"]["ranks"]:
        assert r["residual_l1"] > 0
        assert r["residuals_restored"] and all(r["residuals_restored"])
