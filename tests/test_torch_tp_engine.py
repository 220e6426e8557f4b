"""Tensor and sequence parallelism through the port's GPT model and engine
over gloo ranks (tests/torch_gloo_worker.py), against the JAX reference's
``make_gpt(cfg, mesh=build_mesh(...))`` and engine on a CPU device mesh
of the same shape, from the same fp32 weights and batches:

* the loss within LOSS_RTOL and every leaf's grad (each rank on its
  part, its rows and its sequence chunk; gathered whole) within
  GRAD_RTOL relative L2 at ``{model: 2}``, ``{seq: 2}`` (ring and
  Ulysses), ``{data: 2, model: 2}`` and a canonical ``"mesh"`` block
  ``{dp: 1, tp: 2}`` (the loss built without a mesh, taking the engine's);
  the whole logits of ``apply_fn`` on every rank;
* ``initialize(..., mesh=, param_specs=)`` -> STEPS ``train_batch`` steps
  under ZeRO 1 with SGD (a scaled gradient shifts an SGD trajectory,
  where Adam hides it; tests/test_3d_composition.py) with the reference
  engine's losses, grad norms and params; every replicated leaf holds the
  same bits on every rank (Megatron's invariant);
* checkpoints keep the reference's whole-array layout: the port's, saved
  at tp 2, loads into the reference engine on the same mesh and into a
  world-1 port engine; the reference's loads into a fresh tp-2 port
  engine, whose next step is the reference's, and at world 1;
* 1-bit Adam (configs/neox_6.7b_3d.json's optimizer, freeze_step cut so
  that the later steps are compressed) under ZeRO 1 at ``{model: 2}``
  and ``{data: 2, model: 2}`` (the ZeRO shards over data): the losses,
  grad norms, params, moments and error feedback, gathered whole, with
  the reference engine's on the same mesh.
"""

import os
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import deeperspeed_tpu
import deeperspeed_tpu_torch
from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.parallel import topology as jax_topology
from deeperspeed_tpu.sharding import mesh as jax_mesh
from deeperspeed_tpu.sharding import named_shardings
from deeperspeed_tpu_torch.models import convert, gpt
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 2e-5
STEPS = 5
MODEL = dict(vocab_size=64, n_layer=2, n_head=4, d_model=32, max_seq=16,
             ce_chunk=8)
# name -> (mesh dims, attn_impl, the engine's mesh from a "mesh" block)
CASES = {
    "tp2": ({"model": 2}, "xla", False),
    "ring2": ({"seq": 2}, "ring", False),
    "ulysses2": ({"seq": 2}, "ulysses", False),
    "dp2tp2": ({"data": 2, "model": 2}, "xla", False),
    "block_tp2": ({"dp": 1, "fsdp": 1, "tp": 2, "sp": 1}, "xla", True),
}

# 1-bit Adam: name -> mesh dims (ZeRO 1, attention "xla")
ONEBIT_CASES = {"onebit_tp2": {"model": 2},
                "onebit_dp2tp2": {"data": 2, "model": 2}}
ONEBIT_STEPS = 4
# the share of a leaf's elements whose 1-bit sign may differ at a near
# tie (``_without_ties``), and the error feedback's limit in units of the
# leaf's scale (readings at most 1.3e-3, PERF.md)
TIE_SHARE = 1e-3
ERROR_ATOL = 5e-3

_RUN = {}


def _model(impl):
    return dict(MODEL, attn_impl=impl)


def _jax_mesh(dims):
    n = int(np.prod(list(dims.values())))
    devs = np.asarray(jax.devices()[:n]).reshape(tuple(dims.values()))
    if any(a in ("dp", "tp") for a in dims):
        return jax_mesh.make_mesh(devs, tuple(dims))
    return jax_topology.build_mesh(dims, devices=jax.devices()[:n])


def _reference_engine(dims, impl, jparams, load_dir=None):
    mesh = _jax_mesh(dims)
    jcfg = jax_gpt.GPTConfig(**_model(impl), dtype=jnp.float32)
    _, _, loss, specs = jax_gpt.make_gpt(jcfg, mesh)
    eng, _, _, _ = deeperspeed_tpu.initialize(
        model=loss, model_parameters=jparams, config=worker.tp_config(),
        mesh=mesh, param_specs=specs)
    if load_dir is not None:
        eng.load_checkpoint(load_dir)
    return eng


def _prepare(d, dims, impl):
    """The reference side before the ranks start: the weights, the
    batches, the reference engine's STEPS steps and its checkpoint (for
    the port to load) and the step after it."""
    jparams = jax_gpt.init_params(jax.random.PRNGKey(5), jax_gpt.GPTConfig(
        **_model(impl), dtype=jnp.float32))
    tcfg = gpt.GPTConfig(**_model(impl), dtype=torch.float32)
    torch.save(convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, "cpu"), d / "tp_params.pt")
    rs = np.random.RandomState(6)
    batches = np.stack([rs.randint(0, MODEL["vocab_size"],
                                   (4, MODEL["max_seq"] + 1)).astype(np.int32)
                        for _ in range(STEPS + 1)])
    np.save(d / "tp_batches.npy", batches)
    eng = _reference_engine(dims, impl, jparams)
    losses, norms = [], []
    for b in batches[:STEPS]:
        losses.append(float(eng.train_batch(b)))
        norms.append(eng.get_global_grad_norm())
    eng.save_checkpoint(os.fspath(d / "jax_ckpt"))
    after = jax.tree.map(np.asarray, eng.state.params)
    nxt = float(eng.train_batch(batches[STEPS]))
    return {"jparams": jparams, "batches": batches, "losses": losses,
            "norms": norms, "params": after, "next": nxt}


def _prepare_onebit(d, dims):
    """The reference engine's ONEBIT_STEPS 1-bit Adam steps at ``dims``
    from the weights and batches it saves for the ranks: its losses, grad
    norms, params, moments and error feedback."""
    jcfg = jax_gpt.GPTConfig(**_model("xla"), dtype=jnp.float32)
    jparams = jax_gpt.init_params(jax.random.PRNGKey(8), jcfg)
    tcfg = gpt.GPTConfig(**_model("xla"), dtype=torch.float32)
    torch.save(convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, "cpu"), d / "tp_params.pt")
    rs = np.random.RandomState(9)
    batches = np.stack([rs.randint(0, MODEL["vocab_size"],
                                   (4, MODEL["max_seq"] + 1)).astype(np.int32)
                        for _ in range(ONEBIT_STEPS)])
    np.save(d / "tp_batches.npy", batches)
    mesh = _jax_mesh(dims)
    _, _, loss, specs = jax_gpt.make_gpt(jcfg, mesh)
    eng, _, _, _ = deeperspeed_tpu.initialize(
        model=loss, model_parameters=jparams,
        config=worker.tp_onebit_config(), mesh=mesh, param_specs=specs)
    losses, norms = [], []
    for b in batches:
        losses.append(float(eng.train_batch(b)))
        norms.append(eng.get_global_grad_norm())
    st = eng.state.opt_state
    out = {"losses": losses, "norms": norms, "step": int(st.step),
           "params": convert._flatten(jax.tree.map(np.asarray,
                                                   eng.state.params))}
    for field in ("exp_avg", "exp_avg_sq", "error"):
        out[field] = convert._flatten(jax.tree.map(np.asarray,
                                                   getattr(st, field)))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if not _RUN:
        by_world = {}
        for name, (dims, impl, block) in CASES.items():
            d = tmp_path_factory.mktemp(name)
            _RUN[name] = {"dir": d, "ref": _prepare(d, dims, impl)}
            world = int(np.prod(list(dims.values())))
            by_world.setdefault(world, []).append(
                (str(d), "tp_gpt_run", dims, _model(impl), STEPS,
                 "jax_ckpt", block))
        for name, dims in ONEBIT_CASES.items():
            d = tmp_path_factory.mktemp(name)
            _RUN[name] = {"dir": d, "ref": _prepare_onebit(d, dims)}
            world = int(np.prod(list(dims.values())))
            by_world.setdefault(world, []).append(
                (str(d), "tp_onebit_run", dims, _model("xla"), ONEBIT_STEPS,
                 1))
        errors = []

        def spawn(world):
            try:
                # the store under the world's first case's directory
                worker.spawn("tp_gpt_runs", world, by_world[world][0][0],
                             by_world[world])
            except Exception as e:  # re-raised below, in the test process
                errors.append(e)

        # one set of ranks a world size, the cases of a world in turn (6
        # processes of one thread at most)
        threads = [threading.Thread(target=spawn, args=(w,))
                   for w in by_world]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads)
        if errors:
            raise errors[0]
        for name in CASES:
            with open(_RUN[name]["dir"] / "tp_gpt.pkl", "rb") as f:
                _RUN[name]["got"] = pickle.load(f)
        for name in ONEBIT_CASES:
            with open(_RUN[name]["dir"] / "tp_onebit.pkl", "rb") as f:
                _RUN[name]["got"] = pickle.load(f)
    return _RUN


def _reference_loss_and_grads(name, ref):
    dims, impl, _ = CASES[name]
    mesh = _jax_mesh(dims)
    jcfg = jax_gpt.GPTConfig(**_model(impl), dtype=jnp.float32)
    _, apply_fn, loss, specs = jax_gpt.make_gpt(jcfg, mesh)
    params = jax.device_put(ref["jparams"], named_shardings(mesh, specs))
    lead = tuple(a for a in ("data", "dp") if a in dims)
    batch = jax.device_put(jnp.asarray(ref["batches"][0]), NamedSharding(
        mesh, P(lead[0] if lead else None)))
    l, g = jax.jit(jax.value_and_grad(loss))(params, batch)
    logits = jax.jit(apply_fn)(params, batch[:, :-1])
    return float(l), convert._flatten(jax.tree.map(np.asarray, g)), \
        np.asarray(logits)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_grads_match_reference(run, name):
    got = run[name]["got"]
    loss, grads, logits = _reference_loss_and_grads(name, run[name]["ref"])
    np.testing.assert_allclose(got["loss"], loss, rtol=LOSS_RTOL)
    assert set(got["grads"]) == set(grads)
    for k, g in got["grads"].items():
        assert _rel_l2(g, grads[k]) <= GRAD_RTOL, k
    # rank 0's logits (every rank's are whole); rows of its data rank
    rows = logits.shape[0] // got["dp"]
    np.testing.assert_allclose(got["logits"], logits[:rows], rtol=1e-5,
                               atol=1e-5)


def test_parts_are_this_ranks_heads_and_columns(run):
    shapes = run["tp2"]["got"]["local_shapes"]
    Dh = MODEL["d_model"] // MODEL["n_head"]
    assert shapes["layers/attn/wqkv"] == (2, 32, 3 * 2 * Dh)
    assert shapes["layers/attn/wo"] == (2, 16, 32)
    assert shapes["layers/mlp/wi"] == (2, 32, 64)
    assert shapes["embed/wte"] == (64, 16)
    assert shapes["lm_head"] == (32, 32)
    assert shapes["layers/ln1_scale"] == (2, 32)
    # sequence parallelism cuts no leaf
    assert run["ring2"]["got"]["local_shapes"]["layers/attn/wqkv"] == \
        (2, 32, 3 * 32)


@pytest.mark.parametrize("name", list(CASES))
def test_engine_steps_match_reference_engine(run, name):
    got, ref = run[name]["got"], run[name]["ref"]
    assert got["dp"] == (2 if name == "dp2tp2" else 1)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norms"], ref["norms"],
                               rtol=GRAD_RTOL)
    want = convert._flatten(ref["params"])
    assert set(got["params"]) == set(want)
    for k, p in got["params"].items():
        np.testing.assert_allclose(p, want[k], atol=PARAM_ATOL, err_msg=k)
    assert got["same_replicated"]


@pytest.mark.parametrize("name", ["tp2", "dp2tp2"])
def test_reference_checkpoint_loads_into_the_port(run, name):
    got, ref = run[name]["got"], run[name]["ref"]
    loaded = got["loaded"]
    assert loaded["global_steps"] == STEPS
    want = convert._flatten(ref["params"])
    for k, p in loaded["params"].items():
        np.testing.assert_array_equal(p, want[k], err_msg=k)
    np.testing.assert_allclose(loaded["next_loss"], ref["next"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", ["tp2", "dp2tp2"])
def test_port_checkpoint_loads_in_reference_and_at_world_1(run, name):
    d, got, ref = run[name]["dir"], run[name]["got"], run[name]["ref"]
    dims, impl, _ = CASES[name]
    eng = _reference_engine(dims, impl, ref["jparams"],
                            os.fspath(d / "pt_ckpt"))
    back = convert._flatten(jax.tree.map(np.asarray, eng.state.params))
    for k, p in got["params"].items():
        np.testing.assert_array_equal(back[k], p, err_msg=k)
    np.testing.assert_allclose(float(eng.train_batch(ref["batches"][STEPS])),
                               ref["next"], rtol=LOSS_RTOL)
    tcfg = gpt.GPTConfig(**_model(impl), dtype=torch.float32)
    _, _, loss, specs = gpt.make_gpt(tcfg)
    one, _, _, _ = deeperspeed_tpu_torch.initialize(
        model=loss, model_parameters=torch.load(d / "tp_params.pt"),
        config=worker.tp_config(), device="cpu", param_specs=specs)
    tag, _ = one.load_checkpoint(os.fspath(d / "pt_ckpt"))
    assert tag is not None and one.global_steps == STEPS
    for k, t in convert._flatten(one.params).items():
        np.testing.assert_array_equal(t.detach().numpy(), got["params"][k],
                                      err_msg=k)
    np.testing.assert_allclose(float(one.train_batch(ref["batches"][STEPS])),
                               ref["next"], rtol=LOSS_RTOL)
    # and the reference's tp-2 checkpoint at world 1
    other, _, _, _ = deeperspeed_tpu_torch.initialize(
        model=loss, model_parameters=torch.load(d / "tp_params.pt"),
        config=worker.tp_config(), device="cpu", param_specs=specs)
    other.load_checkpoint(os.fspath(d / "jax_ckpt"))
    want = convert._flatten(ref["params"])
    for k, t in convert._flatten(other.params).items():
        np.testing.assert_array_equal(t.detach().numpy(), want[k],
                                      err_msg=k)


def _without_ties(d):
    """|d| of a leaf without its TIE_SHARE largest elements (one at
    least): where the corrected momentum m + e of an element lies within
    rounding of 0 the two packages' grads (equal to GRAD_RTOL) may give it
    the other sign, and that element then goes its own way."""
    d = np.sort(np.abs(d).ravel())
    return d[:-max(1, int(d.size * TIE_SHARE))]


@pytest.mark.parametrize("name", list(ONEBIT_CASES))
def test_onebit_adam_on_cut_and_sharded_leaves_matches_reference(run, name):
    got, ref = run[name]["got"], run[name]["ref"]
    assert got["step"] == ref["step"] == ONEBIT_STEPS
    # the scale sums over the model axis, and over data where ZeRO shards
    tp = ONEBIT_CASES[name]["model"]
    dp = ONEBIT_CASES[name].get("data", 1)
    assert got["scale_group_sizes"] == sorted({tp, dp, tp * dp} - {1})
    assert (got["zero_sharded"] > 0) == (dp > 1)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norms"], ref["norms"],
                               rtol=GRAD_RTOL)
    for field in ("params", "exp_avg", "exp_avg_sq", "error"):
        assert set(got[field]) == set(ref[field]), field
    for k, m in got["exp_avg"].items():
        want = ref["exp_avg"][k]
        # the compressed momentum is +-the whole leaf's scale: one
        # magnitude on every rank's part (a part's own scale would give
        # one a part), the reference's
        scales = np.unique(np.abs(m))
        assert scales.size == 1, (k, scales)
        scale = float(np.abs(want).max())
        assert abs(scales[0] - scale) <= GRAD_RTOL * scale, k
        flips = int((np.sign(m) != np.sign(want)).sum())
        assert flips <= max(1, int(m.size * TIE_SHARE)), (k, flips)
        err = _without_ties(got["error"][k] - ref["error"][k])
        assert err.max() <= ERROR_ATOL * scale, (k, err.max() / scale)
        p = _without_ties(got["params"][k] - ref["params"][k])
        assert (np.linalg.norm(p) <= GRAD_RTOL
                * np.linalg.norm(ref["params"][k])), k
        assert _rel_l2(got["exp_avg_sq"][k],
                       ref["exp_avg_sq"][k]) <= GRAD_RTOL, k
    # the compressed steps ran: the error feedback is live on a cut leaf
    assert np.abs(got["error"]["layers/attn/wqkv"]).sum() > 0
    assert got["same_replicated"]
