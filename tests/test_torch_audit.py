"""The port's placement audit (deeperspeed_tpu_torch/sharding/audit.py)
against the reference's (deeperspeed_tpu/sharding/audit.py).

A tiny fp32 GPT's engine on ``{fsdp: 2}`` at ZeRO 1 and ZeRO 2, ``{tp: 2}``
and ``{dp: 2}``: the reference engine on a CPU device mesh of that shape,
the port's as each rank of the same layout (``sharding.mesh.PlanningMesh``:
the engine of one rank, its collectives planned), both from the same
numpy-seeded weights. The audits of the params and of the Adam moments
give the same ``leaves``, ``sharded_leaves``, ``sharded_frac`` and
``digest`` (the digest hashes every leaf's path, its spec in the
reference's ``PartitionSpec`` form and this rank's shard shape), and the
same per-leaf specs. ``viz_sha1`` hashes the port's own rendering of the
shard grid, so it is not compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import deeperspeed_tpu
from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.sharding import mesh as jax_mesh
from deeperspeed_tpu.sharding import audit as jax_audit
from deeperspeed_tpu_torch.models import convert, gpt
from deeperspeed_tpu_torch.monitor import runctx
from deeperspeed_tpu_torch.runtime.engine import initialize
from deeperspeed_tpu_torch.sharding import audit, mesh as mesh_lib

torch.set_num_threads(1)

MODEL = dict(vocab_size=64, n_layer=2, n_head=4, d_model=32, max_seq=16,
             attn_impl="xla", remat=False)
KEYS = ("leaves", "sharded_leaves", "sharded_frac", "digest")
# name -> (the "mesh" extents, ZeRO stage)
LAYOUTS = {
    "fsdp2_zero1": ({"fsdp": 2}, 1),
    "fsdp2_zero2": ({"fsdp": 2}, 2),
    "tp2": ({"tp": 2}, 1),
    "dp2": ({"dp": 2}, 1),
}


def _extents(dims):
    return {a: dims.get(a, 1) for a in ("dp", "fsdp", "tp", "sp")}


def _config(dims, zero):
    rows = 2 * (2 // dims.get("tp", 1))
    return {"train_batch_size": rows, "train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": zero},
            "steps_per_print": 10 ** 9}


def _weights():
    """The tiny model's weights, drawn with numpy in the reference's
    layout."""
    jcfg = jax_gpt.GPTConfig(**MODEL, dtype=jnp.float32)
    like = jax_gpt.init_params(jax.random.PRNGKey(0), jcfg)
    rs = np.random.RandomState(3)
    return jax.tree.map(
        lambda a: (0.02 * rs.standard_normal(a.shape)).astype(np.float32),
        like)


def _reference(dims, zero, weights):
    ext = _extents(dims)
    devs = np.asarray(jax.devices()[:2]).reshape(tuple(ext.values()))
    mesh = jax_mesh.make_mesh(devs, tuple(ext))
    jcfg = jax_gpt.GPTConfig(**MODEL, dtype=jnp.float32)
    _, _, loss, specs = jax_gpt.make_gpt(jcfg, mesh)
    eng, _, _, _ = deeperspeed_tpu.initialize(
        model=loss, model_parameters=jax.tree.map(jnp.asarray, weights),
        config=_config(dims, zero), mesh=mesh, param_specs=specs)
    st = eng.state
    return {"params": jax_audit.audit_tree(st.params, mesh=mesh),
            "exp_avg": jax_audit.audit_tree(st.opt_state.exp_avg, mesh=mesh),
            "exp_avg_sq": jax_audit.audit_tree(st.opt_state.exp_avg_sq,
                                               mesh=mesh),
            "specs": {k: v["spec"] for k, v in
                      jax_audit.tree_digest(st.opt_state.exp_avg).items()}}


def _port(dims, zero, weights, rank):
    mesh = mesh_lib.PlanningMesh(_extents(dims), rank=rank)
    tcfg = gpt.GPTConfig(**MODEL, dtype=torch.float32)
    _, _, loss, specs = gpt.make_gpt(tcfg, mesh)
    eng, _, _, _ = initialize(
        model=loss, model_parameters=convert.from_jax_params(
            weights, tcfg, "cpu"),
        config=_config(dims, zero), device="cpu", mesh=mesh,
        param_specs=specs)
    state = audit.placements(eng, "state")
    return {"params": audit.audit_tree(eng.params, mesh,
                                       audit.placements(eng, "params")),
            "exp_avg": audit.audit_tree(eng.opt_state.exp_avg, mesh, state),
            "exp_avg_sq": audit.audit_tree(eng.opt_state.exp_avg_sq, mesh,
                                           state),
            "specs": {k: v["spec"] for k, v in audit.tree_digest(
                eng.opt_state.exp_avg, state, mesh).items()}}


@pytest.fixture(scope="module")
def weights():
    return _weights()


@pytest.fixture(autouse=True)
def _role(monkeypatch):
    """An engine of a mesh of several ranks names its process's monitor
    role (``DS_TPU_ROLE``): this test's engines, one process playing each
    rank, leave the variable as they found it."""
    monkeypatch.setenv(runctx.ROLE_ENV, "trainer")


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_engine_audit_matches_the_reference(weights, name):
    dims, zero = LAYOUTS[name]
    ref = _reference(dims, zero, weights)
    for rank in (0, 1):
        mine = _port(dims, zero, weights, rank)
        assert mine["specs"] == ref["specs"]
        for tree in ("params", "exp_avg", "exp_avg_sq"):
            assert ({k: mine[tree][k] for k in KEYS}
                    == {k: ref[tree][k] for k in KEYS}), (rank, tree)
            assert mine[tree]["mesh"]["axes"] == _extents(dims)
    if name == "dp2":
        assert ref["params"]["sharded_frac"] == 0.0
    if name.startswith("fsdp2"):
        assert ref["exp_avg"]["sharded_frac"] > 0.5
    if name == "tp2":
        assert ref["specs"]["['layers']['mlp']['wi']"] == \
            "PartitionSpec(None, None, 'tp')"


def test_audit_tree_reports_sharded_fraction():
    """The counterpart of tests/test_sharding.py's case: one (64, 8) leaf
    split over fsdp 8 and one replicated (4,) leaf."""
    jm = jax_mesh.from_config({"dp": 1, "fsdp": 8})
    big = jax.device_put(np.zeros((64, 8), np.float32),
                         NamedSharding(jm, P("fsdp", None)))
    rep = jax.device_put(np.zeros((4,), np.float32), NamedSharding(jm, P()))
    ref = jax_audit.audit_tree({"big": big, "rep": rep}, mesh=jm)

    mesh = mesh_lib.PlanningMesh({"dp": 1, "fsdp": 8, "tp": 1, "sp": 1},
                                 rank=3)
    tree = {"big": torch.zeros(8, 8), "rep": torch.zeros(4)}
    specs = {"big": audit.Placement(("fsdp", None), (64, 8)),
             "rep": audit.Placement((), (4,))}
    aud = audit.audit_tree(tree, mesh=mesh, specs=specs)
    assert aud["leaves"] == 2 and aud["sharded_leaves"] == 1
    assert aud["sharded_frac"] == pytest.approx(512 / 516, abs=1e-3)
    assert len(aud["digest"]) > 0
    assert {k: aud[k] for k in KEYS} == {k: ref[k] for k in KEYS}
    assert aud["mesh"] == ref["mesh"]
    # the rendering: rank 3 holds rows 24:32 of the big leaf
    digest = audit.spec_digest(tree["big"], specs["big"], mesh)
    assert digest["shape"] == [64, 8] and digest["shard_shape"] == [8, 8]
    assert "[24:32, 0:8] -> ranks [3]" in audit.render_grid(specs["big"],
                                                            mesh)
    # a tensor with no spec is the reference's unsharded leaf
    assert audit.spec_digest(torch.zeros(3, 2))["spec"] == "unsharded"
