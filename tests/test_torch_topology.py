"""The port's topology and placement rules (parallel/topology.py,
sharding/rules.py) against the JAX reference's:

* ``ProcessTopology``, ``PipeDataParallelTopology``,
  ``PipeModelDataParallelTopology`` and ``PipelineParallelGrid`` on the
  reference's tests/test_topology.py cases, answer for answer;
* ``build_mesh`` with the ``model`` and ``seq`` axes (the shape, the
  row-major rank layout of the reference's CPU device mesh), the ``pipe``
  axis laid out as the reference's;
* ``translate_spec``, ``tp_axis``/``sp_axis``/``tp_size``/``sp_size``,
  ``logical_spec`` and the rule table on legacy and canonical meshes;
* ``zero_tree_specs`` with the model's tensor-parallel specs: the zero
  axis skips the dim tensor parallelism took, as the reference's does;
* ``rules.model_cut``: a rank's part and the whole again, the fused
  qkv's sections, and the refusals;
* the ``ModelParallelUnit``'s rank and size queries.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.parallel import topology as jax_topology
from deeperspeed_tpu.sharding import mesh as jax_mesh
from deeperspeed_tpu.sharding import rules as jax_rules
from deeperspeed_tpu_torch.models import gpt
from deeperspeed_tpu_torch.parallel import topology
from deeperspeed_tpu_torch.parallel.tp import ModelParallelUnit
from deeperspeed_tpu_torch.sharding import mesh as pt_mesh
from deeperspeed_tpu_torch.sharding import rules

torch.set_num_threads(1)


def _both(cls, *args, **kw):
    return getattr(jax_topology, cls)(*args, **kw), \
        getattr(topology, cls)(*args, **kw)


def test_process_topology_as_reference():
    for axes, dims in ((["row", "col"], [2, 2]), (["a", "b", "c"], [2, 3, 4])):
        j, t = _both("ProcessTopology", axes=axes, dims=dims)
        assert t.world_size() == j.world_size()
        assert {tuple(k): v for k, v in t.mapping.items()} == \
            {tuple(k): v for k, v in j.mapping.items()}
        for r in range(j.world_size()):
            assert tuple(t.get_coord(r)) == tuple(j.get_coord(r))
        for a in axes + ["missing"]:
            assert t.get_dim(a) == j.get_dim(a)
            assert t.get_axis_comm_lists(a) == j.get_axis_comm_lists(a)
    t = topology.ProcessTopology(axes=["row", "col"], dims=[2, 2])
    assert t.get_rank(row=1, col=0) == 2
    with pytest.raises(ValueError, match="needs all axes"):
        t.get_rank(row=1)
    with pytest.raises(ValueError, match="not found"):
        t.get_coord(9)


def test_pipe_topologies_as_reference():
    j, t = _both("PipeDataParallelTopology", num_pp=2, num_dp=2)
    assert t.get_axis_comm_lists("pipe") == [[0, 2], [1, 3]]
    assert t.get_axis_comm_lists("data") == j.get_axis_comm_lists("data")
    j, t = _both("PipeDataParallelTopology", num_pp=2, num_dp=4)
    assert t.get_axis_list("pipe", 0) == j.get_axis_list("pipe", 0)
    assert t.get_axis_list("data", 1) == [1, 5]
    j, t = _both("PipeModelDataParallelTopology", num_pp=2, num_mp=2,
                 num_dp=2)
    assert t.filter_match(pipe=0) == j.filter_match(pipe=0)
    assert t.filter_match(pipe=1, model=1) == j.filter_match(pipe=1, model=1)
    j, t = _both("PipeModelDataParallelTopology", num_pp=2, num_mp=2,
                 num_dp=1)
    for r in range(4):
        assert t.get_rank_repr(rank=r) == j.get_rank_repr(rank=r)
    assert t.get_rank_repr(rank=0) == "model_00"


@pytest.mark.parametrize("rank", range(8))
def test_grid_as_reference(rank):
    for make in (lambda m: m.PipeDataParallelTopology(num_pp=2, num_dp=4),
                 lambda m: m.PipeModelDataParallelTopology(2, 2, 2)):
        jt, tt = make(jax_topology), make(topology)
        j = jax_topology.PipelineParallelGrid(jt, global_rank=rank)
        t = topology.PipelineParallelGrid(tt, global_rank=rank)
        for q in ("get_stage_id", "get_data_parallel_id",
                  "get_model_parallel_id", "get_pipe_parallel_world_size",
                  "get_data_parallel_world_size",
                  "get_model_parallel_world_size", "is_first_stage",
                  "is_last_stage", "get_global_rank"):
            assert getattr(t, q)() == getattr(j, q)(), q
        for s in range(2):
            assert t.stage_to_global_rank(s) == j.stage_to_global_rank(s)
        assert t.topology is tt


@pytest.mark.parametrize("dims", [
    {"data": 2, "model": 2}, {"model": 4}, {"seq": 2, "data": -1},
    {"data": 1, "model": 2, "seq": 2}, {"data": 2, "expert": 2}])
def test_build_mesh_model_and_seq_axes_as_reference(dims):
    mesh = topology.build_mesh(dims, world=4)
    jmesh = jax_topology.build_mesh(dims, devices=jax.devices()[:4])
    assert mesh.shape == dict(jmesh.shape)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(4):
        c = mesh.coords(r)
        assert ids[tuple(c[a] for a in mesh.axis_names)] == r
    for f in ("tp_axis", "sp_axis", "tp_size", "sp_size", "batch_axes",
              "zero_axis", "data_parallel_size"):
        assert getattr(rules, f)(mesh) == getattr(jax_rules, f)(jmesh), f


def test_build_mesh_refusals():
    # the pipe axis is a process axis now (the pipeline engine), laid out
    # row-major as the reference's device mesh
    mesh = topology.build_mesh({"pipe": 2, "data": 2}, world=4)
    jmesh = jax_topology.build_mesh({"pipe": 2, "data": 2},
                                    devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r in range(4):
        c = mesh.coords(r)
        assert ids[tuple(c[a] for a in mesh.axis_names)] == r
    with pytest.raises(ValueError):
        topology.build_mesh({"data": 3, "model": 5}, world=4)
    with pytest.raises(ValueError, match="at most one"):
        topology.build_mesh({"data": -1, "model": -1}, world=4)


@pytest.mark.parametrize("spec", [
    ("data", "seq", "model", None), (None, "model"), ("model", None),
    (("data", "model"), None), ("dp", "tp"), ("sp", None, "tp"),
    (None, None, "expert"), ("fsdp", "seq")])
def test_translate_spec_as_reference(spec):
    for dims in ({"data": 2, "model": 2}, {"dp": 1, "fsdp": 2, "tp": 2,
                                            "sp": 1},
                 {"dp": 2, "fsdp": 1, "tp": 1, "sp": 2},
                 {"data": 2, "seq": 2}):
        mesh = pt_mesh.Mesh(dims, rank=0)
        jmesh = jax_mesh.make_mesh(np.asarray(jax.devices()[:4]).reshape(
            tuple(dims.values())), tuple(dims))
        assert rules.translate_spec(spec, mesh) == tuple(
            jax_rules.translate_spec(P(*spec), jmesh))


def test_rule_table_and_logical_specs_as_reference():
    assert rules.DEFAULT_RULES == jax_rules.DEFAULT_RULES
    assert rules.resolve_rules({"seq": None}) == \
        jax_rules.resolve_rules({"seq": None})
    dims = {"dp": 1, "fsdp": 2, "tp": 2, "sp": 1}
    mesh = pt_mesh.Mesh(dims, rank=0)
    jmesh = jax_mesh.make_mesh(np.asarray(jax.devices()[:4]).reshape(
        (1, 2, 2, 1)), tuple(dims))
    for dims_ in (("batch", "seq", "embed"), ("embed", "mlp"),
                  ("vocab", "embed"), ("layers", "embed", "heads")):
        assert rules.logical_spec(dims_) == tuple(
            jax_rules.logical_spec(dims_))
        assert rules.logical_spec(dims_, mesh) == tuple(
            jax_rules.logical_spec(dims_, jmesh))
    with pytest.raises(ValueError, match="unknown logical axis"):
        rules.logical_spec(("nope",))


@pytest.mark.parametrize("dims,stage", [
    ({"data": 2, "model": 2}, 1), ({"data": 2, "model": 2}, 2),
    ({"dp": 1, "fsdp": 2, "tp": 2, "sp": 1}, 1)])
def test_zero_specs_skip_the_tensor_parallel_dim(dims, stage):
    """The port's specs of this rank's part (the tp dim cut) choose the
    zero dim the reference's choose on the whole leaf."""
    kw = dict(vocab_size=64, n_layer=2, n_head=4, d_model=32)
    cfg = gpt.GPTConfig(**kw)
    jcfg = jax_gpt.GPTConfig(**kw)
    mesh = pt_mesh.Mesh(dims, rank=0)
    jmesh = jax_mesh.make_mesh(np.asarray(jax.devices()[:4]).reshape(
        tuple(dims.values())), tuple(dims))
    whole = {k: torch.zeros(s) for k, s in _flat(
        gpt.param_shapes(cfg)).items()}
    specs = _flat(gpt.param_specs(cfg))
    local = {k: rules.model_cut(specs[k], tuple(t.shape), mesh) for k, t in
             whole.items()}
    local = {k: (t if local[k] is None else local[k].part(t, 0))
             for k, t in whole.items()}
    got = _flat(rules.zero_tree_specs(_unflat(local), _unflat(specs), stage,
                                      mesh, "master"))
    jparams = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, np.float32),
                           _unflat({k: tuple(t.shape)
                                    for k, t in whole.items()}),
                           is_leaf=lambda x: isinstance(x, tuple))
    want = _flat(jax_rules.zero_tree_specs(
        jparams, jax_gpt.param_specs(jcfg), stage, jmesh, "master"))
    zaxis = rules.zero_axis(mesh)
    for k, sp in got.items():
        w = tuple(want[k])
        dim = next((i for i, e in enumerate(w) if e == zaxis), None)
        assert sp.dim == dim, (k, sp, w)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflat(flat):
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def test_model_cut_parts_and_refusals():
    mesh = pt_mesh.Mesh({"data": 1, "model": 2}, rank=0)
    cfg = gpt.GPTConfig(vocab_size=64, n_layer=2, n_head=4, n_kv_head=2,
                        d_model=32)
    spec = gpt.param_specs(cfg)["layers"]["attn"]["wqkv"]
    w = torch.arange(2 * 32 * cfg.qkv_dim, dtype=torch.float32).reshape(
        2, 32, cfg.qkv_dim)
    cut = rules.model_cut(spec, tuple(w.shape), mesh)
    assert (cut.axis, cut.dim, cut.size) == ("model", 2, 2)
    assert cut.sections == (32, 16, 16)
    parts = [cut.part(w, i) for i in range(2)]
    # rank 1 holds q heads 2-3, k head 1, v head 1 (Dh 8)
    assert torch.equal(parts[1][..., :16], w[..., 16:32])
    assert torch.equal(parts[1][..., 16:24], w[..., 40:48])
    assert torch.equal(parts[1][..., 24:], w[..., 56:64])
    assert torch.equal(cut.join(parts), w)
    # a plain split, and a leaf no live axis cuts
    assert rules.model_cut((None, "model"), (4, 6), mesh).sections == (6,)
    assert rules.model_cut((None, None), (4, 6), mesh) is None
    assert rules.model_cut((None, "model"), (4, 6),
                           pt_mesh.Mesh({"data": 2}, rank=0)) is None
    with pytest.raises(ValueError, match="not divisible"):
        rules.model_cut((None, "model"), (4, 5), mesh)
    # the refusals of the model's shapes, named
    with pytest.raises(ValueError, match="K/V heads"):
        gpt.check_tp_shapes(gpt.GPTConfig(n_head=4, n_kv_head=1,
                                          d_model=32),
                            pt_mesh.Mesh({"model": 2}, rank=0))
    with pytest.raises(ValueError, match="n_head"):
        gpt.check_tp_shapes(gpt.GPTConfig(n_head=3, d_model=48),
                            pt_mesh.Mesh({"model": 2}, rank=0))


def test_model_parallel_unit_queries():
    mesh = topology.build_mesh({"data": 2, "model": 2}, world=4)
    for r, (mp, dp) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
        mpu = ModelParallelUnit(mesh, process_index=r)
        assert mpu.get_model_parallel_rank() == mp
        assert mpu.get_data_parallel_rank() == dp
        assert mpu.get_model_parallel_world_size() == 2
        assert mpu.get_data_parallel_world_size() == 2
        assert mpu.get_pipe_parallel_world_size() == 1
        assert mpu.get_sequence_parallel_world_size() == 1
    canon = pt_mesh.from_config({"dp": 1, "tp": 2, "sp": 2}, world=4)
    mpu = ModelParallelUnit(canon, process_index=3)
    assert mpu.get_model_parallel_rank() == 1
    assert mpu.get_sequence_parallel_world_size() == 2
