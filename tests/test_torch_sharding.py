"""The port's sharding/ (MeshConfig, the mesh over ranks, ZeRO specs),
runtime/zero/ and distributed/topology against the reference's.

The ``"mesh"`` block parses and fails as in the reference; the port's
``zero_tree_specs`` shards the same dim of every leaf of the
GPT-NeoX-125M and BERT-large trees as the reference's on a CPU mesh of
2, 4 and 8 devices, at ZeRO stages 0-2; the ZeRO block parses to the same
fields. No process group is needed: the port's mesh can be built for
planning."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from deeperspeed_tpu.distributed import topology as jax_topology
from deeperspeed_tpu.models import bert as jax_bert
from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.runtime.zero import config as jax_zero_config
from deeperspeed_tpu.sharding import config as jax_mesh_config
from deeperspeed_tpu.sharding import rules as jax_rules
from deeperspeed_tpu_torch.distributed import topology as pt_topology
from deeperspeed_tpu_torch.models import bert as pt_bert
from deeperspeed_tpu_torch.models import gpt as pt_gpt
from deeperspeed_tpu_torch.ops.adam import tree_leaves
from deeperspeed_tpu_torch.runtime import config as pt_config
from deeperspeed_tpu_torch.runtime.zero import config as pt_zero_config
from deeperspeed_tpu_torch.runtime.zero import partition
from deeperspeed_tpu_torch.sharding import config as pt_mesh_config
from deeperspeed_tpu_torch.sharding import mesh as pt_mesh
from deeperspeed_tpu_torch.sharding import rules as pt_rules

torch.set_num_threads(1)


@pytest.mark.parametrize("block", [
    {"dpp": 2},
    {"dp": -1, "fsdp": -1},
    {"dp": 0},
    {"dp": -2},
    {"dp": 1.5},
    {"dp": True},
    {"rules": ["mlp"]},
    {"rules": {"mlp": "bogus"}},
])
def test_mesh_config_errors_match_reference(block):
    with pytest.raises(ValueError) as want:
        jax_mesh_config.MeshConfig.from_dict(block)
    with pytest.raises(ValueError) as got:
        pt_mesh_config.MeshConfig.from_dict(block)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("block,world", [
    ({}, 8), ({"dp": 2, "fsdp": -1}, 8), ({"dp": -1, "fsdp": 2}, 4),
    ({"dp": 1, "fsdp": 4}, 4), ({"fsdp": 3}, 6)])
def test_mesh_config_resolves_as_reference(block, world):
    assert (pt_mesh_config.resolve_extents(block, world)
            == jax_mesh_config.resolve_extents(block, world))
    for bad_world in (world + 1, 7):
        try:
            want = jax_mesh_config.resolve_extents(block, bad_world)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                pt_mesh_config.resolve_extents(block, bad_world)
            assert str(got.value) == str(e)
        else:
            assert pt_mesh_config.resolve_extents(block, bad_world) == want


def test_mesh_block_through_the_training_config():
    cfg = pt_config.TrainingConfig({"train_batch_size": 8,
                                    "mesh": {"dp": 2, "fsdp": -1}},
                                   world_size=8)
    assert cfg.mesh_config().axis_dims() == {"dp": 2, "fsdp": -1, "tp": 1,
                                             "sp": 1}
    # tensor and sequence parallelism are ported: the blocks parse
    for block in ({"tp": 2}, {"dp": 1, "sp": -1}):
        cfg = pt_config.TrainingConfig({"train_batch_size": 8,
                                        "mesh": block})
        assert cfg.mesh_config().axis_dims() == dict(
            {"dp": -1, "fsdp": 1, "tp": 1, "sp": 1}, **block)
    with pytest.raises(pt_config.ConfigError, match="invalid \"mesh\""):
        pt_config.TrainingConfig({"train_batch_size": 8, "mesh": {"x": 1}})
    assert pt_mesh.from_config({"dp": 2, "tp": 2}, world=4).shape == {
        "dp": 2, "fsdp": 1, "tp": 2, "sp": 1}


def test_mesh_axes_coordinates_and_sizes():
    m = pt_mesh.from_config({"dp": 2, "fsdp": -1}, world=8)
    assert m.shape == {"dp": 2, "fsdp": 4, "tp": 1, "sp": 1}
    assert pt_rules.batch_axes(m) == ("dp", "fsdp")
    assert pt_rules.zero_axis(m) == "fsdp" and pt_rules.zero_size(m) == 4
    assert pt_rules.data_parallel_size(m) == 8
    assert m.ranks_along(("fsdp",), rank=5) == [4, 5, 6, 7]
    assert m.ranks_along(("dp",), rank=5) == [1, 5]
    assert m.axis_index(("dp", "fsdp"), rank=6) == 6
    legacy = pt_mesh.default_mesh(world=4)
    assert pt_rules.batch_axes(legacy) == ("data",)
    assert pt_rules.zero_axis(legacy) == "data"
    # a dp-only canonical mesh shards nothing: its fsdp axis has size 1
    dp_only = pt_mesh.from_config({"dp": 4}, world=4)
    assert pt_rules.zero_axis(dp_only) == "fsdp"
    assert pt_rules.zero_size(dp_only) == 1
    # without a world the mesh plans but hands out no group
    with pytest.raises(RuntimeError, match="torch.distributed"):
        legacy.group(("data",))


def test_place_batch_takes_the_ranks_block_of_rows():
    m = pt_mesh.Mesh({"data": 4}, rank=2)
    x = np.arange(16).reshape(8, 2)
    out = pt_rules.place_batch(m, {"x": x, "s": np.float32(3.0),
                                   "t": (torch.arange(8),)})
    np.testing.assert_array_equal(out["x"], x[4:6])
    assert out["s"] == 3.0 and out["t"][0].tolist() == [4, 5]
    with pytest.raises(ValueError, match="does not split"):
        pt_rules.place_batch(m, np.zeros((6, 2)))


def _jax_tree(fn):
    return jax.eval_shape(fn)


def _meta_tree(shapes):
    if isinstance(shapes, dict):
        return {k: _meta_tree(v) for k, v in shapes.items()}
    return torch.empty(shapes, device="meta")


def _trees():
    gcfg = jax_gpt.get_preset("neox-125m")
    bcfg = dict(vocab_size=30528, n_layer=24, n_head=16, d_model=1024,
                max_seq=128)
    return {
        "neox-125m": (
            _jax_tree(lambda: jax_gpt.init_params(jax.random.PRNGKey(0),
                                                  gcfg)),
            _meta_tree(pt_gpt.param_shapes(pt_gpt.get_preset("neox-125m")))),
        "bert-large": (
            _jax_tree(lambda: jax_bert.init_params(
                jax.random.PRNGKey(0), jax_bert.BertConfig(**bcfg))),
            _meta_tree(pt_bert.param_shapes(pt_bert.BertConfig(**bcfg)))),
    }


def _jax_dims(specs):
    """The zero-axis dim of each leaf of a reference spec tree, in jax
    leaf order (sorted keys), None when replicated."""
    out = []
    for s in jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec)):
        dims = [i for i, a in enumerate(tuple(s)) if a is not None]
        out.append(dims[0] if dims else None)
    return out


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("size", (2, 4, 8))
def test_zero_specs_pick_the_reference_dims(size):
    jmesh = JaxMesh(np.array(jax.devices()[:size]), ("data",))
    pmesh = pt_mesh.default_mesh(world=size)
    for name, (jtree, ptree) in _trees().items():
        # same leaves, same shapes, in the reference's order
        jshapes = [tuple(x.shape) for x in jax.tree.leaves(jtree)]
        assert jshapes == [tuple(x.shape) for x in _sorted_leaves(ptree)]
        for stage in (0, 1, 2):
            for kind in ("master", "grad", "param"):
                want = _jax_dims(jax_rules.zero_tree_specs(
                    jtree, None, stage, jmesh, kind))
                got = [sp.dim for sp in _sorted_leaves(
                    pt_rules.zero_tree_specs(ptree, None, stage, pmesh,
                                             kind))]
                assert got == want, (name, stage, kind)
                for shape in jshapes:
                    assert (pt_rules.choose_shard_dim(shape, (), size)
                            == jax_rules.choose_shard_dim(
                                shape, jax.sharding.PartitionSpec(), size))
    # a leaf no dim of which divides the size stays replicated
    specs = tree_leaves(pt_rules.zero_tree_specs(
        {"odd": torch.empty(13, device="meta"),
         "w": torch.empty(3, 16, device="meta")}, None, 1, pmesh, "master"))
    assert [sp.dim for sp in specs] == [None, 1]


def test_shard_and_gather_roundtrip_off_dim_zero():
    full = torch.arange(2 * 6 * 4, dtype=torch.float32).reshape(2, 6, 4)
    sp = pt_rules.ShardSpec(1, "data", 3)
    shards = [partition.shard_of(full, sp, i) for i in range(3)]
    assert all(s.is_contiguous() and s.shape == (2, 2, 4) for s in shards)
    # gather_into's layout: the (size, *shard) stack moved to the dim

    class Stack:
        def all_gather(self, t):
            return torch.stack(shards)

    out = torch.empty_like(full)
    partition.gather_into(out, shards[0], sp, Stack())
    assert torch.equal(out, full)
    assert partition.shard_of(full, pt_rules.ShardSpec(None, None, 1),
                              0) is full


@pytest.mark.parametrize("block", [
    {}, {"zero_optimization": {"stage": 2, "reduce_bucket_size": 5e7,
                               "overlap_comm": True}},
    {"zero_optimization": True}, {"zero_optimization": False},
    {"zero_optimization": {"stage": 1, "cpu_offload": False}},
])
def test_zero_config_fields_match_reference(block):
    j = jax_zero_config.ZeroConfig(block)
    t = pt_zero_config.ZeroConfig(block)
    for f in ("stage", "enabled", "allgather_partitions", "reduce_scatter",
              "overlap_comm", "contiguous_gradients", "reduce_bucket_size",
              "allgather_bucket_size", "sub_group_size"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.offload_optimizer.device == j.offload_optimizer.device
    with pytest.raises(ValueError) as want:
        jax_zero_config.ZeroConfig({"zero_optimization": {"stage": 4}})
    with pytest.raises(ValueError) as got:
        pt_zero_config.ZeroConfig({"zero_optimization": {"stage": 4}})
    assert str(got.value) == str(want.value)


def test_topology_split_and_intra_size(monkeypatch):
    for world, k in ((4, 2), (8, 4), (8, 2)):
        assert (pt_topology.intra_inter_split(world, k)
                == jax_topology.intra_inter_split(world, k))
    with pytest.raises(ValueError):
        pt_topology.intra_inter_split(6, 4)
    m = pt_mesh.default_mesh(world=8)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert pt_topology.derive_intra_size(m, ("data",)) is None  # one host
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert pt_topology.derive_intra_size(m, ("data",)) == 4
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    assert pt_topology.derive_intra_size(m, ("data",)) is None
