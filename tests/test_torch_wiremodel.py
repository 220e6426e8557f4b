"""The port's wire model (runtime/comm/wiremodel.py) against the
reference's on the same bucket plans: every function gives the same
numbers exactly (==, no tolerance), for every wire mode, flat and
hierarchical, at several world sizes, on GPT-NeoX-125M's plans at three
bucket sizes; and the flat fp32/bf16/int8 prices are twice the port
reducer's own per-bucket model (the reference counts both phases in the
bits and again in the ring factor)."""

import jax
import pytest
import torch

from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.runtime.comm import bucketing as jax_bucketing
from deeperspeed_tpu.runtime.comm import wiremodel as jax_wm
from deeperspeed_tpu.runtime.comm.config import CommConfig as JaxCommConfig
from deeperspeed_tpu_torch.models import gpt as pt_gpt
from deeperspeed_tpu_torch.runtime.comm import bucketing as pt_bucketing
from deeperspeed_tpu_torch.runtime.comm import wiremodel as pt_wm
from deeperspeed_tpu_torch.runtime.comm.config import CommConfig
from deeperspeed_tpu_torch.runtime.comm.reducer import GradReducer

torch.set_num_threads(1)

MODES = ("fp32", "bf16", "int8", "compressed", "lossless")
WORLDS = (1, 2, 4, 8)


def _meta_tree(shapes):
    if isinstance(shapes, dict):
        return {k: _meta_tree(v) for k, v in shapes.items()}
    return torch.empty(shapes, device="meta")


def _plans(bucket_mb, pad_to):
    jtree = jax.eval_shape(lambda: jax_gpt.init_params(
        jax.random.PRNGKey(0), jax_gpt.get_preset("neox-125m")))
    ptree = _meta_tree(pt_gpt.param_shapes(pt_gpt.get_preset("neox-125m")))
    nbytes = int(bucket_mb * 2 ** 20)
    return (jax_bucketing.build_plan(jtree, nbytes, pad_to),
            pt_bucketing.build_plan(ptree, nbytes, pad_to))


@pytest.fixture(scope="module")
def plans():
    return {(mb, pad): _plans(mb, pad)
            for mb, pad in ((25, 256), (4, 128 * 8), (0.5, 1))}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("block", [32, 128])
def test_mode_wire_bits_and_ring_factor(mode, block):
    for w in WORLDS:
        assert (pt_wm.mode_wire_bits(mode, block, w)
                == jax_wm.mode_wire_bits(mode, block, w))
        assert pt_wm.ring_factor(w) == jax_wm.ring_factor(w)
    with pytest.raises(ValueError, match="unknown comm mode"):
        pt_wm.mode_wire_bits("int4")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("key", [(25, 256), (4, 128 * 8), (0.5, 1)])
def test_plan_wire_bytes_and_summary(plans, mode, key):
    jplan, pplan = plans[key]
    for block in (32, 128):
        jcfg = JaxCommConfig.from_dict({"mode": mode, "block": block})
        pcfg = CommConfig.from_dict({"mode": mode, "block": block})
        for w in WORLDS:
            got = pt_wm.plan_wire_bytes(pplan, pcfg, w)
            assert isinstance(got, int)
            assert got == jax_wm.plan_wire_bytes(jplan, jcfg, w)
            assert (pt_wm.plan_collective_launches(pplan, w)
                    == jax_wm.plan_collective_launches(jplan, w))
            n = pplan.total_elements
            assert (pt_wm.wire_summary(pplan, pcfg, w, n)
                    == jax_wm.wire_summary(jplan, jcfg, w, n))
            assert (pt_wm.wire_summary(None, None, w, n)
                    == jax_wm.wire_summary(None, None, w, n))
            assert (pt_wm.dense_wire_bytes(n, w)
                    == jax_wm.dense_wire_bytes(n, w))


@pytest.mark.parametrize("mode", ["int8", "lossless"])
@pytest.mark.parametrize("world,intra", [(4, 2), (8, 2), (8, 4), (16, 8)])
def test_hier_wire_split(plans, mode, world, intra):
    jplan, pplan = plans[(4, 128 * 8)]
    for block in (32, 128):
        jcfg = JaxCommConfig.from_dict({"mode": mode, "block": block})
        pcfg = CommConfig.from_dict({"mode": mode, "block": block})
        assert (pt_wm.hier_wire_split(pplan, pcfg, world, intra)
                == jax_wm.hier_wire_split(jplan, jcfg, world, intra))


def test_hier_wire_split_errors_as_reference(plans):
    jplan, pplan = plans[(25, 256)]
    for kw in ({"world": 8, "intra_size": 3}, {"world": 1, "intra_size": 1},
               {"world": 8, "intra_size": 1}):
        with pytest.raises(ValueError) as je:
            jax_wm.hier_wire_split(jplan, JaxCommConfig(mode="int8"), **kw)
        with pytest.raises(ValueError) as pe:
            pt_wm.hier_wire_split(pplan, CommConfig(mode="int8"), **kw)
        assert str(pe.value) == str(je.value)
    with pytest.raises(ValueError, match='modes "int8" and "lossless"'):
        pt_wm.hier_wire_split(pplan, CommConfig(mode="bf16"), 8, 4)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
def test_flat_price_is_twice_the_reducers_model(plans, mode):
    """At world 2 (phase 14's layout) the reducer's padded buckets make
    every term whole: the reference's price is exactly twice the port
    reducer's ``total_wire_bytes`` for the same plan."""
    world = 2
    cfg = CommConfig(mode=mode, block=128)
    # the reducer's price needs its plan, world and schedule only (no
    # process group: this test runs in one process)
    red = GradReducer.__new__(GradReducer)
    red.cfg, red.world, red.hier_k, red.canonical = cfg, world, None, 0
    red.plan = pt_bucketing.build_plan(
        _meta_tree(pt_gpt.param_shapes(pt_gpt.get_preset("neox-125m"))),
        cfg.bucket_bytes, cfg.block * world)
    assert pt_wm.plan_wire_bytes(red.plan, cfg, world) == \
        2 * red.total_wire_bytes()
