"""The port's elasticity/ and canonical-slot reduction against the
reference's.

``compute_elastic_config`` and ``elastic_world_sizes`` equal the
reference's over a grid of configs, errors included; ``TrainingConfig``
rewrites the batch triple and checks ``canonical_shards`` as the
reference's does; ``plans_reshardable`` and ``reshard_comm_residuals``
give the reference's arrays. ``exact_slot_mean`` and the canonical
``GradReducer`` equal the reference's bit for bit in fp32 on the same
slot rows (C in 4, 6, 8; the fp32 and int8 wires; three steps of error
feedback). The engine runs of the canonical
step are in tests/test_torch_elastic_runs.py.

The JAX side runs on a one-device CPU mesh."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from deeperspeed_tpu import elasticity as jel
from deeperspeed_tpu.resilience import reshard as jrs
from deeperspeed_tpu.runtime.comm import bucketing as jax_bucketing
from deeperspeed_tpu.runtime.comm.config import CommConfig as JaxCommConfig
from deeperspeed_tpu.runtime.comm.reducer import GradReducer as JaxReducer
from deeperspeed_tpu.runtime.comm.reducer import \
    exact_slot_mean as jax_exact_slot_mean
from deeperspeed_tpu.runtime.config import ConfigError as JaxConfigError
from deeperspeed_tpu.runtime.config import TrainingConfig as JaxConfig
from deeperspeed_tpu_torch import elasticity as pel
from deeperspeed_tpu_torch.resilience import reshard as prs
from deeperspeed_tpu_torch.runtime.comm import CommConfig, GradReducer
from deeperspeed_tpu_torch.runtime.comm.collectives import Transport
from deeperspeed_tpu_torch.runtime.comm.reducer import exact_slot_mean
from deeperspeed_tpu_torch.runtime.config import ConfigError, TrainingConfig
from deeperspeed_tpu_torch.sharding import mesh as pt_mesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh1():
    return JaxMesh(np.array(jax.devices()[:1]), ("data",))


# --------------------------------------------------------------------- #
# compute_elastic_config and the config rewrite
# --------------------------------------------------------------------- #

_GRID = [
    dict(max_train_batch_size=m, micro_batch_sizes=mb, min_gpus=lo,
         max_gpus=hi, prefer_larger_batch=pl)
    for m in (48, 64, 100, 512, 2000)
    for mb in ([2, 4, 6], [4, 8, 16], [3, 5], [8])
    for lo, hi in ((1, 64), (2, 16), (4, 8))
    for pl in (True, False)
]


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - compare the error, too
        return ("err", type(e).__name__, str(e))


@pytest.mark.parametrize("world", [0, 1, 2, 3, 4, 6, 12])
def test_compute_elastic_config_matches_the_reference(world):
    for block in _GRID:
        ds = {"elasticity": dict(block, enabled=True, version=0.1)}
        assert _outcome(pel.compute_elastic_config, ds, world_size=world) \
            == _outcome(jel.compute_elastic_config, ds, world_size=world), \
            (block, world)
        assert pel.elastic_world_sizes(ds) == jel.elastic_world_sizes(ds)


@pytest.mark.parametrize("bad", [
    {"enabled": True},
    {"enabled": True, "max_train_batch_size": 100,
     "micro_batch_sizes": [0, -1]},
    {"enabled": True, "max_train_batch_size": 100,
     "micro_batch_sizes": [2], "version": 99.0},
    {"enabled": True, "max_train_batch_size": 100,
     "micro_batch_sizes": [2], "min_gpus": 5, "max_gpus": 2},
    {"enabled": True, "max_train_batch_size": 1,
     "micro_batch_sizes": [2]},
])
def test_elastic_errors_match_the_reference(bad):
    p = _outcome(pel.compute_elastic_config, {"elasticity": bad})
    j = _outcome(jel.compute_elastic_config, {"elasticity": bad})
    assert p[0] == "err" and p == j
    assert pel.elastic_world_sizes({"elasticity": bad}) == \
        jel.elastic_world_sizes({"elasticity": bad}) == []


def test_multihost_config_cut_resolves_as_the_reference():
    """The cut phase 18b of chip_smoke.py makes (max_train_batch_size
    512 -> 64): 48 rows, micro 8 at world 2, admissible worlds [1, 2, 3,
    4, 6, 12], in both packages."""
    import json

    with open(os.path.join(REPO, "configs", "gpt_125m_multihost.json")) as f:
        raw = json.load(f)
    raw["elasticity"]["max_train_batch_size"] = 64
    assert pel.compute_elastic_config(raw, world_size=2) == \
        jel.compute_elastic_config(raw, world_size=2) == \
        (48, [1, 2, 3, 4, 6, 12], 8)
    raw["elasticity"]["canonical_shards"] = 8
    for w in (1, 2):
        tc, jc = TrainingConfig(raw, world_size=w), JaxConfig(raw,
                                                               world_size=w)
        triple = (tc.train_batch_size, tc.train_micro_batch_size_per_gpu,
                  tc.gradient_accumulation_steps)
        assert triple == (jc.train_batch_size,
                          jc.train_micro_batch_size_per_gpu,
                          jc.gradient_accumulation_steps)
        assert tc.elastic_canonical_shards == jc.elastic_canonical_shards \
            == 8
        assert tc.elastic_valid_world_sizes == jc.elastic_valid_world_sizes
        assert vars(tc.distributed_config()) == \
            vars(jc.distributed_config())


@pytest.mark.parametrize("ds,world", [
    ({"elasticity": {"enabled": True, "max_train_batch_size": 1024,
                     "micro_batch_sizes": [2, 4], "min_gpus": 1,
                     "max_gpus": 64, "version": 0.1}}, 8),
    ({"elasticity": {"enabled": True, "max_train_batch_size": 64,
                     "micro_batch_sizes": [4], "min_gpus": 4,
                     "max_gpus": 16, "version": 0.1,
                     "canonical_shards": 16}}, 8),
    ({"train_batch_size": 64,
      "elasticity": {"enabled": True, "max_train_batch_size": 1024,
                     "micro_batch_sizes": [2, 4], "version": 0.1}}, 8),
    ({"train_batch_size": 64,
      "elasticity": {"enabled": True, "max_train_batch_size": 1024,
                     "micro_batch_sizes": [2, 4], "version": 0.1,
                     "ignore_non_elastic_batch_info": True}}, 8),
    ({"elasticity": {"enabled": True, "max_train_batch_size": 64,
                     "micro_batch_sizes": [4], "version": 0.1,
                     "canonical_shards": -1}}, 4),
    ({"train_batch_size": 64}, 8),
])
def test_config_batch_rewrite_and_canonical_checks(ds, world):
    def build(cls, err):
        try:
            c = cls(ds, world_size=world)
        except err as e:
            return ("err", str(e))
        return (c.train_batch_size, c.train_micro_batch_size_per_gpu,
                c.gradient_accumulation_steps, c.elasticity_enabled,
                c.elastic_canonical_shards, c.elastic_valid_world_sizes)

    assert build(TrainingConfig, ConfigError) == build(JaxConfig,
                                                       JaxConfigError)


# --------------------------------------------------------------------- #
# resharding host arrays
# --------------------------------------------------------------------- #


def _plan(world, lengths, padded, mode="int8", ef=True, hier=None,
          canonical=0):
    return {"mode": mode, "world": world, "block": 256, "hier_k": hier,
            "canonical": canonical, "error_feedback": ef,
            "bucket_lengths": list(lengths), "bucket_padded": list(padded)}


def test_plans_reshardable_matches_the_reference():
    saved = _plan(8, [1072], [1280])
    saved["bucket_lengths"] = {"0": 1072}
    saved["bucket_padded"] = {"0": 1280}
    cases = [
        (saved, _plan(4, [1072], [1280])),
        (saved, _plan(4, [999], [1280])),
        (None, _plan(4, [1072], [1280])),
        (_plan(8, [1072], [1280], hier=4), _plan(4, [1072], [1280])),
        (_plan(8, [1072], [1280]), _plan(4, [1072], [1280], hier=2)),
        (_plan(8, [1072], [1280], canonical=16), _plan(4, [1072], [1280])),
        (_plan(8, [1072], [1280], mode="bf16"), _plan(4, [1072], [1280])),
    ]
    for s, t in cases:
        assert prs.plans_reshardable(s, t) == jrs.plans_reshardable(s, t)


@pytest.mark.parametrize("w_old,w_new", [(8, 4), (8, 16), (4, 2), (2, 1)])
def test_reshard_comm_residuals_matches_the_reference(w_old, w_new):
    rs = np.random.RandomState(w_old * 10 + w_new)
    length, padded = 100, 128
    e = np.zeros((w_old, padded), np.float32)
    e[:, :length] = rs.randn(w_old, length)
    e2 = rs.randn(w_old, padded // w_old).astype(np.float32)
    saved = [{"e": e, "e2": e2}, {"e": e[:, ::-1].copy()}]
    for buckets in (saved, {"0": saved[0], "1": saved[1]}):
        args = (buckets, _plan(w_old, [length, length], [padded, padded]),
                _plan(w_new, [length, length], [padded, padded]))
        got, want = prs.reshard_comm_residuals(*args), \
            jrs.reshard_comm_residuals(*args)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in g:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    bad = [{"e": e[:, :64]}]
    assert prs.reshard_comm_residuals(
        bad, _plan(w_old, [length], [padded]),
        _plan(w_new, [length], [padded])) is None


# --------------------------------------------------------------------- #
# exact_slot_mean and the canonical reducer, bit for bit
# --------------------------------------------------------------------- #


def _slot_grads(seed, C):
    rng = np.random.default_rng(seed)
    return [{"w1": (rng.normal(size=(40, 5)) * 10 ** rng.uniform(-3, 1))
             .astype(np.float32),
             "b1": rng.normal(size=(13,)).astype(np.float32),
             "w2": rng.normal(size=(200,)).astype(np.float32)}
            for _ in range(C)]


@pytest.mark.parametrize("C", [4, 6, 8])
def test_exact_slot_mean_matches_the_reference(C):
    rows = np.random.default_rng(C).normal(size=(C, 37, 3)).astype(
        np.float32)
    got = exact_slot_mean(torch.from_numpy(rows), Transport(None), C)
    want = jax_exact_slot_mean(jnp.asarray(rows), _mesh1(), "data", C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["fp32", "int8"])
@pytest.mark.parametrize("C", [4, 6, 8])
def test_canonical_reducer_matches_the_reference_bit_for_bit(C, mode):
    kw = dict(mode=mode, bucket_mb=0.0005, block=32)
    pr = GradReducer(CommConfig(**kw), pt_mesh.default_mesh(world=1),
                     canonical=C)
    jr = JaxReducer(JaxCommConfig(**kw), _mesh1(), axis_name="data",
                    canonical=C)
    like = _slot_grads(0, 1)[0]
    pr.build_plan({k: torch.from_numpy(v) for k, v in like.items()})
    jr.build_plan(like)
    assert [b.padded for b in pr.plan.buckets] == \
        [b.padded for b in jr.plan.buckets]
    assert pr.plan_summary() == {**jr.plan_summary(), "axes": ["data"]}
    assert pr.state_fingerprint()[1] == ("canonical", C)
    p_state = pr.init_state("cpu")
    j_state = [{k: np.zeros((C, n), np.float32)
                for k, n in jr._residual_shapes(b).items()}
               for b in jr.plan.buckets]
    for step in range(3):
        slots = _slot_grads(10 + step, C)
        mean, p_state = pr.reduce_canonical(
            [{k: torch.from_numpy(v) for k, v in s.items()} for s in slots],
            p_state)
        names = sorted(slots[0])
        for j, b in enumerate(jr.plan.buckets):
            rows = jnp.stack([jax_bucketing.pack(
                b, [jnp.asarray(s[names[i]]) for i in b.leaf_ids])
                for s in slots])
            red, nr = jr._reduce_canonical_flat(rows, j_state[j])
            j_state[j] = {k: np.asarray(v) for k, v in nr.items()}
            for i, leaf in zip(b.leaf_ids, jax_bucketing.unpack(b, red)):
                np.testing.assert_array_equal(mean[names[i]].numpy(),
                                              np.asarray(leaf))
            for k in j_state[j]:
                np.testing.assert_array_equal(p_state[j][k].numpy(),
                                              j_state[j][k])
    if mode == "int8":
        assert any(float(np.abs(r).sum()) > 0 for s in j_state
                   for r in s.values())
