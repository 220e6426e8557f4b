"""The port's runtime/comm/ against the reference's.

``CommConfig`` parses and fails as the reference's; ``build_plan`` on the
GPT-NeoX-125M tree equals the reference's (leaf ids, offsets, lengths,
padding). The ``GradReducer`` runs in W = 2 and W = 4 gloo processes
(tests/torch_gloo_worker.py) on per-rank gradients drawn from a seed, for
3 steps, in the fp32, bf16, int8 (with and without error feedback),
compressed and lossless modes, and at W = 4 also the forced hierarchical
int8 and lossless schedules (intra_size 2); the reference reduces the
same stacked gradients with ``reduce_dispatch`` on a W-device CPU mesh,
its fused_quant surface on the XLA route.

Means and residuals are bit-identical in the compressed and lossless
modes at both W, and in fp32 and bf16 at W = 2. Elsewhere the two sides
round differently, and the test holds the difference to a few roundings
of the largest value:
* fp32 and bf16 at W = 4: the sum over ranks is XLA's psum on one side
  and gloo's ring all-reduce on the other, which add in another order:
  one fp32 ulp (2**-23) of the largest mean, two bf16 ulps (2**-7) for
  bf16, whose sum is rounded to bf16 (the residuals, c - bf16(c), are
  rank-local and exact);
* int8 (flat, hierarchical, with and without error feedback): inside the
  reference's jitted reduction XLA's CPU backend contracts q * s + acc of
  the row sum and x - q * s of the residual into FMAs, one rounding fewer
  than the port's plain versions and kernels take (they round q * s, as
  the reference's eager XLA route does, tests/test_torch_fused_quant.py):
  means within 4 ulps of the largest mean, residuals within 4 ulps of the
  largest value quantized (W times the largest gradient).
The error-feedback running mean converges as the reference's does
(tests/test_comm.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.ops import kernel_config as jax_kc
from deeperspeed_tpu.runtime.comm import bucketing as jax_bucketing
from deeperspeed_tpu.runtime.comm import compressed as jax_compressed
from deeperspeed_tpu.runtime.comm.config import CommConfig as JaxCommConfig
from deeperspeed_tpu.runtime.comm.reducer import GradReducer as JaxReducer
from deeperspeed_tpu.runtime.comm.reducer import pairwise_slot_sum as jps
from deeperspeed_tpu_torch.models import gpt as pt_gpt
from deeperspeed_tpu_torch.runtime import config as pt_config
from deeperspeed_tpu_torch.runtime.comm import bucketing as pt_bucketing
from deeperspeed_tpu_torch.runtime.comm import compressed as pt_compressed
from deeperspeed_tpu_torch.runtime.comm.config import CommConfig
from deeperspeed_tpu_torch.runtime.comm.reducer import pairwise_slot_sum
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

ULP = 2.0 ** -23


def _tolerance(case, world):
    """(mean tolerance relative to the largest |mean|, residual tolerance
    relative to the largest value quantized), None for bit-identical."""
    mode = case.split("-")[0]
    if mode == "int8":
        return 4 * ULP, 4 * ULP
    if world > 2 and mode == "fp32":
        return ULP, None
    if world > 2 and mode == "bf16":
        return 2.0 ** -7, None
    return None, None


# ------------------------------------------------------------------ #
# config and plan
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("bad", [
    {"mode": "int4"}, {"bucket_mb": 0}, {"bucket_mb": -1.0}, {"block": 4},
    {"hierarchical": "maybe"}, {"intra_size": 0}, {"overlap": "sometimes"},
    {"no_such_key": 1},
])
def test_comm_config_errors_match_reference(bad):
    with pytest.raises(ValueError) as want:
        JaxCommConfig.from_dict(bad)
    with pytest.raises(ValueError) as got:
        CommConfig.from_dict(bad)
    assert str(got.value) == str(want.value)


def test_comm_block_parses_as_reference():
    block = {"mode": "int8", "bucket_mb": 25, "block": 128,
             "error_feedback": True, "hierarchical": "auto"}
    cfg = pt_config.TrainingConfig({"train_batch_size": 4, "comm": block})
    assert cfg.comm_config() == CommConfig.from_dict(dict(block,
                                                          enabled=True))
    assert (cfg.comm_config().bucket_bytes
            == JaxCommConfig.from_dict(block).bucket_bytes)
    assert pt_config.TrainingConfig(
        {"train_batch_size": 4, "comm": {"enabled": False}}
    ).comm_config() is None
    with pytest.raises(pt_config.ConfigError, match="invalid \"comm\""):
        pt_config.TrainingConfig({"train_batch_size": 4,
                                  "comm": {"mode": "int4"}})
    # the backward-overlap schedule is ported: its values parse as the
    # reference's
    for value in ("off", "auto", "on"):
        assert pt_config.TrainingConfig(
            {"train_batch_size": 4, "comm": {"overlap": value}}
        ).comm_config().overlap == JaxCommConfig.from_dict(
            {"overlap": value}).overlap == value


def _meta_tree(shapes):
    if isinstance(shapes, dict):
        return {k: _meta_tree(v) for k, v in shapes.items()}
    return torch.empty(shapes, device="meta")


@pytest.mark.parametrize("bucket_mb,pad_to", [(25, 256), (4, 128 * 8),
                                              (0.5, 1)])
def test_bucket_plan_equals_reference_on_neox_125m(bucket_mb, pad_to):
    jtree = jax.eval_shape(lambda: jax_gpt.init_params(
        jax.random.PRNGKey(0), jax_gpt.get_preset("neox-125m")))
    ptree = _meta_tree(pt_gpt.param_shapes(pt_gpt.get_preset("neox-125m")))
    nbytes = int(bucket_mb * 2 ** 20)
    want = jax_bucketing.build_plan(jtree, nbytes, pad_to)
    got = pt_bucketing.build_plan(ptree, nbytes, pad_to)
    assert len(got.buckets) > 1 or bucket_mb == 25
    assert [tuple(vars(b).values()) for b in got.buckets] == [
        tuple(vars(b).values()) for b in want.buckets]
    assert (got.n_leaves, got.total_elements, got.pad_to) == (
        want.n_leaves, want.total_elements, want.pad_to)
    assert got.fingerprint() == want.fingerprint()


def test_pack_unpack_and_tree_order():
    rng = np.random.default_rng(0)
    tree = {"b": torch.from_numpy(rng.normal(size=(3, 5))),
            "a": {"z": torch.ones(7), "y": torch.zeros(2, 2)}}
    leaves, unflatten = pt_bucketing.tree_flatten_sorted(tree)
    assert [tuple(x.shape) for x in leaves] == [(2, 2), (7,), (3, 5)]
    back = unflatten(leaves)
    assert list(back) == ["b", "a"] and back["b"] is tree["b"]
    plan = pt_bucketing.build_plan(tree, 10 ** 6, pad_to=16)
    (b,) = plan.buckets
    flat = pt_bucketing.pack(b, leaves)
    assert flat.dtype == torch.float32 and flat.shape == (b.padded,)
    assert float(flat[b.length:].abs().sum()) == 0.0
    for got, want in zip(pt_bucketing.unpack(b, flat), leaves):
        assert torch.equal(got, want.float())


def test_compressed_blocks_and_pairwise_sum_match_reference():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(1000) * np.exp(rng.uniform(-8, 8, 1000))
         ).astype(np.float32)
    x[256:384] = 0.0
    m, e = jax_compressed._compress_blocks(jnp.asarray(x), 128)
    tm, te = pt_compressed._compress_blocks(torch.from_numpy(x), 128)
    np.testing.assert_array_equal(np.asarray(m), tm.numpy())
    np.testing.assert_array_equal(np.asarray(e), te.numpy())
    np.testing.assert_array_equal(
        np.asarray(jax_compressed._decompress_blocks(m, e, 1000)),
        pt_compressed._decompress_blocks(tm, te, 1000).numpy())
    for c in (1, 2, 3, 5, 8):
        rows = rng.standard_normal((c, 33)).astype(np.float32)
        np.testing.assert_array_equal(
            np.asarray(jps(jnp.asarray(rows))),
            pairwise_slot_sum(torch.from_numpy(rows)).numpy())


# ------------------------------------------------------------------ #
# the reducer at W gloo ranks against the reference on a W-device mesh
# ------------------------------------------------------------------ #

_RUNS = {}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    def get(world):
        if world not in _RUNS:
            d = tmp_path_factory.mktemp(f"reduce{world}")
            worker.spawn("reduce_run", world, d)
            _RUNS[world] = [dict(np.load(d / f"reduce_rank{r}.npz"))
                            for r in range(world)]
        return _RUNS[world]
    return get


def _reference(world, cfg):
    mesh = JaxMesh(np.array(jax.devices()[:world]), ("data",))
    outs = []
    with jax_kc.override(mode="auto"):
        red = JaxReducer(JaxCommConfig(**cfg), mesh)
        first = worker.grads_tree(100, world)
        red.build_plan({k: jnp.asarray(v[0]) for k, v in first.items()})
        state = red.init_state()
        for t in range(worker.REDUCE_STEPS):
            stacked = {k: jnp.asarray(v) for k, v in
                       worker.grads_tree(100 + t, world).items()}
            mean, state = red.reduce_dispatch(stacked, state)
            outs.append(({k: np.asarray(v) for k, v in mean.items()},
                         [{k: np.asarray(v) for k, v in s.items()}
                          for s in state]))
    return red, outs


@pytest.mark.parametrize("world,case", [
    (w, name) for w in (2, 4) for name, _ in worker.reduce_cases(w)])
def test_reducer_matches_reference(port_runs, world, case):
    cfg = dict(worker.reduce_cases(world))[case]
    ranks = port_runs(world)
    red, outs = _reference(world, cfg)
    assert int(ranks[0][f"{case}/hier_k"]) == (red.hier_k or 0)
    assert int(ranks[0][f"{case}/n_buckets"]) == red.n_buckets >= 2
    mean_tol, res_tol = _tolerance(case, world)
    gmax = world * max(float(np.abs(v).max()) for t in range(
        worker.REDUCE_STEPS) for v in worker.grads_tree(100 + t,
                                                        world).values())
    for t, (mean, state) in enumerate(outs):
        for r, got in enumerate(ranks):
            for k, want in mean.items():
                g = got[f"{case}/{t}/mean/{k}"]
                if mean_tol is None:
                    np.testing.assert_array_equal(g, want, err_msg=(
                        case, t, r, k))
                else:
                    np.testing.assert_allclose(
                        g, want, rtol=0,
                        atol=mean_tol * float(np.abs(want).max()))
            for j, res in enumerate(state):
                for k, want in res.items():
                    g = got[f"{case}/{t}/res/{j}/{k}"]
                    if res_tol is None:
                        np.testing.assert_array_equal(g, want[r])
                    else:
                        np.testing.assert_allclose(g, want[r], rtol=0,
                                                   atol=res_tol * gmax)
        # the mean is the same bits on every rank
        for got in ranks[1:]:
            for k in mean:
                np.testing.assert_array_equal(
                    got[f"{case}/{t}/mean/{k}"],
                    ranks[0][f"{case}/{t}/mean/{k}"])


def test_error_feedback_running_mean_converges(port_runs):
    """The same grads reduced 24 times with int8: with error feedback the
    running mean of the outputs approaches the true mean; without it the
    bias stays (the reference's test_error_feedback_running_mean_converges
    at W = 2)."""
    got = port_runs(2)[0]
    true = {k: v.mean(axis=0) for k, v in worker.grads_tree(2, 2).items()}
    err_ef = np.mean([np.abs(got[f"ef1/{k}"] - v).mean()
                      for k, v in true.items()])
    err_no = np.mean([np.abs(got[f"ef0/{k}"] - v).mean()
                      for k, v in true.items()])
    assert err_ef < 0.5 * max(err_no, 1e-12) or err_ef < 1e-4
