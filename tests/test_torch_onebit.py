"""The port's compressed wire and 1-bit optimizers against the reference.

runtime/comm/compressed.py, runtime/comm/onebit.py and onebit_spmd.py of
deeperspeed_tpu_torch against deeperspeed_tpu's, on numpy inputs from a
seed, in fp32 on the CPU:

* the 24-bit pieces (decompose, block compress) and the sign packing are
  bit-equal; ``onebit_compress`` packs the same bits, and its scale, an
  fp32 mean whose summation order differs between XLA and torch, agrees
  within SCALE_RTOL (a few fp32 ulps), the error within that difference;
* ``compressed_all_reduce``, ``onebit_all_reduce`` and
  ``onebit_all_reduce_2phase`` over 2 and 4 gloo ranks
  (tests/torch_gloo_worker.py) equal the reference's ``shard_map`` over 2
  and 4 CPU devices: the same signs, values within WIRE_RTOL; and so do
  the 1-bit Adam and LAMB wire train steps across the phase flip;
* ``OnebitAdam`` and ``OnebitLamb`` through ``initialize`` ->
  ``train_batch`` match the reference's engine over steps that cross
  ``freeze_step``, on losses, params and error buffers (ENGINE_RTOL), and
  a 1-bit checkpoint saved by either package loads in the other;
* ``configs/neox_6.7b_3d.json`` builds an engine with ``OnebitAdam``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import deeperspeed_tpu
import deeperspeed_tpu_torch
from deeperspeed_tpu.ops.ring_attention import _SHMAP_CHECK_KWARGS, shard_map
from deeperspeed_tpu.runtime.comm import compressed as jcp
from deeperspeed_tpu.runtime.comm import onebit as jonebit
from deeperspeed_tpu.runtime.comm import onebit_spmd as josp
from deeperspeed_tpu_torch.runtime.comm import compressed as tcp
from deeperspeed_tpu_torch.runtime.comm import onebit as tonebit
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# an fp32 mean over n elements: XLA and torch sum in different orders,
# measured up to 9 ulps apart at n = 1000
SCALE_RTOL = 4e-6
# values rebuilt from the same signs and scales that agree within
# SCALE_RTOL, through a few fp32 operations
WIRE_RTOL = 2e-5
# a few optimizer steps of fp32 math in two frameworks' orders
ENGINE_RTOL = 2e-5


def _mesh(W):
    return JaxMesh(np.array(jax.devices()[:W]), ("data",))


def _np(x):
    return np.asarray(x)


# --------------------------------------------------------------------- #
# the wire formats, one process
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("n", [1, 8, 13, 1000, 4099])
def test_sign_packing_is_bit_equal(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    x[::5] = 0.0           # zeros pack as +
    x[1::7] = -0.0         # as does -0.0 (>= 0)
    jp, jn = jcp._pack_signs(jnp.asarray(x))
    tp, tn = tcp._pack_signs(torch.from_numpy(x))
    assert jn == tn == n
    np.testing.assert_array_equal(tp.numpy(), _np(jp))
    np.testing.assert_array_equal(
        tcp._unpack_signs(tp, n).numpy(), _np(jcp._unpack_signs(jp, n)))


@pytest.mark.parametrize("n", [13, 1000, 4099])
def test_onebit_compress_matches_reference(n):
    rng = np.random.default_rng(n + 1)
    x = rng.standard_normal(n).astype(np.float32)
    e = (rng.standard_normal(n) * 0.1).astype(np.float32)
    jp, js, je = jcp.onebit_compress(jnp.asarray(x), jnp.asarray(e))
    tp, ts, te = tcp.onebit_compress(torch.from_numpy(x),
                                     torch.from_numpy(e))
    np.testing.assert_array_equal(tp.numpy(), _np(jp))
    np.testing.assert_allclose(float(ts), float(js), rtol=SCALE_RTOL)
    # the error is corrected - (+-scale): it moves with the scale, plus
    # the subtraction's own rounding (one ulp of the error)
    diff = np.abs(te.numpy() - _np(je))
    ulp = np.spacing(np.abs(_np(je)))
    assert np.all(diff <= abs(float(ts) - float(js)) + ulp)


def test_decompose_and_block_compress_are_bit_equal():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(1000) * np.exp(rng.uniform(-20, 20, 1000))
         ).astype(np.float32)
    x[:7] = 0.0
    jm, je = jcp.decompose(jnp.asarray(x))
    tm, te = tcp.decompose(torch.from_numpy(x))
    np.testing.assert_array_equal(tm.numpy(), _np(jm))
    np.testing.assert_array_equal(te.numpy(), _np(je))
    np.testing.assert_array_equal(
        tcp.reconstruct(tm, te).numpy(), _np(jcp.reconstruct(jm, je)))
    for block in (32, 128):
        jm, je, jmeta = jcp.compress(jnp.asarray(x.reshape(40, 25)), block)
        tm, te, tmeta = tcp.compress(torch.from_numpy(x.reshape(40, 25)),
                                     block)
        np.testing.assert_array_equal(tm.numpy(), _np(jm))
        np.testing.assert_array_equal(te.numpy(), _np(je))
        np.testing.assert_array_equal(
            tcp.decompress(tm, te, tmeta).numpy(),
            _np(jcp.decompress(jm, je, jmeta)))


# --------------------------------------------------------------------- #
# the wire over 2 and 4 ranks
# --------------------------------------------------------------------- #

WIRE_N, WIRE_ROUNDS, WIRE_SEED, WIRE_LR, WIRE_STEPS = 1001, 3, 7, 3e-2, 4


def _ref_wire(W):
    """The reference's side of ``worker.onebit_wire_run``: shard_map over
    W CPU devices, the same inputs."""
    mesh = _mesh(W)
    n, rounds = WIRE_N, WIRE_ROUNDS
    rng = np.random.default_rng(WIRE_SEED)
    xs = rng.standard_normal((rounds, W, n)).astype(np.float32)
    row = P("data", None)

    def sm(fn, n_in, n_out):
        return jax.jit(shard_map(fn, mesh=mesh, in_specs=(row,) * n_in,
                                 out_specs=(row,) * n_out,
                                 **_SHMAP_CHECK_KWARGS))

    out = {}
    ar = sm(lambda x: (jcp.compressed_all_reduce(x[0], "data")[None],), 1, 1)
    out["ar24"] = np.stack([_np(ar(jnp.asarray(xs[r]))[0])
                            for r in range(rounds)], axis=1)

    def ob(x, e):
        m, ne = jcp.onebit_all_reduce(x[0], "data", e[0])
        return m[None], ne[None]

    ob = sm(ob, 2, 2)
    err = jnp.zeros((W, n), jnp.float32)
    means, errs = [], []
    for r in range(rounds):
        m, err = ob(jnp.asarray(xs[r]), err)
        means.append(_np(m))
        errs.append(_np(err))
    out["ob_mean"], out["ob_err"] = (np.stack(means, axis=1),
                                     np.stack(errs, axis=1))

    def tp(x, we, se):
        m, nw, ns = josp.onebit_all_reduce_2phase(x[0], "data", we[0],
                                                  se[0], W)
        return m[None], nw[None], ns[None]

    tp = sm(tp, 3, 3)
    werr = jnp.zeros((W, n), jnp.float32)
    serr = jnp.zeros((W, josp._chunk_len(n, W)), jnp.float32)
    means, werrs, serrs = [], [], []
    for r in range(rounds):
        m, werr, serr = tp(jnp.asarray(xs[r]), werr, serr)
        means.append(_np(m))
        werrs.append(_np(werr))
        serrs.append(_np(serr))
    out["tp_mean"], out["tp_werr"], out["tp_serr"] = (
        np.stack(means, axis=1), np.stack(werrs, axis=1),
        np.stack(serrs, axis=1))

    params, (x, y) = worker.onebit_problem(WIRE_SEED, W)

    def loss_fn(p, batch):
        bx, by = batch
        return jnp.mean((bx @ p["w"] + p["b"] - by) ** 2)

    batch = (jnp.asarray(x), jnp.asarray(y))
    for name, opt, make in (
            ("adam", jonebit.OnebitAdam(lr=WIRE_LR, freeze_step=1),
             josp.make_onebit_spmd_train_step),
            ("lamb", jonebit.OnebitLamb(lr=WIRE_LR, freeze_step=1),
             josp.make_onebit_lamb_spmd_train_step)):
        p = {k: jnp.asarray(v) for k, v in params.items()}
        init, warm = make(loss_fn, opt, mesh, phase="warmup")
        _, comp = make(loss_fn, opt, mesh, phase="compressed")
        comm = init(p)
        losses = []
        for i in range(WIRE_STEPS):
            p, comm, loss = (warm if i == 0 else comp)(p, comm, batch,
                                                       WIRE_LR, i + 1)
            losses.append(float(loss))
        out[f"{name}_w"], out[f"{name}_b"] = _np(p["w"]), _np(p["b"])
        out[f"{name}_loss"] = np.asarray(losses)
        out[f"{name}_werr"] = _np(comm.werr)
    return out


def _wire_close(got, want, what):
    """Within WIRE_RTOL of the largest |value|: a server average of two
    near-equal scales of opposite sign cancels, so an element's error is
    relative to the scales, not to itself."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=WIRE_RTOL * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("W", [2, 4])
def test_wire_over_gloo_ranks_matches_reference_shard_map(tmp_path, W):
    worker.spawn("onebit_wire_run", W, tmp_path, WIRE_N, WIRE_ROUNDS,
                 WIRE_SEED, WIRE_LR, WIRE_STEPS)
    got = [dict(np.load(tmp_path / f"wire_rank{r}.npz")) for r in range(W)]
    ref = _ref_wire(W)
    for r in range(W):
        g = got[r]
        # the 24-bit sum: exact rebuilds, summed in rank order
        np.testing.assert_allclose(g["ar24"], ref["ar24"][r], rtol=1e-6,
                                   atol=1e-6)
        for key in ("ob_mean", "tp_mean"):
            # every rank holds the same mean, with the reference's signs
            np.testing.assert_array_equal(g[key], got[0][key])
            np.testing.assert_array_equal(np.sign(g[key]),
                                          np.sign(ref[key][r]))
            _wire_close(g[key], ref[key][r], key)
        for key in ("ob_err", "tp_werr", "tp_serr"):
            _wire_close(g[key], ref[key][r], key)
        for name in ("adam", "lamb"):
            for k in ("w", "b", "loss", "werr"):
                np.testing.assert_allclose(
                    g[f"{name}_{k}"],
                    ref[f"{name}_{k}"][r] if k == "werr"
                    else ref[f"{name}_{k}"],
                    rtol=WIRE_RTOL, atol=1e-6, err_msg=f"{name}_{k}")
    # the compressed phase trained: the loss fell after the flip
    assert got[0]["adam_loss"][-1] < got[0]["adam_loss"][0]


# --------------------------------------------------------------------- #
# the optimizers through both engines
# --------------------------------------------------------------------- #

FREEZE, STEPS = 2, 5


def _mlp_params():
    rng = np.random.default_rng(11)
    return {"w1": (rng.standard_normal((8, 16)) * 0.4).astype(np.float32),
            "w2": (rng.standard_normal((16, 4)) * 0.4).astype(np.float32),
            "b": np.zeros((4,), np.float32)}


def _batches():
    rng = np.random.default_rng(12)
    return [(rng.standard_normal((8, 8)).astype(np.float32),
             rng.standard_normal((8, 4)).astype(np.float32))
            for _ in range(STEPS)]


def _jloss(p, b):
    x, y = b
    return jnp.mean((jnp.tanh(x @ p["w1"]) @ p["w2"] + p["b"] - y) ** 2)


def _tloss(p, b):
    x, y = b
    return torch.mean((torch.tanh(x @ p["w1"]) @ p["w2"] + p["b"] - y) ** 2)


def _config(opt, **params):
    return {"train_batch_size": 8,
            "optimizer": {"type": opt,
                          "params": dict({"lr": 2e-2, "betas": [0.9, 0.95],
                                          "weight_decay": 0.01,
                                          "freeze_step": FREEZE}, **params)},
            "gradient_clipping": 1.0}


def _engines(opt):
    cfg = _config(opt)
    params = _mlp_params()
    jeng, _, _, _ = deeperspeed_tpu.initialize(
        model=_jloss, model_parameters={k: jnp.asarray(v)
                                        for k, v in params.items()},
        config=cfg, mesh=_mesh(1))
    teng, _, _, _ = deeperspeed_tpu_torch.initialize(
        model=_tloss, model_parameters={k: torch.from_numpy(v)
                                        for k, v in params.items()},
        config=cfg, device="cpu")
    return jeng, teng


def _close(t, j, what):
    np.testing.assert_allclose(t.detach().cpu().numpy(), _np(j),
                               rtol=ENGINE_RTOL, atol=1e-6, err_msg=what)


def _state_close(teng, jeng):
    tst, jst = teng.opt_state, jeng.state.opt_state
    assert int(tst.step) == int(jst.step)
    for field in tst._fields[1:]:
        for k in ("w1", "w2", "b"):
            _close(getattr(tst, field)[k], getattr(jst, field)[k],
                   f"{field}/{k}")


@pytest.mark.parametrize("opt", ["OneBitAdam", "OneBitLamb"])
def test_onebit_optimizers_through_initialize_match_reference(opt):
    jeng, teng = _engines(opt)
    assert type(teng.optimizer).__name__ == type(jeng.optimizer).__name__
    assert teng.optimizer.freeze_step == FREEZE
    for i, b in enumerate(_batches()):
        jl = float(jeng.train_batch(b))
        tl = float(teng.train_batch(b))
        assert abs(tl - jl) <= ENGINE_RTOL * abs(jl), (i, tl, jl)
        _state_close(teng, jeng)
        for k in ("w1", "w2", "b"):
            _close(teng.params[k], jeng.state.params[k], f"step {i} {k}")
    # the compressed phase ran: the error feedback is live
    assert float(teng.opt_state.error["w1"].abs().sum()) > 0
    if opt == "OneBitLamb":
        coeffs = teng.optimizer.get_lamb_coeffs(teng.opt_state)
        want = jeng.optimizer.get_lamb_coeffs(jeng.state.opt_state)
        np.testing.assert_allclose([float(c) for c in coeffs],
                                   sorted_like(want, teng), rtol=ENGINE_RTOL)


def sorted_like(jax_leaves, teng):
    """The reference's per-leaf values (sorted-key order) in the port's
    tree order."""
    by_key = dict(zip(sorted(teng.params), [float(x) for x in jax_leaves]))
    return [by_key[k] for k in teng.params]


@pytest.mark.parametrize("opt,writer", [("OneBitAdam", "port"),
                                        ("OneBitLamb", "port"),
                                        ("OneBitAdam", "reference"),
                                        ("OneBitLamb", "reference")])
def test_onebit_checkpoint_loads_in_the_other_package(tmp_path, opt, writer):
    """A tag saved past the freeze (the error feedback live) by one
    package loads in the other with the step, the moments, the error
    buffers (and LAMB's frozen ratios) as saved, and both engines continue
    from it alike."""
    jeng, teng = _engines(opt)
    batches = _batches()
    for b in batches[:FREEZE + 1]:
        jeng.train_batch(b)
        teng.train_batch(b)
    (teng if writer == "port" else jeng).save_checkpoint(str(tmp_path))
    jdst, tdst = _engines(opt)
    assert tdst.load_checkpoint(str(tmp_path))[0] is not None
    assert jdst.load_checkpoint(str(tmp_path))[0] is not None
    assert int(tdst.opt_state.step) == FREEZE + 1
    if writer == "port":
        for field in teng.opt_state._fields[1:]:
            for k in teng.params:
                assert torch.equal(getattr(tdst.opt_state, field)[k],
                                   getattr(teng.opt_state, field)[k])
    _state_close(tdst, jdst)
    _state_close(tdst, jeng)
    tl = float(tdst.train_batch(batches[-1]))
    jl = float(jdst.train_batch(batches[-1]))
    assert abs(tl - jl) <= ENGINE_RTOL * abs(jl)
    _state_close(tdst, jdst)


def test_neox_6_7b_3d_config_builds_onebit_adam():
    with open(os.path.join(REPO, "configs", "neox_6.7b_3d.json")) as f:
        cfg = json.load(f)
    cfg["train_batch_size"] = 4
    cfg["train_micro_batch_size_per_gpu"] = 4
    eng, opt, _, _ = deeperspeed_tpu_torch.initialize(
        model=_tloss, model_parameters={k: torch.from_numpy(v)
                                        for k, v in _mlp_params().items()},
        config=cfg, device="cpu")
    assert isinstance(opt, tonebit.OnebitAdam)
    assert opt.freeze_step == 20000 and opt.betas == (0.9, 0.95)
    assert eng.zero_stage == 1
    # the default freeze_step is the reference's
    del cfg["optimizer"]["params"]["freeze_step"]
    eng, opt, _, _ = deeperspeed_tpu_torch.initialize(
        model=_tloss, model_parameters={k: torch.from_numpy(v)
                                        for k, v in _mlp_params().items()},
        config=cfg, device="cpu")
    assert opt.freeze_step == 100000
