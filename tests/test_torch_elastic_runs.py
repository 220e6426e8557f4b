"""The port's canonical-slot step in the engine, against the reference's
and across world sizes.

The port's canonical step gives the reference's loss and grads at world 1
within 1e-5 relative (a 2-layer, width-64 GPT-NeoX in fp32 on the CPU,
plain attention, the same weights and batch). The port's canonical
losses at worlds 1 and 2 (two gloo processes, tests/torch_gloo_worker.py;
int8 wire with error feedback, ZeRO 1) are bit-identical over 3 steps,
and a world-2 tag resumes at world 1 with its (C, n) residual rows as
saved; classic (world, n) residuals saved at world 4 are resharded onto
world 2 by ``reshard_comm_residuals``, not zeroed, their sum over ranks
kept."""


import jax
import pytest
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh as JaxMesh

import deeperspeed_tpu
import deeperspeed_tpu_torch
from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.runtime.comm.reducer import \
    exact_slot_mean as jax_exact_slot_mean
from deeperspeed_tpu_torch.models import convert, gpt
from deeperspeed_tpu_torch.runtime.config import TrainingConfig
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)


def _mesh1():
    return JaxMesh(np.array(jax.devices()[:1]), ("data",))


# --------------------------------------------------------------------- #
# the canonical step: against the reference, and across world sizes
# --------------------------------------------------------------------- #

NEOX = dict(vocab_size=97, n_layer=2, n_head=4, d_model=64, max_seq=16,
            rotary=True, parallel_residual=True)


def _elastic_config(C=4, comm="int8", zero=1, **extra):
    cfg = {
        "elasticity": {"enabled": True, "max_train_batch_size": 16,
                       "micro_batch_sizes": [2, 4], "min_gpus": 1,
                       "max_gpus": 4, "version": 0.1,
                       "canonical_shards": C},
        "zero_optimization": {"stage": zero},
        "optimizer": {"type": "Adam", "params": {"lr": 3e-3,
                                                 "betas": [0.9, 0.95]}},
        "gradient_clipping": 1.0,
    }
    if comm is not None:
        cfg["comm"] = {"mode": comm, "bucket_mb": 0.01, "block": 32,
                       "error_feedback": True}
    cfg.update(extra)
    return cfg


def test_canonical_step_matches_the_reference_at_world_1():
    cfg = _elastic_config(comm=None, zero=0)
    jcfg = jax_gpt.GPTConfig(**NEOX, dtype=jnp.float32, attn_impl="xla",
                             ce_chunk=0)
    jinit, _, jloss, _ = jax_gpt.make_gpt(jcfg)
    jparams = jinit(jax.random.PRNGKey(0))
    tcfg = gpt.GPTConfig(**NEOX, dtype=torch.float32, attn_impl="xla",
                         ce_chunk=0)
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")
    rows = TrainingConfig(cfg, world_size=1).train_batch_size
    batch = np.random.RandomState(5).randint(0, 97, (rows, 17))
    mesh = _mesh1()
    jeng, _, _, _ = deeperspeed_tpu.initialize(
        model=jloss, model_parameters=jparams, config_params=cfg, mesh=mesh)
    C = jeng.canonical_shards
    assert C == 4

    @jax.jit
    def step(state, b, key):
        losses, slots = jeng._batch_grads_canonical(state, b, key, C)
        return (jax_exact_slot_mean(losses, mesh, "data", C),
                jax_exact_slot_mean(slots, mesh, "data", C))

    jl, jg = step(jeng.state, jnp.asarray(batch), jax.random.PRNGKey(0))
    jl = float(jl)
    jg = jax.tree.map(np.asarray, jg)
    teng, _, _, _ = deeperspeed_tpu_torch.initialize(
        model=gpt.make_gpt(tcfg)[2], model_parameters=tparams, config=cfg,
        device="cpu")
    teng.store_gradients = True
    tl = float(teng.train_batch(batch))
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    want = convert.from_jax_params(jg, tcfg, "cpu")
    got = teng.stored_gradients
    flat_w = {k: v for k, v in _flat(want)}
    for k, g in _flat(got):
        w = flat_w[k]
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * scale, k


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _params_file(tmp_path):
    tcfg = gpt.GPTConfig(**NEOX, dtype=torch.float32, attn_impl="xla")
    torch.save(gpt.init_params(3, tcfg, device="cpu"),
               str(tmp_path / "params.pt"))


def _read(tmp_path, tag, world):
    import json

    return [json.load(open(tmp_path / f"{tag}_rank{r}.json"))
            for r in range(world)]


def test_canonical_losses_bit_identical_at_worlds_1_and_2(tmp_path):
    _params_file(tmp_path)
    cfg = _elastic_config()
    worker.spawn("elastic_run", 2, tmp_path, NEOX, cfg, 3,
                 str(tmp_path / "ckpt2"), None, "w2")
    worker.elastic_run(0, 1, str(tmp_path), NEOX, cfg, 3, None, None, "w1")
    w2, (w1,) = _read(tmp_path, "w2", 2), _read(tmp_path, "w1", 1)
    assert w2[0]["losses"] == w2[1]["losses"] == w1["losses"]
    assert (w1["micro"], w1["gas"]) != (w2[0]["micro"], w2[0]["gas"]) or \
        w1["micro"] * w1["gas"] == 2 * w2[0]["micro"] * w2[0]["gas"]
    # the world-2 tag resumes at world 1 with its (C, n) residual rows as
    # saved (canonical fingerprints carry no world term), not zeroed, and
    # the next step continues the world-1 curve
    worker.elastic_run(0, 1, str(tmp_path), NEOX, cfg, 1, None,
                       str(tmp_path / "ckpt2"), "resume")
    (res,) = _read(tmp_path, "resume", 1)
    assert res["loaded"].endswith("global_step3")
    worker.elastic_run(0, 1, str(tmp_path), NEOX, cfg, 4, None, None,
                       "w1long")
    (w1long,) = _read(tmp_path, "w1long", 1)
    assert res["losses"] == w1long["losses"][3:]
    saved_rows = [np.asarray(r["e"]) for r in res["res_after_load"]]
    assert sum(float(np.abs(r).sum()) for r in saved_rows) > 0
    assert all(r.shape[0] == 4 for r in saved_rows)
    assert res["reshard"] == []


def test_cross_world_classic_residuals_resharded_not_zeroed(tmp_path):
    _params_file(tmp_path)
    base = {"zero_optimization": {"stage": 0},
            "optimizer": {"type": "Adam", "params": {"lr": 3e-3}},
            "comm": {"mode": "int8", "bucket_mb": 0.01, "block": 32,
                     "error_feedback": True}}
    worker.spawn("elastic_run", 4, tmp_path, NEOX,
                 dict(base, train_batch_size=8), 2,
                 str(tmp_path / "ckpt4"), None, "save4")
    worker.spawn("elastic_run", 2, tmp_path, NEOX,
                 dict(base, train_batch_size=8), 1, None,
                 str(tmp_path / "ckpt4"), "load2")
    loaded = _read(tmp_path, "load2", 2)
    assert all(r["loaded"].endswith("global_step2") for r in loaded)
    assert all(r["reshard"] == [{"world_from": 4, "world_to": 2}]
               for r in loaded)
    rows = [np.asarray(b["e"]) for r in loaded for b in r["res_after_load"]]
    assert sum(float(np.abs(x).sum()) for x in rows) > 0
    from deeperspeed_tpu_torch.checkpoint.serialization import load_tree

    saved = load_tree(str(tmp_path / "ckpt4" / "global_step2"
                          / "zero_pp_rank_0_mp_rank_00_optim_states.msgpack"))
    sbuckets = [saved["comm"][k] for k in sorted(saved["comm"], key=int)]
    for j, b in enumerate(sbuckets):
        # error feedback needs the sum over ranks kept; the two worlds pad
        # a bucket to different lengths, and the pad region holds zeros
        got = sum(np.asarray(r["res_after_load"][j]["e"]) for r in loaded)
        want = np.asarray(b["e"]).sum(axis=0)
        n = min(got.shape[0], want.shape[0])
        np.testing.assert_allclose(got[:n], want[:n], rtol=0, atol=1e-5)
        assert not got[n:].any() and not want[n:].any()


@pytest.mark.cuda
def test_canonical_losses_bit_identical_at_worlds_1_and_2_on_the_card(
        tmp_path):
    """The canonical step on the card, kernels auto: two processes
    sharing it (gloo through host copies) and one process give the same
    losses, bit for bit, over 3 steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _params_file(tmp_path)
    cfg = _elastic_config(kernels={"mode": "auto"})
    worker.spawn("elastic_run", 2, tmp_path, NEOX, cfg, 3, None, None, "w2",
                 "cuda")
    worker.elastic_run(0, 1, str(tmp_path), NEOX, cfg, 3, None, None, "w1",
                       "cuda")
    w2, (w1,) = _read(tmp_path, "w2", 2), _read(tmp_path, "w1", 1)
    assert w2[0]["losses"] == w2[1]["losses"] == w1["losses"]
