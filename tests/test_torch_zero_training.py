"""Data-parallel training of a tiny GPT (2 layers, d_model 64) under ZeRO 0,
1 and 2 at 2 gloo ranks (tests/torch_gloo_worker.py).

Inside the port the 6-step loss curves of ZeRO 0, 1 and 2 are
bit-identical, losses, grad norms and params after every step: ZeRO only
partitions an elementwise update, the norm and the clip are taken on the
full reduced gradients, and the all-gather moves bits. That holds with no
comm block (the reducer's fp32 wire), with ``"comm": {"mode": "fp32"}``
and with int8, and both ranks hold the same params after every step.
Each rank keeps about half of ZeRO 0's optimizer-state bytes. A ZeRO 1 +
int8 run saved after step 3 resumes in a fresh engine from other
weights: steps 4-6 are bit-identical, params, master, moments and
error-feedback residuals included. A world-1 engine under ZeRO 1 and 2
gives the losses of ZeRO 0, bit for bit. The curves against the reference
engine: tests/test_torch_zero_reference.py."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu_torch
from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu_torch.models import convert, gpt
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

TINY = dict(vocab_size=97, n_layer=2, n_head=4, d_model=64, max_seq=64,
            rotary=True, parallel_residual=True)
S = 64


def _params():
    jcfg = jax_gpt.GPTConfig(**TINY, dtype=jnp.float32, attn_impl="xla")
    jinit, _, jloss, _ = jax_gpt.make_gpt(jcfg)
    jparams = jinit(jax.random.PRNGKey(0))
    tcfg = gpt.GPTConfig(**TINY, dtype=torch.float32, attn_impl="xla")
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")
    return jparams, jloss, tparams


def _batches():
    rs = np.random.RandomState(11)
    two = [rs.randint(0, 97, (8, S + 1)).astype(np.int32) for _ in range(2)]
    return two * (worker.TRAIN_STEPS // 2)


def spawn_training(d, cases, resume):
    """The port's 2-rank runs of ``cases``: each rank's results."""
    jparams, jloss, tparams = _params()
    torch.save(tparams, d / "params.pt")
    np.save(d / "batches.npy", np.stack(_batches()))
    worker.spawn("train_run", 2, d, TINY, cases, resume)
    return ([json.loads((d / f"train_rank{r}.json").read_text())
             for r in range(2)], jparams, jloss)


_RUN = {}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    if not _RUN:
        _RUN["ranks"], _, _ = spawn_training(
            tmp_path_factory.mktemp("zero"), worker.TRAIN_CASES, True)
    return _RUN


@pytest.mark.parametrize("comm", [None, "fp32", "int8"])
def test_zero_stages_bit_identical_and_ranks_agree(run, comm):
    r0, r1 = run["ranks"]
    base = r0[f"0/{comm}"]
    assert all(np.isfinite(base["losses"]))
    assert base["losses"][-1] < base["losses"][0]
    for zero in (1, 2):
        got = r0[f"{zero}/{comm}"]
        assert got["losses"] == base["losses"]
        assert got["grad_norms"] == base["grad_norms"]
        assert got["digests"] == base["digests"]
        # the optimizer state is sharded: about half of ZeRO 0's per rank
        assert got["state_bytes"] < 0.55 * base["state_bytes"]
        assert any(d is not None for d in got["sharded"])
    for key in r0:
        if key != "resume":
            # the reducer's mean is replicated: both ranks hold one model
            assert r0[key]["digests"] == r1[key]["digests"]
            assert r0[key]["losses"] == r1[key]["losses"]


def test_zero1_int8_resume_is_bit_identical(run):
    for rank in run["ranks"]:
        res = rank["resume"]
        assert res["tag"] == f"global_step{worker.SAVE_AFTER}"
        assert res["global_steps"] == worker.TRAIN_STEPS
        assert res["resumed"] == res["losses"][worker.SAVE_AFTER:]
        assert res["final_resumed"] == res["final"]
        assert res["residual_norm"] > 0  # error feedback was live


@pytest.mark.parametrize("zero", [1, 2])
def test_world_one_zero_stages_match_stage_zero(zero):
    _, _, tparams = _params()
    tcfg = gpt.GPTConfig(**TINY, dtype=torch.float32, attn_impl="xla")
    losses = {}
    for stage in (0, zero):
        cfg = worker.train_config(stage, None)
        cfg.update(train_batch_size=4)
        eng, _, _, _ = deeperspeed_tpu_torch.initialize(
            model=gpt.make_gpt(tcfg)[2], model_parameters=tparams,
            config=cfg, device="cpu")
        assert eng.data_parallel_size == 1
        assert not any(sp.sharded for sp in eng._specs)
        losses[stage] = [float(eng.train_batch(b[:4])) for b in _batches()]
    assert losses[zero] == losses[0]


def test_no_comm_block_reduces_as_the_fp32_wire(run):
    """Without a "comm" block the engine reduces through the GradReducer's
    fp32 wire: the same curve, bit for bit, as ``{"mode": "fp32"}`` with
    much smaller buckets (the mean is elementwise, so the bucket layout
    cannot change it)."""
    for rank in run["ranks"]:
        for zero in (0, 1, 2):
            none, fp32 = rank[f"{zero}/None"], rank[f"{zero}/fp32"]
            assert none["losses"] == fp32["losses"]
            assert none["grad_norms"] == fp32["grad_norms"]
            assert none["digests"] == fp32["digests"]


def test_int8_first_step_grad_norm_tracks_fp32(run):
    """Step 1 starts from the same params under both wires, so its grad
    norms differ only by the int8 quantization error of the mean (1.6e-4
    relative at this size, blocks of 32); a mean off by a factor, or wrong
    in one bucket, would leave the bound of 1e-3."""
    r0 = run["ranks"][0]
    for zero in (0, 1, 2):
        a = r0[f"{zero}/int8"]["grad_norms"][0]
        b = r0[f"{zero}/fp32"]["grad_norms"][0]
        assert abs(a - b) / b <= 1e-3
