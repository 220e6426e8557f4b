"""The lifecycle and 1-bit slice on the card. This file imports no JAX, so
it runs on a GPU machine without it:

    python -m pytest tests/test_torch_cuda_lifecycle.py -m cuda -q

Where ``torch.cuda.is_available()`` is false, each test skips with a
reason. The CPU tests of the same code, against the reference, are
tests/test_torch_lifecycle.py and tests/test_torch_onebit.py."""

import json
import os
import sys

import pytest
import torch

from deeperspeed_tpu_torch.models import gpt
from deeperspeed_tpu_torch.runtime.comm import onebit as tonebit

# by path: a GPU machine may have another package named "tests" first
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_gloo_worker as worker  # noqa: E402

NEOX = dict(vocab_size=97, n_layer=2, n_head=4, d_model=64, max_seq=16,
            rotary=True, parallel_residual=True)
STEPS, SIGNAL_BEFORE = 5, 2


def _elastic_config():
    return {
        "elasticity": {"enabled": True, "max_train_batch_size": 16,
                       "micro_batch_sizes": [2, 4], "min_gpus": 1,
                       "max_gpus": 4, "version": 0.1,
                       "canonical_shards": 4},
        "zero_optimization": {"stage": 1},
        "optimizer": {"type": "Adam", "params": {"lr": 3e-3,
                                                 "betas": [0.9, 0.95]}},
        "gradient_clipping": 1.0,
        "comm": {"mode": "int8", "bucket_mb": 0.01, "block": 32,
                 "error_feedback": True},
        "kernels": {"mode": "auto"},
    }




@pytest.mark.cuda
def test_error_feedback_identity_on_the_card():
    """One compressed step of OnebitAdam on the card: the stored momentum
    is +-scale by the sign of m + err, and the new error is exactly
    fl((m + err) - quant) in fp32, as recomputed from the pre-step state;
    the plain CPU update gives the same signs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(0)
    shape = (512, 1024)
    p = torch.randn(shape, generator=gen)
    g = torch.randn(shape, generator=gen)
    opt = tonebit.OnebitAdam(lr=1e-3, freeze_step=0)
    st = opt.init({"p": p.cuda()})
    st.error["p"].copy_(torch.randn(shape, generator=gen).cuda() * 0.01)
    st.exp_avg["p"].copy_(torch.randn(shape, generator=gen).cuda() * 0.1)
    st.exp_avg_sq["p"].copy_(torch.rand(shape, generator=gen).cuda())
    m0, e0 = st.exp_avg["p"].clone(), st.error["p"].clone()
    params = {"p": p.cuda()}
    _, st = opt.update({"p": g.cuda()}, st, params)
    m_new = m0.mul(0.9).add(g.cuda(), alpha=1.0 - 0.9)
    corrected = m_new + e0
    quant = st.exp_avg["p"]
    scale = quant.abs().max()
    assert torch.equal(quant, torch.where(corrected >= 0, scale, -scale))
    assert torch.equal(st.error["p"], corrected - quant)


@pytest.mark.cuda
def test_live_remesh_2_to_1_bit_identical_on_the_card(tmp_path):
    """The 2 -> 1 shrink with both ranks on the one card (gloo through host
    copies), kernels auto, against one process on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tcfg = gpt.GPTConfig(**NEOX, dtype=torch.float32, attn_impl="xla")
    torch.save(gpt.init_params(3, tcfg, device="cpu"),
               str(tmp_path / "params.pt"))
    cfg = _elastic_config()
    live = dict(cfg, lifecycle={"pool_file": str(tmp_path / "pool"),
                                "remesh_debounce_s": 0.0},
                resilience={"async_save": False, "preemption_guard": False})
    worker.spawn("remesh_run", 2, tmp_path, NEOX, live, STEPS,
                 SIGNAL_BEFORE, 1, "live", "cuda")
    worker.remesh_run(0, 1, str(tmp_path), NEOX, cfg, STEPS, -1, 1, "ref",
                      "cuda")
    r0, ref = (json.loads((tmp_path / f"{t}.json").read_text())
               for t in ("live_rank0", "ref_rank0"))
    assert r0["worlds"] == [2, 2, 1, 1, 1]
    for key in ("losses", "gnorms", "params"):
        assert r0[key] == ref[key], key
