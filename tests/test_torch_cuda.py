"""The PyTorch port's CUDA kernels against their plain versions, on the
card. This file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Where ``torch.cuda.is_available()`` is false, each test skips with a
reason."""

import pytest
import torch

from deeperspeed_tpu_torch.ops import fused_blocks as fb


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Both kernels against their plain versions at the serving path's
    widths, bf16 and fp32, with ragged row counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for R in (8, 48, 512):
            x = torch.randn(R, 2048, generator=gen, device="cuda").to(dtype)
            w = torch.randn(2048, generator=gen, device="cuda") * 0.1 + 1
            b = torch.randn(2048, generator=gen, device="cuda") * 0.1
            got = fb.ln_fwd(x, w, b, 1e-5)
            want = fb.ln_fwd_plain(x, w, b, 1e-5)
            torch.testing.assert_close(got[0].float(), want[0].float(),
                                       atol=tol, rtol=tol)
            for g, p in zip(got[1:], want[1:]):
                torch.testing.assert_close(g, p, atol=2e-5, rtol=2e-5)
            h = torch.randn(R, 8192, generator=gen, device="cuda").to(dtype)
            hb = torch.randn(8192, generator=gen, device="cuda").to(dtype)
            for approximate in (True, False):
                torch.testing.assert_close(
                    fb.bias_gelu_fwd(h, hb, approximate).float(),
                    fb.bias_gelu_fwd_plain(h, hb, approximate).float(),
                    atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    x = torch.randn(4, 64, device="cuda")
    w, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    with pytest.raises(ValueError, match="dtype"):
        fb.ln_fwd(x.half(), w, b, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        fb.ln_fwd(x.t().contiguous().t(), w, b, 1e-5)
    with pytest.raises(ValueError, match="shape"):
        fb.ln_fwd(x, w[:32], b, 1e-5)
    with pytest.raises(ValueError, match="float32"):
        fb.ln_fwd(x, w.bfloat16(), b, 1e-5)
    with pytest.raises(ValueError, match="dtype"):
        fb.bias_gelu_fwd(x, b.bfloat16(), True)     # fp32 x takes fp32 b
    with pytest.raises(ValueError, match="non-empty"):
        fb.bias_gelu_fwd(x[:0], b, True)


@pytest.mark.cuda
def test_cuda_serving_takes_the_kernels_and_keeps_greedy_tokens():
    """A small fp32 model served on the card: with the kernels forced on,
    both launch counters move and the greedy tokens equal the plain
    path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    from deeperspeed_tpu_torch.models import gpt
    from deeperspeed_tpu_torch.ops import kernel_config
    from deeperspeed_tpu_torch.serving import ServingEngine

    cfg = gpt.GPTConfig(vocab_size=97, n_layer=2, n_head=4, d_model=64,
                        max_seq=128, rotary=False, parallel_residual=False,
                        dtype=torch.float32)
    params = gpt.init_params(0, cfg, device="cuda")
    prompts = [[(7 * i + j) % 97 for j in range(5 + 3 * i)] for i in range(4)]

    def serve(mode):
        with kernel_config.override(mode=mode):
            eng = ServingEngine(cfg, params, {"num_slots": 3, "block_size": 4,
                                              "num_blocks": 64,
                                              "max_seq_len": 48})
            rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
            outs = eng.run()
        return [outs[r] for r in rids]

    plain = serve("off")
    before = (fb.ln_fwd.launches, fb.bias_gelu_fwd.launches)
    fused = serve("fused")
    after = (fb.ln_fwd.launches, fb.bias_gelu_fwd.launches)
    assert after[0] > before[0] and after[1] > before[1]
    assert fused == plain
