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


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")


@pytest.mark.cuda
def test_cuda_dispatchers_are_differentiable_through_the_kernels():
    """layer_norm and bias_gelu on a CUDA tensor return outputs with a
    grad_fn; their backward launches ln_bwd and bias_gelu_bwd and gives
    the plain path's grads (the reference's gradient tolerances: 10x the
    forward ones)."""
    _needs_card()
    from deeperspeed_tpu_torch.ops import kernel_config

    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-1)):
        x = torch.randn(3, 40, 2048, generator=gen, device="cuda").to(dtype)
        w = torch.randn(2048, generator=gen, device="cuda") * 0.1 + 1
        b = torch.randn(2048, generator=gen, device="cuda") * 0.1
        gy = torch.randn(3, 40, 2048, generator=gen, device="cuda").to(dtype)
        h = torch.randn(3, 40, 1024, generator=gen, device="cuda").to(dtype)
        hb = torch.randn(1024, generator=gen, device="cuda").to(dtype)
        gh = torch.randn(3, 40, 1024, generator=gen, device="cuda").to(dtype)
        grads = {}
        for mode in ("fused", "off"):
            leaves = [t.clone().requires_grad_() for t in (x, w, b, h, hb)]
            with kernel_config.override(mode=mode):
                before = (fb.ln_bwd.launches, fb.bias_gelu_bwd.launches)
                y = fb.layer_norm(leaves[0], leaves[1], leaves[2], 1e-5)
                z = fb.bias_gelu(leaves[3], leaves[4], True)
                assert y.grad_fn is not None and z.grad_fn is not None
                grads[mode] = torch.autograd.grad((y, z), leaves, (gy, gh))
                after = (fb.ln_bwd.launches, fb.bias_gelu_bwd.launches)
            if mode == "fused":
                assert after == (before[0] + 1, before[1] + 1)
            else:
                assert after == before
        for a, p in zip(grads["fused"], grads["off"]):
            assert a.dtype == p.dtype
            torch.testing.assert_close(a.float(), p.float(), atol=tol,
                                       rtol=tol)


@pytest.mark.cuda
def test_cuda_flash_kernels_match_plain_versions():
    """flash_fwd and flash_bwd against their plain versions at one small
    ragged shape, causal and not, fp32 and bf16 (the reference's flash
    tolerances: fp32 2e-3 / 5e-3, bf16 2e-2 / 5e-2)."""
    _needs_card()
    from deeperspeed_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    for dtype, ftol, gtol in ((torch.float32, 2e-3, 5e-3),
                              (torch.bfloat16, 2e-2, 5e-2)):
        for causal in (True, False):
            q, k, v, do = (torch.randn(1, 3, 200, 64, generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(4))
            o, lse = fa.flash_fwd(q, k, v, 0.125, causal)
            po, plse = fa.flash_fwd_plain(q, k, v, 0.125, causal)
            torch.testing.assert_close(o.float(), po.float(), atol=ftol,
                                       rtol=ftol)
            torch.testing.assert_close(lse, plse, atol=ftol, rtol=ftol)
            got = fa.flash_bwd(q, k, v, po, plse, do, 0.125, causal)
            want = fa.flash_bwd_plain(q, k, v, po, plse, do, 0.125, causal)
            for a, p in zip(got, want):
                torch.testing.assert_close(a.float(), p.float(), atol=gtol,
                                           rtol=gtol)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(*(torch.zeros(1, 1, 8, 32, device="cuda"),) * 3, 1.0,
                     True)


@pytest.mark.cuda
def test_cuda_fused_adam_route_raises_until_the_kernel_is_ported():
    _needs_card()
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.ops import kernel_config

    conf = {"train_batch_size": 1, "kernels": {"mode": "fused"}}
    with kernel_config.override():
        with pytest.raises(NotImplementedError, match="row 13"):
            ds.initialize(model=lambda p, b: p["w"].sum(),
                          model_parameters={"w": torch.ones(4)}, config=conf)
        conf["kernels"]["fused_adam"] = False
        eng, _, _, _ = ds.initialize(model=lambda p, b: p["w"].sum(),
                                     model_parameters={"w": torch.ones(4)},
                                     config=conf)
        eng.train_batch(torch.zeros(1))
    assert eng.global_steps == 1


@pytest.mark.cuda
def test_cuda_auto_attention_raises_on_what_the_flash_kernel_cannot_take():
    """attn_impl "auto" sends every Hopper CUDA tensor to the flash kernel:
    an fp16 model or a head dim of 80 raises instead of taking dense
    attention; "xla" runs both."""
    _needs_card()
    from deeperspeed_tpu_torch.models import gpt
    from deeperspeed_tpu_torch.ops import kernel_config

    if not kernel_config._is_hopper(torch.device("cuda")):
        pytest.skip("auto routes to the flash kernel on Hopper only")
    for dtype, dh, match in ((torch.float16, 64, "float32 or bfloat16"),
                             (torch.float32, 80, "head_dim")):
        q = torch.randn(1, 32, 2, dh, device="cuda").to(dtype)
        with pytest.raises(ValueError, match=match):
            gpt.causal_attention(q, q, q, "auto")
        assert torch.isfinite(
            gpt.causal_attention(q, q, q, "xla").float()).all()
