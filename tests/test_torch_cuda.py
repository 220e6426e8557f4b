"""The PyTorch port's CUDA kernels against their plain versions, on the
card. This file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Where ``torch.cuda.is_available()`` is false, each test skips with a
reason."""

import math

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
    # x and residual of two dtypes: the add-LN dispatcher hands them to the
    # wrapper, which raises, rather than adding them on the plain path
    from deeperspeed_tpu_torch.ops import kernel_config
    with pytest.raises(ValueError, match="r has dtype"):
        fb.add_ln_fwd(x.bfloat16(), x, w, b, 1e-5)
    with kernel_config.override(mode="fused"):
        with pytest.raises(ValueError, match="r has dtype"):
            fb.add_layer_norm(x.bfloat16(), x, w, b, 1e-5)


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
    """flash_fwd and flash_bwd against their plain versions at S on the
    kernels' tile edges (1, 17, 63, 65, 127, 129) and a ragged 200, head
    dims 64, 96 and 128, causal and not, fp32 and bf16 (the reference's
    flash tolerances: fp32 2e-3 / 5e-3, bf16 2e-2 / 5e-2); a second launch
    on the same inputs must give the same bits (the backward has no
    atomics)."""
    _needs_card()
    from deeperspeed_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    for S in (1, 17, 63, 65, 127, 129, 200):
        for Dh in (64, 96, 128):
            scale = 1.0 / math.sqrt(Dh)
            for dtype, ftol, gtol in ((torch.float32, 2e-3, 5e-3),
                                      (torch.bfloat16, 2e-2, 5e-2)):
                for causal in (True, False):
                    q, k, v, do = (torch.randn(1, 3, S, Dh, generator=gen,
                                               device="cuda").to(dtype)
                                   for _ in range(4))
                    o, lse = fa.flash_fwd(q, k, v, scale, causal)
                    po, plse = fa.flash_fwd_plain(q, k, v, scale, causal)
                    torch.testing.assert_close(o.float(), po.float(),
                                               atol=ftol, rtol=ftol)
                    torch.testing.assert_close(lse, plse, atol=ftol,
                                               rtol=ftol)
                    got = fa.flash_bwd(q, k, v, po, plse, do, scale, causal)
                    want = fa.flash_bwd_plain(q, k, v, po, plse, do, scale,
                                              causal)
                    for a, p in zip(got, want):
                        torch.testing.assert_close(a.float(), p.float(),
                                                   atol=gtol, rtol=gtol)
                    again = (fa.flash_fwd(q, k, v, scale, causal)
                             + fa.flash_bwd(q, k, v, po, plse, do, scale,
                                            causal))
                    for a, b in zip((o, lse) + got, again):
                        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(*(torch.zeros(1, 1, 8, 32, device="cuda"),) * 3, 1.0,
                     True)
    x = torch.zeros(1 * 1 * 8 * 64 + 1, device="cuda",
                    dtype=torch.bfloat16)[1:].view(1, 1, 8, 64)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_fwd(x, x, x, 1.0, True)


# leaf shapes of the fused Adam cases: a 0-d leaf, counts that are no
# multiple of the kernel's 8-element step, a leaf of several 65536-element
# chunks, and an LM-head-like (3, 50304)
ADAM_SHAPES = ((), (7,), (1000,), (3, 50304), (2, 65536 + 5))
ADAM_COMBOS = (
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, None),
    (torch.bfloat16, torch.bfloat16, torch.float32, None),
    (torch.float32, torch.float32, torch.float32, None),
    (torch.float32, torch.float32, torch.float32, torch.bfloat16),
    (torch.float32, torch.float32, torch.float32, torch.float16),
)


def _adam_leaves(gen, shapes, pdt, mdt, vdt, cdt, unaligned=False):
    """(ps, gs, ms, vs, cs) on the card; ``unaligned`` offsets every leaf
    by one element, off the kernel's 16-byte vector path."""
    def make(shape, dtype, positive=False):
        n = math.prod(shape) + (1 if unaligned else 0)
        t = torch.randn(n, generator=gen, device="cuda")
        t = (t.abs() * 1e-3 if positive else t).to(dtype)
        return (t[1:] if unaligned else t).view(shape)

    ps = [make(s, pdt) for s in shapes]
    return (ps, [make(s, pdt) for s in shapes],
            [make(s, mdt) for s in shapes],
            [make(s, vdt, positive=True) for s in shapes],
            None if cdt is None else [torch.empty(s, dtype=cdt,
                                                  device="cuda")
                                      for s in shapes])


@pytest.mark.cuda
def test_cuda_fused_adam_matches_its_plain_version_bit_for_bit():
    """The kernel against its plain version over 3 steps, every dtype
    combination the engine builds, Adam and AdamW, weight decay 0 and
    0.01, bias correction on and off, aligned and unaligned leaves: both
    round at the same places, so every output is equal."""
    _needs_card()
    from deeperspeed_tpu_torch.ops import fused_adam as fa_

    gen = torch.Generator(device="cuda").manual_seed(0)
    for combo in ADAM_COMBOS:
        for adam_w, wd, bias_correction, unaligned in (
                (True, 0.0, True, False), (True, 0.01, True, False),
                (False, 0.01, True, True), (True, 0.01, False, False)):
            got = _adam_leaves(gen, ADAM_SHAPES, *combo, unaligned)
            want = tuple(None if x is None else [t.clone() for t in x]
                         for x in got)
            kw = dict(b1=0.9, b2=0.95, eps=1e-8, wd=wd, adam_w=adam_w)
            before = fa_.fused_adam.launches
            for step in (1, 2, 3):
                scal = fa_.adam_scalars(1e-3, step, 0.9, 0.95,
                                        bias_correction)
                fa_.fused_adam(*got, *scal, **kw)
                fa_.adam_plain(*want, *scal, **kw)
            torch.cuda.synchronize()
            assert fa_.fused_adam.launches == before + 3
            for a_list, b_list in zip(got, want):
                for a, b in zip(a_list or (), b_list or ()):
                    assert torch.equal(a, b), (combo, adam_w, wd,
                                               bias_correction, unaligned)


@pytest.mark.cuda
def test_cuda_fused_adam_rejects_what_the_kernel_does_not_take():
    """fp16 storage, a list of two dtype combinations and a
    non-contiguous leaf raise; more than 64 leaves take one launch per
    64; under a "kernels" route the optimizer takes no plain path on the
    card."""
    _needs_card()
    from deeperspeed_tpu_torch.ops import fused_adam as fa_
    from deeperspeed_tpu_torch.ops import kernel_config
    from deeperspeed_tpu_torch.ops.adam import FusedAdam

    gen = torch.Generator(device="cuda").manual_seed(1)
    scal = fa_.adam_scalars(1e-3, 1, 0.9, 0.95, True)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.0, adam_w=True)
    half = _adam_leaves(gen, [(8,)], *(torch.float16,) * 3, None)
    with pytest.raises(ValueError, match="dtype combination"):
        fa_.fused_adam(*half, *scal, **kw)
    mixed = _adam_leaves(gen, [(8,), (8,)], *ADAM_COMBOS[0])
    mixed[3][1] = mixed[3][1].float()
    with pytest.raises(ValueError, match="leaf 1 exp_avg_sq has dtype"):
        fa_.fused_adam(*mixed, *scal, **kw)
    bent = _adam_leaves(gen, [(8, 8)], *ADAM_COMBOS[2])
    bent[0][0] = bent[0][0].t()
    with pytest.raises(ValueError, match="contiguous"):
        fa_.fused_adam(*bent, *scal, **kw)
    many = _adam_leaves(gen, [(3,)] * 130, *ADAM_COMBOS[2])
    before = fa_.fused_adam.launches
    fa_.fused_adam(*many, *scal, **kw)
    assert fa_.fused_adam.launches == before + 3
    opt = FusedAdam(state_dtype=torch.float16, betas=(0.9, 0.95))
    p = {"w": torch.ones(4, device="cuda", dtype=torch.float16)}
    with kernel_config.override(mode="fused"):
        with pytest.raises(ValueError, match="dtype combination"):
            opt.update({"w": torch.ones_like(p["w"])}, opt.init(p), p)


@pytest.mark.cuda
def test_cuda_engine_steps_through_the_fused_adam_kernel():
    """Masterless bf16 and bf16 with an fp32 master: under "kernels"
    mode fused each applied step is one fused_adam launch, and the params
    and moments equal those of the same engine with the kernels off."""
    _needs_card()
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.ops import fused_adam as fa_
    from deeperspeed_tpu_torch.ops import kernel_config

    def loss(p, b):
        return ((b.float() @ p["w"].float().t()) ** 2).mean() + \
            p["b"].float().sum()

    params = {"w": torch.randn(3, 17, generator=torch.Generator()
                               .manual_seed(2)), "b": torch.ones(5)}
    batch = torch.randn(4, 17, 2, generator=torch.Generator().manual_seed(3))
    for bf16 in ({"enabled": True, "master_weights": False},
                 {"enabled": True}):
        conf = {"train_batch_size": 4, "bf16": bf16,
                "optimizer": {"type": "AdamW",
                              "params": {"lr": 1e-2, "weight_decay": 0.01,
                                         "betas": [0.9, 0.95]}}}
        engines = {}
        for mode in ("fused", "off"):
            with kernel_config.override():
                eng, _, _, _ = ds.initialize(
                    model=loss, model_parameters=params,
                    config=dict(conf, kernels={"mode": mode}))
                before = fa_.fused_adam.launches
                for _ in range(3):
                    eng.train_batch(batch[:, :, 0])
                launched = fa_.fused_adam.launches - before
            assert launched == (3 if mode == "fused" else 0), mode
            engines[mode] = eng
        a, b = engines["fused"], engines["off"]
        for tree in ("params", "opt_state"):
            for x, y in zip(_leaves(getattr(a, tree)),
                            _leaves(getattr(b, tree))):
                assert torch.equal(x, y), (bf16, tree)
        if a.master is not None:
            for x, y in zip(_leaves(a.master), _leaves(b.master)):
                assert torch.equal(x, y)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [t for x in tree[1:] for t in _leaves(x)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


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


@pytest.mark.cuda
def test_cuda_add_ln_and_supertile_kernels_match_plain_versions():
    """add_ln_fwd/add_ln_bwd at the BERT width and a ragged row count, and
    the super-tile pair at S = 8, 16, 120, 128, 136 and 248 (the bf16
    forward's 16-row tiles and the edges of its S classes) with Dh 24, 40,
    64, 96 and 128 (fp32 at S 248 / Dh 128 is the shape whose K and V
    exceed a block's shared memory), causal and not, against their plain
    versions; a second forward launch gives the same bits."""
    _needs_card()
    from deeperspeed_tpu_torch.ops import flash_static as fs

    gen = torch.Generator(device="cuda").manual_seed(3)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for R in (37, 512):
            x, r, g = (torch.randn(R, 1024, generator=gen,
                                   device="cuda").to(dtype) for _ in range(3))
            w = torch.randn(1024, generator=gen, device="cuda") * 0.1 + 1
            b = torch.randn(1024, generator=gen, device="cuda") * 0.1
            got = fb.add_ln_fwd(x, r, w, b, 1e-12)
            want = fb.add_ln_fwd_plain(x, r, w, b, 1e-12)
            torch.testing.assert_close(got[0].float(), want[0].float(),
                                       atol=tol, rtol=tol)
            for a, p in zip(got[1:], want[1:]):
                torch.testing.assert_close(a, p, atol=2e-5, rtol=2e-5)
            got = fb.add_ln_bwd(x, r, w, want[1], want[2], g)
            want = fb.add_ln_bwd_plain(x, r, w, want[1], want[2], g)
            for a, p in zip(got, want):
                torch.testing.assert_close(a.float(), p.float(),
                                           atol=10 * tol, rtol=10 * tol)
    for dtype, ftol, gtol in ((torch.float32, 2e-3, 5e-3),
                              (torch.bfloat16, 2e-2, 5e-2)):
        for shape in ((2, 3, 8, 64), (2, 4, 128, 64), (1, 2, 248, 128),
                      (1, 3, 200, 24), (3, 2, 16, 40), (2, 3, 120, 96),
                      (2, 2, 136, 40), (2, 2, 136, 128)):
            for causal in (True, False):
                scale = 1.0 / shape[-1] ** 0.5
                q, k, v, do = (torch.randn(*shape, generator=gen,
                                           device="cuda").to(dtype)
                               for _ in range(4))
                o, lse = fs.supertile_fwd(q, k, v, scale, causal)
                po, plse = fs.supertile_fwd_plain(q, k, v, scale, causal)
                torch.testing.assert_close(o.float(), po.float(), atol=ftol,
                                           rtol=ftol)
                torch.testing.assert_close(lse, plse, atol=ftol, rtol=ftol)
                again = fs.supertile_fwd(q, k, v, scale, causal)
                assert torch.equal(again[0], o) and torch.equal(again[1], lse)
                got = fs.supertile_bwd(q, k, v, po, plse, do, scale, causal)
                want = fs.supertile_bwd_plain(q, k, v, po, plse, do, scale,
                                              causal)
                for a, p in zip(got, want):
                    torch.testing.assert_close(a.float(), p.float(),
                                               atol=gtol, rtol=gtol)
    with pytest.raises(ValueError, match="S <"):
        fs.supertile_fwd(*(torch.zeros(1, 1, 256, 64, device="cuda"),) * 3,
                         1.0, False)


@pytest.mark.cuda
def test_cuda_auto_sends_a_maskless_bert_layer_to_the_supertile_kernel():
    """kernels "auto" on Hopper: a maskless post-LN BERT layer at S = 128
    launches the super-tile pair and the add-LN pair (never dense
    attention), and its grads agree with the plain path's."""
    _needs_card()
    from deeperspeed_tpu_torch.ops import flash_static as fs
    from deeperspeed_tpu_torch.ops import kernel_config
    from deeperspeed_tpu_torch.ops.transformer import transformer as tr

    if not kernel_config._is_hopper(torch.device("cuda")):
        pytest.skip("auto routes to the kernels on Hopper only")
    cfg = tr.DeepSpeedTransformerConfig(hidden_size=256, heads=4,
                                        num_hidden_layers=2,
                                        pre_layer_norm=False)
    params = tr.init_transformer_params(0, cfg, device="cuda")
    x = torch.randn(4, 128, 256, device="cuda")
    out = {}
    for mode in ("auto", "off"):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        counts = (fs.supertile_fwd.launches, fs.supertile_bwd.launches,
                  fb.add_ln_fwd.launches, fb.add_ln_bwd.launches)
        with kernel_config.override(mode=mode):
            y = tr._transformer_forward(leaves, x, cfg)
            grads = torch.autograd.grad(y.square().sum(),
                                        list(leaves.values()))
        moved = tuple(a - b for a, b in zip(
            (fs.supertile_fwd.launches, fs.supertile_bwd.launches,
             fb.add_ln_fwd.launches, fb.add_ln_bwd.launches), counts))
        out[mode] = (y, grads, moved)
    assert out["auto"][2] == (1, 1, 2, 2)
    torch.testing.assert_close(out["auto"][0], out["off"][0], atol=2e-3,
                               rtol=2e-3)
    for a, p in zip(out["auto"][1], out["off"][1]):
        torch.testing.assert_close(a, p, atol=5e-3, rtol=5e-3)


def _sparse_layout(H, nb, seed):
    """A random block layout with one empty row per head, a dense diagonal
    and a global column (key block 2, seen by every other row: the longest
    dK/dV list, whose group runs first), so both walks meet short, long and
    empty rows."""
    import numpy as np

    rs = np.random.default_rng(seed)
    lay = (rs.random((H, nb, nb)) < 0.3).astype(np.int64)
    lay[:, np.arange(nb), np.arange(nb)] = 1
    lay[:, :, 2] = 1
    lay[:, 1, :] = 0
    return lay


@pytest.mark.cuda
def test_cuda_sparse_kernels_match_plain_versions():
    """sparse_fwd and sparse_bwd against their plain versions for every
    sparsity block and head dim the kernels take, causal and not, with and
    without a key mask (the last quarter of the keys dropped, a finite
    bias elsewhere), fp32 and bf16 (the reference's flash tolerances:
    fp32 2e-3 / 5e-3, bf16 2e-2 / 5e-2), over layouts with a long global
    column; an empty layout row gives zeros and lse = NEG_INF; the
    backward repeats bit for bit."""
    _needs_card()
    from deeperspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
    from deeperspeed_tpu_torch.ops.sparse_attention import kernels

    gen = torch.Generator(device="cuda").manual_seed(3)
    B, H, S = 2, 3, 512
    for block, Dh in ((16, 64), (32, 96), (64, 128), (128, 64), (16, 128),
                      (32, 64)):
        layout = _sparse_layout(H, S // block, block)
        for dtype, ftol, gtol in ((torch.float32, 2e-3, 5e-3),
                                  (torch.bfloat16, 2e-2, 5e-2)):
            for causal in (False, True):
                for masked in (False, True):
                    lut = kernels.SparseLut(layout, block, causal).on("cuda")
                    q, k, v, do = (torch.randn(B, H, S, Dh, generator=gen,
                                               device="cuda").to(dtype)
                                   for _ in range(4))
                    kpm = None
                    if masked:
                        kpm = torch.zeros(B, S, device="cuda")
                        kpm[:, 3 * S // 4:] = kernels.NEG_INF
                        kpm[1, 5] = -2.5
                    scale = Dh ** -0.5
                    o, lse = bs.sparse_fwd(q, k, v, lut, scale, causal, kpm)
                    po, plse = bs.sparse_fwd_plain(q, k, v, lut.layout,
                                                   block, scale, causal, kpm)
                    torch.testing.assert_close(o.float(), po.float(),
                                               atol=ftol, rtol=ftol)
                    torch.testing.assert_close(lse, plse, atol=ftol,
                                               rtol=ftol)
                    rows = slice(block, 2 * block)   # layout row 1 is empty
                    assert float(o[:, :, rows].abs().max()) == 0.0
                    assert bool((lse[:, :, rows] == kernels.NEG_INF).all())
                    got = bs.sparse_bwd(q, k, v, po, plse, do, lut, scale,
                                        causal, kpm)
                    want = bs.sparse_bwd_plain(q, k, v, po, plse, do,
                                               lut.layout, block, scale,
                                               causal, kpm)
                    for a, p in zip(got, want):
                        assert bool(torch.isfinite(a).all())
                        torch.testing.assert_close(a.float(), p.float(),
                                                   atol=gtol, rtol=gtol)
                    again = bs.sparse_bwd(q, k, v, po, plse, do, lut, scale,
                                          causal, kpm)
                    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_sparse_module_takes_the_kernels_or_raises():
    """SparseSelfAttention "auto" on a CUDA tensor launches the pair, in
    the forward and in the backward, and agrees with "pallas_interpret";
    a block, head dim or dtype the kernels do not take raises."""
    _needs_card()
    from deeperspeed_tpu_torch.ops import sparse_attention as sa
    from deeperspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    gen = torch.Generator(device="cuda").manual_seed(4)
    qkv = [torch.randn(2, 4, 512, 64, generator=gen, device="cuda")
           for _ in range(3)]
    outs = {}
    for impl in ("auto", "pallas_interpret"):
        # a config each: BigBird's random blocks advance with every layout
        # a config makes, so one config would give the two modules two
        # layouts
        cfg = sa.BigBirdSparsityConfig(num_heads=4, block=16)
        mod = sa.SparseSelfAttention(cfg, max_seq_length=1024, impl=impl)
        leaves = [t.clone().requires_grad_() for t in qkv]
        before = (bs.sparse_fwd.launches, bs.sparse_bwd.launches)
        o = mod(*leaves)
        grads = torch.autograd.grad(o.square().sum(), leaves)
        after = (bs.sparse_fwd.launches, bs.sparse_bwd.launches)
        assert after == ((before[0] + 1, before[1] + 1) if impl == "auto"
                         else before)
        outs[impl] = (o.detach(),) + grads
    for a, p in zip(outs["auto"], outs["pallas_interpret"]):
        torch.testing.assert_close(a, p, atol=5e-3, rtol=5e-3)
    cfg = sa.BigBirdSparsityConfig(num_heads=4, block=16)
    x = torch.zeros(1, 4, 64, 64, device="cuda")
    with pytest.raises(ValueError, match="sparsity blocks"):
        sa.SparseSelfAttention(sa.BigBirdSparsityConfig(num_heads=4, block=8),
                               max_seq_length=64)(x, x, x)
    y = torch.zeros(1, 4, 64, 32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        sa.SparseSelfAttention(cfg, max_seq_length=64)(y, y, y)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sa.SparseSelfAttention(cfg, max_seq_length=64)(x.half(), x.half(),
                                                       x.half())


@pytest.mark.cuda
def test_cuda_quant_kernels_match_plain_versions_bit_for_bit():
    """quantize_rows (fp32 and bf16, with and without the residual, blocks
    128 and 32), dequant_sum_rows (int8 and fp16 mantissas) and
    dequant_rows against their plain versions on the card: equal bits,
    all-zero and non-finite blocks included; a block that does not divide
    the row raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    from deeperspeed_tpu_torch.ops import fused_quant as fq

    gen = torch.Generator(device="cuda").manual_seed(0)
    for block in (128, 32):
        for R in (1, 2, 8):
            x = torch.randn(R, 64 * block, generator=gen, device="cuda")
            x[0, :block] = 0
            x[R - 1, block + 3] = float("nan")
            for dtype in (torch.float32, torch.bfloat16):
                xi = x.to(dtype)
                for res in (True, False):
                    got = fq.quantize_rows(xi, block, res)
                    want = fq.quantize_rows_plain(xi, block, res)
                    for g, w in zip(got, want):
                        if w is None:
                            assert g is None
                        else:
                            assert torch.equal(g.nan_to_num(7.0),
                                               w.nan_to_num(7.0))
            q, s, _ = fq.quantize_rows_plain(x.nan_to_num(0.0), block, False)
            assert torch.equal(fq.dequant_sum_rows(q, s, block),
                               fq.dequant_sum_rows_plain(q, s, block))
            assert torch.equal(fq.dequant_rows(q, s, block, R),
                               fq.dequant_rows_plain(q, s, block, R))
            m = x.nan_to_num(0.0).clamp(-1, 1).half()
            e = torch.exp2(torch.randint(-8, 8, s.shape, generator=gen,
                                         device="cuda").float())
            assert torch.equal(fq.dequant_sum_rows(m, e, block),
                               fq.dequant_sum_rows_plain(m, e, block))
    with pytest.raises(ValueError, match="divide"):
        fq.quantize_rows(torch.ones(2, 100, device="cuda"), 128)


@pytest.mark.cuda
def test_cuda_reducer_takes_the_quant_kernels():
    """Under kernels auto on a Hopper card the reducer's wire math goes to
    the kernel wrappers; with the fused_quant surface off, to the plain
    versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("kernels auto routes to the kernels on Hopper only")
    from deeperspeed_tpu_torch.ops import fused_quant as fq
    from deeperspeed_tpu_torch.ops import kernel_config as kc

    with kc.override(mode="auto"):
        assert fq.routing(torch.device("cuda", 0))
    with kc.override(mode="auto", fused_quant=False):
        assert not fq.routing(torch.device("cuda", 0))


def _close(got, want, tol, rel):
    """Element-wise within atol = rtol = ``tol`` and the error's L2 norm
    within ``rel`` of the reference's (chip_smoke.py's two gates)."""
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    err = (got.float() - want.float()).norm()
    assert float(err) <= rel * float(want.float().norm().clamp_min(1e-30))


@pytest.mark.cuda
def test_cuda_supertile_bwd_routes_match_plain_version_and_relaunch():
    """supertile_bwd, bf16 on the tensor cores and fp32 on the CUDA cores,
    at S 120 (one block a sequence), 136 and 248 (four blocks a
    sequence) with Dh 40 (no multiple of 16) and 128, causal and full,
    against its plain version at the reference's gradient tolerance and
    the relative L2 limit; a second launch gives the same bits."""
    _needs_card()
    from deeperspeed_tpu_torch.ops import flash_static as fs

    gen = torch.Generator(device="cuda").manual_seed(5)
    for dtype, tol, rel in ((torch.bfloat16, 5e-2, 1e-2),
                            (torch.float32, 5e-3, 1e-4)):
        for S in (120, 136, 248):
            for Dh in (40, 128):
                for causal in (True, False):
                    shape = (2, 3, S, Dh)
                    scale = 1.0 / Dh ** 0.5
                    q, k, v, do = (torch.randn(*shape, generator=gen,
                                               device="cuda").to(dtype)
                                   for _ in range(4))
                    o, lse = fs.supertile_fwd_plain(q, k, v, scale, causal)
                    before = fs.supertile_bwd.launches
                    got = fs.supertile_bwd(q, k, v, o, lse, do, scale,
                                           causal)
                    assert fs.supertile_bwd.launches == before + 1
                    want = fs.supertile_bwd_plain(q, k, v, o, lse, do,
                                                  scale, causal)
                    for a, p in zip(got, want):
                        _close(a, p, tol, rel)
                    again = fs.supertile_bwd(q, k, v, o, lse, do, scale,
                                             causal)
                    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_cuda_ln_backwards_match_plain_versions_and_relaunch():
    """ln_bwd and add_ln_bwd on both routes (rows: D 768, 1024, 2048 and
    GPT-NeoX-20B's 6144; wide: D 1001, whose rows are no whole 16-byte
    vectors, and unaligned rows) at ragged row counts, bf16 and fp32,
    against their plain versions at the reference's gradient tolerances;
    a second launch gives the same bits."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(6)
    for dtype, tol, rel in ((torch.bfloat16, 2e-1, 1e-2),
                            (torch.float32, 2e-4, 1e-4)):
        for R, D in ((37, 768), (1000, 1024), (333, 2048), (48, 6144),
                     (37, 1001)):
            x, r, g = (torch.randn(R, D, generator=gen,
                                   device="cuda").to(dtype) for _ in range(3))
            w = torch.randn(D, generator=gen, device="cuda") * 0.1 + 1
            b = torch.randn(D, generator=gen, device="cuda") * 0.1
            for add in (False, True):
                if add:
                    _, mean, rstd = fb.add_ln_fwd_plain(x, r, w, b, 1e-5)
                    args = (x, r, w, mean, rstd, g)
                    kernel, plain = fb.add_ln_bwd, fb.add_ln_bwd_plain
                else:
                    _, mean, rstd = fb.ln_fwd_plain(x, w, b, 1e-5)
                    args = (x, w, mean, rstd, g)
                    kernel, plain = fb.ln_bwd, fb.ln_bwd_plain
                before = kernel.launches
                got = kernel(*args)
                assert kernel.launches == before + 1
                for a, p in zip(got, plain(*args)):
                    _close(a, p, tol, rel)
                again = kernel(*args)
                assert all(torch.equal(a, c) for a, c in zip(got, again))
        # rows that start off a 16-byte boundary take the wide route
        buf = torch.randn(65 * 1024 + 1, generator=gen,
                          device="cuda").to(dtype)
        x = buf[1:].view(65, 1024)
        g = torch.randn(65, 1024, generator=gen, device="cuda").to(dtype)
        w = torch.ones(1024, device="cuda")
        _, mean, rstd = fb.ln_fwd_plain(x, w, w, 1e-5)
        for a, p in zip(fb.ln_bwd(x, w, mean, rstd, g),
                        fb.ln_bwd_plain(x, w, mean, rstd, g)):
            _close(a, p, tol, rel)


@pytest.mark.cuda
def test_cuda_sparse_fwd_tensor_cores_match_plain_version_and_relaunch():
    """The bf16 sparse_fwd (tensor cores, over the query groups) against
    its plain version at S 64, 128 and 4096, head dims 64, 96 and 128 and
    blocks 16-128, causal and full, with and without a key mask (the last
    quarter of the keys dropped, one key biased), over layouts with an
    empty block row where there are two rows or more (o = 0 and lse =
    NEG_INF there), at the reference's bf16 forward tolerance and the
    relative L2 limit; a second launch gives the same bits."""
    _needs_card()
    from deeperspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
    from deeperspeed_tpu_torch.ops.sparse_attention import kernels

    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [(64, 16, 64), (64, 32, 96), (64, 64, 128), (128, 16, 96),
             (128, 32, 128), (128, 64, 64), (128, 128, 128),
             (4096, 16, 64), (4096, 64, 96), (4096, 128, 128)]
    for S, block, Dh in cases:
        nb = S // block
        layout = (_sparse_layout(3, nb, block) if nb >= 3
                  else torch.ones(3, nb, nb, dtype=torch.int64).numpy())
        B = 1 if S == 4096 else 2
        for causal in (False, True):
            for masked in (False, True):
                lut = kernels.SparseLut(layout, block, causal).on("cuda")
                q, k, v = (torch.randn(B, 3, S, Dh, generator=gen,
                                       device="cuda").bfloat16()
                           for _ in range(3))
                kpm = None
                if masked:
                    kpm = torch.zeros(B, S, device="cuda")
                    kpm[:, 3 * S // 4:] = kernels.NEG_INF
                    kpm[0, 5] = -2.5
                scale = Dh ** -0.5
                before = bs.sparse_fwd.launches
                o, lse = bs.sparse_fwd(q, k, v, lut, scale, causal, kpm)
                assert bs.sparse_fwd.launches == before + 1
                po, plse = bs.sparse_fwd_plain(q, k, v, lut.layout, block,
                                               scale, causal, kpm)
                alive = plse > kernels.NEG_INF / 2
                assert bool((lse[~alive] == kernels.NEG_INF).all())
                assert bool((o.float()[~alive] == 0).all())
                _close(o, po, 2e-2, 1e-2)
                _close(lse[alive], plse[alive], 2e-2, 1e-2)
                if nb >= 3:   # layout row 1 is empty
                    rows = slice(block, 2 * block)
                    assert float(o[:, :, rows].abs().max()) == 0.0
                again = bs.sparse_fwd(q, k, v, lut, scale, causal, kpm)
                assert torch.equal(again[0], o) and torch.equal(again[1], lse)


@pytest.mark.cuda
def test_cuda_ln_forwards_match_plain_versions_and_relaunch():
    """ln_fwd and add_ln_fwd on both routes (rows: (8, 2048), (37, 768),
    (1000, 1024), (333, 2048) and GPT-NeoX-20B's (48, 6144); wide: (37,
    1001), whose rows are no whole 16-byte vectors, and rows that start
    off a 16-byte boundary), bf16 and fp32, against their plain versions
    at the reference's tolerances (mean and rstd within 2e-5) and the
    relative L2 limit; a second launch gives the same bits."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(8)
    for dtype, tol, rel in ((torch.bfloat16, 2e-2, 1e-2),
                            (torch.float32, 2e-5, 1e-4)):
        for R, D in ((8, 2048), (37, 768), (1000, 1024), (333, 2048),
                     (48, 6144), (37, 1001)):
            x, r = (torch.randn(R, D, generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
            w = torch.randn(D, generator=gen, device="cuda") * 0.1 + 1
            b = torch.randn(D, generator=gen, device="cuda") * 0.1
            for add in (False, True):
                args = (x, r, w, b, 1e-5) if add else (x, w, b, 1e-5)
                kernel = fb.add_ln_fwd if add else fb.ln_fwd
                plain = fb.add_ln_fwd_plain if add else fb.ln_fwd_plain
                before = kernel.launches
                got = kernel(*args)
                assert kernel.launches == before + 1
                want = plain(*args)
                _close(got[0], want[0], tol, rel)
                for a, p in zip(got[1:], want[1:]):
                    _close(a, p, 2e-5, 1e-4)
                again = kernel(*args)
                assert all(torch.equal(a, c) for a, c in zip(got, again))
        buf = torch.randn(65 * 1024 + 1, generator=gen,
                          device="cuda").to(dtype)
        x = buf[1:].view(65, 1024)
        w = torch.ones(1024, device="cuda")
        assert fb.ln_fwd_plan(65, 1024, dtype, aligned=False)["route"] == \
            "wide"
        for a, p in zip(fb.ln_fwd(x, w, w, 1e-5),
                        fb.ln_fwd_plain(x, w, w, 1e-5)):
            _close(a, p, tol, rel)


@pytest.mark.cuda
def test_cuda_bias_gelu_pair_matches_plain_versions_and_relaunches():
    """bias_gelu_fwd and bias_gelu_bwd on the vector route ((1, 8192), (8,
    8192), (37, 3072), (1000, 4096), (48, 24576), (4096, 1024); (37, 1000)
    and fp32's (37, 8188), whose last column strip is partial) and the
    scalar one (width 1001, bf16's 8188, rows off a 16-byte boundary),
    bf16 and fp32, b in x's dtype and in fp32, tanh and erf, on inputs
    with |x| up to 60 beside normal ones: no NaN, the reference's
    tolerances (gradients 10x) and the relative L2 limit against the plain
    versions; each call counts one launch, and a second launch gives the
    same bits (y, dx and db)."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(9)
    shapes = ((1, 8192), (8, 8192), (37, 3072), (1000, 4096), (48, 24576),
              (4096, 1024), (37, 1000), (37, 8188), (37, 1001))
    for dtype, tol, rel in ((torch.bfloat16, 2e-2, 1e-2),
                            (torch.float32, 2e-5, 1e-4)):
        vec = 16 // dtype.itemsize
        for F in (1000, 8188):
            if F % vec == 0:
                plan = fb.bias_gelu_bwd_plan(37, F, dtype)
                assert plan["route"] == "vector"
                assert plan["strips"] * 32 > F // vec
        for R, F in shapes:
            for b_dtype in {dtype, torch.float32}:
                for approximate in (True, False):
                    for scale in (2.0, 60.0):
                        x = ((torch.rand(R, F, generator=gen, device="cuda")
                              * 2 - 1) * scale).to(dtype)
                        b = torch.randn(F, generator=gen,
                                        device="cuda").to(b_dtype)
                        g = torch.randn(R, F, generator=gen,
                                        device="cuda").to(dtype)
                        before = _bias_gelu_launches()
                        y = fb.bias_gelu_fwd(x, b, approximate)
                        dx, db = fb.bias_gelu_bwd(x, b, g, approximate)
                        assert _bias_gelu_launches() == (before[0] + 1,
                                                        before[1] + 1)
                        for t in (y, dx, db):
                            assert bool(torch.isfinite(t.float()).all())
                        _close(y, fb.bias_gelu_fwd_plain(x, b, approximate),
                               tol, rel)
                        for a, p in zip((dx, db), fb.bias_gelu_bwd_plain(
                                x, b, g, approximate)):
                            _close(a, p, 10 * tol, rel)
                        assert torch.equal(fb.bias_gelu_fwd(x, b, approximate),
                                           y)
                        again = fb.bias_gelu_bwd(x, b, g, approximate)
                        assert torch.equal(again[0], dx)
                        assert torch.equal(again[1], db)
        # rows that start off a 16-byte boundary take the scalar route
        buf = torch.randn(65 * 1024 + 1, generator=gen,
                          device="cuda").to(dtype)
        x = buf[1:].view(65, 1024)
        b = torch.randn(1024, generator=gen, device="cuda").to(dtype)
        g = torch.randn(65, 1024, generator=gen, device="cuda").to(dtype)
        assert fb.bias_gelu_bwd_plan(65, 1024, dtype, aligned=False)[
            "route"] == "scalar"
        for approximate in (True, False):
            _close(fb.bias_gelu_fwd(x, b, approximate),
                   fb.bias_gelu_fwd_plain(x, b, approximate), tol, rel)
            for a, p in zip(fb.bias_gelu_bwd(x, b, g, approximate),
                            fb.bias_gelu_bwd_plain(x, b, g, approximate)):
                _close(a, p, 10 * tol, rel)


def _bias_gelu_launches():
    return fb.bias_gelu_fwd.launches, fb.bias_gelu_bwd.launches


# the near-tie margin of chip_smoke.py's phase 17 (its NEAR_TIE): tokens
# of a speculative engine that differ from plain decode's must differ
# first where the plain path's top-1 minus top-2 logit gap is at most
# this fraction of the largest |logit|
_NEAR_TIE = 0.02


@pytest.mark.cuda
def test_cuda_spec_engine_greedy_matches_plain_decode():
    """A speculative engine on the card (bf16, kernels auto, a 1-layer
    truncated drafter), greedy: its tokens equal a plain engine's, or
    differ first at a near tie of the plain path's logits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    from deeperspeed_tpu_torch.models import gpt
    from deeperspeed_tpu_torch.models.generation import (apply_with_cache,
                                                         init_cache)
    from deeperspeed_tpu_torch.ops import kernel_config
    from deeperspeed_tpu_torch.serving import ServingEngine

    cfg = gpt.GPTConfig(vocab_size=4096, n_layer=4, n_head=4, d_model=256,
                        max_seq=512, dtype=torch.bfloat16)
    params = gpt.init_params(0, cfg, device="cuda", dtype=torch.bfloat16)
    block = {"num_slots": 4, "block_size": 16, "num_blocks": 128,
             "max_seq_len": 512, "prefill_chunk": 64}
    host = torch.Generator().manual_seed(0)
    prompts = [torch.randint(1, 4096, (n,), generator=host).tolist()
               for n in (9, 70, 130, 200)]
    outs = []
    with kernel_config.override(mode="auto"):
        for spec in (None, {"draft_k": 4, "drafter": {"n_layer": 1}}):
            b = dict(block, speculative=spec) if spec else block
            eng = ServingEngine(cfg, params, b)
            rids = [eng.submit(p, max_new_tokens=32) for p in prompts]
            out = eng.run()
            outs.append([out[r] for r in rids])
        assert eng.metrics.spec_rounds > 0
        assert (eng.decode_compile_count, eng.draft_compile_count,
                eng.verify_compile_count) in ((0, 1, 1), (1, 1, 1))
        for p, plain, spec in zip(prompts, *outs):
            if plain == spec:
                continue
            pos = next(i for i, (a, c) in enumerate(zip(plain, spec))
                       if a != c)
            toks = torch.tensor([p + plain[:pos]], device="cuda")
            cache = init_cache(cfg, 1, toks.shape[1], "cuda")
            logits = apply_with_cache(cfg, params, toks, cache, 0)[0][0, -1]
            top = torch.topk(logits.float(), 2).values
            assert float(top[0] - top[1]) <= \
                _NEAR_TIE * float(logits.float().abs().max())
