"""The PyTorch port's DeepSpeed transformer layer against the JAX
reference's (deeperspeed_tpu/ops/transformer): pre- and post-LN, with a
padding mask (dense attention) and without one (the attention kernels'
path), forward and gradients in fp32 from the same numpy weights; the
attention rules; dropout; the config.

Under kernels mode ``fused`` the reference runs its Pallas kernels in
interpret mode and the port its kernel wrappers' plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops import kernel_config as jax_kc
from deeperspeed_tpu.ops.transformer import transformer as jax_tr
from deeperspeed_tpu_torch.ops import kernel_config as kc
from deeperspeed_tpu_torch.ops.transformer import transformer as tr

torch.set_num_threads(1)

B, S, H, NH = 2, 64, 32, 4
TOL = 1e-4  # fp32 on both sides


def _configs(pre_ln, **kw):
    args = dict(hidden_size=H, heads=NH, intermediate_size=4 * H,
                num_hidden_layers=2, pre_layer_norm=pre_ln, **kw)
    return (jax_tr.DeepSpeedTransformerConfig(**args),
            tr.DeepSpeedTransformerConfig(**args))


def _params(seed=0):
    """One layer's weights from numpy, with nonzero biases and LN affine."""
    rs = np.random.RandomState(seed)
    shapes = {"attn_qkvw": (H, 3 * H), "attn_qkvb": (3 * H,),
              "attn_ow": (H, H), "attn_ob": (H,), "attn_nw": (H,),
              "attn_nb": (H,), "inter_w": (H, 4 * H), "inter_b": (4 * H,),
              "output_w": (4 * H, H), "output_b": (H,), "norm_w": (H,),
              "norm_b": (H,)}
    out = {}
    for k, s in shapes.items():
        a = rs.randn(*s).astype(np.float32)
        out[k] = (1.0 + 0.1 * a if k.endswith("nw") or k == "norm_w"
                  else 0.1 * a)
    return out


def _mask():
    m = np.ones((B, S), np.float32)
    m[1, 40:] = 0.0
    return (1.0 - m[:, None, None, :]) * -1e4


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pre_ln", [False, True])
@pytest.mark.parametrize("mode", ["off", "fused"])
def test_transformer_forward_matches_reference(mode, pre_ln, masked):
    jcfg, tcfg = _configs(pre_ln)
    pnp = _params()
    x = np.random.RandomState(1).randn(B, S, H).astype(np.float32)
    g = np.random.RandomState(2).randn(B, S, H).astype(np.float32)
    mask = _mask() if masked else None

    def jloss(p, x):
        y = jax_tr._transformer_forward(
            p, x, jcfg, attention_mask=None if mask is None
            else jnp.asarray(mask))
        return jnp.sum(y * g), y

    jp = {k: jnp.asarray(v) for k, v in pnp.items()}
    with jax_kc.override(mode=mode):
        (_, jy), jgrad = jax.value_and_grad(jloss, argnums=(0, 1),
                                            has_aux=True)(jp, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in pnp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    with kc.override(mode=mode):
        ty = tr._transformer_forward(
            tp, tx, tcfg, attention_mask=None if mask is None
            else torch.from_numpy(mask))
        grads = torch.autograd.grad((ty * torch.from_numpy(g)).sum(),
                                    [tx] + list(tp.values()))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgrad[1]),
                               atol=TOL, rtol=TOL)
    for k, gt in zip(tp, grads[1:]):
        np.testing.assert_allclose(gt.numpy(), np.asarray(jgrad[0][k]),
                                   atol=TOL, rtol=TOL, err_msg=k)


def test_transformer_remat_knobs_and_layer_api():
    """normalize_invertible / *_checkpoint only recompute; the layer object
    and its cached function give the same output as the plain forward."""
    _, base = _configs(False)
    _, knobs = _configs(False, normalize_invertible=True,
                        gelu_checkpoint=True, attn_dropout_checkpoint=True)
    pnp = _params(3)
    x = torch.from_numpy(
        np.random.RandomState(4).randn(B, S, H).astype(np.float32))
    outs = []
    for cfg in (base, knobs):
        tp = {k: torch.from_numpy(v).requires_grad_() for k, v in pnp.items()}
        y = tr._transformer_forward(tp, x, cfg)
        outs.append((y, torch.autograd.grad(y.square().sum(),
                                            list(tp.values()))))
    torch.testing.assert_close(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b)
    layer = tr.DeepSpeedTransformerLayer(base)
    params = layer.init(0, device="cpu")
    assert set(params) == set(pnp) and params["attn_qkvw"].shape == (H, 3 * H)
    tp = {k: torch.from_numpy(v) for k, v in pnp.items()}
    torch.testing.assert_close(layer(tp, x), tr._transformer_forward(tp, x,
                                                                     base))


def test_flash_with_a_mask_raises_and_auto_takes_dense():
    _, cfg = _configs(False, attn_impl="flash")
    tp = {k: torch.from_numpy(v) for k, v in _params().items()}
    x = torch.zeros(B, S, H)
    mask = torch.from_numpy(_mask())
    with pytest.raises(ValueError, match="attention_mask"):
        tr._transformer_forward(tp, x, cfg, attention_mask=mask)
    _, auto = _configs(False, attn_impl="auto")
    with kc.override(mode="fused"):
        y = tr._transformer_forward(tp, x, auto, attention_mask=mask)
    assert y.shape == (B, S, H)
    _, bad = _configs(False, attn_impl="pallas")
    with pytest.raises(ValueError, match="attn_impl"):
        tr._transformer_forward(tp, x, bad)


def test_dropout_needs_a_generator_and_is_deterministic_given_one():
    """The port's bits are its own (a torch.Generator), not JAX's: without
    a generator nothing is dropped; the same seed drops the same entries,
    another seed others; kept entries are scaled by 1 / (1 - ratio)."""
    x = torch.ones(64, 64)
    assert tr._dropout(x, 0.5, None) is x
    a = tr._dropout(x, 0.5, torch.Generator().manual_seed(3))
    b = tr._dropout(x, 0.5, torch.Generator().manual_seed(3))
    c = tr._dropout(x, 0.5, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert 0.4 < float((a == 0).float().mean()) < 0.6

    _, cfg = _configs(False, attn_dropout_ratio=0.1, hidden_dropout_ratio=0.1,
                      attn_impl="xla")
    _, ckpt = _configs(False, attn_dropout_ratio=0.1,
                       hidden_dropout_ratio=0.1, attn_impl="xla",
                       normalize_invertible=True)
    tp = {k: torch.from_numpy(v) for k, v in _params().items()}
    x = torch.from_numpy(
        np.random.RandomState(5).randn(B, S, H).astype(np.float32))
    y1 = tr._transformer_forward(tp, x, cfg, rng=7)
    y2 = tr._transformer_forward(tp, x, cfg, rng=torch.Generator()
                                 .manual_seed(7))
    y3 = tr._transformer_forward(tp, x, cfg, rng=8)
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)
    assert not torch.equal(y1, tr._transformer_forward(tp, x, cfg))
    # a recomputed sub-block draws the same masks: same output and grads
    outs = []
    for c in (cfg, ckpt):
        leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
        y = tr._transformer_forward(leaves, x, c, rng=7)
        outs.append((y, torch.autograd.grad(y.sum(), list(leaves.values()))))
    torch.testing.assert_close(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b)


def test_progressive_layer_drop_gate():
    _, cfg = _configs(False, stochastic_mode=True)
    tp = {k: torch.from_numpy(v) for k, v in _params().items()}
    x = torch.randn(B, S, H, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tr._transformer_forward(tp, x, cfg, rng=1,
                                               pld_theta=0.0), x)
    torch.testing.assert_close(
        tr._transformer_forward(tp, x, cfg, rng=1, pld_theta=1.0),
        tr._transformer_forward(tp, x, cfg))


def test_config_from_dict_matches_reference(tmp_path):
    d = {"hidden_size": 64, "heads": 4, "fp16": True, "pre_layer_norm": False,
         "attn_dropout_ratio": 0.1}
    j = jax_tr.DeepSpeedTransformerConfig.from_dict(d)
    t = tr.DeepSpeedTransformerConfig.from_dict(d)
    assert {k: v for k, v in t.__dict__.items()} == {
        k: v for k, v in j.__dict__.items()}
    assert t.intermediate_size == 256 and t.compute_dtype == torch.bfloat16
    path = tmp_path / "layer.json"
    path.write_text('{"hidden_size": 32, "heads": 2, "intermediate_size": 48}')
    f = tr.DeepSpeedTransformerConfig.from_json_file(str(path))
    assert (f.hidden_size, f.heads, f.intermediate_size) == (32, 2, 48)
    with pytest.raises(ValueError, match="interpret"):
        tr.DeepSpeedTransformerConfig(interpret=True)
    with pytest.raises(ValueError, match="interpret"):
        tr.DeepSpeedTransformerConfig.from_dict({"interpret": True})


def test_weights_to_params_matches_reference():
    rs = np.random.RandomState(6)
    ws = [rs.randn(*s).astype(np.float32) for s in
          [(H, H)] * 4 + [(H,), (4 * H, H), (H, 4 * H), (H,)]]
    bs = [rs.randn(n).astype(np.float32) for n in
          [H, H, H, H, H, 4 * H, H, H]]
    j = {**jax_tr.weights_to_params(ws), **jax_tr.biases_to_params(bs)}
    t = {**tr.weights_to_params([torch.from_numpy(w) for w in ws]),
         **tr.biases_to_params(bs)}
    assert set(j) == set(t)
    for k in j:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
