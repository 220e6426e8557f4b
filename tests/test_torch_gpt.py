"""The PyTorch port's GPT forward and training loss against the JAX
reference's ``make_gpt`` on the same fp32 weights, carried across by
deeperspeed_tpu_torch/models/convert.py; plus the config surface, the
init and the converter."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.ops import kernel_config as jax_kc
from deeperspeed_tpu_torch.models import convert
from deeperspeed_tpu_torch.models import gpt
from deeperspeed_tpu_torch.ops import kernel_config as kc

torch.set_num_threads(1)

NEOX = dict(vocab_size=97, n_layer=2, n_head=4, n_kv_head=1, d_model=32,
            max_seq=64, rotary=True, rotary_pct=0.25,
            parallel_residual=True)
GPT2 = dict(vocab_size=97, n_layer=2, n_head=2, d_model=32, max_seq=64,
            rotary=False, parallel_residual=False)


def _models(kw, seed=0):
    jcfg = jax_gpt.GPTConfig(**kw, remat=False, dtype=jnp.float32,
                             attn_impl="xla")
    init_fn, apply_fn, _, _ = jax_gpt.make_gpt(jcfg)
    jparams = init_fn(jax.random.PRNGKey(seed))
    tcfg = gpt.GPTConfig(**kw, remat=False, dtype=torch.float32,
                         attn_impl="xla")
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, apply_fn, tcfg, convert.from_jax_params(
        np_params, tcfg, "cpu")


@pytest.mark.parametrize("jax_kernels", ["off", "fused"])
@pytest.mark.parametrize("variant", ["neox", "gpt2"])
def test_apply_matches_reference_logits(variant, jax_kernels):
    kw = NEOX if variant == "neox" else GPT2
    _, jparams, apply_fn, tcfg, tparams = _models(kw)
    tokens = np.random.RandomState(3).randint(0, 97, (2, 12))
    with jax_kc.override(mode=jax_kernels):
        ref = np.asarray(apply_fn(jparams, jnp.asarray(tokens)))
    out = gpt.apply(tcfg, tparams, torch.from_numpy(tokens))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_rotary_embedding_per_row_positions_match_reference():
    rs = np.random.RandomState(4)
    x = rs.randn(3, 5, 2, 16).astype(np.float32)
    for pos in (np.arange(5), rs.randint(0, 40, (3, 5))):
        ref = jax_gpt.rotary_embedding(jnp.asarray(x), jnp.asarray(pos), 8)
        out = gpt.rotary_embedding(torch.from_numpy(x), torch.from_numpy(pos), 8)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=1e-6)


def test_layer_norm2_matches_reference():
    rs = np.random.RandomState(5)
    x, s1, b1, s2, b2 = (rs.randn(*sh).astype(np.float32)
                         for sh in ((4, 32), (32,), (32,), (32,), (32,)))
    ref = jax_gpt.layer_norm2(*map(jnp.asarray, (x, s1, b1, s2, b2)), 1e-5)
    out = gpt.layer_norm2(*map(torch.from_numpy, (x, s1, b1, s2, b2)), 1e-5)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-5,
                                   rtol=2e-5)


def test_config_surface():
    jf = [f.name for f in dataclasses.fields(jax_gpt.GPTConfig)]
    tf = [f.name for f in dataclasses.fields(gpt.GPTConfig)]
    assert tf == jf
    assert set(gpt.PRESETS) == set(jax_gpt.PRESETS)
    for name, tcfg in gpt.PRESETS.items():
        jcfg = jax_gpt.PRESETS[name]
        for f in tf:
            if f != "dtype":
                assert getattr(tcfg, f) == getattr(jcfg, f), (name, f)
        assert (tcfg.qkv_dim, tcfg.ffn_dim) == (jcfg.qkv_dim, jcfg.ffn_dim)
    c = gpt.get_preset("neox-1.3b")
    assert (c.n_layer, c.d_model, c.n_head, c.head_dim, c.ffn_dim,
            c.vocab_size) == (24, 2048, 16, 128, 8192, 50304)
    # Mixture-of-Experts is ported: the config builds the reference's
    # MoEConfig
    assert dataclasses.asdict(gpt.GPTConfig(moe_num_experts=4).moe) == \
        dataclasses.asdict(jax_gpt.GPTConfig(moe_num_experts=4).moe)
    with pytest.raises(ValueError, match="not ported"):
        gpt.GPTConfig(attn_impl="splash")
    # the context-parallel impls are ported; they need a mesh
    with pytest.raises(ValueError, match="needs a mesh"):
        gpt.make_gpt(gpt.GPTConfig(attn_impl="ring"))
    with pytest.raises(ValueError, match="multiple of n_kv_head"):
        gpt.GPTConfig(n_head=4, n_kv_head=3)
    with pytest.raises(ValueError, match="remat_policy"):
        gpt.GPTConfig(remat_policy="some")


@pytest.mark.parametrize("kw", [NEOX, GPT2])
def test_init_params_shapes_and_std_match_reference(kw):
    jcfg, jparams, _, tcfg, _ = _models(dict(kw, n_layer=4, d_model=64))
    for seed in (0, np.random.default_rng(0),
                 torch.Generator().manual_seed(0)):
        tparams = gpt.init_params(seed, tcfg, device="cpu")
        jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
        tflat = convert._flatten(tparams)
        assert len(jflat) == len(tflat)
        for path, leaf in jflat:
            key = "/".join(p.key for p in path)
            t = tflat[key]
            assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
            ref_std = float(np.std(np.asarray(leaf)))
            assert abs(float(t.std()) - ref_std) <= 0.15 * ref_std + 1e-7, key
    bf = gpt.init_params(0, tcfg, device="cpu", dtype=torch.bfloat16)
    assert bf["layers"]["attn"]["wqkv"].dtype == torch.bfloat16
    assert bf["layers"]["ln1_scale"].dtype == torch.float32
    assert bf["final_ln"]["bias"].dtype == torch.float32


def test_convert_round_trip_and_validation():
    jcfg, jparams, _, tcfg, tparams = _models(NEOX)
    back = convert.to_numpy_params(tparams)
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, jparams))
    np_params = jax.tree.map(np.asarray, jparams)
    bad = jax.tree.map(lambda a: a, np_params)
    bad["layers"]["attn"]["wqkv"] = bad["layers"]["attn"]["wqkv"][:, :, :-1]
    with pytest.raises(ValueError, match="wqkv"):
        convert.from_jax_params(bad, tcfg, "cpu")
    del np_params["lm_head"]
    with pytest.raises(ValueError, match="missing"):
        convert.from_jax_params(np_params, tcfg, "cpu")


@pytest.mark.parametrize("ce_chunk", [0, 16])
def test_loss_and_grads_match_reference(ce_chunk):
    """One forward+backward of make_gpt's loss, fused and streaming
    cross-entropy, kernels fused on both sides (the reference's Pallas
    kernels in interpret mode, the port's wrappers' plain versions): fp32
    loss within 1e-5, grads within 1e-5 + 1e-4 relative."""
    kw = dict(vocab_size=97, n_layer=2, n_head=4, d_model=64, max_seq=64,
              ce_chunk=ce_chunk, remat=False, attn_impl="pallas_interpret")
    jcfg = jax_gpt.GPTConfig(**kw, dtype=jnp.float32)
    jinit, _, jloss, _ = jax_gpt.make_gpt(jcfg)
    jparams = jinit(jax.random.PRNGKey(0))
    tcfg = gpt.GPTConfig(**kw, dtype=torch.float32)
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")
    S = 64
    batch = np.random.RandomState(11).randint(0, 97, (2, S + 1)).astype(
        np.int32)
    with jax_kc.override(mode="fused"), kc.override(mode="fused"):
        jl, jg = jax.value_and_grad(jloss)(jparams, jnp.asarray(batch))
        _, _, tloss, _ = gpt.make_gpt(tcfg)
        leaves = {k: v.requires_grad_() for k, v in
                  convert._flatten(tparams).items()}
        tl = tloss(tparams, torch.from_numpy(batch))
        tg = torch.autograd.grad(tl, list(leaves.values()))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jflat = convert._flatten(jax.tree.map(np.asarray, jg))
    for (k, _), g in zip(leaves.items(), tg):
        np.testing.assert_allclose(g.numpy(), jflat[k], atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    assert gpt.pick_ce_chunk(S, ce_chunk) == jax_gpt.pick_ce_chunk(S,
                                                                   ce_chunk)
    for s_, c_ in ((100, 64), (97, 32), (128, 0), (96, 128)):
        assert gpt.pick_ce_chunk(s_, c_) == jax_gpt.pick_ce_chunk(s_, c_)
