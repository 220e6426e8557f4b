"""The PyTorch port's KV-cache generation against the JAX reference's
models/generation.py on the same fp32 weights: ``apply_with_cache``
logits (prefill, scalar-offset decode, per-row offsets) and greedy
``make_generator`` tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.models import generation as jax_gen
from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu_torch.models import convert, generation, gpt

torch.set_num_threads(1)

NEOX = dict(vocab_size=97, n_layer=2, n_head=4, n_kv_head=2, d_model=32,
            max_seq=64, rotary=True, rotary_pct=0.5,
            parallel_residual=True)
GPT2 = dict(vocab_size=97, n_layer=2, n_head=2, d_model=32, max_seq=64,
            rotary=False, parallel_residual=False)


def _models(kw, seed=0):
    jcfg = jax_gpt.GPTConfig(**kw, remat=False, dtype=jnp.float32,
                             attn_impl="xla")
    jparams = jax_gpt.make_gpt(jcfg)[0](jax.random.PRNGKey(seed))
    tcfg = gpt.GPTConfig(**kw, remat=False, dtype=torch.float32,
                         attn_impl="xla")
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("kw", [NEOX, GPT2], ids=["neox", "gpt2"])
def test_apply_with_cache_matches_reference(kw):
    jcfg, jparams, tcfg, tparams = _models(kw)
    rs = np.random.RandomState(0)
    prompt = rs.randint(0, 97, (2, 7))
    jcache = jax_gen.init_cache(jcfg, 2, 16)
    tcache = generation.init_cache(tcfg, 2, 16, "cpu")
    jl, jcache = jax_gen.apply_with_cache(jcfg, jparams, jnp.asarray(prompt),
                                          jcache, 0)
    tl, tcache = generation.apply_with_cache(tcfg, tparams,
                                             torch.from_numpy(prompt),
                                             tcache, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    # one decode step at a shared offset, then at per-row offsets
    step = rs.randint(0, 97, (2, 1))
    jl, jcache = jax_gen.apply_with_cache(jcfg, jparams, jnp.asarray(step),
                                          jcache, 7)
    tl, tcache = generation.apply_with_cache(tcfg, tparams,
                                             torch.from_numpy(step), tcache, 7)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    offs = np.array([8, 5], np.int32)
    jl, jcache = jax_gen.apply_with_cache(jcfg, jparams, jnp.asarray(step),
                                          jcache, jnp.asarray(offs))
    tl, tcache = generation.apply_with_cache(
        tcfg, tparams, torch.from_numpy(step), tcache,
        torch.from_numpy(offs.astype(np.int64)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for side in ("k", "v"):
        np.testing.assert_allclose(tcache[side].numpy(),
                                   np.asarray(jcache[side]), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("kw", [NEOX, GPT2], ids=["neox", "gpt2"])
def test_greedy_generator_tokens_match_reference(kw):
    jcfg, jparams, tcfg, tparams = _models(kw, seed=1)
    prompt = np.random.RandomState(1).randint(0, 97, (3, 6))
    ref = np.asarray(jax_gen.make_generator(jcfg)(
        jparams, jnp.asarray(prompt), max_new_tokens=10))
    out = generation.make_generator(tcfg)(tparams, torch.from_numpy(prompt),
                                          max_new_tokens=10)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_generator_rejects_bad_lengths():
    _, _, tcfg, tparams = _models(GPT2)
    gen = generation.make_generator(tcfg)
    with pytest.raises(ValueError, match="max_new_tokens"):
        gen(tparams, torch.zeros((1, 4), dtype=torch.long), max_new_tokens=0)
    with pytest.raises(ValueError, match="max_seq"):
        gen(tparams, torch.zeros((1, 60), dtype=torch.long), max_new_tokens=8)


def test_sampling_helpers():
    logits = torch.tensor([[0.0, 5.0, 1.0, 4.0]])
    filtered = generation.prep_sampling_logits(logits, 2.0, 2)
    assert filtered[0, 0] == -1e30 and filtered[0, 2] == -1e30
    assert filtered[0, 1] == 2.5 and filtered[0, 3] == 2.0
    draws = {int(generation.categorical(
        filtered, torch.Generator().manual_seed(s))[0]) for s in range(50)}
    assert draws == {1, 3}                       # top-k keeps two tokens
    a = generation.categorical(filtered, torch.Generator().manual_seed(7))
    b = generation.categorical(filtered, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
