"""The PyTorch port's speculative generators (models/speculative.py)
against the JAX reference's on the same fp32 weights: greedy output
token-identical to the reference's ``make_speculative_generator`` and to
the port's plain greedy decode for a weak draft, a perfect draft,
k_draft 1/2/5, a GQA draft and batched rows (each equal to its own B=1
run); sampled output with a perfect draft equal to plain ancestral
sampling under the same positional keys; the matched-key generator equal
to per-token decode under the engine's keys; the learned-positions and
vocabulary guards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.models import speculative as jax_spec
from deeperspeed_tpu_torch.models import convert, gpt
from deeperspeed_tpu_torch.models.generation import (apply_with_cache,
                                                     categorical, init_cache,
                                                     make_generator)
from deeperspeed_tpu_torch.models.speculative import (
    _pos_key,
    _prep_logits,
    _split,
    engine_sample_key,
    make_matched_speculative_generator,
    make_speculative_generator,
    sample_seed,
)

torch.set_num_threads(1)

KW = dict(vocab_size=97, n_head=2, d_model=32, max_seq=256, remat=False,
          attn_impl="xla", ce_chunk=0)


def _jcfg(n_layer, **kw):
    return jax_gpt.GPTConfig(**{**KW, "rotary": True, **kw},
                             n_layer=n_layer, dtype=jnp.float32)


def _tcfg(n_layer, **kw):
    return gpt.GPTConfig(**{**KW, "rotary": True, **kw}, n_layer=n_layer,
                         dtype=torch.float32)


def _pair(n_layer, seed, **kw):
    """(jax cfg, jax params, port cfg, port params): one set of weights."""
    jcfg = _jcfg(n_layer, **kw)
    jparams = jax_gpt.make_gpt(jcfg)[0](jax.random.PRNGKey(seed))
    tcfg = _tcfg(n_layer, **kw)
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def models():
    return _pair(3, 0), _pair(1, 1)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.int64))


def _greedy_three_ways(models, draft, prompt, new, k):
    """The port's spec output, after asserting it equals the reference's
    spec output and the port's plain greedy decode."""
    (jt, jtp, tt, ttp), (jd, jdp, td, tdp) = models[0], draft
    ref = jax_spec.make_speculative_generator(jt, jd, k_draft=k)(
        jtp, jdp, jnp.asarray(prompt, jnp.int32), max_new_tokens=new)
    plain = make_generator(tt)(ttp, _t(prompt), max_new_tokens=new)
    spec = make_speculative_generator(tt, td, k_draft=k)(
        ttp, tdp, _t(prompt), max_new_tokens=new)
    np.testing.assert_array_equal(spec.numpy(), plain.numpy())
    np.testing.assert_array_equal(spec.numpy(), np.asarray(ref))
    return spec


def test_matches_plain_greedy_with_weak_draft(models):
    """An unrelated random draft mostly mispredicts; the verify path must
    still reproduce plain greedy exactly."""
    _greedy_three_ways(models, models[1], [[5, 17, 3]], 24, 4)


def test_matches_plain_greedy_with_perfect_draft(models):
    """Draft == target: every proposal accepted."""
    _greedy_three_ways(models, models[0], [[1, 2, 3, 4]], 17, 3)


@pytest.mark.parametrize("k_draft", [1, 2, 5])
def test_k_draft_sweep(models, k_draft):
    _greedy_three_ways(models, models[1], [[9, 8]], 11, k_draft)


def test_gqa_draft_composes(models):
    """A GQA draft (n_kv_head=1) against an MHA target."""
    _greedy_three_ways(models, _pair(1, 2, n_kv_head=1), [[4, 4, 2]], 9, 3)


def test_learned_positions_guard():
    _, _, tt, ttp = _pair(2, 0, rotary=False)
    _, _, td, tdp = _pair(1, 1, rotary=False)
    gen = make_speculative_generator(tt, td, k_draft=4)
    with pytest.raises(ValueError, match="draft slack"):
        gen(ttp, tdp, torch.zeros((1, 250), dtype=torch.long),
            max_new_tokens=4)


def test_vocab_mismatch_rejected():
    with pytest.raises(AssertionError, match="vocabulary"):
        make_speculative_generator(_tcfg(2, vocab_size=97),
                                   _tcfg(1, vocab_size=64))


class TestSamplingAcceptance:
    """temperature > 0: Leviathan-style rejection sampling with keys per
    OUTPUT POSITION, so with draft == target every proposal is accepted
    and the output equals plain ancestral sampling of the target with
    the same positional keys."""

    @staticmethod
    def _ancestral(cfg, params, prompt, max_new, temperature, rng):
        """Plain ancestral sampling, one token a forward, with the
        positional-key discipline (the proposal stream is the first of
        the generator's three-way split)."""
        rng_tok = _split(rng, 3)[0]
        B, S = prompt.shape
        cache = init_cache(cfg, B, S + max_new, "cpu")
        logits, _ = apply_with_cache(cfg, params, prompt, cache, 0)
        toks = []
        for m in range(max_new):
            if m:
                logits, _ = apply_with_cache(cfg, params, toks[-1][:, None],
                                             cache, S + m - 1)
            toks.append(categorical(
                _prep_logits(logits[:, -1], temperature, None),
                _pos_key(rng_tok, m, "cpu")))
        return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)

    def test_perfect_draft_matches_ancestral_sampling(self, models):
        _, _, tt, ttp = models[0]
        prompt = _t([[3, 1, 4]])
        ref = self._ancestral(tt, ttp, prompt, 15, 0.9, 42)
        spec = make_speculative_generator(tt, tt, k_draft=3)(
            ttp, ttp, prompt, max_new_tokens=15, temperature=0.9, rng=42)
        np.testing.assert_array_equal(spec.numpy(), ref.numpy())

    def test_weak_draft_samples_valid_tokens(self, models):
        (_, _, tt, ttp), (_, _, td, tdp) = models
        gen = make_speculative_generator(tt, td, k_draft=4)
        prompt = _t([[7, 7]])
        out = gen(ttp, tdp, prompt, max_new_tokens=20, temperature=1.0,
                  top_k=20, rng=5).numpy()
        assert out.shape == (1, 22)
        assert (out >= 0).all() and (out < tt.vocab_size).all()
        # another seed, another continuation (it is sampling)
        out2 = gen(ttp, tdp, prompt, max_new_tokens=20, temperature=1.0,
                   top_k=20, rng=6).numpy()
        assert not np.array_equal(out, out2)

    def test_sampling_requires_rng(self, models):
        (_, _, tt, ttp), (_, _, td, tdp) = models
        gen = make_speculative_generator(tt, td, k_draft=2)
        with pytest.raises(ValueError, match="rng"):
            gen(ttp, tdp, _t([[5, 17, 3]]), max_new_tokens=4,
                temperature=0.9)


class TestBatchedDecoding:
    """B > 1: rows accept different draft lengths and their caches
    desynchronize (per-row offsets). Each row's greedy output equals its
    own B=1 decode, the port's plain greedy decode and the reference's."""

    def test_b8_greedy_rows_match_their_b1_decodes(self, models):
        (jt, jtp, tt, ttp), (jd, jdp, td, tdp) = models
        prompts = np.random.default_rng(0).integers(
            0, tt.vocab_size, size=(8, 5))
        gen = make_speculative_generator(tt, td, k_draft=3)
        batched = gen(ttp, tdp, _t(prompts), max_new_tokens=19)
        for row in range(8):
            single = gen(ttp, tdp, _t(prompts[row:row + 1]),
                         max_new_tokens=19)
            np.testing.assert_array_equal(batched[row].numpy(),
                                          single[0].numpy(),
                                          err_msg=f"row {row}")
        plain = make_generator(tt)(ttp, _t(prompts), max_new_tokens=19)
        np.testing.assert_array_equal(batched.numpy(), plain.numpy())
        ref = jax_spec.make_speculative_generator(jt, jd, k_draft=3)(
            jtp, jdp, jnp.asarray(prompts, jnp.int32), max_new_tokens=19)
        np.testing.assert_array_equal(batched.numpy(), np.asarray(ref))

    def test_b4_sampling_finite_and_varied(self, models):
        (_, _, tt, ttp), (_, _, td, tdp) = models
        prompts = _t(np.tile([[5, 17, 3]], (4, 1)))
        out = make_speculative_generator(tt, td, k_draft=3)(
            ttp, tdp, prompts, max_new_tokens=12, temperature=1.0, top_k=30,
            rng=7).numpy()
        assert out.shape == (4, 3 + 12)
        assert (out >= 0).all() and (out < tt.vocab_size).all()
        # identical prompts, per-row streams: rows differ
        assert len({tuple(r) for r in out}) > 1


class TestMatchedKeyVerification:
    """make_matched_speculative_generator: the serving engine's key
    contract in generator form. Draft and target both draw with
    engine_sample_key(seed, output index); a draft is accepted iff it
    equals the target's own draw, so the output is exactly the per-token
    decode stream for any drafter, greedy or sampled."""

    @staticmethod
    def _per_token(cfg, params, prompt, max_new, temperature, seeds):
        """Plain per-token decode with the engine's key discipline."""
        B, S = prompt.shape

        def draw(logits_last, i):
            return torch.stack([categorical(
                _prep_logits(logits_last[b:b + 1], temperature, None),
                engine_sample_key(seeds[b], i, "cpu"))[0]
                for b in range(B)])

        cache = init_cache(cfg, B, S + max_new, "cpu")
        logits, _ = apply_with_cache(cfg, params, prompt, cache, 0)
        toks = [draw(logits[:, -1], 0)]
        for m in range(1, max_new):
            logits, _ = apply_with_cache(cfg, params, toks[-1][:, None],
                                         cache, S + m - 1)
            toks.append(draw(logits[:, -1], m))
        return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)

    def test_greedy_matches_plain_greedy_weak_draft(self, models):
        (_, _, tt, ttp), (_, _, td, tdp) = models
        prompt = _t([[5, 17, 3]])
        ref = make_generator(tt)(ttp, prompt, max_new_tokens=21)
        spec = make_matched_speculative_generator(tt, td, k_draft=4)(
            ttp, tdp, prompt, max_new_tokens=21)
        np.testing.assert_array_equal(spec.numpy(), ref.numpy())

    def test_sampled_matches_per_token_decode_weak_draft(self, models):
        """Token identity under sampling with an unrelated draft."""
        (_, _, tt, ttp), (_, _, td, tdp) = models
        prompt = _t([[3, 1, 4], [1, 5, 9]])
        seeds = [7, 1234]
        ref = self._per_token(tt, ttp, prompt, 17, 0.9, seeds)
        spec = make_matched_speculative_generator(tt, td, k_draft=3)(
            ttp, tdp, prompt, max_new_tokens=17, temperature=0.9,
            seeds=seeds)
        np.testing.assert_array_equal(spec.numpy(), ref.numpy())

    def test_sampled_matches_per_token_decode_perfect_draft(self, models):
        _, _, tt, ttp = models[0]
        prompt = _t([[9, 8, 7]])
        ref = self._per_token(tt, ttp, prompt, 14, 1.0, [42])
        spec = make_matched_speculative_generator(tt, tt, k_draft=3)(
            ttp, ttp, prompt, max_new_tokens=14, temperature=1.0,
            seeds=[42])
        np.testing.assert_array_equal(spec.numpy(), ref.numpy())

    def test_engine_key_contract_is_the_single_definition(self):
        """serving/engine.request_sample_key must BE
        models/speculative.engine_sample_key: the fleet's retry and
        mixed-replica identity hangs on the two never diverging."""
        from deeperspeed_tpu_torch.serving import engine

        a = engine.request_sample_key(123, 7)
        b = engine_sample_key(123, 7)
        assert a.initial_seed() == b.initial_seed() == sample_seed(123, 7)
        assert torch.equal(torch.rand(5, generator=a),
                           torch.rand(5, generator=b))
