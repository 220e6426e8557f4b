"""Speculative decoding: draft-model proposal + single-pass target verify.

Counterpart of deeperspeed_tpu/models/speculative.py. A small DRAFT model
proposes K tokens autoregressively, then the TARGET model scores all K+1
positions in ONE cached forward; matching tokens are accepted and the
target's own prediction at the first mismatch is emitted as the bonus
token. Greedy (temperature=0) acceptance makes the output identical to
plain greedy decoding of the target model, for any draft: the draft only
changes how many target forwards are needed.

Precision caveat (the reference's): the guarantee holds exactly when the
verify pass's logits match per-token logits; under bf16 the batched
(K+1)-token matmuls reduce in a different order than single-token decode
steps, so near-tie argmaxes can flip and sequences may diverge at such
positions (either branch is a legitimate greedy decode).

The reference's ``lax.while_loop`` is a Python loop here over fixed-shape
draft and verify calls on ``models/generation.apply_with_cache`` with
per-row offsets: every round drafts exactly K tokens and verifies K+1 for
every row; accepted counts vary per row, and finished rows keep looping
as masked no-ops (their cache writes land at rows 0..K of their own
cache, which no later read uses) until the slowest row is done. Stale
KV-cache rows beyond a rolled-back offset need no cleanup: the attention
mask is offset-derived.

``temperature > 0`` runs speculative SAMPLING (Leviathan et al.): accept
draft token d with probability min(1, p_t(d)/p_d(d)); on rejection,
sample the replacement from norm(max(p_t - p_d, 0)) with a key
independent of the rejected draw. Keys are per OUTPUT POSITION (per row
when B > 1), so a perfect draft reproduces plain ancestral sampling of
the target with the same positional keys.

Keys are the port's own: jax's PRNG cannot be reproduced in PyTorch. A
key is a 64-bit integer; ``_fold(key, data)`` is the port's ``fold_in``
(``sample_seed``'s splitmix64 mix) and a draw takes a ``torch.Generator``
seeded with the folded key. ``rng`` is an int seed and is REQUIRED when
sampling: a silent default would return identical "samples" on every
call. Sampled tokens therefore differ from the reference's; greedy tokens
do not.

Usage::

    gen = make_speculative_generator(target_cfg, draft_cfg, k_draft=4)
    out = gen(target_params, draft_params, prompt, max_new_tokens=64)
    out = gen(target_params, draft_params, prompt, max_new_tokens=64,
              temperature=0.9, top_k=40, rng=1234)
"""

from typing import List, Optional, Sequence

import torch

from .generation import (apply_with_cache, categorical, init_cache,
                         prep_sampling_logits)
from .gpt import GPTConfig

# one transform for draft AND target (and make_generator): identical
# temperature/top-k filtering is what the acceptance ratio assumes
_prep_logits = prep_sampling_logits

_MASK64 = (1 << 64) - 1


def sample_seed(seed: int, count: int) -> int:
    """The 64-bit generator seed for a request's ``count``-th sampled
    token: ``z = (seed * 0x9E3779B97F4A7C15 + count + 1) mod 2**64``, then
    the splitmix64 finalizer ``z ^= z >> 30; z *= 0xBF58476D1CE4E5B9;
    z ^= z >> 27; z *= 0x94D049BB133111EB; z ^= z >> 31`` (mod 2**64)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(count) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def engine_sample_key(seed: int, count: int, device="cpu") -> torch.Generator:
    """The serving engine's sampling-key contract: the generator that
    draws a request's ``count``-th generated token is a
    ``torch.Generator`` on ``device`` seeded with ``sample_seed(seed,
    count)`` — a pure function of (seed, token index) with no global
    stream, so retries and replica moves replay token-identically.
    serving/engine.request_sample_key delegates here;
    ``make_matched_speculative_generator`` uses the same keys so its
    output matches plain engine decode token for token."""
    return torch.Generator(device=device).manual_seed(sample_seed(seed,
                                                                  count))


def _fold(key: int, data: int) -> int:
    """The port's ``fold_in``: a new 64-bit key from ``key`` and ``data``."""
    return sample_seed(key, data)


def _pos_key(stream: int, pos: int, device) -> torch.Generator:
    """Per-absolute-position sampling generator: deterministic in the
    position, independent of HOW decoding reached it — what makes
    speculative sampling with draft == target reproduce plain ancestral
    sampling exactly (same key at the same position -> same draw)."""
    return torch.Generator(device=device).manual_seed(_fold(stream, pos))


def _split(rng: int, n: int) -> List[int]:
    """``n`` independent keys from ``rng`` (negative fold data: disjoint
    from the non-negative positions ``_pos_key`` folds)."""
    return [_fold(rng, -1 - i) for i in range(n)]


def _row_streams(stream: int, B: int) -> List[int]:
    """Row r's stream. B == 1 keeps the stream EXACTLY as the unbatched
    convention (no row fold), preserving the draft==target ==
    ancestral-sampling parity; B > 1 folds the row index for independent
    per-row streams."""
    if B == 1:
        return [stream]
    return [_fold(stream, -1 - r) for r in range(B)]


def _draw(streams: Sequence[int], pos: Sequence[int], logits):
    """Per-row categorical with per-(row, position) keys. pos (B,) ints;
    logits (B, V) -> (B,) int64 on logits' device."""
    dev = logits.device
    return torch.stack([
        categorical(logits[r:r + 1], _pos_key(streams[r], int(pos[r]),
                                              dev))[0]
        for r in range(logits.shape[0])])


def _check_lengths(target_cfg, draft_cfg, S, max_new_tokens, K):
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens must be >= 1, got {max_new_tokens}")
    max_len = S + max_new_tokens + K + 1
    for cfg in (target_cfg, draft_cfg):
        if not cfg.rotary and max_len > cfg.max_seq:
            raise ValueError(
                f"prompt ({S}) + max_new_tokens ({max_new_tokens}) + "
                f"draft slack ({K + 1}) exceeds max_seq ({cfg.max_seq})")
    return max_len


def _emit(out, n, last, drafts, n_acc, bonus, max_new_tokens, K):
    """Write one round's tokens per row: accepted drafts then the bonus
    at the first mismatch (or after full acceptance); finished rows keep
    their tokens. Returns (n, last) advanced."""
    B, W = out.shape
    dev = out.device
    idx = torch.arange(K + 1, device=dev)
    drafts_pad = torch.cat([drafts, torch.zeros((B, 1), dtype=torch.long,
                                                device=dev)], dim=1)
    emitted = torch.where(idx[None] < n_acc[:, None], drafts_pad,
                          bonus[:, None])
    done = n >= max_new_tokens
    rows = torch.arange(B, device=dev)[:, None]
    cols = (n[:, None] + idx[None]).clamp(0, W - 1)
    cur = out[rows, cols]
    out[rows, cols] = torch.where(done[:, None], cur, emitted)
    n = torch.where(done, n, n + n_acc + 1)
    last = torch.where(done, last, bonus)
    return n, last


def _round_offsets(n, S, max_new_tokens):
    """Tokens in both caches per row (S + n - 1); finished rows run the
    round at offset 0, writing into rows 0..K of their own cache, which
    nothing reads again (the reference's out-of-range writes are dropped
    by XLA; PyTorch indexing would raise)."""
    done = n >= max_new_tokens
    return torch.where(done, torch.zeros_like(n), S + n - 1)


def make_speculative_generator(target_cfg: GPTConfig, draft_cfg: GPTConfig,
                               k_draft: int = 4):
    """Build speculative generate(target_params, draft_params, prompt,
    max_new_tokens, temperature=0.0, top_k=None, rng=None)
    -> (B, S+max_new_tokens) tokens. temperature<=0 = greedy (parity with
    plain greedy target decoding, per row); >0 = rejection sampling (an
    explicit int ``rng`` required)."""
    assert target_cfg.vocab_size == draft_cfg.vocab_size, (
        "target and draft must share a vocabulary")
    K = int(k_draft)
    assert K >= 1

    @torch.no_grad()
    def generate(target_params, draft_params, prompt, max_new_tokens: int,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 rng: Optional[int] = None):
        B, S = prompt.shape
        max_len = _check_lengths(target_cfg, draft_cfg, S, max_new_tokens,
                                 K)
        sampling = temperature > 0.0
        if sampling and rng is None:
            raise ValueError(
                "temperature > 0 requires an explicit rng: a default key "
                "would return the same 'samples' on every call")
        if rng is None:
            rng = 0
        dev = prompt.device
        prompt = prompt.long()
        # three independent streams: proposal/bonus draws, acceptance
        # uniforms, and rejection replacements (the replacement must not
        # reuse the proposal's key: the same noise would condition it on
        # the rejected token)
        rng_tok, rng_acc, rng_fix = _split(int(rng), 3)
        tok_s = _row_streams(rng_tok, B)
        acc_s = _row_streams(rng_acc, B)
        fix_s = _row_streams(rng_fix, B)
        rows_i = torch.arange(B, device=dev)

        t_cache = init_cache(target_cfg, B, max_len, dev)
        d_cache = init_cache(draft_cfg, B, max_len, dev)
        t_logits, _ = apply_with_cache(target_cfg, target_params, prompt,
                                       t_cache, 0)
        apply_with_cache(draft_cfg, draft_params, prompt, d_cache, 0)
        if sampling:
            first = _draw(tok_s, [0] * B,
                          _prep_logits(t_logits[:, -1], temperature, top_k))
        else:
            first = torch.argmax(t_logits[:, -1], dim=-1)

        W = max_new_tokens + K + 1
        out = torch.zeros((B, W), dtype=torch.long, device=dev)
        out[:, 0] = first
        n = torch.ones(B, dtype=torch.long, device=dev)
        last = first
        # invariant at loop top, PER ROW r: n[r] tokens emitted; last[r]
        # is the newest, in neither cache; both caches hold the S + n[r] - 1
        # tokens before it
        while bool((n < max_new_tokens).any()):
            offsets = _round_offsets(n, S, max_new_tokens)
            n_host = n.tolist()
            # draft: propose K tokens (and cache d_K too, so the draft
            # cache stays ahead even on full acceptance)
            tok, props, d_rows = last, [], []
            for j in range(K + 1):
                logits, _ = apply_with_cache(draft_cfg, draft_params,
                                             tok[:, None], d_cache,
                                             offsets + j)
                row = logits[:, -1]
                if sampling:
                    # the per-output-position key: a token proposed for
                    # output index n+j draws with the key ancestral
                    # sampling would use there
                    tok = _draw(tok_s, [m + j for m in n_host],
                                _prep_logits(row, temperature, top_k))
                else:
                    tok = torch.argmax(row, dim=-1)
                props.append(tok)
                d_rows.append(row)
            drafts = torch.stack(props[:K], dim=1)           # (B, K)

            # verify: one target forward over [last, d_1..d_K]
            block = torch.cat([last[:, None], drafts], dim=1)
            t_logits, _ = apply_with_cache(target_cfg, target_params, block,
                                           t_cache, offsets)
            if sampling:
                p_t = torch.softmax(
                    _prep_logits(t_logits, temperature, top_k), dim=-1)
                p_d = torch.softmax(
                    _prep_logits(torch.stack(d_rows[:K], dim=1),
                                 temperature, top_k), dim=-1)
                ratio = (torch.gather(p_t[:, :K], 2, drafts[..., None])[..., 0]
                         / (torch.gather(p_d, 2, drafts[..., None])[..., 0]
                            + 1e-20))
                u = torch.stack([torch.stack([
                    torch.rand((), generator=_pos_key(acc_s[r], n_host[r] + j,
                                                      dev), device=dev)
                    for j in range(K)]) for r in range(B)])  # (B, K)
                accept = (u <= ratio).long()
                n_acc = torch.cumprod(accept, dim=1).sum(dim=1)
                p_d_pad = torch.cat([p_d, torch.zeros_like(p_d[:, :1])],
                                    dim=1)
                p_t_at = p_t[rows_i, n_acc]                    # (B, V)
                p_d_at = p_d_pad[rows_i, n_acc]
                resid = (p_t_at - p_d_at).clamp_min(0.0)
                total = resid.sum(dim=-1, keepdim=True)
                q = torch.where(total > 0,
                                resid / total.clamp_min(1e-20), p_t_at)
                # full acceptance: the bonus comes from p_t[K] under the
                # POSITIONAL token key (a perfect draft reproduces
                # ancestral sampling); a rejection replacement takes a key
                # independent of the rejected proposal's draw
                na_host = n_acc.tolist()
                bonus = torch.stack([
                    categorical(torch.log(q[r:r + 1] + 1e-20), _pos_key(
                        tok_s[r] if na_host[r] == K else fix_s[r],
                        n_host[r] + na_host[r], dev))[0]
                    for r in range(B)])
            else:
                t_preds = torch.argmax(t_logits, dim=-1)       # (B, K+1)
                # t_preds[r, j]: the target's token after block[:j+1]
                matches = (drafts == t_preds[:, :K]).long()
                n_acc = torch.cumprod(matches, dim=1).sum(dim=1)
                bonus = t_preds[rows_i, n_acc]
            n, last = _emit(out, n, last, drafts, n_acc, bonus,
                            max_new_tokens, K)
        return torch.cat([prompt, out[:, :max_new_tokens]], dim=1)

    return generate


def make_matched_speculative_generator(target_cfg: GPTConfig,
                                       draft_cfg: GPTConfig,
                                       k_draft: int = 4):
    """Speculative decoding under the SERVING ENGINE's determinism
    contract (matched-key verification, the scheme serving/spec uses).

    Draft and target both SAMPLE their next token with the same
    per-position key ``engine_sample_key(seed, output_index)`` over their
    own temperature/top-k-filtered logits; a draft token is accepted iff
    it equals the target's own draw at that position. The emitted stream
    is therefore EXACTLY the token sequence plain per-token decode of the
    target would produce with the same (seed, index) keys, for any draft
    model and any temperature (greedy included: temperature<=0
    degenerates to argmax agreement).

    Returns generate(target_params, draft_params, prompt,
    max_new_tokens, temperature=0.0, top_k=None, seeds=None) ->
    (B, S+max_new_tokens). ``seeds`` is a (B,) sequence of per-row engine
    seeds (e.g. serving/engine.derive_request_seed); defaults to zeros."""
    assert target_cfg.vocab_size == draft_cfg.vocab_size, (
        "target and draft must share a vocabulary")
    K = int(k_draft)
    assert K >= 1

    @torch.no_grad()
    def generate(target_params, draft_params, prompt, max_new_tokens: int,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 seeds=None):
        B, S = prompt.shape
        max_len = _check_lengths(target_cfg, draft_cfg, S, max_new_tokens,
                                 K)
        seeds = [0] * B if seeds is None else [int(s) for s in seeds]
        dev = prompt.device
        prompt = prompt.long()
        sampling = temperature > 0.0

        def choose(logits, idx):
            """The engine's per-token selection: argmax when greedy, else
            categorical over filtered logits with the matched (seed,
            output-index) key. logits (B, V); idx (B,) ints."""
            if not sampling:
                return torch.argmax(logits, dim=-1)
            return torch.stack([
                categorical(_prep_logits(logits[b:b + 1], temperature, top_k),
                            engine_sample_key(seeds[b], int(idx[b]), dev))[0]
                for b in range(B)])

        t_cache = init_cache(target_cfg, B, max_len, dev)
        d_cache = init_cache(draft_cfg, B, max_len, dev)
        t_logits, _ = apply_with_cache(target_cfg, target_params, prompt,
                                       t_cache, 0)
        apply_with_cache(draft_cfg, draft_params, prompt, d_cache, 0)
        first = choose(t_logits[:, -1], [0] * B)

        W = max_new_tokens + K + 1
        out = torch.zeros((B, W), dtype=torch.long, device=dev)
        out[:, 0] = first
        n = torch.ones(B, dtype=torch.long, device=dev)
        last = first
        rows_i = torch.arange(B, device=dev)
        while bool((n < max_new_tokens).any()):
            offsets = _round_offsets(n, S, max_new_tokens)
            n_host = n.tolist()
            # draft K+1 proposals with the ENGINE's keys (the extra one
            # only keeps the draft cache ahead on full acceptance)
            tok, props = last, []
            for j in range(K + 1):
                logits, _ = apply_with_cache(draft_cfg, draft_params,
                                             tok[:, None], d_cache,
                                             offsets + j)
                tok = choose(logits[:, -1], [m + j for m in n_host])
                props.append(tok)
            drafts = torch.stack(props[:K], dim=1)           # (B, K)
            block = torch.cat([last[:, None], drafts], dim=1)
            t_logits, _ = apply_with_cache(target_cfg, target_params, block,
                                           t_cache, offsets)
            # the target's own draw at every position, with the keys plain
            # per-token decode would use
            choice = torch.stack(
                [choose(t_logits[:, t], [m + t for m in n_host])
                 for t in range(K + 1)], dim=1)              # (B, K+1)
            matches = (drafts == choice[:, :K]).long()
            n_acc = torch.cumprod(matches, dim=1).sum(dim=1)
            bonus = choice[rows_i, n_acc]
            n, last = _emit(out, n, last, drafts, n_acc, bonus,
                            max_new_tokens, K)
        return torch.cat([prompt, out[:, :max_new_tokens]], dim=1)

    return generate
