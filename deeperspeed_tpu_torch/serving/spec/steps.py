"""The speculative decode path's two steps.

Counterpart of deeperspeed_tpu/serving/spec/steps.py. ``make_draft_step``
runs the DRAFTER: ``draft_k + 1`` single-token paged decodes over the full
slot array (the per-layer math of the engine's decode step, against the
drafter's own paged pool), proposing ``draft_k`` tokens per slot. It runs
one extra iteration so the last proposal's KV row is already in the
drafter pool when every draft is accepted: a full-accept round never
needs a host-side drafter resync.

``make_verify_step`` runs the TARGET over the ``draft_k + 1`` window
``[pending, d_1..d_K]`` in one forward (``paged_attend_multi``), picks the
target's own next-token choice at every position with the decode step's
selection (``engine.choose_tokens``: argmax when temperature <= 0, else a
top-k-filtered draw keyed by ``request_sample_key(seed, token index)``),
and accepts the longest draft prefix that MATCHES those choices. The
emitted stream (accepted drafts plus the target's choice at the first
mismatch) is by construction the stream the plain decode step would have
produced on the same logits: greedy speculative output equals plain
greedy decode, and sampled accept/reject is a pure function of (per-rid
seed, token index), so a failover retry or a spec-off replica replays the
same stream.

Both steps run the full slot array (idle lanes: token 0 / length 0 /
null tables), so with the engine's fallback plain decode the decode path
meets exactly three argument signatures. The pools are written in place;
rows written for rejected drafts are stale but invisible (the next
round's length-derived masks hide them until they are overwritten).
"""

import numpy as np
import torch

from ...models.gpt import (GPTConfig, decoder_block, head_weight, layer_norm,
                           layer_slices)
from ..config import ServingConfig
from ..engine import _paged_block, choose_tokens
from ..kv_cache import paged_attend_multi


# the decode step's next-token selection itself, so the draft and verify
# choices are the ones plain decode would pick on the same logits
_choose = choose_tokens


def _resolve_top_k(cfg: GPTConfig, scfg: ServingConfig):
    top_k = scfg.top_k
    if top_k is not None and top_k >= cfg.vocab_size:
        return None  # full-vocab top-k is a no-op filter
    return top_k


def _unembed(cfg: GPTConfig, params, x):
    x = layer_norm(x, params["final_ln"]["scale"],
                   params["final_ln"]["bias"], cfg.layernorm_eps)
    return x @ head_weight(cfg, params)


def _embed(cfg: GPTConfig, params, tokens, positions):
    x = params["embed"]["wte"][tokens].to(cfg.dtype)
    if not cfg.rotary:
        x = x + params["embed"]["wpe"][positions].to(cfg.dtype)
    return x


def make_draft_step(cfg: GPTConfig, scfg: ServingConfig, draft_k: int):
    """Build the drafter step.

    draft_step(params, k_pool, v_pool, tables, lengths, tokens, temps,
    seeds, counts) -> drafts (N, K) int64 on the host. ``cfg`` is the
    DRAFTER's config; the pools are the drafter's paged pool (written in
    place). Iteration j feeds the running token (the slot's pending token
    at j=0), writes its KV at row ``lengths + j``, and proposes the token
    for emitted index ``counts + j`` with the engine's selection keyed at
    that index. tables, lengths and tokens are device tensors; temps,
    seeds and counts host sequences.
    """
    top_k = _resolve_top_k(cfg, scfg)
    bs = scfg.block_size

    @torch.no_grad()
    def draft_step(params, k_pool, v_pool, tables, lengths, tokens, temps,
                   seeds, counts):
        N = tokens.shape[0]
        rows = torch.arange(N, device=tokens.device)
        layers = layer_slices(params, cfg.n_layer)
        counts = np.asarray(counts)
        tok, drafts = tokens, []
        # K+1 iterations: the extra one writes d_K's KV row (its proposal
        # is discarded), keeping the drafter cache complete even when the
        # verify step accepts every draft
        for j in range(draft_k + 1):
            pos = lengths + j
            positions = pos[:, None]
            x = _embed(cfg, params, tok[:, None], positions)  # (N, 1, D)
            wblk = tables[rows, pos // bs]
            woff = pos % bs
            for i, layer_params in enumerate(layers):
                x = _paged_block(cfg, x, layer_params, k_pool[i], v_pool[i],
                                 tables, pos, wblk, woff, positions)
            logits = _unembed(cfg, params, x)[:, 0]
            tok = _choose(logits, temps, seeds, counts + j, top_k)
            drafts.append(tok)
        return torch.stack(drafts[:draft_k], dim=1).cpu()

    return draft_step


def _paged_block_multi(cfg: GPTConfig, x, layer_params, k_l, v_l, tables,
                       lengths, wblk, woff, positions):
    """One decoder layer over all slots' T-token windows: the multi-token
    twin of engine._paged_block (same decoder_block math, the attention
    core swapped for paged_attend_multi; a Mixture-of-Experts layer takes
    decoder_block's moe_ffn over the T-token windows, as the reference's
    mlp_fn)."""

    def attend(q, k, v):
        return paged_attend_multi(k_l, v_l, q, k, v, tables, lengths, wblk,
                                  woff), None

    x, _ = decoder_block(cfg, x, layer_params, positions, attend)
    return x


def make_verify_step(cfg: GPTConfig, scfg: ServingConfig, draft_k: int):
    """Build the target verify step.

    verify_step(params, k_pool, v_pool, tables, lengths, tokens (N, K+1),
    temps, seeds, counts) -> (n_acc (N,), bonus (N,)) int64 on the host.
    ``tokens`` is ``[pending, d_1..d_K]`` per slot; ``cfg`` and the pools
    are the TARGET's. n_acc is the length of the longest draft prefix
    matching the target's own per-position choices; bonus is the target's
    choice at the first mismatch (position n_acc): the host emits
    ``drafts[:n_acc] + [bonus]``.
    """
    T = draft_k + 1
    top_k = _resolve_top_k(cfg, scfg)
    bs = scfg.block_size

    @torch.no_grad()
    def verify_step(params, k_pool, v_pool, tables, lengths, tokens, temps,
                    seeds, counts):
        positions = lengths[:, None] + torch.arange(T, device=tokens.device)
        x = _embed(cfg, params, tokens, positions)            # (N, T, D)
        wblk = torch.gather(tables, 1, positions // bs)
        woff = positions % bs
        for i, layer_params in enumerate(layer_slices(params, cfg.n_layer)):
            x = _paged_block_multi(cfg, x, layer_params, k_pool[i],
                                   v_pool[i], tables, lengths, wblk, woff,
                                   positions)
        logits = _unembed(cfg, params, x)                     # (N, T, V)
        counts = np.asarray(counts)
        # the target's own choice at every window position, with the
        # decode step's selection at that position's token index
        choice = torch.stack(
            [_choose(logits[:, t], temps, seeds, counts + t, top_k)
             for t in range(T)], dim=1).cpu()                 # (N, T)
        drafts = tokens[:, 1:].cpu()                          # (N, K)
        matches = (drafts == choice[:, :draft_k]).long()
        n_acc = torch.cumprod(matches, dim=1).sum(dim=1)
        bonus = torch.gather(choice, 1, n_acc[:, None])[:, 0]
        return n_acc, bonus

    return verify_step
