"""KV-cache autoregressive generation for the GPT family.

Counterpart of deeperspeed_tpu/models/generation.py. The cache is a dense
per-layer tensor pair updated IN PLACE (the reference returns a new cache
from each jitted call; here ``apply_with_cache`` writes into the tensors
it is given and returns the same dict). ``make_generator`` is a Python
loop over decode steps where the reference scans.

Usage::

    gen = make_generator(cfg)          # cfg: models.gpt.GPTConfig
    out = gen(params, prompt_ids, max_new_tokens=64,
              temperature=1.0, top_k=40, rng=torch_generator)  # (B, S+64)

temperature=0 (default) is greedy argmax. The prompt is prefilled in one
pass; decode steps attend to the cache only.
"""

import math
from typing import Optional

import torch

from .gpt import (GPTConfig, decoder_block, embed, layer_norm, layer_slices,
                  logits_of)


def init_cache(cfg: GPTConfig, batch: int, max_len: int, device):
    """Stacked per-layer KV cache: (L, B, max_len, Hkv, Dh) — GQA/MQA
    models cache only their n_kv_head heads (a tensor-parallel rank's
    ``cfg`` names its own heads: ServingEngine's ``_local_kv_cfg``)."""
    shape = (cfg.n_layer, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def grouped_attention(q, k_c, v_c, valid):
    """Attention of q (B, S, Hq, Dh) over cached keys/values
    (B, T, Hkv, Dh), with ``valid`` (B or 1, S, T) marking the keys each
    query may see. Q heads fold to (Hkv, rep) so the cache is read at its
    small Hkv width (no repeat). Scores and softmax in fp32; the context
    in q's dtype."""
    B, S, Hq, Dh = q.shape
    Hkv = k_c.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, Dh)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(), k_c.float())
    scores = scores / math.sqrt(Dh)
    scores = scores.masked_fill(~valid[:, None, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bhrqk,bkhd->bqhrd", probs, v_c)
    return ctx.reshape(B, S, Hq, Dh)


def _cached_block(cfg: GPTConfig, x, layer_params, k_cache, v_cache,
                  offset, positions, tp=None):
    """One decoder layer over S new tokens with a KV cache.

    x: (B, S, D); k/v_cache: (B, max_len, Hkv, Dh), written in place;
    offset: an int (tokens already cached, shared) or a (B,) tensor of
    per-row offsets. Returns x_out. The layer math is gpt.decoder_block;
    only the attention core differs (cache update + absolute-position
    masking). A Mixture-of-Experts layer (a ``moe`` subtree) takes
    decoder_block's moe_ffn, the reference's mlp_fn. ``tp``: as
    ``decoder_block`` takes it (the cache holds this rank's heads)."""
    cdt = cfg.dtype
    B_, S = x.shape[0], x.shape[1]
    vec = isinstance(offset, torch.Tensor)
    dev = x.device

    def attend(q, k, v):
        steps = torch.arange(S, device=dev)
        if vec:
            rows = torch.arange(B_, device=dev)[:, None]
            cols = offset[:, None] + steps[None]
            k_cache[rows, cols] = k.to(cdt)
            v_cache[rows, cols] = v.to(cdt)
            q_pos = offset[:, None] + steps[None]            # (B, S)
        else:
            k_cache[:, offset:offset + S] = k.to(cdt)
            v_cache[:, offset:offset + S] = v.to(cdt)
            q_pos = (offset + steps)[None]                   # (1, S)
        key_pos = torch.arange(k_cache.shape[1], device=dev)
        valid = key_pos[None, None, :] <= q_pos[:, :, None]  # (B|1, S, T)
        return grouped_attention(q, k_cache, v_cache, valid), None

    x, _ = decoder_block(cfg, x, layer_params, positions, attend, tp=tp)
    return x


@torch.no_grad()
def apply_with_cache(cfg: GPTConfig, params, tokens, cache, offset,
                     tp=None):
    """Process S tokens given ``offset`` already-cached ones. Returns
    (logits (B, S, V), cache), the cache updated in place. ``offset`` is
    an int, or a (B,) int tensor of PER-ROW offsets. With ``tp`` (a
    tensor-parallel Transport) ``params`` and the cache are this rank's
    part and every rank gets the whole logits."""
    B, S = tokens.shape
    if isinstance(offset, torch.Tensor) and offset.dim() == 0:
        offset = int(offset)
    if (not cfg.rotary and isinstance(offset, int)
            and offset + S > cfg.max_seq):
        raise ValueError(
            f"offset ({offset}) + tokens ({S}) exceeds max_seq "
            f"({cfg.max_seq}): the learned-position table cannot extrapolate"
        )
    tokens = tokens.long()
    steps = torch.arange(S, device=tokens.device)
    if isinstance(offset, torch.Tensor):
        positions = offset[:, None] + steps[None]
    else:
        positions = offset + steps
    x = embed(cfg, params, tokens, positions, tp, rows_first=True)
    for i, layer_params in enumerate(layer_slices(params, cfg.n_layer)):
        x = _cached_block(cfg, x, layer_params, cache["k"][i],
                          cache["v"][i], offset, positions, tp)
    x = layer_norm(x, params["final_ln"]["scale"], params["final_ln"]["bias"],
                   cfg.layernorm_eps)
    return logits_of(cfg, params, x, tp), cache


def prep_sampling_logits(logits, temperature, top_k):
    """Shared sampling transform: fp32 temperature divide + top-k filter."""
    logits = logits.float() / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -1e30)
    return logits


def categorical(logits, generator: torch.Generator):
    """One draw per row of ``logits`` (..., V) by the Gumbel-max trick,
    with the uniform noise drawn from ``generator`` (which must live on
    the logits' device): a pure function of the generator's state."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)


def _select_next(logits, temperature, top_k, gen):
    """logits (B, V) -> next token (B,). temperature<=0 = greedy."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    return categorical(prep_sampling_logits(logits, temperature, top_k), gen)


def make_generator(cfg: GPTConfig):
    """Build generate(params, prompt, max_new_tokens, ...): a Python loop
    of one prefill and ``max_new_tokens - 1`` decode steps."""

    @torch.no_grad()
    def generate(params, prompt, max_new_tokens: int, temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 rng: Optional[torch.Generator] = None):
        B, S = prompt.shape
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        max_len = S + max_new_tokens
        if not cfg.rotary and max_len > cfg.max_seq:
            raise ValueError(
                f"prompt ({S}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"max_seq ({cfg.max_seq}) — learned position embeddings "
                "cannot extrapolate"
            )
        dev = prompt.device
        if rng is None:
            rng = torch.Generator(device=dev).manual_seed(0)
        cache = init_cache(cfg, B, max_len, dev)
        logits, cache = apply_with_cache(cfg, params, prompt, cache, 0)
        tok = _select_next(logits[:, -1], temperature, top_k, rng)
        out = [tok]
        for offset in range(S, max_len - 1):
            logits, cache = apply_with_cache(cfg, params, tok[:, None], cache,
                                             offset)
            tok = _select_next(logits[:, -1], temperature, top_k, rng)
            out.append(tok)
        return torch.cat([prompt.long(), torch.stack(out, dim=1)], dim=1)

    return generate
