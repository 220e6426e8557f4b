"""Utilities for integrating sparse attention into transformer models.

Counterpart of deeperspeed_tpu/ops/sparse_attention/sparse_attention_utils.py
(``SparseAttentionUtils``) on torch tensors: extend position embeddings
for longer sequences, swap a HF-shaped BERT/RoBERTa encoder's dense
self-attention for block-sparse attention, and pad/unpad sequences to the
sparsity block size.

"Replacing a module" means extracting each layer's q/k/v ``nn.Linear``
weights into a ``BertSparseSelfAttention`` params dict (``w = weight.T``);
the padding helpers return the pad length for ``unpad_sequence_output``.
"""

from typing import List, Optional, Tuple

import torch

from ...utils.logging import logger
from .sparse_self_attention import BertSparseSelfAttention
from .sparsity_config import SparsityConfig


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().float()


class SparseAttentionUtils:
    """DeepSpeed's sparse_attention_utils.py:13."""

    @staticmethod
    def extend_position_embedding(position_embeddings, max_position: int):
        """Tile an existing (orig_max, dim) position table out to
        ``max_position`` rows (DeepSpeed :19 duplicates the learned table),
        so a model pretrained at 512 can run longer sparse sequences."""
        emb = _f32(position_embeddings)
        orig, dim = emb.shape
        if max_position <= orig:
            return emb[:max_position].clone()
        reps = (max_position + orig - 1) // orig
        out = emb.repeat(reps, 1)[:max_position].contiguous()
        logger.info("extended position embeddings %d -> %d", orig, max_position)
        return out

    @staticmethod
    def update_tokenizer_model_max_length(tokenizer, max_position: int):
        """DeepSpeed :68."""
        tokenizer.model_max_length = max_position
        if hasattr(tokenizer, "init_kwargs"):
            tokenizer.init_kwargs["model_max_length"] = max_position
        return tokenizer

    @staticmethod
    def replace_model_self_attention_with_sparse_self_attention(
        model,
        max_position: int,
        sparsity_config: Optional[SparsityConfig] = None,
    ) -> Tuple[BertSparseSelfAttention, List[dict]]:
        """DeepSpeed :85. Walks a HF BERT-family model (``.bert``,
        ``.roberta`` or ``.encoder``, then ``.layer[i].attention.self
        .{query,key,value}``) and extracts every layer's q/k/v projections
        into sparse-attention params. Returns (layer, params_list); the
        caller runs ``layer.apply(params_i, h)`` in place of the dense
        self-attention of layer i."""
        hf_config = model.config
        if sparsity_config is None:
            sparsity_config = SparsityConfig(
                num_heads=hf_config.num_attention_heads
            )
        if hasattr(model, "bert"):
            encoder = model.bert.encoder
        elif hasattr(model, "roberta"):
            encoder = model.roberta.encoder
        elif hasattr(model, "encoder"):
            encoder = model.encoder
        else:
            raise ValueError(
                "replace_model_self_attention_with_sparse_self_attention "
                "supports BERT/RoBERTa-shaped models (needs .encoder)"
            )
        sparse_layer = BertSparseSelfAttention(
            hidden_size=hf_config.hidden_size,
            num_heads=hf_config.num_attention_heads,
            sparsity_config=sparsity_config,
            max_seq_length=max_position,
        )
        params_list = []
        for layer in encoder.layer:
            att = layer.attention.self
            params_list.append({
                name: {"w": _f32(proj.weight).t().contiguous(),
                       "b": _f32(proj.bias).clone()}
                for name, proj in (("query", att.query), ("key", att.key),
                                   ("value", att.value))
            })
        logger.info("extracted sparse self-attention params for %d layers",
                    len(params_list))
        return sparse_layer, params_list

    # DeepSpeed :123 — per-layer variant
    @staticmethod
    def replace_self_attention_layer_with_sparse_self_attention_layer(
        config, layer, sparsity_config=None
    ):
        model_like = type("M", (), {"config": config,
                                    "encoder": type("E", (), {"layer": [layer]})()})
        sparse_layer, params = (
            SparseAttentionUtils
            .replace_model_self_attention_with_sparse_self_attention(
                model_like, getattr(config, "max_position_embeddings", 2048),
                sparsity_config,
            )
        )
        return sparse_layer, params[0]

    @staticmethod
    def pad_to_block_size(
        block_size: int,
        input_ids=None,
        attention_mask=None,
        token_type_ids=None,
        position_ids=None,
        inputs_embeds=None,
        pad_token_id: int = 0,
        model_embeddings=None,
    ):
        """DeepSpeed :151. Pads the sequence dim of every provided tensor up
        to a multiple of ``block_size``. Returns (pad_len, *padded) in the
        same order; None inputs stay None."""
        ref = input_ids if input_ids is not None else inputs_embeds
        assert ref is not None, "need input_ids or inputs_embeds"
        seq_len = ref.shape[1]
        pad_len = (block_size - seq_len % block_size) % block_size

        def pad_tok(x, value=0):
            if x is None or pad_len == 0:
                return x
            x = torch.as_tensor(x)
            widths = [0, 0] * (x.dim() - 2) + [0, pad_len]
            return torch.nn.functional.pad(x, widths, value=value)

        input_ids = pad_tok(input_ids, pad_token_id)
        attention_mask = pad_tok(attention_mask, 0)
        token_type_ids = pad_tok(token_type_ids, 0)
        position_ids = pad_tok(position_ids, 0)
        if inputs_embeds is not None and pad_len > 0:
            inputs_embeds = torch.as_tensor(inputs_embeds)
            if model_embeddings is not None and input_ids is not None:
                pad_ids = input_ids[:, -pad_len:]
                table = torch.as_tensor(model_embeddings)
                pad_emb = table[pad_ids].to(inputs_embeds.dtype)
            else:
                pad_emb = inputs_embeds.new_zeros(
                    (inputs_embeds.shape[0], pad_len, inputs_embeds.shape[2]))
            inputs_embeds = torch.cat([inputs_embeds, pad_emb], dim=1)
        return (pad_len, input_ids, attention_mask, token_type_ids,
                position_ids, inputs_embeds)

    @staticmethod
    def unpad_sequence_output(pad_len: int, sequence_output):
        """DeepSpeed :210."""
        if pad_len > 0:
            return sequence_output[:, :-pad_len]
        return sequence_output
