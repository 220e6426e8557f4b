"""The BERT encoder family in PyTorch: MLM pretraining and the SQuAD head.

Counterpart of deeperspeed_tpu/models/bert.py: embeddings, a loop over
the DeepSpeed transformer layer (ops/transformer), a pooler and the MLM
head tied to the word embeddings. Parameters keep the reference's layout
so weights carry across by copy (models/convert.py): a plain dict whose
per-layer tensors are STACKED on a leading layer axis (Lamb's trust ratio
is taken per leaf of that tree, so the stacking is part of the numbers),
matrices (in, out).

Each layer runs under activation checkpointing when ``remat`` is set:
``remat_policy`` "full" replays the whole layer in the backward,
"matmuls" keeps the qkv and pre-GeLU products and the attention kernel's
output (the reference's ``bert_qkv``, ``bert_mlp_pre`` and ``bert_ctx``)
and replays the rest, "dots_all" keeps every matrix product. The MLM loss
streams its cross-entropy over sequence chunks (``ce_chunk``), each chunk
recomputed in the backward, and with ``mlm_gather_frac`` runs the
vocabulary-wide head only on scored positions.

Not ported: importing a Hugging Face checkpoint (``params_from_hf``) and
BERT's tensor parallelism (``param_specs`` gives the reference's axis
names, and no mesh uses them yet; the GPT model's is ported; ROADMAP.md).
"""

import dataclasses
import math
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.flash_attention import FLASH_FWD_OP
from ..ops.flash_static import SUPERTILE_FWD_OP
from ..ops.fused_blocks import bias_gelu
from ..ops.transformer import DeepSpeedTransformerConfig, init_transformer_params
from ..ops.transformer.transformer import (_layer_norm, _seed_of,
                                           _transformer_forward, fold_seed)
from ..utils import hooks
from ..utils.init import normal_drawer
from .gpt import layer_slices, pick_ce_chunk

MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 0  # 0 => 4 * d_model
    max_seq: int = 512
    type_vocab_size: int = 2
    layernorm_eps: float = 1e-12
    initializer_range: float = 0.02
    pre_layer_norm: bool = False  # classic BERT is post-LN
    remat: bool = True
    # 'full' replays the whole layer in the backward; 'matmuls' keeps the
    # qkv / attention-output / pre-GeLU products; 'dots_all' keeps every
    # matrix product (see _remat_step)
    remat_policy: str = "full"
    dtype: Any = torch.bfloat16
    attn_impl: str = "auto"
    attn_dropout: float = 0.0
    hidden_dropout: float = 0.0
    # MLM-loss sequence chunk (streaming CE, no (B, S, V) fp32 logits);
    # 0 disables chunking
    ce_chunk: int = 64
    # when > 0, the MLM head runs only on scored positions: the (B*S)
    # hidden rows are stably ordered scored-first and the head takes the
    # first ceil(frac*B*S) rows, rounded up to a multiple of 128. frac must
    # upper-bound the scored fraction: positions past the cut go unscored
    # (the loss counts only gathered positions; the overflow is reported
    # to the "mlm_dropped" tap). 0 = score every position (exact).
    mlm_gather_frac: float = 0.0

    def __post_init__(self):
        if self.remat_policy not in ("full", "matmuls", "dots_all"):
            raise ValueError(
                f"remat_policy must be 'full', 'matmuls' or 'dots_all', "
                f"got {self.remat_policy!r}")
        if not 0.0 <= self.mlm_gather_frac <= 1.0:
            raise ValueError("mlm_gather_frac must be in [0, 1]")
        if not isinstance(self.dtype, torch.dtype):
            raise TypeError(f"dtype must be a torch.dtype, got {self.dtype!r}")

    @property
    def ffn_dim(self):
        return self.d_ff if self.d_ff else 4 * self.d_model

    def layer_config(self) -> DeepSpeedTransformerConfig:
        return DeepSpeedTransformerConfig(
            batch_size=-1,
            max_seq_length=self.max_seq,
            hidden_size=self.d_model,
            intermediate_size=self.ffn_dim,
            heads=self.n_head,
            attn_dropout_ratio=self.attn_dropout,
            hidden_dropout_ratio=self.hidden_dropout,
            num_hidden_layers=self.n_layer,
            initializer_range=self.initializer_range,
            fp16=self.dtype == torch.bfloat16,
            pre_layer_norm=self.pre_layer_norm,
            layernorm_eps=self.layernorm_eps,
            attn_impl=self.attn_impl,
        )


def param_shapes(cfg: BertConfig, qa: bool = False):
    """The params tree with each leaf's shape: the reference's layout (with
    the SQuAD head's ``qa`` leaves when ``qa``)."""
    D, F_, L, V = cfg.d_model, cfg.ffn_dim, cfg.n_layer, cfg.vocab_size
    shapes = {
        "embed": {"word": (V, D), "pos": (cfg.max_seq, D),
                  "type": (cfg.type_vocab_size, D), "ln_w": (D,),
                  "ln_b": (D,)},
        "layers": {
            "attn_qkvw": (L, D, 3 * D), "attn_qkvb": (L, 3 * D),
            "attn_ow": (L, D, D), "attn_ob": (L, D),
            "attn_nw": (L, D), "attn_nb": (L, D),
            "inter_w": (L, D, F_), "inter_b": (L, F_),
            "output_w": (L, F_, D), "output_b": (L, D),
            "norm_w": (L, D), "norm_b": (L, D),
        },
        "pooler": {"w": (D, D), "b": (D,)},
        "mlm": {"w": (D, D), "b": (D,), "ln_w": (D,), "ln_b": (D,),
                "bias": (V,)},
    }
    if qa:
        shapes["qa"] = {"w": (D, 2), "b": (2,)}
    return shapes


def init_params(seed, cfg: BertConfig, device=None):
    """Initial params with the reference's shapes and scales, fp32, per-
    layer tensors stacked on axis 0, on ``device`` (default CUDA). ``seed``:
    an int, a ``torch.Generator`` on ``device`` or a numpy generator (see
    utils/init.py ``normal_drawer``). The draws differ from the
    reference's; convert its params (models/convert.py) to compare."""
    device = torch.device("cuda" if device is None else device)
    if isinstance(seed, int):
        seed = torch.Generator(device=device).manual_seed(seed)
    norm = normal_drawer(seed, device)
    std = cfg.initializer_range
    layer_cfg = cfg.layer_config()
    per_layer = [init_transformer_params(seed, layer_cfg, device=device)
                 for _ in range(cfg.n_layer)]
    layers = {k: torch.stack([p[k] for p in per_layer]) for k in per_layer[0]}
    D = cfg.d_model

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    return {
        "embed": {"word": norm((cfg.vocab_size, D), std),
                  "pos": norm((cfg.max_seq, D), std),
                  "type": norm((cfg.type_vocab_size, D), std),
                  "ln_w": ones(D), "ln_b": zeros(D)},
        "layers": layers,
        "pooler": {"w": norm((D, D), std), "b": zeros(D)},
        # transform dense + LN; the decoder is tied to the word embeddings
        "mlm": {"w": norm((D, D), std), "b": zeros(D), "ln_w": ones(D),
                "ln_b": zeros(D), "bias": zeros(cfg.vocab_size)},
    }


def param_specs(cfg: BertConfig):
    """The reference's tensor-parallel layout over the 'model' axis, one
    tuple of axis names (None = replicated) per leaf. No mesh consumes it
    yet: BERT's tensor parallelism is not ported (ROADMAP.md)."""
    M = MODEL_AXIS
    return {
        "embed": {"word": (None, M), "pos": (), "type": (), "ln_w": (),
                  "ln_b": ()},
        "layers": {
            "attn_qkvw": (None, None, M), "attn_qkvb": (None, M),
            "attn_ow": (None, M, None), "attn_ob": (None, None),
            "attn_nw": (None, None), "attn_nb": (None, None),
            "inter_w": (None, None, M), "inter_b": (None, M),
            "output_w": (None, M, None), "output_b": (None, None),
            "norm_w": (None, None), "norm_b": (None, None),
        },
        "pooler": {"w": (), "b": ()},
        "mlm": {"w": (), "b": (), "ln_w": (), "ln_b": (), "bias": ()},
    }


# ------------------------------------------------------------------ #
# activation checkpointing
# ------------------------------------------------------------------ #

_MM_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_ATTN_OPS = (FLASH_FWD_OP, SUPERTILE_FWD_OP)
# a layer's 2-D products run in this order, pre- or post-LN: qkv (0),
# attention output (1), FFN in (2, the pre-GeLU product), FFN out (3)
_MATMULS_KEPT = (0, 2)


class _LayerPolicy:
    """Selective checkpointing policy of one layer call. "matmuls" keeps
    the qkv and pre-GeLU products and the attention kernel's outputs (on
    the dense path, with a mask, the attention replays); "dots_all" keeps
    every matrix product and the attention kernel's outputs. Eager
    recomputation replays the layer from its start, so the products are
    told apart by their order in the layer, counted afresh in the forward
    and in the recomputation."""

    def __init__(self, policy: str):
        self.policy = policy
        self.count = {False: 0, True: 0}

    def __call__(self, ctx, op, *args, **kwargs):
        if op in _ATTN_OPS:
            return CheckpointPolicy.MUST_SAVE
        if op in _MM_OPS:
            i = self.count[ctx.is_recompute]
            self.count[ctx.is_recompute] = i + 1
            if self.policy == "dots_all" or i in _MATMULS_KEPT:
                return CheckpointPolicy.MUST_SAVE
        elif self.policy == "dots_all" and op == torch.ops.aten.bmm.default:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_step(cfg: BertConfig, fn):
    """``fn(x, layer_params, seed)`` under ``cfg.remat``/``remat_policy``."""
    if not cfg.remat:
        return fn
    if cfg.remat_policy == "full":
        return lambda x, lp, seed: checkpoint(fn, x, lp, seed,
                                              use_reentrant=False)

    def context():
        return create_selective_checkpoint_contexts(
            _LayerPolicy(cfg.remat_policy))

    return lambda x, lp, seed: checkpoint(fn, x, lp, seed,
                                          use_reentrant=False,
                                          context_fn=context)


# ------------------------------------------------------------------ #
# the model
# ------------------------------------------------------------------ #


def make_bert(cfg: BertConfig):
    """Returns (init_fn, apply_fn, mlm_loss_fn, specs), as the reference's
    ``make_bert``.

    init_fn(seed, device=None) -> params (``init_params``)
    apply_fn(params, input_ids, token_type_ids=None, attention_mask=None,
        rng=None) -> (sequence_output, pooled_output); differentiable
    mlm_loss_fn(params, batch, rng=None) with batch = (input_ids, labels[,
        attention_mask]) where labels == -100 marks unscored positions (the
        Hugging Face convention) -> fp32 scalar
    ``rng`` (a ``torch.Generator`` or an int) seeds dropout; each layer
    draws from a seed folded from it and its index."""
    layer_cfg = cfg.layer_config()

    def apply_fn(params, input_ids, token_type_ids=None, attention_mask=None,
                 rng=None):
        cdt = cfg.dtype
        ids = input_ids.long()
        S = ids.shape[1]
        e = params["embed"]
        x = F.embedding(ids, e["word"].to(cdt))
        x = x + e["pos"][:S].to(cdt)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(ids)
        x = x + F.embedding(token_type_ids.long(), e["type"].to(cdt))
        x = _layer_norm(x, e["ln_w"].to(cdt), e["ln_b"].to(cdt),
                        cfg.layernorm_eps)

        additive = None
        if attention_mask is not None:
            additive = (1.0 - attention_mask[:, None, None, :].float()) * -1e4

        def block(h, layer_params, seed):
            return _transformer_forward(layer_params, h, layer_cfg,
                                        attention_mask=additive, rng=seed)

        step = _remat_step(cfg, block)
        base = None if rng is None else _seed_of(rng)
        for i, layer_params in enumerate(layer_slices(params, cfg.n_layer)):
            seed = None if base is None else fold_seed(base, i)
            x = step(x, layer_params, seed)
            x = hooks.record_layer_output("bertlayer", x, i)

        p = params["pooler"]
        pooled = torch.tanh(x[:, 0] @ p["w"].to(cdt) + p["b"].to(cdt))
        return x, pooled

    def mlm_logits(params, sequence_output):
        cdt = cfg.dtype
        m = params["mlm"]
        h = bias_gelu(sequence_output @ m["w"].to(cdt), m["b"].to(cdt),
                      approximate=False)
        h = _layer_norm(h, m["ln_w"], m["ln_b"], cfg.layernorm_eps)
        return h @ params["embed"]["word"].to(cdt).T + m["bias"].to(cdt)

    def _chunk_nll(params, seq_chunk, labels_chunk):
        """Masked-LM nll summed over one chunk, and the count of scored
        positions: logsumexp minus the target logit, in fp32."""
        logits = mlm_logits(params, seq_chunk).float()
        valid = labels_chunk != -100
        safe = torch.where(valid, labels_chunk, 0)
        lse = torch.logsumexp(logits, dim=-1)
        tgt = logits.gather(-1, safe[..., None])[..., 0]
        nll = torch.where(valid, lse - tgt, 0.0)
        return nll.sum(), valid.sum()

    def mlm_loss_fn(params, batch, rng=None):
        input_ids, labels = batch[0], batch[1].long()
        attention_mask = batch[2] if len(batch) > 2 else None
        seq_out, _ = apply_fn(params, input_ids,
                              attention_mask=attention_mask, rng=rng)
        B, S, D = seq_out.shape
        if cfg.mlm_gather_frac:
            # the vocabulary-wide head only on scored positions: a stable
            # sort puts scored rows first, the head takes a prefix of K
            BS = B * S
            K = min(BS, int(math.ceil(cfg.mlm_gather_frac * BS / 128)) * 128)
            flat_lab = labels.reshape(BS)
            n_scored = (flat_lab != -100).sum()
            order = torch.argsort((flat_lab == -100).to(torch.int8),
                                  stable=True)[:K]
            seq_out = seq_out.reshape(BS, D)[order][None]
            labels = flat_lab[order][None]
            # positions past the cut go unscored: report how many
            hooks.record_layer_output("mlm_dropped",
                                      torch.clamp(n_scored - K, min=0))
            B, S = 1, K
        chunk = pick_ce_chunk(S, cfg.ce_chunk)
        if chunk and S > chunk:
            total = count = None
            for c0 in range(0, S, chunk):
                t, c = checkpoint(partial(_chunk_nll, params),
                                  seq_out[:, c0:c0 + chunk],
                                  labels[:, c0:c0 + chunk],
                                  use_reentrant=False)
                total = t if total is None else total + t
                count = c if count is None else count + c
        else:
            total, count = _chunk_nll(params, seq_out, labels)
        return total / torch.clamp(count, min=1)

    def init_fn(seed, device=None):
        return init_params(seed, cfg, device=device)

    apply_fn.mlm_logits = mlm_logits
    return init_fn, apply_fn, mlm_loss_fn, param_specs(cfg)


def make_bert_qa(cfg: BertConfig):
    """SQuAD-class span extraction (the reference's ``make_bert_qa``):
    returns (init_fn, apply_fn, qa_loss_fn, specs). ``qa_loss_fn(params,
    batch, rng=None)`` takes batch = (input_ids, start_positions,
    end_positions[, attention_mask]) and averages the start and end
    cross-entropies."""
    init_fn, apply_fn, _, specs = make_bert(cfg)

    def qa_init_fn(seed, device=None):
        device = torch.device("cuda" if device is None else device)
        if isinstance(seed, int):
            seed = torch.Generator(device=device).manual_seed(seed)
        params = init_fn(seed, device=device)
        params["qa"] = {
            "w": normal_drawer(seed, device)((cfg.d_model, 2),
                                             cfg.initializer_range),
            "b": torch.zeros(2, dtype=torch.float32, device=device),
        }
        return params

    def qa_loss_fn(params, batch, rng=None):
        input_ids, start_pos, end_pos = batch[0], batch[1], batch[2]
        attention_mask = batch[3] if len(batch) > 3 else None
        seq_out, _ = apply_fn(params, input_ids,
                              attention_mask=attention_mask, rng=rng)
        cdt = cfg.dtype
        logits = (seq_out @ params["qa"]["w"].to(cdt)
                  + params["qa"]["b"].to(cdt)).float()
        if attention_mask is not None:
            logits = torch.where(attention_mask[..., None] > 0, logits,
                                 torch.full_like(logits, -1e9))

        def span_nll(lg, pos):
            lse = torch.logsumexp(lg, dim=-1)
            tgt = lg.gather(-1, pos.long()[:, None])[:, 0]
            return (lse - tgt).mean()

        return 0.5 * (span_nll(logits[..., 0], start_pos)
                      + span_nll(logits[..., 1], end_pos))

    qa_specs = dict(specs)
    qa_specs["qa"] = {"w": (), "b": ()}
    return qa_init_fn, apply_fn, qa_loss_fn, qa_specs
