"""The DeepSpeed transformer layer (BERT-style), in PyTorch.

Counterpart of deeperspeed_tpu/ops/transformer/transformer.py: one
functional layer, attention -> add&norm -> GeLU MLP -> add&norm, pre- or
post-LN, over a dict of one layer's params whose names mirror the
reference layer's attributes (attn_qkvw, attn_qkvb, attn_ow, attn_ob,
attn_nw, attn_nb, inter_w, inter_b, output_w, output_b, norm_w, norm_b),
matrices (in, out) as used by ``x @ w``.

Its elementwise work dispatches through the "kernels" block: LayerNorm,
the post-LN residual-add LayerNorm and bias+GeLU (ops/fused_blocks.py).
The attention core (``_attention_core``) takes ops/flash_attention.py's
``flash_attention`` when there is no mask and no attention dropout; that
routes a short sequence to the super-tile kernel (ops/flash_static.py)
and any other to the flash kernel. With a mask or attention dropout it
computes dense attention, whose probabilities it needs.

The reference's memory knobs (``normalize_invertible``,
``attn_dropout_checkpoint``, ``gelu_checkpoint``) recompute the attention
or FFN sub-block in the backward (``torch.utils.checkpoint``);
``stochastic_mode`` keeps the whole layer with probability ``pld_theta``
(progressive layer drop). Dropout draws from ``torch.Generator``s derived
from the caller's generator or integer seed: its bits are the port's own,
not JAX's, and each sub-block builds its generator from a seed, so a
recomputation draws the same masks as the forward.
"""

import json
import math
from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from ...utils.init import normal_drawer
from ..flash_attention import attention_dispatch, flash_attention
from ..fused_blocks import add_layer_norm, bias_gelu, layer_norm

ATTN_IMPLS = ("auto", "flash", "xla")


class TransformerConfig:
    """Base config (the reference's ``TransformerConfig``)."""

    def __init__(self, batch_size=-1, hidden_size=-1, intermediate_size=-1,
                 heads=-1, attn_dropout_ratio=-1, hidden_dropout_ratio=-1,
                 num_hidden_layers=-1, initializer_range=-1):
        self.layer_id = -1
        self.batch_size = batch_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.heads = heads
        self.attn_dropout_ratio = attn_dropout_ratio
        self.hidden_dropout_ratio = hidden_dropout_ratio
        self.num_hidden_layers = num_hidden_layers
        self.initializer_range = initializer_range


def _check_interpret(interpret):
    if interpret:
        raise ValueError("interpret=True has no counterpart on CUDA: a CUDA "
                         "kernel has no interpret mode (on a CPU tensor the "
                         "kernels take their plain versions)")


class DeepSpeedTransformerConfig(TransformerConfig):
    """The reference's ``DeepSpeedTransformerConfig``: the same fields and
    defaults. ``fp16`` selects bf16 compute; ``attn_impl`` picks "flash"
    (the attention kernels; no mask, no attention dropout), "xla" (dense)
    or "auto" (see ``_attention_core``). ``interpret`` is accepted only as
    False."""

    def __init__(self, batch_size=-1, max_seq_length=-1, hidden_size=-1,
                 intermediate_size=-1, heads=-1, attn_dropout_ratio=-1,
                 hidden_dropout_ratio=-1, num_hidden_layers=-1,
                 initializer_range=-1, local_rank=-1, seed=-1, fp16=False,
                 pre_layer_norm=True, normalize_invertible=False,
                 gelu_checkpoint=False, adjust_init_range=True,
                 attn_dropout_checkpoint=False, stochastic_mode=False,
                 huggingface=False, training=True, attn_impl="auto",
                 interpret=False, layernorm_eps=1e-12):
        super().__init__(
            batch_size,
            hidden_size,
            (intermediate_size if intermediate_size > 0 else 4 * hidden_size),
            heads,
            attn_dropout_ratio,
            hidden_dropout_ratio,
            num_hidden_layers,
            initializer_range,
        )
        _check_interpret(interpret)
        self.max_seq_length = max_seq_length
        self.local_rank = local_rank
        self.seed = seed
        self.fp16 = fp16
        self.pre_layer_norm = pre_layer_norm
        self.normalize_invertible = normalize_invertible
        self.gelu_checkpoint = gelu_checkpoint
        self.adjust_init_range = adjust_init_range
        self.attn_dropout_checkpoint = attn_dropout_checkpoint
        self.stochastic_mode = stochastic_mode
        self.huggingface = huggingface
        self.training = training
        self.attn_impl = attn_impl
        self.interpret = interpret
        self.layernorm_eps = layernorm_eps

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.fp16 else torch.float32

    @classmethod
    def from_dict(cls, json_object):
        config = cls()
        for key, value in json_object.items():
            config.__dict__[key] = value
        if "intermediate_size" not in json_object and config.hidden_size > 0:
            config.intermediate_size = 4 * config.hidden_size
        _check_interpret(config.interpret)
        return config

    @classmethod
    def from_json_file(cls, json_file):
        with open(json_file, "r", encoding="utf-8") as reader:
            return cls.from_dict(json.loads(reader.read()))


# ------------------------------------------------------------------ #
# init
# ------------------------------------------------------------------ #


def init_transformer_params(seed, config: DeepSpeedTransformerConfig,
                            device=None):
    """One layer's params with the reference's shapes and scales (N(0,
    std), output projections N(0, std / sqrt(2 L)) when
    ``adjust_init_range``, biases 0, LN scales 1), fp32 on ``device``
    (default CUDA). ``seed`` as utils/init.py's ``normal_drawer`` takes
    it. The draws differ from the reference's ``jax.random`` ones; to hold
    the two packages against each other, convert the reference's params
    (models/convert.py)."""
    device = torch.device("cuda" if device is None else device)
    norm = normal_drawer(seed, device)
    H, I = config.hidden_size, config.intermediate_size
    std = config.initializer_range if config.initializer_range > 0 else 0.02
    out_std = std
    if config.adjust_init_range and config.num_hidden_layers > 0:
        out_std = std / (2.0 * config.num_hidden_layers) ** 0.5

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=device)

    return {
        "attn_qkvw": norm((H, 3 * H), std),
        "attn_qkvb": zeros(3 * H),
        "attn_ow": norm((H, H), out_std),
        "attn_ob": zeros(H),
        "attn_nw": ones(H),
        "attn_nb": zeros(H),
        "inter_w": norm((H, I), std),
        "inter_b": zeros(I),
        "output_w": norm((I, H), out_std),
        "output_b": zeros(H),
        "norm_w": ones(H),
        "norm_b": zeros(H),
    }


# ------------------------------------------------------------------ #
# building blocks
# ------------------------------------------------------------------ #


def _layer_norm(x, w, b, eps=1e-12):
    # dispatches through the "kernels" config block: the CUDA LN kernel on
    # a CUDA tensor when enabled, else the fp32-stats plain math
    return layer_norm(x, w, b, eps)


def fold_seed(seed: int, i: int) -> int:
    """A new 63-bit seed from (seed, i), the counterpart of the
    reference's ``jax.random.fold_in``/``split`` (other bits)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + (i + 1) * 0xBF58476D1CE4E5B9)
    x &= (1 << 64) - 1
    x ^= x >> 31
    return x % (1 << 63)


def _seed_of(rng):
    """An integer seed from a ``torch.Generator`` (its initial seed) or an
    int."""
    if isinstance(rng, torch.Generator):
        return rng.initial_seed()
    return int(rng)


def _generator(seed, device):
    return torch.Generator(device=device).manual_seed(seed)


def _dropout(x, ratio, gen):
    """Inverted dropout of ``x`` drawing from ``gen``; the identity when
    ``gen`` is None or ``ratio`` <= 0, as in the reference."""
    if gen is None or ratio <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - ratio
    return torch.where(keep, x / (1.0 - ratio), torch.zeros_like(x))


def _dense_attention(q, k, v, attention_mask, drop_gen, ratio):
    """(B, S, nH, Dh) dense attention: fp32 scores and softmax, the
    additive mask, dropout on the probabilities, P cast to v's dtype
    before P V (the reference's XLA path)."""
    dh = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(dh)
    if attention_mask is not None:
        s = s + attention_mask.float()
    p = torch.softmax(s, dim=-1)
    p = _dropout(p, ratio, drop_gen)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v).to(q.dtype)


def _attention_core(q, k, v, config, attention_mask, drop_gen=None):
    """(B, S, nH, Dh) -> (B, S, nH, Dh), as the reference's rules:

    the attention kernels ("flash": ``flash_attention``, which takes the
    super-tile kernel for a short sequence its gate admits) only without a
    mask and without attention dropout, which need the probabilities;
    dense otherwise. ``attn_impl="flash"`` with a mask or attention
    dropout raises. ``"auto"`` takes the kernels whenever
    ``attention_dispatch`` names one: on a Hopper CUDA tensor always (a
    short maskless sequence never gives way to dense attention there), on
    the CPU the super-tile path's plain version under kernels mode
    ``fused``."""
    impl = config.attn_impl
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {impl!r}; choose from "
                         f"{ATTN_IMPLS}")
    needs_probs = attention_mask is not None or drop_gen is not None
    if impl == "auto":
        B, S, nh, dh = q.shape
        route = attention_dispatch((B, nh, S, dh), q.dtype, q.device)
        impl = "flash" if (not needs_probs and route != "xla") else "xla"
    if impl == "flash" and needs_probs:
        raise ValueError(
            "flash attn_impl supports neither attention_mask nor attention "
            "dropout (the probs tensor is never materialized); use "
            "attn_impl='xla' (or 'auto') for masked/prob-dropout batches")
    if impl == "flash":
        return flash_attention(q, k, v, causal=False)
    return _dense_attention(q, k, v, attention_mask, drop_gen,
                            config.attn_dropout_ratio)


def _transformer_forward(params, x, config: DeepSpeedTransformerConfig,
                         attention_mask=None, rng=None, pld_theta=None):
    """One BERT layer: attn -> add&norm -> gelu MLP -> add&norm, pre- or
    post-LN (the reference's ``_transformer_forward``). ``rng``: None, a
    ``torch.Generator`` or an int seed for dropout and the layer-drop
    gate, used only when ``config.training``. With ``stochastic_mode``
    the whole layer is kept with probability ``pld_theta``, identity
    otherwise."""
    B, S, H = x.shape
    nh = config.heads
    dh = H // nh
    dtype = config.compute_dtype
    x = x.to(dtype)
    p = {k: v.to(dtype) for k, v in params.items()}
    seeds = [None] * 4
    if rng is not None and config.training:
        base = _seed_of(rng)
        seeds = [fold_seed(base, i) for i in range(4)]
    s_attn, s_hid1, s_hid2, s_gate = seeds
    eps = config.layernorm_eps
    device = x.device

    def gen(seed, ratio):
        return None if seed is None or ratio <= 0 else _generator(seed,
                                                                  device)

    def attn_block(x):
        h = (_layer_norm(x, p["attn_nw"], p["attn_nb"], eps)
             if config.pre_layer_norm else x)
        qkv = h @ p["attn_qkvw"] + p["attn_qkvb"]
        q, k, v = qkv.split(H, dim=-1)
        shp = (B, S, nh, dh)
        ctx = _attention_core(q.reshape(shp), k.reshape(shp), v.reshape(shp),
                              config, attention_mask,
                              drop_gen=gen(s_attn, config.attn_dropout_ratio))
        out = ctx.reshape(B, S, H) @ p["attn_ow"] + p["attn_ob"]
        return _dropout(out, config.hidden_dropout_ratio,
                        gen(s_hid1, config.hidden_dropout_ratio))

    def ffn_block(x):
        h = (_layer_norm(x, p["norm_w"], p["norm_b"], eps)
             if config.pre_layer_norm else x)
        # pre-bias product, so the fused kernel owns the bias add
        inter = bias_gelu(h @ p["inter_w"], p["inter_b"], approximate=False)
        out = inter @ p["output_w"] + p["output_b"]
        return _dropout(out, config.hidden_dropout_ratio,
                        gen(s_hid2, config.hidden_dropout_ratio))

    # the reference's memory knobs become recomputation of the sub-block
    if config.normalize_invertible or config.attn_dropout_checkpoint:
        attn_block = partial(checkpoint, attn_block, use_reentrant=False)
    if config.normalize_invertible or config.gelu_checkpoint:
        ffn_block = partial(checkpoint, ffn_block, use_reentrant=False)

    def full_layer(x):
        if config.pre_layer_norm:
            x = x + attn_block(x)
            return x + ffn_block(x)
        # post-LN add&norm fuses the residual add into the LN kernel
        x = add_layer_norm(attn_block(x), x, p["attn_nw"], p["attn_nb"], eps)
        return add_layer_norm(ffn_block(x), x, p["norm_w"], p["norm_b"], eps)

    if (config.stochastic_mode and pld_theta is not None
            and s_gate is not None):
        u = torch.rand((), generator=_generator(s_gate, device),
                       device=device)
        gate = (u < float(pld_theta)).to(dtype)
        return gate * full_layer(x) + (1 - gate) * x
    return full_layer(x)


def transformer_layer_fn(config: DeepSpeedTransformerConfig):
    """The layer function for a config:
    ``fn(params, x, attention_mask=None, rng=None, pld_theta=None)``."""
    return partial(_transformer_forward, config=config)


# --- reference-layer weights -> param dict -------------------------------
# The reference layer's weight order: q, k, v, attn_out, attn_norm,
# intermediate, output, norm; torch tensors in (out, in) orientation, ours
# (in, out).


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().float()


def weights_to_params(weights) -> dict:
    qw, kw, vw, ow, nw1, iw, out_w, nw2 = [_f32(w) for w in weights]
    return {
        "attn_qkvw": torch.cat([qw.T, kw.T, vw.T], dim=1),
        "attn_ow": ow.T.contiguous(),
        "attn_nw": nw1,
        "inter_w": iw.T.contiguous(),
        "output_w": out_w.T.contiguous(),
        "norm_w": nw2,
    }


def biases_to_params(biases) -> dict:
    qb, kb, vb, ob, nb1, ib, out_b, nb2 = [_f32(b) for b in biases]
    return {
        "attn_qkvb": torch.cat([qb, kb, vb]),
        "attn_ob": ob,
        "attn_nb": nb1,
        "inter_b": ib,
        "output_b": out_b,
        "norm_b": nb2,
    }


class DeepSpeedTransformerLayer:
    """The reference's ``DeepSpeedTransformerLayer``: a functional layer
    (``init``/``apply``). ``init`` places params on CUDA unless given a
    device."""

    layer_id = 0

    def __init__(self, config: DeepSpeedTransformerConfig,
                 initial_weights=None, initial_biases=None):
        self.config = config
        self.config.layer_id = DeepSpeedTransformerLayer.layer_id
        DeepSpeedTransformerLayer.layer_id += 1
        self._initial = (initial_weights, initial_biases)

    def init(self, seed, device=None):
        params = init_transformer_params(seed, self.config, device=device)
        weights, biases = self._initial
        dev = next(iter(params.values())).device
        if weights is not None:
            params.update({k: v.to(dev)
                           for k, v in weights_to_params(weights).items()})
        if biases is not None:
            params.update({k: v.to(dev)
                           for k, v in biases_to_params(biases).items()})
        return params

    def apply(self, params, x, rng=None, attention_mask=None, pld_theta=None):
        return transformer_layer_fn(self.config)(
            params, x, attention_mask=attention_mask, rng=rng,
            pld_theta=pld_theta)

    __call__ = apply
