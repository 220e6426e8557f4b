"""GPT / GPT-NeoX decoder-only transformer in PyTorch.

Counterpart of deeperspeed_tpu/models/gpt.py. Parameters keep the
reference's layout so weights carry across by copy (models/convert.py):
a plain dict of tensors whose per-layer tensors are STACKED on a leading
layer axis, and whose matrices are (in, out), used as ``x @ w``. The
forward walks the layer axis with a Python loop where the reference scans.

Supports GPT-2 (learned positions, serial residual) and GPT-NeoX (rotary,
parallel attention+MLP residual) variants, with grouped-query attention.
``make_gpt`` gives the training loss (streaming or fused cross-entropy)
with per-layer activation checkpointing: remat policy ``"full"``
(``torch.utils.checkpoint``), or ``"flash"``, ``"matmuls"``, ``"dots"``
and ``"dots_all"`` (selective checkpointing, ``REMAT_SAVED``).
Attention goes through the flash kernels (ops/flash_attention.py) or the
plain dense computation, as ``attn_impl`` says (``causal_attention``).
With ``moe_num_experts`` each layer's FFN is a Mixture-of-Experts
(models/moe.py, the ``layers/moe`` subtree in place of ``mlp``), its
experts split over a mesh's ``expert`` axis (``make_gpt(cfg, mesh)``).

Tensor and sequence parallelism (``make_gpt(cfg, mesh)`` on a mesh with a
live ``model``/``tp`` or ``seq``/``sp`` axis): each rank holds its part of
the leaves ``param_specs`` splits over the tensor-parallel axis
(``shard_params``; the fused qkv projection by heads of q, k and v, a
``rules.SectionSpec``), and the forward places Megatron's f and g
(parallel/tp.py) where GSPMD places the reference's collectives: f on the
input of each column-parallel matmul (qkv, FFN in, the untied head), one
g on the row-parallel outputs of a layer (attention out plus FFN out
under the parallel residual, one each under the serial one), the
embedding's columns all-gathered, and the untied head's cross-entropy
vocab-parallel (each rank's logsumexp gathered, the target logit summed;
``_VocabParallelNLL``). Under sequence parallelism each rank takes its
``S/sp`` tokens of every row (rotary positions offset to match), attends
with ring or Ulysses attention (ops/ring_attention.py, ``attn_impl``
"ring"/"ulysses"), and the loss is the mean over the global tokens (its
per-rank shares summed over the axis by a g).
"""

import dataclasses
import math
from functools import partial
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops import fused_blocks
from ..ops.flash_attention import FLASH_FWD_OP, flash_attention
from ..ops.flash_static import SUPERTILE_FWD_OP
from ..ops.kernel_config import on_hopper
from ..parallel.tp import (copy_to_tp_region, gather_from_tp_region,
                           reduce_from_tp_region, scatter_to_tp_region,
                           shard_tree, sp_transport, tp_transport)
from ..sharding import rules
from ..sharding.mesh import MODEL_AXIS, active_mesh
from ..utils import hooks
from ..utils.init import normal_drawer


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304
    n_layer: int = 12
    n_head: int = 12
    # grouped-query attention: number of K/V heads (0 = n_head = classic
    # MHA; 1 = MQA)
    n_kv_head: int = 0
    d_model: int = 768
    d_ff: int = 0  # 0 => 4 * d_model
    max_seq: int = 1024
    rotary: bool = True  # NeoX-style rotary; False => learned positions
    rotary_pct: float = 1.0
    parallel_residual: bool = True  # NeoX parallel attn+mlp
    layernorm_eps: float = 1e-5
    tie_embeddings: bool = False
    # activation checkpointing of each layer in make_gpt's loss: 'full'
    # replays the whole layer in the backward; 'matmuls' keeps every
    # projection output and the flash o/lse and replays only the cheap
    # elementwise work (see _remat_step). The reference's 'flash', 'dots'
    # and 'dots_all' validate here and raise in make_gpt (not ported).
    remat: bool = True
    remat_policy: str = "full"
    dtype: Any = torch.bfloat16  # compute dtype for activations
    # 'auto' (flash kernel on a Hopper CUDA tensor, raising on a head dim or
    # dtype it does not take; else dense) | 'pallas'
    # (always the flash path) | 'pallas_interpret' (the flash path's plain
    # version, CPU tensors) | 'xla' (dense); see causal_attention |
    # 'ring' | 'ulysses' (the context-parallel paths over the mesh's
    # sequence axis; make_gpt wires them)
    attn_impl: str = "auto"
    # streaming cross-entropy chunk (pick_ce_chunk); 0 = one fused pass
    ce_chunk: int = 128
    # an expert-parallel MoE (models/moe.py) of this many experts, sharded
    # over the mesh's 'expert' axis, replaces each layer's dense FFN
    moe_num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    moe_z_coef: float = 1e-3
    moe_dispatch_impl: str = "auto"
    moe_normalize_gates: bool = False
    moe_ep_buffer_factor: float = 2.0

    @property
    def moe(self):
        if not self.moe_num_experts:
            return None
        from .moe import MoEConfig

        return MoEConfig(
            num_experts=self.moe_num_experts,
            top_k=self.moe_top_k,
            capacity_factor=self.moe_capacity_factor,
            aux_loss_coef=self.moe_aux_coef,
            z_loss_coef=self.moe_z_coef,
            dispatch_impl=self.moe_dispatch_impl,
            normalize_gates=self.moe_normalize_gates,
            ep_buffer_factor=self.moe_ep_buffer_factor,
        )

    def __post_init__(self):
        kv = self.n_kv_head or self.n_head
        if self.n_head % kv:
            raise ValueError(
                f"n_head ({self.n_head}) must be a multiple of n_kv_head "
                f"({kv})"
            )
        if self.remat_policy not in ("full", "flash", "matmuls", "dots",
                                     "dots_all"):
            raise ValueError(
                f"remat_policy must be 'full', 'flash', 'matmuls', 'dots', "
                f"or 'dots_all', got {self.remat_policy!r}"
            )
        if self.attn_impl not in _ATTN_IMPLS:
            raise ValueError(
                f"attn_impl {self.attn_impl!r} is not ported; the PyTorch "
                f"package takes {_ATTN_IMPLS}")
        if not isinstance(self.dtype, torch.dtype):
            raise TypeError(f"dtype must be a torch.dtype, got {self.dtype!r}")

    @property
    def ffn_dim(self):
        return self.d_ff if self.d_ff else 4 * self.d_model

    @property
    def head_dim(self):
        if self.d_model % self.n_head:
            raise ValueError(f"d_model ({self.d_model}) must be a multiple "
                             f"of n_head ({self.n_head})")
        return self.d_model // self.n_head

    @property
    def kv_heads(self):
        return self.n_kv_head or self.n_head  # validated in __post_init__

    @property
    def qkv_dim(self):
        """Width of the fused qkv projection: H*Dh + 2*Hkv*Dh."""
        return (self.n_head + 2 * self.kv_heads) * self.head_dim


_ATTN_IMPLS = ("auto", "pallas", "pallas_interpret", "xla", "ring",
               "ulysses")


# ------------------------------------------------------------------ #
# init
# ------------------------------------------------------------------ #


def _layer_norm_key(path: str) -> bool:
    return path.startswith("final_ln/") or "/ln1_" in path or "/ln2_" in path


def cast_params(params: Dict, dtype: torch.dtype) -> Dict:
    """Cast every leaf to ``dtype`` except the layer-norm scales and
    biases, which stay fp32 as the reference keeps them (its forward casts
    the other leaves to the compute dtype at use; storing them in it once
    saves that cast on every call)."""
    def walk(tree, prefix):
        return {k: (walk(v, f"{prefix}{k}/") if isinstance(v, dict)
                    else v if _layer_norm_key(f"{prefix}{k}") else v.to(dtype))
                for k, v in tree.items()}

    return walk(params, "")


def param_shapes(cfg: GPTConfig) -> Dict:
    """The params tree with each leaf's shape: the reference's layout."""
    D, F, L, V = cfg.d_model, cfg.ffn_dim, cfg.n_layer, cfg.vocab_size
    shapes = {
        "embed": {"wte": (V, D)},
        "layers": {
            "ln1_scale": (L, D),
            "ln1_bias": (L, D),
            "ln2_scale": (L, D),
            "ln2_bias": (L, D),
            "attn": {"wqkv": (L, D, cfg.qkv_dim), "bqkv": (L, cfg.qkv_dim),
                     "wo": (L, D, D), "bo": (L, D)},
            "mlp": {"wi": (L, D, F), "bi": (L, F),
                    "wo": (L, F, D), "bo": (L, D)},
        },
        "final_ln": {"scale": (D,), "bias": (D,)},
    }
    if cfg.moe_num_experts:
        # the reference's layers/moe subtree (models/moe.py
        # init_moe_params, stacked on the layer axis) replaces the mlp
        E = cfg.moe_num_experts
        shapes["layers"]["moe"] = {
            "router": {"wg": (L, D, E)},
            "experts": {"wi": (L, E, D, F), "bi": (L, E, F),
                        "wo": (L, E, F, D), "bo": (L, E, D)},
        }
        del shapes["layers"]["mlp"]
    if not cfg.rotary:
        shapes["embed"]["wpe"] = (cfg.max_seq, D)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (D, V)
    return shapes


def param_specs(cfg: GPTConfig):
    """The params tree with each leaf's placement spec (one entry a dim:
    None or a mesh axis), the reference's: Megatron's column/row split
    over the ``model`` axis (qkv and FFN-in column-parallel, attention-out
    and FFN-out row-parallel, ``wte`` split over d_model, the untied head
    over the vocabulary), the expert leaves of an MoE model on the
    ``expert`` axis. The fused qkv leaves are ``rules.SectionSpec``s: a
    rank's part is its heads of q, of k and of v."""
    M = MODEL_AXIS
    Dh = cfg.head_dim
    qkv = (cfg.n_head * Dh, cfg.kv_heads * Dh, cfg.kv_heads * Dh)
    specs = {
        "embed": {"wte": (None, M)},
        "layers": {
            "ln1_scale": (None, None),
            "ln1_bias": (None, None),
            "ln2_scale": (None, None),
            "ln2_bias": (None, None),
            "attn": {
                "wqkv": rules.SectionSpec((None, None, M), qkv),
                "bqkv": rules.SectionSpec((None, M), qkv),
                "wo": (None, M, None),
                "bo": (None, None),
            },
            "mlp": {
                "wi": (None, None, M),
                "bi": (None, M),
                "wo": (None, M, None),
                "bo": (None, None),
            },
        },
        "final_ln": {"scale": (None,), "bias": (None,)},
    }
    if cfg.moe_num_experts:
        from .moe import moe_param_specs

        # the stacked layer axis prepended to every expert/router spec
        specs["layers"]["moe"] = {
            group: {k: (None,) + spec for k, spec in leaves.items()}
            for group, leaves in moe_param_specs().items()}
        del specs["layers"]["mlp"]
    if not cfg.rotary:
        specs["embed"]["wpe"] = (None, None)
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, M)
    return specs


def shard_params(cfg: GPTConfig, params: Dict, mesh) -> Dict:
    """This rank's part of WHOLE params (the reference's layout) on
    ``mesh``: each leaf that ``param_specs`` splits over a live model axis
    cut by ``rules.model_cut``, the rule the engine's checkpoint load
    uses; every other leaf as it is."""
    check_tp_shapes(cfg, mesh)
    return shard_tree(params, param_specs(cfg), mesh)


def check_tp_shapes(cfg: GPTConfig, mesh) -> int:
    """The mesh's tensor-parallel size, after refusing a model whose
    shapes it does not divide (the reference's GSPMD shapes would fail
    there too), naming the reason."""
    tp = rules.tp_size(mesh)
    if tp <= 1:
        return 1
    why = None
    if cfg.n_head % tp:
        why = f"n_head ({cfg.n_head}) is not a multiple of it"
    elif cfg.kv_heads % tp:
        why = (f"the K/V heads ({cfg.kv_heads}) are fewer than, or not a "
               f"multiple of, its ranks: each rank needs whole K/V heads")
    elif cfg.ffn_dim % tp:
        why = f"d_ff ({cfg.ffn_dim}) is not a multiple of it"
    elif not cfg.tie_embeddings and cfg.vocab_size % tp:
        why = (f"the untied head's vocabulary ({cfg.vocab_size}) is not a "
               f"multiple of it")
    elif cfg.moe_num_experts:
        why = ("a Mixture-of-Experts model does not take tensor "
               "parallelism in the port (ROADMAP.md section 1, item 11)")
    if why is not None:
        raise ValueError(f"tensor parallelism over {tp} ranks: {why}")
    return tp


def init_params(seed, cfg: GPTConfig, device=None,
                dtype: Optional[torch.dtype] = None) -> Dict:
    """Initial params with the reference's shapes and std (N(0, 0.02),
    output projections N(0, 0.02 / sqrt(2 L)), layer-norm scales 1,
    biases 0), per-layer tensors stacked on axis 0, fp32.

    ``seed``: as ``normal_drawer`` takes it. ``device`` defaults to CUDA.
    ``dtype`` casts the result with ``cast_params``. The draws differ from
    the reference's ``jax.random`` ones; to hold the two packages against
    each other, convert the reference's params with models/convert.py."""
    device = torch.device("cuda" if device is None else device)
    std = 0.02
    out_std = std / math.sqrt(2.0 * cfg.n_layer)
    norm = normal_drawer(seed, device)

    def init(path, shape):
        name = path.rsplit("/", 1)[-1]
        if name in ("scale", "ln1_scale", "ln2_scale"):
            return torch.ones(shape, dtype=torch.float32, device=device)
        if name.startswith("b") or name.endswith("_bias"):
            return torch.zeros(shape, dtype=torch.float32, device=device)
        # output projections scaled by 1/sqrt(2L) (GPT-2/NeoX convention)
        return norm(shape, out_std if name == "wo" else std)

    def walk(tree, prefix):
        return {k: walk(v, f"{prefix}{k}/") if isinstance(v, dict)
                else init(f"{prefix}{k}", v) for k, v in tree.items()}

    params = walk(param_shapes(cfg), "")
    return cast_params(params, dtype) if dtype is not None else params


def layer_slices(params: Dict, n_layer: int) -> List[Dict]:
    """Views of the stacked ``params["layers"]`` tree, one dict per layer.
    Each stacked leaf is split once with ``unbind``, so under autograd the
    per-layer gradients are stacked back by one op (indexing layer by
    layer would build a full-size zero gradient for every layer)."""
    def split(tree):
        return {k: split(v) if isinstance(v, dict) else v.unbind(0)
                for k, v in tree.items()}

    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    parts = split(params["layers"])
    return [pick(parts, i) for i in range(n_layer)]


# ------------------------------------------------------------------ #
# building blocks
# ------------------------------------------------------------------ #


def layer_norm(x, scale, bias, eps):
    # dispatches through the "kernels" config block: the CUDA LN kernel
    # when enabled on a CUDA tensor, else the fp32-stats plain math
    return fused_blocks.layer_norm(x, scale, bias, eps)


def layer_norm2(x, scale1, bias1, scale2, bias2, eps):
    """Two layernorms of the SAME input (the NeoX parallel-residual block
    applies ln1 and ln2 both to x): mean/var are computed once and only
    the affine differs. Plain PyTorch, as in the reference."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return ((y * scale1 + bias1).to(x.dtype),
            (y * scale2 + bias2).to(x.dtype))


def rotary_embedding(x, positions, rotary_dims):
    """Apply rotary position embedding to the first rotary_dims of head_dim.

    x: (B, S, H, Dh); positions: (S,) shared across the batch, or (B, S)
    per-row absolute positions (batched cache decode, where rows sit at
    different offsets)."""
    rot, rest = x[..., :rotary_dims], x[..., rotary_dims:]
    half = rotary_dims // 2
    freq = torch.exp(
        -math.log(10000.0)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = positions[..., None].float() * freq  # (..., S, half)
    if positions.dim() == 1:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = rot[..., :half], rot[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    if rest.shape[-1]:
        return torch.cat([rotated, rest], dim=-1)
    return rotated


def dense_causal_attention(q, k, v):
    """Dense causal attention, (B, S, H, Dh); fp32 scores and softmax
    (the reference's ``_xla_causal_attention``)."""
    dh = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(dh)
    s_q, s_k = q.shape[1], k.shape[1]
    mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _auto_takes_flash(device: torch.device) -> bool:
    return on_hopper(device)


def causal_attention(q, k, v, impl="auto"):
    """Causal attention on (B, S, H, Dh), dispatched by ``impl``:

    ``"auto"``: ``flash_attention`` for every CUDA tensor on Hopper, at
    every S (the reference's S > 256 cutoff was measured on a TPU). There
    a sequence shorter than 256 that the super-tile gate admits takes the
    super-tile kernel when the "kernels" config routes its ``supertile``
    surface (ops/flash_static.py), as the reference's ``gpt.py`` sends
    S < 256 to its super-tile kernel; every other call the flash kernel. A
    head dim or dtype the kernel does not take raises there rather than
    giving way to dense attention, so such a model picks ``"xla"`` itself.
    Elsewhere (a CPU tensor, another card) dense.
    ``"pallas"``: always the flash path (a CPU tensor takes its plain
    version). ``"pallas_interpret"``: the flash path's plain version, the
    counterpart of the reference's interpret-mode Pallas; CPU tensors
    only. ``"xla"``: dense."""
    if impl not in _ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {impl!r}; the PyTorch package "
                         f"takes {_ATTN_IMPLS}")
    if impl in ("ring", "ulysses"):
        raise ValueError(
            f"attn_impl {impl!r} is context-parallel and needs a mesh; use "
            "ops.ring_attention.make_context_parallel_attention (make_gpt "
            "wires it when given a mesh)")
    if impl == "pallas_interpret" and q.device.type != "cpu":
        raise ValueError("attn_impl 'pallas_interpret' is the CPU test path; "
                         "use 'pallas' or 'auto' on a CUDA tensor")
    flash = impl in ("pallas", "pallas_interpret") or (
        impl == "auto" and _auto_takes_flash(q.device))
    if flash:
        return flash_attention(q, k, v, causal=True)
    return dense_causal_attention(q, k, v)


def expand_kv_heads(q, k, v):
    """GQA: repeat K/V heads to match Q's head count (q head i attends to
    kv head i // rep). The decode path avoids this with a grouped einsum
    (models/generation.py)."""
    if k.shape[2] != q.shape[2]:
        rep = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return k, v


# ------------------------------------------------------------------ #
# forward
# ------------------------------------------------------------------ #


def decoder_block(cfg: GPTConfig, x, layer_params, positions, attend,
                  mlp_fn=None, tp=None):
    """One decoder layer shared by the full forward (``apply``), KV-cache
    decoding (models/generation.py) and serving (serving/engine.py):
    qkv projection, rotary, residual/MLP wiring.

    ``attend(q, k, v) -> (ctx, aux)`` supplies the attention core.
    ``mlp_fn(mlp_in) -> (mlp_out, aux2)`` overrides the dense FFN; with it,
    aux is (attend_aux, aux2). A layer with a ``moe`` subtree and no
    ``mlp_fn`` takes ``moe_ffn`` (models/moe.py) on the active mesh: the
    decode paths' MoE FFN, as the reference's generation and serving steps
    pass it. ``tp`` (the tensor-parallel axis's Transport; None: one
    rank) means ``layer_params`` hold this rank's part, the reference's
    GSPMD placement of ``param_specs`` written out: its ``n_head / tp``
    heads and ``d_ff / tp`` FFN columns, f on the inputs of the
    column-parallel matmuls (qkv, FFN in), g on the row-parallel outputs
    (attention out, FFN out: under the parallel residual one g on their
    sum, g being linear), each bias added once, after g. Returns
    (x_out, aux)."""
    cdt = cfg.dtype
    B, S, D = x.shape
    n = tp.size if tp is not None else 1
    H, Hkv, Dh = cfg.n_head // n, cfg.kv_heads // n, cfg.head_dim
    mlp_in_shared = None
    if cfg.parallel_residual:
        # ln1(x) and ln2(x) normalize the SAME x — share the mean/var pass
        attn_in, mlp_in_shared = layer_norm2(
            x, layer_params["ln1_scale"], layer_params["ln1_bias"],
            layer_params["ln2_scale"], layer_params["ln2_bias"],
            cfg.layernorm_eps,
        )
    else:
        attn_in = layer_norm(
            x, layer_params["ln1_scale"], layer_params["ln1_bias"],
            cfg.layernorm_eps,
        )
    attn_p = layer_params["attn"]
    qkv = (copy_to_tp_region(attn_in, tp) @ attn_p["wqkv"].to(cdt)
           + attn_p["bqkv"].to(cdt))
    q = qkv[..., : H * Dh].reshape(B, S, H, Dh)
    k = qkv[..., H * Dh: (H + Hkv) * Dh].reshape(B, S, Hkv, Dh)
    v = qkv[..., (H + Hkv) * Dh:].reshape(B, S, Hkv, Dh)
    if cfg.rotary:
        rd = int(cfg.rotary_pct * Dh) // 2 * 2
        q = rotary_embedding(q, positions, rd)
        k = rotary_embedding(k, positions, rd)
    ctx, aux = attend(q, k, v)
    attn_part = ctx.reshape(B, S, H * Dh) @ attn_p["wo"].to(cdt)

    if cfg.parallel_residual:
        mlp_in = mlp_in_shared
    else:
        x = x + (reduce_from_tp_region(attn_part, tp) + attn_p["bo"].to(cdt))
        mlp_in = layer_norm(
            x, layer_params["ln2_scale"], layer_params["ln2_bias"],
            cfg.layernorm_eps,
        )
    if mlp_fn is None and "moe" in layer_params:
        from .moe import moe_ffn

        mlp_fn = partial(moe_ffn, layer_params["moe"], cfg=cfg.moe)
    if mlp_fn is not None:
        mlp_out, aux2 = mlp_fn(mlp_in)
        aux = (aux, aux2)
        if cfg.parallel_residual:
            return x + (attn_part + attn_p["bo"].to(cdt)) + mlp_out, aux
        return x + mlp_out, aux
    mlp_p = layer_params["mlp"]
    h = copy_to_tp_region(mlp_in, tp) @ mlp_p["wi"].to(cdt)
    h = fused_blocks.bias_gelu(h, mlp_p["bi"].to(cdt), approximate=True)
    mlp_part = h @ mlp_p["wo"].to(cdt)
    if cfg.parallel_residual and n > 1:
        out = reduce_from_tp_region(attn_part + mlp_part, tp)
        return x + (out + attn_p["bo"].to(cdt) + mlp_p["bo"].to(cdt)), aux
    mlp_out = reduce_from_tp_region(mlp_part, tp) + mlp_p["bo"].to(cdt)
    if cfg.parallel_residual:
        return x + (attn_part + attn_p["bo"].to(cdt)) + mlp_out, aux
    return x + mlp_out, aux


def embed(cfg: GPTConfig, params, tokens, positions, tp=None,
          rows_first: bool = False):
    """The token (and learned-position) embeddings of ``tokens`` in the
    compute dtype; with ``tp``, ``wte`` holds this rank's d_model columns
    and the columns are all-gathered (split in the backward).
    ``rows_first`` gathers the rows and then casts them (the decode paths:
    no cast of the whole table a call)."""
    cdt = cfg.dtype
    wte = params["embed"]["wte"]
    x = (wte[tokens.long()].to(cdt) if rows_first
         else F.embedding(tokens.long(), wte.to(cdt)))
    x = gather_from_tp_region(x, tp)
    if not cfg.rotary:
        x = x + params["embed"]["wpe"][positions].to(cdt).reshape(
            (-1,) + tuple(x.shape[1:]))
    return x


def logits_of(cfg: GPTConfig, params, x, tp=None):
    """The head's logits (..., V) of hidden states ``x``; with ``tp`` each
    rank's part is combined: the untied head's vocabulary columns
    all-gathered, the tied head's d_model partial products summed."""
    if tp is None or tp.size <= 1:
        return x @ head_weight(cfg, params)
    if cfg.tie_embeddings:
        part = scatter_to_tp_region(x, tp) @ head_weight(cfg, params)
        return reduce_from_tp_region(part, tp)
    return gather_from_tp_region(
        copy_to_tp_region(x, tp) @ head_weight(cfg, params), tp)


def head_weight(cfg: GPTConfig, params):
    if cfg.tie_embeddings:
        return params["embed"]["wte"].to(cfg.dtype).T
    return params["lm_head"].to(cfg.dtype)


@torch.no_grad()
def apply(cfg: GPTConfig, params, tokens, mesh=None):
    """tokens (B, S) int -> logits (B, S, V): the reference's
    ``make_gpt(cfg)[1]``. On a ``mesh`` with a live tensor-parallel axis
    ``params`` are this rank's part and every rank gets the whole
    logits."""
    tp = tp_transport(mesh)
    S = tokens.shape[1]
    tokens = tokens.long()
    positions = torch.arange(S, device=tokens.device)
    x = embed(cfg, params, tokens, positions, tp, rows_first=True)

    def attend(q, k, v):
        k, v = expand_kv_heads(q, k, v)
        return causal_attention(q, k, v, cfg.attn_impl), None

    for layer_params in layer_slices(params, cfg.n_layer):
        x, _ = decoder_block(cfg, x, layer_params, positions, attend, tp=tp)
    x = layer_norm(x, params["final_ln"]["scale"], params["final_ln"]["bias"],
                   cfg.layernorm_eps)
    return logits_of(cfg, params, x, tp)


# ------------------------------------------------------------------ #
# training: loss with activation checkpointing
# ------------------------------------------------------------------ #


def pick_ce_chunk(S: int, chunk: int) -> int:
    """Streaming-CE chunk for sequence length S: the configured chunk when
    it divides S, else the largest divisor of S not above it; 0 (one fused
    pass) when chunking is off, S fits one chunk, or the divisor would
    fall below 32. The reference's rule, unchanged."""
    if not chunk or S <= chunk:
        return 0
    if S % chunk:
        chunk = next(c for c in range(min(chunk, S), 0, -1) if S % c == 0)
        if chunk < 32:
            return 0
    return chunk


# the ops whose outputs each selective remat policy keeps (the reference's
# table, models/gpt.py's jax.checkpoint policies):
# - "flash": the attention kernel's o and lse (flash or super-tile), as
#   save_only_these_names("flash_o", "flash_lse");
# - "matmuls": those and every projection (a 2-D mm once matmul folds the
#   batch). Eager recomputation replays a layer from its start, so an op
#   upstream of a kept tensor still runs unless it is kept too; keeping
#   the projections themselves (not only the reference's post-rotary
#   q/k/v and pre-GeLU activations) leaves only layer norm, rotary,
#   bias+GeLU and the residual adds to replay, as the reference's policy
#   does;
# - "dots": the products without batch dimensions, the projections
#   (dots_with_no_batch_dims_saveable);
# - "dots_all": every product, the batched ones of dense attention too
#   (dots_saveable).
# JAX's dots policies match dot_general, never a pallas_call: under "dots"
# and "dots_all" the reference recomputes the flash forward in the
# backward, and so does the port.
_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_BMM = (torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)
_ATTN = (FLASH_FWD_OP, SUPERTILE_FWD_OP)
REMAT_SAVED = {
    "flash": _ATTN,
    "matmuls": _MM + _ATTN,
    "dots": _MM,
    "dots_all": _MM + _BMM,
}


def _saving_policy(saved):
    def policy(ctx, op, *args, **kwargs):
        if op in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def _remat_step(cfg: GPTConfig, fn):
    """``fn(x, layer_params)`` wrapped as ``cfg.remat``/``remat_policy``
    say: per-layer ``torch.utils.checkpoint`` ("full") or selective
    checkpointing that keeps the outputs of the policy's ops in
    ``REMAT_SAVED``."""
    if not cfg.remat:
        return fn
    if cfg.remat_policy == "full":
        return lambda x, lp: checkpoint(fn, x, lp, use_reentrant=False)
    context = partial(create_selective_checkpoint_contexts,
                      _saving_policy(REMAT_SAVED[cfg.remat_policy]))
    return lambda x, lp: checkpoint(fn, x, lp, use_reentrant=False,
                                    context_fn=context)


def _chunk_nll(xc, tc, w):
    logits = (xc @ w).float()
    tgt = logits.gather(-1, tc[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - tgt).sum()


class _VocabParallelNLL(torch.autograd.Function):
    """The summed next-token NLL of hidden states ``xc`` (B, c, D) under
    the untied head's vocabulary columns ``w`` (D, V/tp) of this rank
    (the ones from ``v0``): each rank's logsumexp over its columns is
    all-gathered and combined, and the target logits (on the rank whose
    columns hold them) summed over the group, so every rank gets the
    reference's loss without the whole logits. The backward recomputes
    this rank's logits (as the chunked loss's checkpoint does), takes
    softmax minus the one-hot of its columns, and gives this rank's share
    of ``xc``'s grad (the f before the head sums the shares) and its
    columns' grad; it needs no collective."""

    @staticmethod
    def forward(ctx, xc, w, tc, group, v0):
        logits = (xc @ w).float()
        lse_parts = group.all_gather(torch.logsumexp(logits, dim=-1))
        lse = torch.logsumexp(lse_parts, dim=0)
        local = tc - v0
        mine = (local >= 0) & (local < w.shape[1])
        idx = local.clamp(0, w.shape[1] - 1)
        tgt = logits.gather(-1, idx[..., None])[..., 0] * mine
        tgt = group.all_reduce_sum(tgt)
        ctx.save_for_backward(xc, w, lse, idx, mine)
        return (lse - tgt).sum()

    @staticmethod
    def backward(ctx, g):
        xc, w, lse, idx, mine = ctx.saved_tensors
        p = torch.exp((xc @ w).float() - lse[..., None])
        p.scatter_add_(-1, idx[..., None], -mine[..., None].to(p.dtype))
        d = (p * g).to(xc.dtype)
        dx = d @ w.transpose(0, 1)
        dw = xc.reshape(-1, xc.shape[-1]).transpose(0, 1) @ d.reshape(
            -1, d.shape[-1])
        return dx, dw, None, None, None


class _Parallel:
    """What one mesh gives the model: the tensor-parallel group, the
    sequence-parallel group with this rank's place on it, and the
    attention core (context-parallel over ``sp`` when ``attn_impl`` asks
    for it). The groups are the mesh's own (``Mesh.transport``), made on
    first use: ``new_group`` is collective, so every rank first builds
    this in the same order."""

    def __init__(self, cfg: GPTConfig, mesh):
        check_tp_shapes(cfg, mesh)
        self.tp = tp_transport(mesh)
        self.sp = sp_transport(mesh)
        self.sp_size = self.sp.size if self.sp is not None else 1
        self.sp_rank = self.sp.rank if self.sp is not None else 0
        cp = None
        if cfg.attn_impl in ("ring", "ulysses"):
            from ..ops.ring_attention import make_context_parallel_attention

            # raises without a live sequence axis: never quietly dense
            cp = make_context_parallel_attention(mesh, cfg.attn_impl)
        elif self.sp_size > 1:
            raise ValueError(
                f"the mesh {mesh.shape} splits the sequence over "
                f"{self.sp_size} ranks: set attn_impl 'ring' or 'ulysses' "
                f"(attention over a split sequence is context-parallel)")

        def attend(q, k, v):
            k, v = expand_kv_heads(q, k, v)
            if cp is not None:
                return cp(q, k, v), None
            return causal_attention(q, k, v, cfg.attn_impl), None

        self.attend = attend

    def local_tokens(self, t):
        """This rank's chunk of the sequence dim of ``t`` (B, S)."""
        if self.sp_size == 1:
            return t
        S = t.shape[1]
        if S % self.sp_size:
            raise ValueError(f"a sequence of {S} tokens does not split over "
                             f"{self.sp_size} sequence-parallel ranks")
        n = S // self.sp_size
        return t[:, self.sp_rank * n:(self.sp_rank + 1) * n]


def make_gpt(cfg: GPTConfig, mesh=None):
    """Returns (init_fn, apply_fn, loss_fn, specs), as the reference's
    ``make_gpt``.

    init_fn(seed, device=None, dtype=None) -> params (``init_params``)
    apply_fn(params, tokens) -> logits (B, S, V) (no grad)
    loss_fn(params, batch) -> mean next-token cross-entropy, plus the MoE
    layers' summed auxiliary loss (``moe_loss``), fp32 scalar;
    batch = tokens (B, S+1) or (inputs, targets) (B, S) each.
    specs: ``param_specs(cfg)`` (hand them to ``initialize(..., mesh=,
    param_specs=)``). ``mesh`` (parallel/topology.build_mesh, or the
    engine's) gives the layers their collectives: with a live ``model``
    (tp) axis ``params`` are this rank's part (``shard_params``; the
    engine cuts them itself), with a live ``seq`` (sp) axis each rank
    computes its chunk of every row's tokens and the loss is the global
    mean, with an ``expert`` axis each rank runs its experts. Without one
    the layers take the running engine's (``active_mesh``). attn_impl
    "ring"/"ulysses" needs ``mesh``."""
    if cfg.attn_impl in ("ring", "ulysses") and mesh is None:
        raise ValueError(
            f"attn_impl={cfg.attn_impl!r} is a context-parallel strategy "
            "and needs a mesh with a 'seq' axis; pass mesh= to make_gpt")
    moe_cfg = cfg.moe
    # new_group is collective: every rank builds the groups here
    fixed = _Parallel(cfg, mesh) if mesh is not None else None
    if mesh is not None and moe_cfg is not None:
        from .moe import groups

        groups(mesh)

    def layer(x, layer_params, positions, par, layer_mesh=None):
        """-> (x, this layer's scalar MoE auxiliary loss; 0 when dense)."""
        if moe_cfg is None:
            return decoder_block(cfg, x, layer_params, positions,
                                 par.attend, tp=par.tp)[0]
        from .moe import moe_ffn, moe_loss

        def mlp_fn(mlp_in):
            return moe_ffn(layer_params["moe"], mlp_in, moe_cfg,
                           mesh=layer_mesh)

        x, (_, moe_aux) = decoder_block(cfg, x, layer_params, positions,
                                        par.attend, mlp_fn=mlp_fn)
        return x, moe_loss(moe_aux, moe_cfg)

    def hidden_fn(params, tokens, layer_mesh, par):
        """tokens (B, S_local) int -> final-layernormed hidden states."""
        tokens = tokens.long()
        S = tokens.shape[1]
        positions = (torch.arange(S, device=tokens.device)
                     + par.sp_rank * S)
        x = embed(cfg, params, tokens, positions, par.tp)
        # the mesh is bound here: a remat replay in the backward runs
        # outside the engine's use_mesh context
        step = _remat_step(cfg, partial(
            layer, positions=positions, par=par, layer_mesh=layer_mesh))
        moe_aux = None
        for i, layer_params in enumerate(layer_slices(params, cfg.n_layer)):
            x = step(x, layer_params)
            if moe_cfg is not None:
                x, aux = x
                moe_aux = aux if moe_aux is None else moe_aux + aux
            # the layer-output tap (utils/hooks.py): free unless a collector
            # is active
            x = hooks.record_layer_output("transformerlayer", x, i)
        x = layer_norm(x, params["final_ln"]["scale"],
                       params["final_ln"]["bias"], cfg.layernorm_eps)
        return x, moe_aux

    def resolve():
        if fixed is not None:
            return mesh, fixed
        m = active_mesh()
        return m, _Parallel(cfg, m)

    def loss_fn(params, batch):
        layer_mesh, par = resolve()
        if isinstance(batch, (tuple, list)):
            inputs, targets = batch
        else:
            inputs, targets = batch[:, :-1], batch[:, 1:]
        S_global = inputs.shape[1]
        inputs = par.local_tokens(inputs)
        targets = par.local_tokens(targets).long()
        x, moe_aux = hidden_fn(params, inputs, layer_mesh, par)
        extra = 0.0 if moe_aux is None else moe_aux
        w = head_weight(cfg, params)
        B, S, _ = x.shape
        vocab_parallel = (par.tp is not None and par.tp.size > 1
                          and not cfg.tie_embeddings)
        if vocab_parallel:
            x = copy_to_tp_region(x, par.tp)
            v0 = par.tp.rank * w.shape[1]
        elif par.tp is not None and par.tp.size > 1:
            # the tied head: this rank's d_model columns of x against its
            # columns of wte, the partial logits summed
            x = scatter_to_tp_region(x, par.tp)
        chunk = pick_ce_chunk(S, cfg.ce_chunk)
        parallel = par.tp is not None and par.tp.size > 1
        if not chunk and not parallel and par.sp_size == 1:
            logits = (x @ w).float()
            tgt = logits.gather(-1, targets[..., None])[..., 0]
            return (torch.logsumexp(logits, dim=-1) - tgt).mean() + extra
        # stream the cross-entropy over sequence chunks: the (B, S, V)
        # logits never exist at once; each chunk's logits are recomputed
        # in the backward
        total = x.new_zeros((), dtype=torch.float32)
        for c0 in range(0, S, chunk or S):
            xc = x[:, c0:c0 + (chunk or S)]
            tc = targets[:, c0:c0 + (chunk or S)]
            if vocab_parallel:
                nll = _VocabParallelNLL.apply(xc, w, tc, par.tp, v0)
            elif parallel:
                nll = checkpoint(_tied_tp_chunk_nll, xc, tc, w, par.tp,
                                 use_reentrant=False)
            else:
                nll = checkpoint(_chunk_nll, xc, tc, w, use_reentrant=False)
            total = total + nll
        if par.sp_size > 1:
            # this rank's share of the mean over the global tokens, summed
            # over the sequence axis (identity backward: the engine sums
            # the grads over the axis)
            return reduce_from_tp_region(total / (B * S_global),
                                         par.sp) + extra
        return total / (B * S) + extra

    def init_fn(seed, device=None, dtype=None):
        return init_params(seed, cfg, device=device, dtype=dtype)

    @torch.no_grad()
    def apply_fn(params, tokens):
        layer_mesh, par = resolve()
        if par.sp_size == 1:
            return apply(cfg, params, tokens, layer_mesh)
        x, _ = hidden_fn(params, par.local_tokens(tokens), layer_mesh, par)
        logits = logits_of(cfg, params, x, par.tp)
        parts = par.sp.all_gather(logits.contiguous())
        return torch.cat(parts.unbind(0), dim=1)

    return init_fn, apply_fn, loss_fn, param_specs(cfg)


def _tied_tp_chunk_nll(xc, tc, w, tp):
    logits = reduce_from_tp_region(xc @ w, tp).float()
    tgt = logits.gather(-1, tc[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - tgt).sum()


@torch.no_grad()
def moe_stats(cfg: GPTConfig, params, tokens, mesh=None) -> List[Dict]:
    """The MoE layers' auxiliary terms of one forward of ``tokens`` (B, S)
    (no grad): a dict a layer with its ``aux_loss``, ``z_loss`` and
    ``dropped_frac`` as floats, over the global batch when ``mesh`` (else
    the active mesh) spans data ranks. Every rank of the mesh calls it."""
    from .moe import moe_ffn

    if cfg.moe is None:
        raise ValueError("moe_stats needs a Mixture-of-Experts config")
    cdt = cfg.dtype
    tokens = tokens.long()
    S = tokens.shape[1]
    x = F.embedding(tokens, params["embed"]["wte"].to(cdt))
    positions = torch.arange(S, device=tokens.device)
    if not cfg.rotary:
        x = x + params["embed"]["wpe"][:S].to(cdt)

    def attend(q, k, v):
        k, v = expand_kv_heads(q, k, v)
        return causal_attention(q, k, v, cfg.attn_impl), None

    out = []
    for lp in layer_slices(params, cfg.n_layer):
        x, (_, aux) = decoder_block(
            cfg, x, lp, positions, attend,
            mlp_fn=partial(moe_ffn, lp["moe"], cfg=cfg.moe, mesh=mesh))
        out.append({k: float(v) for k, v in aux.items()})
    return out


# convenience presets ------------------------------------------------- #

PRESETS = {
    "gpt2-125m": GPTConfig(n_layer=12, n_head=12, d_model=768, rotary=False,
                           parallel_residual=False),
    "gpt2-350m": GPTConfig(n_layer=24, n_head=16, d_model=1024, rotary=False,
                           parallel_residual=False),
    "neox-125m": GPTConfig(n_layer=12, n_head=12, d_model=768),
    "neox-1.3b": GPTConfig(n_layer=24, n_head=16, d_model=2048),
    "neox-6.7b": GPTConfig(n_layer=32, n_head=32, d_model=4096),
    "neox-20b": GPTConfig(
        n_layer=44, n_head=64, d_model=6144, d_ff=24576, vocab_size=50432,
        rotary_pct=0.25,
    ),
}


def get_preset(name: str, **overrides) -> GPTConfig:
    cfg = PRESETS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
