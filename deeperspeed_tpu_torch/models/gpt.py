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
Not ported yet: tensor/sequence parallelism (ROADMAP.md queue 1).
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
from ..ops.kernel_config import _is_hopper
from ..sharding.mesh import active_mesh
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
    # version, CPU tensors) | 'xla' (dense); see causal_attention
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


_ATTN_IMPLS = ("auto", "pallas", "pallas_interpret", "xla")


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
    None or a mesh axis): the expert leaves of an MoE model sharded on the
    ``expert`` axis (the reference's ``moe_param_specs`` with the layer
    axis prepended), every other leaf replicated (None: the port has no
    tensor parallelism). None for a dense model."""
    if not cfg.moe_num_experts:
        return None
    from .moe import moe_param_specs

    def walk(shapes, specs):
        return {k: walk(v, (specs or {}).get(k)) if isinstance(v, dict)
                else (None if specs is None else (None,) + specs[k])
                for k, v in shapes.items()}

    shapes = param_shapes(cfg)
    out = walk(shapes, None)
    out["layers"]["moe"] = walk(shapes["layers"]["moe"], moe_param_specs())
    return out


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
    return device.type == "cuda" and _is_hopper(device)


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
                  mlp_fn=None):
    """One decoder layer shared by the full forward (``apply``), KV-cache
    decoding (models/generation.py) and serving (serving/engine.py):
    qkv projection, rotary, residual/MLP wiring.

    ``attend(q, k, v) -> (ctx, aux)`` supplies the attention core.
    ``mlp_fn(mlp_in) -> (mlp_out, aux2)`` overrides the dense FFN; with it,
    aux is (attend_aux, aux2). A layer with a ``moe`` subtree and no
    ``mlp_fn`` takes ``moe_ffn`` (models/moe.py) on the active mesh: the
    decode paths' MoE FFN, as the reference's generation and serving steps
    pass it. Returns (x_out, aux)."""
    cdt = cfg.dtype
    B, S, D = x.shape
    H, Dh = cfg.n_head, cfg.head_dim
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
    qkv = attn_in @ attn_p["wqkv"].to(cdt) + attn_p["bqkv"].to(cdt)
    Hkv = cfg.kv_heads
    q = qkv[..., : H * Dh].reshape(B, S, H, Dh)
    k = qkv[..., H * Dh: (H + Hkv) * Dh].reshape(B, S, Hkv, Dh)
    v = qkv[..., (H + Hkv) * Dh:].reshape(B, S, Hkv, Dh)
    if cfg.rotary:
        rd = int(cfg.rotary_pct * Dh) // 2 * 2
        q = rotary_embedding(q, positions, rd)
        k = rotary_embedding(k, positions, rd)
    ctx, aux = attend(q, k, v)
    attn = ctx.reshape(B, S, D)
    attn_out = attn @ attn_p["wo"].to(cdt) + attn_p["bo"].to(cdt)

    if cfg.parallel_residual:
        mlp_in = mlp_in_shared
    else:
        x = x + attn_out
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
    else:
        mlp_p = layer_params["mlp"]
        h = mlp_in @ mlp_p["wi"].to(cdt)
        h = fused_blocks.bias_gelu(h, mlp_p["bi"].to(cdt), approximate=True)
        mlp_out = h @ mlp_p["wo"].to(cdt) + mlp_p["bo"].to(cdt)

    if cfg.parallel_residual:
        x = x + attn_out + mlp_out
    else:
        x = x + mlp_out
    return x, aux


def head_weight(cfg: GPTConfig, params):
    if cfg.tie_embeddings:
        return params["embed"]["wte"].to(cfg.dtype).T
    return params["lm_head"].to(cfg.dtype)


@torch.no_grad()
def apply(cfg: GPTConfig, params, tokens):
    """tokens (B, S) int -> logits (B, S, V): the reference's
    ``make_gpt(cfg)[1]``."""
    cdt = cfg.dtype
    S = tokens.shape[1]
    tokens = tokens.long()
    x = params["embed"]["wte"][tokens].to(cdt)  # (B, S, D)
    positions = torch.arange(S, device=tokens.device)
    if not cfg.rotary:
        x = x + params["embed"]["wpe"][:S].to(cdt)

    def attend(q, k, v):
        k, v = expand_kv_heads(q, k, v)
        return causal_attention(q, k, v, cfg.attn_impl), None

    for layer_params in layer_slices(params, cfg.n_layer):
        x, _ = decoder_block(cfg, x, layer_params, positions, attend)
    x = layer_norm(x, params["final_ln"]["scale"], params["final_ln"]["bias"],
                   cfg.layernorm_eps)
    return x @ head_weight(cfg, params)


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


def make_gpt(cfg: GPTConfig, mesh=None):
    """Returns (init_fn, apply_fn, loss_fn, specs), as the reference's
    ``make_gpt``.

    init_fn(seed, device=None, dtype=None) -> params (``init_params``)
    apply_fn(params, tokens) -> logits (B, S, V) (no grad)
    loss_fn(params, batch) -> mean next-token cross-entropy, plus the MoE
    layers' summed auxiliary loss (``moe_loss``), fp32 scalar;
    batch = tokens (B, S+1) or (inputs, targets) (B, S) each.
    specs: ``param_specs(cfg)``, the MoE expert leaves on the ``expert``
    axis (hand them to ``initialize(..., mesh=, param_specs=)``), or None
    for a dense model. ``mesh`` (a legacy ``{data, expert}`` mesh,
    parallel/topology.build_mesh) gives the MoE layers their collectives;
    without one they take the running engine's (``active_mesh``)."""

    def attend(q, k, v):
        k, v = expand_kv_heads(q, k, v)
        return causal_attention(q, k, v, cfg.attn_impl), None

    moe_cfg = cfg.moe
    if moe_cfg is not None and mesh is not None:
        from .moe import groups

        groups(mesh)  # new_group is collective: every rank builds them here

    def layer(x, layer_params, positions, layer_mesh=None):
        """-> (x, this layer's scalar MoE auxiliary loss; 0 when dense)."""
        if moe_cfg is None:
            return decoder_block(cfg, x, layer_params, positions, attend)[0]
        from .moe import moe_ffn, moe_loss

        def mlp_fn(mlp_in):
            return moe_ffn(layer_params["moe"], mlp_in, moe_cfg,
                           mesh=layer_mesh)

        x, (_, moe_aux) = decoder_block(cfg, x, layer_params, positions,
                                        attend, mlp_fn=mlp_fn)
        return x, moe_loss(moe_aux, moe_cfg)

    def hidden_fn(params, tokens):
        """tokens (B, S) int -> final-layernormed hidden states (B, S, D)."""
        cdt = cfg.dtype
        tokens = tokens.long()
        S = tokens.shape[1]
        x = F.embedding(tokens, params["embed"]["wte"].to(cdt))
        positions = torch.arange(S, device=tokens.device)
        if not cfg.rotary:
            x = x + params["embed"]["wpe"][:S].to(cdt)
        # the mesh is bound here: a remat replay in the backward runs
        # outside the engine's use_mesh context
        step = _remat_step(cfg, partial(
            layer, positions=positions,
            layer_mesh=mesh if mesh is not None else active_mesh()))
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

    def loss_fn(params, batch):
        if isinstance(batch, (tuple, list)):
            inputs, targets = batch
        else:
            inputs, targets = batch[:, :-1], batch[:, 1:]
        targets = targets.long()
        x, moe_aux = hidden_fn(params, inputs)
        extra = 0.0 if moe_aux is None else moe_aux
        w = head_weight(cfg, params)
        B, S, _ = x.shape
        chunk = pick_ce_chunk(S, cfg.ce_chunk)
        if chunk:
            # stream the cross-entropy over sequence chunks: the (B, S, V)
            # logits never exist at once; each chunk's logits are
            # recomputed in the backward
            total = x.new_zeros((), dtype=torch.float32)
            for c0 in range(0, S, chunk):
                total = total + checkpoint(
                    _chunk_nll, x[:, c0:c0 + chunk],
                    targets[:, c0:c0 + chunk], w, use_reentrant=False)
            return total / (B * S) + extra
        logits = (x @ w).float()
        tgt = logits.gather(-1, targets[..., None])[..., 0]
        return (torch.logsumexp(logits, dim=-1) - tgt).mean() + extra

    def init_fn(seed, device=None, dtype=None):
        return init_params(seed, cfg, device=device, dtype=dtype)

    def apply_fn(params, tokens):
        return apply(cfg, params, tokens)

    return init_fn, apply_fn, loss_fn, param_specs(cfg)


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
