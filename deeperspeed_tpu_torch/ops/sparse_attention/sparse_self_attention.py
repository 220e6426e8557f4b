"""SparseSelfAttention and BertSparseSelfAttention.

Counterpart of deeperspeed_tpu/ops/sparse_attention/sparse_self_attention.py:
(B, H, S, Dh) q/k/v in, (B, H, S, Dh) context out, one op per
(S, Dh, device). The master layout is built once at ``max_seq_length`` and
sliced for a shorter S, as the reference's master_layout buffer is.

``impl``:
  "auto"             the CUDA kernel pair for a CUDA tensor, its plain
                     version for a CPU tensor. On a CUDA tensor a block,
                     head dim or dtype that the kernels do not take raises;
                     it never quietly takes the plain path.
  "pallas"           the kernel pair; raises on the CPU.
  "pallas_interpret" the plain versions on any device: the CPU counterpart
                     of the reference's interpret mode.
  "xla"              the dense-mask ``block_sparse_attention_xla``.

A key-padding mask is an additive (B, S) float mask. The reference sends a
masked batch to its dense path whatever ``impl`` says; here the kernel
pair takes the mask, so a masked batch on the card runs the kernels. The
function is the same: an added bias on the scores, and a key whose mask is
<= NEG_INF / 2 counts as not visible.
"""

import math
from typing import Optional

import numpy as np
import torch

from . import block_sparse
from .kernels import SparseLut, block_sparse_attention_xla
from .sparsity_config import SparsityConfig

IMPLS = ("auto", "pallas", "pallas_interpret", "xla")


class SparseSelfAttention(torch.nn.Module):
    """Block-sparse self attention with a pluggable SparsityConfig.

    Call with query/key/value of shape (B, num_heads, S, head_dim) (the
    reference's convention). ``causal`` defaults to True when the sparsity
    config's attention mode is 'unidirectional'. The module has no
    parameters."""

    def __init__(self, sparsity_config: Optional[SparsityConfig] = None,
                 max_seq_length: int = 2048, causal: Optional[bool] = None,
                 impl: str = "auto"):
        super().__init__()
        self.sparsity_config = sparsity_config or SparsityConfig(num_heads=4)
        if not hasattr(self.sparsity_config, "make_layout"):
            raise TypeError("sparsity_config must provide make_layout()")
        self.max_seq_length = max_seq_length
        self.master_layout = np.asarray(
            self.sparsity_config.make_layout(max_seq_length))
        if causal is None:
            causal = getattr(self.sparsity_config, "attention",
                             None) == "unidirectional"
        self.causal = causal
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.impl = impl
        self._ops = {}  # (S, Dh, device) -> the attention function

    def get_layout(self, L: int) -> np.ndarray:
        if L % self.sparsity_config.block != 0:
            raise ValueError(
                f"Sequence Length, {L}, needs to be divisible by Block size "
                f"{self.sparsity_config.block}!"
            )
        nb = L // self.sparsity_config.block
        return self.master_layout[..., :nb, :nb]

    def _get_op(self, L: int, Dh: int, device: torch.device):
        key = (L, Dh, device)
        op = self._ops.get(key)
        if op is not None:
            return op
        block = self.sparsity_config.block
        scale = 1.0 / math.sqrt(Dh)
        if self.impl == "xla":
            layout = self.get_layout(L)

            def op(q, k, v, kpm):
                t = lambda x: x.transpose(1, 2)
                return t(block_sparse_attention_xla(
                    t(q), t(k), t(v), layout, block, causal=self.causal,
                    sm_scale=scale, key_padding_mask=kpm))
        else:
            if self.impl == "pallas" and device.type != "cuda":
                raise ValueError(
                    f'impl="pallas" runs the CUDA kernels and takes CUDA '
                    f'tensors, got {device}; use "auto" or '
                    f'"pallas_interpret" on the CPU')
            lut = SparseLut(self.get_layout(L), block, self.causal).on(device)
            plain = self.impl == "pallas_interpret"

            def op(q, k, v, kpm):
                return block_sparse.sparse_attention_bhsd(
                    q, k, v, lut, scale, self.causal, kpm, plain=plain)
        self._ops[key] = op
        return op

    def forward(self, query, key, value, key_padding_mask=None):
        """query/key/value: (B, H, S, Dh). key_padding_mask: (B, S) additive
        float mask (0 keep / -inf or NEG_INF drop) applied pre-softmax, the
        reference's 'add' mode."""
        B, H, S, Dh = query.shape
        if query.shape != key.shape or key.shape != value.shape:
            raise NotImplementedError("only self-attention is supported for now")
        op = self._get_op(S, Dh, query.device)
        return op(query, key, value, key_padding_mask)


class BertSparseSelfAttention:
    """BERT-style QKV projection + SparseSelfAttention (the reference's
    bert_sparse_self_attention). Functional: ``init(generator, device,
    dtype)`` -> params {"query"|"key"|"value": {"w": (D, D), "b": (D,)}},
    ``apply(params, hidden, key_padding_mask)``; the params ride an
    engine's params tree. The projections are plain ``torch.matmul``."""

    def __init__(self, hidden_size: int, num_heads: int,
                 sparsity_config: Optional[SparsityConfig] = None,
                 max_seq_length: int = 2048, impl: str = "auto"):
        if hidden_size % num_heads:
            raise ValueError(
                f"The hidden size ({hidden_size}) is not a multiple of the "
                f"number of attention heads ({num_heads})"
            )
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.attn = SparseSelfAttention(
            sparsity_config or SparsityConfig(num_heads=num_heads),
            max_seq_length=max_seq_length, impl=impl,
        )

    def init(self, generator=None, device="cuda", dtype=torch.float32):
        """Weights ~ N(0, 1 / D) drawn from ``generator`` (an int seed or a
        ``torch.Generator``), zero biases."""
        if generator is None or isinstance(generator, int):
            generator = torch.Generator().manual_seed(int(generator or 0))
        D = self.hidden_size
        s = 1.0 / math.sqrt(D)
        out = {}
        for name in ("query", "key", "value"):
            w = torch.randn((D, D), generator=generator,
                            device=generator.device) * s
            out[name] = {"w": w.to(device, dtype),
                         "b": torch.zeros((D,), device=device, dtype=dtype)}
        return out

    def _split_heads(self, x):
        B, S, _ = x.shape
        return x.reshape(B, S, self.num_heads,
                         self.head_dim).transpose(1, 2).contiguous()

    def apply(self, params, hidden, key_padding_mask=None):
        q = hidden @ params["query"]["w"] + params["query"]["b"]
        k = hidden @ params["key"]["w"] + params["key"]["b"]
        v = hidden @ params["value"]["w"] + params["value"]["b"]
        ctx = self.attn(
            self._split_heads(q), self._split_heads(k), self._split_heads(v),
            key_padding_mask=key_padding_mask,
        )  # (B, H, S, Dh)
        B, H, S, Dh = ctx.shape
        return ctx.transpose(1, 2).reshape(B, S, H * Dh)
