"""The functional layer protocol of the pipeline container.

Counterpart of the first part of deeperspeed_tpu/runtime/pipe/module.py
(``Layer``, ``FnLayer``, ``Linear``, ``Embedding``): a layer is a pair
``init(seed) -> params`` / ``apply(params, x, rng=None) -> y`` over a
plain dict of tensors instead of an ``nn.Module``; plain callables are
zero-param layers. ``init`` takes what ``utils.init.normal_drawer`` takes
(an int seed, a ``torch.Generator``, or a numpy generator) and a device
(CPU by default), and returns fp32 params. ``LayerSpec``,
``TiedLayerSpec`` and ``PipelineModule`` wait for the pipeline engine
(ROADMAP.md queue 1, item 11).
"""

from typing import Any, Callable

import math

import torch

from ...utils.init import normal_drawer

__all__ = ["Layer", "FnLayer", "Linear", "Embedding"]


class Layer:
    """Functional layer protocol: subclass and implement init/apply."""

    def init(self, seed, device="cpu") -> Any:  # pragma: no cover
        return None

    def apply(self, params, x, rng=None):  # pragma: no cover - interface
        raise NotImplementedError


class FnLayer(Layer):
    """Zero-parameter layer wrapping a plain callable."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.__name__ = getattr(fn, "__name__", type(fn).__name__)

    def init(self, seed, device="cpu"):
        return None

    def apply(self, params, x, rng=None):
        return self.fn(x)


class Linear(Layer):
    """Dense layer, ``x @ w + b`` with ``w`` (in, out)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 scale: float = 1.0):
        self.in_dim, self.out_dim = in_dim, out_dim
        self.bias, self.scale = bias, scale

    def init(self, seed, device="cpu"):
        norm = normal_drawer(seed, device)
        p = {"w": norm((self.in_dim, self.out_dim),
                       self.scale / math.sqrt(self.in_dim))}
        if self.bias:
            p["b"] = torch.zeros(self.out_dim, dtype=torch.float32,
                                 device=device)
        return p

    def apply(self, params, x, rng=None):
        y = x @ params["w"]
        if self.bias:
            y = y + params["b"]
        return y


class Embedding(Layer):
    def __init__(self, vocab: int, dim: int):
        self.vocab, self.dim = vocab, dim

    def init(self, seed, device="cpu"):
        return {"w": normal_drawer(seed, device)((self.vocab, self.dim),
                                                 0.02)}

    def apply(self, params, x, rng=None):
        return params["w"][x.long()]
