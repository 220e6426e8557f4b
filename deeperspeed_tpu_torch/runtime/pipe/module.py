"""The pipeline model container.

Counterpart of deeperspeed_tpu/runtime/pipe/module.py: the functional
layer protocol (``Layer``, ``FnLayer``, ``Linear``, ``Embedding``),
``LayerSpec``, ``TiedLayerSpec`` and ``PipelineModule`` with layer
partitioning ``uniform|parameters|type:regex``, tied-layer bookkeeping
and per-layer checkpoint files.

A layer is a pair ``init(seed, device) -> params`` / ``apply(params, x,
rng=None) -> y`` over a plain dict of tensors instead of an
``nn.Module``; plain callables are zero-param layers. ``init`` takes what
``utils.init.normal_drawer`` takes (an int seed, a ``torch.Generator``,
or a numpy generator) and a device, and returns fp32 params. The port's
``DeepSpeedTransformerLayer`` and the tensor-parallel layers of
parallel/tp.py follow the same protocol, so a ``LayerSpec`` takes them.

Params of a whole module are ``{"layers": [per-layer dict | None],
"tied": {key: dict}}``, the reference's layout. ``init_params`` draws
each layer from its own seed (``base_seed + i`` with ``seed_layers``,
else ``fold_seed(seed, i)``), so a process that builds only its stage's
layers (``stages=``) gets the same values as one that builds them all.
The "parameters" partition counts each layer's params from shapes on the
``meta`` device, without allocating them.

``stage_forward`` composes a stage's contiguous slice of layers, under
``torch.utils.checkpoint`` every ``activation_checkpoint_interval``
layers (the reference's ``jax.checkpoint`` ranges).
"""

import math
import os
import re
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ...utils.init import normal_drawer
from ...utils.logging import logger
from ..utils import call_to_str, partition_balanced, partition_uniform

__all__ = ["Layer", "FnLayer", "Linear", "Embedding", "LayerSpec",
           "TiedLayerSpec", "PipelineModule", "layer_seed"]


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
    """Dense layer, ``x @ w + b`` with ``w`` (in, out). Mixed dtypes are
    promoted as jax.numpy promotes them (fp32 input, bf16 weights:
    fp32)."""

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
        dt = torch.promote_types(x.dtype, params["w"].dtype)
        y = x.to(dt) @ params["w"].to(dt)
        if self.bias:
            y = y + params["b"].to(dt)
        return y


class Embedding(Layer):
    def __init__(self, vocab: int, dim: int):
        self.vocab, self.dim = vocab, dim

    def init(self, seed, device="cpu"):
        return {"w": normal_drawer(seed, device)((self.vocab, self.dim),
                                                 0.02)}

    def apply(self, params, x, rng=None):
        return params["w"][x.long()]


def _as_layer(obj):
    if isinstance(obj, Layer):
        return obj
    # duck-typed functional layers (DeepSpeedTransformerLayer, the TP
    # layers) expose init/apply without subclassing Layer
    if hasattr(obj, "init") and hasattr(obj, "apply"):
        return obj
    if callable(obj):
        return FnLayer(obj)
    raise TypeError(f"not a pipeline layer: {obj!r}")


def layer_seed(seed: int, i: int) -> int:
    """Layer ``i``'s seed from a module seed (ops/transformer's
    ``fold_seed``: the counterpart of the reference's key split)."""
    from ...ops.transformer.transformer import fold_seed

    return fold_seed(int(seed), i)


class LayerSpec:
    """Deferred layer construction: the class (or factory) and its
    arguments; ``build()`` instantiates."""

    def __init__(self, typename, *module_args, **module_kwargs):
        self.typename = typename
        self.module_args = module_args
        self.module_kwargs = module_kwargs
        if not callable(typename):
            raise RuntimeError("LayerSpec requires a callable type/factory")
        self.name = getattr(typename, "__name__", str(typename))

    def __repr__(self):
        return call_to_str(self.name, *self.module_args,
                           **self.module_kwargs)

    def build(self, log: bool = False):
        if log:
            logger.info("building %r", self)
        if (isinstance(self.typename, type) or self.module_args
                or self.module_kwargs):
            return _as_layer(self.typename(*self.module_args,
                                           **self.module_kwargs))
        # a bare callable with no construction args IS the layer
        return _as_layer(self.typename)


class TiedLayerSpec(LayerSpec):
    """A LayerSpec whose params are shared with every other spec carrying
    the same ``key`` (e.g. tied input and output embeddings).
    ``forward_fn(params, x)`` optionally reinterprets the shared params
    (e.g. the embedding matrix transposed as the LM head)."""

    def __init__(self, key, typename, *module_args, forward_fn=None,
                 tied_weight_attr="weight", **module_kwargs):
        super().__init__(typename, *module_args, **module_kwargs)
        self.key = key
        self.forward_fn = forward_fn
        self.tied_weight_attr = tied_weight_attr


class PipelineModule:
    """Partitions a flat layer list into pipeline stages.

    Args:
        layers: sequence of LayerSpec / layers / callables.
        num_stages: pipeline depth (or from ``topology``'s pipe axis).
        topology: optional ProcessTopology with a 'pipe' axis.
        loss_fn: ``(output, label) -> scalar loss`` of the last stage.
        partition_method: 'parameters' | 'uniform' | 'type:<regex>'.
        activation_checkpoint_interval: recompute every N layers (0: off).
    """

    def __init__(self, layers: Sequence[Any], num_stages: Optional[int] = None,
                 topology=None, loss_fn: Optional[Callable] = None,
                 seed_layers: bool = False, base_seed: int = 1234,
                 partition_method: str = "parameters",
                 activation_checkpoint_interval: int = 0):
        if num_stages is None and topology is None:
            raise RuntimeError("must provide num_stages or topology")
        self._topo = topology
        if num_stages is None:
            num_stages = topology.get_dim("pipe")
        self.num_stages = num_stages
        self.loss_fn = loss_fn
        self.seed_layers = seed_layers
        self.base_seed = base_seed
        self.activation_checkpoint_interval = activation_checkpoint_interval

        def wrap(s):
            if isinstance(s, LayerSpec):
                return s
            spec = LayerSpec(lambda obj=s: obj)
            # keep the object's own name for `type:<regex>` partitioning
            spec.name = getattr(s, "__name__", type(s).__name__)
            return spec

        self._layer_specs = [wrap(s) for s in layers]
        self._orig = list(layers)
        self._built = [self._build_layer(i)
                       for i in range(len(self._layer_specs))]
        self.parts = self._partition_layers(partition_method)
        self.tied_specs: Dict[str, List[int]] = {}
        for i, spec in enumerate(self._layer_specs):
            if isinstance(spec, TiedLayerSpec):
                self.tied_specs.setdefault(spec.key, []).append(i)

    # -------------------------------------------------------------- #
    # construction
    # -------------------------------------------------------------- #

    def _build_layer(self, idx: int):
        orig = self._orig[idx]
        if isinstance(orig, LayerSpec):
            return orig.build()
        return _as_layer(orig)

    def _count_layer_params(self, idx: int) -> int:
        shapes = self._built[idx].init(0, device="meta")
        if shapes is None:
            return 0
        return sum(int(t.numel()) for t in _leaves(shapes))

    def _partition_layers(self, method: str) -> List[int]:
        n = len(self._layer_specs)
        method = method.lower()
        if method == "uniform":
            parts = partition_uniform(n, self.num_stages)
        elif method == "parameters":
            weights = [max(1, self._count_layer_params(i)) for i in range(n)]
            parts = partition_balanced(weights, self.num_stages)
        elif method.startswith("type:"):
            pat = method.split(":", 1)[1]
            weights = [1 if re.search(pat, self._layer_specs[i].name,
                                      re.IGNORECASE) else 0
                       for i in range(n)]
            if sum(weights) == 0:
                raise RuntimeError(f"no layers match type regex {pat!r}")
            parts = partition_balanced(weights, self.num_stages)
        elif method == "profile":
            raise NotImplementedError(
                "profile-based partitioning not supported")
        else:
            raise NotImplementedError(f"partition method {method!r}")
        logger.info("pipeline partition (%s): %s", method, parts)
        return parts

    # -------------------------------------------------------------- #
    # stage views
    # -------------------------------------------------------------- #

    def stage_layer_indices(self, stage_id: int) -> range:
        return range(self.parts[stage_id], self.parts[stage_id + 1])

    def stage_owning_layer(self, layer_idx: int) -> int:
        for s in range(self.num_stages):
            if self.parts[s] <= layer_idx < self.parts[s + 1]:
                return s
        raise IndexError(layer_idx)

    def tied_owner_stage(self, key: str) -> int:
        """The lowest stage touching a tie owns the canonical copy."""
        return min(self.stage_owning_layer(i) for i in self.tied_specs[key])

    def tied_stages(self, key: str) -> List[int]:
        return sorted({self.stage_owning_layer(i)
                       for i in self.tied_specs[key]})

    def layer(self, idx: int):
        """The built layer at ``idx``."""
        return self._built[idx]

    def layer_spec(self, idx: int) -> LayerSpec:
        return self._layer_specs[idx]

    def _layer_seed(self, seed, i: int):
        if self.seed_layers:
            return self.base_seed + i
        return layer_seed(seed, i)

    def init_params(self, seed=0, device="cpu",
                    stages: Optional[Sequence[int]] = None):
        """``{'layers': [per-layer dict | None], 'tied': {key: dict}}``,
        fp32 on ``device``. Only the layers of ``stages`` (default all)
        are drawn; the others are None. A tied key is drawn (once) from
        the seed of the first spec carrying it when one of its stages is
        among ``stages``."""
        want = (set(range(self.num_stages)) if stages is None
                else set(stages))
        layer_params: List[Any] = []
        tied: Dict[str, Any] = {}
        for i, layer in enumerate(self._built):
            spec = self._layer_specs[i]
            if isinstance(spec, TiedLayerSpec):
                first = self.tied_specs[spec.key][0]
                if (spec.key not in tied
                        and want & set(self.tied_stages(spec.key))):
                    tied[spec.key] = self._built[first].init(
                        self._layer_seed(seed, first), device=device)
                layer_params.append(None)
            elif self.stage_owning_layer(i) in want:
                layer_params.append(layer.init(self._layer_seed(seed, i),
                                               device=device))
            else:
                layer_params.append(None)
        return {"layers": layer_params, "tied": tied}

    def apply_layer(self, idx: int, params_all, x, rng=None):
        spec = self._layer_specs[idx]
        layer = self._built[idx]
        if isinstance(spec, TiedLayerSpec):
            p = params_all["tied"][spec.key]
            if spec.forward_fn is not None:
                return spec.forward_fn(p, x)
            return layer.apply(p, x, rng)
        return layer.apply(params_all["layers"][idx], x, rng)

    def stage_forward(self, stage_id: int) -> Callable:
        """``fwd(params_all, x, rng=None) -> y`` over the stage's layers
        (only its slots of ``params_all`` are read), recomputing every
        ``activation_checkpoint_interval`` layers in the backward."""
        idxs = list(self.stage_layer_indices(stage_id))
        interval = self.activation_checkpoint_interval

        def run_range(params_all, x, rng, lo, hi):
            for j in range(lo, hi):
                sub = None if rng is None else layer_seed(rng, j)
                x = self.apply_layer(idxs[j], params_all, x, sub)
            return x

        def fwd(params_all, x, rng=None):
            n = len(idxs)
            if not (interval and interval > 0):
                return run_range(params_all, x, rng, 0, n)
            j = 0
            while j < n:
                hi = min(j + interval, n)
                if torch.is_grad_enabled():
                    x = checkpoint(run_range, params_all, x, rng, j, hi,
                                   use_reentrant=False)
                else:
                    x = run_range(params_all, x, rng, j, hi)
                j = hi
            return x

        return fwd

    # -------------------------------------------------------------- #
    # per-layer checkpoint files
    # -------------------------------------------------------------- #

    @staticmethod
    def ckpt_layer_path(ckpt_dir: str, local_layer_idx: int,
                        mp_rank: int = 0) -> str:
        return os.path.join(
            ckpt_dir, f"layer_{local_layer_idx:02d}-model_{mp_rank:02d}"
            f"-model_states.msgpack")

    def save_state_dict(self, save_dir: str, params_all, mp_rank: int = 0,
                        layers: Optional[Sequence[int]] = None):
        """One file per layer (of ``layers``, default all), so a
        checkpoint survives pipeline and TP re-grouping; a tie is written
        once, at the first spec carrying it."""
        from ...checkpoint.serialization import save_tree

        os.makedirs(save_dir, exist_ok=True)
        idxs = range(len(self._layer_specs)) if layers is None else layers
        for idx in idxs:
            spec = self._layer_specs[idx]
            if isinstance(spec, TiedLayerSpec):
                if self.tied_specs[spec.key][0] != idx:
                    continue
                p = params_all["tied"].get(spec.key)
            else:
                p = params_all["layers"][idx]
            if p is None:
                continue
            save_tree(self.ckpt_layer_path(save_dir, idx, mp_rank), p)

    def load_state_dir(self, load_dir: str, params_all, mp_rank: int = 0):
        """The params with every layer file found in ``load_dir`` read
        into its slot (numpy arrays, bf16 as CPU tensors; the caller
        copies them where they belong). A tie is read from the file of
        the first spec carrying it; slots that are None stay None."""
        from ...checkpoint.serialization import load_tree

        layers = list(params_all["layers"])
        tied = dict(params_all["tied"])
        for idx in range(len(self._layer_specs)):
            spec = self._layer_specs[idx]
            if isinstance(spec, TiedLayerSpec):
                if spec.key not in tied or tied[spec.key] is None:
                    continue
                idx = self.tied_specs[spec.key][0]
            elif layers[idx] is None:
                continue
            path = self.ckpt_layer_path(load_dir, idx, mp_rank)
            if not os.path.exists(path):
                continue
            if isinstance(spec, TiedLayerSpec):
                tied[spec.key] = load_tree(path, tied[spec.key])
            else:
                layers[idx] = load_tree(path, layers[idx])
        return {"layers": layers, "tied": tied}

    def topology(self):
        return self._topo

    def num_layers(self) -> int:
        return len(self._layer_specs)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]
