"""Carry GPT and BERT weights, and Adam and LAMB state, between the JAX
reference and the port.

The port keeps the reference's parameter layout (models/gpt.py,
models/bert.py): the same tree, per-layer tensors stacked on axis 0,
matrices (in, out). So the conversion is a copy, leaf for leaf; nothing
is transposed, and a transposition bug has nowhere to hide. The
reference's ``AdamState`` and ``LambState`` (step, exp_avg tree,
exp_avg_sq tree) carry across the same way, so an optimizer step can be
held against the reference from the same state. A ``PipelineModule``'s
params (``from_jax_pipeline_params``) carry across layer by layer, a
tensor-parallel layer's cut to a rank.
"""

from typing import Dict, Optional

import numpy as np
import torch

from ..ops.adam import AdamState, tree_map
from ..ops.lamb import LambState
from . import bert
from .gpt import GPTConfig, cast_params, param_shapes


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _copy_tree(tree_of_numpy: Dict, shapes: Dict, device) -> Dict:
    """The tree's leaves as tensors on ``device``, keys and shapes checked
    against ``shapes`` exactly."""
    want = _flatten(shapes)
    got = _flatten(tree_of_numpy)
    if set(want) != set(got):
        raise ValueError(
            f"params tree does not match the config: missing "
            f"{sorted(set(want) - set(got))}, unexpected "
            f"{sorted(set(got) - set(want))}")

    def walk(tree, prefix):
        out = {}
        for k, v in tree.items():
            path = f"{prefix}{k}"
            if isinstance(v, dict):
                out[k] = walk(v, f"{path}/")
                continue
            a = np.asarray(v)
            if tuple(a.shape) != tuple(want[path]):
                raise ValueError(f"{path}: shape {tuple(a.shape)}, the config "
                                 f"needs {tuple(want[path])}")
            out[k] = torch.tensor(a, device=device)
        return out

    return walk(tree_of_numpy, "")


def from_jax_params(tree_of_numpy: Dict, cfg: GPTConfig, device,
                    dtype: Optional[torch.dtype] = None) -> Dict:
    """The reference's GPT params pytree (numpy arrays, or anything
    ``np.asarray`` takes) -> the port's params on ``device``. Keys and
    shapes must match ``param_shapes(cfg)`` exactly. Leaves keep their
    dtype (the reference's are fp32) unless ``dtype`` is given, which casts
    them with ``gpt.cast_params`` (layer norms stay fp32)."""
    params = _copy_tree(tree_of_numpy, param_shapes(cfg), device)
    return cast_params(params, dtype) if dtype is not None else params


def from_jax_bert_params(tree_of_numpy: Dict, cfg: "bert.BertConfig",
                         device) -> Dict:
    """The reference's BERT params pytree -> the port's on ``device``,
    leaves keeping their dtype. Keys and shapes must match
    ``bert.param_shapes(cfg)`` exactly, with the SQuAD head's ``qa``
    leaves when the tree has them."""
    shapes = bert.param_shapes(cfg, qa="qa" in tree_of_numpy)
    return _copy_tree(tree_of_numpy, shapes, device)


def to_numpy_params(params: Dict) -> Dict:
    """The port's params (GPT or BERT) -> the reference's pytree of numpy
    arrays (bf16 leaves come back as fp32, since numpy has no bf16)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return {k: to_numpy_params(v) if isinstance(v, dict) else leaf(v)
            for k, v in params.items()}


def _to_torch(a, device):
    """A numpy-convertible leaf as a tensor; bf16 (which numpy cannot hold
    natively) arrives through fp32 and is cast back."""
    dtype = getattr(a, "dtype", None)
    if dtype is not None and str(dtype) == "bfloat16":
        return torch.tensor(np.asarray(a, np.float32),
                            device=device).to(torch.bfloat16)
    return torch.tensor(np.asarray(a), device=device)


def _moments(state, device):
    return (int(np.asarray(state.step)),
            tree_map(lambda a: _to_torch(a, device), state.exp_avg),
            tree_map(lambda a: _to_torch(a, device), state.exp_avg_sq))


def from_jax_adam_state(state, device) -> AdamState:
    """The reference's ``AdamState`` (numpy or JAX leaves) -> the port's,
    on ``device``, each moment keeping its storage dtype."""
    return AdamState(*_moments(state, device))


def to_numpy_adam_state(state: AdamState) -> AdamState:
    """The port's AdamState with numpy leaves (bf16 moments as fp32)."""
    return AdamState(step=int(state.step),
                     exp_avg=to_numpy_params(state.exp_avg),
                     exp_avg_sq=to_numpy_params(state.exp_avg_sq))


to_numpy_bert_params = to_numpy_params


def from_jax_lamb_state(state, device) -> LambState:
    """The reference's ``LambState`` (numpy or JAX leaves, fp32 moments)
    -> the port's, on ``device``."""
    return LambState(*_moments(state, device))


def sparse_attention_shapes(hidden_size: int) -> Dict:
    """The params tree of one ``BertSparseSelfAttention`` of width D."""
    D = hidden_size
    return {name: {"w": (D, D), "b": (D,)}
            for name in ("query", "key", "value")}


def from_jax_sparse_attention_params(tree_of_numpy: Dict, hidden_size: int,
                                     device) -> Dict:
    """The reference's ``BertSparseSelfAttention`` params (numpy arrays)
    -> the port's on ``device``, leaves keeping their dtype. Both keep
    ``w`` as (in, out), so this is a copy; keys and shapes must match."""
    return _copy_tree(tree_of_numpy, sparse_attention_shapes(hidden_size),
                      device)


to_numpy_sparse_attention_params = to_numpy_params


def from_jax_pipeline_params(params_all: Dict, module, device="cpu",
                             mesh=None) -> Dict:
    """The reference's ``PipelineModule`` params ``{"layers": [dict | None],
    "tied": {key: dict}}`` (numpy leaves) as the port's, on ``device``:
    each layer's leaves checked against the port layer's shapes (its
    ``init`` on the meta device). With ``mesh``, a layer carrying
    ``specs`` (the tensor-parallel layers) keeps this rank's part of each
    leaf (``parallel.tp.shard_tree``); every other leaf stays whole."""
    from ..parallel.tp import shard_tree

    def layer(idx, tree):
        if tree is None:
            return None
        shapes = module.layer(idx).init(0, device="meta")
        out = _copy_tree(tree, tree_map(lambda t: tuple(t.shape), shapes),
                         device)
        specs = getattr(module.layer(idx), "specs", None)
        if mesh is not None and specs is not None:
            out = shard_tree(out, specs, mesh)
        return out

    layers = [layer(i, p) for i, p in enumerate(params_all["layers"])]
    tied = {k: layer(module.tied_specs[k][0], v)
            for k, v in params_all["tied"].items()}
    return {"layers": layers, "tied": tied}
