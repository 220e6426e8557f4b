"""Carry GPT weights, and Adam state, between the JAX reference and the
port.

The port keeps the reference's parameter layout (models/gpt.py): the same
tree, per-layer tensors stacked on axis 0, matrices (in, out). So the
conversion is a copy, leaf for leaf; nothing is transposed, and a
transposition bug has nowhere to hide. The reference's ``AdamState``
(step, exp_avg tree, exp_avg_sq tree) carries across the same way, so an
optimizer step can be held against the reference from the same state.
"""

from typing import Dict, Optional

import numpy as np
import torch

from ..ops.adam import AdamState, tree_map
from .gpt import GPTConfig, cast_params, param_shapes


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def from_jax_params(tree_of_numpy: Dict, cfg: GPTConfig, device,
                    dtype: Optional[torch.dtype] = None) -> Dict:
    """The reference's params pytree (numpy arrays, or anything
    ``np.asarray`` takes) -> the port's params on ``device``. Keys and
    shapes must match ``param_shapes(cfg)`` exactly. Leaves keep their
    dtype (the reference's are fp32) unless ``dtype`` is given, which casts
    them with ``gpt.cast_params`` (layer norms stay fp32)."""
    want = _flatten(param_shapes(cfg))
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

    params = walk(tree_of_numpy, "")
    return cast_params(params, dtype) if dtype is not None else params


def to_numpy_params(params: Dict) -> Dict:
    """The port's params -> the reference's pytree of numpy arrays (bf16
    leaves come back as fp32, since numpy has no bf16)."""
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


def from_jax_adam_state(state, device) -> AdamState:
    """The reference's ``AdamState`` (numpy or JAX leaves) -> the port's,
    on ``device``, each moment keeping its storage dtype."""
    return AdamState(
        step=int(np.asarray(state.step)),
        exp_avg=tree_map(lambda a: _to_torch(a, device), state.exp_avg),
        exp_avg_sq=tree_map(lambda a: _to_torch(a, device),
                            state.exp_avg_sq))


def to_numpy_adam_state(state: AdamState) -> AdamState:
    """The port's AdamState with numpy leaves (bf16 moments as fp32)."""
    return AdamState(step=int(state.step),
                     exp_avg=to_numpy_params(state.exp_avg),
                     exp_avg_sq=to_numpy_params(state.exp_avg_sq))
