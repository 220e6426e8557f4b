"""Carry GPT weights between the JAX reference and the port.

The port keeps the reference's parameter layout (models/gpt.py): the same
tree, per-layer tensors stacked on axis 0, matrices (in, out). So the
conversion is a copy, leaf for leaf; nothing is transposed, and a
transposition bug has nowhere to hide.
"""

from typing import Dict, Optional

import numpy as np
import torch

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
