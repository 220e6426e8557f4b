"""Adam / AdamW over a params tree.

Counterpart of deeperspeed_tpu/ops/adam.py (``FusedAdam``, ``AdamState``).
The update is the reference's per-leaf math in plain PyTorch: every leaf
is cast to fp32, updated, and written back in its storage dtype. Unlike
the reference, which returns new arrays, the port updates the params and
the moments IN PLACE (and returns them): at 1.3B parameters a second copy
of params and moments would cost ~8 GB of device memory.

The fused one-pass kernel (the reference's ``fused_adam_leaf``, PERF.md
kernel row 13) is not ported yet. A "kernels" config that routes the
``fused_adam`` surface to it for a CUDA tensor (mode ``fused``, or
``auto`` on Hopper) raises instead of silently taking the plain update;
set ``"fused_adam": false`` in the block to run the plain update there.
"""

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..utils.logging import logger
from . import kernel_config


class AdamState(NamedTuple):
    step: int
    exp_avg: Any     # tree like params
    exp_avg_sq: Any  # tree like params


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


FUSED_ADAM_UNPORTED = (
    "the fused Adam kernel (PERF.md kernel row 13, ROADMAP.md queue 2) is "
    "not ported to the PyTorch package yet, and the \"kernels\" config "
    "routes fused_adam to it on {device}; set \"fused_adam\": false in the "
    "kernels block to take the plain update")


class FusedAdam:
    """Adam/AdamW over a tree of (usually fp32 master) params.

    ``state_dtype`` selects the moment STORAGE dtype; arithmetic is always
    fp32. The second moment keeps a low-precision state_dtype only when
    its per-step relative update (1 - beta2) is at least 2^-7, about two
    bf16 ulps; below that (e.g. beta2 = 0.999) bf16 would round the
    updates away, so it stays fp32, as in the reference."""

    def __init__(
        self,
        lr: float = 1e-3,
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        adam_w_mode: bool = True,
        bias_correction: bool = True,
        amsgrad: bool = False,
        state_dtype: torch.dtype = torch.float32,
    ):
        if amsgrad:
            raise NotImplementedError("FusedAdam does not support amsgrad")
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction
        self.state_dtype = state_dtype
        self.state_dtype_sq = (state_dtype
                               if (1.0 - self.betas[1]) >= 2.0 ** -7
                               else torch.float32)
        if self.state_dtype_sq != state_dtype:
            logger.warning(
                "FusedAdam: exp_avg_sq kept in fp32 despite state_dtype=%s "
                "— 1-beta2=%.2e is below 2^-7, where bf16 second moments "
                "round updates to zero. Budget +4 bytes/param of optimizer "
                "state, or use beta2 <= 0.992 (e.g. 0.95) for bf16 moments.",
                state_dtype, 1.0 - self.betas[1])

    def init(self, params) -> AdamState:
        return AdamState(
            step=0,
            exp_avg=tree_map(lambda p: torch.zeros_like(
                p, dtype=self.state_dtype), params),
            exp_avg_sq=tree_map(lambda p: torch.zeros_like(
                p, dtype=self.state_dtype_sq), params),
        )

    @staticmethod
    def check_kernel_route(device) -> None:
        """Raise where the "kernels" config sends this update to the
        unported fused kernel."""
        if kernel_config.resolve("fused_adam", device):
            raise NotImplementedError(
                FUSED_ADAM_UNPORTED.format(device=torch.device(device)))

    @torch.no_grad()
    def update(self, grads, state: AdamState, params,
               lr: Optional[float] = None):
        """One step: returns (params, new_state), both updated in place."""
        leaves = tree_leaves(params)
        if leaves:
            self.check_kernel_route(leaves[0].device)
        b1, b2 = self.betas
        lr = np.float32(self.lr if lr is None else lr)
        step = state.step + 1
        if self.bias_correction:
            # fp32, as the reference computes them
            bc1 = np.float32(1.0) - np.float32(b1) ** np.float32(step)
            bc2 = np.float32(1.0) - np.float32(b2) ** np.float32(step)
        else:
            bc1 = bc2 = np.float32(1.0)

        def leaf(p, g, m, v):
            g32 = g.float()
            p32 = p.float()
            if self.weight_decay and not self.adam_w_mode:
                g32 = g32 + self.weight_decay * p32
            m_ = b1 * m.float() + (1.0 - b1) * g32
            v_ = b2 * v.float() + (1.0 - b2) * (g32 * g32)
            denom = torch.sqrt(v_ / float(bc2)) + self.eps
            upd = (m_ / float(bc1)) / denom
            if self.weight_decay and self.adam_w_mode:
                upd = upd + self.weight_decay * p32
            p.copy_(p32 - float(lr) * upd)
            m.copy_(m_)
            v.copy_(v_)

        tree_map(leaf, params, grads, state.exp_avg, state.exp_avg_sq)
        return params, AdamState(step, state.exp_avg, state.exp_avg_sq)
