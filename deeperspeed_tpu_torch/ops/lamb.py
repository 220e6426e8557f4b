"""LAMB over a params tree.

Counterpart of deeperspeed_tpu/ops/lamb.py (``FusedLamb``,
``LambState``). The reference has no Pallas LAMB: its update is per-leaf
array math, and so is this one, in plain PyTorch: fp32 moments, bias
correction, weight decay added to the update, and a per-leaf trust ratio
||p|| / ||update|| clamped to [min_coeff, max_coeff] (1.0 when either
norm is 0). The trust ratio is taken per leaf of the tree it is given;
for the models here that is the stacked layout, one leaf per parameter
kind across all layers, as in the reference.

Like ops/adam.py, the update writes the params and the moments IN PLACE
(and returns them) instead of building new tensors, which would double
the optimizer's memory. The ratio stays on the device: no host sync.
"""

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .adam import tree_map


class LambState(NamedTuple):
    step: int
    exp_avg: Any     # tree like params, fp32
    exp_avg_sq: Any  # tree like params, fp32


class FusedLamb:
    def __init__(
        self,
        lr: float = 1e-3,
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        bias_correction: bool = True,
        max_coeff: float = 10.0,
        min_coeff: float = 0.01,
    ):
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff

    def init(self, params) -> LambState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return LambState(step=0, exp_avg=tree_map(zeros, params),
                         exp_avg_sq=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: LambState, params,
               lr: Optional[float] = None):
        """One step: returns (params, new_state), both updated in place."""
        b1, b2 = self.betas
        lr = float(np.float32(self.lr if lr is None else lr))
        step = state.step + 1
        if self.bias_correction:
            # fp32, as the reference computes them
            bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
            bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
        else:
            bc1 = bc2 = 1.0

        def leaf(p, g, m, v):
            g32 = g.float()
            p32 = p.float()
            m.mul_(b1).add_(g32, alpha=1.0 - b1)
            v.mul_(b2).add_(g32 * g32, alpha=1.0 - b2)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * p32
            w_norm = torch.linalg.vector_norm(p32)
            u_norm = torch.linalg.vector_norm(upd)
            ratio = torch.where(
                (w_norm > 0) & (u_norm > 0),
                torch.clamp(w_norm / u_norm, self.min_coeff, self.max_coeff),
                torch.ones_like(w_norm))
            p.copy_(p32 - lr * ratio * upd)

        tree_map(leaf, params, grads, state.exp_avg, state.exp_avg_sq)
        return params, LambState(step, state.exp_avg, state.exp_avg_sq)
