"""LAMB over a params tree.

Counterpart of deeperspeed_tpu/ops/lamb.py (``FusedLamb``,
``LambState``). The reference has no Pallas LAMB: its update is per-leaf
array math, and so is this one, in plain PyTorch: fp32 moments, bias
correction, weight decay added to the update, and a per-leaf trust ratio
||p|| / ||update|| clamped to [min_coeff, max_coeff] (1.0 when either
norm is 0). The trust ratio is taken per leaf of the tree it is given;
for the models here that is the stacked layout, one leaf per parameter
kind across all layers, as in the reference.

Where a rank keeps only part of a leaf (a ZeRO shard, a cut over a model
axis, or both), the ratio must still be the whole leaf's, as GSPMD's
full-tensor reductions give the reference: ``norm_groups`` (a tree like
the params of ``Transport``s, None for a whole leaf; set by the engines)
names the group a leaf's parts lie over, and the squared partial norms
of the leaf and of its update are summed over it in fp32, one all-reduce
a group a step (``whole_norms``).

Like ops/adam.py, the update writes the params and the moments IN PLACE
(and returns them) instead of building new tensors, which would double
the optimizer's memory. The ratio stays on the device: no host sync.
"""

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .adam import tree_leaves, tree_map


def whole_norms(sq, groups):
    """Each partial leaf's whole-leaf norms from ``sq`` (a leaf's (2,)
    fp32 squared norms of its part of w and of the update; None for a
    whole leaf) and ``groups`` (the Transport its parts lie over): the
    squares summed over the group, the leaves of one group in one
    all-reduce (the groups in the order they first appear: the same on
    every rank of a group). Returns a (2,) tensor (||w||, ||u||) a
    partial leaf, None a whole one."""
    out = [None] * len(sq)
    by_group = {}
    for i, g in enumerate(groups):
        if g is not None:
            by_group.setdefault(id(g), (g, []))[1].append(i)
    for g, idx in by_group.values():
        summed = g.all_reduce_sum(torch.stack([sq[i] for i in idx])).sqrt()
        for j, i in enumerate(idx):
            out[i] = summed[j]
    return out


def trust_ratio(w_norm, u_norm, min_coeff, max_coeff):
    """||w|| / ||u|| clamped to [min_coeff, max_coeff]; 1 where either
    norm is 0."""
    return torch.where(
        (w_norm > 0) & (u_norm > 0),
        torch.clamp(w_norm / u_norm, min_coeff, max_coeff),
        torch.ones_like(w_norm))


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
        # the group each leaf's parts lie over (module docstring)
        self.norm_groups = None

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

        def direction(p, m, v):
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * p.float()
            return upd

        # one tuple a leaf, in the params' key order
        trees = (params, grads, state.exp_avg, state.exp_avg_sq)
        if self.norm_groups is not None:
            trees += (self.norm_groups,)
        rows = [r + (None,) * (5 - len(r))
                for r in tree_leaves(tree_map(lambda *x: x, *trees))]
        for _, g, m, v, _ in rows:
            g32 = g.float()
            m.mul_(b1).add_(g32, alpha=1.0 - b1)
            v.mul_(b2).add_(g32 * g32, alpha=1.0 - b2)
        groups = [r[4] for r in rows]
        # the partial leaves' norms first (one all-reduce a group), then
        # each update from its direction, computed again: the same bits,
        # and no direction kept for every leaf at once
        norms = whole_norms(
            [None if gr is None else torch.stack([
                p.float().square().sum(),
                direction(p, m, v).square().sum()])
             for p, _, m, v, gr in rows],
            groups)
        for (p, _, m, v, _), nm in zip(rows, norms):
            p32 = p.float()
            upd = direction(p, m, v)
            if nm is None:
                nm = (torch.linalg.vector_norm(p32),
                      torch.linalg.vector_norm(upd))
            ratio = trust_ratio(nm[0], nm[1], self.min_coeff,
                                self.max_coeff)
            p.copy_(p32 - lr * ratio * upd)
        return params, LambState(step, state.exp_avg, state.exp_avg_sq)
