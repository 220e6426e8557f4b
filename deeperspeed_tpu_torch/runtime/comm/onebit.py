"""1-bit Adam and 1-bit LAMB.

Counterpart of deeperspeed_tpu/runtime/comm/onebit.py (``OnebitAdam``,
``OnebitLamb``, their states and ``get_lamb_coeffs``): two-phase
optimizers that run exact Adam/LAMB (no bias correction, as the
reference's) up to ``freeze_step``, then freeze the variance (LAMB also
its per-leaf scaling coefficients) and update with an error-compensated
1-bit compression of the momentum: sign(corrected) * mean(|corrected|)
for corrected = momentum + error, the error keeping what the quantization
dropped. Zeros quantize to +scale, the convention the 1-bit wire format
forces (runtime/comm/compressed.py packs ``>= 0`` sign bits).

The state is fp32 (momentum, variance, error, and LAMB's frozen ratios,
one 0-d tensor a leaf); the scale is an fp32 mean. The phase is a host
decision per step (the step counter is a host int), where the reference
selects between both branches on the device; the values are the same.
Like ops/adam.py and ops/lamb.py, ``update`` writes the params and the
state IN PLACE and returns them, and keeps its temporaries to one
fp32 buffer and one byte mask a leaf. The reference has no kernel for
either optimizer; neither has the port.

Where a rank keeps part of a leaf (a tp cut, a ZeRO shard, or both),
``scale_groups`` (set by the engines) names the group its parts lie
over: the 1-bit scale is the whole leaf's mean, and 1-bit LAMB's warmup
ratios take the whole leaf's norms (ops/lamb.py ``whole_norms``); the
frozen ratios stay as they are.
"""

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ...ops.adam import tree_leaves, tree_map
from ...ops.lamb import trust_ratio, whole_norms
from .compressed import _l1_scale

__all__ = ["OnebitAdam", "OnebitAdamState", "OnebitLamb",
           "OnebitLambState"]


def _compress_with_error_feedback(m: torch.Tensor, err: torch.Tensor,
                                  group=None):
    """In place: ``err`` <- m + err - quant and ``m`` <- quant, where quant
    is +-mean(|m + err|) by the sign of m + err (zero as +). With
    ``group`` (a Transport) ``m`` is this rank's part of a leaf split in
    equal parts over the group, and the mean is the whole leaf's. Returns
    the scale."""
    err.add_(m)                      # the corrected momentum
    if group is None:
        scale = _l1_scale(err)
    else:
        l1 = torch.linalg.vector_norm(err, 1, dtype=torch.float32)
        scale = group.all_reduce_sum(l1.reshape(1))[0] / max(
            err.numel() * group.size, 1)
    m.copy_(err.ge(0))               # 1.0 / 0.0
    m.mul_(2.0 * scale).sub_(scale)  # +scale / -scale, exactly
    err.sub_(m)
    return scale


class OnebitAdamState(NamedTuple):
    step: int
    exp_avg: Any     # tree like params, fp32
    exp_avg_sq: Any  # tree like params, fp32
    error: Any       # error-feedback residual a leaf, fp32


def _zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _moments(p, g, m, v, e, b1, b2, warm, group=None):
    """Advance the leaf's momentum, variance and error one step in place;
    returns the leaf's params in fp32."""
    g32 = g.float()
    m.mul_(b1).add_(g32, alpha=1.0 - b1)
    if warm:
        v.mul_(b2).addcmul_(g32, g32, value=1.0 - b2)
    else:
        # the variance is frozen; the momentum goes through the 1-bit
        # error-compensated channel, and what is stored is the quantized
        # (server-synchronized) momentum
        _compress_with_error_feedback(m, e, group)
    return p.float()


def _direction(m, v, eps, wd, p32):
    """m / (sqrt(v) + eps) (+ wd * p), in one new fp32 buffer."""
    upd = torch.sqrt(v).add_(eps)
    torch.div(m, upd, out=upd)
    if wd:
        upd.add_(p32, alpha=wd)
    return upd


class OnebitAdam:
    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, freeze_step=100000, **_unused):
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.freeze_step = int(freeze_step)
        # a tree like the params of Transports (None: a whole leaf): the
        # group a leaf's parts lie over, whose whole leaf the scale is
        # taken over (set by the engine where a rank keeps part of a leaf:
        # cut over a model axis, a ZeRO shard, or both)
        self.scale_groups = None

    def init(self, params) -> OnebitAdamState:
        return OnebitAdamState(step=0, exp_avg=tree_map(_zeros, params),
                               exp_avg_sq=tree_map(_zeros, params),
                               error=tree_map(_zeros, params))

    @torch.no_grad()
    def update(self, grads, state: OnebitAdamState, params,
               lr: Optional[float] = None):
        """One step: returns (params, new_state), both updated in place."""
        b1, b2 = self.betas
        lr = float(np.float32(self.lr if lr is None else lr))
        step = state.step + 1
        warm = step <= self.freeze_step

        def leaf(p, g, m, v, e, group=None):
            p32 = _moments(p, g, m, v, e, b1, b2, warm, group)
            upd = _direction(m, v, self.eps, self.weight_decay, p32)
            upd.mul_(lr)
            p.copy_(torch.sub(p32, upd, out=upd))

        trees = (params, grads, state.exp_avg, state.exp_avg_sq, state.error)
        if self.scale_groups is not None:
            trees += (self.scale_groups,)
        tree_map(leaf, *trees)
        return params, OnebitAdamState(step, state.exp_avg, state.exp_avg_sq,
                                       state.error)


class OnebitLambState(NamedTuple):
    step: int
    exp_avg: Any
    exp_avg_sq: Any
    error: Any
    frozen_ratio: Any  # per-leaf LAMB coefficient (0-d), frozen after warmup


class OnebitLamb:
    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, freeze_step=100000, max_coeff=10.0,
                 min_coeff=0.01, **_unused):
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.freeze_step = int(freeze_step)
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff
        # as OnebitAdam's: the group a leaf's parts lie over, for the
        # 1-bit scale and the warmup's whole-leaf norms (ops/lamb.py)
        self.scale_groups = None

    def init(self, params) -> OnebitLambState:
        def one(p):
            return torch.ones((), dtype=torch.float32, device=p.device)

        return OnebitLambState(step=0, exp_avg=tree_map(_zeros, params),
                               exp_avg_sq=tree_map(_zeros, params),
                               error=tree_map(_zeros, params),
                               frozen_ratio=tree_map(one, params))

    @torch.no_grad()
    def update(self, grads, state: OnebitLambState, params,
               lr: Optional[float] = None):
        """One step: returns (params, new_state), both updated in place."""
        b1, b2 = self.betas
        lr = float(np.float32(self.lr if lr is None else lr))
        step = state.step + 1
        warm = step <= self.freeze_step

        # one tuple a leaf, in the params' key order
        trees = (params, grads, state.exp_avg, state.exp_avg_sq, state.error,
                 state.frozen_ratio)
        if self.scale_groups is not None:
            trees += (self.scale_groups,)
        rows = [r + (None,) * (7 - len(r))
                for r in tree_leaves(tree_map(lambda *x: x, *trees))]
        for p, g, m, v, e, _, gr in rows:
            _moments(p, g, m, v, e, b1, b2, warm, gr)
        groups = [r[6] for r in rows]
        norms = [None] * len(groups)
        if warm:
            # the partial leaves' norms over their groups first, the
            # direction computed again below (the same bits)
            norms = whole_norms(
                [None if gr is None else torch.stack([
                    p.float().square().sum(), _direction(
                        m, v, self.eps, self.weight_decay, p.float())
                    .square().sum()])
                 for p, _, m, v, _, _, gr in rows],
                groups)
        for (p, _, m, v, _, fr, _), nm in zip(rows, norms):
            p32 = p.float()
            upd = _direction(m, v, self.eps, self.weight_decay, p32)
            if warm:
                if nm is None:
                    nm = (torch.linalg.vector_norm(p32),
                          torch.linalg.vector_norm(upd))
                # warmup tracks the live ratio; the one of the freeze step
                # stays (the reference's frozen lamb coefficients)
                fr.copy_(trust_ratio(nm[0], nm[1], self.min_coeff,
                                     self.max_coeff))
            upd.mul_(lr * fr)
            p.copy_(torch.sub(p32, upd, out=upd))
        return params, OnebitLambState(step, state.exp_avg,
                                       state.exp_avg_sq, state.error,
                                       state.frozen_ratio)

    def get_lamb_coeffs(self, state):
        """The current per-leaf coefficients (the reference's
        ``get_lamb_coeffs``)."""
        return tree_leaves(state.frozen_ratio)
