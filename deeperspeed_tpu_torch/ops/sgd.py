"""SGD with momentum, Nesterov and weight decay over a params tree.

Counterpart of deeperspeed_tpu/ops/sgd.py (``SGD``, ``SGDState``), with
torch.optim.SGD's semantics: weight decay added to the gradient, the
momentum buffer ``b = momentum * b + g``, the step ``g + momentum * b``
under Nesterov, else ``b`` (or ``g`` without momentum). The reference has
no kernel for it: this is the same per-leaf fp32 arithmetic in plain
PyTorch. As in ops/adam.py the params and the fp32 buffers are updated
in place (and returned).
"""

from typing import Any, NamedTuple, Optional

import torch

from .adam import tree_map


class SGDState(NamedTuple):
    step: int
    momentum_buf: Any  # tree like params, fp32


class SGD:
    def __init__(self, lr=1e-3, momentum=0.0, weight_decay=0.0,
                 nesterov=False):
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov

    def init(self, params) -> SGDState:
        return SGDState(step=0, momentum_buf=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))

    @torch.no_grad()
    def update(self, grads, state: SGDState, params,
               lr: Optional[float] = None):
        """One step: returns (params, new_state), both updated in place."""
        lr = self.lr if lr is None else lr
        mom = self.momentum

        def leaf(p, g, b):
            g = g.float()
            p32 = p.float()
            if self.weight_decay:
                g = g + self.weight_decay * p32
            b_ = mom * b + g
            d = g + mom * b_ if self.nesterov else (b_ if mom else g)
            p.copy_(p32 - lr * d)
            b.copy_(b_)

        tree_map(leaf, params, grads, state.momentum_buf)
        return params, SGDState(state.step + 1, state.momentum_buf)
