"""Adam / AdamW over a params tree.

Counterpart of deeperspeed_tpu/ops/adam.py (``FusedAdam``, ``AdamState``).
Every leaf is cast to fp32, updated, and written back in its storage
dtype. Unlike the reference, which returns new arrays, the port updates
the params and the moments IN PLACE (and returns them): at 1.3B
parameters a second copy of params and moments would cost ~8 GB of
device memory.

The "kernels" block's ``fused_adam`` surface routes the update to the
fused kernel (ops/fused_adam.py, PERF.md kernel row 13): one launch per
dtype combination over all leaves on CUDA (mode ``fused``, or ``auto`` on
Hopper), the wrapper's plain version on the CPU under mode ``fused``.
Otherwise each leaf takes the plain update, which is the same math.
"""

from typing import Any, NamedTuple, Optional

import torch

from ..monitor.tracer import trace_span
from ..utils.logging import logger
from .fused_adam import adam_plain, adam_scalars, fused_adam, group_by_dtypes
from .kernel_config import routes_to_wrapper


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

    @torch.no_grad()
    def update(self, grads, state: AdamState, params,
               lr: Optional[float] = None, cast=None):
        """One step: returns (params, new_state), both updated in place.
        With ``cast`` (a tree like params, e.g. the compute-dtype params of
        a master path) its leaves are given the new params in their own
        dtype, in the same pass."""
        b1, b2 = self.betas
        step = state.step + 1
        lr, bc1, bc2 = adam_scalars(self.lr if lr is None else lr, step, b1,
                                    b2, self.bias_correction)
        ps = tree_leaves(params)
        lists = (ps, tree_leaves(grads), tree_leaves(state.exp_avg),
                 tree_leaves(state.exp_avg_sq),
                 None if cast is None else tree_leaves(cast))
        kw = dict(b1=b1, b2=b2, eps=self.eps, wd=self.weight_decay,
                  adam_w=self.adam_w_mode)
        if ps and routes_to_wrapper("fused_adam", ps[0].device):
            with trace_span("kernels/fused_adam", lane="kernels",
                            leaves=len(ps)):
                for key, idx in group_by_dtypes(*lists).items():
                    ps_, gs_, ms_, vs_, cs_ = (
                        None if t is None else [t[i] for i in idx]
                        for t in lists)
                    fused_adam(ps_, gs_, ms_, vs_,
                               None if key[-1] is None else cs_,
                               lr, bc1, bc2, **kw)
        else:
            adam_plain(*lists, lr, bc1, bc2, **kw)
        return params, AdamState(step, state.exp_avg, state.exp_avg_sq)
