"""Standalone mixed-precision optimizer wrappers.

Counterpart of deeperspeed_tpu/runtime/fp16/fused_optimizer.py
(``FP16_Optimizer``, ``FP16_UnfusedOptimizer``): fp32 master weights,
static or dynamic loss scaling and gradient clipping around a functional
optimizer (``init``/``update``, e.g. ops/adam.py's ``FusedAdam``), for
callers that drive the optimizer themselves rather than through the
engine, which runs the same arithmetic in its own step.

The two classes differ as in the reference: ``FP16_Optimizer`` clips by
the global norm of all gradients, ``FP16_UnfusedOptimizer`` clips each
tensor by its own norm (the per-tensor layout LAMB's norms want). The
compute copy defaults to bf16, as in the reference, so both packages
compute the same thing.

Like the port's optimizers, the update runs in place on the fp32 master
and the optimizer state; ``params`` are the compute-dtype copies,
refreshed in place after each applied step. ``state_dict`` returns
copies (a snapshot), and ``load_state_dict`` copies into the wrapper's
own tensors.
"""

import torch

from ...ops.adam import tree_map
from ...utils.logging import logger
from ..utils import CheckOverflow, clip_by_global_norm, global_norm
from .loss_scaler import DynamicLossScaler, LossScaleState, StaticLossScaler


def _snapshot(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _snapshot(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_snapshot(v) for v in x))
    return x


def _copy_state(dst, src):
    """``src``'s values into ``dst``'s tensors (trees of one structure);
    returns ``dst`` with its non-tensor leaves (a step count) taken from
    ``src``."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(torch.as_tensor(src))
        return dst
    if isinstance(dst, dict):
        for k in dst:
            dst[k] = _copy_state(dst[k], src[k])
        return dst
    if isinstance(dst, tuple) and hasattr(dst, "_fields"):
        return type(dst)(*(_copy_state(d, s) for d, s in zip(dst, src)))
    return src


class FP16_Optimizer:
    """Wraps a functional optimizer with fp32 master weights and loss
    scaling.

    Usage::

        opt = FP16_Optimizer(FusedAdam(lr=1e-3), init_params,
                             dynamic_loss_scale=True)
        scaled_loss = opt.scale_loss(loss)    # before the backward
        skipped = opt.step(scaled_grads)      # grads of the SCALED loss
        half_params = opt.params              # refreshed compute copy
    """

    per_tensor_clip = False

    def __init__(self, optimizer, init_params, static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: dict = None, clip_grad: float = 0.0,
                 compute_dtype=torch.bfloat16, verbose: bool = True):
        self.optimizer = optimizer
        self.clip_grad = clip_grad
        self.compute_dtype = compute_dtype
        self.fp32_params = tree_map(
            lambda p: torch.as_tensor(p).detach().to(torch.float32,
                                                     copy=True),
            init_params)
        self.opt_state = optimizer.init(self.fp32_params)
        if dynamic_loss_scale:
            self.loss_scaler = DynamicLossScaler(**(dynamic_loss_args or {}))
        else:
            self.loss_scaler = StaticLossScaler(scale=static_loss_scale)
        self.scaler_state = self.loss_scaler.init()
        self.overflow = False
        self._last_norm = None
        self._half_params = tree_map(
            lambda p: p.to(self.compute_dtype, copy=True), self.fp32_params)
        if verbose:
            logger.info("FP16_Optimizer: loss scale %s, clip %s",
                        self.cur_scale, clip_grad)

    # ------------------------------------------------------------------ #

    @property
    def cur_scale(self) -> float:
        return float(self.scaler_state.loss_scale)

    @property
    def params(self):
        return self._half_params

    @torch.no_grad()
    def _refresh_half(self):
        tree_map(lambda h, p: h.copy_(p), self._half_params,
                 self.fp32_params)

    def scale_loss(self, loss):
        """The loss times the current scale (the reference's
        ``backward()``)."""
        return loss * self.scaler_state.loss_scale

    backward = scale_loss  # the reference's API name

    def _clip(self, grads):
        norm = global_norm(grads)
        if not self.clip_grad:
            return grads, norm
        if self.per_tensor_clip:
            return tree_map(
                lambda g: clip_by_global_norm({"g": g}, self.clip_grad)[0]
                ["g"], grads), norm
        return clip_by_global_norm(grads, self.clip_grad, norm)

    @torch.no_grad()
    def step(self, grads) -> bool:
        """Unscale, check for overflow, clip, update the master and
        refresh the compute copy. Returns True when the step was skipped
        on an overflow (the scaler then shrinks its scale)."""
        scale = self.scaler_state.loss_scale
        grads32 = tree_map(lambda g: g.float() / scale, grads)
        overflow = bool(CheckOverflow.has_overflow_serial(grads32))
        self.scaler_state = self.loss_scaler.update(self.scaler_state,
                                                    overflow)
        self.overflow = overflow
        if overflow:
            logger.info("FP16_Optimizer overflow: skipping step; "
                        "loss scale -> %s", self.cur_scale)
            return True
        grads32, self._last_norm = self._clip(grads32)
        _, self.opt_state = self.optimizer.update(
            grads32, self.opt_state, self.fp32_params)
        self._refresh_half()
        return False

    # checkpointing ---------------------------------------------------- #

    def state_dict(self) -> dict:
        return {
            "fp32_params": _snapshot(self.fp32_params),
            "opt_state": _snapshot(self.opt_state),
            "scaler_state": self.scaler_state._asdict(),
            "overflow": self.overflow,
        }

    @torch.no_grad()
    def load_state_dict(self, sd: dict):
        _copy_state(self.fp32_params, sd["fp32_params"])
        self.opt_state = _copy_state(self.opt_state, sd["opt_state"])
        sc = sd["scaler_state"]
        if not isinstance(sc, dict):
            sc = sc._asdict()
        self.scaler_state = LossScaleState(float(sc["loss_scale"]),
                                           int(sc["good_steps"]),
                                           int(sc["hysteresis"]))
        self.overflow = bool(sd.get("overflow", False))
        self._refresh_half()


class FP16_UnfusedOptimizer(FP16_Optimizer):
    """Per-tensor clipping: each gradient tensor is clipped by its own
    norm, not the global one."""

    per_tensor_clip = True
