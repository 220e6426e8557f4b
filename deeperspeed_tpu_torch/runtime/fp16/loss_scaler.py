"""Static and dynamic loss scaling as pure state transitions.

Counterpart of deeperspeed_tpu/runtime/fp16/loss_scaler.py: 2x growth per
``scale_window`` clean steps, /2 shrink on overflow with ``delayed_shift``
hysteresis and a ``min_scale`` floor. The state is a small tuple of host
numbers: the engine learns whether a step overflowed (it reads the
gradient norm's finiteness once per step) and calls ``update``.
"""

from typing import NamedTuple


class LossScaleState(NamedTuple):
    loss_scale: float
    good_steps: int  # consecutive non-overflow steps
    hysteresis: int  # remaining tolerated overflows


class DynamicLossScaler:
    def __init__(
        self,
        init_scale=2**32,
        scale_factor=2.0,
        scale_window=1000,
        min_scale=1.0,
        delayed_shift=1,
        consecutive_hysteresis=False,
    ):
        self.init_scale = float(init_scale)
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.min_scale = float(min_scale)
        self.delayed_shift = int(delayed_shift)
        self.consecutive_hysteresis = consecutive_hysteresis
        self.dynamic = True

    def init(self) -> LossScaleState:
        return LossScaleState(loss_scale=self.init_scale, good_steps=0,
                              hysteresis=self.delayed_shift)

    def update(self, state: LossScaleState, overflow: bool) -> LossScaleState:
        """Pure function of (state, overflow)."""
        if overflow:
            # consume hysteresis first; once exhausted, shrink the scale
            if state.hysteresis <= 1:
                scale = max(state.loss_scale / self.scale_factor,
                            self.min_scale)
                return LossScaleState(scale, 0, state.hysteresis)
            return LossScaleState(state.loss_scale, 0, state.hysteresis - 1)
        good = state.good_steps + 1
        scale = (state.loss_scale * self.scale_factor
                 if good % self.scale_window == 0 else state.loss_scale)
        hysteresis = (self.delayed_shift if self.consecutive_hysteresis
                      else state.hysteresis)
        return LossScaleState(scale, good, hysteresis)


class StaticLossScaler(DynamicLossScaler):
    def __init__(self, scale=1.0):
        super().__init__(init_scale=scale)
        self.dynamic = False

    def update(self, state: LossScaleState, overflow: bool) -> LossScaleState:
        return state


def create_loss_scaler(precision, static_loss_scale=0, dynamic_args=None):
    """The engine's loss-scaler selection: fp16 with loss_scale 0 =>
    dynamic; otherwise static (bf16/fp32 default to static 1.0)."""
    if precision == "fp16" and static_loss_scale == 0:
        args = dynamic_args or {}
        return DynamicLossScaler(
            init_scale=args.get("init_scale", 2**32),
            scale_window=args.get("scale_window", 1000),
            delayed_shift=args.get("delayed_shift", 2),
            min_scale=args.get("min_scale", 1.0),
        )
    scale = static_loss_scale if static_loss_scale else 1.0
    return StaticLossScaler(scale=scale)
