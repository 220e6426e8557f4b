from .loss_scaler import (DynamicLossScaler, LossScaleState,  # noqa: F401
                          StaticLossScaler, create_loss_scaler)
from .fused_optimizer import (FP16_Optimizer,  # noqa: F401
                              FP16_UnfusedOptimizer)
