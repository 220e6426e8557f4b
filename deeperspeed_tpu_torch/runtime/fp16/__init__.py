from .loss_scaler import (DynamicLossScaler, LossScaleState,  # noqa: F401
                          StaticLossScaler, create_loss_scaler)
