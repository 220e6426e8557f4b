from .transformer import (
    TransformerConfig,
    DeepSpeedTransformerConfig,
    DeepSpeedTransformerLayer,
    init_transformer_params,
    transformer_layer_fn,
)
