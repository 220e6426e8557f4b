"""Elastic batch-size / world-size co-design. Counterpart of
deeperspeed_tpu/elasticity/, whole."""

from .elasticity import (
    ElasticityConfig,
    ElasticityError,
    ElasticityConfigError,
    ElasticityIncompatibleWorldSize,
    compute_elastic_config,
    elastic_world_sizes,
    ensure_immutable_elastic_config,
)
from . import constants
