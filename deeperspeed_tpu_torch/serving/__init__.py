"""Continuous-batching inference serving on PyTorch.

Counterpart of deeperspeed_tpu/serving: ``ServingEngine`` turns
concurrent requests into fixed-shape decode batches over a slot pool
backed by a paged KV cache. Exports the names the reference's package
exports for the modules ported so far; the pipeline bridge, the fleet
router, its replicas and metrics, and ``SLOTracker`` are not ported yet.
"""

from .config import RouterConfig, ServingConfig, SLOConfig, SpeculativeConfig
from .engine import (
    EngineDrainingError,
    ServingEngine,
    derive_request_seed,
    make_decode_step,
    request_sample_key,
)
from .kv_cache import BlockAllocator, PagedKVCache, PrefixCache, blocks_needed
from .metrics import ServingMetrics
from .scheduler import (
    FINISH_EOS,
    FINISH_FAILED,
    FINISH_LENGTH,
    FINISH_RETRIED,
    FINISH_SHED,
    FINISH_TIMEOUT,
    Request,
    Scheduler,
)

__all__ = [
    "ServingConfig",
    "RouterConfig",
    "SLOConfig",
    "SpeculativeConfig",
    "ServingEngine",
    "EngineDrainingError",
    "make_decode_step",
    "derive_request_seed",
    "request_sample_key",
    "BlockAllocator",
    "PagedKVCache",
    "PrefixCache",
    "blocks_needed",
    "ServingMetrics",
    "Scheduler",
    "Request",
    "FINISH_EOS",
    "FINISH_LENGTH",
    "FINISH_TIMEOUT",
    "FINISH_SHED",
    "FINISH_RETRIED",
    "FINISH_FAILED",
]
