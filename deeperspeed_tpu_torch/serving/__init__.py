"""Continuous-batching inference serving on PyTorch.

Counterpart of deeperspeed_tpu/serving: ``ServingEngine`` turns
concurrent requests into fixed-shape decode batches over a slot pool
backed by a paged KV cache, with drafter-backed speculative decoding
(``spec/``) under a ``"speculative"`` block. On top of single engines,
the fleet layer (``FleetRouter`` over ``ThreadReplica`` /
``SubprocessReplica`` workers) adds admission control, wall-clock
deadlines, health-checked failover and rolling restarts;
``PipelineServingBridge`` serves a pipelined model (a ``PipelineEngine``).
Exports the reference's names.
"""

from .config import RouterConfig, ServingConfig, SLOConfig, SpeculativeConfig
from .engine import (
    EngineDrainingError,
    PipelineServingBridge,
    ServingEngine,
    derive_request_seed,
    make_decode_step,
    request_sample_key,
)
from .fleet import (
    ReplicaUnavailableError,
    SubprocessReplica,
    ThreadReplica,
    build_subprocess_fleet,
    build_thread_fleet,
)
from .kv_cache import BlockAllocator, PagedKVCache, PrefixCache, blocks_needed
from .metrics import FleetMetrics, ServingMetrics, SLOTracker
from .router import FleetRouter, RouterRequest, ShedError
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
    "SLOTracker",
    "SpeculativeConfig",
    "ServingEngine",
    "PipelineServingBridge",
    "EngineDrainingError",
    "make_decode_step",
    "derive_request_seed",
    "request_sample_key",
    "BlockAllocator",
    "PagedKVCache",
    "PrefixCache",
    "blocks_needed",
    "ServingMetrics",
    "FleetMetrics",
    "Scheduler",
    "Request",
    "FleetRouter",
    "RouterRequest",
    "ShedError",
    "ThreadReplica",
    "SubprocessReplica",
    "ReplicaUnavailableError",
    "build_thread_fleet",
    "build_subprocess_fleet",
    "FINISH_EOS",
    "FINISH_LENGTH",
    "FINISH_TIMEOUT",
    "FINISH_SHED",
    "FINISH_RETRIED",
    "FINISH_FAILED",
]
