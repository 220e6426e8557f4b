"""lifecycle/: the train->serve control plane.

Counterpart of deeperspeed_tpu/lifecycle/, with the same exports. Two
capabilities the rest of the stack composes:

  * **Live re-mesh**: on a pool-change signal the trainer's ranks agree
    at one optimizer-step boundary on the new world, the ranks past it
    retire (exit 0) and the survivors form a new process group and
    re-place their state in memory (``Engine.remesh``): ZeRO shards
    re-cut from the gathered state, the ``GradReducer`` rebuilt and its
    residuals resharded by ``resilience/reshard.py``, no checkpoint round
    trip and no re-exec. With ``elasticity.canonical_shards`` the losses
    stay bit-identical to an uninterrupted run.
  * **Weight versions**: COMMITTED checkpoint tags become monotonically
    numbered ``WeightVersion`` records (``VERSIONS.json``, byte-compatible
    with the reference's); the fleet router rolling-restarts replicas
    onto new versions with mixed-version routing, and failover retries
    stay pinned to the version that served the first dispatch.

``python -m deeperspeed_tpu_torch.lifecycle`` is the operator CLI
(inspect / publish / retire versions, poke the pool file).
"""

from .config import LifecycleConfig
from .controller import LifecycleController, RolloutDriver, VersionPublisher
from .remesh import RemeshHook, cross_host_growth_needed
from .versions import VERSIONS_FILE, VersionRegistry, WeightVersion, live_tags

__all__ = [
    "LifecycleConfig",
    "LifecycleController",
    "RolloutDriver",
    "VersionPublisher",
    "RemeshHook",
    "cross_host_growth_needed",
    "VERSIONS_FILE",
    "VersionRegistry",
    "WeightVersion",
    "live_tags",
]
