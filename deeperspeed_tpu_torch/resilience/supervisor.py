"""Restart policy of the auto-resume supervisor.

Counterpart of deeperspeed_tpu/resilience/supervisor.py. Ported so far:
``compute_backoff`` (the reference's :74-89), the exponential backoff the
serving router uses between failover retries and replica restarts. The
``Supervisor`` itself (the restart loop, valid-tag discovery, the resume
environment, elastic pool files) comes with the resilience slice
(ROADMAP item 9).
"""

import random
from typing import Callable, Optional


def compute_backoff(failures: int, base: float, factor: float,
                    cap: float, jitter: float = 0.0,
                    rand: Optional[Callable[[], float]] = None) -> float:
    """Delay before restart number ``failures`` (1-based): base *
    factor^(failures-1), capped. ``jitter`` adds a bounded random
    fraction (delay * U[0, jitter]) so a fleet of supervisors killed by
    the same pool event does not restart in lockstep; the jittered delay
    still respects ``cap``. Pure (given ``rand``) so the policy is
    testable; jitter defaults off."""
    if failures <= 0:
        return 0.0
    delay = min(cap, base * factor ** (failures - 1))
    if jitter > 0.0:
        u = (rand or random.random)()
        delay = min(cap, delay * (1.0 + jitter * u))
    return delay
