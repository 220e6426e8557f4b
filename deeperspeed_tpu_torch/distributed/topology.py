"""Process topology: which ranks share a host.

Counterpart of deeperspeed_tpu/distributed/topology.py. The reference
reads the host of each device off jax's ``process_index``; here every rank
is a process, and the ranks of one host are the consecutive blocks of
``LOCAL_WORLD_SIZE`` ranks that torchrun and similar launchers set up. A
world launched without that variable counts as one host.
"""

import os
from typing import List, Optional, Sequence, Tuple

__all__ = ["local_world_size", "derive_intra_size", "intra_inter_split"]


def local_world_size(world: int) -> int:
    """Ranks per host: ``LOCAL_WORLD_SIZE`` when the launcher set it, else
    the whole world (one host)."""
    env = os.environ.get("LOCAL_WORLD_SIZE")
    return int(env) if env else int(world)


def derive_intra_size(mesh, axes: Sequence[str]) -> Optional[int]:
    """The in-host group size for a hierarchical reduction over ``axes``:
    the count of consecutive same-host ranks along them, or None when the
    reduction stays on one host or host boundaries do not cut it into
    equal contiguous blocks (then the flat schedule is used, rather than
    put the "intra" hop on the cross-host wire)."""
    ranks = mesh.ranks_along(tuple(axes))
    n = len(ranks)
    local = local_world_size(mesh.size)
    hosts = [r // local for r in ranks]
    if n <= 1 or len(set(hosts)) <= 1:
        return None
    k = 1
    while k < n and hosts[k] == hosts[0]:
        k += 1
    if n % k:
        return None
    seen = set()
    for g in range(n // k):
        block = hosts[g * k:(g + 1) * k]
        if len(set(block)) != 1 or block[0] in seen:
            return None
        seen.add(block[0])
    return k


def intra_inter_split(world: int, k: int) -> Tuple[List[List[int]],
                                                   List[List[int]]]:
    """The (intra, inter) rank groups of the two-level schedule for a world
    of ``world`` ranks in host blocks of ``k``."""
    if world % k:
        raise ValueError(f"intra size {k} must divide world {world}")
    nn = world // k
    intra = [[n * k + i for i in range(k)] for n in range(nn)]
    inter = [[n * k + i for n in range(nn)] for i in range(k)]
    return intra, inter
