"""``distributed/``: process topology for the hierarchical reduction.

Counterpart of deeperspeed_tpu/distributed/topology.py; the multi-host
bootstrap, rendezvous and fleet of the reference are not ported
(ROADMAP.md queue 1, item 'Resilience and multi-process runtime')."""

from .topology import derive_intra_size, intra_inter_split, local_world_size

__all__ = ["derive_intra_size", "intra_inter_split", "local_world_size"]
