"""``sharding/``: the named mesh over ``torch.distributed`` ranks, the
``"mesh"`` config block, and ZeRO stages as per-leaf shard specs.

Counterpart of deeperspeed_tpu/sharding/ for data parallelism and ZeRO
(the dp and fsdp axes); tensor and sequence parallelism are not ported.
"""

from .config import CANONICAL_AXES, MeshConfig, resolve_extents
from .mesh import (DATA_AXIS, DP_AXIS, FSDP_AXIS, SP_AXIS, TP_AXIS, Mesh,
                   default_mesh, from_config)
from .rules import (ShardSpec, add_zero_axis, batch_axes, batch_index,
                    choose_shard_dim, data_parallel_size, place_batch,
                    zero_axis, zero_size, zero_tree_specs)

__all__ = [
    "MeshConfig", "CANONICAL_AXES", "resolve_extents", "Mesh",
    "DATA_AXIS", "DP_AXIS", "FSDP_AXIS", "TP_AXIS", "SP_AXIS",
    "from_config", "default_mesh",
    "ShardSpec", "batch_axes", "zero_axis", "data_parallel_size",
    "zero_size", "batch_index", "place_batch", "choose_shard_dim",
    "add_zero_axis", "zero_tree_specs",
]
