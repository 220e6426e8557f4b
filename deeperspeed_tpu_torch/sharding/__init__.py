"""``sharding/``: the named mesh over ``torch.distributed`` ranks, the
``"mesh"`` config block, and ZeRO stages as per-leaf shard specs.

Counterpart of deeperspeed_tpu/sharding/: the dp and fsdp axes (data
parallelism and ZeRO), tp (tensor parallelism, parallel/tp.py) and sp
(sequence parallelism, ops/ring_attention.py), and the rule table that
maps logical dims onto them.
"""

from .config import CANONICAL_AXES, MeshConfig, resolve_extents
from .mesh import (DATA_AXIS, DP_AXIS, FSDP_AXIS, SP_AXIS, TP_AXIS, Mesh,
                   default_mesh, from_config)
from .rules import (DEFAULT_RULES, ShardSpec, add_zero_axis, batch_axes,
                    batch_index, choose_shard_dim, data_parallel_size,
                    logical_spec, place_batch, resolve_rules, sp_axis,
                    sp_size, tp_axis, tp_size, translate_spec, zero_axis,
                    zero_size, zero_tree_specs)

__all__ = [
    "MeshConfig", "CANONICAL_AXES", "resolve_extents", "Mesh",
    "DATA_AXIS", "DP_AXIS", "FSDP_AXIS", "TP_AXIS", "SP_AXIS",
    "from_config", "default_mesh",
    "DEFAULT_RULES", "resolve_rules", "translate_spec", "logical_spec",
    "ShardSpec", "batch_axes", "zero_axis", "tp_axis", "sp_axis",
    "data_parallel_size", "zero_size", "tp_size", "sp_size",
    "batch_index", "place_batch", "choose_shard_dim", "add_zero_axis",
    "zero_tree_specs",
]
