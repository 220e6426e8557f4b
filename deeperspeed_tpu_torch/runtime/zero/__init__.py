"""``runtime/zero/``: the ZeRO config block and ZeRO stages 1-2 as shards
of each leaf over the mesh's ZeRO axis (partition.py)."""

from . import constants, partition
from .config import OffloadConfig, ZeroConfig

__all__ = ["ZeroConfig", "OffloadConfig", "constants", "partition"]
