"""Checkpoint files. Counterpart of deeperspeed_tpu/checkpoint/: the
reference's flax msgpack layout (``msgpack``, ``serialization``) and the
``zero_to_fp32`` consolidation tool."""

from .serialization import (CheckpointEngine,  # noqa: F401
                            consolidate_fp32_state, load_tree, read_latest,
                            save_tree, write_latest)
