"""Multi-host launcher: ``python -m deeperspeed_tpu_torch.launcher <script>``.

Counterpart of deeperspeed_tpu/launcher/ (the deepspeed CLI): hostfile +
include/exclude resource selection, pdsh/ssh/mpirun fan-out, per-node
process spawn with the process-group rendezvous env.
"""

from .runner import (
    encode_world_info,
    fetch_hostfile,
    main,
    parse_args,
    parse_inclusion_exclusion,
    parse_resource_filter,
)
from .launch import plan_node_processes
