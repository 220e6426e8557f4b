"""Per-node process launcher.

Counterpart of deeperspeed_tpu/launcher/launch.py (DeepSpeed's
launcher/launch.py): decodes the base64 world-info dict, computes this
node's process ids, and spawns the user script.

- ``--procs_per_node`` processes per host (default 1), the node's cards
  split across them round-robin; each process sees its cards through
  CUDA_VISIBLE_DEVICES (the reference's TPU_VISIBLE_CHIPS). One process
  per card is DeepSpeed's layout.
- Rendezvous env: DS_COORDINATOR_ADDRESS / DS_NUM_PROCESSES /
  DS_PROCESS_ID, read by deeperspeed_tpu_torch.utils.distributed and the
  distributed bootstrap; RANK / LOCAL_RANK / WORLD_SIZE / MASTER_ADDR /
  MASTER_PORT are also set so torchrun-style scripts run unchanged.
- Node rank may be given as an integer or the literal string "env", which
  resolves from NODE_RANK or RANK.

Signals: SIGINT/SIGTERM are forwarded to children; the first non-zero
child exit code is propagated (reference launch.py sig_handler/poll loop).
"""

from __future__ import annotations

import base64
import json
import os
import signal
import subprocess
import sys
import time
from argparse import REMAINDER, ArgumentParser
from collections import defaultdict

from ..utils.logging import logger
from .constants import DISTRIBUTED_DEFAULT_PORT


def parse_args(args=None):
    parser = ArgumentParser(
        description="DeeperSpeed-TPU (PyTorch) per-node launcher: spawns "
        "this node's processes for a distributed job."
    )
    parser.add_argument(
        "--node_rank",
        type=str,
        default="0",
        help="Rank of this node, or 'env' to read NODE_RANK/RANK.",
    )
    parser.add_argument("--master_addr", default="127.0.0.1", type=str)
    parser.add_argument(
        "--master_port", default=DISTRIBUTED_DEFAULT_PORT, type=int
    )
    parser.add_argument(
        "--world_info", default="None", type=str, help="base64 world-info dict"
    )
    parser.add_argument("--procs_per_node", type=int, default=1)
    parser.add_argument("training_script", type=str)
    parser.add_argument("training_script_args", nargs=REMAINDER)
    return parser.parse_args(args=args)


def _resolve_node_rank(token: str) -> int:
    if token != "env":
        return int(token)
    for var in ("NODE_RANK", "RANK"):
        if var in os.environ:
            return int(os.environ[var])
    raise RuntimeError("--node_rank=env but none of NODE_RANK/RANK is set")


def plan_node_processes(world_info, node_rank, procs_per_node):
    """Compute the per-process env layout for this node.

    Returns a list of dicts, one per local process, with keys:
    process_id (global), local_rank, chips (list of local card ids),
    num_processes (global process count), world_size (global card count).
    Slots are divided round-robin-contiguously across procs_per_node.
    """
    node_list = list(world_info.keys())
    if node_rank >= len(node_list):
        raise ValueError(
            f"node_rank {node_rank} out of range for {len(node_list)} nodes"
        )

    world_size = sum(len(v) for v in world_info.values())
    num_processes = 0
    first_pid_by_node = {}
    for node_id in node_list:
        first_pid_by_node[node_id] = num_processes
        n_slots = len(world_info[node_id])
        num_processes += min(procs_per_node, n_slots) if n_slots else 0

    local_node = node_list[node_rank]
    local_slots = world_info[local_node]
    n_procs = min(procs_per_node, len(local_slots))
    base = first_pid_by_node[local_node]

    plans = []
    per = defaultdict(list)
    for i, slot in enumerate(local_slots):
        per[i % n_procs].append(slot)
    for local_rank in range(n_procs):
        plans.append(
            dict(
                process_id=base + local_rank,
                local_rank=local_rank,
                chips=sorted(per[local_rank]),
                num_processes=num_processes,
                world_size=world_size,
            )
        )
    return plans


def main(args=None):
    args = parse_args(args)
    assert args.world_info != "None", "must provide world info dict"
    world_info = json.loads(base64.urlsafe_b64decode(args.world_info))
    logger.info("WORLD INFO DICT: %s", world_info)

    node_rank = _resolve_node_rank(args.node_rank)
    plans = plan_node_processes(world_info, node_rank, args.procs_per_node)
    logger.info(
        "nnodes=%d, node_rank=%d, local procs=%d",
        len(world_info),
        node_rank,
        len(plans),
    )

    current_env = os.environ.copy()
    processes = []
    for plan in plans:
        env = current_env.copy()
        env["DS_COORDINATOR_ADDRESS"] = f"{args.master_addr}:{args.master_port}"
        env["DS_NUM_PROCESSES"] = str(plan["num_processes"])
        env["DS_PROCESS_ID"] = str(plan["process_id"])
        # card visibility; always set so slot filters (--num_chips,
        # --exclude, include slot lists) restrict the cards actually used
        env["CUDA_VISIBLE_DEVICES"] = ",".join(map(str, plan["chips"]))
        # reference-compatible env (launch.py sets RANK/LOCAL_RANK/...)
        env["RANK"] = str(plan["process_id"])
        env["LOCAL_RANK"] = str(plan["local_rank"])
        env["LOCAL_WORLD_SIZE"] = str(len(plans))
        env["WORLD_SIZE"] = str(plan["num_processes"])
        env["MASTER_ADDR"] = args.master_addr
        env["MASTER_PORT"] = str(args.master_port)

        cmd = [sys.executable, "-u", args.training_script] + args.training_script_args
        processes.append(subprocess.Popen(cmd, env=env))

    def sig_handler(signum, frame):
        for p in processes:
            if p.poll() is None:
                p.send_signal(signum)

    signal.signal(signal.SIGINT, sig_handler)
    signal.signal(signal.SIGTERM, sig_handler)

    exit_code = 0
    alive = list(processes)
    while alive:
        for p in list(alive):
            rc = p.poll()
            if rc is None:
                continue
            alive.remove(p)
            if rc != 0 and exit_code == 0:
                exit_code = rc
                # one process failed: bring the rest down (reference
                # behavior is to terminate the job on first failure)
                for q in alive:
                    if q.poll() is None:
                        q.terminate()
        time.sleep(0.1)
    sys.exit(exit_code)


if __name__ == "__main__":
    main()
