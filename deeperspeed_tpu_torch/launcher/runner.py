"""Multi-host job runner: the ``deeperspeed`` CLI front-end.

Counterpart of deeperspeed_tpu/launcher/runner.py (DeepSpeed's
launcher/runner.py): parses an MPI-style hostfile ("worker-0 slots=4",
slots are cards), applies include/exclude resource filters with the same
NODE_SPEC grammar, encodes the active resources as a base64 world-info
blob, and fans out one per-node ``deeperspeed_tpu_torch.launcher.launch``
invocation via pdsh / plain ssh / mpirun, or runs locally when no
hostfile is given (the local card count is ``torch.cuda.device_count()``).

The rendezvous env is the process group's (coordinator address and
process count), with RANK/WORLD_SIZE/MASTER_ADDR also set. One departure:
``--launcher gcloud`` (``gcloud compute tpus tpu-vm ssh``) launches onto
TPU VMs and has no GPU counterpart, so it raises.
"""

from __future__ import annotations

import argparse
import base64
import collections
import json
import os
import subprocess
import sys
from copy import deepcopy

from ..utils.logging import logger
from .constants import (
    DEFAULT_HOSTFILE,
    DISTRIBUTED_DEFAULT_PORT,
    ENVIRONMENT_FILE,
    EXPORT_ENVS,
    GCLOUD_LAUNCHER,
    OPENMPI_LAUNCHER,
    PDSH_LAUNCHER,
    SSH_LAUNCHER,
)
from .multinode_runner import (
    OpenMPIRunner,
    PDSHRunner,
    SSHRunner,
    launch_module_args,
)


def parse_args(args=None):
    parser = argparse.ArgumentParser(
        prog="deeperspeed",
        description="DeeperSpeed-TPU (PyTorch) runner: launch multi-host "
        "training jobs across any ssh-reachable cluster.",
    )
    parser.add_argument(
        "-H",
        "--hostfile",
        type=str,
        default=DEFAULT_HOSTFILE,
        help="MPI-style hostfile defining the resource pool "
        "(e.g. 'worker-0 slots=4', slots = cards).",
    )
    parser.add_argument(
        "-i",
        "--include",
        type=str,
        default="",
        help="Resources to use: NODE_SPEC[@NODE_SPEC ...] where "
        "NODE_SPEC=NAME[:SLOT[,SLOT ...]]. Omitting :SLOT takes every slot.",
    )
    parser.add_argument(
        "-e",
        "--exclude",
        type=str,
        default="",
        help="Resources NOT to use; same grammar as --include, mutually "
        "exclusive with it.",
    )
    parser.add_argument(
        "--num_nodes",
        type=int,
        default=-1,
        help="Use only the first N hosts of the hostfile.",
    )
    parser.add_argument(
        "--num_chips",
        "--num_gpus",
        dest="num_chips",
        type=int,
        default=-1,
        help="Max cards per node; uses card ids [0, N).",
    )
    parser.add_argument(
        "--master_port",
        default=DISTRIBUTED_DEFAULT_PORT,
        type=int,
        help="Port of the process group's coordinator (TCPStore).",
    )
    parser.add_argument(
        "--master_addr",
        default="",
        type=str,
        help="Address of node 0; inferred via 'hostname -I' over ssh if unset.",
    )
    parser.add_argument(
        "--launcher",
        default=PDSH_LAUNCHER,
        type=str,
        help="Multi-node backend: pdsh, ssh or openmpi (gcloud, the "
        "reference's TPU VM backend, raises).",
    )
    parser.add_argument(
        "--launcher_args",
        default="",
        type=str,
        help="Extra args passed through to the launcher backend.",
    )
    parser.add_argument(
        "--force_multi",
        action="store_true",
        help="Force multi-node launch even for a single host.",
    )
    parser.add_argument(
        "--procs_per_node",
        type=int,
        default=1,
        help="Processes per host (default 1; one per card is DeepSpeed's "
        "layout: set it to the card count).",
    )
    parser.add_argument(
        "user_script",
        type=str,
        help="User training script, followed by its arguments.",
    )
    parser.add_argument("user_args", nargs=argparse.REMAINDER)
    return parser.parse_args(args=args)


def fetch_hostfile(hostfile_path):
    """Parse 'hostname slots=N' lines into an ordered {host: slot_count}.

    Mirrors reference launcher/runner.py:122 semantics: empty lines skipped,
    malformed lines and duplicate hosts raise ValueError, order preserved.
    """
    if not os.path.isfile(hostfile_path):
        logger.warning(
            "Unable to find hostfile %s, proceeding with local resources only.",
            hostfile_path,
        )
        return None

    resource_pool = collections.OrderedDict()
    with open(hostfile_path, "r") as fd:
        for line in fd.readlines():
            line = line.strip()
            if line == "" or line.startswith("#"):
                continue
            try:
                hostname, slots = line.split()
                key, slot_count = slots.split("=")
                if key != "slots":
                    raise ValueError(key)
                slot_count = int(slot_count)
            except ValueError:
                raise ValueError(
                    f"Hostfile is not formatted correctly: {line!r} "
                    "(expected 'hostname slots=N')"
                )
            if hostname in resource_pool:
                raise ValueError(f"host {hostname} is already defined")
            resource_pool[hostname] = slot_count
    return resource_pool


def parse_resource_filter(host_info, include_str="", exclude_str=""):
    """Filter {host: [slot ids]} by an include or exclude NODE_SPEC string.

    Grammar (reference launcher/runner.py:155): NODE_SPEC[@NODE_SPEC ...],
    NODE_SPEC = NAME[:SLOT[,SLOT ...]]; bare NAME means every slot.
    include and exclude are mutually exclusive; host order is preserved.
    """
    NODE_SEP = "@"
    SLOT_LIST_START = ":"
    SLOT_SEP = ","

    if include_str and exclude_str:
        raise ValueError("include_str and exclude_str are mutually exclusive.")
    if not include_str and not exclude_str:
        return host_info

    filtered_hosts = dict()
    if include_str:
        parse_str = include_str
    else:
        filtered_hosts = deepcopy(host_info)
        parse_str = exclude_str

    for node_config in parse_str.split(NODE_SEP):
        if SLOT_LIST_START in node_config:
            hostname, slots = node_config.split(SLOT_LIST_START)
            slots = [int(x) for x in slots.split(SLOT_SEP)]
            if hostname not in host_info:
                raise ValueError(f"Hostname '{hostname}' not found in hostfile")
            for s in slots:
                if s not in host_info[hostname]:
                    raise ValueError(
                        f"No slot '{s}' specified on host '{hostname}'"
                    )
            if include_str:
                filtered_hosts[hostname] = slots
            else:
                for s in slots:
                    filtered_hosts[hostname].remove(s)
        else:
            hostname = node_config
            if hostname not in host_info:
                raise ValueError(f"Hostname '{hostname}' not found in hostfile")
            if include_str:
                filtered_hosts[hostname] = host_info[hostname]
            else:
                filtered_hosts[hostname] = []

    ordered_hosts = collections.OrderedDict()
    for host in host_info:
        if host not in filtered_hosts:
            continue
        slots = sorted(set(filtered_hosts[host]))
        if slots:
            ordered_hosts[host] = slots
    return ordered_hosts


def parse_inclusion_exclusion(resource_pool, inclusion, exclusion):
    active_resources = collections.OrderedDict()
    for hostname, slots in resource_pool.items():
        active_resources[hostname] = list(range(slots))
    return parse_resource_filter(
        active_resources, include_str=inclusion, exclude_str=exclusion
    )


def encode_world_info(world_info):
    world_info_json = json.dumps(world_info).encode("utf-8")
    return base64.urlsafe_b64encode(world_info_json).decode("utf-8")


def _local_chip_count() -> int:
    """The local card count (CUDA_VISIBLE_DEVICES respected); 1 without a
    card."""
    try:
        import torch

        return max(1, torch.cuda.device_count())
    except Exception:
        return 1


def _build_launch_cmd(args, world_info_base64, node_rank=None):
    cmd = launch_module_args(
        world_info_base64,
        args.master_addr,
        args.master_port,
        args.procs_per_node,
        node_rank_token=node_rank,
    )
    return cmd + [args.user_script] + args.user_args


def main(args=None):
    args = parse_args(args)
    if args.launcher.lower() == GCLOUD_LAUNCHER:
        raise NotImplementedError(
            "--launcher gcloud fans a job out to Cloud TPU VMs ('gcloud "
            "compute tpus tpu-vm ssh --worker=all'), which has no GPU "
            "counterpart in the PyTorch package; use pdsh, ssh or openmpi")

    if (args.num_nodes >= 0 or args.num_chips >= 0) and (
        args.include != "" or args.exclude != ""
    ):
        raise ValueError("Cannot specify num_nodes/chips with include/exclude")

    resource_pool = fetch_hostfile(args.hostfile)
    multi_node_exec = resource_pool is not None
    if resource_pool is None:
        resource_pool = collections.OrderedDict(localhost=_local_chip_count())
        args.master_addr = "127.0.0.1"

    if not multi_node_exec and args.num_nodes > 1:
        raise ValueError("num_nodes > 1 but no extra nodes in hostfile")

    active_resources = parse_inclusion_exclusion(
        resource_pool, args.include, args.exclude
    )

    env = os.environ.copy()

    # env fills in the coordinator only when the CLI flag was left unset —
    # an explicit --master_addr wins over an inherited MASTER_ADDR
    if not args.master_addr and "MASTER_ADDR" in os.environ:
        args.master_addr = os.environ["MASTER_ADDR"]
        args.master_port = int(os.environ.get("MASTER_PORT", args.master_port))
    if not args.master_addr:
        first_host = list(active_resources.keys())[0]
        result = subprocess.check_output(
            [f"ssh {first_host} hostname -I"], shell=True
        )
        args.master_addr = result.decode("utf-8").split()[0]
        logger.info("Using IP %s for node %s", args.master_addr, first_host)

    if args.num_nodes > 0:
        active_resources = collections.OrderedDict(
            list(active_resources.items())[: args.num_nodes]
        )
    if args.num_chips > 0:
        for hostname in active_resources:
            n = min(args.num_chips, len(active_resources[hostname]))
            active_resources[hostname] = list(range(n))

    world_info_base64 = encode_world_info(active_resources)
    multi_node_exec = args.force_multi or len(active_resources) > 1

    if not multi_node_exec:
        # single-node world_info always has exactly one node; never inherit
        # a stale RANK from the shell as a node rank
        cmd = _build_launch_cmd(args, world_info_base64, node_rank=None)
    else:
        launcher = args.launcher.lower()
        if launcher == PDSH_LAUNCHER:
            runner = PDSHRunner(args, world_info_base64)
        elif launcher == SSH_LAUNCHER:
            runner = SSHRunner(args, world_info_base64)
        elif launcher == OPENMPI_LAUNCHER:
            runner = OpenMPIRunner(args, world_info_base64, resource_pool)
        else:
            raise NotImplementedError(f"Unknown launcher {args.launcher}")

        if not runner.backend_exists():
            raise RuntimeError(f"launcher '{launcher}' is not installed.")

        curr_path = os.path.abspath(".")
        env["PYTHONPATH"] = (
            curr_path + ":" + env["PYTHONPATH"] if "PYTHONPATH" in env else curr_path
        )
        for var in env:
            if any(var.startswith(name) for name in EXPORT_ENVS):
                runner.add_export(var, env[var])
        for environ_path in (os.path.expanduser("~"), "."):
            environ_file = os.path.join(environ_path, ENVIRONMENT_FILE)
            if os.path.isfile(environ_file):
                with open(environ_file, "r") as fd:
                    for var in fd.readlines():
                        var = var.strip()
                        if not var or var.startswith("#") or "=" not in var:
                            continue
                        key, val = var.split("=", 1)
                        runner.add_export(key, val)
        cmd = runner.get_cmd(env, active_resources)

    logger.info("cmd = %s", " ".join(cmd))
    result = subprocess.Popen(cmd, env=env)
    result.wait()
    if result.returncode != 0:
        # negative returncode = killed by signal; surface as failure too
        sys.exit(result.returncode if result.returncode > 0 else 1)


if __name__ == "__main__":
    main()
