"""Multi-node launch backends.

Counterpart of deeperspeed_tpu/launcher/multinode_runner.py: pdsh and
plain-ssh fan-out, and mpirun for MPI sites, building the reference's
commands around ``python -m deeperspeed_tpu_torch.launcher.launch``. The
reference's ``GCloudRunner`` launches onto TPU VMs and has no GPU
counterpart; ``--launcher gcloud`` raises (runner.py).
"""

from __future__ import annotations

import os
import shlex
import shutil
import sys
from abc import ABC, abstractmethod

from .constants import PDSH_MAX_FAN_OUT


def launch_module_args(
    world_info_base64, master_addr, master_port, procs_per_node, node_rank_token=None
):
    """The shared ``python -m deeperspeed_tpu_torch.launcher.launch`` arg list:
    single source of truth for local and multi-node launch paths."""
    cmd = [
        sys.executable,
        "-u",
        "-m",
        "deeperspeed_tpu_torch.launcher.launch",
        f"--world_info={world_info_base64}",
        f"--master_addr={master_addr}",
        f"--master_port={master_port}",
        f"--procs_per_node={procs_per_node}",
    ]
    if node_rank_token is not None:
        cmd.append(f"--node_rank={node_rank_token}")
    return cmd


class MultiNodeRunner(ABC):
    def __init__(self, args, world_info_base64):
        self.args = args
        self.user_arguments = self.parse_user_args()
        self.user_script = args.user_script
        self.world_info_base64 = world_info_base64
        self.exports = {}

    @abstractmethod
    def backend_exists(self):
        ...

    @abstractmethod
    def get_cmd(self, environment, active_resources):
        ...

    def add_export(self, key, var):
        self.exports[key.strip()] = var.strip()

    def parse_user_args(self):
        return self.args.user_args

    def _launch_module_args(self, node_rank_token):
        return launch_module_args(
            self.world_info_base64,
            self.args.master_addr,
            self.args.master_port,
            self.args.procs_per_node,
            node_rank_token=node_rank_token,
        )

    def _exports_prefix(self) -> str:
        return "".join(
            f"export {key}={shlex.quote(val)}; "
            for key, val in self.exports.items()
        )


class PDSHRunner(MultiNodeRunner):
    """pdsh fan-out: %n expands to the per-host index (node rank)."""

    def backend_exists(self):
        return shutil.which("pdsh")

    def parse_user_args(self):
        return [
            x if x.startswith("-") else f"'{x}'" for x in self.args.user_args
        ]

    def get_cmd(self, environment, active_resources):
        environment["PDSH_RCMD_TYPE"] = "ssh"
        active_workers = ",".join(active_resources.keys())
        pdsh_cmd_args = ["pdsh", "-f", str(PDSH_MAX_FAN_OUT), "-w", active_workers]
        if self.args.launcher_args:
            pdsh_cmd_args += self.args.launcher_args.split()

        launch = (
            [self._exports_prefix(), f"cd {os.path.abspath('.')};"]
            + self._launch_module_args("%n")
        )
        return pdsh_cmd_args + launch + [self.user_script] + self.user_arguments


class SSHRunner(MultiNodeRunner):
    """Plain-ssh fan-out via a generated bash command: one ssh per host,
    backgrounded, with 'wait' to propagate failures. No pdsh dependency."""

    def backend_exists(self):
        return shutil.which("ssh")

    def get_cmd(self, environment, active_resources):
        exports = self._exports_prefix()
        workdir = os.path.abspath(".")
        per_host = []
        for node_rank, host in enumerate(active_resources.keys()):
            launch = " ".join(
                shlex.quote(a)
                for a in self._launch_module_args(node_rank)
                + [self.user_script]
                + self.user_arguments
            )
            remote = f"{exports}cd {workdir}; {launch}"
            ssh_args = self.args.launcher_args or ""
            per_host.append(f"ssh {ssh_args} {host} {shlex.quote(remote)} &")
            per_host.append("pids+=($!)")
        # collect each child's status so a failing node fails the launch
        script = "\n".join(
            ["pids=()"]
            + per_host
            + ["rc=0", 'for p in "${pids[@]}"; do wait "$p" || rc=$?; done', "exit $rc"]
        )
        return ["bash", "-c", script]


class OpenMPIRunner(MultiNodeRunner):
    """mpirun -n <procs> with one rank per (host, slot): ranks discover
    their ids via the OMPI env (utils/distributed.mpi_discovery)."""

    def __init__(self, args, world_info_base64, resource_pool):
        super().__init__(args, world_info_base64)
        self.resource_pool = resource_pool
        self.add_export("UCX_TLS", "tcp")

    def backend_exists(self):
        return shutil.which("ompi_info")

    def get_cmd(self, environment, active_resources):
        if self.args.include or self.args.exclude:
            raise ValueError(
                "openmpi backend does not support worker include/exclusion"
            )
        if self.args.num_nodes != -1 or self.args.num_chips != -1:
            raise ValueError(
                "openmpi backend does not support limiting num nodes/chips"
            )
        # every rank needs the coordinator address for the process-group
        # rendezvous (mpi_discovery reads MASTER_ADDR/MASTER_PORT)
        self.add_export("MASTER_ADDR", str(self.args.master_addr))
        self.add_export("MASTER_PORT", str(self.args.master_port))
        total_process_count = sum(self.resource_pool.values())
        mpirun_cmd = [
            "mpirun",
            "-n",
            str(total_process_count),
            "-hostfile",
            self.args.hostfile,
            "--mca",
            "btl",
            "^openib",
            "--mca",
            "btl_tcp_if_include",
            "eth0",
        ]
        if self.args.launcher_args:
            mpirun_cmd += self.args.launcher_args.split()
        export_cmd = []
        for key, val in self.exports.items():
            export_cmd += ["-x", f"{key}={val}"]
        return (
            mpirun_cmd
            + export_cmd
            + [sys.executable, "-u", self.user_script]
            + self.user_arguments
        )
