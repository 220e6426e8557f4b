"""Launcher constants. Counterpart of deeperspeed_tpu/launcher/constants.py
(DeepSpeed's launcher/constants.py)."""

PDSH_LAUNCHER = "pdsh"
OPENMPI_LAUNCHER = "openmpi"
GCLOUD_LAUNCHER = "gcloud"  # TPU VMs only: refused (runner.py)
SSH_LAUNCHER = "ssh"

PDSH_MAX_FAN_OUT = 1024

# Default coordinator port of the process group's TCPStore (DeepSpeed's
# TORCH_DISTRIBUTED_DEFAULT_PORT).
DISTRIBUTED_DEFAULT_PORT = 29500

DEFAULT_HOSTFILE = "/job/hostfile"

# Env prefixes forwarded to remote workers: DeepSpeed's NCCL/PYTHON/MV2/
# UCX, plus the CUDA and torch knobs and the package's own DS_TPU_*.
EXPORT_ENVS = ["NCCL", "PYTHON", "MV2", "UCX", "CUDA", "TORCH", "DS_TPU"]

ENVIRONMENT_FILE = ".deeperspeed_env"
