"""Multi-process distributed initialization.

Counterpart of deeperspeed_tpu/utils/distributed.py (DeepSpeed's
``init_distributed`` and ``mpi_discovery``): the same discovery chain,
leading to ``torch.distributed.init_process_group`` (through
:func:`..distributed.bootstrap.initialize_process_group`, the bootstrap's
retry policy) instead of ``jax.distributed.initialize``.

Discovery order:
1. explicit arguments
2. DS_COORDINATOR_ADDRESS / DS_NUM_PROCESSES / DS_PROCESS_ID (set by
   deeperspeed_tpu_torch.launcher.launch and the fleet supervisor)
3. MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK (torchrun-compatible)
4. OpenMPI env (OMPI_COMM_WORLD_*): the mpirun launch path
5. single-process fallback (no-op)
"""

from __future__ import annotations

import os
from typing import Optional

from .logging import logger

_initialized = False


def mpi_discovery():
    """Read rank/world from the OpenMPI environment (env vars, no mpi4py).
    mpirun starts one rank per slot with no per-rank device env, so the
    node-local rank selects the card here (``LOCAL_RANK``), before CUDA
    initializes."""
    env = os.environ
    if "OMPI_COMM_WORLD_SIZE" not in env:
        return None
    world_size = int(env["OMPI_COMM_WORLD_SIZE"])
    rank = int(env["OMPI_COMM_WORLD_RANK"])
    master_addr = env.get("MASTER_ADDR", "127.0.0.1")
    master_port = env.get("MASTER_PORT", "29500")
    local_size = int(env.get("OMPI_COMM_WORLD_LOCAL_SIZE", "1"))
    if local_size > 1 and "LOCAL_RANK" not in env:
        os.environ["LOCAL_RANK"] = env["OMPI_COMM_WORLD_LOCAL_RANK"]
        os.environ.setdefault("LOCAL_WORLD_SIZE", str(local_size))
    return dict(
        coordinator_address=f"{master_addr}:{master_port}",
        num_processes=world_size,
        process_id=rank,
    )


def in_aml() -> bool:
    """Running inside Azure ML?"""
    return "AZUREML_EXPERIMENT_ID" in os.environ


def patch_aml_env():
    """Map the AzureML/MPI env onto MASTER_ADDR/RANK/WORLD_SIZE so the
    standard discovery below finds them."""
    env = os.environ
    if "AZ_BATCH_MASTER_NODE" in env:
        env["MASTER_ADDR"] = env["AZ_BATCH_MASTER_NODE"].split(":")[0]
    elif "AZ_BATCHAI_MPI_MASTER_NODE" in env:
        env["MASTER_ADDR"] = env["AZ_BATCHAI_MPI_MASTER_NODE"]
    env.setdefault("MASTER_PORT", "29500")
    if "OMPI_COMM_WORLD_RANK" in env:
        env.setdefault("RANK", env["OMPI_COMM_WORLD_RANK"])
        env.setdefault("WORLD_SIZE", env["OMPI_COMM_WORLD_SIZE"])
    logger.info(
        "AzureML env: master=%s:%s rank=%s world=%s",
        env.get("MASTER_ADDR"), env.get("MASTER_PORT"),
        env.get("RANK"), env.get("WORLD_SIZE"),
    )


def discover():
    env = os.environ
    if in_aml():
        patch_aml_env()
    if "DS_COORDINATOR_ADDRESS" in env:
        return dict(
            coordinator_address=env["DS_COORDINATOR_ADDRESS"],
            num_processes=int(env["DS_NUM_PROCESSES"]),
            process_id=int(env["DS_PROCESS_ID"]),
        )
    if "MASTER_ADDR" in env and "WORLD_SIZE" in env and "RANK" in env:
        return dict(
            coordinator_address=(
                f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
            ),
            num_processes=int(env["WORLD_SIZE"]),
            process_id=int(env["RANK"]),
        )
    return mpi_discovery()


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    auto_mpi_discovery: bool = True,
) -> bool:
    """Initialize the default ``torch.distributed`` process group.

    Returns True if multi-process init ran (or already had), False for the
    single-process fallback. Idempotent: an already initialized process
    group is adopted.
    """
    global _initialized
    import torch.distributed as dist

    if _initialized or dist.is_initialized():
        _initialized = True
        return True

    if coordinator_address is None:
        found = discover() if auto_mpi_discovery else None
        if found is None:
            logger.info(
                "No distributed environment detected; running "
                "single-process.")
            return False
        coordinator_address = found["coordinator_address"]
        num_processes = found["num_processes"]
        process_id = found["process_id"]
    elif num_processes is None or process_id is None:
        # explicit address but incomplete shape: fill from the environment,
        # and fail loudly rather than silently running single-process
        found = discover() if auto_mpi_discovery else None
        if found is not None:
            num_processes = (found["num_processes"] if num_processes is None
                             else num_processes)
            process_id = (found["process_id"] if process_id is None
                          else process_id)
        if num_processes is None or process_id is None:
            raise ValueError(
                "init_distributed(coordinator_address=...) also needs "
                "num_processes and process_id (not found in environment)")

    if num_processes <= 1:
        logger.info("num_processes<=1; running single-process.")
        return False

    # the bootstrap's rendezvous: the same retry policy and backend
    # choice as a "distributed" config block
    from ..distributed import bootstrap as _bootstrap

    logger.info(
        "init_process_group(coordinator=%s, num_processes=%d, "
        "process_id=%d)", coordinator_address, num_processes, process_id)
    _bootstrap.initialize_process_group(
        coordinator_address, num_processes, process_id)
    _initialized = True
    return True
