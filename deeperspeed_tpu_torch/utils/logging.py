"""Logger factory + rank-filtered logging.

Counterpart of deeperspeed_tpu/utils/logging.py; the rank comes from
``torch.distributed`` when a process group is up, else from ``RANK``.
"""

import logging
import os
import sys

import torch.distributed as dist

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


class LoggerFactory:
    @staticmethod
    def create_logger(name=None, level=logging.INFO):
        if name is None:
            raise ValueError("name for logger cannot be None")
        formatter = logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"
        )
        logger_ = logging.getLogger(name)
        logger_.setLevel(level)
        logger_.propagate = False
        if not logger_.handlers:
            ch = logging.StreamHandler(stream=sys.stdout)
            ch.setLevel(level)
            ch.setFormatter(formatter)
            logger_.addHandler(ch)
        return logger_


logger = LoggerFactory.create_logger(
    name="DeeperSpeedTorch",
    level=log_levels.get(os.environ.get("DS_LOG_LEVEL", "info").lower(), logging.INFO),
)


def _current_rank():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def log_dist(message, ranks=None, level=logging.INFO):
    """Log only on the given process ranks (rank -1 or None list => all)."""
    rank = _current_rank()
    should = ranks is None or len(ranks) == 0 or (-1 in ranks) or (rank in ranks)
    if should:
        logger.log(level, f"[Rank {rank}] {message}")
