from .logging import log_dist, logger

__all__ = ["logger", "log_dist"]
