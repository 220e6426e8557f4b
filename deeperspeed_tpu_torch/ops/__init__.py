"""The port's ops: optimizers and the kernel wrappers (each module of
this package is imported where it is used; nothing is built at import)."""

from .adam import AdamState, DeepSpeedCPUAdam, FusedAdam  # noqa: F401
