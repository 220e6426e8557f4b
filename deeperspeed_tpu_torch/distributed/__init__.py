"""Multi-process runtime: process groups over ``torch.distributed``.

Counterpart of deeperspeed_tpu/distributed/. The pieces, bottom-up:

* :mod:`.config`: the validated ``"distributed"`` config block
  (coordinator address, process shape, timeouts, the host-tensor
  backend).
* :mod:`.bootstrap`: ``bootstrap()``, an idempotent
  ``init_process_group`` with retry/backoff, per-host run-context roles,
  the localhost multiprocess capability probe.
* :mod:`.topology`: which ranks share a host (``derive_intra_size``,
  ``intra_inter_split``).
* :mod:`.rendezvous`: atomic per-host records and the clock handshake.
* :mod:`.fleet`: the N-process supervisor, its coordinated restart
  barrier and cross-host pool growth.

The submodules other than :mod:`.topology` load lazily: the comm reducer
imports ``.topology`` on its hot path and must not drag ``.fleet``'s
subprocess machinery in with it.
"""

import importlib

from .topology import derive_intra_size, intra_inter_split, local_world_size

__all__ = [
    "DistributedConfig",
    "bootstrap",
    "config",
    "derive_intra_size",
    "fleet",
    "intra_inter_split",
    "local_world_size",
    "rendezvous",
    "topology",
]

_SUBMODULES = ("bootstrap", "config", "fleet", "rendezvous")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    if name == "DistributedConfig":
        return importlib.import_module(".config", __name__).DistributedConfig
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
