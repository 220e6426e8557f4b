"""Process-global selection state for the hand-written CUDA kernel layer.

Counterpart of deeperspeed_tpu/ops/kernel_config.py: the same "kernels"
config block picks how the fused surfaces execute.

  off    — plain PyTorch everywhere (default; the safe fallback).
  fused  — force the CUDA kernels on every supported call site whose
           tensor lies on a CUDA device. A CPU tensor takes the plain
           version: a CUDA kernel has no interpret mode, so on the CPU
           ``fused`` computes exactly what ``off`` computes.
  auto   — the CUDA kernels on a Hopper card (compute capability 9.0),
           plain PyTorch otherwise. This is the production setting.

Per-surface booleans (fused_blocks / fused_adam / supertile / fused_quant)
narrow a mode to a subset of surfaces, as in the reference. All four
surfaces have kernels in the port: ``fused_blocks`` (LayerNorm,
residual-add LayerNorm, bias+GeLU; ops/fused_blocks.py), ``supertile``
(short-sequence attention; ops/flash_static.py, routed by
ops/flash_attention.py), ``fused_adam`` (the multi-tensor Adam update;
ops/fused_adam.py, routed by ops/adam.py) and ``fused_quant`` (the int8
wire format of the gradient reducer; ops/fused_quant.py, routed by
runtime/comm/reducer.py).

``interpret`` is accepted for config compatibility, but only as False:
there is no interpret mode for a CUDA kernel, and True raises.

The state is process-global (like the monitor tracer) because the
consumers are free functions deep inside model code. Engines configure it
once from the config; tests use ``override()``.
"""

import contextlib
import dataclasses
import threading

import torch

MODES = ("off", "fused", "auto")
SURFACES = ("fused_blocks", "fused_adam", "supertile", "fused_quant")


@dataclasses.dataclass(frozen=True)
class KernelsConfig:
    mode: str = "off"
    interpret: bool = False   # must stay False: no interpret mode on CUDA
    fused_blocks: bool = True
    fused_adam: bool = True
    supertile: bool = True
    fused_quant: bool = True


_LOCK = threading.Lock()
_STATE = KernelsConfig()


def get() -> KernelsConfig:
    return _STATE


def _check(kwargs):
    bad = set(kwargs) - {f.name for f in dataclasses.fields(KernelsConfig)}
    if bad:
        raise ValueError(f"unknown kernels config keys: {sorted(bad)}")
    mode = kwargs.get("mode")
    if mode is not None and mode not in MODES:
        raise ValueError(f"kernels mode must be one of {MODES}, got {mode!r}")
    for k in ("interpret",) + SURFACES:
        if k in kwargs and not isinstance(kwargs[k], bool):
            raise ValueError(f"kernels.{k} must be a bool, got {kwargs[k]!r}")
    if kwargs.get("interpret"):
        raise ValueError("kernels.interpret=True has no counterpart on CUDA: "
                         "a CUDA kernel has no interpret mode")


def validate(params) -> dict:
    """Check a "kernels" config-block dict WITHOUT touching global state."""
    if not isinstance(params, dict):
        raise ValueError('"kernels" must be a dict of KernelsConfig fields')
    _check(params)
    return dict(params)


def configure(**kwargs) -> KernelsConfig:
    """Replace fields of the global kernels config; returns the new value."""
    global _STATE
    _check(kwargs)
    with _LOCK:
        _STATE = dataclasses.replace(_STATE, **kwargs)
        return _STATE


@contextlib.contextmanager
def override(**kwargs):
    """Temporarily swap the global config (tests, scoped experiments)."""
    global _STATE
    with _LOCK:
        prev = _STATE
    try:
        configure(**kwargs)
        yield _STATE
    finally:
        with _LOCK:
            _STATE = prev


def _is_hopper(device: torch.device) -> bool:
    return torch.cuda.get_device_capability(device) == (9, 0)


def resolve(surface: str, device) -> bool:
    """Whether the config routes ``surface`` to its CUDA kernel for a
    tensor on ``device``.

    Never for a non-CUDA device (there is no interpret mode: the caller
    takes the plain version). ``fused`` forces the kernel on any CUDA
    device; ``auto`` fires only on compute capability 9.0. Shape limits
    are the kernel wrapper's job, and it raises on a shape it cannot take.
    """
    st = _STATE
    if surface not in SURFACES:
        raise ValueError(f"unknown kernel surface {surface!r}")
    device = torch.device(device)
    if st.mode == "off" or not getattr(st, surface) or device.type != "cuda":
        return False
    if st.mode == "fused":
        return True
    return _is_hopper(device)


def routes_to_wrapper(surface: str, device) -> bool:
    """Whether a dispatcher sends ``surface`` through its kernel wrapper
    (and the wrapper's autograd Function) for a tensor on ``device``: on
    CUDA exactly when ``resolve`` says so; on the CPU under mode ``fused``,
    where each wrapper takes its plain version. That is the counterpart of
    the reference running its Pallas kernels in interpret mode off the TPU,
    and it lets the CPU tests drive the wrappers' forward and backward."""
    if resolve(surface, device):
        return True
    st = _STATE
    return (torch.device(device).type == "cpu" and st.mode == "fused"
            and getattr(st, surface))
