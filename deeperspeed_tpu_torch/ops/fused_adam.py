"""Fused Adam / AdamW: the whole update of every leaf in one kernel launch.

Counterpart of deeperspeed_tpu/ops/pallas/fused_adam.py. The Pallas kernel
there (``_adam_kernel``, launched per leaf by ``fused_adam_leaf``) becomes
a hand-written multi-tensor CUDA kernel for Hopper in
``csrc/fused_adam.cu``, built at first use by ``op_builder``: ``fused_adam``
updates every leaf of one dtype combination in one launch (at most
``ds_fused_adam_max_leaves()`` leaves a launch, 64; a longer list takes
one launch per 64). Per element, in fp32: the m/v update, bias
correction, L2 or decoupled (AdamW) weight decay and the parameter step;
p, m and v are overwritten in place in their storage dtypes, and with a
cast list the new params are also written, in place, into the cast
tensors' dtype (the master path's compute-dtype params).

The reference's per-leaf TPU rules have no counterpart: its ``_row_block``
VMEM geometry (under which a (2048, 50304) head falls back to XLA) and its
``MIN_AUTO_SIZE`` launch gate. Every leaf, a 0-d one too, rides the one
launch; the math is the same for all of them, so the results are too.

Bound by device-memory bytes: 14 bytes a parameter in masterless bf16,
30 with fp32 master state and a bf16 cast (csrc/fused_adam.cu says why
and how the design meets it).

``adam_plain`` beside it is the plain PyTorch version, the per-leaf math
of the reference's ``FusedAdam`` plus the cast output: the CPU path and
the kernel's parity reference. Both round at the same places, so the
kernel agrees with it bit for bit. ``fused_adam`` takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises, on a dtype combination the kernel does not take too.
``fused_adam.launches`` counts launches. ``group_by_dtypes`` splits a
leaf list into the kernel's dtype combinations.
"""

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..monitor.perf import declares, io_bytes
from . import op_builder
from .kernel_config import takes_plain

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NO_CAST = -1
_DECAY_NONE, _DECAY_L2, _DECAY_ADAMW = 0, 1, 2
# (param and grad, exp_avg, exp_avg_sq, cast or None): what the engine
# builds — masterless bf16 (fp32 exp_avg_sq where beta2 keeps it so), fp32
# master state with the compute-dtype cast, and plain fp32
KERNEL_COMBOS = (
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, None),
    (torch.bfloat16, torch.bfloat16, torch.float32, None),
    (torch.float32, torch.float32, torch.float32, None),
    (torch.float32, torch.float32, torch.float32, torch.bfloat16),
    (torch.float32, torch.float32, torch.float32, torch.float16),
)

_P = ctypes.c_void_p
_F = ctypes.c_float
_I = ctypes.c_int
_SIGNATURES = {
    "ds_adam_error_string": ([_I], ctypes.c_char_p),
    "ds_fused_adam_max_leaves": ([], _I),
    "ds_fused_adam": ([_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F,
                       _F, _F, _F, _I, _P], _I),
}


def _lib():
    return op_builder.load("fused_adam", _SIGNATURES)


def adam_scalars(lr: float, step: int, b1: float, b2: float,
                 bias_correction: bool) -> Tuple[np.float32, np.float32,
                                                 np.float32]:
    """(lr, bc1, bc2) of optimizer step ``step`` (1 for the first), fp32
    on the host, as the reference computes them."""
    if bias_correction:
        bc1 = np.float32(1.0) - np.float32(b1) ** np.float32(step)
        bc2 = np.float32(1.0) - np.float32(b2) ** np.float32(step)
    else:
        bc1 = bc2 = np.float32(1.0)
    return np.float32(lr), bc1, bc2


def adam_plain(ps, gs, ms, vs, cs, lr, bc1, bc2, *, b1, b2, eps, wd,
               adam_w):
    """The plain update of each leaf, in place: p, m, v overwritten in
    their dtypes, and ``cs[i]`` (when ``cs`` and it are not None) given
    the new params in its dtype. Arithmetic in fp32. The bias corrections
    divide as 0-d tensors on the leaf's device, so that the division is a
    true fp32 division everywhere (PyTorch's CUDA division by a Python
    number multiplies by its reciprocal); ``torch.full`` makes them
    without a host-to-device copy, so the update can be captured in a
    CUDA graph."""
    divisors = {}
    for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
        if p.device not in divisors:
            divisors[p.device] = tuple(
                torch.full((), float(x), dtype=torch.float32,
                           device=p.device) for x in (bc1, bc2))
        d1, d2 = divisors[p.device]
        g32 = g.float()
        p32 = p.float()
        if wd and not adam_w:
            g32 = g32 + wd * p32
        m_ = b1 * m.float() + (1.0 - b1) * g32
        v_ = b2 * v.float() + (1.0 - b2) * (g32 * g32)
        denom = torch.sqrt(v_ / d2) + eps
        upd = (m_ / d1) / denom
        if wd and adam_w:
            upd = upd + wd * p32
        new = p32 - float(lr) * upd
        p.copy_(new)
        m.copy_(m_)
        v.copy_(v_)
        if cs is not None and cs[i] is not None:
            cs[i].copy_(new)


def group_by_dtypes(ps, gs, ms, vs, cs=None) -> Dict[tuple, List[int]]:
    """Leaf indices by dtype combination (param, grad, exp_avg,
    exp_avg_sq, cast or None), in leaf order: every leaf in exactly one
    group."""
    groups: Dict[tuple, List[int]] = {}
    for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
        c = None if cs is None or cs[i] is None else cs[i].dtype
        groups.setdefault((p.dtype, g.dtype, m.dtype, v.dtype, c),
                          []).append(i)
    return groups


def _check(ps, gs, ms, vs, cs) -> torch.device:
    n = len(ps)
    if not (len(gs) == len(ms) == len(vs) == n) or (cs is not None
                                                   and len(cs) != n):
        raise ValueError("fused_adam takes lists of one length")
    device = ps[0].device
    first = ps[0], gs[0], ms[0], vs[0], None if cs is None else cs[0]
    combo = (first[0].dtype, first[2].dtype, first[3].dtype,
             None if first[4] is None else first[4].dtype)
    if combo not in KERNEL_COMBOS or first[1].dtype != first[0].dtype:
        raise ValueError(
            f"fused_adam: the kernel takes no dtype combination (param "
            f"{first[0].dtype}, grad {first[1].dtype}, exp_avg "
            f"{first[2].dtype}, exp_avg_sq {first[3].dtype}, cast "
            f"{combo[3]}); it takes (param = grad, exp_avg, exp_avg_sq, "
            f"cast) in {[tuple(str(d) for d in c) for c in KERNEL_COMBOS]}")
    for i in range(n):
        leaf = (ps[i], gs[i], ms[i], vs[i]) + (
            () if cs is None else (cs[i],))
        for name, t, dtype in zip(("param", "grad", "exp_avg", "exp_avg_sq",
                                   "cast"), leaf,
                                  (combo[0], combo[0]) + combo[1:]):
            if t.device != device:
                raise ValueError(f"leaf {i} {name} is on {t.device}, "
                                 f"expected {device}")
            if t.dtype != dtype:
                raise ValueError(f"leaf {i} {name} has dtype {t.dtype}; one "
                                 f"launch takes one dtype combination (see "
                                 f"group_by_dtypes)")
            if t.shape != ps[i].shape:
                raise ValueError(f"leaf {i} {name} has shape "
                                 f"{tuple(t.shape)}, the param "
                                 f"{tuple(ps[i].shape)}")
            if not t.is_contiguous():
                raise ValueError(f"leaf {i} {name} must be contiguous")
    return device


def _adam_work(out, ps, gs, ms, vs, cs, *args, **kwargs):
    """The work the wrapper declares to the cost index (monitor/perf.py):
    no matmul flops; p, g, m and v read, p, m, v and the casts written."""
    return 0, io_bytes(None, ps, gs, ms, vs) + io_bytes(None, ps, ms, vs,
                                                         cs or [])


@declares(_adam_work)
def fused_adam(ps: Sequence[torch.Tensor], gs: Sequence[torch.Tensor],
               ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
               cs: Optional[Sequence[torch.Tensor]], lr, bc1, bc2, *,
               b1: float, b2: float, eps: float, wd: float, adam_w: bool):
    """Adam/AdamW over leaves of ONE dtype combination (``KERNEL_COMBOS``;
    ``group_by_dtypes`` splits a mixed list), in place: the params ``ps``,
    moments ``ms``/``vs`` and, with ``cs``, the cast outputs. ``lr``,
    ``bc1``, ``bc2`` are the step's fp32 scalars (``adam_scalars``). CPU
    tensors take ``adam_plain``; CUDA tensors launch the kernel (one
    launch per 64 leaves) or raise."""
    if not ps:
        return
    if all(takes_plain(t.device) for t in ps):
        return adam_plain(ps, gs, ms, vs, cs, lr, bc1, bc2, b1=b1, b2=b2,
                          eps=eps, wd=wd, adam_w=adam_w)
    if ps[0].device.type != "cuda":
        raise ValueError(f"fused_adam takes CPU or CUDA tensors, got "
                         f"{ps[0].device}")
    device = _check(ps, gs, ms, vs, cs)
    live = [i for i in range(len(ps)) if ps[i].numel() > 0]
    if not live:
        return
    lib = _lib()
    per_launch = lib.ds_fused_adam_max_leaves()
    codes = [_CODES[t.dtype] for t in (ps[0], ms[0], vs[0])]
    c_code = _NO_CAST if cs is None else _CODES[cs[0].dtype]
    decay = (_DECAY_NONE if not wd else _DECAY_ADAMW if adam_w
             else _DECAY_L2)
    stream = torch.cuda.current_stream(device).cuda_stream
    for start in range(0, len(live), per_launch):
        idx = live[start:start + per_launch]
        ptrs = np.array([[ps[i].data_ptr(), gs[i].data_ptr(),
                          ms[i].data_ptr(), vs[i].data_ptr(),
                          0 if cs is None else cs[i].data_ptr()]
                         for i in idx], dtype=np.int64)
        counts = np.array([ps[i].numel() for i in idx], dtype=np.int64)
        with torch.cuda.device(device):
            err = lib.ds_fused_adam(
                ptrs.ctypes.data, counts.ctypes.data, len(idx), *codes,
                c_code, float(lr), float(bc1), float(bc2), float(
                    np.float32(b1)), float(np.float32(1.0 - b1)),
                float(np.float32(b2)), float(np.float32(1.0 - b2)),
                float(np.float32(eps)), float(np.float32(wd)), decay,
                stream)
        if err != 0:
            msg = lib.ds_adam_error_string(err).decode()
            raise RuntimeError(f"fused_adam kernel launch failed: CUDA "
                               f"error {err} ({msg})")
        fused_adam.launches += 1


fused_adam.launches = 0
