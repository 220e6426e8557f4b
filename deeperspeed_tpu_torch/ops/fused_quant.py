"""Blockwise int8 wire-format kernels of the gradient reducer.

Counterpart of deeperspeed_tpu/ops/pallas/fused_quant.py. Its three Pallas
kernels become hand-written CUDA kernels for Hopper in
``csrc/fused_quant.cu``, built at first use by ``op_builder``:

  ``quantize_rows``     replaces ``_quant_kernel`` and
                        ``_quant_residual_kernel``: per block of ``block``
                        values of (R, C) rows, s = max|x| / 127 (1 for an
                        all-zero block), q = rint(x / s) as int8 and,
                        optionally, the error-feedback residual x - q * s,
                        from one read of x.
  ``dequant_sum_rows``  replaces ``_dequant_sum_kernel``: the (C,) fp32 sum
                        over the R received rows of q * s, without R
                        dequantized copies; q is int8, or the fp16
                        mantissas of the 24-bit compressed wire.
  ``dequant_rows``      replaces ``_dequant_kernel``: (q * s) / divisor,
                        (R, C) fp32 (divisor = world size for the mean).

All three are bound by device-memory bytes; csrc/fused_quant.cu says how
each design meets that. ``pack_wire``/``unpack_wire`` put the fp32 scales
as 4 trailing bytes per block into one int8 payload, so each collective
phase ships one tensor; in torch they are bitcasts (``view``), not
kernels.

Beside each wrapper sits its plain PyTorch version (``*_plain``), the
reference's XLA route: the CPU path and the card check's reference. The
kernels take the same rounding steps in the same order, so they agree
with the plain versions bit for bit: x / s is a true division, q * s is
rounded before it is added or subtracted, the R-row sum runs over r in
ascending order, ``torch.round`` rounds half to even like ``rintf``, and
the int8 cast saturates with NaN -> 0 on every device. Scalar divisors
are 0-d tensors on the data's device, because PyTorch's CUDA division by a
Python number multiplies by its reciprocal. A block holding a NaN has
max|x| = NaN, hence s = 1 (NaN > 0 is false), q = 0 where x is NaN and a
NaN residual there; ``torch.amax`` and the kernel's max both propagate
the NaN, as ``jnp.max`` does.

A wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises (a dtype or shape the kernel
does not take, a ``block`` that does not divide C). Every ``block`` >= 1
that divides C is taken; block 128 has the vectorized path. Each wrapper
counts its launches in a plain integer attribute (``quantize_rows.
launches``, ...). ``routing`` reads the "kernels" block's ``fused_quant``
surface for the reducer.
"""

import ctypes

import torch

from ..monitor.perf import declares, io_bytes
from . import op_builder
from .kernel_config import routes_to_wrapper, takes_plain

_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
_Q_CODES = {torch.int8: 0, torch.float16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "ds_quant_error_string": ([_I], ctypes.c_char_p),
    "ds_quantize_rows": ([_P, _I, _P, _P, _P, _L, _L, _I, _I, _P], _I),
    "ds_dequant_sum_rows": ([_P, _I, _P, _P, _I, _L, _I, _I, _P], _I),
    "ds_dequant_rows": ([_P, _P, _P, _L, _L, _I, ctypes.c_float, _I, _P],
                        _I),
}


def _lib():
    return op_builder.load("fused_quant", _SIGNATURES)


def _raise_on(err: int, name: str):
    if err != 0:
        msg = _lib().ds_quant_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")


def routing(device) -> bool:
    """Whether the reducer's wire math on ``device`` goes through the
    kernel wrappers (``True``) or straight to the plain versions: the
    "kernels" block's ``fused_quant`` surface, as ops/kernel_config.py
    resolves it (on the CPU under mode ``fused`` the wrappers take their
    plain versions)."""
    return routes_to_wrapper("fused_quant", device)


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def _check_block(C: int, block: int, name: str):
    if block < 1 or C % block:
        raise ValueError(f"{name}: block {block} must be >= 1 and divide "
                         f"the row length {C}")


# ---------------------------------------------------------------------- #
# quantize (+ scale, + residual)
# ---------------------------------------------------------------------- #


def quantize_rows_plain(x: torch.Tensor, block: int,
                        want_residual: bool = True):
    """The plain version: ``(q (R, C) int8, s (R, C // block) fp32,
    residual (R, C) fp32 | None)``."""
    R, C = x.shape
    _check_block(C, block, "quantize_rows")
    nb = C // block
    xb = x.float().reshape(R, nb, block)
    s = torch.amax(xb.abs(), dim=2) / _scalar(127.0, x)
    s = torch.where(s > 0, s, torch.ones_like(s))
    qf = torch.round(xb / s[:, :, None])
    q = torch.where(torch.isnan(qf), torch.zeros_like(qf),
                    qf.clamp(-128.0, 127.0)).to(torch.int8)
    r = (xb - qf * s[:, :, None]).reshape(R, C) if want_residual else None
    return q.reshape(R, C), s, r


def _wire_work(out, *args, **kwargs):
    """The work a wrapper declares to the cost index (monitor/perf.py): no
    matmul flops, each input read and each output written once."""
    return 0, io_bytes(out, *args, **kwargs)


@declares(_wire_work)
def quantize_rows(x: torch.Tensor, block: int, want_residual: bool = True):
    """Blockwise int8 quantization of ``(R, C)`` rows (``block | C``), fp32
    or bf16: ``(q, s, residual | None)`` as ``quantize_rows_plain``. CPU
    tensors take the plain version; CUDA tensors launch
    ``ds_quantize_rows`` or raise."""
    if takes_plain(x.device):
        return quantize_rows_plain(x, block, want_residual)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows takes CPU or CUDA tensors, got "
                         f"{x.device}")
    if x.dim() != 2 or x.dtype not in _X_CODES:
        raise ValueError(f"quantize_rows takes (R, C) fp32 or bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    R, C = x.shape
    _check_block(C, block, "quantize_rows")
    x = x.contiguous()
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    s = torch.empty((R, C // block), dtype=torch.float32, device=x.device)
    r = (torch.empty((R, C), dtype=torch.float32, device=x.device)
         if want_residual else None)
    vec = int(block == 128 and all(
        t.data_ptr() % 16 == 0 for t in (x, q) + ((r,) if r is not None
                                                  else ())))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib().ds_quantize_rows(
            x.data_ptr(), _X_CODES[x.dtype], q.data_ptr(), s.data_ptr(),
            0 if r is None else r.data_ptr(), R, C, block, vec, stream)
    _raise_on(err, "quantize_rows")
    quantize_rows.launches += 1
    return q, s, r


quantize_rows.launches = 0


# ---------------------------------------------------------------------- #
# dequant + accumulate over rows
# ---------------------------------------------------------------------- #


def dequant_sum_rows_plain(q: torch.Tensor, s: torch.Tensor,
                           block: int) -> torch.Tensor:
    """The plain version: ``sum_r q[r] * s[r]`` as (C,) fp32, the rows
    added in ascending order (an explicit loop: ``torch.sum`` promises no
    order)."""
    R, C = q.shape
    _check_block(C, block, "dequant_sum_rows")
    nb = C // block
    vals = q.float().reshape(R, nb, block)
    acc = vals[0] * s[0, :, None]
    for r in range(1, R):
        acc = acc + vals[r] * s[r, :, None]
    return acc.reshape(C)


@declares(_wire_work)
def dequant_sum_rows(q: torch.Tensor, s: torch.Tensor,
                     block: int) -> torch.Tensor:
    """``sum_r dequant(q[r], s[r])`` -> (C,) fp32, q (R, C) int8 or fp16,
    s (R, C // block) fp32. CPU tensors take the plain version; CUDA
    tensors launch ``ds_dequant_sum_rows`` or raise."""
    if takes_plain(q.device):
        return dequant_sum_rows_plain(q, s, block)
    if q.device.type != "cuda" or s.device != q.device:
        raise ValueError(f"dequant_sum_rows takes CPU or CUDA tensors on one "
                         f"device, got {q.device} and {s.device}")
    if q.dim() != 2 or q.dtype not in _Q_CODES or s.dtype != torch.float32:
        raise ValueError(f"dequant_sum_rows takes (R, C) int8 or fp16 values "
                         f"and fp32 scales, got {q.dtype} {s.dtype}")
    R, C = q.shape
    _check_block(C, block, "dequant_sum_rows")
    if tuple(s.shape) != (R, C // block):
        raise ValueError(f"dequant_sum_rows: scales {tuple(s.shape)}, "
                         f"expected {(R, C // block)}")
    if R < 1:
        raise ValueError("dequant_sum_rows needs at least one row")
    q, s = q.contiguous(), s.contiguous()
    out = torch.empty((C,), dtype=torch.float32, device=q.device)
    vec = int(C % 4 == 0 and block % 4 == 0
              and q.data_ptr() % (4 * q.element_size()) == 0
              and out.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib().ds_dequant_sum_rows(
            q.data_ptr(), _Q_CODES[q.dtype], s.data_ptr(), out.data_ptr(),
            R, C, block, vec, stream)
    _raise_on(err, "dequant_sum_rows")
    dequant_sum_rows.launches += 1
    return out


dequant_sum_rows.launches = 0


# ---------------------------------------------------------------------- #
# dequant (+ divide)
# ---------------------------------------------------------------------- #


def dequant_rows_plain(q: torch.Tensor, s: torch.Tensor, block: int,
                       divisor: float = 1.0) -> torch.Tensor:
    """The plain version: ``(q * s) / divisor`` as (R, C) fp32."""
    R, C = q.shape
    _check_block(C, block, "dequant_rows")
    nb = C // block
    vals = q.float().reshape(R, nb, block) * s[:, :, None]
    return (vals / _scalar(divisor, q)).reshape(R, C)


@declares(_wire_work)
def dequant_rows(q: torch.Tensor, s: torch.Tensor, block: int,
                 divisor: float = 1.0) -> torch.Tensor:
    """``dequant(q, s) / divisor`` -> (R, C) fp32, q (R, C) int8, s (R,
    C // block) fp32. CPU tensors take the plain version; CUDA tensors
    launch ``ds_dequant_rows`` or raise."""
    if takes_plain(q.device):
        return dequant_rows_plain(q, s, block, divisor)
    if q.device.type != "cuda" or s.device != q.device:
        raise ValueError(f"dequant_rows takes CPU or CUDA tensors on one "
                         f"device, got {q.device} and {s.device}")
    if q.dim() != 2 or q.dtype != torch.int8 or s.dtype != torch.float32:
        raise ValueError(f"dequant_rows takes (R, C) int8 values and fp32 "
                         f"scales, got {q.dtype} {s.dtype}")
    R, C = q.shape
    _check_block(C, block, "dequant_rows")
    if tuple(s.shape) != (R, C // block):
        raise ValueError(f"dequant_rows: scales {tuple(s.shape)}, expected "
                         f"{(R, C // block)}")
    q, s = q.contiguous(), s.contiguous()
    out = torch.empty((R, C), dtype=torch.float32, device=q.device)
    vec = int(block % 4 == 0 and q.data_ptr() % 4 == 0
              and out.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib().ds_dequant_rows(q.data_ptr(), s.data_ptr(),
                                     out.data_ptr(), R, C, block,
                                     float(divisor), vec, stream)
    _raise_on(err, "dequant_rows")
    dequant_rows.launches += 1
    return out


dequant_rows.launches = 0


# ---------------------------------------------------------------------- #
# packed wire layout: values + bitcast scales in ONE int8 payload
# ---------------------------------------------------------------------- #


def pack_wire(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``(R, C) int8`` values + ``(R, nb) fp32`` scales -> one
    ``(R, C + 4 * nb) int8`` payload (scales bitcast to 4 trailing bytes
    per block)."""
    return torch.cat([q, s.contiguous().view(torch.int8)], dim=1)


def unpack_wire(w: torch.Tensor, values: int, block: int):
    """Inverse of ``pack_wire`` for an ``(R, values + 4 * values // block)``
    payload -> ``(q (R, values) int8, s (R, values // block) fp32)``."""
    q = w[:, :values]
    s = w[:, values:].contiguous().view(torch.float32)
    return q, s
