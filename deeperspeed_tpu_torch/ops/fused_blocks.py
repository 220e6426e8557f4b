"""Fused elementwise blocks: LayerNorm and bias+GeLU forward.

Counterpart of deeperspeed_tpu/ops/pallas/fused_blocks.py. The Pallas
kernels there become hand-written CUDA kernels for Hopper in
``csrc/fused_blocks.cu``, built at first use by ``op_builder``:

  ``ln_fwd``         replaces ``_ln_fwd_kernel`` (launched by
                     ``_ln_fwd_call``): y = LN(x) * w + b with fp32
                     statistics, plus the fp32 per-row mean and rstd.
  ``bias_gelu_fwd``  replaces ``_bg_fwd_kernel`` (launched by ``_bg``):
                     y = gelu(x + b), tanh or erf form, in fp32, cast once.

Both are bound by device-memory bytes: on an H100 SXM (3.35 TB/s) their
least time is (bytes read + bytes written) / 3.35 TB/s, e.g. bias+GeLU on
(512, 8192) bf16 moves ~16.8 MB, ~5.0 us. The source file says how each
design keeps intermediates out of device memory.

Beside each kernel wrapper sits its plain PyTorch version (``ln_fwd_plain``,
``bias_gelu_fwd_plain``), the math of the reference's ``_ln_ref`` and
``_bg_ref``. A wrapper takes the plain version only for a tensor on the
CPU; for a CUDA tensor it launches the kernel or raises. Each wrapper
counts its launches in a plain integer attribute (``ln_fwd.launches``,
``bias_gelu_fwd.launches``), raised by one per launch and nowhere else.

The public ``layer_norm``/``bias_gelu`` are dispatchers, as in the
reference: they consult ops/kernel_config.py and call the kernel wrapper
or the plain math. The reference's ``_row_block`` geometry gate is a TPU
VMEM rule and has no counterpart: the CUDA kernels take every (R, D).
Backward kernels and the residual-add LayerNorm are not ported yet.
"""

import ctypes

import torch
import torch.nn.functional as F

from ..monitor.tracer import trace_span
from . import op_builder
from .kernel_config import resolve as _resolve_kernels

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_SIGNATURES = {
    "ds_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "ds_ln_fwd": ([_P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, _P], ctypes.c_int),
    "ds_bias_gelu_fwd": ([_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
                         ctypes.c_int),
}


def _lib():
    return op_builder.load("fused_blocks", _SIGNATURES)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = _lib().ds_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")


def _check_cuda(t: torch.Tensor, name: str, device, shape=None,
                dtypes=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if dtypes is not None and t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes "
                         f"{[str(d) for d in dtypes]}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ------------------------------------------------------------------ #
# layer norm
# ------------------------------------------------------------------ #


def ln_fwd_plain(x, w, b, eps):
    """Plain LayerNorm over the last axis: (y in x's dtype, fp32 mean,
    fp32 rstd), stats biased and computed as mean((x - mu)^2)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    rs = torch.rsqrt(var + eps)
    y = ((x32 - mu) * rs * w + b).to(x.dtype)
    return y, mu[..., 0], rs[..., 0]


def ln_fwd(x, w, b, eps):
    """LayerNorm forward kernel on x (R, D) fp32 or bf16, w/b (D,) fp32:
    returns (y (R, D) in x's dtype, mean (R,) fp32, rstd (R,) fp32).
    A CPU tensor takes ``ln_fwd_plain``."""
    if x.device.type == "cpu":
        return ln_fwd_plain(x, w, b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_fwd takes a CPU or CUDA tensor, got {x.device}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"ln_fwd takes a non-empty (R, D) x, got "
                         f"{tuple(x.shape)}")
    R, D = x.shape
    if R > 0x7FFFFFFF:
        raise ValueError(f"ln_fwd takes at most 2**31 - 1 rows, got {R}")
    _check_cuda(x, "x", x.device, dtypes=_DTYPE_CODES)
    _check_cuda(w, "w", x.device, (D,), (torch.float32,))
    _check_cuda(b, "b", x.device, (D,), (torch.float32,))
    y = torch.empty_like(x)
    mean = torch.empty(R, dtype=torch.float32, device=x.device)
    rstd = torch.empty(R, dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ds_ln_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                            y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                            R, D, float(eps), _DTYPE_CODES[x.dtype],
                            _stream(x.device))
    _raise_on(err, "ln_fwd")
    ln_fwd.launches += 1
    return y, mean, rstd


ln_fwd.launches = 0


# ------------------------------------------------------------------ #
# bias + GeLU
# ------------------------------------------------------------------ #


def bias_gelu_fwd_plain(x, b, approximate):
    """Plain gelu(x + b) in x's dtype (the reference's ``_bg_ref``; with
    b in x's dtype, as the models pass it, the cast is a no-op)."""
    return F.gelu(x + b, approximate="tanh" if approximate else "none"
                  ).to(x.dtype)


def bias_gelu_fwd(x, b, approximate):
    """bias+GeLU forward kernel on x (R, F) fp32 or bf16 and b (F,) of x's
    dtype or fp32; returns y (R, F) in x's dtype. ``approximate`` picks
    tanh (True) or erf (False) GeLU. A CPU tensor takes
    ``bias_gelu_fwd_plain``."""
    if x.device.type == "cpu":
        return bias_gelu_fwd_plain(x, b, approximate)
    if x.device.type != "cuda":
        raise ValueError(f"bias_gelu_fwd takes a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"bias_gelu_fwd takes a non-empty (R, F) x, got "
                         f"{tuple(x.shape)}")
    R, Fd = x.shape
    _check_cuda(x, "x", x.device, dtypes=_DTYPE_CODES)
    _check_cuda(b, "b", x.device, (Fd,), {x.dtype, torch.float32})
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ds_bias_gelu_fwd(x.data_ptr(), b.data_ptr(), y.data_ptr(),
                                   x.numel(), Fd, int(bool(approximate)),
                                   _DTYPE_CODES[x.dtype],
                                   _DTYPE_CODES[b.dtype], _stream(x.device))
    _raise_on(err, "bias_gelu_fwd")
    bias_gelu_fwd.launches += 1
    return y


bias_gelu_fwd.launches = 0


# ------------------------------------------------------------------ #
# dispatchers (the public API models call)
# ------------------------------------------------------------------ #


def _trace_kernel(name, shape):
    return trace_span(f"kernels/{name}", lane="kernels", shape=list(shape))


def layer_norm(x, w, b, eps):
    """LN(x) * w + b over the last axis, fp32 statistics."""
    if _resolve_kernels("fused_blocks", x.device):
        shape = x.shape
        with _trace_kernel("fused_layer_norm", shape):
            y, _, _ = ln_fwd(x.reshape(-1, shape[-1]).contiguous(),
                             w.reshape(-1).float().contiguous(),
                             b.reshape(-1).float().contiguous(), float(eps))
        return y.reshape(shape)
    return ln_fwd_plain(x, w, b, eps)[0]


def bias_gelu(x, b, approximate):
    """gelu(x + b) in one pass; ``approximate`` picks tanh vs erf GeLU."""
    if _resolve_kernels("fused_blocks", x.device):
        shape = x.shape
        with _trace_kernel("fused_bias_gelu", shape):
            y = bias_gelu_fwd(x.reshape(-1, shape[-1]).contiguous(),
                              b.reshape(-1).contiguous(), bool(approximate))
        return y.reshape(shape)
    return bias_gelu_fwd_plain(x, b, approximate)
