"""Fused elementwise blocks: LayerNorm, residual-add LayerNorm and
bias+GeLU, forward and backward.

Counterpart of deeperspeed_tpu/ops/pallas/fused_blocks.py. The Pallas
kernels there become hand-written CUDA kernels for Hopper in
``csrc/fused_blocks.cu``, built at first use by ``op_builder``:

  ``ln_fwd``         replaces ``_ln_fwd_kernel`` (launched by
                     ``_ln_fwd_call``): y = LN(x) * w + b with fp32
                     statistics, plus the fp32 per-row mean and rstd.
  ``ln_bwd``         replaces ``_ln_bwd_kernel`` (launched by
                     ``_ln_vjp_bwd``): dx from the saved mean and rstd,
                     and dw, db as fp32 sums over rows.
  ``bias_gelu_fwd``  replaces ``_bg_fwd_kernel`` (launched by ``_bg``):
                     y = gelu(x + b), tanh or erf form, in fp32, cast once.
  ``bias_gelu_bwd``  replaces ``_bg_bwd_kernel`` (launched by
                     ``_bg_vjp_bwd``): dx = g * gelu'(x + b) and db, the
                     fp32 sum of dx over rows.
  ``add_ln_fwd``     replaces ``_aln_fwd_kernel`` (launched by
                     ``_aln_fwd_call``): y = LN(x + r) * w + b, the sum
                     taken in fp32, plus its fp32 mean and rstd.
  ``add_ln_bwd``     replaces ``_aln_bwd_kernel`` (launched by
                     ``_aln_vjp_bwd``): ds, the cotangent of both x and r,
                     recomputing x + r, and dw, db as fp32 sums over rows.

All six are bound by device-memory bytes: on an H100 SXM (3.35 TB/s)
their least time is (bytes read + bytes written) / 3.35 TB/s, e.g.
bias+GeLU on (512, 8192) bf16 moves ~16.8 MB, ~5.0 us. The source file
says how each design keeps intermediates out of device memory, how the
backwards reduce over rows without atomics, and how bias+GeLU keeps its
instructions below that bound. The launches (which route, how many warps
a row or a block, how many threads and blocks, and the backwards'
partial rows) are decided here, by ``ln_fwd_plan``, ``ln_bwd_plan``,
``bias_gelu_fwd_plan`` and ``bias_gelu_bwd_plan``, and handed to the
kernels.

Beside each kernel wrapper sits its plain PyTorch version
(``ln_fwd_plain``, ``ln_bwd_plain``, ``add_ln_fwd_plain``,
``add_ln_bwd_plain``, ``bias_gelu_fwd_plain``, ``bias_gelu_bwd_plain``),
the math of the reference's ``_ln_ref``, ``_ln_dx``, ``_bg_ref`` and
``_gelu_grad_f32``. A wrapper takes the plain
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises. Each wrapper counts its launches in a plain integer
attribute (``ln_fwd.launches``, ...), raised by one per call that launches
and nowhere else.

The public ``layer_norm``/``add_layer_norm``/``bias_gelu`` are dispatchers, as in the
reference: they consult ops/kernel_config.py and either run the wrappers
inside an autograd Function (forward and backward both kernels on CUDA;
both plain versions on the CPU under mode ``fused``) or the plain math,
whose gradient autograd derives. The reference's ``_row_block`` geometry
gate is a TPU VMEM rule and has no counterpart: the CUDA kernels take
every (R, D) up to the shared-memory limit of the backwards' wide and
scalar routes (rows of whole 16-byte vectors take bias+GeLU's backward
at any width).
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..monitor.tracer import trace_span
from . import op_builder
from .kernel_config import routes_to_wrapper

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_SIGNATURES = {
    "ds_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "ds_ln_fwd": ([_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 5 + [_P],
                  ctypes.c_int),
    "ds_ln_fwd_kernel_info": ([ctypes.c_int] * 6
                              + [ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
    "ds_bias_gelu_fwd": ([_P, _P, _P, ctypes.c_longlong]
                         + [ctypes.c_int] * 8 + [_P], ctypes.c_int),
    "ds_bias_gelu_fwd_kernel_info": ([ctypes.c_int] * 5
                                     + [ctypes.POINTER(ctypes.c_int)],
                                     ctypes.c_int),
    "ds_ln_bwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
                  ctypes.c_int),
    "ds_ln_bwd_kernel_info": ([ctypes.c_int] * 5
                              + [ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
    "ds_ln_bwd_reduce_info": ([ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
    "ds_bias_gelu_bwd": ([_P, _P, _P, _P, _P, _P, ctypes.c_longlong]
                         + [ctypes.c_int] * 8 + [_P], ctypes.c_int),
    "ds_bias_gelu_bwd_kernel_info": ([ctypes.c_int] * 6
                                     + [ctypes.POINTER(ctypes.c_int)],
                                     ctypes.c_int),
    "ds_bias_gelu_bwd_reduce_info": ([ctypes.POINTER(ctypes.c_int)],
                                     ctypes.c_int),
}
# the scalar route of bias+GeLU's backward and the LN backwards' wide route
# keep fp32 column partials in shared memory (F floats; 2 * D floats) within
# a block's 227 KB on Hopper
_SMEM_FLOATS = 232448 // 4
H100_SMS = 132
_LN_THREADS = 256
# the LN backwards' rows route: (warps a row, 16-byte vectors a lane), the
# fewest warps that hold the row first
_LN_ROWS_PAIRS = ((1, 2), (2, 2), (4, 2), (8, 2), (8, 4))
_LN_REDUCE_COLS = 8  # columns of a block of the partial-row reduction
# the LN forwards' rows route: the backward's pairs, blocks of at most 256
# threads, two blocks an SM
_LN_FWD_THREADS = 256
_LN_FWD_BLOCKS_PER_SM = 2
_INFO_KEYS = ("registers", "static_smem", "dynamic_smem", "local_bytes",
              "threads", "blocks_per_sm")
# bias+GeLU's vector route: one 16-byte vector of each row a lane, at most
# 8 warps (256 threads, the kernels' launch bound) a block and 4 blocks an
# SM; the backward's partial rows hold at most _BG_PART_FLOATS fp32 values
# (0.5 MB) wherever one row group a strip stays within them
_BG_MAX_WARPS = 8
_BG_BLOCKS_PER_SM = 4
_BG_PART_FLOATS = 1 << 17
# the scalar route: 256-thread blocks, the forward's at most 32 an SM, the
# backward's (one partial row each) at most 2 an SM
_EW_THREADS = 256
_EW_BLOCKS_PER_SM = 32
_BG_SCALAR_BWD_BLOCKS_PER_SM = 2


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


def ln_fwd_plan(R, D, dtype, aligned=True, n_sm=H100_SMS) -> dict:
    """How ``ln_fwd`` and ``add_ln_fwd`` run an (R, D) call of ``dtype``
    (csrc/fused_blocks.cu says why):

      route             "rows" where a row is whole 16-byte vectors
                        (``aligned``: x, r and y start on a 16-byte
                        boundary) of at most 1024 of them, else "wide"
      warps_per_row     the rows route's team of warps a row, the fewest
                        whose lanes hold the row in 2 vectors each, or 8
                        warps of 4 (``ln_bwd_plan``'s pairs; 0: wide)
      vectors_per_lane  16-byte vectors of x (and r) a lane holds (0: wide)
      threads           threads a block: whole teams, at most 256 (the
                        kernel's launch bound); 256 on the wide route
      teams_per_block   rows a block works on at once: as many as fill
                        ``_LN_FWD_BLOCKS_PER_SM`` blocks on every SM, and
                        one when the rows are few, so that they spread
                        over the SMs
      blocks            blocks of the launch, persistent over the rows on
                        the rows route; one a row on the wide one
      smem_bytes        dynamic shared memory a block (none: the teams'
                        warp sums sit in static shared memory)
    """
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    pair = None
    if aligned and D % vec == 0:
        pair = next(((wpr, nv) for wpr, nv in _LN_ROWS_PAIRS
                     if D // vec <= 32 * wpr * nv), None)
    if pair is None:
        return {"route": "wide", "warps_per_row": 0, "vectors_per_lane": 0,
                "threads": _LN_THREADS, "teams_per_block": 1, "blocks": R,
                "smem_bytes": 0}
    wpr, nv = pair
    most = _LN_FWD_THREADS // (32 * wpr)
    slots = n_sm * _LN_FWD_BLOCKS_PER_SM
    teams = min(most, -(-R // slots))
    return {"route": "rows", "warps_per_row": wpr, "vectors_per_lane": nv,
            "threads": 32 * wpr * teams, "teams_per_block": teams,
            "blocks": min(-(-R // teams), slots), "smem_bytes": 0}


def ln_fwd_kernel_info(D: int, dtype, add: bool = False,
                       R: int = 8192) -> dict:
    """The compiled kernel that an LN forward (``add``: the residual-add
    one) of R aligned rows at width D of ``dtype`` launches, at its launch
    configuration: registers, static and dynamic shared memory, local
    memory a thread (spills), threads and blocks an SM. Builds the library
    if needed."""
    plan = ln_fwd_plan(R, D, dtype)
    out = (ctypes.c_int * len(_INFO_KEYS))()
    _raise_on(_lib().ds_ln_fwd_kernel_info(
        plan["warps_per_row"], plan["vectors_per_lane"], plan["threads"], D,
        _DTYPE_CODES[dtype], int(add), out), "ln_fwd info")
    return dict(zip(_INFO_KEYS, out))


def _ln_fwd_launch(name, x, r, w, b, eps):
    """Checks and launches ds_ln_fwd on x (and r) (R, D); returns (y,
    mean, rstd)."""
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{name} takes a non-empty (R, D) x, got "
                         f"{tuple(x.shape)}")
    R, D = x.shape
    if R > 0x7FFFFFFF:
        raise ValueError(f"{name} takes at most 2**31 - 1 rows, got {R}")
    _check_cuda(x, "x", x.device, dtypes=_DTYPE_CODES)
    if r is not None:
        _check_cuda(r, "r", x.device, (R, D), (x.dtype,))
    _check_cuda(w, "w", x.device, (D,), (torch.float32,))
    _check_cuda(b, "b", x.device, (D,), (torch.float32,))
    y = torch.empty_like(x)
    mean = torch.empty(R, dtype=torch.float32, device=x.device)
    rstd = torch.empty(R, dtype=torch.float32, device=x.device)
    rows = (x, y) if r is None else (x, r, y)
    plan = ln_fwd_plan(R, D, x.dtype,
                       aligned=all(t.data_ptr() % 16 == 0 for t in rows),
                       n_sm=_sm_count(x.device.index))
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ds_ln_fwd(x.data_ptr(),
                            None if r is None else r.data_ptr(),
                            w.data_ptr(), b.data_ptr(), y.data_ptr(),
                            mean.data_ptr(), rstd.data_ptr(), R, D,
                            float(eps), _DTYPE_CODES[x.dtype],
                            plan["warps_per_row"], plan["vectors_per_lane"],
                            plan["threads"], plan["blocks"],
                            _stream(x.device))
    _raise_on(err, name)
    return y, mean, rstd


def _not_cuda(name, t):
    return ValueError(f"{name} takes a CPU or CUDA tensor, got {t.device}")


def ln_fwd(x, w, b, eps):
    """LayerNorm forward kernel on x (R, D) fp32 or bf16, w/b (D,) fp32:
    returns (y (R, D) in x's dtype, mean (R,) fp32, rstd (R,) fp32).
    A CPU tensor takes ``ln_fwd_plain``."""
    if x.device.type == "cpu":
        return ln_fwd_plain(x, w, b, eps)
    if x.device.type != "cuda":
        raise _not_cuda("ln_fwd", x)
    out = _ln_fwd_launch("ln_fwd", x, None, w, b, eps)
    ln_fwd.launches += 1
    return out


ln_fwd.launches = 0


def ln_bwd_plain(x, w, mean, rstd, g):
    """Plain LayerNorm backward (the reference's ``_ln_dx``): returns
    (dx in x's dtype, dw fp32, db fp32) for y = (x - mean) * rstd * w + b
    and the cotangent g; mean and rstd are ``ln_fwd``'s fp32 rows."""
    x32, g32 = x.float(), g.float()
    xhat = (x32 - mean[:, None]) * rstd[:, None]
    dy = g32 * w.float()
    c1 = dy.mean(dim=-1, keepdim=True)
    c2 = (dy * xhat).mean(dim=-1, keepdim=True)
    dx = rstd[:, None] * (dy - c1 - xhat * c2)
    return dx.to(x.dtype), (g32 * xhat).sum(dim=0), g32.sum(dim=0)


def ln_bwd_plan(R, D, dtype, aligned=True, n_sm=H100_SMS) -> dict:
    """How ``ln_bwd`` and ``add_ln_bwd`` run an (R, D) call of ``dtype``
    (csrc/fused_blocks.cu says why):

      route             "rows" where a row is whole 16-byte vectors
                        (``aligned``: every row input starts on a 16-byte
                        boundary) of at most 1024 of them, else "wide"
      warps_per_row     the rows route's team of warps a row (0: wide)
      vectors_per_lane  16-byte vectors a lane holds (0: wide)
      threads           threads a block of the first launch: 512 (256 at
                        4 vectors a lane, and wide)
      teams_per_block   rows a block works on at once
      blocks            the first launch's blocks, persistent over the
                        rows: one an SM on the rows route (two on the
                        wide one), never more than the rows need
      partial_rows      fp32 partial rows of dw and of db it writes (one a
                        block)
      smem_bytes        its dynamic shared memory a block: on the rows
                        route w, then half the teams' column partials for
                        the block's tree
      reduce_blocks     blocks of the second launch, which sums the partial
                        rows per column (8 columns a block, dw and db)
    """
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    pair = None
    if aligned and D % vec == 0:
        pair = next(((wpr, nv) for wpr, nv in _LN_ROWS_PAIRS
                     if D // vec <= 32 * wpr * nv), None)
    reduce_blocks = 2 * -(-D // _LN_REDUCE_COLS)
    if pair is None:
        blocks = min(R, 2 * n_sm)
        return {"route": "wide", "warps_per_row": 0, "vectors_per_lane": 0,
                "threads": _LN_THREADS, "teams_per_block": 1,
                "blocks": blocks, "partial_rows": blocks,
                "smem_bytes": 2 * D * 4, "reduce_blocks": reduce_blocks}
    wpr, nv = pair
    threads = 512 if nv <= 2 else 256
    teams = threads // (32 * wpr)
    blocks = min(-(-R // teams), n_sm)
    tree = teams // 2 * 2 * nv * vec * 32 * wpr * 4
    return {"route": "rows", "warps_per_row": wpr, "vectors_per_lane": nv,
            "threads": threads, "teams_per_block": teams, "blocks": blocks,
            "partial_rows": blocks, "smem_bytes": -(-D // 4) * 16 + tree,
            "reduce_blocks": reduce_blocks}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ln_bwd_kernel_info(D: int, dtype, add: bool = False) -> dict:
    """The compiled first kernel that an LN backward (``add``: the
    residual-add one) at width D of ``dtype`` launches on aligned rows, at
    its launch configuration: registers, static and dynamic shared memory,
    local memory a thread (spills), threads and blocks an SM. Builds the
    library if needed."""
    plan = ln_bwd_plan(1, D, dtype)
    out = (ctypes.c_int * len(_INFO_KEYS))()
    _raise_on(_lib().ds_ln_bwd_kernel_info(
        plan["warps_per_row"], plan["vectors_per_lane"], D,
        _DTYPE_CODES[dtype], int(add), out), "ln_bwd info")
    return dict(zip(_INFO_KEYS, out))


def ln_bwd_reduce_info() -> dict:
    """``ln_bwd_kernel_info``'s record for the LN backwards' second
    launch, the reduction of the partial rows."""
    out = (ctypes.c_int * len(_INFO_KEYS))()
    _raise_on(_lib().ds_ln_bwd_reduce_info(out), "ln_bwd reduce info")
    return dict(zip(_INFO_KEYS, out))


def _ln_bwd_launch(name, x, r, w, mean, rstd, g):
    """Checks and launches ds_ln_bwd; returns (dx, dw, db)."""
    if x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"{name} takes a non-empty (R, D) x, got "
                         f"{tuple(x.shape)}")
    R, D = x.shape
    if 2 * D > _SMEM_FLOATS:
        raise ValueError(f"{name} takes D <= {_SMEM_FLOATS // 2}, got {D}")
    _check_cuda(x, "x", x.device, dtypes=_DTYPE_CODES)
    if r is not None:
        _check_cuda(r, "r", x.device, (R, D), (x.dtype,))
    _check_cuda(g, "g", x.device, (R, D), (x.dtype,))
    _check_cuda(w, "w", x.device, (D,), (torch.float32,))
    _check_cuda(mean, "mean", x.device, (R,), (torch.float32,))
    _check_cuda(rstd, "rstd", x.device, (R,), (torch.float32,))
    lib = _lib()
    dx = torch.empty_like(x)
    dw = torch.empty(D, dtype=torch.float32, device=x.device)
    db = torch.empty(D, dtype=torch.float32, device=x.device)
    rows = (x, g, dx) if r is None else (x, r, g, dx)
    plan = ln_bwd_plan(R, D, x.dtype,
                       aligned=all(t.data_ptr() % 16 == 0 for t in rows),
                       n_sm=_sm_count(x.device.index))
    part = torch.empty(2 * plan["partial_rows"] * D, dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        err = lib.ds_ln_bwd(x.data_ptr(),
                            None if r is None else r.data_ptr(),
                            w.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                            g.data_ptr(), dx.data_ptr(), dw.data_ptr(),
                            db.data_ptr(), part.data_ptr(), R, D,
                            _DTYPE_CODES[x.dtype], plan["warps_per_row"],
                            plan["vectors_per_lane"], plan["blocks"],
                            _stream(x.device))
    _raise_on(err, name)
    return dx, dw, db


def ln_bwd(x, w, mean, rstd, g):
    """LayerNorm backward kernel on x, g (R, D) fp32 or bf16, w (D,) fp32
    and ln_fwd's fp32 mean, rstd (R,): returns (dx (R, D) in x's dtype,
    dw (D,) fp32, db (D,) fp32). A CPU tensor takes ``ln_bwd_plain``."""
    if x.device.type == "cpu":
        return ln_bwd_plain(x, w, mean, rstd, g)
    if x.device.type != "cuda":
        raise _not_cuda("ln_bwd", x)
    out = _ln_bwd_launch("ln_bwd", x, None, w, mean, rstd, g)
    ln_bwd.launches += 1
    return out


ln_bwd.launches = 0


# ------------------------------------------------------------------ #
# residual add + layer norm
# ------------------------------------------------------------------ #


def add_ln_fwd_plain(x, r, w, b, eps):
    """Plain LN(x + r) * w + b: x and r cast to fp32 before the add (the
    reference kernel's rounding); returns (y in x's dtype, fp32 mean, fp32
    rstd)."""
    y, mean, rstd = ln_fwd_plain(x.float() + r.float(), w, b, eps)
    return y.to(x.dtype), mean, rstd


def add_ln_fwd(x, r, w, b, eps):
    """Residual-add LayerNorm forward kernel on x, r (R, D) of one dtype,
    fp32 or bf16, and w, b (D,) fp32: returns (y (R, D) in x's dtype, mean
    and rstd (R,) fp32 of x + r). A CPU tensor takes
    ``add_ln_fwd_plain``."""
    if x.device.type == "cpu":
        return add_ln_fwd_plain(x, r, w, b, eps)
    if x.device.type != "cuda":
        raise _not_cuda("add_ln_fwd", x)
    out = _ln_fwd_launch("add_ln_fwd", x, r, w, b, eps)
    add_ln_fwd.launches += 1
    return out


add_ln_fwd.launches = 0


def add_ln_bwd_plain(x, r, w, mean, rstd, g):
    """Plain residual-add LayerNorm backward (the reference's
    ``_aln_bwd_kernel``): s = x + r in fp32, then ``ln_bwd_plain``'s math;
    returns (ds in x's dtype, dw fp32, db fp32). ds is the cotangent of
    both x and r."""
    ds, dw, db = ln_bwd_plain(x.float() + r.float(), w, mean, rstd, g)
    return ds.to(x.dtype), dw, db


def add_ln_bwd(x, r, w, mean, rstd, g):
    """Residual-add LayerNorm backward kernel on x, r, g (R, D) of one
    dtype, w (D,) fp32 and add_ln_fwd's fp32 mean, rstd (R,): returns
    (ds (R, D) in x's dtype, dw (D,) fp32, db (D,) fp32). A CPU tensor
    takes ``add_ln_bwd_plain``."""
    if x.device.type == "cpu":
        return add_ln_bwd_plain(x, r, w, mean, rstd, g)
    if x.device.type != "cuda":
        raise _not_cuda("add_ln_bwd", x)
    out = _ln_bwd_launch("add_ln_bwd", x, r, w, mean, rstd, g)
    add_ln_bwd.launches += 1
    return out


add_ln_bwd.launches = 0


# ------------------------------------------------------------------ #
# bias + GeLU
# ------------------------------------------------------------------ #


def bias_gelu_fwd_plain(x, b, approximate):
    """Plain gelu(x + b) in x's dtype (the reference's ``_bg_ref``; with
    b in x's dtype, as the models pass it, the cast is a no-op)."""
    return F.gelu(x + b, approximate="tanh" if approximate else "none"
                  ).to(x.dtype)


def _bg_vector_plan(R, F, dtype, aligned, n_sm, most_groups=None):
    """The vector route's launch of an (R, F) call (None where a row is no
    whole number of 16-byte vectors or a row tensor is off a 16-byte
    boundary): column strips of 32 lanes of one vector, row groups of
    ``warps`` rows at a time, at most ``_BG_BLOCKS_PER_SM`` blocks an SM
    (and ``most_groups`` row groups, where given); one warp a block while
    the rows are no more than the row groups that many blocks allow, so
    that few rows spread over the SMs."""
    vec = 16 // dtype.itemsize
    if not aligned or F % vec:
        return None
    strips = -(-(F // vec) // 32)
    most = max(1, _BG_BLOCKS_PER_SM * n_sm // strips)
    if most_groups is not None:
        most = min(most, most_groups)
    if R <= most:
        warps, groups = 1, R
    else:
        warps = min(_BG_MAX_WARPS, -(-R // most))
        groups = min(-(-R // warps), most)
    return {"route": "vector", "vectors_per_lane": 1, "strips": strips,
            "warps_per_block": warps, "threads": 32 * warps,
            "row_groups": groups, "blocks": strips * groups}


@functools.lru_cache(maxsize=1024)
def bias_gelu_fwd_plan(R, F, dtype, aligned=True, n_sm=H100_SMS) -> dict:
    """How ``bias_gelu_fwd`` runs an (R, F) call of x's ``dtype``
    (csrc/fused_blocks.cu says why):

      route             "vector" where a row is whole 16-byte vectors
                        (``aligned``: x and y start on a 16-byte
                        boundary), else "scalar"
      vectors_per_lane  16-byte vectors of a row a lane owns: 1 (0: scalar)
      strips            column strips of 32 lanes, 32 vectors: the grid's x
                        (1: scalar)
      warps_per_block   rows a block works on at once, one a warp
      threads           threads a block: whole warps, at most 256 (256 on
                        the scalar route)
      row_groups        the grid's y: a warp walks rows row_group *
                        warps_per_block + warp, strided by row_groups *
                        warps_per_block (the scalar route's blocks)
      blocks            strips x row_groups (at most 4 an SM; the scalar
                        route's grid-stride blocks, at most 32 an SM)

    Plans are cached on their arguments: a caller must not change one.
    """
    plan = _bg_vector_plan(R, F, dtype, aligned, n_sm)
    if plan is None:
        blocks = min(-(-R * F // _EW_THREADS), _EW_BLOCKS_PER_SM * n_sm)
        plan = {"route": "scalar", "vectors_per_lane": 0, "strips": 1,
                "warps_per_block": _EW_THREADS // 32,
                "threads": _EW_THREADS, "row_groups": blocks,
                "blocks": blocks}
    return plan


def bias_gelu_fwd_kernel_info(R: int, F: int, dtype, b_dtype,
                              approximate=True) -> dict:
    """The compiled kernel that ``bias_gelu_fwd`` on aligned (R, F) rows of
    ``dtype`` and b of ``b_dtype`` (x's or fp32) launches, at its launch
    configuration: registers, static and dynamic shared memory, local
    memory a thread (spills), threads and blocks an SM. Builds the library
    if needed."""
    plan = bias_gelu_fwd_plan(R, F, dtype)
    out = (ctypes.c_int * len(_INFO_KEYS))()
    _raise_on(_lib().ds_bias_gelu_fwd_kernel_info(
        plan["vectors_per_lane"], plan["threads"], _DTYPE_CODES[dtype],
        _DTYPE_CODES[b_dtype], int(bool(approximate)), out),
        "bias_gelu_fwd info")
    return dict(zip(_INFO_KEYS, out))


def _bg_check(name, x, b, g=None):
    """Raises unless x is a non-empty (R, F) CUDA tensor the bias+GeLU
    kernels take, g (when given) of x's shape and dtype, and b (F,) of x's
    dtype or fp32, all contiguous on x's device."""
    if x.dim() != 2 or x.numel() == 0:
        raise ValueError(f"{name} takes a non-empty (R, F) x, got "
                         f"{tuple(x.shape)}")
    _check_cuda(x, "x", x.device, dtypes=_DTYPE_CODES)
    if g is not None:
        _check_cuda(g, "g", x.device, tuple(x.shape), (x.dtype,))
    _check_cuda(b, "b", x.device, (x.shape[1],), {x.dtype, torch.float32})


def bias_gelu_fwd(x, b, approximate):
    """bias+GeLU forward kernel on x (R, F) fp32 or bf16 and b (F,) of x's
    dtype or fp32; returns y (R, F) in x's dtype. ``approximate`` picks
    tanh (True) or erf (False) GeLU. The launch is ``bias_gelu_fwd_plan``'s:
    16-byte vectors at fixed columns a lane where the rows allow, else a
    scalar grid-stride pass. A CPU tensor takes ``bias_gelu_fwd_plain``."""
    if x.device.type == "cpu":
        return bias_gelu_fwd_plain(x, b, approximate)
    if x.device.type != "cuda":
        raise _not_cuda("bias_gelu_fwd", x)
    _bg_check("bias_gelu_fwd", x, b)
    R, Fd = x.shape
    y = torch.empty_like(x)
    plan = bias_gelu_fwd_plan(R, Fd, x.dtype,
                              aligned=x.data_ptr() % 16 == 0
                              and y.data_ptr() % 16 == 0,
                              n_sm=_sm_count(x.device.index))
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ds_bias_gelu_fwd(
            x.data_ptr(), b.data_ptr(), y.data_ptr(), R, Fd,
            int(bool(approximate)), _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[b.dtype], plan["vectors_per_lane"], plan["threads"],
            plan["strips"], plan["row_groups"], _stream(x.device))
    _raise_on(err, "bias_gelu_fwd")
    bias_gelu_fwd.launches += 1
    return y


bias_gelu_fwd.launches = 0

_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_C = 0.044715
_INV_SQRT2 = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def _gelu_grad_f32(u, approximate):
    """d gelu(u) / du in fp32, the reference's ``_gelu_grad_f32``."""
    if approximate:
        t = torch.tanh(_SQRT_2_OVER_PI * (u + _GELU_C * u * u * u))
        dinner = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * u * u)
        return 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * dinner
    phi = 0.5 * (1.0 + torch.erf(u * _INV_SQRT2))
    return phi + u * torch.exp(-0.5 * u * u) * _INV_SQRT_2PI


def bias_gelu_bwd_plain(x, b, g, approximate):
    """Plain bias+GeLU backward (the reference's ``_bg_bwd_kernel``
    math): returns (dx = g * gelu'(x + b) in x's dtype, db = the fp32 sum
    of dx over rows)."""
    u = x.float() + b.float()
    dx = g.float() * _gelu_grad_f32(u, approximate)
    return dx.to(x.dtype), dx.sum(dim=0)


@functools.lru_cache(maxsize=1024)
def bias_gelu_bwd_plan(R, F, dtype, aligned=True, n_sm=H100_SMS) -> dict:
    """How ``bias_gelu_bwd`` runs an (R, F) call of x's ``dtype``
    (csrc/fused_blocks.cu says why): ``bias_gelu_fwd_plan``'s keys, the
    row groups also held to ``_BG_PART_FLOATS // F`` (at least one), and

      partial_rows      fp32 partial rows of db the first launch writes
                        (one a row group; the scalar route's one a block,
                        min(R, 2 an SM))
      scratch_floats    partial_rows x F, the scratch the wrapper allocates
      smem_bytes        the first launch's dynamic shared memory a block
                        (the scalar route's F fp32 partials; none on the
                        vector route, whose warps' tree is static)
      reduce_blocks     blocks of the second launch, which adds the
                        partial rows per column in a fixed order (8 columns
                        a block)

    Plans are cached on their arguments: a caller must not change one.
    """
    plan = _bg_vector_plan(R, F, dtype, aligned, n_sm,
                           max(1, _BG_PART_FLOATS // F))
    if plan is None:
        blocks = min(R, _BG_SCALAR_BWD_BLOCKS_PER_SM * n_sm)
        plan = {"route": "scalar", "vectors_per_lane": 0, "strips": 1,
                "warps_per_block": _EW_THREADS // 32,
                "threads": _EW_THREADS, "row_groups": blocks,
                "blocks": blocks, "smem_bytes": 4 * F}
    else:
        plan["smem_bytes"] = 0
    plan.update(partial_rows=plan["row_groups"],
                scratch_floats=plan["row_groups"] * F,
                reduce_blocks=-(-F // _LN_REDUCE_COLS))
    return plan


def bias_gelu_bwd_kernel_info(R: int, F: int, dtype, b_dtype,
                              approximate=True) -> dict:
    """``bias_gelu_fwd_kernel_info``'s record for the first kernel that
    ``bias_gelu_bwd`` on aligned (R, F) rows launches."""
    plan = bias_gelu_bwd_plan(R, F, dtype)
    out = (ctypes.c_int * len(_INFO_KEYS))()
    _raise_on(_lib().ds_bias_gelu_bwd_kernel_info(
        plan["vectors_per_lane"], plan["threads"], F,
        _DTYPE_CODES[dtype], _DTYPE_CODES[b_dtype],
        int(bool(approximate)), out), "bias_gelu_bwd info")
    return dict(zip(_INFO_KEYS, out))


def bias_gelu_bwd_reduce_info() -> dict:
    """``bias_gelu_fwd_kernel_info``'s record for ``bias_gelu_bwd``'s
    second launch, the reduction of the partial rows."""
    out = (ctypes.c_int * len(_INFO_KEYS))()
    _raise_on(_lib().ds_bias_gelu_bwd_reduce_info(out),
              "bias_gelu_bwd reduce info")
    return dict(zip(_INFO_KEYS, out))


def bias_gelu_bwd(x, b, g, approximate):
    """bias+GeLU backward kernel on x, g (R, F) fp32 or bf16 and b (F,) of
    x's dtype or fp32: returns (dx (R, F) in x's dtype, db (F,) fp32). The
    launches are ``bias_gelu_bwd_plan``'s: dx and fp32 partial rows of db,
    then their sum per column in a fixed order (no atomics: a relaunch
    gives the same bits). A CPU tensor takes ``bias_gelu_bwd_plain``."""
    if x.device.type == "cpu":
        return bias_gelu_bwd_plain(x, b, g, approximate)
    if x.device.type != "cuda":
        raise _not_cuda("bias_gelu_bwd", x)
    _bg_check("bias_gelu_bwd", x, b, g)
    R, Fd = x.shape
    dx = torch.empty_like(x)
    plan = bias_gelu_bwd_plan(
        R, Fd, x.dtype,
        aligned=all(t.data_ptr() % 16 == 0 for t in (x, g, dx)),
        n_sm=_sm_count(x.device.index))
    if plan["route"] == "scalar" and Fd > _SMEM_FLOATS:
        raise ValueError(f"bias_gelu_bwd takes F <= {_SMEM_FLOATS} on rows "
                         f"that are no whole 16-byte vectors, got {Fd}")
    db = torch.empty(Fd, dtype=torch.float32, device=x.device)
    part = torch.empty(plan["scratch_floats"], dtype=torch.float32,
                       device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ds_bias_gelu_bwd(
            x.data_ptr(), b.data_ptr(), g.data_ptr(), dx.data_ptr(),
            db.data_ptr(), part.data_ptr(), R, Fd, int(bool(approximate)),
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[b.dtype],
            plan["vectors_per_lane"], plan["threads"], plan["strips"],
            plan["partial_rows"], _stream(x.device))
    _raise_on(err, "bias_gelu_bwd")
    bias_gelu_bwd.launches += 1
    return dx, db


bias_gelu_bwd.launches = 0


# ------------------------------------------------------------------ #
# autograd: the kernels' forward and backward as one differentiable op
# ------------------------------------------------------------------ #


class _LayerNormFn(torch.autograd.Function):
    """y = LN(x2) * w + b through ``ln_fwd``; the backward is ``ln_bwd``
    from the saved fp32 mean and rstd. x2 (R, D), w and b (D,) fp32."""

    @staticmethod
    def forward(ctx, x2, w, b, eps):
        y, mean, rstd = ln_fwd(x2, w, b, eps)
        ctx.save_for_backward(x2, w, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x2, w, mean, rstd = ctx.saved_tensors
        dx, dw, db = ln_bwd(x2, w, mean, rstd, g.contiguous())
        return dx, dw, db, None


class _AddLayerNormFn(torch.autograd.Function):
    """y = LN(x2 + r2) * w + b through ``add_ln_fwd``; the backward is
    ``add_ln_bwd``, whose ds is returned for both x2 and r2 (the
    reference's ``_aln_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, x2, r2, w, b, eps):
        y, mean, rstd = add_ln_fwd(x2, r2, w, b, eps)
        ctx.save_for_backward(x2, r2, w, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        x2, r2, w, mean, rstd = ctx.saved_tensors
        ds, dw, db = add_ln_bwd(x2, r2, w, mean, rstd, g.contiguous())
        return ds, ds, dw, db, None


class _BiasGeluFn(torch.autograd.Function):
    """y = gelu(x2 + b) through ``bias_gelu_fwd``; the backward is
    ``bias_gelu_bwd``, its db cast to b's dtype as the reference does."""

    @staticmethod
    def forward(ctx, x2, b, approximate):
        ctx.approximate = approximate
        ctx.save_for_backward(x2, b)
        return bias_gelu_fwd(x2, b, approximate)

    @staticmethod
    def backward(ctx, g):
        x2, b = ctx.saved_tensors
        dx, db = bias_gelu_bwd(x2, b, g.contiguous(), ctx.approximate)
        return dx, db.to(b.dtype), None


# ------------------------------------------------------------------ #
# dispatchers (the public API models call)
# ------------------------------------------------------------------ #


def _trace_kernel(name, shape):
    return trace_span(f"kernels/{name}", lane="kernels", shape=list(shape))


def layer_norm(x, w, b, eps):
    """LN(x) * w + b over the last axis, fp32 statistics."""
    if routes_to_wrapper("fused_blocks", x.device):
        shape = x.shape
        with _trace_kernel("fused_layer_norm", shape):
            y = _LayerNormFn.apply(x.reshape(-1, shape[-1]).contiguous(),
                                   w.reshape(-1).float(),
                                   b.reshape(-1).float(), float(eps))
        return y.reshape(shape)
    return ln_fwd_plain(x, w, b, eps)[0]


def add_layer_norm(x, residual, w, b, eps):
    """LN(x + residual) * w + b: the BERT post-LN add&norm in one pass.
    The plain path adds in x's dtype, then normalizes (the reference's
    ``_ln_ref(x + residual, ...)``); the kernel path adds in fp32. On the
    kernel path a residual that broadcasts against x is expanded first (its
    gradient sums back over the broadcast axes), and x and residual of
    different dtypes reach the wrapper, which raises on a CUDA tensor."""
    if routes_to_wrapper("fused_blocks", x.device):
        if x.shape != residual.shape:
            x, residual = torch.broadcast_tensors(x, residual)
        shape = x.shape
        with _trace_kernel("fused_add_layer_norm", shape):
            y = _AddLayerNormFn.apply(
                x.reshape(-1, shape[-1]).contiguous(),
                residual.reshape(-1, shape[-1]).contiguous(),
                w.reshape(-1).float(), b.reshape(-1).float(), float(eps))
        return y.reshape(shape)
    return ln_fwd_plain(x + residual, w, b, eps)[0]


def bias_gelu(x, b, approximate):
    """gelu(x + b) in one pass; ``approximate`` picks tanh vs erf GeLU."""
    if routes_to_wrapper("fused_blocks", x.device):
        shape = x.shape
        with _trace_kernel("fused_bias_gelu", shape):
            y = _BiasGeluFn.apply(x.reshape(-1, shape[-1]).contiguous(),
                                  b.reshape(-1).contiguous(),
                                  bool(approximate))
        return y.reshape(shape)
    return bias_gelu_fwd_plain(x, b, approximate)
