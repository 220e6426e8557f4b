"""Short-sequence ("super-tile") attention, forward and backward.

Counterpart of the dense super-tile half of
deeperspeed_tpu/ops/pallas/flash_static.py. There, sequences shorter than
256 pack G ~ 512/S at a time into one MXU-sized tile with a block-diagonal
mask. The port computes the same function, causal or full softmax(Q K^T *
scale) V with the fp32 logsumexp saved for the backward, with one
hand-written CUDA pair in ``csrc/supertile_attention.cu`` that needs no
packing:

  ``supertile_fwd``  q, k, v (B, H, S, Dh) -> (o in q's dtype, lse
                     (B, H, S) fp32); replaces ``_st_fwd_kernel``
                     (launched by ``_st_fwd``). bf16 runs on the tensor
                     cores (``mma.sync``), one thread block per sequence
                     with the scores of each 16-row query tile in
                     registers; fp32 on the CUDA cores.
  ``supertile_bwd``  (q, k, v, o, lse, do) -> (dq, dk, dv) in one launch;
                     replaces ``_st_bwd_kernel`` (launched by
                     ``_st_vjp_bwd``). delta = rowsum(dO * O) is a plain
                     torch reduction here, as the reference computes it in
                     XLA outside the kernel.

Their plain versions (``supertile_fwd_plain``, ``supertile_bwd_plain``)
are the flash pair's (ops/flash_attention.py): the two kernels compute one
function. A wrapper takes the plain version only for a CPU tensor; for a
CUDA tensor it launches the kernel or raises. ``supertile_fwd.launches``
and ``supertile_bwd.launches`` count launches.

The shape gate (``supertile_geometry_ok``): 8 <= S < 256, S % 8 == 0,
Dh % 8 == 0, Dh <= 128, dtype fp32 or bf16; the kernels take every shape
it admits. The reference's gate also asks for a legal packing (G must
divide B * H, with a 128-aligned tile of 256 to 1024 rows) and a 12 MB VMEM
budget: those are TPU facts with no counterpart here, so the port drops
them.

The pair is registered as ``torch.library`` custom ops
(``deeperspeed_tpu_torch::supertile_fwd`` and ``::supertile_bwd``) joined
by ``register_autograd``, so selective activation checkpointing sees the
forward as one op and can keep its o and lse.
``flash_attention_supertile_bhsd`` is the differentiable entry point;
ops/flash_attention.py routes to it.
"""

import ctypes
import math
from typing import Tuple

import torch

from . import op_builder
from .flash_attention import flash_bwd_plain, flash_fwd_plain

SUPERTILE_MAX_SEQ = 256  # exclusive: S < 256 takes the super-tile kernel
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64  # rows of a key chunk; the backward's dq scratch is needed above

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ds_supertile_error_string": ([_I], ctypes.c_char_p),
    "ds_supertile_fwd": ([_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I,
                          _I, _P], _I),
    "ds_supertile_bwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          ctypes.c_float, _I, _I, _P], _I),
    "ds_supertile_fwd_kernel_info": ([_I, _I, ctypes.POINTER(_I)], _I),
}
_INFO_KEYS = ("registers", "static_smem", "dynamic_smem", "local_bytes",
              "threads", "blocks_per_sm")


def _lib():
    return op_builder.load("supertile_attention", _SIGNATURES)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = _lib().ds_supertile_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")


def fwd_kernel_info(S: int, head_dim: int) -> dict:
    """The compiled bf16 ``supertile_fwd`` kernel that a call at (S,
    ``head_dim``) launches, at that launch configuration: registers,
    static and dynamic shared memory, local memory a thread (spills),
    threads and blocks an SM (the CUDA occupancy calculator). One
    instantiation serves each head dim rounded up to 16 and each S class
    (S <= 64, S <= 128 and above). Builds the library if needed."""
    out = (_I * len(_INFO_KEYS))()
    _raise_on(_lib().ds_supertile_fwd_kernel_info(S, head_dim, out),
              "supertile_fwd info")
    return dict(zip(_INFO_KEYS, out))


def supertile_geometry_ok(B, H, S, Dh, dtype) -> bool:
    """The port's shape gate: whether the super-tile kernels take a
    (B, H, S, Dh) call of ``dtype``."""
    return (B * H >= 1 and 8 <= S < SUPERTILE_MAX_SEQ and S % 8 == 0
            and Dh % 8 == 0 and 8 <= Dh <= MAX_HEAD_DIM
            and dtype in _DTYPE_CODES)


# the two kernels compute the flash pair's function
supertile_fwd_plain = flash_fwd_plain
supertile_bwd_plain = flash_bwd_plain


def _check(name, tensors, like):
    """Every tensor CUDA, contiguous, shaped and typed like ``like``, and
    the shape inside the gate."""
    if like.dim() != 4:
        raise ValueError(f"{name} takes (B, H, S, Dh) tensors, got "
                         f"{tuple(like.shape)}")
    B, H, S, Dh = like.shape
    if not supertile_geometry_ok(B, H, S, Dh, like.dtype):
        raise ValueError(
            f"{name} takes 8 <= S < {SUPERTILE_MAX_SEQ}, S % 8 == 0, "
            f"Dh % 8 == 0, Dh <= {MAX_HEAD_DIM}, float32 or bfloat16; got "
            f"{tuple(like.shape)} {like.dtype}")
    if B * H > 0x7FFFFFFF // ((S + _TILE - 1) // _TILE):
        raise ValueError(f"{name}: B * H = {B * H} is too large")
    for t in tensors:
        if t.device != like.device:
            raise ValueError(f"{name}: a tensor is on {t.device}, expected "
                             f"{like.device}")
        if t.dtype != like.dtype or tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"{name}: q, k, v (and o, do) must share shape "
                             f"and dtype; got {tuple(t.shape)} {t.dtype} "
                             f"beside {tuple(like.shape)} {like.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: every tensor must start on a 16-byte "
                             f"boundary (the kernels load 16 bytes a lane)")
    return B, H, S, Dh


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def supertile_fwd(q, k, v, sm_scale, causal):
    """Super-tile forward kernel on contiguous (B, H, S, Dh) q, k, v of
    one dtype inside the gate: returns (o, lse (B, H, S) fp32). A CPU
    tensor takes ``supertile_fwd_plain``."""
    if q.device.type == "cpu":
        return supertile_fwd_plain(q, k, v, sm_scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"supertile_fwd takes a CPU or CUDA tensor, got "
                         f"{q.device}")
    B, H, S, Dh = _check("supertile_fwd", (q, k, v), q)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.ds_supertile_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   o.data_ptr(), lse.data_ptr(), B * H, S, Dh,
                                   float(sm_scale), int(bool(causal)),
                                   _DTYPE_CODES[q.dtype], _stream(q.device))
    _raise_on(err, "supertile_fwd")
    supertile_fwd.launches += 1
    return o, lse


supertile_fwd.launches = 0


def supertile_bwd(q, k, v, o, lse, do, sm_scale, causal):
    """Super-tile backward kernel, one launch, on contiguous (B, H, S, Dh)
    tensors of one dtype and ``supertile_fwd``'s fp32 lse: returns (dq,
    dk, dv). delta = rowsum(dO * O) is computed here in torch. A CPU
    tensor takes ``supertile_bwd_plain``."""
    if q.device.type == "cpu":
        return supertile_bwd_plain(q, k, v, o, lse, do, sm_scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"supertile_bwd takes a CPU or CUDA tensor, got "
                         f"{q.device}")
    B, H, S, Dh = _check("supertile_bwd", (q, k, v, o, do), q)
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (B, H, S) or not lse.is_contiguous()):
        raise ValueError(f"supertile_bwd takes a contiguous fp32 lse of "
                         f"shape {(B, H, S)} on {q.device}")
    delta = (do.float() * o.float()).sum(dim=-1)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    # fp32 dq carried across key chunks: one block owns a sequence, so
    # no two blocks touch the same rows
    dq_acc = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
              if S > _TILE else None)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.ds_supertile_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), None if dq_acc is None else dq_acc.data_ptr(),
            B * H, S, Dh, float(sm_scale), int(bool(causal)),
            _DTYPE_CODES[q.dtype], _stream(q.device))
    _raise_on(err, "supertile_bwd")
    supertile_bwd.launches += 1
    return dq, dk, dv


supertile_bwd.launches = 0


# ------------------------------------------------------------------ #
# custom ops and autograd
# ------------------------------------------------------------------ #


@torch.library.custom_op("deeperspeed_tpu_torch::supertile_fwd",
                         mutates_args=())
def _supertile_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      sm_scale: float, causal: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    return supertile_fwd(q, k, v, sm_scale, causal)


@_supertile_fwd_op.register_fake
def _(q, k, v, sm_scale, causal):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.custom_op("deeperspeed_tpu_torch::supertile_bwd",
                         mutates_args=())
def _supertile_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      sm_scale: float, causal: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return supertile_bwd(q, k, v, o, lse, do, sm_scale, causal)


@_supertile_bwd_op.register_fake
def _(q, k, v, o, lse, do, sm_scale, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output):
    q, k, v, sm_scale, causal = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.sm_scale = sm_scale
    ctx.causal = causal


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = _supertile_bwd_op(q, k, v, o, lse, do.contiguous(),
                                   ctx.sm_scale, ctx.causal)
    return dq, dk, dv, None, None


_supertile_fwd_op.register_autograd(_backward, setup_context=_setup_context)

# the op selective checkpointing keeps (models/gpt.py, models/bert.py)
SUPERTILE_FWD_OP = torch.ops.deeperspeed_tpu_torch.supertile_fwd.default


def flash_attention_supertile_bhsd(q, k, v, causal=True, sm_scale=None):
    """Head-major (B, H, S, Dh) super-tile attention for short sequences,
    differentiable. Raises on a shape outside ``supertile_geometry_ok``
    (the caller gates, as the reference's callers do)."""
    B, H, S, Dh = q.shape
    if not supertile_geometry_ok(B, H, S, Dh, q.dtype):
        raise ValueError(f"the super-tile kernel does not take "
                         f"{(B, H, S, Dh)} {q.dtype}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(Dh)
    o, _ = _supertile_fwd_op(q.contiguous(), k.contiguous(), v.contiguous(),
                             float(sm_scale), bool(causal))
    return o
