"""Flash attention, forward and backward.

Counterpart of deeperspeed_tpu/ops/pallas/flash_attention.py together with
the static-unrolled path of ops/pallas/flash_static.py. The reference has
two Pallas kernel pairs for one function, causal or full
softmax(Q K^T * scale) V with the fp32 logsumexp saved for a flash-2
backward: a streaming pair (``_flash_fwd``/``_flash_bwd``) and a whole-S
resident pair (``flash_static._fwd``/``_bwd``). Its ``attention_dispatch``
picks between them by whether whole-S K and V fit the TPU's VMEM
(``MAX_STATIC_SEQ``), a rule with no meaning on Hopper. The port has one
hand-written CUDA pair in ``csrc/flash_attention.cu`` that takes any S
(ragged S included) and Dh in ``HEAD_DIMS``:

  ``flash_fwd``  q, k, v (B, H, S, Dh) -> (o (B, H, S, Dh) in q's dtype,
                 lse (B, H, S) fp32).
  ``flash_bwd``  (q, k, v, o, lse, do) -> (dq, dk, dv); delta =
                 rowsum(dO * O), which the reference computes in XLA
                 outside both kernels, is a small kernel of its own here
                 (``flash_bwd_delta``) ahead of the dK/dV and dQ kernels.

bf16 runs on the tensor cores (FlashAttention-2 on ``mma.sync``); fp32 on
the CUDA cores, whose fp32 FMAs keep the port's fp32 tolerance.

Beside each sits its plain PyTorch version (``flash_fwd_plain``,
``flash_bwd_plain``), used for a CPU tensor and as the kernels' yardstick
on the card. A wrapper takes the plain version only for a CPU tensor; for
a CUDA tensor it launches the kernel or raises. ``flash_fwd.launches`` and
``flash_bwd.launches`` count launches.

The two kernels are registered as ``torch.library`` custom ops
(``deeperspeed_tpu_torch::flash_fwd`` and ``::flash_bwd``) joined by
``register_autograd``, so selective activation checkpointing
(models/gpt.py, ``remat_policy="matmuls"``) sees the forward as one
dispatcher op and can keep its o and lse instead of replaying the kernel.
``flash_attention_bhsd`` (head-major) and ``flash_attention``
(B, S, H, Dh) are the entry points models call. They route as the
reference's ``flash_attention_bhsd`` does: a short sequence that the
super-tile gate admits goes to the super-tile kernel
(ops/flash_static.py) when the "kernels" config routes its ``supertile``
surface for the device; everything else to the flash kernel here.
``attention_dispatch`` states that decision for model code.
"""

import ctypes
import math
from typing import Tuple

import torch

from ..monitor.perf import declares, io_bytes
from . import op_builder
from .kernel_config import _is_hopper, routes_to_wrapper

NEG_INF = -1e30  # the reference's masked score: finite, so no NaN appears
HEAD_DIMS = (64, 96, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BH = 65535  # grid.y of the fp32 kernels' launch

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ds_flash_error_string": ([_I], ctypes.c_char_p),
    "ds_flash_fwd": ([_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _I, _I,
                      _P], _I),
    "ds_flash_bwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      ctypes.c_float, _I, _I, _P], _I),
    "ds_flash_bwd_delta": ([_P, _P, _P, _I, _I, _I, _I, _P], _I),
    "ds_flash_kernel_info": ([_I, _I, _I, ctypes.POINTER(_I)], _I),
}
# the kernels ``kernel_info`` describes, by the index the library takes
KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq", "flash_bwd_delta")
_INFO_KEYS = ("registers", "static_smem", "dynamic_smem", "local_bytes",
              "threads", "blocks_per_sm")


def _lib():
    return op_builder.load("flash_attention", _SIGNATURES)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = _lib().ds_flash_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")


def kernel_info(kernel: str, head_dim: int, dtype) -> dict:
    """The compiled ``kernel`` (one of KERNELS) for ``head_dim`` and
    ``dtype`` at its launch configuration: registers, static and dynamic
    shared memory, local memory a thread (spills), threads and blocks an SM
    (the CUDA occupancy calculator). Builds the library if needed."""
    out = (_I * len(_INFO_KEYS))()
    _raise_on(_lib().ds_flash_kernel_info(KERNELS.index(kernel), head_dim,
                                          _DTYPE_CODES[dtype], out),
              f"{kernel} info")
    return dict(zip(_INFO_KEYS, out))


def _scores(q, k, sm_scale, causal):
    """fp32 (B, H, S, S) scores, masked with NEG_INF above the diagonal."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        S = q.shape[2]
        keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


# ------------------------------------------------------------------ #
# plain versions
# ------------------------------------------------------------------ #


def flash_fwd_plain(q, k, v, sm_scale, causal):
    """Plain flash forward on (B, H, S, Dh): (o in q's dtype, lse fp32).
    The reference kernels' arithmetic with the whole row as one block:
    fp32 scores, p = exp(s - rowmax) cast to the input dtype before P V,
    the row sum of the uncast p, lse = rowmax + log(sum)."""
    s = _scores(q, k, sm_scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), v.float())
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def flash_bwd_plain(q, k, v, o, lse, do, sm_scale, causal):
    """Plain flash-2 backward from the saved lse: (dq, dk, dv) in q's
    dtype. P is recomputed as exp(s - lse); P and dS = P (dP - delta) *
    scale are cast to the input dtype before their products, as the
    reference's kernels cast them."""
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    p = torch.exp(_scores(q, k, sm_scale, causal) - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).float(), do.float())
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta) * sm_scale).to(q.dtype).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# ------------------------------------------------------------------ #
# kernel wrappers
# ------------------------------------------------------------------ #


def _check(name, tensors, like):
    """Every tensor on ``like``'s device, contiguous, 16-byte aligned,
    shaped and typed like ``like``."""
    if like.dim() != 4:
        raise ValueError(f"{name} takes (B, H, S, Dh) tensors, got "
                         f"{tuple(like.shape)}")
    B, H, S, Dh = like.shape
    if like.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {like.dtype}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"{name} takes head_dim in {HEAD_DIMS}, got {Dh}")
    if S < 1 or B * H < 1 or B * H > _MAX_BH:
        raise ValueError(f"{name} takes S >= 1 and 1 <= B * H <= {_MAX_BH}, "
                         f"got {tuple(like.shape)}")
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


def attention_work(out, q, *args, pairs=None, backward=False):
    """The work an attention wrapper declares to the cost index
    (monitor/perf.py), as torch.utils.flop_counter counts SDPA: 2 products
    of 2 flops over every (query, key) pair of the score tiles the call
    covers (``pairs``, default all B * H * S * S; a causal mask does not
    halve it) per head dim forward; backward 4 products, plus the score
    recomputation as recompute flops; bytes: each input and output once."""
    B, H, S, Dh = q.shape
    if pairs is None:
        pairs = B * H * S * S
    nbytes = io_bytes(out, q, *args)
    if backward:
        return 8 * pairs * Dh, nbytes, 2 * pairs * Dh
    return 4 * pairs * Dh, nbytes


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@declares(lambda out, q, *a: attention_work(out, q, *a))
def flash_fwd(q, k, v, sm_scale, causal):
    """Flash forward kernel on contiguous (B, H, S, Dh) q, k, v of one
    dtype (fp32 or bf16, Dh in HEAD_DIMS): returns (o, lse (B, H, S)
    fp32). A CPU tensor takes ``flash_fwd_plain``."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, sm_scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd takes a CPU or CUDA tensor, got "
                         f"{q.device}")
    B, H, S, Dh = _check("flash_fwd", (q, k, v), q)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.ds_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), lse.data_ptr(), B * H, S, Dh,
                               float(sm_scale), int(bool(causal)),
                               _DTYPE_CODES[q.dtype], _stream(q.device))
    _raise_on(err, "flash_fwd")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


@declares(lambda out, q, *a: attention_work(out, q, *a,
                                              backward=True))
def flash_bwd(q, k, v, o, lse, do, sm_scale, causal):
    """Flash backward kernels (delta = rowsum(dO * O), dK/dV, then dQ) on
    contiguous (B, H, S, Dh) tensors of one dtype and ``flash_fwd``'s fp32
    lse: returns (dq, dk, dv). A CPU tensor takes ``flash_bwd_plain``."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, sm_scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd takes a CPU or CUDA tensor, got "
                         f"{q.device}")
    B, H, S, Dh = _check("flash_bwd", (q, k, v, o, do), q)
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (B, H, S) or not lse.is_contiguous()):
        raise ValueError(f"flash_bwd takes a contiguous fp32 lse of shape "
                         f"{(B, H, S)} on {q.device}")
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.ds_flash_bwd_delta(o.data_ptr(), do.data_ptr(),
                                     delta.data_ptr(), B * H, S, Dh,
                                     _DTYPE_CODES[q.dtype], _stream(q.device))
        _raise_on(err, "flash_bwd_delta")
        err = lib.ds_flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               do.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                               dv.data_ptr(), B * H, S, Dh, float(sm_scale),
                               int(bool(causal)), _DTYPE_CODES[q.dtype],
                               _stream(q.device))
    _raise_on(err, "flash_bwd")
    flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0


# ------------------------------------------------------------------ #
# custom ops and autograd
# ------------------------------------------------------------------ #


@torch.library.custom_op("deeperspeed_tpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  sm_scale: float, causal: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd(q, k, v, sm_scale, causal)


@_flash_fwd_op.register_fake
def _(q, k, v, sm_scale, causal):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.custom_op("deeperspeed_tpu_torch::flash_bwd", mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  sm_scale: float, causal: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return flash_bwd(q, k, v, o, lse, do, sm_scale, causal)


@_flash_bwd_op.register_fake
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
    dq, dk, dv = _flash_bwd_op(q, k, v, o, lse, do.contiguous(),
                               ctx.sm_scale, ctx.causal)
    return dq, dk, dv, None, None


_flash_fwd_op.register_autograd(_backward, setup_context=_setup_context)

# the op selective checkpointing keeps (models/gpt.py, remat "matmuls")
FLASH_FWD_OP = torch.ops.deeperspeed_tpu_torch.flash_fwd.default


def attention_dispatch(shape, dtype, device) -> str:
    """Which implementation a (B, H, S, Dh) attention call of ``dtype``
    on ``device`` gets: ``"supertile"`` | ``"flash"`` | ``"xla"``.

    "supertile": the "kernels" config routes the ``supertile`` surface for
    the device (the CUDA kernel, or on the CPU under mode ``fused`` its
    plain version, as the reference runs it in interpret mode) and the
    shape gate holds. "flash": any other call on a Hopper CUDA device,
    whatever S (the reference's S > 256 rule for its flash kernels was
    measured on a TPU). "xla": dense attention, the caller's plain path.
    Causal or not does not change the decision, so unlike the reference's
    it takes no ``causal``."""
    from .flash_static import supertile_geometry_ok

    device = torch.device(device)
    if (routes_to_wrapper("supertile", device)
            and supertile_geometry_ok(*shape, dtype)):
        return "supertile"
    if device.type == "cuda" and _is_hopper(device):
        return "flash"
    return "xla"


def flash_attention_bhsd(q, k, v, causal=True, sm_scale=None):
    """Head-major (B, H, S, Dh) flash attention, differentiable: the
    super-tile kernel where ``attention_dispatch`` says "supertile", else
    the flash kernel."""
    if attention_dispatch(q.shape, q.dtype, q.device) == "supertile":
        from .flash_static import flash_attention_supertile_bhsd

        return flash_attention_supertile_bhsd(q, k, v, causal=causal,
                                              sm_scale=sm_scale)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    o, _ = _flash_fwd_op(q.contiguous(), k.contiguous(), v.contiguous(),
                         float(sm_scale), bool(causal))
    return o


def flash_attention(q, k, v, causal=True, sm_scale=None):
    """q, k, v: (B, S, H, Dh) -> (B, S, H, Dh)."""
    t = lambda x: x.transpose(1, 2)
    return t(flash_attention_bhsd(t(q), t(k), t(v), causal=causal,
                                  sm_scale=sm_scale))
