"""Block-sparse attention kernels, forward and backward.

The port of rows 17-20 of the reference's Pallas kernels
(deeperspeed_tpu/ops/sparse_attention/kernels.py): the streaming pair
``_bs_fwd``/``_bs_bwd`` over a flat LUT and the K/V-resident pair
``_bs_fwd_res``/``_bs_bwd_res`` over a super-tile LUT. Both pairs compute
one function, block-sparse softmax(Q K^T * scale) V with the fp32
logsumexp saved for a flash-2 backward; they differ only in how the TPU's
VMEM holds K and V. The port has one hand-written CUDA pair in
``csrc/sparse_attention.cu`` for all four:

  ``sparse_fwd``  q, k, v (B, H, S, Dh), the CSR tables of a
                  ``kernels.SparseLut``, an optional (B, S) fp32 additive
                  key mask -> (o (B, H, S, Dh) in q's dtype, lse (B, H, S)
                  fp32). bf16 runs on the tensor cores over the lut's
                  query groups (as the backward's dQ, ``fwd_plan`` its
                  launch); fp32 on the first port's CUDA-core kernel.
  ``sparse_bwd``  (q, k, v, o, lse, do, tables, mask) -> (dq, dk, dv):
                  delta = rowsum(dO * O) (a kernel of its own, where the
                  reference computes it outside its kernels), then dQ over
                  the row table and dK/dV over the transposed one. bf16
                  runs on the tensor cores over the lut's groups (16-row
                  tiles with identical block lists, four a thread block,
                  longest list first); fp32 on the first port's CUDA-core
                  kernels, whose fp32 FMAs keep the port's fp32 tolerance.

The kernels take sparsity blocks in ``BLOCKS``, head dims in
``HEAD_DIMS``, fp32 and bf16; a CUDA tensor of anything else raises.
Unlike the reference's kernels they take the key-padding mask, which the
reference's module sends to its dense path instead: an added bias on the
scores, where a key whose mask is <= NEG_INF / 2 counts as not visible,
and a row with no visible key gives o = 0 and lse = NEG_INF (and a zero
gradient).

Beside each kernel sits its plain PyTorch version (``sparse_fwd_plain``,
``sparse_bwd_plain``): dense-mask PyTorch over the expanded layout, in
chunks of heads so that S = 8192 fits, with the kernels' rounding (fp32
scores, P cast to the input dtype before P V, dS before its products).
A wrapper takes the plain version only for a CPU tensor; for a CUDA
tensor it launches the kernel or raises. ``sparse_fwd.launches`` and
``sparse_bwd.launches`` count launches (one a call).

The pair is registered as the ``torch.library`` custom ops
``deeperspeed_tpu_torch::sparse_fwd`` and ``::sparse_bwd``, joined by
``register_autograd``. ``sparse_attention_bhsd`` is the differentiable
entry point; with ``plain=True`` it runs the plain versions on any device
(the counterpart of the reference's interpret mode).
"""

import ctypes
from typing import Optional, Tuple

import torch

from ...monitor.perf import declares
from .. import op_builder
from ..kernel_config import takes_plain
from ..flash_attention import attention_work
from .kernels import GROUP_TILES, NEG_INF, DeviceLut, dense_mask

HEAD_DIMS = (64, 96, 128)
BLOCKS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BH = 65535  # grid.y of the CUDA launch
# elements of one fp32 (B, heads, S, S) score tensor in the plain versions
_PLAIN_CHUNK_ELEMS = 2 ** 28

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "ds_sparse_error_string": ([_I], ctypes.c_char_p),
    "ds_sparse_fwd": ([_P] * 9 + [_I] * 6 + [_F, _I, _I, _P], _I),
    "ds_sparse_bwd": ([_P] * 17 + [_I] * 7 + [_F, _I, _I, _P], _I),
    "ds_sparse_kernel_info": ([_I, _I, _I, ctypes.POINTER(_I)], _I),
}
# the bf16 kernels ``kernel_info`` describes, by the index the library
# takes: the backward's three, then the forward
KERNELS = ("sparse_bwd_dq", "sparse_bwd_dkdv", "sparse_bwd_delta",
           "sparse_fwd")
_INFO_KEYS = ("registers", "static_smem", "dynamic_smem", "local_bytes",
              "threads", "blocks_per_sm")
# the bf16 forward: four warps a thread block, one a 16-row tile; each
# step gathers 64 keys
FWD_THREADS = 128
_STEP_KEYS = 64
MAX_SMEM = 232448  # a thread block's shared memory on Hopper (227 KB)


def _lib():
    return op_builder.load("sparse_attention", _SIGNATURES)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = _lib().ds_sparse_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")


def kernel_info(kernel: str, head_dim: int, list_len: int = 0) -> dict:
    """The compiled bf16 ``kernel`` (one of KERNELS) for ``head_dim`` at
    its launch configuration with a block list of ``list_len`` ids (S /
    block) in shared memory: registers, static and dynamic shared memory,
    local memory a thread (spills), threads and blocks an SM (the CUDA
    occupancy calculator). Builds the library if needed."""
    out = (_I * len(_INFO_KEYS))()
    _raise_on(_lib().ds_sparse_kernel_info(KERNELS.index(kernel), head_dim,
                                           list_len, out), f"{kernel} info")
    return dict(zip(_INFO_KEYS, out))


def fwd_plan(S: int, block: int, head_dim: int) -> dict:
    """How the bf16 ``sparse_fwd`` launches at sequence length S, sparsity
    block ``block`` and ``head_dim`` (csrc/sparse_attention.cu says why):
    ``threads`` a thread block (four warps, one a 16-row query tile of its
    group), ``list_len`` the most block ids a group's list holds (S /
    block, kept in shared memory), ``smem_bytes`` its dynamic shared memory
    (the group's own Q rows, two stages of 64 gathered K and V rows, the
    stages' key positions and biases, the list) and ``fits``, whether that
    is within a block's 227 KB. A group table row (``kernels.build_groups``)
    launches one block for each batch."""
    list_len = S // block
    tiles = (1 + 2 * 2) * _STEP_KEYS * head_dim * 2
    smem = tiles + 4 * _STEP_KEYS * 4 + list_len * 4
    return {"threads": FWD_THREADS, "list_len": list_len,
            "smem_bytes": smem, "fits": smem <= MAX_SMEM}


# ------------------------------------------------------------------ #
# plain versions
# ------------------------------------------------------------------ #


def _head_chunks(B, H, S):
    step = max(1, _PLAIN_CHUNK_ELEMS // max(1, B * S * S))
    return [(h, min(H, h + step)) for h in range(0, H, step)]


def _masked_scores(q, k, layout, block, sm_scale, causal, kpm):
    """fp32 scores of a head chunk with NEG_INF where a key is not visible,
    and the visibility (B|1, h, S, S)."""
    S = q.shape[2]
    vis = dense_mask(layout, block, S, causal, q.device)[None]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if kpm is not None:
        s = s + kpm[:, None, None, :]
        vis = vis & (kpm > NEG_INF / 2)[:, None, None, :]
    return s.masked_fill(~vis, NEG_INF), vis


def _kpm(key_padding_mask, q):
    if key_padding_mask is None:
        return None
    return torch.as_tensor(key_padding_mask, device=q.device).float()


def sparse_fwd_plain(q, k, v, layout, block, sm_scale, causal,
                     key_padding_mask=None):
    """Plain block-sparse forward on (B, H, S, Dh) over the (H, nb, nb)
    ``layout`` (numpy or tensor): (o in q's dtype, lse (B, H, S) fp32).
    fp32 scores, p = exp(s - rowmax) over the visible keys cast to the
    input dtype before P V, the row sum of the uncast p; a row with no
    visible key gives o = 0 and lse = NEG_INF."""
    B, H, S, _ = q.shape
    kpm = _kpm(key_padding_mask, q)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    for h0, h1 in _head_chunks(B, H, S):
        s, vis = _masked_scores(q[:, h0:h1], k[:, h0:h1], layout[h0:h1],
                                block, sm_scale, causal, kpm)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m) * vis
        del s, vis
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(),
                           v[:, h0:h1].float())
        del p
        alive = l > 0
        o[:, h0:h1] = torch.where(alive, acc / l.clamp_min(1e-30),
                                  0.0).to(q.dtype)
        lse[:, h0:h1] = torch.where(alive, m + torch.log(l.clamp_min(1e-30)),
                                    NEG_INF)[..., 0]
    return o, lse


def sparse_bwd_plain(q, k, v, o, lse, do, layout, block, sm_scale, causal,
                     key_padding_mask=None):
    """Plain flash-2 backward from the saved lse: (dq, dk, dv) in q's
    dtype. P = exp(s - lse) on the visible keys of rows with lse >
    NEG_INF / 2, else 0; delta = rowsum(dO * O); P and dS = P (dP - delta)
    * scale are cast to the input dtype before their products."""
    B, H, S, _ = q.shape
    kpm = _kpm(key_padding_mask, q)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    for h0, h1 in _head_chunks(B, H, S):
        hs = slice(h0, h1)
        qf, kf, vf, dof = (t[:, hs].float() for t in (q, k, v, do))
        s, vis = _masked_scores(q[:, hs], k[:, hs], layout[h0:h1], block,
                                sm_scale, causal, kpm)
        lse_c = lse[:, hs, :, None]
        p = torch.exp(s - lse_c) * (vis & (lse_c > NEG_INF / 2))
        del s, vis
        delta = (dof * o[:, hs].float()).sum(dim=-1, keepdim=True)
        dv[:, hs] = torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).float(),
                                 dof).to(q.dtype)
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
        ds = (p * (dp - delta) * sm_scale).to(q.dtype).float()
        del p, dp
        dk[:, hs] = torch.einsum("bhqk,bhqd->bhkd", ds, qf).to(q.dtype)
        dq[:, hs] = torch.einsum("bhqk,bhkd->bhqd", ds, kf).to(q.dtype)
    return dq, dk, dv


# ------------------------------------------------------------------ #
# kernel wrappers
# ------------------------------------------------------------------ #


def _check(name, tensors, like, lut: DeviceLut, key_padding_mask):
    """Every tensor CUDA, contiguous, shaped and typed like ``like``; the
    geometry one the kernels take; the tables and the mask on its device."""
    if like.dim() != 4:
        raise ValueError(f"{name} takes (B, H, S, Dh) tensors, got "
                         f"{tuple(like.shape)}")
    B, H, S, Dh = like.shape
    if like.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} takes float32 or bfloat16, got {like.dtype}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"{name} takes head_dim in {HEAD_DIMS}, got {Dh}")
    if lut.block not in BLOCKS:
        raise ValueError(f"{name} takes sparsity blocks in {BLOCKS}, got "
                         f"{lut.block}")
    Hl, nb, _ = lut.layout.shape
    if Hl != H or nb * lut.block != S:
        raise ValueError(f"{name}: tables built for {Hl} heads and S = "
                         f"{nb * lut.block}, got {tuple(like.shape)}")
    if B * H < 1 or B * H > _MAX_BH:
        raise ValueError(f"{name} takes 1 <= B * H <= {_MAX_BH}, got "
                         f"{tuple(like.shape)}")
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
    for t in lut[1:7]:
        if t.device != like.device or t.dtype != torch.int32:
            raise ValueError(f"{name}: the CSR tables and groups must be "
                             f"int32 on {like.device}")
    if key_padding_mask is not None and (
            key_padding_mask.device != like.device
            or key_padding_mask.dtype != torch.float32
            or tuple(key_padding_mask.shape) != (B, S)
            or not key_padding_mask.is_contiguous()):
        raise ValueError(f"{name} takes a contiguous fp32 key_padding_mask "
                         f"of shape {(B, S)} on {like.device}")
    return B, H, S, Dh


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None or t.numel() == 0 else t.data_ptr()


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_groups(name, B, tables):
    """Each (what, table) a contiguous (n, GROUP_TILES + 2) group table
    whose n * B blocks fit the launch's grid."""
    for what, t in tables:
        if (t.dim() != 2 or t.shape[1] != GROUP_TILES + 2
                or not t.is_contiguous()):
            raise ValueError(f"{name}: {what} must be a contiguous "
                             f"(n, {GROUP_TILES + 2}) table")
        if t.shape[0] * B > 0x7FFFFFFF:
            raise ValueError(f"{name}: {t.shape[0]} groups x B = {B} "
                             f"exceed the launch's grid")


def _sparse_work(out, q, k, v, *rest, backward=False):
    """attention_work over the (query, key) pairs of the layout's blocks
    (the lut follows q, k, v, and o, lse, do before it backward)."""
    lut = next(a for a in rest if isinstance(a, DeviceLut))
    pairs = q.shape[0] * int(lut.layout.sum()) * lut.block ** 2
    return attention_work(out, q, k, v, *rest, pairs=pairs,
                          backward=backward)


@declares(_sparse_work)
def sparse_fwd(q, k, v, lut: DeviceLut, sm_scale, causal,
               key_padding_mask=None):
    """Block-sparse forward kernel on contiguous (B, H, S, Dh) q, k, v of
    one dtype over ``lut`` (``kernels.SparseLut.on(device)``), with an
    optional contiguous (B, S) fp32 additive key mask: returns (o, lse
    (B, H, S) fp32). bf16 runs on the tensor cores over the lut's query
    groups; fp32 on the first port's CUDA-core kernel over the row table.
    A CPU tensor takes ``sparse_fwd_plain``."""
    if takes_plain(q.device):
        return sparse_fwd_plain(q, k, v, lut.layout, lut.block, sm_scale,
                                causal, key_padding_mask)
    if q.device.type != "cuda":
        raise ValueError(f"sparse_fwd takes a CPU or CUDA tensor, got "
                         f"{q.device}")
    B, H, S, Dh = _check("sparse_fwd", (q, k, v), q, lut, key_padding_mask)
    if q.dtype == torch.bfloat16:
        _check_groups("sparse_fwd", B, (("q_groups", lut.q_groups),))
        if not fwd_plan(S, lut.block, Dh)["fits"]:
            raise ValueError(f"sparse_fwd: a block list of S / block = "
                             f"{S // lut.block} ids does not fit a thread "
                             f"block's shared memory beside the tiles at "
                             f"head_dim {Dh}")
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.ds_sparse_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_padding_mask),
            _ptr(lut.row_offsets), _ptr(lut.row_cols), _ptr(lut.q_groups),
            o.data_ptr(), lse.data_ptr(), B * H, H, S, lut.block, Dh,
            lut.q_groups.shape[0], float(sm_scale), int(bool(causal)),
            _DTYPE_CODES[q.dtype], _stream(q.device))
    _raise_on(err, "sparse_fwd")
    sparse_fwd.launches += 1
    return o, lse


sparse_fwd.launches = 0


@declares(lambda *a, **k: _sparse_work(*a, **k, backward=True))
def sparse_bwd(q, k, v, o, lse, do, lut: DeviceLut, sm_scale, causal,
               key_padding_mask=None):
    """Block-sparse backward kernels (delta = rowsum(dO * O), dQ over the
    row table, then dK/dV over the transposed one; bf16 over the lut's
    groups) on contiguous (B, H, S, Dh) tensors of one dtype and
    ``sparse_fwd``'s fp32 lse: returns (dq, dk, dv). A CPU tensor takes
    ``sparse_bwd_plain``."""
    if takes_plain(q.device):
        return sparse_bwd_plain(q, k, v, o, lse, do, lut.layout, lut.block,
                                sm_scale, causal, key_padding_mask)
    if q.device.type != "cuda":
        raise ValueError(f"sparse_bwd takes a CPU or CUDA tensor, got "
                         f"{q.device}")
    B, H, S, Dh = _check("sparse_bwd", (q, k, v, o, do), q, lut,
                         key_padding_mask)
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (B, H, S) or not lse.is_contiguous()):
        raise ValueError(f"sparse_bwd takes a contiguous fp32 lse of shape "
                         f"{(B, H, S)} on {q.device}")
    _check_groups("sparse_bwd", B, (("q_groups", lut.q_groups),
                                    ("kv_groups", lut.kv_groups)))
    # scratch for delta, written by the first kernel
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.ds_sparse_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(key_padding_mask), _ptr(lut.row_offsets),
            _ptr(lut.row_cols), _ptr(lut.col_offsets), _ptr(lut.col_rows),
            _ptr(lut.q_groups), _ptr(lut.kv_groups), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B * H, H, S, lut.block, Dh,
            lut.q_groups.shape[0], lut.kv_groups.shape[0], float(sm_scale),
            int(bool(causal)), _DTYPE_CODES[q.dtype], _stream(q.device))
    _raise_on(err, "sparse_bwd")
    sparse_bwd.launches += 1
    return dq, dk, dv


sparse_bwd.launches = 0


# ------------------------------------------------------------------ #
# custom ops and autograd
# ------------------------------------------------------------------ #


@torch.library.custom_op("deeperspeed_tpu_torch::sparse_fwd", mutates_args=())
def _sparse_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   layout: torch.Tensor, row_offsets: torch.Tensor,
                   row_cols: torch.Tensor, col_offsets: torch.Tensor,
                   col_rows: torch.Tensor, q_groups: torch.Tensor,
                   kv_groups: torch.Tensor,
                   key_padding_mask: Optional[torch.Tensor], block: int,
                   sm_scale: float, causal: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    lut = DeviceLut(layout, row_offsets, row_cols, col_offsets, col_rows,
                    q_groups, kv_groups, block)
    return sparse_fwd(q, k, v, lut, sm_scale, causal, key_padding_mask)


@_sparse_fwd_op.register_fake
def _(q, k, v, layout, row_offsets, row_cols, col_offsets, col_rows,
      q_groups, kv_groups, key_padding_mask, block, sm_scale, causal):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


@torch.library.custom_op("deeperspeed_tpu_torch::sparse_bwd", mutates_args=())
def _sparse_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   layout: torch.Tensor, row_offsets: torch.Tensor,
                   row_cols: torch.Tensor, col_offsets: torch.Tensor,
                   col_rows: torch.Tensor, q_groups: torch.Tensor,
                   kv_groups: torch.Tensor,
                   key_padding_mask: Optional[torch.Tensor], block: int,
                   sm_scale: float, causal: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    lut = DeviceLut(layout, row_offsets, row_cols, col_offsets, col_rows,
                    q_groups, kv_groups, block)
    return sparse_bwd(q, k, v, o, lse, do, lut, sm_scale, causal,
                      key_padding_mask)


@_sparse_bwd_op.register_fake
def _(q, k, v, o, lse, do, layout, row_offsets, row_cols, col_offsets,
      col_rows, q_groups, kv_groups, key_padding_mask, block, sm_scale,
      causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output):
    (q, k, v, layout, row_offsets, row_cols, col_offsets, col_rows, q_groups,
     kv_groups, kpm, block, sm_scale, causal) = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse, layout, row_offsets, row_cols,
                          col_offsets, col_rows, q_groups, kv_groups, kpm)
    ctx.block = block
    ctx.sm_scale = sm_scale
    ctx.causal = causal


def _backward(ctx, do, _dlse):
    (q, k, v, o, lse, layout, row_offsets, row_cols, col_offsets, col_rows,
     q_groups, kv_groups, kpm) = ctx.saved_tensors
    dq, dk, dv = _sparse_bwd_op(q, k, v, o, lse, do.contiguous(), layout,
                                row_offsets, row_cols, col_offsets, col_rows,
                                q_groups, kv_groups, kpm, ctx.block,
                                ctx.sm_scale, ctx.causal)
    return (dq, dk, dv) + (None,) * 11


_sparse_fwd_op.register_autograd(_backward, setup_context=_setup_context)


class _PlainSparseFn(torch.autograd.Function):
    """The plain pair as one differentiable function, on any device."""

    @staticmethod
    def forward(ctx, q, k, v, layout, block, sm_scale, causal, kpm):
        o, lse = sparse_fwd_plain(q, k, v, layout, block, sm_scale, causal,
                                  kpm)
        ctx.save_for_backward(q, k, v, o, lse, layout, kpm)
        ctx.args = (block, sm_scale, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, layout, kpm = ctx.saved_tensors
        block, sm_scale, causal = ctx.args
        dq, dk, dv = sparse_bwd_plain(q, k, v, o, lse, do, layout, block,
                                      sm_scale, causal, kpm)
        return dq, dk, dv, None, None, None, None, None


def sparse_attention_bhsd(q, k, v, lut: DeviceLut, sm_scale: float,
                          causal: bool, key_padding_mask=None,
                          plain: bool = False):
    """Differentiable block-sparse attention on (B, H, S, Dh) q, k, v over
    ``lut`` with an optional (B, S) additive key mask: the custom op (the
    kernel pair on CUDA, their plain versions on the CPU), or with
    ``plain=True`` the plain versions on any device."""
    kpm = (None if key_padding_mask is None else torch.as_tensor(
        key_padding_mask, device=q.device).float().contiguous())
    if plain:
        return _PlainSparseFn.apply(q, k, v, lut.layout, lut.block,
                                    float(sm_scale), bool(causal), kpm)
    o, _ = _sparse_fwd_op(q.contiguous(), k.contiguous(), v.contiguous(),
                          lut.layout, lut.row_offsets, lut.row_cols,
                          lut.col_offsets, lut.col_rows, lut.q_groups,
                          lut.kv_groups, kpm, int(lut.block),
                          float(sm_scale), bool(causal))
    return o
