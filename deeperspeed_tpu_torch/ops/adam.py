"""Adam / AdamW over a params tree.

Counterpart of deeperspeed_tpu/ops/adam.py (``FusedAdam``, ``AdamState``).
Every leaf is cast to fp32, updated, and written back in its storage
dtype. Unlike the reference, which returns new arrays, the port updates
the params and the moments IN PLACE (and returns them): at 1.3B
parameters a second copy of params and moments would cost ~8 GB of
device memory.

The "kernels" block's ``fused_adam`` surface routes the update to the
fused kernel (ops/fused_adam.py, PERF.md kernel row 13): one launch per
dtype combination over all leaves on CUDA (mode ``fused``, or ``auto`` on
Hopper), the wrapper's plain version on the CPU under mode ``fused``.
Otherwise each leaf takes the plain update, which is the same math.

``DeepSpeedCPUAdam`` is the host Adam of the offload engine
(runtime/offload/streaming.py): the update and the fused wire codec over
flat numpy buffers, in C++ (csrc/host/ds_cpu_adam.cpp) through ctypes.
"""

import ctypes
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..monitor.tracer import trace_span
from ..utils.logging import logger
from . import op_builder
from .fused_adam import adam_plain, adam_scalars, fused_adam, group_by_dtypes
from .kernel_config import routes_to_wrapper


class AdamState(NamedTuple):
    step: int
    exp_avg: Any     # tree like params
    exp_avg_sq: Any  # tree like params


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


class FusedAdam:
    """Adam/AdamW over a tree of (usually fp32 master) params.

    ``state_dtype`` selects the moment STORAGE dtype; arithmetic is always
    fp32. The second moment keeps a low-precision state_dtype only when
    its per-step relative update (1 - beta2) is at least 2^-7, about two
    bf16 ulps; below that (e.g. beta2 = 0.999) bf16 would round the
    updates away, so it stays fp32, as in the reference."""

    def __init__(
        self,
        lr: float = 1e-3,
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        adam_w_mode: bool = True,
        bias_correction: bool = True,
        amsgrad: bool = False,
        state_dtype: torch.dtype = torch.float32,
    ):
        if amsgrad:
            raise NotImplementedError("FusedAdam does not support amsgrad")
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction
        self.state_dtype = state_dtype
        self.state_dtype_sq = (state_dtype
                               if (1.0 - self.betas[1]) >= 2.0 ** -7
                               else torch.float32)
        if self.state_dtype_sq != state_dtype:
            logger.warning(
                "FusedAdam: exp_avg_sq kept in fp32 despite state_dtype=%s "
                "— 1-beta2=%.2e is below 2^-7, where bf16 second moments "
                "round updates to zero. Budget +4 bytes/param of optimizer "
                "state, or use beta2 <= 0.992 (e.g. 0.95) for bf16 moments.",
                state_dtype, 1.0 - self.betas[1])

    def init(self, params) -> AdamState:
        return AdamState(
            step=0,
            exp_avg=tree_map(lambda p: torch.zeros_like(
                p, dtype=self.state_dtype), params),
            exp_avg_sq=tree_map(lambda p: torch.zeros_like(
                p, dtype=self.state_dtype_sq), params),
        )

    @torch.no_grad()
    def update(self, grads, state: AdamState, params,
               lr: Optional[float] = None, cast=None):
        """One step: returns (params, new_state), both updated in place.
        With ``cast`` (a tree like params, e.g. the compute-dtype params of
        a master path) its leaves are given the new params in their own
        dtype, in the same pass."""
        b1, b2 = self.betas
        step = state.step + 1
        lr, bc1, bc2 = adam_scalars(self.lr if lr is None else lr, step, b1,
                                    b2, self.bias_correction)
        ps = tree_leaves(params)
        lists = (ps, tree_leaves(grads), tree_leaves(state.exp_avg),
                 tree_leaves(state.exp_avg_sq),
                 None if cast is None else tree_leaves(cast))
        kw = dict(b1=b1, b2=b2, eps=self.eps, wd=self.weight_decay,
                  adam_w=self.adam_w_mode)
        if ps and routes_to_wrapper("fused_adam", ps[0].device):
            with trace_span("kernels/fused_adam", lane="kernels",
                            leaves=len(ps)):
                for key, idx in group_by_dtypes(*lists).items():
                    ps_, gs_, ms_, vs_, cs_ = (
                        None if t is None else [t[i] for i in idx]
                        for t in lists)
                    fused_adam(ps_, gs_, ms_, vs_,
                               None if key[-1] is None else cs_,
                               lr, bc1, bc2, **kw)
        else:
            adam_plain(*lists, lr, bc1, bc2, **kw)
        return params, AdamState(step, state.exp_avg, state.exp_avg_sq)


# ------------------------------------------------------------------ #
# host Adam over numpy buffers (the offload engine's optimizer)
# ------------------------------------------------------------------ #

_c = ctypes
_FP = _c.POINTER(_c.c_float)
_U8P = _c.POINTER(_c.c_uint8)
_U16P = _c.POINTER(_c.c_uint16)
_CPU_ADAM_SIGNATURES = {
    "ds_adam_create": ([_c.c_int] + [_c.c_float] * 5 + [_c.c_int, _c.c_int],
                       _c.c_int),
    "ds_adam_destroy": ([_c.c_int], _c.c_int),
    "ds_adam_step": ([_c.c_int, _c.c_longlong] + [_c.c_float] * 5
                     + [_FP, _FP, _FP, _FP, _c.c_longlong], _c.c_int),
    "ds_adam_step_copy_bf16": ([_c.c_int, _c.c_longlong] + [_c.c_float] * 5
                               + [_FP, _FP, _FP, _FP, _c.c_longlong, _U16P],
                               _c.c_int),
    "ds_adam_simd_width": ([], _c.c_char_p),
    "ds_stream_chunk_step": ([
        _c.c_int, _c.c_longlong, _c.c_float,
        _U8P, _FP,                    # wire grads: packed + scales
        _FP, _FP, _FP,                # master, exp_avg, exp_avg_sq
        _U16P,                        # bf16 shadow bits
        _U8P, _FP,                    # delta wire out: packed + scales
        _c.POINTER(_c.c_longlong), _c.POINTER(_c.c_int),  # leaf geometry
        _c.c_longlong, _c.c_int,      # n_leaves, block
    ], _c.c_int),
    "ds_stream_chunk_step2": ([
        _c.c_int, _c.c_longlong, _c.c_float,
        _U8P, _FP,                    # wire grads: packed + scales
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int,  # state, bf16 flag
        _U16P,                        # bf16 shadow bits (mode 0)
        _U8P, _FP,                    # mode-0 delta wire out
        _U8P, _FP, _U16P,             # mode-1 resident out: c/s/w
        _c.POINTER(_c.c_longlong), _c.POINTER(_c.c_int),
        _c.POINTER(_c.c_int),
        _c.c_longlong, _c.c_int, _c.c_int,  # n_leaves, block, mode
    ], _c.c_int),
    "ds_stream_blocks_step2": ([
        _c.c_int, _c.c_longlong, _c.c_float,
        _U8P, _FP,                    # the leaf's wire grads and scales
        _c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_int,  # state, bf16 flag
        _U16P,                        # the leaf's bf16 shadow (mode 0)
        _U8P, _FP, _U16P,             # the leaf's uplink codes/scales/words
        _c.c_longlong, _c.c_int, _c.c_int,  # n, wire bits, resident bits
        _c.c_int, _c.c_int,           # block, mode
        _c.c_longlong, _c.c_longlong,  # the block range
    ], _c.c_int),
}


def load_cpu_adam() -> ctypes.CDLL:
    """The host Adam library (csrc/host/ds_cpu_adam.cpp), built at first
    use; raises with the compiler's output when it cannot be built."""
    return op_builder.load_host("ds_cpu_adam", _CPU_ADAM_SIGNATURES)


def _ptr(a, t):
    return None if a is None else a.ctypes.data_as(_c.POINTER(t))


class DeepSpeedCPUAdam(FusedAdam):
    """Host-side Adam for the offload engine: the reference's
    ``DeepSpeedCPUAdam`` (ops/adam.py) over flat numpy buffers, through
    the native library csrc/host/ds_cpu_adam.cpp (AVX-512 or AVX2 with
    FMA, OpenMP over 64K-element chunks in ``step_flat``). As a device
    optimizer it is ``FusedAdam``.

    ``native=True`` (the default) builds and loads the library now and
    raises if it cannot; ``native=False`` takes the numpy versions, the
    same math in numpy's order of operations. Each instance registers its
    hyperparameters under its own id in the library's registry and drops
    them when collected, as the reference's create/destroy pair does."""

    _next_id = 0

    def __init__(self, *args, native: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self._lib = None
        self._opt_id = None
        if native:
            self._lib = load_cpu_adam()
            DeepSpeedCPUAdam._next_id += 1
            self._opt_id = DeepSpeedCPUAdam._next_id
            self._lib.ds_adam_create(
                self._opt_id, self.lr, self.betas[0], self.betas[1], self.eps,
                self.weight_decay, int(self.adam_w_mode),
                int(self.bias_correction))

    def __del__(self):
        lib, oid = getattr(self, "_lib", None), getattr(self, "_opt_id", None)
        if lib is not None and oid is not None:
            lib.ds_adam_destroy(oid)

    @property
    def has_native(self) -> bool:
        return self._lib is not None

    def simd_width(self) -> str:
        """The library's vector path: "avx512", "avx2" or "scalar"."""
        return self._lib.ds_adam_simd_width().decode()

    def step_stream_chunk(self, step, g_packed, g_scales, master, exp_avg,
                          exp_avg_sq, shadow_u16, out_packed, out_scales,
                          leaf_sizes, leaf_bits, block, lr=None) -> bool:
        """The fused wire step (``ds_stream_chunk_step``): dequantize the
        int4/int8 wire grads, Adam the fp32 master chunk, quantize the
        error-fed delta against the bf16 shadow and advance the shadow, in
        one native pass. False when the library is not loaded or a leaf's
        wire is not 4 or 8 bits (the numpy pass then runs)."""
        if self._lib is None:
            return False
        lr = self.lr if lr is None else float(lr)
        sizes = np.ascontiguousarray(leaf_sizes, np.int64)
        bits = np.ascontiguousarray(leaf_bits, np.int32)
        rc = self._lib.ds_stream_chunk_step(
            self._opt_id, int(step), lr,
            _ptr(g_packed, _c.c_uint8), _ptr(g_scales, _c.c_float),
            _ptr(master, _c.c_float), _ptr(exp_avg, _c.c_float),
            _ptr(exp_avg_sq, _c.c_float), _ptr(shadow_u16, _c.c_uint16),
            _ptr(out_packed, _c.c_uint8), _ptr(out_scales, _c.c_float),
            _ptr(sizes, _c.c_longlong), _ptr(bits, _c.c_int),
            len(sizes), int(block))
        if rc == -2:
            return False
        if rc != 0:
            raise RuntimeError("native stream_chunk_step failed")
        return True

    def step_stream_chunk2(self, step, g_packed, g_scales, master, exp_avg,
                           exp_avg_sq, shadow_u16, out_packed, out_scales,
                           out_c, out_s, out_w, leaf_sizes, leaf_bits,
                           res_bits, block, mode, lr=None) -> bool:
        """The generalized wire step (``ds_stream_chunk_step2``): host
        state as fp32 or bf16 bits (inferred from ``master.dtype``, all
        three alike), uplink ``mode`` 0 the error-fed delta against the
        shadow, 1 the new resident codes (``out_c``/``out_s``/``out_w``).
        False, with nothing stepped, when the library is not loaded or a
        leaf's precisions are not 4/8-bit wire and 4/8/16-bit resident.
        ctypes drops the GIL for the call, so calls on disjoint leaves may
        run on several threads."""
        if self._lib is None:
            return False
        lr = self.lr if lr is None else float(lr)
        state_bf16 = master.dtype == np.uint16
        expect = np.uint16 if state_bf16 else np.float32
        for a in (master, exp_avg, exp_avg_sq):
            if a.dtype != expect or not a.flags["C_CONTIGUOUS"]:
                raise ValueError(f"state buffers must be contiguous "
                                 f"{np.dtype(expect)}, got {a.dtype}")
        if any(b not in (4, 8) for b in leaf_bits) or (
                mode == 1 and any(b not in (4, 8, 16) for b in res_bits)):
            return False
        sizes = np.ascontiguousarray(leaf_sizes, np.int64)
        bits = np.ascontiguousarray(leaf_bits, np.int32)
        rbits = np.ascontiguousarray(res_bits, np.int32)
        vptr = lambda a: _c.c_void_p(a.ctypes.data)
        rc = self._lib.ds_stream_chunk_step2(
            self._opt_id, int(step), lr,
            _ptr(g_packed, _c.c_uint8), _ptr(g_scales, _c.c_float),
            vptr(master), vptr(exp_avg), vptr(exp_avg_sq), int(state_bf16),
            _ptr(shadow_u16, _c.c_uint16),
            _ptr(out_packed, _c.c_uint8), _ptr(out_scales, _c.c_float),
            _ptr(out_c, _c.c_uint8), _ptr(out_s, _c.c_float),
            _ptr(out_w, _c.c_uint16),
            _ptr(sizes, _c.c_longlong), _ptr(bits, _c.c_int),
            _ptr(rbits, _c.c_int), len(sizes), int(block), int(mode))
        if rc != 0:
            raise RuntimeError(f"native stream_chunk_step2 failed ({rc})")
        return True

    def step_stream_blocks2(self, step, g_packed, g_scales, master, exp_avg,
                            exp_avg_sq, shadow_u16, up_codes, up_scales,
                            out_w, n, bits, res_bits, block, mode, b_begin,
                            b_end, lr=None) -> bool:
        """Wire blocks [b_begin, b_end) of ONE leaf of
        ``step_stream_chunk2`` (``ds_stream_blocks_step2``): each array is
        the leaf's own (its wire, scales, state, shadow, uplink), the
        uplink codes zeroed by the caller beforehand. Disjoint ranges may
        run on several threads, except the two halves of a leaf with a
        4-bit uplink, whose blocks share bytes. False when the library is
        not loaded or the precisions are not 4/8-bit wire and 4/8/16-bit
        resident."""
        if self._lib is None:
            return False
        if bits not in (4, 8) or (mode == 1 and res_bits not in (4, 8, 16)):
            return False
        lr = self.lr if lr is None else float(lr)
        vptr = lambda a: _c.c_void_p(a.ctypes.data)
        rc = self._lib.ds_stream_blocks_step2(
            self._opt_id, int(step), lr,
            _ptr(g_packed, _c.c_uint8), _ptr(g_scales, _c.c_float),
            vptr(master), vptr(exp_avg), vptr(exp_avg_sq),
            int(master.dtype == np.uint16), _ptr(shadow_u16, _c.c_uint16),
            _ptr(up_codes, _c.c_uint8), _ptr(up_scales, _c.c_float),
            _ptr(out_w, _c.c_uint16), int(n), int(bits), int(res_bits),
            int(block), int(mode), int(b_begin), int(b_end))
        if rc != 0:
            raise RuntimeError(f"native stream_blocks_step2 failed ({rc})")
        return True

    def step_flat(self, step, params, grads, exp_avg, exp_avg_sq, lr=None,
                  bf16_out=None):
        """In-place Adam step on flat fp32 numpy arrays; ``bf16_out``
        (uint16) receives the round-to-nearest-even bf16 bits of the
        updated params when given."""
        lr = self.lr if lr is None else float(lr)
        for a in (params, grads, exp_avg, exp_avg_sq):
            if a.dtype != np.float32 or not a.flags["C_CONTIGUOUS"]:
                raise ValueError("step_flat takes contiguous fp32 arrays")
        if self._lib is not None:
            fp = lambda x: _ptr(x, _c.c_float)
            if bf16_out is not None:
                rc = self._lib.ds_adam_step_copy_bf16(
                    self._opt_id, int(step), lr, -1.0, -1.0, -1.0, -1.0,
                    fp(params), fp(grads), fp(exp_avg), fp(exp_avg_sq),
                    params.size, _ptr(bf16_out, _c.c_uint16))
            else:
                rc = self._lib.ds_adam_step(
                    self._opt_id, int(step), lr, -1.0, -1.0, -1.0, -1.0,
                    fp(params), fp(grads), fp(exp_avg), fp(exp_avg_sq),
                    params.size)
            if rc != 0:
                raise RuntimeError("native cpu_adam step failed")
            return
        # numpy (the reference's fallback, FusedAdam's math)
        b1, b2 = self.betas
        g = grads
        if self.weight_decay and not self.adam_w_mode:
            g = g + self.weight_decay * params
        exp_avg *= b1
        exp_avg += (1.0 - b1) * g
        exp_avg_sq *= b2
        exp_avg_sq += (1.0 - b2) * g * g
        if self.bias_correction:
            bc1 = 1.0 - b1 ** step
            bc2 = 1.0 - b2 ** step
        else:
            bc1 = bc2 = 1.0
        denom = np.sqrt(exp_avg_sq / bc2) + self.eps
        upd = (exp_avg / bc1) / denom
        if self.weight_decay and self.adam_w_mode:
            upd = upd + self.weight_decay * params
        params -= lr * upd
        if bf16_out is not None:
            u = params.view(np.uint32)
            bf16_out[:] = ((u + np.uint32(0x7FFF) + ((u >> 16) & 1)) >> 16
                           ).astype(np.uint16)
