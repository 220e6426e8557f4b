#!/usr/bin/env python3
"""Drive the PyTorch port (deeperspeed_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. Card: print the card's name and power limit (nvidia-smi) and build the
   CUDA kernels from deeperspeed_tpu_torch/csrc into build/kernels/, one
   nvcc per source, started together.
2. Forward fused blocks against their plain PyTorch versions, bf16 and
   fp32: LayerNorm at (R, 2048), bias+GeLU (tanh and erf) at (R, 8192),
   for R in CHECK_ROWS (every row count the serving and training runs
   give them, and ragged ones), within atol = rtol = 2e-5 (fp32) or 2e-2
   (bf16), the reference's own tolerances for these kernels.
3. Backward fused blocks against their plain versions: ln_bwd at
   (R, 2048) and bias_gelu_bwd (tanh and erf) at (R, 8192), R in
   BWD_ROWS, within 10x the forward tolerances (the reference's gradient
   tolerances, tests/test_fused_kernels.py).
4. Flash attention forward and backward against their plain versions at
   FLASH_SHAPES: the training shape (2, 16, 1024, 128), S = 2048 and 4096
   (beyond the reference's whole-S kernel), ragged S = 640 and 1000, and
   head dims 64 and 96; causal and not, bf16 and fp32; within the
   reference's flash tolerances (fp32 2e-3 forward, 5e-3 gradients; bf16
   2e-2 and 5e-2).
   Beside those element-wise tolerances, every output of phases 2-4 must
   hold ||got - want|| <= REL_L2 * ||want|| (1e-4 fp32, 1e-2 bf16: a few
   bf16 ulps on the whole tensor), which the element-wise bounds alone
   would not catch at the training shapes, where they are about as large
   as the values (a bf16 kernel that dropped a term could pass them).
   Phases 2-4 time each kernel at its training-path shape (bf16) with
   CUDA events over CUDA-graph replays, beside its plain version, its
   bound (the larger of bytes over 3.35 TB/s and operations over the
   card's peak for their type) and one PyTorch call computing the same
   function where there is one.
5. Serving at full width: GPT-NeoX-1.3B (24 layers, d_model 2048, bf16,
   random weights from a fixed seed) behind ServingEngine with the
   "kernels" block at mode "auto", 8 greedy requests with staggered
   arrivals and prompts of 16-900 tokens, 32 new tokens each. The launch
   counters are set to 0 just before the run and read just after it: 24
   bias+GeLU launches and 1 LayerNorm launch per forward. Every request
   must finish by length with 32 tokens. The first-token logits of two
   requests are recomputed with the kernels off and must agree with the
   kernel path within 0.05 of the largest |logit|.
6. Training at full width: GPT-NeoX-1.3B (max_seq 1024, remat "matmuls",
   ce_chunk 0, bf16, random weights from a fixed seed) through
   deeperspeed_tpu_torch.initialize -> Engine.train_batch with the keys
   of configs/neox_1.3b_single_chip.json (masterless bf16, Adam 2e-4
   with betas (0.9, 0.95), clipping 1.0, micro-batch 2 x 8 accumulation
   steps) plus "kernels": {"mode": "auto", "fused_adam": false} and a
   100-step warmup (WARMUP_STEPS), on one 16 x 1025 batch of
   data/corpus_tokens.npy, for 6 steps. First, on one
   micro-batch, the kernel path's loss and grads are held against the
   plain path's (kernels off, attn_impl "xla"): losses within 0.5 %, grad
   norms within 5 %, cosine of the grads >= 0.99 (bf16 limits: the two
   paths round at different places). Then the counters are zeroed, the 6
   steps run, and the counters are read: every kernel launched, at the
   counts the remat policy implies. Losses must be finite and the last
   below the first, no step skipped, every grad norm finite and > 0. A
   seventh step then runs under torch.profiler: wall and device time,
   the device's busy share, device time by kernel family and the top
   kernels.

The line before the last is the kernels JSON object, the one before it
the card; the last line is ``{"ok": true, "device": {...}}``. Without a
CUDA device the script exits non-zero before printing any result.
"""

import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
FUSED_SOURCE = "deeperspeed_tpu_torch/csrc/fused_blocks.cu"
FLASH_SOURCE = "deeperspeed_tpu_torch/csrc/flash_attention.cu"
SOURCES = {"ln_fwd": FUSED_SOURCE, "bias_gelu_fwd": FUSED_SOURCE,
           "ln_bwd": FUSED_SOURCE, "bias_gelu_bwd": FUSED_SOURCE,
           "flash_fwd": FLASH_SOURCE, "flash_bwd": FLASH_SOURCE}
# the TPU kernel each one replaces (the kernel body); flash_fwd and
# flash_bwd each replace the static and the streaming pair
REPLACES = {
    "ln_fwd": "deeperspeed_tpu/ops/pallas/fused_blocks.py:72",
    "bias_gelu_fwd": "deeperspeed_tpu/ops/pallas/fused_blocks.py:280",
    "ln_bwd": "deeperspeed_tpu/ops/pallas/fused_blocks.py:94",
    "bias_gelu_bwd": "deeperspeed_tpu/ops/pallas/fused_blocks.py:285",
    "flash_fwd": "deeperspeed_tpu/ops/pallas/flash_static.py:127",
    "flash_bwd": "deeperspeed_tpu/ops/pallas/flash_static.py:201",
}
ALSO_REPLACES = {
    "flash_fwd": "deeperspeed_tpu/ops/pallas/flash_attention.py:131",
    "flash_bwd": "deeperspeed_tpu/ops/pallas/flash_attention.py:239,319",
}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the reference's flash tolerances: (forward, gradients)
FLASH_TOL = {torch.float32: (2e-3, 5e-3), torch.bfloat16: (2e-2, 5e-2)}
# scale-aware limit on every output, by the inputs' dtype: the error's L2
# norm over the reference's (bf16: about 2.5 ulps of each element)
REL_L2 = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
LOGIT_TOL = 0.05
SEED = 0
L2_BYTES = 50 * 2**20
# rows the runs give the forward kernels: 8 decode slots and every prefill
# bucket (16 ... 1024) in serving, 2 x 1024 tokens in training, plus
# ragged counts (6 slots, 48 rows)
CHECK_ROWS = (6, 8, 16, 48, 64, 128, 256, 512, 1024, 2048)
TIMED_ROWS = (8, 512, 2048)
BWD_ROWS = (8, 48, 512, 2048)
PATH_ROWS = 2048          # B * S of the training micro-batch
# (B, H, S, Dh): the training shape first (timed), then S beyond the
# reference's whole-S kernel, ragged S, and the other head dims
FLASH_SHAPES = ((2, 16, 1024, 128), (1, 4, 2048, 128), (1, 2, 4096, 128),
                (1, 4, 640, 128), (1, 4, 1000, 128), (2, 12, 1024, 64),
                (1, 8, 1024, 96))
# the training run's bf16 limits, kernel path against plain path
LOSS_RTOL = 5e-3
GNORM_RTOL = 5e-2
MIN_COSINE = 0.99
TRAIN_STEPS = 6
# overrides the config's 1000 so the LR moves within 6 steps. The
# scheduler gives lr 0 on the first two steps; the first Adam step after
# them moves every weight by about lr (Adam's first steps are sign-like),
# which lifts the loss for a step, with or without the kernels, the
# randomized biases or an fp32 master (scripts/torch_first_step_probe.py,
# PERF.md). 100 lets the loss fall below its start by step 6; with 2 it
# had not recovered by then.
WARMUP_STEPS = 100


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, args_list, iters=100, replays=5):
    """(device ms, eager ms) per call. Device: ``iters`` calls captured in
    one CUDA graph and replayed, timed with CUDA events, so the host's
    launch cost is out of the number. Eager: the same calls launched one
    by one from Python, which is what the serving path pays today. The
    calls cycle through ``args_list`` (distinct buffers that together
    exceed the L2 cache, so each call reads its inputs from device
    memory)."""
    for args in args_list[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*args_list[i % len(args_list)])
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays), eager


def copies(make, bytes_per_call):
    n = max(2, min(512, math.ceil(2 * L2_BYTES / bytes_per_call)))
    return [make() for _ in range(n)]


def check_close(name, got, want, tol, rel):
    """Fails unless every element is within atol = rtol = ``tol`` and the
    error's L2 norm is within ``rel`` of the reference's. Returns (max abs
    error, relative L2 error)."""
    diff = got.float() - want.float()
    err = diff.abs()
    bad = err > tol + tol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol=rtol={tol}; "
            f"max abs err {float(err.max()):.3e}")
    rel_err = float(diff.norm() / want.float().norm().clamp_min(1e-30))
    if not rel_err <= rel:
        raise AssertionError(f"{name}: relative L2 error {rel_err:.3e} "
                             f"above {rel}")
    return float(err.max()), rel_err


def check_outputs(name, names, got, want, tol, rel):
    """check_close over paired outputs: (max abs error, max relative L2
    error)."""
    errs = [check_close(f"{name} {n}", a, b, tol, rel)
            for n, a, b in zip(names, got, want)]
    return max(e for e, _ in errs), max(r for _, r in errs)


def timings(kernel, plain, bufs, library=None, lib_bufs=None, iters=100,
            replays=5):
    ms, eager_ms = time_ms(kernel, bufs, iters, replays)
    plain_ms, plain_eager_ms = time_ms(plain, bufs, iters, replays)
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "eager_ms": eager_ms, "plain_eager_ms": plain_eager_ms}
    if library is not None:
        out["library_ms"], out["library_eager_ms"] = time_ms(
            library, lib_bufs, iters, replays)
    return out


def bound(nbytes, ops, ops_per_s=FP32_OPS_PER_S):
    """The least time the card could take: the larger of the bytes the
    function must move over the memory rate and its operations over the
    peak rate for their type."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes": nbytes, "ops": ops,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def randn_on(gen, shape, dtype, scale=1.0, shift=0.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale
            + shift).to(dtype)


def dtype_name(dtype):
    return str(dtype).split(".")[-1]


def kernel_phase(fb, gen):
    """Hold each kernel against its plain version at every row count in
    CHECK_ROWS; time the kernel, its plain version and the yardstick at
    TIMED_ROWS."""
    results = {"ln_fwd": [], "bias_gelu_fwd": []}

    def randn(shape, dtype, scale=1.0, shift=0.0):
        return randn_on(gen, shape, dtype, scale, shift)

    for R in CHECK_ROWS:
        for dtype in (torch.bfloat16, torch.float32):
            tol, rel = TOL[dtype], REL_L2[dtype]
            isz = torch.tensor([], dtype=dtype).element_size()
            dname = str(dtype).split(".")[-1]
            D = 2048
            x = randn((R, D), dtype)
            w = randn((D,), torch.float32, 0.1, 1.0)
            b = randn((D,), torch.float32, 0.1)
            y, mu, rs = fb.ln_fwd(x, w, b, 1e-5)
            torch.cuda.synchronize()
            py, pmu, prs = fb.ln_fwd_plain(x, w, b, 1e-5)
            err, rel_err = check_close(f"ln_fwd {R}x{D} {dname}", y, py, tol,
                                       rel)
            check_close(f"ln_fwd mean {R}x{D} {dname}", mu, pmu, 2e-5, rel)
            check_close(f"ln_fwd rstd {R}x{D} {dname}", rs, prs, 2e-5, rel)
            row = {"shape": [R, D], "dtype": dname, "max_abs_err": err,
                   "tol": tol, "rel_l2_err": rel_err, "rel_l2_tol": rel}
            if R in TIMED_ROWS:
                bufs = copies(lambda: (randn((R, D), dtype), w, b, 1e-5),
                              R * D * isz)
                # F.layer_norm takes no fp32 affine beside a bf16 x: the
                # yardstick gets w and b in x's dtype (the same bytes)
                wl, bl = w.to(dtype), b.to(dtype)
                lib_bufs = [(xx, (D,), wl, bl, 1e-5) for xx, _, _, _ in bufs]
                row.update(timings(fb.ln_fwd, fb.ln_fwd_plain, bufs,
                                   torch.nn.functional.layer_norm, lib_bufs))
                row.update(bound(2 * R * D * isz + 2 * D * 4 + 2 * R * 4,
                                 8 * R * D))
                del bufs, lib_bufs
            results["ln_fwd"].append(row)

            Fd = 8192
            for approximate in (True, False):
                x = randn((R, Fd), dtype, 2.0)
                bias = randn((Fd,), dtype)
                y = fb.bias_gelu_fwd(x, bias, approximate)
                torch.cuda.synchronize()
                py = fb.bias_gelu_fwd_plain(x, bias, approximate)
                err, rel_err = check_close(
                    f"bias_gelu_fwd {R}x{Fd} {dname} approx={approximate}",
                    y, py, tol, rel)
                row = {"shape": [R, Fd], "dtype": dname,
                       "approximate": approximate, "max_abs_err": err,
                       "tol": tol, "rel_l2_err": rel_err, "rel_l2_tol": rel}
                if R in TIMED_ROWS:
                    bufs = copies(lambda: (randn((R, Fd), dtype, 2.0), bias,
                                           approximate), R * Fd * isz)
                    row.update(timings(fb.bias_gelu_fwd,
                                       fb.bias_gelu_fwd_plain, bufs))
                    row.update(bound(2 * R * Fd * isz + Fd * isz,
                                     10 * R * Fd))
                    del bufs
                results["bias_gelu_fwd"].append(row)
    return results


def backward_phase(fb, gen):
    """ln_bwd and bias_gelu_bwd against their plain versions at every row
    count in BWD_ROWS, bf16 and fp32; timed at PATH_ROWS in bf16."""
    results = {"ln_bwd": [], "bias_gelu_bwd": []}
    D, Fd = 2048, 8192
    for R in BWD_ROWS:
        for dtype in (torch.bfloat16, torch.float32):
            tol, rel = 10 * TOL[dtype], REL_L2[dtype]
            isz = torch.tensor([], dtype=dtype).element_size()
            dname = dtype_name(dtype)
            timed = R == PATH_ROWS and dtype == torch.bfloat16

            def ln_case():
                x = randn_on(gen, (R, D), dtype, 2.0, 0.5)
                w = randn_on(gen, (D,), torch.float32, 0.1, 1.0)
                _, mean, rstd = fb.ln_fwd_plain(x, w, w, 1e-5)
                return x, w, mean, rstd, randn_on(gen, (R, D), dtype)

            args = ln_case()
            got = fb.ln_bwd(*args)
            torch.cuda.synchronize()
            want = fb.ln_bwd_plain(*args)
            err, rel_err = check_outputs(f"ln_bwd {R}x{D} {dname}",
                                         ("dx", "dw", "db"), got, want, tol,
                                         rel)
            row = {"shape": [R, D], "dtype": dname, "max_abs_err": err,
                   "tol": tol, "rel_l2_err": rel_err, "rel_l2_tol": rel}
            if timed:
                bufs = copies(ln_case, 2 * R * D * isz)
                w = bufs[0][1]
                # F.layer_norm's backward takes w in x's dtype
                wl = w.to(dtype)
                lib_bufs = [(g, xx, (D,), mu[:, None], rs[:, None], wl, wl,
                             [True, True, True])
                            for xx, _, mu, rs, g in bufs]
                row.update(timings(fb.ln_bwd, fb.ln_bwd_plain, bufs,
                                   torch.ops.aten.native_layer_norm_backward,
                                   lib_bufs))
                row["library"] = "aten.native_layer_norm_backward"
                row.update(bound(3 * R * D * isz + 8 * R + 12 * D,
                                 13 * R * D))
                del bufs, lib_bufs
            results["ln_bwd"].append(row)

            for approximate in (True, False):
                def bg_case():
                    return (randn_on(gen, (R, Fd), dtype, 2.0),
                            randn_on(gen, (Fd,), dtype),
                            randn_on(gen, (R, Fd), dtype), approximate)

                args = bg_case()
                got = fb.bias_gelu_bwd(*args)
                torch.cuda.synchronize()
                want = fb.bias_gelu_bwd_plain(*args)
                err, rel_err = check_outputs(
                    f"bias_gelu_bwd {R}x{Fd} {dname} approx={approximate}",
                    ("dx", "db"), got, want, tol, rel)
                row = {"shape": [R, Fd], "dtype": dname,
                       "approximate": approximate, "max_abs_err": err,
                       "tol": tol, "rel_l2_err": rel_err, "rel_l2_tol": rel}
                if timed and approximate:
                    bufs = copies(bg_case, 2 * R * Fd * isz)
                    row.update(timings(fb.bias_gelu_bwd,
                                       fb.bias_gelu_bwd_plain, bufs))
                    row["library"] = None
                    row.update(bound(3 * R * Fd * isz + Fd * (isz + 4),
                                     20 * R * Fd))
                    del bufs
                results["bias_gelu_bwd"].append(row)
    return results


def flash_work(shape, causal, dtype, backward):
    """(bytes, operations) the flash forward or backward must do: each
    input read once, each output written once; the products over the
    (query, key) pairs the mask keeps (S (S + 1) / 2 causal)."""
    B, H, S, Dh = shape
    isz = torch.tensor([], dtype=dtype).element_size()
    tensor = B * H * S * Dh * isz
    rows = B * H * S * 4
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    if backward:  # q, k, v, o, do, lse in; dq, dk, dv out; 5 products
        return 8 * tensor + rows, 5 * 2 * pairs * Dh
    return 4 * tensor + rows, 2 * 2 * pairs * Dh  # q, k, v in; o, lse out


def sdpa_backward_args(q, k, v, do, scale, causal):
    """Arguments of aten's flash-attention backward (the backward of
    F.scaled_dot_product_attention on the card) for one case, from its
    own forward: the yardstick is then one op, timed by ``time_ms``
    under CUDA-graph replay like every other."""
    (out, lse, cum_q, cum_k, max_q, max_k, seed, offset,
     _) = torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, causal, False, scale=scale)
    return (do, q, k, v, out, lse, cum_q, cum_k, max_q, max_k, 0.0, causal,
            seed, offset, scale)


def sdpa_backward(*args):
    return torch.ops.aten._scaled_dot_product_flash_attention_backward(
        *args[:-1], scale=args[-1])


def flash_phase(fa, gen):
    """flash_fwd and flash_bwd against their plain versions at every shape
    in FLASH_SHAPES, causal and not, bf16 and fp32; the training shape
    (the first) is timed causal in bf16."""
    results = {"flash_fwd": [], "flash_bwd": []}
    for si, shape in enumerate(FLASH_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            ftol, gtol = FLASH_TOL[dtype]
            rel = REL_L2[dtype]
            dname = dtype_name(dtype)
            for causal in (True, False):
                scale = 1.0 / math.sqrt(shape[-1])
                q, k, v, do = (randn_on(gen, shape, dtype) for _ in range(4))
                o, lse = fa.flash_fwd(q, k, v, scale, causal)
                torch.cuda.synchronize()
                po, plse = fa.flash_fwd_plain(q, k, v, scale, causal)
                tag = f"{tuple(shape)} {dname} causal={causal}"
                err, rel_err = check_outputs(f"flash_fwd {tag}", ("o", "lse"),
                                             (o, lse), (po, plse), ftol, rel)
                fwd = {"shape": list(shape), "dtype": dname,
                       "causal": causal, "max_abs_err": err, "tol": ftol,
                       "rel_l2_err": rel_err, "rel_l2_tol": rel}
                got = fa.flash_bwd(q, k, v, po, plse, do, scale, causal)
                torch.cuda.synchronize()
                want = fa.flash_bwd_plain(q, k, v, po, plse, do, scale,
                                          causal)
                err, rel_err = check_outputs(f"flash_bwd {tag}",
                                             ("dq", "dk", "dv"), got, want,
                                             gtol, rel)
                bwd = {"shape": list(shape), "dtype": dname,
                       "causal": causal, "max_abs_err": err, "tol": gtol,
                       "rel_l2_err": rel_err, "rel_l2_tol": rel}
                del o, lse, got, want
                if si == 0 and causal and dtype == torch.bfloat16:
                    def case():
                        t = [randn_on(gen, shape, dtype) for _ in range(4)]
                        o_, lse_ = fa.flash_fwd_plain(*t[:3], scale, True)
                        return t[:3] + [o_, lse_, t[3]]

                    fbytes = flash_work(shape, True, dtype, False)[0]
                    bufs = copies(case, fbytes)
                    fwd_bufs = [(a[0], a[1], a[2], scale, True) for a in bufs]
                    sdpa = torch.nn.functional.scaled_dot_product_attention
                    fwd.update(timings(
                        fa.flash_fwd, fa.flash_fwd_plain, fwd_bufs,
                        lambda a, b, c, *_: sdpa(a, b, c, is_causal=True),
                        fwd_bufs, iters=10, replays=3))
                    fwd["library"] = "F.scaled_dot_product_attention"
                    fwd.update(bound(*flash_work(shape, True, dtype, False),
                                     BF16_OPS_PER_S))
                    bwd_bufs = [tuple(a) + (scale, True) for a in bufs]
                    lib_bufs = [sdpa_backward_args(a[0], a[1], a[2], a[5],
                                                   scale, True) for a in bufs]
                    bwd.update(timings(fa.flash_bwd, fa.flash_bwd_plain,
                                       bwd_bufs, sdpa_backward, lib_bufs,
                                       iters=10, replays=3))
                    bwd["library"] = ("aten._scaled_dot_product_flash_"
                                      "attention_backward")
                    bwd.update(bound(*flash_work(shape, True, dtype, True),
                                     BF16_OPS_PER_S))
                    del bufs, fwd_bufs, bwd_bufs, lib_bufs
                results["flash_fwd"].append(fwd)
                results["flash_bwd"].append(bwd)
                del q, k, v, do, po, plse
        torch.cuda.empty_cache()
    return results


def randomize_affine(params, gen):
    """Give the biases and layer-norm parameters random values (the init
    leaves them at 0 and 1), so the serving run exercises every input of
    both kernels."""
    for k, v in params.items():
        if isinstance(v, dict):
            randomize_affine(v, gen)
        elif k.endswith("scale"):
            v.copy_(1.0 + 0.1 * torch.randn(v.shape, generator=gen,
                                            device=v.device))
        elif k.startswith("b") or k.endswith("bias"):
            v.copy_(0.1 * torch.randn(v.shape, generator=gen,
                                      device=v.device))


def serving_phase(fb, card):
    from deeperspeed_tpu_torch.models.generation import init_cache
    from deeperspeed_tpu_torch.models.gpt import get_preset, init_params
    from deeperspeed_tpu_torch.ops import kernel_config
    from deeperspeed_tpu_torch.runtime.config_utils import load_config
    from deeperspeed_tpu_torch.serving import FINISH_LENGTH, ServingEngine
    from deeperspeed_tpu_torch.serving.metrics import DECODE_TIMER

    config = load_config(json.dumps({
        "kernels": {"mode": "auto"},
        "serving": {"num_slots": 8, "block_size": 16, "num_blocks": 1024,
                    "max_seq_len": 1024},
    }))
    kernel_config.configure(**kernel_config.validate(config["kernels"]))
    cfg = get_preset("neox-1.3b", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(gen, cfg, device="cuda", dtype=torch.bfloat16)
    randomize_affine(params, gen)
    engine = ServingEngine(cfg, params, config["serving"])

    lens = [16, 40, 100, 220, 380, 550, 730, 900]
    host = torch.Generator().manual_seed(SEED)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=host).tolist()
               for n in lens]
    new = 32

    torch.cuda.synchronize()
    fb.ln_fwd.launches = 0
    fb.bias_gelu_fwd.launches = 0
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_new_tokens=new) for p in prompts[:2]]
    engine.step()
    engine.step()
    rids += [engine.submit(p, max_new_tokens=new) for p in prompts[2:5]]
    engine.step()
    rids += [engine.submit(p, max_new_tokens=new) for p in prompts[5:]]
    outs = engine.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"ln_fwd": fb.ln_fwd.launches,
                "bias_gelu_fwd": fb.bias_gelu_fwd.launches}

    forwards = engine.metrics.prefills + engine.metrics.decode_steps
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched by the run")
    if launches["ln_fwd"] != forwards or \
            launches["bias_gelu_fwd"] != cfg.n_layer * forwards:
        raise AssertionError(f"launches {launches} for {forwards} forwards")
    for rid in rids:
        req = engine.get(rid)
        if req.finish_reason != FINISH_LENGTH or len(outs[rid]) != new:
            raise AssertionError(f"{rid}: {req.finish_reason}, "
                                 f"{len(outs[rid])} tokens")
        if not all(0 <= t < cfg.vocab_size for t in outs[rid]):
            raise AssertionError(f"{rid}: token out of range")

    logit_errs = []
    for i in (0, len(prompts) - 1):
        L = len(prompts[i])
        toks = torch.zeros((1, engine.scfg.bucket_for(L)), dtype=torch.long)
        toks[0, :L] = torch.tensor(prompts[i])
        rows = {}
        for mode in ("auto", "off"):
            with kernel_config.override(mode=mode):
                cache = init_cache(cfg, 1, toks.shape[1], engine.device)
                logits, _ = engine._forward(toks.numpy(), cache, 0)
                rows[mode] = logits[0, L - 1].float()
        if int(torch.argmax(rows["auto"])) != outs[rids[i]][0]:
            raise AssertionError(f"{rids[i]}: first token differs from the "
                                 f"recomputed kernel-path logits")
        err = float((rows["auto"] - rows["off"]).abs().max())
        scale = float(rows["off"].abs().max())
        if not math.isfinite(err) or err > LOGIT_TOL * scale:
            raise AssertionError(
                f"{rids[i]}: first-token logits differ by {err:.4f} between "
                f"the kernel and plain paths (limit {LOGIT_TOL} x {scale:.3f})")
        logit_errs.append({"rid": rids[i], "prompt_len": L,
                           "max_abs_err": err, "max_abs_logit": scale})

    s = engine.metrics.summary()
    decode_s = engine.metrics.timers(DECODE_TIMER).elapsed(reset=False)
    decode_tokens = s["tokens_generated"] - s["prefills"]
    report = {
        "model": "neox-1.3b", "dtype": "bfloat16", "card": card,
        "requests": len(rids), "new_tokens": new, "prompt_lens": lens,
        "wall_s": wall_s, "forwards": forwards, "launches": launches,
        "ttft_p50_ms": s["ttft_s"]["p50"] * 1e3,
        "ttft_max_ms": s["ttft_s"]["max"] * 1e3,
        "decode_steps": s["decode_steps"],
        "decode_tokens_per_s": decode_tokens / decode_s,
        "decode_step_ms": decode_s / s["decode_steps"] * 1e3,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "first_token_logits": logit_errs,
    }
    print("serving: " + json.dumps(report), flush=True)
    print("decode profile: " + json.dumps(profile_decode(engine, prompts)),
          flush=True)
    return launches


def profile_decode(engine, prompts, new=8, top=8):
    """Where a decode step's time goes, after the main path has been read:
    8 more requests (64-token prompts) are admitted, then their decode
    steps run under torch.profiler. Reports the wall time per step, the
    device's kernel time per step and its busy share, and the kernels
    that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for p in prompts:
        engine.submit(p[:64], max_new_tokens=new)
    engine.step()                       # prefill all 8 and one decode step
    torch.cuda.synchronize()
    steps0 = engine.metrics.decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = engine.metrics.decode_steps - steps0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {
        "decode_steps": steps,
        "wall_ms_per_step": wall / steps * 1e3,
        "device_ms_per_step": device_us / 1e3 / steps,
        "device_busy_share": device_us / 1e6 / wall,
        "top_kernels": [{"name": e.key[:80], "calls_per_step": e.count / steps,
                         "device_ms_per_step":
                             e.self_device_time_total / 1e3 / steps}
                        for e in kernels[:top]],
    }


def training_config():
    """The keys of configs/neox_1.3b_single_chip.json, plus the kernels
    block of this run and a short warmup so the LR moves in 6 steps."""
    config = {
        "train_batch_size": 16,
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 8,
        "bf16": {"enabled": True, "master_weights": False},
        "zero_optimization": {"stage": 0},
        "optimizer": {"type": "Adam",
                      "params": {"lr": 2e-4, "betas": [0.9, 0.95]}},
        "scheduler": {"type": "WarmupDecayLR",
                      "params": {"warmup_max_lr": 2e-4,
                                 "warmup_num_steps": 1000,
                                 "total_num_steps": 100000}},
        "gradient_clipping": 1.0,
        "steps_per_print": 10,
        "kernels": {"mode": "auto", "fused_adam": False},
    }
    config["scheduler"]["params"]["warmup_num_steps"] = WARMUP_STEPS
    return config


def compare_paths(engine, cfg, tokens):
    """Loss and grads of one micro-batch through the kernel path (kernels
    auto, flash attention) and the plain path (kernels off, attn_impl
    "xla") from the engine's params: relative loss difference, both grad
    norms, and the cosine of the flattened grads."""
    from deeperspeed_tpu_torch.models.gpt import make_gpt
    from deeperspeed_tpu_torch.ops import kernel_config
    from deeperspeed_tpu_torch.ops.adam import tree_leaves

    leaves = tree_leaves(engine.params)
    out = {}
    for name, c, mode in (("kernels", cfg, "auto"),
                          ("plain", dataclasses.replace(cfg, attn_impl="xla"),
                           "off")):
        loss_fn = make_gpt(c)[2]
        with kernel_config.override(mode=mode, fused_adam=False):
            loss = loss_fn(engine.params, tokens)
            grads = torch.autograd.grad(loss, leaves)
        out[name] = (float(loss.detach()), grads)
        del loss
    (lk, gk), (lp, gp) = out["kernels"], out["plain"]
    dot = sum(float((a.float() * b.float()).sum()) for a, b in zip(gk, gp))
    nk = math.sqrt(sum(float(a.float().square().sum()) for a in gk))
    np_ = math.sqrt(sum(float(b.float().square().sum()) for b in gp))
    res = {"loss_kernels": lk, "loss_plain": lp,
           "loss_rel_diff": abs(lk - lp) / abs(lp),
           "grad_norm_kernels": nk, "grad_norm_plain": np_,
           "grad_norm_rel_diff": abs(nk - np_) / np_,
           "grad_cosine": dot / (nk * np_)}
    del out, gk, gp
    if not (res["loss_rel_diff"] <= LOSS_RTOL
            and res["grad_norm_rel_diff"] <= GNORM_RTOL
            and res["grad_cosine"] >= MIN_COSINE):
        raise AssertionError(
            f"kernel path disagrees with the plain path: {res} (limits: "
            f"loss {LOSS_RTOL}, grad norm {GNORM_RTOL}, cosine >= "
            f"{MIN_COSINE})")
    return res


def profile_training(engine, batch, top=10):
    """Where a training step's time goes, after the main run has been
    read: one more train_batch under torch.profiler. Reports wall time,
    device kernel time, the busy share, device time per kernel family
    (the port's kernels by name, GEMMs, the rest) and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_batch(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    families = {}
    for e in kernels:
        name = e.key
        fam = next((f for f in ("flash_fwd", "flash_bwd_dkdv",
                                "flash_bwd_dq", "ln_fwd", "ln_bwd",
                                "bias_gelu_fwd", "bias_gelu_bwd",
                                "sum_partials") if f in name),
                   "gemm" if any(w in name.lower() for w in
                                 ("gemm", "nvjet", "cutlass", "sm90_xmma"))
                   else "other")
        families[fam] = families.get(fam, 0.0) + e.self_device_time_total
    device_us = sum(families.values())
    return {
        "wall_ms": wall * 1e3, "device_ms": device_us / 1e3,
        "device_busy_share": device_us / 1e6 / wall,
        "device_ms_by_family": {k: v / 1e3 for k, v in sorted(
            families.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "device_ms": e.self_device_time_total / 1e3}
                        for e in kernels[:top]],
    }


def training_phase(card):
    """GPT-NeoX-1.3B through initialize -> train_batch; see the module
    docstring, phase 6. Returns the launch counts of the 6-step run."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models.gpt import (get_preset, init_params,
                                                  make_gpt)
    from deeperspeed_tpu_torch.ops import flash_attention as fa
    from deeperspeed_tpu_torch.ops import fused_blocks as fb
    from deeperspeed_tpu_torch.ops import kernel_config

    cfg = get_preset("neox-1.3b", max_seq=1024, remat_policy="matmuls",
                     ce_chunk=0, dtype=torch.bfloat16)
    config = training_config()
    print(f"training: scheduler warmup_num_steps overridden 1000 -> "
          f"{WARMUP_STEPS}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(gen, cfg, device="cuda", dtype=torch.bfloat16)
    randomize_affine(params, gen)
    corpus = np.load(ROOT / "data" / "corpus_tokens.npy", mmap_mode="r")
    rows = config["train_batch_size"]
    batch = np.asarray(corpus[: rows * (cfg.max_seq + 1)],
                       dtype=np.int64).reshape(rows, cfg.max_seq + 1)
    counters = {"ln_fwd": fb.ln_fwd, "ln_bwd": fb.ln_bwd,
                "bias_gelu_fwd": fb.bias_gelu_fwd,
                "bias_gelu_bwd": fb.bias_gelu_bwd,
                "flash_fwd": fa.flash_fwd, "flash_bwd": fa.flash_bwd}

    with kernel_config.override():
        engine, _, _, sched = ds.initialize(
            model=make_gpt(cfg)[2], model_parameters=params, config=config)
        del params
        micro = config["train_micro_batch_size_per_gpu"]
        parity = compare_paths(
            engine, cfg, torch.from_numpy(batch[:micro]).cuda())
        print("training parity: " + json.dumps(parity), flush=True)
        gc.collect()
        torch.cuda.empty_cache()

        losses, norms, lrs, step_s = [], [], [], []
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        for _ in range(TRAIN_STEPS):
            lrs.append(engine.get_lr()[0])
            t0 = time.perf_counter()
            loss = engine.train_batch(batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss))
            norms.append(engine.get_global_grad_norm())
        launches = {name: fn.launches for name, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()

    gas = config["gradient_accumulation_steps"]
    expected = {"flash_fwd": cfg.n_layer * gas, "flash_bwd": cfg.n_layer * gas,
                "ln_fwd": gas, "ln_bwd": gas,
                # the backward replays bias+GeLU from the kept pre-GeLU
                "bias_gelu_fwd": 2 * cfg.n_layer * gas,
                "bias_gelu_bwd": cfg.n_layer * gas}
    per_step = {k: n / TRAIN_STEPS for k, n in launches.items()}
    step_ms = statistics.median(step_s[1:]) * 1e3
    tokens = rows * cfg.max_seq
    report = {
        "model": "neox-1.3b", "dtype": "bfloat16", "card": card,
        "layers": cfg.n_layer, "d_model": cfg.d_model, "seq": cfg.max_seq,
        "remat_policy": cfg.remat_policy, "micro_batch": micro,
        "grad_accum": gas, "warmup_num_steps": WARMUP_STEPS,
        "steps": TRAIN_STEPS, "losses": losses,
        "grad_norms": norms, "lrs": lrs, "skipped_steps":
            engine.skipped_steps, "step_s": step_s,
        "step_ms_median_2_6": step_ms,
        "tokens_per_s": tokens / (step_ms / 1e3),
        "peak_mem_gib": peak / 2**30, "launches": launches,
        "launches_per_step": per_step, "parity": parity,
    }
    print("training: " + json.dumps(report), flush=True)
    if per_step != expected:
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{expected} (launches {launches} over "
                             f"{TRAIN_STEPS} steps)")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    if engine.skipped_steps or not all(math.isfinite(n) and n > 0
                                       for n in norms):
        raise AssertionError(f"skipped {engine.skipped_steps} steps; grad "
                             f"norms {norms}")
    with kernel_config.override(**config["kernels"]):
        print("training profile: " + json.dumps(profile_training(
            engine, batch)), flush=True)
    del engine, sched
    gc.collect()
    torch.cuda.empty_cache()
    return launches, per_step


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deeperspeed_tpu_torch.ops import flash_attention as fa
    from deeperspeed_tpu_torch.ops import fused_blocks as fb
    from deeperspeed_tpu_torch.ops import op_builder

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)
    t0 = time.perf_counter()
    sources = ("fused_blocks", "flash_attention")
    op_builder.build_all(sources)
    fb._lib()
    fa._lib()
    print(f"build: {', '.join(s_ + '.cu' for s_ in sources)} in "
          f"{time.perf_counter() - t0:.2f} s, side by side", flush=True)
    for name in sources:
        info = op_builder.build_info[name]
        print(f"build: {name}.cu nvcc {info['seconds']:.2f} s -> "
              f"{info['path']}", flush=True)
        for line in info["ptxas"].splitlines():
            if any(w in line for w in ("registers", "Compiling entry",
                                       "spill")):
                print(f"  ptxas: {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = kernel_phase(fb, gen)
    cases.update(backward_phase(fb, gen))
    cases.update(flash_phase(fa, gen))
    for name, rows in cases.items():
        for r in rows:
            if "ms" in r:
                print(f"kernel {name}: " + json.dumps(r), flush=True)
        worst = max(rows, key=lambda r: r["max_abs_err"] / r["tol"])
        print(f"kernel {name}: {len(rows)} cases within tolerance; "
              f"closest to its limit: " + json.dumps(worst), flush=True)
        worst_rel = max(rows, key=lambda r: r["rel_l2_err"] / r["rel_l2_tol"])
        print(f"kernel {name}: closest to its relative L2 limit: "
              + json.dumps(worst_rel), flush=True)

    serving = serving_phase(fb, card)
    gc.collect()
    torch.cuda.empty_cache()
    training, per_step = training_phase(card)

    kernels = []
    for name, rows in cases.items():
        head = next(r for r in rows if "ms" in r and r["dtype"] == "bfloat16"
                    and (r["shape"][0] == PATH_ROWS
                         or tuple(r["shape"]) == FLASH_SHAPES[0]))
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": training[name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "dtype": head["dtype"],
            "launches_per_step": per_step[name],
        }
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        if name in serving:
            entry["launches_serving"] = serving[name]
        kernels.append(entry)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
