#!/usr/bin/env python3
"""Drive the PyTorch port (deeperspeed_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. Card: print the card's name and power limit (nvidia-smi) and build the
   CUDA kernels from deeperspeed_tpu_torch/csrc into build/kernels/.
2. Kernels against their plain PyTorch versions at the serving path's
   widths, bf16 and fp32: LayerNorm at (R, 2048), bias+GeLU (tanh and
   erf) at (R, 8192), for R in CHECK_ROWS (every row count the serving
   run gives them, and ragged ones). Each case must agree within
   atol = rtol = 2e-5 (fp32) or 2e-2 (bf16), the reference's own
   tolerances for these kernels. At R = 8 and 512 each is timed with CUDA
   events beside its plain version, its bound, and one PyTorch call
   computing the same function where there is one (F.layer_norm; there is
   no single call for bias+GeLU).
3. Serving at full width: GPT-NeoX-1.3B (24 layers, d_model 2048, bf16,
   random weights from a fixed seed) behind ServingEngine with the
   "kernels" block at mode "auto", 8 greedy requests with staggered
   arrivals and prompts of 16-900 tokens, 32 new tokens each. The launch
   counters of both kernels are set to 0 just before the run and read just
   after it; every kernel must have launched, 24 bias+GeLU launches and 1
   LayerNorm launch per forward. Every request must finish by length with
   32 tokens. The first-token logits of two requests are recomputed with
   the kernels off and must agree with the kernel path within 0.05 of the
   largest |logit| (bf16 rounds at other places in the two paths).

The line before the last is the kernels JSON object; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script exits
non-zero before printing any result.
"""

import json
import math
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
SOURCE = "deeperspeed_tpu_torch/csrc/fused_blocks.cu"
REPLACES = {
    "ln_fwd": "deeperspeed_tpu/ops/pallas/fused_blocks.py:72",
    "bias_gelu_fwd": "deeperspeed_tpu/ops/pallas/fused_blocks.py:280",
}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LOGIT_TOL = 0.05
SEED = 0
L2_BYTES = 50 * 2**20
# rows the serving run gives the kernels: 8 decode slots and every prefill
# bucket (16 ... 1024), plus ragged counts (6 slots, 48 rows)
CHECK_ROWS = (6, 8, 16, 48, 64, 128, 256, 512, 1024)
TIMED_ROWS = (8, 512)


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


def check_close(name, got, want, tol):
    err = (got.float() - want.float()).abs()
    bad = err > tol + tol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol=rtol={tol}; "
            f"max abs err {float(err.max()):.3e}")
    return float(err.max())


def timings(kernel, plain, bufs, library=None, lib_bufs=None):
    ms, eager_ms = time_ms(kernel, bufs)
    plain_ms, plain_eager_ms = time_ms(plain, bufs)
    out = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "eager_ms": eager_ms, "plain_eager_ms": plain_eager_ms}
    if library is not None:
        out["library_ms"], out["library_eager_ms"] = time_ms(library,
                                                             lib_bufs)
    return out


def kernel_phase(fb, gen):
    """Hold each kernel against its plain version at every row count in
    CHECK_ROWS; time the kernel, its plain version and the yardstick at
    TIMED_ROWS."""
    dev = torch.device("cuda")
    results = {"ln_fwd": [], "bias_gelu_fwd": []}

    def randn(shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                + shift).to(dtype)

    def bound(nbytes, ops):
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_OPS_PER_S * 1e3
        return {"bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}

    for R in CHECK_ROWS:
        for dtype in (torch.bfloat16, torch.float32):
            tol = TOL[dtype]
            isz = torch.tensor([], dtype=dtype).element_size()
            dname = str(dtype).split(".")[-1]
            D = 2048
            x = randn((R, D), dtype)
            w = randn((D,), torch.float32, 0.1, 1.0)
            b = randn((D,), torch.float32, 0.1)
            y, mu, rs = fb.ln_fwd(x, w, b, 1e-5)
            torch.cuda.synchronize()
            py, pmu, prs = fb.ln_fwd_plain(x, w, b, 1e-5)
            err = check_close(f"ln_fwd {R}x{D} {dname}", y, py, tol)
            check_close(f"ln_fwd mean {R}x{D} {dname}", mu, pmu, 2e-5)
            check_close(f"ln_fwd rstd {R}x{D} {dname}", rs, prs, 2e-5)
            row = {"shape": [R, D], "dtype": dname, "max_abs_err": err,
                   "tol": tol}
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
                err = check_close(
                    f"bias_gelu_fwd {R}x{Fd} {dname} approx={approximate}",
                    y, py, tol)
                row = {"shape": [R, Fd], "dtype": dname,
                       "approximate": approximate, "max_abs_err": err,
                       "tol": tol}
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deeperspeed_tpu_torch.ops import fused_blocks as fb
    from deeperspeed_tpu_torch.ops import op_builder

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)
    t0 = time.perf_counter()
    fb._lib()
    info = op_builder.build_info["fused_blocks"]
    print(f"build: fused_blocks.cu in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {info['seconds']:.2f} s) -> {info['path']}", flush=True)
    for line in info["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = kernel_phase(fb, gen)
    for name, rows in cases.items():
        for r in rows:
            if "ms" in r:
                print(f"kernel {name}: " + json.dumps(r), flush=True)
        worst = max(rows, key=lambda r: r["max_abs_err"] / r["tol"])
        print(f"kernel {name}: {len(rows)} cases within tolerance; "
              f"closest to its limit: " + json.dumps(worst), flush=True)

    launches = serving_phase(fb, card)

    kernels = []
    for name, rows in cases.items():
        head = next(r for r in rows
                    if r["shape"][0] == 512 and r["dtype"] == "bfloat16"
                    and "ms" in r)
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "dtype": head["dtype"],
        })
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
