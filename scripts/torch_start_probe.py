#!/usr/bin/env python3
"""Where a process start goes on the card: a serving replica's start and a
pipeline rank's first steps, each split into timed parts.

    python3 scripts/torch_start_probe.py [OUT.json]

A replica (``--child replica``) is a fresh interpreter that does what
``deeperspeed_tpu_torch.serving.replica_worker`` does before it reports
ready, at chip_smoke.py phase 17's model (GPT-NeoX-125M, bf16, kernels
auto, weights from a checkpoint this script writes first): the
interpreter's start, ``import torch``, the package's imports, ``import
torch._dynamo`` (which a training step's first non-reentrant
``torch.utils.checkpoint`` call imports; a replica never does), the CUDA
context, the kernel libraries, the weights drawn on the card, the
checkpoint load, the engine, the first matmul (the cuBLAS handle) and the
warmup requests (the first kernels). It runs twice: with a fresh bytecode
cache, then with the one the first run wrote (chip_smoke.py shares one
with every process it starts).

A pipeline rank is one of two processes of chip_smoke.py phase 23a's
``{pipe: 2}`` BERT-large engine, started as the script starts its ranks
(``chip_smoke.start_ranks``: from a fork server that imported torch,
torch._dynamo and the package's training modules once; the server's
own start counts here): the start to the rank's first line, the CUDA context, the gloo
rendezvous, the engine (its stage's weights drawn on the card), the
first matmul, an ``eval_batch`` (every stage's first forward), then the
first two ``train_batch`` calls (the first backward). Each rank prints
its parts.

Prints one JSON object a run and writes them all to OUT.json (default
build/start_probe.json). Needs one CUDA card; builds the kernels
it loads first (as chip_smoke.py does, before any child starts).
"""

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def mark(parts, name, t):
    now = time.perf_counter()
    parts[name] = now - t[0]
    t[0] = now


def replica_child(spec_path):
    """The replica's start, part by part; prints the parts as JSON."""
    t0_spawn = float(os.environ["PROBE_T0"])
    parts = {"interpreter": time.time() - t0_spawn}
    t = [time.perf_counter()]
    import torch
    mark(parts, "import torch", t)
    from deeperspeed_tpu_torch.serving import replica_worker as rw
    from deeperspeed_tpu_torch.models.gpt import GPTConfig, init_params
    from deeperspeed_tpu_torch.ops import flash_attention as fa
    from deeperspeed_tpu_torch.ops import fused_blocks as fb
    from deeperspeed_tpu_torch.ops import kernel_config
    from deeperspeed_tpu_torch.serving.config import ServingConfig
    from deeperspeed_tpu_torch.serving.engine import ServingEngine
    mark(parts, "import the package", t)
    import torch._dynamo  # noqa: F401 - what a training step's first
    # non-reentrant torch.utils.checkpoint call imports (a replica's
    # serving path never does): timed as its own part
    mark(parts, "import torch._dynamo (a training step's first checkpoint)",
         t)
    torch.cuda.init()
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    mark(parts, "CUDA context", t)
    fb._lib()
    fa._lib()
    mark(parts, "kernel libraries", t)
    spec = json.loads(Path(spec_path).read_text())
    kw = dict(spec["gpt"], dtype=torch.bfloat16)
    cfg = GPTConfig(**kw)
    kernel_config.configure(**kernel_config.validate(spec["kernels"]))
    gen = torch.Generator(device="cuda").manual_seed(spec["init_seed"])
    params = init_params(gen, cfg, device="cuda", dtype=cfg.dtype)
    torch.cuda.synchronize()
    mark(parts, "weights drawn on the card", t)
    params = rw._load_weights(params, spec["weights"])
    torch.cuda.synchronize()
    mark(parts, "checkpoint load", t)
    eng = ServingEngine(cfg, params, ServingConfig.from_dict(
        spec["serving"]), device="cuda")
    torch.cuda.synchronize()
    mark(parts, "engine", t)
    a = torch.ones(64, 64, device="cuda", dtype=torch.bfloat16)
    (a @ a).sum().item()
    mark(parts, "first matmul (cuBLAS handle)", t)
    eng.submit([1, 2, 3], max_new_tokens=2, request_id="_warm")
    eng.submit([4, 5, 6], max_new_tokens=2, temperature=0.5,
               request_id="_warm2")
    eng.run()
    torch.cuda.synchronize()
    mark(parts, "warmup requests (first kernels)", t)
    parts["total"] = time.time() - t0_spawn
    print(json.dumps(parts), flush=True)


def rank_main(rank, tmp, t0_spawn, out_dir):
    """One rank of the {pipe: 2} engine, part by part."""
    parts = {"start to the rank's first line": time.time() - t0_spawn}
    t = [time.perf_counter()]
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from deeperspeed_tpu_torch.parallel import build_mesh

    torch.cuda.set_device(0)
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    mark(parts, "CUDA context", t)
    store = dist.FileStore(str(Path(tmp) / "store"), 2)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    probe = torch.ones(1)
    dist.all_reduce(probe)
    mark(parts, "gloo rendezvous", t)
    try:
        engine = cs.pipe_engine(2, build_mesh(cs.PIPE_DIMS))
        torch.cuda.synchronize()
        mark(parts, "engine (its stage's weights on the card)", t)
        a = torch.ones(64, 64, device="cuda", dtype=torch.bfloat16)
        (a @ a).sum().item()
        mark(parts, "first matmul (cuBLAS handle)", t)
        batches = cs.pipe_batches(3)
        engine.eval_batch(iter(batches.pop()))
        torch.cuda.synchronize()
        mark(parts, "eval_batch (every stage's first forward)", t)
        for i, mbs in enumerate(batches):
            engine.train_batch(iter(mbs))
            torch.cuda.synchronize()
            mark(parts, f"train_batch {i + 1}", t)
            parts[f"train_batch {i + 1} phases"] = engine.phase_seconds()
    finally:
        dist.destroy_process_group()
    parts["total"] = time.time() - t0_spawn
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(parts, f)


def replica_runs(card):
    """Two replica starts (a fresh bytecode cache, then a warm one)."""
    import dataclasses

    import chip_smoke as cs
    from deeperspeed_tpu_torch.checkpoint.serialization import (
        model_state_filename, save_tree)

    cfg, params = cs.spec_model()
    work = Path(tempfile.mkdtemp(prefix="start_probe_"))
    tag = work / "ckpt" / "global_step1"
    tag.mkdir(parents=True)
    save_tree(str(tag / model_state_filename()), {"module": params})
    del params
    gpt_kw = {k: v for k, v in dataclasses.asdict(cfg).items()
              if k != "dtype"}
    spec = {"gpt": gpt_kw, "init_seed": cs.SEED, "device": "cuda",
            "weights": {"load_dir": str(work / "ckpt"),
                        "tag": "global_step1"},
            "kernels": {"mode": "auto"},
            "serving": {"num_slots": 4, "block_size": 16,
                        "num_blocks": 256, "max_seq_len": 1024}}
    spec_path = work / "spec.json"
    spec_path.write_text(json.dumps(spec))
    runs = []
    for cache in ("fresh", "warm"):
        env = dict(os.environ, PROBE_T0=str(time.time()))
        out = subprocess.run([sys.executable, __file__, "--child",
                              "replica", str(spec_path)], env=env,
                             capture_output=True, text=True, timeout=600)
        if out.returncode:
            raise RuntimeError(f"replica probe failed:\n{out.stderr}")
        rec = {"kind": "replica", "bytecode_cache": cache, "card": card,
               "parts_s": json.loads(out.stdout.strip().splitlines()[-1])}
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    return runs


def rank_runs(card):
    import chip_smoke as cs

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        # as chip_smoke.py starts its ranks: from a fork server that
        # imported cs.RANK_PRELOAD once (its first start included)
        cs.start_ranks(rank_main, (tmp, t0, tmp), 2, join=True)
        runs = []
        for r in range(2):
            rec = {"kind": "pipe rank", "stage": r, "card": card,
                   "parts_s": json.loads(
                       (Path(tmp) / f"rank{r}.json").read_text())}
            print(json.dumps(rec), flush=True)
            runs.append(rec)
    return runs


def main():
    import torch

    if not torch.cuda.is_available():
        print("torch_start_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deeperspeed_tpu_torch.ops import op_builder

    out = Path(sys.argv[1] if len(sys.argv) > 1
               else ROOT / "build" / "start_probe.json")
    cache = cs.share_bytecode_cache()
    try:
        card = cs.card_line()
        print(f"card: {card}", flush=True)
        op_builder.build_all(("fused_blocks", "flash_attention",
                              "supertile_attention", "fused_adam"))
        runs = replica_runs(card) + rank_runs(card)
    finally:
        if cache:
            import shutil

            shutil.rmtree(cache, ignore_errors=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        replica_child(sys.argv[3])
        sys.exit(0)
    sys.exit(main())
