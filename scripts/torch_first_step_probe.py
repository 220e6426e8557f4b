#!/usr/bin/env python3
"""What lifts the loss on the first Adam step of the port's 1.3B training run.

    python3 scripts/torch_first_step_probe.py            # every variant
    python3 scripts/torch_first_step_probe.py base plain # some of them

Needs one CUDA card; run from the root of the checkout. chip_smoke.py's
training phase (GPT-NeoX-1.3B, masterless bf16, Adam 2e-4, clipping 1.0,
16 x 1025 tokens) runs a 100-step warmup. With a 2-step warmup the
scheduler gives lr 0 twice, and the first step with a non-zero lr lifts
the loss. This script trains 5 steps of that run with warmup 2 in
variants that each change one thing:

  base     chip_smoke.py's run ("kernels" auto, flash attention, remat
           "matmuls", biases and layer-norm params randomized)
  plain    kernels off and dense attention (no port kernel runs)
  norand   biases and layer-norm params left at their init (0 and 1)
  master   fp32 master weights (bf16.master_weights true)
  tiny_lr  lr 1e-7

and prints one JSON line per variant: losses, grad norms and lrs per step,
and, for the first step with a non-zero lr, each param leaf's largest
absolute change, its relative change |dp| / |p| and the share of its
elements that changed.
"""

import gc
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

WARMUP_STEPS = 2
STEPS = 5
VARIANTS = {
    "base": {},
    "plain": {"kernels": False},
    "norand": {"randomize": False},
    "master": {"master": True},
    "tiny_lr": {"lr": 1e-7},
}


def leaf_names(tree, prefix=""):
    names = []
    for k, v in tree.items():
        if isinstance(v, dict):
            names += leaf_names(v, f"{prefix}{k}/")
        else:
            names.append(prefix + k)
    return names


def run(name, batch, kernels=True, randomize=True, master=False, lr=2e-4):
    import chip_smoke as cs
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models.gpt import (get_preset, init_params,
                                                  make_gpt)
    from deeperspeed_tpu_torch.ops import kernel_config
    from deeperspeed_tpu_torch.ops.adam import tree_leaves

    cfg = get_preset("neox-1.3b", max_seq=1024, remat_policy="matmuls",
                     ce_chunk=0, dtype=torch.bfloat16,
                     attn_impl="auto" if kernels else "xla")
    config = cs.training_config()
    config["scheduler"]["params"]["warmup_num_steps"] = WARMUP_STEPS
    config["scheduler"]["params"]["warmup_max_lr"] = lr
    config["optimizer"]["params"]["lr"] = lr
    config["bf16"]["master_weights"] = master
    if not kernels:
        config["kernels"] = {"mode": "off"}
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    params = init_params(gen, cfg, device="cuda", dtype=torch.bfloat16)
    if randomize:
        cs.randomize_affine(params, gen)
    names = leaf_names(params)
    out = {"variant": name, "losses": [], "grad_norms": [], "lrs": []}
    with kernel_config.override():
        engine, *_ = ds.initialize(model=make_gpt(cfg)[2],
                                   model_parameters=params, config=config)
        del params
        for _ in range(STEPS):
            lr_now = engine.get_lr()[0]
            first = lr_now > 0 and "first_update" not in out
            if first:
                before = [p.detach().clone()
                          for p in tree_leaves(engine.params)]
            out["lrs"].append(lr_now)
            out["losses"].append(float(engine.train_batch(batch)))
            out["grad_norms"].append(engine.get_global_grad_norm())
            if first:
                rows = []
                for n, a, b in zip(names, before,
                                   tree_leaves(engine.params)):
                    d = b.detach().float() - a.float()
                    norm = float(a.float().norm())
                    rows.append({
                        "leaf": n, "max_abs": float(d.abs().max()),
                        # None for a leaf that starts at 0 (the biases
                        # of variant norand)
                        "rel": float(d.norm()) / norm if norm else None,
                        "changed": float((d != 0).float().mean())})
                out["first_update"] = sorted(
                    rows, key=lambda r: -(r["rel"] or 0.0))
                del before
    print(json.dumps(out), flush=True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_first_step_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deeperspeed_tpu_torch.ops import op_builder

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    op_builder.build_all(("fused_blocks", "flash_attention"))
    corpus = np.load(ROOT / "data" / "corpus_tokens.npy", mmap_mode="r")
    batch = np.asarray(corpus[:16 * 1025], dtype=np.int64).reshape(16, 1025)
    for name in argv or VARIANTS:
        run(name, batch, **VARIANTS[name])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
