#!/usr/bin/env python3
"""The first Adam step's loss, through the JAX reference's engine and the
port's, from the same weights and tokens.

    python3 scripts/first_step_crosscheck.py               # both, compared
    python3 scripts/first_step_crosscheck.py --engine jax  # one engine

Runs on the CPU; run from the root of the checkout. chip_smoke.py's
training run (GPT-NeoX-1.3B, masterless bf16, Adam 2e-4, clipping 1.0)
lifts its loss on the first step with a non-zero lr. This script trains
that configuration, cut to fit a CPU, through each package's
``initialize`` -> ``train_batch`` with a 2-step warmup, each engine in a
process of its own (neither package imports the other), and compares the
per-step losses. Each engine prints one JSON line: losses, grad norms and
lrs per step, the seconds it took and its peak resident memory; the
comparison prints one more (the relative loss difference per step and
each engine's lift: the loss the step after the first update, less the
first loss) and exits 1 when a step's losses differ by more than
LOSS_RTOL.

Kept from the 1.3B run: the width (d_model 2048, 16 heads, d_ff 8192,
vocab 50304) and the init scales of the 24-layer model (N(0, 0.02),
output projections N(0, 0.02 / sqrt(48))), biases and layer-norm params
randomized as chip_smoke.py does, max_seq 1024, remat "matmuls",
ce_chunk 0, masterless bf16, Adam 2e-4 with betas (0.9, 0.95), clipping
1.0, WarmupDecayLR. Cut: depth 24 -> LAYERS, batch 16 x 1025 -> 2 x 1025
tokens of data/corpus_tokens.npy (micro-batch 1 x 2 accumulation steps),
warmup 1000 -> 2. Both sides take their plain paths (no "kernels" block,
dense attention): the CPU runs no kernel.
"""

import argparse
import json
import math
import os
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
LAYERS = 2
STEPS = 6
ROWS, SEQ = 2, 1024
D, HEADS, FFN, VOCAB, FULL_DEPTH = 2048, 16, 8192, 50304, 24
CONFIG = {
    "train_batch_size": ROWS,
    "train_micro_batch_size_per_gpu": 1,
    "gradient_accumulation_steps": ROWS,
    "bf16": {"enabled": True, "master_weights": False},
    "zero_optimization": {"stage": 0},
    "optimizer": {"type": "Adam",
                  "params": {"lr": 2e-4, "betas": [0.9, 0.95]}},
    "scheduler": {"type": "WarmupDecayLR",
                  "params": {"warmup_max_lr": 2e-4, "warmup_num_steps": 2,
                             "total_num_steps": 100000}},
    "gradient_clipping": 1.0,
    "steps_per_print": 10,
}
# both engines store bf16 params and moments and round the forward at
# different places (XLA fuses): the losses agree to a few bf16 ulps of the
# loss, the masterless bf16 limit of tests/test_torch_engine.py
LOSS_RTOL = 4e-3


def param_arrays():
    """The reference's params tree (numpy fp32) from SEED."""
    rng = np.random.default_rng(SEED)
    std, out_std = 0.02, 0.02 / math.sqrt(2 * FULL_DEPTH)
    L, qkv = LAYERS, 3 * D

    def normal(shape, s):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(s)

    def scale(shape):
        return 1 + normal(shape, 0.1)

    def bias(shape):
        return normal(shape, 0.1)

    return {
        "embed": {"wte": normal((VOCAB, D), std)},
        "layers": {
            "ln1_scale": scale((L, D)), "ln1_bias": bias((L, D)),
            "ln2_scale": scale((L, D)), "ln2_bias": bias((L, D)),
            "attn": {"wqkv": normal((L, D, qkv), std), "bqkv": bias((L, qkv)),
                     "wo": normal((L, D, D), out_std), "bo": bias((L, D))},
            "mlp": {"wi": normal((L, D, FFN), std), "bi": bias((L, FFN)),
                    "wo": normal((L, FFN, D), out_std), "bo": bias((L, D))},
        },
        "final_ln": {"scale": scale((D,)), "bias": bias((D,))},
        "lm_head": normal((D, VOCAB), std),
    }


def tokens():
    corpus = np.load(ROOT / "data" / "corpus_tokens.npy", mmap_mode="r")
    return np.asarray(corpus[:ROWS * (SEQ + 1)],
                      dtype=np.int32).reshape(ROWS, SEQ + 1)


def model_kwargs():
    return dict(n_layer=LAYERS, n_head=HEADS, d_model=D, vocab_size=VOCAB,
                max_seq=SEQ, remat_policy="matmuls", ce_chunk=0,
                attn_impl="xla")


def train(engine, batch):
    out = {"losses": [], "grad_norms": [], "lrs": []}
    for _ in range(STEPS):
        out["lrs"].append(float(engine.get_lr()[0]))
        out["losses"].append(float(engine.train_batch(batch)))
        out["grad_norms"].append(float(engine.get_global_grad_norm()))
    return out


def run_jax():
    import jax
    import jax.numpy as jnp

    import deeperspeed_tpu
    from deeperspeed_tpu.models import gpt
    from deeperspeed_tpu.parallel.topology import single_device_mesh

    cfg = gpt.get_preset("neox-1.3b", dtype=jnp.bfloat16,
                         **model_kwargs())
    params = jax.tree.map(jnp.asarray, param_arrays())
    mesh = single_device_mesh()
    engine, _, _, _ = deeperspeed_tpu.initialize(
        model=gpt.make_gpt(cfg)[2], model_parameters=params, config=CONFIG,
        mesh=mesh)
    del params
    return train(engine, tokens())


def run_torch():
    import torch

    import deeperspeed_tpu_torch
    from deeperspeed_tpu_torch.models import gpt
    from deeperspeed_tpu_torch.ops.adam import tree_map

    cfg = gpt.get_preset("neox-1.3b", dtype=torch.bfloat16,
                         **model_kwargs())
    params = tree_map(torch.from_numpy, param_arrays())
    engine, _, _, _ = deeperspeed_tpu_torch.initialize(
        model=gpt.make_gpt(cfg)[2], model_parameters=params, config=CONFIG,
        device="cpu")
    del params
    return train(engine, tokens())


def child(engine):
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    out = (run_jax if engine == "jax" else run_torch)()
    out.update(engine=engine, layers=LAYERS,
               seconds=time.perf_counter() - t0,
               peak_rss_gib=resource.getrusage(
                   resource.RUSAGE_SELF).ru_maxrss / 2**20)
    print(json.dumps(out), flush=True)
    return 0


def compare():
    runs = {}
    for engine in ("jax", "torch"):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.run(
            [sys.executable, __file__, "--engine", engine],
            env=env, cwd=ROOT, capture_output=True, text=True, check=False)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"{engine} engine failed ({proc.returncode})")
        runs[engine] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(runs[engine]), flush=True)
    jl, tl = runs["jax"]["losses"], runs["torch"]["losses"]
    rel = [abs(t - j) / abs(j) for j, t in zip(jl, tl)]
    first = next(i for i, lr in enumerate(runs["jax"]["lrs"]) if lr > 0)
    verdict = {
        "loss_rel_diff": rel, "max_loss_rel_diff": max(rel),
        "loss_rtol": LOSS_RTOL,
        "first_update_step": first + 1,
        "lift_jax": jl[first + 1] - jl[0],
        "lift_torch": tl[first + 1] - tl[0],
    }
    print(json.dumps(verdict), flush=True)
    return 0 if max(rel) <= LOSS_RTOL else 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--engine", choices=("jax", "torch"),
                        help="run one engine and print its JSON line")
    args = parser.parse_args()
    if args.engine:
        return child(args.engine)
    return compare()


if __name__ == "__main__":
    sys.exit(main())
