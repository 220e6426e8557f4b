#!/usr/bin/env python3
"""What the monitor costs a GPT-NeoX-1.3B training step on the card.

    python3 scripts/torch_monitor_overhead.py [steps_per_block [rounds]]

Needs one CUDA card; run from the root of the checkout. One engine of
chip_smoke.py's phase 6 (GPT-NeoX-1.3B, masterless bf16, micro-batch 2 x
8, "kernels" auto) is built under configs/gpt_125m_obs.json's "monitor"
block (cut as phase 6 cuts it), takes one step (the cost index's
capture), then runs blocks of ``steps_per_block`` steps (default 4) in
three modes, in the order A B C C B A, ``rounds`` times (default 2):

  full     the monitor as phase 6 runs it: spans into the ring and the
           flight file, memwatch, the watchdog, the cost index's MFU
  no_perf  the same without the cost index (no MFU, no stop event)
  off      no monitor: the engine's hooks see None and no tracer is
           installed, as for an engine built without a "monitor" block

Each step is timed on the host clock, ending in a synchronize. Prints the
card, then one JSON line: every step's seconds by mode and the median of
each mode.
"""

import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main(steps_per_block: int, rounds: int) -> int:
    if not torch.cuda.is_available():
        print("torch_monitor_overhead: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch import monitor as tmon
    from deeperspeed_tpu_torch.models.gpt import (get_preset, init_params,
                                                  make_gpt)
    from deeperspeed_tpu_torch.ops import kernel_config, op_builder

    print(f"card: {chip_smoke.card_line()}", flush=True)
    op_builder.build_all(("fused_blocks", "flash_attention", "fused_adam"))
    cfg = get_preset("neox-1.3b", max_seq=1024, remat_policy="matmuls",
                     ce_chunk=0, dtype=torch.bfloat16)
    config = chip_smoke.training_config()
    obs = Path(tempfile.mkdtemp(prefix="monitor_overhead_"))
    config["monitor"] = chip_smoke.obs_monitor(obs)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    params = init_params(gen, cfg, device="cuda", dtype=torch.bfloat16)
    chip_smoke.randomize_affine(params, gen)
    corpus = np.load(ROOT / "data" / "corpus_tokens.npy", mmap_mode="r")
    rows = config["train_batch_size"]
    batch = np.asarray(corpus[: rows * (cfg.max_seq + 1)],
                       dtype=np.int64).reshape(rows, cfg.max_seq + 1)
    with kernel_config.override():
        engine, _, _, _ = ds.initialize(
            model=make_gpt(cfg)[2], model_parameters=params, config=config)
        del params
        mon = engine.monitor
        cost_index = mon.cost_index

        def set_mode(mode):
            engine.monitor = None if mode == "off" else mon
            tmon.set_tracer(None if mode == "off" else mon.tracer)
            mon.cost_index = cost_index if mode == "full" else None

        engine.train_batch(batch)  # the capture step
        seconds = {"full": [], "no_perf": [], "off": []}
        for mode in ("full", "no_perf", "off", "off", "no_perf",
                     "full") * rounds:
            set_mode(mode)
            for _ in range(steps_per_block):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.train_batch(batch)
                torch.cuda.synchronize()
                seconds[mode].append(time.perf_counter() - t0)
        set_mode("full")
    tmon.shutdown_monitor(save=False)
    print(json.dumps({
        "model": "neox-1.3b", "steps_per_block": steps_per_block,
        "rounds": rounds,
        "step_s": seconds,
        "median_ms": {m: statistics.median(s) * 1e3
                      for m, s in seconds.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:3]]
    sys.exit(main(*(args + [4, 2][len(args):])))
