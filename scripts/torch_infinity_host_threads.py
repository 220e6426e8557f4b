#!/usr/bin/env python3
"""What the host threads give the streamed ZeRO-Infinity step on the card.

    python3 scripts/torch_infinity_host_threads.py [layers [rounds]]

Needs one CUDA card; run from the root of the checkout. One engine of
chip_smoke.py's phase 15b (configs/neox_20b_infinity.json as written plus
"kernels": {"mode": "auto"}, GPT-NeoX-20B width cut to ``layers`` layers,
default 4, nvme_path in a temporary directory) takes one warm-up step on
one fixed corpus batch, then steps in the order N 1 1 N, ``rounds`` times
(default 1): N is torch's thread count, the engine's default
``host_threads``, and 1 is one thread. ``host_threads`` is how many
threads the native v2 pass spreads a chunk's pieces of whole wire blocks
over; nothing else of the step changes with it.

Each step is timed on the host clock, ending in a synchronize. Prints the
card and the host's CPU count, then one JSON line: every step's seconds
and four timings (compute_s, d2h_s, h2d_s, host_opt_s) by mode, and the
median of each.
"""

import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

TIMINGS = ("compute_s", "d2h_s", "h2d_s", "host_opt_s")


def main(layers: int, rounds: int) -> int:
    if not torch.cuda.is_available():
        print("torch_infinity_host_threads: no CUDA device", file=sys.stderr)
        return 2
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models.gpt import get_preset
    from deeperspeed_tpu_torch.ops import kernel_config, op_builder

    print(f"card: {chip_smoke.card_line()}", flush=True)
    print(f"host: {os.cpu_count()} CPUs, torch threads "
          f"{torch.get_num_threads()}", flush=True)
    op_builder.build_all(("fused_blocks", "flash_attention"))
    cfg = get_preset("neox-20b", n_layer=layers,
                     max_seq=chip_smoke.INFINITY_SEQ, dtype=torch.bfloat16)
    nvme = Path(tempfile.mkdtemp(prefix="infinity_threads_"))
    config = chip_smoke.infinity_config(nvme)
    batch = chip_smoke.infinity_batch(chip_smoke.SEED + 1)
    with kernel_config.override():
        engine, _, _, _ = ds.initialize(model=cfg, config=config)
        many = engine.host_threads
        modes = {many: "threads", 1: "one_thread"}
        runs = {name: [] for name in modes.values()}
        order = [None] + [many, 1, 1, many] * rounds
        for threads in order:
            engine.host_threads = many if threads is None else threads
            before = dict(engine.timings)
            t0 = time.perf_counter()
            loss = engine.train_batch(batch)
            torch.cuda.synchronize()
            rec = {"step_s": time.perf_counter() - t0, "loss": loss,
                   **{k: engine.timings[k] - before.get(k, 0.0)
                      for k in TIMINGS}}
            print(f"step host_threads={engine.host_threads}: "
                  f"{json.dumps(rec)}", flush=True)
            if threads is not None:
                runs[modes[threads]].append(rec)
    out = {"model": "neox-20b", "layers": layers, "params": engine.n_params,
           "host_threads": many, "steps": runs,
           "median": {name: {k: statistics.median(r[k] for r in recs)
                             for k in ("step_s",) + TIMINGS}
                      for name, recs in runs.items()}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    sys.exit(main(*(args + [4, 1][len(args):])))
