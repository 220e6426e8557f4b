#!/usr/bin/env python3
"""Drive the PyTorch port (deeperspeed_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. Card: print the card's name and power limit (nvidia-smi) and build the
   CUDA kernels from deeperspeed_tpu_torch/csrc into build/kernels/, one
   nvcc per source (six), started together, printing ptxas's registers
   and spills of every kernel. For each flash kernel (forward, dK/dV, dQ,
   delta) at every head dim, bf16 and fp32, print its registers, static
   and dynamic shared memory, local memory a thread and blocks an SM;
   fail if a bf16 one uses local memory (spills), or unless cuobjdump
   -sass finds HMMA/HGMMA instructions in each of the nine bf16 forward
   and backward kernels (the tensor cores). The same for the bf16
   tensor-core kernels of the sparse pair (the forward, dQ, dK/dV and
   delta at head dims 64, 96 and 128; HMMA in all nine forward, dQ and
   dK/dV ones; the forward's dynamic shared memory and threads at the
   path's S and block must be what block_sparse.fwd_plan says), of
   the super-tile forward (at every padded head dim 16-128 and each S
   class, S 64, 128 and 248: HMMA in all 24) and of the super-tile
   backward (every padded head dim at S 128, one block a sequence, and
   S 248, four: HMMA in all 16; the dynamic shared memory and threads
   must be what flash_static.bwd_plan says). The LN backwards' first
   kernel (ln_bwd and add_ln_bwd, bf16 and fp32, at the model widths
   768, 1024, 2048 and 6144) and their reduction get the same record and
   must not spill; so do the LN forwards' kernel (ln_fwd and add_ln_fwd
   at those widths, bf16 and fp32, for 8 and 2048 rows), whose dynamic
   shared memory and threads must be what fused_blocks.ln_fwd_plan says.
   So do the bias+GeLU pair's (bias_gelu_fwd for 8 and 2048 rows and
   bias_gelu_bwd's first kernel for 2048, at BG_WIDTHS 1024-24576, bf16
   and fp32, b in x's dtype and in fp32, tanh and erf) and the backward's
   reduction; a profile of the wrappers' own calls at those widths and
   rows must show each launch with the grid, block and shared memory that
   bias_gelu_fwd_plan and bias_gelu_bwd_plan give; and the row loop
   of each of the 12 vector kernels is read from cuobjdump -sass: its
   instructions and MUFU instructions a 16-byte vector, and the issue and
   MUFU times they imply at (2048, 8192) and (8192, 4096) beside the byte
   bound, are printed.
2. Forward fused blocks against their plain PyTorch versions, bf16 and
   fp32: LayerNorm at (R, 2048), bias+GeLU (tanh and erf) at (R, 8192),
   for R in CHECK_ROWS (every row count the serving and training runs
   give them, and ragged ones), within atol = rtol = 2e-5 (fp32) or 2e-2
   (bf16), the reference's own tolerances for these kernels, with the
   LN statistics (mean, rstd) within 2e-5; then ln_fwd and add_ln_fwd at
   LN_FWD_CASES (GPT-NeoX-20B's (48, 6144), the other model widths at
   ragged rows, the widest row the rows route takes, and the wide
   route's widths 1001 and 8200) and on rows off a 16-byte boundary. At
   the path shapes (2048, 2048) and (2048, 8192) tanh bf16 two launches of
   ln_fwd, and of bias_gelu_fwd, on the same inputs must give the same
   bits.
3. Backward fused blocks against their plain versions: ln_bwd at
   (R, 2048) and bias_gelu_bwd (tanh and erf) at (R, 8192), R in
   BWD_ROWS, and ln_bwd at GPT-NeoX-20B's width, LN_WIDE_CASE (48,
   6144), within 10x the forward tolerances (the reference's gradient
   tolerances, tests/test_fused_kernels.py). At the path shape (2048,
   2048) bf16 two launches of ln_bwd on the same inputs must give the
   same bits, and of bias_gelu_bwd at (2048, 8192) tanh (dx and db), whose
   launches are also timed one by one from a profile. Then both bias+GeLU
   kernels at BG_CASES: the data-parallel GPT-NeoX-125M FFN (16384, 3072),
   timed, GPT-NeoX-20B's (48, 24576), widths whose last column strip is
   partial on the vector route (1000, and 8188 in fp32), the scalar
   route's width 1001 and rows off a 16-byte boundary; bf16 and fp32, b
   in x's dtype and in fp32, tanh and erf, on inputs of scale 2 and
   uniform in [-60, 60], where the sigmoid and erf saturate (finite
   outputs, the plain version's values).
4. Flash attention forward and backward against their plain versions at
   FLASH_SHAPES: the training shape (2, 16, 1024, 128), S = 2048 and 4096
   (beyond the reference's whole-S kernel), ragged S = 640 and 1000, head
   dims 64 and 96, and phase 14's (16, 12, 1024, 64); then
   FLASH_EDGE_SHAPES, S in {1, 17, 63, 65, 127, 129} (the kernels' tile
   edges) at head dims 64, 96 and 128; causal and not, bf16 and fp32;
   within the reference's flash tolerances (fp32 2e-3 forward, 5e-3
   gradients; bf16 2e-2 and 5e-2). At the two FLASH_TIMED shapes (causal,
   bf16) two launches of each kernel on the same inputs must give the
   same bits, and both are timed.
   Beside those element-wise tolerances, every output of phases 2-4 must
   hold ||got - want|| <= REL_L2 * ||want|| (1e-4 fp32, 1e-2 bf16: a few
   bf16 ulps on the whole tensor), which the element-wise bounds alone
   would not catch at the training shapes, where they are about as large
   as the values (a bf16 kernel that dropped a term could pass them). At
   S = 1, where dQ and dK are zero in exact arithmetic, their L2 error is
   taken relative to ||dV||.
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
   kernel path within 0.05 of the largest |logit|. The engine runs under
   a "monitor" block (SERVING_MONITOR: a strict watchdog, the metrics
   endpoint on an ephemeral port, the cost index) and the serving
   config's "slo" block (SERVING_SLO): its trace must hold the
   reference's serving/* spans and instants (SERVING_EVENTS) and pass
   strict validation, the endpoint must serve the serving and SLO
   metrics (SERVING_METRICS), the port's reqledger must build a ledger
   of every request from the trace, every cost record must be free of
   errors and the decode step's signature must never change. Then a
   second, small engine under a monitor with near_oom_fraction 0.02 and
   a 4 GiB live buffer trips the near-OOM post-mortem at its first
   sample: its top-K live tensors go through the flight recorder, and
   ``recover`` must read them back from flight.bin, the 4 GiB buffer
   first.
6. Training at full width: GPT-NeoX-1.3B cut to TRAIN_LAYERS of its 24
   layers (max_seq 1024, remat "matmuls",
   ce_chunk 0, bf16, random weights from a fixed seed) through
   deeperspeed_tpu_torch.initialize -> Engine.train_batch with the keys
   of configs/neox_1.3b_single_chip.json (masterless bf16, Adam 2e-4
   with betas (0.9, 0.95), clipping 1.0, micro-batch 2 x 8 accumulation
   steps) plus "kernels": {"mode": "auto"} (every Adam step one fused_adam
   launch over the 16 bf16 leaves) and a 100-step warmup (WARMUP_STEPS),
   on one 16 x 1025 batch of data/corpus_tokens.npy, for 6 steps; after
   step 3, outside the step timings, Engine.save_checkpoint writes
   build/smoke_ckpt. The engine runs under configs/gpt_125m_obs.json's
   "monitor" block (perf, memwatch, the flight recorder, a warning
   watchdog) cut as PERF.md section 4 lists: obs_dir in a temporary
   directory, metrics_port 0, tb_export_interval 3. First, on one
   micro-batch, the kernel path's loss and grads are held against the
   plain path's (kernels off, attn_impl "xla"): losses within 0.5 %, grad
   norms within 5 %, cosine of the grads >= 0.99 (bf16 limits: the two
   paths round at different places), and a cost index captures both
   paths: they must count the same flops. Then the counters are zeroed,
   the 6 steps run, and the counters are read: every kernel launched, at
   the counts the remat policy implies. Losses must be finite and the
   last below the first, no step skipped, every grad norm finite and >
   0. The monitor's gates: every cost record free of errors, the
   watchdog's counts after step 6 those after step 1 (and it never
   fired), train_steps_total 6 read over HTTP from the endpoint, the
   trace holding TRAIN_EVENTS; the step's MFU, the cost index's flops and
   bytes and the analytic 6 N tokens are printed. The final params and
   moments are copied to the host (with a sha256 digest). A seventh step
   then runs under torch.profiler: wall and device time, the device's
   busy share, device time by kernel family, the top kernels, and the
   "other" family split by kernel name. Last, the monitor is shut down:
   its trace and flight files must be under obs_dir and the trace must
   pass strict validation.
7. BERT kernels against their plain versions: the residual-add LayerNorm
   pair (add_ln_fwd/add_ln_bwd) at (R, 1024) for R in ADD_LN_ROWS (the
   BERT-large path's 8192 rows and ragged counts) and at (2048, 2048);
   the super-tile attention pair at SUPERTILE_SHAPES (the BERT-large
   shape (64, 16, 128, 64), then S in {8, 16, 64, 120, 136, 200, 248},
   the forward's 16-row tile and its S classes' edges, with Dh 40, 64,
   96 and 128, Dh 40 being no multiple of 16, including fp32 at S 248 /
   Dh 128, whose K and V exceed a block's shared memory), causal and not,
   and at the BERT shape two launches of supertile_fwd, and of
   supertile_bwd, on the same inputs must give the same bits; LN and erf
   bias+GeLU, forward and backward, at the BERT widths (D 1024, F 4096
   and the MLM head's (4096, 1024)), where two launches of add_ln_fwd,
   add_ln_bwd, ln_fwd and ln_bwd at (8192, 1024) bf16 must give the same
   bits too, and those of bias_gelu_fwd and bias_gelu_bwd at (8192, 4096)
   (bias_gelu_bwd's launches also timed from a profile). bf16 and
   fp32, with the tolerances and relative L2 limits of phases 2-4; each
   new kernel, and the four block kernels at the BERT shapes, timed at
   its path shape as in phases 2-4 (bias+GeLU also at the head's (4096,
   1024)). At the
   super-tile pair's path shape the flash pair, which GPT took below
   S = 256 before the super-tile route, is held against the same plain
   versions and timed beside it.
8. BERT-large pretraining at full width and depth (24 layers, d_model
   1024, 16 heads, vocab 30528, max_seq 128, post-LN, bf16, remat "full",
   ce_chunk 64, dropout 0, random weights from a fixed seed) through
   initialize -> Engine.train_batch with the keys of
   configs/bert_large_zero2.json changed for one card (Lamb 2e-3, weight
   decay 0.01, WarmupLR, bf16 with an fp32 master, clipping 1.0,
   micro-batch 64, one accumulation step, the file's ZeRO stage 2, which
   on one rank shards nothing) plus
   "kernels": {"mode": "auto"} and a BERT_WARMUP_STEPS warmup, on one
   64 x 128 batch of data/corpus_tokens.npy with 15 % of positions
   scored (the input there replaced by the mask id 103), for 6 steps.
   The same gates as phase 6: kernel path against plain path on the
   batch, finite and falling losses, no skipped step, grad norms finite
   and > 0, and launches per step equal to what remat "full" implies.
   One more step runs under torch.profiler.
9. Fused Adam (run after phase 7, before serving) against its plain
   version: small cases (a 0-d leaf, (7,), (1000,), (3, 50304), (2,
   65541)) in each of the kernel's five dtype combinations, Adam and
   AdamW, weight decay 0 and 0.01, bias correction off, 3 steps; then the
   GPT-NeoX-1.3B leaf list (16 leaves, 1,414,647,808 parameters) as the
   masterless path builds it (bf16 p, g, m, v) and as a master path does
   (fp32 p, g, m, v with a bf16 cast output), 3 steps. fp32 outputs
   within atol = rtol = 1e-6 (the reference's own test of its kernel),
   bf16 ones within one ulp, every output within REL_L2; the elements
   that differ at all are counted. Both GPT cases are timed beside the
   bound (14 and 30 bytes a parameter over 3.35 TB/s), the plain version
   and torch._fused_adam_ (whose eps sits outside the bias-corrected
   sqrt, so it computes a slightly different function).
10. Resume (run after phase 6): phase 6's engine is freed; a fresh one,
   from weights of another seed, calls Engine.load_checkpoint on
   build/smoke_ckpt; global_steps, the optimizer step and the LR
   scheduler's state must be those of step 3. Steps 4-6 then run on the
   same batch with the counters zeroed: the losses and grad norms, and
   the final params and moments (torch.equal, and their digest), must
   equal phase 6's bit for bit, and the launches per step phase 6's. The
   checkpoint's bytes and the save and load seconds are printed, and the
   directory is deleted. It runs without a monitor block: its equality
   with phase 6 shows the monitor changed no number.
11. Block-sparse attention kernels (run after phase 9) against their
   plain versions: sparse_fwd and sparse_bwd at the path shape
   (1, 16, 4096, 64) bf16 over SPARSE_LAYOUTS (the path's Fixed block-16
   layout with 4 global patterns, Fixed unidirectional block 128 causal,
   BigBird, BSLongformer and Variable at block 64, LocalSlidingWindow
   unidirectional block 128 with 14 window blocks, Dense block 64), and
   BigBird 64 and Fixed unidirectional 128 at S 8192; then small cases
   (blocks 32 and 64 of one family, head dims 96 and 128, fp32, a key
   mask dropping the last quarter of the keys, empty layout rows, which
   must give o = 0 and lse = NEG_INF); then a wrong head count, a wrong
   length and an unsupported block, each of which must raise. At the
   path's layout two launches of sparse_fwd, and of sparse_bwd, on the
   same inputs must give the same bits; the elements of each kernel's
   outputs that differ from the plain version at all are counted, bf16
   and fp32. The
   reference's flash tolerances (fp32 2e-3 / 5e-3, bf16 2e-2 / 5e-2) and
   REL_L2 hold on every output. Every path-shape case is timed by
   CUDA-graph replay beside its bound (operations counted over the (query,
   key) pairs the layout keeps), the plain versions and
   F.scaled_dot_product_attention with the expanded boolean mask (its
   backward through autograd, launched eagerly); at the path's layout
   both kernels are also timed over one-tile groups, each warp walking
   its list alone (one_tile_groups_ms), the yardstick of the shared
   groups.
12. Sparse-attention training at full width: the user's loss
   of 24 BertSparseSelfAttention layers (BERT-large's attention
   sub-layers: hidden 1024, 16 heads, max_seq_length 4096, bf16, weights
   from a fixed seed) pre-LN with a residual, a final layer_norm and the
   mean square against a fixed target, on one (2, 4096, 1024) batch drawn
   from the seed, through initialize -> train_batch with micro-batch
   1 x 2 accumulation steps, masterless bf16, Adam at a constant 1e-3,
   clipping 1.0, "kernels": {"mode": "auto"} and the "sparse_attention"
   block of upstream DeepSpeed's documented example (fixed mode, block
   16), read back through TrainingConfig.get_sparse_attention; 6 steps.
   The gates of phase 6 (kernel path against the plain path, impl "xla"
   and kernels off, on one micro-batch; finite, falling losses; no
   skipped step; grad norms finite and > 0) and launches per step of
   exactly sparse_fwd 48, sparse_bwd 48, ln_fwd 50, ln_bwd 50 and
   fused_adam ceil(194 leaves / 64) = 4. One more step runs under
   torch.profiler, the sparse kernels a device-time family of their own.

13. The int8 wire-format kernels (run after phase 11) against their plain
   versions, bit for bit (every element's bits; a NaN matches a NaN), at
   the GPT-NeoX-125M bucket plan of configs/gpt_125m_comm.json at 2
   ranks (25 MB buckets padded to 2 x 128): quantize_rows at (2, L/2),
   fp32 and bf16 input, with and without the residual, and the second
   phase's (1, L/2); dequant_sum_rows at (2, L/2) int8 and (2, L) fp16
   mantissas with 2^e scales; dequant_rows at (2, L/2), divisor 2; R = 4
   and 8 rows at the largest bucket; all-zero blocks, a block holding a
   NaN (scale 1) and one holding an inf (scale inf); block 96 (the
   strided path); shapes the kernels do not take must raise. Each kernel
   is timed at the largest bucket, beside its byte bound (bytes over
   3.35 TB/s) and its plain version; no single PyTorch call computes any
   of the three.
14. Data-parallel training on one card (run before phase 15): 2 ranks,
   spawned with torch.multiprocessing, share cuda:0 and a gloo group
   through a FileStore in a temporary directory (NCCL refuses two ranks on
   one device, so the collectives cross host memory: the step time is no
   measure of a multi-GPU node). Each trains GPT-NeoX-125M at full width
   and depth (the neox-125m preset, max_seq 1024, remat "matmuls", bf16,
   weights from a fixed seed) on data/corpus_tokens.npy through initialize
   -> train_batch with the blocks of configs/gpt_125m_comm.json (ZeRO 1,
   bf16 with an fp32 master, Adam 6e-4 with weight decay 0.1,
   WarmupDecayLR, clipping 1.0, the int8 comm block with error feedback and
   hierarchical "auto", which on one host is the flat schedule, and its
   "monitor" block as written) cut as PERF.md section 4 lists (2 ranks x
   micro-batch 16 x 2 accumulation steps, warmup DP_WARMUP_STEPS) plus
   "kernels": {"mode": "auto"}: 6 steps, then 6 more from the same seed
   with "comm": {"mode": "fp32"}. Gates: on one micro-batch rank 0's kernel
   path agrees with the plain path (phase 6's limits); after every step
   both ranks' params are bit-identical; losses finite and falling, no
   skipped step; the int8 losses within INT8_LOSS_RTOL of the fp32-comm
   ones, and the grad norms of the steps both runs take from the same
   params (the lr-0 warmup steps and the next) within INT8_GNORM_RTOL;
   launches per step and rank exactly those of phase 6's model at this
   depth plus, per bucket, 2 quantize_rows, 1 dequant_sum_rows and 1
   dequant_rows under int8 and none of the three under fp32 comm; each
   rank's fp32 master and moments at most ZERO1_STATE_RATIO of a ZeRO 0
   engine's; each rank's monitor counts n_buckets and the modeled wire
   bytes per step for 6 steps (comm_buckets, comm_wire_bytes) and 6
   train_steps_total; each rank saves its int8 run's trace under its own
   role lane (trainer.h0, trainer.h1: two ranks never write one path), and
   ``aggregate`` merges the two into one timeline that passes strict
   validation and holds both ranks' comm/reduce spans. It prints step time,
   tokens/s, peak memory per rank, the buckets, the modeled wire bytes and
   the bytes staged through host memory per step, and the reduction's share
   of the step. A rank that raises fails the run. Every source is built
   before the spawn.
15. ZeRO-Infinity (run last): the streamed offload engine
   (runtime/offload/streaming.py) at GPT-NeoX-20B width (d_model 6144, 64
   heads of 96, d_ff 24576, vocab 50432, untied), built by initialize from
   a GPTConfig. First the host: its RAM (/proc/meminfo), the free disk at
   the swap folder, the host library's build (csrc/host/ds_cpu_adam.cpp:
   compiler, seconds, OpenMP, ds_adam_simd_width()). 15a: 1 layer, the
   fp32 wire, bf16 residency, fp32 host state in RAM, kernels auto, lr 0:
   the streamed grads (capture_grads) against make_gpt's autograd grads on
   the card's params, per leaf cosine >= INFINITY_GRAD_COSINE and relative
   L2 <= INFINITY_GRAD_REL_L2; the loss with the kernels off (eval_batch,
   dense attention) and make_gpt's within INFINITY_LOSS_RTOL; the native
   v1 pass against the numpy pass on the globals chunk (moments bit for
   bit, masters within 1e-7, the shadow and the uplink codes differing in
   at most INFINITY_V1_SHADOW_MAX and INFINITY_V1_CODES_MAX elements).
   15b: configs/
   neox_20b_infinity.json as written (stage 3, nvme offload, the
   streaming block: int4 wire and residency, bf16 host state, exp_avg_sq
   on the NVMe tier; its aio block, Adam 8e-6, WarmupLR 14) plus
   "kernels": {"mode": "auto"}, cut as PERF.md section 4 lists (n_layer
   44 -> INFINITY_LAYERS, 1, nvme_path a temporary directory), fresh init,
   INFINITY_STEPS steps on one corpus batch, a checkpoint saved after step
   2 (15c's). Gates after every step: the
   loss finite, every chunk's host shadow equal to the card's resident
   bytes, the wire bytes moved equal to wire_bytes_per_step(), every host
   pass on the native v2 route; the launches per step on steps 2 and 3
   equal to infinity_expected_launches. It prints each step's time and
   its four timings, the bytes in host RAM and on the NVMe tier, the
   resident bytes and the peak device memory, and the wire bytes. 15c:
   15b's checkpoint of step 2 (the config's profile at 1 layer) loaded
   into a fresh engine (at step 0): its step 3 on the same batch must give
   15b's step-3 loss and card bytes, bit for bit. The LN, bias+GeLU and
   flash kernels are held against their plain versions and timed at this
   step's shapes (INFINITY_LN, INFINITY_BG, INFINITY_FLASH) in the kernel
   phases ("path": "infinity").
16. The input pipeline and the training follow-ups (run after phase 15).
   16a: configs/gpt_125m_datapipe.json as written (bf16 with the fp32
   master, ZeRO 1, Adam, WarmupDecayLR, clipping, the "datapipe" block
   with prefetch and device staging and the seq-len curriculum, the
   "monitor" block) plus "kernels": {"mode": "auto"}, cut as PERF.md
   section 4 lists (source data/corpus_tokens.npy, micro-batch
   DATAPIPE_MICRO x DATAPIPE_GAS at one rank, warmup DATAPIPE_WARMUP,
   curriculum warmup DATAPIPE_CURRICULUM_STEPS: lengths 128/427/725/1024
   from steps 0/3/5/8), on phase 14's GPT-NeoX-125M (remat "matmuls"),
   trains DATAPIPE_STEPS steps through initialize -> train_batch() with no
   batch passed, saving a checkpoint after step DATAPIPE_SAVE_AFTER with
   the prefetch queue non-empty. Gates: every global batch the step read
   (cloned on the consumer's stream after the staging wait) equal by
   sha256 to a synchronous host-only pipe's batch of the same step; the
   active lengths, read from the pad columns, the curriculum's; losses
   and grad norms finite, no step skipped; the launches per step
   datapipe_expected's; the datapipe metrics in the monitor's registry.
   A fresh engine from other weights, its queue holding step 0's
   batches, loads the checkpoint and runs the remaining steps: the same
   DataState, batches (by hash) and losses, bit for bit. A run with the
   producer thread off (DATAPIPE_OFF_STEPS steps) is held to the host
   pipe too; the step time, tokens/s, median host stall, the busy share
   of a profiled step and the peak memory are printed for both, not
   gated. 16b: one micro-batch's loss and grads under each remat policy,
   same weights and tokens: losses within REMAT_LOSS_RTOL and grad norms
   within REMAT_NORM_RTOL of "full"'s, flash_fwd launched once a layer
   under "flash" and "matmuls" and twice under "full", "dots" and
   "dots_all", flash_bwd once; each policy's peak memory printed. 16c:
   store_gradients on the 16a engine equal to the unfused backward's
   grads (STORE_GRADS_ATOL), layer_outputs for all 12 layers, two SGD
   steps (momentum, Nesterov) on the 125M leaves against the CPU
   (SGD_ATOL), and FP16_Optimizer(FusedAdam) for 3 steps with a dynamic
   scale: the step with an inf gradient skipped and the scale halved.

17. Speculative decoding and the serving fleet (run after phase 16), on
   GPT-NeoX-125M at full width and depth (12 layers, d_model 768), bf16,
   random weights from SEED with random biases and layer-norm affines.
   The kernel phases hold ln_fwd at (VERIFY_ROWS, 768) and bias_gelu_fwd
   at (VERIFY_ROWS, 3072), the verify step's 8 x 5 rows, against their
   plain versions and time them ("path": "spec"). 17a:
   configs/gpt_125m_spec.json's "serving" block less its "fleet"
   sub-block (a 3-layer truncated drafter, draft_k 4, a 128-block drafter
   pool, prefix caching, chunked prefill), plus top_k SPEC_TOP_K, kernels
   auto and a strict-watchdog monitor, serves 16 requests of SPEC_NEW
   tokens (12 greedy, 4 sampled at SPEC_TEMPERATURE with fixed seeds;
   prompts 16-900 tokens, two pairs sharing a 300-token prefix); the same
   requests then run on a spec-off engine over the same params. Gates:
   every request finishes by length with SPEC_NEW tokens; the outputs
   equal the spec-off engine's, or differ first at a near tie (NEAR_TIE;
   the differing requests are printed); drafts accepted; ln_fwd launched
   once per target and drafter forward and bias_gelu_fwd once a layer
   (12 x target + 3 x drafter forwards: the drafter shares the target's
   final LN and head); one argument signature each for the decode, draft
   and verify steps; the trace strict-valid and the request ledger
   counting 64 tokens a request; the first-token logits of two requests
   within LOGIT_TOL between the kernel and plain paths. Printed: the
   accept rate, tokens per verify, draft and verify ms a round, the
   fallback lanes, decode tokens/s and TTFT p50 with speculation on and
   off, and the peak memory. 17b: configs/gpt_125m_fleet.json's "serving"
   block (its "fleet" sub-block included; plus top_k SPEC_TOP_K), three
   SubprocessReplicas of 17a's model (its params through a checkpoint
   under build/smoke_fleet_ckpt, each child loading the kernels the
   parent built: a child that ran nvcc fails the phase) sharing the card,
   started side by side. A healthy run of FLEET_GREEDY greedy and
   FLEET_SAMPLED sampled requests (prompts 16-FLEET_PROMPT_MAX, FLEET_NEW
   tokens), then a burst of FLEET_SHED_BURST short requests against
   max_queue_depth (every one past the cap shed with a retry_after_s,
   serving_shed_total counting them), then the same requests on a new
   fleet whose replica 1 is SIGKILLed and replica 2 wedged by
   DS_TPU_FAULTS plans. Gates: every request finishes by length; tokens
   equal one unkilled in-process engine's under the near-tie rule; one
   "dead" and one "stalled" replica-down, a retry, restarts within
   replica_max_restarts; the router's trace strict-valid. 17c:
   configs/gpt_125m_spec.json's whole "serving" block (3 speculative
   replicas), 17a's requests, replica 0 SIGKILLed mid-decode: every
   request finishes, and its tokens equal 17a's speculative engine's
   under the near-tie rule.
18. Resilience and the multi-process runtime (run after phase 17), on
   phase 16's GPT-NeoX-125M (full width and depth, remat "matmuls", bf16,
   weights from SEED), kernels auto. Its trainers are processes: this
   script with ``--child resilience|multihost WORK`` (a trainer that logs
   one JSON line a step and prints no contract line; its stdout and
   stderr go to WORK/log.<name>), loading the kernels the parent built
   (one that ran nvcc, or ran no step, fails the phase with its log), in
   an environment with CUBLAS_WORKSPACE_CONFIG fixed. 18a:
   configs/gpt_125m_obs.json cut as PERF.md section 4 lists
   (train_batch_size 512 -> RES_ROWS, warmup -> RES_WARMUP,
   save_interval_steps 500 -> RES_SAVE_INTERVAL, save_dir and obs_dir
   temporary, metrics_port 0, the corpus as the datapipe's source) under
   ``python -m deeperspeed_tpu_torch.resilience.supervisor``, to step
   RES_STEPS: DS_TPU_FAULTS SIGKILLs the first incarnation while it
   writes the first file of global_step4 (a one-shot flag file); the
   restart resumes global_step2 (``latest`` never named the torn staging
   directory) and, held after step RES_PREEMPT_AFTER, takes a SIGTERM:
   an urgent save, exit 86, an immediate restart that finishes. Gates:
   every step's loss bits, batch hash, grad norm bits and digest of the
   params after the update equal an uninterrupted trainer's
   (one process, no supervisor, saves off; it and 18b's world-1 trainer
   run beside the first incarnation); the restart log one crash
   with its backoff, one preemption without, then done; each restart's
   resilience counters (restarts, resumes, the preemption; no fallback);
   the committed tags 2, 4, 5, 6 verify their manifests; launches a
   step as phase 16's; the merged trace of the incarnations (the killed
   one's flight file) strict-valid. Printed: the async save's blocked
   and writer seconds (its resilience/* spans), restart-to-first-step
   seconds, checkpoint bytes, the step time of steps run alone on the
   card.
   18b: configs/gpt_125m_multihost.json cut as PERF.md section 4 lists
   (max_train_batch_size 512 -> MH_MAX_BATCH: 48 rows, micro 8 at world
   2; canonical_shards 32 -> MH_CANONICAL; save_interval_steps 500 ->
   MH_SAVE_INTERVAL; warmup, save and obs dirs as 18a) under the
   FleetSupervisor: two processes share the card over gloo through host
   copies (not NCCL, not two hosts); host 1 is SIGKILLed after step
   MH_KILL_AFTER, the barrier tears host 0 down and relaunches both from
   the step-MH_KILL_AFTER tag; after step
   MH_REMESH_AFTER the pool file goes 2 -> 1, a planned re-mesh (urgent
   save, no crash counted), and one process resumes the world-2 tag and
   runs the steps after it to MH_STEPS. Gates: every step's loss bits,
   grad norm bits and params digest equal a world-1 trainer's (the
   canonical-slot guarantee: the grad norm reads the restored residuals,
   the params the restored Adam moments); the restart log host 1
   crashed, host 0 fleet_restart, then pool_change for both, then done;
   the tags each epoch loaded; rendezvous records and clock offsets; the
   merged per-host, per-epoch trace strict-valid; launches a step and
   rank: the model's kernels per local slot, quantize_rows and
   dequant_rows once a bucket, dequant_sum_rows none. Printed: step
   seconds at worlds 2 and 1, the slot-row reduction's share (its
   comm/reduce spans), spawn to first step, peak memory a rank.
A line before the kernels line gives each phase's wall seconds. The line
before the last is the kernels JSON object, the one before it the card;
the last line is ``{"ok": true, "device": {...}}``. Without a CUDA
device the script exits non-zero before printing any result.
"""

import dataclasses
import gc
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
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
SUPERTILE_SOURCE = "deeperspeed_tpu_torch/csrc/supertile_attention.cu"
ADAM_SOURCE = "deeperspeed_tpu_torch/csrc/fused_adam.cu"
SPARSE_SOURCE = "deeperspeed_tpu_torch/csrc/sparse_attention.cu"
QUANT_SOURCE = "deeperspeed_tpu_torch/csrc/fused_quant.cu"
SOURCES = {"ln_fwd": FUSED_SOURCE, "bias_gelu_fwd": FUSED_SOURCE,
           "ln_bwd": FUSED_SOURCE, "bias_gelu_bwd": FUSED_SOURCE,
           "flash_fwd": FLASH_SOURCE, "flash_bwd": FLASH_SOURCE,
           "add_ln_fwd": FUSED_SOURCE, "add_ln_bwd": FUSED_SOURCE,
           "supertile_fwd": SUPERTILE_SOURCE,
           "supertile_bwd": SUPERTILE_SOURCE, "fused_adam": ADAM_SOURCE,
           "sparse_fwd": SPARSE_SOURCE, "sparse_bwd": SPARSE_SOURCE,
           "quantize_rows": QUANT_SOURCE, "dequant_sum_rows": QUANT_SOURCE,
           "dequant_rows": QUANT_SOURCE}
QUANT_KERNELS = ("quantize_rows", "dequant_sum_rows", "dequant_rows")
# the TPU kernel each one replaces (the kernel body); flash_fwd and
# flash_bwd each replace the static and the streaming pair
REPLACES = {
    "ln_fwd": "deeperspeed_tpu/ops/pallas/fused_blocks.py:72",
    "bias_gelu_fwd": "deeperspeed_tpu/ops/pallas/fused_blocks.py:280",
    "ln_bwd": "deeperspeed_tpu/ops/pallas/fused_blocks.py:94",
    "bias_gelu_bwd": "deeperspeed_tpu/ops/pallas/fused_blocks.py:285",
    "flash_fwd": "deeperspeed_tpu/ops/pallas/flash_static.py:127",
    "flash_bwd": "deeperspeed_tpu/ops/pallas/flash_static.py:201",
    "add_ln_fwd": "deeperspeed_tpu/ops/pallas/fused_blocks.py:173",
    "add_ln_bwd": "deeperspeed_tpu/ops/pallas/fused_blocks.py:184",
    "supertile_fwd": "deeperspeed_tpu/ops/pallas/flash_static.py:406",
    "supertile_bwd": "deeperspeed_tpu/ops/pallas/flash_static.py:428",
    "fused_adam": "deeperspeed_tpu/ops/pallas/fused_adam.py:101",
    "sparse_fwd": "deeperspeed_tpu/ops/sparse_attention/kernels.py:273",
    "sparse_bwd": "deeperspeed_tpu/ops/sparse_attention/kernels.py:464",
    "quantize_rows": "deeperspeed_tpu/ops/pallas/fused_quant.py:108",
    "dequant_sum_rows": "deeperspeed_tpu/ops/pallas/fused_quant.py:174",
    "dequant_rows": "deeperspeed_tpu/ops/pallas/fused_quant.py:211",
}
ALSO_REPLACES = {
    "flash_fwd": "deeperspeed_tpu/ops/pallas/flash_attention.py:131",
    "flash_bwd": "deeperspeed_tpu/ops/pallas/flash_attention.py:239,319",
    "sparse_fwd": "deeperspeed_tpu/ops/sparse_attention/kernels.py:956",
    "sparse_bwd": "deeperspeed_tpu/ops/sparse_attention/kernels.py:990",
    "quantize_rows": "deeperspeed_tpu/ops/pallas/fused_quant.py:100",
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
# bucket (16 ... 1024) in serving, the speculative verify step's 8 x 5
# window (VERIFY_ROWS), 2 x 1024 tokens in training, plus ragged counts
# (6 slots, 48 rows)
CHECK_ROWS = (6, 8, 16, 40, 48, 64, 128, 256, 512, 1024, 2048)
TIMED_ROWS = (8, 512, 2048)
BWD_ROWS = (8, 48, 512, 2048)
LN_WIDE_CASE = (48, 6144)  # GPT-NeoX-20B's width, the widest a model runs
# the LN forwards beside phase 2's (R, 2048): LN_WIDE_CASE, the other model
# widths at ragged rows, the widest row the rows route takes (1024 bf16
# vectors), and the wide route's widths, no whole 16-byte vectors (1001)
# or wider than 1024 of them (8200 bf16)
LN_FWD_CASES = (LN_WIDE_CASE, (37, 768), (1000, 1024), (333, 2048),
                (5, 8192), (37, 1001), (7, 8200))
# widths the LN backwards' kernels are built for and recorded at (phase 1):
# GPT-NeoX-125M, BERT-large, GPT-NeoX-1.3B, GPT-NeoX-20B
LN_WIDTHS = (768, 1024, 2048, 6144)
# FFN widths bias+GeLU runs at (phase 1 records its kernels there): BERT's
# MLM head and GPT-NeoX-125M, GPT-NeoX-125M's and BERT-large's FFN,
# GPT-NeoX-1.3B's and GPT-NeoX-20B's
BG_WIDTHS = (1024, 3072, 4096, 8192, 24576)
# bias+GeLU beside phases 2-3's (R, 8192): the data-parallel GPT-NeoX-125M
# FFN (16384, 3072) bf16, timed there ("path": "dp"); GPT-NeoX-20B's width
# at 48 rows; widths whose last column strip of 32 vectors is partial on
# the vector route (1000; 8188 fp32, which bf16 takes on the scalar route);
# the scalar route's width 1001 and rows off a 16-byte boundary
BG_CASES = ((16384, 3072, True), (48, 24576, True), (37, 1000, True),
            (37, 8188, True), (37, 1001, True), (65, 1024, False))
# |x| of the inputs that saturate GeLU's sigmoid and erf
BG_SATURATED = 60.0
PATH_ROWS = 2048          # B * S of the training micro-batch
# (B, H, S, Dh): the training shape first (timed), then S beyond the
# reference's whole-S kernel, ragged S, and the other head dims
FLASH_SHAPES = ((2, 16, 1024, 128), (1, 4, 2048, 128), (1, 2, 4096, 128),
                (1, 4, 640, 128), (1, 4, 1000, 128), (2, 12, 1024, 64),
                (1, 8, 1024, 96), (16, 12, 1024, 64), (1, 64, 1024, 96))
# S at the kernels' tile edges (the tiles are 16, 32 and 64 rows), every
# head dim
FLASH_EDGE_SHAPES = tuple((1, 2, S, Dh) for S in (1, 17, 63, 65, 127, 129)
                          for Dh in (64, 96, 128))
# shapes timed (causal, bf16) and the path each is: GPT-NeoX-1.3B
# training's micro-batch and phase 14's GPT-NeoX-125M one
FLASH_TIMED = {(2, 16, 1024, 128): "gpt", (16, 12, 1024, 64): "dp",
               (1, 64, 1024, 96): "infinity"}
# the training run's bf16 limits, kernel path against plain path
LOSS_RTOL = 5e-3
GNORM_RTOL = 5e-2
MIN_COSINE = 0.99
TRAIN_STEPS = 6
# phases 6 and 6' train GPT-NeoX-1.3B at full width, cut to 10 of its 24
# layers to give phase 18 time (PERF.md section 4); phase 5 serves all 24
TRAIN_LAYERS = 10
# overrides the config's 1000 so the LR moves within 6 steps. The
# scheduler gives lr 0 on the first two steps; the first Adam step after
# them moves every weight by about lr (Adam's first steps are sign-like),
# which lifts the loss for a step, with or without the kernels, the
# randomized biases or an fp32 master (scripts/torch_first_step_probe.py,
# PERF.md). 100 lets the loss fall below its start by step 6; with 2 it
# had not recovered by then.
WARMUP_STEPS = 100
# BERT-large (phases 7-8)
BERT_ROWS = 64 * 128       # B * S of the BERT micro-batch
BERT_HEAD_ROWS = 64 * 64   # the MLM head's rows: one 64-position CE chunk
ADD_LN_ROWS = (37, 1000, BERT_ROWS)
# the BERT-large shape, then the forward's tile and S-class edges (16-row
# query tiles; scores held in registers up to S 64 and 128, recomputed
# above) at head dims that are and are not a multiple of 16
SUPERTILE_SHAPES = ((64, 16, 128, 64),) + tuple(
    (2, 4, S, Dh) for S in (8, 16, 64, 120, 136, 200, 248)
    for Dh in (40, 64, 96, 128))
BERT_STEPS = 6
# WarmupLR, as the reference's, gives lr 0 on the first two steps, then
# warmup_max_lr * log(t + 1) / log(W + 1): with W = 4 the LR is at 43 %,
# 68 %, 86 % and 100 % of 2e-3 on steps 3-6, so the four LAMB updates,
# each moving every leaf by about lr of its norm, show in the loss by
# step 6; the config's 10000 would keep them below 8 % of it.
BERT_WARMUP_STEPS = 4
BERT_MASK_ID = 103
BERT_MASK_FRAC = 0.15
# fused Adam (phase 9): the reference's own element-wise tolerance for its
# kernel (tests/test_fused_kernels.py) for fp32 storage, one ulp for bf16
ADAM_TOL = 1e-6
ADAM_STEPS = 3
# small leaves: a 0-d one, counts that are no multiple of the kernel's
# 8-element step, an LM-head-like row block, several 65536-element chunks
ADAM_SMALL_SHAPES = ((), (7,), (1000,), (3, 50304), (2, 65536 + 5))
# (adam_w_mode, weight decay, bias correction)
ADAM_HYPER = ((True, 0.0, True), (True, 0.01, True), (False, 0.01, True),
              (True, 0.01, False))
CKPT_DIR = ROOT / "build" / "smoke_ckpt"
SAVE_AFTER_STEP = 3
# the monitor (phases 5, 6 and 14): phase 6 takes configs/gpt_125m_obs.json's
# "monitor" block with the cuts PERF.md section 4 lists (obs_dir in a
# temporary directory, an ephemeral metrics port, the TB export every 3
# steps); serving runs a strict watchdog, the endpoint and the cost index
OBS_CONFIG = ROOT / "configs" / "gpt_125m_obs.json"
OBS_TB_EXPORT_INTERVAL = 3
SERVING_MONITOR = {"watchdog": "strict", "metrics_port": 0, "perf": True}
# tail-latency targets of the serving run's "slo" block: they drive the
# burn-rate gauges and slo/violation instants, they gate nothing
SERVING_SLO = {"ttft_p99_ms": 1000.0, "tpot_p99_ms": 50.0,
               "e2e_p99_ms": 5000.0}
SERVING_EVENTS = {"serving/step", "serving/prefill", "serving/decode",
                  "req/submit", "serving/admit", "serving/finish",
                  "perf/compiled", "perf/step", "mem/watermark",
                  "kernels/fused_layer_norm", "kernels/fused_bias_gelu"}
SERVING_METRICS = ("serving_ttft_seconds_bucket",
                   "serving_tokens_generated_total",
                   "serving_decode_steps_total",
                   "serving_requests_finished_total",
                   "serving_finish_total", "slo_burn_rate",
                   "mem_bytes_in_use", "perf_mfu", "perf_flops")
TRAIN_EVENTS = {"run/start", "mesh/build", "engine/train_batch",
                "perf/compiled", "perf/step", "mem/watermark",
                "kernels/fused_layer_norm", "kernels/fused_bias_gelu",
                "kernels/fused_adam"}
# the near-OOM trip: a 4 GiB buffer (larger than any other live tensor
# then) puts the allocator above 2 % of the card at the first sample
NEAR_OOM_FRACTION = 0.02
NEAR_OOM_BALLAST = 4 << 30
# block-sparse attention (phases 11-12) at BERT-large's attention width
SPARSE_HEADS, SPARSE_DH, SPARSE_D = 16, 64, 1024
SPARSE_SEQ = 4096
SPARSE_LONG_SEQ = 8192
# the fixed-mode keys of upstream DeepSpeed's documented "sparse_attention"
# example (docs config-json, "Sparse Attention"); its keys of the other
# modes are left out, since sparsity_config_from_dict passes every key to
# the mode's class
SPARSE_BLOCK = {"mode": "fixed", "block": 16,
                "different_layout_per_head": True, "num_local_blocks": 4,
                "num_global_blocks": 1, "attention": "bidirectional",
                "horizontal_global_attention": False,
                "num_different_global_patterns": 4}
# (name, config factory, causal, also at SPARSE_LONG_SEQ): the path's
# layout first, then the JAX bench's default (scripts/bert_sparse_bench.py
# :140), each other family, and dense
SPARSE_LAYOUTS = (
    ("fixed-path", lambda sa: sa.sparsity_config_from_dict(
        SPARSE_HEADS, SPARSE_BLOCK), False, False),
    ("fixed-uni-128", lambda sa: sa.FixedSparsityConfig(
        num_heads=SPARSE_HEADS, block=128, attention="unidirectional"),
     True, True),
    ("bigbird-64", lambda sa: sa.BigBirdSparsityConfig(
        num_heads=SPARSE_HEADS, block=64), False, True),
    ("bslongformer-64", lambda sa: sa.BSLongformerSparsityConfig(
        num_heads=SPARSE_HEADS, block=64), False, False),
    ("variable-64", lambda sa: sa.VariableSparsityConfig(
        num_heads=SPARSE_HEADS, block=64), False, False),
    ("local-uni-128", lambda sa: sa.LocalSlidingWindowSparsityConfig(
        num_heads=SPARSE_HEADS, block=128, num_sliding_window_blocks=14),
     True, False),
    ("dense-64", lambda sa: sa.DenseSparsityConfig(
        num_heads=SPARSE_HEADS, block=64), False, False),
)
# (name, config factory, S, Dh, causal, masked): blocks 32 and 64 of one
# family, head dims 96 and 128, the path's layout and a causal window
# under a key mask that drops the last quarter of the keys (the window
# rows there then see no key)
SPARSE_SMALL = (
    ("bigbird-32", lambda sa: sa.BigBirdSparsityConfig(
        num_heads=4, block=32), 1024, 128, False, False),
    ("bigbird-64-uni", lambda sa: sa.BigBirdSparsityConfig(
        num_heads=4, block=64, attention="unidirectional"), 1024, 128, True,
     False),
    ("fixed-16", lambda sa: sa.FixedSparsityConfig(num_heads=4, block=16),
     512, 96, False, False),
    ("fixed-path-masked", lambda sa: sa.sparsity_config_from_dict(
        4, SPARSE_BLOCK), 1024, 64, False, True),
    ("local-uni-128-masked", lambda sa: sa.LocalSlidingWindowSparsityConfig(
        num_heads=4, block=128, num_sliding_window_blocks=3), 1024, 64, True,
     True),
)
SPARSE_LAYERS = 24
SPARSE_STEPS = 6
SPARSE_LR = 1e-3
# ZeRO-Infinity (phase 15): configs/neox_20b_infinity.json at GPT-NeoX-20B
# width, cut to INFINITY_LAYERS of its 44 layers (15b and 15c, which
# resumes 15b's step-2 checkpoint; 1 layer in 15a too) with nvme_path in a
# temporary directory (PERF.md section 4)
INFINITY_CONFIG = ROOT / "configs" / "neox_20b_infinity.json"
INFINITY_LAYERS = 1
INFINITY_SEQ = 1024
INFINITY_STEPS = 3
INFINITY_LR = 8e-6                  # the config's peak lr
# 15a's limits: the streamed grads against make_gpt's, per leaf; the loss
# of the kernel path against the plain one
INFINITY_GRAD_COSINE = 0.99
INFINITY_GRAD_REL_L2 = 1e-2
INFINITY_LOSS_RTOL = 5e-3
# 15a's native v1 pass against the numpy pass on the 620M-element globals
# chunk: moments bit for bit, masters within 1e-7, and at most this many
# shadow elements and uplink codes apart (the library's FMA against
# numpy's two roundings; a reading of 1318 and 11, PERF.md section 6)
INFINITY_V1_SHADOW_MAX = 5000
INFINITY_V1_CODES_MAX = 100
# the streamed step's kernel shapes: flash (B, H, S, Dh), the final layer
# norm's rows and the FFN's
INFINITY_FLASH = (1, 64, 1024, 96)
INFINITY_LN = (1024, 6144)
INFINITY_BG = (1024, 24576)


# the input pipeline (phase 16): configs/gpt_125m_datapipe.json with the
# cuts PERF.md section 4 lists, on phase 14's GPT-NeoX-125M
DATAPIPE_CONFIG = ROOT / "configs" / "gpt_125m_datapipe.json"
DATAPIPE_MICRO = 16
DATAPIPE_GAS = 4
DATAPIPE_STEPS = 12                 # crosses the curriculum's 4 stages
DATAPIPE_SAVE_AFTER = 6
DATAPIPE_OFF_STEPS = 6              # the run with the producer thread off
DATAPIPE_WARMUP = 100               # the file's 2000
DATAPIPE_CURRICULUM_STEPS = 8       # the file's 2000: stages at 0/3/5/8
DATAPIPE_CKPT = ROOT / "build" / "smoke_datapipe_ckpt"
# 16b: every remat policy's loss within fp32 rounding of "full"'s (the
# same forward runs under every policy; a few ulps of the fp32 loss) and
# its grad norm within 1e-3 relative
REMAT_POLICIES = ("full", "flash", "matmuls", "dots", "dots_all")
REMAT_LOSS_RTOL = 1e-6
REMAT_NORM_RTOL = 1e-3
# 16c: the stored grads against the unfused backward's, relative to the
# largest gradient element (the same bf16 grads summed in fp32 in the
# same order: equal unless a kernel is nondeterministic), and SGD on the
# card against the CPU (the same fp32 elementwise ops)
STORE_GRADS_ATOL = 1e-6
SGD_ATOL = 1e-6
# speculative decoding and the fleet (phase 17) on GPT-NeoX-125M: 17a
# configs/gpt_125m_spec.json's "serving" block less its "fleet" sub-block,
# 17b configs/gpt_125m_fleet.json's, 17c the spec file's whole block; each
# plus top_k SPEC_TOP_K for the sampled requests (PERF.md section 4)
SPEC_CONFIG = ROOT / "configs" / "gpt_125m_spec.json"
FLEET_CONFIG = ROOT / "configs" / "gpt_125m_fleet.json"
SPEC_TOP_K = 40
SPEC_TEMPERATURE = 0.8
SPEC_NEW = 64
# 16 prompts; the pairs SPEC_SHARED share their first SPEC_PREFIX tokens
# (prefix-cache hits), and nine are longer than the 256-token prefill chunk
SPEC_LENS = (16, 40, 64, 100, 150, 200, 240, 320, 330, 400, 480, 520, 600,
             700, 800, 900)
SPEC_SHARED = ((7, 8), (9, 10))
SPEC_PREFIX = 300
SPEC_SAMPLED = {1: 11, 6: 22, 11: 33, 14: 44}   # request index -> seed
# a request whose spec-on and spec-off tokens differ passes only at a near
# tie: at the first differing position, logits that move by NEAR_TIE times
# the largest |logit| there can change the selection (near_tie: the top-1
# / top-2 gap, and for sampled requests also the top-k filter's edge).
# Phase 5's rule lets the kernel and plain paths' logits differ by
# LOGIT_TOL times the largest |logit|: the margin is no larger.
# (four bf16 ulps at the largest |logit|: the two paths' logits were seen
# one ulp apart, and a tie flips when two of them move toward each other)
NEAR_TIE = 0.02
# 17b: 24 greedy and 4 sampled requests, prompts 16-512 tokens; replica 1
# is SIGKILLed at its FLEET_KILL_AT-th decode step after its warm-up and
# replica 2 wedged from its FLEET_STALL_AT-th (scripts/fleet_drill.py's
# faults, one-shot flag files)
FLEET_GREEDY = 24
FLEET_SAMPLED = 4
FLEET_NEW = 48
FLEET_PROMPT_MAX = 512
FLEET_KILL_AT = 12
FLEET_STALL_AT = 20
FLEET_SHED_BURST = 160
FLEET_SHED_NEW = 8
FLEET_CKPT = ROOT / "build" / "smoke_fleet_ckpt"
FLEET_TAG = "smoke"
FLEET_RUN_TIMEOUT_S = 240.0
SPEC_FLEET_KILL_AT = 15
# the verify step's rows: num_slots x (draft_k + 1) of the spec config
VERIFY_ROWS = 40
# resilience and the multi-process runtime (phase 18) on GPT-NeoX-125M
# (phase 16's model): 18a configs/gpt_125m_obs.json under the Supervisor,
# 18b configs/gpt_125m_multihost.json under the FleetSupervisor, each cut
# as PERF.md section 4 lists
OBS_CONFIG = ROOT / "configs" / "gpt_125m_obs.json"
MULTIHOST_CONFIG = ROOT / "configs" / "gpt_125m_multihost.json"
RES_ROWS = 64                       # the file's 512 (phase 16's cut)
RES_WARMUP = 100                    # the files' 2000
RES_SAVE_INTERVAL = 2               # the files' 500
RES_STEPS = 7
RES_PREEMPT_AFTER = 5               # SIGTERM while held after this step
RES_TAG_FILES = 2                   # payload files a tag (model, optim)
MH_MAX_BATCH = 64                   # the file's 512
MH_CANONICAL = 8                    # the file's 32
MH_ROWS, MH_MICRO_W2, MH_WORLDS = 48, 8, [1, 2, 3, 4, 6, 12]
MH_SAVE_INTERVAL = 4                # the file's 500: tags at 4 and 5 only
MH_STEPS = 7                        # epoch 2 (world 1) runs steps 6 and 7
MH_KILL_AFTER = 4                   # host 1 SIGKILLed after this step
MH_REMESH_AFTER = 5                 # the pool file 2 -> 1 after this step
PHASE18_CHILD_TIMEOUT_S = 600


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


def check_close(name, got, want, tol, rel, norm=None):
    """Fails unless every element is within atol = rtol = ``tol`` and the
    error's L2 norm is within ``rel`` of the reference's (or of ``norm``,
    where the reference is zero in exact arithmetic). Returns (max abs
    error, relative L2 error)."""
    diff = got.float() - want.float()
    err = diff.abs()
    bad = err > tol + tol * want.float().abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol=rtol={tol}; "
            f"max abs err {float(err.max()):.3e}")
    if norm is None:
        norm = want.float().norm()
    rel_err = float(diff.norm() / norm.clamp_min(1e-30))
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
            if R == PATH_ROWS and dtype == torch.bfloat16:
                row["bit_identical_relaunch"] = relaunch_same_bits(
                    fb, "ln_fwd", (x, w, b, 1e-5))
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
                if (R == PATH_ROWS and dtype == torch.bfloat16
                        and approximate):
                    row["bit_identical_relaunch"] = relaunch_same_bits(
                        fb, "bias_gelu_fwd", (x, bias, approximate))
                if R in TIMED_ROWS:
                    bufs = copies(lambda: (randn((R, Fd), dtype, 2.0), bias,
                                           approximate), R * Fd * isz)
                    row.update(timings(fb.bias_gelu_fwd,
                                       fb.bias_gelu_fwd_plain, bufs))
                    row.update(bound(2 * R * Fd * isz + Fd * isz,
                                     10 * R * Fd))
                    del bufs
                results["bias_gelu_fwd"].append(row)
    for name, rows in ln_fwd_width_cases(fb, gen).items():
        results.setdefault(name, []).extend(rows)
    return results


def ln_fwd_width_cases(fb, gen):
    """ln_fwd and add_ln_fwd at LN_FWD_CASES and on rows that start off a
    16-byte boundary (the wide route), bf16 and fp32, against their plain
    versions: y within TOL, mean and rstd within 2e-5, every output within
    REL_L2; each row records the route ln_fwd_plan took."""
    results = {"ln_fwd": [], "add_ln_fwd": []}
    cases = [(R, D, True) for R, D in LN_FWD_CASES] + [(65, 1024, False)]
    for R, D, aligned in cases:
        for dtype in (torch.bfloat16, torch.float32):
            tol, rel = TOL[dtype], REL_L2[dtype]
            if aligned:
                x, r = (randn_on(gen, (R, D), dtype, 2.0, 0.5)
                        for _ in range(2))
            else:
                x, r = (randn_on(gen, (R * D + 1,), dtype, 2.0, 0.5)[1:]
                        .view(R, D) for _ in range(2))
            w = randn_on(gen, (D,), torch.float32, 0.1, 1.0)
            b = randn_on(gen, (D,), torch.float32, 0.1)
            route = fb.ln_fwd_plan(R, D, dtype, aligned=aligned)["route"]
            for name, args in (("ln_fwd", (x, w, b, 1e-5)),
                               ("add_ln_fwd", (x, r, w, b, 1e-5))):
                got = getattr(fb, name)(*args)
                torch.cuda.synchronize()
                want = getattr(fb, f"{name}_plain")(*args)
                tag = (f"{name} {R}x{D} {dtype_name(dtype)}"
                       f"{'' if aligned else ' unaligned'}")
                err, rel_err = check_close(tag, got[0], want[0], tol, rel)
                check_outputs(f"{tag} stats", ("mean", "rstd"), got[1:],
                              want[1:], 2e-5, rel)
                results[name].append({
                    "shape": [R, D], "dtype": dtype_name(dtype),
                    "aligned": aligned, "route": route, "max_abs_err": err,
                    "tol": tol, "rel_l2_err": rel_err, "rel_l2_tol": rel})
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
                row["bit_identical_relaunch"] = relaunch_same_bits(
                    fb, "ln_bwd", args)
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
                    row["bit_identical_relaunch"] = relaunch_same_bits(
                        fb, "bias_gelu_bwd", args)
                    row["launch_ms"] = launch_profile(fb.bias_gelu_bwd, args)
                    bufs = copies(bg_case, 2 * R * Fd * isz)
                    row.update(timings(fb.bias_gelu_bwd,
                                       fb.bias_gelu_bwd_plain, bufs))
                    row["library"] = None
                    row.update(bound(3 * R * Fd * isz + Fd * (isz + 4),
                                     20 * R * Fd))
                    del bufs
                results["bias_gelu_bwd"].append(row)
    R, D = LN_WIDE_CASE
    for dtype in (torch.bfloat16, torch.float32):
        x = randn_on(gen, (R, D), dtype, 2.0, 0.5)
        w = randn_on(gen, (D,), torch.float32, 0.1, 1.0)
        _, mean, rstd = fb.ln_fwd_plain(x, w, w, 1e-5)
        args = (x, w, mean, rstd, randn_on(gen, (R, D), dtype))
        got = fb.ln_bwd(*args)
        torch.cuda.synchronize()
        tol, rel = 10 * TOL[dtype], REL_L2[dtype]
        err, rel_err = check_outputs(f"ln_bwd {R}x{D} {dtype_name(dtype)}",
                                     ("dx", "dw", "db"), got,
                                     fb.ln_bwd_plain(*args), tol, rel)
        results["ln_bwd"].append({
            "shape": [R, D], "dtype": dtype_name(dtype), "max_abs_err": err,
            "tol": tol, "rel_l2_err": rel_err, "rel_l2_tol": rel,
            "route": fb.ln_bwd_plan(R, D, dtype)["route"]})
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


def flash_case(fa, gen, shape, dtype, causal):
    """flash_fwd and flash_bwd against their plain versions at one case:
    (forward row, backward row)."""
    ftol, gtol = FLASH_TOL[dtype]
    rel = REL_L2[dtype]
    dname = dtype_name(dtype)
    scale = 1.0 / math.sqrt(shape[-1])
    q, k, v, do = (randn_on(gen, shape, dtype) for _ in range(4))
    o, lse = fa.flash_fwd(q, k, v, scale, causal)
    torch.cuda.synchronize()
    po, plse = fa.flash_fwd_plain(q, k, v, scale, causal)
    tag = f"{tuple(shape)} {dname} causal={causal}"
    err, rel_err = check_outputs(f"flash_fwd {tag}", ("o", "lse"), (o, lse),
                                 (po, plse), ftol, rel)
    fwd = {"shape": list(shape), "dtype": dname, "causal": causal,
           "max_abs_err": err, "tol": ftol, "rel_l2_err": rel_err,
           "rel_l2_tol": rel}
    got = fa.flash_bwd(q, k, v, po, plse, do, scale, causal)
    torch.cuda.synchronize()
    want = fa.flash_bwd_plain(q, k, v, po, plse, do, scale, causal)
    # At S = 1 every row's softmax has one key, so dQ and dK are zero in
    # exact arithmetic and both versions return fp32 rounding noise: their
    # L2 error is taken relative to dV's norm, the case's gradient scale.
    norms = [want[2].float().norm()] * 2 if shape[2] == 1 else [None] * 2
    errs = [check_close(f"flash_bwd {tag} {n}", a, b, gtol, rel, norm)
            for n, a, b, norm in zip(("dq", "dk", "dv"), got, want,
                                     norms + [None])]
    err, rel_err = max(e for e, _ in errs), max(r for _, r in errs)
    bwd = {"shape": list(shape), "dtype": dname, "causal": causal,
           "max_abs_err": err, "tol": gtol, "rel_l2_err": rel_err,
           "rel_l2_tol": rel}
    return fwd, bwd


def time_flash(fa, gen, shape, fwd, bwd):
    """Times the bf16 causal pair at ``shape`` (kernel, plain version, SDPA
    and its backward) into the rows, adds the bound, and requires two
    launches of each kernel on the same inputs to give the same bits."""
    dtype = torch.bfloat16
    scale = 1.0 / math.sqrt(shape[-1])

    def case():
        t = [randn_on(gen, shape, dtype) for _ in range(4)]
        o_, lse_ = fa.flash_fwd_plain(*t[:3], scale, True)
        return t[:3] + [o_, lse_, t[3]]

    bufs = copies(case, flash_work(shape, True, dtype, False)[0])
    fwd_bufs = [(a[0], a[1], a[2], scale, True) for a in bufs]
    bwd_bufs = [tuple(a) + (scale, True) for a in bufs]
    for name, fn, args in (("flash_fwd", fa.flash_fwd, fwd_bufs[0]),
                           ("flash_bwd", fa.flash_bwd, bwd_bufs[0])):
        first, second = fn(*args), fn(*args)
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"{name} {tuple(shape)}: two launches on the "
                                 f"same inputs differ")
        del first, second
    fwd["bit_identical_relaunch"] = bwd["bit_identical_relaunch"] = True
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd.update(timings(fa.flash_fwd, fa.flash_fwd_plain, fwd_bufs,
                       lambda a, b, c, *_: sdpa(a, b, c, is_causal=True),
                       fwd_bufs, iters=10, replays=3))
    fwd["library"] = "F.scaled_dot_product_attention"
    fwd.update(bound(*flash_work(shape, True, dtype, False), BF16_OPS_PER_S))
    lib_bufs = [sdpa_backward_args(a[0], a[1], a[2], a[5], scale, True)
                for a in bufs]
    bwd.update(timings(fa.flash_bwd, fa.flash_bwd_plain, bwd_bufs,
                       sdpa_backward, lib_bufs, iters=10, replays=3))
    bwd["library"] = "aten._scaled_dot_product_flash_attention_backward"
    bwd.update(bound(*flash_work(shape, True, dtype, True), BF16_OPS_PER_S))


def flash_phase(fa, gen):
    """flash_fwd and flash_bwd against their plain versions at every shape
    in FLASH_SHAPES and FLASH_EDGE_SHAPES, causal and not, bf16 and fp32;
    the shapes in FLASH_TIMED are timed causal in bf16 and relaunched for
    bit identity."""
    results = {"flash_fwd": [], "flash_bwd": []}
    for shape in FLASH_SHAPES + FLASH_EDGE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                fwd, bwd = flash_case(fa, gen, shape, dtype, causal)
                if (causal and dtype == torch.bfloat16
                        and shape in FLASH_TIMED):
                    time_flash(fa, gen, shape, fwd, bwd)
                    fwd["path"] = bwd["path"] = FLASH_TIMED[shape]
                results["flash_fwd"].append(fwd)
                results["flash_bwd"].append(bwd)
        torch.cuda.empty_cache()
    return results


def sass_matrix_ops(library, nvcc):
    """{kernel function name: count of HMMA / HGMMA instructions} from
    ``cuobjdump -sass`` (beside ``nvcc``) of a built library."""
    tool = Path(nvcc).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(library)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    return counts


def flash_build_report(fa, op_builder):
    """Phase 1's record of the flash kernels: prints each instantiation's
    registers, shared memory, local memory (spills) and blocks an SM, and
    the matrix instructions in its SASS. Fails if a bf16 kernel spills or
    if a bf16 forward or backward kernel has no tensor-core instruction."""
    for name in fa.KERNELS:
        for dh in fa.HEAD_DIMS:
            for dtype in (torch.bfloat16, torch.float32):
                info = fa.kernel_info(name, dh, dtype)
                print(f"build: {name} Dh {dh} {dtype_name(dtype)}: "
                      f"{info['registers']} registers, "
                      f"{info['static_smem']} B static + "
                      f"{info['dynamic_smem']} B dynamic shared memory, "
                      f"{info['local_bytes']} B local a thread, "
                      f"{info['threads']} threads, "
                      f"{info['blocks_per_sm']} blocks an SM", flush=True)
                if dtype == torch.bfloat16 and info["local_bytes"]:
                    raise AssertionError(f"{name} Dh {dh} bf16 uses "
                                         f"{info['local_bytes']} B of local "
                                         f"memory a thread (spills)")
    counts = sass_matrix_ops(op_builder.build_info["flash_attention"]["path"],
                             op_builder.find_nvcc())
    for fn, n in sorted(counts.items()):
        print(f"build: SASS {fn}: {n} HMMA/HGMMA", flush=True)
    mma = {fn: n for fn, n in counts.items() if "_mma_kernel" in fn}
    want = len(fa.HEAD_DIMS) * 3  # forward, dK/dV and dQ at each head dim
    if len(mma) != want or not all(mma.values()):
        raise AssertionError(f"expected {want} bf16 tensor-core flash kernels "
                             f"with HMMA/HGMMA in their SASS, got {mma}")


def report_kernel(name, info):
    """Prints one compiled kernel's record; fails if it uses local memory
    (spills)."""
    print(f"build: {name}: {info['registers']} registers, "
          f"{info['static_smem']} B static + {info['dynamic_smem']} B "
          f"dynamic shared memory, {info['local_bytes']} B local a thread, "
          f"{info['threads']} threads, {info['blocks_per_sm']} blocks an SM",
          flush=True)
    if info["local_bytes"]:
        raise AssertionError(f"{name} uses {info['local_bytes']} B of local "
                             f"memory a thread (spills)")


def require_hmma(library, op_builder, marker, want):
    """Fails unless ``want`` kernels whose name holds ``marker`` in the
    built ``library`` each have HMMA/HGMMA instructions in their SASS."""
    counts = sass_matrix_ops(op_builder.build_info[library]["path"],
                             op_builder.find_nvcc())
    mma = {fn: n for fn, n in counts.items() if marker in fn}
    for fn, n in sorted(mma.items()):
        print(f"build: SASS {fn}: {n} HMMA/HGMMA", flush=True)
    if len(mma) != want or not all(mma.values()):
        raise AssertionError(f"expected {want} {marker} kernels with "
                             f"HMMA/HGMMA in their SASS, got {mma}")


def tensor_core_build_report(bs, fs, op_builder):
    """Phase 1's record of the sparse pair's and the super-tile forward's
    bf16 kernels: every instantiation's registers, shared and local memory
    and blocks an SM (no spills), and HMMA in the SASS of each tensor-core
    kernel; the sparse forward at the path's S and block, its dynamic
    shared memory and threads those block_sparse.fwd_plan says."""
    for name in bs.KERNELS:
        for dh in bs.HEAD_DIMS:
            if name != "sparse_fwd":
                report_kernel(f"{name} Dh {dh} bf16", bs.kernel_info(name, dh))
                continue
            plan = bs.fwd_plan(SPARSE_SEQ, SPARSE_BLOCK["block"], dh)
            info = bs.kernel_info(name, dh, plan["list_len"])
            report_kernel(f"{name} Dh {dh} bf16 (S {SPARSE_SEQ}, block "
                          f"{SPARSE_BLOCK['block']})", info)
            if (info["dynamic_smem"], info["threads"]) != (
                    plan["smem_bytes"], plan["threads"]):
                raise AssertionError(
                    f"sparse_fwd Dh {dh}: the kernel launches with "
                    f"{info['dynamic_smem']} B and {info['threads']} threads, "
                    f"fwd_plan says {plan['smem_bytes']} B and "
                    f"{plan['threads']}")
    for marker in ("sparse_bwd_dq_mma_kernel", "sparse_bwd_dkdv_mma_kernel",
                   "sparse_fwd_mma_kernel"):
        require_hmma("sparse_attention", op_builder, marker,
                     len(bs.HEAD_DIMS))
    # one instantiation for each head dim rounded up to 16 and each S
    # class (the whole row's scores in registers up to S 64 and 128,
    # recomputed above)
    padded = range(16, fs.MAX_HEAD_DIM + 1, 16)
    for dh in padded:
        for S in (64, 128, 248):
            report_kernel(f"supertile_fwd Dh {dh} S {S} bf16",
                          fs.fwd_kernel_info(S, dh))
    require_hmma("supertile_attention", op_builder,
                 "supertile_fwd_mma_kernel", 3 * len(padded))


def backward_build_report(fb, fs, op_builder):
    """Phase 1's record of the kernels PERF.md's rows 2, 4 and 12 run:
    the bf16 super-tile backward at every padded head dim on both routes
    (S 128: one block a sequence; S 248: four), each launch configuration
    as flash_static.bwd_plan computes it and HMMA in every instantiation;
    the LN backwards' first kernel at LN_WIDTHS (ln and add-LN, bf16 and
    fp32, the route ln_bwd_plan picks) and their reduction. Fails on any
    spill."""
    padded = range(16, fs.MAX_HEAD_DIM + 1, 16)
    for dh in padded:
        for S in (128, 248):
            info = fs.bwd_kernel_info(S, dh)
            plan = fs.bwd_plan(S, dh, torch.bfloat16)
            report_kernel(f"supertile_bwd Dh {dh} S {S} bf16 "
                          f"({plan['route']})", info)
            if (info["dynamic_smem"], info["threads"]) != (
                    plan["smem_bytes"], plan["threads"]):
                raise AssertionError(
                    f"supertile_bwd Dh {dh} S {S}: the kernel launches with "
                    f"{info['dynamic_smem']} B and {info['threads']} threads, "
                    f"bwd_plan says {plan['smem_bytes']} B and "
                    f"{plan['threads']}")
    require_hmma("supertile_attention", op_builder,
                 "supertile_bwd_mma_kernel", 2 * len(padded))
    for D in LN_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            plan = fb.ln_bwd_plan(1, D, dtype)
            for add in (False, True):
                info = fb.ln_bwd_kernel_info(D, dtype, add)
                report_kernel(
                    f"{'add_ln_bwd' if add else 'ln_bwd'} D {D} "
                    f"{dtype_name(dtype)} ({plan['route']}, "
                    f"{plan['warps_per_row']} warps a row)", info)
                if info["dynamic_smem"] != plan["smem_bytes"]:
                    raise AssertionError(
                        f"ln_bwd D {D}: the kernel launches with "
                        f"{info['dynamic_smem']} B, ln_bwd_plan says "
                        f"{plan['smem_bytes']} B")
    report_kernel("ln_bwd_reduce", fb.ln_bwd_reduce_info())


def ln_fwd_build_report(fb):
    """Phase 1's record of the LN forwards (PERF.md's rows 1 and 3): the
    kernel ln_fwd and add_ln_fwd launch at LN_WIDTHS, bf16 and fp32, for
    8 rows (serving's decode) and the GPT training path's PATH_ROWS, the
    route ln_fwd_plan picks; its dynamic shared memory and threads those
    of the plan. Fails on any spill."""
    for D in LN_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            for R in (8, PATH_ROWS):
                plan = fb.ln_fwd_plan(R, D, dtype)
                for add in (False, True):
                    info = fb.ln_fwd_kernel_info(D, dtype, add, R)
                    report_kernel(
                        f"{'add_ln_fwd' if add else 'ln_fwd'} D {D} R {R} "
                        f"{dtype_name(dtype)} ({plan['route']}, "
                        f"{plan['warps_per_row']} warps a row)", info)
                    if (info["dynamic_smem"], info["threads"]) != (
                            plan["smem_bytes"], plan["threads"]):
                        raise AssertionError(
                            f"ln_fwd D {D} R {R}: the kernel launches with "
                            f"{info['dynamic_smem']} B and {info['threads']} "
                            f"threads, ln_fwd_plan says {plan['smem_bytes']} "
                            f"B and {plan['threads']}")


def sm_clock_hz():
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def sass_row_loops(library, nvcc, marker):
    """{kernel function name: (instructions, MUFU instructions)} of the
    longest loop (a backward branch and the instructions from its target)
    in the SASS of each function of a built library whose name holds
    ``marker``: the row loop of the bias+GeLU vector kernels, whose work
    inside is unrolled."""
    tool = Path(nvcc).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(library)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name] = [] if marker in name else None
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and name is not None and funcs[name] is not None:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    loops = {}
    for fn, code in funcs.items():
        if code is None:
            continue
        best = []
        for addr, ins in code:
            br = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)\s*$", ins)
            if br and int(br.group(1), 16) <= addr:
                body = [i for a, i in code if int(br.group(1), 16) <= a <= addr]
                best = max(best, body, key=len)
        loops[fn] = (len(best), sum("MUFU" in i for i in best))
    return loops


def bg_kernel_tag(mangled):
    """(kind, x dtype, b dtype, form) of a bias+GeLU vector kernel's
    mangled name, e.g. bias_gelu_fwd_vec_kernel<bf16, float, true>."""
    m = re.search(r"bias_gelu_(fwd|bwd)_vec_kernelI(13__nv_bfloat16|f)"
                  r"(S\d*_|f)Lb([01])E", mangled)
    x = "bfloat16" if m.group(2) != "f" else "float32"
    b = "float32" if m.group(3) == "f" else x
    return m.group(1), x, b, "tanh" if m.group(4) == "1" else "erf"


def traced_launches(calls, marker):
    """[(kernel name, grid, block, shared memory bytes a block)] of each
    kernel whose name holds ``marker`` that the callables ``calls``, run in
    order, launch: the launches the card ran, in the order it ran them, as
    torch.profiler's trace of them records them (shared memory is the
    static and the dynamic together)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"
                      and marker in e.get("name", "")),
                     key=lambda e: float(e["ts"]))
    return [(e["name"], tuple(e["args"]["grid"]), tuple(e["args"]["block"]),
             e["args"]["shared memory"]) for e in kernels]


def bias_gelu_launch_check(fb, infos, sms):
    """Fails unless the kernels bias_gelu_fwd (8 and PATH_ROWS rows) and
    bias_gelu_bwd (PATH_ROWS rows) launch at BG_WIDTHS, bf16 and fp32, are
    launched as bias_gelu_fwd_plan and bias_gelu_bwd_plan say: grid, block
    and shared memory (the static of ``infos``, the records of phase 1's
    kernel_info by (kind, F, dtype), and the plan's dynamic), read from a
    profile of the wrappers' own calls."""
    calls, want = [], []
    for F in BG_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            for kind, rows in (("fwd", (8, PATH_ROWS)), ("bwd", (PATH_ROWS,))):
                for R in rows:
                    plan = getattr(fb, f"bias_gelu_{kind}_plan")(
                        R, F, dtype, n_sm=sms)
                    grid = ((plan["strips"], plan["row_groups"], 1)
                            if plan["route"] == "vector"
                            else (plan["blocks"], 1, 1))
                    want.append((f"bias_gelu_{kind}", R, F, dtype, grid,
                                 (plan["threads"], 1, 1),
                                 infos[kind, F, dtype]["static_smem"]
                                 + plan.get("smem_bytes", 0)))
                    if kind == "bwd":
                        want.append(("bias_gelu_bwd_reduce", R, F, dtype,
                                     (plan["reduce_blocks"], 1, 1),
                                     (infos["reduce"]["threads"], 1, 1),
                                     infos["reduce"]["static_smem"]))

                    def call(R=R, F=F, dtype=dtype, kind=kind):
                        x = torch.zeros(R, F, dtype=dtype, device="cuda")
                        b = torch.zeros(F, dtype=dtype, device="cuda")
                        if kind == "fwd":
                            fb.bias_gelu_fwd(x, b, True)
                        else:
                            fb.bias_gelu_bwd(x, b, torch.zeros_like(x), True)
                    calls.append(call)
    got = traced_launches(calls, "bias_gelu_")
    if len(got) != len(want):
        raise AssertionError(f"bias_gelu: {len(want)} launches planned, the "
                             f"profile holds {len(got)}: {got[:4]}")
    for (kernel, R, F, dtype, grid, block, smem), (name, *seen) in zip(
            want, got):
        if (f"{kernel}_" not in name or
                tuple(seen) != (grid, block, smem)):
            raise AssertionError(
                f"{kernel} F {F} R {R} {dtype_name(dtype)}: the plan says "
                f"grid {grid}, block {block}, {smem} B of shared memory; "
                f"the card ran {name[:80]} at grid {seen[0]}, block "
                f"{seen[1]}, {seen[2]} B")
    print(f"build: bias_gelu: {len(got)} launches of the wrappers at "
          f"BG_WIDTHS ran with the plans' grid, block and shared memory",
          flush=True)


def bias_gelu_build_report(fb, op_builder):
    """Phase 1's record of the kernels PERF.md's rows 5 and 6 run: the
    kernel bias_gelu_fwd launches at BG_WIDTHS for 8 and PATH_ROWS rows and
    bias_gelu_bwd's first kernel at PATH_ROWS, bf16 and fp32, b in x's
    dtype and in fp32, tanh and erf, and the backward's reduction; fails on
    any spill, and (bias_gelu_launch_check) unless the wrappers' launches
    are the plans'. Then each vector kernel's row loop from its SASS:
    instructions and special-function (MUFU) instructions a 16-byte
    vector, and the issue time (4 warp-instructions a clock an SM) and
    MUFU time (16 lanes a clock an SM) they imply at the path shapes
    beside the byte bound. Returns those records."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    infos = {}
    for F in BG_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            for b_dtype in sorted({dtype, torch.float32}, key=str):
                for approx in (True, False):
                    form = "tanh" if approx else "erf"
                    for kind, rows in (("fwd", (8, PATH_ROWS)),
                                       ("bwd", (PATH_ROWS,))):
                        for R in rows:
                            plan = getattr(fb, f"bias_gelu_{kind}_plan")(
                                R, F, dtype, n_sm=sms)
                            info = getattr(
                                fb, f"bias_gelu_{kind}_kernel_info")(
                                R, F, dtype, b_dtype, approx)
                            report_kernel(
                                f"bias_gelu_{kind} F {F} R {R} "
                                f"{dtype_name(dtype)} b {dtype_name(b_dtype)}"
                                f" {form} ({plan['route']}, "
                                f"{plan['warps_per_block']} warps a block, "
                                f"{plan['blocks']} blocks)", info)
                            if b_dtype == dtype and approx:
                                infos[kind, F, dtype] = info
    infos["reduce"] = fb.bias_gelu_bwd_reduce_info()
    report_kernel("bias_gelu_bwd_reduce", infos["reduce"])
    bias_gelu_launch_check(fb, infos, sms)
    loops = sass_row_loops(op_builder.build_info["fused_blocks"]["path"],
                           op_builder.find_nvcc(), "bias_gelu_")
    vec_loops = {bg_kernel_tag(fn): v for fn, v in loops.items()
                 if "_vec_kernel" in fn}
    if len(vec_loops) != 12 or not all(n for n, _ in vec_loops.values()):
        raise AssertionError(f"expected the row loops of 12 bias+GeLU vector "
                             f"kernels in their SASS, got {vec_loops}")
    clock = sm_clock_hz()
    records = []
    for (kind, x, b, form), (n, mufu) in sorted(vec_loops.items()):
        rec = {"kernel": f"bias_gelu_{kind}", "x": x, "b": b, "form": form,
               "instructions_a_vector": n, "mufu_a_vector": mufu}
        isz = 2 if x == "bfloat16" else 4
        for R, F in ((PATH_ROWS, 8192), (BERT_ROWS, 4096)):
            vectors = R * F * isz // 16
            moved = (2 if kind == "fwd" else 3) * R * F * isz
            rec[f"{R}x{F}"] = {
                "issue_ms": n * vectors / 32 / (4 * sms * clock) * 1e3,
                "mufu_ms": mufu * vectors / (16 * sms * clock) * 1e3,
                "bytes_ms": moved / HBM_BYTES_PER_S * 1e3}
        print(f"build: SASS bias_gelu_{kind}_vec_kernel<{x}, {b}, {form}> "
              f"row loop: " + json.dumps(rec), flush=True)
        records.append(rec)
    return records


def launch_profile(fn, args, calls=20):
    """{kernel name: device ms a call} of the kernels ``calls`` calls of
    ``fn(*args)`` launch, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0][:90]:
            e.self_device_time_total / calls / 1e3
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def bias_gelu_width_cases(fb, gen):
    """bias_gelu_fwd and bias_gelu_bwd at BG_CASES, bf16 and fp32, b in
    x's dtype and in fp32, tanh and erf, on inputs of scale 2 and inputs
    uniform in [-BG_SATURATED, BG_SATURATED]: outputs finite and within
    TOL (10x for gradients) and REL_L2 of the plain versions; each row
    records the route. (16384, 3072) bf16 with b in x's dtype is timed
    ("path": "dp", tanh, as GPT-NeoX-125M runs it)."""
    results = {"bias_gelu_fwd": [], "bias_gelu_bwd": []}
    for R, F, aligned in BG_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            tol, rel = TOL[dtype], REL_L2[dtype]
            isz = torch.tensor([], dtype=dtype).element_size()
            for b_dtype in sorted({dtype, torch.float32}, key=str):
                for approx in (True, False):
                    for scale in (2.0, BG_SATURATED):
                        def case():
                            n = R * F + (0 if aligned else 1)
                            x = ((torch.rand(n, generator=gen, device="cuda")
                                  * 2 - 1) * scale).to(dtype)
                            return (x[n - R * F:].view(R, F),
                                    randn_on(gen, (F,), b_dtype),
                                    randn_on(gen, (R, F), dtype), approx)
                        x, b, g, _ = args = case()
                        tag = (f"{R}x{F} {dtype_name(dtype)} b "
                               f"{dtype_name(b_dtype)} approx={approx} "
                               f"|x|<={scale:g}"
                               f"{'' if aligned else ' unaligned'}")
                        y = fb.bias_gelu_fwd(x, b, approx)
                        dx, db = fb.bias_gelu_bwd(*args)
                        torch.cuda.synchronize()
                        for name, t in (("y", y), ("dx", dx), ("db", db)):
                            if not bool(torch.isfinite(t.float()).all()):
                                raise AssertionError(f"bias_gelu {tag}: {name} "
                                                     f"is not finite")
                        err, rel_err = check_close(
                            f"bias_gelu_fwd {tag}", y,
                            fb.bias_gelu_fwd_plain(x, b, approx), tol, rel)
                        route = fb.bias_gelu_fwd_plan(
                            R, F, dtype, aligned=aligned)["route"]
                        common = {"shape": [R, F], "dtype": dtype_name(dtype),
                                  "b_dtype": dtype_name(b_dtype),
                                  "approximate": approx, "scale": scale,
                                  "aligned": aligned, "route": route}
                        fwd = dict(common, max_abs_err=err, tol=tol,
                                   rel_l2_err=rel_err, rel_l2_tol=rel)
                        err, rel_err = check_outputs(
                            f"bias_gelu_bwd {tag}", ("dx", "db"), (dx, db),
                            fb.bias_gelu_bwd_plain(*args), 10 * tol, rel)
                        bwd = dict(common, max_abs_err=err, tol=10 * tol,
                                   rel_l2_err=rel_err, rel_l2_tol=rel)
                        if ((R, F) == (16384, 3072) and b_dtype == dtype
                                and dtype == torch.bfloat16 and approx
                                and scale != BG_SATURATED):
                            bufs = copies(case, 2 * R * F * isz)
                            fwd.update(timings(fb.bias_gelu_fwd,
                                               fb.bias_gelu_fwd_plain,
                                               [a[:2] + (approx,)
                                                for a in bufs]))
                            fwd.update(path="dp", library=None, **bound(
                                2 * R * F * isz + F * isz, 10 * R * F))
                            bwd.update(timings(fb.bias_gelu_bwd,
                                               fb.bias_gelu_bwd_plain, bufs))
                            bwd.update(path="dp", library=None, **bound(
                                3 * R * F * isz + F * (isz + 4), 20 * R * F))
                            bwd["launch_ms"] = launch_profile(
                                fb.bias_gelu_bwd, args)
                            del bufs
                        results["bias_gelu_fwd"].append(fwd)
                        results["bias_gelu_bwd"].append(bwd)
                        del x, b, g, args, y, dx, db
        torch.cuda.empty_cache()
    return results


def relaunch_same_bits(fb, name, args):
    """Fails unless two launches of ``fb.<name>`` on ``args`` give the
    same bits (every output: y, mean and rstd; dx, dw and db; y; dx and
    db)."""
    kernel = getattr(fb, name)
    first, second = (out if isinstance(out, tuple) else (out,)
                     for out in (kernel(*args), kernel(*args)))
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{name} {tuple(args[0].shape)}: two launches on "
                             f"the same inputs differ")
    return True


def bert_kernel_phase(fb, fs, fa, gen):
    """Phase 7: the add-LN and super-tile pairs against their plain
    versions, and the LN and bias+GeLU kernels at the BERT widths; each
    new kernel and each block kernel timed at its BERT path shape (bf16;
    rows tagged "path": "bert"). At the super-tile pair's path shape the
    flash pair is checked too and timed beside it ("flash_ms")."""
    results = {"add_ln_fwd": [], "add_ln_bwd": [], "supertile_fwd": [],
               "supertile_bwd": [], "ln_fwd": [], "ln_bwd": [],
               "bias_gelu_fwd": [], "bias_gelu_bwd": []}
    for R, D in [(r, 1024) for r in ADD_LN_ROWS] + [(2048, 2048)]:
        for dtype in (torch.bfloat16, torch.float32):
            tol, rel = TOL[dtype], REL_L2[dtype]
            isz = torch.tensor([], dtype=dtype).element_size()
            dname = dtype_name(dtype)
            timed = R == BERT_ROWS and dtype == torch.bfloat16

            def case():
                return (randn_on(gen, (R, D), dtype, 2.0, 0.5),
                        randn_on(gen, (R, D), dtype),
                        randn_on(gen, (D,), torch.float32, 0.1, 1.0),
                        randn_on(gen, (D,), torch.float32, 0.1), 1e-12)

            x, r, w, b, eps = case()
            y, mu, rs = fb.add_ln_fwd(x, r, w, b, eps)
            torch.cuda.synchronize()
            py, pmu, prs = fb.add_ln_fwd_plain(x, r, w, b, eps)
            tag = f"{R}x{D} {dname}"
            err, rel_err = check_close(f"add_ln_fwd {tag}", y, py, tol, rel)
            check_close(f"add_ln_fwd mean {tag}", mu, pmu, 2e-5, rel)
            check_close(f"add_ln_fwd rstd {tag}", rs, prs, 2e-5, rel)
            fwd = {"shape": [R, D], "dtype": dname, "max_abs_err": err,
                   "tol": tol, "rel_l2_err": rel_err, "rel_l2_tol": rel}
            g = randn_on(gen, (R, D), dtype)
            got = fb.add_ln_bwd(x, r, w, pmu, prs, g)
            torch.cuda.synchronize()
            want = fb.add_ln_bwd_plain(x, r, w, pmu, prs, g)
            err, rel_err = check_outputs(f"add_ln_bwd {tag}",
                                         ("ds", "dw", "db"), got, want,
                                         10 * tol, rel)
            bwd = {"shape": [R, D], "dtype": dname, "max_abs_err": err,
                   "tol": 10 * tol, "rel_l2_err": rel_err, "rel_l2_tol": rel}
            if timed:
                fwd["bit_identical_relaunch"] = relaunch_same_bits(
                    fb, "add_ln_fwd", (x, r, w, b, eps))
                bwd["bit_identical_relaunch"] = relaunch_same_bits(
                    fb, "add_ln_bwd", (x, r, w, pmu, prs, g))
                bufs = copies(case, 2 * R * D * isz)
                fwd.update(timings(fb.add_ln_fwd, fb.add_ln_fwd_plain, bufs))
                fwd.update(path="bert", library=None, **bound(
                    3 * R * D * isz + 2 * D * 4 + 2 * R * 4, 9 * R * D))

                def bcase():
                    x_, r_, w_, b_, e_ = case()
                    _, m_, s_ = fb.add_ln_fwd_plain(x_, r_, w_, b_, e_)
                    return x_, r_, w_, m_, s_, randn_on(gen, (R, D), dtype)

                bbufs = copies(bcase, 3 * R * D * isz)
                bwd.update(timings(fb.add_ln_bwd, fb.add_ln_bwd_plain,
                                   bbufs))
                bwd.update(path="bert", library=None, **bound(
                    4 * R * D * isz + 8 * R + 12 * D, 15 * R * D))
                del bufs, bbufs
            results["add_ln_fwd"].append(fwd)
            results["add_ln_bwd"].append(bwd)
            del x, r, g, y, got, want

    for si, shape in enumerate(SUPERTILE_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            ftol, gtol = FLASH_TOL[dtype]
            rel = REL_L2[dtype]
            dname = dtype_name(dtype)
            scale = 1.0 / math.sqrt(shape[-1])
            for causal in (False, True):
                q, k, v, do = (randn_on(gen, shape, dtype) for _ in range(4))
                o, lse = fs.supertile_fwd(q, k, v, scale, causal)
                torch.cuda.synchronize()
                po, plse = fs.supertile_fwd_plain(q, k, v, scale, causal)
                tag = f"{tuple(shape)} {dname} causal={causal}"
                err, rel_err = check_outputs(f"supertile_fwd {tag}",
                                             ("o", "lse"), (o, lse),
                                             (po, plse), ftol, rel)
                fwd = {"shape": list(shape), "dtype": dname,
                       "causal": causal, "max_abs_err": err, "tol": ftol,
                       "rel_l2_err": rel_err, "rel_l2_tol": rel}
                got = fs.supertile_bwd(q, k, v, po, plse, do, scale, causal)
                torch.cuda.synchronize()
                want = fs.supertile_bwd_plain(q, k, v, po, plse, do, scale,
                                              causal)
                err, rel_err = check_outputs(f"supertile_bwd {tag}",
                                             ("dq", "dk", "dv"), got, want,
                                             gtol, rel)
                bwd = {"shape": list(shape), "dtype": dname,
                       "causal": causal, "max_abs_err": err, "tol": gtol,
                       "rel_l2_err": rel_err, "rel_l2_tol": rel}
                del got, want
                if si == 0 and not causal and dtype == torch.bfloat16:
                    again = fs.supertile_fwd(q, k, v, scale, causal)
                    if not (torch.equal(again[0], o)
                            and torch.equal(again[1], lse)):
                        raise AssertionError(f"supertile_fwd {tag}: two "
                                             f"launches on the same inputs "
                                             f"differ")
                    fwd["bit_identical_relaunch"] = True
                    again = fs.supertile_bwd(q, k, v, po, plse, do, scale,
                                             causal)
                    first = fs.supertile_bwd(q, k, v, po, plse, do, scale,
                                             causal)
                    if not all(torch.equal(a, b)
                               for a, b in zip(first, again)):
                        raise AssertionError(f"supertile_bwd {tag}: two "
                                             f"launches on the same inputs "
                                             f"differ")
                    bwd["bit_identical_relaunch"] = True
                    del again, first

                    def case():
                        t = [randn_on(gen, shape, dtype) for _ in range(4)]
                        o_, lse_ = fs.supertile_fwd_plain(*t[:3], scale,
                                                          False)
                        return t[:3] + [o_, lse_, t[3]]

                    bufs = copies(case, flash_work(shape, False, dtype,
                                                   False)[0])
                    fwd_bufs = [(a[0], a[1], a[2], scale, False)
                                for a in bufs]
                    sdpa = torch.nn.functional.scaled_dot_product_attention
                    fwd.update(timings(
                        fs.supertile_fwd, fs.supertile_fwd_plain, fwd_bufs,
                        lambda a, b, c, *_: sdpa(a, b, c), fwd_bufs,
                        iters=10, replays=3))
                    fwd.update(path="bert",
                               library="F.scaled_dot_product_attention",
                               **bound(*flash_work(shape, False, dtype,
                                                   False), BF16_OPS_PER_S))
                    bwd_bufs = [tuple(a) + (scale, False) for a in bufs]
                    lib_bufs = [sdpa_backward_args(a[0], a[1], a[2], a[5],
                                                   scale, False)
                                for a in bufs]
                    bwd.update(timings(fs.supertile_bwd,
                                       fs.supertile_bwd_plain, bwd_bufs,
                                       sdpa_backward, lib_bufs, iters=10,
                                       replays=3))
                    bwd.update(path="bert",
                               library=("aten._scaled_dot_product_flash_"
                                        "attention_backward"),
                               **bound(*flash_work(shape, False, dtype,
                                                   True), BF16_OPS_PER_S))
                    # the flash pair, which took this shape before the
                    # super-tile route existed (GPT below S = 256), held
                    # against the same plain versions and timed beside it
                    fo, flse = fa.flash_fwd(q, k, v, scale, False)
                    torch.cuda.synchronize()
                    check_outputs(f"flash_fwd {tag}", ("o", "lse"),
                                  (fo, flse), (po, plse), ftol, rel)
                    fgot = fa.flash_bwd(q, k, v, po, plse, do, scale, False)
                    torch.cuda.synchronize()
                    check_outputs(f"flash_bwd {tag}", ("dq", "dk", "dv"),
                                  fgot, fs.supertile_bwd_plain(
                                      q, k, v, po, plse, do, scale, False),
                                  gtol, rel)
                    del fo, flse, fgot
                    fwd["flash_ms"], fwd["flash_eager_ms"] = time_ms(
                        fa.flash_fwd, fwd_bufs, 10, 3)
                    bwd["flash_ms"], bwd["flash_eager_ms"] = time_ms(
                        fa.flash_bwd, bwd_bufs, 10, 3)
                    del bufs, fwd_bufs, bwd_bufs, lib_bufs
                results["supertile_fwd"].append(fwd)
                results["supertile_bwd"].append(bwd)
                del q, k, v, do, o, lse, po, plse
        torch.cuda.empty_cache()

    # the block kernels at the BERT widths: LN on the embedding (8192 rows)
    # and in the MLM head (4096 rows), erf bias+GeLU in the FFN (8192 x
    # 4096) and the head (4096 x 1024); timed at the first of each
    for R, D, timed in ((BERT_ROWS, 1024, True), (BERT_HEAD_ROWS, 1024,
                                                  False)):
        for dtype in (torch.bfloat16, torch.float32):
            tol, rel = TOL[dtype], REL_L2[dtype]
            isz = torch.tensor([], dtype=dtype).element_size()
            dname = dtype_name(dtype)
            timed_here = timed and dtype == torch.bfloat16

            def ln_case():
                x_ = randn_on(gen, (R, D), dtype, 2.0, 0.5)
                w_ = randn_on(gen, (D,), torch.float32, 0.1, 1.0)
                b_ = randn_on(gen, (D,), torch.float32, 0.1)
                return x_, w_, b_, 1e-12

            x, w, b, eps = ln_case()
            y, mu, rs = fb.ln_fwd(x, w, b, eps)
            torch.cuda.synchronize()
            py, pmu, prs = fb.ln_fwd_plain(x, w, b, eps)
            tag = f"{R}x{D} {dname}"
            err, rel_err = check_close(f"ln_fwd {tag}", y, py, tol, rel)
            check_close(f"ln_fwd mean {tag}", mu, pmu, 2e-5, rel)
            check_close(f"ln_fwd rstd {tag}", rs, prs, 2e-5, rel)
            row = {"shape": [R, D], "dtype": dname, "max_abs_err": err,
                   "tol": tol, "rel_l2_err": rel_err, "rel_l2_tol": rel}
            if timed_here:
                row["bit_identical_relaunch"] = relaunch_same_bits(
                    fb, "ln_fwd", (x, w, b, eps))
                bufs = copies(ln_case, R * D * isz)
                lib_bufs = [(xx, (D,), ww.to(dtype), bb.to(dtype), e)
                            for xx, ww, bb, e in bufs]
                row.update(timings(fb.ln_fwd, fb.ln_fwd_plain, bufs,
                                   torch.nn.functional.layer_norm, lib_bufs))
                row.update(path="bert", **bound(
                    2 * R * D * isz + 2 * D * 4 + 2 * R * 4, 8 * R * D))
                del bufs, lib_bufs
            results["ln_fwd"].append(row)
            g = randn_on(gen, (R, D), dtype)
            got = fb.ln_bwd(x, w, pmu, prs, g)
            torch.cuda.synchronize()
            want = fb.ln_bwd_plain(x, w, pmu, prs, g)
            err, rel_err = check_outputs(f"ln_bwd {tag}", ("dx", "dw", "db"),
                                         got, want, 10 * tol, rel)
            row = {"shape": [R, D], "dtype": dname, "max_abs_err": err,
                   "tol": 10 * tol, "rel_l2_err": rel_err, "rel_l2_tol": rel}
            if timed_here:
                row["bit_identical_relaunch"] = relaunch_same_bits(
                    fb, "ln_bwd", (x, w, pmu, prs, g))

                def lnb_case():
                    x_, w_, b_, e_ = ln_case()
                    _, m_, s_ = fb.ln_fwd_plain(x_, w_, b_, e_)
                    return x_, w_, m_, s_, randn_on(gen, (R, D), dtype)

                bufs = copies(lnb_case, 2 * R * D * isz)
                lib_bufs = [(gg, xx, (D,), m_[:, None], s_[:, None],
                             ww.to(dtype), ww.to(dtype), [True, True, True])
                            for xx, ww, m_, s_, gg in bufs]
                row.update(timings(fb.ln_bwd, fb.ln_bwd_plain, bufs,
                                   torch.ops.aten.native_layer_norm_backward,
                                   lib_bufs))
                row.update(path="bert",
                           library="aten.native_layer_norm_backward",
                           **bound(3 * R * D * isz + 8 * R + 12 * D,
                                   13 * R * D))
                del bufs, lib_bufs
            results["ln_bwd"].append(row)

            Fd = 4096 if timed else 1024
            rows_bg = R
            # bias+GeLU is timed at the FFN's and the MLM head's shape
            bg_timed = dtype == torch.bfloat16
            bg_path = "bert" if timed else "bert-head"

            def bg_case():
                return (randn_on(gen, (rows_bg, Fd), dtype, 2.0),
                        randn_on(gen, (Fd,), dtype),
                        randn_on(gen, (rows_bg, Fd), dtype), False)

            h, hb, hg, approx = bg_case()
            y = fb.bias_gelu_fwd(h, hb, approx)
            torch.cuda.synchronize()
            tag = f"{rows_bg}x{Fd} {dname} approx=False"
            err, rel_err = check_close(f"bias_gelu_fwd {tag}", y,
                                       fb.bias_gelu_fwd_plain(h, hb, approx),
                                       tol, rel)
            row = {"shape": [rows_bg, Fd], "dtype": dname,
                   "approximate": False, "max_abs_err": err, "tol": tol,
                   "rel_l2_err": rel_err, "rel_l2_tol": rel}
            if timed_here:
                row["bit_identical_relaunch"] = relaunch_same_bits(
                    fb, "bias_gelu_fwd", (h, hb, approx))
            if bg_timed:
                bufs = copies(lambda: bg_case()[:2] + (False,),
                              rows_bg * Fd * isz)
                row.update(timings(fb.bias_gelu_fwd, fb.bias_gelu_fwd_plain,
                                   bufs))
                row.update(path=bg_path, library=None, **bound(
                    2 * rows_bg * Fd * isz + Fd * isz, 10 * rows_bg * Fd))
                del bufs
            results["bias_gelu_fwd"].append(row)
            got = fb.bias_gelu_bwd(h, hb, hg, approx)
            torch.cuda.synchronize()
            want = fb.bias_gelu_bwd_plain(h, hb, hg, approx)
            err, rel_err = check_outputs(f"bias_gelu_bwd {tag}", ("dx", "db"),
                                         got, want, 10 * tol, rel)
            row = {"shape": [rows_bg, Fd], "dtype": dname,
                   "approximate": False, "max_abs_err": err,
                   "tol": 10 * tol, "rel_l2_err": rel_err, "rel_l2_tol": rel}
            if timed_here:
                row["bit_identical_relaunch"] = relaunch_same_bits(
                    fb, "bias_gelu_bwd", (h, hb, hg, approx))
                row["launch_ms"] = launch_profile(fb.bias_gelu_bwd,
                                                  (h, hb, hg, approx))
            if bg_timed:
                bufs = copies(bg_case, 2 * rows_bg * Fd * isz)
                row.update(timings(fb.bias_gelu_bwd, fb.bias_gelu_bwd_plain,
                                   bufs))
                row.update(path=bg_path, library=None, **bound(
                    3 * rows_bg * Fd * isz + Fd * (isz + 4),
                    20 * rows_bg * Fd))
                del bufs
            results["bias_gelu_bwd"].append(row)
            del x, g, h, hg, got, want
        torch.cuda.empty_cache()
    return results


def bf16_ulps(got, want):
    """Elementwise distance in bf16 ulps (sign-magnitude bits mapped to a
    monotone integer line, so +0 and -0 are 0 apart)."""
    def line(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (line(got) - line(want)).abs()


def check_adam_outputs(name, got, want):
    """Gates of one fused Adam case: fp32 outputs within atol = rtol =
    ADAM_TOL, bf16 ones within one ulp, every output within REL_L2 of its
    dtype. Returns (max abs error, max relative L2 error, elements that
    differ at all, elements compared)."""
    errs, rels, differ, total = [0.0], [0.0], 0, 0
    for kind, a_list, b_list in zip(("p", "g", "m", "v", "cast"), got, want):
        for i, (a, b) in enumerate(zip(a_list or (), b_list or ())):
            tag = f"{name} {kind}[{i}] {dtype_name(a.dtype)}"
            differ += int((a.view(-1) != b.view(-1)).sum())
            total += a.numel()
            if a.dtype == torch.bfloat16:
                ulps = int(bf16_ulps(a, b).max()) if a.numel() else 0
                if ulps > 1:
                    raise AssertionError(f"{tag}: {ulps} bf16 ulps apart")
                diff = a.float() - b.float()
                rel = float(diff.norm() / b.float().norm().clamp_min(1e-30))
                if not rel <= REL_L2[torch.bfloat16]:
                    raise AssertionError(f"{tag}: relative L2 error {rel}")
                errs.append(float(diff.abs().max()) if a.numel() else 0.0)
                rels.append(rel)
            else:
                e, r = check_close(tag, a, b, ADAM_TOL, REL_L2[torch.float32])
                errs.append(e)
                rels.append(r)
    return max(errs), max(rels), differ, total


def adam_state(gen, shapes, pdt, mdt, vdt, cdt):
    """(ps, gs, ms, vs, cs) on the card: params and grads N(0, 1), first
    moments N(0, 0.1), second moments |N(0, 1e-3)|."""
    def make(shape, dtype, scale=1.0, positive=False):
        t = torch.randn(shape, generator=gen, device="cuda") * scale
        return (t.abs() if positive else t).to(dtype)

    return ([make(s, pdt) for s in shapes], [make(s, pdt) for s in shapes],
            [make(s, mdt, 0.1) for s in shapes],
            [make(s, vdt, 1e-3, True) for s in shapes],
            None if cdt is None else [torch.empty(s, dtype=cdt,
                                                  device="cuda")
                                      for s in shapes])


def adam_case(fad, gen, name, shapes, combo, hyper):
    """ADAM_STEPS steps of the kernel and of its plain version from the
    same state; returns the row of the case and the kernel's state."""
    adam_w, wd, bias_correction = hyper
    got = adam_state(gen, shapes, *combo)
    want = tuple(None if x is None else [t.clone() for t in x] for x in got)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, wd=wd, adam_w=adam_w)
    for step in range(1, ADAM_STEPS + 1):
        scal = fad.adam_scalars(1e-3, step, 0.9, 0.95, bias_correction)
        fad.fused_adam(*got, *scal, **kw)
        fad.adam_plain(*want, *scal, **kw)
    torch.cuda.synchronize()
    err, rel, differ, total = check_adam_outputs(name, got, want)
    dnames = [dtype_name(d) if d is not None else None for d in combo]
    row = {"case": name, "shape": [sum(math.prod(x) for x in shapes)],
           "leaves": len(shapes), "dtype": dnames[0], "dtypes": dnames,
           "adam_w": adam_w, "weight_decay": wd,
           "bias_correction": bias_correction, "steps": ADAM_STEPS,
           "max_abs_err": err, "tol": ADAM_TOL, "rel_l2_err": rel,
           "rel_l2_tol": REL_L2[combo[0]], "elements_differing": differ,
           "elements": total}
    del want
    return row, got


def library_adam(state, lr, steps):
    """torch._fused_adam_ over the same lists (no weight decay, no cast;
    its eps sits outside the bias-corrected sqrt, sqrt(v)/sqrt(bc2) +
    eps, where the reference's is sqrt(v / bc2) + eps)."""
    ps, gs, ms, vs, _ = state
    torch._fused_adam_(ps, gs, ms, vs, [], steps, lr=lr, beta1=0.9,
                       beta2=0.95, weight_decay=0.0, eps=1e-8, amsgrad=False,
                       maximize=False)


def adam_phase(fad, gen):
    """Phase 9: the fused Adam kernel against its plain version, small
    cases in every dtype combination the engine builds, then the
    GPT-NeoX-1.3B leaf list (16 leaves, 1,414,647,808 parameters) as the
    masterless path builds it (bf16 p, g, m, v) and as a master path does
    (fp32 p, g, m, v and a bf16 cast); both timed beside their bound,
    the plain version and torch._fused_adam_."""
    from deeperspeed_tpu_torch.models.gpt import get_preset, param_shapes
    from deeperspeed_tpu_torch.ops.adam import tree_leaves
    from deeperspeed_tpu_torch.ops.fused_adam import KERNEL_COMBOS

    rows = []
    for combo in KERNEL_COMBOS:
        for hyper in ADAM_HYPER:
            row, _ = adam_case(fad, gen, "small", ADAM_SMALL_SHAPES, combo,
                               hyper)
            rows.append(row)
    shapes = [tuple(s) for s in tree_leaves(
        param_shapes(get_preset("neox-1.3b")))]
    n = sum(math.prod(x) for x in shapes)
    if (len(shapes), n) != (16, 1414647808):
        raise AssertionError(f"GPT-NeoX-1.3B leaf list: {len(shapes)} "
                             f"leaves, {n} parameters")
    for name, combo, per_param in (
            ("gpt-masterless", KERNEL_COMBOS[0], 14),
            ("gpt-master", KERNEL_COMBOS[3], 30)):
        row, state = adam_case(fad, gen, name, shapes, combo,
                               (True, 0.0, True))
        scal = fad.adam_scalars(1e-3, ADAM_STEPS + 1, 0.9, 0.95, True)
        kw = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.0, adam_w=True)
        steps = [torch.full((), float(ADAM_STEPS), device="cuda")
                 for _ in shapes]
        row.update(timings(
            lambda st: fad.fused_adam(*st, *scal, **kw),
            lambda st: fad.adam_plain(*st, *scal, **kw), [(state,)],
            lambda st: library_adam(st, 1e-3, steps), [(state,)],
            iters=10, replays=3))
        row.update(path="gpt" if name == "gpt-masterless" else "gpt-master",
                   library="torch._fused_adam_",
                   **bound(per_param * n, 14 * n))
        rows.append(row)
        del state, steps
        gc.collect()
        torch.cuda.empty_cache()
    return {"fused_adam": rows}


def sparse_work(lut, B, Dh, dtype, backward):
    """(bytes, operations) the sparse forward or backward must do on this
    layout: each input read once, each output written once (a key mask,
    where there is one, is not counted); the products over the (query,
    key) pairs the filtered layout keeps, the lower triangle of each
    diagonal block under causal."""
    lay = lut.layout
    blk = lut.block
    H, nb, _ = lay.shape
    S = nb * blk
    active = int(lay.sum())
    diag = int(lay[:, np.arange(nb), np.arange(nb)].sum()) if lut.causal \
        else 0
    pairs = B * ((active - diag) * blk * blk + diag * blk * (blk + 1) // 2)
    isz = torch.tensor([], dtype=dtype).element_size()
    tensor = B * H * S * Dh * isz
    rows = B * H * S * 4
    if backward:  # q, k, v, o, do, lse in; dq, dk, dv out; 5 products
        return 8 * tensor + rows, 5 * 2 * pairs * Dh
    return 4 * tensor + rows, 2 * 2 * pairs * Dh


def eager_ms(fn, args_list, iters=10):
    """Device ms per call of ``fn`` launched one by one from Python, timed
    with CUDA events: for a library call whose backward runs through
    autograd, which a CUDA graph capture is not asked to hold."""
    for args in args_list[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sparse_case(bs, gen, tag, lut, shape, dtype, kpm=None):
    """sparse_fwd and sparse_bwd on one case against their plain versions:
    (forward row, backward row, the case's tensors: q, k, v, the plain o
    and lse, do, then the kernel's o and lse). lse is held on the rows
    with a visible key; the others must be NEG_INF in both. The elements
    of each kernel's outputs that differ from the plain version at all
    are counted."""
    ftol, gtol = FLASH_TOL[dtype]
    rel = REL_L2[dtype]
    scale = shape[-1] ** -0.5
    dev = lut.on("cuda")
    q, k, v, do = (randn_on(gen, shape, dtype) for _ in range(4))
    o, lse = bs.sparse_fwd(q, k, v, dev, scale, lut.causal, kpm)
    torch.cuda.synchronize()
    po, plse = bs.sparse_fwd_plain(q, k, v, dev.layout, lut.block, scale,
                                   lut.causal, kpm)
    alive = plse > bs.NEG_INF / 2
    if not bool((lse[~alive] == bs.NEG_INF).all()) or not bool(
            (o.float()[~alive] == 0).all()):
        raise AssertionError(f"sparse_fwd {tag}: a row with no visible key "
                             f"is not zero with lse = NEG_INF")
    err, rel_err = check_outputs(f"sparse_fwd {tag}", ("o", "lse"),
                                 (o, lse[alive]), (po, plse[alive]), ftol,
                                 rel)
    meta = {"layout": tag, "shape": list(shape), "dtype": dtype_name(dtype),
            "block": lut.block, "causal": lut.causal,
            "masked": kpm is not None, "active_blocks": lut.active_blocks,
            "empty_rows": int((~alive).sum())}
    fwd = dict(meta, max_abs_err=err, tol=ftol, rel_l2_err=rel_err,
               rel_l2_tol=rel,
               elements_differing=int((o != po).sum())
               + int((lse[alive] != plse[alive]).sum()),
               elements=o.numel() + int(alive.sum()))
    got = bs.sparse_bwd(q, k, v, po, plse, do, dev, scale, lut.causal, kpm)
    torch.cuda.synchronize()
    want = bs.sparse_bwd_plain(q, k, v, po, plse, do, dev.layout, lut.block,
                               scale, lut.causal, kpm)
    err, rel_err = check_outputs(f"sparse_bwd {tag}", ("dq", "dk", "dv"),
                                 got, want, gtol, rel)
    bwd = dict(meta, max_abs_err=err, tol=gtol, rel_l2_err=rel_err,
               rel_l2_tol=rel,
               elements_differing=sum(int((a != b).sum())
                                      for a, b in zip(got, want)),
               elements=sum(a.numel() for a in got))
    return fwd, bwd, (q, k, v, po, plse, do, o, lse)


def one_tile_groups(groups):
    """A backward group table (rows of four tile ids, offset, length) with
    every tile in a group of its own, longest list first."""
    rows = [[t, -1, -1, -1, g[4], g[5]] for g in groups.tolist()
            for t in g[:4] if t >= 0]
    rows.sort(key=lambda r: -r[5])
    return torch.tensor(rows, dtype=torch.int32, device=groups.device)


def time_sparse(bs, sk, gen, lut, shape, dtype, fwd, bwd,
                one_tile_walks=False):
    """Device ms of the pair, its plain versions and SDPA with the
    expanded boolean mask (forward by CUDA-graph replay; its backward
    through autograd, launched eagerly), beside each one's bound; with
    ``one_tile_walks`` also sparse_bwd over one-tile groups."""
    B, _, S, Dh = shape
    scale = Dh ** -0.5
    dev = lut.on("cuda")
    causal = lut.causal
    mask = sk.dense_mask(dev.layout, lut.block, S, causal, "cuda")[None]

    def case():
        t = [randn_on(gen, shape, dtype) for _ in range(4)]
        o_, lse_ = bs.sparse_fwd_plain(*t[:3], dev.layout, lut.block, scale,
                                       causal)
        return t[:3] + [o_, lse_, t[3]]

    fwork = sparse_work(lut, B, Dh, dtype, False)
    bwork = sparse_work(lut, B, Dh, dtype, True)
    bufs = copies(case, fwork[0])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd.update(timings(
        lambda q, k, v, *_: bs.sparse_fwd(q, k, v, dev, scale, causal),
        lambda q, k, v, *_: bs.sparse_fwd_plain(q, k, v, dev.layout,
                                                lut.block, scale, causal),
        bufs, lambda q, k, v, *_: sdpa(q, k, v, attn_mask=mask, scale=scale),
        bufs, iters=10, replays=3))
    fwd.update(library="F.scaled_dot_product_attention(attn_mask=the "
               "expanded layout)", **bound(*fwork, BF16_OPS_PER_S))
    bwd.update(timings(
        lambda q, k, v, o, lse, do: bs.sparse_bwd(q, k, v, o, lse, do, dev,
                                                  scale, causal),
        lambda q, k, v, o, lse, do: bs.sparse_bwd_plain(
            q, k, v, o, lse, do, dev.layout, lut.block, scale, causal),
        bufs, iters=10, replays=3))
    if one_tile_walks:
        # the same kernels over groups of one tile each: every warp walks
        # its list alone, sharing no gathered tile (the groups' yardstick)
        solo = dev._replace(q_groups=one_tile_groups(dev.q_groups),
                            kv_groups=one_tile_groups(dev.kv_groups))
        fwd["one_tile_groups_ms"], _ = time_ms(
            lambda q, k, v, *_: bs.sparse_fwd(q, k, v, solo, scale, causal),
            bufs, 10, 3)
        bwd["one_tile_groups_ms"], _ = time_ms(
            lambda q, k, v, o, lse, do: bs.sparse_bwd(q, k, v, o, lse, do,
                                                      solo, scale, causal),
            bufs, 10, 3)
    lib_bufs = []
    for q, k, v, _, _, do in bufs[:2]:
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_bufs.append((sdpa(*leaves, attn_mask=mask, scale=scale), leaves,
                         do))
    bwd["library_ms"] = eager_ms(
        lambda out, leaves, do: torch.autograd.grad(out, leaves, do,
                                                    retain_graph=True),
        lib_bufs)
    bwd.update(library="the backward of F.scaled_dot_product_attention("
               "attn_mask=the expanded layout) through autograd, launched "
               "eagerly",
               **bound(*bwork, BF16_OPS_PER_S))
    del bufs, lib_bufs, mask


def sparse_phase(bs, gen):
    """Phase 11: the block-sparse pair against its plain versions at the
    path shape (1, 16, 4096, 64) bf16 over SPARSE_LAYOUTS (two of them
    also at S 8192), each timed; then the SPARSE_SMALL cases and an empty
    layout row in bf16 and fp32; then the errors a wrong head count, a
    wrong length and an unsupported block must raise. The path's layout
    rows are tagged "path": "sparse"."""
    from deeperspeed_tpu_torch.ops import sparse_attention as sa
    from deeperspeed_tpu_torch.ops.sparse_attention import kernels as sk

    results = {"sparse_fwd": [], "sparse_bwd": []}
    for name, make, causal, long in SPARSE_LAYOUTS:
        for S in (SPARSE_SEQ, SPARSE_LONG_SEQ) if long else (SPARSE_SEQ,):
            cfg = make(sa)
            lut = sk.SparseLut(cfg.make_layout(S), cfg.block, causal)
            shape = (1, SPARSE_HEADS, S, SPARSE_DH)
            fwd, bwd, tensors = sparse_case(bs, gen, name, lut, shape,
                                            torch.bfloat16)
            if name == "fixed-path":
                dev = lut.on("cuda")
                scale = SPARSE_DH ** -0.5
                q, k, v, _, _, _, o, lse = tensors
                again = bs.sparse_fwd(q, k, v, dev, scale, lut.causal)
                if not (torch.equal(again[0], o)
                        and torch.equal(again[1], lse)):
                    raise AssertionError(f"sparse_fwd {name}: two launches "
                                         f"on the same inputs differ")
                fwd["bit_identical_relaunch"] = True
                first, second = (bs.sparse_bwd(*tensors[:6], dev, scale,
                                               lut.causal)
                                 for _ in range(2))
                if not all(torch.equal(a, b) for a, b in zip(first, second)):
                    raise AssertionError(f"sparse_bwd {name}: two launches "
                                         f"on the same inputs differ")
                bwd["bit_identical_relaunch"] = True
                del first, second, again
            del tensors
            fwd["density"] = bwd["density"] = sa.layout_density(lut.layout)
            time_sparse(bs, sk, gen, lut, shape, torch.bfloat16, fwd, bwd,
                        one_tile_walks=name == "fixed-path")
            if name == "fixed-path":
                fwd["path"] = bwd["path"] = "sparse"
            results["sparse_fwd"].append(fwd)
            results["sparse_bwd"].append(bwd)
            gc.collect()
            torch.cuda.empty_cache()
    empty = np.ones((4, 32, 32), np.int64)
    empty[:, 3] = 0
    empty[1, 10:20] = 0
    small = [(name, make(sa).make_layout(S), make(sa).block, S, Dh, causal,
              masked) for name, make, S, Dh, causal, masked in SPARSE_SMALL]
    small.append(("empty-rows", empty, 16, 512, 64, False, False))
    for name, layout, blk, S, Dh, causal, masked in small:
        lut = sk.SparseLut(layout, blk, causal)
        kpm = None
        if masked:
            kpm = torch.zeros(2, S, device="cuda")
            kpm[:, 3 * S // 4:] = bs.NEG_INF
        for dtype in (torch.bfloat16, torch.float32):
            fwd, bwd, _ = sparse_case(bs, gen, name, lut,
                                      (2, 4, S, Dh), dtype, kpm)
            if name in ("empty-rows", "local-uni-128-masked") and \
                    fwd["empty_rows"] == 0:
                raise AssertionError(f"sparse {name}: no empty row to check")
            results["sparse_fwd"].append(fwd)
            results["sparse_bwd"].append(bwd)
    layout = sa.sparsity_config_from_dict(4, SPARSE_BLOCK).make_layout(512)
    attend = sa.make_block_sparse_attention(layout, 16)
    errors = {}
    for what, shape in (("head count", (1, 512, 8, 64)),
                        ("length", (1, 256, 4, 64))):
        x = torch.zeros(shape, device="cuda", dtype=torch.bfloat16)
        try:
            attend(x, x, x)
        except ValueError as e:
            errors[what] = str(e)
        else:
            raise AssertionError(f"sparse attention took a wrong {what}")
    x = torch.zeros(1, 4, 512, 64, device="cuda", dtype=torch.bfloat16)
    block8 = sa.SparseSelfAttention(
        sa.BigBirdSparsityConfig(num_heads=4, block=8), max_seq_length=512)
    try:
        block8(x, x, x)
    except ValueError as e:
        errors["block 8"] = str(e)
    else:
        raise AssertionError("sparse attention took block 8 on the card")
    print("sparse errors raised: " + json.dumps(errors), flush=True)
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


def serving_phase(fb, card, obs):
    from deeperspeed_tpu_torch.models.generation import init_cache
    from deeperspeed_tpu_torch.models.gpt import get_preset, init_params
    from deeperspeed_tpu_torch.ops import kernel_config
    from deeperspeed_tpu_torch.runtime.config_utils import load_config
    from deeperspeed_tpu_torch.serving import FINISH_LENGTH, ServingEngine
    from deeperspeed_tpu_torch.serving.metrics import DECODE_TIMER

    config = load_config(json.dumps({
        "kernels": {"mode": "auto"},
        "serving": {"num_slots": 8, "block_size": 16, "num_blocks": 1024,
                    "max_seq_len": 1024, "slo": SERVING_SLO},
        "monitor": dict(SERVING_MONITOR, obs_dir=str(obs)),
    }))
    kernel_config.configure(**kernel_config.validate(config["kernels"]))
    cfg = get_preset("neox-1.3b", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(gen, cfg, device="cuda", dtype=torch.bfloat16)
    randomize_affine(params, gen)
    engine = ServingEngine(cfg, params, config["serving"],
                           monitor_config=config["monitor"])

    lens = [16, 40, 100, 220, 380, 550, 730, 900]
    host = torch.Generator().manual_seed(SEED)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=host).tolist()
               for n in lens]
    new = 32

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    telemetry = serving_telemetry(engine, rids)

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
        "first_token_logits": logit_errs, "telemetry": telemetry,
    }
    print("serving: " + json.dumps(report), flush=True)
    print("decode profile: " + json.dumps(profile_decode(engine, prompts)),
          flush=True)
    return launches


def serving_telemetry(engine, rids):
    """The serving run's monitor, read after the main path: the
    reference's serving/* spans and instants in a trace that passes strict
    validation, the SLO and serving metrics in the registry (and over
    HTTP), a request ledger with every request, the cost index's records
    free of errors and the decode step's MFU, and a silent watchdog."""
    import urllib.request

    from deeperspeed_tpu_torch.monitor import reqledger, validate_events

    mon = engine.telemetry
    events = mon.tracer.to_dict()["traceEvents"]
    names = {e["name"] for e in events}
    missing = SERVING_EVENTS - names
    problems = validate_events(events, strict=True)
    if missing or problems:
        raise AssertionError(f"serving trace: missing {sorted(missing)}, "
                             f"problems {problems[:5]}")
    with urllib.request.urlopen(mon.metrics_server.url, timeout=10) as r:
        scraped = r.read().decode()
    absent = [m for m in SERVING_METRICS if f"\n{m}" not in scraped]
    if absent:
        raise AssertionError(f"serving metrics {absent} not on the endpoint")
    ledger = reqledger.build_ledger(events)
    if sorted(ledger["requests"]) != sorted(rids) or \
            ledger["ttft"]["count"] != len(rids):
        raise AssertionError(f"request ledger covers "
                             f"{sorted(ledger['requests'])}, expected "
                             f"{sorted(rids)}")
    records = mon.cost_index.records()
    failed = {k: r.error for k, r in records.items() if r.error}
    if failed or "serving/decode_step" not in records:
        raise AssertionError(f"serving cost records: {sorted(records)}, "
                             f"failed {failed}")
    if mon.watchdog.fired:
        raise AssertionError(f"the decode step met a new signature: "
                             f"{mon.watchdog.fired}")
    mfu = [e["args"]["mfu"] for e in events if e["name"] == "perf/step"]
    dec = records["serving/decode_step"]
    return {"events": len(events), "dropped": mon.tracer.dropped,
            "watchdog_counts": mon.watchdog.counts(),
            "decode_flops": dec.flops, "decode_bytes": dec.bytes_accessed,
            "decode_peak_bytes": dec.peak_bytes,
            "decode_mfu_median": statistics.median(mfu),
            "cost_entries": sorted(records),
            "slo": engine.metrics.slo_tracker.summary(),
            "ledger_ttft": ledger["ttft"], "ledger_e2e": ledger["e2e"],
            "ledger_p99_victim": ledger["p99_victim"]}


def near_oom_phase(obs):
    """A second, small serving engine whose monitor trips the near-OOM
    post-mortem at its first sample (near_oom_fraction NEAR_OOM_FRACTION
    of the card): its top-K live CUDA tensors go through the flight
    recorder, and ``recover`` must read them back from flight.bin."""
    from deeperspeed_tpu_torch.models.gpt import GPTConfig, init_params
    from deeperspeed_tpu_torch.monitor import (get_monitor, shutdown_monitor)
    from deeperspeed_tpu_torch.monitor.flight import recover
    from deeperspeed_tpu_torch.serving import ServingEngine

    cfg = GPTConfig(vocab_size=512, n_layer=2, n_head=4, d_model=256,
                    max_seq=128, dtype=torch.bfloat16)
    params = init_params(SEED, cfg, device="cuda", dtype=torch.bfloat16)
    flight = str(Path(obs) / "near_oom.flight.bin")
    engine = ServingEngine(
        cfg, params, {"num_slots": 2, "block_size": 16, "num_blocks": 32,
                      "max_seq_len": 128},
        monitor_config={"flight_path": flight, "watchdog": "strict",
                        "near_oom_fraction": NEAR_OOM_FRACTION})
    # a live buffer the post-mortem must name
    ballast = torch.empty(NEAR_OOM_BALLAST, dtype=torch.uint8, device="cuda")
    engine.submit(list(range(1, 17)), max_new_tokens=4)
    engine.run()
    mw = get_monitor().memwatch
    shutdown_monitor(save=False)
    snap = recover(flight)
    heads = [e for e in snap.events if e["name"] == "mem/postmortem"]
    rows = [e["args"] for e in snap.events if e["name"] == "mem/buffer"]
    top = max((r["nbytes"] for r in rows), default=0)
    report = {"postmortems": mw.postmortems, "recovered": len(snap.events),
              "torn": snap.torn, "buffers": rows[:3],
              "reason": heads[0]["args"]["reason"] if heads else None}
    print("near-oom: " + json.dumps(report), flush=True)
    if not heads or not rows or mw.postmortems < 1 or \
            top != ballast.untyped_storage().nbytes():
        raise AssertionError(f"near-OOM post-mortem not recovered from "
                             f"{flight}: {report}")
    del engine, params, ballast
    return report


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
        "kernels": {"mode": "auto"},
    }
    config["scheduler"]["params"]["warmup_num_steps"] = WARMUP_STEPS
    return config


def compare_paths(engine, kernel_loss, plain_loss, batch, kernels_block,
                  count=False):
    """Loss and grads of one micro-batch through the kernel path
    (``kernel_loss`` under ``kernels_block``) and the plain path
    (``plain_loss``, kernels off) from the engine's params: relative loss
    difference, both grad norms, and the cosine of the flattened grads.
    With ``count``, a cost index (of its own, emitting nothing) captures
    each path's loss and grads: both must count the same flops."""
    from contextlib import nullcontext

    from deeperspeed_tpu_torch.monitor.perf import CompiledCostIndex
    from deeperspeed_tpu_torch.monitor.watchdog import SignatureCache
    from deeperspeed_tpu_torch.ops import kernel_config
    from deeperspeed_tpu_torch.ops.adam import tree_leaves

    leaves = tree_leaves(engine.params)
    index = CompiledCostIndex(emit=False)
    out = {}
    for name, loss_fn, block in (("kernels", kernel_loss, kernels_block),
                                 ("plain", plain_loss, {"mode": "off"})):
        sigs = SignatureCache()
        sigs.record(engine.params, batch)
        with kernel_config.override(**block), (
                index.capture(name, sigs, engine.device) if count
                else nullcontext()):
            loss = loss_fn(engine.params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
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
    if count:
        recs = index.records()
        res["cost"] = {k: {"flops": r.flops,
                           "recompute_flops": r.recompute_flops,
                           "bytes": r.bytes_accessed, "error": r.error}
                       for k, r in recs.items()}
        if any(r.error for r in recs.values()) or \
                recs["kernels"].flops != recs["plain"].flops:
            raise AssertionError(f"the cost index counts the kernel and "
                                 f"plain paths apart: {res['cost']}")
    if not (res["loss_rel_diff"] <= LOSS_RTOL
            and res["grad_norm_rel_diff"] <= GNORM_RTOL
            and res["grad_cosine"] >= MIN_COSINE):
        raise AssertionError(
            f"kernel path disagrees with the plain path: {res} (limits: "
            f"loss {LOSS_RTOL}, grad norm {GNORM_RTOL}, cosine >= "
            f"{MIN_COSINE})")
    return res


def run_steps(engine, batch, counters, steps, after_step=None):
    """``steps`` train_batch calls with every launch counter set to 0
    just before and read just after: losses, grad norms, LRs, step times,
    launches and the peak device memory of the run. ``after_step(i)``, if
    given, runs after step i (1-based), outside the step's timing."""
    losses, norms, lrs, step_s = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    for _ in range(steps):
        lrs.append(engine.get_lr()[0])
        t0 = time.perf_counter()
        loss = engine.train_batch(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
        norms.append(engine.get_global_grad_norm())
        if after_step is not None:
            after_step(len(losses))
    launches = {name: fn.launches for name, fn in counters.items()}
    return {"losses": losses, "grad_norms": norms, "lrs": lrs,
            "step_s": step_s, "launches": launches,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def check_run(run, engine, expected, steps):
    """The gates of a training run: launches per step as expected (every
    kernel of the path launched), losses finite and the last below the
    first, no skipped step, grad norms finite and > 0. Returns the
    launches per step."""
    per_step = {k: n / steps for k, n in run["launches"].items()}
    if per_step != expected:
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{expected} (launches {run['launches']} over "
                             f"{steps} steps)")
    losses, norms = run["losses"], run["grad_norms"]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    if engine.skipped_steps or not all(math.isfinite(n) and n > 0
                                       for n in norms):
        raise AssertionError(f"skipped {engine.skipped_steps} steps; grad "
                             f"norms {norms}")
    return per_step


KERNEL_FAMILIES = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                   "flash_bwd_delta", "supertile_fwd", "supertile_bwd",
                   "sparse_fwd", "sparse_bwd_dkdv", "sparse_bwd_dq",
                   "sparse_bwd_delta", "ln_fwd",
                   "ln_bwd", "bias_gelu_fwd", "bias_gelu_bwd", "fused_adam")


def kernel_family(name):
    """The port's kernel a profiled CUDA kernel name belongs to (the
    add-LN pair is the LN kernels' templates with the residual flag set:
    ln_fwd_kernel<T, true>, ln_bwd_kernel<T, true>, ln_bwd_rows_kernel<T,
    true, ...> and ln_bwd_reduce_kernel<true>), else "gemm" or "other"."""
    fam = next((f for f in KERNEL_FAMILIES if f in name), None)
    if fam in ("ln_fwd", "ln_bwd") and any(
            m in name for m in ("<true>", ", true>", ", true,")):
        return "add_" + fam
    if fam is not None:
        return fam
    return ("gemm" if any(w in name.lower() for w in
                          ("gemm", "nvjet", "cutlass", "sm90_xmma"))
            else "other")


def profile_training(engine, batch, top=10, other_top=12):
    """Where a training step's time goes, after the main run has been
    read: one more train_batch under torch.profiler. Reports wall time,
    device kernel time, the busy share, device time per kernel family
    (the port's kernels by name, GEMMs, the rest), the top kernels, and
    the "other" family split by kernel name (its ``other_top`` largest,
    with their calls and device time)."""
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
        fam = kernel_family(e.key)
        families[fam] = families.get(fam, 0.0) + e.self_device_time_total
    device_us = sum(families.values())
    other = [e for e in kernels if kernel_family(e.key) == "other"]
    return {
        "wall_ms": wall * 1e3, "device_ms": device_us / 1e3,
        "device_busy_share": device_us / 1e6 / wall,
        "device_ms_by_family": {k: v / 1e3 for k, v in sorted(
            families.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "device_ms": e.self_device_time_total / 1e3}
                        for e in kernels[:top]],
        "other_kernels": len(other),
        "other_top_kernels": [
            {"name": e.key[:120], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3}
            for e in other[:other_top]],
    }


def obs_monitor(obs):
    """configs/gpt_125m_obs.json's "monitor" block, cut for this run:
    obs_dir in ``obs``, an ephemeral metrics port, the TB export every
    OBS_TB_EXPORT_INTERVAL steps."""
    with open(OBS_CONFIG) as f:
        block = json.load(f)["monitor"]
    return dict(block, obs_dir=str(obs), metrics_port=0,
                tb_export_interval=OBS_TB_EXPORT_INTERVAL)


def training_phase(card, obs):
    """GPT-NeoX-1.3B through initialize -> train_batch; see the module
    docstring, phase 6. Returns the launch counts of the 6-step run and
    the launches per step."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models.gpt import (get_preset, init_params,
                                                  make_gpt)
    from deeperspeed_tpu_torch.ops import kernel_config

    cfg = get_preset("neox-1.3b", n_layer=TRAIN_LAYERS, max_seq=1024,
                     remat_policy="matmuls", ce_chunk=0, dtype=torch.bfloat16)
    config = training_config()
    config["monitor"] = obs_monitor(obs)
    print(f"training: scheduler warmup_num_steps overridden 1000 -> "
          f"{WARMUP_STEPS}; monitor {json.dumps(config['monitor'])}",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(gen, cfg, device="cuda", dtype=torch.bfloat16)
    randomize_affine(params, gen)
    corpus = np.load(ROOT / "data" / "corpus_tokens.npy", mmap_mode="r")
    rows = config["train_batch_size"]
    batch = np.asarray(corpus[: rows * (cfg.max_seq + 1)],
                       dtype=np.int64).reshape(rows, cfg.max_seq + 1)

    with kernel_config.override():
        engine, _, _, sched = ds.initialize(
            model=make_gpt(cfg)[2], model_parameters=params, config=config)
        del params
        micro = config["train_micro_batch_size_per_gpu"]
        parity = compare_paths(
            engine, make_gpt(cfg)[2],
            make_gpt(dataclasses.replace(cfg, attn_impl="xla"))[2],
            torch.from_numpy(batch[:micro]).cuda(), config["kernels"],
            count=True)
        print("training parity: " + json.dumps(parity), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        saved = {}
        watched = {}

        def after_step(step):
            if step == 1:
                watched["after_step_1"] = engine.monitor.watchdog.counts()
            if step == SAVE_AFTER_STEP:
                saved.update(save_checkpoint(engine, sched))

        run = run_steps(engine, batch, kernel_counters(), TRAIN_STEPS,
                        after_step=after_step)
        final = host_state(engine)
        telemetry = training_telemetry(engine, watched["after_step_1"],
                                       rows * cfg.max_seq)

    gas = config["gradient_accumulation_steps"]
    expected = {"flash_fwd": cfg.n_layer * gas, "flash_bwd": cfg.n_layer * gas,
                "ln_fwd": gas, "ln_bwd": gas,
                # the backward replays bias+GeLU from the kept pre-GeLU
                "bias_gelu_fwd": 2 * cfg.n_layer * gas,
                "bias_gelu_bwd": cfg.n_layer * gas,
                "add_ln_fwd": 0, "add_ln_bwd": 0, "supertile_fwd": 0,
                "supertile_bwd": 0,
                # all 16 leaves are bf16 (one dtype combination): one
                # launch per applied step
                "fused_adam": 1, "sparse_fwd": 0, "sparse_bwd": 0,
                # one rank: no gradient reduction
                "quantize_rows": 0, "dequant_sum_rows": 0,
                "dequant_rows": 0}
    per_step = {k: n / TRAIN_STEPS for k, n in run["launches"].items()}
    step_ms = statistics.median(run["step_s"][1:]) * 1e3
    tokens = rows * cfg.max_seq
    report = {
        "model": "neox-1.3b", "dtype": "bfloat16", "card": card,
        "layers": cfg.n_layer, "d_model": cfg.d_model, "seq": cfg.max_seq,
        "remat_policy": cfg.remat_policy, "micro_batch": micro,
        "grad_accum": gas, "warmup_num_steps": WARMUP_STEPS,
        "steps": TRAIN_STEPS, **run, "skipped_steps": engine.skipped_steps,
        "step_ms_median_2_6": step_ms,
        "tokens_per_s": tokens / (step_ms / 1e3),
        "launches_per_step": per_step, "parity": parity,
        "checkpoint": {k: v for k, v in saved.items()
                       if k != "scheduler"},
        "final_digest": final["digest"], "telemetry": telemetry,
    }
    print("training: " + json.dumps(report), flush=True)
    per_step = check_run(run, engine, expected, TRAIN_STEPS)
    with kernel_config.override(**config["kernels"]):
        print("training profile: " + json.dumps(profile_training(
            engine, batch)), flush=True)
    print("training monitor files: " + json.dumps(close_monitor(obs)),
          flush=True)
    del engine, sched
    gc.collect()
    torch.cuda.empty_cache()
    after = {"losses": run["losses"][SAVE_AFTER_STEP:],
             "grad_norms": run["grad_norms"][SAVE_AFTER_STEP:],
             "final": final, "checkpoint": saved, "expected": expected}
    return run["launches"], per_step, after


def training_telemetry(engine, after_step_1, tokens):
    """Phase 6's monitor, read after the 6 steps: every cost record free of
    errors, the watchdog's counts as after step 1 (and never fired), 6
    optimizer steps read over HTTP from the endpoint, the trace's names;
    and the step's MFU, the cost index's flops and bytes beside the
    analytic 6 N tokens model flops."""
    import urllib.request

    from deeperspeed_tpu_torch.ops.adam import tree_leaves

    mon = engine.monitor
    model_flops = 6 * sum(p.numel() for p in tree_leaves(engine.params)) \
        * tokens
    records = mon.cost_index.records()
    failed = {k: r.error for k, r in records.items() if r.error}
    if failed or "engine/train_step" not in records:
        raise AssertionError(f"cost records {sorted(records)}, failed "
                             f"{failed}")
    counts = mon.watchdog.counts()
    if counts != after_step_1 or mon.watchdog.fired:
        raise AssertionError(f"watchdog counts {after_step_1} after step 1, "
                             f"{counts} after step {TRAIN_STEPS}; fired "
                             f"{mon.watchdog.fired}")
    with urllib.request.urlopen(mon.metrics_server.url, timeout=10) as r:
        scraped = r.read().decode()
    if f"\ntrain_steps_total {TRAIN_STEPS}\n" not in scraped:
        raise AssertionError(f"train_steps_total over HTTP is not "
                             f"{TRAIN_STEPS}: " + "".join(
                                 l for l in scraped.splitlines(True)
                                 if l.startswith("train_")))
    events = mon.tracer.events()
    missing = TRAIN_EVENTS - {e["name"] for e in events}
    if missing:
        raise AssertionError(f"training trace lacks {sorted(missing)}")
    step = records["engine/train_step"]
    mfu = [e["args"]["mfu"] for e in events if e["name"] == "perf/step"]
    return {"mfu_per_step": mfu,
            "verdicts": [e["args"]["verdict"] for e in events
                         if e["name"] == "perf/step"],
            "flops": step.flops, "recompute_flops": step.recompute_flops,
            "bytes": step.bytes_accessed, "peak_bytes": step.peak_bytes,
            "model_flops_6nt": model_flops,
            "flops_over_6nt": step.flops / model_flops,
            "watchdog_counts": counts, "events": len(events),
            "dropped": mon.tracer.dropped,
            "hbm_peak": max(e["args"].get("hbm_peak", 0) for e in events
                            if e["name"] == "engine/train_batch")}


def close_monitor(obs):
    """Shut the installed monitor down (saving its trace), then require
    its trace and flight files under ``obs`` and strict validation of the
    trace. Returns the files and their bytes."""
    from deeperspeed_tpu_torch.monitor import (shutdown_monitor,
                                               validate_file)

    shutdown_monitor(save=True)
    files = {f.name: f.stat().st_size for f in Path(obs).iterdir()}
    traces = [f for f in files if f.endswith(".trace.json")]
    flights = [f for f in files if f.endswith(".flight.bin")]
    if len(traces) != 1 or len(flights) != 1:
        raise AssertionError(f"monitor files under {obs}: {files}")
    problems = validate_file(str(Path(obs) / traces[0]), strict=True)
    if problems:
        raise AssertionError(f"{traces[0]} fails strict validation: "
                             f"{problems[:5]}")
    return files


def save_checkpoint(engine, sched):
    """Save the engine into CKPT_DIR (a fresh directory): the tag, the
    scheduler's state, the files' bytes and the seconds the save took."""
    import shutil

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.save_checkpoint(str(CKPT_DIR))
    seconds = time.perf_counter() - t0
    tag = (CKPT_DIR / "latest").read_text().strip()
    nbytes = sum(f.stat().st_size for f in (CKPT_DIR / tag).iterdir())
    return {"tag": tag, "global_steps": engine.global_steps,
            "scheduler": sched.state_dict(), "bytes": nbytes,
            "save_s": seconds}


def host_state(engine):
    """The engine's params and Adam moments copied to the host, with a
    sha256 digest of their bytes."""
    import hashlib

    from deeperspeed_tpu_torch.ops.adam import tree_leaves

    leaves = [t.detach().cpu() for tree in (engine.params,
                                            engine.opt_state.exp_avg,
                                            engine.opt_state.exp_avg_sq)
              for t in tree_leaves(tree)]
    h = hashlib.sha256()
    for t in leaves:
        h.update(t.contiguous().view(-1).view(torch.uint8).numpy())
    return {"leaves": leaves, "digest": h.hexdigest()}


def resume_phase(card, after):
    """Phase 10: a fresh engine, from weights of another seed, loads the
    checkpoint phase 6 saved after step 3 and runs steps 4-6 on the same
    batch. Its losses, grad norms, final params and moments must equal
    phase 6's bit for bit. Returns the launch counts of its 3 steps."""
    import shutil

    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models.gpt import (get_preset, init_params,
                                                  make_gpt)
    from deeperspeed_tpu_torch.ops import kernel_config

    cfg = get_preset("neox-1.3b", n_layer=TRAIN_LAYERS, max_seq=1024,
                     remat_policy="matmuls", ce_chunk=0, dtype=torch.bfloat16)
    config = training_config()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    params = init_params(gen, cfg, device="cuda", dtype=torch.bfloat16)
    corpus = np.load(ROOT / "data" / "corpus_tokens.npy", mmap_mode="r")
    rows = config["train_batch_size"]
    batch = np.asarray(corpus[: rows * (cfg.max_seq + 1)],
                       dtype=np.int64).reshape(rows, cfg.max_seq + 1)
    saved = after["checkpoint"]
    with kernel_config.override():
        engine, _, _, sched = ds.initialize(
            model=make_gpt(cfg)[2], model_parameters=params, config=config)
        del params
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path, client = engine.load_checkpoint(str(CKPT_DIR))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        state = {"path": path, "global_steps": engine.global_steps,
                 "optimizer_step": engine.opt_state.step,
                 "scheduler": sched.state_dict(), "client_state": client}
        want = {"path": str(CKPT_DIR / saved["tag"]),
                "global_steps": SAVE_AFTER_STEP,
                "optimizer_step": SAVE_AFTER_STEP,
                "scheduler": saved["scheduler"], "client_state": {}}
        if state != want:
            raise AssertionError(f"resumed state {state}, expected {want}")
        steps = TRAIN_STEPS - SAVE_AFTER_STEP
        run = run_steps(engine, batch, kernel_counters(), steps)
        final = host_state(engine)
    same = {"losses": run["losses"] == after["losses"],
            "grad_norms": run["grad_norms"] == after["grad_norms"],
            "params_and_moments": len(final["leaves"]) == len(
                after["final"]["leaves"]) and all(
                torch.equal(a, b) for a, b in zip(final["leaves"],
                                                  after["final"]["leaves"])),
            "digest": final["digest"] == after["final"]["digest"]}
    report = {
        "model": "neox-1.3b", "card": card, "resumed_from": state["path"],
        "checkpoint_bytes": saved["bytes"], "save_s": saved["save_s"],
        "load_s": load_s, "steps": steps, "losses": run["losses"],
        "uninterrupted_losses": after["losses"],
        "grad_norms": run["grad_norms"],
        "uninterrupted_grad_norms": after["grad_norms"],
        "digest": final["digest"], "bit_identical": same,
        "launches": run["launches"], "step_s": run["step_s"],
        # steps 5-6: no monitor here; phase 6's steps ran under one
        "step_ms_median_5_6": statistics.median(run["step_s"][1:]) * 1e3,
    }
    print("resume: " + json.dumps(report), flush=True)
    del engine, sched, final
    after["final"] = None
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    if not all(same.values()):
        raise AssertionError(f"the resumed run differs from the "
                             f"uninterrupted one: {same}")
    per_step = {k: n / steps for k, n in run["launches"].items()}
    if per_step != after["expected"]:
        raise AssertionError(f"resume launches per step {per_step}, "
                             f"expected {after['expected']}")
    return run["launches"]


def kernel_counters():
    """Every kernel wrapper of the port, by name: each counts its
    launches."""
    from deeperspeed_tpu_torch.ops import flash_attention as fa
    from deeperspeed_tpu_torch.ops import flash_static as fs
    from deeperspeed_tpu_torch.ops import fused_adam as fad
    from deeperspeed_tpu_torch.ops import fused_blocks as fb
    from deeperspeed_tpu_torch.ops import fused_quant as fq
    from deeperspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    return {"ln_fwd": fb.ln_fwd, "ln_bwd": fb.ln_bwd,
            "bias_gelu_fwd": fb.bias_gelu_fwd,
            "bias_gelu_bwd": fb.bias_gelu_bwd,
            "flash_fwd": fa.flash_fwd, "flash_bwd": fa.flash_bwd,
            "add_ln_fwd": fb.add_ln_fwd, "add_ln_bwd": fb.add_ln_bwd,
            "supertile_fwd": fs.supertile_fwd,
            "supertile_bwd": fs.supertile_bwd,
            "fused_adam": fad.fused_adam, "sparse_fwd": bs.sparse_fwd,
            "sparse_bwd": bs.sparse_bwd, "quantize_rows": fq.quantize_rows,
            "dequant_sum_rows": fq.dequant_sum_rows,
            "dequant_rows": fq.dequant_rows}


def bert_config():
    """The keys of configs/bert_large_zero2.json changed for one card:
    micro-batch 64 x 1 accumulation step (the file's 4096 / 48 has no whole
    accumulation count on one card; 64 is the reference bench's
    micro-batch at seq 128), the kernels block, and the warmup of
    BERT_WARMUP_STEPS. Its zero_optimization block runs as written: stage
    2 on one rank, where the ZeRO size is 1 and no leaf is sharded. Lamb
    runs no fused Adam: fused_adam launches 0 times on this path."""
    return {
        "train_batch_size": 64,
        "train_micro_batch_size_per_gpu": 64,
        "gradient_accumulation_steps": 1,
        "bf16": {"enabled": True},
        "zero_optimization": {"stage": 2},
        "optimizer": {"type": "Lamb",
                      "params": {"lr": 2e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_max_lr": 2e-3,
                                 "warmup_num_steps": BERT_WARMUP_STEPS}},
        "gradient_clipping": 1.0,
        "steps_per_print": 100,
        "kernels": {"mode": "auto"},
    }


def bert_batch(rows, seq):
    """One MLM batch: ids from data/corpus_tokens.npy, BERT_MASK_FRAC of
    the positions scored (label = the original id, input = the mask id),
    the rest labelled -100."""
    corpus = np.load(ROOT / "data" / "corpus_tokens.npy", mmap_mode="r")
    ids = np.asarray(corpus[: rows * seq], dtype=np.int64).reshape(rows, seq)
    scored = np.random.default_rng(SEED).random(ids.shape) < BERT_MASK_FRAC
    return (np.where(scored, BERT_MASK_ID, ids),
            np.where(scored, ids, -100))


def bert_training_phase(card):
    """BERT-large through initialize -> train_batch; see the module
    docstring, phase 8. Returns the launch counts of the 6-step run and
    the launches per step."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models.bert import (BertConfig, init_params,
                                                   make_bert)
    from deeperspeed_tpu_torch.ops import kernel_config
    from deeperspeed_tpu_torch.ops.lamb import FusedLamb

    cfg = BertConfig(vocab_size=30528, n_layer=24, n_head=16, d_model=1024,
                     max_seq=128, dtype=torch.bfloat16, remat=True,
                     remat_policy="full", ce_chunk=64, mlm_gather_frac=0.0)
    config = bert_config()
    print(f"bert training: scheduler warmup_num_steps overridden 10000 -> "
          f"{BERT_WARMUP_STEPS}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(gen, cfg, device="cuda")
    ids, labels = bert_batch(config["train_batch_size"], cfg.max_seq)
    batch = (ids, labels)

    with kernel_config.override():
        engine, opt, _, sched = ds.initialize(
            model=make_bert(cfg)[2], model_parameters=params, config=config)
        del params
        if not isinstance(opt, FusedLamb):
            raise AssertionError(f"the Lamb config built {type(opt)}")
        parity = compare_paths(
            engine, make_bert(cfg)[2],
            make_bert(dataclasses.replace(cfg, attn_impl="xla"))[2],
            engine._place_batch(batch), config["kernels"])
        print("bert training parity: " + json.dumps(parity), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        run = run_steps(engine, batch, kernel_counters(), BERT_STEPS)

    L = cfg.n_layer
    n_chunks = cfg.max_seq // cfg.ce_chunk
    # remat "full" replays each layer (and each checkpointed CE chunk) in
    # the backward: two forwards per layer and chunk, one backward
    expected = {"add_ln_fwd": 2 * 2 * L, "add_ln_bwd": 2 * L,
                "supertile_fwd": 2 * L, "supertile_bwd": L,
                "bias_gelu_fwd": 2 * L + 2 * n_chunks,
                "bias_gelu_bwd": L + n_chunks,
                "ln_fwd": 1 + 2 * n_chunks, "ln_bwd": 1 + n_chunks,
                "flash_fwd": 0, "flash_bwd": 0, "fused_adam": 0,
                "sparse_fwd": 0, "sparse_bwd": 0, "quantize_rows": 0,
                "dequant_sum_rows": 0, "dequant_rows": 0}
    per_step = {k: n / BERT_STEPS for k, n in run["launches"].items()}
    step_ms = statistics.median(run["step_s"][1:]) * 1e3
    tokens = ids.size
    report = {
        "model": "bert-large", "dtype": "bfloat16", "card": card,
        "layers": L, "d_model": cfg.d_model, "heads": cfg.n_head,
        "vocab": cfg.vocab_size, "seq": cfg.max_seq,
        "remat_policy": cfg.remat_policy, "micro_batch": ids.shape[0],
        "grad_accum": 1, "optimizer": "Lamb",
        "warmup_num_steps": BERT_WARMUP_STEPS,
        "scored_positions": int((labels != -100).sum()),
        "steps": BERT_STEPS, **run, "skipped_steps": engine.skipped_steps,
        "step_ms_median_2_6": step_ms,
        "tokens_per_s": tokens / (step_ms / 1e3),
        "samples_per_s": ids.shape[0] / (step_ms / 1e3),
        "launches_per_step": per_step, "parity": parity,
    }
    print("bert training: " + json.dumps(report), flush=True)
    per_step = check_run(run, engine, expected, BERT_STEPS)
    with kernel_config.override(**config["kernels"]):
        print("bert training profile: " + json.dumps(profile_training(
            engine, batch)), flush=True)
    del engine, sched
    gc.collect()
    torch.cuda.empty_cache()
    return run["launches"], per_step


def sparse_config():
    """Phase 12's config: micro-batch 1 x 2 accumulation steps, masterless
    bf16, Adam at a constant LR (no scheduler), clipping 1.0, the kernels
    block, and the "sparse_attention" block of upstream DeepSpeed's
    documented example (fixed mode)."""
    return {
        "train_batch_size": 2,
        "train_micro_batch_size_per_gpu": 1,
        "gradient_accumulation_steps": 2,
        "bf16": {"enabled": True, "master_weights": False},
        "zero_optimization": {"stage": 0},
        "optimizer": {"type": "Adam",
                      "params": {"lr": SPARSE_LR, "betas": [0.9, 0.95]}},
        "gradient_clipping": 1.0,
        "steps_per_print": 100,
        "kernels": {"mode": "auto"},
        "sparse_attention": SPARSE_BLOCK,
    }


def sparse_loss(sparsity, impl):
    """The user's loss: SPARSE_LAYERS BertSparseSelfAttention layers (BERT-
    large's attention sub-layers) pre-LN with a residual, h = h +
    attn_i(layer_norm_i(h)), a final layer_norm, and the mean square of the
    result against the batch's target. Returns (layer, loss_fn)."""
    from deeperspeed_tpu_torch.ops.fused_blocks import layer_norm
    from deeperspeed_tpu_torch.ops.sparse_attention import (
        BertSparseSelfAttention)

    attn = BertSparseSelfAttention(SPARSE_D, SPARSE_HEADS, sparsity,
                                   max_seq_length=SPARSE_SEQ, impl=impl)

    def loss_fn(params, batch):
        x, target = batch
        h = x.to(params["ln_f"]["w"].dtype)
        for i in range(SPARSE_LAYERS):
            lp = params[f"layer{i:02d}"]
            h = h + attn.apply(lp["attn"], layer_norm(h, lp["ln"]["w"],
                                                      lp["ln"]["b"], 1e-5))
        y = layer_norm(h, params["ln_f"]["w"], params["ln_f"]["b"], 1e-5)
        return (y.float() - target).square().mean()

    return attn, loss_fn


def sparse_training_phase(card):
    """Phase 12: the user's sparse-attention loss at BERT-large's attention
    width through initialize -> train_batch; see the module docstring.
    Returns the launch counts of the 6-step run and the launches per
    step."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.ops import fused_adam as fad
    from deeperspeed_tpu_torch.ops import kernel_config
    from deeperspeed_tpu_torch.ops.adam import tree_leaves
    from deeperspeed_tpu_torch.runtime.config import TrainingConfig

    config = sparse_config()
    sparsity = TrainingConfig(config).get_sparse_attention(SPARSE_HEADS)
    attn, loss = sparse_loss(sparsity, "auto")
    _, plain_loss = sparse_loss(sparsity, "xla")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    D = SPARSE_D
    params = {f"layer{i:02d}": {
        "ln": {"w": torch.ones(D, device="cuda"),
               "b": torch.zeros(D, device="cuda")},
        "attn": attn.init(gen, "cuda")} for i in range(SPARSE_LAYERS)}
    params["ln_f"] = {"w": torch.ones(D, device="cuda"),
                      "b": torch.zeros(D, device="cuda")}
    rows = config["train_batch_size"]
    batch = (torch.randn(rows, SPARSE_SEQ, D, generator=gen, device="cuda"),
             torch.randn(rows, SPARSE_SEQ, D, generator=gen, device="cuda"))
    n_leaves = len(tree_leaves(params))

    with kernel_config.override():
        engine, _, _, _ = ds.initialize(model=loss, model_parameters=params,
                                        config=config)
        del params
        parity = compare_paths(
            engine, loss, plain_loss,
            engine._place_batch(tuple(t[:1] for t in batch)),
            config["kernels"])
        print("sparse training parity: " + json.dumps(parity), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        run = run_steps(engine, batch, kernel_counters(), SPARSE_STEPS)

    gas = config["gradient_accumulation_steps"]
    per_launch = fad._lib().ds_fused_adam_max_leaves()
    expected = {name: 0 for name in kernel_counters()}
    # no remat: one forward and one backward per layer and micro-batch;
    # pre-LN on every layer plus the final LN; every leaf bf16 (one dtype
    # combination): one Adam launch per 64 leaves
    expected.update(sparse_fwd=SPARSE_LAYERS * gas,
                    sparse_bwd=SPARSE_LAYERS * gas,
                    ln_fwd=(SPARSE_LAYERS + 1) * gas,
                    ln_bwd=(SPARSE_LAYERS + 1) * gas,
                    fused_adam=math.ceil(n_leaves / per_launch))
    per_step = {k: n / SPARSE_STEPS for k, n in run["launches"].items()}
    step_ms = statistics.median(run["step_s"][1:]) * 1e3
    tokens = rows * SPARSE_SEQ
    layout = sparsity.make_layout(SPARSE_SEQ)
    report = {
        "model": "bert-large attention x 24, block-sparse", "card": card,
        "dtype": "bfloat16", "layers": SPARSE_LAYERS, "d_model": D,
        "heads": SPARSE_HEADS, "seq": SPARSE_SEQ, "sparse_attention":
        SPARSE_BLOCK, "layout_density": float(layout.mean()),
        "active_blocks": int(layout.sum()), "leaves": n_leaves,
        "micro_batch": config["train_micro_batch_size_per_gpu"],
        "grad_accum": gas, "lr": SPARSE_LR, "steps": SPARSE_STEPS, **run,
        "skipped_steps": engine.skipped_steps,
        "step_ms_median_2_6": step_ms,
        "tokens_per_s": tokens / (step_ms / 1e3),
        "launches_per_step": per_step, "parity": parity,
    }
    print("sparse training: " + json.dumps(report), flush=True)
    per_step = check_run(run, engine, expected, SPARSE_STEPS)
    with kernel_config.override(**config["kernels"]):
        print("sparse training profile: " + json.dumps(profile_training(
            engine, batch)), flush=True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return run["launches"], per_step
# the int8 gradient wire (phases 13-14): configs/gpt_125m_comm.json, cut
DP_RANKS = 2
DP_MICRO = 16
DP_GAS = 2
DP_STEPS = 6
DP_WARMUP_STEPS = 100
# int8 against fp32 comm, 6 steps from one seed: the largest relative
# loss difference allowed (error feedback keeps the int8 curve on the fp32
# one), and the largest relative difference of the grad norms of the steps
# whose params both runs share (the warmup's lr-0 steps and the step after
# them), where only the wire's quantization error tells the two means
# apart. Set from the measured gaps, which PERF.md states.
INT8_LOSS_RTOL = 1e-3
INT8_GNORM_RTOL = 1e-3
# each rank's fp32 master + Adam moments against a ZeRO 0 engine's: about
# half under ZeRO 1 on 2 ranks (leaves with no even dim stay replicated)
ZERO1_STATE_RATIO = 0.55


def bits_differing(got, want):
    """Elements of two equal-shape tensors whose bits differ; a NaN matches
    a NaN (its payload aside)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{got.dtype} {tuple(got.shape)} against "
                             f"{want.dtype} {tuple(want.shape)}")
    if not got.is_floating_point():
        return int((got != want).sum())
    nan = torch.isnan(got.float()) & torch.isnan(want.float())
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32}[got.element_size()]
    return int(((got.view(view) != want.view(view)) & ~nan).sum())


def dp_bucket_lengths():
    """The padded lengths of the GPT-NeoX-125M buckets the reducer plans
    at 2 ranks with the comm block of configs/gpt_125m_comm.json."""
    from deeperspeed_tpu_torch.models.gpt import get_preset, param_shapes
    from deeperspeed_tpu_torch.runtime.comm import CommConfig, bucketing

    comm = CommConfig.from_dict(dp_config()["comm"])

    def meta(t):
        if isinstance(t, dict):
            return {k: meta(v) for k, v in t.items()}
        return torch.empty(t, device="meta")

    plan = bucketing.build_plan(
        meta(param_shapes(get_preset("neox-125m", max_seq=1024))),
        comm.bucket_bytes, comm.block * DP_RANKS)
    return [b.padded for b in plan.buckets]


def quant_case(name, shape, dtype, got, want, extra=None):
    diff = sum(bits_differing(g, w) for g, w in zip(got, want)
               if w is not None)
    if diff:
        raise AssertionError(f"{name} {shape} {dtype_name(dtype)}: {diff} "
                             f"elements differ from the plain version")
    row = {"shape": list(shape), "dtype": dtype_name(dtype),
           "max_abs_err": 0.0, "tol": 0.0, "rel_l2_err": 0.0,
           "rel_l2_tol": 0.0, "elements_differing": 0}
    row.update(extra or {})
    return row


def quant_phase(fq, gen):
    """Phase 13: the three wire-format kernels against their plain
    versions, bit for bit, at the reducer's bucket shapes for the
    GPT-NeoX-125M plan; the path's shapes timed."""
    lengths = dp_bucket_lengths()
    block = dp_config()["comm"]["block"]
    print(f"quant: GPT-NeoX-125M plan at {DP_RANKS} ranks: "
          f"{len(lengths)} buckets, padded lengths {lengths}", flush=True)
    cases = {k: [] for k in QUANT_KERNELS}

    def values(R, C, dtype):
        x = torch.randn((R, C), generator=gen, device="cuda")
        x *= torch.exp(torch.randn((R, 1), generator=gen,
                                   device="cuda") * 3)
        x[0, :block] = 0.0              # an all-zero block
        x[R - 1, 3 * block + 5] = 0.0
        return x.to(dtype)

    def quantize(x, res, extra=None):
        cases["quantize_rows"].append(quant_case(
            "quantize_rows", x.shape, x.dtype,
            fq.quantize_rows(x, block, res),
            fq.quantize_rows_plain(x, block, res),
            dict(extra or {}, residual=res)))

    for L in sorted(set(lengths)):
        half = L // DP_RANKS
        for dtype in (torch.float32, torch.bfloat16):
            x = values(DP_RANKS, half, dtype)
            for res in (True, False):
                quantize(x, res)
            quantize(values(1, half, dtype), True, {"phase": 2})
        q, s, _ = fq.quantize_rows_plain(values(DP_RANKS, half,
                                                torch.float32), block)
        cases["dequant_sum_rows"].append(quant_case(
            "dequant_sum_rows", q.shape, q.dtype,
            [fq.dequant_sum_rows(q, s, block)],
            [fq.dequant_sum_rows_plain(q, s, block)]))
        cases["dequant_rows"].append(quant_case(
            "dequant_rows", q.shape, q.dtype,
            [fq.dequant_rows(q, s, block, DP_RANKS)],
            [fq.dequant_rows_plain(q, s, block, DP_RANKS)]))
        # the compressed wire: (2, L) fp16 mantissas, 2^e scales
        m = (torch.rand((DP_RANKS, L), generator=gen, device="cuda") * 2
             - 1).half()
        e = torch.exp2(torch.randint(-30, 30, (DP_RANKS, L // block),
                                     generator=gen, device="cuda").float())
        cases["dequant_sum_rows"].append(quant_case(
            "dequant_sum_rows", m.shape, m.dtype,
            [fq.dequant_sum_rows(m, e, block)],
            [fq.dequant_sum_rows_plain(m, e, block)]))
    # R = 4 and 8 rows standing for ranks, at the largest bucket
    L = max(lengths)
    for R in (4, 8):
        x = values(R, L // R // block * block, torch.float32)
        quantize(x, True)
        q, s, _ = fq.quantize_rows_plain(x, block)
        cases["dequant_sum_rows"].append(quant_case(
            "dequant_sum_rows", q.shape, q.dtype,
            [fq.dequant_sum_rows(q, s, block)],
            [fq.dequant_sum_rows_plain(q, s, block)]))
        cases["dequant_rows"].append(quant_case(
            "dequant_rows", q.shape, q.dtype,
            [fq.dequant_rows(q, s, block, R)],
            [fq.dequant_rows_plain(q, s, block, R)]))
    # non-finite blocks: a NaN gives s = 1 and q = 0 there, an inf s = inf
    x = values(DP_RANKS, 64 * block, torch.float32)
    x[0, 2 * block + 1] = float("nan")
    x[1, 5 * block + 2] = float("inf")
    quantize(x, True, {"non_finite": True})
    _, s, _ = fq.quantize_rows(x, block, True)
    if not (float(s[0, 2]) == 1.0 and math.isinf(float(s[1, 5]))):
        raise AssertionError(f"non-finite blocks: scales {s[0, 2]}, "
                             f"{s[1, 5]}")
    # another block than 128 takes the strided path
    quantize(values(DP_RANKS, 64 * 96, torch.float32), True, {"block": 96})
    for bad in (lambda: fq.quantize_rows(torch.ones(2, 100, device="cuda"),
                                         block),
                lambda: fq.dequant_rows(torch.ones(2, 128, device="cuda",
                                                   dtype=torch.int8),
                                        torch.ones(2, 2, device="cuda"),
                                        block)):
        try:
            bad()
        except ValueError:
            continue
        raise AssertionError("a shape the kernel does not take was accepted")

    # timed at the path's largest bucket: (2, L/2) fp32 with the residual,
    # the (2, L/2) int8 partial sum and the (2, L/2) rebuild
    half = L // DP_RANKS
    n = DP_RANKS * half
    nb = n // block
    x_bytes = 4 * n + n + 4 * nb + 4 * n
    bufs = copies(lambda: (values(DP_RANKS, half, torch.float32), block,
                           True), x_bytes)
    row = dict(quant_case("quantize_rows", (DP_RANKS, half),
                          torch.float32, [], []), path="comm",
               **timings(fq.quantize_rows, fq.quantize_rows_plain, bufs),
               **bound(x_bytes, 4 * n), residual=True)
    cases["quantize_rows"].append(row)
    qs = [fq.quantize_rows_plain(b[0], block, False)[:2] for b in bufs]
    sum_bytes = n + 4 * nb + 4 * half
    cases["dequant_sum_rows"].append(dict(
        quant_case("dequant_sum_rows", (DP_RANKS, half), torch.int8,
                   [], []), path="comm",
        **timings(fq.dequant_sum_rows, fq.dequant_sum_rows_plain,
                  [(q, s_, block) for q, s_ in qs]),
        **bound(sum_bytes, 2 * n)))
    deq_bytes = n + 4 * nb + 4 * n
    cases["dequant_rows"].append(dict(
        quant_case("dequant_rows", (DP_RANKS, half), torch.int8, [],
                   []), path="comm",
        **timings(fq.dequant_rows, fq.dequant_rows_plain,
                  [(q, s_, block, float(DP_RANKS)) for q, s_ in qs]),
        **bound(deq_bytes, 2 * n)))
    for name, rows in cases.items():
        print(f"quant: {name} equal to its plain version bit for bit in "
              f"{len(rows)} cases", flush=True)
    return cases


def dp_config(comm=None):
    """configs/gpt_125m_comm.json as written, its "monitor" block
    included, with the cuts PERF.md §4 lists: 2 ranks x micro-batch 16 x
    2 accumulation steps (the file's 512 / 16 would be 16 steps a rank),
    a 100-step warmup (the file's 2000 keeps the LR below 21 % of its
    peak for 6 steps), and the kernels block. ``comm`` replaces the comm
    block."""
    with open(ROOT / "configs" / "gpt_125m_comm.json") as f:
        config = json.load(f)
    config["train_batch_size"] = DP_RANKS * DP_MICRO * DP_GAS
    config["train_micro_batch_size_per_gpu"] = DP_MICRO
    config["scheduler"]["params"]["warmup_num_steps"] = DP_WARMUP_STEPS
    config["kernels"] = {"mode": "auto"}
    if comm is not None:
        config["comm"] = comm
    return config


def params_digest(params):
    import hashlib

    from deeperspeed_tpu_torch.ops.adam import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(params):
        h.update(t.detach().contiguous().view(torch.int16).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def dp_rank(rank, tmp):
    """One rank of phase 14 (spawned): joins the gloo group, trains
    GPT-NeoX-125M with the int8 comm block, then with fp32 comm, and
    writes its report to ``tmp``."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    store = dist.FileStore(str(Path(tmp) / "store"), DP_RANKS)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=DP_RANKS)
    try:
        report = {"rank": rank}
        for comm in ("int8", "fp32"):
            report[comm] = dp_run(rank, None if comm == "int8"
                                  else {"mode": "fp32"}, tmp)
        (Path(tmp) / f"rank{rank}.json").write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def dp_run(rank, comm, tmp):
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models.gpt import (get_preset, init_params,
                                                  make_gpt)
    from deeperspeed_tpu_torch.ops import kernel_config
    from deeperspeed_tpu_torch.ops.adam import tree_leaves

    cfg = get_preset("neox-125m", max_seq=1024, remat_policy="matmuls",
                     ce_chunk=0, dtype=torch.bfloat16)
    config = dp_config(comm)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = init_params(gen, cfg, device="cuda", dtype=torch.bfloat16)
    randomize_affine(params, gen)
    corpus = np.load(ROOT / "data" / "corpus_tokens.npy", mmap_mode="r")
    rows = config["train_batch_size"]
    batch = np.asarray(corpus[: rows * (cfg.max_seq + 1)],
                       dtype=np.int64).reshape(rows, cfg.max_seq + 1)
    out = {}
    with kernel_config.override():
        engine, _, _, _ = ds.initialize(
            model=make_gpt(cfg)[2], model_parameters=params, config=config)
        zero0 = sum(12 * p.numel() for p in tree_leaves(params))
        del params
        if comm is None and rank == 0:
            out["parity"] = compare_paths(
                engine, make_gpt(cfg)[2],
                make_gpt(dataclasses.replace(cfg, attn_impl="xla"))[2],
                torch.from_numpy(batch[:DP_MICRO]).cuda(), config["kernels"])
        gc.collect()
        torch.cuda.empty_cache()
        state = (tree_leaves(engine.master)
                 + tree_leaves(engine.opt_state.exp_avg)
                 + tree_leaves(engine.opt_state.exp_avg_sq))
        red = engine.comm
        digests = []
        staged0 = red.transport.staged_bytes
        reduce_s = []
        reduce = engine._reduce_grads

        def timed_reduce(grads):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grads = reduce(grads)
            torch.cuda.synchronize()
            reduce_s.append(time.perf_counter() - t0)
            return grads

        engine._reduce_grads = timed_reduce
        run = run_steps(engine, batch, kernel_counters(), DP_STEPS,
                        after_step=lambda i: digests.append(params_digest(
                            engine.params)))
        out.update(run)
        # the monitor of configs/gpt_125m_comm.json: this rank's role lane,
        # its trace (the int8 run's) and the reducer's counters
        mon = engine.monitor
        rc = mon.run_context
        out["monitor"] = {
            "role": rc.role,
            "comm_buckets": mon.registry.counter("comm_buckets").value,
            "comm_wire_bytes": mon.registry.counter(
                "comm_wire_bytes").value,
            "train_steps_total": mon.registry.counter(
                "train_steps_total").value}
        if comm is None:
            out["monitor"]["trace"] = mon.save_trace(str(
                Path(tmp) / f"{rc.role}.i{rc.incarnation}.trace.json"))
        out.update(
            digests=digests, reduce_s=reduce_s,
            skipped_steps=engine.skipped_steps,
            mode=red.cfg.mode, hier_k=red.hier_k or 0,
            n_buckets=red.n_buckets,
            bucket_padded=[b.padded for b in red.plan.buckets],
            wire_bytes_per_step=red.total_wire_bytes(),
            staged_bytes_per_step=(red.transport.staged_bytes - staged0)
            / DP_STEPS,
            state_bytes=sum(t.numel() * t.element_size() for t in state),
            zero0_state_bytes=zero0,
            replicated_leaves=sum(1 for sp in engine._specs
                                  if not sp.sharded),
            leaves=len(engine._specs),
            tokens_per_step_per_rank=DP_MICRO * DP_GAS * cfg.max_seq,
            n_layer=cfg.n_layer, d_model=cfg.d_model)
    del engine, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dp_merge_traces(monitors, tmp):
    """Phase 14's two traces: each rank wrote its own (its role lane,
    runctx.host_role), and ``aggregate`` merges them into one timeline
    that passes strict validation and holds both ranks' comm/reduce
    spans."""
    from deeperspeed_tpu_torch.monitor import aggregate, validate_events

    paths = [m["trace"] for m in monitors]
    roles = [m["role"] for m in monitors]
    if len(set(paths)) != len(paths) or len(set(roles)) != len(roles):
        raise AssertionError(f"the ranks share a role or a trace file: "
                             f"{roles}, {paths}")
    doc, stats = aggregate.merge_files(paths, out=str(Path(tmp) /
                                                      "merged.json"))
    events = doc["traceEvents"]
    problems = validate_events(events, strict=True)
    reduce_pids = {e["pid"] for e in events if e.get("name") == "comm/reduce"}
    if problems or len(reduce_pids) != len(paths):
        raise AssertionError(f"merged trace: problems {problems[:5]}, "
                             f"comm/reduce spans from {len(reduce_pids)} "
                             f"of {len(paths)} ranks")
    return {"roles": roles, "files": [Path(p_).name for p_ in paths],
            "events": stats["events"], "sources": len(stats["sources"]),
            "comm_reduce_spans": sum(1 for e in events
                                     if e.get("name") == "comm/reduce")}


def dp_training_phase(card):
    """Phase 14: 2 ranks on one card train GPT-NeoX-125M under the blocks
    of configs/gpt_125m_comm.json (int8 comm, ZeRO 1), then with fp32
    comm; see the module docstring. Returns the int8 run's launches (both
    ranks) and its launches per step per rank."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.start_processes(dp_rank, args=(tmp,), nprocs=DP_RANKS,
                           start_method="spawn", join=True)
        seconds = time.perf_counter() - t0
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(DP_RANKS)]
        merged = dp_merge_traces([r["int8"]["monitor"] for r in ranks], tmp)
    int8 = [r["int8"] for r in ranks]
    fp32 = [r["fp32"] for r in ranks]
    first = int8[0]
    gas = DP_GAS
    L = first["n_layer"]
    nb = first["n_buckets"]
    base = {"flash_fwd": L * gas, "flash_bwd": L * gas, "ln_fwd": gas,
            "ln_bwd": gas, "bias_gelu_fwd": 2 * L * gas,
            "bias_gelu_bwd": L * gas, "add_ln_fwd": 0, "add_ln_bwd": 0,
            "supertile_fwd": 0, "supertile_bwd": 0,
            # every leaf fp32 master with a bf16 cast: one combination
            "fused_adam": 1, "sparse_fwd": 0, "sparse_bwd": 0}
    # the flat int8 schedule with error feedback, per bucket: quantize the
    # W chunks and the partial sum, one row sum, one rebuild
    expected = dict(base, quantize_rows=2 * nb, dequant_sum_rows=nb,
                    dequant_rows=nb)
    expected_fp32 = dict(base, quantize_rows=0, dequant_sum_rows=0,
                         dequant_rows=0)
    report = {"card": card, "ranks": DP_RANKS, "micro_batch": DP_MICRO,
              "grad_accum": gas, "steps": DP_STEPS,
              "warmup_num_steps": DP_WARMUP_STEPS, "spawn_s": seconds,
              "parity": first["parity"], "merged_trace": merged,
              "monitor": [r["monitor"] for r in int8]}
    for name, runs, want in (("int8", int8, expected),
                             ("fp32", fp32, expected_fp32)):
        for r, run in enumerate(runs):
            per_step = {k: n / DP_STEPS for k, n in run["launches"].items()}
            if per_step != want:
                raise AssertionError(f"{name} rank {r}: launches per step "
                                     f"{per_step}, expected {want}")
            losses, norms = run["losses"], run["grad_norms"]
            if (not all(math.isfinite(x) for x in losses)
                    or losses[-1] >= losses[0]):
                raise AssertionError(f"{name} rank {r}: losses not finite "
                                     f"and falling: {losses}")
            if run["skipped_steps"] or not all(
                    math.isfinite(n_) and n_ > 0 for n_ in norms):
                raise AssertionError(f"{name} rank {r}: skipped "
                                     f"{run['skipped_steps']}; grad norms "
                                     f"{norms}")
            counters = run["monitor"]
            want_counters = {
                "comm_buckets": run["n_buckets"] * DP_STEPS,
                "comm_wire_bytes": run["wire_bytes_per_step"] * DP_STEPS,
                "train_steps_total": DP_STEPS}
            got = {k: counters[k] for k in want_counters}
            if got != want_counters:
                raise AssertionError(f"{name} rank {r}: monitor counters "
                                     f"{got}, expected {want_counters}")
            ratio = run["state_bytes"] / run["zero0_state_bytes"]
            if not ratio <= ZERO1_STATE_RATIO:
                raise AssertionError(f"{name} rank {r}: ZeRO 1 keeps "
                                     f"{ratio:.3f} of ZeRO 0's state bytes")
        if runs[0]["digests"] != runs[1]["digests"]:
            raise AssertionError(f"{name}: the ranks' params differ after a "
                                 f"step: {runs[0]['digests']} / "
                                 f"{runs[1]['digests']}")
        if runs[0]["losses"] != runs[1]["losses"]:
            raise AssertionError(f"{name}: the ranks' losses differ")
        step_ms = statistics.median(runs[0]["step_s"][1:]) * 1e3
        reduce_ms = statistics.median(runs[0]["reduce_s"][1:]) * 1e3
        report[name] = {
            "losses": runs[0]["losses"], "grad_norms": runs[0]["grad_norms"],
            "lrs": runs[0]["lrs"],
            "step_ms_median_2_6": [statistics.median(r_["step_s"][1:]) * 1e3
                                   for r_ in runs],
            "reduce_ms_median_2_6": reduce_ms,
            "reduce_share": reduce_ms / step_ms,
            "tokens_per_s": DP_RANKS * runs[0]["tokens_per_step_per_rank"]
            / (step_ms / 1e3),
            "peak_mem_gib": [r_["peak_mem_gib"] for r_ in runs],
            "n_buckets": runs[0]["n_buckets"],
            "bucket_padded": runs[0]["bucket_padded"],
            "hier_k": runs[0]["hier_k"],
            "wire_bytes_per_step": runs[0]["wire_bytes_per_step"],
            "staged_bytes_per_step": runs[0]["staged_bytes_per_step"],
            "state_bytes": [r_["state_bytes"] for r_ in runs],
            "zero0_state_bytes": runs[0]["zero0_state_bytes"],
            "replicated_leaves": runs[0]["replicated_leaves"],
            "leaves": runs[0]["leaves"],
            "launches_per_step_per_rank": {
                k: n / DP_STEPS for k, n in runs[0]["launches"].items()
                if k in QUANT_KERNELS or n},
        }
    gap = max(abs(a - b) / abs(b) for a, b in zip(report["int8"]["losses"],
                                                  report["fp32"]["losses"]))
    report["int8_vs_fp32_loss_rel_max"] = gap
    # the steps that start from the same params in both runs: up to and
    # including the first one with lr > 0
    lrs = report["int8"]["lrs"]
    shared = next((i for i, lr in enumerate(lrs) if lr > 0), len(lrs)) + 1
    ngaps = [abs(a - b) / abs(b) for a, b in zip(
        report["int8"]["grad_norms"][:shared],
        report["fp32"]["grad_norms"][:shared])]
    report["int8_vs_fp32_grad_norm_rel"] = ngaps
    print("dp training: " + json.dumps(report), flush=True)
    if lrs != report["fp32"]["lrs"]:
        raise AssertionError(f"int8 and fp32-comm LRs differ: {lrs} / "
                             f"{report['fp32']['lrs']}")
    if not gap <= INT8_LOSS_RTOL:
        raise AssertionError(f"int8 losses {report['int8']['losses']} leave "
                             f"the fp32-comm ones {report['fp32']['losses']}"
                             f" by {gap:.3e} (limit {INT8_LOSS_RTOL})")
    if not max(ngaps) <= INT8_GNORM_RTOL:
        raise AssertionError(f"int8 grad norms {report['int8']['grad_norms']}"
                             f" leave the fp32-comm ones "
                             f"{report['fp32']['grad_norms']} by {ngaps} on "
                             f"the first {shared} steps (limit "
                             f"{INT8_GNORM_RTOL})")
    launches = {k: sum(r["launches"][k] for r in int8)
                for k in int8[0]["launches"]}
    per_step = {k: n / DP_STEPS for k, n in int8[0]["launches"].items()}
    return launches, per_step


# ------------------------------------------------------------------ #
# phase 15: ZeRO-Infinity (the streamed offload engine)
# ------------------------------------------------------------------ #


def host_memory_line():
    """The host's RAM as /proc/meminfo gives it (GiB)."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable", "SwapTotal"):
                info[key] = int(val.split()[0]) * 1024 / 2**30
    return info


def infinity_config(nvme_path):
    """configs/neox_20b_infinity.json as written, plus "kernels": {"mode":
    "auto"}, with its nvme_path cut to ``nvme_path`` (PERF.md section 4)."""
    config = json.loads(INFINITY_CONFIG.read_text())
    config.pop("_comment", None)
    config["zero_optimization"]["offload_optimizer"]["nvme_path"] = str(
        nvme_path)
    config["kernels"] = {"mode": "auto"}
    return config


def infinity_batch(seed):
    """One (1, 1025) batch of the corpus at a seeded offset."""
    corpus = np.load(ROOT / "data" / "corpus_tokens.npy", mmap_mode="r")
    start = int(np.random.default_rng(seed).integers(
        0, corpus.size - INFINITY_SEQ - 1))
    return np.asarray(corpus[start: start + INFINITY_SEQ + 1],
                      dtype=np.int64).reshape(1, INFINITY_SEQ + 1)


def per_leaf(meta, flat):
    return [flat[o: o + n] for o, n in zip(meta.offsets, meta.sizes)]


def infinity_grads_phase(card, tmp):
    """Phase 15a: GPT-NeoX-20B width at 1 layer, the fp32 wire, bf16
    residency, fp32 host state in RAM, kernels auto, lr 0. The streamed
    grads against make_gpt's autograd grads on the card's params; the
    loss with the kernels off; the native v1 pass against the numpy pass
    on the globals chunk."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models.gpt import get_preset, make_gpt
    from deeperspeed_tpu_torch.ops import kernel_config
    from deeperspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam
    from deeperspeed_tpu_torch.runtime.offload import streaming

    cfg = get_preset("neox-20b", n_layer=1, max_seq=INFINITY_SEQ,
                     dtype=torch.bfloat16)
    config = infinity_config(tmp / "nvme_a")
    config["zero_optimization"]["offload_optimizer"] = {"device": "none"}
    config["streaming"].update(wire_bits=32, resident_bits=16,
                               host_state="fp32", warmup_steps=0)
    config["optimizer"]["params"]["lr"] = 0.0
    batch = infinity_batch(SEED)
    with kernel_config.override():
        t0 = time.perf_counter()
        engine, _, _, _ = ds.initialize(model=cfg, config=config)
        init_s = time.perf_counter() - t0
        engine.capture_grads = True
        loss_on = engine.train_batch(batch)
        grads = {c: g for c, g in engine.last_grads.items()}
        engine.capture_grads = False
        params = streaming.tree_map(
            lambda a: torch.from_numpy(a).to("cuda", torch.bfloat16)
            .requires_grad_(True), engine.device_params_tree())
        ref_loss = make_gpt(cfg)[2](params, torch.from_numpy(batch).cuda())
        ref_grads = torch.autograd.grad(
            ref_loss, streaming.tree_leaves(params))
        ref_loss = float(ref_loss.detach())
        ref_tree = streaming.tree_unflatten(params, [
            g.float().cpu().numpy() for g in ref_grads])
        del params, ref_grads
        _, ref_chunks = engine._chunk(ref_tree)
        del ref_tree
        leaves = {}
        for c in engine.chunk_names:
            meta = engine._meta[c]
            names = [f"{c}.{i}" for i in range(len(meta.sizes))]
            for name, a, b in zip(names, per_leaf(meta, grads[c]),
                                  per_leaf(meta, ref_chunks[c])):
                # in fp64 on the card
                a64, b64 = (torch.from_numpy(x).cuda().double()
                            for x in (a, b))
                cos = float(a64 @ b64 / (a64.norm() * b64.norm())
                            .clamp_min(1e-300))
                rel = float((a64 - b64).norm() / b64.norm().clamp_min(1e-300))
                leaves[name] = {"cosine": cos, "rel_l2": rel}
                del a64, b64
        bad = {k: v for k, v in leaves.items()
               if not (v["cosine"] >= INFINITY_GRAD_COSINE
                       and v["rel_l2"] <= INFINITY_GRAD_REL_L2)}
        if bad:
            raise AssertionError(f"infinity 15a: streamed grads disagree with "
                                 f"make_gpt's: {bad}")
        # the same params (lr 0) with the kernels off and dense attention
        engine.cfg = dataclasses.replace(cfg, attn_impl="xla")
        with kernel_config.override(mode="off"):
            loss_off = engine.eval_batch(batch)
        engine.cfg = cfg
        loss_rel = abs(loss_on - loss_off) / abs(loss_off)
        mono_rel = abs(loss_on - ref_loss) / abs(ref_loss)
        if not (loss_rel <= INFINITY_LOSS_RTOL
                and mono_rel <= INFINITY_LOSS_RTOL):
            raise AssertionError(
                f"infinity 15a: loss with kernels {loss_on}, without "
                f"{loss_off}, make_gpt's {ref_loss}: above "
                f"{INFINITY_LOSS_RTOL}")

        v1 = native_v1_check(engine, grads["globals"], streaming,
                             DeepSpeedCPUAdam)
    report = {"card": card, "model": "neox-20b", "layers": 1,
              "params": engine.n_params, "init_s": init_s,
              "loss_kernels": loss_on, "loss_plain": loss_off,
              "loss_make_gpt": ref_loss,
              "loss_rel_diff": loss_rel, "loss_make_gpt_rel_diff": mono_rel,
              "worst_cosine": min(leaves.items(),
                                  key=lambda kv: kv[1]["cosine"]),
              "worst_rel_l2": max(leaves.items(),
                                  key=lambda kv: kv[1]["rel_l2"]),
              "leaves": len(leaves), "native_v1": v1,
              "timings": engine.timings}
    print("infinity 15a: " + json.dumps(report), flush=True)
    del engine, grads, ref_chunks, ref_loss
    gc.collect()
    torch.cuda.empty_cache()


def native_v1_check(engine, g, streaming, cpu_adam):
    """The native v1 pass (ds_stream_chunk_step) against the numpy pass
    (the engine's numpy codec around the library's Adam) on the globals
    chunk: its fp32 grads on an int8 wire, its params as masters, one
    Adam step at the config's peak lr. Gates: moments bit for bit,
    masters within 1e-7, the shadow and the uplink codes differing in at
    most INFINITY_V1_SHADOW_MAX and INFINITY_V1_CODES_MAX elements (the
    library's FMAs against numpy's two roundings)."""
    from concurrent.futures import ThreadPoolExecutor

    meta = engine._meta["globals"]
    block = engine.scfg.wire_block
    lr = INFINITY_LR
    pool = ThreadPoolExecutor(max_workers=len(meta.sizes))
    wires = list(pool.map(lambda x: streaming.host_quant(x, 8, block),
                          per_leaf(meta, g)))
    pk = np.concatenate([w[0] for w in wires])
    sk = np.concatenate([w[1] for w in wires])
    shadow = engine._shadow["globals"].copy()
    opt = cpu_adam(lr=lr, betas=engine.scfg.betas, eps=engine.scfg.eps)
    # native v1
    master = streaming.bf16_bits_to_f32(shadow)
    m, v = np.zeros_like(master), np.zeros_like(master)
    sh_nat = shadow.copy()
    out_p = np.empty(pk.size, np.uint8)
    out_s = np.empty(sk.size, np.float32)
    t0 = time.perf_counter()
    if not opt.step_stream_chunk(1, pk, sk, master, m, v, sh_nat, out_p,
                                 out_s, meta.sizes, [8] * len(meta.sizes),
                                 block, lr=lr):
        raise AssertionError("infinity 15a: the native v1 pass refused")
    native_s = time.perf_counter() - t0
    # the numpy pass
    t0 = time.perf_counter()
    # the numpy codec's per-leaf passes on threads (numpy drops the GIL)
    g_np = np.empty(meta.total, np.float32)
    spans = list(zip(meta.offsets, meta.sizes))
    list(pool.map(lambda i: streaming.host_dequant(
        *wires[i], spans[i][1], 8, block,
        out=g_np[spans[i][0]: spans[i][0] + spans[i][1]]),
        range(len(spans))))
    master_np = streaming.bf16_bits_to_f32(shadow)
    m_np, v_np = np.zeros_like(master_np), np.zeros_like(master_np)
    opt.step_flat(1, master_np, g_np, m_np, v_np, lr=lr)
    sh_f32 = streaming.bf16_bits_to_f32(shadow)
    delta = master_np - sh_f32

    def uplink(i):
        o, n = spans[i]
        p_, s_ = streaming.host_quant(delta[o: o + n], 8, block)
        streaming.host_dequant(p_, s_, n, 8, block, out=delta[o: o + n])
        return p_

    ups = list(pool.map(uplink, range(len(spans))))
    pool.shutdown()
    sh_np = streaming.f32_to_bf16_bits(sh_f32 + delta)
    numpy_s = time.perf_counter() - t0
    up_np = np.concatenate(ups)
    res = {"elements": int(meta.total),
           "moments_equal": bool(np.array_equal(m, m_np)
                                 and np.array_equal(v, v_np)),
           "master_max_abs_diff": float(np.abs(master - master_np).max()),
           "master_elements_differing": int((master != master_np).sum()),
           "shadow_elements_differing": int((sh_nat != sh_np).sum()),
           "codes_differing": int((out_p != up_np).sum()),
           "native_s": native_s, "numpy_s": numpy_s}
    if not (res["moments_equal"] and res["master_max_abs_diff"] <= 1e-7
            and res["shadow_elements_differing"] <= INFINITY_V1_SHADOW_MAX
            and res["codes_differing"] <= INFINITY_V1_CODES_MAX):
        raise AssertionError(f"infinity 15a: native v1 against numpy: {res}")
    return res


def infinity_expected_launches(n_layer):
    """Launches per streamed step the code gives: each layer's forward runs
    twice (the no-grad group forward and the group backward's re-run under
    autograd, whose backward launches each backward kernel once); the
    final layer norm runs once forward and once backward in the head. The
    NeoX block's two layer norms share one plain pass (layer_norm2)."""
    expected = {name: 0 for name in SOURCES}
    expected.update(flash_fwd=2 * n_layer, flash_bwd=n_layer,
                    bias_gelu_fwd=2 * n_layer, bias_gelu_bwd=n_layer,
                    ln_fwd=1, ln_bwd=1)
    return expected


def infinity_training_phase(card, tmp):
    """Phase 15b: configs/neox_20b_infinity.json as written with its two
    cuts (n_layer 44 -> INFINITY_LAYERS, nvme_path a temporary directory),
    fresh init from the config's seed, INFINITY_STEPS steps on one fixed
    batch, a checkpoint saved after step 2 for 15c. Returns the launches
    of the run, the launches per step and what 15c holds its resume to."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models.gpt import get_preset
    from deeperspeed_tpu_torch.ops import kernel_config

    cfg = get_preset("neox-20b", n_layer=INFINITY_LAYERS,
                     max_seq=INFINITY_SEQ, dtype=torch.bfloat16)
    nvme = tmp / "nvme_b"
    config = infinity_config(nvme)
    batch = infinity_batch(SEED + 1)
    counters = kernel_counters()
    with kernel_config.override():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine, _, _, _ = ds.initialize(model=cfg, config=config)
        init_s = time.perf_counter() - t0
        print(f"infinity 15b: initialize {init_s:.2f} s, {engine.n_params} "
              f"params, scfg {json.dumps(dataclasses.asdict(engine.scfg))}",
              flush=True)
        expected = infinity_expected_launches(cfg.n_layer)
        wire = engine.wire_bytes_per_step()
        steps = []
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        total = {name: 0 for name in counters}
        for step in range(1, INFINITY_STEPS + 1):
            before = dict(engine.timings)
            t0 = time.perf_counter()
            loss = engine.train_batch(batch)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            launches = {n: fn.launches - total[n]
                        for n, fn in counters.items()}
            total = {n: fn.launches for n, fn in counters.items()}
            matches = engine.shadow_matches_device()
            rec = {"step": step, "loss": loss, "step_s": step_s,
                   **{k: engine.timings[k] - before.get(k, 0.0)
                      for k in ("compute_s", "d2h_s", "h2d_s",
                                "host_opt_s")},
                   "wire_bytes": engine.wire_bytes_last_step,
                   "routes": sorted(set(engine.host_routes.values())),
                   "shadow_equals_device": all(matches.values()),
                   "launches": launches, "lr": engine._lr()}
            print("infinity 15b step: " + json.dumps(rec), flush=True)
            if not math.isfinite(loss):
                raise AssertionError(f"infinity 15b: loss {loss}")
            if not rec["shadow_equals_device"]:
                raise AssertionError(f"infinity 15b: shadow differs from the "
                                     f"card in {matches}")
            if rec["wire_bytes"] != wire:
                raise AssertionError(f"infinity 15b: moved {rec['wire_bytes']}"
                                     f" wire bytes, accounting says {wire}")
            if rec["routes"] != ["native_v2"]:
                raise AssertionError(f"infinity 15b: host passes "
                                     f"{engine.host_routes}")
            if step > 1 and launches != expected:
                raise AssertionError(f"infinity 15b: launches {launches}, "
                                     f"expected {expected}")
            steps.append(rec)
            if step == 2:
                # 15c's checkpoint: this engine's state after step 2
                t0 = time.perf_counter()
                engine.save_checkpoint(str(tmp / "ckpt"))
                resume = {"save_s": time.perf_counter() - t0}
            if step == 3:
                resume["loss_3"] = loss
                resume["shadow_3"] = {c: engine.storage_bytes(c)
                                      for c in engine.chunk_names}
        run_launches = dict(total)
        sizes = engine.host_state_bytes()
        report = {
            "card": card, "model": "neox-20b", "layers": cfg.n_layer,
            "d_model": cfg.d_model, "seq": INFINITY_SEQ, "params":
                engine.n_params, "init_s": init_s,
            "initial_upload_s": engine.timings["initial_upload_s"],
            "losses": [s["loss"] for s in steps],
            "step_s": [s["step_s"] for s in steps],
            "step_s_median_2_3": statistics.median(
                [s["step_s"] for s in steps[1:]]),
            "timings_median_2_3": {k: statistics.median(
                [s[k] for s in steps[1:]]) for k in
                ("compute_s", "d2h_s", "h2d_s", "host_opt_s")},
            "host_ram_bytes": sizes["ram"], "nvme_bytes": sizes["nvme"],
            "nvme_files": sorted(p.name for p in nvme.iterdir()),
            "resident_bytes": engine.resident_bytes(),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "wire_bytes_per_step": wire,
            "launches_per_step": expected,
            "simd": engine.opt.simd_width(),
        }
    print("infinity 15b: " + json.dumps(report), flush=True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    resume["batch"] = batch
    return run_launches, {k: v / INFINITY_STEPS
                          for k, v in run_launches.items()}, resume


def infinity_resume_phase(card, tmp, saved):
    """Phase 15c: 15b's checkpoint of step 2 (the config's own profile:
    int4 wire and residency, bf16 host state, exp_avg_sq on the NVMe
    tier, at INFINITY_LAYERS) loaded into a fresh engine (at step 0: zero
    moments, the initial params): its step 3 on 15b's batch must give
    15b's step-3 loss and card bytes, bit for bit."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models.gpt import get_preset
    from deeperspeed_tpu_torch.ops import kernel_config

    cfg = get_preset("neox-20b", n_layer=INFINITY_LAYERS,
                     max_seq=INFINITY_SEQ, dtype=torch.bfloat16)
    ckpt = tmp / "ckpt"
    ckpt_bytes = sum(p.stat().st_size for p in ckpt.rglob("*")
                     if p.is_file())
    with kernel_config.override():
        b, _, _, _ = ds.initialize(model=cfg,
                                   config=infinity_config(tmp / "nvme_c"))
        t0 = time.perf_counter()
        b.load_checkpoint(str(ckpt))
        load_s = time.perf_counter() - t0
        loss3_b = b.train_batch(saved["batch"])
        same_shadow = all(
            np.array_equal(saved["shadow_3"][c][k], v)
            for c in b.chunk_names for k, v in b.storage_bytes(c).items())
        same_device = all(b.shadow_matches_device().values())
    report = {"card": card, "layers": INFINITY_LAYERS,
              "loss_3": saved["loss_3"], "loss_3_resumed": loss3_b,
              "same_loss": saved["loss_3"] == loss3_b,
              "same_shadow": same_shadow,
              "shadow_equals_device": same_device,
              "save_s": saved["save_s"], "load_s": load_s,
              "checkpoint_bytes": ckpt_bytes}
    print("infinity 15c: " + json.dumps(report), flush=True)
    if not (report["same_loss"] and same_shadow and same_device):
        raise AssertionError(f"infinity 15c: resume not bit for bit: {report}")
    del b
    gc.collect()
    torch.cuda.empty_cache()


def infinity_phase(card):
    """Phase 15 (ZeRO-Infinity): the host's RAM, the free disk at the swap
    folder and the host library's build, then 15a-15c. Returns 15b's
    launches and launches per step."""
    import shutil

    from deeperspeed_tpu_torch.ops import op_builder
    from deeperspeed_tpu_torch.ops.adam import DeepSpeedCPUAdam

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_infinity_"))
    try:
        opt = DeepSpeedCPUAdam(lr=INFINITY_LR)
        info = op_builder.build_info["ds_cpu_adam"]
        disk = shutil.disk_usage(tmp)
        print("infinity host: " + json.dumps({
            "meminfo_gib": host_memory_line(),
            "swap_folder": str(tmp), "disk_free_gib": disk.free / 2**30,
            "disk_total_gib": disk.total / 2**30,
            "cpu_count": os.cpu_count(),
            "ds_cpu_adam_build_s": info["seconds"],
            "ds_cpu_adam_library": info["path"],
            "ds_cpu_adam_compiler": info["compiler"],
            "ds_cpu_adam_openmp": info["openmp"],
            "ds_adam_simd_width": opt.simd_width()}), flush=True)
        del opt
        infinity_grads_phase(card, tmp)
        launches, per_step, saved = infinity_training_phase(card, tmp)
        infinity_resume_phase(card, tmp, saved)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, per_step


def infinity_kernel_cases(fb, gen):
    """The LN and bias+GeLU kernels at the streamed 20B step's shapes:
    ln_fwd / ln_bwd at (1024, 6144) and bias_gelu_fwd / bias_gelu_bwd
    (tanh) at (1024, 24576), bf16, against their plain versions (TOL; 10x
    for gradients; REL_L2), timed beside the plain version, the library
    call (F.layer_norm and its aten backward; none computes bias+GeLU in
    one call) and the bound ("path": "infinity")."""
    results = {}
    dtype = torch.bfloat16
    tol, rel, isz = TOL[dtype], REL_L2[dtype], 2
    R, D = INFINITY_LN
    w = randn_on(gen, (D,), torch.float32, 0.1, 1.0)
    b = randn_on(gen, (D,), torch.float32, 0.1)

    def ln_fwd_case():
        return randn_on(gen, (R, D), dtype, 2.0, 0.5), w, b, 1e-5

    args = ln_fwd_case()
    y, mu, rs = fb.ln_fwd(*args)
    torch.cuda.synchronize()
    py, pmu, prs = fb.ln_fwd_plain(*args)
    err, rel_err = check_close(f"ln_fwd {R}x{D} bf16", y, py, tol, rel)
    check_outputs(f"ln_fwd {R}x{D} stats", ("mean", "rstd"), (mu, rs),
                  (pmu, prs), 2e-5, rel)
    row = {"shape": [R, D], "dtype": "bfloat16", "path": "infinity",
           "max_abs_err": err, "tol": tol, "rel_l2_err": rel_err,
           "rel_l2_tol": rel, "library": "F.layer_norm"}
    bufs = copies(ln_fwd_case, R * D * isz)
    lib_bufs = [(a[0], (D,), w.to(dtype), b.to(dtype), 1e-5) for a in bufs]
    row.update(timings(fb.ln_fwd, fb.ln_fwd_plain, bufs,
                       torch.nn.functional.layer_norm, lib_bufs))
    row.update(bound(2 * R * D * isz + 2 * D * 4 + 2 * R * 4, 8 * R * D))
    results["ln_fwd"] = [row]
    del bufs, lib_bufs

    def ln_bwd_case():
        x = randn_on(gen, (R, D), dtype, 2.0, 0.5)
        _, mean, rstd = fb.ln_fwd_plain(x, w, b, 1e-5)
        return x, w, mean, rstd, randn_on(gen, (R, D), dtype)

    args = ln_bwd_case()
    got = fb.ln_bwd(*args)
    torch.cuda.synchronize()
    err, rel_err = check_outputs(f"ln_bwd {R}x{D} bf16", ("dx", "dw", "db"),
                                 got, fb.ln_bwd_plain(*args), 10 * tol, rel)
    row = {"shape": [R, D], "dtype": "bfloat16", "path": "infinity",
           "max_abs_err": err, "tol": 10 * tol, "rel_l2_err": rel_err,
           "rel_l2_tol": rel, "library": "aten.native_layer_norm_backward"}
    bufs = copies(ln_bwd_case, 2 * R * D * isz)
    wl = w.to(dtype)
    lib_bufs = [(g, xx, (D,), mu_[:, None], rs_[:, None], wl, wl,
                 [True, True, True]) for xx, _, mu_, rs_, g in bufs]
    row.update(timings(fb.ln_bwd, fb.ln_bwd_plain, bufs,
                       torch.ops.aten.native_layer_norm_backward, lib_bufs))
    row.update(bound(3 * R * D * isz + 8 * R + 12 * D, 13 * R * D))
    results["ln_bwd"] = [row]
    del bufs, lib_bufs

    R, F = INFINITY_BG

    def bg_case():
        return (randn_on(gen, (R, F), dtype, 2.0), randn_on(gen, (F,), dtype),
                randn_on(gen, (R, F), dtype), True)

    args = bg_case()
    y = fb.bias_gelu_fwd(*args[:2], True)
    dx, db = fb.bias_gelu_bwd(*args)
    torch.cuda.synchronize()
    err, rel_err = check_close(f"bias_gelu_fwd {R}x{F} bf16", y,
                               fb.bias_gelu_fwd_plain(*args[:2], True),
                               tol, rel)
    fwd = {"shape": [R, F], "dtype": "bfloat16", "approximate": True,
           "path": "infinity", "max_abs_err": err, "tol": tol,
           "rel_l2_err": rel_err, "rel_l2_tol": rel, "library": None}
    err, rel_err = check_outputs(f"bias_gelu_bwd {R}x{F} bf16", ("dx", "db"),
                                 (dx, db), fb.bias_gelu_bwd_plain(*args),
                                 10 * tol, rel)
    bwd = dict(fwd, max_abs_err=err, tol=10 * tol, rel_l2_err=rel_err)
    bufs = copies(bg_case, 2 * R * F * isz)
    fwd.update(timings(fb.bias_gelu_fwd, fb.bias_gelu_fwd_plain,
                       [a[:2] + (True,) for a in bufs]))
    fwd.update(bound(2 * R * F * isz + F * isz, 10 * R * F))
    bwd.update(timings(fb.bias_gelu_bwd, fb.bias_gelu_bwd_plain, bufs))
    bwd.update(bound(3 * R * F * isz + F * (isz + 4), 20 * R * F))
    results["bias_gelu_fwd"] = [fwd]
    results["bias_gelu_bwd"] = [bwd]
    del bufs
    torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------------ #
# phase 16: the input pipeline and the training follow-ups
# ------------------------------------------------------------------ #


def datapipe_config(obs, prefetch=True):
    """configs/gpt_125m_datapipe.json as written, with the cuts PERF.md
    section 4 lists: the bundled corpus for data/pile_tokens/, micro-batch
    16 x 4 accumulation steps at one rank (the file's 512), the
    scheduler's warmup and the curriculum's cut, the monitor's obs_dir in
    ``obs`` with an ephemeral metrics port, and the kernels block.
    ``prefetch`` False turns the producer thread off (the pipe then
    collates and stages in the step loop)."""
    with open(DATAPIPE_CONFIG) as f:
        config = json.load(f)
    config["train_batch_size"] = DATAPIPE_MICRO * DATAPIPE_GAS
    config["train_micro_batch_size_per_gpu"] = DATAPIPE_MICRO
    config["scheduler"]["params"]["warmup_num_steps"] = DATAPIPE_WARMUP
    dp = config["datapipe"]
    dp["source"] = str(ROOT / "data" / "corpus_tokens.npy")
    dp["curriculum"]["warmup_steps"] = DATAPIPE_CURRICULUM_STEPS
    dp["prefetch"] = prefetch
    config["monitor"] = dict(config["monitor"], obs_dir=str(obs),
                             metrics_port=0)
    config["kernels"] = {"mode": "auto"}
    return config


def datapipe_model():
    from deeperspeed_tpu_torch.models.gpt import get_preset

    return get_preset("neox-125m", max_seq=1024, remat_policy="matmuls",
                      ce_chunk=0, dtype=torch.bfloat16)


def datapipe_params(cfg, seed):
    from deeperspeed_tpu_torch.models.gpt import init_params

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(gen, cfg, device="cuda", dtype=torch.bfloat16)
    randomize_affine(params, gen)
    return params


def sha(array) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(array, np.int64)).tobytes()).hexdigest()


def active_seq(batch, pad_id):
    """The active sequence length of a (rows, seq + 1) batch, read from
    its pad columns: the index of the last column holding a token."""
    live = (np.asarray(batch) != pad_id).any(axis=0).nonzero()[0]
    return int(live.max())


def host_stream(config, steps):
    """The hashes and active lengths of a synchronous host-only pipe's
    first ``steps`` global batches (prefetch and staging off), and the
    batches."""
    from deeperspeed_tpu_torch.datapipe import DataPipeConfig, build_datapipe

    block = dict(config["datapipe"], prefetch=False, stage_to_device=False)
    pipe = build_datapipe(DataPipeConfig.from_dict(block),
                          global_rows=config["train_batch_size"],
                          device="cpu")
    batches = [pipe.next_global_batch()[0] for _ in range(steps)]
    pad = block.get("pad_id", 0)
    return {"hashes": [sha(b) for b in batches],
            "active": [active_seq(b, pad) for b in batches],
            "batches": batches}


def watch_pipe(engine):
    """Wrap the engine's pipe: every global batch it hands over is cloned
    on the consumer's stream (after the staging wait, before the step
    reads it; no host sync), with the step's host stall and the queue
    depth it left."""
    seen = {"batches": [], "stall_s": [], "queued": [], "placed": []}
    pull = engine.datapipe.next_global_batch

    def watched():
        batch, placed = pull()
        seen["batches"].append(batch.clone() if isinstance(
            batch, torch.Tensor) else np.array(batch))
        seen["stall_s"].append(engine.datapipe.last_stall_seconds)
        seen["queued"].append(engine.datapipe.queued)
        seen["placed"].append(placed)
        return batch, placed

    engine.datapipe.next_global_batch = watched
    return seen


def pipe_steps(engine, counters, steps, after_step=None):
    """``steps`` train_batch() calls (the pipe supplies each batch) with
    every launch counter set to 0 just before and read just after:
    losses, grad norms, step times, launches and the peak memory."""
    losses, norms, step_s = [], [], []
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    for _ in range(steps):
        t0 = time.perf_counter()
        loss = engine.train_batch()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
        norms.append(engine.get_global_grad_norm())
        if after_step is not None:
            after_step(len(losses))
    return {"losses": losses, "grad_norms": norms, "step_s": step_s,
            "launches": {n: fn.launches for n, fn in counters.items()},
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def datapipe_expected(cfg):
    """Launches per step of the 125M step under remat "matmuls" at
    DATAPIPE_GAS micro-batches (phase 14's plan at one rank)."""
    L, gas = cfg.n_layer, DATAPIPE_GAS
    return {"flash_fwd": L * gas, "flash_bwd": L * gas, "ln_fwd": gas,
            "ln_bwd": gas, "bias_gelu_fwd": 2 * L * gas,
            "bias_gelu_bwd": L * gas, "add_ln_fwd": 0, "add_ln_bwd": 0,
            "supertile_fwd": 0, "supertile_bwd": 0,
            # every leaf an fp32 master with a bf16 cast: one combination
            "fused_adam": 1, "sparse_fwd": 0, "sparse_bwd": 0,
            "quantize_rows": 0, "dequant_sum_rows": 0, "dequant_rows": 0}


def check_stream(name, seen, host, first=0):
    """Every batch the engine consumed, hashed on the host after the run,
    equal to the host pipe's batch of the same step; its active length
    the curriculum's."""
    got = [sha(b.cpu().numpy() if isinstance(b, torch.Tensor) else b)
           for b in seen["batches"]]
    want = host["hashes"][first:first + len(got)]
    if got != want:
        bad = [first + i for i, (a, b) in enumerate(zip(got, want))
               if a != b]
        raise AssertionError(f"{name}: staged batches of steps {bad} differ "
                             f"from the host pipe's")
    if not all(seen["placed"]):
        raise AssertionError(f"{name}: a batch was not staged: "
                             f"{seen['placed']}")
    return len(got)


def pipe_report(run, seen, tokens, profile):
    """Step time (the median of steps 2 to DATAPIPE_OFF_STEPS, the steps
    both runs take before any checkpoint, and of every step after the
    first), tokens/s at the former, the host stall, the queue depth, the
    busy share of one profiled step and the peak memory."""
    step_ms = statistics.median(run["step_s"][1:DATAPIPE_OFF_STEPS]) * 1e3
    return {"step_ms_median_2_6": step_ms,
            "step_ms_median_all": statistics.median(run["step_s"][1:]) * 1e3,
            "tokens_per_s": tokens / step_ms * 1e3,
            "host_stall_ms_median": statistics.median(seen["stall_s"]) * 1e3,
            "host_stall_ms_max": max(seen["stall_s"]) * 1e3,
            "queue_depth_after_pull": seen["queued"],
            "device_busy_share": profile["device_busy_share"],
            "profile_wall_ms": profile["wall_ms"],
            "profile_device_ms": profile["device_ms"],
            "peak_mem_gib": run["peak_mem_gib"]}


def datapipe_phase(card):
    """Phase 16a: configs/gpt_125m_datapipe.json trains GPT-NeoX-125M
    through initialize -> train_batch() with no batch passed; see the
    module docstring. Returns the launches of its 12 steps and the
    launches per step, and the engine (for 16c)."""
    import shutil

    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.datapipe import SeqLenCurriculum
    from deeperspeed_tpu_torch.models.gpt import make_gpt
    from deeperspeed_tpu_torch.ops import kernel_config

    obs = Path(tempfile.mkdtemp(prefix="chip_smoke_datapipe_"))
    cfg = datapipe_model()
    config = datapipe_config(obs / "a")
    rows = config["train_batch_size"]
    cur = config["datapipe"]["curriculum"]
    schedule = SeqLenCurriculum(cfg.max_seq, cur["start_seq_len"],
                                cur["warmup_steps"], cur["num_intervals"])
    print(f"datapipe: configs/gpt_125m_datapipe.json, source "
          f"data/pile_tokens/ -> data/corpus_tokens.npy, train_batch_size "
          f"512 -> {rows} ({DATAPIPE_MICRO} x {DATAPIPE_GAS}, one rank), "
          f"warmup_num_steps 2000 -> {DATAPIPE_WARMUP}, curriculum "
          f"warmup_steps 2000 -> {DATAPIPE_CURRICULUM_STEPS} (stages "
          f"{schedule.schedule}), monitor obs_dir temporary and "
          f"metrics_port 0, kernels auto", flush=True)
    t0 = time.perf_counter()
    host = host_stream(config, DATAPIPE_STEPS)
    host_s = time.perf_counter() - t0
    want_active = [schedule.seq_len_at(i) for i in range(DATAPIPE_STEPS)]
    if host["active"] != want_active:
        raise AssertionError(f"active lengths {host['active']}, the "
                             f"schedule {want_active}")
    expected = datapipe_expected(cfg)
    tokens = rows * cfg.max_seq
    loss_fn = make_gpt(cfg)[2]
    saved = {}

    with kernel_config.override():
        engine, _, loader, _ = ds.initialize(
            model=loss_fn, model_parameters=datapipe_params(cfg, SEED),
            config=config)
        if loader is not None or engine.datapipe is None:
            raise AssertionError("initialize built no datapipe")
        seen = watch_pipe(engine)

        def after_step(step):
            if step == DATAPIPE_SAVE_AFTER:
                torch.cuda.synchronize()
                saved["queued_at_save"] = engine.datapipe.queued
                shutil.rmtree(DATAPIPE_CKPT, ignore_errors=True)
                t1 = time.perf_counter()
                engine.save_checkpoint(str(DATAPIPE_CKPT))
                saved["save_s"] = time.perf_counter() - t1
                saved["data_state"] = engine.datapipe.state_dict()

        run = pipe_steps(engine, kernel_counters(), DATAPIPE_STEPS,
                         after_step=after_step)
        per_step = check_run_pipe(run, engine, expected, DATAPIPE_STEPS)
        check_stream("16a", seen, host)
        snap = engine.monitor.registry.snapshot_scalars()
        if snap.get("datapipe_batches_total") != DATAPIPE_STEPS or any(
                n not in snap for n in (
                    "datapipe_host_stall_seconds", "datapipe_queue_depth",
                    "datapipe_epoch")):
            raise AssertionError(f"datapipe metrics: {sorted(snap)}")
        if "datapipe_host_stall_seconds_hist_bucket" not in \
                engine.monitor.registry.render():
            raise AssertionError("no datapipe_host_stall_seconds_hist")
        profile_on = profile_training(engine, None)
        on = pipe_report(run, seen, tokens, profile_on)
        followups = store_and_capture(engine, loss_fn, host["batches"][0])
        engine.datapipe.close()
        files_a = close_monitor(obs / "a")
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    resume = datapipe_resume(cfg, loss_fn, obs, host, run, saved)
    off, off_run = datapipe_prefetch_off(cfg, loss_fn, obs, host, expected)
    shutil.rmtree(obs, ignore_errors=True)
    shutil.rmtree(DATAPIPE_CKPT, ignore_errors=True)
    report = {
        "model": "neox-125m", "card": card, "layers": cfg.n_layer,
        "d_model": cfg.d_model, "seq": cfg.max_seq,
        "remat_policy": cfg.remat_policy, "micro_batch": DATAPIPE_MICRO,
        "grad_accum": DATAPIPE_GAS, "steps": DATAPIPE_STEPS,
        "losses": run["losses"], "grad_norms": run["grad_norms"],
        "step_s": run["step_s"], "active_seq": host["active"],
        "host_pipe_s": host_s, "batches_hashed": DATAPIPE_STEPS,
        "launches_per_step": per_step,
        "checkpoint": {k: saved[k] for k in ("save_s", "queued_at_save",
                                              "data_state")},
        "resume": resume, "prefetch_on": on, "prefetch_off": off,
        "prefetch_off_steps": off_run, "monitor_files": files_a,
        "followups": followups}
    print("datapipe 16a: " + json.dumps(report), flush=True)
    return run["launches"], per_step


def check_run_pipe(run, engine, expected, steps):
    """16a's gates on a run: launches per step as planned, losses and
    grad norms finite, no step skipped."""
    per_step = {k: n / steps for k, n in run["launches"].items()}
    if per_step != expected:
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{expected}")
    if not all(math.isfinite(x) for x in run["losses"] + run["grad_norms"]):
        raise AssertionError(f"losses {run['losses']}, grad norms "
                             f"{run['grad_norms']}")
    if engine.skipped_steps:
        raise AssertionError(f"skipped {engine.skipped_steps} steps")
    return per_step


def datapipe_resume(cfg, loss_fn, obs, host, run, saved):
    """A fresh engine from weights of another seed, its prefetch queue
    already holding batches of step 0, loads the checkpoint of step
    DATAPIPE_SAVE_AFTER and runs the remaining steps: batches and losses
    bit-identical to the uninterrupted run's."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.ops import kernel_config

    config = datapipe_config(obs / "b")
    with kernel_config.override():
        engine, _, _, _ = ds.initialize(
            model=loss_fn, model_parameters=datapipe_params(cfg, SEED + 1),
            config=config)
        deadline = time.time() + 30
        while engine.datapipe.queued == 0 and time.time() < deadline:
            time.sleep(0.01)
        queued = engine.datapipe.queued
        if queued == 0 or saved["queued_at_save"] == 0:
            raise AssertionError(f"prefetch queue empty at the save "
                                 f"({saved['queued_at_save']}) or the "
                                 f"resume ({queued})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.load_checkpoint(str(DATAPIPE_CKPT))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        if engine.datapipe.state_dict() != saved["data_state"]:
            raise AssertionError(f"restored DataState "
                                 f"{engine.datapipe.state_dict()}, saved "
                                 f"{saved['data_state']}")
        seen = watch_pipe(engine)
        steps = DATAPIPE_STEPS - DATAPIPE_SAVE_AFTER
        res = pipe_steps(engine, kernel_counters(), steps)
        check_stream("16a resume", seen, host, first=DATAPIPE_SAVE_AFTER)
        engine.datapipe.close()
        close_monitor(obs / "b")
    want = run["losses"][DATAPIPE_SAVE_AFTER:]
    if res["losses"] != want:
        raise AssertionError(f"resumed losses {res['losses']}, "
                             f"uninterrupted {want}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {"queued_at_resume": queued, "load_s": load_s,
            "losses": res["losses"], "bit_identical": True,
            "batches_hashed": steps}


def datapipe_prefetch_off(cfg, loss_fn, obs, host, expected):
    """The same config with the producer thread off: the pipe collates
    and stages in the step loop. Its batches are held to the host pipe's
    too; its timings are printed beside the prefetched run's."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.ops import kernel_config

    config = datapipe_config(obs / "c", prefetch=False)
    with kernel_config.override():
        engine, _, _, _ = ds.initialize(
            model=loss_fn, model_parameters=datapipe_params(cfg, SEED),
            config=config)
        seen = watch_pipe(engine)
        run = pipe_steps(engine, kernel_counters(), DATAPIPE_OFF_STEPS)
        check_run_pipe(run, engine, expected, DATAPIPE_OFF_STEPS)
        check_stream("16a prefetch off", seen, host)
        profile = profile_training(engine, None)
        engine.datapipe.close()
        close_monitor(obs / "c")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    report = pipe_report(run, seen, DATAPIPE_MICRO * DATAPIPE_GAS
                         * cfg.max_seq, profile)
    return report, {"losses": run["losses"], "step_s": run["step_s"]}


def store_and_capture(engine, loss_fn, batch):
    """16c on the datapipe engine, after its run: one more step with
    ``store_gradients`` and the layer-output hooks on. The stored grads
    must equal the unfused backward's (the micro-batches' grads of the
    pre-step params, summed in fp32 in order) within STORE_GRADS_ATOL of
    the largest; the hooks must give one finite (rows, seq, d_model)
    output for each of the 12 layers."""
    from deeperspeed_tpu_torch.ops.adam import tree_leaves, tree_map

    params = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                      engine.params)
    leaves = tree_leaves(params)
    tokens = torch.from_numpy(np.asarray(batch, np.int64)).cuda()
    m = tokens.shape[0] // DATAPIPE_GAS
    want = None
    for i in range(DATAPIPE_GAS):
        loss = loss_fn(params, tokens[i * m:(i + 1) * m])
        g = [x.float() for x in torch.autograd.grad(loss.float(), leaves)]
        want = g if want is None else [a.add_(b) for a, b in zip(want, g)]
        del loss, g
    del params, leaves
    engine.store_gradients = True
    engine.register_forward_hook(layer_name_pattern="transformerlayer")
    engine.train_batch(np.asarray(batch))
    engine.store_gradients = False
    stored = tree_leaves(engine.stored_gradients)
    worst = max(float((a - b).abs().max()) for a, b in zip(stored, want))
    scale = max(float(b.abs().max()) for b in want)
    same = all(torch.equal(a, b) for a, b in zip(stored, want))
    if worst > STORE_GRADS_ATOL * scale:
        raise AssertionError(f"stored grads differ from the unfused "
                             f"backward's by {worst} (largest grad "
                             f"{scale})")
    outs = engine.layer_outputs.get("transformerlayer", [])
    shape = (batch.shape[0], batch.shape[1] - 1,
             engine.params["embed"]["wte"].shape[1])
    if len(outs) != datapipe_model().n_layer or not all(
            o is not None and o.shape == shape and np.isfinite(o).all()
            for o in outs):
        raise AssertionError(f"layer outputs: {len(outs)} of shapes "
                             f"{[getattr(o, 'shape', None) for o in outs]}")
    engine.remove_forward_hooks()
    engine.stored_gradients = None
    del want, stored, outs
    return {"store_gradients_max_abs_err": worst,
            "store_gradients_largest": scale,
            "store_gradients_bit_identical": same,
            "layer_outputs": datapipe_model().n_layer,
            "layer_output_shape": list(shape)}


def remat_phase(card):
    """Phase 16b: one micro-batch's loss and grads of the 125M model, the
    same weights and tokens, under each remat policy. Returns the
    launches of the five runs together."""
    from deeperspeed_tpu_torch.models.gpt import make_gpt
    from deeperspeed_tpu_torch.ops import kernel_config
    from deeperspeed_tpu_torch.ops.adam import tree_leaves

    cfg = datapipe_model()
    params = datapipe_params(cfg, SEED)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    corpus = np.load(ROOT / "data" / "corpus_tokens.npy", mmap_mode="r")
    tokens = torch.from_numpy(np.asarray(
        corpus[:DATAPIPE_MICRO * (cfg.max_seq + 1)], np.int64).reshape(
        DATAPIPE_MICRO, cfg.max_seq + 1)).cuda()
    counters = kernel_counters()
    total = {n: 0 for n in counters}
    out = {}
    L = cfg.n_layer
    with kernel_config.override(mode="auto"):
        for policy in REMAT_POLICIES:
            loss_fn = make_gpt(dataclasses.replace(
                cfg, remat_policy=policy))[2]
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            loss = loss_fn(params, tokens)
            grads = torch.autograd.grad(loss, leaves)
            loss = loss.detach()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {n: fn.launches for n, fn in counters.items()}
            for n, k in launches.items():
                total[n] += k
            norm = float(torch.sqrt(sum(g.float().square().sum()
                                        for g in grads)))
            out[policy] = {
                "loss": loss.item(), "grad_norm": norm, "seconds": seconds,
                "peak_activation_gib": (torch.cuda.max_memory_allocated()
                                        - base) / 2**30,
                "flash_fwd": launches["flash_fwd"],
                "flash_bwd": launches["flash_bwd"]}
            del loss, grads
    full = out["full"]
    for policy, r in out.items():
        fwd = L * (1 if policy in ("flash", "matmuls") else 2)
        if (r["flash_fwd"], r["flash_bwd"]) != (fwd, L):
            raise AssertionError(f"remat {policy}: flash_fwd "
                                 f"{r['flash_fwd']}, flash_bwd "
                                 f"{r['flash_bwd']}; expected {fwd}, {L}")
        if abs(r["loss"] - full["loss"]) > REMAT_LOSS_RTOL * abs(
                full["loss"]) or not math.isfinite(r["loss"]):
            raise AssertionError(f"remat {policy} loss {r['loss']}, full "
                                 f"{full['loss']}")
        if abs(r["grad_norm"] - full["grad_norm"]) > REMAT_NORM_RTOL * \
                full["grad_norm"]:
            raise AssertionError(f"remat {policy} grad norm "
                                 f"{r['grad_norm']}, full "
                                 f"{full['grad_norm']}")
    print("datapipe 16b: " + json.dumps({
        "card": card, "model": "neox-125m", "tokens": list(tokens.shape),
        "loss_rtol": REMAT_LOSS_RTOL, "grad_norm_rtol": REMAT_NORM_RTOL,
        "policies": out}), flush=True)
    del params, leaves, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return total


def optimizers_phase(card):
    """Phase 16c's optimizers over the 125M leaves: two SGD steps
    (momentum, Nesterov, weight decay) on the card against the same steps
    on the CPU; FP16_Optimizer(FusedAdam) for 3 steps with a dynamic
    scale, the second step's gradients holding an inf: skipped, the scale
    halved, the fused Adam kernel launched on the other two."""
    from deeperspeed_tpu_torch.ops import fused_adam as fad
    from deeperspeed_tpu_torch.ops import kernel_config
    from deeperspeed_tpu_torch.ops.adam import FusedAdam, tree_map
    from deeperspeed_tpu_torch.ops.sgd import SGD
    from deeperspeed_tpu_torch.runtime.fp16 import FP16_Optimizer

    cfg = datapipe_model()
    params = tree_map(lambda p: p.float(), datapipe_params(cfg, SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    grads = [tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                            device="cuda") * 1e-3, params)
             for _ in range(2)]
    opt = SGD(lr=0.01, momentum=0.9, nesterov=True, weight_decay=1e-4)
    cpu_p = tree_map(lambda p: p.cpu(), params)
    card_p = tree_map(lambda p: p.clone(), params)
    cpu_s, card_s = opt.init(cpu_p), opt.init(card_p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for g in grads:
        card_p, card_s = opt.update(g, card_s, card_p)
    torch.cuda.synchronize()
    sgd_s = (time.perf_counter() - t0) / len(grads)
    for g in grads:
        cpu_p, cpu_s = opt.update(tree_map(lambda t: t.cpu(), g), cpu_s,
                                  cpu_p)
    from deeperspeed_tpu_torch.ops.adam import tree_leaves

    sgd_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree_leaves(card_p) + tree_leaves(card_s.momentum_buf),
        tree_leaves(cpu_p) + tree_leaves(cpu_s.momentum_buf)))
    if sgd_err > SGD_ATOL:
        raise AssertionError(f"SGD on the card differs from the CPU by "
                             f"{sgd_err}")
    del cpu_p, cpu_s, card_p, card_s
    scales, skipped = [], []
    with kernel_config.override(mode="auto"):
        fad.fused_adam.launches = 0
        wrap = FP16_Optimizer(FusedAdam(lr=1e-4), params,
                              dynamic_loss_scale=True,
                              dynamic_loss_args={"init_scale": 2.0 ** 16},
                              clip_grad=1.0, verbose=False)
        before = tree_leaves(wrap.fp32_params)[0].clone()
        for step in range(3):
            g = tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                               device="cuda") * 1e-3
                         * wrap.cur_scale, params)
            if step == 1:
                tree_leaves(g)[3].view(-1)[7] = float("inf")
            scales.append(wrap.cur_scale)
            skipped.append(wrap.step(g))
            if step == 0:
                per_step = fad.fused_adam.launches
        scales.append(wrap.cur_scale)
        launches = fad.fused_adam.launches
    moved = not torch.equal(before, tree_leaves(wrap.fp32_params)[0])
    if skipped != [False, True, False] or scales[2] != scales[1] / 2 or \
            per_step < 1 or launches != 2 * per_step or not moved:
        raise AssertionError(f"FP16_Optimizer skipped {skipped}, scales "
                             f"{scales}, fused_adam launches {launches}, "
                             f"params moved {moved}")
    report = {"card": card, "leaves": len(tree_leaves(params)),
              "elements": sum(p.numel() for p in tree_leaves(params)),
              "sgd_max_abs_err_vs_cpu": sgd_err, "sgd_step_ms": sgd_s * 1e3,
              "fp16_optimizer": {"skipped": skipped, "scales": scales,
                                 "fused_adam_launches": launches}}
    print("datapipe 16c: " + json.dumps(report), flush=True)
    del wrap, params, grads
    gc.collect()
    torch.cuda.empty_cache()


def spec_kernel_cases(fb, gen):
    """ln_fwd at (VERIFY_ROWS, 768) and bias_gelu_fwd (tanh) at
    (VERIFY_ROWS, 3072), bf16, the rows and widths GPT-NeoX-125M's verify
    step gives them, against their plain versions (TOL, REL_L2) and timed
    beside the plain version, F.layer_norm (none computes bias+GeLU in one
    call) and the bound ("path": "spec")."""
    dtype = torch.bfloat16
    tol, rel, isz = TOL[dtype], REL_L2[dtype], 2
    R, D, F = VERIFY_ROWS, 768, 3072
    w = randn_on(gen, (D,), torch.float32, 0.1, 1.0)
    b = randn_on(gen, (D,), torch.float32, 0.1)

    def ln_case():
        return randn_on(gen, (R, D), dtype, 2.0, 0.5), w, b, 1e-5

    args = ln_case()
    y, mu, rs = fb.ln_fwd(*args)
    torch.cuda.synchronize()
    py, pmu, prs = fb.ln_fwd_plain(*args)
    err, rel_err = check_close(f"ln_fwd {R}x{D} bf16", y, py, tol, rel)
    check_outputs(f"ln_fwd {R}x{D} stats", ("mean", "rstd"), (mu, rs),
                  (pmu, prs), 2e-5, rel)
    ln = {"shape": [R, D], "dtype": "bfloat16", "path": "spec",
          "max_abs_err": err, "tol": tol, "rel_l2_err": rel_err,
          "rel_l2_tol": rel, "library": "F.layer_norm"}
    bufs = copies(ln_case, R * D * isz)
    lib_bufs = [(a[0], (D,), w.to(dtype), b.to(dtype), 1e-5) for a in bufs]
    ln.update(timings(fb.ln_fwd, fb.ln_fwd_plain, bufs,
                      torch.nn.functional.layer_norm, lib_bufs))
    ln.update(bound(2 * R * D * isz + 2 * D * 4 + 2 * R * 4, 8 * R * D))
    del bufs, lib_bufs

    def bg_case():
        return (randn_on(gen, (R, F), dtype, 2.0), randn_on(gen, (F,), dtype),
                True)

    args = bg_case()
    y = fb.bias_gelu_fwd(*args)
    torch.cuda.synchronize()
    err, rel_err = check_close(f"bias_gelu_fwd {R}x{F} bf16", y,
                               fb.bias_gelu_fwd_plain(*args), tol, rel)
    bg = {"shape": [R, F], "dtype": "bfloat16", "approximate": True,
          "path": "spec", "max_abs_err": err, "tol": tol,
          "rel_l2_err": rel_err, "rel_l2_tol": rel, "library": None}
    bufs = copies(bg_case, R * F * isz)
    bg.update(timings(fb.bias_gelu_fwd, fb.bias_gelu_fwd_plain, bufs))
    bg.update(bound(2 * R * F * isz + F * isz, 10 * R * F))
    del bufs
    return {"ln_fwd": [ln], "bias_gelu_fwd": [bg]}


def spec_model():
    """GPT-NeoX-125M at full width and depth, bf16, weights from SEED
    with random biases and layer-norm affines."""
    from deeperspeed_tpu_torch.models.gpt import get_preset, init_params

    cfg = get_preset("neox-125m", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    params = init_params(gen, cfg, device="cuda", dtype=torch.bfloat16)
    randomize_affine(params, gen)
    return cfg, params


def spec_requests(vocab):
    """Phase 17a's 16 requests (and 17c's): rid, prompt, temperature and
    seed; SPEC_SAMPLED's at SPEC_TEMPERATURE with their fixed seeds."""
    host = torch.Generator().manual_seed(SEED + 17)
    prompts = [torch.randint(0, vocab, (n,), generator=host).tolist()
               for n in SPEC_LENS]
    for a, b in SPEC_SHARED:
        prompts[b][:SPEC_PREFIX] = prompts[a][:SPEC_PREFIX]
    return [{"rid": f"spec-{i}", "prompt": p,
             "temperature": SPEC_TEMPERATURE if i in SPEC_SAMPLED else 0.0,
             "seed": SPEC_SAMPLED.get(i, 1000 + i)}
            for i, p in enumerate(prompts)]


def fleet_requests(vocab):
    """Phase 17b's requests: FLEET_GREEDY greedy and FLEET_SAMPLED sampled,
    prompts of 16 to FLEET_PROMPT_MAX tokens."""
    host = torch.Generator().manual_seed(SEED + 170)
    n = FLEET_GREEDY + FLEET_SAMPLED
    lens = torch.randint(16, FLEET_PROMPT_MAX + 1, (n,), generator=host)
    sampled = set(range(0, n, n // FLEET_SAMPLED))
    return [{"rid": f"fleet-{i}",
             "prompt": torch.randint(0, vocab, (int(L),),
                                     generator=host).tolist(),
             "temperature": SPEC_TEMPERATURE if i in sampled else 0.0,
             "seed": 2000 + i} for i, L in enumerate(lens)]


def serve_requests(engine, reqs, new):
    """Submit every request at once and run the engine dry: ({rid:
    tokens}, wall seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r["prompt"], max_new_tokens=new,
                      temperature=r["temperature"], request_id=r["rid"],
                      seed=r["seed"])
    outs = engine.run()
    torch.cuda.synchronize()
    return {r["rid"]: outs[r["rid"]] for r in reqs}, time.perf_counter() - t0


def near_tie(cfg, params, req, want, got, top_k):
    """None when ``got`` equals ``want``; else the record of the first
    position they differ at, with ``ok`` true only at a near tie there:
    where logits that move by ``delta`` (NEAR_TIE times the largest
    |logit|) can turn the selection of one token into the other. The
    logits are recomputed from the prompt and ``want``'s tokens before the
    position by one dense forward. Greedy: the top-1 minus top-2 logit gap
    is at most ``delta``. Sampled (the best of the top_k filtered logits
    over the temperature plus the request key's Gumbel noise): both tokens
    are within ``delta`` of the top-k (their logits at least the k-th's
    less ``delta``), and either their scores are within ``delta`` over the
    temperature or the better-scoring one sits at the filter's edge (its
    logit within ``delta`` of the k-th's, so ``delta`` can take it out)."""
    from deeperspeed_tpu_torch.models.generation import (apply_with_cache,
                                                         init_cache)
    from deeperspeed_tpu_torch.serving.engine import request_sample_key

    if got == want:
        return None
    pos = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
               min(len(want), len(got)))
    if pos >= min(len(want), len(got)):
        return {"rid": req["rid"], "position": pos, "ok": False,
                "lengths": [len(want), len(got)]}
    dev = "cuda"
    toks = torch.tensor([req["prompt"] + want[:pos]], device=dev)
    cache = init_cache(cfg, 1, toks.shape[1], dev)
    logits = apply_with_cache(cfg, params, toks, cache, 0)[0][0, -1].float()
    delta = NEAR_TIE * float(logits.abs().max())
    pair = (want[pos], got[pos])
    rec = {"rid": req["rid"], "position": pos, "delta": delta,
           "want": pair[0], "got": pair[1]}
    if req["temperature"] <= 0:
        top = torch.topk(logits, 2).values
        rec["gap"] = float(top[0] - top[1])
        rec["ok"] = rec["gap"] <= delta
        return rec
    temp = req["temperature"]
    u = torch.rand(logits[None].shape, device=dev,
                   generator=request_sample_key(req["seed"], pos, dev))
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)[0]
    score = logits / temp - torch.log(-torch.log(u))
    kth = float(torch.topk(logits, top_k).values[-1])
    lw, lg = (float(logits[t]) for t in pair)
    sw, sg = (float(score[t]) for t in pair)
    edge = lw - kth if sw >= sg else lg - kth
    rec.update(gap=abs(sw - sg), logits_minus_kth=[lw - kth, lg - kth])
    rec["ok"] = (min(lw, lg) >= kth - delta
                 and (abs(sw - sg) <= delta / temp or abs(edge) <= delta))
    return rec


def held_to(cfg, params, reqs, want, got, top_k, label):
    """Every request of ``got`` equal to ``want`` or differing first at a
    near tie; returns the differing requests' records."""
    diffs = [d for d in (near_tie(cfg, params, r, want[r["rid"]],
                                  got[r["rid"]], top_k) for r in reqs)
             if d is not None]
    bad = [d for d in diffs if not d["ok"]]
    print(f"{label}: {len(diffs)} of {len(reqs)} requests differ, "
          f"{len(bad)} not at a near tie: " + json.dumps(diffs), flush=True)
    if bad:
        raise AssertionError(f"{label}: tokens differ away from a near tie: "
                             f"{bad}")
    return diffs


def counted(fn, calls, key):
    """``fn`` counting its calls in ``calls[key]``."""
    def call(*args, **kwargs):
        calls[key] += 1
        return fn(*args, **kwargs)
    return call


def spec_serving_phase(fb, card, cfg, params, obs):
    """Phase 17a (module docstring). Returns the launch counts of the
    speculative run and its tokens by rid."""
    from deeperspeed_tpu_torch.models.generation import init_cache
    from deeperspeed_tpu_torch.monitor import (reqledger, shutdown_monitor,
                                               validate_events)
    from deeperspeed_tpu_torch.ops import kernel_config
    from deeperspeed_tpu_torch.serving import FINISH_LENGTH, ServingEngine
    from deeperspeed_tpu_torch.serving.metrics import DECODE_TIMER

    raw = json.loads(SPEC_CONFIG.read_text())
    block = {k: v for k, v in raw["serving"].items() if k != "fleet"}
    block["top_k"] = SPEC_TOP_K
    kernel_config.configure(**kernel_config.validate({"mode": "auto"}))
    engine = ServingEngine(cfg, params, block, monitor_config={
        **raw["monitor"], **SERVING_MONITOR, "obs_dir": str(obs)})
    spec = engine._spec
    K, draft_layers = spec.K, spec.dcfg.n_layer
    calls = {"prefill": 0, "decode": 0, "draft": 0, "verify": 0}
    engine._forward = counted(engine._forward, calls, "prefill")
    engine._decode_step = counted(engine._decode_step, calls, "decode")
    spec._draft_step = counted(spec._draft_step, calls, "draft")
    spec._verify_step = counted(spec._verify_step, calls, "verify")
    reqs = spec_requests(cfg.vocab_size)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fb.ln_fwd.launches = 0
    fb.bias_gelu_fwd.launches = 0
    outs, wall_s = serve_requests(engine, reqs, SPEC_NEW)
    launches = {"ln_fwd": fb.ln_fwd.launches,
                "bias_gelu_fwd": fb.bias_gelu_fwd.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    m = engine.metrics
    target = calls["prefill"] + calls["decode"] + calls["verify"]
    draft = (K + 1) * calls["draft"] + m.spec_drafter_prefills
    want = {"ln_fwd": target + draft,
            "bias_gelu_fwd": cfg.n_layer * target + draft_layers * draft}
    if launches != want or min(launches.values()) <= 0:
        raise AssertionError(f"launches {launches}, the forwards imply "
                             f"{want} (calls {calls}, drafter prefills "
                             f"{m.spec_drafter_prefills})")
    for r in reqs:
        req = engine.get(r["rid"])
        if req.finish_reason != FINISH_LENGTH or \
                len(outs[r["rid"]]) != SPEC_NEW:
            raise AssertionError(f"{r['rid']}: {req.finish_reason}, "
                                 f"{len(outs[r['rid']])} tokens")
    if m.spec_rounds <= 0 or calls["verify"] <= 0 or m.spec_accepted <= 0:
        raise AssertionError(f"no draft accepted: {m.summary()}")
    sigs = {"decode": engine.decode_compile_count,
            "draft": engine.draft_compile_count,
            "verify": engine.verify_compile_count}
    if sigs != {"decode": 1, "draft": 1, "verify": 1}:
        raise AssertionError(f"decode-path signatures {sigs}, expected one "
                             f"each (three)")

    mon = engine.telemetry
    events = mon.tracer.to_dict()["traceEvents"]
    names = [e["name"] for e in events]
    problems = validate_events(events, strict=True)
    missing = {"spec/draft", "spec/verify", "spec/accept",
               "serving/decode", "serving/prefill"} - set(names)
    if problems or missing or mon.watchdog.fired or \
            names.count("spec/verify") != calls["verify"]:
        raise AssertionError(f"17a trace: problems {problems[:5]}, missing "
                             f"{sorted(missing)}, watchdog "
                             f"{mon.watchdog.fired}, "
                             f"{names.count('spec/verify')} spec/verify "
                             f"for {calls['verify']} verify steps")
    ledger = reqledger.build_ledger(events)
    short = {rid: row["cost"]["tokens_final"]
             for rid, row in ledger["requests"].items()
             if row["cost"]["tokens_final"] != SPEC_NEW}
    if sorted(ledger["requests"]) != sorted(outs) or short:
        raise AssertionError(f"17a ledger: {sorted(ledger['requests'])}, "
                             f"token counts {short}")
    s_on = m.summary()
    decode_s = m.timers(DECODE_TIMER).elapsed(reset=False)
    watchdog_counts = mon.watchdog.counts()
    shutdown_monitor(save=True)

    logit_errs = []
    for r in (reqs[0], reqs[-1]):
        L = len(r["prompt"])
        toks = np.zeros((1, engine.scfg.bucket_for(L)), np.int64)
        toks[0, :L] = r["prompt"]
        rows = {}
        for mode in ("auto", "off"):
            with kernel_config.override(mode=mode):
                cache = init_cache(cfg, 1, toks.shape[1], engine.device)
                rows[mode] = engine._forward(toks, cache, 0)[0][0, L - 1] \
                    .float()
        if int(torch.argmax(rows["auto"])) != outs[r["rid"]][0]:
            raise AssertionError(f"{r['rid']}: first token differs from the "
                                 f"recomputed kernel-path logits")
        err = float((rows["auto"] - rows["off"]).abs().max())
        scale = float(rows["off"].abs().max())
        if not math.isfinite(err) or err > LOGIT_TOL * scale:
            raise AssertionError(
                f"{r['rid']}: first-token logits differ by {err:.4f} between "
                f"the kernel and plain paths (limit {LOGIT_TOL} x "
                f"{scale:.3f})")
        logit_errs.append({"rid": r["rid"], "prompt_len": L,
                           "max_abs_err": err, "max_abs_logit": scale})
    del engine, spec
    gc.collect()
    torch.cuda.empty_cache()

    # the same requests on a spec-off engine over the same params
    off_block = {k: v for k, v in block.items() if k != "speculative"}
    off = ServingEngine(cfg, params, off_block)
    off_outs, off_wall_s = serve_requests(off, reqs, SPEC_NEW)
    s_off = off.metrics.summary()
    off_decode_s = off.metrics.timers(DECODE_TIMER).elapsed(reset=False)
    diffs = held_to(cfg, params, reqs, off_outs, outs, SPEC_TOP_K,
                    "spec 17a against spec off")
    del off

    sp = s_on["speculative"]
    decode_tokens = s_on["tokens_generated"] - s_on["prefills"]
    off_tokens = s_off["tokens_generated"] - s_off["prefills"]
    report = {
        "model": "neox-125m", "dtype": "bfloat16", "card": card,
        "requests": len(reqs), "sampled": len(SPEC_SAMPLED),
        "new_tokens": SPEC_NEW, "prompt_lens": list(SPEC_LENS),
        "draft_k": K, "drafter_layers": draft_layers,
        "launches": launches,
        "forwards": {"target": target, "drafter": draft,
                     "steps": calls},
        "launches_per_request": {k: v / len(reqs)
                                 for k, v in launches.items()},
        "signatures": sigs, "watchdog_counts": watchdog_counts,
        "accept_rate": sp["accept_rate"],
        # a speculating lane's tokens a round (1 on plain decode), and all
        # lanes' decode tokens over the target's decode-path forwards
        "tokens_per_spec_lane_round": sp["emitted"] * K / sp["drafted"],
        "decode_tokens_per_target_forward":
            decode_tokens / (calls["verify"] + calls["decode"]),
        "spec_rounds": sp["rounds"], "verify_steps": calls["verify"],
        "fallback_decode_steps": calls["decode"],
        "spec_fallback_lanes": sp["fallback_lanes"],
        "drafter_prefills": sp["drafter_prefills"],
        "draft_ms_per_round": sp["draft_time_s"] / calls["verify"] * 1e3,
        "verify_ms_per_round": sp["verify_time_s"] / calls["verify"] * 1e3,
        "prefix_reuse_hits": s_on["prefix_reuse"]["reuse_hits"],
        "prefill_chunks": s_on["prefix_reuse"]["prefill_chunks"],
        "preemptions": {"spec_on": s_on["preemptions"],
                        "spec_off": s_off["preemptions"]},
        "decode_tokens_per_s": {"spec_on": decode_tokens / decode_s,
                                "spec_off": off_tokens / off_decode_s},
        "ttft_p50_ms": {"spec_on": s_on["ttft_s"]["p50"] * 1e3,
                        "spec_off": s_off["ttft_s"]["p50"] * 1e3},
        "wall_s": {"spec_on": wall_s, "spec_off": off_wall_s},
        "peak_mem_gib": peak_gib, "differing_requests": len(diffs),
        "near_ties": diffs, "first_token_logits": logit_errs,
    }
    print("spec 17a: " + json.dumps(report), flush=True)
    return launches, outs


def replica_spec(cfg, block):
    """A replica worker's spec for the phase-17 model: its config, the
    checkpoint FLEET_CKPT holds, the card, kernels auto and ``block``."""
    gpt_kw = {k: v for k, v in dataclasses.asdict(cfg).items()
              if k != "dtype"}
    gpt_kw["dtype"] = "bfloat16"
    return {"gpt": gpt_kw, "init_seed": SEED, "device": "cuda",
            "weights": {"load_dir": str(FLEET_CKPT), "tag": FLEET_TAG},
            "kernels": {"mode": "auto"}, "serving": block,
            "poll_interval_s": 0.002}


def start_fleet(spec, n, faults, workdir):
    """``n`` SubprocessReplicas of ``spec`` (``faults``: replica index ->
    fault plan), started side by side; a replica that fails to start
    fails the phase with its stderr, after every other one is stopped."""
    from deeperspeed_tpu_torch.serving.fleet import SubprocessReplica

    fleet = []
    for i in range(n):
        rspec = dict(spec)
        if faults and i in faults:
            rspec["faults"] = dict(faults[i])
        fleet.append(SubprocessReplica(f"r{i}", rspec, workdir=workdir))
    errors = []

    def start(rep):
        try:
            rep.start()
        except RuntimeError as e:
            errors.append(f"{rep.name}: {e}")

    threads = [threading.Thread(target=start, args=(r,)) for r in fleet]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        stop_fleet(fleet)
        raise AssertionError("replicas failed to start:\n"
                             + "\n".join(errors))
    built = {r.name: r.ready_info.get("nvcc_s") for r in fleet}
    if any(v != 0 for v in built.values()):
        stop_fleet(fleet)
        raise AssertionError(f"a replica ran nvcc: {built}")
    return fleet


def stop_fleet(fleet):
    for rep in fleet:
        rep.stop()
        rep.kill()


def drive_fleet(router, reqs, new):
    """Submit every request to the router and run it until each is
    terminal: (outcomes, {rid: tokens}, wall seconds)."""
    t0 = time.perf_counter()
    for r in reqs:
        router.submit(r["prompt"], max_new_tokens=new,
                      temperature=r["temperature"], request_id=r["rid"],
                      seed=r["seed"])
    outcomes = router.run_until_idle(timeout_s=FLEET_RUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    return outcomes, {r["rid"]: router.result(r["rid"]).tokens
                      for r in reqs}, wall


def fleet_outcomes_ok(label, rids, outcomes, router):
    from deeperspeed_tpu_torch.serving import FINISH_LENGTH

    bad = {rid: outcomes.get(rid) for rid in rids
           if outcomes.get(rid) != FINISH_LENGTH}
    if bad:
        recs = {rid: {k: getattr(router.result(rid), k) for k in (
            "attempts", "assigned", "submit_t", "first_t", "finish_t")}
            for rid in bad}
        raise AssertionError(f"{label}: requests not finished by length: "
                             f"{bad} {recs}; router "
                             f"{router.metrics.summary()}")


def fleet_launches(fleet):
    """The kernel launches the replicas reported in their last
    heartbeats (since their warm-ups), summed."""
    total = {"ln_fwd": 0, "bias_gelu_fwd": 0}
    for rep in fleet:
        for k in total:
            total[k] += int(rep.launches.get(k, 0))
    if min(total.values()) <= 0:
        raise AssertionError(f"the replicas launched {total}")
    return total


def ttft_ms(summary):
    return {k: v * 1e3 for k, v in summary["router_ttft_s"].items()}


def fleet_phase(card, cfg, params, obs):
    """Phase 17b (module docstring). Returns the replicas' launch
    counts."""
    import shutil

    from deeperspeed_tpu_torch.checkpoint.serialization import (
        model_state_filename, save_tree)
    from deeperspeed_tpu_torch.monitor import (init_monitor,
                                               shutdown_monitor,
                                               validate_events)
    from deeperspeed_tpu_torch.serving import (FleetRouter, RouterConfig,
                                               ShedError)
    from deeperspeed_tpu_torch.serving.replica_worker import build_engine

    shutil.rmtree(FLEET_CKPT, ignore_errors=True)
    save_tree(str(FLEET_CKPT / FLEET_TAG / model_state_filename()),
              {"module": params})
    raw = json.loads(FLEET_CONFIG.read_text())
    block = dict(raw["serving"], top_k=SPEC_TOP_K)
    rcfg = RouterConfig.from_dict(block["fleet"])
    spec = replica_spec(cfg, block)
    reqs = fleet_requests(cfg.vocab_size)
    rids = [r["rid"] for r in reqs]

    # the reference: one unkilled engine in this process, from the spec
    ref_engine = build_engine(spec)
    ref, _ = serve_requests(ref_engine, reqs, FLEET_NEW)
    del ref_engine
    gc.collect()

    mon = init_monitor({"obs_dir": str(obs), "watchdog": "strict"})
    workdir = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    runs = {}
    fleet = start_fleet(spec, rcfg.num_replicas, None, workdir)
    spawn = {"healthy": {r.name: r.spawn_to_ready_s for r in fleet}}
    router = FleetRouter(fleet, rcfg)
    try:
        outcomes, got, wall = drive_fleet(router, reqs, FLEET_NEW)
        fleet_outcomes_ok("17b healthy", rids, outcomes, router)
        held_to(cfg, params, reqs, ref, got, SPEC_TOP_K,
                "fleet 17b healthy against one engine")
        runs["healthy"] = {"wall_s": wall,
                           "router_ttft_ms": ttft_ms(
                               router.metrics.summary()),
                           "progress": {r.name: r.progress for r in fleet}}
        # a burst of short requests against max_queue_depth
        shed_c = mon.registry.counter("serving_shed_total", "")
        shed0 = shed_c.value
        accepted, hints = [], []
        for i in range(FLEET_SHED_BURST):
            try:
                accepted.append(router.submit(
                    reqs[i % len(reqs)]["prompt"][:16],
                    max_new_tokens=FLEET_SHED_NEW,
                    request_id=f"burst-{i}"))
            except ShedError as e:
                hints.append(e.retry_after_s)
        want_shed = FLEET_SHED_BURST - rcfg.max_queue_depth
        if len(hints) != want_shed or min(hints, default=0) <= 0 or \
                shed_c.value - shed0 != want_shed:
            raise AssertionError(
                f"the burst shed {len(hints)} (hints {hints[:3]}), "
                f"serving_shed_total rose {shed_c.value - shed0}; expected "
                f"{want_shed}")
        burst = router.run_until_idle(timeout_s=FLEET_RUN_TIMEOUT_S)
        fleet_outcomes_ok("17b burst", accepted, burst, router)
        runs["shed"] = {"burst": FLEET_SHED_BURST, "accepted": len(accepted),
                        "shed": len(hints),
                        "retry_after_s": [min(hints), max(hints)]}
    finally:
        router.shutdown()
        stop_fleet(fleet)

    flags = tempfile.mkdtemp(prefix="chip_smoke_flags_")
    faults = {1: {"replica_sigkill_at_decode": FLEET_KILL_AT,
                  "flag_file": os.path.join(flags, "kill")},
              2: {"replica_stall_at_decode": FLEET_STALL_AT,
                  "flag_file": os.path.join(flags, "stall")}}
    fleet = start_fleet(spec, rcfg.num_replicas, faults, workdir)
    spawn["faults"] = {r.name: r.spawn_to_ready_s for r in fleet}
    router = FleetRouter(fleet, rcfg)
    try:
        outcomes, got, wall = drive_fleet(router, reqs, FLEET_NEW)
        fleet_outcomes_ok("17b faults", rids, outcomes, router)
        diffs = held_to(cfg, params, reqs, ref, got, SPEC_TOP_K,
                        "fleet 17b faults against one engine")
        s = router.metrics.summary()
        causes = sorted(d["cause"] for d in s["replica_downs"])
        restarts = {r.name: r.restarts for r in fleet}
        if causes != ["dead", "stalled"] or s["retries"] < 1 or \
                max(restarts.values()) > rcfg.replica_max_restarts:
            raise AssertionError(f"17b: replica downs {s['replica_downs']}, "
                                 f"retries {s['retries']}, restarts "
                                 f"{restarts}")
        launches = fleet_launches(fleet)
        runs["faults"] = {
            "wall_s": wall, "retries": s["retries"],
            "replica_downs": s["replica_downs"], "restarts": restarts,
            "router_ttft_ms": ttft_ms(s),
            "progress": {r.name: r.progress for r in fleet},
            "respawn_to_ready_s": {r.name: r.spawn_to_ready_s for r in fleet
                                   if r.restarts},
            "differing_requests": len(diffs), "launches": launches}
    finally:
        router.shutdown()
        stop_fleet(fleet)
    events = mon.tracer.to_dict()["traceEvents"]
    problems = validate_events(events, strict=True)
    names = {e["name"] for e in events}
    need = {"serving/replica_down", "serving/retry", "serving/shed",
            "serving/finish"}
    shutdown_monitor(save=True)
    if problems or need - names:
        raise AssertionError(f"17b router trace: problems {problems[:5]}, "
                             f"missing {sorted(need - names)}")
    print("fleet 17b: " + json.dumps({
        "card": card, "replicas": rcfg.num_replicas,
        "requests": len(reqs), "sampled": FLEET_SAMPLED,
        "new_tokens": FLEET_NEW, "spawn_to_ready_s": spawn,
        "router_events": len(events), **runs}), flush=True)
    return launches


def spec_fleet_phase(card, cfg, params, spec_outs):
    """Phase 17c (module docstring). Returns the replicas' launch
    counts."""
    from deeperspeed_tpu_torch.serving import FleetRouter, RouterConfig

    raw = json.loads(SPEC_CONFIG.read_text())
    block = dict(raw["serving"], top_k=SPEC_TOP_K)
    rcfg = RouterConfig.from_dict(block["fleet"])
    spec = replica_spec(cfg, block)
    reqs = spec_requests(cfg.vocab_size)
    flags = tempfile.mkdtemp(prefix="chip_smoke_flags_")
    faults = {0: {"replica_sigkill_at_decode": SPEC_FLEET_KILL_AT,
                  "flag_file": os.path.join(flags, "kill")}}
    fleet = start_fleet(spec, rcfg.num_replicas, faults,
                        tempfile.mkdtemp(prefix="chip_smoke_spec_fleet_"))
    spawn = {r.name: r.spawn_to_ready_s for r in fleet}
    router = FleetRouter(fleet, rcfg)
    try:
        outcomes, got, wall = drive_fleet(router, reqs, SPEC_NEW)
        fleet_outcomes_ok("17c", [r["rid"] for r in reqs], outcomes,
                          router)
        diffs = held_to(cfg, params, reqs, spec_outs, got, SPEC_TOP_K,
                        "spec fleet 17c against 17a's engine")
        s = router.metrics.summary()
        if not any(d["cause"] == "dead" for d in s["replica_downs"]) or \
                s["retries"] < 1:
            raise AssertionError(f"17c: no kill recorded: {s}")
        launches = fleet_launches(fleet)
        report = {"card": card, "replicas": rcfg.num_replicas,
                  "requests": len(reqs), "wall_s": wall,
                  "spawn_to_ready_s": spawn, "retries": s["retries"],
                  "replica_downs": s["replica_downs"],
                  "restarts": {r.name: r.restarts for r in fleet},
                  "router_ttft_ms": ttft_ms(s),
                  "progress": {r.name: r.progress for r in fleet},
                  "differing_requests": len(diffs), "launches": launches}
    finally:
        router.shutdown()
        stop_fleet(fleet)
    print("spec fleet 17c: " + json.dumps(report), flush=True)
    return launches


def spec_and_fleet_phase(fb, card, obs):
    """Phase 17: 17a, 17b and 17c on one GPT-NeoX-125M. Returns the
    launch counts of each."""
    cfg, params = spec_model()
    t0 = time.perf_counter()
    spec, spec_outs = spec_serving_phase(fb, card, cfg, params, obs / "spec")
    t1 = time.perf_counter()
    fleet = fleet_phase(card, cfg, params, obs / "fleet")
    t2 = time.perf_counter()
    spec_fleet = spec_fleet_phase(card, cfg, params, spec_outs)
    t3 = time.perf_counter()
    print(f"phase 17: 17a {t1 - t0:.1f} s, 17b {t2 - t1:.1f} s, 17c "
          f"{t3 - t2:.1f} s", flush=True)
    return spec, fleet, spec_fleet


# phase 18: resilience and the multi-process runtime
# ------------------------------------------------------------------ #


def phase18_child_env(extra=None):
    """The environment of every phase-18 trainer process: the repo on the
    path, one OpenMP thread, and cuBLAS's fixed workspace, so that every
    process picks the same GEMM algorithms (the bit-identity gates)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.update(OMP_NUM_THREADS="1", CUBLAS_WORKSPACE_CONFIG=":4096:8")
    for k in ("DS_TPU_FAULTS", "DS_TPU_RESUME_DIR", "DS_TPU_RESUME_TAG",
              "DS_TPU_RESTART_COUNT", "DS_TPU_RESTART_REASON",
              "DS_TPU_ROLE", "DS_TPU_INCARNATION", "DS_TPU_RUN_ID",
              "DS_COORDINATOR_ADDRESS", "DS_NUM_PROCESSES",
              "DS_PROCESS_ID", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    env.update(extra or {})
    return env


def corpus_batch(step, rows, seq):
    """18b's global batch of ``step``: ``rows`` windows of ``seq + 1``
    tokens of data/corpus_tokens.npy at offsets drawn from the step."""
    tokens = np.load(ROOT / "data" / "corpus_tokens.npy", mmap_mode="r")
    starts = np.random.RandomState(1000 + step).randint(
        0, tokens.shape[0] - seq - 1, rows)
    return np.stack([np.asarray(tokens[s:s + seq + 1], np.int64)
                     for s in starts])


def phase18_child(kind, work) -> int:
    """A phase-18 trainer: ``chip_smoke.py --child resilience|multihost
    WORK``. Trains GPT-NeoX-125M on the card under WORK/spec.json's config
    to its target step (18a through the config's datapipe, 18b on corpus
    batches keyed by the step), holding before every step the file
    WORK/allow does not allow yet (a SIGTERM there takes the preemption
    protocol). Resumes DS_TPU_RESUME_DIR when the supervisor exports one.
    Logs one JSON line a step and writes a report at exit; its stdout and
    stderr go to WORK/log.<name>. Prints no contract line."""
    import atexit

    work = Path(work)
    epoch = os.environ.get("DS_TPU_FLEET_EPOCH")
    name = (f"h{os.environ.get('DS_PROCESS_ID', '0')}.e{epoch}"
            if epoch is not None else
            f"i{os.environ.get('DS_TPU_RESTART_COUNT', '0')}")
    log = open(work / f"log.{name}", "a")
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    t_start = time.time()
    if not torch.cuda.is_available():
        print("phase 18 child: no CUDA device", file=sys.stderr)
        return 2
    (work / f"pid.{name}").write_text(str(os.getpid()))
    spec = json.loads((work / "spec.json").read_text())
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models.gpt import make_gpt
    from deeperspeed_tpu_torch.ops import op_builder

    cfg = datapipe_model()
    engine, _, _, _ = ds.initialize(
        model=make_gpt(cfg)[2], model_parameters=datapipe_params(cfg, SEED),
        config=spec["config"])
    mgr = engine._resilience
    seen = watch_pipe(engine) if engine.datapipe is not None else None
    loaded, load_s = None, None
    if os.environ.get("DS_TPU_RESUME_DIR"):
        t0 = time.perf_counter()
        loaded, _ = engine.load_checkpoint(os.environ["DS_TPU_RESUME_DIR"])
        load_s = time.perf_counter() - t0
    counters = kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    steps_path = work / f"steps.{name}"
    rank, world = engine.mesh.rank, engine.data_parallel_size
    n_buckets = engine.comm.n_buckets

    def report():
        snap = (engine.monitor.registry.snapshot_scalars()
                if engine.monitor is not None else {})
        (work / f"report.{name}.json").write_text(json.dumps({
            "loaded": loaded, "load_s": load_s, "t_start": t_start,
            "rank": rank, "world": world,
            "saves": save_seconds(engine.monitor.tracer.events()),
            "registry": snap, "n_buckets": n_buckets,
            "canonical_wire": (engine.comm.canonical_wire_launches()
                               if engine.canonical_shards else None),
            "global_steps": engine.global_steps}))

    atexit.register(report)

    def allowed():
        return int((work / "allow").read_text())

    while engine.global_steps < spec["steps"]:
        while engine.global_steps >= allowed():
            if mgr is not None and mgr.guard is not None \
                    and mgr.guard.requested:
                mgr.handle_preemption(engine)
            time.sleep(0.02)
        step = engine.global_steps
        t0 = time.perf_counter()
        if seen is not None:
            loss = engine.train_batch()
            batch_hash = sha(seen["batches"][-1].cpu().numpy())
            seen["batches"].clear()
        else:
            batch = corpus_batch(step, engine._config.train_batch_size,
                                 cfg.max_seq)
            loss = engine.train_batch(batch)
            batch_hash = sha(batch)
        loss = float(loss)
        step_s = time.perf_counter() - t0
        t_end = time.time()
        with open(steps_path, "a") as f:
            f.write(json.dumps({
                "step": engine.global_steps, "loss": loss.hex(),
                "hash": batch_hash, "t": t_end, "step_s": step_s,
                # what the step restored and updated shows here too: the
                # norm of the reduced grads (residuals included) and the
                # params after the update (the Adam moments included)
                "gnorm": engine.get_global_grad_norm().hex(),
                "params": params_digest(engine.params),
                "wire_s": (reduce_seconds(engine.monitor.tracer.events())
                           if engine.canonical_shards else 0.0),
                "launches": {n: fn.launches for n, fn in counters.items()},
                "nvcc_s": sum(i["seconds"]
                              for i in op_builder.build_info.values()),
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
                + "\n")
    if mgr is not None:
        mgr.wait_for_pending_saves()
    if engine.datapipe is not None:
        engine.datapipe.close()
    return 0


def reduce_seconds(events):
    """Seconds in the comm/reduce spans inside this process's last
    engine/train_batch span: the step just taken. A span also holds what
    device work was still queued when its gather copied to the host."""
    xs = [e for e in events if e.get("ph") == "X"]
    tb = [e for e in xs if e["name"] == "engine/train_batch"][-1]
    return sum(e["dur"] for e in xs if e["name"] == "comm/reduce"
               and tb["ts"] <= e["ts"] <= tb["ts"] + tb["dur"]) / 1e6


def save_seconds(events):
    """Each resilience save of this process, from its spans: the
    snapshot that blocks the step loop, and the writer's write plus
    commit (the two run one after the other on the writer thread)."""
    xs = [e for e in events if e.get("ph") == "X"]

    def secs(name):
        return [e["dur"] / 1e6 for e in xs if e["name"] == name]

    return {"blocked_s": secs("resilience/snapshot"),
            "writer_s": [w + c for w, c in zip(secs("resilience/write"),
                                               secs("resilience/commit"))]}


def child_lines(work, name):
    path = Path(work) / f"steps.{name}"
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines()]


def child_report(work, name):
    path = Path(work) / f"report.{name}.json"
    return json.loads(path.read_text()) if path.exists() else None


def child_failure(work, names, why):
    """An AssertionError naming ``why`` with the tail of each child's
    log."""
    tails = []
    for n in names:
        p = Path(work) / f"log.{n}"
        if p.exists():
            tails.append(f"--- {n} ---\n" + p.read_text()[-3000:])
    return AssertionError(f"{why}\n" + "\n".join(tails))


def wait_for(pred, timeout, what, work, names, proc=None):
    t0 = time.monotonic()
    while not pred():
        if proc is not None and proc.poll() is not None:
            raise child_failure(work, names, f"{what}: the supervisor "
                                f"exited {proc.returncode}")
        if time.monotonic() - t0 > timeout:
            raise child_failure(work, names, f"{what}: timed out after "
                                f"{timeout} s")
        time.sleep(0.05)


def start_references(runs):
    """Start the uninterrupted runs: one trainer process each, no
    supervisor, no fault, the same config and environment as the run
    they are held against. ``runs``: kind -> (work, config, steps). They
    run side by side, and beside 18a's first incarnation (their losses
    and hashes, not their times, are what the gates read)."""
    procs = {}
    for kind, (work, config, steps) in runs.items():
        work.mkdir(parents=True)
        (work / "spec.json").write_text(json.dumps({"config": config,
                                                    "steps": steps}))
        (work / "allow").write_text(str(steps))
        procs[kind] = (subprocess.Popen(child_command(kind, work),
                                        env=phase18_child_env(),
                                        cwd=str(ROOT)), work, steps)
    return procs


def collect_references(procs):
    """Wait for the uninterrupted runs; kind -> step lines."""
    out = {}
    for kind, (proc, work, steps) in procs.items():
        try:
            rc = proc.wait(timeout=PHASE18_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        lines = child_lines(work, "i0")
        if rc != 0 or [x["step"] for x in lines] != list(
                range(1, steps + 1)):
            raise child_failure(work, ["i0"], f"the {kind} reference run "
                                f"exited {rc} after {len(lines)} steps")
        out[kind] = lines
    return out


def tag_bytes(tag_dir):
    return sum(f.stat().st_size for f in Path(tag_dir).rglob("*")
               if f.is_file())


def obs_run_config(save_dir, obs):
    """configs/gpt_125m_obs.json as written, with the cuts PERF.md section
    4 lists: train_batch_size 512 -> RES_ROWS (phase 16's), the warmup
    -> RES_WARMUP, save_interval_steps 500 -> RES_SAVE_INTERVAL, save_dir
    and obs_dir in a temporary directory, metrics_port 9400 -> 0, the
    corpus as the datapipe's source, plus kernels auto."""
    with open(OBS_CONFIG) as f:
        config = json.load(f)
    config["train_batch_size"] = RES_ROWS
    config["scheduler"]["params"]["warmup_num_steps"] = RES_WARMUP
    config["resilience"].update(save_dir=str(save_dir),
                                save_interval_steps=RES_SAVE_INTERVAL)
    config["monitor"].update(obs_dir=str(obs), metrics_port=0)
    config["datapipe"]["source"] = str(ROOT / "data" / "corpus_tokens.npy")
    config["kernels"] = {"mode": "auto"}
    return config


def merged_trace(obs, tmp):
    """Every incarnation's trace (or, for a SIGKILLed one, its flight
    file's tail) merged by ``aggregate`` and validated strict."""
    from deeperspeed_tpu_torch.monitor import aggregate, validate_events

    files = sorted(Path(obs).iterdir())
    traces = [f for f in files if f.name.endswith(".trace.json")]
    stems = {f.name[:-len(".trace.json")] for f in traces}
    flights = [f for f in files if f.name.endswith(".flight.bin")
               and f.name[:-len(".flight.bin")] not in stems]
    paths = [str(f) for f in traces + flights]
    doc, stats = aggregate.merge_files(paths, out=str(Path(tmp) /
                                                      "merged.json"))
    problems = validate_events(doc["traceEvents"], strict=True)
    if problems:
        raise AssertionError(f"merged trace of {paths}: {problems[:5]}")
    return {"files": [Path(p_).name for p_ in paths],
            "events": stats["events"], "sources": len(stats["sources"])}


STITCHED_KEYS = ("loss", "hash", "gnorm", "params")


def stitched(lines_by_name, ref, name):
    """Every logged step of every incarnation equal to the reference's
    step: loss bits, batch hash, grad norm bits and the digest of the
    params after the update. Returns the steps covered."""
    covered = {}
    for inc, lines in lines_by_name.items():
        for x in lines:
            want = ref[x["step"] - 1]
            differ = [k for k in STITCHED_KEYS if x[k] != want[k]]
            if differ:
                raise AssertionError(
                    f"{name}: {inc} step {x['step']}: {differ} differ: "
                    f"loss {float.fromhex(x['loss'])} grad norm "
                    f"{float.fromhex(x['gnorm'])}, the uninterrupted run's "
                    f"{float.fromhex(want['loss'])} "
                    f"{float.fromhex(want['gnorm'])}")
            covered.setdefault(x["step"], []).append(inc)
    if sorted(covered) != list(range(1, len(ref) + 1)):
        raise AssertionError(f"{name}: steps covered {sorted(covered)}")
    return covered


def per_step_launches(lines, first_step_before):
    """The launches of the steps an incarnation ran, from its last line
    (the counters were set to 0 after its resume), divided by them."""
    last = lines[-1]
    steps = last["step"] - first_step_before
    return steps, {k: v / steps for k, v in last["launches"].items()}


def check_launches(name, got, want):
    if got != want:
        raise AssertionError(f"{name}: launches per step {got}, expected "
                             f"{want}")


def child_command(kind, work):
    """The command of a phase-18 trainer process."""
    return [sys.executable, str(ROOT / "chip_smoke.py"), "--child", kind,
            str(work)]


def resilience_reference(base):
    """18a's uninterrupted run: its work dir, config (saves off) and
    steps."""
    config = obs_run_config(base / "ref" / "ckpt", base / "ref" / "obs")
    config["resilience"]["save_interval_steps"] = 0  # no saves
    return base / "ref", config, RES_STEPS


def resilience_phase(card, base, refs):
    """Phase 18a: configs/gpt_125m_obs.json under the Supervisor; see the
    module docstring. ``refs``: the started uninterrupted runs
    (``start_references``). Returns the launches of every incarnation's
    steps (summed), the per-step launches and every run's step lines."""
    from deeperspeed_tpu_torch.checkpoint.serialization import read_latest
    from deeperspeed_tpu_torch.resilience import (is_committed, tag_status,
                                                  verify_manifest)

    cfg = datapipe_model()
    expected = datapipe_expected(cfg)
    print(f"resilience 18a: configs/gpt_125m_obs.json, train_batch_size "
          f"512 -> {RES_ROWS} (micro 16 x 4, one rank), warmup_num_steps "
          f"2000 -> {RES_WARMUP}, save_interval_steps 500 -> "
          f"{RES_SAVE_INTERVAL}, save_dir and obs_dir temporary, "
          f"metrics_port 9400 -> 0, datapipe source data/corpus_tokens.npy,"
          f" async_save true, plus kernels auto; {card}", flush=True)
    work = base / "run"
    work.mkdir()
    save_dir, obs = work / "ckpt", work / "obs"
    (work / "spec.json").write_text(json.dumps({
        "config": obs_run_config(save_dir, obs), "steps": RES_STEPS}))
    (work / "allow").write_text(str(RES_PREEMPT_AFTER))
    faults = {"sigkill_mid_save": RES_TAG_FILES + 1,
              "flag_file": str(work / "fault.flag")}
    log = work / "restarts.jsonl"
    cmd = [sys.executable, "-m", "deeperspeed_tpu_torch.resilience."
           "supervisor", "--checkpoint-dir", str(save_dir), "--restart-log",
           str(log), "--max-restarts", "3", "--"] + child_command(
               "resilience", work)
    names = ["i0", "i1", "i2"]
    with open(work / "supervisor.log", "w") as out:
        proc = subprocess.Popen(cmd, cwd=str(ROOT), stdout=out, stderr=out,
                                env=phase18_child_env(
                                    {"DS_TPU_FAULTS": json.dumps(faults)}))
    try:
        # incarnation 0 dies mid-save of global_step4; the restart is up
        wait_for(lambda: (work / "pid.i1").exists(), PHASE18_CHILD_TIMEOUT_S,
                 "18a: the restart after the mid-save kill", work, names,
                 proc)
        torn = {"latest": read_latest(str(save_dir)),
                "global_step4": tag_status(str(save_dir / "global_step4")),
                "staging": (save_dir / "global_step4.tmp").is_dir()}
        if torn != {"latest": "global_step2", "global_step4": "missing",
                    "staging": True}:
            raise child_failure(work, names, f"18a: after the kill {torn}")
        wait_for(lambda: any(x["step"] == RES_PREEMPT_AFTER
                             for x in child_lines(work, "i1")),
                 PHASE18_CHILD_TIMEOUT_S, "18a: incarnation 1 at step "
                 f"{RES_PREEMPT_AFTER}", work, names, proc)
        t_term = time.time()
        os.kill(int((work / "pid.i1").read_text()), signal.SIGTERM)
        wait_for(lambda: (work / "pid.i2").exists(), PHASE18_CHILD_TIMEOUT_S,
                 "18a: the restart after the preemption", work, names, proc)
        (work / "allow").write_text(str(RES_STEPS))
        rc = proc.wait(timeout=PHASE18_CHILD_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise child_failure(work, names, f"18a: the supervisor exited {rc}")
    ref_lines = collect_references(refs)
    ref = ref_lines["resilience"]
    lines = {n: child_lines(work, n) for n in names}
    reports = {n: child_report(work, n) for n in names}
    covered = stitched(lines, ref, "18a")
    # the restart log: one crash with its backoff, one preemption without
    events = [json.loads(x) for x in log.read_text().splitlines()]
    exits = [(e["reason"], e["code"], e.get("delay")) for e in events
             if e["event"] == "exit"]
    if (len(exits) != 3 or exits[0][0] != "crash" or exits[0][1] != -9
            or not exits[0][2] or exits[1][:2] != ("preemption", 86)
            or exits[1][2] != 0.0 or exits[2][:2] != ("done", 0)):
        raise AssertionError(f"18a restart log: {events}")
    launches_ev = [e for e in events if e["event"] == "launch"]
    # what each restarted incarnation loaded and counted
    want_loaded = {"i1": f"global_step{RES_SAVE_INTERVAL}",
                   "i2": f"global_step{RES_PREEMPT_AFTER}"}
    for n, tag in want_loaded.items():
        rep = reports[n]
        if rep is None or not (rep["loaded"] or "").endswith(tag):
            raise child_failure(work, names, f"18a: {n} loaded "
                                f"{rep and rep['loaded']}, expected {tag}")
        reg = rep["registry"]
        want = {"resilience_restarts": 1.0, "resilience_resume_total": 1.0}
        if n == "i1":
            want["resilience_preemption_total"] = 1.0
        got = {k: reg.get(k) for k in want}
        if got != want or reg.get("resilience_fallback_total") or \
                reg.get("resilience_corrupt_tags"):
            counters = {k: v for k, v in reg.items()
                        if k.startswith("resilience")}
            raise AssertionError(f"18a {n} resilience counters: {counters}")
    # every committed tag verifies its manifest; the torn one was never
    # loaded and is gone (incarnation 1 rewrote global_step4)
    tags = sorted(p_.name for p_ in save_dir.iterdir() if p_.is_dir())
    want_tags = sorted({f"global_step{s}" for s in range(
        RES_SAVE_INTERVAL, RES_STEPS + 1, RES_SAVE_INTERVAL)}
        | {f"global_step{RES_PREEMPT_AFTER}"})
    if tags != sorted(want_tags):
        raise AssertionError(f"18a tags {tags}, expected {want_tags}")
    for t in tags:
        ok, problems = verify_manifest(str(save_dir / t))
        if not (ok and is_committed(str(save_dir / t))):
            raise AssertionError(f"18a {t}: {problems}")
    # launches: every incarnation's steps as phase 16's plan
    launches = {}
    first = {"i0": 0, "i1": RES_SAVE_INTERVAL, "i2": RES_PREEMPT_AFTER}
    per_step = None
    for n in names:
        if not lines[n]:
            continue
        if any(x["nvcc_s"] for x in lines[n]):
            raise child_failure(work, names, f"18a: {n} ran nvcc")
        steps, ps = per_step_launches(lines[n], first[n])
        check_launches(f"18a {n}", ps, expected)
        per_step = ps
        for k, v in lines[n][-1]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    trace = merged_trace(obs, work)
    launch_t = [e["ts"] for e in launches_ev]
    restart_s = {n: lines[n][0]["t"] - launch_t[i]
                 for i, n in enumerate(names) if lines[n]}
    # a step time only from a trainer alone on the card: steps that began
    # after both uninterrupted runs' last step, saved nothing and were
    # not their process's first
    refs_end = max(ls[-1]["t"] for ls in ref_lines.values())
    alone = [x["step_s"] for n in names for x in lines[n][1:]
             if x["step"] % RES_SAVE_INTERVAL
             and x["t"] - x["step_s"] > refs_end]
    report = {
        "card": card, "steps": RES_STEPS, "covered_by": covered,
        "losses": [float.fromhex(x["loss"]) for x in ref],
        "step_s_median_alone": (statistics.median(alone) if alone
                                else None),
        "steps_alone": len(alone),
        "save_steps_s": [(n, x["step"], x["step_s"])
                         for n in names for x in lines[n]
                         if x["step"] % RES_SAVE_INTERVAL == 0],
        "restart_log": [(e["event"], e.get("reason"), e.get("code"),
                         e.get("delay")) for e in events],
        "torn_after_kill": torn,
        "sigterm_to_restart_s": (work / "pid.i2").stat().st_mtime
        - t_term,
        "restart_to_first_step_s": restart_s,
        "i0_beside_the_uninterrupted_runs": True,
        "load_s": {n: reports[n]["load_s"] for n in ("i1", "i2")},
        "async_save_blocked_s": [b for n in ("i1", "i2")
                                 for b in reports[n]["saves"]["blocked_s"]],
        "writer_s": [w for n in ("i1", "i2")
                     for w in reports[n]["saves"]["writer_s"]],
        "checkpoint_bytes": tag_bytes(save_dir / tags[-1]),
        "tags": tags, "trace": trace, "launches_per_step": per_step}
    print("resilience 18a: " + json.dumps(report), flush=True)
    return launches, per_step, ref_lines


def multihost_run_config(save_dir, obs, resilience=True):
    """configs/gpt_125m_multihost.json as written, with the cuts PERF.md
    section 4 lists: elasticity.max_train_batch_size 512 -> MH_MAX_BATCH
    (48 rows, micro 8 at world 2), canonical_shards 32 -> MH_CANONICAL,
    the warmup -> RES_WARMUP, save_interval_steps 500 -> MH_SAVE_INTERVAL,
    the save dir and the monitor's obs_dir in a temporary directory, plus
    kernels auto. ``resilience`` False drops the block (the reference run
    saves nothing)."""
    with open(MULTIHOST_CONFIG) as f:
        config = json.load(f)
    config["elasticity"].update(max_train_batch_size=MH_MAX_BATCH,
                                canonical_shards=MH_CANONICAL)
    config["scheduler"]["params"]["warmup_num_steps"] = RES_WARMUP
    if resilience:
        config["resilience"].update(save_interval_steps=MH_SAVE_INTERVAL,
                                    save_dir=str(save_dir))
    else:
        del config["resilience"]
    config["monitor"] = dict(config["monitor"], obs_dir=str(obs))
    config["kernels"] = {"mode": "auto"}
    return config


def multihost_reference(base):
    """18b's uninterrupted world-1 run: its work dir, config (no
    resilience block: no saves) and steps."""
    return (base / "ref", multihost_run_config(None, base / "ref" / "obs",
                                               resilience=False), MH_STEPS)


def multihost_phase(card, base, ref):
    """Phase 18b: configs/gpt_125m_multihost.json under the
    FleetSupervisor, two processes sharing the card over gloo; see the
    module docstring. ``ref``: the world-1 run's step lines. Returns the
    launches of every process's steps (summed) and the per-step launches
    of a world-2 rank."""
    from deeperspeed_tpu_torch.distributed import fleet, rendezvous
    from deeperspeed_tpu_torch.elasticity import compute_elastic_config

    cfg = datapipe_model()
    probe = multihost_run_config(base, base)
    rows, worlds, micro = compute_elastic_config(probe, world_size=2)
    if (rows, worlds, micro) != (MH_ROWS, MH_WORLDS, MH_MICRO_W2):
        raise AssertionError(f"elastic config {(rows, worlds, micro)}")
    print(f"multihost 18b: configs/gpt_125m_multihost.json, elasticity "
          f"max_train_batch_size 512 -> {MH_MAX_BATCH} ({rows} rows, micro "
          f"{micro} at world 2, admissible worlds {worlds}: the card's "
          f"memory and the step time), canonical_shards 32 -> "
          f"{MH_CANONICAL} (each slot gathers its fp32 rows; 32 slots would "
          f"move ~10 GB over gloo a step), warmup_num_steps 2000 -> "
          f"{RES_WARMUP}, save_interval_steps 500 -> {MH_SAVE_INTERVAL} "
          f"(two 7.47 GB multi-process saves, not three), "
          f"save dir and obs_dir temporary, plus kernels auto; two "
          f"processes share one card over gloo through host copies (not "
          f"NCCL, not two hosts); {card}", flush=True)
    work = base / "run"
    work.mkdir()
    save_dir, obs = work / "ckpt", work / "obs"
    (work / "spec.json").write_text(json.dumps({
        "config": multihost_run_config(save_dir, obs), "steps": MH_STEPS}))
    (work / "allow").write_text(str(MH_KILL_AFTER))
    (work / "pool").write_text("2\n")
    policy = fleet.FleetPolicy(
        procs=2, checkpoint_dir=str(save_dir),
        rendezvous_dir=str(work / "rdzv"),
        restart_log=str(work / "restarts.jsonl"),
        pool_file=str(work / "pool"), watch_pool=True, term_grace_s=30.0,
        extra_env={k: v for k, v in phase18_child_env().items()
                   if k in ("PYTHONPATH", "OMP_NUM_THREADS",
                            "CUBLAS_WORKSPACE_CONFIG")})
    sup = fleet.FleetSupervisor(child_command("multihost", work), policy)
    names = ["h0.e0", "h1.e0", "h0.e1", "h1.e1", "h0.e2"]
    result = {}

    def run():
        try:
            result["rc"] = sup.run()
        except BaseException as e:  # noqa: BLE001 - reported below
            result["error"] = repr(e)

    env_keep = {k: os.environ.pop(k) for k in (
        "DS_TPU_ROLE", "DS_TPU_INCARNATION", "DS_TPU_RUN_ID")
        if k in os.environ}
    th = threading.Thread(target=run, daemon=True)
    th.start()

    def stepped(name, step):
        return any(x["step"] == step for x in child_lines(work, name))

    try:
        wait_for(lambda: stepped("h0.e0", MH_KILL_AFTER)
                 and stepped("h1.e0", MH_KILL_AFTER),
                 PHASE18_CHILD_TIMEOUT_S, f"18b: epoch 0 at step "
                 f"{MH_KILL_AFTER}", work, names)
        os.kill(sup._children[1].pid, signal.SIGKILL)
        wait_for(lambda: sup.epoch == 1, PHASE18_CHILD_TIMEOUT_S,
                 "18b: the restart barrier", work, names)
        (work / "allow").write_text(str(MH_REMESH_AFTER))
        wait_for(lambda: stepped("h0.e1", MH_REMESH_AFTER)
                 and stepped("h1.e1", MH_REMESH_AFTER),
                 PHASE18_CHILD_TIMEOUT_S, f"18b: epoch 1 at step "
                 f"{MH_REMESH_AFTER}", work, names)
        (work / "pool").write_text("1\n")
        wait_for(lambda: sup.epoch == 2, PHASE18_CHILD_TIMEOUT_S,
                 "18b: the planned re-mesh", work, names)
        (work / "allow").write_text(str(MH_STEPS))
        th.join(timeout=PHASE18_CHILD_TIMEOUT_S)
    finally:
        for c in sup._children:
            if c.poll() is None:
                c.kill()
        os.environ.update(env_keep)
    if result.get("rc") != 0:
        raise child_failure(work, names, f"18b: the fleet ended {result}")
    lines = {n: child_lines(work, n) for n in names}
    reports = {n: child_report(work, n) for n in names}
    covered = stitched(lines, ref, "18b")
    if sup.crashes != 1 or sup.remeshes != 1 or sup.procs != 1:
        raise AssertionError(f"18b fleet: crashes {sup.crashes}, re-meshes "
                             f"{sup.remeshes}, processes {sup.procs}")
    events = [json.loads(x) for x in
              (work / "restarts.jsonl").read_text().splitlines()]
    exits = [(e["epoch"], e.get("host"), e["reason"]) for e in events
             if e["event"] == "exit"]
    want_exits = [(0, 1, "crashed"), (0, 0, "fleet_restart"),
                  (1, 0, "pool_change"), (1, 1, "pool_change"),
                  (2, 0, "done")]
    if exits != want_exits or [e["reason"] for e in events
                               if e["event"] == "launch"] != [
                                   "start", "crashed", "pool_change"]:
        raise AssertionError(f"18b restart log: {events}")
    # what each incarnation loaded: the world-2 interval tag, then the
    # world-2 urgent tag of the re-mesh at world 1 (its (C, n) residual
    # rows restore verbatim: a canonical fingerprint has no world term)
    kill_tag = MH_KILL_AFTER // MH_SAVE_INTERVAL * MH_SAVE_INTERVAL
    for n, tag in (("h0.e1", f"global_step{kill_tag}"),
                   ("h1.e1", f"global_step{kill_tag}"),
                   ("h0.e2", f"global_step{MH_REMESH_AFTER}")):
        rep = reports[n]
        if rep is None or not (rep["loaded"] or "").endswith(tag):
            raise child_failure(work, names, f"18b: {n} loaded "
                                f"{rep and rep['loaded']}, expected {tag}")
    if reports["h0.e2"]["world"] != 1 or reports["h0.e1"]["world"] != 2:
        raise AssertionError("18b: the epochs' worlds")
    # rendezvous records and clock offsets
    recs = {r.host: r for r in rendezvous.read_records(str(work / "rdzv"))}
    offsets = rendezvous.read_offsets(str(work / "rdzv"))
    if sorted(recs) != [0, 1] or set(offsets) != {"trainer.h0",
                                                  "trainer.h1"}:
        raise AssertionError(f"18b rendezvous: {recs}, offsets {offsets}")
    trace = merged_trace(obs, work)
    # launches: the model's kernels per local slot, the int8 wire's
    # quantize_rows and dequant_rows once a bucket a step, no
    # dequant_sum_rows (canonical_wire_launches)
    launches, per_rank = {}, {}
    first = {"h0.e0": 0, "h1.e0": 0, "h0.e1": kill_tag, "h1.e1": kill_tag,
             "h0.e2": MH_REMESH_AFTER}
    for n in names:
        if not lines[n] or any(x["nvcc_s"] for x in lines[n]):
            raise child_failure(work, names, f"18b: {n} ran no step or ran "
                                f"nvcc")
        rep = reports[n] or reports["h0.e1"]
        slots = MH_CANONICAL // (1 if n == "h0.e2" else 2)
        steps, ps = per_step_launches(lines[n], first[n])
        L = cfg.n_layer
        want = {"flash_fwd": L * slots, "flash_bwd": L * slots,
                "ln_fwd": slots, "ln_bwd": slots,
                "bias_gelu_fwd": 2 * L * slots, "bias_gelu_bwd": L * slots,
                **rep["canonical_wire"]}
        check_launches(f"18b {n}", {k: ps.get(k) for k in want}, want)
        per_rank[n] = ps
        for k, v in lines[n][-1]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    launch_t = {e["epoch"]: e["wall"] for e in events
                if e["event"] == "launch"}
    # the steps that saved nothing and were not a process's first: at
    # world 2 two trainers share the card, at world 1 epoch 2's trainer
    # is alone on it
    w2 = [x for n in ("h0.e0", "h0.e1") for x in lines[n][1:]
          if x["step"] % MH_SAVE_INTERVAL]
    w1 = [x for x in lines["h0.e2"][1:] if x["step"] % MH_SAVE_INTERVAL]
    report = {
        "card": card, "gloo_on_one_card": True, "steps": MH_STEPS,
        "covered_by": covered,
        "losses": [float.fromhex(x["loss"]) for x in ref],
        "step_s_world2_median": statistics.median(x["step_s"] for x in w2),
        "step_s_world1_median": statistics.median(x["step_s"] for x in w1),
        "save_steps_s": [(n, x["step"], x["step_s"])
                         for n in names for x in lines[n]
                         if x["step"] % MH_SAVE_INTERVAL == 0],
        "wire_share_world2": statistics.median(
            x["wire_s"] / x["step_s"] for x in w2),
        "wire_share_world1": statistics.median(
            x["wire_s"] / x["step_s"] for x in w1),
        "spawn_to_first_step_s": {
            n: lines[n][0]["t"] - launch_t[int(n[-1])] for n in names},
        "peak_mem_gib": {n: lines[n][-1]["peak_mem_gib"] for n in names},
        "load_s": {n: reports[n]["load_s"] for n in ("h0.e1", "h1.e1",
                                                     "h0.e2")},
        "n_buckets": reports["h0.e2"]["n_buckets"],
        "quant_launches_per_rank_step": {
            n: {k: per_rank[n][k] for k in ("quantize_rows",
                                            "dequant_sum_rows",
                                            "dequant_rows")}
            for n in names},
        "restart_log": [(e["event"], e.get("host"), e.get("reason"))
                        for e in events],
        "checkpoint_bytes": tag_bytes(save_dir /
                                      f"global_step{MH_REMESH_AFTER}"),
        "trace": trace, "offsets": offsets}
    print("multihost 18b: " + json.dumps(report), flush=True)
    return launches, per_rank["h0.e1"]


def phase18(card):
    """Phase 18: 18a with the two uninterrupted runs started beside its
    first incarnation, then 18b; prints the wall seconds of each half."""
    import shutil

    base = Path(tempfile.mkdtemp(prefix="chip_smoke_phase18_"))
    t0 = time.perf_counter()
    refs = start_references({
        "resilience": resilience_reference(base / "18a"),
        "multihost": multihost_reference(base / "18b")})
    try:
        res, res_per_step, ref_lines = resilience_phase(card, base / "18a",
                                                        refs)
    finally:
        for proc, _, _ in refs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    t1 = time.perf_counter()
    mh, mh_per_step = multihost_phase(card, base / "18b",
                                      ref_lines["multihost"])
    t2 = time.perf_counter()
    shutil.rmtree(base, ignore_errors=True)
    print(f"phase 18: 18a (with the uninterrupted runs) {t1 - t0:.1f} s, "
          f"18b {t2 - t1:.1f} s", flush=True)
    return res, res_per_step, mh, mh_per_step


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deeperspeed_tpu_torch.ops import flash_attention as fa
    from deeperspeed_tpu_torch.ops import flash_static as fs
    from deeperspeed_tpu_torch.ops import fused_adam as fad
    from deeperspeed_tpu_torch.ops import fused_blocks as fb
    from deeperspeed_tpu_torch.ops import fused_quant as fq
    from deeperspeed_tpu_torch.ops import op_builder
    from deeperspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    card = card_line()
    print(f"card: {card}", flush=True)
    t_main = time.perf_counter()
    wall = {}
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"capability {torch.cuda.get_device_capability(0)}", flush=True)
    t0 = time.perf_counter()
    # every source is built here, before phase 14 spawns its ranks, so the
    # ranks load the libraries and never race on build/kernels/
    sources = ("fused_blocks", "flash_attention", "supertile_attention",
               "fused_adam", "sparse_attention", "fused_quant")
    op_builder.build_all(sources)
    fb._lib()
    fa._lib()
    fs._lib()
    fad._lib()
    bs._lib()
    fq._lib()
    wall["build"] = time.perf_counter() - t0
    print(f"build: {', '.join(s_ + '.cu' for s_ in sources)} in "
          f"{wall['build']:.2f} s, side by side", flush=True)
    for name in sources:
        info = op_builder.build_info[name]
        print(f"build: {name}.cu nvcc {info['seconds']:.2f} s -> "
              f"{info['path']}", flush=True)
        for line in info["ptxas"].splitlines():
            if any(w in line for w in ("registers", "Compiling entry",
                                       "spill")):
                print(f"  ptxas: {line.strip()}", flush=True)

    flash_build_report(fa, op_builder)
    tensor_core_build_report(bs, fs, op_builder)
    backward_build_report(fb, fs, op_builder)
    ln_fwd_build_report(fb)
    bias_gelu_build_report(fb, op_builder)

    wall["build_reports"] = time.perf_counter() - t0 - wall["build"]
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = kernel_phase(fb, gen)
    cases.update(backward_phase(fb, gen))
    for name, rows in bias_gelu_width_cases(fb, gen).items():
        cases[name].extend(rows)
    cases.update(flash_phase(fa, gen))
    for name, rows in bert_kernel_phase(fb, fs, fa, gen).items():
        cases.setdefault(name, []).extend(rows)
    cases.update(adam_phase(fad, gen))
    gc.collect()
    torch.cuda.empty_cache()
    cases.update(sparse_phase(bs, gen))
    gc.collect()
    torch.cuda.empty_cache()
    cases.update(quant_phase(fq, gen))
    gc.collect()
    torch.cuda.empty_cache()
    for name, rows in infinity_kernel_cases(fb, gen).items():
        cases[name].extend(rows)
    for name, rows in spec_kernel_cases(fb, gen).items():
        cases[name].extend(rows)
    for name, rows in cases.items():
        for r in rows:
            if "ms" in r:
                print(f"kernel {name}: " + json.dumps(r), flush=True)
        if name in QUANT_KERNELS:
            # held bit for bit: quant_case raised on any differing element
            continue
        worst = max(rows, key=lambda r: r["max_abs_err"] / r["tol"])
        print(f"kernel {name}: {len(rows)} cases within tolerance; "
              f"closest to its limit: " + json.dumps(worst), flush=True)
        worst_rel = max(rows, key=lambda r: r["rel_l2_err"] / r["rel_l2_tol"])
        print(f"kernel {name}: closest to its relative L2 limit: "
              + json.dumps(worst_rel), flush=True)
        if name == "fused_adam":
            print(f"kernel {name}: elements differing from the plain "
                  f"version: {sum(r['elements_differing'] for r in rows)} "
                  f"of {sum(r['elements'] for r in rows)}", flush=True)
        if name in ("sparse_fwd", "sparse_bwd"):
            for dt in ("bfloat16", "float32"):
                sel = [r for r in rows if r["dtype"] == dt]
                print(f"kernel {name}: {dt} elements differing from the "
                      f"plain version: "
                      f"{sum(r['elements_differing'] for r in sel)} of "
                      f"{sum(r['elements'] for r in sel)}", flush=True)

    wall["kernels"] = time.perf_counter() - t0

    def timed(phase, fn, *args):
        t1 = time.perf_counter()
        out = fn(*args)
        gc.collect()
        torch.cuda.empty_cache()
        wall[phase] = time.perf_counter() - t1
        return out

    obs = Path(tempfile.mkdtemp(prefix="chip_smoke_obs_"))
    serving = timed("5 serving", serving_phase, fb, card, obs / "serving")
    timed("5' near-oom", near_oom_phase, obs / "near_oom")
    training, per_step, after = timed("6 training", training_phase, card,
                                      obs / "training")
    resume = timed("6' resume", resume_phase, card, after)
    bert, bert_per_step = timed("8 bert", bert_training_phase, card)
    sparse, sparse_per_step = timed("12 sparse training",
                                    sparse_training_phase, card)
    dp, dp_per_step = timed("14 data parallel", dp_training_phase, card)
    infinity, infinity_per_step = timed("15 infinity", infinity_phase, card)
    datapipe, datapipe_per_step = timed("16a datapipe", datapipe_phase, card)
    remat = timed("16b remat", remat_phase, card)
    timed("16c optimizers", optimizers_phase, card)
    spec, fleet, spec_fleet = timed("17 spec and fleet",
                                    spec_and_fleet_phase, fb, card,
                                    obs / "spec")
    res, res_per_step, mh, mh_per_step = timed("18 resilience and "
                                               "multi-process", phase18,
                                               card)
    import shutil

    shutil.rmtree(obs, ignore_errors=True)
    wall["total"] = time.perf_counter() - t_main
    print("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in wall.items()}), flush=True)

    # each path's counts were set to 0 just before it and read just after
    # (phase 14's in each rank, summed over the ranks)
    paths = {"serving": serving, "gpt_training": training,
             "gpt_resume": resume, "bert_training": bert,
             "sparse_training": sparse, "dp_training": dp,
             "infinity_training": infinity, "datapipe_training": datapipe,
             "remat_policies": remat, "spec_serving": spec,
             "fleet_replicas": fleet, "spec_fleet_replicas": spec_fleet,
             "resilience_training": res, "multihost_training": mh}
    kernels = []
    for name, rows in cases.items():
        # the timed row of the path the kernel was ported for: BERT's for
        # the add-LN and super-tile pairs, the sparse path's for the sparse
        # pair, GPT training's for the rest
        bert_row = name.startswith(("add_ln", "supertile"))
        if name.startswith("sparse"):
            head = next(r for r in rows if r.get("path") == "sparse")
        elif name in QUANT_KERNELS:
            head = next(r for r in rows if r.get("path") == "comm")
        else:
            head = next(r for r in rows if "ms" in r
                        and r["dtype"] == "bfloat16"
                        and (r.get("path") == "bert") == bert_row
                        and (bert_row or r.get("path") == "gpt"
                             or r["shape"][0] == PATH_ROWS
                             or tuple(r["shape"]) == FLASH_SHAPES[0]))
        by_path = {p: n[name] for p, n in paths.items() if n.get(name)}
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(by_path.values()),
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"], "dtype": head["dtype"],
            "launches_by_path": by_path,
            "launches_per_step": {"gpt_training": per_step[name],
                                  "bert_training": bert_per_step[name],
                                  "sparse_training": sparse_per_step[name],
                                  "dp_training_per_rank":
                                      dp_per_step[name],
                                  "infinity_training":
                                      infinity_per_step[name],
                                  "datapipe_training":
                                      datapipe_per_step[name],
                                  "resilience_training":
                                      res_per_step[name],
                                  "multihost_training_per_rank":
                                      mh_per_step[name]},
        }
        inf = next((r for r in rows if r.get("path") == "infinity"), None)
        if inf is not None:
            # the kernel at the streamed GPT-NeoX-20B step's shape
            entry["infinity_path"] = {k: inf[k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")}
        sp = next((r for r in rows if r.get("path") == "spec"), None)
        if sp is not None:
            # the kernel at GPT-NeoX-125M's verify step's rows
            entry["spec_path"] = {k: sp[k] for k in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")}
            entry["spec_path"]["launches_per_request"] = \
                spec[name] / len(SPEC_LENS)
        if name in ALSO_REPLACES:
            entry["also_replaces"] = ALSO_REPLACES[name]
        if name == "fused_adam":
            master = next(r for r in rows if r.get("path") == "gpt-master")
            entry["master_path"] = {k: master[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "dtypes", "max_abs_err")}
        kernels.append(entry)
    if sorted(k["name"] for k in kernels) != sorted(SOURCES):
        raise AssertionError(f"kernels line has {[k['name'] for k in kernels]}"
                             f", expected {sorted(SOURCES)}")
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(phase18_child(sys.argv[2], sys.argv[3]))
    sys.exit(main())
