"""ServingEngine: continuous-batching inference over a fixed slot pool.

Counterpart of deeperspeed_tpu/serving/engine.py. The request lifecycle::

    engine = ServingEngine(cfg, params, {"num_slots": 8, "num_blocks": 128})
    rid = engine.submit([1, 2, 3], max_new_tokens=32)
    while engine.has_work():
        for req in engine.step():
            print(req.rid, req.output)
    # or: outputs = engine.run()

One ``step()`` is: expire timeouts -> admit+prefill queued requests into
free slots (length-bucketed, backpressure when the block pool is dry) ->
grow block tables for the next write (preempting the youngest slot when
the pool is exhausted) -> ONE decode step over ALL slots -> append
tokens, evict finished requests.

The decode step always runs the full slot array: idle slots carry token
0 / length 0 / an all-null block table and their lane is ignored on the
host. Decode math reuses ``models/gpt.decoder_block`` with a paged-cache
``attend`` (serving/kv_cache.paged_attend), which is what makes greedy
serving outputs token-identical to per-request ``make_generator`` calls.
The KV pool is updated in place.

The engine runs on CUDA unless ``device="cpu"`` is passed; with no CUDA
device and no device asked for, it raises.

Telemetry, as in the reference: ``monitor_config`` (a ``"monitor"`` block)
builds and installs the process-global monitor, else an installed one is
adopted. Its registry feeds ``ServingMetrics`` (and the SLO tracker of the
serving config's ``"slo"`` block); the decode step is watched by the
recompile watchdog (its argument signature must never change); with
``perf`` on, the cost index captures the decode step and each prefill
bucket at a new signature and the decode span carries its MFU; memwatch
stamps the prefill and decode spans with the allocator's watermarks.
``monitor`` is a ``TensorBoardMonitor`` the metrics' summary is exported
through every step.

Speculative decoding: a ``"speculative"`` sub-block hands the decode phase
to a ``spec.SpecRuntime`` (a drafter with its own paged pool, a draft
step and a verify step); the plain decode step stays as the fallback for
slots that cannot speculate a given round. The engine then meets exactly
three decode-path signatures (decode, draft, verify), each watched.

Not ported yet (each raises or is absent): ``mesh=``,
``PipelineServingBridge`` and the resilience manager hook.
"""

import itertools
import time
import zlib
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..models.generation import (apply_with_cache, categorical, init_cache,
                                  prep_sampling_logits)
from ..models.gpt import (GPTConfig, decoder_block, head_weight, layer_norm,
                          layer_slices)
from ..models.speculative import engine_sample_key
from ..monitor import get_monitor, init_monitor
from ..monitor.tracer import trace_counter, trace_instant, trace_span
from ..monitor.watchdog import SignatureCache
from ..utils.logging import logger
from .config import ServingConfig
from .kv_cache import NULL_BLOCK, PagedKVCache, blocks_needed, paged_attend
from .metrics import DECODE_TIMER, PREFILL_TIMER, ServingMetrics
from .scheduler import Request, Scheduler


class EngineDrainingError(RuntimeError):
    """Raised by ``submit()`` while the engine is draining: it is
    finishing its in-flight requests and admits nothing new. Callers
    owning more than one engine catch this and fail the request over to
    another replica."""


# ------------------------------------------------------------------ #
# deterministic per-request sampling
# ------------------------------------------------------------------ #

def derive_request_seed(base_seed: int, rid: str) -> int:
    """Stable per-request sampling seed: a pure function of the engine
    seed and the request id (crc32, NOT Python hash(), which is
    randomized per process), as in the reference."""
    return (zlib.crc32(rid.encode("utf-8")) ^ (base_seed * 0x9E3779B1)) \
        & 0x7FFFFFFF


def request_sample_key(seed: int, count: int, device="cpu") -> torch.Generator:
    """The generator that draws a request's ``count``-th sampled token: a
    ``torch.Generator`` on ``device`` seeded with ``sample_seed(seed,
    count)``. Sampling is a pure function of (seed, token index): no
    engine-global stream, so a preempted or retried request replays its
    sampled tokens exactly. This is the port's own contract; JAX's PRNG
    cannot be reproduced in PyTorch, so sampled tokens differ from the
    reference's (greedy tokens do not). Delegates to
    models/speculative.engine_sample_key, the one definition of the key
    contract that plain decode, the speculative draft and verify steps and
    ``make_matched_speculative_generator`` share (its seed is
    ``models.speculative.sample_seed(seed, count)``)."""
    return engine_sample_key(seed, count, device)


def _draw(logits_row, temperature: float, top_k, seed: int, count: int):
    """One sampled token (a 0-d tensor on the logits' device) from logits
    (V,) under the request's key."""
    filtered = prep_sampling_logits(logits_row[None], temperature, top_k)
    gen = request_sample_key(seed, count, logits_row.device)
    return categorical(filtered, gen)[0]


def _sample(logits_row, temperature: float, top_k, seed: int, count: int):
    """One sampled token from logits (V,) under the request's key."""
    return int(_draw(logits_row, temperature, top_k, seed, count))


def choose_tokens(logits, temps, seeds, counts, top_k):
    """The decode step's next-token selection over (N, V) logits: the raw
    argmax for lanes with ``temps[i] <= 0``, else a draw at that
    temperature under ``top_k`` keyed by ``request_sample_key(seeds[i],
    counts[i])``. temps, seeds and counts are host sequences. Returns (N,)
    int64 on the logits' device. The speculative draft and verify steps
    select with this same function, so their per-position choices are the
    ones plain decode would make on the same logits."""
    nxt = torch.argmax(logits, dim=-1)
    for i in np.flatnonzero(np.asarray(temps) > 0.0):
        nxt[i] = _draw(logits[i], float(temps[i]), top_k, int(seeds[i]),
                       int(counts[i]))
    return nxt


# ------------------------------------------------------------------ #
# the decode step
# ------------------------------------------------------------------ #


def _paged_block(cfg: GPTConfig, x, layer_params, k_l, v_l, tables,
                 lengths, wblk, woff, positions):
    """One decoder layer over all slots' single new tokens, reading and
    writing the paged pool in place. The layer math is gpt.decoder_block
    — only the attention core differs (mirrors generation._cached_block)."""

    def attend(q, k, v):
        return paged_attend(k_l, v_l, q, k, v, tables, lengths, wblk,
                            woff), None

    x, _ = decoder_block(cfg, x, layer_params, positions, attend)
    return x


def make_decode_step(cfg: GPTConfig, scfg: ServingConfig):
    """Build the all-slots decode step.

    decode_step(params, k_pool, v_pool, tables, lengths, tokens, temps,
    seeds, counts) -> next_tokens (N,) int64 on the host. tables (N, bps),
    lengths (N,) and tokens (N,) are device tensors; temps, seeds and
    counts are host sequences. The pools are written in place.
    temps[i] <= 0 selects greedy argmax for slot i; > 0 samples at that
    temperature under the config's top_k with
    ``request_sample_key(seeds[i], counts[i])``.
    """
    top_k = scfg.top_k
    if top_k is not None and top_k >= cfg.vocab_size:
        top_k = None  # full-vocab top-k is a no-op filter
    bs = scfg.block_size

    @torch.no_grad()
    def decode_step(params, k_pool, v_pool, tables, lengths, tokens, temps,
                    seeds, counts):
        cdt = cfg.dtype
        N = tokens.shape[0]
        x = params["embed"]["wte"][tokens].to(cdt)[:, None, :]  # (N, 1, D)
        positions = lengths[:, None]                            # (N, 1)
        if not cfg.rotary:
            x = x + params["embed"]["wpe"][positions].to(cdt)
        wblk = tables[torch.arange(N, device=tables.device), lengths // bs]
        woff = lengths % bs
        for i, layer_params in enumerate(layer_slices(params, cfg.n_layer)):
            x = _paged_block(cfg, x, layer_params, k_pool[i], v_pool[i],
                             tables, lengths, wblk, woff, positions)
        x = layer_norm(x, params["final_ln"]["scale"],
                       params["final_ln"]["bias"], cfg.layernorm_eps)
        logits = (x @ head_weight(cfg, params))[:, 0]           # (N, V)
        return choose_tokens(logits, temps, seeds, counts, top_k).cpu()

    return decode_step


# ------------------------------------------------------------------ #
# the engine
# ------------------------------------------------------------------ #


def _params_to(tree, device):
    return {k: _params_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


class ServingEngine:
    """Continuous batching with the slot-based paged KV cache (module
    docstring has the architecture)."""

    def __init__(self, cfg: GPTConfig, params,
                 serving_config: Union[ServingConfig, dict, None] = None,
                 clock=time.monotonic, device=None, mesh=None,
                 monitor=None, monitor_config=None, drafter_params=None):
        scfg = (serving_config if isinstance(serving_config, ServingConfig)
                else ServingConfig.from_dict(serving_config))
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (dp x tp serving) is not ported to the PyTorch "
                "package yet")
        if not cfg.rotary and scfg.max_seq_len > cfg.max_seq:
            raise ValueError(
                f"serving max_seq_len ({scfg.max_seq_len}) exceeds the "
                f"model's learned-position table ({cfg.max_seq})"
            )
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ServingEngine runs on CUDA unless device='cpu' is "
                    "passed, and no CUDA device is available")
            device = "cuda"
        self.device = torch.device(device)
        self.cfg = cfg
        self.scfg = scfg
        self.clock = clock
        self.params = _params_to(params, self.device)
        self.kv = PagedKVCache(cfg, scfg, self.device)
        self.sched = Scheduler(scfg, self.kv.allocator, clock)
        # telemetry facade (monitor/ package): own it when a config is
        # passed, else adopt a process-global one if installed
        if monitor_config is not None:
            self.telemetry = init_monitor(monitor_config)
        else:
            self.telemetry = get_monitor()
        registry = (self.telemetry.registry
                    if self.telemetry is not None else None)
        self.metrics = ServingMetrics(scfg.num_slots, clock, monitor,
                                      registry, slo=scfg.slo)
        self._decode_step = make_decode_step(cfg, scfg)
        # argument signatures of the decode step and the prefills: the
        # watchdog's and the cost index's counterpart of jit caches
        self._decode_sigs = SignatureCache()
        self._prefill_sigs = SignatureCache()
        self._suffix_sigs = SignatureCache()
        if self.telemetry is not None:
            # decode must keep one signature forever; prefill meets one
            # per length bucket, so it is deliberately unwatched
            self.telemetry.watchdog.watch("serving/decode_step",
                                          self._decode_sigs)
        self._rid_counter = itertools.count()
        self._requests: Dict[str, Request] = {}
        self._step_i = 0
        # preemption drain: while set, step() admits nothing new and only
        # finishes the requests already holding slots
        self._draining = False
        # the resilience manager drains live serving engines on preemption
        from ..resilience import get_resilience_manager

        mgr = get_resilience_manager()
        if mgr is not None:
            mgr.attach_serving(self)
        # slot -> in-flight chunked-prefill state (staging cache, cursor)
        self._chunking: Dict[int, dict] = {}
        self._prefill_spent = 0   # prompt tokens prefilled this step
        # speculative decoding: a SpecRuntime owns the drafter (params,
        # paged pool, draft and verify steps) and takes over the decode
        # phase; the decode step above stays as the fallback for slots
        # that cannot speculate a given round
        self._spec = None
        if scfg.speculative is not None:
            from .spec.runtime import SpecRuntime

            self._spec = SpecRuntime(self, scfg.speculative, drafter_params)

    # -- signature counters (the reference's compile counters) --------- #

    @property
    def decode_compile_count(self) -> int:
        return self._decode_sigs._cache_size()

    @property
    def prefill_compile_count(self) -> int:
        return self._prefill_sigs._cache_size()

    @property
    def chunk_prefill_compile_count(self) -> int:
        return self._suffix_sigs._cache_size()

    @property
    def draft_compile_count(self) -> int:
        return self._spec.draft_compile_count if self._spec else -1

    @property
    def verify_compile_count(self) -> int:
        return self._spec.verify_compile_count if self._spec else -1

    def _decode_window(self) -> int:
        """Tokens of KV headroom each active slot needs for the next
        decode phase: 1 for plain decode, draft_k + 1 with speculation on
        (a round's window of writes always has rows)."""
        return self._spec.K + 1 if self._spec is not None else 1

    def set_drafter_params(self, drafter_params) -> None:
        """Swap the drafter's weights in place (same drafter config, so
        the draft step keeps its one signature); every slot's drafter
        cache resyncs lazily. Raises when speculative decoding is off."""
        if self._spec is None:
            raise RuntimeError(
                "set_drafter_params: speculative decoding is not enabled "
                "on this engine")
        self._spec.set_drafter_params(drafter_params)

    # -- queue surface ------------------------------------------------ #

    def submit(self, prompt: Union[Sequence[int], np.ndarray],
               max_new_tokens: Optional[int] = None,
               temperature: float = 0.0,
               request_id: Optional[str] = None,
               arrival_t: Optional[float] = None,
               seed: Optional[int] = None) -> str:
        """Queue one request; returns its id. Raises when the request
        could never fit (context cap / pool footprint) or while the
        engine is draining (``EngineDrainingError``)."""
        if self._draining:
            raise EngineDrainingError(
                "engine is draining (preemption/restart in progress); "
                "admits nothing new — resubmit on another replica")
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        rid = request_id if request_id is not None else \
            f"req-{next(self._rid_counter)}"
        if rid in self._requests:
            raise ValueError(f"duplicate request id {rid!r}")
        req = Request(
            rid=rid,
            prompt=prompt,
            max_new_tokens=(self.scfg.max_new_tokens
                            if max_new_tokens is None else max_new_tokens),
            temperature=float(temperature),
            arrival_t=self.clock() if arrival_t is None else arrival_t,
            seed=(derive_request_seed(self.scfg.seed, rid)
                  if seed is None else int(seed)),
        )
        self.sched.submit(req)
        self._requests[rid] = req
        trace_instant("req/submit", lane="serving", rid=rid,
                      prompt_len=len(prompt),
                      max_new=req.max_new_tokens)
        return rid

    def get(self, rid: str) -> Request:
        return self._requests[rid]

    def has_work(self) -> bool:
        return self.sched.has_work()

    def cancel(self, rid: str, reason: str = "timeout") -> bool:
        """Terminate one request wherever it is (queued or active),
        releasing its slot/blocks; partial output is kept. Returns False
        when the rid is unknown or already finished."""
        req = self._requests.get(rid)
        if req is None or req.state == "finished":
            return False
        self.sched.finish(req, reason)
        self.metrics.record_finish(req, self.clock())
        return True

    # -- the scheduler loop ------------------------------------------- #

    def step(self) -> List[Request]:
        """One scheduler iteration; returns requests finished by it."""
        n_done = len(self.sched.finished)
        with trace_span("serving/step", lane="serving", step=self._step_i):
            now = self.clock()
            for req in self.sched.expire_timeouts(now):
                self.metrics.record_finish(req, now)
            self._prefill_phase()
            for _ in self.sched.ensure_decode_capacity(
                    self._decode_window()):
                self.metrics.record_preemption()
            trace_counter("serving/load", {
                "queued": len(self.sched.queue),
                "active": self.sched.num_active,
            }, lane="serving")
            if self._active_decodable():
                self._decode_all()
        self._step_i += 1
        self.metrics.export(self._step_i)
        return self.sched.finished[n_done:]

    def run(self, max_steps: Optional[int] = None) -> Dict[str, List[int]]:
        """Drive step() until idle (or max_steps); returns {rid: tokens}
        for every finished request."""
        steps = 0
        while self.has_work():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return {r.rid: r.output for r in self.sched.finished}

    def drain(self, max_steps: Optional[int] = None) -> List[str]:
        """Preemption drain: stop admitting, run decode until every
        in-flight (slot-holding) request finishes, and return the rids
        left queued for the caller to re-submit elsewhere."""
        self._draining = True
        steps = 0
        while self.sched.num_active:
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return [r.rid for r in self.sched.queue]

    # -- helpers ------------------------------------------------------ #

    def _record_emitted(self, req: Request, prefill: bool) -> None:
        now = self.clock()
        req.last_token_t = now    # progress clock for expire_timeouts
        if prefill:
            ttft = None
            if req.first_token_t is None:
                req.first_token_t = now
                ttft = now - req.arrival_t
            self.metrics.record_prefill(now, ttft)
        if self.sched.check_finished(req, now):
            self.metrics.record_finish(req, now)

    def _pick_token(self, logits_1d, req: Request) -> int:
        """Prefill-time next-token selection (one request). Greedy is the
        raw argmax make_generator uses; sampling keys off (req.seed,
        token index) exactly like the decode step."""
        if req.temperature <= 0.0:
            return int(torch.argmax(logits_1d))
        top_k = self.scfg.top_k
        if top_k is not None and top_k >= self.cfg.vocab_size:
            top_k = None
        return _sample(logits_1d, req.temperature, top_k, req.seed,
                       len(req.generated))

    def _capture(self, name, sigs, *args):
        """The monitor's hook around one call of entry ``name``
        (``Monitor.capture``); without a monitor it only records the
        call's signature in ``sigs``."""
        if self.telemetry is None:
            sigs.record(*args)
            return nullcontext()
        return self.telemetry.capture(name, sigs, self.device, *args)

    def _forward(self, toks: np.ndarray, cache, offset: int):
        return apply_with_cache(self.cfg, self.params,
                                torch.as_tensor(toks, device=self.device),
                                cache, offset)

    # -- admission: full, suffix, and chunked prefill ------------------ #

    def _budget_ok(self) -> bool:
        b = self.scfg.prefill_token_budget
        return b is None or self._prefill_spent < b

    def _prefill_phase(self) -> None:
        """Chunk-aware prefill phase: pump in-flight prompt chunks, then
        admit queued requests, all under ``prefill_token_budget`` prompt
        tokens per step (a high-water mark: the launch that crosses it
        still runs, so progress is guaranteed). Chunk pumping keeps
        running while draining; only NEW admissions stop."""
        self._prefill_spent = 0
        self._sweep_chunk_states()
        for slot in sorted(self._chunking):
            if not self._budget_ok():
                break
            self._pump_slot(slot, self._chunking[slot])
        if self._draining:
            return
        while self._budget_ok() and \
                (adm := self.sched.pop_admissible()) is not None:
            self._admit_one(*adm)

    def _sweep_chunk_states(self) -> None:
        """Drop chunk states whose request no longer holds the slot
        (preempted or expired mid-prefill). Chunked prefill stages into a
        private dense cache and touches the pool only at finalize, so
        abandoning the state abandons nothing."""
        for slot in list(self._chunking):
            if self.sched.slots[slot] is not self._chunking[slot]["req"]:
                del self._chunking[slot]

    def _admit_one(self, slot: int, req: Request, blocks: List[int]) -> None:
        """Prefill the request's context into its allocated blocks.

        Three paths: (1) no cached prefix, prompt within one chunk — the
        full bucketed prefill; (2) cached prefix — gather shared pages
        into a staging cache, forward only the suffix at the matched
        offset, scatter back the private pages (the matched boundary
        page's re-scatter is the CoW split); (3) long suffix — same
        staging, forwarded ``prefill_chunk`` tokens per engine step."""
        ctx = req.context
        L = len(ctx)
        plan = (self.scfg.prefill_plan(L, req.prefix_matched)
                if (req.prefix_matched > 0
                    or self.scfg.prefill_chunk is not None) else None)
        if plan is None or (req.prefix_matched == 0 and plan[0] == 1):
            self._prefill_full(slot, req, blocks)
            self._prefill_spent += L
            return
        n_chunks, chunk, cache_len = plan
        bs = self.scfg.block_size
        page_to_block = [NULL_BLOCK] * (cache_len // bs)
        for i in range(req.prefix_shared_blocks):
            page_to_block[i] = blocks[i]
        if req.prefix_src is not None:
            page_to_block[req.prefix_shared_blocks] = req.prefix_src[0]
        k_stage, v_stage = self.kv.gather_pages(page_to_block)
        state = {
            "req": req, "blocks": blocks, "m": req.prefix_matched, "L": L,
            "suffix": ctx[req.prefix_matched:], "n": n_chunks,
            "chunk": chunk, "cache_len": cache_len, "k": k_stage,
            "v": v_stage, "next": 0,
        }
        self._chunking[slot] = state
        self._pump_slot(slot, state)

    def _pump_slot(self, slot: int, state: dict) -> None:
        """Forward staged prompt chunks for one slot while the step
        budget allows; the final chunk scatters the staging cache into
        the pool and emits the request's first token."""
        req = state["req"]
        chunk = state["chunk"]
        suffix = state["suffix"]
        while state["next"] < state["n"] and self._budget_ok():
            c = state["next"]
            lo = c * chunk
            hi = min(lo + chunk, len(suffix))
            final = (c + 1) == state["n"]
            if final:
                cm = trace_span("serving/prefill", lane="serving",
                                rid=req.rid, slot=slot,
                                ctx_len=state["L"],
                                bucket=state["cache_len"])
            else:
                cm = trace_span("serving/prefill_chunk", lane="serving",
                                rid=req.rid, chunk=c, tokens=hi - lo)
            with cm as _sp:
                timer = self.metrics.timers(PREFILL_TIMER)
                timer.safe_start()
                toks = np.zeros((1, chunk), np.int64)
                toks[0, :hi - lo] = suffix[lo:hi]
                # one signature per (chunk len, staging len) pair; the
                # offset is a Python int, so every chunk position shares it
                with self._capture(
                        f"serving/suffix_prefill[s{chunk}c"
                        f"{state['cache_len']}]", self._suffix_sigs,
                        self.params, toks, state["k"], state["v"]):
                    logits, _ = self._forward(
                        toks, {"k": state["k"], "v": state["v"]},
                        state["m"] + lo)
                if final:
                    self._finish_staged(req, state)
                    tok = self._pick_token(logits[0, hi - lo - 1], req)
                    req.generated.append(tok)
                timer.stop(sync_with=self.kv.k)
                tel = self.telemetry
                if tel is not None and tel.memwatch is not None:
                    tel.memwatch.annotate(_sp, "prefill")
            self._prefill_spent += hi - lo
            self.metrics.record_prefill_chunk(hi - lo)
            state["next"] += 1
            if final:
                del self._chunking[slot]
                logger.debug(
                    "serving: admitted %s to slot %d (ctx=%d matched=%d "
                    "chunks=%d)", req.rid, slot, state["L"], state["m"],
                    state["n"])
                self._record_emitted(req, prefill=True)

    def _finish_staged(self, req: Request, state: dict) -> None:
        """Scatter the staged suffix into the slot's private blocks.
        Pages fully covered by shared blocks stay mapped read-only (their
        scatter target is the null block); the matched boundary page —
        gathered shared rows plus fresh suffix rows — lands in a private
        block, which IS the copy-on-write split. Then index the prompt in
        the radix cache for the next request."""
        bs = self.scfg.block_size
        m, L, blocks = state["m"], state["L"], state["blocks"]
        first = m // bs
        page_to_block = [NULL_BLOCK] * (state["cache_len"] // bs)
        for p in range(first, blocks_needed(L, bs)):
            page_to_block[p] = blocks[p]
        self.kv.write_pages(state["k"], state["v"], page_to_block)
        if req.prefix_src is not None:
            trace_instant("kv/cow_split", lane="serving", rid=req.rid,
                          block=blocks[first], rows=req.prefix_src[1])
            self.metrics.record_cow_split()
        self.sched.release_prefix_src(req)
        self.metrics.record_reuse(m, L)
        self._index_prompt(req, blocks)

    def _index_prompt(self, req: Request, blocks: List[int]) -> None:
        if self.sched.prefix_cache is None:
            return
        n = blocks_needed(len(req.prompt), self.scfg.block_size)
        self.sched.prefix_cache.insert(req.prompt, blocks[:n])

    def _prefill_full(self, slot: int, req: Request,
                      blocks: List[int]) -> None:
        """Length-bucketed prefill of the request's whole context into
        its allocated blocks; emits the request's next token."""
        ctx = req.context
        L = len(ctx)
        bucket = self.scfg.bucket_for(L)
        with trace_span("serving/prefill", lane="serving", rid=req.rid,
                        slot=slot, ctx_len=L, bucket=bucket) as _sp:
            timer = self.metrics.timers(PREFILL_TIMER)
            timer.safe_start()
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :L] = ctx
            # per bucket: the prefill meets one signature per length bucket
            with self._capture(f"serving/prefill_step[b{bucket}]",
                               self._prefill_sigs, self.params, toks):
                cache = init_cache(self.cfg, 1, bucket, self.device)
                logits, cache = self._forward(toks, cache, 0)
            # admission allocated headroom for the first decode write;
            # only the context's own pages carry prefill data
            data_blocks = blocks[:blocks_needed(L, self.scfg.block_size)]
            self.kv.write_prefill(cache["k"], cache["v"], data_blocks, L)
            tok = self._pick_token(logits[0, L - 1], req)
            req.generated.append(tok)
            timer.stop(sync_with=self.kv.k)
            tel = self.telemetry
            if tel is not None and tel.memwatch is not None:
                tel.memwatch.annotate(_sp, "prefill")
        logger.debug("serving: admitted %s to slot %d (ctx=%d bucket=%d)",
                     req.rid, slot, L, bucket)
        self.metrics.record_reuse(0, L)
        self._index_prompt(req, blocks)
        self._record_emitted(req, prefill=True)

    # -- decode ------------------------------------------------------- #

    def _active_decodable(self):
        """(slot, request) pairs with a pending token this step.
        Chunk-prefilling slots have none yet: their lane stays idle
        (all-null table, length 0)."""
        return [(s, req) for s, req in enumerate(self.sched.slots)
                if req is not None and s not in self._chunking]

    def _dispatch_plain(self, active):
        """Run the decode step with ``active`` lanes populated (the rest
        idle); returns the next tokens (N,) on the host. Both the whole
        decode phase (speculation off) and the fallback for slots that do
        not speculate a round (speculation on)."""
        N = self.scfg.num_slots
        tables = np.zeros((N, self.scfg.blocks_per_slot), np.int64)
        lengths = np.zeros(N, np.int64)
        tokens = np.zeros(N, np.int64)
        temps = np.zeros(N, np.float32)
        seeds = np.zeros(N, np.int64)
        counts = np.zeros(N, np.int64)
        for s, req in active:
            tables[s] = self.sched.slot_table_row(s)
            lengths[s] = req.cached_len
            tokens[s] = req.pending_token
            temps[s] = req.temperature
            seeds[s] = req.seed
            counts[s] = len(req.generated)
        dev = self.device
        dargs = (self.params, self.kv.k, self.kv.v,
                 torch.as_tensor(tables, device=dev),
                 torch.as_tensor(lengths, device=dev),
                 torch.as_tensor(tokens, device=dev), temps, seeds, counts)
        with self._capture("serving/decode_step", self._decode_sigs,
                           *dargs):
            return self._decode_step(*dargs)

    def _decode_all(self) -> None:
        """One decode phase over the full slot array: the speculative
        round when enabled, else one plain decode step."""
        if self._spec is not None:
            self._spec.decode_round()
            return
        active = self._active_decodable()
        tel = self.telemetry
        with trace_span("serving/decode", lane="serving",
                        n_active=len(active),
                        rids=",".join(r.rid for _, r in active)) as _sp:
            _t0 = time.perf_counter()
            timer = self.metrics.timers(DECODE_TIMER)
            timer.safe_start()
            nxt = self._dispatch_plain(active)
            timer.stop()   # nxt is on the host: the step has finished
            ci = tel.cost_index if tel is not None else None
            if ci is not None:
                # nxt reached the host, so this wall time is real
                _stats = ci.note_step("serving/decode_step",
                                      time.perf_counter() - _t0)
                if _stats is not None:
                    _sp.note(mfu=round(_stats["mfu"], 6),
                             verdict=_stats["verdict"])
            if tel is not None and tel.memwatch is not None:
                tel.memwatch.annotate(_sp, "decode")
        if tel is not None:
            tel.watchdog.observe("serving/decode_step", step=self._step_i)
        self.metrics.record_decode_step(len(active), len(self.sched.queue),
                                        self.clock())
        for s, req in active:
            req.cached_len += 1
            req.generated.append(int(nxt[s]))
            self._record_emitted(req, prefill=False)
