"""Serving-engine configuration.

Counterpart of deeperspeed_tpu/serving/config.py, with the same keys,
defaults and errors: a ``"serving"`` block of a JSON config (or a plain
dict) builds a ``ServingConfig``. The sizes here fix the shapes of the
decode step (slot count, block-table width) and of the paged KV pool.

Geometry:

  * ``num_slots`` decode slots — the fixed batch dimension of the decode
    step. A request occupies one slot from admission to eviction.
  * The KV pool holds ``num_blocks`` blocks of ``block_size`` tokens each
    (block 0 is reserved as the null block that idle slots and padding
    point at). Long and short requests draw from the SAME pool — no
    per-request max-length reservation.
  * Prefill pads prompts up to a length bucket (multiples of
    ``block_size``, doubling).

The ``"fleet"``, ``"slo"`` and ``"speculative"`` sub-blocks parse as in the
reference; the port's engine does not serve them yet (``speculative``
raises ``NotImplementedError`` there).
"""

import dataclasses
import math
from typing import Optional, Tuple

_KNOWN_KEYS = frozenset({
    "enabled", "num_slots", "block_size", "num_blocks", "max_seq_len",
    "max_new_tokens", "eos_token_id", "top_k", "request_timeout_s",
    "prefill_buckets", "seed", "fleet", "slo",
    "prefix_caching", "prefill_chunk", "prefill_token_budget",
    "speculative",
})

_SPEC_KNOWN_KEYS = frozenset({
    "enabled", "draft_k", "drafter", "drafter_checkpoint", "num_blocks",
})

_SLO_KNOWN_KEYS = frozenset({
    "ttft_p99_ms", "tpot_p99_ms", "e2e_p99_ms", "error_budget",
})

_ROUTER_KNOWN_KEYS = frozenset({
    "num_replicas", "max_queue_depth", "max_inflight_tokens",
    "default_deadline_s", "retry_max", "retry_backoff_base_s",
    "retry_backoff_max_s", "heartbeat_timeout_s", "progress_timeout_s",
    "replica_restart", "replica_max_restarts", "poll_interval_s",
    "prefix_affinity", "affinity_prefix_len", "affinity_load_slack",
})


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """The ``"slo"`` sub-block of the serving config: tail-latency
    targets the fleet promises its clients. Each target is a p99 bound
    in milliseconds; None leaves that axis unpromised. Targets drive
    live burn-rate gauges and ``slo/violation`` trace instants
    (serving/metrics.SLOTracker) and the offline doctor's verdicts
    (``python -m deeperspeed_tpu_torch.monitor.slo``).

    ``burn_rate = violating_fraction / error_budget`` — at 1.0 the
    request stream is violating exactly as fast as a p99 target allows
    (1% of requests for the default budget); above 1.0 the budget is
    burning down and the pager should care."""

    ttft_p99_ms: Optional[float] = None   # time to first token
    tpot_p99_ms: Optional[float] = None   # time per output token
    e2e_p99_ms: Optional[float] = None    # submit/accept -> terminal
    error_budget: float = 0.01            # allowed violating fraction

    def __post_init__(self):
        for key in ("ttft_p99_ms", "tpot_p99_ms", "e2e_p99_ms"):
            v = getattr(self, key)
            if v is not None and v <= 0:
                raise ValueError(f"{key} must be > 0 or None, got {v}")
        if not 0.0 < self.error_budget < 1.0:
            raise ValueError(
                f"error_budget must be in (0, 1), got {self.error_budget}")

    def targets(self) -> dict:
        """Non-None targets: ``{"ttft": ms, ...}`` keyed by axis."""
        out = {}
        for axis in ("ttft", "tpot", "e2e"):
            v = getattr(self, f"{axis}_p99_ms")
            if v is not None:
                out[axis] = float(v)
        return out

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "SLOConfig":
        if d is None:
            return cls()
        unknown = set(d) - _SLO_KNOWN_KEYS
        if unknown:
            raise ValueError(
                f"unknown slo config keys {sorted(unknown)}; known keys "
                f"are {sorted(_SLO_KNOWN_KEYS)}")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    """The ``"speculative"`` sub-block of the serving config: drafter-
    backed speculative decoding (serving/spec/). Off unless the block is
    present — the plain one-compile decode path is bit-for-bit untouched
    without it.

    The drafter is a second, smaller model sharing the target's
    vocabulary. It proposes ``draft_k`` tokens per round from its own
    paged KV pool; the target then scores all ``draft_k + 1`` positions
    in one batched verify step and keeps the longest agreeing prefix
    plus one bonus token. Greedy output is bit-identical to plain greedy
    decode for ANY drafter — the drafter only changes how many target
    forwards a token costs, never which token is emitted."""

    # tokens drafted per speculative round (the verify step scores
    # draft_k + 1 positions; static — it shapes the compiled programs)
    draft_k: int = 4
    # drafter model config (GPTConfig kwargs, e.g. {"n_layer": 1, ...});
    # None means the engine derives a layer-truncated drafter from the
    # target (serving/spec.truncated_drafter) unless explicit drafter
    # params are passed to the engine
    drafter: Optional[dict] = None
    # checkpoint tag/path the drafter's weights load from (subprocess
    # replicas; in-process engines usually pass drafter_params directly)
    drafter_checkpoint: Optional[str] = None
    # drafter KV pool size in blocks (its own BlockAllocator; block 0
    # reserved exactly like the target pool); None = target num_blocks
    num_blocks: Optional[int] = None

    def __post_init__(self):
        if self.draft_k < 1:
            raise ValueError(
                f"draft_k must be >= 1, got {self.draft_k}")
        if self.num_blocks is not None and self.num_blocks < 2:
            raise ValueError(
                f"speculative num_blocks must be >= 2 (block 0 is the "
                f"reserved null block), got {self.num_blocks}")
        if self.drafter is not None and not isinstance(self.drafter, dict):
            raise ValueError(
                f"drafter must be a GPTConfig kwargs dict or None, got "
                f"{type(self.drafter).__name__}")

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "SpeculativeConfig":
        if d is None:
            return cls()
        unknown = set(d) - _SPEC_KNOWN_KEYS
        if unknown:
            raise ValueError(
                f"unknown speculative config keys {sorted(unknown)}; "
                f"known keys are {sorted(_SPEC_KNOWN_KEYS)}")
        return cls(**{k: v for k, v in d.items() if k != "enabled"})


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """The ``"fleet"`` sub-block of the serving config: the front-end
    router's admission, deadline, retry, and health policy
    (serving/router.py). Every limit is explicit — the router sheds
    rather than queue unboundedly, and a replica that stops heartbeating
    or stops emitting tokens is failed over, not waited on."""

    # replicas the fleet builder spawns (a pre-built replica list wins)
    num_replicas: int = 2
    # admission control: accepted-but-unfinished request cap ...
    max_queue_depth: int = 64
    # ... and in-flight token budget (sum of prompt + max_new_tokens
    # over accepted requests); None disables the token gate
    max_inflight_tokens: Optional[int] = None
    # wall-clock budget per request, checked AT THE ROUTER (distinct
    # from the engine's progress-based request_timeout_s); submit may
    # override per request; None = no deadline
    default_deadline_s: Optional[float] = None
    # bounded failover: re-dispatches allowed per request after replica
    # failures, with exponential backoff between attempts
    retry_max: int = 2
    retry_backoff_base_s: float = 0.05
    retry_backoff_max_s: float = 2.0
    # health watchdogs: a replica is DEAD when its heartbeat is older
    # than this ...
    heartbeat_timeout_s: float = 10.0
    # ... and STALLED when it holds in-flight work but its decode
    # progress counter has not moved for this long
    progress_timeout_s: float = 30.0
    # lifecycle: restart failed replicas (supervisor-style backoff),
    # capped per replica
    replica_restart: bool = True
    replica_max_restarts: int = 2
    # router run()/drive loop sleep when idle
    poll_interval_s: float = 0.01
    # prefix affinity: hash each request's first affinity_prefix_len
    # prompt tokens and prefer the replica that last served that prefix
    # (its radix cache is warm), as long as that replica's assigned
    # count is within affinity_load_slack of the least-loaded one —
    # affinity never overrides health, and never builds hot spots
    prefix_affinity: bool = False
    affinity_prefix_len: int = 64
    affinity_load_slack: int = 2

    def __post_init__(self):
        if self.affinity_prefix_len < 1:
            raise ValueError(
                f"affinity_prefix_len must be >= 1, got "
                f"{self.affinity_prefix_len}")
        if self.affinity_load_slack < 0:
            raise ValueError(
                f"affinity_load_slack must be >= 0, got "
                f"{self.affinity_load_slack}")
        if self.num_replicas < 1:
            raise ValueError(
                f"num_replicas must be >= 1, got {self.num_replicas}")
        if self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {self.max_queue_depth}")
        if (self.max_inflight_tokens is not None
                and self.max_inflight_tokens < 1):
            raise ValueError(
                f"max_inflight_tokens must be >= 1 or None, got "
                f"{self.max_inflight_tokens}")
        if (self.default_deadline_s is not None
                and self.default_deadline_s <= 0):
            raise ValueError(
                f"default_deadline_s must be > 0 or None, got "
                f"{self.default_deadline_s}")
        if self.retry_max < 0:
            raise ValueError(
                f"retry_max must be >= 0, got {self.retry_max}")
        for key in ("retry_backoff_base_s", "retry_backoff_max_s",
                    "heartbeat_timeout_s", "progress_timeout_s",
                    "poll_interval_s"):
            if getattr(self, key) <= 0:
                raise ValueError(
                    f"{key} must be > 0, got {getattr(self, key)}")
        if self.replica_max_restarts < 0:
            raise ValueError(
                f"replica_max_restarts must be >= 0, got "
                f"{self.replica_max_restarts}")

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "RouterConfig":
        if d is None:
            return cls()
        unknown = set(d) - _ROUTER_KNOWN_KEYS
        if unknown:
            raise ValueError(
                f"unknown fleet config keys {sorted(unknown)}; known keys "
                f"are {sorted(_ROUTER_KNOWN_KEYS)}")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    # slot pool: batch dimension of the decode step
    num_slots: int = 8
    # paged KV cache geometry; block 0 is the reserved null block
    block_size: int = 16
    num_blocks: int = 128
    # hard cap on prompt_len + max_new_tokens per request (bounds the
    # block-table width: ceil(max_seq_len / block_size) entries per slot)
    max_seq_len: int = 512
    # default per-request generation budget (requests may pass their own)
    max_new_tokens: int = 64
    # stop token; None disables EOS eviction
    eos_token_id: Optional[int] = None
    # static top-k for sampled (temperature > 0) slots; None = full vocab.
    # Static: one value for the whole engine, as in the reference.
    top_k: Optional[int] = None
    # evict requests (queued or running) older than this; None = never
    request_timeout_s: Optional[float] = None
    # prefill length buckets; () derives doubling multiples of block_size
    prefill_buckets: Tuple[int, ...] = ()
    # base PRNG seed for sampled slots (per-request seeds derive from it)
    seed: int = 0
    # prefix-radix KV reuse: index prefilled prompts in a radix trie and
    # admit new requests by longest cached prefix, mapping shared blocks
    # read-only and prefilling only the suffix. Off by default — the
    # exact-ownership block accounting stays bit-for-bit what it was.
    prefix_caching: bool = False
    # chunked prefill: prompts longer than this prefill in fixed-size
    # chunks interleaved with decode steps (one extra compile per
    # (chunk, cache-bucket) pair in the reference). None
    # disables chunking (one-shot prefill, the original behavior).
    prefill_chunk: Optional[int] = None
    # per-step prefill token budget: one scheduler step runs at most
    # this many prefill tokens (admissions + chunks) before decoding,
    # so a wave of long prompts cannot stall active decodes for more
    # than ~budget tokens of prefill compute. None = unbounded.
    prefill_token_budget: Optional[int] = None
    # multi-replica front-end router policy (serving/router.py); None =
    # single-engine serving, no fleet layer
    fleet: Optional[RouterConfig] = None
    # tail-latency promises (burn-rate gauges + slo/violation instants);
    # None = no SLO accounting
    slo: Optional[SLOConfig] = None
    # drafter-backed speculative decoding (serving/spec/); None = plain
    # one-program decode, the default path, untouched
    speculative: Optional[SpeculativeConfig] = None

    def __post_init__(self):
        if isinstance(self.fleet, dict):
            object.__setattr__(self, "fleet",
                               RouterConfig.from_dict(self.fleet))
        if isinstance(self.slo, dict):
            object.__setattr__(self, "slo",
                               SLOConfig.from_dict(self.slo))
        if isinstance(self.speculative, dict):
            object.__setattr__(self, "speculative",
                               SpeculativeConfig.from_dict(self.speculative))
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {self.num_slots}")
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        if self.max_seq_len < 1:
            raise ValueError(f"max_seq_len must be >= 1, got {self.max_seq_len}")
        # block 0 is the null block — at least one usable block is needed
        if self.num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the reserved null "
                f"block), got {self.num_blocks}"
            )
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}"
            )
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1 or None, got {self.top_k}")
        buckets = self.prefill_buckets or self._default_buckets()
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        for b in buckets:
            if b < 1 or b % self.block_size:
                raise ValueError(
                    f"prefill bucket {b} must be a positive multiple of "
                    f"block_size ({self.block_size})"
                )
        if buckets[-1] < self.max_seq_len:
            raise ValueError(
                f"largest prefill bucket ({buckets[-1]}) must cover "
                f"max_seq_len ({self.max_seq_len})"
            )
        object.__setattr__(self, "prefill_buckets", buckets)
        if self.prefill_chunk is not None and self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 or None, got "
                f"{self.prefill_chunk}")
        if (self.prefill_token_budget is not None
                and self.prefill_token_budget < 1):
            raise ValueError(
                f"prefill_token_budget must be >= 1 or None, got "
                f"{self.prefill_token_budget}")

    def _default_buckets(self):
        buckets, b = [], self.block_size
        while b < self.max_seq_len:
            buckets.append(b)
            b *= 2
        buckets.append(self.blocks_per_slot * self.block_size)
        return tuple(buckets)

    @property
    def blocks_per_slot(self) -> int:
        """Block-table width: blocks a maximally long request occupies."""
        return math.ceil(self.max_seq_len / self.block_size)

    @property
    def usable_blocks(self) -> int:
        """Allocatable blocks (the pool minus the null block)."""
        return self.num_blocks - 1

    def bucket_for(self, length: int) -> int:
        """Smallest prefill bucket covering ``length``."""
        for b in self.prefill_buckets:
            if b >= length:
                return b
        raise ValueError(
            f"prompt length {length} exceeds the largest prefill bucket "
            f"({self.prefill_buckets[-1]}); raise max_seq_len"
        )

    def prefill_plan(self, ctx_len: int,
                     matched: int = 0) -> Optional[Tuple[int, int, int]]:
        """Shape plan for a (possibly suffix-only, possibly chunked)
        staging-cache prefill of ``ctx_len`` context tokens of which
        ``matched`` are already cached: ``(n_chunks, chunk_tokens,
        cache_len)``. The forward runs n_chunks times over
        (1, chunk_tokens) token slabs against a (1, cache_len) staging
        cache at a TRACED offset, so compiles are bounded by
        (chunk size, cache bucket) pairs, never by matched/offset values.
        None when no bucket combination covers the request — the caller
        falls back to the one-shot full prefill (correct, just unshared).
        """
        suffix = ctx_len - matched
        if suffix < 1:
            return None
        try:
            if (self.prefill_chunk is not None
                    and suffix > self.prefill_chunk):
                chunk = self.prefill_chunk
                n = math.ceil(suffix / chunk)
                return n, chunk, self.bucket_for(matched + n * chunk)
            s_pad = self.bucket_for(suffix)
            cache_len = (self.bucket_for(matched + s_pad) if matched
                         else s_pad)
            return 1, s_pad, cache_len
        except ValueError:
            return None

    def kv_pool_bytes(self, n_layer: int, kv_heads: int, head_dim: int,
                      dtype_bytes: int = 2) -> int:
        """Bytes the paged KV pool pins in device memory for a given
        model shape: K and V for every layer, every block."""
        per_token = 2 * n_layer * kv_heads * head_dim
        return self.num_blocks * self.block_size * per_token * dtype_bytes

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "ServingConfig":
        """Build from a ``"serving"`` config block. Unknown keys raise —
        a typo'd knob silently falling back to its default is the classic
        serving-config footgun."""
        if d is None:
            return cls()
        unknown = set(d) - _KNOWN_KEYS
        if unknown:
            raise ValueError(
                f"unknown serving config keys {sorted(unknown)}; known keys "
                f"are {sorted(_KNOWN_KEYS)}"
            )
        kw = {k: v for k, v in d.items() if k != "enabled"}
        if "prefill_buckets" in kw and kw["prefill_buckets"] is not None:
            kw["prefill_buckets"] = tuple(kw["prefill_buckets"])
        return cls(**kw)
