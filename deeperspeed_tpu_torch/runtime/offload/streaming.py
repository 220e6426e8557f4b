"""Streamed ZeRO-Infinity training: models whose optimizer state (and
grads) do not fit on the card, with the master and the Adam moments in
host RAM or on NVMe and only the params resident on the card.

Counterpart of deeperspeed_tpu/runtime/offload/streaming.py
(``StreamedOffloadEngine``, ``StreamConfig``, the host and device wire
codecs, ``stream_config_from_ds_config``, ``build_streamed_engine``), for
the GPT family. The schedule is the reference's:

  1. **Layer-group streaming.** The forward runs group by group
     (``group_layers`` decoder layers each) under ``torch.no_grad`` and
     keeps only the boundary activations. The backward re-runs each group
     in reverse under autograd on a ``requires_grad`` copy of the group's
     resident params, so at most one group's grads exist on the card at a
     time; the group is the unit of recomputation (no per-layer
     checkpointing inside it).

  2. **A quantized offload wire.** Each group's grads are block-quantized
     on the card (per-block absmax scales, stochastic rounding drawn from a
     device ``torch.Generator`` seeded from (seed, step, group)), copied
     into pinned host buffers, and consumed by one native host pass
     (ops/adam.DeepSpeedCPUAdam over csrc/host/ds_cpu_adam.cpp):
     dequantize, Adam, then quantize the uplink. Params resident in bf16
     get the delta (master - shadow) with error feedback against the
     host's exact shadow of the card's params; params resident as int4 or
     int8 codes (``resident_bits``) get the new codes themselves, which
     the card stores verbatim. Leaves below ``MIN_QUANT_SIZE`` elements
     ride the wire at 8 bits and stay bf16 on the card.

The wire format is the reference's byte for byte (int8 per block, then one
half-split nibble pack per leaf for int4), and so are the host codecs, the
fresh host init (the same ``np.random.default_rng(seed)`` draws in the
same order), the chunk layout and the checkpoint files: each package
resumes the other's. The stochastic rounding draws differ (jax's PRNG is
not reproduced), so the two packages agree exactly only on the
deterministic wires (``wire_bits`` 16 and 32 with bf16 residency).

Departure: with ``use_native_host`` (the default) the host library must
build and load, else construction raises with the compiler's error; the
numpy pass runs only when the config sets ``use_native_host: false`` (the
reference drops to it silently). Wires of 16 or 32 bits always take the
numpy pass, in both packages, since the native pass codes 4 and 8 bits.

Not ported (each raises ``NotImplementedError`` naming its ROADMAP.md
item): the BERT family, a data-parallel mesh and compact checkpoints.
"""

import dataclasses
import json
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...models import gpt as gpt_mod
from ...models.gpt import GPTConfig
from ...ops.adam import DeepSpeedCPUAdam, tree_map
from ...utils.logging import log_dist
from .aio_config import AioConfig
from .swapper import PartitionedOptimizerSwapper, PipelinedOptimizerSwapper

# leaves smaller than this ride the wire at >= 8 bits whatever wire_bits
# says, and stay bf16 on the card (their bytes are noise; their precision
# is not)
MIN_QUANT_SIZE = 1 << 20
# device quantization works on segments of this many blocks, so its fp32
# temporaries stay segment-sized (8192 blocks x 128 x 4 B = 4 MB)
QUANT_SEGMENT_BLOCKS = 8192


def _unported(what: str, part: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md queue "
        f"1, item 10 'Offload and ZeRO-Infinity': {part}); use the JAX "
        f"package")


# --------------------------------------------------------------------- #
# trees: nested dicts, leaves in sorted-key order (the reference's
# jax.tree.leaves order, which fixes the chunk layout)
# --------------------------------------------------------------------- #


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(template, leaves) -> Any:
    """A tree shaped like ``template`` holding ``leaves`` in order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(template)


def _shapes(tree):
    """The template of a tree of arrays: the same tree of shape tuples."""
    return tree_map(lambda a: tuple(np.shape(a)), tree)


def _emit_chunk(tree):
    """One fresh-init chunk: (leaf shapes, flat fp32)."""
    flat = np.concatenate([np.asarray(leaf, np.float32).reshape(-1)
                           for leaf in tree_leaves(tree)])
    return _shapes(tree), flat


def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


# --------------------------------------------------------------------- #
# bf16 <-> fp32 bit helpers
# --------------------------------------------------------------------- #


# the host passes below split a large vector into contiguous pieces on
# torch's intra-op threads (numpy drops the GIL in its loops); every
# element (every block, for the codecs) is computed alone, so the bytes
# are those of one pass. Vectors under PAR_MIN elements take one pass.
PAR_MIN = 1 << 20


def par_ranges(n: int, align: int = 1, threads: Optional[int] = None,
               unit: int = 1):
    """[(start, stop)] covering range(n) (items of ``unit`` elements) in
    about two pieces a thread, each start a multiple of ``align``; one
    range for a small vector or one thread."""
    threads = max(1, torch.get_num_threads() if threads is None
                  else int(threads))
    if threads == 1 or n * unit < PAR_MIN:
        return [(0, n)]
    step = -(-n // (2 * threads))
    step = -(-step // align) * align
    return [(a, min(a + step, n)) for a in range(0, n, step)]


def par_run(fn, n: int, align: int = 1, threads: Optional[int] = None,
            unit: int = 1):
    """``fn(start, stop)`` over ``par_ranges(n, align, threads, unit)``,
    on threads when there are several ranges."""
    ranges = par_ranges(n, align, threads, unit)
    if len(ranges) == 1:
        fn(*ranges[0])
        return
    with ThreadPoolExecutor(max_workers=len(ranges)) as pool:
        list(pool.map(lambda r: fn(*r), ranges))


def _concat(flats) -> np.ndarray:
    """``np.concatenate`` of 1-D fp32 arrays, each copied in pieces."""
    out = np.empty(sum(a.size for a in flats), np.float32)
    o = 0
    for a in flats:
        dst = out[o: o + a.size]
        par_run(lambda i, j, a=a, dst=dst: np.copyto(dst[i:j], a[i:j]),
                a.size)
        o += a.size
    return out


def bf16_bits_to_f32(u16: np.ndarray) -> np.ndarray:
    u16 = np.asarray(u16)
    out = np.empty(u16.shape, np.float32)
    src, dst = u16.reshape(-1), out.reshape(-1).view(np.uint32)

    def piece(a, b):
        np.left_shift(src[a:b], 16, out=dst[a:b], dtype=np.uint32)

    par_run(piece, src.size)
    return out


def f32_to_bf16_bits(f32: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even fp32 -> bf16 bit pattern (uint16)."""
    u = np.ascontiguousarray(f32, np.float32).view(np.uint32)
    out = np.empty(u.shape, np.uint16)
    src, dst = u.reshape(-1), out.reshape(-1)

    def piece(a, b):
        x = src[a:b]
        rounded = x + np.uint32(0x7FFF) + ((x >> 16) & 1)
        dst[a:b] = rounded >> 16

    par_run(piece, src.size)
    return out


# --------------------------------------------------------------------- #
# host wire codec: symmetric per-block absmax quantization
# --------------------------------------------------------------------- #


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1  # 7 for int4, 127 for int8


def host_dequant(packed: np.ndarray, scales: np.ndarray, n: int,
                 bits: int, block: int,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """Wire buffer -> fp32[n]. Wire dtypes: fp32 for bits=32, uint16 (bf16
    bits) for 16, uint8 for 8 and 4. int4 packs HALF-SPLIT: byte i carries
    element i (low nibble) and element half+i (high nibble) of the
    block-padded vector."""
    packed = np.asarray(packed)
    if bits == 32:
        res = packed.view(np.float32)[:n]
    elif bits == 16:
        res = bf16_bits_to_f32(packed.view(np.uint16)[:n])
    else:
        # block by block (in pieces, ``par_run``), into the output
        res = np.empty(n, np.float32) if out is None else out
        dst = res.reshape(-1)
        sc = scales.astype(np.float32)
        half = packed.size  # int4: the elements of the lower half
        codes = packed.view(np.int8) if bits == 8 else packed

        def nibbles(x):
            q = x.astype(np.int8)
            q[q >= 8] -= 16
            return q

        def piece(b0, b1):
            e0, e1 = b0 * block, min(b1 * block, n)
            if bits == 8:
                q = codes[e0:e1].astype(np.float32)
            else:  # 4: half-split nibbles
                q = np.empty(e1 - e0, np.float32)
                lo_end, hi_start = min(e1, half), max(e0, half)
                if lo_end > e0:
                    q[:lo_end - e0] = nibbles(codes[e0:lo_end] & 0x0F)
                if e1 > hi_start:
                    q[hi_start - e0:] = nibbles(
                        codes[hi_start - half: e1 - half] >> 4)
            full = (e1 - e0) // block
            q[:full * block].reshape(full, block)[...] *= \
                sc[b0: b0 + full, None]
            if full * block < e1 - e0:
                q[full * block:] *= sc[b0 + full]
            dst[e0:e1] = q

        par_run(piece, -(-n // block), unit=block)
        return res
    if out is not None:
        np.copyto(out, res)
        return out
    return np.ascontiguousarray(res, np.float32)


def _block_codes(x: np.ndarray, bits: int, block: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """fp32[n] -> (int8 codes of the block-padded vector, fp32 per-block
    absmax scales), rounding to nearest. Each block's codes depend on that
    block alone (so the blocks may be coded in pieces, ``par_run``)."""
    x = x.reshape(-1)
    n = x.size
    nb = -(-n // block)
    qm = _qmax(bits)
    q_out = np.empty(nb * block, np.int8)
    s_out = np.empty(nb, np.float32)

    def piece(b0, b1):
        xa = x[b0 * block: min(b1 * block, n)]
        pad = (b1 - b0) * block - xa.size
        xb = np.pad(xa.astype(np.float32, copy=False), (0, pad)).reshape(
            b1 - b0, block)
        s = np.abs(xb).max(axis=1) / qm
        s[s == 0] = 1.0
        q_out[b0 * block: b1 * block] = np.clip(
            np.rint(xb / s[:, None]), -qm - 1, qm).astype(np.int8).reshape(-1)
        s_out[b0:b1] = s

    par_run(piece, nb, unit=block)
    return q_out, s_out


def _pack_codes(q: np.ndarray, bits: int) -> np.ndarray:
    """int8 codes -> the uint8 wire: one byte a code for int8; for int4
    one half-split nibble pack over the whole vector."""
    if bits == 8:
        return q.view(np.uint8)
    half = q.size // 2
    out = np.empty(half, np.uint8)

    def piece(a, b):
        out[a:b] = (q[a:b] & 0x0F) | ((q[half + a: half + b] & 0x0F) << 4)

    par_run(piece, half)
    return out


def host_quant(x: np.ndarray, bits: int, block: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """fp32[n] -> (wire buffer, fp32 per-block scales). Deterministic
    round-to-nearest (the uplink has error feedback, so the rounding's bias
    carries into the next step instead of being lost)."""
    if bits == 32:
        return np.ascontiguousarray(x, np.float32), np.zeros(0, np.float32)
    if bits == 16:
        return f32_to_bf16_bits(x), np.zeros(0, np.float32)
    q, s = _block_codes(x, bits, block)
    return _pack_codes(q, bits), s


def host_quant_log(x: np.ndarray, bits: int, block: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Non-negative vector -> per-block log2-domain codes (the reference's
    codec for exp_avg_sq in compact checkpoints). Code 0 is an exact zero;
    1..2^bits-1 span [lo, hi] in log2, where lo and hi bound the block's
    positive values. Returns (packed codes, per-block [lo, step] fp32
    pairs flattened); int4 packs half-split unsigned nibbles."""
    n = x.size
    nb = -(-n // block)
    pad = nb * block - n
    xb = np.pad(x.astype(np.float32, copy=False), (0, pad)).reshape(
        nb, block)
    levels = (1 << bits) - 1  # nonzero codes 1..levels
    pos = xb > 0
    any_pos = pos.any(axis=1)
    minpos = np.where(pos, xb, np.inf).min(axis=1)  # inf if no positive
    maxv = xb.max(axis=1)
    lo = np.where(any_pos, np.log2(np.where(any_pos, minpos, 1.0)),
                  0.0).astype(np.float32)
    hi = np.where(any_pos, np.log2(np.where(any_pos, maxv, 1.0)),
                  0.0).astype(np.float32)
    step = np.where(any_pos, (hi - lo) / max(levels - 1, 1), 0.0).astype(
        np.float32)
    safe_step = np.where(step > 0, step, 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        lg = np.where(pos, np.log2(np.where(pos, xb, 1.0)), 0.0)
    q = np.where(
        pos,
        np.clip(np.rint((lg - lo[:, None]) / safe_step[:, None]) + 1,
                1, levels),
        0).astype(np.uint8)
    flat = q.reshape(-1)
    scales = np.stack([lo, step], axis=1).reshape(-1)
    if bits == 8:
        return flat, scales
    half = flat.size // 2
    packed = ((flat[:half] & 0x0F)
              | ((flat[half:] & 0x0F) << 4)).astype(np.uint8)
    return packed, scales


def host_dequant_log(packed: np.ndarray, scales: np.ndarray, n: int,
                     bits: int, block: int) -> np.ndarray:
    """Inverse of host_quant_log -> fp32[n] (zeros restore exactly)."""
    if bits == 8:
        q = packed.astype(np.float32)
        qi = packed
    else:
        lo_n = (packed & 0x0F)
        hi_n = (packed >> 4)
        qi = np.concatenate([lo_n, hi_n])
        q = qi.astype(np.float32)
    nb = -(-n // block)
    q = q[: nb * block].reshape(nb, block)
    qi = qi[: nb * block].reshape(nb, block)
    sc = scales.reshape(nb, 2)
    lo, step = sc[:, 0][:, None], sc[:, 1][:, None]
    v = np.exp2(lo + (q - 1.0) * step)
    v = np.where(qi == 0, 0.0, v).astype(np.float32)
    return v.reshape(-1)[:n]


# --------------------------------------------------------------------- #
# device wire codec (plain torch on the card's tensors)
# --------------------------------------------------------------------- #


def _dev_quant(x_flat: torch.Tensor, bits: int, block: int,
               gen: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat tensor -> (wire, fp32 scales), rounding stochastically
    (unbiased) with uniforms drawn from ``gen``. Wire dtypes: fp32 for
    bits=32, bf16 for 16, uint8 for 8 and 4 (int8 codes per block, then
    one half-split nibble pack over the leaf for int4).

    The blocks are quantized in segments of QUANT_SEGMENT_BLOCKS, so the
    fp32 temporaries (the upcast input, the normalized values and the
    uniform draws) are segment-sized, whatever the leaf's size."""
    dev = x_flat.device
    n = x_flat.numel()
    if bits == 32:
        return x_flat.float(), torch.zeros(0, dtype=torch.float32, device=dev)
    if bits == 16:
        return (x_flat.to(torch.bfloat16),
                torch.zeros(0, dtype=torch.float32, device=dev))
    nb = -(-n // block)
    if nb == 0:  # empty leaf: empty wire and scales
        return (torch.zeros(0, dtype=torch.uint8, device=dev),
                torch.zeros(0, dtype=torch.float32, device=dev))
    qm = _qmax(bits)
    seg = min(nb, QUANT_SEGMENT_BLOCKS)
    q = torch.empty(nb * block, dtype=torch.int8, device=dev)
    scales = torch.empty(nb, dtype=torch.float32, device=dev)
    for b0 in range(0, nb, seg):
        b1 = min(b0 + seg, nb)
        e0, e1 = b0 * block, min(b1 * block, n)
        xb = torch.zeros((b1 - b0) * block, dtype=torch.float32, device=dev)
        xb[: e1 - e0] = x_flat[e0:e1]
        xb = xb.view(b1 - b0, block)
        s = xb.abs().amax(dim=1) / qm
        s = torch.where(s == 0, torch.ones_like(s), s)
        y = xb / s[:, None]
        u = torch.rand(y.shape, generator=gen, dtype=torch.float32,
                       device=dev)
        q[b0 * block: b1 * block] = torch.clamp(
            torch.floor(y + u), -qm - 1, qm).to(torch.int8).view(-1)
        scales[b0:b1] = s
    flat = q.view(torch.uint8)
    if bits == 8:
        return flat, scales
    half = flat.numel() // 2
    return (flat[:half] & 0x0F) | ((flat[half:] & 0x0F) << 4), scales


def _dev_dequant(packed: torch.Tensor, scales: torch.Tensor, n: int,
                 bits: int, block: int) -> torch.Tensor:
    """Inverse of host_quant on the card -> fp32[n]. Wire dtypes as
    host_quant gives them (fp32, bf16 bits as int16, uint8)."""
    if bits == 32:
        return packed[:n]
    if bits == 16:
        return packed.view(torch.bfloat16).float()[:n]
    if bits == 8:
        q = packed.view(torch.int8).float()
    else:
        lo = (packed & 0x0F).to(torch.int16)
        hi = (packed >> 4).to(torch.int16)
        q = torch.cat([torch.where(lo >= 8, lo - 16, lo),
                       torch.where(hi >= 8, hi - 16, hi)]).float()
    nb = -(-n // block)
    q = q[: nb * block].view(nb, block) * scales[:, None]
    return q.view(-1)[:n]


# pieces of whole wire blocks a host thread takes in the native pass: a
# few, so that the threads finish together
PIECES_PER_THREAD = 4


def _host_map(fn, items, threads: int) -> list:
    """[fn(x) for x in items], on ``threads`` threads when above 1."""
    items = list(items)
    if threads <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=min(threads, len(items))) as pool:
        return list(pool.map(fn, items))


def _nbytes(x) -> int:
    """Bytes of the host buffers in a wire value (arrays, lists, tuples,
    dicts of them, None)."""
    if x is None:
        return 0
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return int(x.nbytes)


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host wire or shadow buffer -> an owned tensor on ``device`` (bf16
    bits travel as int16; the card reinterprets them)."""
    if arr.dtype == np.uint16:
        arr = arr.view(np.int16)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return t.clone()
    return t.to(device)


@dataclasses.dataclass
class StreamConfig:
    """Execution and channel config of the streamed offload engine (the
    reference's fields, names and defaults)."""
    micro_batch: int = 1
    seq: int = 2048
    group_layers: int = 1
    wire_bits: int = 4           # 4 | 8 | 16 | 32
    wire_block: int = 128
    state_device: str = "cpu"    # cpu | nvme  (master + moments)
    swap_folder: Optional[str] = None
    pipeline_swap: bool = True
    lr: float = 1.2e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.0
    warmup_steps: int = 10
    seed: int = 0
    # the fused native host pass (csrc/host/ds_cpu_adam.cpp); False takes
    # the numpy pass
    use_native_host: bool = True
    # resident param precision on the card: 16 = bf16; 4 | 8 = block codes
    # + fp32 scales, dequantized to bf16 per group while it computes.
    # Leaves below MIN_QUANT_SIZE stay bf16 whatever this says. The host
    # shadow holds the same codes, so shadow == card holds byte for byte.
    resident_bits: int = 16      # 16 | 8 | 4
    # host optimizer state precision: 'fp32' (12 B/param) or 'bf16' (bf16
    # bits for master and moments, 6 B/param, fp32 only per wire block)
    host_state: str = "fp32"     # fp32 | bf16
    # the states the NVMe tier holds when state_device='nvme': 'all', or
    # 'exp_avg_sq' (master and exp_avg stay in RAM)
    swap_states: str = "all"
    # save_checkpoint prunes the previous 'latest' checkpoint only when its
    # tag was generated (global_step*); named tags are always kept
    ckpt_prune_auto_tags: bool = True
    # compact checkpoints: not ported (True raises)
    ckpt_compact: bool = False
    ckpt_moment_bits: int = 4            # 4 | 8
    ckpt_master_residual_bits: int = 0   # 0 (off) | 4 | 8


class _ChunkMeta:
    """Wire layout of one host chunk: leaf order, sizes, offsets, per-leaf
    wire precision. Quantized profiles (wire_bits 4/8) concatenate every
    leaf into one uint8 wire buffer and one fp32 scales buffer a direction
    (small leaves ride int8, so the buffer stays uint8); the bf16 and fp32
    wires keep per-leaf buffers."""

    def __init__(self, template, wire_bits: int, resident_bits: int = 16):
        self.sizes = [int(np.prod(s)) for s in tree_leaves(template)]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).astype(
            np.int64)
        self.total = int(self.offsets[-1])
        self.concat = wire_bits < 16
        self.bits = [
            wire_bits if (wire_bits >= 16 or s >= MIN_QUANT_SIZE) else 8
            for s in self.sizes]
        # resident precision per leaf: codes only for the large matmul
        # weights; small leaves (layer norms, biases) stay bf16
        self.res_bits = [
            resident_bits if (resident_bits < 16 and s >= MIN_QUANT_SIZE)
            else 16
            for s in self.sizes]
        self.quant_resident = any(b < 16 for b in self.res_bits)

    def wire_geometry(self, block: int):
        """Per-leaf packed-byte and scale counts and their cumulative
        offsets in the concatenated uint8 wire (quantized profiles)."""
        pb, sc = [], []
        for n, bits in zip(self.sizes, self.bits):
            nb = -(-n // block)
            pb.append(nb * block // 2 if bits == 4 else nb * block)
            sc.append(nb)
        return (pb, np.concatenate([[0], np.cumsum(pb)]).astype(np.int64),
                sc, np.concatenate([[0], np.cumsum(sc)]).astype(np.int64))

    def res_geometry(self, block: int):
        """Resident layout of a quant-resident chunk: coded leaves in one
        uint8 codes buffer ("c") with fp32 scales ("s"), small leaves in a
        separate bf16 buffer ("w"). Returns (code_bytes, code_offsets,
        n_scales, scale_offsets, w_elems, w_offsets) per leaf, zeros where
        a list does not apply to a leaf."""
        pb, sc, wl = [], [], []
        for n, bits in zip(self.sizes, self.res_bits):
            if bits >= 16:
                pb.append(0)
                sc.append(0)
                wl.append(n)
            else:
                nb = -(-n // block)
                pb.append(nb * block // 2 if bits == 4 else nb * block)
                sc.append(nb)
                wl.append(0)

        def off(v):
            return np.concatenate([[0], np.cumsum(v)]).astype(np.int64)

        return pb, off(pb), sc, off(sc), wl, off(wl)


class StreamedOffloadEngine:
    """Single-process streamed training engine for GPT models whose Adam
    state exceeds the card's memory: ``loss = engine.train_batch(tokens)``
    with tokens (B, S+1) int. ``engine.timings`` holds the step's
    breakdown (compute_s, d2h_s, h2d_s, host_opt_s, summed over steps, at
    the blocking points of the schedule; initial_upload_s)."""

    def __init__(self, cfg: GPTConfig, scfg: StreamConfig,
                 host_params: Optional[dict] = None,
                 device: Optional[Any] = None,
                 mesh: Optional[Any] = None,
                 aio_config: Optional[AioConfig] = None):
        if mesh is not None:
            raise _unported("the streamed engine over a data-parallel mesh",
                            "Streaming over a data-parallel mesh")
        if not isinstance(cfg, GPTConfig):
            raise _unported(f"streaming a {type(cfg).__name__} (the BERT "
                            f"family)", "BERT streaming")
        if cfg.moe is not None:
            raise NotImplementedError(
                "StreamedOffloadEngine supports dense GPT and BERT models")
        if cfg.n_layer % scfg.group_layers:
            raise ValueError("n_layer must be divisible by group_layers")
        if scfg.wire_bits not in (4, 8, 16, 32):
            raise ValueError("wire_bits must be 4, 8, 16 or 32")
        if scfg.wire_block <= 0 or scfg.wire_block % 2:
            raise ValueError(
                f"wire_block must be positive and even (int4 half-split "
                f"nibble packing), got {scfg.wire_block}")
        if scfg.resident_bits not in (4, 8, 16):
            raise ValueError("resident_bits must be 4, 8 or 16")
        if scfg.host_state not in ("fp32", "bf16"):
            raise ValueError("host_state must be 'fp32' or 'bf16'")
        if scfg.swap_states not in ("all", "exp_avg_sq"):
            raise ValueError("swap_states must be 'all' or 'exp_avg_sq'")
        if scfg.ckpt_moment_bits not in (4, 8):
            raise ValueError("ckpt_moment_bits must be 4 or 8 (other "
                             "values silently corrupt the nibble packing)")
        if scfg.ckpt_master_residual_bits not in (0, 4, 8):
            raise ValueError("ckpt_master_residual_bits must be 0, 4 or 8")
        if scfg.ckpt_compact:
            raise _unported("ckpt_compact (compact checkpoints)",
                            "Compact streamed checkpoints")
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "StreamedOffloadEngine runs on CUDA unless given "
                "device='cpu', and no CUDA device is available")
        self.cfg = cfg
        self.scfg = scfg
        self.n_groups = cfg.n_layer // scfg.group_layers
        self.step_count = 0
        self.timings: Dict[str, float] = {}
        # test surface: when True, _host_chunk_step keeps the fp32 grads it
        # dequantized off the wire (per chunk) in .last_grads
        self.capture_grads = False
        self.last_grads: Dict[str, np.ndarray] = {}
        # which route each host pass of the last step took, by chunk
        # ("native_v2" or "numpy"), and the bytes the last step moved over
        # the host<->card wire (grads down, uplink up, with scales)
        self.host_routes: Dict[str, str] = {}
        self.wire_bytes_last_step = 0
        self._rng = np.random.default_rng(scfg.seed)
        # host threads of the native pass (pieces of whole wire blocks):
        # torch's intra-op thread count
        self.host_threads = max(1, torch.get_num_threads())
        self.opt = DeepSpeedCPUAdam(
            lr=scfg.lr, betas=scfg.betas, eps=scfg.eps,
            weight_decay=scfg.weight_decay, native=scfg.use_native_host)

        # host state, one chunk at a time: a whole model's fp32 tree next to
        # its Adam state would not fit the host
        self._leaf_templates: Dict[str, Any] = {}
        self.chunk_names: List[str] = []
        self.n_params = 0
        self._meta: Dict[str, _ChunkMeta] = {}
        self._shadow: Dict[str, Any] = {}
        self._ram: Dict[str, Dict[str, np.ndarray]] = {}
        self.swapper = None
        if scfg.state_device == "nvme":
            folder = scfg.swap_folder or os.path.join(
                tempfile.gettempdir(), "ds_tpu_stream_swap")
            cls = (PipelinedOptimizerSwapper if scfg.pipeline_swap
                   else PartitionedOptimizerSwapper)
            self.swapper = cls(aio_config or AioConfig(), folder)
        for cname, template, flat in self._iter_chunks(host_params):
            self._leaf_templates[cname] = template
            self.chunk_names.append(cname)
            self.n_params += flat.size
            meta = _ChunkMeta(template, scfg.wire_bits, scfg.resident_bits)
            self._meta[cname] = meta
            if meta.quant_resident:
                # the shadow is the per-leaf codes; the master keeps the
                # init's full precision and stays authoritative (each
                # uplink replaces the card's codes with quant(master))
                self._shadow[cname] = self._quant_shadow_from_f32(meta, flat)
                master = np.ascontiguousarray(flat, np.float32)
            else:
                self._shadow[cname] = f32_to_bf16_bits(flat)
                # the master tracks the shadow (what the card holds), so
                # step 0 starts with zero residual
                master = bf16_bits_to_f32(self._shadow[cname])
            del flat
            states = {"master": self._st_store(master),
                      "exp_avg": self._st_zeros(master.size),
                      "exp_avg_sq": self._st_zeros(master.size)}
            del master
            self._register_states(cname, states)
            del states
        log_dist(
            f"StreamedOffloadEngine: {self.n_params:,} params, "
            f"{self.n_groups} groups, wire=int{scfg.wire_bits}, Adam state "
            f"({self.n_params * 12 / 2**30:.1f} GB fp32) on "
            f"{scfg.state_device}", ranks=[0])

        self._dev_groups: List[Any] = []
        self._dev_globals = None
        self._pinned: Dict[Tuple, torch.Tensor] = {}
        self._upload_initial()

    def _register_states(self, cname, states):
        if self.swapper is None:
            self._ram[cname] = states
        elif self.scfg.swap_states == "exp_avg_sq":
            # master and m in RAM, v on the NVMe tier
            self._ram[cname] = {k: states[k] for k in ("master", "exp_avg")}
            self.swapper.register_leaf(
                cname, {"exp_avg_sq": states["exp_avg_sq"]})
        else:
            self.swapper.register_leaf(cname, states)

    # ------------------------------------------------------------- #
    # shadow / host-state representation
    # ------------------------------------------------------------- #

    def _st_store(self, f32: np.ndarray) -> np.ndarray:
        """fp32 optimizer-state vector -> its stored representation."""
        if self.scfg.host_state == "bf16":
            return f32_to_bf16_bits(f32)
        return np.ascontiguousarray(f32, np.float32)

    def _st_zeros(self, n: int) -> np.ndarray:
        """A zero state vector, stored (bf16 +0.0 is the bits 0)."""
        return np.zeros(n, np.uint16 if self.scfg.host_state == "bf16"
                        else np.float32)

    @staticmethod
    def _st_load(arr: np.ndarray) -> np.ndarray:
        """Stored state -> fp32 working copy (the fp32 store itself)."""
        if arr.dtype == np.uint16:
            return bf16_bits_to_f32(arr)
        return arr

    @staticmethod
    def _st_writeback(store: np.ndarray, f32: np.ndarray):
        if store.dtype == np.uint16:
            store[:] = f32_to_bf16_bits(f32)

    def _quant_shadow_from_f32(self, meta: _ChunkMeta, flat: np.ndarray):
        """Per-leaf shadow entries of a quant-resident chunk: (codes,
        scales) for coded leaves, bf16 bits for the small ones."""
        block = self.scfg.wire_block

        def entry(i):
            o, n = int(meta.offsets[i]), meta.sizes[i]
            leaf = flat[o: o + n]
            if meta.res_bits[i] < 16:
                return host_quant(leaf, meta.res_bits[i], block)
            return f32_to_bf16_bits(leaf)

        return [entry(i) for i in range(len(meta.sizes))]

    def _shadow_f32(self, cname: str) -> np.ndarray:
        """Shadow -> flat fp32 (the exact image of the card's params)."""
        meta = self._meta[cname]
        sh = self._shadow[cname]
        if not meta.quant_resident:
            return bf16_bits_to_f32(sh)
        out = np.empty(meta.total, np.float32)
        block = self.scfg.wire_block
        for i, entry in enumerate(sh):
            o, n = int(meta.offsets[i]), meta.sizes[i]
            if meta.res_bits[i] < 16:
                codes, scales = entry
                host_dequant(codes, scales, n, meta.res_bits[i], block,
                             out=out[o: o + n])
            else:
                out[o: o + n] = bf16_bits_to_f32(entry)
        return out

    def _shadow_payload(self, cname: str) -> Dict[str, np.ndarray]:
        """Quant-profile shadow -> {'c': uint8 codes, 's': fp32 scales,
        'w': bf16 bits of the small leaves}: the buffers the card holds and
        the uplink after every host step."""
        entries = self._shadow[cname]

        def cat(xs, dt):
            return np.concatenate(xs) if xs else np.zeros(0, dt)

        return {"c": cat([e[0] for e in entries if isinstance(e, tuple)],
                         np.uint8),
                "s": np.ascontiguousarray(cat(
                    [e[1] for e in entries if isinstance(e, tuple)],
                    np.float32), np.float32),
                "w": cat([np.ascontiguousarray(e, np.uint16) for e in entries
                          if not isinstance(e, tuple)], np.uint16)}

    # ------------------------------------------------------------- #
    # init / chunk layout
    # ------------------------------------------------------------- #

    def _iter_chunks(self, host_params):
        """Yield (chunk name, leaf shapes, flat fp32) one chunk at a time.
        Given params are chunked by _chunk; a fresh init draws each group's
        tensors on demand, the reference's draws in the reference's order,
        so at most one chunk's fp32 data exists at once."""
        if host_params is not None:
            templates, chunks = self._chunk(host_params)
            for cname in chunks:
                yield cname, templates[cname], chunks[cname]
            return
        cfg = self.cfg
        D, F = cfg.d_model, cfg.ffn_dim
        G, V = self.scfg.group_layers, cfg.vocab_size
        std, out_std = 0.02, 0.02 / np.sqrt(2.0 * cfg.n_layer)
        r = self._rng

        def norm(shape, s):
            # the reference's (draw * s).astype(float32): in place where
            # numpy's promotion keeps the product in float32
            out = r.standard_normal(shape, np.float32)
            if np.result_type(out, s) == np.float32:
                return np.multiply(out, s, out=out)
            return (out * s).astype(np.float32)

        for g in range(self.n_groups):
            # the structure of models/gpt.py param_shapes' layer stack,
            # sliced to this group (dict order fixes the draw order)
            lay = {
                "ln1_scale": np.ones((G, D), np.float32),
                "ln1_bias": np.zeros((G, D), np.float32),
                "ln2_scale": np.ones((G, D), np.float32),
                "ln2_bias": np.zeros((G, D), np.float32),
                "attn": {
                    "wqkv": norm((G, D, cfg.qkv_dim), std),
                    "bqkv": np.zeros((G, cfg.qkv_dim), np.float32),
                    "wo": norm((G, D, D), out_std),
                    "bo": np.zeros((G, D), np.float32),
                },
                "mlp": {
                    "wi": norm((G, D, F), std),
                    "bi": np.zeros((G, F), np.float32),
                    "wo": norm((G, F, D), out_std),
                    "bo": np.zeros((G, D), np.float32),
                },
            }
            yield (f"g{g}",) + _emit_chunk(lay)
        gl = {"embed": {"wte": norm((V, D), std)},
              "final_ln": {"scale": np.ones((D,), np.float32),
                           "bias": np.zeros((D,), np.float32)}}
        if not cfg.rotary:
            gl["embed"]["wpe"] = norm((cfg.max_seq, D), std)
        if not cfg.tie_embeddings:
            gl["lm_head"] = norm((D, V), std)
        yield ("globals",) + _emit_chunk(gl)

    def _chunk(self, params: dict):
        """Split a params tree (the port's layout: numpy arrays or tensors)
        into per-group flat fp32 chunks and one 'globals' chunk (the
        embeddings, the final layer norm and an untied head). Returns
        (leaf shapes, {chunk name: flat fp32})."""
        G = self.scfg.group_layers
        lay = params["layers"]
        templates: Dict[str, Any] = {}
        chunks: Dict[str, np.ndarray] = {}
        for g in range(self.n_groups):
            sl = tree_map(lambda a: _host_array(a[g * G:(g + 1) * G]), lay)
            templates[f"g{g}"] = _shapes(sl)
            chunks[f"g{g}"] = _concat(
                [leaf.reshape(-1) for leaf in tree_leaves(sl)])
        gl = {k: v for k, v in params.items() if k != "layers"}
        templates["globals"] = _shapes(gl)
        chunks["globals"] = _concat(
            [_host_array(leaf).reshape(-1) for leaf in tree_leaves(gl)])
        return templates, chunks

    # ------------------------------------------------------------- #
    # device storage
    # ------------------------------------------------------------- #

    def _device_storage(self, cname: str):
        """Host shadow -> the value held on the card: one flat bf16 buffer
        (bf16 residency), or {'c', 's', 'w'} buffers (codes, scales and
        the bf16 small leaves) under quantized residency, sliced and
        dequantized per leaf while the group computes."""
        if not self._meta[cname].quant_resident:
            return _to_device(self._shadow[cname], self.device).view(
                torch.bfloat16)
        return {k: _to_device(v, self.device)
                for k, v in self._shadow_payload(cname).items()}

    def _storage_to_tree(self, storage, cname: str):
        """Card storage -> the bf16 params tree (views of the flat buffer,
        or per-leaf dequantized transients under quantized residency)."""
        meta = self._meta[cname]
        shapes = tree_leaves(self._leaf_templates[cname])
        out = []
        if not meta.quant_resident:
            for i, shape in enumerate(shapes):
                o = int(meta.offsets[i])
                out.append(storage[o: o + meta.sizes[i]].view(shape))
            return tree_unflatten(self._leaf_templates[cname], out)
        block = self.scfg.wire_block
        rpb, rpoff, rsc, rsoff, wl, woff = meta.res_geometry(block)
        w = storage["w"].view(torch.bfloat16)
        for i, shape in enumerate(shapes):
            if meta.res_bits[i] < 16:
                pk = storage["c"][int(rpoff[i]): int(rpoff[i]) + rpb[i]]
                sl = storage["s"][int(rsoff[i]): int(rsoff[i]) + rsc[i]]
                out.append(_dev_dequant(pk, sl, meta.sizes[i],
                                        meta.res_bits[i], block)
                           .view(shape).to(torch.bfloat16))
            else:
                out.append(w[int(woff[i]): int(woff[i]) + wl[i]].view(shape))
        return tree_unflatten(self._leaf_templates[cname], out)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _upload_initial(self):
        t0 = time.perf_counter()
        self._dev_groups = [self._device_storage(f"g{g}")
                            for g in range(self.n_groups)]
        self._dev_globals = self._device_storage("globals")
        self._sync()
        self.timings["initial_upload_s"] = time.perf_counter() - t0

    def resident_bytes(self) -> int:
        """Bytes of the params held on the card."""
        def nbytes(st):
            if isinstance(st, dict):
                return sum(t.numel() * t.element_size() for t in st.values())
            return st.numel() * st.element_size()

        return (sum(nbytes(st) for st in self._dev_groups)
                + nbytes(self._dev_globals))

    def host_state_bytes(self) -> Dict[str, int]:
        """Bytes of host state: {'ram': master, moments and shadows in
        RAM, 'nvme': the state files of the NVMe tier}."""
        ram = 0
        for c in self.chunk_names:
            ram += sum(a.nbytes for a in self._ram.get(c, {}).values())
            sh = self._shadow[c]
            ram += (sh.nbytes if isinstance(sh, np.ndarray) else sum(
                sum(x.nbytes for x in e) if isinstance(e, tuple) else e.nbytes
                for e in sh))
        nvme = (sum(self.swapper.leaf_bytes(c) for c in self.chunk_names)
                if self.swapper is not None else 0)
        return {"ram": int(ram), "nvme": int(nvme)}

    # ------------------------------------------------------------- #
    # the stages on the card
    # ------------------------------------------------------------- #

    def _attend(self, q, k, v):
        k, v = gpt_mod.expand_kv_heads(q, k, v)
        return gpt_mod.causal_attention(q, k, v, self.cfg.attn_impl), None

    def _group_fwd(self, tree, x, positions):
        for lp in gpt_mod.layer_slices({"layers": tree},
                                       self.scfg.group_layers):
            x, _ = gpt_mod.decoder_block(self.cfg, x, lp, positions,
                                         self._attend)
        return x

    def _generator(self, step: int, group: int) -> torch.Generator:
        """The stochastic-rounding draws of one (step, group): a device
        generator seeded from (seed, step, group)."""
        seed = np.random.SeedSequence(
            [self.scfg.seed, step, group]).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _quant_tree(self, grads: list, gen, meta: _ChunkMeta):
        """Quantize every leaf's grad for the wire, in leaf order; the
        quantized profiles concatenate the leaves into one wire buffer and
        one scales buffer."""
        block = self.scfg.wire_block
        packed, scales = [], []
        for i, g in enumerate(grads):
            p, s = _dev_quant(g.reshape(-1), meta.bits[i], block, gen)
            packed.append(p)
            scales.append(s)
        if meta.concat:
            return torch.cat(packed), torch.cat(scales)
        return packed, scales

    def _embed(self, tokens):
        gl = self._storage_to_tree(self._dev_globals, "globals")
        x = torch.nn.functional.embedding(
            tokens, gl["embed"]["wte"].to(self.cfg.dtype))
        if not self.cfg.rotary:
            x = x + gl["embed"]["wpe"][: tokens.shape[1]].to(self.cfg.dtype)
        return x

    def _globals_tree(self):
        """The globals' params for the head: the card's bf16 leaves, the
        final layer norm in fp32 (its grads come out fp32; the (V, D)
        tables keep bf16 grads)."""
        gl = self._storage_to_tree(self._dev_globals, "globals")
        gl = tree_map(lambda t: t.detach(), gl)
        gl["final_ln"] = tree_map(lambda t: t.float(), gl["final_ln"])
        return gl

    def _head_loss(self, gl, x, targets):
        """The final layer norm and the cross-entropy head (chunked over
        the sequence as make_gpt's loss, each chunk's logits recomputed in
        the backward)."""
        cfg = self.cfg
        h = gpt_mod.layer_norm(x, gl["final_ln"]["scale"],
                               gl["final_ln"]["bias"], cfg.layernorm_eps)
        w = gpt_mod.head_weight(cfg, gl)
        B, S, _ = h.shape
        chunk = gpt_mod.pick_ce_chunk(S, cfg.ce_chunk)
        if chunk:
            loss = h.new_zeros((), dtype=torch.float32)
            for c0 in range(0, S, chunk):
                loss = loss + torch.utils.checkpoint.checkpoint(
                    gpt_mod._chunk_nll, h[:, c0:c0 + chunk],
                    targets[:, c0:c0 + chunk], w, use_reentrant=False)
            return loss / (B * S)
        logits = (h @ w).float()
        tgt = logits.gather(-1, targets[..., None])[..., 0]
        return (torch.logsumexp(logits, dim=-1) - tgt).mean()

    def _head_bwd(self, x, targets):
        """The head's loss and grads: (loss, globals grads as a tree, dx)."""
        gl = self._globals_tree()
        leaves = [t.requires_grad_(True) for t in tree_leaves(gl)]
        gl = tree_unflatten(gl, leaves)
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = self._head_loss(gl, x, targets)
            grads = torch.autograd.grad(loss, leaves + [x],
                                        allow_unused=True)
        d_leaves = [torch.zeros_like(t) if g is None else g
                    for t, g in zip(leaves, grads[:-1])]
        return loss.detach(), tree_unflatten(gl, d_leaves), grads[-1]

    def _group_bwd(self, g: int, x_in, dx, gen):
        """Re-run group ``g`` under autograd from its input and push ``dx``
        back: (dx of the input, wire grads, wire scales)."""
        tree = self._storage_to_tree(self._dev_groups[g], f"g{g}")
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tree)]
        tree = tree_unflatten(tree, leaves)
        x_in = x_in.detach().requires_grad_(True)
        positions = torch.arange(x_in.shape[1], device=self.device)
        with torch.enable_grad():
            out = self._group_fwd(tree, x_in, positions)
            grads = torch.autograd.grad(out, leaves + [x_in], dx)
        del out, tree, leaves
        packed, scales = self._quant_tree(list(grads[:-1]), gen,
                                          self._meta[f"g{g}"])
        return grads[-1], packed, scales

    def _embed_bwd(self, dx0, d_gl, tokens, gen):
        """Merge the token-embedding grad into the head's globals grads and
        quantize them as the 'globals' chunk. The (V, D) table grad stays
        bf16; each token's contributions are summed in fp32 first (sorted
        by id, run sums from one cumsum: deterministic, no atomics), so
        each row takes one bf16 add of its full-precision sum."""
        B, S, D = dx0.shape
        d_wte = d_gl["embed"]["wte"]
        ids = tokens.reshape(-1)
        ids_s, perm = torch.sort(ids, stable=True)
        csum = torch.cumsum(dx0.reshape(-1, D).float()[perm], dim=0)
        last = torch.ones_like(ids_s, dtype=torch.bool)
        last[:-1] = ids_s[1:] != ids_s[:-1]
        ends = torch.nonzero(last).reshape(-1)
        prev = torch.zeros_like(csum[: ends.numel()])
        prev[1:] = csum[ends[:-1]]
        run_sum = csum[ends] - prev
        d_wte.index_put_((ids_s[ends],), run_sum.to(d_wte.dtype),
                         accumulate=True)
        if not self.cfg.rotary:
            d_wpe = d_gl["embed"]["wpe"]
            d_wpe[:S] += dx0.float().sum(dim=0).to(d_wpe.dtype)
        return self._quant_tree(tree_leaves(d_gl), gen,
                                self._meta["globals"])

    def _apply_delta(self, storage, cname, packed, scales):
        """bf16 residency: add the uplinked delta to each leaf, in fp32,
        rounding once to bf16 (the add the host replays on its shadow)."""
        meta = self._meta[cname]
        block = self.scfg.wire_block
        if meta.concat:
            pb, poff, sc, soff = meta.wire_geometry(block)
        for i, n in enumerate(meta.sizes):
            if meta.concat:
                pk = packed[int(poff[i]): int(poff[i + 1])]
                sl = scales[int(soff[i]): int(soff[i + 1])]
            else:
                pk, sl = packed[i], scales[i]
            delta = _dev_dequant(pk, sl, n, meta.bits[i], block)
            o = int(meta.offsets[i])
            leaf = storage[o: o + n]
            leaf.copy_((leaf.float() + delta).to(torch.bfloat16))

    # ------------------------------------------------------------- #
    # wire transfers
    # ------------------------------------------------------------- #

    def _fetch(self, x, key):
        """Card wire -> host numpy. On CUDA through pinned host buffers
        kept per (key, shape, dtype) and reused every step; the host pass
        consumes a buffer before the next fetch of its key."""
        if isinstance(x, (list, tuple)):
            return [self._fetch(t, (key, i)) for i, t in enumerate(x)]
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        if self.device.type == "cpu":
            out = x.numpy().copy()
        else:
            k = (key, tuple(x.shape), x.dtype)
            buf = self._pinned.get(k)
            if buf is None:
                buf = self._pinned[k] = torch.empty(
                    x.shape, dtype=x.dtype, pin_memory=True)
            buf.copy_(x)
            out = buf.numpy()
        return out.view(np.uint16) if out.dtype == np.int16 else out

    def _upload(self, up):
        if isinstance(up, dict):
            return {k: _to_device(v, self.device) for k, v in up.items()}
        if isinstance(up, list):
            return [_to_device(v, self.device) for v in up]
        return _to_device(up, self.device)

    # ------------------------------------------------------------- #
    # host optimizer step for one chunk
    # ------------------------------------------------------------- #

    def _lr(self) -> float:
        w = self.scfg.warmup_steps
        if w and self.step_count <= w:
            return self.scfg.lr * self.step_count / w
        return self.scfg.lr

    def _native_pass(self, meta: _ChunkMeta, pk, sk, states, shadow, outs,
                     mode: int):
        """``ds_stream_chunk_step2``'s pass over a chunk, cut into pieces
        of whole wire blocks (``ds_stream_blocks_step2``, about
        ``PIECES_PER_THREAD`` a thread) on ``host_threads`` threads
        (ctypes drops the GIL for each call). Every block is computed
        alone, so the bytes are those of one call over the whole chunk,
        as the reference makes it. The uplink codes are zeroed first; a
        leaf with a 4-bit uplink packs element e and e + half into one
        byte, so its lower-half blocks run in one round, its upper-half
        blocks in the next and the block that straddles the half (an odd
        block count) in a third: within a round no two pieces share a
        byte. ``outs`` pairs each output buffer with its per-leaf offsets
        from the chunk's geometry: (delta codes, scales) in mode 0,
        (codes, scales, bf16 words) in mode 1."""
        block = self.scfg.wire_block
        _, poff, _, soff = meta.wire_geometry(block)
        lr = self._lr()
        outs[0][0].fill(0)
        nbs = [-(-n // block) for n in meta.sizes]
        size = max(1, sum(nbs) // max(1, PIECES_PER_THREAD
                                      * self.host_threads))
        rounds = [[], [], []]
        for i, nb in enumerate(nbs):
            up = meta.bits[i] if mode == 0 else meta.res_bits[i]
            if up != 4:
                spans = [(0, 0, nb)]
            else:
                half = nb * block // 2
                lo, hi = half // block, -(-half // block)
                spans = [(0, 0, lo), (1, hi, nb), (2, lo, hi)]
            for r, b0, b1 in spans:
                rounds[r] += [(i, b, min(b + size, b1))
                              for b in range(b0, b1, size)]

        def piece(work):
            i, b0, b1 = work

            def cut(a, off):
                return a[int(off[i]): int(off[i + 1])]

            o, n = int(meta.offsets[i]), meta.sizes[i]
            elems = [None if a is None else a[o: o + n] for a in (
                states["master"], states["exp_avg"], states["exp_avg_sq"],
                shadow)]
            out = [cut(a, off) for a, off in outs]
            if mode == 0:
                out.append(None)
            if not self.opt.step_stream_blocks2(
                    self.step_count, cut(pk, poff), cut(sk, soff), *elems,
                    *out, n, meta.bits[i], meta.res_bits[i], block, mode,
                    b0, b1, lr=lr):
                raise RuntimeError(
                    f"the native host pass refused leaf {i} (wire "
                    f"{meta.bits[i]} bits, resident {meta.res_bits[i]})")

        for works in rounds:
            _host_map(piece, works, self.host_threads)

    def _host_chunk_step(self, cname: str, packed, scales):
        """Dequantize the wire grads, Adam the flat master, then quantize
        the uplink: the error-fed delta against the bf16 shadow, or the new
        resident codes. ``packed``/``scales`` are one concatenated buffer
        each (quantized wires) or per-leaf lists (bf16 and fp32 wires);
        the uplink comes back in the same form, or as the {'c', 's', 'w'}
        storage of a quant-resident chunk (then with None scales). The
        quantized wires take one fused native pass unless use_native_host
        is off or grads are being captured: ``ds_stream_chunk_step2`` for
        every profile. The reference sends the fp32-state, bf16-resident
        profile through ``ds_stream_chunk_step`` (v1), whose shadow replay
        g++ contracts into one FMA (shadow + q * s rounded once), while the
        card adds the delta after rounding q * s, as v2 and the numpy pass
        replay it: with v1 the shadow would drift from the card's bytes."""
        scfg = self.scfg
        meta = self._meta[cname]
        block = scfg.wire_block

        def run(states):
            native = (scfg.use_native_host and not self.capture_grads
                      and self.opt.has_native)
            if meta.concat:
                pb, poff, sc, soff = meta.wire_geometry(block)
                pk = np.ascontiguousarray(packed.view(np.uint8))
                sk = np.ascontiguousarray(scales, dtype=np.float32)
                if native and meta.quant_resident:
                    rpb, rpoff, rsc, rsoff, wl, woff = \
                        meta.res_geometry(block)
                    out_c = np.empty(int(rpoff[-1]), np.uint8)
                    out_s = np.empty(int(rsoff[-1]), np.float32)
                    out_w = np.empty(int(woff[-1]), np.uint16)
                    self._native_pass(meta, pk, sk, states, None,
                                      ((out_c, rpoff), (out_s, rsoff),
                                       (out_w, woff)), mode=1)
                    entries = []
                    for i in range(len(meta.sizes)):
                        if meta.res_bits[i] < 16:
                            entries.append(
                                (out_c[int(rpoff[i]): int(rpoff[i + 1])],
                                 out_s[int(rsoff[i]): int(rsoff[i + 1])]))
                        else:
                            entries.append(
                                out_w[int(woff[i]): int(woff[i + 1])])
                    self._shadow[cname] = entries
                    self.host_routes[cname] = "native_v2"
                    return {"c": out_c, "s": out_s, "w": out_w}, None
                elif native:  # delta uplink, fp32 or bf16-bits state
                    out_p = np.empty(int(poff[-1]), np.uint8)
                    out_s = np.empty(int(soff[-1]), np.float32)
                    self._native_pass(meta, pk, sk, states,
                                      self._shadow[cname],
                                      ((out_p, poff), (out_s, soff)), mode=0)
                    self.host_routes[cname] = "native_v2"
                    return out_p, out_s
                leaf_packed = [pk[poff[i]: poff[i + 1]]
                               for i in range(len(meta.sizes))]
                leaf_scales = [sk[soff[i]: soff[i + 1]]
                               for i in range(len(meta.sizes))]
            else:
                leaf_packed, leaf_scales = packed, scales
            self.host_routes[cname] = "numpy"
            g = np.empty(meta.total, np.float32)
            for i in range(len(meta.sizes)):
                o, n = int(meta.offsets[i]), meta.sizes[i]
                host_dequant(leaf_packed[i], leaf_scales[i], n,
                             meta.bits[i], block, out=g[o: o + n])
            if self.capture_grads:
                self.last_grads[cname] = g.copy()
            master = self._st_load(states["master"])
            m = self._st_load(states["exp_avg"])
            v = self._st_load(states["exp_avg_sq"])
            lr = self._lr()
            # in pieces of whole 64K-element chunks, the library's own
            # OpenMP split: the same elements take its vector loop
            par_run(lambda a, b: self.opt.step_flat(
                self.step_count, master[a:b], g[a:b], m[a:b], v[a:b],
                lr=lr), meta.total, align=1 << 16)
            self._st_writeback(states["master"], master)
            self._st_writeback(states["exp_avg"], m)
            self._st_writeback(states["exp_avg_sq"], v)
            del g, m, v
            if meta.quant_resident:
                # the uplink is the new resident representation
                # quant(master); the card stores these bytes verbatim
                self._shadow[cname] = self._quant_shadow_from_f32(meta,
                                                                  master)
                return self._shadow_payload(cname), None
            shadow_f32 = self._shadow_f32(cname)
            delta = np.empty_like(master)
            par_run(lambda a, b: np.subtract(master[a:b], shadow_f32[a:b],
                                             out=delta[a:b]), meta.total)
            ups, ups_s = [], []
            for i in range(len(meta.sizes)):
                o, n = int(meta.offsets[i]), meta.sizes[i]
                p, s = host_quant(delta[o: o + n], meta.bits[i], block)
                ups.append(p)
                ups_s.append(s)
                # replay the card's add exactly: shadow += dequant(delta)
                host_dequant(p, s, n, meta.bits[i], block,
                             out=delta[o: o + n])
            par_run(lambda a, b: np.add(shadow_f32[a:b], delta[a:b],
                                        out=shadow_f32[a:b]), meta.total)
            self._shadow[cname] = f32_to_bf16_bits(shadow_f32)
            if meta.concat:
                return (np.concatenate([u.view(np.uint8) for u in ups]),
                        np.concatenate(ups_s))
            return ups, ups_s

        if self.swapper is None:
            return run(self._ram[cname])
        result: List[Any] = []
        if self.scfg.swap_states == "exp_avg_sq":
            # master and m from RAM, v from the swapper (whose write-back
            # persists the updated v)
            def body(name, sw_states):
                merged = dict(self._ram[cname])
                merged.update(sw_states)
                result.append(run(merged))

            self.swapper.for_each_leaf([cname], body)
        else:
            self.swapper.for_each_leaf(
                [cname], lambda name, states: result.append(run(states)))
        return result[0]

    def _step_chunk(self, cname, packed, scales, storage):
        """Fetch one chunk's wire grads, run its host pass and upload the
        result: the new storage for the chunk."""
        t = self.timings
        t0 = time.perf_counter()
        kind = "globals" if cname == "globals" else "group"
        p_host = self._fetch(packed, (kind, "p"))
        s_host = self._fetch(scales, (kind, "s"))
        t["d2h_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        up, up_s = self._host_chunk_step(cname, p_host, s_host)
        t["host_opt_s"] += time.perf_counter() - t0
        self.wire_bytes_last_step += _nbytes((p_host, s_host, up, up_s))
        t0 = time.perf_counter()
        if self._meta[cname].quant_resident:
            # the uplink buffers are the new storage: no arithmetic
            storage = self._upload(up)
        else:
            self._apply_delta(storage, cname, self._upload(up),
                              self._upload(up_s))
        self._sync()
        t["h2d_s"] += time.perf_counter() - t0
        return storage

    # ------------------------------------------------------------- #
    # the step
    # ------------------------------------------------------------- #

    def _split(self, tokens):
        """tokens (B, seq+1) -> (inputs, targets) on the card."""
        seq = self.scfg.seq
        tokens = (tokens.long() if isinstance(tokens, torch.Tensor)
                  else torch.as_tensor(np.asarray(tokens), dtype=torch.long))
        if tokens.dim() != 2 or tokens.shape[1] != seq + 1:
            raise ValueError(
                f"tokens must be (B, seq+1)=(B, {seq + 1}), got "
                f"{tuple(tokens.shape)}")
        tokens = tokens.to(self.device)
        return tokens[:, :-1], tokens[:, 1:]

    def _forward(self, inputs):
        """The streamed forward: the group boundaries, embedding output
        first, the last group's output last."""
        positions = torch.arange(inputs.shape[1], device=self.device)
        boundaries = [self._embed(inputs)]
        for g in range(self.n_groups):
            boundaries.append(self._group_fwd(
                self._storage_to_tree(self._dev_groups[g], f"g{g}"),
                boundaries[-1], positions))
        return boundaries

    @torch.no_grad()
    def eval_batch(self, tokens) -> float:
        """The loss of tokens (B, seq+1) at the card's params: the
        streamed forward and the head, no backward and no host step."""
        inputs, targets = self._split(tokens)
        x = self._forward(inputs)[-1]
        return float(self._head_loss(self._globals_tree(), x, targets))

    @torch.no_grad()
    def train_batch(self, tokens) -> float:
        """tokens: (B, seq+1) int (numpy or tensor). Returns the loss."""
        t = self.timings
        for k in ("compute_s", "d2h_s", "h2d_s", "host_opt_s"):
            t.setdefault(k, 0.0)
        inputs, targets = self._split(tokens)
        self.step_count += 1
        self.host_routes = {}
        self.wire_bytes_last_step = 0

        # ---- forward: stream the groups, keep the boundaries ---- #
        t0 = time.perf_counter()
        boundaries = self._forward(inputs)
        loss, d_gl, dx = self._head_bwd(boundaries.pop(), targets)
        loss = float(loss)
        t["compute_s"] += time.perf_counter() - t0

        # ---- backward: reverse groups; fetch, host step, upload ---- #
        for g in reversed(range(self.n_groups)):
            t0 = time.perf_counter()
            dx, packed, scales = self._group_bwd(
                g, boundaries.pop(), dx, self._generator(self.step_count, g))
            self._sync()
            t["compute_s"] += time.perf_counter() - t0
            self._dev_groups[g] = self._step_chunk(
                f"g{g}", packed, scales, self._dev_groups[g])
            del packed, scales

        # ---- globals: the embedding scatter and the head ---- #
        t0 = time.perf_counter()
        packed, scales = self._embed_bwd(
            dx, d_gl, inputs, self._generator(self.step_count,
                                              self.n_groups))
        del dx, d_gl
        self._sync()
        t["compute_s"] += time.perf_counter() - t0
        self._dev_globals = self._step_chunk("globals", packed, scales,
                                             self._dev_globals)
        return loss

    # ------------------------------------------------------------- #
    # checkpoint / resume (the reference's full format)
    # ------------------------------------------------------------- #

    def _geometry(self) -> dict:
        """Fingerprint that must match for a resume to be valid."""
        return {
            "n_params": int(self.n_params),
            "chunk_names": list(self.chunk_names),
            "chunk_sizes": {c: self._meta[c].sizes
                            for c in self.chunk_names},
            "wire_bits": self.scfg.wire_bits,
            "wire_block": self.scfg.wire_block,  # shadow codes depend on it
            "group_layers": self.scfg.group_layers,
            "resident_bits": self.scfg.resident_bits,
            "host_state": self.scfg.host_state,
        }

    def _save_shadow(self, tmp: str, cname: str):
        sh = self._shadow[cname]
        if not self._meta[cname].quant_resident:
            np.save(os.path.join(tmp, f"{cname}.shadow.npy"), sh)
            return
        arrs = {}
        for i, entry in enumerate(sh):
            if isinstance(entry, tuple):
                arrs[f"c{i}"], arrs[f"s{i}"] = entry
            else:
                arrs[f"w{i}"] = entry
        np.savez(os.path.join(tmp, f"{cname}.shadow.npz"), **arrs)

    def _load_shadow(self, ckpt: str, cname: str):
        meta = self._meta[cname]
        if not meta.quant_resident:
            return np.load(os.path.join(ckpt, f"{cname}.shadow.npy"))
        with np.load(os.path.join(ckpt, f"{cname}.shadow.npz")) as z:
            return [
                (z[f"c{i}"], z[f"s{i}"]) if f"c{i}" in z else z[f"w{i}"]
                for i in range(len(meta.sizes))]

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None):
        """Write each chunk's host state (shadow, master, moments) and the
        step and host RNG under ``save_dir/<tag>/``, then point ``latest``
        at it. One chunk is in memory at a time; the files go to a
        temporary directory renamed into place, so a killed save never
        corrupts ``latest``. After the save the previous ``latest`` is
        deleted if its tag was generated (``global_step*``) and
        ``ckpt_prune_auto_tags`` is on; named tags are always kept."""
        tag = tag or f"global_step{self.step_count}"
        final = os.path.join(save_dir, tag)
        tmp = final + f".tmp{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)

        def dump(cname, states):
            self._save_shadow(tmp, cname)
            for k in ("master", "exp_avg", "exp_avg_sq"):
                np.save(os.path.join(tmp, f"{cname}.{k}.npy"), states[k])

        for c in self.chunk_names:
            if self.swapper is None:
                dump(c, self._ram[c])
                continue
            # a read-only pass: for_each_leaf would write every chunk's
            # unchanged state back out
            buf = self.swapper.swap_in(c, async_op=False)
            states = dict(self._ram.get(c, {}))
            states.update(self.swapper.unpack(c, buf))
            dump(c, states)
            del buf, states
        meta = {
            "step_count": self.step_count,
            "rng_state": self._rng.bit_generator.state,
            "geometry": self._geometry(),
            "format": "full",
        }
        with open(os.path.join(tmp, "stream_meta.json"), "w") as f:
            json.dump(meta, f)
        prev_latest = None
        latest_path = os.path.join(save_dir, "latest")
        if os.path.isfile(latest_path):
            with open(latest_path) as f:
                prev_latest = f.read().strip()
        old = None
        if os.path.isdir(final):
            # the live tag moves aside first: a kill between the two steps
            # must not leave 'latest' pointing at nothing
            old = final + f".old{os.getpid()}"
            os.replace(final, old)
        os.replace(tmp, final)
        with open(latest_path + ".tmp", "w") as f:
            f.write(tag)
        os.replace(latest_path + ".tmp", latest_path)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        if (self.scfg.ckpt_prune_auto_tags and prev_latest
                and prev_latest != tag
                and prev_latest.startswith("global_step")):
            stale = os.path.join(save_dir, prev_latest)
            if os.path.isdir(stale):
                shutil.rmtree(stale, ignore_errors=True)
        log_dist(f"StreamedOffloadEngine: saved checkpoint {final}",
                 ranks=[0])
        return final

    def load_checkpoint(self, save_dir: str, tag: Optional[str] = None):
        """Restore the host state save_checkpoint wrote and upload the
        card's params from the restored shadow. The geometry (model,
        grouping, wire, residency, host state) must match this engine's.
        Returns the checkpoint directory, or None when ``save_dir`` has no
        ``latest``."""
        if tag is None:
            latest = os.path.join(save_dir, "latest")
            if not os.path.isfile(latest):
                log_dist(f"no 'latest' in {save_dir}; starting fresh",
                         ranks=[0])
                return None
            with open(latest) as f:
                tag = f.read().strip()
        ckpt = os.path.join(save_dir, tag)
        with open(os.path.join(ckpt, "stream_meta.json")) as f:
            meta = json.load(f)
        mine = self._geometry()
        theirs = meta["geometry"]
        if theirs != mine:
            raise ValueError(
                f"checkpoint geometry mismatch: saved {theirs}, engine "
                f"built with {mine}")
        if meta.get("format", "full") != "full":
            raise _unported("loading a compact checkpoint",
                            "Compact streamed checkpoints")
        for c in self.chunk_names:
            self._shadow[c] = self._load_shadow(ckpt, c)
            self._register_states(c, {
                k: np.load(os.path.join(ckpt, f"{c}.{k}.npy"))
                for k in ("master", "exp_avg", "exp_avg_sq")})
        self.step_count = int(meta["step_count"])
        self._rng.bit_generator.state = meta["rng_state"]
        self._dev_groups = []
        self._dev_globals = None
        self._upload_initial()
        log_dist(f"StreamedOffloadEngine: resumed {ckpt} at step "
                 f"{self.step_count}", ranks=[0])
        return ckpt

    # ------------------------------------------------------------- #

    def wire_bytes_per_step(self) -> int:
        """Bytes on the host<->card wire a step (both directions, payload
        and scales): the grads down at the wire bits; up, the delta for
        bf16-resident chunks or the resident codes for quant-resident
        ones."""
        block = self.scfg.wire_block
        total = 0
        for cname in self.chunk_names:
            meta = self._meta[cname]
            if meta.concat:
                pb, _, sc, _ = meta.wire_geometry(block)
                total += sum(pb) + 4 * sum(sc)
            else:
                total += sum((b // 8) * n
                             for n, b in zip(meta.sizes, meta.bits))
            if meta.quant_resident:
                rpb, _, rsc, _, wl, _ = meta.res_geometry(block)
                total += sum(rpb) + 4 * sum(rsc) + 2 * sum(wl)
            elif meta.concat:
                pb, _, sc, _ = meta.wire_geometry(block)
                total += sum(pb) + 4 * sum(sc)
            else:
                total += sum((b // 8) * n
                             for n, b in zip(meta.sizes, meta.bits))
        return int(total)

    def master_params_f32(self) -> Dict[str, np.ndarray]:
        """Host fp32 masters by chunk."""
        def as_f32(arr):
            return (bf16_bits_to_f32(arr) if arr.dtype == np.uint16
                    else arr.copy())

        if self.swapper is None or self.scfg.swap_states == "exp_avg_sq":
            return {c: as_f32(self._ram[c]["master"])
                    for c in self.chunk_names}
        out = {}
        for c in self.chunk_names:
            buf = self.swapper.swap_in(c, async_op=False)
            out[c] = as_f32(self.swapper.unpack(c, buf)["master"])
        return out

    def storage_bytes(self, cname: str) -> Dict[str, np.ndarray]:
        """The card's storage of a chunk as host bytes: {'w': bf16 bits}
        under bf16 residency, else {'c', 's', 'w'} (the shadow's form)."""
        st = (self._dev_globals if cname == "globals"
              else self._dev_groups[int(cname[1:])])
        if not isinstance(st, dict):
            st = {"w": st}
        out = {}
        for k, t in st.items():
            if t.dtype in (torch.bfloat16, torch.int16):
                out[k] = t.view(torch.int16).cpu().numpy().view(np.uint16)
            else:
                out[k] = t.cpu().numpy()
        return out

    def shadow_matches_device(self) -> Dict[str, bool]:
        """Per chunk: whether the host shadow holds the card's bytes."""
        res = {}
        for c in self.chunk_names:
            dev = self.storage_bytes(c)
            host = (self._shadow_payload(c) if self._meta[c].quant_resident
                    else {"w": self._shadow[c]})
            res[c] = all(np.array_equal(dev[k], host[k]) for k in host)
        return res

    def _fetch_device_tree(self, storage, cname):
        """Card storage -> host numpy fp32 params tree (codes dequantized
        by the host codec)."""
        meta = self._meta[cname]
        shapes = tree_leaves(self._leaf_templates[cname])
        out = []
        if not meta.quant_resident:
            flat = bf16_bits_to_f32(
                storage.view(torch.int16).cpu().numpy().view(np.uint16))
            for i, shape in enumerate(shapes):
                o = int(meta.offsets[i])
                out.append(flat[o: o + meta.sizes[i]].reshape(shape))
            return tree_unflatten(self._leaf_templates[cname], out)
        block = self.scfg.wire_block
        rpb, rpoff, rsc, rsoff, wl, woff = meta.res_geometry(block)
        payload = storage["c"].cpu().numpy()
        scal = storage["s"].cpu().numpy()
        wbuf = bf16_bits_to_f32(
            storage["w"].view(torch.int16).cpu().numpy().view(np.uint16))
        for i, shape in enumerate(shapes):
            if meta.res_bits[i] < 16:
                pk = payload[int(rpoff[i]): int(rpoff[i]) + rpb[i]]
                sl = scal[int(rsoff[i]): int(rsoff[i]) + rsc[i]]
                out.append(host_dequant(pk, sl, meta.sizes[i],
                                        meta.res_bits[i], block)
                           .reshape(shape))
            else:
                out.append(wbuf[int(woff[i]): int(woff[i]) + wl[i]]
                           .reshape(shape))
        return tree_unflatten(self._leaf_templates[cname], out)

    def device_params_tree(self):
        """The full (stacked-layer) params tree, host fp32, from the card's
        copies."""
        lay = [self._fetch_device_tree(st, f"g{g}")
               for g, st in enumerate(self._dev_groups)]
        layers = tree_unflatten(lay[0], [
            np.concatenate(xs, axis=0)
            for xs in zip(*(tree_leaves(t) for t in lay))])
        out = dict(self._fetch_device_tree(self._dev_globals, "globals"))
        out["layers"] = layers
        return out


# --------------------------------------------------------------------- #
# config routing: initialize(model=GPTConfig, config) -> streamed engine
# --------------------------------------------------------------------- #


def stream_config_from_ds_config(ds_config, model_cfg) -> StreamConfig:
    """A StreamConfig from a parsed TrainingConfig and a model config.

    The base comes from the standard keys (micro batch, optimizer params,
    scheduler warmup, the optimizer offload device and path); any
    StreamConfig field can be set in the config's "streaming" block
    ("enabled" only routes). Config semantics the engine does not run
    raise rather than train differently than declared."""
    gas = int(getattr(ds_config, "gradient_accumulation_steps", 1) or 1)
    if gas > 1:
        raise ValueError(
            f"the streaming engine optimizer-steps every micro batch; "
            f"gradient_accumulation_steps={gas} is not supported — set "
            f"the triple to micro x world (gas=1)")
    clip = getattr(ds_config, "gradient_clipping", 0.0)
    if clip:
        raise ValueError(
            f"gradient_clipping={clip} is not supported by the streaming "
            f"engine (the host pass applies raw Adam); remove it from the "
            f"config")
    if ds_config.scheduler_name not in (None, "WarmupLR"):
        raise ValueError(
            f"streaming supports only WarmupLR (linear warmup to the "
            f"optimizer lr), got scheduler {ds_config.scheduler_name!r}")
    if ds_config.optimizer_name not in (None, "Adam", "AdamW"):
        raise ValueError(
            f"the streaming engine's host pass is Adam; optimizer type "
            f"{ds_config.optimizer_name!r} would silently train with "
            f"different update math — use Adam/AdamW (1-bit optimizers "
            f"ride the SPMD wire path, runtime/comm/onebit_spmd.py)")

    kw: Dict[str, Any] = {}
    kw["micro_batch"] = int(ds_config.train_micro_batch_size_per_gpu or 1)
    kw["seq"] = int(getattr(model_cfg, "max_seq", 0)
                    or getattr(model_cfg, "max_position", 0) or 2048)
    opt_p = ds_config.optimizer_params or {}
    if "lr" in opt_p:
        kw["lr"] = float(opt_p["lr"])
    if "betas" in opt_p:
        kw["betas"] = tuple(opt_p["betas"])
    if "eps" in opt_p:
        kw["eps"] = float(opt_p["eps"])
    if "weight_decay" in opt_p:
        kw["weight_decay"] = float(opt_p["weight_decay"])
    sch_p = ds_config.scheduler_params or {}
    if "warmup_num_steps" in sch_p:
        kw["warmup_steps"] = int(sch_p["warmup_num_steps"])
    # WarmupLR: the engine warms 0 -> lr linearly; a declared
    # warmup_max_lr is the peak lr
    if float(sch_p.get("warmup_min_lr", 0.0) or 0.0) != 0.0:
        raise ValueError(
            "streaming's warmup ramps from 0; nonzero warmup_min_lr is "
            "not supported")
    if "warmup_max_lr" in sch_p:
        wmax = float(sch_p["warmup_max_lr"])
        if "lr" in kw and abs(wmax - kw["lr"]) > 1e-12:
            raise ValueError(
                f"warmup_max_lr={wmax} conflicts with optimizer "
                f"lr={kw['lr']}; set them equal (the engine warms to one "
                f"peak lr)")
        kw["lr"] = wmax
    off_opt = ds_config.zero_config.offload_optimizer
    if off_opt.enabled and off_opt.device == "nvme":
        kw["state_device"] = "nvme"
        if off_opt.nvme_path:
            kw["swap_folder"] = off_opt.nvme_path
        kw["pipeline_swap"] = bool(off_opt.pipeline_read
                                   or off_opt.pipeline_write)
    overrides = dict(ds_config.streaming_params or {})
    overrides.pop("enabled", None)
    valid = {f.name for f in dataclasses.fields(StreamConfig)}
    unknown = set(overrides) - valid
    if unknown:
        raise ValueError(
            f"unknown streaming config keys: {sorted(unknown)}; valid: "
            f"{sorted(valid)}")
    kw.update(overrides)
    if "betas" in kw:
        kw["betas"] = tuple(kw["betas"])
    return StreamConfig(**kw)


def build_streamed_engine(model_cfg, ds_config, host_params=None,
                          device=None, mesh=None) -> StreamedOffloadEngine:
    """The engine ``initialize`` builds when the config enables streaming
    (a "streaming" block, or ZeRO stage 3 with offload_param on cpu or
    nvme). ``device`` defaults to CUDA; the config's "aio" block sets the
    NVMe tier's queues."""
    if mesh is not None:
        raise _unported("the streamed engine over a data-parallel mesh",
                        "Streaming over a data-parallel mesh")
    scfg = stream_config_from_ds_config(ds_config, model_cfg)
    return StreamedOffloadEngine(model_cfg, scfg, host_params=host_params,
                                 device=device,
                                 aio_config=getattr(ds_config, "aio_config",
                                                    None))
