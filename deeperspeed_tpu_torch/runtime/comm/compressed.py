"""The compressed wire formats: the fork's 24-bit all-reduce and 1-bit signs.

Counterpart of deeperspeed_tpu/runtime/comm/compressed.py, whole, as
functions on tensors and a ``torch.distributed`` group (a ``Transport``,
runtime/comm/collectives.py, or a group it wraps; None is one rank):

* ``decompose``/``reconstruct``: the reference fork's frexp pieces, an
  fp16 mantissa in [0.5, 1) and an int8 exponent (24 bits an element).
* ``compress``/``decompress``: the block-exponent format. Each block of
  ``block`` fp32 values is normalized by the frexp exponent e of its max
  |x| (an int8, clipped to [-126, 127]) and its mantissas stored as fp16,
  16 + 8/block bits an element. Rebuilding multiplies each mantissa by
  2^e, which is exact.
* ``compressed_all_reduce`` (``_tree`` for a tree of grads): every rank
  compresses its contribution, all-gathers the (mantissa, exponent)
  pair and rebuilds the sum of the quantized contributions locally, in
  rank order, so every rank holds the same bits; correct at any world
  size, unlike the fork's sum-of-exponents demo.
* ``_pack_signs``/``_unpack_signs`` and ``onebit_compress``/
  ``onebit_all_reduce``: the 1-bit format, sign bits packed into uint8 in
  the reference's chunk-split layout (bit b of byte i carries element
  b * nb + i) plus one fp32 scale, mean(|corrected|), with error
  feedback. Zero packs as + (a bit cannot carry 0), as the 1-bit
  optimizers quantize it.
"""

from typing import Optional, Tuple

import torch

from .collectives import Transport

BLOCK = 128

__all__ = ["BLOCK", "decompose", "reconstruct", "compress", "decompress",
           "compressed_all_reduce", "compressed_all_reduce_tree",
           "onebit_compress", "onebit_all_reduce"]


def _transport(group) -> Transport:
    return group if isinstance(group, Transport) else Transport(group)


# --------------------------------------------------------------------------
# the fork's frexp/ldexp pieces
# --------------------------------------------------------------------------


def decompose(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (fp16 mantissa in [0.5, 1), int8 exponent)."""
    m, e = torch.frexp(t.float())
    return m.to(torch.float16), e.to(torch.int8)


def reconstruct(mantissa: torch.Tensor, exponent: torch.Tensor,
                original_dtype=torch.float32) -> torch.Tensor:
    return torch.ldexp(mantissa.float(),
                       exponent.to(torch.int32)).to(original_dtype)


# --------------------------------------------------------------------------
# block-exponent compression (the correct-sum wire format)
# --------------------------------------------------------------------------


def _compress_blocks(x32: torch.Tensor, block: int):
    """(n,) fp32 -> ((nb, block) fp16 mantissas, (nb,) int8 exponents)."""
    n = x32.shape[0]
    nb = (n + block - 1) // block
    xb = torch.nn.functional.pad(x32, (0, nb * block - n)).reshape(nb, block)
    _, e = torch.frexp(torch.amax(xb.abs(), dim=1))
    e = e.clamp(-126, 127).to(torch.int8)
    m = torch.ldexp(xb, -e[:, None].to(torch.int32)).to(torch.float16)
    return m, e


def _decompress_blocks(m: torch.Tensor, e: torch.Tensor, n: int):
    xb = torch.ldexp(m.float(), e[:, None].to(torch.int32))
    return xb.reshape(-1)[:n]


def compress(x: torch.Tensor, block: int = BLOCK):
    """Flatten + block-compress any-shape fp tensor. Returns (m, e, meta)."""
    flat = x.reshape(-1).float()
    m, e = _compress_blocks(flat, block)
    return m, e, (tuple(x.shape), flat.shape[0])


def decompress(m, e, meta, dtype=torch.float32) -> torch.Tensor:
    shape, n = meta
    return _decompress_blocks(m, e, n).reshape(shape).to(dtype)


def compressed_all_reduce(x: torch.Tensor, group=None, block: int = BLOCK,
                          average: bool = False) -> torch.Tensor:
    """SUM (or mean) all-reduce over ``group`` shipping 24 bits an element.

    Each rank compresses its contribution, all-gathers the (fp16
    mantissa, int8 exponent) pair and rebuilds the exact sum of the
    quantized contributions, in rank order: the same bits on every rank,
    correct at any world size."""
    tr = _transport(group)
    m, e, meta = compress(x, block)
    ms = tr.all_gather(m)          # (W, nb, block) fp16
    es = tr.all_gather(e)          # (W, nb) int8
    total = _decompress_blocks(ms[0], es[0], meta[1])
    for w in range(1, ms.shape[0]):
        total = total + _decompress_blocks(ms[w], es[w], meta[1])
    if average:
        total = total / ms.shape[0]
    return total.reshape(meta[0]).to(x.dtype)


def compressed_all_reduce_tree(tree, group=None, block: int = BLOCK,
                               average: bool = False):
    """The compressed all-reduce of every leaf of a (nested dict) tree."""
    if isinstance(tree, dict):
        return {k: compressed_all_reduce_tree(v, group, block, average)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(compressed_all_reduce_tree(v, group, block,
                                                     average)
                          for v in tree)
    return compressed_all_reduce(tree, group, block, average)


# --------------------------------------------------------------------------
# the 1-bit wire format
# --------------------------------------------------------------------------

_BIT_WEIGHTS = [1 << b for b in range(8)]


def _bit_weights(device) -> torch.Tensor:
    return torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8,
                        device=device)[:, None]


def _pack_signs(x32: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(n,) fp32 -> ((ceil(n/8),) uint8 sign bits, n).

    Chunk-split bit layout, the reference's: bit b of byte i carries
    element b * nb + i. The pad elements (zeros) pack as +."""
    n = x32.shape[0]
    nb = (n + 7) // 8
    bits = (torch.nn.functional.pad(x32, (0, nb * 8 - n)) >= 0).to(
        torch.uint8)
    rows = bits.reshape(8, nb)
    return torch.sum(rows * _bit_weights(x32.device), dim=0,
                     dtype=torch.uint8), n


def _unpack_signs(packed: torch.Tensor, n: int) -> torch.Tensor:
    """uint8 bit rows -> (n,) +-1.0 fp32 (chunk-split layout, see
    ``_pack_signs``)."""
    bits = (packed[None, :] & _bit_weights(packed.device)) > 0  # (8, nb)
    one = torch.ones((), dtype=torch.float32, device=packed.device)
    return torch.where(bits.reshape(-1)[:n], one, -one)


def _l1_scale(x32: torch.Tensor) -> torch.Tensor:
    """mean(|x|) of an fp32 tensor: the fp32 L1 norm over the element
    count (no |x| temporary the size of x)."""
    return torch.linalg.vector_norm(x32, 1, dtype=torch.float32) / max(
        x32.numel(), 1)


def onebit_compress(x: torch.Tensor, error: torch.Tensor):
    """Error-compensated 1-bit quantization of a flat fp32 tensor.

    Returns (packed uint8 signs, the fp32 scale, the new error feedback).
    scale = mean(|corrected|) keeps the expected magnitude (the
    reference's OnebitAdam server scale)."""
    corrected = x.float() + error
    scale = _l1_scale(corrected)
    packed, _ = _pack_signs(corrected)
    # the pack's `>= 0` predicate: bit-identical to unpacking
    quantized = torch.where(corrected >= 0, scale, -scale)
    return packed, scale, corrected - quantized


def onebit_all_reduce(x: torch.Tensor, group=None,
                      error: Optional[torch.Tensor] = None):
    """The mean of ``x`` over ``group`` shipping ~1 bit an element plus one
    scale. Each rank quantizes its contribution with error feedback,
    all-gathers (packed signs, scale) and rebuilds the mean of the
    quantized contributions. Returns (mean, new_error); thread the error
    back in next step."""
    tr = _transport(group)
    shape = x.shape
    flat = x.reshape(-1).float()
    if error is None:
        error = torch.zeros_like(flat)
    packed, scale, new_error = onebit_compress(flat, error.reshape(-1))
    all_packed = tr.all_gather(packed)            # (W, nb) uint8
    all_scales = tr.all_gather(scale.reshape(1))  # (W, 1)
    n = flat.shape[0]
    vals = torch.stack([_unpack_signs(all_packed[w], n) * all_scales[w, 0]
                        for w in range(all_packed.shape[0])])
    avg = torch.mean(vals, dim=0)
    return avg.reshape(shape).to(x.dtype), new_error.reshape(shape)
