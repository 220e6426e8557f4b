"""The 24-bit block-exponent wire format of the compressed mode.

Counterpart of ``_compress_blocks``/``_decompress_blocks`` in
deeperspeed_tpu/runtime/comm/compressed.py: each block of ``block`` fp32
values is normalized by the frexp exponent e of its max |x| (an int8,
clipped to [-126, 127]) and its mantissas stored as fp16, 16 + 8/block
bits an element. Rebuilding multiplies each mantissa by 2^e, which is
exact. The reference's single-process frexp demo, its sum-of-exponents
all-reduce and its 1-bit format are not ported.
"""

import torch

BLOCK = 128


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
