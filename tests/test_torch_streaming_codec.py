"""The streamed engine's codecs and host init against the reference.

The port's host codecs (int4/int8 block absmax, bf16 and fp32 wires, the
log2 codec, the bf16 bit helpers) must give the reference's bytes on the
same seeded inputs; the port's device codec (torch) must decode with the
host decoder and round without bias; a fresh init must build the
reference's host chunks bit for bit; the wire geometry and the bytes a
step moves must be the reference's."""

import numpy as np
import pytest
import torch

from deeperspeed_tpu.runtime.offload import streaming as jst
from torch_streaming_common import (B, S, batch, jax_cfg, jax_engine,
                                    port_engine, scfg, streaming, tiny_cfg)


def _inputs(seed, n=1000, scale=0.1):
    r = np.random.default_rng(seed)
    x = r.standard_normal(n).astype(np.float32) * scale
    x[::97] = 0.0                         # exact zeros
    x[5] = 3.0 * scale                    # one outlier per block-ish
    return x


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
@pytest.mark.parametrize("block", [64, 128])
def test_host_codec_bytes_match_reference(bits, block):
    x = _inputs(bits + block)
    p, s = streaming.host_quant(x, bits, block)
    rp, rs = jst.host_quant(x, bits, block)
    assert p.dtype == rp.dtype and s.dtype == rs.dtype
    np.testing.assert_array_equal(p, rp)
    np.testing.assert_array_equal(s, rs)
    y = streaming.host_dequant(p, s, x.size, bits, block)
    np.testing.assert_array_equal(y, jst.host_dequant(rp, rs, x.size, bits,
                                                      block))
    if bits == 32:
        np.testing.assert_array_equal(x, y)
    elif bits < 16:
        # absmax block scaling: the error is at most half a step
        qm = (1 << (bits - 1)) - 1
        nb = -(-x.size // block)
        bound = np.repeat(np.abs(np.pad(x, (0, nb * block - x.size))
                                 .reshape(nb, block)).max(1), block
                          )[: x.size] / qm / 2 + 1e-9
        assert np.all(np.abs(x - y) <= bound)


@pytest.mark.parametrize("bits", [4, 8])
def test_log_codec_bytes_match_reference(bits):
    r = np.random.default_rng(bits)
    v = np.abs(r.standard_normal(1000)).astype(np.float32) ** 4 * 1e-6
    v[::7] = 0.0
    q, s = streaming.host_quant_log(v, bits, 64)
    rq, rs = jst.host_quant_log(v, bits, 64)
    np.testing.assert_array_equal(q, rq)
    np.testing.assert_array_equal(s, rs)
    y = streaming.host_dequant_log(q, s, v.size, bits, 64)
    np.testing.assert_array_equal(y, jst.host_dequant_log(rq, rs, v.size,
                                                          bits, 64))
    assert np.all(y[v == 0] == 0.0) and np.all(y[v > 0] > 0)


def test_bf16_bit_helpers_match_reference_and_torch():
    r = np.random.default_rng(2)
    x = r.standard_normal(4096).astype(np.float32)
    x[:4] = [0.0, -0.0, np.inf, 1e-40]
    ours = streaming.f32_to_bf16_bits(x)
    np.testing.assert_array_equal(ours, jst.f32_to_bf16_bits(x))
    ref = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(ours, ref.view(np.uint16))
    np.testing.assert_array_equal(streaming.bf16_bits_to_f32(ours),
                                  jst.bf16_bits_to_f32(ours))


@pytest.mark.parametrize("bits", [4, 8, 16, 32])
def test_device_codec_matches_host_layout(bits):
    """The card's quantized wire decodes with the host decoder, and a
    host-packed wire decodes on the card as on the host."""
    r = np.random.default_rng(1)
    x = r.standard_normal(1000).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    p, s = streaming._dev_quant(torch.from_numpy(x), bits, 64, gen)
    p_np = p.view(torch.int16).numpy().view(np.uint16) if bits == 16 \
        else p.numpy()
    y = streaming.host_dequant(p_np, s.numpy(), x.size, bits, 64)
    if bits >= 16:
        tol = 0 if bits == 32 else np.abs(x).max() * 2 ** -7
        assert np.max(np.abs(x - y)) <= tol
    else:
        # stochastic rounding: within one quantization step
        scale = np.repeat(s.numpy(), 64)[: x.size]
        assert np.all(np.abs(x - y) <= scale + 1e-9)
        assert p.dtype == torch.uint8
        assert p.numel() == (-(-x.size // 64) * 64) // (2 if bits == 4
                                                          else 1)
    hp, hs = streaming.host_quant(x, bits, 64)
    yd = streaming._dev_dequant(streaming._to_device(hp, torch.device("cpu")),
                                torch.from_numpy(hs), x.size, bits, 64)
    np.testing.assert_array_equal(yd.numpy(),
                                  streaming.host_dequant(hp, hs, x.size,
                                                         bits, 64))


def test_device_codec_segments_keep_the_wire_format(monkeypatch):
    """Quantizing in segments of blocks gives the wire a single pass
    would: the same codes for the same draws (deterministic inputs on the
    grid), whatever the segment size."""
    x = torch.from_numpy(
        (np.arange(2000, dtype=np.float32) % 15 - 7) / 7.0)
    outs = []
    for seg in (3, 1000):
        monkeypatch.setattr(streaming, "QUANT_SEGMENT_BLOCKS", seg)
        outs.append(streaming._dev_quant(
            x, 4, 64, torch.Generator().manual_seed(0)))
    np.testing.assert_array_equal(outs[0][0].numpy(), outs[1][0].numpy())
    np.testing.assert_array_equal(outs[0][1].numpy(), outs[1][1].numpy())


def test_stochastic_rounding_unbiased():
    x = torch.full((256,), 0.3)  # between int4 grid points
    outs = []
    for i in range(200):
        p, s = streaming._dev_quant(x, 4, 64,
                                    torch.Generator().manual_seed(i))
        outs.append(streaming.host_dequant(p.numpy(), s.numpy(), 256, 4, 64))
    assert abs(np.stack(outs).mean() - 0.3) < 0.005


@pytest.mark.parametrize("kw", [dict(), dict(rotary=False,
                                             tie_embeddings=False,
                                             parallel_residual=False)])
def test_fresh_init_matches_reference_bit_for_bit(kw):
    """No host params: both packages draw each chunk from
    np.random.default_rng(seed) in the same order."""
    sc = scfg(wire_bits=4, seed=3)
    ours = port_engine(tiny_cfg("bf16", **kw), sc)
    ref = jax_engine(jax_cfg("bf16", **kw), sc)
    assert ours.chunk_names == ref.chunk_names == ["g0", "g1", "globals"]
    assert ours.n_params == ref.n_params
    om, rm = ours.master_params_f32(), ref.master_params_f32()
    for c in ref.chunk_names:
        np.testing.assert_array_equal(om[c], rm[c], err_msg=c)
        np.testing.assert_array_equal(ours._shadow[c], ref._shadow[c])
        assert ours._meta[c].sizes == ref._meta[c].sizes
    assert ours._geometry() == ref._geometry()


@pytest.mark.parametrize("wire,res", [(4, 16), (8, 4), (16, 16), (32, 16)])
def test_wire_geometry_matches_reference(wire, res, monkeypatch):
    monkeypatch.setattr(streaming, "MIN_QUANT_SIZE", 1000)
    monkeypatch.setattr(jst, "MIN_QUANT_SIZE", 1000)
    sc = scfg(wire_bits=wire, resident_bits=res, seed=1)
    ours = port_engine(tiny_cfg("bf16"), sc)
    ref = jax_engine(jax_cfg("bf16"), sc)
    for c in ref.chunk_names:
        a, b = ours._meta[c], ref._meta[c]
        assert (a.bits, a.res_bits, a.concat) == (b.bits, b.res_bits,
                                                  b.concat)
        for x, y in zip(a.wire_geometry(128), b.wire_geometry(128)):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(a.res_geometry(128), b.res_geometry(128)):
            np.testing.assert_array_equal(x, y)
    assert ours.wire_bytes_per_step() == ref.wire_bytes_per_step()
    # a step moves exactly the bytes the accounting says
    ours.train_batch(batch(seed=wire)[0])
    assert ours.wire_bytes_last_step == ours.wire_bytes_per_step()


def test_wire_bytes_accounting():
    sc = scfg(wire_bits=4)
    eng = port_engine(tiny_cfg(), sc)
    total = 0
    for cname in eng.chunk_names:
        meta = eng._meta[cname]
        for n, bits in zip(meta.sizes, meta.bits):
            # every leaf of the tiny model is small: int8 on the wire
            assert bits == 8
            nb = -(-n // sc.wire_block)
            total += nb * sc.wire_block + 4 * nb
    assert eng.wire_bytes_per_step() == 2 * total
    assert B == 2 and S == 16


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("n", [5 * 8192 * 64 + 17, 3 * 8192 * 64])
def test_host_quant_of_many_segments_matches_reference(bits, n):
    """Leaves of several device-codec segments (8192 blocks each), whole
    and ragged: the host codec's bytes are the reference's, and decode
    back to them."""
    x = _inputs(n, n=n)
    want = jst.host_quant(x, bits, 64)
    got = streaming.host_quant(x, bits, 64)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(
        streaming.host_dequant(*got, n, bits, 64),
        jst.host_dequant(*want, n, bits, 64))
