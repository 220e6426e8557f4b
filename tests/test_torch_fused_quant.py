"""The port's int8 wire-format functions (ops/fused_quant.py) against the
reference's (deeperspeed_tpu/ops/pallas/fused_quant.py).

On the CPU the port's wrappers take their plain versions. The reference
has two routes here: its XLA route, which its own tests hold bit for bit
to its unfused chain, and its Pallas kernels in interpret mode. Against
the XLA route the port is bit-identical: quantized values, scales,
residuals, the R-row sums (XLA adds the rows in ascending order, as the
plain version's loop does) and the rebuild. The interpret route lowers
the scale division as a multiply by the reciprocal and may contract the
residual and the row sums, so the reference's own tests give it a bound:
scales within an ulp and values within one quantum (its
``_assert_quant_close``); the port is held to it with the same bound, and
to one ulp (relative 2**-23 of the largest magnitude) on the sums.

Inputs come from numpy with a seed: R in {1, 2, 4, 8}, blocks 32 and 128,
fp32 and bf16 input, fp16 mantissas with 2**e scales, all-zero blocks
and a non-finite block."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu.ops import kernel_config as jax_kc
from deeperspeed_tpu.ops.pallas import fused_quant as jfq
from deeperspeed_tpu.runtime.comm import reducer as jax_reducer
from deeperspeed_tpu_torch.ops import fused_quant as tfq
from deeperspeed_tpu_torch.ops import kernel_config as kc

torch.set_num_threads(1)

ROWS = (1, 2, 4, 8)
BLOCKS = (32, 128)


def _rows(seed, r, c, block, zero_block=True):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((r, c)) *
         rng.uniform(1e-3, 10.0, size=(r, 1))).astype(np.float32)
    if zero_block:
        x[r - 1, block:2 * block] = 0.0
    return x


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("R", ROWS)
def test_plain_matches_xla_route_bit_for_bit(R, block):
    x = _rows(R * block, R, 6 * block, block)
    for want_res in (True, False):
        q, s, r = jfq.quantize_rows(jnp.asarray(x), block,
                                    want_residual=want_res, choice="xla")
        tq, ts, tr = tfq.quantize_rows(torch.from_numpy(x), block,
                                       want_residual=want_res)
        _eq(q, tq)
        _eq(s, ts)
        if want_res:
            _eq(r, tr)
        else:
            assert r is None and tr is None
    # the R-row sum and the rebuild, on the quantized rows
    _eq(jfq.dequant_sum_rows(q, s, block, choice="xla"),
        tfq.dequant_sum_rows(tq, ts, block))
    _eq(jfq.dequant_rows(q, s, block, divisor=R, choice="xla"),
        tfq.dequant_rows(tq, ts, block, R))
    # the all-zero block: scale 1, q 0
    assert float(ts[R - 1, 1]) == 1.0
    assert int(tq[R - 1, block:2 * block].abs().max()) == 0


@pytest.mark.parametrize("block", BLOCKS)
def test_bf16_input_matches_xla_route(block):
    x = _rows(7, 2, 4 * block, block)
    xb = jnp.asarray(x, dtype=jnp.bfloat16)
    tb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(xb, np.float32),
                                  tb.float().numpy())
    q, s, r = jfq.quantize_rows(xb, block, choice="xla")
    tq, ts, tr = tfq.quantize_rows(tb, block)
    _eq(q, tq)
    _eq(s, ts)
    _eq(r, tr)


@pytest.mark.parametrize("R", ROWS)
def test_fp16_mantissas_sum_matches_xla_route(R):
    """The compressed wire's rebuild: fp16 mantissas times 2**e scales."""
    block = 128
    rng = np.random.default_rng(R)
    m = rng.uniform(-1, 1, size=(R, 3 * block)).astype(np.float16)
    e = rng.integers(-20, 20, size=(R, 3)).astype(np.int8)
    s = np.exp2(e.astype(np.float32))
    got = tfq.dequant_sum_rows(torch.from_numpy(m), torch.from_numpy(s),
                               block)
    _eq(jfq.dequant_sum_rows(jnp.asarray(m), jnp.asarray(s), block,
                             choice="xla"), got)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("R", (2, 8))
def test_plain_within_reference_bound_of_interpret_kernels(R, block):
    x = _rows(11 * R, R, 4 * block, block)
    q, s, r = jfq.quantize_rows(jnp.asarray(x), block, want_residual=True,
                                choice="pallas", interpret=True)
    tq, ts, tr = tfq.quantize_rows(torch.from_numpy(x), block)
    np.testing.assert_allclose(np.asarray(s), ts.numpy(), rtol=2e-7)
    dq = np.abs(np.asarray(q).astype(np.int32) - tq.numpy().astype(np.int32))
    assert dq.max() <= 1 and (dq > 0).mean() < 0.01
    ulp = 2.0 ** -23
    for got, want in (
            (tfq.dequant_sum_rows(tq, ts, block),
             jfq.dequant_sum_rows(jnp.asarray(tq.numpy()),
                                  jnp.asarray(ts.numpy()), block,
                                  choice="pallas", interpret=True)),
            (tfq.dequant_rows(tq, ts, block, R),
             jfq.dequant_rows(jnp.asarray(tq.numpy()),
                              jnp.asarray(ts.numpy()), block, divisor=R,
                              choice="pallas", interpret=True))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=ulp * np.abs(want).max())


def test_non_finite_block():
    """A block holding a NaN gets scale 1 on both sides (max|x| is NaN and
    NaN > 0 is false): q is 0 where x is NaN, the residual NaN there, and
    the other values of the block are rint(x). A block holding an inf gets
    scale inf, q 0 and NaN residuals. Both routes agree on all of it."""
    block = 128
    x = _rows(3, 2, 2 * block, block, zero_block=False)
    x[0, 5] = np.nan
    x[1, block + 7] = np.inf
    q, s, r = jfq.quantize_rows(jnp.asarray(x), block, choice="xla")
    tq, ts, tr = tfq.quantize_rows(torch.from_numpy(x), block)
    _eq(q, tq)
    _eq(s, ts)
    np.testing.assert_array_equal(np.asarray(r), tr.numpy())  # NaN == NaN
    assert float(ts[0, 0]) == 1.0 and float(ts[1, 1]) == float("inf")
    assert int(tq[0, 5]) == 0 and bool(torch.isnan(tr[0, 5]))
    assert int(tq[1, block:].abs().max()) == 0


@pytest.mark.parametrize("n", (45, 129))
def test_flat_api_pads_and_matches_reference_chain(n):
    """The reference's flat unfused chain (quantize_int8_blocks /
    dequantize_int8_blocks, clamping to [-127, 127]) against the port's one
    quantizer on a (1, n) view of the block-padded vector (the bucket plan
    pads every bucket to whole blocks): x / s never leaves [-127, 127], so
    the two clamps agree."""
    x = _rows(n, 1, n + 3, 16, zero_block=False)[0, :n]
    xp = np.pad(x, (0, -(-n // 16) * 16 - n))
    q0, s0 = jax_reducer.quantize_int8_blocks(jnp.asarray(xp), 16)
    tq, ts, _ = tfq.quantize_rows(torch.from_numpy(xp).reshape(1, -1), 16,
                                  want_residual=False)
    _eq(q0, tq.reshape(-1, 16))
    _eq(s0, ts.reshape(-1))
    _eq(jax_reducer.dequantize_int8_blocks(q0, s0),
        tfq.dequant_rows(tq, ts, 16).reshape(-1))
    assert int(tq.abs().max()) <= 127


def test_pack_unpack_wire_roundtrip_matches_reference():
    x = _rows(4, 8, 128, 8, zero_block=False)
    q, s, _ = jfq.quantize_rows(jnp.asarray(x), 8, want_residual=False,
                                choice="xla")
    tq, ts, _ = tfq.quantize_rows(torch.from_numpy(x), 8,
                                  want_residual=False)
    w = tfq.pack_wire(tq, ts)
    assert tuple(w.shape) == (8, 128 + 4 * 16) and w.dtype == torch.int8
    _eq(jfq.pack_wire(q, s), w)
    q2, s2 = tfq.unpack_wire(w, 128, 8)
    assert torch.equal(q2, tq) and torch.equal(s2, ts)


def test_routing_follows_kernel_config():
    cpu = torch.device("cpu")
    with kc.override(mode="off"):
        assert not tfq.routing(cpu)
    with kc.override(mode="auto"):
        # no Hopper tensor: the plain versions
        assert not tfq.routing(cpu)
    with kc.override(mode="fused"):
        # the wrappers, which take their plain versions on the CPU
        assert tfq.routing(cpu)
    with kc.override(mode="fused", fused_quant=False):
        assert not tfq.routing(cpu)
    # the reference's switch reads the same block
    with jax_kc.override(mode="off"):
        assert jfq.routing() == ("off", False)


def test_wrappers_count_only_kernel_launches_and_check_shapes():
    before = (tfq.quantize_rows.launches, tfq.dequant_sum_rows.launches,
              tfq.dequant_rows.launches)
    q, s, _ = tfq.quantize_rows(torch.ones(2, 64), 32)
    tfq.dequant_sum_rows(q, s, 32)
    tfq.dequant_rows(q, s, 32, 2.0)
    assert (tfq.quantize_rows.launches, tfq.dequant_sum_rows.launches,
            tfq.dequant_rows.launches) == before
    with pytest.raises(ValueError, match="divide"):
        tfq.quantize_rows(torch.ones(2, 60), 32)
