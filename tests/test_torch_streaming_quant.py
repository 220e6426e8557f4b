"""The quantized profiles, held inside the port (the reference's
stochastic rounding draws from jax's PRNG, which torch cannot reproduce):
after every step the host shadow holds the card's bytes exactly, with
bf16 params on the card and with int4/int8 codes; the master stays within
a quantization step of the shadow; the loss descends; int4 tracks the
fp32 wire's trajectory; the 20B budget profile (bf16 host state,
exp_avg_sq on the NVMe tier, int4 residency) trains. Every run takes the
native host pass (csrc/host/ds_cpu_adam.cpp) unless it says otherwise."""

import numpy as np
import pytest

from torch_streaming_common import (batch, params_np, port_engine, scfg,
                                    streaming, tiny_cfg)


@pytest.fixture(autouse=True)
def _quantize_every_leaf(monkeypatch):
    # the tiny model's leaves are all below MIN_QUANT_SIZE
    monkeypatch.setattr(streaming, "MIN_QUANT_SIZE", 0)


def _shadow_equals_device(eng):
    got = eng.shadow_matches_device()
    assert all(got.values()), got
    # and the card's params, read back through the host codec, are the
    # shadow's fp32 image
    dev = eng.device_params_tree()
    _, chunks = eng._chunk(dev)
    for c in eng.chunk_names:
        np.testing.assert_array_equal(chunks[c], eng._shadow_f32(c))


@pytest.mark.parametrize("wire,res,state", [
    (4, 16, "fp32"), (8, 16, "fp32"), (4, 16, "bf16"), (16, 16, "fp32"),
    (8, 4, "fp32"), (4, 8, "bf16"), (4, 4, "bf16")])
def test_shadow_tracks_device_after_every_step(wire, res, state):
    eng = port_engine(tiny_cfg("bf16"), scfg(
        wire_bits=wire, resident_bits=res, host_state=state,
        warmup_steps=0, lr=1e-3), params_np(dtype="bf16"))
    for tok in batch(n=3):
        eng.train_batch(tok)
        _shadow_equals_device(eng)
    routes = set(eng.host_routes.values())
    assert routes == ({"numpy"} if wire >= 16 else {"native_v2"})


def test_shadow_tracks_device_numpy_pass():
    eng = port_engine(tiny_cfg("bf16"), scfg(
        wire_bits=4, resident_bits=4, warmup_steps=0, lr=1e-3,
        use_native_host=False), params_np(dtype="bf16"))
    for tok in batch(n=2):
        eng.train_batch(tok)
        _shadow_equals_device(eng)
    assert set(eng.host_routes.values()) == {"numpy"}


def test_quant_resident_mixed_leaf_paths(monkeypatch):
    """A MIN_QUANT_SIZE between the leaf sizes puts coded leaves and bf16
    small leaves in one chunk (the separate 'w' buffer)."""
    monkeypatch.setattr(streaming, "MIN_QUANT_SIZE", 1000)
    eng = port_engine(tiny_cfg("bf16"), scfg(
        wire_bits=8, warmup_steps=0, lr=1e-2, resident_bits=4),
        params_np(dtype="bf16"))
    meta = eng._meta["g0"]
    assert any(b < 16 for b in meta.res_bits)
    assert any(b == 16 for b in meta.res_bits)
    data = batch(seed=11, n=4)
    losses = [eng.train_batch(data[i]) for i in range(4)]
    assert losses[-1] < losses[0], losses
    _shadow_equals_device(eng)


def test_master_converges_to_shadow_residual_bounded():
    """Error feedback: the master-shadow residual stays within one
    quantization step (it is re-sent every step, never accumulated)."""
    eng = port_engine(tiny_cfg("bf16"), scfg(
        wire_bits=4, warmup_steps=0, lr=1e-3), params_np(dtype="bf16"))
    for tok in batch(n=5):
        eng.train_batch(tok)
    masters = eng.master_params_f32()
    for c in eng.chunk_names:
        resid = masters[c] - streaming.bf16_bits_to_f32(eng._shadow[c])
        assert np.abs(resid).max() < 0.02, c


@pytest.mark.parametrize("bits", [32, 4, 8])
def test_loss_descends(bits):
    eng = port_engine(tiny_cfg("bf16" if bits < 32 else "fp32"), scfg(
        wire_bits=bits, warmup_steps=3, lr=3e-3),
        params_np(dtype="bf16" if bits < 32 else "fp32"))
    losses = [eng.train_batch(t) for t in batch(n=25)]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.2, (first, last)


def test_quant_resident_loss_descends():
    eng = port_engine(tiny_cfg("bf16"), scfg(
        group_layers=1, wire_bits=4, warmup_steps=0, lr=2e-2,
        resident_bits=4), params_np(dtype="bf16"))
    tok = batch(seed=7)[0]
    losses = [eng.train_batch(tok) for _ in range(12)]
    assert losses[-1] < losses[0] - 0.3, losses


def test_int4_tracks_fp32_trajectory():
    toks = batch(n=15)
    finals = {}
    for bits in (32, 4):
        eng = port_engine(tiny_cfg(), scfg(wire_bits=bits, warmup_steps=3,
                                           lr=3e-3), params_np())
        losses = [eng.train_batch(t) for t in toks]
        finals[bits] = np.mean(losses[-3:])
    assert abs(finals[4] - finals[32]) < 0.3, finals


@pytest.mark.parametrize("pipelined", [True, False])
def test_bf16_host_state_and_v_swap_descends(tmp_path, pipelined):
    """The 20B budget profile: bf16 master and m in RAM, v on the NVMe
    tier, int4 residency."""
    eng = port_engine(tiny_cfg("bf16"), scfg(
        group_layers=1, wire_bits=4, warmup_steps=0, lr=2e-2,
        resident_bits=4, host_state="bf16", state_device="nvme",
        swap_states="exp_avg_sq", swap_folder=str(tmp_path),
        pipeline_swap=pipelined), params_np(dtype="bf16"))
    data = batch(seed=9, n=4)
    losses = [eng.train_batch(data[i]) for i in range(4)]
    assert losses[-1] < losses[0], losses
    assert set(eng.host_routes.values()) == {"native_v2"}
    _shadow_equals_device(eng)
    sizes = eng.host_state_bytes()
    assert sizes["nvme"] >= 2 * eng.n_params   # v as bf16 bits on disk
    assert all(set(eng._ram[c]) == {"master", "exp_avg"}
               for c in eng.chunk_names)
    assert len(list(tmp_path.glob("*.swp"))) == len(eng.chunk_names)


def test_nvme_state_tier_all_states(tmp_path):
    eng = port_engine(tiny_cfg(), scfg(
        wire_bits=32, warmup_steps=0, lr=1e-3, state_device="nvme",
        swap_folder=str(tmp_path)), params_np())
    losses = [eng.train_batch(t) for t in batch(seed=1, n=2)]
    assert np.isfinite(losses).all()
    assert set(eng.master_params_f32()) == set(eng.chunk_names)
    assert eng._ram == {}


def _whole_chunk_pass(eng):
    """The engine's native pass as one library call over each whole chunk
    (``ds_stream_chunk_step2``): the bytes the block pieces must give."""
    def native_pass(meta, pk, sk, states, shadow, outs, mode):
        out = [a for a, _ in outs]
        out = out + [None] * 3 if mode == 0 else [None, None] + out
        assert eng.opt.step_stream_chunk2(
            eng.step_count, pk, sk, states["master"], states["exp_avg"],
            states["exp_avg_sq"], shadow, *out, meta.sizes, meta.bits,
            meta.res_bits, eng.scfg.wire_block, mode=mode, lr=eng._lr())

    eng._native_pass = native_pass


@pytest.mark.parametrize("res,state", [(16, "fp32"), (4, "bf16"),
                                       (8, "fp32")])
def test_host_threads_give_the_same_bytes(res, state, monkeypatch):
    """The native host pass in pieces of whole wire blocks on 4 threads,
    a leaf split over several pieces (the pieces made small here), gives
    the bytes of one library call over each whole chunk on one thread,
    the halves of a 4-bit uplink and the block that straddles them
    included; the host codecs and conversions run in pieces too (their
    threshold lowered here)."""
    import torch

    from deeperspeed_tpu_torch.runtime.offload import streaming

    monkeypatch.setattr(streaming, "PIECES_PER_THREAD", 16)
    monkeypatch.setattr(streaming, "PAR_MIN", 256)
    engines, pieces = [], []
    for threads in (1, 4):
        prev = torch.get_num_threads()
        torch.set_num_threads(threads)
        try:
            eng = port_engine(tiny_cfg("bf16"), scfg(
                wire_bits=4, resident_bits=res, host_state=state,
                warmup_steps=0, lr=1e-3))
        finally:
            torch.set_num_threads(prev)
        assert eng.host_threads == threads
        if threads == 1:
            _whole_chunk_pass(eng)
        else:
            call = eng.opt.step_stream_blocks2

            def logged(*a, **kw):
                pieces.append((a[10], a[13], a[15], a[16]))  # n, block, b0, b1
                return call(*a, **kw)

            eng.opt.step_stream_blocks2 = logged
        eng.losses = [eng.train_batch(t) for t in batch(seed=5, n=2)]
        engines.append(eng)
    one, four = engines
    # leaves cut into several pieces, and blocks that straddle a 4-bit
    # uplink's half (a leaf of an odd block count)
    by_leaf = {}
    for n, _, b0, b1 in pieces:
        by_leaf.setdefault(n, set()).add((b0, b1))
    assert max(len(v) for v in by_leaf.values()) > 2
    if res != 8:  # a 4-bit uplink (the delta wire, or 4-bit residency)
        assert any(b1 - b0 == 1 and b0 == -(-n // blk) // 2
                   and -(-n // blk) % 2 for n, blk, b0, b1 in pieces)
    assert one.losses == four.losses
    for c in one.chunk_names:
        a, b = one.storage_bytes(c), four.storage_bytes(c)
        assert all(np.array_equal(a[k], b[k]) for k in a)
        for k in ("master", "exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(one._ram[c][k], four._ram[c][k])


@pytest.mark.parametrize("wire,res,state", [(32, 16, "fp32"),
                                            (4, 16, "bf16"), (8, 8, "fp32")])
def test_numpy_route_threads_give_the_same_bytes(wire, res, state,
                                                 monkeypatch):
    """The numpy host pass (taken while grads are captured) in pieces on 4
    threads (the library's Adam over 64K-element chunks, the codecs over
    whole blocks, the conversions over elements; the threshold lowered
    here) gives one thread's bytes."""
    import torch

    from deeperspeed_tpu_torch.runtime.offload import streaming

    monkeypatch.setattr(streaming, "PAR_MIN", 256)
    engines = []
    for threads in (1, 4):
        prev = torch.get_num_threads()
        torch.set_num_threads(threads)
        try:
            eng = port_engine(tiny_cfg("bf16"), scfg(
                wire_bits=wire, resident_bits=res, host_state=state,
                warmup_steps=0, lr=1e-3))
            eng.capture_grads = True
            eng.losses = [eng.train_batch(t) for t in batch(seed=5, n=2)]
        finally:
            torch.set_num_threads(prev)
        assert set(eng.host_routes.values()) == {"numpy"}
        engines.append(eng)
    one, four = engines
    assert one.losses == four.losses
    for c in one.chunk_names:
        a, b = one.storage_bytes(c), four.storage_bytes(c)
        assert all(np.array_equal(a[k], b[k]) for k in a)
        np.testing.assert_array_equal(one.last_grads[c], four.last_grads[c])
        for k in ("master", "exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(one._ram[c][k], four._ram[c][k])
