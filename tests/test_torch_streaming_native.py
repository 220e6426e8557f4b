"""The port's host libraries (csrc/host/ds_cpu_adam.cpp, ds_aio.cpp),
built here with the host compiler.

- Against the reference's library (csrc/adam/ds_cpu_adam.cpp built by the
  reference's op builder): the same bytes out of every entry point on the
  same inputs (the sources are copies, built with the same flags).
- Against the numpy pass, one step of each fused pass (v1
  ``ds_stream_chunk_step``; v2 ``ds_stream_chunk_step2`` in the profiles
  of the reference's tests/test_streaming_offload.py:322-439), with the
  reference's tolerances: the AVX Adam contracts multiply-adds into FMAs
  and orders its divisions as the reference's CPU Adam does, where numpy
  rounds each operation, so fp32 masters agree within 1e-7 and the
  rounded stores (bf16 state, shadows, codes) differ in isolated
  elements at a rounding boundary; moments agree bit for bit on a first
  step (zero moments make the FMA exact).
- The build: a failed build raises with the compiler's output, and the
  engine never falls back to numpy unless told to.
- The NVMe tier: the aio handle and the swappers round-trip state.
"""

import numpy as np
import pytest

from deeperspeed_tpu_torch.ops import adam as pt_adam
from deeperspeed_tpu_torch.ops import aio, op_builder
from deeperspeed_tpu_torch.runtime.offload import swapper
from torch_streaming_common import (batch, params_np, port_engine, scfg,
                                    streaming, tiny_cfg)

HYPER = dict(lr=2e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.0)


@pytest.fixture(scope="module")
def ref_opt(tmp_path_factory):
    from deeperspeed_tpu.ops.adam import DeepSpeedCPUAdam

    # the reference builds its library into this test's own cache, and
    # the variable is gone again before any other test runs
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DS_TPU_OP_CACHE", str(tmp_path_factory.mktemp("ref_ops")))
        opt = DeepSpeedCPUAdam(**HYPER)
    assert opt.has_native
    return opt


def _chunk_inputs(seed, sizes, wire_bits=4, block=128):
    """Wire grads of the given leaves, fp32 masters and first-step
    moments, the bf16 shadow of the masters."""
    r = np.random.default_rng(seed)
    packed, scales, masters = [], [], []
    for n in sizes:
        g = r.standard_normal(n).astype(np.float32) * 0.01
        p, s = streaming.host_quant(g, wire_bits, block)
        packed.append(p)
        scales.append(s)
        masters.append(r.standard_normal(n).astype(np.float32) * 0.02)
    master = np.concatenate(masters)
    return (np.concatenate(packed), np.concatenate(scales), master,
            np.zeros_like(master), np.zeros_like(master),
            streaming.f32_to_bf16_bits(master))


SIZES = [1000, 4096, 130, 7]


def _v1(opt, inputs, bits):
    pk, sk, master, m, v, shadow = (a.copy() for a in inputs)
    meta_bits = [bits] * len(SIZES)
    nbytes = sum((-(-n // 128) * 128) // (2 if bits == 4 else 1)
                 for n in SIZES)
    out_p = np.empty(nbytes, np.uint8)
    out_s = np.empty(sum(-(-n // 128) for n in SIZES), np.float32)
    assert opt.step_stream_chunk(1, pk, sk, master, m, v, shadow, out_p,
                                 out_s, SIZES, meta_bits, 128)
    return master, m, v, shadow, out_p, out_s


def _v2(opt, inputs, bits, mode, state_bf16, res):
    pk, sk, master, m, v, shadow = (a.copy() for a in inputs)
    if state_bf16:
        master, m, v = (streaming.f32_to_bf16_bits(a) for a in (master, m, v))
    nb = [-(-n // 128) for n in SIZES]
    out_p = np.empty(sum(b * 128 // (2 if bits == 4 else 1) for b in nb),
                     np.uint8)
    out_s = np.empty(sum(nb), np.float32)
    out_c = np.empty(sum(b * 128 // (2 if res == 4 else 1) for b in nb),
                     np.uint8)
    out_w = np.empty(sum(SIZES), np.uint16)
    assert opt.step_stream_chunk2(
        1, pk, sk, master, m, v, shadow if mode == 0 else None,
        out_p if mode == 0 else None, out_s if mode == 0 else None,
        out_c if mode == 1 else None, out_s if mode == 1 else None,
        out_w if mode == 1 else None, SIZES, [bits] * len(SIZES),
        [res] * len(SIZES), 128, mode=mode)
    return (master, m, v, shadow) + ((out_p, out_s) if mode == 0
                                     else (out_c, out_s))


@pytest.mark.parametrize("bits", [4, 8])
def test_native_library_matches_reference_library(ref_opt, bits):
    ours = pt_adam.DeepSpeedCPUAdam(**HYPER)
    inputs = _chunk_inputs(bits, SIZES, bits)
    for a, b in zip(_v1(ours, inputs, bits), _v1(ref_opt, inputs, bits)):
        np.testing.assert_array_equal(a, b)
    for mode, state_bf16, res in ((0, False, 16), (0, True, 16),
                                  (1, False, 4), (1, True, 8)):
        got = _v2(ours, inputs, bits, mode, state_bf16, res)
        want = _v2(ref_opt, inputs, bits, mode, state_bf16, res)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=(mode, state_bf16))
    # the plain Adam step, with the bf16 copy-back
    r = np.random.default_rng(0)
    p, g = (r.standard_normal(70001).astype(np.float32) for _ in range(2))
    outs = []
    for opt in (ours, ref_opt):
        pp, m, v = p.copy(), np.zeros_like(p), np.zeros_like(p)
        bf = np.empty(p.size, np.uint16)
        opt.step_flat(3, pp, g.copy(), m, v, bf16_out=bf)
        outs.append((pp, m, v, bf))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert ours.simd_width() in ("avx512", "avx2", "scalar")


def numpy_codec_engine(sc, params):
    """An engine whose host pass runs the numpy codec around the library's
    Adam (``step_flat`` -> ``ds_adam_step``), the pairing the reference's
    tests compare the fused passes with: the codec is then the only
    difference."""
    eng = port_engine(tiny_cfg("bf16"), sc, params)
    eng.opt = pt_adam.DeepSpeedCPUAdam(lr=sc.lr, betas=sc.betas, eps=sc.eps,
                                       weight_decay=sc.weight_decay)
    return eng


@pytest.mark.parametrize("bits", [4, 8])
def test_native_v1_matches_numpy_pass(bits, monkeypatch):
    """v1 through the library against the engine's numpy codec on the
    same chunk (the reference's test_native_host_codec_matches_python):
    the same moments, masters within 1e-7 (g++ contracts the update
    differently where it inlines it); the uplink codes (v1 multiplies by
    1/s where numpy divides by s) and the shadow (v1's replay is one FMA)
    differ in isolated elements."""
    monkeypatch.setattr(streaming, "MIN_QUANT_SIZE", 0)
    sc = scfg(wire_bits=bits, warmup_steps=0, lr=2e-3,
              use_native_host=False)
    eng = numpy_codec_engine(sc, params_np(dtype="bf16"))
    eng.step_count = 1
    meta = eng._meta["g0"]
    r = np.random.default_rng(bits)
    g = r.standard_normal(meta.total).astype(np.float32) * 0.01
    wires = [streaming.host_quant(g[o: o + n], bits, 128)
             for o, n in zip(meta.offsets, meta.sizes)]
    pk = np.concatenate([w[0] for w in wires])
    sk = np.concatenate([w[1] for w in wires])
    st = eng._ram["g0"]
    nat = {k: a.copy() for k, a in st.items()}
    nat_shadow = eng._shadow["g0"].copy()
    out_p = np.empty(pk.size, np.uint8)
    out_s = np.empty(sk.size, np.float32)
    opt = pt_adam.DeepSpeedCPUAdam(lr=2e-3, betas=sc.betas, eps=sc.eps)
    assert opt.step_stream_chunk(1, pk, sk, nat["master"], nat["exp_avg"],
                                 nat["exp_avg_sq"], nat_shadow, out_p, out_s,
                                 meta.sizes, meta.bits, 128, lr=2e-3)
    up_p, up_s = eng._host_chunk_step("g0", pk, sk)
    assert eng.host_routes["g0"] == "numpy"
    np.testing.assert_allclose(nat["master"], st["master"], rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(nat["exp_avg"], st["exp_avg"])
    np.testing.assert_array_equal(nat["exp_avg_sq"], st["exp_avg_sq"])
    # the reference's bound for the shadows of its v2 test: isolated
    # elements, at most one in 5000
    flips = int((nat_shadow != eng._shadow["g0"]).sum())
    assert flips <= max(2, nat_shadow.size // 5000), flips
    # the delta's block scales are absmax(master - shadow) / qmax: masters
    # 1e-7 apart move them by at most 1e-7 / qmax
    qmax = (1 << (bits - 1)) - 1
    np.testing.assert_allclose(out_s, up_s, rtol=5e-7, atol=1e-7 / qmax)
    assert int((out_p != up_p).sum()) <= max(4, out_p.size // 500)


@pytest.mark.parametrize("profile", ["fp32_state", "bf16_state",
                                     "quant_fp32", "quant_bf16"])
def test_native_v2_matches_numpy_pass(monkeypatch, profile):
    """One engine step through ds_stream_chunk_step2 against the numpy
    pass (the reference's test_native_host_codec_v2_matches_python, its
    flip bounds)."""
    monkeypatch.setattr(streaming, "MIN_QUANT_SIZE", 0)
    host_state = "fp32" if profile in ("fp32_state", "quant_fp32") \
        else "bf16"
    res_bits = 4 if profile.startswith("quant") else 16
    tok = batch()[0]
    params = params_np(dtype="bf16")
    engines = {}
    for native in (True, False):
        sc = scfg(wire_bits=4, warmup_steps=0, lr=2e-3,
                  host_state=host_state, resident_bits=res_bits,
                  use_native_host=native)
        eng = (port_engine(tiny_cfg("bf16"), sc, params) if native
               else numpy_codec_engine(sc, params))
        eng.train_batch(tok)
        engines[native] = eng
    nat, ref = engines[True], engines[False]
    assert set(nat.host_routes.values()) == {"native_v2"}
    assert set(ref.host_routes.values()) == {"numpy"}
    for c in nat.chunk_names:
        for k in ("master", "exp_avg", "exp_avg_sq"):
            a, b = nat._ram[c][k], ref._ram[c][k]
            if host_state == "bf16":
                flips = int((a != b).sum())
                assert flips <= max(2, a.size // 5000), (c, k, flips)
            elif k == "master":
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-7)
            else:
                np.testing.assert_array_equal(a, b, err_msg=(c, k))
        if res_bits == 16:
            flips = int((nat._shadow[c] != ref._shadow[c]).sum())
            assert flips <= max(2, nat._shadow[c].size // 5000), (c, flips)
            continue
        for i, (ea, eb) in enumerate(zip(nat._shadow[c], ref._shadow[c])):
            # scales: absmax over masters 1 fp32 ulp apart; codes: a moved
            # scale can shift its block's codes by one, plus isolated
            # rounding-boundary flips
            np.testing.assert_allclose(ea[1], eb[1], rtol=5e-7, atol=0)
            flips = int((ea[0] != eb[0]).sum())
            assert flips <= max(4, ea[0].size // 500), (c, i, flips)


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "c++"
    fake.write_text("#!/bin/sh\necho 'no compiler here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(op_builder, "_LIBS", {})
    monkeypatch.setattr(op_builder, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="no compiler here") as e:
        pt_adam.DeepSpeedCPUAdam(lr=1e-3)
    # $CXX is tried alone: with and without OpenMP
    assert str(e.value).count(str(fake)) == 2
    # the engine's default (use_native_host true) raises the same way
    with pytest.raises(RuntimeError, match="failed to build"):
        port_engine(tiny_cfg(), scfg(wire_bits=4))
    # only an explicit use_native_host false takes the numpy pass
    eng = port_engine(tiny_cfg(), scfg(wire_bits=4, use_native_host=False))
    assert not eng.opt.has_native
    assert not list((tmp_path / "build").glob("*.so"))


def test_host_build_is_cached_and_hashed():
    from deeperspeed_tpu_torch.ops.adam import load_cpu_adam

    load_cpu_adam()
    info = op_builder.build_info["ds_cpu_adam"]
    path = op_builder.host_library_path("ds_cpu_adam", info["compiler"],
                                        info["openmp"])
    assert info["path"] == str(path) and path.exists()
    assert path.parent == op_builder.BUILD_DIR
    cmd = op_builder.host_command("ds_cpu_adam", "g++", path)
    for flag in ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
                 "-march=native", "-fopenmp", "-lgomp"):
        assert flag in cmd
    plain = op_builder.host_command("ds_cpu_adam", "g++", path, openmp=False)
    assert "-fopenmp" not in plain and "-lgomp" not in plain
    assert "-march=native" in plain
    assert (op_builder.host_library_path("ds_cpu_adam", "g++", False)
            != op_builder.host_library_path("ds_cpu_adam", "g++", True))


def test_aio_handle_and_parallel_copy(tmp_path):
    h = aio.AsyncIOHandle(block_size=1 << 16, queue_depth=4, thread_count=2)
    assert (h.get_block_size(), h.get_queue_depth(),
            h.get_thread_count()) == (1 << 16, 4, 2)
    src = aio.aligned_empty((300000,), np.float32)
    src[:] = np.arange(src.size, dtype=np.float32)
    assert src.ctypes.data % 512 == 0
    path = str(tmp_path / "x.swp")
    assert h.sync_pwrite(src, path) == src.nbytes
    dst = aio.aligned_empty((300000,), np.float32)
    h.async_pread(dst, path)
    assert h.wait() == 1
    np.testing.assert_array_equal(dst, src)
    out = np.empty_like(src)
    aio.parallel_copy(out, src, threads=3)
    np.testing.assert_array_equal(out, src)
    with pytest.raises(IOError):
        h.sync_pread(dst, str(tmp_path / "missing.swp"))


@pytest.mark.parametrize("pipelined", [True, False])
def test_optimizer_swapper_round_trip(tmp_path, pipelined):
    cls = (swapper.PipelinedOptimizerSwapper if pipelined
           else swapper.PartitionedOptimizerSwapper)
    sw = cls(swapper.AioConfig(), str(tmp_path))
    leaves = {f"l{i}": {"m": np.full(1000 + i, i, np.float32),
                        "v": np.full(37, i, np.uint16)} for i in range(4)}
    for name, st in leaves.items():
        sw.register_leaf(name, st)
    assert sw.leaf_names() == list(leaves)

    def step(name, st):
        st["m"] += 1
        st["v"] += 2

    sw.for_each_leaf(list(leaves), step)
    for i, name in enumerate(leaves):
        got = sw.unpack(name, sw.swap_in(name))
        np.testing.assert_array_equal(got["m"], i + 1)
        np.testing.assert_array_equal(got["v"], i + 2)
    buf = swapper.SwapBuffer(4096)
    view = buf.insert("a", np.arange(10, dtype=np.float32))
    assert buf.offset == 512 and buf.has_space(3584)
    np.testing.assert_array_equal(buf.get("a"), view)
    pool = swapper.SwapBufferPool(2, 1024)
    a, b = pool.acquire(), pool.acquire()
    assert pool.acquire() is None
    pool.release(a)
    assert pool.acquire() is a and b is not a
