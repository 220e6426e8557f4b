"""The monitor inside the engines, the port against the reference: a small
GPT trained a few steps on both engines under one "monitor" block gives
the same span names, lanes and argument keys, the same
train_steps_total / train_global_samples, and a port trace that passes
both packages' strict validators; the watchdog stays silent at one shape
and fires (warn) or raises (strict) when a new sequence length arrives,
in both packages; the cost index's flops for a small GPT step equal the
analytic sum of its matmuls and attention exactly, on the plain path and
on the kernel path; the serving engine's telemetry matches the
reference's. A ``cuda`` test runs phase 6's monitor gates of
chip_smoke.py at a small size on the card.

Exact unless a test says otherwise. Weights come from the reference's
init with a fixed key (converted), batches from numpy with a seed; the
JAX side runs as its own monitor tests run it on the CPU."""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu
import deeperspeed_tpu_torch
from deeperspeed_tpu import monitor as jmon
from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.monitor import validate as jvalidate
from deeperspeed_tpu.monitor import watchdog as jwatchdog
from deeperspeed_tpu.serving import ServingEngine as JServingEngine
from deeperspeed_tpu_torch import monitor as tmon
from deeperspeed_tpu_torch.models import convert, gpt
from deeperspeed_tpu_torch.monitor import validate as tvalidate
from deeperspeed_tpu_torch.monitor import watchdog as twatchdog
from deeperspeed_tpu_torch.ops import kernel_config as kc
from deeperspeed_tpu_torch.serving import ServingEngine as TServingEngine
from deeperspeed_tpu_torch.utils import tensorboard

torch.set_num_threads(1)

KW = dict(vocab_size=97, n_layer=2, n_head=4, d_model=32, max_seq=32,
          rotary=True, parallel_residual=True)
S = 32
CONFIG = {
    "train_batch_size": 4,
    "train_micro_batch_size_per_gpu": 2,
    "gradient_accumulation_steps": 2,
    "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
}


@pytest.fixture(autouse=True)
def _clean_global_monitors():
    yield
    for pkg in (jmon, tmon):
        pkg.shutdown_monitor(save=False)
        pkg.set_tracer(None)


def _one_device_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))


def _models(**cfg_kw):
    jcfg = jax_gpt.GPTConfig(**KW, dtype=jnp.float32, attn_impl="xla",
                             remat=False, ce_chunk=0)
    jinit, _, jloss, _ = jax_gpt.make_gpt(jcfg)
    jparams = jinit(jax.random.PRNGKey(0))
    tcfg = gpt.GPTConfig(**KW, dtype=torch.float32, attn_impl="xla",
                         remat=False, ce_chunk=0, **cfg_kw)
    tparams = convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")
    return jparams, jloss, tcfg, tparams


def _batch(seq=S, seed=7):
    return np.random.RandomState(seed).randint(0, 97, (4, seq + 1)).astype(
        np.int32)


def _shape(events):
    """{name: (lanes, arg keys)} of the non-metadata events."""
    out = {}
    for e in events:
        if e["ph"] == "M":
            continue
        lanes, keys = out.setdefault(e["name"], (set(), set()))
        lanes.add(e["tid"] if isinstance(e["tid"], str) else "")
        keys.update(e.get("args") or {})
    return out


def _lane_names(tracer):
    """tid -> lane name of a tracer's logical lanes."""
    return {tid: lane for lane, tid in tracer._lanes.items()}


def _named(tracer):
    lanes = _lane_names(tracer)
    return [dict(e, tid=lanes.get(e["tid"], "")) for e in tracer.events()]


def _counters(registry):
    text = registry.render()
    return {line.split()[0]: float(line.split()[1])
            for line in text.splitlines()
            if line.startswith(("train_steps_total", "train_global_samples"))}


# ------------------------------------------------------------------ #
# training
# ------------------------------------------------------------------ #


def test_train_run_under_one_monitor_block_matches_reference(tmp_path):
    jparams, jloss, tcfg, tparams = _models()
    batch = _batch()
    block = {"watchdog": "strict", "metrics_port": 0, "perf": True}
    jeng, _, _, _ = deeperspeed_tpu.initialize(
        model=jloss, model_parameters=jparams,
        config=dict(CONFIG, monitor=dict(
            block, trace_path=str(tmp_path / "j.json"))),
        mesh=_one_device_mesh())
    for _ in range(3):
        jeng.train_batch(batch)
    jm = jmon.get_monitor()
    j_events = _named(jm.tracer)
    j_counts = _counters(jm.registry)
    jmon.shutdown_monitor(save=True)

    _, _, tloss, _ = gpt.make_gpt(tcfg)
    teng, _, _, _ = deeperspeed_tpu_torch.initialize(
        model=tloss, model_parameters=tparams,
        config=dict(CONFIG, monitor=dict(
            block, trace_path=str(tmp_path / "t.json"))), device="cpu")
    assert teng.monitor is tmon.get_monitor()
    for _ in range(3):
        teng.train_batch(batch)
    tm = teng.monitor
    t_events = _named(tm.tracer)
    with urllib.request.urlopen(tm.metrics_server.url, timeout=10) as r:
        scraped = r.read().decode()
    t_counts = _counters(tm.registry)
    assert tm.watchdog.fired == [] and jm.watchdog.fired == []
    tmon.shutdown_monitor(save=True)

    # the reference's xla_compile instants mark jit compiles, which the
    # eager port does not have (its compile instants are kernel builds).
    # Neither engine here checkpoints: resilience/* events in the
    # reference's process-global tracer come from the async checkpoint
    # writer of an earlier test in the same worker process
    # (tests/test_lifecycle.py), still pruning while this one runs
    want = {k: v for k, v in _shape(j_events).items()
            if k != "xla_compile" and not k.startswith("resilience/")}
    assert not [e for e in t_events if e["name"].startswith("resilience/")]
    assert _shape(t_events) == want
    assert [e["name"] for e in t_events if e["name"] == "engine/train_batch"
            ] == ["engine/train_batch"] * 3
    assert t_counts == j_counts == {"train_steps_total": 3.0,
                                    "train_global_samples": 12.0}
    assert "train_steps_total 3\n" in scraped
    for mod in (jvalidate, tvalidate):
        assert mod.validate_file(str(tmp_path / "t.json"), strict=True) == []


def _watch_run(package, mode, seqs):
    """Train one step per sequence length in ``seqs``; returns the steps
    after which the watchdog had fired (or the error a strict one
    raised)."""
    jparams, jloss, tcfg, tparams = _models()
    config = dict(CONFIG, monitor={"watchdog": mode, "trace_enabled": False})
    if package == "reference":
        eng, _, _, _ = deeperspeed_tpu.initialize(
            model=jloss, model_parameters=jparams, config=config,
            mesh=_one_device_mesh())
        mon = jmon.get_monitor()
    else:
        eng, _, _, _ = deeperspeed_tpu_torch.initialize(
            model=gpt.make_gpt(tcfg)[2], model_parameters=tparams,
            config=config, device="cpu")
        mon = eng.monitor
    fired_after = []
    for i, seq in enumerate(seqs):
        n = len(mon.watchdog.fired)
        try:
            eng.train_batch(_batch(seq))
        except (jwatchdog.RecompileError, twatchdog.RecompileError) as e:
            return fired_after, i, type(e).__module__.split(".")[0]
        if len(mon.watchdog.fired) > n:
            fired_after.append(i)
    return fired_after, None, None


@pytest.mark.parametrize("package", ["reference", "port"])
def test_watchdog_silent_at_one_shape_fires_on_a_new_length(package):
    # silent on steps 0-2 (one shape) and on step 4 (the new shape again)
    assert _watch_run(package, "warn", [S] * 3 + [S // 2, S // 2]) == \
        ([3], None, None)
    pkg = "deeperspeed_tpu" if package == "reference" \
        else "deeperspeed_tpu_torch"
    assert _watch_run(package, "strict", [S] * 3 + [S // 2]) == \
        ([], 3, pkg)


def _analytic_step_flops(cfg, micro, gas, seq):
    """3 x the forward's matmul flops (each forward product has two
    backward ones): 2 flops per token and matmul weight (qkv, attention
    out, the two FFN matmuls, the LM head), plus attention's two products
    over every (query, key) pair of each head."""
    D, F, V, L = cfg.d_model, cfg.ffn_dim, cfg.vocab_size, cfg.n_layer
    weights = L * (D * cfg.qkv_dim + D * D + 2 * D * F) + D * V
    tokens = micro * gas * seq
    attention = gas * L * 4 * micro * cfg.n_head * seq * seq * cfg.head_dim
    return 3 * (2 * tokens * weights + attention)


@pytest.mark.parametrize("path", ["plain", "kernels"])
def test_cost_index_flops_equal_the_analytic_sum(path):
    """On the plain path (kernels off, dense attention) the aten matmuls;
    on the kernel path (kernels fused, the flash path's wrappers, remat
    "matmuls") the wrappers' declared work; both exactly the analytic
    sum. Recomputation stays apart, in recompute_flops."""
    kw = ({"attn_impl": "xla"} if path == "plain" else
          {"attn_impl": "pallas_interpret", "remat": True,
           "remat_policy": "matmuls"})
    _, _, tcfg, tparams = _models()
    tcfg = gpt.GPTConfig(**dict(vars(tcfg), **kw))
    mode = "off" if path == "plain" else "fused"
    with kc.override():
        eng, _, _, _ = deeperspeed_tpu_torch.initialize(
            model=gpt.make_gpt(tcfg)[2], model_parameters=tparams,
            config=dict(CONFIG, kernels={"mode": mode},
                        monitor={"perf": True}), device="cpu")
        for _ in range(2):
            eng.train_batch(_batch())
    rec = eng.monitor.cost_index.get("engine/train_step")
    assert rec.error is None and rec.captures == 1
    assert rec.flops == _analytic_step_flops(tcfg, 2, 2, S)
    if path == "kernels":
        # the flash backward's recomputed scores: 2 flops per pair and
        # head dim, for 2 layers x 2 micro-batches of (2, 4 heads, S, S)
        assert rec.recompute_flops == 2 * (2 * 2) * 2 * 4 * S * S * 8
    events = eng.monitor.tracer.events()
    steps = [e for e in events if e["name"] == "engine/train_batch"]
    assert {"mfu", "tflops", "verdict", "hbm_peak"} <= set(steps[-1]["args"])
    assert [e["args"]["entry"] for e in events
            if e["name"] == "perf/compiled"] == ["engine/train_step"]


def test_imperative_path_spans_and_costs():
    _, _, tcfg, tparams = _models()
    eng, _, _, _ = deeperspeed_tpu_torch.initialize(
        model=gpt.make_gpt(tcfg)[2], model_parameters=tparams,
        config=dict(CONFIG, monitor={"perf": True}), device="cpu")
    batch = _batch()
    for i in range(2):
        loss = eng.forward(batch[2 * i:2 * i + 2])
        eng.backward(loss)
        eng.step()
    names = [e["name"] for e in eng.monitor.tracer.events()
             if e["name"].startswith("engine/")]
    assert names == ["engine/forward", "engine/backward"] * 2 + [
        "engine/step"]
    assert set(eng.monitor.cost_index.summary()) == {
        "engine/forward", "engine/backward", "engine/apply_update"}
    assert "train_steps_total 1\n" in eng.monitor.registry.render()


def test_tensorboard_block_gets_the_scalars_and_the_export(tmp_path,
                                                           monkeypatch):
    _, _, tcfg, tparams = _models()
    tb = {"enabled": True, "output_path": str(tmp_path), "job_name": "j"}
    written = []

    class Writer:  # the TensorBoardMonitor surface the engine calls
        def __init__(self, output_path, job_name):
            assert (output_path, job_name) == (str(tmp_path), "j")

        def write_scalars(self, scalars, step):
            written.append((sorted(scalars), step))

        def flush(self):
            pass

    monkeypatch.setattr(tensorboard, "TensorBoardMonitor", Writer)
    eng, _, _, _ = deeperspeed_tpu_torch.initialize(
        model=gpt.make_gpt(tcfg)[2], model_parameters=tparams,
        config=dict(CONFIG, tensorboard=tb,
                    monitor={"tb_export_interval": 2}), device="cpu")
    for _ in range(3):
        eng.train_batch(_batch())
    exports = [w for w in written if any(k.startswith("Monitor/")
                                         for k in w[0])]
    trains = [w for w in written if w not in exports]
    assert [w[1] for w in exports] == [8]          # step 2's samples
    assert "Monitor/train_steps_total" in exports[0][0]
    assert trains == [(["Train/Samples/lr", "Train/Samples/train_loss"],
                       4), (["Train/Samples/lr",
                             "Train/Samples/train_loss"], 8)]


# ------------------------------------------------------------------ #
# serving
# ------------------------------------------------------------------ #


SERVING = {"num_slots": 2, "block_size": 8, "num_blocks": 32,
           "max_seq_len": 32, "prefill_buckets": [8, 32],
           "slo": {"ttft_p99_ms": 60000.0, "tpot_p99_ms": 1e-6}}


def _serve(package, monitor_config):
    jparams, _, tcfg, tparams = _models()
    if package == "reference":
        jcfg = jax_gpt.GPTConfig(**KW, dtype=jnp.float32, attn_impl="xla",
                                 remat=False)
        eng = JServingEngine(jcfg, jparams, SERVING,
                             monitor_config=monitor_config)
    else:
        eng = TServingEngine(tcfg, tparams, SERVING, device="cpu",
                             monitor_config=monitor_config)
    rs = np.random.RandomState(2)
    rids = [eng.submit(rs.randint(1, 97, n).tolist(), max_new_tokens=4)
            for n in (5, 12, 7)]
    outs = eng.run()
    return eng, rids, outs


def test_serving_telemetry_matches_reference():
    block = {"watchdog": "strict", "perf": True}
    jeng, jrids, jouts = _serve("reference", block)
    jm = jmon.get_monitor()
    j_events = _named(jm.tracer)
    j_text = jm.registry.render()
    jmon.shutdown_monitor(save=False)
    teng, trids, touts = _serve("port", block)
    tm = teng.telemetry
    t_events = _named(tm.tracer)
    assert [touts[r] for r in trids] == [jouts[r] for r in jrids]
    want = {k: v for k, v in _shape(j_events).items()
            if k not in ("xla_compile", "kernels/fused_layer_norm",
                         "kernels/fused_bias_gelu")}
    assert _shape(t_events) == want
    families = [{ln.split()[2] for ln in text.splitlines()
                 if ln.startswith("# TYPE")}
                for text in (j_text, tm.registry.render())]
    assert families[1] == families[0]
    assert teng.metrics.slo_tracker.summary() == \
        jeng.metrics.slo_tracker.summary()
    assert tm.watchdog.fired == [] and tm.watchdog.counts() == {
        "serving/decode_step": 1}
    assert sorted(tm.cost_index.summary()) == sorted(
        k for k in jm.cost_index.summary())
    evs = tm.tracer.to_dict()["traceEvents"]
    for mod in (jvalidate, tvalidate):
        assert mod.validate_events(evs, strict=True) == []


# ------------------------------------------------------------------ #
# the card
# ------------------------------------------------------------------ #


@pytest.mark.cuda
def test_phase6_monitor_gates_on_the_card(tmp_path):
    """chip_smoke.py phase 6's monitor gates at a small size: the kernel
    and plain paths count the same flops, every cost record is free of
    errors, the watchdog is silent after step 1, train_steps_total reads
    over HTTP, and the saved trace passes strict validation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    cfg = gpt.GPTConfig(**dict(KW, d_model=256, n_head=2, max_seq=256),
                        dtype=torch.bfloat16, remat=True,
                        remat_policy="matmuls", ce_chunk=0)
    params = gpt.init_params(0, cfg, device="cuda", dtype=torch.bfloat16)
    config = dict(CONFIG, kernels={"mode": "auto"},
                  monitor=cs.obs_monitor(tmp_path))
    batch = np.random.RandomState(0).randint(0, 97, (4, 257))
    with kc.override():
        eng, _, _, _ = deeperspeed_tpu_torch.initialize(
            model=gpt.make_gpt(cfg)[2], model_parameters=params,
            config=config)
        parity = cs.compare_paths(
            eng, gpt.make_gpt(cfg)[2],
            gpt.make_gpt(dataclasses.replace(cfg, attn_impl="xla"))[2],
            torch.from_numpy(batch[:2]).cuda(), config["kernels"],
            count=True)
        assert parity["cost"]["kernels"]["flops"] == \
            parity["cost"]["plain"]["flops"]
        eng.train_batch(batch)
        after1 = eng.monitor.watchdog.counts()
        for _ in range(cs.TRAIN_STEPS - 1):
            eng.train_batch(batch)
        cs.training_telemetry(eng, after1, 4 * 256)
    files = cs.close_monitor(tmp_path)
    assert any(f.endswith(".flight.bin") for f in files)
