"""The port's monitor package against the reference's, piece by piece: the
"monitor" block (every shipped config's, and the errors), the Prometheus
text (byte for byte, and over HTTP from the port's endpoint on port 0),
the flight recorder's file format (each package recovers the other's
flight.bin, a SIGKILLed writer's too), the tracer's events, the validator,
the run context, the watchdog's firing rule, memwatch on the CPU, the
cost index's peaks and roofline arithmetic, and the TensorBoard writer.

Everything here is exact (equal objects, bytes or texts) unless a test
says otherwise. Inputs come from fixed values or numpy with a seed."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeperspeed_tpu import monitor as jmon
from deeperspeed_tpu.monitor import flight as jflight
from deeperspeed_tpu.monitor import metrics as jmetrics
from deeperspeed_tpu.monitor import perf as jperf
from deeperspeed_tpu.monitor import runctx as jrunctx
from deeperspeed_tpu.monitor import validate as jvalidate
from deeperspeed_tpu.monitor import watchdog as jwatchdog
from deeperspeed_tpu.runtime import config as jconfig
from deeperspeed_tpu_torch import monitor as tmon
from deeperspeed_tpu_torch.monitor import flight as tflight
from deeperspeed_tpu_torch.monitor import memwatch as tmemwatch
from deeperspeed_tpu_torch.monitor import metrics as tmetrics
from deeperspeed_tpu_torch.monitor import perf as tperf
from deeperspeed_tpu_torch.monitor import runctx as trunctx
from deeperspeed_tpu_torch.monitor import validate as tvalidate
from deeperspeed_tpu_torch.monitor import watchdog as twatchdog
from deeperspeed_tpu_torch.runtime import accessors as taccessors
from deeperspeed_tpu_torch.runtime import config as tconfig
from deeperspeed_tpu_torch.utils.tensorboard import TensorBoardMonitor

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SHIPPED = sorted(p.name for p in (ROOT / "configs").glob("*.json")
                 if "monitor" in json.loads(p.read_text()))


@pytest.fixture(autouse=True)
def _clean_global_monitors():
    """Telemetry is process-global in both packages: leave none behind
    (an endpoint thread or an atexit hook would outlive the test)."""
    yield
    for pkg in (jmon, tmon):
        pkg.shutdown_monitor(save=False)
        pkg.set_tracer(None)


def _outcome(fn, *args):
    try:
        out = fn(*args)
    except Exception as e:  # noqa: BLE001 - the type and text are compared
        return ("raise", type(e).__name__, str(e))
    return ("ok", out)


# ------------------------------------------------------------------ #
# the "monitor" block
# ------------------------------------------------------------------ #


def test_every_shipped_config_with_a_monitor_block_is_checked():
    assert SHIPPED == [f"gpt_125m_{n}.json" for n in (
        "comm", "datapipe", "fleet", "lifecycle", "multihost", "obs",
        "spec")]


@pytest.mark.parametrize("name", SHIPPED)
def test_monitor_config_matches_reference_on_shipped_configs(name):
    block = json.loads((ROOT / "configs" / name).read_text())["monitor"]
    want = dataclasses.asdict(jmon.MonitorConfig.from_dict(block))
    assert dataclasses.asdict(tmon.MonitorConfig.from_dict(block)) == want


@pytest.mark.parametrize("bad", [
    {"bogus_key": 1}, {"ring_size": 0}, {"watchdog": "loud"},
    {"metrics_port": 70000}, {"tb_export_interval": -1},
    {"near_oom_fraction": 0.0}, {"near_oom_fraction": 1.5},
    {"flight_slot_bytes": 40}, {"flight_records": 0},
])
def test_monitor_config_errors_match_reference(bad):
    want = _outcome(jmon.MonitorConfig.from_dict, bad)
    assert want[0] == "raise"
    assert _outcome(tmon.MonitorConfig.from_dict, bad) == want


@pytest.mark.parametrize("block", [
    {"monitor": {"watchdog": "strict", "ring_size": 8}},
    {"monitor": {"enabled": False, "ring_size": 4}},
    {"monitor": {"enabled": True}},
    {"monitor": {"bogus_key": 1}},
    {"monitor": {"watchdog": "loud"}},
    {"monitor": "yes"},
    {"tensorboard": {"enabled": True, "output_path": "tb",
                     "job_name": "j"}},
])
def test_training_config_monitor_and_tensorboard_match_reference(block):
    cfg = dict({"train_batch_size": 8}, **block)

    def fields(cls):
        c = cls(cfg)
        mc = c.monitor_config()
        return (c.monitor_enabled,
                None if mc is None else dataclasses.asdict(mc),
                c.tensorboard_enabled, c.tensorboard_output_path,
                c.tensorboard_job_name)

    want = _outcome(fields, jconfig.TrainingConfig)
    assert _outcome(fields, tconfig.TrainingConfig) == want


def test_comm_config_as_written_is_accepted():
    cfg = json.loads((ROOT / "configs" / "gpt_125m_comm.json").read_text())
    tc = tconfig.TrainingConfig(cfg, world_size=32)
    assert tc.monitor_enabled and tc.monitor_config().enabled
    assert tc.comm_config().mode == "int8"


# ------------------------------------------------------------------ #
# metrics: registry text and the endpoint
# ------------------------------------------------------------------ #


def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    rs = np.random.RandomState(3)
    c = reg.counter("serving_finish_total", "outcomes",
                    labels={"reason": "eos"})
    c.inc()
    c.inc(2.5)
    reg.counter("serving_finish_total", labels={"reason": "length"}).inc()
    reg.counter("weird name-1", "sanitized").inc(7)
    g = reg.gauge("queue_depth", "waiting")
    g.set(4)
    g.inc(1.5)
    g.dec()
    h = reg.histogram("ttft_seconds", "latency")
    for v in rs.exponential(0.4, 50):
        h.observe(float(v))
    reg.histogram("small", buckets=(0.1, 1.0)).observe(0.5)
    return reg


def test_prometheus_text_matches_reference_byte_for_byte():
    want = _drive_registry(jmetrics).render()
    got = _drive_registry(tmetrics).render()
    assert got == want
    assert (_drive_registry(tmetrics).snapshot_scalars("M/")
            == _drive_registry(jmetrics).snapshot_scalars("M/"))


def test_endpoint_serves_the_text_on_an_ephemeral_port():
    reg = _drive_registry(tmetrics)
    srv = tmetrics.MetricsServer(reg, port=0).start()
    try:
        assert srv.port != 0
        with urllib.request.urlopen(srv.url, timeout=10) as r:
            assert r.headers["Content-Type"] == jmetrics.CONTENT_TYPE
            body = r.read().decode()
    finally:
        srv.close()
    assert body == _drive_registry(jmetrics).render()
    assert srv._thread is None  # closed: no thread outlives the server


def test_shutdown_monitor_stops_the_endpoint_and_the_atexit_hook():
    mon = tmon.init_monitor({"metrics_port": 0})
    server = mon.metrics_server
    assert server._thread.is_alive()
    tmon.shutdown_monitor(save=False)
    assert server._thread is None and tmon.get_monitor() is None
    with pytest.raises(OSError):
        urllib.request.urlopen(server.url, timeout=2)


# ------------------------------------------------------------------ #
# flight recorder: one file format
# ------------------------------------------------------------------ #


def _events(n, seed=0):
    rs = np.random.RandomState(seed)
    return [{"name": f"engine/e{i}", "ph": "i", "ts": float(i * 10),
             "pid": 1, "tid": int(rs.randint(1, 5)),
             "args": {"step": i, "x": "y" * int(rs.randint(0, 40))}}
            for i in range(n)]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_recovers_the_others_flight_file(tmp_path, writer,
                                                      monkeypatch):
    monkeypatch.setenv("DS_TPU_ROLE", "replica-r1")
    monkeypatch.setenv("DS_TPU_INCARNATION", "3")
    mod = jflight if writer == "reference" else tflight
    path = str(tmp_path / "flight.bin")
    rec = mod.FlightRecorder(path, capacity=16, slot_bytes=128)
    evs = _events(20)
    for ev in evs:
        rec.append(ev)
    rec.close()
    snaps = [m.recover(path) for m in (jflight, tflight)]
    for snap in snaps:
        # the ring's last 16; an event over a slot keeps its envelope
        assert [e["name"] for e in snap.events] == \
            [e["name"] for e in evs[-16:]]
        assert snap.meta["role"] == "replica-r1"
        assert snap.meta["incarnation"] == 3
    assert any(e["args"] == {"truncated": True} for e in snaps[0].events)
    assert any(e["args"] != {"truncated": True} for e in snaps[0].events)
    a, b = snaps
    assert (a.events, a.torn, a.last_seq, a.overwritten) == \
        (b.events, b.torn, b.last_seq, b.overwritten)


def test_flight_slots_are_byte_identical(tmp_path):
    raw = []
    for mod in (jflight, tflight):
        path = str(tmp_path / f"{mod.__name__}.bin")
        rec = mod.FlightRecorder(path, capacity=8, slot_bytes=96)
        for ev in _events(11, seed=1):
            rec.append(ev)
        rec.close()
        raw.append(Path(path).read_bytes())
    head = jflight._HEADER
    assert head.unpack(raw[0][:head.size])[:4] == \
        head.unpack(raw[1][:head.size])[:4]
    assert raw[0][jflight.HEADER_BYTES:] == raw[1][tflight.HEADER_BYTES:]


_KILLED_WRITER = """
import os, signal, sys
sys.path.insert(0, {root!r})
from {pkg}.monitor.flight import FlightRecorder
from {pkg}.monitor.tracer import Tracer
rec = FlightRecorder({path!r}, capacity=64, slot_bytes=256)
t = Tracer(flight=rec)
for i in range(100):
    with t.span("engine/train_batch", lane="engine", step=i):
        pass
    if i == 70:
        os.kill(os.getpid(), signal.SIGKILL)
"""


@pytest.mark.parametrize("pkg", ["deeperspeed_tpu_torch", "deeperspeed_tpu"])
def test_sigkilled_writer_is_recovered_by_both_packages(tmp_path, pkg):
    path = str(tmp_path / "killed.flight.bin")
    env = dict(os.environ, JAX_PLATFORMS="cpu", DS_TPU_ROLE="trainer.h1")
    proc = subprocess.run(
        [sys.executable, "-c", _KILLED_WRITER.format(root=str(ROOT),
                                                     pkg=pkg, path=path)],
        env=env, capture_output=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr.decode()[-2000:]
    snaps = [m.recover(path) for m in (jflight, tflight)]
    for snap in snaps:
        steps = [e["args"]["step"] for e in snap.events]
        assert steps == list(range(71 - 64, 71))  # the ring's last 64
        assert snap.meta["role"] == "trainer.h1" and snap.torn == 0
    assert snaps[0].events == snaps[1].events


# ------------------------------------------------------------------ #
# tracer, validator, run context
# ------------------------------------------------------------------ #


def _drive_tracer(mod, flight_path):
    drops = []
    rec = mod.flight.FlightRecorder(flight_path, capacity=32)
    t = mod.Tracer(ring_size=8, flight=rec, on_drop=drops.append)
    for i in range(12):
        with t.span("engine/train_batch", lane="engine", step=i) as sp:
            sp.note(mfu=0.5)
        t.instant("mem/watermark", lane="mem", phase="step",
                  bytes_in_use=i, peak_bytes=i)
        t.counter("serving/load", {"queued": i}, lane="serving")
    t.set_metadata("perf", {"engine/train_step": {"flops": 1.0}})
    rec.close()
    return t, drops


def _shape(ev):
    return {k: v for k, v in ev.items() if k not in ("ts", "dur", "pid",
                                                     "tid")}


def test_tracer_matches_reference(tmp_path):
    jt, jdrops = _drive_tracer(jmon, str(tmp_path / "j.bin"))
    tt, tdrops = _drive_tracer(tmon, str(tmp_path / "t.bin"))
    assert [_shape(e) for e in tt.events()] == \
        [_shape(e) for e in jt.events()]
    assert tt.dropped == jt.dropped and tdrops == jdrops
    jd, td = jt.to_dict(), tt.to_dict()
    assert sorted(td["otherData"]) == sorted(jd["otherData"])
    assert td["otherData"]["perf"] == jd["otherData"]["perf"]
    assert [m["args"]["name"] for m in td["traceEvents"]
            if m["name"] == "thread_name"] == \
        [m["args"]["name"] for m in jd["traceEvents"]
         if m["name"] == "thread_name"]
    for mod in (jvalidate, tvalidate):
        assert mod.validate_events(td["traceEvents"], strict=True) == []


_BAD_EVENTS = [
    {"ph": "X", "pid": 1, "tid": 1, "name": "engine/x", "ts": 1.0},
    {"ph": "i", "pid": 1, "tid": 1, "name": "mystery", "ts": 2.0},
    {"ph": "i", "pid": 1, "tid": 1, "name": "perf/step", "ts": 3.0,
     "args": {"entry": "e"}},
    {"ph": "B", "pid": 1, "tid": 2, "name": "comm/a", "ts": 4.0},
    {"ph": "E", "pid": 1, "tid": 2, "name": "comm/b", "ts": 5.0},
    {"ph": "Q", "pid": 1, "tid": 1},
    {"pid": 1},
    {"ph": "i", "pid": 1, "tid": 1, "name": "run/start", "ts": -1,
     "args": {"run_id": "", "role": "main", "incarnation": 0}},
]


@pytest.mark.parametrize("strict", [False, True])
def test_validator_matches_reference(strict, tmp_path, capsys):
    assert tvalidate.validate_events(_BAD_EVENTS, strict=strict) == \
        jvalidate.validate_events(_BAD_EVENTS, strict=strict)
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"traceEvents": _BAD_EVENTS}))
    args = (["--strict"] if strict else []) + [str(path)]
    assert tvalidate.main(args) == jvalidate.main(args) == 1


def test_run_context_matches_reference(monkeypatch):
    monkeypatch.delenv("DS_TPU_RUN_ID", raising=False)
    monkeypatch.setenv("DS_TPU_ROLE", "router")
    monkeypatch.setenv("DS_TPU_INCARNATION", "x")
    assert dataclasses.asdict(trunctx.current()) == \
        dataclasses.asdict(jrunctx.current())
    rid = trunctx.ensure_run_id()
    assert jrunctx.ensure_run_id() == rid  # one variable, one run id
    base = {"PATH": "/bin"}
    assert trunctx.child_env("replica-r2", 4, base) == \
        jrunctx.child_env("replica-r2", 4, base)
    for args in (("trainer", 0, 1), ("trainer", 1, 2), ("t", 3, 8)):
        assert trunctx.host_role(*args) == jrunctx.host_role(*args)
    assert trunctx.estimate_clock_offset(1.0, 5.0, 3.0) == \
        jrunctx.estimate_clock_offset(1.0, 5.0, 3.0)
    assert (trunctx.RUN_ID_ENV, trunctx.ROLE_ENV, trunctx.INCARNATION_ENV) \
        == (jrunctx.RUN_ID_ENV, jrunctx.ROLE_ENV, jrunctx.INCARNATION_ENV)


# ------------------------------------------------------------------ #
# watchdog
# ------------------------------------------------------------------ #


def _watch_sequence(mode, shapes, package):
    """Feed calls at ``shapes`` through a watched entry point of each
    package (a jitted function / an eager SignatureCache); returns the
    index of each call after which the watchdog fired."""
    if package == "reference":
        wd = jwatchdog.RecompileWatchdog(mode=mode)
        fn = jax.jit(lambda x: x * 2)
        wd.watch("f", fn)
        call = lambda s: fn(jnp.ones(s))  # noqa: E731
    else:
        wd = twatchdog.RecompileWatchdog(mode=mode)
        sigs = twatchdog.SignatureCache()
        wd.watch("f", sigs)
        call = lambda s: sigs.record(torch.ones(s))  # noqa: E731
    fired = []
    for i, s in enumerate(shapes):
        call(s)
        if wd.observe("f", step=i):
            fired.append(i)
    return fired, wd


@pytest.mark.parametrize("package", ["reference", "port"])
def test_watchdog_silent_at_one_shape_fires_on_a_new_one(package):
    fired, wd = _watch_sequence("warn", [(4, 8)] * 5, package)
    assert fired == [] and wd.fired == []
    fired, wd = _watch_sequence("warn", [(4, 8)] * 3 + [(4, 9), (4, 9)],
                                package)
    assert fired == [3]
    assert wd.fired[0]["step"] == 3
    fired, wd = _watch_sequence("off", [(4, 8), (4, 9)], package)
    assert fired == []


@pytest.mark.parametrize("package", ["reference", "port"])
def test_watchdog_strict_raises(package):
    error = (jwatchdog if package == "reference"
             else twatchdog).RecompileError
    with pytest.raises(error):
        _watch_sequence("strict", [(2,), (2,), (3,)], package)


def test_watchdog_modes_match_reference():
    assert twatchdog.MODES == jwatchdog.MODES
    for mod in (jwatchdog, twatchdog):
        with pytest.raises(ValueError):
            mod.RecompileWatchdog(mode="loud")


def test_signature_counts_shapes_dtypes_and_devices():
    sigs = twatchdog.SignatureCache()
    assert sigs.record({"w": torch.ones(2)}, 3) is True
    assert sigs.record({"w": torch.zeros(2)}, 4) is False  # values differ
    assert sigs.record({"w": torch.ones(2, dtype=torch.float64)}, 3)
    assert sigs.record({"w": torch.ones(3)}, 3)
    assert sigs.record({"w": torch.ones(2)}, 3.0)  # another leaf type
    assert sigs._cache_size() == 4


def test_kernel_build_is_the_compile_instant():
    t = tmon.Tracer()
    prev = tmon.set_tracer(t)
    try:
        before = twatchdog.global_compile_events()
        twatchdog.note_compile(1.25, "fused_blocks.cu")
    finally:
        tmon.set_tracer(prev)
    (ev,) = t.events()
    assert ev["name"] == "xla_compile" and ev["args"]["seconds"] == 1.25
    assert twatchdog.global_compile_events() == before + 1


# ------------------------------------------------------------------ #
# memwatch and the cost index's arithmetic
# ------------------------------------------------------------------ #


def test_memwatch_on_the_cpu_matches_reference():
    assert tmemwatch.device_memory_stats("cpu") == {}
    assert tmemwatch.aggregate_memory_stats() == {}
    lanes = []
    for pkg in (jmon, tmon):
        t = pkg.Tracer()
        prev = pkg.set_tracer(t)
        try:
            reg = pkg.MetricsRegistry()
            mw = pkg.MemWatch(registry=reg)
            sp = t.span("engine/train_batch", lane="engine")
            with sp:
                mw.annotate(sp, "train_batch")
            lanes.append(([_shape(e) for e in t.events()], reg.render()))
        finally:
            pkg.set_tracer(prev)
    assert lanes[0] == lanes[1]
    with pytest.raises(ValueError):
        tmon.MemWatch(near_oom_fraction=0.0)


def test_platform_peaks():
    cpu = tperf.platform_peaks("cpu")
    want = jperf.PLATFORM_PEAKS["cpu"]
    assert {k: cpu[k] for k in want} == want
    h100 = tperf.PLATFORM_PEAKS["h100"]
    assert (h100["peak_tflops"], h100["peak_gbps"], h100["hbm_gib"]) == \
        (989.0, 3350.0, 80.0)
    assert "H100" in h100["label"]
    assert set(tperf.PLATFORM_PEAKS) == {"h100", "cpu"}


@pytest.mark.parametrize("flops,nbytes,wall", [
    (1e12, 1e9, 4.0), (1e9, 5e10, 1.5), (1e9, 1e8, 100.0)])
def test_step_stats_match_reference(flops, nbytes, wall):
    """MFU, tflops, the floors and the roofline verdict from the same
    record on the reference's CPU row (relative 1e-12: one division
    order)."""
    j = jperf.CompiledCostIndex(peaks=dict(jperf.PLATFORM_PEAKS["cpu"]))
    j._devices = 1
    j._records["e"] = jperf.CostRecord("e", flops=flops,
                                       bytes_accessed=nbytes)
    t = tperf.CompiledCostIndex(peaks=tperf.platform_peaks("cpu"))
    t._records["e"] = tperf.CostRecord("e", flops=flops,
                                       bytes_accessed=nbytes)
    a, b = j.step_stats("e", wall), t.step_stats("e", wall)
    assert a["verdict"] == b["verdict"]
    for k in ("mfu", "tflops", "wall_ms", "est_compute_ms",
              "est_memory_ms"):
        assert b[k] == pytest.approx(a[k], rel=1e-12)


def test_capture_counts_matmuls_and_declared_work():
    """One capture of a matmul and a declaring wrapper: flop_counter's
    2 m n k for the mm, the wrapper's declared work for its call, none of
    the aten ops inside it."""
    @tperf.declares(lambda out, x: (7, tperf.io_bytes(out, x)))
    def wrapped(x):
        return x @ x  # counted as the declaration only

    idx = tperf.CompiledCostIndex(emit=False, peaks=tperf.platform_peaks())
    sigs = twatchdog.SignatureCache()
    a = torch.ones(4, 5)
    b = torch.ones(5, 3)
    c = torch.ones(2, 2)
    sigs.record(a, b)
    with idx.capture("e", sigs, "cpu", (a, b)):
        a @ b
        wrapped(c)
    rec = idx.get("e")
    assert rec.error is None and rec.captures == 1
    assert rec.flops == 2 * 4 * 5 * 3 + 7
    assert rec.bytes_accessed == (20 + 15 + 12) * 4 + (4 + 4) * 4
    assert rec.argument_bytes == (20 + 15) * 4
    # warm: the same signature count does not capture again
    assert isinstance(idx.capture("e", sigs, "cpu"), type(tperf._NULL))


# ------------------------------------------------------------------ #
# tensorboard
# ------------------------------------------------------------------ #


def test_tensorboard_writer_and_rank_gate(tmp_path):
    cfg = tconfig.TrainingConfig({
        "train_batch_size": 2,
        "tensorboard": {"enabled": True, "output_path": str(tmp_path),
                        "job_name": "job"}})
    assert taccessors.make_summary_writer(cfg, rank=1) is None
    with taccessors.make_summary_writer(cfg, rank=0) as tb:
        tb.write_scalars({"Train/Samples/lr": 0.5}, 3)
    assert any((tmp_path / "job").iterdir())
    assert taccessors.make_summary_writer(
        tconfig.TrainingConfig({"train_batch_size": 2})) is None
    assert isinstance(tb, TensorBoardMonitor)


def test_near_oom_trip_writes_through_the_flight_recorder(tmp_path,
                                                          monkeypatch):
    """The post-mortem fires once per crossing (re-arming below 75 % of
    the fraction) with the reference's instants, and ``recover`` reads
    them back from either package's flight file."""
    recovered = []
    for pkg, mw_mod in ((jmon, jmon.memwatch), (tmon, tmemwatch)):
        monkeypatch.setattr(
            mw_mod, "aggregate_memory_stats",
            lambda it=iter([95, 96, 50, 97]): {
                "bytes_in_use": next(it), "peak_bytes_in_use": 97,
                "bytes_limit": 100})
        path = str(tmp_path / f"{pkg.__name__}.flight.bin")
        mon = pkg.Monitor({"flight_path": path,
                           "near_oom_fraction": 0.9}).start()
        for phase in ("a", "b", "c", "d"):
            mon.memwatch.sample(phase)
        assert mon.memwatch.postmortems == 2
        mon.shutdown(save=False)
        recovered.append([(e["name"], e["args"].get("reason"))
                          for e in tflight.recover(path).events])
    assert recovered[1] == recovered[0]
    assert [n for n, _ in recovered[1]].count("mem/postmortem") == 2
