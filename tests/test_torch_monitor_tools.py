"""The offline trace tools, the port's copies against the reference's, on
the same inputs: ``aggregate`` (merged timelines of several processes,
flight files included), ``goodput`` (a restart log beside incarnation
traces), ``reqledger`` and ``slo`` (on a trace of the port's
ServingEngine). And the data-parallel monitor: 2 gloo ranks train under
the blocks of configs/gpt_125m_comm.json, each writes its own trace (its
role lane, ``trainer.h<rank>``), and ``aggregate`` merges them into one
timeline holding both ranks' comm/reduce spans.

Every report is compared exactly (equal dicts or files)."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deeperspeed_tpu import monitor as jmon
from deeperspeed_tpu.monitor import aggregate as jaggregate
from deeperspeed_tpu.monitor import goodput as jgoodput
from deeperspeed_tpu.monitor import metrics as jmetrics
from deeperspeed_tpu.monitor import reqledger as jreqledger
from deeperspeed_tpu.monitor import slo as jslo
from deeperspeed_tpu_torch import monitor as tmon
from deeperspeed_tpu_torch.models import gpt
from deeperspeed_tpu_torch.monitor import aggregate as taggregate
from deeperspeed_tpu_torch.monitor import goodput as tgoodput
from deeperspeed_tpu_torch.monitor import metrics as tmetrics
from deeperspeed_tpu_torch.monitor import reqledger as treqledger
from deeperspeed_tpu_torch.monitor import slo as tslo
from deeperspeed_tpu_torch.monitor.flight import FlightRecorder
from deeperspeed_tpu_torch.monitor.tracer import Tracer
from deeperspeed_tpu_torch.serving import ServingEngine

import torch_gloo_worker as worker

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean_global_monitors():
    yield
    for pkg in (jmon, tmon):
        pkg.shutdown_monitor(save=False)
        pkg.set_tracer(None)


def _span(name, ts_us, dur_us, **args):
    return {"name": name, "ph": "X", "ts": float(ts_us),
            "dur": float(dur_us), "pid": 1, "tid": 1,
            **({"args": args} if args else {})}


def _instant(name, ts_us, **args):
    return {"name": name, "ph": "i", "ts": float(ts_us), "pid": 1,
            "tid": 1, "s": "t", "args": args}


# ------------------------------------------------------------------ #
# aggregate and goodput
# ------------------------------------------------------------------ #


def _sources(tmp_path, monkeypatch):
    """A router trace and a replica's flight file, written by the port."""
    monkeypatch.setenv("DS_TPU_RUN_ID", "run-agg")
    monkeypatch.setenv("DS_TPU_ROLE", "router")
    t = Tracer()
    t.instant("serving/dispatch", lane="serving", rid="q1", replica="r0",
              attempt=1)
    with t.span("serving/step", lane="serving", step=0):
        pass
    router = t.save(str(tmp_path / "router.i0.trace.json"))
    time.sleep(0.002)
    monkeypatch.setenv("DS_TPU_ROLE", "replica-r0")
    fl = FlightRecorder(str(tmp_path / "replica-r0.i0.flight.bin"),
                        capacity=32, slot_bytes=256)
    now = time.perf_counter() * 1e6
    fl.append(_instant("serving/admit", now, rid="q1", slot=0, ctx_len=8,
                       admissions=1))
    fl.append(_span("serving/decode", now + 10, 1000, rid="q1"))
    fl.close()
    return [router, fl.path]


def test_aggregate_matches_reference(tmp_path, monkeypatch):
    paths = _sources(tmp_path, monkeypatch)
    want = jaggregate.merge_files(paths)
    got = taggregate.merge_files(paths)
    assert got == want
    assert want[1]["flow_arrows"] == 1 and want[1]["recovered_events"] == 2
    rcs = [mod.main(["--out", str(tmp_path / f"{i}.json"), "--strict",
                     *paths]) for i, mod in enumerate((jaggregate,
                                                       taggregate))]
    assert rcs == [0, 0]
    assert (tmp_path / "0.json").read_text() == \
        (tmp_path / "1.json").read_text()


def test_goodput_matches_reference(tmp_path):
    restart_log = [{"event": "launch", "ts": 100.0},
                   {"event": "exit", "ts": 104.0, "code": 137},
                   {"event": "launch", "ts": 104.5},
                   {"event": "exit", "ts": 108.5, "code": 0}]
    inc0 = [_instant("xla_compile", 1_000_000, seconds=0.5),
            _span("engine/train_batch", 500_000, 1_000_000, step=0),
            _span("engine/train_batch", 1_500_000, 500_000, step=1),
            _span("resilience/write", 2_000_000, 300_000),
            _span("datapipe/wait", 2_300_000, 200_000)]
    fp = str(tmp_path / "trainer.i1.flight.bin")
    fl = FlightRecorder(fp, capacity=16, slot_bytes=256)
    fl.append(_span("engine/train_batch", 0, 400_000, step=1))
    fl.append(_span("engine/train_batch", 400_000, 600_000, step=2))
    fl.close()
    regs = (jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry())
    want = jgoodput.compute_goodput(restart_log, [inc0, fp],
                                    registry=regs[0], emit_trace=False)
    got = tgoodput.compute_goodput(restart_log, [inc0, fp],
                                   registry=regs[1], emit_trace=False)
    assert got == want
    assert regs[1].render() == regs[0].render()
    assert want["buckets"]["rework"] == pytest.approx(0.4)


# ------------------------------------------------------------------ #
# reqledger and slo on the port's serving trace
# ------------------------------------------------------------------ #


def test_request_ledger_and_slo_doctor_match_reference(tmp_path, capsys):
    cfg = gpt.GPTConfig(vocab_size=97, n_layer=2, n_head=2, d_model=32,
                        max_seq=64, dtype=torch.float32, attn_impl="xla",
                        remat=False)
    params = gpt.init_params(0, cfg, device="cpu")
    trace = str(tmp_path / "serving.trace.json")
    eng = ServingEngine(
        cfg, params, {"num_slots": 2, "block_size": 8, "num_blocks": 32,
                      "max_seq_len": 64, "prefill_buckets": [16, 64],
                      "slo": {"ttft_p99_ms": 1e-3, "e2e_p99_ms": 1e5}},
        device="cpu", monitor_config={"trace_path": trace})
    rs = np.random.RandomState(4)
    rids = [eng.submit(rs.randint(1, 97, n).tolist(), max_new_tokens=5)
            for n in (6, 20, 9, 3)]
    eng.run()
    tmon.shutdown_monitor(save=True)
    want = jreqledger.build_ledger(trace)
    got = treqledger.build_ledger(trace)
    assert got == want
    assert sorted(got["requests"]) == sorted(rids)
    assert got["ttft"]["count"] == got["e2e"]["count"] == len(rids)
    reports = []
    for mod in (jslo, tslo):
        out = tmp_path / f"{mod.__name__}.json"
        assert mod.main(["--json", str(out), trace]) == 0
        reports.append(json.loads(out.read_text()))
    assert reports[1] == reports[0]
    regs = (jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry())
    jreqledger.export_cost_gauges(want, regs[0])
    treqledger.export_cost_gauges(got, regs[1])
    assert regs[1].render() == regs[0].render()


# ------------------------------------------------------------------ #
# the data-parallel monitor: per-rank files, one merged timeline
# ------------------------------------------------------------------ #


TINY = dict(vocab_size=97, n_layer=2, n_head=2, d_model=32, max_seq=16,
            dtype=torch.float32, attn_impl="xla", remat=False, ce_chunk=0)


def _comm_config(world):
    """configs/gpt_125m_comm.json as written, its batch cut to world x 2
    rows and no accumulation."""
    cfg = json.loads((ROOT / "configs" / "gpt_125m_comm.json").read_text())
    cfg["train_batch_size"] = 2 * world
    cfg["train_micro_batch_size_per_gpu"] = 2
    return cfg


def test_data_parallel_ranks_write_their_own_traces(tmp_path):
    steps = 2
    worker.spawn("monitor_run", 2, tmp_path, TINY, _comm_config(2), steps)
    ranks = [json.loads((tmp_path / f"monitor{r}.json").read_text())
             for r in range(2)]
    assert [r["role"] for r in ranks] == ["trainer.h0", "trainer.h1"]
    assert [Path(r["trace"]).name for r in ranks] == [
        "trainer.h0.i0.trace.json", "trainer.h1.i0.trace.json"]
    for r in ranks:
        assert r["comm_buckets"] == r["n_buckets"] * steps
        assert r["comm_wire_bytes"] == r["wire_bytes_per_step"] * steps
        assert r["train_steps_total"] == steps
    paths = [r["trace"] for r in ranks]
    doc, stats = taggregate.merge_files(paths)
    assert (doc, stats) == jaggregate.merge_files(paths)
    events = doc["traceEvents"]
    assert tmon.validate_events(events, strict=True) == []
    reduce_pids = {e["pid"] for e in events if e["name"] == "comm/reduce"}
    assert len(reduce_pids) == 2
    assert {s["label"] for s in stats["sources"]} == {"trainer.h0#0",
                                                     "trainer.h1#0"}
