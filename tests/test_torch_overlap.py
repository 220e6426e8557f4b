"""The backward-overlap schedule (runtime/comm/overlap.py).

``overlap_fraction`` and ``reduce_span_stats`` give the reference's
numbers on the reference's synthetic traces (tests/test_comm_overlap.py),
and ``resolve_overlap`` its decisions. On 2 gloo ranks
(tests/torch_gloo_worker.py) a tiny GPT (2 layers, d_model 64, 2
accumulation steps, ZeRO 1) trains 3 steps with overlap off and on, for
the fp32 and the int8 wire, through ``train_batch`` and through
``forward``/``backward``/``step``: the losses, the params after every step
and the error-feedback residuals are bit-identical (no tolerance), both
ranks agree, every bucket leaves from a hook while the backward runs, and
the scheduler is drained at every boundary; ``GradReducer.reduce_dispatch``
launching onto a scheduler gives its serial dispatch's bits."""

import json
import threading

import numpy as np
import pytest
import torch

from deeperspeed_tpu.runtime.comm import overlap as jax_overlap
from deeperspeed_tpu.runtime.comm.config import CommConfig as JaxCommConfig
from deeperspeed_tpu_torch.runtime.comm import overlap
from deeperspeed_tpu_torch.runtime.comm.config import CommConfig
from tests import torch_gloo_worker as worker
from tests.test_torch_zero_training import TINY, _params

torch.set_num_threads(1)

STEPS = 3


def _serial():
    return [{"ph": "X", "name": "comm/reduce", "dur": 800.0,
             "args": {"overlapped": False}},
            {"ph": "X", "name": "comm/reduce", "dur": 200.0,
             "args": {"overlapped": False}}]


def _overlapped():
    return [{"ph": "X", "name": "comm/reduce", "dur": 5.0,
             "args": {"overlapped": True}},
            {"ph": "X", "name": "comm/overlap_window", "dur": 250.0,
             "args": {"buckets": 2}}]


def test_overlap_fraction_from_traces():
    serial, over = _serial(), _overlapped()
    assert overlap.overlap_fraction(serial, over) == 0.75
    assert overlap.overlap_fraction([], over) == 0.0
    exposed = serial + [{"ph": "X", "name": "comm/overlap_window",
                         "dur": 2000.0, "args": {"buckets": 2}}]
    assert overlap.overlap_fraction(serial, exposed) == 0.0
    for a, b in ((serial, over), ([], over), (serial, exposed),
                 ({"traceEvents": serial}, {"traceEvents": over})):
        assert (overlap.overlap_fraction(a, b)
                == jax_overlap.overlap_fraction(a, b))


def test_reduce_span_stats_match_reference():
    events = _serial() + _overlapped() + [
        {"ph": "i", "name": "comm/reduce"}, "not an event",
        {"ph": "X", "name": "engine/step", "dur": 9.0}]
    for trace in (events, {"traceEvents": events}):
        assert (overlap.reduce_span_stats(trace)
                == jax_overlap.reduce_span_stats(trace))
    stats = overlap.reduce_span_stats(events)
    assert stats["overlapped_spans"] == 1 and stats["serial_spans"] == 2
    assert stats["windows"] == 1 and stats["window_ms"] == 0.25


def test_resolve_overlap_as_reference():
    for value in ("off", "auto", "on"):
        for world in (1, 2, 8):
            for canonical in (0, 4):
                assert overlap.resolve_overlap(
                    CommConfig(overlap=value), world=world,
                    canonical=canonical) == jax_overlap.resolve_overlap(
                        JaxCommConfig(overlap=value), world=world,
                        canonical=canonical)


def test_scheduler_runs_in_order_on_one_thread_and_drains():
    sched = overlap.OverlapScheduler()
    seen = []

    def job(i):
        seen.append((i, threading.current_thread().name))
        return i * i

    futs = [sched.submit(job, i) for i in range(5)]
    sched.note(futs, 5)
    assert sched.pending_buckets == 5
    assert sched.drain() == [0, 1, 4, 9, 16]
    assert sched.pending_buckets == 0 and sched.drain() == []
    assert [i for i, _ in seen] == list(range(5))
    assert {name for _, name in seen} == {"comm-overlap"}

    def boom():
        raise RuntimeError("bucket failed")

    sched.note(sched.submit(boom), 1)
    with pytest.raises(RuntimeError, match="bucket failed"):
        sched.drain()
    sched.close()


_RUN = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if not _RUN:
        d = tmp_path_factory.mktemp("overlap")
        _, _, tparams = _params()
        torch.save(tparams, d / "params.pt")
        rs = np.random.RandomState(5)
        np.save(d / "batches.npy", np.stack(
            [rs.randint(0, 97, (8, 33)).astype(np.int32)
             for _ in range(STEPS)]))
        worker.spawn("overlap_run", 2, d, TINY, STEPS)
        _RUN["ranks"] = [json.loads((d / f"overlap_rank{r}.json")
                                    .read_text()) for r in range(2)]
    return _RUN["ranks"]


@pytest.mark.parametrize("mode", ["fp32", "int8"])
@pytest.mark.parametrize("path", ["train_batch", "imperative"])
def test_overlap_on_is_bit_identical_to_off(ranks, mode, path):
    for r in ranks:
        off, on = r[f"{mode}/off/{path}"], r[f"{mode}/on/{path}"]
        assert not off["scheduler"] and on["scheduler"]
        assert on["losses"] == off["losses"]
        assert on["digests"] == off["digests"]
        assert on["residuals"] == off["residuals"]
        assert on["pending"] == 0
        assert all(np.isfinite(float.fromhex(x)) for x in on["losses"])
    assert ranks[0][f"{mode}/on/{path}"]["digests"] == \
        ranks[1][f"{mode}/on/{path}"]["digests"]
    assert all(r["reduce_dispatch_overlap_equal"] for r in ranks)
    # several buckets, launched by the hooks one by one: all of them
    # leave while the backward still runs
    on = ranks[0][f"{mode}/on/{path}"]
    assert on["buckets"] > 1 and on["in_backward"] == on["buckets"]
