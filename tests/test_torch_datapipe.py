"""The PyTorch port's input pipeline (deeperspeed_tpu_torch/datapipe/)
against the reference's (deeperspeed_tpu/datapipe/), module by module.

Both are numpy at their core, so the port must give the reference's
windows, epoch orders, fingerprints, packed tokens and segment ids,
curriculum masks and batch streams exactly (``np.array_equal``, the same
hex strings). The corpora are made from a numpy seed. The reference's
pipes run with ``stage_to_device`` off (its staging places onto a JAX
mesh); the port's stage onto the CPU through the engine-less default
``place_fn`` where a test says so."""

import time

import numpy as np
import pytest
import torch

from deeperspeed_tpu import datapipe as jdp
from deeperspeed_tpu.runtime import bs_schedules as jbs
from deeperspeed_tpu_torch import datapipe as tdp
from deeperspeed_tpu_torch.runtime import bs_schedules as tbs

torch.set_num_threads(1)

SEQ = 16
ROWS = 6


def _corpus(n=2000, seed=3, vocab=97):
    return np.random.RandomState(seed).randint(0, vocab, n).astype(np.uint16)


def _write_shards(tmp_path, corpus, cuts):
    d = tmp_path / "shards"
    d.mkdir()
    for i, (a, b) in enumerate(zip((0,) + cuts, cuts + (corpus.size,))):
        np.save(d / f"shard_{i:03d}.npy", corpus[a:b])
    return str(d)


def _source(kind, tmp_path):
    corpus = _corpus()
    if kind == "array":
        return corpus
    if kind == "file":
        path = tmp_path / "corpus.npy"
        np.save(path, corpus)
        return str(path)
    # uneven shards: each drops its own ragged tail
    return _write_shards(tmp_path, corpus, (333, 1010, 1500))


# ------------------------------------------------------------------ #
# dataset, order, fingerprint, state
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("kind", ["array", "file", "shards"])
def test_windows_match_reference(kind, tmp_path):
    src = _source(kind, tmp_path)
    j = jdp.TokenShardDataset(src, SEQ)
    t = tdp.TokenShardDataset(src, SEQ)
    assert len(t) == len(j) > 0
    assert t.identity() == j.identity()
    for i in range(len(j)):
        a, b = t[i], j[i]
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(IndexError):
        t[len(t)]


def test_dataset_errors_match_reference(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    for src, exc in ((str(empty), FileNotFoundError),
                     (str(tmp_path / "nope.npy"), FileNotFoundError),
                     (np.zeros(5, np.int32), ValueError)):
        for mod in (jdp, tdp):
            with pytest.raises(exc):
                mod.TokenShardDataset(src, SEQ)
    np.save(tmp_path / "two_d.npy", np.zeros((4, 4), np.int32))
    for mod in (jdp, tdp):
        with pytest.raises(ValueError, match="1-D"):
            mod.TokenShardDataset(str(tmp_path / "two_d.npy"), SEQ)


@pytest.mark.parametrize("seed,epoch,n,shuffle", [
    (0, 0, 10, True), (42, 3, 1000, True), (2**40 + 7, 9, 4097, True),
    (5, 1, 77, False)])
def test_epoch_order_and_fingerprint_match_reference(seed, epoch, n,
                                                     shuffle):
    a = tdp.epoch_order(seed, epoch, n, shuffle)
    b = jdp.epoch_order(seed, epoch, n, shuffle)
    assert a.dtype == b.dtype == np.int64 and np.array_equal(a, b)
    ident = {"n_windows": n, "seq_len": SEQ, "shards": ["a.npy"]}
    for identity in (None, ident):
        assert (tdp.order_fingerprint(seed, epoch, n, shuffle, identity)
                == jdp.order_fingerprint(seed, epoch, n, shuffle, identity))


def test_data_state_round_trips_and_filters_unknown_keys():
    st = tdp.DataState(epoch=2, cursor=30, step=7, samples=150, seed=4,
                       fingerprint="abc", offset=3)
    d = st.to_dict()
    assert d == jdp.DataState(**d).to_dict()
    assert tdp.DataState.from_dict(dict(d, future_field=1)) == st
    old = {k: v for k, v in d.items() if k != "offset"}
    assert tdp.DataState.from_dict(old).offset == 0
    assert (tdp.DataState.from_dict(old).to_dict()
            == jdp.DataState.from_dict(old).to_dict())


@pytest.mark.parametrize("bad", [
    {"seq_len": 0}, {"prefetch_depth": 0}, {"curriculum": 5},
    {"curriculum": {"warmup": 3}}, {"curriculum": {"start_seq_len": 0}},
    {"seq_len": 8, "curriculum": {"start_seq_len": 9}},
    {"curriculum": {"warmup_steps": -1}}, {"bogus": 1}])
def test_config_errors_match_reference(bad):
    def outcome(cls):
        try:
            cls.from_dict(bad)
        except ValueError as e:
            return str(e)
        return None

    want = outcome(jdp.DataPipeConfig)
    assert want is not None and outcome(tdp.DataPipeConfig) == want


# ------------------------------------------------------------------ #
# packer and curriculum
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("eos,offset", [(None, 0), (96, 0), (96, 5)])
def test_packer_matches_reference(eos, offset):
    rs = np.random.RandomState(1)
    docs = [rs.randint(1, 90, rs.randint(1, 40)) for _ in range(30)]
    jp = jdp.SequencePacker(SEQ, pad_id=0, eos_id=eos)
    tp = tdp.SequencePacker(SEQ, pad_id=0, eos_id=eos)
    for rows in (1, 3, 8):
        a = tp.pack(iter(docs), rows, first_offset=offset)
        b = jp.pack(iter(docs), rows, first_offset=offset)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert a[2:] == b[2:]


@pytest.mark.parametrize("bs_sched", [None, (64, 0.25, 6, 3)])
def test_curriculum_schedule_and_masks_match_reference(bs_sched):
    jcur = jdp.SeqLenCurriculum(SEQ, 4, warmup_steps=8, num_intervals=4)
    tcur = tdp.SeqLenCurriculum(SEQ, 4, warmup_steps=8, num_intervals=4)
    assert tcur.schedule == jcur.schedule
    jsched = tsched = None
    if bs_sched is not None:
        final, mult, warm, k = bs_sched
        jsched = jbs.BatchSizeScheduler(final, mult, warm, k).schedule
        tsched = tbs.BatchSizeScheduler(final, mult, warm, k).schedule
        assert tsched == jsched
    jst = jdp.CurriculumStage(jcur, bs_schedule=jsched, pad_id=0)
    tst = tdp.CurriculumStage(tcur, bs_schedule=tsched, pad_id=0)
    rs = np.random.RandomState(2)
    tokens = rs.randint(1, 97, (64, SEQ + 1)).astype(np.int32)
    segs = rs.randint(1, 3, (64, SEQ + 1)).astype(np.int32)
    for step in range(12):
        assert tst.plan(step, 64, SEQ) == jst.plan(step, 64, SEQ)
        assert tcur.seq_len_at(step) == jcur.seq_len_at(step)
        a, b = tst.apply(tokens, step), jst.apply(tokens, step)
        assert a.shape == tokens.shape and np.array_equal(a, b)
        (a, sa), (b, sb) = (tst.apply(tokens, step, segment_ids=segs),
                            jst.apply(tokens, step, segment_ids=segs))
        assert np.array_equal(a, b) and np.array_equal(sa, sb)
        if bs_sched is not None:
            assert (tdp.batch_size_at(tsched, step)
                    == jdp.batch_size_at(jsched, step))
    # a tuple batch passes through untouched
    pair = (tokens, tokens)
    assert tst.apply(pair, 0) is pair


# ------------------------------------------------------------------ #
# prefetcher
# ------------------------------------------------------------------ #

def test_prefetcher_order_error_and_close():
    it = iter(range(5))

    def produce():
        i = next(it)
        if i == 3:
            raise KeyError("boom")
        return i

    p = tdp.AsyncPrefetcher(produce, depth=2)
    assert [p.get()[0] for _ in range(3)] == [0, 1, 2]
    with pytest.raises(KeyError, match="boom"):
        p.get()
    with pytest.raises(RuntimeError, match="closed"):
        p.get()
    p.close()

    # close() unblocks a producer waiting on a full queue
    made = []
    p = tdp.AsyncPrefetcher(lambda: made.append(1) or len(made), depth=1)
    deadline = time.time() + 5
    while p.queued < 1 and time.time() < deadline:
        time.sleep(0.01)
    assert p.queued == 1
    t0 = time.perf_counter()
    p.close()
    assert time.perf_counter() - t0 < 2
    assert not p._thread.is_alive()
    p.close()  # twice is fine


# ------------------------------------------------------------------ #
# the pipe
# ------------------------------------------------------------------ #

def _block(**kw):
    d = dict(seq_len=SEQ, seed=7, prefetch=False, stage_to_device=False,
             curriculum={"start_seq_len": 4, "warmup_steps": 6,
                         "num_intervals": 3})
    d.update(kw)
    return d


def _pipes(src, port_kw=None, rows=ROWS):
    """The reference's pipe and the port's (staging onto the CPU when its
    block stages) over ``src``: a path, or an array wrapped in each
    package's dataset."""
    def build(mod, kw, **extra):
        block = _block(**kw)
        if isinstance(src, str):
            block["source"] = src
            return mod.build_datapipe(mod.DataPipeConfig.from_dict(block),
                                      global_rows=rows, **extra)
        return mod.build_datapipe(mod.DataPipeConfig.from_dict(block),
                                  dataset=mod.TokenShardDataset(src, SEQ),
                                  global_rows=rows, **extra)

    return build(jdp, {}), build(tdp, port_kw or {}, device="cpu")


def _np(b):
    return b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)


@pytest.mark.parametrize("mode", ["sync", "prefetch", "prefetch_staged"])
def test_stream_over_two_epochs_matches_reference(mode, tmp_path):
    """A synchronous reference pipe against the port's, synchronous,
    prefetched, and prefetched with staging onto the CPU: the same
    batches, in the same order, across the epoch boundary (the ragged
    tail dropped), and the same DataState after every batch."""
    src = _source("file", tmp_path)
    port_kw = {"sync": {}, "prefetch": {"prefetch": True},
               "prefetch_staged": {"prefetch": True,
                                   "stage_to_device": True}}[mode]
    j, t = _pipes(src, port_kw=port_kw)
    n = len(j.dataset)
    steps = 2 * (n // ROWS) + 2
    try:
        for _ in range(steps):
            jb, jplaced = j.next_global_batch()
            tb, tplaced = t.next_global_batch()
            assert tplaced == (mode == "prefetch_staged") and not jplaced
            if tplaced:
                assert isinstance(tb, torch.Tensor) and tb.device.type == \
                    "cpu"
            assert np.array_equal(_np(tb), jb)
            assert t.state_dict() == j.state_dict()
        assert t.state.epoch == 2
    finally:
        t.close()
        j.close()


def test_packed_stream_matches_reference():
    """Ragged documents packed with an EOS separator: the tokens and the
    segment ids of every batch, and the cursor and tail offset."""
    rs = np.random.RandomState(5)
    docs = [rs.randint(1, 90, rs.randint(1, 50)).astype(np.int32)
            for _ in range(60)]
    kw = dict(pack_sequences=True, eos_id=96, curriculum=None)
    j = jdp.build_datapipe(jdp.DataPipeConfig.from_dict(_block(**kw)),
                           dataset=docs, global_rows=3)
    t = tdp.build_datapipe(tdp.DataPipeConfig.from_dict(_block(**kw)),
                           dataset=docs, global_rows=3, device="cpu")
    for _ in range(40):
        jb, _ = j.next_global_batch()
        tb, _ = t.next_global_batch()
        for k in ("tokens", "segment_ids"):
            assert np.array_equal(tb[k], jb[k])
        assert t.state_dict() == j.state_dict()
    assert t.state.epoch >= 1


@pytest.mark.parametrize("prefetch", [False, True])
def test_mid_epoch_restore_gives_the_same_next_batches(prefetch, tmp_path):
    src = _source("shards", tmp_path)
    _, a = _pipes(src, port_kw={"prefetch": prefetch})
    for _ in range(5):
        a.next_global_batch()
    sd = a.state_dict()
    want = [_np(a.next_global_batch()[0]) for _ in range(6)]
    _, b = _pipes(src, port_kw={"prefetch": prefetch})
    b.next_global_batch()  # staged batches predate the restore
    b.load_state_dict(sd)
    got = [_np(b.next_global_batch()[0]) for _ in range(6)]
    assert all(np.array_equal(x, y) for x, y in zip(got, want))
    assert b.state_dict() == a.state_dict()
    a.close()
    b.close()


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_state_saved_by_either_package_resumes_in_the_other(direction,
                                                            tmp_path):
    src = _source("file", tmp_path)
    j, t = _pipes(src)
    first, second = (j, t) if direction == "jax_to_torch" else (t, j)
    for _ in range(7):
        first.next_global_batch()
    second.load_state_dict(first.state_dict())
    for _ in range(5):
        assert np.array_equal(_np(first.next_global_batch()[0]),
                              _np(second.next_global_batch()[0]))
    assert first.state_dict() == second.state_dict()


def _warnings(monkeypatch, module):
    """The messages ``module``'s logger warns, recorded."""
    said = []
    monkeypatch.setattr(module.logger, "warning",
                        lambda msg, *a: said.append(msg % a))
    return said


def test_changed_seed_on_restore_warns_and_keeps_the_checkpoints_stream(
        tmp_path, monkeypatch):
    from deeperspeed_tpu_torch.datapipe import pipeline

    said = _warnings(monkeypatch, pipeline)
    src = _source("file", tmp_path)
    _, a = _pipes(src)
    a.next_global_batch()
    sd = a.state_dict()
    want = _np(a.next_global_batch()[0])
    _, b = _pipes(src, port_kw={"seed": 8})
    b.load_state_dict(dict(sd, fingerprint="0" * 16))
    assert any("does not match this dataset/seed" in m for m in said)
    assert np.array_equal(_np(b.next_global_batch()[0]), want)


def test_seed_step_aligns_the_curriculum(tmp_path):
    src = _source("file", tmp_path)
    j, t = _pipes(src)
    j.seed_step(4)
    t.seed_step(4)
    assert t.state_dict() == j.state_dict()
    assert np.array_equal(_np(t.next_global_batch()[0]),
                          j.next_global_batch()[0])


def test_pipe_errors_match_reference(tmp_path):
    src = _source("array", tmp_path)
    for mod, kw in ((jdp, {}), (tdp, {"device": "cpu"})):
        cfg = mod.DataPipeConfig.from_dict(_block())
        with pytest.raises(ValueError, match="exceeds the dataset"):
            mod.build_datapipe(cfg, dataset=mod.TokenShardDataset(src, SEQ),
                               global_rows=10**6, **kw)
        with pytest.raises(ValueError, match="needs a \"source\""):
            mod.build_datapipe(cfg, global_rows=2, **kw)
        with pytest.raises(ValueError, match="global_rows"):
            mod.build_datapipe(cfg, dataset=mod.TokenShardDataset(src, SEQ),
                               global_rows=0, **kw)


def test_producer_error_reaches_the_step_loop(tmp_path):
    class Broken:
        def __len__(self):
            return 100

        def __getitem__(self, i):
            raise OSError("disk gone")

    t = tdp.build_datapipe(
        tdp.DataPipeConfig.from_dict(_block(prefetch=True, curriculum=None)),
        dataset=Broken(), global_rows=2, device="cpu")
    with pytest.raises(OSError, match="disk gone"):
        t.next_global_batch()
    t.close()


def test_staging_needs_a_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: staging targets it")
    cfg = tdp.DataPipeConfig.from_dict(_block(stage_to_device=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdp.build_datapipe(cfg, dataset=_corpus().reshape(-1, 20),
                           global_rows=2)


def test_metrics_go_to_the_monitor_under_the_reference_names(tmp_path):
    from deeperspeed_tpu_torch import monitor as tmon
    from deeperspeed_tpu_torch.monitor.config import MonitorConfig

    mon = tmon.init_monitor(MonitorConfig.from_dict({}))
    try:
        _, t = _pipes(_source("array", tmp_path),
                      port_kw={"prefetch": True})
        for _ in range(3):
            t.next_global_batch()
        snap = mon.registry.snapshot_scalars()
        assert snap["datapipe_batches_total"] == 3
        for name in ("datapipe_host_stall_seconds", "datapipe_queue_depth",
                     "datapipe_epoch"):
            assert name in snap, sorted(snap)
        text = mon.registry.render()
        assert "datapipe_host_stall_seconds_hist_bucket" in text
        t.close()
    finally:
        tmon.shutdown_monitor(save=False)


@pytest.mark.cuda
def test_staged_batches_on_the_card_equal_the_host_batches():
    """The producer thread's copies on the pipe's stream, after the
    consumer's wait, hold the host pipe's tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    data = _corpus(20000).astype(np.int32)
    mk = lambda **kw: tdp.build_datapipe(  # noqa: E731
        tdp.DataPipeConfig.from_dict(_block(**kw)),
        dataset=tdp.TokenShardDataset(data, SEQ), global_rows=64)
    host, card = mk(), mk(prefetch=True, stage_to_device=True)
    for _ in range(20):
        want = host.next_global_batch()[0]
        got, placed = card.next_global_batch()
        assert placed and got.is_cuda
        assert np.array_equal(got.cpu().numpy(), want)
    card.close()
