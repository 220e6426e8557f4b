"""The port's resilience/ against the reference's.

The background writer runs jobs in order, surfaces a writer-thread error
on the training thread and applies backpressure; an engine save through
the ``ResilienceManager`` commits with a manifest (async and sync); a
corrupt ``latest`` falls back to the older tag and the counter and the
``resilience/corrupt_tag`` instant fire; interval autosaves and
``keep_last`` prune, never dropping the resumed or the newest tag; a
SIGTERM exits with the sentinel after an urgent save. The ``Supervisor``
of both packages takes the same decisions on the same scripted exit codes
(backoff, crash cap, resume env, largest admissible world, restart log).
A CPU child SIGKILLed mid-save resumes bit for bit, and the tags each
package commits pass the other's manifest check and valid-tag discovery.

The port's engines run a linear model on the CPU in fp32; the reference's
engines (for the cross-package tags) run on its CPU test mesh."""

import json
import os
import signal
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeperspeed_tpu
import deeperspeed_tpu_torch
from deeperspeed_tpu import resilience as jres
from deeperspeed_tpu_torch import resilience as pres
from deeperspeed_tpu_torch.checkpoint.serialization import read_latest
from deeperspeed_tpu_torch.monitor import (get_monitor, init_monitor,
                                           shutdown_monitor)
from deeperspeed_tpu_torch.resilience.manager import ResilienceManager

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _reset_global_managers():
    """Engines with a resilience block install a process-global manager
    (signal handlers + writer thread); tear both packages' down."""
    yield
    pres.shutdown_resilience()
    jres.shutdown_resilience()


# --------------------------------------------------------------------- #
# the writer
# --------------------------------------------------------------------- #


def test_writer_runs_jobs_in_order_and_waits():
    w = pres.AsyncCheckpointWriter(max_pending=2)
    done = []
    for i in range(5):
        w.submit(lambda i=i: done.append(i))
    w.wait()
    assert done == [0, 1, 2, 3, 4]
    w.close()


def test_writer_propagates_errors_to_training_thread():
    w = pres.AsyncCheckpointWriter(max_pending=2)

    def boom():
        raise OSError("disk gone")

    w.submit(boom)
    with pytest.raises(pres.CheckpointWriteError, match="disk gone"):
        w.wait()
    out = []
    w.submit(lambda: out.append(1))
    w.wait()
    assert out == [1]
    w.close()
    with pytest.raises(pres.CheckpointWriteError):
        w.submit(lambda: None)


def test_writer_bounded_queue_backpressure():
    gate = threading.Event()
    w = pres.AsyncCheckpointWriter(max_pending=1)
    w.submit(gate.wait)  # occupies the worker
    w.submit(lambda: None)  # fills the one queue slot
    t = threading.Thread(target=lambda: w.submit(lambda: None))
    t.start()
    t.join(timeout=0.2)
    assert t.is_alive(), "third submit should block on the bounded queue"
    gate.set()
    t.join(timeout=10)
    assert not t.is_alive()
    w.wait()
    w.close()


@pytest.mark.parametrize("bad", [
    {"max_pending_saves": 0}, {"save_interval_steps": -1},
    {"keep_last": -1}, {"preemption_exit_code": 0},
    {"preemption_signals": ["SIGNOPE"]}, {"faults": 3}, {"bogus": 1},
])
def test_config_errors_match_the_reference(bad):
    with pytest.raises(ValueError) as pe:
        pres.ResilienceConfig.from_dict(bad)
    with pytest.raises(ValueError) as je:
        jres.ResilienceConfig.from_dict(bad)
    assert str(pe.value) == str(je.value)


def test_training_config_accepts_the_obs_config():
    from deeperspeed_tpu.runtime.config import TrainingConfig as JaxConfig
    from deeperspeed_tpu_torch.runtime.config import TrainingConfig

    path = os.path.join(REPO, "configs", "gpt_125m_obs.json")
    rc = TrainingConfig(path, world_size=1).resilience_config()
    assert vars(rc) == vars(JaxConfig(path, world_size=1)
                            .resilience_config())
    assert (rc.save_dir, rc.save_interval_steps, rc.async_save) == (
        "runs/ckpt", 500, True)


# --------------------------------------------------------------------- #
# engine integration
# --------------------------------------------------------------------- #


def _loss_fn(p, b):
    x, y = b
    return torch.mean((x @ p["w"] - y) ** 2)


def _engine(resilience=None, seed=0):
    cfg = {"train_batch_size": 8,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    if resilience is not None:
        cfg["resilience"] = resilience
    w = np.random.RandomState(100 + seed).randn(4, 2).astype(np.float32)
    engine, _, _, _ = deeperspeed_tpu_torch.initialize(
        model=_loss_fn, model_parameters={"w": w * 0.1}, config=cfg,
        device="cpu")
    return engine


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(8, 4).astype(np.float32),
            rs.randn(8, 2).astype(np.float32))


@pytest.mark.parametrize("async_save", [True, False])
def test_resilience_save_commits_with_manifest(tmp_path, async_save):
    engine = _engine(resilience={"async_save": async_save,
                                 "preemption_guard": False})
    engine.train_batch(_batch())
    engine.save_checkpoint(str(tmp_path))
    engine._resilience.wait_for_pending_saves()
    tag_dir = tmp_path / "global_step1"
    assert pres.is_committed(str(tag_dir))
    ok, problems = pres.verify_manifest(str(tag_dir))
    assert ok, problems
    assert not os.path.exists(str(tag_dir) + ".tmp")
    assert read_latest(str(tmp_path)) == "global_step1"
    engine2 = _engine(seed=1)
    path, _ = engine2.load_checkpoint(str(tmp_path))
    assert path is not None
    assert torch.equal(engine2.params["w"], engine.params["w"])


def test_corrupt_latest_falls_back_with_counter_and_instant(tmp_path):
    init_monitor({})
    try:
        engine = _engine(resilience={"async_save": False,
                                     "preemption_guard": False})
        engine.train_batch(_batch(0))
        engine.save_checkpoint(str(tmp_path))
        w_step1 = engine.params["w"].detach().clone()
        engine.train_batch(_batch(1))
        engine.save_checkpoint(str(tmp_path))
        pres.corrupt_file(str(tmp_path / "global_step2"
                              / "mp_rank_00_model_states.msgpack"),
                          "bitflip")
        fresh = _engine(seed=1)
        path, _ = fresh.load_checkpoint(str(tmp_path))
        assert path is not None and path.endswith("global_step1")
        assert fresh.global_steps == 1
        assert torch.equal(fresh.params["w"], w_step1)
        mon = get_monitor()
        reg = mon.registry
        assert reg.counter("resilience_corrupt_tags").value == 1
        assert reg.counter("resilience_fallback_total").value == 1
        assert reg.counter("resilience_resume_total").value == 1
        instants = [e for e in mon.tracer.events()
                    if e.get("name") == "resilience/corrupt_tag"]
        assert instants and instants[0]["args"]["tag"] == "global_step2"
    finally:
        shutdown_monitor(save=False)


def test_interval_autosave_and_keep_last(tmp_path):
    engine = _engine(resilience={"save_dir": str(tmp_path),
                                 "save_interval_steps": 1, "keep_last": 2,
                                 "async_save": False,
                                 "preemption_guard": False})
    for i in range(4):
        engine.train_batch(_batch(i))
    tags = sorted(p.name for p in tmp_path.iterdir() if p.is_dir())
    assert tags == ["global_step3", "global_step4"]
    assert all(pres.is_committed(str(tmp_path / t)) for t in tags)


def test_prune_never_drops_resumed_or_newest_tag(tmp_path):
    engine = _engine(resilience={"async_save": False,
                                 "preemption_guard": False, "keep_last": 1})
    for i in range(3):
        engine.train_batch(_batch(i))
        engine.save_checkpoint(str(tmp_path))
    tags = sorted(p.name for p in tmp_path.iterdir() if p.is_dir())
    assert tags == ["global_step3"]
    pres.shutdown_resilience()
    fresh = _engine(resilience={"async_save": False,
                                "preemption_guard": False, "keep_last": 1},
                    seed=1)
    path, _ = fresh.load_checkpoint(str(tmp_path))
    assert path is not None and path.endswith("global_step3")
    for i in range(3, 5):
        fresh.train_batch(_batch(i))
        fresh.save_checkpoint(str(tmp_path))
    tags = sorted(p.name for p in tmp_path.iterdir() if p.is_dir())
    assert "global_step3" in tags, "resumed-from tag was pruned mid-run"
    assert "global_step5" in tags, "newest committed tag was pruned"


def test_preemption_exits_with_sentinel_after_urgent_save(tmp_path):
    init_monitor({})
    try:
        engine = _engine(resilience={"save_dir": str(tmp_path),
                                     "async_save": True})
        engine.train_batch(_batch(0))
        signal.raise_signal(signal.SIGTERM)
        with pytest.raises(SystemExit) as exc:
            engine.train_batch(_batch(1))
        assert exc.value.code == 86
        tag_dir = tmp_path / "global_step2"
        assert pres.is_committed(str(tag_dir))
        ok, problems = pres.verify_manifest(str(tag_dir))
        assert ok, problems
        mon = get_monitor()
        assert mon.registry.counter(
            "resilience_preemption_total").value == 1
        assert [e["name"] for e in mon.tracer.events()
                if e.get("name") == "run/preempt"] == ["run/preempt"]
    finally:
        shutdown_monitor(save=False)
        pres.shutdown_resilience()
    fresh = _engine(seed=1)
    path, _ = fresh.load_checkpoint(str(tmp_path))
    assert path is not None and fresh.global_steps == 2


def test_restart_context_counter(monkeypatch):
    monkeypatch.setenv("DS_TPU_RESTART_COUNT", "2")
    monkeypatch.setenv("DS_TPU_RESTART_REASON", "preemption")
    monkeypatch.setenv("DS_TPU_WORLD_SIZE", "4")
    init_monitor({})
    try:
        mgr = ResilienceManager(pres.ResilienceConfig.from_dict(
            {"async_save": False, "preemption_guard": False}))
        mgr.note_restart_context()
        mgr.note_restart_context()  # once per process
        mon = get_monitor()
        assert mon.registry.counter("resilience_restarts").value == 1
        instants = [e for e in mon.tracer.events()
                    if e.get("name") == "resilience/restart"]
        assert len(instants) == 1
        assert instants[0]["args"] == {
            "count": 2, "reason": "preemption", "world_size": 4}
        mgr.close()
    finally:
        shutdown_monitor(save=False)


def test_serving_engine_attaches_for_the_drain():
    from deeperspeed_tpu_torch.models import gpt
    from deeperspeed_tpu_torch.serving import ServingConfig, ServingEngine

    mgr = pres.init_resilience({"async_save": False,
                                "preemption_guard": False})
    cfg = gpt.GPTConfig(vocab_size=64, n_layer=1, n_head=2, d_model=32,
                        max_seq=32, dtype=torch.float32)
    eng = ServingEngine(cfg, gpt.init_params(0, cfg, device="cpu"),
                        ServingConfig(num_slots=2, block_size=8,
                                      max_seq_len=32, num_blocks=8),
                        device="cpu")
    assert mgr.serving == [eng]


# --------------------------------------------------------------------- #
# the supervisor: the reference's decisions on the same exit codes
# --------------------------------------------------------------------- #


def _supervise(pkg, rcs, tmp, **policy):
    """Run ``pkg``'s Supervisor on scripted exit codes; returns what it
    decided: result, sleeps, counters, history, the env of each launch
    and the restart log."""
    log = os.path.join(tmp, f"{pkg.__name__}.jsonl")
    codes = iter(rcs)
    envs, sleeps = [], []

    def fake_run(cmd, env):
        envs.append({k: env.get(k) for k in (
            "DS_TPU_RESUME_TAG", "DS_TPU_RESUME_DIR", "DS_TPU_RESTART_COUNT",
            "DS_TPU_RESTART_REASON", "DS_TPU_WORLD_SIZE",
            "DS_TPU_ELASTIC_WORLD_SIZES", "DS_TPU_INCARNATION")})
        return next(codes)

    sup = pkg.Supervisor(["trainer"],
                         pkg.SupervisorPolicy(restart_log=log, **policy),
                         run_fn=fake_run, sleep_fn=sleeps.append)
    rc = sup.run()
    with open(log) as f:
        events = [{k: v for k, v in json.loads(line).items()
                   if k not in ("ts", "run_id")} for line in f]
    return dict(rc=rc, sleeps=sleeps, crashes=sup.crashes,
                restarts=sup.restarts, history=sup.history, envs=envs,
                world=sup.world_history, events=events)


_ELASTIC_CFG = {"elasticity": {
    "enabled": True, "max_train_batch_size": 64, "micro_batch_sizes": [4],
    "min_gpus": 4, "max_gpus": 16, "version": 0.1,
    "ignore_non_elastic_batch_info": True}}


@pytest.mark.parametrize("rcs,policy", [
    ([1, 1, 86, 0], dict(max_restarts=5, backoff_base=1.0)),
    ([7, 7, 7], dict(max_restarts=2, backoff_base=0.5)),
    ([86, 86, 3, 0], dict(max_restarts=1, backoff_base=2.0,
                          backoff_max=3.0)),
    ([-9, 86, 0], dict(max_restarts=3, backoff_base=0.25,
                       backoff_factor=3.0)),
    ([0], dict()),
])
def test_supervisor_decisions_match_the_reference(tmp_path, rcs, policy):
    ckpt = tmp_path / "ckpt"
    d = ckpt / "global_step4"
    d.mkdir(parents=True)
    (d / "mp_rank_00_model_states.msgpack").write_bytes(b"z" * 32)
    pres.write_manifest(str(d))
    (d / pres.COMMITTED_MARKER).write_text("ok\n")
    cfg = tmp_path / "ds.json"
    cfg.write_text(json.dumps(_ELASTIC_CFG))
    pool = tmp_path / "pool"
    pool.write_text("6\n")
    kw = dict(policy, checkpoint_dir=str(ckpt), elastic_config=str(cfg),
              pool_file=str(pool))
    os.environ.pop("DS_TPU_INCARNATION", None)
    port = _supervise(pres, rcs, str(tmp_path), **kw)
    ref = _supervise(jres, rcs, str(tmp_path), **kw)
    assert port == ref
    assert port["envs"][0]["DS_TPU_RESUME_TAG"] == "global_step4"
    assert port["world"][0] == 4  # the largest admissible size <= 6


@pytest.mark.parametrize("pool_n,want", [(8, 8), (6, 4), (16, 16),
                                         (100, 16), (3, None)])
def test_supervisor_picks_largest_admissible_world(tmp_path, pool_n, want):
    cfg = tmp_path / "ds.json"
    cfg.write_text(json.dumps(_ELASTIC_CFG))
    pool = tmp_path / "pool"
    pool.write_text(f"{pool_n}\n")
    got = {}
    for pkg in (pres, jres):
        sup = pkg.Supervisor(["trainer"], pkg.SupervisorPolicy(
            elastic_config=str(cfg), pool_file=str(pool)),
            run_fn=lambda cmd, env: 0)
        sup.run()
        got[pkg.__name__] = sup.world_history
    assert got["deeperspeed_tpu_torch.resilience"] == [want]
    assert got["deeperspeed_tpu.resilience"] == [want]


def test_supervisor_cli_parses_as_the_reference_less_the_cpu_drill():
    from deeperspeed_tpu.resilience import supervisor as jsup
    from deeperspeed_tpu_torch.resilience import supervisor as psup

    argv = ["--checkpoint-dir", "/c", "--max-restarts", "3",
            "--backoff-base", "0.5", "--restart-log", "r.jsonl", "--",
            "python", "train.py"]
    pa, ja = psup.build_parser().parse_args(argv), \
        jsup.build_parser().parse_args(argv)
    assert {k: v for k, v in vars(ja).items()
            if k != "simulate_cpu_devices"} == vars(pa)


# --------------------------------------------------------------------- #
# end to end: SIGKILL mid-save, then a bit-identical resume
# --------------------------------------------------------------------- #

_TRAINER = """\
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import deeperspeed_tpu_torch as deepspeed
from deeperspeed_tpu_torch.resilience import shutdown_resilience

ckpt_dir, steps = sys.argv[1], int(sys.argv[2])

def loss_fn(p, b):
    x, y = b
    return torch.mean((x @ p["w"] - y) ** 2)

cfg = {
    "train_batch_size": 8,
    "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
    "resilience": {"save_dir": ckpt_dir, "save_interval_steps": 2,
                   "async_save": True, "preemption_guard": False},
}
params = {"w": np.zeros((4, 2), np.float32)}
engine, _, _, _ = deepspeed.initialize(
    model=loss_fn, model_parameters=params, config=cfg, device="cpu")
path, _ = engine.load_checkpoint(ckpt_dir)
start = engine.global_steps if path is not None else 0
for i in range(start, steps):
    rs = np.random.RandomState(i)
    b = (rs.randn(8, 4).astype(np.float32), rs.randn(8, 2).astype(np.float32))
    loss = engine.train_batch(b)
    print(f"STEP {i} LOSS {float(loss).hex()}", flush=True)
shutdown_resilience()
"""


def _run_trainer(script, ckpt_dir, steps, faults=None):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("DS_TPU_FAULTS", None)
    if faults is not None:
        env["DS_TPU_FAULTS"] = faults
    return subprocess.run([sys.executable, script, ckpt_dir, str(steps)],
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _losses(stdout):
    out = {}
    for line in stdout.splitlines():
        if line.startswith("STEP "):
            _, i, _, loss = line.split()
            out[int(i)] = loss
    return out


def test_sigkill_mid_save_then_resume_bit_identical(tmp_path):
    script = str(tmp_path / "trainer.py")
    with open(script, "w") as f:
        f.write(_TRAINER)
    ref = _run_trainer(script, str(tmp_path / "ref"), 6)
    assert ref.returncode == 0, ref.stderr[-2000:]
    ref_losses = _losses(ref.stdout)
    assert sorted(ref_losses) == list(range(6))
    # two payload files a tag: the 3rd file of the process is the first
    # of global_step4, written after global_step2 committed
    ckpt = str(tmp_path / "ckpt")
    killed = _run_trainer(script, ckpt, 6, faults='{"sigkill_mid_save": 3}')
    assert killed.returncode == -signal.SIGKILL, (
        killed.returncode, killed.stdout, killed.stderr[-2000:])
    assert read_latest(ckpt) == "global_step2"
    ok, problems = pres.verify_manifest(os.path.join(ckpt, "global_step2"))
    assert ok, problems
    assert pres.tag_status(os.path.join(ckpt, "global_step4")) != \
        "committed"
    assert pres.find_latest_valid_tag(ckpt) == "global_step2"
    resumed = _run_trainer(script, ckpt, 6)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    res_losses = _losses(resumed.stdout)
    assert sorted(res_losses) == [2, 3, 4, 5]
    for i in range(2, 6):
        assert res_losses[i] == ref_losses[i], i


# --------------------------------------------------------------------- #
# cross-package tags
# --------------------------------------------------------------------- #


def _jax_engine(save_dir):
    cfg = {"train_batch_size": 8,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "resilience": {"save_dir": save_dir, "async_save": True,
                          "preemption_guard": False}}

    def loss_fn(p, b):
        x, y = b
        return jnp.mean((x @ p["w"] - y) ** 2)

    params = {"w": jnp.asarray(np.random.RandomState(100).randn(4, 2)
                               .astype(np.float32) * 0.1)}
    engine, _, _, _ = deeperspeed_tpu.initialize(
        model=loss_fn, model_parameters=params, config_params=cfg)
    return engine


def test_tags_are_cross_readable_between_the_packages(tmp_path):
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    pe = _engine(resilience={"save_dir": port_dir, "async_save": True,
                             "preemption_guard": False})
    pe.train_batch(_batch(0))
    pe.save_checkpoint(port_dir)
    pe._resilience.wait_for_pending_saves()
    pres.shutdown_resilience()
    je = _jax_engine(ref_dir)
    je.train_batch(batch=tuple(jnp.asarray(a) for a in _batch(0)))
    je.save_checkpoint(ref_dir)
    je._resilience.wait_for_pending_saves()
    jres.shutdown_resilience()
    for d in (port_dir, ref_dir):
        tag = os.path.join(d, "global_step1")
        for pkg in (pres, jres):
            ok, problems = pkg.verify_manifest(tag)
            assert ok, (d, pkg.__name__, problems)
            assert pkg.tag_status(tag) == "committed"
            assert pkg.find_latest_valid_tag(d) == "global_step1"
    # the port's engine resumes the reference's committed tag
    fresh = _engine(seed=1)
    path, _ = fresh.load_checkpoint(ref_dir)
    assert path is not None and fresh.global_steps == 1
    np.testing.assert_allclose(fresh.params["w"].detach().numpy(),
                               np.asarray(je.state.params["w"]), rtol=1e-6)
