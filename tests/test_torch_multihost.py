"""The port's multi-process runtime (distributed/, utils/distributed.py)
against the reference's.

``DistributedConfig`` takes the reference's defaults and raises its
errors (plus the port's one departure, ``local_devices`` above 1);
``discover`` reads the launcher, torchrun and OpenMPI environments in the
reference's precedence; rendezvous records and clock offsets round-trip
and each package reads the other's files; ``classify_exit``,
``FleetPolicy`` and the pool-change (growth) predicate decide as the
reference's; ``bootstrap`` joins a 2-process gloo group through a
``TCPStore`` (adopting an existing group on a second call) and gives up
after ``init_retries`` attempts. One ``FleetSupervisor`` run on the CPU:
two gloo trainer processes of a tiny GPT under the canonical-slot int8
reduction; host 1 is SIGKILLed after step 3, the fleet is torn down and
relaunched from the step-2 tag, then the pool file shrinks to 1 and the
fleet re-meshes to one process, which finishes step 7; every step's loss
equals the world-1 run's bit for bit."""

import json
import os
import signal
import sys
import threading
import time

import pytest
import torch

from deeperspeed_tpu.distributed import fleet as jfleet
from deeperspeed_tpu.distributed import rendezvous as jrdzv
from deeperspeed_tpu.distributed.config import \
    DistributedConfig as JaxDistributedConfig
from deeperspeed_tpu.utils import distributed as jud
from deeperspeed_tpu_torch.distributed import bootstrap
from deeperspeed_tpu_torch.distributed import fleet as pfleet
from deeperspeed_tpu_torch.distributed import rendezvous as prdzv
from deeperspeed_tpu_torch.distributed.config import DistributedConfig
from deeperspeed_tpu_torch.utils import distributed as pud
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ENV_KEYS = ("DS_COORDINATOR_ADDRESS", "DS_NUM_PROCESSES", "DS_PROCESS_ID",
             "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
             "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
             "OMPI_COMM_WORLD_LOCAL_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK",
             "AZUREML_EXPERIMENT_ID", "AZ_BATCH_MASTER_NODE",
             "LOCAL_RANK", "LOCAL_WORLD_SIZE")


# --------------------------------------------------------------------- #
# the config block
# --------------------------------------------------------------------- #


def _outcome(cls, **kw):
    try:
        return ("ok", vars(cls(**kw)))
    except ValueError as e:
        return ("err", str(e))


@pytest.mark.parametrize("kw", [
    {}, {"coordinator_address": "10.0.0.1"},
    {"num_processes": 2}, {"process_id": 0},
    {"coordinator_address": "127.0.0.1:9999", "num_processes": 2,
     "process_id": 1},
    {"coordinator_address": "h:1", "num_processes": 2, "process_id": 2},
    {"cpu_collectives": "nccl"}, {"cpu_collectives": "gloo"},
    {"init_timeout_s": 0}, {"heartbeat_timeout_s": -1},
    {"init_retries": 0}, {"retry_backoff_s": -1.0},
    {"local_devices": 0}, {"local_devices": 1},
])
def test_distributed_config_matches_the_reference(kw):
    assert _outcome(DistributedConfig, **kw) == \
        _outcome(JaxDistributedConfig, **kw)


def test_distributed_config_unknown_key_and_local_devices():
    for cls in (DistributedConfig, JaxDistributedConfig):
        with pytest.raises(ValueError, match="unknown"):
            cls.from_dict({"enabled": True, "cordinator": "x:1"})
    # the one departure: simulated CPU devices have no torch counterpart
    with pytest.raises(ValueError, match="package is one rank"):
        DistributedConfig(local_devices=2)
    with pytest.raises(ValueError, match="PyTorch counterpart"):
        DistributedConfig(local_devices=4)
    JaxDistributedConfig(local_devices=2)


def test_training_config_distributed_block():
    from deeperspeed_tpu_torch.runtime.config import (ConfigError,
                                                      TrainingConfig)

    cfg = TrainingConfig({"train_batch_size": 8,
                          "distributed": {"cpu_collectives": "gloo"}})
    assert cfg.distributed_enabled
    assert cfg.distributed_config().cpu_collectives == "gloo"
    cfg = TrainingConfig({"train_batch_size": 8,
                          "distributed": {"enabled": False}})
    assert cfg.distributed_config() is None
    with pytest.raises(ConfigError, match="distributed"):
        TrainingConfig({"train_batch_size": 8,
                        "distributed": {"cordinator_address": "x:1"}})
    # the shipped multihost config is accepted as written
    tc = TrainingConfig(os.path.join(REPO, "configs",
                                     "gpt_125m_multihost.json"),
                        world_size=2)
    assert tc.elastic_canonical_shards == 32 and tc.comm_config().mode == \
        "int8"
    assert tc.resilience_config().preemption_guard


# --------------------------------------------------------------------- #
# discovery
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("env", [
    {"DS_COORDINATOR_ADDRESS": "1.2.3.4:29500", "DS_NUM_PROCESSES": "4",
     "DS_PROCESS_ID": "2", "MASTER_ADDR": "5.6.7.8", "WORLD_SIZE": "2",
     "RANK": "1"},
    {"MASTER_ADDR": "5.6.7.8", "MASTER_PORT": "1234", "WORLD_SIZE": "2",
     "RANK": "1", "OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_RANK": "3"},
    {"MASTER_ADDR": "5.6.7.8", "WORLD_SIZE": "2", "RANK": "1"},
    {"OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_RANK": "3"},
    {"AZUREML_EXPERIMENT_ID": "x", "AZ_BATCH_MASTER_NODE": "9.9.9.9:6000",
     "OMPI_COMM_WORLD_SIZE": "4", "OMPI_COMM_WORLD_RANK": "1"},
    {},
])
def test_discover_reads_the_env_chain_in_the_reference_order(monkeypatch,
                                                             env):
    got = []
    for mod in (pud, jud):
        for k in _ENV_KEYS:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got.append(mod.discover())
    assert got[0] == got[1]
    for k in _ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert pud.init_distributed() is False  # single-process fallback


# --------------------------------------------------------------------- #
# rendezvous records, both ways
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("writer,reader", [(prdzv, jrdzv), (jrdzv, prdzv),
                                           (prdzv, prdzv)])
def test_host_records_round_trip_across_packages(tmp_path, writer, reader):
    rec = writer.HostRecord(host=1, pid=4242, incarnation=2, epoch=3,
                            role="trainer.h1", status="ready",
                            clock={"wall": 12.0, "perf": 1.0})
    writer.write_record(str(tmp_path), rec)
    writer.write_record(str(tmp_path), writer.HostRecord(host=0, epoch=3,
                                                         status="ready"))
    (tmp_path / "host9.json").write_text("{torn")
    back = reader.read_record(str(tmp_path), 1)
    assert (back.host, back.status, back.role, back.epoch, back.pid) == (
        1, "ready", "trainer.h1", 3, 4242)
    assert back.clock == {"wall": 12.0, "perf": 1.0} and back.wall > 0
    assert [r.host for r in reader.read_records(str(tmp_path))] == [0, 1]
    assert [r.host for r in reader.wait_all_ready(
        str(tmp_path), hosts=2, epoch=3, timeout_s=5.0)] == [0, 1]
    with pytest.raises(TimeoutError, match="missing"):
        reader.wait_all_ready(str(tmp_path), hosts=3, epoch=3,
                              timeout_s=0.1, poll_s=0.02)
    writer.write_offsets(str(tmp_path), {"trainer.h0": 0.0,
                                         "trainer.h1": 0.25})
    assert reader.read_offsets(str(tmp_path)) == {"trainer.h0": 0.0,
                                                  "trainer.h1": 0.25}
    with pytest.raises(ValueError, match="status"):
        prdzv.HostRecord(host=0, status="zombie")


# --------------------------------------------------------------------- #
# fleet supervisor pieces
# --------------------------------------------------------------------- #


def test_classify_exit_and_policy_match_the_reference():
    for code in (0, 86, 1, -9, 137, 3):
        for sentinel in (86, 3):
            assert pfleet.classify_exit(code, sentinel) == \
                jfleet.classify_exit(code, sentinel)
    p, j = vars(pfleet.FleetPolicy()), vars(jfleet.FleetPolicy())
    j.pop("simulate_cpu_devices")
    assert p == j
    assert 0 < pfleet.free_port() < 65536
    with pytest.raises(ValueError, match="one rank"):
        pfleet.FleetSupervisor(["x"], pfleet.FleetPolicy(local_devices=2))


def test_pool_change_growth_predicate_matches_the_reference(tmp_path):
    """The fleet's debounced pool-file watch (a changed process count
    that held still for pool_debounce_s is a planned re-mesh) decides as
    the reference's on the same writes."""
    pool = tmp_path / "pool"
    pool.write_text("2\n")
    sups = [mod.FleetSupervisor(["x"], mod.FleetPolicy(
        procs=2, pool_file=str(pool), watch_pool=True,
        pool_debounce_s=0.3)) for mod in (pfleet, jfleet)]
    script = [None, "3", None, "sleep", None, "2", "sleep", None, "5",
              "0", "sleep", None]
    seen = [[], []]
    for action in script:
        if action == "sleep":
            time.sleep(0.5)
            continue
        if action is not None:
            time.sleep(0.01)  # a fresh mtime
            pool.write_text(action + "\n")
        for s, out in zip(sups, seen):
            out.append(s._poll_pool_change())
    assert seen[0] == seen[1]
    assert 3 in seen[0]


def test_bootstrap_gives_up_after_init_retries(monkeypatch):
    """A coordinator nobody serves: every attempt fails, the policy backs
    off ``retry_backoff_s * 2^(k-1)`` between them and raises after
    ``init_retries``; nothing falls back to a world of one."""
    sleeps = []
    monkeypatch.setattr(bootstrap.time, "sleep", sleeps.append)
    port = pfleet.free_port()
    cfg = DistributedConfig(coordinator_address=f"127.0.0.1:{port}",
                            num_processes=2, process_id=1,
                            init_timeout_s=0.5, init_retries=3,
                            retry_backoff_s=0.25)
    with pytest.raises(RuntimeError, match="after 3 attempt"):
        bootstrap.bootstrap(cfg)
    assert sleeps == [0.25, 0.5]
    assert bootstrap.current_topology() is None
    assert not torch.distributed.is_initialized()


def test_bootstrap_joins_two_gloo_processes(tmp_path):
    port = pfleet.free_port()
    worker.spawn_tcp("bootstrap_run", 2, tmp_path, port)
    recs = {r.host: r for r in prdzv.read_records(str(tmp_path / "rdzv"))}
    assert sorted(recs) == [0, 1]
    assert all(r.status == "ready" and r.role == f"trainer.h{h}"
               for h, r in recs.items())
    for r in range(2):
        out = json.loads((tmp_path / f"boot{r}.json").read_text())
        assert out["topology"] == {"process": r, "processes": 2,
                                   "local_devices": 1, "global_devices": 2}
        assert out["backend"] == "gloo" and out["again_same"]
        assert out["sum"] == 3.0 and out["dist_init_spans"] == 1


# --------------------------------------------------------------------- #
# the fleet: crash, restart barrier, planned re-mesh (CPU, gloo)
# --------------------------------------------------------------------- #

_TRAINER = r'''
import json, os, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
import deeperspeed_tpu_torch as ds
from deeperspeed_tpu_torch.models import gpt

work = sys.argv[1]
cfg = json.load(open(os.path.join(work, "config.json")))
kw = json.load(open(os.path.join(work, "model.json")))
mcfg = gpt.GPTConfig(**kw, dtype=torch.float32, attn_impl="xla")
params = torch.load(os.path.join(work, "params.pt"))
eng, _, _, _ = ds.initialize(model=gpt.make_gpt(mcfg)[2],
                             model_parameters=params, config=cfg,
                             device="cpu")
if os.environ.get("DS_TPU_RESUME_DIR"):
    eng.load_checkpoint(os.environ["DS_TPU_RESUME_DIR"])
mgr = eng._resilience
rank = torch.distributed.get_rank() if torch.distributed.is_initialized() \
    else 0
log = open(os.path.join(work, f"steps.h{rank}.e{os.environ['DS_TPU_FLEET_EPOCH']}"), "a")
while eng.global_steps < 7:
    # hold at the step the control file allows; a SIGTERM there takes
    # the preemption protocol (urgent save, sentinel exit)
    while eng.global_steps >= int(open(os.path.join(work, "allow")).read()):
        if mgr.guard.requested:
            mgr.handle_preemption(eng)
        time.sleep(0.02)
    s = eng.global_steps
    b = np.random.RandomState(1000 + s).randint(0, kw["vocab_size"],
                                               (eng._config.train_batch_size,
                                                kw["max_seq"] + 1))
    loss = eng.train_batch(b)
    log.write(f"{eng.global_steps} {float(loss).hex()}\n")
    log.flush()
'''

NEOX = dict(vocab_size=97, n_layer=2, n_head=4, d_model=64, max_seq=16,
            rotary=True, parallel_residual=True)


def _fleet_config(ckpt):
    return {
        "distributed": {"enabled": True, "init_timeout_s": 60.0,
                        "heartbeat_timeout_s": 30.0, "init_retries": 3,
                        "retry_backoff_s": 0.5},
        "elasticity": {"enabled": True, "max_train_batch_size": 16,
                       "micro_batch_sizes": [2, 4], "min_gpus": 1,
                       "max_gpus": 4, "version": 0.1, "canonical_shards": 4},
        "zero_optimization": {"stage": 1},
        "optimizer": {"type": "Adam", "params": {"lr": 3e-3}},
        "gradient_clipping": 1.0,
        "comm": {"mode": "int8", "bucket_mb": 0.01, "block": 32,
                 "error_feedback": True},
        "resilience": {"save_dir": ckpt, "save_interval_steps": 2,
                       "async_save": False, "preemption_guard": True},
    }


def _steps(work, host, epoch):
    p = work / f"steps.h{host}.e{epoch}"
    if not p.exists():
        return {}
    return {int(a): b for a, b in (line.split() for line in
                                   p.read_text().splitlines())}


def _wait(pred, timeout=180.0, what=""):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(what)
        time.sleep(0.05)


def test_fleet_crash_restart_and_remesh_bit_identical(tmp_path):
    work = tmp_path
    ckpt = str(work / "ckpt")
    cfg = _fleet_config(ckpt)
    (work / "config.json").write_text(json.dumps(cfg))
    (work / "model.json").write_text(json.dumps(NEOX))
    tcfg = __import__("deeperspeed_tpu_torch.models.gpt",
                      fromlist=["gpt"]).GPTConfig(**NEOX,
                                                  dtype=torch.float32,
                                                  attn_impl="xla")
    from deeperspeed_tpu_torch.models import gpt

    torch.save(gpt.init_params(3, tcfg, device="cpu"),
               str(work / "params.pt"))
    (work / "trainer.py").write_text(_TRAINER)
    (work / "allow").write_text("3")
    (work / "pool").write_text("2\n")
    os.environ.pop("DS_TPU_RESUME_DIR", None)
    policy = pfleet.FleetPolicy(
        procs=2, checkpoint_dir=ckpt, rendezvous_dir=str(work / "rdzv"),
        restart_log=str(work / "restarts.jsonl"),
        pool_file=str(work / "pool"), watch_pool=True, backoff_base=0.2,
        pool_poll_interval_s=0.05, pool_debounce_s=0.2, term_grace_s=20.0,
        extra_env={"PYTHONPATH": REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   "OMP_NUM_THREADS": "1"})
    sup = pfleet.FleetSupervisor([sys.executable, str(work / "trainer.py"),
                                  str(work)], policy)
    result = {}
    th = threading.Thread(target=lambda: result.update(rc=sup.run()),
                          daemon=True)
    th.start()
    try:
        _wait(lambda: 3 in _steps(work, 1, 0) and 3 in _steps(work, 0, 0),
              what="epoch 0 step 3")
        os.kill(sup._children[1].pid, signal.SIGKILL)
        _wait(lambda: sup.epoch == 1, what="restart barrier")
        (work / "allow").write_text("5")
        _wait(lambda: 5 in _steps(work, 0, 1) and 5 in _steps(work, 1, 1),
              what="epoch 1 step 5")
        time.sleep(0.05)
        (work / "pool").write_text("1\n")
        _wait(lambda: sup.epoch == 2, what="planned re-mesh")
        (work / "allow").write_text("7")
        th.join(timeout=90)
    finally:
        for c in sup._children:
            if c.poll() is None:
                c.kill()
    assert result.get("rc") == 0, result
    assert sup.crashes == 1 and sup.remeshes == 1 and sup.procs == 1
    # the reference world: one process, no faults
    worker.elastic_run(0, 1, str(work), NEOX,
                       {k: v for k, v in cfg.items()
                        if k not in ("distributed", "resilience")},
                       7, None, None, "w1")
    ref = json.loads((work / "w1_rank0.json").read_text())["losses"]
    seen = {}
    for host, epoch in ((0, 0), (1, 0), (0, 1), (1, 1), (0, 2)):
        for step, loss in _steps(work, host, epoch).items():
            assert loss == ref[step - 1], (host, epoch, step)
            seen[step] = loss
    assert sorted(seen) == list(range(1, 8))
    assert sorted(_steps(work, 0, 1)) == [3, 4, 5]  # resumed from step 2
    assert sorted(_steps(work, 0, 2)) == [6, 7]     # resumed from step 5
    events = [json.loads(line) for line in
              (work / "restarts.jsonl").read_text().splitlines()]
    exits = [(e["epoch"], e.get("host"), e["reason"]) for e in events
             if e["event"] == "exit"]
    assert (0, 1, "crashed") in exits and (0, 0, "fleet_restart") in exits
    assert (1, 0, "pool_change") in exits and (1, 1, "pool_change") in exits
    assert [e["procs_to"] for e in events if e["event"] == "fleet_remesh"] \
        == [1]
    assert [e["reason"] for e in events if e["event"] == "launch"] == [
        "start", "crashed", "pool_change"]
    # host 0's last record is epoch 2's "launched": a world of one joins
    # no group, so its bootstrap writes no "ready" (as the reference's)
    recs = {r.host: r for r in prdzv.read_records(str(work / "rdzv"))}
    assert (recs[0].epoch, recs[0].status) == (2, "launched")
    assert (recs[1].epoch, recs[1].status, recs[1].reason) == (
        1, "exited", "pool_change")
    assert set(prdzv.read_offsets(str(work / "rdzv"))) == {"trainer.h0",
                                                           "trainer.h1"}
