"""The port's lifecycle control plane against the reference's.

lifecycle/ of deeperspeed_tpu_torch against deeperspeed_tpu's, on the
CPU in fp32, inputs from numpy seeds:

* ``LifecycleConfig`` defaults, validation and ``signal_number`` equal the
  reference's, and ``TrainingConfig`` accepts configs/gpt_125m_lifecycle.json
  with the reference's block;
* the ``VERSIONS.json`` each package writes is read back and extended by
  the other (the same bytes for the same records); ``live_tags`` and the
  resilience manager's prune protection agree;
* ``RemeshHook.choose_world`` agrees with the reference's over pool sizes
  0-10, and the hook's latch/debounce state machine is the reference's;
* a 2 -> 1 live re-mesh (two gloo processes, tests/torch_gloo_worker.py;
  int8 wire with error feedback, ZeRO 1, canonical_shards 4) gives
  per-step losses, grad norms and params bit-identical to the port's own
  uninterrupted world-1 run, the retired rank exiting 0, and losses within
  REMESH_RTOL of the reference's ``Engine.remesh`` on two CPU devices;
* a mixed-version thread fleet keeps failover pinned; version starvation
  repins with full regeneration; greedy tokens equal the reference
  ``ServingEngine``'s on the same weights, sampled ones the port's own
  plain engine's (jax's PRNG is not reproduced in torch);
* the publisher, the rollout driver (with the target+drafter pair path)
  and the operator CLI.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import deeperspeed_tpu
import deeperspeed_tpu.lifecycle as jlc
import deeperspeed_tpu.resilience.manager as jax_manager
import deeperspeed_tpu_torch
import deeperspeed_tpu_torch.lifecycle as tlc
from deeperspeed_tpu.models import gpt as jax_gpt
from deeperspeed_tpu.runtime.config import TrainingConfig as JaxTrainingConfig
from deeperspeed_tpu.serving import ServingConfig as JaxServingConfig
from deeperspeed_tpu.serving import ServingEngine as JaxServingEngine
from deeperspeed_tpu_torch.models import convert, gpt
from deeperspeed_tpu_torch.resilience import manager as port_manager
from deeperspeed_tpu_torch.resilience.config import ResilienceConfig
from deeperspeed_tpu_torch.resilience.manifest import (commit_checkpoint,
                                                       staging_dir_for,
                                                       write_manifest)
from deeperspeed_tpu_torch.runtime.config import TrainingConfig
from deeperspeed_tpu_torch.serving import (FleetRouter, RouterConfig,
                                           ServingConfig, ServingEngine)
from deeperspeed_tpu_torch.serving.fleet import ThreadReplica
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 canonical-slot steps of two frameworks (int8 wire, Adam): the
# elastic tests hold one step to 1e-5; five steps through the flip
REMESH_RTOL = 1e-4


# --------------------------------------------------------------------- #
# config
# --------------------------------------------------------------------- #

GOOD_BLOCKS = [
    {},
    {"pool_file": "p", "remesh_debounce_s": 0.0, "publish": False},
    {"remesh_signal": "SIGUSR2", "keep_live_versions": 5,
     "publish_interval_steps": 10, "drain_timeout_s": 1.0},
]
BAD_BLOCKS = [
    {"publish_interval_steps": -1},
    {"keep_live_versions": 0},
    {"remesh_debounce_s": -0.1},
    {"rollout_poll_interval_s": 0},
    {"drain_timeout_s": 0},
    {"remesh_signal": "SIGNOPE"},
    {"typo_key": 1},
]


@pytest.mark.parametrize("block", GOOD_BLOCKS + BAD_BLOCKS)
def test_lifecycle_config_matches_reference(block):
    try:
        want = jlc.LifecycleConfig.from_dict(dict(block))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tlc.LifecycleConfig.from_dict(dict(block))
        assert str(got.value) == str(e)
        return
    got = tlc.LifecycleConfig.from_dict(dict(block))
    assert vars(got) == vars(want)
    assert got.signal_number() == want.signal_number()
    assert tlc.LifecycleConfig().signal_number() == int(signal.SIGUSR1)


@pytest.mark.parametrize("world", [1, 2])
def test_gpt_125m_lifecycle_json_parses_like_reference(world):
    path = os.path.join(REPO, "configs", "gpt_125m_lifecycle.json")
    t = TrainingConfig(path, world_size=world)
    j = JaxTrainingConfig(path, world_size=world)
    assert vars(t.lifecycle_config()) == vars(j.lifecycle_config())
    assert (t.train_batch_size, t.train_micro_batch_size_per_gpu,
            t.gradient_accumulation_steps) == (
        j.train_batch_size, j.train_micro_batch_size_per_gpu,
        j.gradient_accumulation_steps)
    assert t.elastic_valid_world_sizes == j.elastic_valid_world_sizes
    off = TrainingConfig({"train_batch_size": 4,
                          "lifecycle": {"enabled": False}})
    assert off.lifecycle_config() is None


# --------------------------------------------------------------------- #
# the version registry
# --------------------------------------------------------------------- #


def _commit_tag(ckpt_dir, tag):
    """A COMMITTED tag with a model-state file, through the port's
    two-phase commit."""
    staging = staging_dir_for(str(ckpt_dir), tag)
    os.makedirs(staging)
    with open(os.path.join(staging, "mp_rank_00_model_states.msgpack"),
              "wb") as f:
        f.write(tag.encode())
    write_manifest(staging)
    commit_checkpoint(staging, os.path.join(str(ckpt_dir), tag))


def _records(reg):
    return [r.to_dict() for r in reg.list()]


def test_versions_json_crosses_between_packages(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    for d in (a, b):
        for s in (1, 2, 3, 4):
            _commit_tag(d, f"global_step{s}")
        os.makedirs(d / "global_step9.tmp")      # staging: never published
    # the same publish sequence in each package: the same bytes
    for d, mod in ((a, tlc), (b, jlc)):
        reg = mod.VersionRegistry(str(d), keep_live=2)
        reg.publish("global_step1", now=1.0)
        reg.publish("global_step2", now=2.0, drafter="global_step1")
        with pytest.raises(ValueError, match="only committed"):
            reg.publish("global_step9.tmp", now=3.0)
    assert (a / "VERSIONS.json").read_bytes() == \
        (b / "VERSIONS.json").read_bytes()
    # each package reads and extends the other's file
    treg = tlc.VersionRegistry(str(b), keep_live=2)
    jreg = jlc.VersionRegistry(str(a), keep_live=2)
    assert _records(treg) == _records(jlc.VersionRegistry(str(b)))
    assert treg.publish("global_step3", now=3.0).version == 3
    assert jreg.publish("global_step3", now=3.0).version == 3
    assert (a / "VERSIONS.json").read_bytes() == \
        (b / "VERSIONS.json").read_bytes()
    # idempotent re-publish, the live window, retire, live_tags
    assert treg.publish("global_step3").version == 3
    assert tlc.live_tags(str(a)) == jlc.live_tags(str(a)) == {
        "global_step2": 2, "global_step3": 3}
    assert treg.retire(2) and not treg.retire(2)
    assert jlc.live_tags(str(b)) == tlc.live_tags(str(b)) == {
        "global_step3": 3}
    assert tlc.VersionRegistry(str(b)).latest().tag == "global_step3"
    assert tlc.live_tags(str(tmp_path / "none")) == {}


def _prune_survivors(mod_manager, cfg_cls, d):
    mgr = mod_manager.ResilienceManager(cfg_cls.from_dict(
        {"async_save": False, "preemption_guard": False}))
    try:
        mgr._prune(str(d), keep=1)
    finally:
        mgr.close()
    return sorted(p for p in os.listdir(d) if p.startswith("global_step"))


def test_prune_protects_live_versions_like_reference(tmp_path):
    from deeperspeed_tpu.resilience.config import \
        ResilienceConfig as JaxResilienceConfig

    out = {}
    for name, mod, cfg_cls, lc in (
            ("port", port_manager, ResilienceConfig, tlc),
            ("reference", jax_manager, JaxResilienceConfig, jlc)):
        d = tmp_path / name
        for s in (1, 2, 3, 4, 5):
            _commit_tag(d, f"global_step{s}")
        reg = lc.VersionRegistry(str(d), keep_live=2)
        reg.publish("global_step1", now=1.0)
        reg.publish("global_step2", now=2.0)
        out[name] = _prune_survivors(mod, cfg_cls, d)
    # the live versions' tags and the newest committed survive keep_last 1
    assert out["port"] == out["reference"] == [
        "global_step1", "global_step2", "global_step5"]


# --------------------------------------------------------------------- #
# the re-mesh hook
# --------------------------------------------------------------------- #


class _Cfg:
    def __init__(self, sizes):
        self.elastic_valid_world_sizes = sizes


class _FakeEngine:
    def __init__(self, sizes, world):
        self._config = _Cfg(sizes)
        self.data_parallel_size = world
        self.remeshed = []
        self.monitor = None

    def remesh(self, world):
        self.remeshed.append(world)
        self.data_parallel_size = world
        return world

    def agree_remesh(self, ready, pool):
        return ready, pool


@pytest.mark.parametrize("sizes", [[1, 2, 4, 8], [1, 2, 3, 4, 6, 8],
                                   [2, 4, 8], None])
def test_choose_world_matches_reference(tmp_path, sizes):
    """Over pools 0-10 (and an unreadable file) at the reference's cap of
    8 CPU devices and the port's 8 processes alive."""
    assert len(jax.devices()) == 8
    pool = tmp_path / "pool"
    th = tlc.RemeshHook(tlc.LifecycleConfig(), pool_file=str(pool))
    jh = jlc.RemeshHook(jlc.LifecycleConfig(), pool_file=str(pool))
    for n in [None] + list(range(0, 11)):
        if n is None:
            pool.write_text("garbage")
        else:
            pool.write_text(f"{n}\n")
        assert th.choose_world(_FakeEngine(sizes, 8)) == \
            jh.choose_world(_FakeEngine(sizes, 8)), n
        assert tlc.cross_host_growth_needed(n, 8) == (n is not None
                                                      and n > 8)


def test_remesh_hook_state_machine_matches_reference(tmp_path):
    pool = tmp_path / "pool"
    for mod in (tlc, jlc):
        hook = mod.RemeshHook(mod.LifecycleConfig(remesh_debounce_s=0.0),
                              pool_file=str(pool))
        eng = _FakeEngine([1, 2, 4, 8], 8)
        assert not hook.poll(eng)            # nothing pending
        hook.request()
        pool.write_text("1\n")
        assert hook.poll(eng) and eng.remeshed == [1]
        assert hook.remeshes == 1 and hook.last_world == 1
        hook.request()                       # resolves to the current world
        assert not hook.poll(eng) and not hook.pending
        slow = mod.RemeshHook(mod.LifecycleConfig(remesh_debounce_s=60.0))
        slow.request()
        assert not slow.poll(eng) and slow.pending
        off = mod.RemeshHook(mod.LifecycleConfig(remesh_enabled=False))
        off.request()
        assert not off.poll(eng)
        pool.unlink()


def test_remesh_signal_latches_in_process():
    hook = tlc.RemeshHook(tlc.LifecycleConfig(remesh_signal="SIGUSR2"))
    hook.install()
    try:
        os.kill(os.getpid(), signal.SIGUSR2)
        deadline = time.monotonic() + 5
        while not hook.pending and time.monotonic() < deadline:
            time.sleep(0.01)
        assert hook.pending
    finally:
        hook.uninstall()


# --------------------------------------------------------------------- #
# the engine: guards, and a live 2 -> 1 shrink
# --------------------------------------------------------------------- #

NEOX = dict(vocab_size=97, n_layer=2, n_head=4, d_model=64, max_seq=16,
            rotary=True, parallel_residual=True)
STEPS, SIGNAL_BEFORE = 5, 2


def _elastic_config():
    return {
        "elasticity": {"enabled": True, "max_train_batch_size": 16,
                       "micro_batch_sizes": [2, 4], "min_gpus": 1,
                       "max_gpus": 4, "version": 0.1,
                       "canonical_shards": 4},
        "zero_optimization": {"stage": 1},
        "optimizer": {"type": "Adam", "params": {"lr": 3e-3,
                                                 "betas": [0.9, 0.95]}},
        "gradient_clipping": 1.0,
        "comm": {"mode": "int8", "bucket_mb": 0.01, "block": 32,
                 "error_feedback": True},
    }


def test_engine_remesh_guards():
    params = {"w": torch.ones(4, 2)}

    def loss(p, b):
        return (b @ p["w"]).square().mean()

    eng, _, _, _ = deeperspeed_tpu_torch.initialize(
        model=loss, model_parameters=params,
        config={"train_batch_size": 4}, device="cpu")
    assert eng.remesh(1) == 1                 # same world: nothing to do
    with pytest.raises(RuntimeError, match="elasticity"):
        eng.remesh(2)
    cfg = dict(_elastic_config(), comm=None)
    cfg["elasticity"]["canonical_shards"] = 0
    eng, _, _, _ = deeperspeed_tpu_torch.initialize(
        model=loss, model_parameters=params, config=cfg, device="cpu")
    with pytest.raises(ValueError, match="not an admissible"):
        eng.remesh(3)
    with pytest.raises(ValueError, match="growth needs a relaunch"):
        eng.remesh(2)
    eng.forward(torch.ones(4, 4))
    eng.backward()
    with pytest.raises(RuntimeError, match="optimizer-step boundary"):
        eng.remesh(2)


def _reference_remesh_losses(jparams):
    cfg = _elastic_config()
    jeng, _, _, _ = deeperspeed_tpu.initialize(
        model=jax_gpt.make_gpt(jax_gpt.GPTConfig(
            **NEOX, dtype=jnp.float32, attn_impl="xla"))[2],
        model_parameters=jparams, config_params=cfg,
        mesh=JaxMesh(np.array(jax.devices()[:2]), ("data",)))
    rows = jeng._config.train_batch_size
    losses = []
    for s in range(STEPS):
        batch = np.random.RandomState(1000 + s).randint(
            0, NEOX["vocab_size"], (rows, NEOX["max_seq"] + 1))
        losses.append(float(jeng.train_batch(batch)))
        if s == SIGNAL_BEFORE:
            assert jeng.remesh(1) == 1
    return losses


def test_live_remesh_2_to_1_bit_identical_and_matches_reference(tmp_path):
    jcfg = jax_gpt.GPTConfig(**NEOX, dtype=jnp.float32, attn_impl="xla")
    jparams = jax_gpt.make_gpt(jcfg)[0](jax.random.PRNGKey(3))
    tcfg = gpt.GPTConfig(**NEOX, dtype=torch.float32, attn_impl="xla")
    torch.save(convert.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       tcfg, "cpu"),
               str(tmp_path / "params.pt"))
    cfg = _elastic_config()
    live = dict(cfg, lifecycle={"pool_file": str(tmp_path / "pool"),
                                "remesh_debounce_s": 0.0},
                resilience={"async_save": False, "preemption_guard": False})
    (tmp_path / "pool").write_text("2\n")
    worker.spawn("remesh_run", 2, tmp_path, NEOX, live, STEPS,
                 SIGNAL_BEFORE, 1, "live")
    worker.remesh_run(0, 1, str(tmp_path), NEOX, cfg, STEPS, -1, 1, "ref")
    r0, r1, ref = (json.loads((tmp_path / f"{t}.json").read_text())
                   for t in ("live_rank0", "live_rank1", "ref_rank0"))
    # rank 1 retired cleanly at the flip; rank 0 went on at world 1
    assert r1["retired"] == 0 and r0["retired"] is None
    assert r0["worlds"] == [2, 2, 1, 1, 1]
    assert len(r1["losses"]) == SIGNAL_BEFORE
    assert r0["spans"] == 1 and r1["spans"] == 0
    assert r0["micro_gas"] == ref["micro_gas"] == [4, 4]
    for key in ("losses", "gnorms", "params"):
        assert r0[key] == ref[key], key
        assert r1[key] == ref[key][:SIGNAL_BEFORE], key
    want = _reference_remesh_losses(jparams)
    got = [float.fromhex(x) for x in r0["losses"]]
    np.testing.assert_allclose(got, want, rtol=REMESH_RTOL)


def _live_fleet(tmp_path):
    """A FleetSupervisor with live_remesh over two ``fleet_trainer``
    processes of the tiny GPT (steps held by ``<tmp>/allow``, the pool
    file at 2), run on a thread. Returns the supervisor, its result, its
    thread, and a reader of a host's step lines."""
    from deeperspeed_tpu_torch.distributed.fleet import (FleetPolicy,
                                                         FleetSupervisor)

    tcfg = gpt.GPTConfig(**NEOX, dtype=torch.float32, attn_impl="xla")
    torch.save(gpt.init_params(3, tcfg, device="cpu"),
               str(tmp_path / "params.pt"))
    cfg = _elastic_config()
    live = dict(cfg, lifecycle={"remesh_debounce_s": 0.0},
                resilience={"async_save": False, "preemption_guard": False})
    (tmp_path / "spec.json").write_text(json.dumps(
        {"model": NEOX, "config": live, "steps": STEPS}))
    (tmp_path / "allow").write_text("2")
    (tmp_path / "pool").write_text("2\n")
    cmd = [sys.executable, "-c",
           "import sys; from tests.torch_gloo_worker import fleet_trainer; "
           f"fleet_trainer({str(tmp_path)!r})"]
    sup = FleetSupervisor(cmd, FleetPolicy(
        procs=2, pool_file=str(tmp_path / "pool"), watch_pool=True,
        live_remesh=True, pool_poll_interval_s=0.05, pool_debounce_s=0.1,
        restart_log=str(tmp_path / "restarts.jsonl"), max_restarts=0,
        extra_env={"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}))
    out = {}
    th = threading.Thread(target=lambda: out.update(rc=sup.run()))
    th.start()

    def lines(h):
        p = tmp_path / f"steps.h{h}"
        return ([json.loads(x) for x in p.read_text().splitlines()]
                if p.exists() else [])

    return sup, out, th, lines


def _wait(cond, th, out, deadline):
    while not cond():
        assert th.is_alive() and time.monotonic() < deadline, out
        time.sleep(0.05)


def _events(tmp_path):
    return [json.loads(x) for x in
            (tmp_path / "restarts.jsonl").read_text().splitlines()]


def test_fleet_supervisor_live_shrink_retires_a_host(tmp_path):
    """The FleetSupervisor with live_remesh: a pool file 2 -> 1 signals
    both trainer processes instead of a restart; host 1 retires (exit 0,
    logged "retired"), host 0 goes on at world 1 with the uninterrupted
    run's losses, and the fleet launched once."""
    sup, out, th, lines = _live_fleet(tmp_path)
    try:
        deadline = time.monotonic() + 120
        _wait(lambda: all(len(lines(h)) >= 2 for h in (0, 1)), th, out,
              deadline)
        (tmp_path / "pool").write_text("1\n")
        _wait(lambda: sup.remesh_signals >= 1, th, out, deadline)
        (tmp_path / "allow").write_text(str(STEPS))
        th.join(timeout=120)
    finally:
        for c in sup._children:
            if c.poll() is None:
                c.kill()
    assert out.get("rc") == 0
    events = _events(tmp_path)
    assert [e["event"] for e in events].count("launch") == 1
    assert sorted((e["host"], e["reason"]) for e in events
                  if e["event"] == "exit") == [(0, "done"), (1, "retired")]
    assert sup.crashes == 0 and sup.remeshes == 0
    h0, h1 = lines(0), lines(1)
    assert h1[-1] == {"retired": 0, "after_step": 3}
    assert [x["world"] for x in h0] == [2, 2, 1, 1, 1]
    worker.remesh_run(0, 1, str(tmp_path), NEOX, _elastic_config(), STEPS,
                      -1, 1, "ref")
    ref = json.loads((tmp_path / "ref_rank0.json").read_text())
    assert [x["loss"] for x in h0] == ref["losses"]


def test_fleet_supervisor_regrows_after_a_live_shrink(tmp_path):
    """A spot pool's round trip 2 -> 1 -> 2: the shrink is live (host 1
    retires, no relaunch), and the growth back to 2 is the coordinated
    restart at 2 processes, after which both hosts run to the end and
    exit "done" (not "retired"), with no crash counted."""
    sup, out, th, lines = _live_fleet(tmp_path)
    try:
        deadline = time.monotonic() + 150
        _wait(lambda: all(len(lines(h)) >= 2 for h in (0, 1)), th, out,
              deadline)
        (tmp_path / "pool").write_text("1\n")
        _wait(lambda: sup.remesh_signals >= 1, th, out, deadline)
        (tmp_path / "allow").write_text("4")
        _wait(lambda: len(lines(0)) >= 4 and "retired" in lines(1)[-1],
              th, out, deadline)
        assert sup.procs == 1
        (tmp_path / "pool").write_text("2\n")
        _wait(lambda: sup.remeshes >= 1, th, out, deadline)
        (tmp_path / "allow").write_text(str(STEPS))
        th.join(timeout=120)
    finally:
        for c in sup._children:
            if c.poll() is None:
                c.kill()
    assert out.get("rc") == 0
    events = _events(tmp_path)
    assert [(e["procs"], e["reason"]) for e in events
            if e["event"] == "launch"] == [(2, "start"), (2, "pool_change")]
    assert [(e["procs_from"], e["procs_to"]) for e in events
            if e["event"] == "fleet_remesh"] == [(1, 2)]
    assert sorted((e["host"], e["reason"]) for e in events
                  if e["event"] == "exit" and e["reason"] in
                  ("done", "retired")) == [(0, "done"), (1, "done")]
    assert sup.crashes == 0 and sup.remesh_signals == 1
    assert sup.procs == 2 and not sup._retiring
    h0, h1 = lines(0), lines(1)
    assert [x["world"] for x in h0] == [2, 2, 1, 1] + [2] * STEPS
    assert h1[2] == {"retired": 0, "after_step": 3}
    assert [x.get("world") for x in h1[3:]] == [2] * STEPS


# --------------------------------------------------------------------- #
# the publisher and the CLI
# --------------------------------------------------------------------- #


def test_publisher_autowires_and_publishes_committed_saves(tmp_path):
    from deeperspeed_tpu_torch.resilience import shutdown_resilience

    def loss(p, b):
        return (b @ p["w"]).square().mean()

    cfg = {"train_batch_size": 4,
           "resilience": {"save_dir": str(tmp_path), "async_save": False,
                          "preemption_guard": False,
                          "save_interval_steps": 1},
           "lifecycle": {"publish_interval_steps": 2}}
    try:
        eng, _, _, _ = deeperspeed_tpu_torch.initialize(
            model=loss, model_parameters={"w": torch.ones(4, 2)},
            config=cfg, device="cpu")
        assert isinstance(eng._lifecycle, tlc.LifecycleController)
        for _ in range(4):
            eng.train_batch(torch.ones(4, 4))
    finally:
        shutdown_resilience()
    recs = jlc.VersionRegistry(str(tmp_path)).list()
    # every save committed; the interval publishes steps 1 and 3
    assert [(r.version, r.tag) for r in recs] == [
        (1, "global_step1"), (2, "global_step3")]


def _cli(capsys, *args):
    """The port's CLI in process: (exit code, stdout)."""
    from deeperspeed_tpu_torch.lifecycle.__main__ import main

    rc = main(list(args))
    return rc, capsys.readouterr().out


def test_operator_cli_matches_reference(tmp_path, capsys):
    for s in (1, 2):
        _commit_tag(tmp_path, f"global_step{s}")
    (tmp_path / "latest").write_text("global_step2")
    ck = ("--ckpt-dir", str(tmp_path))
    rc, out = _cli(capsys, "publish", *ck)
    assert rc == 0 and json.loads(out)["tag"] == "global_step2"
    rc, out = _cli(capsys, "publish", *ck, "--tag", "global_step1")
    assert json.loads(out)["version"] == 2
    assert _cli(capsys, "retire", *ck, "--version", "9")[0] == 1
    assert json.loads(_cli(capsys, "retire", *ck, "--version", "1")[1]) == \
        {"retired": 1}
    pool = tmp_path / "sub" / "pool"
    rc, out = _cli(capsys, "pool", "--pool-file", str(pool), "--size", "3")
    assert json.loads(out) == {"pool_file": str(pool), "size": 3}
    assert pool.read_text() == "3\n"
    # as a module, with the standard library's verbs only
    proc = subprocess.run(
        [sys.executable, "-m", "deeperspeed_tpu_torch.lifecycle", "versions",
         *ck], capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == {
        "versions": _records(jlc.VersionRegistry(str(tmp_path)))}


# --------------------------------------------------------------------- #
# version-pinned serving
# --------------------------------------------------------------------- #

KW = dict(vocab_size=97, n_layer=2, n_head=2, d_model=32, max_seq=128,
          rotary=True, parallel_residual=True)
_SCFG = dict(num_slots=4, block_size=8, num_blocks=64, max_seq_len=128,
             max_new_tokens=64, prefill_buckets=(16, 128))
NEW = 24


@pytest.fixture(scope="module")
def versions():
    """Two weight versions (reference init seeds 0 and 1, converted), the
    request trace, and per version: the reference engine's greedy tokens
    and the port's plain engine's tokens (greedy and sampled)."""
    jcfg = jax_gpt.GPTConfig(**KW, remat=False, dtype=jnp.float32,
                             attn_impl="xla")
    tcfg = gpt.GPTConfig(**KW, remat=False, dtype=torch.float32,
                         attn_impl="xla")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 97, int(rng.integers(4, 12))).tolist()
               for _ in range(6)]
    temps = [0.0, 0.7] * 3
    rids = [f"v{i}" for i in range(6)]
    out = {}
    for v, seed in ((1, 0), (2, 1)):
        jparams = jax_gpt.make_gpt(jcfg)[0](jax.random.PRNGKey(seed))
        tparams = convert.from_jax_params(
            jax.tree.map(np.asarray, jparams), tcfg, "cpu")
        jeng = JaxServingEngine(jcfg, jparams, JaxServingConfig(**_SCFG))
        greedy = [i for i, t in enumerate(temps) if t == 0.0]
        for i in greedy:
            jeng.submit(prompts[i], max_new_tokens=NEW, request_id=rids[i])
        jeng.run()
        factory = _factory(tcfg, tparams)
        plain = factory()
        for p, t, rid in zip(prompts, temps, rids):
            plain.submit(p, max_new_tokens=NEW, temperature=t,
                         request_id=rid)
        plain.run()
        out[v] = {"factory": factory,
                  "ref": {rids[i]: jeng.get(rids[i]).output for i in greedy},
                  "plain": {rid: plain.get(rid).output for rid in rids}}
    return out, prompts, temps, rids


def _factory(cfg, params):
    def factory():
        eng = ServingEngine(cfg, params, ServingConfig(**_SCFG),
                            device="cpu")
        eng.submit([1, 2, 3], max_new_tokens=2, request_id="_warm")
        eng.run()
        return eng

    return factory


def _fleet(assignments):
    fleet = [ThreadReplica(name, factory, poll_interval_s=0.001)
             for name, factory, _ in assignments]
    for rep in fleet:
        rep.start()
    for rep, (_, _, version) in zip(fleet, assignments):
        rep.wait_ready()
        rep.set_weights(None, version)
    return fleet


def _rcfg(**kw):
    d = dict(num_replicas=2, max_queue_depth=64, retry_max=3,
             retry_backoff_base_s=0.01, retry_backoff_max_s=0.1,
             heartbeat_timeout_s=60.0, progress_timeout_s=60.0,
             poll_interval_s=0.002)
    d.update(kw)
    return RouterConfig(**d)


def _check_tokens(router, versions, rid, version):
    rec = router.result(rid)
    assert rec.tokens == versions[version]["plain"][rid], (rid, version)
    if rid in versions[version]["ref"]:
        assert rec.tokens == versions[version]["ref"][rid], (rid, version)


def test_mixed_version_failover_stays_pinned(versions):
    vs, prompts, temps, rids = versions
    fleet = _fleet([("a", vs[1]["factory"], 1), ("b", vs[1]["factory"], 1),
                    ("c", vs[2]["factory"], 2)])
    router = FleetRouter(fleet, _rcfg(num_replicas=3))
    try:
        for p, t, rid in zip(prompts, temps, rids):
            router.submit(p, max_new_tokens=NEW, temperature=t,
                          request_id=rid)
        router.step()
        pinned_v1 = [r for r in rids if router.result(r).version == 1]
        time.sleep(0.05)
        fleet[0].kill()
        outcomes = router.run_until_idle(timeout_s=120)
        assert sorted(outcomes) == sorted(rids)
        assert set(outcomes.values()) <= {"length", "eos"}, outcomes
        for rid in rids:
            rec = router.result(rid)
            assert rec.version in (1, 2) and rec.repins == 0, rid
            _check_tokens(router, vs, rid, rec.version)
        assert pinned_v1
        assert all(router.result(r).version == 1 for r in pinned_v1)
        assert any(d["cause"] == "dead"
                   for d in router.metrics.summary()["replica_downs"])
    finally:
        router.shutdown()


def test_version_starvation_repins_with_full_regeneration(versions):
    vs, prompts, temps, rids = versions
    fleet = _fleet([("a", vs[1]["factory"], 1), ("b", vs[2]["factory"], 2)])
    router = FleetRouter(fleet, _rcfg(replica_restart=False))
    try:
        for p, t, rid in zip(prompts, temps, rids):
            router.submit(p, max_new_tokens=NEW, temperature=t,
                          request_id=rid)
        router.step()
        pinned_v1 = [r for r in rids if router.result(r).version == 1]
        assert pinned_v1
        time.sleep(0.05)
        fleet[0].kill()                 # v1's only replica
        outcomes = router.run_until_idle(timeout_s=120)
        assert set(outcomes.values()) <= {"length", "eos"}, outcomes
        for rid in rids:
            rec = router.result(rid)
            if rid in pinned_v1:
                assert rec.version == 2 and rec.repins >= 1, rid
            _check_tokens(router, vs, rid, rec.version)
    finally:
        router.shutdown()


def test_rollout_driver_rolls_versions_and_drafter_pairs(tmp_path, versions):
    """The driver rolls a thread fleet onto each new live version of a
    registry; a (target, drafter) pair reaches the replicas' set_weights
    as the checkpoint pointer with its drafter tag."""
    vs, prompts, temps, rids = versions
    for s in (1, 2, 3):
        _commit_tag(tmp_path, f"global_step{s}")
    pushed = []
    fleet = _fleet([("a", vs[1]["factory"], 0), ("b", vs[1]["factory"], 0)])
    for rep in fleet:
        orig = rep.set_weights

        def spy(weights, version, _orig=orig):
            pushed.append((version, weights))
            _orig(None, version)

        rep.set_weights = spy
    router = FleetRouter(fleet, _rcfg())
    reg = tlc.VersionRegistry(str(tmp_path))
    driver = tlc.RolloutDriver(router, reg, tlc.LifecycleConfig(
        drain_timeout_s=5.0))
    try:
        assert driver.poll_once() is None          # nothing published
        reg.publish("global_step1")
        assert driver.poll_once().version == 1
        assert driver.poll_once() is None          # already applied
        reg.publish("global_step3", drafter="global_step2")
        assert driver.poll_once().version == 2
        assert driver.rollouts == 2 and driver.applied == 2
        assert [r.version for r in fleet] == [2, 2]
        assert pushed[-1] == (2, {"load_dir": str(tmp_path),
                                  "tag": "global_step3",
                                  "drafter_tag": "global_step2"})
        router.submit(prompts[0], max_new_tokens=NEW, request_id="after")
        router.run_until_idle(timeout_s=60)
        assert router.result("after").version == 2
    finally:
        router.shutdown()
