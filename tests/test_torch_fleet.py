"""The PyTorch port's serving fleet against the JAX reference's: the two
``FleetRouter``s run the same scripted traces over stub replicas on a
fake clock and reach the same outcomes, shed decisions (reason and
``retry_after_s``), retries, replica-down causes, restarts and metrics;
``compute_backoff`` and the ``DS_TPU_FAULTS`` parser agree; and, in the
port alone, thread replicas killed mid-decode retry token-identically,
drain and rolling restart lose nothing, ``rolling_update`` pins versions,
the ``"fleet"`` block parses, and a CPU ``SubprocessReplica`` SIGKILLed
mid-decode has its requests retried token-identically."""

import dataclasses
import itertools
import time
import types

import numpy as np
import pytest
import torch

import deeperspeed_tpu.resilience.faults as jax_faults
import deeperspeed_tpu.resilience.supervisor as jax_supervisor
import deeperspeed_tpu.serving as jax_serving
import deeperspeed_tpu.serving.fleet as jax_fleet
import deeperspeed_tpu_torch.resilience.faults as faults
import deeperspeed_tpu_torch.resilience.supervisor as supervisor
import deeperspeed_tpu_torch.serving as serving
import deeperspeed_tpu_torch.serving.fleet as fleet_mod
from deeperspeed_tpu_torch.models import gpt
from deeperspeed_tpu_torch.monitor.metrics import MetricsRegistry
from deeperspeed_tpu_torch.monitor.validate import validate_events
from deeperspeed_tpu_torch.serving import (
    FINISH_TIMEOUT,
    EngineDrainingError,
    FleetRouter,
    RouterConfig,
    ServingConfig,
    ServingEngine,
    ShedError,
    build_thread_fleet,
)
from deeperspeed_tpu_torch.serving.metrics import record_finish_outcome

torch.set_num_threads(1)

PACKAGES = {
    "jax": types.SimpleNamespace(
        FleetRouter=jax_serving.FleetRouter,
        RouterConfig=jax_serving.RouterConfig,
        ShedError=jax_serving.ShedError,
        Unavailable=jax_fleet.ReplicaUnavailableError),
    "torch": types.SimpleNamespace(
        FleetRouter=serving.FleetRouter,
        RouterConfig=serving.RouterConfig,
        ShedError=serving.ShedError,
        Unavailable=fleet_mod.ReplicaUnavailableError),
}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class StubReplica:
    """Scripted replica: records submits and cancels, emits pushed
    events; raises its package's ReplicaUnavailableError when down."""

    def __init__(self, name, clock, unavailable, version=None):
        self.name = name
        self._clock = clock
        self._unavailable = unavailable
        self.alive = True
        self.heartbeat_t = clock()
        self.progress = 0
        self.restarts = 0
        self.version = version
        self.submitted = []
        self.cancelled = []
        self.drains = 0
        self._events = []

    def submit(self, spec):
        if not self.alive:
            raise self._unavailable(self.name)
        self.submitted.append(dict(spec))

    def cancel(self, rid, reason="timeout"):
        self.cancelled.append((rid, reason))

    def push(self, **ev):
        self._events.append(ev)

    def poll_events(self):
        evs, self._events = self._events, []
        return evs

    def kill(self):
        self.alive = False

    def restart(self):
        self.restarts += 1
        self.alive = True
        self.heartbeat_t = self._clock()
        self.progress = 0

    def stop(self, timeout_s=1.0):
        self.alive = False

    def drain(self, timeout_s=1.0):
        self.drains += 1
        return []

    def inflight_rids(self):
        return []


def _stub_router(P, clock, versions=(None, None), **rcfg_kw):
    kw = dict(num_replicas=2, max_queue_depth=64, retry_max=2,
              retry_backoff_base_s=0.1, retry_backoff_max_s=1.0,
              heartbeat_timeout_s=1000.0, progress_timeout_s=1000.0,
              replica_max_restarts=1, poll_interval_s=0.001)
    kw.update(rcfg_kw)
    stubs = [StubReplica(f"s{i}", clock, P.Unavailable, v)
             for i, v in enumerate(versions)]
    return P.FleetRouter(stubs, P.RouterConfig(**kw), clock=clock,
                         registry=None), stubs


def _tick(clock, stubs, t, fresh=None):
    clock.t = t
    for st in stubs:
        if fresh is None or st.name in fresh:
            st.heartbeat_t = t


# Each scenario drives (router, stubs, clock, P) and returns a list of
# the shed decisions it met; the transcript adds the router's state.

def _sc_queue_depth(router, stubs, clock, P):
    sheds = []
    for _ in range(4):
        try:
            router.submit([1, 2, 3], max_new_tokens=4)
        except P.ShedError as e:
            sheds.append((e.rid, e.reason, e.retry_after_s))
    return sheds


def _sc_token_budget(router, stubs, clock, P):
    sheds = []
    rid = router.submit([1] * 8, max_new_tokens=8)        # 16 of 20
    try:
        router.submit([1] * 8, max_new_tokens=8)
    except P.ShedError as e:
        sheds.append((e.rid, e.reason, e.retry_after_s))
    router.step()
    stubs[0].push(ev="fin", rid=rid, tokens=[7], reason="length")
    router.step()
    router.submit([1] * 8, max_new_tokens=8)              # fits again
    return sheds


def _sc_heartbeat_failover(router, stubs, clock, P):
    s0, s1 = stubs
    rid = router.submit([1, 2, 3], max_new_tokens=4)
    router.step()
    _tick(clock, stubs, 6.0, fresh={"s1"})                # s0 goes stale
    router.step()
    _tick(clock, stubs, 7.0, fresh={"s1"})                # past backoff
    router.step()
    s1.push(ev="first", rid=rid)
    s1.push(ev="fin", rid=rid, tokens=[9, 9], reason="length")
    router.step()
    return []


def _sc_progress_stall(router, stubs, clock, P):
    router.submit([1, 2, 3], max_new_tokens=4)
    router.step()
    for t in (2.0, 4.0, 6.0):        # heartbeats flow, progress frozen
        _tick(clock, stubs, t)
        router.step()
    return []


def _sc_idle(router, stubs, clock, P):
    for t in (3.0, 9.0, 20.0):
        _tick(clock, stubs, t)
        router.step()
    return []


def _sc_retry_exhausted(router, stubs, clock, P):
    router.submit([1, 2, 3], max_new_tokens=4)
    router.step()
    _tick(clock, stubs, 6.0, fresh={"s1"})
    router.step()
    return []


def _sc_deadline(router, stubs, clock, P):
    rid = router.submit([1, 2, 3], max_new_tokens=4)
    router.step()
    _tick(clock, stubs, 4.0)
    router.step()
    _tick(clock, stubs, 6.0)
    router.step()
    stubs[0].push(ev="fin", rid=rid, tokens=[1], reason="length")
    router.step()                    # a late fin does not resurrect it
    return []


def _sc_crash_restart(router, stubs, clock, P):
    router.submit([1, 2, 3], max_new_tokens=4)
    router.step()
    _tick(clock, stubs, 6.0, fresh={"s1"})
    router.step()                    # s0 down, restart armed
    _tick(clock, stubs, 10.0, fresh={"s1"})
    router.step()                    # restarted after the backoff
    for i in range(4):
        router.submit([4, 5, i], max_new_tokens=2)
    router.step()
    return []


def _sc_err_then_drain_restart(router, stubs, clock, P):
    rids = [router.submit([i, i + 1], max_new_tokens=3, seed=100 + i)
            for i in range(5)]
    router.step()
    stubs[1].push(ev="err", rid=rids[1], error="EngineDrainingError")
    _tick(clock, stubs, 0.5)
    router.step()                    # bounced submit: requeued, backoff
    router.drain_replica("s0")
    _tick(clock, stubs, 1.0)
    router.step()
    router.rolling_restart()
    _tick(clock, stubs, 2.0)
    router.step()
    for st in stubs:
        for spec in list(st.submitted):
            st.push(ev="fin", rid=spec["rid"], tokens=[spec["seed"]],
                    reason="length")
    router.step()
    return []


def _sc_rolling_update_pins(router, stubs, clock, P):
    """Four requests pin to v1; three finish there. The rollout leaves
    the fourth without a v1 replica: it re-pins to v2 and regenerates.
    Requests after the rollout pin to v2."""
    rids = [router.submit([7, i], max_new_tokens=2) for i in range(4)]
    router.step()                    # pinned to v1 by dispatch

    def finish(skip=()):
        for st in stubs:
            for spec in st.submitted:
                if spec["rid"] not in skip:
                    st.push(ev="fin", rid=spec["rid"], tokens=[st.version],
                            reason="length")
            st.submitted.clear()

    finish(skip=(rids[3],))
    router.step()
    router.rolling_update(2)
    for i in range(2):
        router.submit([8, i], max_new_tokens=2)
    _tick(clock, stubs, 1.0)
    router.step()
    finish()
    router.step()
    return []


SCENARIOS = {
    "queue_depth": (_sc_queue_depth, dict(max_queue_depth=2), (None, None)),
    "token_budget": (_sc_token_budget, dict(max_inflight_tokens=20),
                     (None, None)),
    "heartbeat_failover": (_sc_heartbeat_failover,
                           dict(heartbeat_timeout_s=5.0,
                                replica_restart=False), (None, None)),
    "progress_stall": (_sc_progress_stall, dict(progress_timeout_s=5.0),
                       (None, None)),
    "idle": (_sc_idle, dict(progress_timeout_s=5.0), (None, None)),
    "retry_exhausted": (_sc_retry_exhausted,
                        dict(retry_max=0, heartbeat_timeout_s=5.0),
                        (None, None)),
    "deadline": (_sc_deadline, dict(default_deadline_s=5.0), (None, None)),
    "crash_restart": (_sc_crash_restart, dict(heartbeat_timeout_s=5.0),
                      (None, None)),
    "err_drain_restart": (_sc_err_then_drain_restart, {}, (None, None)),
    "rolling_update": (_sc_rolling_update_pins, {}, (1, 1)),
}


def _transcript(pkg, name):
    P = PACKAGES[pkg]
    fn, rcfg, versions = SCENARIOS[name]
    clock = FakeClock()
    router, stubs = _stub_router(P, clock, versions, **rcfg)
    sheds = fn(router, stubs, clock, P)
    recs = {rid: (r.finish_reason, r.tokens, r.attempts, r.version,
                  r.repins, r.assigned, r.spec["seed"])
            for rid, r in router.results().items()}
    return {
        "sheds": sheds,
        "outcomes": router.outcomes(),
        "records": recs,
        "summary": router.metrics.summary(),
        "stubs": [(st.name, st.alive, st.restarts, st.version, st.drains,
                   st.submitted, st.cancelled) for st in stubs],
        "unfinished": router.unfinished(),
    }


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_matches_reference_on_scripted_trace(name):
    port, ref = _transcript("torch", name), _transcript("jax", name)
    assert port == ref
    # and the scenario did what it is named for
    s = port["summary"]
    causes = [d["cause"] for d in s["replica_downs"]]
    if name == "queue_depth":
        assert [x[1] for x in port["sheds"]] == ["queue_depth"] * 2
        assert all(x[2] > 0 for x in port["sheds"])
        assert s["shed"] == 2 and s["accepted"] == 2
    elif name == "token_budget":
        assert [x[1] for x in port["sheds"]] == ["token_budget"]
    elif name == "heartbeat_failover":
        assert causes == ["heartbeat"] and s["retries"] == 1
        assert list(port["outcomes"].values()) == ["length"]
        sub0, sub1 = port["stubs"][0][5], port["stubs"][1][5]
        assert sub0[0]["seed"] == sub1[0]["seed"]   # token-identical replay
    elif name == "progress_stall":
        assert causes == ["stalled"]
    elif name == "idle":
        assert causes == []
    elif name == "retry_exhausted":
        assert list(port["outcomes"].values()) == ["failed"]
        assert port["unfinished"] == []
    elif name == "deadline":
        assert list(port["outcomes"].values()) == [FINISH_TIMEOUT]
    elif name == "crash_restart":
        assert port["stubs"][0][2] == 1 and port["stubs"][0][1]
    elif name == "err_drain_restart":
        assert all(r.startswith("fleet-") for r in port["outcomes"])
        assert set(port["outcomes"].values()) == {"length"}
        assert all(st[2] == 1 for st in port["stubs"])
        assert causes == []
    elif name == "rolling_update":
        recs = port["records"]
        assert sorted(r[3] for r in recs.values()) == [1, 1, 1, 2, 2, 2]
        assert sorted(r[4] for r in recs.values()) == [0] * 5 + [1]
        for rec in recs.values():
            assert rec[1] == [rec[3]]   # served by its pinned version


def test_shed_error_is_structured():
    with pytest.raises(ShedError) as ei:
        clock = FakeClock()
        router, _ = _stub_router(PACKAGES["torch"], clock,
                                 max_queue_depth=1)
        router.submit([1], max_new_tokens=1)
        router.submit([1], max_new_tokens=1, request_id="late")
    assert ei.value.rid == "late" and ei.value.retry_after_s > 0
    assert "retry after" in str(ei.value)


def test_compute_backoff_matches_reference():
    grid = itertools.product(range(-1, 8), (0.01, 0.05, 1.0), (1.5, 2.0),
                             (0.1, 2.0, 60.0), (0.0, 0.5))
    for failures, base, factor, cap, jitter in grid:
        args = (failures, base, factor, cap, jitter)
        assert supervisor.compute_backoff(*args, rand=lambda: 0.37) == \
            jax_supervisor.compute_backoff(*args, rand=lambda: 0.37), args


@pytest.mark.parametrize("spec", [
    "",
    '{"replica_sigkill_at_decode": 12}',
    "replica_stall_at_decode=7,flag_file=/tmp/x",
    "replica_slow_ms=5, raise_at_step=3",
    '{"corrupt_after_save": "bitflip", "sigkill_mid_save": 2}',
])
def test_fault_plan_parses_like_reference(spec, monkeypatch):
    monkeypatch.setenv(faults.FAULTS_ENV_VAR, spec)
    got = faults.plan_from_config_and_env({"sigkill_at_step": 9})
    want = jax_faults.plan_from_config_and_env({"sigkill_at_step": 9})
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.any_armed == want.any_armed


@pytest.mark.parametrize("bad", [{"replica_kill": 3},
                                 {"replica_stall_at_decode": 0},
                                 {"corrupt_after_save": "shred"}])
def test_fault_plan_rejects_like_reference(bad):
    with pytest.raises(ValueError) as ours:
        faults.FaultPlan.from_dict(bad)
    with pytest.raises(ValueError) as theirs:
        jax_faults.FaultPlan.from_dict(bad)
    assert str(ours.value) == str(theirs.value)


def test_decode_step_faults_fire_on_schedule(tmp_path):
    inj = faults.FaultInjector(faults.FaultPlan(
        replica_stall_at_decode=3, flag_file=str(tmp_path / "flag")))
    # the worker keeps the wedge itself once told; the latch makes later
    # calls (and a restarted replica's fresh injector) return None
    assert [inj.on_decode_step(i) for i in (1, 2, 3, 4)] == \
        [None, None, "stall", None]
    again = faults.FaultInjector(inj.plan)
    assert again.on_decode_step(5) is None
    assert faults.FaultInjector(faults.FaultPlan()).on_decode_step(9) is None


# ------------------------------------------------------------------ #
# engine satellites: draining submit, progress-based timeout
# ------------------------------------------------------------------ #

KW = dict(vocab_size=97, n_layer=2, n_head=2, d_model=32, max_seq=128,
          remat=False, attn_impl="xla", dtype=torch.float32)
_SCFG = dict(num_slots=4, block_size=8, num_blocks=64, max_seq_len=128,
             max_new_tokens=64, prefill_buckets=(16, 128))


@pytest.fixture(scope="module")
def model():
    cfg = gpt.GPTConfig(**KW)
    return cfg, gpt.init_params(0, cfg, device="cpu")


def _warm_factory(cfg, params, **scfg_kw):
    scfg = ServingConfig(**{**_SCFG, **scfg_kw})

    def factory():
        eng = ServingEngine(cfg, params, scfg, device="cpu")
        eng.submit([1, 2, 3], max_new_tokens=2, request_id="_warm")
        eng.submit([4, 5, 6], max_new_tokens=2, temperature=0.5,
                   request_id="_warm2")
        eng.run()
        return eng

    return factory


def test_engine_submit_rejected_while_draining(model):
    cfg, params = model
    eng = ServingEngine(cfg, params, ServingConfig(**_SCFG), device="cpu")
    eng.submit([1, 2, 3], max_new_tokens=4)
    eng.step()
    assert eng.drain() == []
    with pytest.raises(EngineDrainingError):
        eng.submit([4, 5, 6], max_new_tokens=4)


def test_engine_timeout_requires_lack_of_progress(model):
    cfg, params = model
    clock = FakeClock()
    eng = ServingEngine(cfg, params,
                        ServingConfig(**{**_SCFG, "request_timeout_s": 5.0}),
                        clock=clock, device="cpu")
    rid = eng.submit(list(range(1, 7)), max_new_tokens=40)
    for _ in range(6):
        eng.step()
        clock.t += 3.0
    assert eng.get(rid).state == "active"
    clock.t += 5.0
    eng.step()
    assert eng.get(rid).finish_reason == FINISH_TIMEOUT


# ------------------------------------------------------------------ #
# real thread replicas
# ------------------------------------------------------------------ #

def _fleet_rcfg(**kw):
    d = dict(num_replicas=2, max_queue_depth=64, retry_max=3,
             retry_backoff_base_s=0.01, retry_backoff_max_s=0.1,
             heartbeat_timeout_s=60.0, progress_timeout_s=60.0,
             poll_interval_s=0.002)
    d.update(kw)
    return RouterConfig(**d)


def _trace(n, seed, new=40):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 97, rng.integers(4, 12)).tolist()
               for _ in range(n)]
    return prompts, [new] * n, [0.0, 0.7] * (n // 2)


def _reference_outputs(factory, prompts, news, temps, rids):
    eng = factory()
    for p, n, t, rid in zip(prompts, news, temps, rids):
        eng.submit(p, max_new_tokens=n, temperature=t, request_id=rid)
    eng.run()
    return {rid: eng.get(rid).output for rid in rids}


def _submit_all(router, prompts, news, temps, rids):
    for p, n, t, rid in zip(prompts, news, temps, rids):
        router.submit(p, max_new_tokens=n, temperature=t, request_id=rid)


@pytest.mark.parametrize("speculative", [False, True])
def test_thread_fleet_kill_retry_token_identity(model, speculative):
    """A thread replica killed mid-decode: its requests are requeued, and
    the retried outputs (greedy and sampled) equal an unkilled plain
    single engine's, with speculation on the replicas or off."""
    cfg, params = model
    prompts, news, temps = _trace(6, 0)
    rids = [f"q{i}" for i in range(6)]
    ref = _reference_outputs(_warm_factory(cfg, params), prompts, news,
                             temps, rids)
    spec = ({"speculative": {"draft_k": 3, "drafter": {"n_layer": 1}}}
            if speculative else {})
    fleet = build_thread_fleet(2, _warm_factory(cfg, params, **spec))
    router = FleetRouter(fleet, _fleet_rcfg())
    try:
        _submit_all(router, prompts, news, temps, rids)
        router.step()
        time.sleep(0.05)
        fleet[0].kill()
        outcomes = router.run_until_idle(timeout_s=120)
        assert sorted(outcomes) == sorted(rids)
        assert set(outcomes.values()) <= {"length", "eos"}, outcomes
        for rid in rids:
            assert router.result(rid).tokens == ref[rid], rid
        downs = router.metrics.summary()["replica_downs"]
        assert any(d["cause"] == "dead" for d in downs)
        if speculative:
            assert any(r.spec_stats.get("rounds", 0) > 0 for r in fleet)
    finally:
        router.shutdown()


def test_drain_and_rolling_restart_lose_nothing(model):
    cfg, params = model
    factory = _warm_factory(cfg, params)
    prompts, news, temps = _trace(6, 1, new=32)
    rids = [f"d{i}" for i in range(6)]
    ref = _reference_outputs(factory, prompts, news, temps, rids)
    fleet = build_thread_fleet(2, factory)
    router = FleetRouter(fleet, _fleet_rcfg())
    try:
        _submit_all(router, prompts, news, temps, rids)
        router.step()
        router.rolling_restart(timeout_s=60)
        outcomes = router.run_until_idle(timeout_s=120)
        assert sorted(outcomes) == sorted(rids)
        assert set(outcomes.values()) <= {"length", "eos"}, outcomes
        for rid in rids:
            assert router.result(rid).tokens == ref[rid], rid
        assert all(st.replica.restarts == 1 for st in router._states)
        assert router.metrics.summary()["replica_downs"] == []
    finally:
        router.shutdown()


def test_rolling_update_pins_versions(model):
    """A rolling update from v1 to v2 weights: requests dispatched before
    it finish on v1 (the drain), requests after it pin to v2, and every
    stream equals its version's single-engine reference."""
    cfg, p1 = model
    p2 = gpt.init_params(1, cfg, device="cpu")
    f1, f2 = _warm_factory(cfg, p1), _warm_factory(cfg, p2)
    prompts, news, temps = _trace(8, 2, new=16)
    rids = [f"v{i}" for i in range(8)]
    ref = {1: _reference_outputs(f1, prompts, news, temps, rids),
           2: _reference_outputs(f2, prompts, news, temps, rids)}
    fleet = build_thread_fleet(2, f1)
    for rep in fleet:
        rep.set_weights(None, 1)
    registry = MetricsRegistry()
    router = FleetRouter(fleet, _fleet_rcfg(), registry=registry)
    try:
        _submit_all(router, prompts[:4], news[:4], temps[:4], rids[:4])
        # the first four are decoding on v1 before the rollout drains them
        deadline = time.monotonic() + 60
        while any(router.result(r).first_t is None for r in rids[:4]):
            assert time.monotonic() < deadline, "no first tokens"
            router.step()
            time.sleep(0.002)
        router.rolling_update(2, weights=f2, timeout_s=60)
        _submit_all(router, prompts[4:], news[4:], temps[4:], rids[4:])
        outcomes = router.run_until_idle(timeout_s=120)
        assert sorted(outcomes) == sorted(rids)
        for i, rid in enumerate(rids):
            rec = router.result(rid)
            assert rec.version == (1 if i < 4 else 2), rid
            assert rec.tokens == ref[rec.version][rid], rid
        assert registry.counter("lifecycle_rollout_total", "").value == 1
    finally:
        router.shutdown()


# ------------------------------------------------------------------ #
# metrics labels, trace schemas, the config block
# ------------------------------------------------------------------ #

def test_finish_reason_counter_labels():
    reg = MetricsRegistry()
    for reason in ("length", "eos", "timeout", "shed", "retried",
                   "failed", "length"):
        record_finish_outcome(reg, reason)
    assert reg.counter("serving_finish_total",
                       labels={"reason": "length"}).value == 2
    assert reg.counter("serving_finish_total",
                       labels={"reason": "shed"}).value == 1


def test_router_metrics_reach_the_registry():
    reg = MetricsRegistry()
    clock = FakeClock()
    P = PACKAGES["torch"]
    stubs = [StubReplica("s0", clock, P.Unavailable)]
    router = FleetRouter(stubs, RouterConfig(max_queue_depth=1),
                         clock=clock, registry=reg)
    router.submit([1], max_new_tokens=1)
    with pytest.raises(ShedError):
        router.submit([1], max_new_tokens=1)
    router.step()
    assert reg.counter("serving_shed_total", "").value == 1
    assert reg.counter("serving_router_accepted_total", "").value == 1
    assert reg.gauge("serving_fleet_queue_depth", "").value == 1.0


def test_validator_enforces_fleet_instant_schemas():
    def instant(name, args):
        return {"ph": "i", "name": name, "ts": 1, "pid": 1, "tid": 1,
                "s": "t", "args": args}

    good = [
        instant("serving/finish", {"rid": "a", "reason": "length"}),
        instant("serving/shed", {"rid": "b", "retry_after_s": 0.1}),
        instant("serving/retry", {"rid": "a", "attempt": 2,
                                  "replica": "r1"}),
        instant("serving/replica_down", {"replica": "r0", "cause": "dead",
                                         "inflight": 3}),
    ]
    assert validate_events(good, strict=True) == []
    bad = [instant("serving/shed", {"rid": "b"}),
           {"ph": "i", "name": "serving/retry", "ts": 1, "pid": 1,
            "tid": 1, "s": "t"}]
    errors = validate_events(bad)
    assert len(errors) == 2
    assert "retry_after_s" in errors[0] and "args" in errors[1]


def test_fleet_config_block():
    scfg = ServingConfig.from_dict(
        {"fleet": {"num_replicas": 3, "max_queue_depth": 16,
                   "default_deadline_s": 30.0}})
    assert scfg.fleet.num_replicas == 3
    assert scfg.fleet.default_deadline_s == 30.0
    with pytest.raises(ValueError, match="unknown fleet config"):
        ServingConfig.from_dict({"fleet": {"replicas": 3}})
    with pytest.raises(ValueError, match="retry_max"):
        RouterConfig(retry_max=-1)


# ------------------------------------------------------------------ #
# a subprocess replica: a real SIGKILL mid-decode
# ------------------------------------------------------------------ #

_SUB_SPEC = {
    "gpt": {"vocab_size": 97, "n_layer": 2, "n_head": 2, "d_model": 32,
            "max_seq": 128, "remat": False, "attn_impl": "xla"},
    "init_seed": 0,
    "device": "cpu",
    "serving": {"num_slots": 4, "block_size": 8, "num_blocks": 64,
                "max_seq_len": 128, "max_new_tokens": 64,
                "prefill_buckets": [16, 128]},
    "warm": True,
}


def test_subprocess_sigkill_mid_decode_token_identity(tmp_path):
    """SIGKILL a subprocess replica mid-decode: the router requeues its
    rids and the retried greedy outputs equal an unkilled in-process
    engine's built from the same spec."""
    from deeperspeed_tpu_torch.serving.fleet import build_subprocess_fleet
    from deeperspeed_tpu_torch.serving.replica_worker import build_engine

    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 97, 8).tolist() for _ in range(4)]
    rids = [f"k{i}" for i in range(4)]
    ref_eng = build_engine(_SUB_SPEC)
    for p, rid in zip(prompts, rids):
        ref_eng.submit(p, max_new_tokens=96, request_id=rid)
    ref_eng.run()
    ref = {rid: ref_eng.get(rid).output for rid in rids}

    fleet = build_subprocess_fleet(2, _SUB_SPEC, workdir=str(tmp_path))
    assert all(r.ready_info.get("nvcc_s") == 0 for r in fleet)
    router = FleetRouter(fleet, _fleet_rcfg(heartbeat_timeout_s=30.0))
    try:
        for p, rid in zip(prompts, rids):
            router.submit(p, max_new_tokens=96, request_id=rid)
        router.step()
        # the decode counter moves past the warmup's tokens, so the
        # SIGKILL provably lands mid-decode
        deadline = time.time() + 60
        while fleet[0].progress < 12 and time.time() < deadline:
            router.step()
            time.sleep(0.005)
        assert fleet[0].progress >= 12, "replica never started decoding"
        fleet[0].kill()
        outcomes = router.run_until_idle(timeout_s=120)
        assert sorted(outcomes) == sorted(rids)
        assert set(outcomes.values()) == {"length"}, outcomes
        for rid in rids:
            assert router.result(rid).tokens == ref[rid], rid
        s = router.metrics.summary()
        assert any(d["cause"] == "dead" for d in s["replica_downs"])
        assert s["retries"] >= 1
    finally:
        router.shutdown()


def test_subprocess_replica_that_cannot_build_fails_start(tmp_path):
    """A child whose engine fails to build exits non-zero, and start()
    raises with its stderr: no quiet fallback."""
    from deeperspeed_tpu_torch.serving.fleet import SubprocessReplica

    spec = dict(_SUB_SPEC, gpt=dict(_SUB_SPEC["gpt"], dtype="float64"))
    rep = SubprocessReplica("bad", spec, workdir=str(tmp_path))
    with pytest.raises(RuntimeError, match="gpt.dtype must be one of"):
        rep.start()
    assert not rep.alive


def test_replica_weights_load_from_a_checkpoint(tmp_path):
    """A spec's "weights" block replaces the init with a checkpoint's
    module tree, leaf for leaf, in the init's dtypes (bf16 compute with
    fp32 layer norms); a mismatched tree raises."""
    from deeperspeed_tpu_torch.checkpoint.serialization import (
        model_state_filename, save_tree)
    from deeperspeed_tpu_torch.serving.replica_worker import build_engine

    spec = dict(_SUB_SPEC, gpt=dict(_SUB_SPEC["gpt"], dtype="bfloat16"))
    cfg = gpt.GPTConfig(**{**KW, "dtype": torch.bfloat16})
    params = gpt.init_params(7, cfg, device="cpu", dtype=torch.bfloat16)
    save_tree(str(tmp_path / "v1" / model_state_filename()),
              {"module": params})
    eng = build_engine(dict(spec, weights={"load_dir": str(tmp_path),
                                           "tag": "v1"}))
    got, want = eng.params, params
    assert got["layers"]["mlp"]["wi"].dtype == torch.bfloat16
    assert got["final_ln"]["scale"].dtype == torch.float32
    for key in ("wqkv", "bo"):
        assert torch.equal(got["layers"]["attn"][key],
                           want["layers"]["attn"][key])
    assert torch.equal(got["embed"]["wte"], want["embed"]["wte"])
    assert not torch.equal(build_engine(spec).params["embed"]["wte"],
                           want["embed"]["wte"])
    del params["lm_head"]
    save_tree(str(tmp_path / "bad" / model_state_filename()),
              {"module": params})
    with pytest.raises(ValueError, match="module keys"):
        build_engine(dict(spec, weights={"load_dir": str(tmp_path),
                                         "tag": "bad"}))


def test_idle_replica_given_work_is_not_stalled_at_once():
    """The port's one departure from the reference router: a replica
    idle for longer than progress_timeout_s that is then given work gets
    a full progress window; the reference marks it stalled on the next
    step."""
    downs = {}
    for pkg, P in PACKAGES.items():
        clock = FakeClock()
        router, stubs = _stub_router(P, clock, progress_timeout_s=5.0)
        _tick(clock, stubs, 20.0)
        router.step()                 # both idle since t=0
        router.submit([1, 2, 3], max_new_tokens=4)
        router.step()                 # dispatched at t=20
        _tick(clock, stubs, 21.0)
        router.step()
        downs[pkg] = [d["cause"] for d in
                      router.metrics.summary()["replica_downs"]]
        if pkg == "torch":
            _tick(clock, stubs, 26.0)  # 6 s of work without progress
            router.step()
            downs["torch_later"] = [d["cause"] for d in
                                    router.metrics.summary()["replica_downs"]]
    assert downs == {"jax": ["stalled"], "torch": [],
                     "torch_later": ["stalled"]}
