"""The port's autotuner (deeperspeed_tpu_torch/autotune/) against the
reference's (deeperspeed_tpu/autotune/), on the CPU.

* The search space: the layout, comm, kernel-route and serving
  enumerations and ``space_hash`` equal the reference's for worlds 1, 2,
  4 and 8 and two model specs (the reference's tiny model and
  GPT-NeoX-125M's facts); ``price_serving`` (speculative variants too),
  ``rank_candidates``, ``select_spread``, ``spearman`` and
  ``effective_micro`` give the reference's results.
* ``price_layout``'s wire, launch, ZeRO-gather and activation terms equal
  the reference's for the same layouts at world 8 (the reference's AOT
  capture on its 8 CPU devices, the port's on the meta device).
* The port's capture: its ``flops`` equal, and its bytes lie within 1 % of,
  what the live ``CompiledCostIndex`` records for one real step of the
  same candidate engine on 2 gloo ranks (tests/torch_gloo_worker.py's
  ``autotune_run``, one spawn for the file); it leaves the watchdog's
  signature caches and the kernel launch counters as they were, and a
  capture that runs a real step raises. A ZeRO-3 candidate comes back
  infeasible with the engine's refusal as its reason.
* ``python -m deeperspeed_tpu_torch.autotune --devices 2 --quick --top-k 2
  --steps 2 --warmup 1 --device cpu`` on the tiny model emits a config
  that loads in the port's ``TrainingConfig``, verifies in both packages'
  ``verify_provenance``, carries the reference CLI's ``space_hash`` for the
  same arguments, and trains 2 steps at world 2 (the same spawn).
* The ``"autotune"`` block is accepted, and refused when it is not a dict,
  as in the reference's tests/test_tuner.py.

The reference's ``test_autotune_metrics_registered_in_ledger`` has no
counterpart here: the port has no ``monitor/ledger.py`` yet (ROADMAP.md
section 1, item 12).
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deeperspeed_tpu.autotune import __main__ as ref_main
from deeperspeed_tpu.autotune import confirm as ref_confirm
from deeperspeed_tpu.autotune import costmodel as ref_cost
from deeperspeed_tpu.autotune import space as ref_space
from deeperspeed_tpu.autotune.capture import \
    sandboxed_cost_index as ref_index
from deeperspeed_tpu.autotune.provenance import \
    verify_provenance as ref_verify
from deeperspeed_tpu_torch.autotune import (aot_capture, confirm, costmodel,
                                            sandboxed_cost_index, space,
                                            verify_provenance)
from deeperspeed_tpu_torch.autotune.capture import kernel_launches
from deeperspeed_tpu_torch.monitor import init_monitor, shutdown_monitor
from deeperspeed_tpu_torch.monitor.config import MonitorConfig
from deeperspeed_tpu_torch.runtime.comm import wiremodel
from deeperspeed_tpu_torch.runtime.config import ConfigError, TrainingConfig
from tests import torch_gloo_worker as worker

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CLI_ARGS = ["--devices", "2", "--quick", "--top-k", "2", "--steps", "2",
            "--warmup", "1"]
SPECS = {"tiny": {},
         "neox125m": dict(vocab=50304, n_layer=12, n_head=12, d_model=768,
                          seq=2048)}
# world-2 layouts whose capture is held against a real step
LIVE = ("dp2", "fsdp2_zero2", "tp2", "sp2")
# world-8 layouts whose pricing terms are held against the reference's:
# the 2-D data mesh, the ZeRO gather, the tp and sp activations
TERMS = ("dp2_fsdp4", "fsdp8_zero2", "dp2_tp4", "dp2_sp4")
KERNELS = {"mode": "auto"}
BYTES_RTOL = 0.01
TINY = space.ModelSpec()
CPU = costmodel.platform_budget(world=2)


def _ident(cands):
    return [(c.name, tuple(c.axes), c.zero_stage) for c in cands]


def _serving_ident(cands):
    return [(s.name, s.block, tuple(s.prefill_buckets), s.kv_pool_bytes)
            for s in cands]


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The CLI run, started with the module (the other cases run while it
    works) and read where a case needs it."""
    d = tmp_path_factory.mktemp("autotune_cli")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeperspeed_tpu_torch.autotune", *CLI_ARGS,
         "--device", "cpu", "--out", "tuned.json", "--report",
         "report.json"], cwd=d, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    state = {"proc": proc, "dir": d}
    yield state
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(autouse=True)
def _start_cli(cli):
    yield


def _cli_result(cli):
    if "tuned" not in cli:
        out, _ = cli["proc"].communicate(timeout=600)
        assert cli["proc"].returncode == 0, out[-4000:]
        cli["tuned"] = json.loads((cli["dir"] / "tuned.json").read_text())
        cli["report"] = json.loads((cli["dir"] / "report.json").read_text())
    return cli


@pytest.fixture(scope="module")
def ranks(cli, tmp_path_factory):
    tuned = _cli_result(cli)["tuned"]
    d = tmp_path_factory.mktemp("autotune_ranks")
    layouts = [(c.name, [list(a) for a in c.axes], c.zero_stage)
               for c in space.enumerate_mesh_layouts(2, TINY)
               if c.name in LIVE]
    worker.spawn("autotune_run", 2, d, layouts, KERNELS, tuned)
    return [json.loads((d / f"autotune_rank{r}.json").read_text())
            for r in range(2)]


@pytest.fixture(autouse=True)
def _no_monitor_left():
    yield
    shutdown_monitor(save=False)


# ------------------------------------------------------------------ #
# the space
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_enumerations_and_space_hash_match_the_reference(world, spec):
    rm, pm = ref_space.ModelSpec(**SPECS[spec]), space.ModelSpec(
        **SPECS[spec])
    assert rm.as_dict() == pm.as_dict()
    assert rm.param_count() == pm.param_count()
    rl = ref_space.enumerate_mesh_layouts(world, rm)
    pl = space.enumerate_mesh_layouts(world, pm)
    assert _ident(pl) == _ident(rl)
    for kw in ({}, dict(max_tp=1, max_sp=1, zero_stages=(1,))):
        assert _ident(space.enumerate_mesh_layouts(world, pm, **kw)) == \
            _ident(ref_space.enumerate_mesh_layouts(world, rm, **kw))
    rc, pc = (ref_space.enumerate_comm_variants(),
              space.enumerate_comm_variants())
    assert [(c.name, c.block) for c in pc] == [(c.name, c.block) for c in rc]
    rr, pr = (ref_space.enumerate_kernel_routes(),
              space.enumerate_kernel_routes())
    assert pr == rr
    rs = ref_space.enumerate_serving_buckets(rm, draft_ks=(0, 4),
                                             pool_doublings=3)
    ps = space.enumerate_serving_buckets(pm, draft_ks=(0, 4),
                                         pool_doublings=3)
    assert _serving_ident(ps) == _serving_ident(rs)
    assert space.kv_pool_bytes(pm, 16, 33) == ref_space.kv_pool_bytes(
        rm, 16, 33)
    assert space.space_hash(world, pm, pl, pc, pr, ps) == \
        ref_space.space_hash(world, rm, rl, rc, rr, rs)
    # the hash moves with the space
    assert space.space_hash(world, pm, pl, pc[:1], pr, ps) != \
        space.space_hash(world, pm, pl, pc, pr, ps)


def test_serving_ranking_selection_and_rank_statistics_match_the_reference():
    for spec in SPECS.values():
        rm, pm = ref_space.ModelSpec(**spec), space.ModelSpec(**spec)
        rs = ref_space.enumerate_serving_buckets(rm, draft_ks=(0, 2, 4),
                                                 pool_doublings=6)
        ps = space.enumerate_serving_buckets(pm, draft_ks=(0, 2, 4),
                                             pool_doublings=6)
        for hbm in (0.25, 40.0):
            budget = {"hbm_bytes": hbm * (1 << 30), "source": "cpu"}
            for accept in (0.3, 0.7):
                want = [ref_cost.price_serving(s, rm, budget,
                                               accept_rate=accept).as_dict()
                        for s in rs]
                got = [costmodel.price_serving(s, pm, budget,
                                               accept_rate=accept).as_dict()
                       for s in ps]
                assert got == want
                rr, rp = ref_cost.rank_candidates(
                    [ref_cost.price_serving(s, rm, budget) for s in rs])
                pr, pp = costmodel.rank_candidates(
                    [costmodel.price_serving(s, pm, budget) for s in ps])
                assert [p.name for p in pr] == [p.name for p in rr]
                assert [(p.name, p.reason) for p in pp] == \
                    [(p.name, p.reason) for p in rp]
                for k in (1, 2, 3, 5):
                    for res in (5e-4, 0.05):
                        assert [p.name for p in confirm.select_spread(
                            pr, k, res)] == [p.name for p in
                                             ref_confirm.select_spread(
                                                 rr, k, res)]
    rng = np.random.RandomState(4)
    for n in (2, 3, 7):
        xs = rng.randint(0, 4, n).astype(float).tolist()
        ys = rng.standard_normal(n).tolist()
        assert confirm.spearman(xs, ys) == ref_confirm.spearman(xs, ys)
    entries = [{"name": "a", "predicted_step_s": 1.0, "step_ms": 3.0},
               {"name": "b", "predicted_step_s": 2.0, "step_ms": 2.0},
               {"name": "c", "predicted_step_s": 3.0, "error": "x"}]
    assert confirm.rank_correlation(entries) == \
        ref_confirm.rank_correlation(entries) == -1.0
    for world in (2, 8):
        for rl, pl in zip(ref_space.enumerate_mesh_layouts(world, TINY),
                          space.enumerate_mesh_layouts(world, TINY)):
            for micro in (1, 2):
                assert costmodel.effective_micro(pl, world, micro) == \
                    ref_cost.effective_micro(rl, world, micro)
    assert np.array_equal(confirm._token_stream(TINY, 3, 2, 5),
                          ref_confirm._token_stream(TINY, 3, 2, 5))


# ------------------------------------------------------------------ #
# pricing
# ------------------------------------------------------------------ #


@pytest.fixture(scope="module")
def reference_index():
    return ref_index()


@pytest.mark.parametrize("name", TERMS)
def test_layout_pricing_terms_match_the_reference(reference_index, name):
    rl = {c.name: c for c in ref_space.enumerate_mesh_layouts(8, TINY)}
    pl = {c.name: c for c in space.enumerate_mesh_layouts(8, TINY)}
    want, _ = ref_cost.price_layout(rl[name], TINY, 8,
                                    ref_cost.platform_budget(),
                                    index=reference_index)
    got, _ = costmodel.price_layout(pl[name], TINY, 8,
                                    costmodel.platform_budget(world=8))
    assert want.feasible and got.feasible, (want.reason, got.reason)
    assert got.detail["wire"] == want.detail["wire"]
    assert got.wire_bytes == want.wire_bytes
    assert got.launches == want.launches
    for key in ("act", "zero_gather", "data_axes", "zero_dense_ref"):
        assert got.detail.get(key) == want.detail.get(key), key
    # the port's own term: the engine's grad sum over a live sp axis
    sp = pl[name].extents()["sp"]
    assert got.detail.get("sp_grad_sum") == (None if sp == 1 else {
        "launches": 1.0,
        "bytes": float(wiremodel.dense_wire_bytes(TINY.param_count(), sp))})
    assert set(got.components) == set(want.components)
    assert got.predicted_step_s == pytest.approx(
        max(got.components["compute_s"], got.components["memory_s"])
        + got.components["wire_s"] + got.components["launch_s"])


@pytest.mark.parametrize("name", LIVE)
def test_capture_matches_the_live_index_on_a_real_step(ranks, name):
    """Each rank's planning capture against that rank's live record: the
    ranks of sp2's causal ring differ (rank 0 also masks the chunk it may
    not see), and the plans see it."""
    layout = {c.name: c for c in space.enumerate_mesh_layouts(2, TINY)}[name]
    recs = [costmodel.capture_rank(TINY, layout, 2, CPU, r, kernels=KERNELS)
            for r in range(2)]
    for rec, r in zip(recs, ranks):
        live = r["live"][name]
        assert rec.error is None and live["error"] is None
        assert rec.flops == live["flops"]
        assert rec.bytes_accessed == pytest.approx(live["bytes"],
                                                   rel=BYTES_RTOL)
        assert rec.peak_bytes >= rec.argument_bytes > 0
    if name == "sp2":
        assert recs[1].bytes_accessed < recs[0].bytes_accessed


def test_capture_keeps_the_process_clean_and_refuses_a_real_step():
    mon = init_monitor(MonitorConfig(perf=True, watchdog="strict"))
    layout = space.enumerate_mesh_layouts(1, TINY)[0]
    live = costmodel.build_candidate_engine(TINY, layout, 1, device="cpu")
    batch = confirm._token_stream(TINY, 2, 1)
    live.train_batch(batch)
    live.train_batch(batch)
    sizes = {n: f._cache_size() for n, f in mon.watchdog._fns.items()}
    launches = kernel_launches()
    idx = sandboxed_cost_index()
    for lc in space.enumerate_mesh_layouts(2, TINY)[:5]:
        p, _ = costmodel.price_layout(lc, TINY, 2, CPU, index=idx,
                                      kernels=KERNELS)
        assert p.feasible and math.isfinite(p.predicted_step_s)
    live.train_batch(batch)
    assert {n: f._cache_size() for n, f in
            mon.watchdog._fns.items()} == sizes
    assert not mon.watchdog.fired
    assert kernel_launches() == launches
    # the sandboxed index stays out of the live one
    assert set(mon.cost_index.records()) == {"engine/train_step"}

    # a capture whose function runs the engine's real step
    fresh = costmodel.build_candidate_engine(TINY, layout, 1, device="cpu")

    def real_step(state):
        fresh.train_batch(batch)

    real_step._cache_size = fresh._step_sigs._cache_size
    with pytest.raises(RuntimeError, match="signature cache"):
        aot_capture("real", real_step, ({},), index=idx)


def test_nccl_launch_overhead_is_left_unpriced():
    """NCCL's per-collective overhead is not measured: a candidate whose
    step launches collectives over it comes back infeasible, saying so; a
    single rank launches none and is priced."""
    assert costmodel.TRANSPORTS["nccl"]["launch_overhead_s"] is None
    nccl = {"transport": "nccl", "launch_overhead_s": None}
    dp2 = {c.name: c for c in space.enumerate_mesh_layouts(2, TINY)}["dp2"]
    price, _ = costmodel.price_layout(dp2, TINY, 2, dict(CPU, **nccl))
    assert not price.feasible and price.launches > 0
    assert price.reason.startswith("nccl launch overhead not measured")
    one = space.enumerate_mesh_layouts(1, TINY)[0]
    price, _ = costmodel.price_layout(
        one, TINY, 1, dict(costmodel.platform_budget(world=1), **nccl))
    assert price.feasible and price.components["launch_s"] == 0.0


def test_zero3_candidate_is_infeasible_with_the_engines_refusal():
    zero3 = [c for c in space.enumerate_mesh_layouts(2, TINY)
             if c.zero_stage == 3]
    assert [c.name for c in zero3] == ["fsdp2_zero3"]
    price, engine = costmodel.price_layout(zero3[0], TINY, 2, CPU)
    assert not price.feasible and engine is None
    assert "ZeRO stage 3" in price.reason and "ROADMAP" in price.reason
    ranked, pruned = costmodel.rank_candidates([price])
    assert not ranked and pruned == [price]


# ------------------------------------------------------------------ #
# the CLI, the emitted config and the config block
# ------------------------------------------------------------------ #


def test_cli_emits_a_config_that_loads_verifies_and_trains(cli, ranks):
    res = _cli_result(cli)
    tuned, report = res["tuned"], res["report"]
    want_keys = {"world", "platform", "model", "space_hash", "space_sizes",
                 "ranking", "comm_ranking", "kernel_ranking",
                 "serving_ranking", "pruned", "confirm", "best"}
    assert set(report) == want_keys
    # the reference CLI's space for the same arguments
    args = ref_main._parse_args(CLI_ARGS)
    ref = ref_main._enumerate_space(args, ref_space.ModelSpec(),
                                    ref_cost.platform_budget())
    assert report["space_hash"] == ref["hash"]
    assert tuned["provenance"]["space_hash"] == ref["hash"]
    assert report["space_sizes"] == {
        "layouts": len(ref["layouts"]), "comms": len(ref["comms"]),
        "kernel_routes": len(ref["routes"]),
        "servings": len(ref["servings"])}
    dp = tuned["train_batch_size"] // tuned["train_micro_batch_size_per_gpu"]
    before = json.dumps(tuned, sort_keys=True)
    TrainingConfig(tuned, world_size=dp)
    assert json.dumps(tuned, sort_keys=True) == before
    assert verify_provenance(tuned)[0], verify_provenance(tuned)
    assert ref_verify(tuned)[0], ref_verify(tuned)
    entries = report["confirm"]["entries"]
    assert len(entries) == 2 and not any("error" in e for e in entries)
    assert report["confirm"]["rank_correlation"] is not None
    # each confirmed run's first step, as the live cost index recorded it
    # on each rank, against the planning capture that priced it
    for e in entries:
        assert len(e["live_cost"]) == len(e["captured_cost"]) == 2
        for live, want in zip(e["live_cost"], e["captured_cost"]):
            assert live["error"] is None
            assert live["flops"] == want["flops"]
            assert live["bytes"] == pytest.approx(want["bytes"],
                                                  rel=BYTES_RTOL)
    assert all(p["reason"] for p in report["pruned"])
    # the emitted config trains at world 2, every rank the same losses
    losses = [r["tuned"]["losses"] for r in ranks]
    assert len(losses[0]) == 2 and all(map(math.isfinite, losses[0]))
    assert losses[0] == losses[1]
    assert ranks[0]["tuned"]["mesh"]["fsdp"] * \
        ranks[0]["tuned"]["mesh"]["dp"] == 2


def test_autotune_block_accepted_and_refused_when_not_a_dict():
    base = {"train_batch_size": 8, "optimizer": {"type": "Adam"}}
    tc = TrainingConfig(base)
    assert tc.autotune_params is None and not tc.autotune_enabled
    tc = TrainingConfig({**base, "autotune": {"enabled": True}})
    assert tc.autotune_enabled and tc.autotune_params == {"enabled": True}
    assert TrainingConfig({**base, "autotune": {}}).autotune_enabled
    assert not TrainingConfig(
        {**base, "autotune": {"enabled": False}}).autotune_enabled
    with pytest.raises(ConfigError, match='"autotune" must be a dict'):
        TrainingConfig({**base, "autotune": True})
    with pytest.raises(ConfigError, match="missing keys"):
        TrainingConfig({**base, "provenance": {"tool": "x"}})
