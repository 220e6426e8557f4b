"""Ranks of the port's multi-process CPU tests (torch.distributed, gloo).

``spawn(name, world, tmp, *args)`` starts ``world`` processes; each joins
a gloo group through a ``FileStore`` under ``tmp`` (no TCP port, so test
workers running side by side cannot collide), runs ``<name>(rank, world,
tmp, *args)`` of this module and writes its results under ``tmp``. A rank
that raises fails the spawn. This module imports torch and the port only:
the reference runs in the test process.

The rendezvous (``_rendezvous``) binds gloo to the loopback device
(``GLOO_SOCKET_IFNAME=lo``: the ranks share one host, and an interface
the hostname resolves to may refuse connections), gives it an explicit
timeout, checks the new group with one all-reduce, and has every rank
report its outcome in a file: when any rank failed to connect (a
connection refused while many ranks start at once on a loaded host), all
of them tear the group down and meet again on a fresh store. Only the
rendezvous is retried, never a rank's work.
"""

import datetime
import json
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# ------------------------------------------------------------------ #
# harness
# ------------------------------------------------------------------ #


RENDEZVOUS_ATTEMPTS = 4
RENDEZVOUS_TIMEOUT_S = 120


def _verdicts(tmp, attempt, rank, world, ok):
    """Write this rank's outcome of rendezvous ``attempt`` and wait for
    every rank's; True when all of them connected."""
    with open(os.path.join(tmp, f"rendezvous.{attempt}.{rank}"), "w") as f:
        f.write("ok" if ok else "fail")
    deadline = time.monotonic() + 2 * RENDEZVOUS_TIMEOUT_S
    got = {}
    while len(got) < world:
        for r in range(world):
            path = os.path.join(tmp, f"rendezvous.{attempt}.{r}")
            if r not in got and os.path.exists(path):
                with open(path) as f:
                    text = f.read()
                if text:
                    got[r] = text
        if len(got) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank {rank}: no rendezvous verdict from "
                                   f"ranks {sorted(set(range(world)) - set(got))}")
            time.sleep(0.05)
    return all(v == "ok" for v in got.values())


def _rendezvous(rank, world, tmp):
    """Join the gloo group of ``world`` ranks (module docstring)."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    timeout = datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S)
    err = None
    for attempt in range(RENDEZVOUS_ATTEMPTS):
        store = dist.FileStore(os.path.join(tmp, f"store.{attempt}"), world)
        ok = True
        try:
            dist.init_process_group("gloo", store=store, rank=rank,
                                    world_size=world, timeout=timeout)
            probe = torch.ones(1)
            dist.all_reduce(probe)
            ok = float(probe[0]) == world
        except RuntimeError as e:  # a refused or timed-out connection
            ok, err = False, e
        if _verdicts(tmp, attempt, rank, world, ok):
            return
        if dist.is_initialized():
            dist.destroy_process_group()
    raise RuntimeError(f"rank {rank}: gloo rendezvous failed "
                       f"{RENDEZVOUS_ATTEMPTS} times") from err


def _entry(rank, name, world, tmp, args):
    torch.set_num_threads(1)
    _rendezvous(rank, world, tmp)
    try:
        globals()[name](rank, world, tmp, *args)
    finally:
        # a live re-mesh may have left (or replaced) the default group
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(name, world, tmp, *args):
    mp.start_processes(_entry, args=(name, world, str(tmp), args),
                       nprocs=world, start_method="spawn", join=True)


def _tcp_entry(rank, name, world, tmp, port, args):
    torch.set_num_threads(1)
    os.environ.update(DS_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                      DS_NUM_PROCESSES=str(world), DS_PROCESS_ID=str(rank))
    globals()[name](rank, world, tmp, *args)


def spawn_tcp(name, world, tmp, port, *args):
    """Like ``spawn``, but the ranks join no group themselves: each gets
    the launcher's rendezvous env (a coordinator on ``port``) and
    ``<name>`` brings the group up."""
    mp.start_processes(_tcp_entry, args=(name, world, str(tmp), port, args),
                       nprocs=world, start_method="spawn", join=True)


# ------------------------------------------------------------------ #
# the reducer at W ranks
# ------------------------------------------------------------------ #

REDUCE_STEPS = 3
EF_ROUNDS = 24


def reduce_cases(world):
    """(name, CommConfig kwargs) of every reducer case at ``world``."""
    small = dict(bucket_mb=0.0005, block=32)
    cases = [(m, dict(small, mode=m))
             for m in ("fp32", "bf16", "int8", "compressed", "lossless")]
    cases.append(("int8-noef", dict(small, mode="int8",
                                    error_feedback=False)))
    if world == 4:
        for m in ("int8", "lossless"):
            cases.append((f"{m}-hier", dict(
                mode=m, bucket_mb=0.001, block=16, hierarchical="on",
                intra_size=2)))
    return cases


def grads_tree(seed, world):
    """Per-rank gradients, stacked (world, *shape), from a seed."""
    rng = np.random.default_rng(seed)
    return {
        "w1": rng.normal(size=(world, 40, 5)).astype(np.float32),
        "b1": rng.normal(size=(world, 13)).astype(np.float32),
        "w2": rng.normal(size=(world, 200)).astype(np.float32),
    }


def reduce_run(rank, world, tmp):
    from deeperspeed_tpu_torch.ops import kernel_config as kc
    from deeperspeed_tpu_torch.runtime.comm import CommConfig, GradReducer
    from deeperspeed_tpu_torch.sharding import mesh as pt_mesh

    mesh = pt_mesh.default_mesh()
    out = {}
    with kc.override(mode="fused"):
        for name, cfg in reduce_cases(world):
            red = GradReducer(CommConfig(**cfg), mesh)
            first = grads_tree(100, world)
            red.build_plan({k: torch.from_numpy(v[rank])
                            for k, v in first.items()})
            state = red.init_state("cpu")
            out[f"{name}/hier_k"] = np.asarray(red.hier_k or 0)
            out[f"{name}/n_buckets"] = np.asarray(red.n_buckets)
            for t in range(REDUCE_STEPS):
                stacked = grads_tree(100 + t, world)
                mean, state = red.reduce_dispatch(
                    {k: torch.from_numpy(v[rank]) for k, v in
                     stacked.items()}, state)
                for k, v in mean.items():
                    out[f"{name}/{t}/mean/{k}"] = v.numpy()
                for j, res in enumerate(state):
                    for k, v in res.items():
                        out[f"{name}/{t}/res/{j}/{k}"] = v.numpy()
        # the error-feedback running mean: the same grads, reduced again
        # and again, with and without error feedback
        stacked = grads_tree(2, world)
        local = {k: torch.from_numpy(v[rank]) for k, v in stacked.items()}
        for ef in (True, False):
            red = GradReducer(CommConfig(mode="int8", bucket_mb=0.001,
                                         block=32, error_feedback=ef), mesh)
            red.build_plan(local)
            state = red.init_state("cpu")
            acc = {k: torch.zeros_like(v) for k, v in local.items()}
            for _ in range(EF_ROUNDS):
                mean, state = red.reduce_dispatch(local, state)
                for k in acc:
                    acc[k] += mean[k]
            for k, v in acc.items():
                out[f"ef{int(ef)}/{k}"] = (v / EF_ROUNDS).numpy()
    np.savez(os.path.join(tmp, f"reduce_rank{rank}.npz"), **out)


# ------------------------------------------------------------------ #
# a tiny GPT trained at W ranks
# ------------------------------------------------------------------ #

TRAIN_STEPS = 6
SAVE_AFTER = 3


def train_config(zero, comm):
    """The tiny-GPT config: 2 ranks x micro-batch 2 x 2 accumulation
    steps, fp32, Adam with a warmup, clipping, ZeRO ``zero`` and the comm
    block ``comm`` (None: no block)."""
    cfg = {
        "train_batch_size": 8,
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 2,
        "optimizer": {"type": "Adam",
                      "params": {"lr": 3e-3, "betas": [0.9, 0.95]}},
        "scheduler": {"type": "WarmupDecayLR",
                      "params": {"warmup_max_lr": 3e-3,
                                 "warmup_num_steps": 3,
                                 "total_num_steps": 50}},
        "gradient_clipping": 0.5,
        "zero_optimization": {"stage": zero},
        "kernels": {"mode": "fused", "fused_blocks": False,
                    "supertile": False},
    }
    if comm is not None:
        cfg["comm"] = dict(comm, bucket_mb=0.05, block=32)
    return cfg


TRAIN_CASES = [(zero, comm) for comm in (None, "fp32", "int8")
               for zero in (0, 1, 2)]


def _engine(model_kw, zero, comm, params):
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models import gpt

    cfg = gpt.GPTConfig(**model_kw, dtype=torch.float32, attn_impl="xla")
    loss = gpt.make_gpt(cfg)[2]
    eng, _, _, _ = ds.initialize(
        model=loss, model_parameters=params,
        config=train_config(zero, None if comm is None else {"mode": comm}),
        device="cpu")
    return eng


def train_run(rank, world, tmp, model_kw, cases, resume):
    """Train each (zero, comm) of ``cases`` for the saved batches from the
    saved params; with ``resume``, the save-and-resume run too."""
    from deeperspeed_tpu_torch.ops.adam import tree_leaves

    params = torch.load(os.path.join(tmp, "params.pt"))
    batches = list(np.load(os.path.join(tmp, "batches.npy")))
    result = {}
    for zero, comm in cases:
        eng = _engine(model_kw, zero, comm, params)
        losses, norms, digests = [], [], []
        for b in batches:
            losses.append(float(eng.train_batch(b)))
            norms.append(eng.get_global_grad_norm())
            digests.append(_digest(tree_leaves(eng.params)))
        st = eng.master if eng.master is not None else eng._opt_target
        result[f"{zero}/{comm}"] = {
            "losses": losses, "grad_norms": norms, "digests": digests,
            "state_bytes": sum(t.numel() * t.element_size() for t in
                               tree_leaves(st) + tree_leaves(
                                   eng.opt_state.exp_avg)
                               + tree_leaves(eng.opt_state.exp_avg_sq)),
            "sharded": [sp.dim for sp in eng._specs],
        }
    if resume:
        result["resume"] = _resume(rank, tmp, model_kw, params, batches)
    with open(os.path.join(tmp, f"train_rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _resume(rank, tmp, model_kw, params, batches):
    """ZeRO 1 + int8: save after step 3, resume in a fresh engine from
    other weights, run steps 4-6: losses, params, moments and residuals
    must equal the uninterrupted run's."""
    from deeperspeed_tpu_torch.ops.adam import tree_leaves

    ckpt = os.path.join(tmp, "ckpt")
    eng = _engine(model_kw, 1, "int8", params)
    losses = []
    for i, b in enumerate(batches, 1):
        losses.append(float(eng.train_batch(b)))
        if i == SAVE_AFTER:
            eng.save_checkpoint(ckpt)
    final = _state_digests(eng)
    fresh = _engine(model_kw, 1, "int8", _tree_scale(params, 0.5))
    tag, _ = fresh.load_checkpoint(ckpt)
    resumed = [float(fresh.train_batch(b)) for b in batches[SAVE_AFTER:]]
    return {"tag": os.path.basename(tag), "losses": losses,
            "resumed": resumed, "final": final,
            "final_resumed": _state_digests(fresh),
            "residual_norm": float(sum(
                float(v.abs().sum()) for r in eng._comm_state
                for v in r.values())),
            "global_steps": fresh.global_steps,
            "leaves": len(tree_leaves(eng.params))}


def _tree_scale(tree, s):
    if isinstance(tree, dict):
        return {k: _tree_scale(v, s) for k, v in tree.items()}
    return tree * s


def _state_digests(eng):
    from deeperspeed_tpu_torch.ops.adam import tree_leaves

    master = eng.master if eng.master is not None else eng._opt_target
    return {"params": _digest(tree_leaves(eng.params)),
            "master": _digest(tree_leaves(master)),
            "exp_avg": _digest(tree_leaves(eng.opt_state.exp_avg)),
            "exp_avg_sq": _digest(tree_leaves(eng.opt_state.exp_avg_sq)),
            "residuals": _digest([v for r in eng._comm_state
                                  for v in r.values()])}


# ------------------------------------------------------------------ #
# the monitor of a data-parallel run
# ------------------------------------------------------------------ #


def monitor_run(rank, world, tmp, model_kw, config, steps):
    """Train a tiny GPT under ``config`` (configs/gpt_125m_comm.json's
    blocks, its "monitor" block included) for ``steps`` steps; save this
    rank's trace under its own role lane and write the reducer's plan and
    the monitor's counters to ``monitor<rank>.json``."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models import gpt

    cfg = gpt.GPTConfig(**model_kw)
    params = gpt.init_params(0, cfg, device="cpu")
    eng, _, _, _ = ds.initialize(model=gpt.make_gpt(cfg)[2],
                                 model_parameters=params, config=config,
                                 device="cpu")
    rows = config["train_batch_size"]
    rs = np.random.RandomState(5)
    for _ in range(steps):
        eng.train_batch(rs.randint(0, cfg.vocab_size,
                                   (rows, cfg.max_seq + 1)))
    mon = eng.monitor
    rc = mon.run_context
    trace = mon.save_trace(os.path.join(
        tmp, f"{rc.role}.i{rc.incarnation}.trace.json"))
    out = {"role": rc.role, "trace": trace,
           "n_buckets": eng.comm.n_buckets,
           "wire_bytes_per_step": eng.comm.total_wire_bytes()}
    for name in ("comm_buckets", "comm_wire_bytes", "train_steps_total"):
        out[name] = mon.registry.counter(name).value
    with open(os.path.join(tmp, f"monitor{rank}.json"), "w") as f:
        json.dump(out, f)


# ------------------------------------------------------------------ #
# the streamed engine refuses a data-parallel world
# ------------------------------------------------------------------ #


def streaming_refusal(rank, world, tmp, model_kw, config):
    """``initialize`` a GPTConfig under a streaming ``config`` on every
    rank; write the NotImplementedError's text to ``refusal<rank>.txt``
    (a rank that builds an engine raises)."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models import gpt

    try:
        ds.initialize(model=gpt.GPTConfig(**model_kw), config=config,
                      device="cpu")
    except NotImplementedError as e:
        with open(os.path.join(tmp, f"refusal{rank}.txt"), "w") as f:
            f.write(str(e))
        return
    raise AssertionError(f"rank {rank} built a streamed engine")


# ------------------------------------------------------------------ #
# the datapipe under data parallelism
# ------------------------------------------------------------------ #


def datapipe_rows(rank, world, tmp, model_kw, config, steps):
    """Train ``steps`` steps from the config's datapipe (no batch passed)
    and save the rows this rank's step consumed, its losses and its
    DataState."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models import gpt

    params = torch.load(os.path.join(tmp, "params.pt"))
    cfg = gpt.GPTConfig(**model_kw, dtype=torch.float32, attn_impl="xla")
    eng, _, _, _ = ds.initialize(model=gpt.make_gpt(cfg)[2],
                                 model_parameters=params, config=config,
                                 device="cpu")
    rows = []
    pull = eng.datapipe.next_global_batch

    def recording():
        batch, placed = pull()
        rows.append(np.asarray(batch))
        return batch, placed

    eng.datapipe.next_global_batch = recording
    losses = [float(eng.train_batch()) for _ in range(steps)]
    eng.datapipe.close()
    np.save(os.path.join(tmp, f"rows{rank}.npy"), np.stack(rows))
    with open(os.path.join(tmp, f"datapipe_rank{rank}.json"), "w") as f:
        json.dump({"losses": losses,
                   "state": eng.datapipe.state_dict()}, f)


# ------------------------------------------------------------------ #
# elasticity: the canonical-slot step and cross-world residuals
# ------------------------------------------------------------------ #


def elastic_run(rank, world, tmp, model_kw, config, steps, save_dir,
                load_dir, tag, device="cpu"):
    """Train ``steps`` steps of the tiny GPT under ``config`` (batches
    keyed by the global step), after loading ``load_dir`` when given and
    saving into ``save_dir`` at the end when given; write the losses (as
    hex), the residual rows, what the load reported, and the monitor's
    ``resilience/comm_reshard`` instants to ``<tag>_rank<r>.json``. On
    ``device="cuda"`` every rank runs on the one card (gloo through host
    copies)."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models import gpt
    from deeperspeed_tpu_torch.monitor import (get_monitor, init_monitor,
                                               shutdown_monitor)

    init_monitor({})
    params = torch.load(os.path.join(tmp, "params.pt"))
    cfg = gpt.GPTConfig(**model_kw, dtype=torch.float32, attn_impl="xla")
    eng, _, _, _ = ds.initialize(model=gpt.make_gpt(cfg)[2],
                                 model_parameters=params, config=config,
                                 device=device)
    loaded = None
    if load_dir is not None:
        loaded, _ = eng.load_checkpoint(load_dir)
    rows = eng._config.train_batch_size
    res_after_load = [{k: v.cpu().tolist() for k, v in r.items()}
                      for r in eng._comm_state]
    losses = []
    for _ in range(steps):
        s = eng.global_steps
        batch = np.random.RandomState(1000 + s).randint(
            0, model_kw["vocab_size"], (rows, model_kw["max_seq"] + 1))
        losses.append(float(eng.train_batch(batch)).hex())
    if save_dir is not None:
        eng.save_checkpoint(save_dir)
    events = [e for e in get_monitor().tracer.events()
              if e.get("name") == "resilience/comm_reshard"]
    shutdown_monitor(save=False)
    with open(os.path.join(tmp, f"{tag}_rank{rank}.json"), "w") as f:
        json.dump({"losses": losses, "loaded": loaded,
                   "res_after_load": res_after_load,
                   "reshard": [e["args"] for e in events],
                   "canonical": eng.canonical_shards,
                   "micro": eng._config.train_micro_batch_size_per_gpu,
                   "gas": eng._config.gradient_accumulation_steps}, f)


# ------------------------------------------------------------------ #
# the distributed bootstrap
# ------------------------------------------------------------------ #


def bootstrap_run(rank, world, tmp):
    """Join the group through ``bootstrap`` (TCPStore at the launcher's
    coordinator), call it again (adopted), all-reduce once, and report."""
    from deeperspeed_tpu_torch.distributed import bootstrap
    from deeperspeed_tpu_torch.distributed.config import DistributedConfig
    from deeperspeed_tpu_torch.monitor import (get_monitor, init_monitor,
                                               shutdown_monitor)

    os.environ["DS_TPU_RENDEZVOUS_DIR"] = os.path.join(tmp, "rdzv")
    os.environ.pop("DS_TPU_ROLE", None)
    init_monitor({})
    topo = bootstrap.bootstrap(DistributedConfig(init_timeout_s=30.0))
    again = bootstrap.bootstrap(DistributedConfig())
    t = torch.full((1,), float(rank + 1))
    dist.all_reduce(t)
    spans = [e for e in get_monitor().tracer.events()
             if e.get("name") == "dist/init"]
    with open(os.path.join(tmp, f"boot{rank}.json"), "w") as f:
        json.dump({"topology": topo.as_args(),
                   "backend": topo.cpu_collectives,
                   "again_same": again is topo, "sum": float(t),
                   "dist_init_spans": len(spans)}, f)
    shutdown_monitor(save=False)
    bootstrap.shutdown()


# ------------------------------------------------------------------ #
# the live re-mesh (lifecycle/)
# ------------------------------------------------------------------ #


def remesh_run(rank, world, tmp, model_kw, config, steps, signal_before,
               pool, tag, device="cpu"):
    """Train ``steps`` steps of the tiny GPT under ``config`` (batches
    keyed by the global step; ``config`` carries a "lifecycle" block whose
    pool file is ``<tmp>/pool``). Before step ``signal_before`` rank 0
    writes ``pool`` into the pool file and takes the re-mesh signal (the
    other ranks only learn of it through the step boundary's agreement).
    A rank the re-mesh retires exits 0. Writes the losses and grad norms
    (hex), a digest of the params after each step, the world after each
    step, the number of ``lifecycle/remesh`` spans and whether the rank
    retired to ``<tag>_rank<r>.json``."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models import gpt
    from deeperspeed_tpu_torch.monitor import (get_monitor, init_monitor,
                                               shutdown_monitor)
    from deeperspeed_tpu_torch.resilience import shutdown_resilience

    init_monitor({})
    params = torch.load(os.path.join(tmp, "params.pt"))
    cfg = gpt.GPTConfig(**model_kw, dtype=torch.float32, attn_impl="xla")
    eng, _, _, _ = ds.initialize(model=gpt.make_gpt(cfg)[2],
                                 model_parameters=params, config=config,
                                 device=device)
    out = {"losses": [], "gnorms": [], "params": [], "worlds": [],
           "retired": None}
    rows = eng._config.train_batch_size
    try:
        for _ in range(steps):
            s = eng.global_steps
            if s == signal_before and rank == 0:
                with open(os.path.join(tmp, "pool"), "w") as f:
                    f.write(f"{pool}\n")
                getattr(eng._lifecycle, "remesh", eng._lifecycle).request()
            batch = np.random.RandomState(1000 + s).randint(
                0, model_kw["vocab_size"], (rows, model_kw["max_seq"] + 1))
            out["losses"].append(float(eng.train_batch(batch)).hex())
            out["gnorms"].append(eng.get_global_grad_norm().hex())
            out["params"].append(_digest(
                [t.cpu() for t in _leaves(eng.params)]))
            out["worlds"].append(eng.data_parallel_size)
    except SystemExit as e:
        out["retired"] = e.code
    finally:
        out["spans"] = sum(1 for e in get_monitor().tracer.events()
                           if e.get("name") == "lifecycle/remesh")
        out["micro_gas"] = [eng._config.train_micro_batch_size_per_gpu,
                            eng._config.gradient_accumulation_steps]
        shutdown_monitor(save=False)
        shutdown_resilience()
        with open(os.path.join(tmp, f"{tag}_rank{rank}.json"), "w") as f:
            json.dump(out, f)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


# ------------------------------------------------------------------ #
# the 1-bit wire (runtime/comm/onebit_spmd.py)
# ------------------------------------------------------------------ #


def onebit_problem(seed, W):
    """A linear regression of W * 4 rows (numpy, from ``seed``): params,
    batch (x, y)."""
    r = np.random.default_rng(seed)
    x = r.normal(size=(W * 4, 8)).astype(np.float32)
    y = r.normal(size=(W * 4, 2)).astype(np.float32)
    params = {"w": (r.normal(size=(8, 2)) * 0.3).astype(np.float32),
              "b": np.zeros((2,), np.float32)}
    return params, (x, y)


def onebit_linear_loss(p, batch):
    x, y = batch
    return torch.mean((x @ p["w"] + p["b"] - y) ** 2)


def onebit_wire_run(rank, world, tmp, n, rounds, seed, lr, steps):
    """The 1-bit and 24-bit wire at ``world`` ranks on per-rank inputs from
    ``seed``: ``rounds`` calls each of ``compressed_all_reduce``,
    ``onebit_all_reduce`` and ``onebit_all_reduce_2phase`` (threading the
    error buffers), then ``steps`` steps (one warmup, the rest compressed)
    of the 1-bit Adam and LAMB wire train steps on ``onebit_problem``.
    Writes everything to ``wire_rank<r>.npz``."""
    from deeperspeed_tpu_torch.runtime.comm import compressed as cp
    from deeperspeed_tpu_torch.runtime.comm import onebit_spmd as osp
    from deeperspeed_tpu_torch.runtime.comm.onebit import (OnebitAdam,
                                                           OnebitLamb)

    g = dist.group.WORLD
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((rounds, world, n)).astype(np.float32)
    out = {}
    out["ar24"] = np.stack([cp.compressed_all_reduce(
        torch.from_numpy(xs[r, rank]), g).numpy() for r in range(rounds)])
    err = None
    means, errs = [], []
    for r in range(rounds):
        mean, err = cp.onebit_all_reduce(torch.from_numpy(xs[r, rank]), g,
                                         err)
        means.append(mean.numpy())
        errs.append(err.numpy())
    out["ob_mean"], out["ob_err"] = np.stack(means), np.stack(errs)
    werr = torch.zeros(n)
    serr = torch.zeros(osp._chunk_len(n, world))
    means, werrs, serrs = [], [], []
    for r in range(rounds):
        mean, werr, serr = osp.onebit_all_reduce_2phase(
            torch.from_numpy(xs[r, rank]), g, werr, serr, world)
        means.append(mean.numpy())
        werrs.append(werr.numpy())
        serrs.append(serr.numpy())
    out["tp_mean"], out["tp_werr"], out["tp_serr"] = (
        np.stack(means), np.stack(werrs), np.stack(serrs))
    params, (x, y) = onebit_problem(seed, world)
    batch = (torch.from_numpy(x), torch.from_numpy(y))
    for name, opt, make in (
            ("adam", OnebitAdam(lr=lr, freeze_step=1),
             osp.make_onebit_spmd_train_step),
            ("lamb", OnebitLamb(lr=lr, freeze_step=1),
             osp.make_onebit_lamb_spmd_train_step)):
        p = {k: torch.from_numpy(v) for k, v in params.items()}
        init, warm = make(onebit_linear_loss, opt, g, "warmup")
        _, comp = make(onebit_linear_loss, opt, g, "compressed")
        comm = init(p)
        losses = []
        for i in range(steps):
            fn = warm if i == 0 else comp
            p, comm, loss = fn(p, comm, batch, lr, i + 1)
            losses.append(float(loss))
        out[f"{name}_w"], out[f"{name}_b"] = p["w"].numpy(), p["b"].numpy()
        out[f"{name}_loss"] = np.asarray(losses)
        out[f"{name}_werr"] = comm.werr.numpy()
    np.savez(os.path.join(tmp, f"wire_rank{rank}.npz"), **out)


def fleet_trainer(work):
    """A trainer process of a ``FleetSupervisor`` (``python -c`` entry):
    joins the group its environment describes, trains the tiny GPT of
    ``<work>/spec.json`` (model, config, steps) on batches keyed by the
    step, holding before each step the count ``<work>/allow`` does not
    allow yet, and logs one JSON line a step (or its retirement) to
    ``<work>/steps.h<rank>``."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.distributed import bootstrap
    from deeperspeed_tpu_torch.models import gpt

    torch.set_num_threads(1)
    bootstrap.bootstrap()
    spec = json.load(open(os.path.join(work, "spec.json")))
    model_kw = spec["model"]
    cfg = gpt.GPTConfig(**model_kw, dtype=torch.float32, attn_impl="xla")
    eng, _, _, _ = ds.initialize(
        model=gpt.make_gpt(cfg)[2],
        model_parameters=torch.load(os.path.join(work, "params.pt")),
        config=spec["config"], device="cpu")
    path = os.path.join(work, f"steps.h{os.environ['DS_PROCESS_ID']}")

    def line(rec):
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    rows = eng._config.train_batch_size
    try:
        while eng.global_steps < spec["steps"]:
            while eng.global_steps >= int(open(os.path.join(
                    work, "allow")).read()):
                time.sleep(0.01)
            s = eng.global_steps
            batch = np.random.RandomState(1000 + s).randint(
                0, model_kw["vocab_size"], (rows, model_kw["max_seq"] + 1))
            line({"step": s + 1, "loss": float(eng.train_batch(batch)).hex(),
                  "world": eng.data_parallel_size})
    except SystemExit as e:
        line({"retired": e.code, "after_step": eng.global_steps})
        raise


# ------------------------------------------------------------------ #
# Mixture-of-Experts over data x expert
# ------------------------------------------------------------------ #

MOE_STEPS = 3


def _expert_chunk(t, spec, mesh):
    """This rank's chunk of a whole leaf along its ``expert`` dim."""
    if spec is None or "expert" not in spec:
        return t
    dim = spec.index("expert")
    ep = mesh.shape["expert"]
    m = t.shape[dim] // ep
    return t.narrow(dim, mesh.coords()["expert"] * m, m)


def moe_ffn_run(rank, world, tmp, dims, cases):
    """``moe_ffn`` on this rank's rows (its data rank's block of the saved
    global ``x``) and experts, for each (name, MoEConfig kwargs) of
    ``cases``; the rank's loss is ``dp * sum(y * w) + aux + z`` (its share
    of the global ``sum(y * w) + aux + z`` under the engine's mean over
    the data ranks). Writes y, the aux terms and the grads of x and of
    every param."""
    from deeperspeed_tpu_torch.models import moe
    from deeperspeed_tpu_torch.parallel import build_mesh

    mesh = build_mesh(dims)
    data = np.load(os.path.join(tmp, "moe_ffn.npz"))
    specs = moe.moe_param_specs()
    dp = mesh.shape.get("data", 1)
    d = mesh.coords().get("data", 0)
    rows = data["x"].shape[0] // dp
    out = {}
    for name, kw in cases:
        cfg = moe.MoEConfig(**kw)
        params = {
            "router": {"wg": torch.tensor(data["wg"])},
            "experts": {k: _expert_chunk(torch.tensor(data[k]),
                                         specs["experts"][k], mesh)
                        for k in ("wi", "bi", "wo", "bo")}}
        leaves = [params["router"]["wg"]] + [params["experts"][k] for k in
                                             ("wi", "bi", "wo", "bo")]
        for t in leaves:
            t.requires_grad_(True)
        x = torch.tensor(data["x"][d * rows:(d + 1) * rows],
                         requires_grad=True)
        w = torch.tensor(data["w"][d * rows:(d + 1) * rows])
        y, aux = moe.moe_ffn(params, x, cfg, mesh=mesh)
        loss = dp * (y * w).sum() + aux["aux_loss"] + aux["z_loss"]
        grads = torch.autograd.grad(loss, leaves + [x])
        out[name] = {"y": y.detach().numpy(),
                     "aux": {k: float(v) for k, v in aux.items()},
                     "grads": [g.numpy() for g in grads]}
    with open(os.path.join(tmp, f"moe_ffn_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def moe_dp_run(rank, world, tmp):
    """The dense MoE GPT on the engine's default mesh (every rank on
    ``data``) with a loss built without a mesh (``make_gpt(cfg)``): its
    MoE layers take the engine's active mesh. Rank 0 writes the losses."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models import gpt

    spec = json.load(open(os.path.join(tmp, "moe_train.json")))
    batches = list(np.load(os.path.join(tmp, "moe_batches.npy")))
    cfg = gpt.GPTConfig(**spec["model"], dtype=torch.float32)
    eng, _, _, _ = ds.initialize(
        model=gpt.make_gpt(cfg)[2],
        model_parameters=torch.load(os.path.join(tmp, "moe_params.pt")),
        config=moe_config(), device="cpu")
    losses = [float(eng.train_batch(b)) for b in batches]
    if rank == 0:
        with open(os.path.join(tmp, "moe_dp.json"), "w") as f:
            json.dump({"losses": losses, "dp": eng.data_parallel_size}, f)


def moe_config():
    """The MoE engine config: micro-batch 2 a data rank, fp32, Adam with
    clipping, ZeRO 1."""
    return {"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "Adam",
                          "params": {"lr": 3e-3, "betas": [0.9, 0.95]}},
            "gradient_clipping": 0.5, "zero_optimization": {"stage": 1}}


def moe_train_run(rank, world, tmp, dims):
    """``initialize`` -> ``train_batch`` for the saved batches on the mesh
    ``dims``, once a dispatch impl of ``moe_train.json``; rank 0 writes
    the losses and the whole params after the last step (gathered over the
    expert axis), and after the dense run every rank saves a checkpoint."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models import convert, gpt
    from deeperspeed_tpu_torch.parallel import build_mesh

    spec = json.load(open(os.path.join(tmp, "moe_train.json")))
    batches = list(np.load(os.path.join(tmp, "moe_batches.npy")))
    mesh = build_mesh(dims)
    result = {}
    for impl in spec["impls"]:
        cfg = gpt.GPTConfig(**spec["model"], moe_dispatch_impl=impl,
                            dtype=torch.float32)
        _, _, loss_fn, specs = gpt.make_gpt(cfg, mesh)
        eng, _, _, _ = ds.initialize(
            model=loss_fn,
            model_parameters=torch.load(os.path.join(tmp, "moe_params.pt")),
            config=moe_config(), device="cpu", mesh=mesh,
            param_specs=specs)
        losses = [float(eng.train_batch(b)) for b in batches]
        whole = eng._model_whole(eng.params)
        result[impl] = {
            "losses": losses,
            "params": {k: t.detach().numpy()
                       for k, t in convert._flatten(whole).items()},
            "local_experts": int(eng.params["layers"]["moe"]["experts"]
                                 ["wi"].shape[1]),
            "dp": eng.data_parallel_size}
        if impl == "dense":
            eng.save_checkpoint(os.path.join(tmp, "moe_ckpt"))
    # a "comm" block over 2 data ranks is refused for an MoE model
    try:
        ds.initialize(model=loss_fn, model_parameters=torch.load(
            os.path.join(tmp, "moe_params.pt")), config=dict(
                moe_config(), comm={"mode": "fp32"}), device="cpu",
            mesh=mesh, param_specs=specs)
        result["comm_refusal"] = None
    except NotImplementedError as e:
        result["comm_refusal"] = str(e)
    if rank == 0:
        with open(os.path.join(tmp, "moe_train.pkl"), "wb") as f:
            pickle.dump(result, f)


# ------------------------------------------------------------------ #
# the backward-overlap schedule
# ------------------------------------------------------------------ #


def overlap_run(rank, world, tmp, model_kw, steps):
    """The tiny GPT at 2 accumulation steps under each comm wire (fp32,
    int8) with overlap off and on, through ``train_batch`` and through
    ``forward``/``backward``/``step``: each step's params digest and loss,
    the residuals, and the overlap runs' span counts."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models import gpt
    from deeperspeed_tpu_torch.ops.adam import tree_leaves

    params = torch.load(os.path.join(tmp, "params.pt"))
    batches = list(np.load(os.path.join(tmp, "batches.npy")))[:steps]
    cfg = gpt.GPTConfig(**model_kw, dtype=torch.float32, attn_impl="xla")
    result = {}
    for mode in ("fp32", "int8"):
        for overlap in ("off", "on"):
            for path in ("train_batch", "imperative"):
                config = train_config(1, {"mode": mode, "overlap": overlap})
                eng, _, _, _ = ds.initialize(
                    model=gpt.make_gpt(cfg)[2], model_parameters=params,
                    config=config, device="cpu")
                gas = eng.gradient_accumulation_steps()
                losses, digests = [], []
                for b in batches:
                    if path == "train_batch":
                        losses.append(float(eng.train_batch(b)).hex())
                    else:
                        half = len(b) // gas
                        for i in range(gas):
                            loss = eng.forward(b[i * half:(i + 1) * half])
                            eng.backward(loss)
                            eng.step()
                        losses.append(float(loss).hex())
                    digests.append(_digest(tree_leaves(eng.params)))
                sched = eng._comm_overlap
                result[f"{mode}/{overlap}/{path}"] = {
                    "losses": losses, "digests": digests,
                    "residuals": _digest([v for r in eng._comm_state
                                          for v in r.values()]),
                    "scheduler": sched is not None,
                    "pending": sched.pending_buckets if sched else 0,
                    "in_backward": eng.overlap_launched_in_backward,
                    "buckets": eng.comm.n_buckets}
    # the reducer's own async dispatch: the same bits as its serial one
    from deeperspeed_tpu_torch.runtime.comm.overlap import OverlapScheduler

    red = eng.comm
    grads = _randomized(params, torch.Generator().manual_seed(rank))
    state = red.init_state("cpu")
    serial, s1 = red.reduce_dispatch(grads, state)
    sched = OverlapScheduler()
    launched, s2 = red.reduce_dispatch(grads, state, overlap=sched)
    sched.close()
    result["reduce_dispatch_overlap_equal"] = (
        _digest(tree_leaves(serial)) == _digest(tree_leaves(launched))
        and _digest([v for r in s1 for v in r.values()])
        == _digest([v for r in s2 for v in r.values()]))
    with open(os.path.join(tmp, f"overlap_rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _randomized(tree, gen):
    if isinstance(tree, dict):
        return {k: _randomized(v, gen) for k, v in tree.items()}
    return 0.01 * torch.randn(tree.shape, generator=gen)


# ------------------------------------------------------------------ #
# tensor and sequence parallelism
# ------------------------------------------------------------------ #


def _tree_leaves(tree):
    """Leaves in insertion order (the engine's ``tree_leaves``)."""
    from deeperspeed_tpu_torch.ops.adam import tree_leaves

    return tree_leaves(tree)


def _tp_rank_data(mesh, batch):
    """This rank's rows of a global batch (its data rank's block)."""
    from deeperspeed_tpu_torch.sharding import rules

    return rules.place_batch(mesh, batch)


def tp_layers_run(rank, world, tmp, dims):
    """The TP layers of parallel/tp.py on this rank's part of the saved
    whole params: each layer's output and the grads of its input and of
    every param (gathered whole), for ``sum(out * w)``; plus the column ->
    row pair with a plain differentiable all-reduce in place of g and
    with no f, whose grads must then be wrong."""
    from deeperspeed_tpu_torch.parallel import build_mesh
    from deeperspeed_tpu_torch.parallel import tp

    mesh = build_mesh(dims)
    data = np.load(os.path.join(tmp, "tp_layers.npz"))
    D, F, V = 16, 32, 50
    col = tp.ColumnParallelLinear(D, F, mesh=mesh)
    row = tp.RowParallelLinear(F, D, mesh=mesh)
    mlp = tp.ParallelMLP(D, F, mesh=mesh)
    emb = tp.VocabParallelEmbedding(V, D, mesh=mesh)
    gather_col = tp.ColumnParallelLinear(D, F, gather_output=True,
                                         mesh=mesh)
    row_scatter = tp.RowParallelLinear(F, D, input_is_parallel=False,
                                       mesh=mesh)
    whole = {"col": {"w": data["col_w"], "b": data["col_b"]},
             "row": {"w": data["row_w"], "b": data["row_b"]},
             "emb": {"w": data["emb_w"]}}
    whole = {k: {n: torch.tensor(a) for n, a in v.items()}
             for k, v in whole.items()}
    out = {}

    def run(name, fn, params, x, w, specs):
        leaves = [t.requires_grad_(True) for t in _tree_leaves(params)]
        if x.is_floating_point():
            x = x.clone().requires_grad_(True)
        y = fn(params, x)
        loss = (y * w).sum()
        grads = torch.autograd.grad(loss, leaves + ([x] if x.requires_grad
                                                    else []))
        from deeperspeed_tpu_torch.runtime.engine import tree_unflatten

        g_whole = tp.gather_tree(tree_unflatten(params, list(
            grads[:len(leaves)])), specs, mesh)
        out[name] = {"y": y.detach().numpy(),
                     "grads": {k: v.numpy() for k, v in
                               _flat(g_whole).items()},
                     "x_grad": (grads[-1].numpy() if x.requires_grad
                                else None)}

    x = torch.tensor(data["x"])
    pc, pr = col.shard(whole["col"]), row.shard(whole["row"])
    pair = {"col": pc, "row": pr}
    pair_specs = {"col": col.specs, "row": row.specs}
    run("pair", lambda p, x: row.apply(p["row"], col.apply(p["col"], x)),
        {k: {n: t.clone() for n, t in v.items()} for k, v in pair.items()},
        x, torch.tensor(data["w_out"]), pair_specs)
    run("mlp", lambda p, x: mlp.apply(p, x),
        mlp.shard({"up": whole["col"], "down": whole["row"]}), x,
        torch.tensor(data["w_out"]), mlp.specs)
    run("gather_col", lambda p, x: gather_col.apply(p, x),
        gather_col.shard(whole["col"]), x, torch.tensor(data["w_col"]),
        gather_col.specs)
    run("row_scatter", lambda p, x: row_scatter.apply(p, x),
        row_scatter.shard(whole["row"]), torch.tensor(data["h"]),
        torch.tensor(data["w_out"]), row_scatter.specs)
    run("emb", lambda p, x: emb.apply(p, x), emb.shard(whole["emb"]),
        torch.tensor(data["tok"]), torch.tensor(data["w_emb"]), emb.specs)
    # the double count: a plain differentiable all-reduce (its backward
    # all-reduces too, as torch.distributed.nn's does) in place of g, and
    # the under-count: no f on the column's input
    group = tp.tp_transport(mesh)

    class PlainAllReduce(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return group.all_reduce_sum(x)

        @staticmethod
        def backward(ctx, g):
            return group.all_reduce_sum(g)

    def plain_g(p, x):
        h = col.apply(p["col"], x)
        return PlainAllReduce.apply(h @ p["row"]["w"]) + p["row"]["b"]

    def no_f(p, x):
        h = x @ p["col"]["w"] + p["col"]["b"]
        return row.apply(p["row"], h)

    for name, fn in (("plain_g", plain_g), ("no_f", no_f)):
        run(name, fn, {k: {n: t.clone().detach() for n, t in v.items()}
                       for k, v in pair.items()},
            x, torch.tensor(data["w_out"]), pair_specs)
    mpu = tp.ModelParallelUnit(mesh)
    out["mpu"] = {
        "mp_rank": mpu.get_model_parallel_rank(),
        "mp_size": mpu.get_model_parallel_world_size(),
        "dp_rank": mpu.get_data_parallel_rank(),
        "dp_size": mpu.get_data_parallel_world_size(),
        "mp_group_ranks": dist.get_process_group_ranks(
            mpu.get_model_parallel_group())}
    with open(os.path.join(tmp, f"tp_layers_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def ring_run(rank, world, tmp, dims):
    """Ring and Ulysses attention, causal and not, on this rank's chunks
    of the saved global q, k, v (B, S, H, Dh): the output chunk and the
    grads of the chunks for ``sum(out * w)``."""
    from deeperspeed_tpu_torch.ops.ring_attention import \
        make_context_parallel_attention
    from deeperspeed_tpu_torch.parallel import build_mesh

    mesh = build_mesh(dims)
    data = np.load(os.path.join(tmp, "ring.npz"))
    sp = mesh.shape["seq"]
    i = mesh.coords()["seq"]
    n = data["q"].shape[1] // sp
    out = {}
    for strategy in ("ring", "ulysses"):
        for causal in (True, False):
            fn = make_context_parallel_attention(mesh, strategy, causal)
            qkv = [torch.tensor(data[k][:, i * n:(i + 1) * n])
                   .requires_grad_(True) for k in ("q", "k", "v")]
            y = fn(*qkv)
            w = torch.tensor(data["w"][:, i * n:(i + 1) * n])
            grads = torch.autograd.grad((y * w).sum(), qkv)
            out[(strategy, causal)] = {
                "y": y.detach().numpy(),
                "grads": [g.numpy() for g in grads]}
    with open(os.path.join(tmp, f"ring_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def tp_config(zero=1, **extra):
    """The TP/SP engine config: micro-batch 2 a data rank, fp32, SGD (a
    scaled gradient shifts an SGD trajectory, where Adam would hide it),
    ZeRO ``zero``."""
    return dict({"train_batch_size": 4, "train_micro_batch_size_per_gpu": 2,
                 "optimizer": {"type": "SGD", "params": {"lr": 0.1}},
                 "zero_optimization": {"stage": zero}}, **extra)


def tp_gpt_run(rank, world, tmp, dims, model_kw, steps, ckpt,
               block=False):
    """The tiny GPT at ``dims``: the loss and every leaf's grad of the
    saved batch on the saved whole params (each rank on its part, its
    rows and its sequence chunk; the grads summed over ``seq``, averaged
    over ``data`` and gathered whole), then ``steps`` engine steps (SGD,
    ZeRO 1, the mesh from ``initialize(mesh=, param_specs=)``) with the
    losses, grad norms and whole params, a checkpoint of the port, and a
    fresh engine loading the reference's checkpoint (when the test wrote
    one) and taking one more step. With ``block`` the engine's mesh comes
    from the config's ``"mesh"`` block and its loss is built without a
    mesh (the engine's active mesh). Rank 0 writes the report."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models import gpt
    from deeperspeed_tpu_torch.parallel import build_mesh
    from deeperspeed_tpu_torch.parallel.tp import (gather_tree,
                                                   sp_transport)
    from deeperspeed_tpu_torch.runtime.comm.collectives import Transport
    from deeperspeed_tpu_torch.runtime.engine import tree_unflatten
    from deeperspeed_tpu_torch.sharding import rules

    mesh = build_mesh(dims)
    cfg = gpt.GPTConfig(**model_kw, dtype=torch.float32)
    whole = torch.load(os.path.join(tmp, "tp_params.pt"))
    batches = np.load(os.path.join(tmp, "tp_batches.npy"))
    _, apply_fn, loss_fn, specs = gpt.make_gpt(cfg, mesh)
    local = gpt.shard_params(cfg, whole, mesh)
    leaves = [t.clone().requires_grad_(True) for t in _tree_leaves(local)]
    local = tree_unflatten(local, leaves)
    mine = _tp_rank_data(mesh, torch.tensor(batches[0]).long())
    loss = loss_fn(local, mine)
    grads = list(torch.autograd.grad(loss, leaves))
    sp = sp_transport(mesh)
    if sp is not None:
        grads = [sp.all_reduce_sum(g) for g in grads]
    data = Transport(mesh.group(rules.batch_axes(mesh)))
    if data.size > 1:
        grads = [data.all_reduce_sum(g) / data.size for g in grads]
        loss = data.all_reduce_sum(loss.detach().reshape(1))[0] / data.size
    g_whole = gather_tree(tree_unflatten(local, grads), specs, mesh)
    logits = apply_fn(local, mine[:, :-1])
    report = {"loss": float(loss), "grads": {
        k: v.numpy() for k, v in _flat(g_whole).items()},
        "local_shapes": {k: tuple(v.shape) for k, v in _flat(local).items()},
        "logits": logits.numpy()}
    config, engine_mesh, engine_loss = tp_config(), mesh, loss_fn
    if block:
        config = tp_config(mesh={a: n for a, n in dims.items()})
        engine_mesh, engine_loss = None, gpt.make_gpt(cfg)[2]
    eng, _, _, _ = ds.initialize(model=engine_loss, model_parameters=whole,
                                 config=config, device="cpu",
                                 mesh=engine_mesh, param_specs=specs)
    losses, norms = [], []
    for b in batches[:steps]:
        losses.append(float(eng.train_batch(b)))
        norms.append(eng.get_global_grad_norm())
    report.update(losses=losses, grad_norms=norms,
                  dp=eng.data_parallel_size, params={
                      k: v.detach().numpy().copy() for k, v in
                      _flat(eng._model_whole(eng.params)).items()},
                  same_replicated=_replicated_equal(eng, mesh))
    eng.save_checkpoint(os.path.join(tmp, "pt_ckpt"))
    if ckpt and os.path.isdir(os.path.join(tmp, ckpt)):
        fresh, _, _, _ = ds.initialize(
            model=engine_loss, model_parameters=whole, config=config,
            device="cpu", mesh=engine_mesh, param_specs=specs)
        fresh.load_checkpoint(os.path.join(tmp, ckpt))
        report["loaded"] = {
            "global_steps": fresh.global_steps,
            "params": {k: v.detach().numpy().copy() for k, v in _flat(
                fresh._model_whole(fresh.params)).items()},
            "next_loss": float(fresh.train_batch(batches[steps]))}
    if rank == 0:
        with open(os.path.join(tmp, "tp_gpt.pkl"), "wb") as f:
            pickle.dump(report, f)


TP_ONEBIT_FREEZE = 2


def tp_onebit_config(zero=1):
    """1-bit Adam as configs/neox_6.7b_3d.json names it (betas 0.9/0.95,
    clip 1.0, ZeRO ``zero``), its freeze_step cut to TP_ONEBIT_FREEZE so
    that the later steps run the compressed update; fp32, the lr 1e-3."""
    return tp_config(zero, optimizer={
        "type": "OneBitAdam",
        "params": {"lr": 1e-3, "betas": [0.9, 0.95], "weight_decay": 0.01,
                   "freeze_step": TP_ONEBIT_FREEZE}},
        gradient_clipping=1.0)


def tp_onebit_run(rank, world, tmp, dims, model_kw, steps, zero):
    """``steps`` engine steps of the tiny GPT at ``dims`` under 1-bit Adam
    (``tp_onebit_config``) from the saved whole params and batches: the
    losses, grad norms, whole params and the whole moments and error
    feedback (gathered over ZeRO and the model axes), the group sizes the
    1-bit scale sums over, and whether the replicated leaves agree on
    every rank. Rank 0 writes the report."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models import gpt
    from deeperspeed_tpu_torch.parallel import build_mesh

    mesh = build_mesh(dims)
    cfg = gpt.GPTConfig(**model_kw, dtype=torch.float32)
    whole = torch.load(os.path.join(tmp, "tp_params.pt"))
    batches = np.load(os.path.join(tmp, "tp_batches.npy"))
    _, _, loss_fn, specs = gpt.make_gpt(cfg, mesh)
    eng, opt, _, _ = ds.initialize(model=loss_fn, model_parameters=whole,
                                   config=tp_onebit_config(zero),
                                   device="cpu", mesh=mesh,
                                   param_specs=specs)
    losses, norms = [], []
    for b in batches[:steps]:
        losses.append(float(eng.train_batch(b)))
        norms.append(eng.get_global_grad_norm())
    st = eng.opt_state
    report = {
        "losses": losses, "grad_norms": norms, "step": int(st.step),
        "params": {k: v.detach().numpy().copy() for k, v in
                   _flat(eng._model_whole(eng.params)).items()},
        "scale_group_sizes": sorted({
            g.size for g in _tree_leaves(opt.scale_groups or {})
            if g is not None}),
        "zero_sharded": sum(sp.sharded for sp in eng._specs),
        "same_replicated": _replicated_equal(eng, mesh)}
    for field in st._fields[1:]:
        tree = eng._model_whole(eng._full(getattr(st, field)))
        report[field] = {k: v.numpy().copy()
                         for k, v in _flat(tree).items()}
    if rank == 0:
        with open(os.path.join(tmp, "tp_onebit.pkl"), "wb") as f:
            pickle.dump(report, f)


def tp_gpt_runs(rank, world, tmp, cases):
    """For each case (its directory, the worker's name, then its
    arguments) that worker in turn, in one set of ranks: one process
    start for several meshes of the same world."""
    for case_tmp, fn, *args in cases:
        globals()[fn](rank, world, case_tmp, *args)


def _replicated_equal(eng, mesh):
    """Whether every leaf no model axis cuts holds the same bits on every
    rank (Megatron's invariant)."""
    from deeperspeed_tpu_torch.runtime.comm.collectives import Transport

    world = Transport(mesh.group(tuple(mesh.shape)))
    ok = True
    for t, cut in zip(_tree_leaves(eng.params), eng._cuts):
        if cut is None:
            every = world.all_gather(t.detach())
            ok = ok and all(torch.equal(every[0], e) for e in every)
    return ok


def tp_serving_run(rank, world, tmp, dims, model_kw, reqs, new):
    """A ServingEngine on ``dims`` from the saved whole params serving
    ``reqs`` greedily; each rank writes its tokens and its pools' head
    count."""
    from deeperspeed_tpu_torch.models import gpt
    from deeperspeed_tpu_torch.parallel import build_mesh
    from deeperspeed_tpu_torch.serving import ServingEngine

    mesh = build_mesh(dims)
    cfg = gpt.GPTConfig(**model_kw, dtype=torch.float32)
    whole = torch.load(os.path.join(tmp, "tp_params.pt"))
    eng = ServingEngine(cfg, whole, {"num_slots": 4, "block_size": 8,
                                     "num_blocks": 64, "max_seq_len": 64},
                        device="cpu", mesh=mesh)
    for r in reqs:
        eng.submit(r["prompt"], max_new_tokens=new, request_id=r["rid"])
    outs = eng.run()
    with open(os.path.join(tmp, f"tp_serving_rank{rank}.json"), "w") as f:
        json.dump({"outs": outs, "kv_heads": int(eng.kv.k.shape[3]),
                   "wqkv": list(eng.params["layers"]["attn"]["wqkv"].shape)},
                  f)


# ------------------------------------------------------------------ #
# the pipeline engine at 2 and 4 ranks
# ------------------------------------------------------------------ #

PIPE_V, PIPE_D, PIPE_S = 32, 16, 8       # the transformer case's sizes


def pipe_batches(kind, steps, gas, rows, seed=0):
    """``steps`` global batches of ``gas`` micro-batches, each an (inputs,
    labels) pair of ``rows`` rows (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        mbs = []
        for _ in range(gas):
            if kind == "bert":
                x = rng.integers(0, PIPE_V, size=(rows, PIPE_S))
                y = rng.integers(0, PIPE_V, size=(rows, PIPE_S))
                mbs.append((x.astype(np.int32), y.astype(np.int32)))
            else:
                d, o = (16, 16) if kind == "tp" else (8, 4)
                x = rng.normal(size=(rows, d)).astype(np.float32)
                w = np.linspace(-1, 1, d * o).reshape(d, o) / np.sqrt(d)
                mbs.append((x, (x @ w).astype(np.float32)))
        out.append(mbs)
    return out


def pipe_transformer_config(pt):
    """The transformer case's layer config (the same fields in both
    packages)."""
    return dict(batch_size=4, hidden_size=PIPE_D, heads=2,
                intermediate_size=4 * PIPE_D, attn_dropout_ratio=0.0,
                hidden_dropout_ratio=0.0, num_hidden_layers=4,
                pre_layer_norm=False, attn_impl="auto" if pt else "xla")


def pipe_module(kind, stages, mesh=None, explode=False):
    """The port's PipelineModule of a case: an MLP, tied embedding + 4
    transformer layers + tied head ("bert"), or two ParallelMLPs
    ("tp")."""
    import torch.nn.functional as F

    from deeperspeed_tpu_torch.ops.transformer import (
        DeepSpeedTransformerConfig, DeepSpeedTransformerLayer)
    from deeperspeed_tpu_torch.parallel import ParallelMLP
    from deeperspeed_tpu_torch.runtime.pipe import (Embedding, LayerSpec,
                                                    Linear, PipelineModule,
                                                    TiedLayerSpec)

    def mse(y, t):
        loss = ((y.float() - t.float()) ** 2).mean()
        return loss * 1e30 if explode else loss

    if kind == "bert":
        conf = DeepSpeedTransformerConfig(**pipe_transformer_config(True))

        def xent(logits, labels):
            return F.cross_entropy(logits.float().reshape(-1, PIPE_V),
                                   labels.long().reshape(-1))

        layers = ([TiedLayerSpec("embed", Embedding, PIPE_V, PIPE_D)]
                  + [LayerSpec(DeepSpeedTransformerLayer, conf)
                     for _ in range(4)]
                  + [TiedLayerSpec("embed", Embedding, PIPE_V, PIPE_D,
                                   forward_fn=lambda p, x: x @ p["w"].T)])
        return PipelineModule(layers, num_stages=stages, loss_fn=xent,
                              partition_method="uniform")
    if kind == "tp":
        layers = [LayerSpec(ParallelMLP, 16, 32, mesh=mesh)
                  for _ in range(2)]
        return PipelineModule(layers, num_stages=stages, loss_fn=mse,
                              partition_method="uniform")
    layers = [LayerSpec(Linear, 8, 16), torch.relu, LayerSpec(Linear, 16, 16),
              torch.relu, LayerSpec(Linear, 16, 4)]
    return PipelineModule(layers, num_stages=stages, loss_fn=mse,
                          seed_layers=True, partition_method="uniform")


def pipe_engine(case, mesh, init):
    """The port's engine of ``case`` on ``mesh``, its params the
    reference's ``init`` (``{"layers", "tied"}`` of numpy)."""
    import deeperspeed_tpu_torch as pt
    from deeperspeed_tpu_torch.models.convert import from_jax_pipeline_params

    stages = int(case["dims"].get("pipe", 1)) if mesh is not None else 1
    mod = pipe_module(case["kind"], stages, mesh,
                      explode=case.get("explode", False))
    eng, _, _, _ = pt.initialize(model=mod, config=case["config"], mesh=mesh,
                                 device="cpu")
    eng.load_module_params(from_jax_pipeline_params(init, mod))
    return eng


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_tree(v) for v in tree]
    return None if tree is None else np.asarray(tree.detach().cpu())


def pipe_case_run(case, mesh, tmp):
    """One case on this rank: losses, grad norms and loss scales of every
    step, this stage's final params (whole leaves), and for the cases
    that ask for them eval/inference outputs and a save."""
    with open(os.path.join(tmp, f"{case['name']}_init.pkl"), "rb") as f:
        init = pickle.load(f)
    eng = pipe_engine(case, mesh, init)
    rows = (case["config"]["train_micro_batch_size_per_gpu"]
            * eng.data_parallel_size)
    gas = case["config"].get("gradient_accumulation_steps", 1)
    out = {"losses": [], "grad_norms": [], "scales": [],
           "stage": eng.stage_id, "coords": mesh.coords()}
    for mbs in pipe_batches(case["kind"], case["steps"], gas, rows):
        out["losses"].append(float(eng.train_batch(iter(mbs))))
        out["grad_norms"].append(eng.get_global_grad_norm())
        out["scales"].append(eng.loss_scale())
    out["skipped"] = eng.skipped_steps
    out["params"] = _host_tree(eng._params_all(eng._whole(eng._opt_target)))
    if case.get("eval"):
        mbs = pipe_batches(case["kind"], 1, gas, rows, seed=7)[0]
        out["eval"] = float(eng.eval_batch(iter(mbs)))
        out["inference"] = np.asarray(eng.inference_batch(mbs[0][0]))
    if case.get("save"):
        eng.save_checkpoint(os.path.join(tmp, f"{case['name']}_ckpt"))
        eng.save_fp16_model(os.path.join(tmp, f"{case['name']}_fp16"))
    if case.get("reload"):
        # a fresh engine of the same layout resumes the comm residuals
        eng.save_checkpoint(os.path.join(tmp, f"{case['name']}_ckpt"))
        back = pipe_engine(case, mesh, init)
        back.load_checkpoint(os.path.join(tmp, f"{case['name']}_ckpt"))
        out["residuals_restored"] = [
            bool(torch.equal(a[k], b[k]))
            for a, b in zip(eng._comm_state, back._comm_state) for k in a]
        out["residual_l1"] = sum(float(a[k].abs().sum())
                                 for a in eng._comm_state for k in a)
    return out


def pipe_runs(rank, world, tmp, cases):
    """Each case of ``cases`` in turn on its own mesh over this world."""
    from deeperspeed_tpu_torch.parallel import build_mesh

    out = {}
    for case in cases:
        out[case["name"]] = pipe_case_run(case, build_mesh(case["dims"]), tmp)
    with open(os.path.join(tmp, f"pipe_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def pipe_serving_run(rank, world, tmp, case, prompts, news):
    """The PipelineServingBridge over this rank's stage of the engine:
    greedy tokens of every request."""
    from deeperspeed_tpu_torch.parallel import build_mesh
    from deeperspeed_tpu_torch.serving import (PipelineServingBridge,
                                               ServingConfig)

    with open(os.path.join(tmp, f"{case['name']}_init.pkl"), "rb") as f:
        init = pickle.load(f)
    eng = pipe_engine(case, build_mesh(case["dims"]), init)
    bridge = PipelineServingBridge.from_pipeline_engine(
        eng, ServingConfig(num_slots=2, block_size=8, num_blocks=16,
                           max_seq_len=32))
    rids = [bridge.submit(p, max_new_tokens=m) for p, m in zip(prompts, news)]
    outs = bridge.run()
    with open(os.path.join(tmp, f"serve_rank{rank}.pkl"), "wb") as f:
        pickle.dump({"outs": [outs[r] for r in rids],
                     "finished": bridge.metrics.summary()[
                         "requests_finished"]}, f)



# ------------------------------------------------------------------ #
# the single-program SPMD pipeline (runtime/pipe/spmd.py)
# ------------------------------------------------------------------ #

SPMD_3D_SPECS = {"wi": ("pipe", None, "model"), "bi": ("pipe", "model"),
                 "wo": ("pipe", "model", None), "bo": ("pipe", None)}


def spmd_tanh_stage(p, x):
    """tests/test_pipe_spmd.py's stage: linear + tanh."""
    return torch.tanh(x @ p["w"] + p["b"])


def spmd_tp_stage(mesh):
    """tests/test_3d_composition.py's stage: column-parallel in,
    row-parallel out, through parallel/tp.py's f and g over the mesh's
    model axis."""
    from deeperspeed_tpu_torch.parallel.tp import (copy_to_tp_region,
                                                   reduce_from_tp_region,
                                                   tp_transport)

    tp = tp_transport(mesh)

    def stage(p, x):
        xin = copy_to_tp_region(x, tp)
        h = torch.tanh(xin @ p["wi"] + p["bi"])
        y = reduce_from_tp_region(h @ p["wo"], tp)
        return x + y + p["bo"]

    return stage


def spmd_dense_stage(p, x):
    h = torch.tanh(x @ p["wi"] + p["bi"])
    return x + h @ p["wo"] + p["bo"]


def spmd_mse(outputs, labels):
    return ((outputs - labels) ** 2).mean()


def _spmd_optimizer(name, lr):
    from deeperspeed_tpu_torch.ops.adam import FusedAdam
    from deeperspeed_tpu_torch.ops.sgd import SGD

    return FusedAdam(lr=lr) if name == "adam" else SGD(lr=lr)


def spmd_case_run(case, mesh):
    """One case on this rank: ``fwd`` (the forward's outputs), ``train``
    (each step's loss, the gathered params and first moments) or
    ``memory`` (the ring's bytes at each M, 1f1b and gpipe)."""
    from deeperspeed_tpu_torch.runtime.pipe import spmd

    S = mesh.shape["pipe"]
    specs = case.get("specs")
    fn = {"tanh": spmd_tanh_stage, "dense": spmd_dense_stage}.get(
        case["stage"]) or spmd_tp_stage(mesh)
    params = {k: torch.from_numpy(v) for k, v in case["params"].items()}
    mbs = torch.from_numpy(case["mbs"])
    if case.get("bf16"):
        mbs = mbs.to(torch.bfloat16)
    labels = torch.from_numpy(case["labels"])
    local = spmd.stage_part(params, mesh, specs)
    if case["mode"] == "fwd":
        fwd = spmd.make_spmd_pipeline(fn, S, case["M"], mesh, device="cpu")
        out = fwd(local, mbs)
        return {"dtype": str(out.dtype), "out": out.float().numpy()}
    if case["mode"] == "memory":
        got = {}
        for sched in ("1f1b", "gpipe"):
            for m in (4, 32):
                opt = _spmd_optimizer("adam", 1e-2)
                part = spmd.stage_part(params, mesh, specs)
                step = spmd.make_spmd_pipeline_train_step(
                    fn, spmd_mse, opt, S, m, mesh, schedule=sched,
                    device="cpu")
                zeros = torch.zeros((m,) + tuple(mbs.shape[1:]))
                step(part, opt.init(part), zeros, zeros, 1e-2)
                got[f"{sched}/{m}"] = dict(step.stats)
        return got
    opt = _spmd_optimizer(case["opt"], case["lr"])
    state = opt.init(local)
    step = spmd.make_spmd_pipeline_train_step(
        fn, spmd_mse, opt, S, case["M"], mesh, remat=case.get("remat", True),
        param_specs=specs, schedule=case["schedule"], device="cpu")
    losses = []
    for _ in range(case["steps"]):
        (local, state), loss = step(local, state, mbs, labels, case["lr"])
        losses.append(float(loss))
    out = {"losses": losses, "params": {
        k: v.numpy() for k, v in spmd.gather_stages(local, mesh,
                                                    specs).items()}}
    if case["opt"] == "adam":
        out["exp_avg"] = {k: v.numpy() for k, v in spmd.gather_stages(
            state.exp_avg, mesh, specs).items()}
    return out


def spmd_runs(rank, world, tmp, cases):
    """Each case of ``cases`` in turn on its own mesh over this world;
    rank 0 writes the results (every rank gathers the same)."""
    from deeperspeed_tpu_torch.parallel import build_mesh

    out = {}
    for case in cases:
        out[case["name"]] = spmd_case_run(case, build_mesh(case["dims"]))
    with open(os.path.join(tmp, f"spmd_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


# ------------------------------------------------------------------ #
# LAMB over partial leaves: ZeRO shards and model-axis cuts
# ------------------------------------------------------------------ #


def lamb_config(zero, optimizer):
    """``tp_config``'s batch (micro-batch 2 a data rank, 4 rows a step),
    fp32, ZeRO ``zero``, the optimizer block ``optimizer``."""
    return tp_config(zero, optimizer=optimizer)


def lamb_runs(rank, world, tmp, model_kw, cases):
    """Each case (name, mesh dims, ZeRO stage, optimizer block, whether
    the norms are left shard-local) in turn: the tiny GPT from the saved
    whole params, ``steps`` engine steps on the saved batches; the losses
    and the whole params. A shard-local case drops the groups the engine
    gave the optimizer (``norm_groups`` / ``scale_groups``), so each rank
    takes LAMB's norms over its own part: the fault the groups fix. Rank 0
    writes the report."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models import gpt
    from deeperspeed_tpu_torch.parallel import build_mesh

    cfg = gpt.GPTConfig(**model_kw, dtype=torch.float32)
    whole = torch.load(os.path.join(tmp, "tp_params.pt"))
    batches = np.load(os.path.join(tmp, "tp_batches.npy"))
    report = {}
    for name, dims, zero, opt_block, local, steps in cases:
        mesh = build_mesh(dims)
        _, _, loss_fn, specs = gpt.make_gpt(cfg, mesh)
        eng, opt, _, _ = ds.initialize(
            model=loss_fn, model_parameters=whole,
            config=lamb_config(zero, opt_block), device="cpu", mesh=mesh,
            param_specs=specs)
        attr = ("norm_groups" if hasattr(opt, "norm_groups")
                else "scale_groups")
        groups = [g for g in _tree_leaves(getattr(opt, attr) or {})
                  if g is not None]
        if local:
            setattr(opt, attr, None)
        losses = [float(eng.train_batch(b)) for b in batches[:steps]]
        report[name] = {
            "losses": losses,
            "group_sizes": sorted({g.size for g in groups}),
            "zero_sharded": sum(sp.sharded for sp in eng._specs),
            "params": {k: v.detach().numpy().copy() for k, v in
                       _flat(eng._model_whole(eng.params)).items()}}
    if rank == 0:
        with open(os.path.join(tmp, "lamb.pkl"), "wb") as f:
            pickle.dump(report, f)


def config_run(rank, world, tmp, model_kw, config, steps):
    """``steps`` engine steps of the tiny GPT under ``config`` (its mesh
    from the config's ``"mesh"`` block) from the saved params and
    batches: each rank writes its losses, grad norms, the ZeRO axis and
    how many leaves it shards, and the comm block's mode."""
    import deeperspeed_tpu_torch as ds
    from deeperspeed_tpu_torch.models import gpt
    from deeperspeed_tpu_torch.sharding import rules

    cfg = gpt.GPTConfig(**model_kw, dtype=torch.float32, attn_impl="xla")
    params = torch.load(os.path.join(tmp, "params.pt"))
    batches = list(np.load(os.path.join(tmp, "batches.npy")))
    eng, _, _, _ = ds.initialize(model=gpt.make_gpt(cfg)[2],
                                 model_parameters=params, config=config,
                                 device="cpu")
    losses, norms = [], []
    for b in batches[:steps]:
        losses.append(float(eng.train_batch(b)))
        norms.append(eng.get_global_grad_norm())
    out = {"losses": losses, "grad_norms": norms,
           "mesh": dict(eng.mesh.shape),
           "zero_axis": rules.zero_axis(eng.mesh),
           "zero_sharded": sum(sp.sharded for sp in eng._specs),
           "comm_mode": eng._config.comm_config().mode}
    with open(os.path.join(tmp, f"config_rank{rank}.json"), "w") as f:
        json.dump(out, f)
