"""Ranks of the port's multi-process CPU tests (torch.distributed, gloo).

``spawn(name, world, tmp, *args)`` starts ``world`` processes; each joins
a gloo group through a ``FileStore`` under ``tmp`` (no TCP port, so test
workers running side by side cannot collide), runs ``<name>(rank, world,
tmp, *args)`` of this module and writes its results under ``tmp``. A rank
that raises fails the spawn. This module imports torch and the port only:
the reference runs in the test process.
"""

import json
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# ------------------------------------------------------------------ #
# harness
# ------------------------------------------------------------------ #


def _entry(rank, name, world, tmp, args):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        globals()[name](rank, world, tmp, *args)
    finally:
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
