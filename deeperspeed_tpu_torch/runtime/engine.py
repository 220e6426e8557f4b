"""The training engine.

Counterpart of deeperspeed_tpu/runtime/engine.py (``Engine``,
``initialize``): wraps a loss callable and its params with mixed
precision, gradient accumulation, loss scaling, gradient clipping and LR
scheduling, behind the reference's surface: ``forward``/``backward``/
``step`` for the imperative loop and ``train_batch`` for one whole
optimizer step.

Model contract, as in the reference: a callable ``loss_fn(params, batch)``
or ``loss_fn(params, batch, rng)`` returning a scalar loss (optionally
``(loss, aux)``), plus an initial params tree (nested dicts of tensors,
e.g. ``models.gpt.make_gpt``'s). The engine keeps its own copies of the
params on its device, cast to the compute dtype, as autograd leaves; an
fp32 master copy when the config keeps one; and the optimizer state.

Where the reference jit-compiles one fused step, the port runs eagerly:
``train_batch`` loops over the gradient-accumulation micro-batches, each
a forward and an ``autograd.grad``, banks the gradients in the
accumulation dtype, then unscales, clips and applies the optimizer once.
An overflow (a non-finite gradient norm) skips the update, as the
reference's ``keep`` select does; the port reads that flag on the host
once per optimizer step.

``save_checkpoint``/``load_checkpoint`` write and read the reference's
legacy single-writer layout (a tag directory with the model-state and
optimizer-state msgpack files, the ``latest`` pointer and the
``zero_to_fp32`` stub), leaf for leaf what the JAX engine writes for the
same model, so either engine resumes from the other's files. A load
copies each leaf from the mapped file straight into the engine's own
tensors.

Data parallelism: with an initialized ``torch.distributed`` world each
process is one rank of the engine's mesh (the ``"mesh"`` block, or every
rank on the legacy ``data`` axis; world 1 without one). A global batch
handed to ``train_batch`` is split over the ranks along its leading dim
(rank r takes the r-th block of rows, as the reference's ``place_batch``
shards it), each rank sums its local gradients over its micro-batches,
and at the accumulation boundary the comm ``GradReducer`` reduces them
once, bucket by bucket, under the ``"comm"`` block's wire (fp32 without
one). ZeRO stages 1 and 2 keep each rank's shard of the fp32 master and
the Adam moments (runtime/zero/partition.py) as contiguous copies,
update them (the fused Adam kernel over the shards), and all-gather the
updated compute-dtype params.

Telemetry, as in the reference: a ``"monitor"`` block builds and installs
the process-global monitor (monitor/), else an installed one is adopted.
Under data parallelism each rank first takes its own role lane
(``<role>.h<rank>``, monitor/runctx.host_role), so two ranks never write
one trace or flight file. The engine stamps ``run/start`` and
``mesh/build``; ``train_batch`` runs in an ``engine/train_batch`` span
(``forward``/``backward``/``step`` in ``engine/forward``,
``engine/backward`` and ``engine/step`` spans), with the recompile
watchdog on its argument signature, the cost index's capture and live
MFU (``perf``) and memwatch's watermarks; every optimizer step bumps
``train_steps_total`` and sets ``train_global_samples``, the registry is
exported through the ``"tensorboard"`` block's writer every
``tb_export_interval`` steps, and the writer gets the previous step's
loss, LR and loss scale, as the reference writes them.

Input: a ``"datapipe"`` block builds the port's ``DataPipe``
(datapipe/) at construction, over the block's ``source`` or
``training_data``, with ``global_rows = micro * dp * gas`` and the
``"batch_scheduler"`` block's static schedule; ``train_batch()`` with no
batch takes its next global batch, which the pipe's producer thread has
already copied to the card, and every checkpoint carries its
``DataState`` under the reference's keys. The producer thread holds the
pipe and, through its ``place_fn``, the engine: ``engine.datapipe.close()``
stops it. Without the block the synchronous ``DeepSpeedDataLoader`` feeds
``train_batch()``.

The fork's extras: ``store_gradients`` (``store_gradients_cpu`` copies
them to the host) keeps the summed gradients of each optimizer step,
before unscaling and clipping, in ``stored_gradients``;
``register_forward_hook`` turns on the models' layer-output taps
(utils/hooks.py) and ``layer_outputs`` holds, after each ``train_batch``,
the outputs of a forward of the step's batch under the updated params,
as the reference replays it.

Resilience, as in the reference: a ``"resilience"`` block installs the
process-global ``ResilienceManager`` (else an installed one is adopted);
``save_checkpoint`` goes through its two-phase-commit writer (async: the
step blocks only for the snapshot into pinned host memory) when it
handles the save (one process), every optimizer step ends at its
boundary hook (fault injection, the preemption protocol, interval
autosaves), and a load honours ``verify_on_load`` and counts fallbacks
and resumes. A ``"distributed"`` block joins the process group first
(distributed/bootstrap.py; ``initialize`` does it before the batch triple
reads the world size).

Elasticity: with ``elasticity.canonical_shards`` C, ``train_batch``
splits the global batch into C slots; each rank computes the loss and
grads of the slots it owns, one forward and backward a slot with a
generator keyed by the step and the slot index, and the reducer's
canonical mode takes the slot means through gathered fp32 rows and the
fixed pairwise tree (runtime/comm/reducer.py). Every step's loss is then
bit-identical at every admissible world size, world 1 included.

Lifecycle, as in the reference: a ``"lifecycle"`` block attaches the
``LifecycleController`` (the version publisher and the live re-mesh hook)
to the resilience manager's step boundary when ``resilience.save_dir`` is
set, else a bare ``RemeshHook``. ``remesh(w)`` is the live shrink: at one
optimizer-step boundary every rank has agreed on ``w`` (the hook's one
small all-gather a boundary); the ranks ``>= w`` retire (exit 0), the
survivors form a new process group over the old group's store, re-solve
the batch triple from the ``"elasticity"`` block (the global batch
invariant), re-cut their ZeRO shards from the gathered master and
moments, and rebuild the ``GradReducer`` with its residuals restored
(canonical rows verbatim) or resharded (``resilience/reshard.py``).

The 1-bit optimizers (``OneBitAdam``/``OneBitLamb``,
runtime/comm/onebit.py) are built as the reference builds them
(``freeze_step`` 100000 by default), and their state (step, moments,
error feedback, LAMB's frozen ratios) rides in the checkpoint's
``opt_state`` under the reference's field names.

Model-sharded leaves: ``initialize(..., mesh=build_mesh({"data": d,
"model": t, "seq": s, "expert": e}), param_specs=...)`` (or a ``"mesh"``
block's ``tp``/``sp``) keeps on each rank its part of every leaf whose
spec names a live model axis (``rules.model_cut``: the tensor-parallel
axis's heads and FFN columns, parallel/tp.py, or ``E/e`` experts a layer,
models/moe.py) and every other leaf whole; one mechanism for all of them
(``_cuts``): a checkpoint gathers them whole (the reference's files) and
a load cuts them again, the clip norm sums their squares over their
axis, ZeRO shards each rank's part over the data group, and the 1-bit
Adam's scale is taken over the whole leaf. The batch splits over the
data axes only; the ranks of the tp and sp axes hold the same rows (sp
ranks each compute their chunk of the sequence, models/gpt.py). The
grads are summed over the sp axis (each rank's loss is its share of the
global mean), then reduced over the data group. The loss runs with the
engine's mesh active (``sharding.mesh.use_mesh``). With a ``"comm"``
block over several data ranks an MoE model is refused: the reference's
comm step computes the loss per shard. ``initialize(mpu=)`` is kept as
``engine.mpu``, as the reference keeps it.

Backward overlap: with ``"comm": {"overlap": "on"|"auto"}``
(runtime/comm/overlap.py) ``train_batch`` launches each bucket's
reduction on the scheduler's comm thread as soon as the last micro-batch's
backward has banked all of its leaves (a hook a param), and drains them
before the update; ``backward()`` does the same at the accumulation
boundary and ``step()`` drains. Bit-identical to ``overlap: off``.

Pipeline parallelism: ``initialize(model=PipelineModule, ...)`` builds
runtime/pipe/engine.py's ``PipelineEngine`` instead.

Not ported yet (ROADMAP.md): the orbax sharded checkpoint layout, ZeRO
stage 3 and offload for a loss callable, the single-program SPMD
pipeline and the flops profiler.
"""

import copy
import inspect
import os
import time
from contextlib import nullcontext
from typing import Callable, Optional

import numpy as np
import torch

from ..checkpoint import msgpack
from ..checkpoint.serialization import (SHARDED_STATE_DIR, CheckpointEngine,
                                        model_state_filename,
                                        optim_state_filename, read_latest,
                                        validate_tag_across_processes,
                                        write_latest)
from ..checkpoint.zero_to_fp32 import write_recovery_stub
from ..models.bert import BertConfig
from ..models.gpt import GPTConfig
from ..monitor import get_monitor, init_monitor, runctx
from ..monitor.perf import StepTimer
from ..monitor.tracer import trace_instant, trace_span
from ..monitor.watchdog import SignatureCache
from ..ops.adam import FusedAdam, tree_leaves, tree_map
from ..ops.lamb import FusedLamb
from ..ops.sgd import SGD
from ..ops import kernel_config
from ..resilience.manifest import resolve_load_tag
from ..resilience.reshard import remap_data_state
from ..sharding import mesh as mesh_lib
from ..sharding import rules
from ..utils import hooks
from ..utils.logging import log_dist, logger
from ..utils.timer import SynchronizedWallClockTimer, ThroughputTimer
from . import lr_schedules
from .accessors import ConfigAccessorsMixin, make_summary_writer
from .comm.collectives import Transport
from .comm.config import CommConfig
from .comm import bucketing
from .comm.onebit import OnebitAdam, OnebitLamb
from .comm.overlap import OverlapScheduler, resolve_overlap
from .comm.reducer import GradReducer, exact_slot_mean
from .config import TrainingConfig
from .bs_schedules import BatchSizeScheduler
from .dataloader import DeepSpeedDataLoader, RepeatingLoader
from .fp16.loss_scaler import LossScaleState, create_loss_scaler
from .zero import partition

FORWARD_MICRO_TIMER = "forward_microstep"
BACKWARD_MICRO_TIMER = "backward_microstep"
STEP_MICRO_TIMER = "step_microstep"
TRAIN_BATCH_TIMER = "train_batch"

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
SGD_OPTIMIZER = "sgd"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
# known to the reference, not ported yet: name -> ROADMAP.md queue 1 item
_UNPORTED_OPTIMIZERS = {
    "cpuadam": "Offload and ZeRO-Infinity",
}
# the exit code of a rank a live re-mesh retires: a clean exit, which the
# supervisors count as done, not as a crash
RETIRE_EXIT_CODE = 0


def _dtype_of(precision: str) -> torch.dtype:
    return {"fp16": torch.float16, "bfloat16": torch.bfloat16,
            "fp32": torch.float32}[precision]


def tree_unflatten(like, leaves):
    """Rebuild the nested-dict structure of ``like`` from ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _refuse_offload(config: TrainingConfig) -> None:
    """Engine (a loss callable) runs ZeRO stages 0-2 without offload; stage
    3 and the offload devices run only in the streamed engine, which
    ``initialize`` builds for a model config."""
    zc = config.zero_config
    item = "ROADMAP.md queue 1, item 10 'Offload and ZeRO-Infinity'"
    if zc.offload_optimizer.enabled:
        raise NotImplementedError(
            f"zero_optimization.offload_optimizer (device "
            f"{zc.offload_optimizer.device!r}) for a loss callable, the "
            f"reference's HostOffloadOptimizer, is not ported to the "
            f"PyTorch package yet ({item}: HostOffloadOptimizer); pass "
            f"initialize a GPTConfig to train on the streamed offload "
            f"engine")
    if config.zero_optimization_stage == 3 or zc.offload_param.enabled:
        raise NotImplementedError(
            f"ZeRO stage 3 and offload_param for a loss callable (the "
            f"reference's stage-3 helpers) are not ported to the PyTorch "
            f"package yet ({item}: the stage-3 helpers); pass initialize "
            f"a GPTConfig to train on the streamed offload engine")
    if config.streaming_enabled:
        raise NotImplementedError(
            f'the "streaming" block trains a model config on the streamed '
            f"offload engine: pass initialize a GPTConfig. Engine, built "
            f"for a loss callable, does not stream ({item})")


def part_groups_attr(optimizer):
    """The attribute through which ``optimizer`` takes, per leaf, the
    group a rank's part of the leaf lies over (a tree of Transports; None
    for a whole leaf), where its update needs a whole-leaf statistic:
    LAMB's trust-ratio norms (``norm_groups``), the 1-bit scale and the
    1-bit LAMB's warmup norms (``scale_groups``); None for an elementwise
    optimizer."""
    if isinstance(optimizer, FusedLamb):
        return "norm_groups"
    if isinstance(optimizer, (OnebitAdam, OnebitLamb)):
        return "scale_groups"
    return None


class Engine(ConfigAccessorsMixin):
    def __init__(
        self,
        model: Callable,
        params,
        config: TrainingConfig,
        optimizer=None,
        lr_scheduler=None,
        training_data=None,
        collate_fn=None,
        device=None,
        rng: Optional[int] = None,
        mesh=None,
        param_specs=None,
        mpu=None,
    ):
        _refuse_offload(config)
        self._config = config
        # the Megatron-style mpu facade, kept as the reference keeps it
        self.mpu = mpu
        # a "distributed" block joins the process group before the mesh
        # reads the world size (idempotent: initialize() or a launcher may
        # have made the group already)
        if config.distributed_config() is not None:
            from ..distributed import bootstrap as _dist_bootstrap

            _dist_bootstrap.bootstrap(config.distributed_config())
        self.loss_fn = model
        self.module = model  # reference-compatible alias
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Engine runs on CUDA unless given device='cpu', and no CUDA "
                "device is available")
        # the meta device is the autotuner's planning run (autotune/
        # capture.py): such an engine reports to no monitor and adopts no
        # process-global resilience manager
        self._planning = self.device.type == "meta"
        self._takes_rng = _loss_fn_takes_rng(model)
        self._seed = int(rng or 0)
        self._rng_tick = 0

        self._compute_dtype = _dtype_of(config.precision)
        # masterless bf16 (bf16.master_weights=false): the optimizer updates
        # the bf16 params with bf16-stored moments and bf16 grads
        self._use_master = (self._compute_dtype != torch.float32
                            and config.master_weights)
        self._grad_dtype = (torch.float32 if (self._use_master or
                                              self._compute_dtype
                                              == torch.float32)
                            else self._compute_dtype)
        gad = config.grad_accum_dtype
        self._grad_accum_dtype = (
            torch.float32 if gad in ("fp32", "float32")
            else torch.bfloat16 if gad in ("bf16", "bfloat16")
            else self._grad_dtype)
        self._init_mesh(config, mesh)
        params = self._init_model_cuts(params, param_specs)

        self.timers = SynchronizedWallClockTimer()
        self.tput_timer = ThroughputTimer(
            batch_size=config.train_micro_batch_size_per_gpu
            * config.gradient_accumulation_steps,
            num_workers=1, steps_per_output=config.steps_per_print)

        # tensorboard writer (rank 0 only) and the unified telemetry (the
        # "monitor" block's, else an installed one)
        self.summary_writer = make_summary_writer(config, self.mesh.rank)
        self._tb_pending = None
        self.monitor = self._init_monitor(config)
        # the argument signatures of the entry points: the watchdog's and
        # the cost index's counterpart of the reference's jit caches
        self._step_sigs = SignatureCache()
        self._fwd_sigs = SignatureCache()
        self._bwd_sigs = SignatureCache()
        self._upd_sigs = SignatureCache()

        # the "kernels" block is process-global (the consumers are free
        # functions deep inside model code); a planning engine leaves it to
        # its capture (autotune/capture.py)
        if config.kernels_params and not self._planning:
            kernel_config.configure(**config.kernels_params)

        # resilience: a "resilience" block installs the process-global
        # manager (async two-phase-commit saves, preemption guard, fault
        # injection); without one an installed manager is adopted
        from ..resilience import get_resilience_manager, init_resilience

        if self._planning:
            self._resilience = None
        elif config.resilience_config() is not None:
            self._resilience = init_resilience(config.resilience_config())
        else:
            self._resilience = get_resilience_manager()
        if self._resilience is not None:
            # a supervisor-restarted child: count it, record reason/world
            self._resilience.note_restart_context()
        self._init_lifecycle(config)

        # batch-size warmup (the fork's bs_schedules.py): the engine
        # tracks the schedule and exposes current_batch_size(); the
        # datapipe masks the inactive rows, the shapes stay fixed
        self.batch_size_scheduler = None
        if config.batch_scheduler_enabled:
            known = ("final_batch_size", "min_batch_size_multiplier",
                     "warmup_num_steps", "num_intervals",
                     "last_batch_iteration")
            bs_params = {k: v for k, v in
                         config.batch_scheduler_params.items() if k in known}
            unknown = (set(config.batch_scheduler_params) - set(known)
                       - {"enabled"})
            if unknown:
                raise ValueError(
                    f"batch_scheduler config has unknown keys "
                    f"{sorted(unknown)}; valid keys: {list(known)}")
            bs_params.setdefault("final_batch_size", config.train_batch_size)
            self.batch_size_scheduler = BatchSizeScheduler(**bs_params)
            # a configured resume point; step 0 by default
            self.batch_size_scheduler.step(
                max(bs_params.get("last_batch_iteration", 0), 0))

        # the fork's extras: gradient stashing and layer-output capture
        self.store_gradients = False
        self.store_gradients_cpu = False
        self.stored_gradients = None
        self._layer_collector = None

        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self._mode = "train"
        self._stashed = None   # the loss of forward(), pending backward()
        self._grad_acc = None  # banked grads between backward() and step()
        self._acc_count = 0
        self._pending_metrics = None
        self._last_micro_loss = None
        self._lr_override = None
        self._train_data_iter = None

        self._loss_scaler = create_loss_scaler(
            config.precision, static_loss_scale=config.loss_scale,
            dynamic_args=config.dynamic_loss_scale_args)
        self.optimizer = optimizer or self._configure_basic_optimizer()
        self.lr_scheduler = lr_scheduler or self._configure_lr_scheduler()
        self._client_lr = _optimizer_base_lr(self.optimizer, config)

        # ZeRO: the shard of each leaf this rank keeps of the fp32 master
        # and the moments (replicated below stage 1, or where no dim
        # divides the ZeRO size)
        self.master_specs = rules.zero_tree_specs(params, param_specs,
                                                  self.zero_stage, self.mesh,
                                                  "master")
        self._specs = tree_leaves(self.master_specs)
        self._init_optimizer_cuts(params)
        if (any(sp.sharded for sp in self._specs)
                and not isinstance(self.optimizer,
                                   (FusedAdam, SGD, OnebitAdam, FusedLamb,
                                    OnebitLamb))):
            raise NotImplementedError(
                f"ZeRO stage {self.zero_stage} over {self._zero_size} ranks "
                f"shards the optimizer state, which the port does for "
                f"Adam, SGD, LAMB and the 1-bit optimizers (their "
                f"whole-leaf statistics summed over the shards), not for "
                f"{type(self.optimizer).__name__}: use stage 0 or one rank")

        # the engine owns its state: copies, never aliases of the caller's
        with torch.no_grad():
            self.params = tree_map(
                lambda p: torch.as_tensor(p).to(
                    self.device, self._compute_dtype, copy=True
                ).requires_grad_(True), params)
            # the fp32 master starts from the caller's values, not from
            # their compute-dtype cast; under ZeRO each rank keeps its shard
            self.master = (tree_map(
                lambda p, sp: partition.shard_of(torch.as_tensor(p).to(
                    self.device, torch.float32, copy=True), sp,
                    self._zero_index), params, self.master_specs)
                           if self._use_master else None)
            # what the optimizer updates: the master (shards), or in
            # masterless mode the params themselves (contiguous copies of
            # the shards, gathered back into the params after each update)
            self._opt_target = (self.master if self._use_master else tree_map(
                lambda p, sp: partition.shard_of(p.detach(), sp,
                                                 self._zero_index),
                self.params, self.master_specs))
            # where a master path's update writes the compute-dtype params:
            # the params of replicated leaves, shard buffers of sharded ones
            self._cast_target = (tree_map(
                lambda p, sp: p if not sp.sharded else torch.empty(
                    partition.shard_of(p.detach(), sp,
                                       self._zero_index).shape,
                    dtype=p.dtype, device=p.device),
                self.params, self.master_specs)
                                 if self._use_master else None)
        self.opt_state = self.optimizer.init(self._opt_target)

        # canonical-slot reduction (elasticity.canonical_shards): C slots
        # whose reduction is the same at every admissible world size;
        # resolved before the reducer so its residuals take the (C, n)
        # world-free layout
        self.canonical_shards = 0
        canon = int(config.elastic_canonical_shards or 0)
        if canon:
            rows = self._global_rows()
            if rows % canon != 0:
                raise ValueError(
                    f"elasticity.canonical_shards={canon} must divide the "
                    f"global batch rows ({rows})")
            if self.mesh.size != self.data_parallel_size:
                raise NotImplementedError(
                    f"elasticity.canonical_shards on the mesh "
                    f"{self.mesh.shape}: the canonical-slot reduction runs "
                    f"over a data-only world")
            if canon % self.data_parallel_size != 0:
                raise ValueError(
                    f"elasticity.canonical_shards={canon} must be a "
                    f"multiple of every admissible data-parallel size "
                    f"(current: {self.data_parallel_size})")
            self.canonical_shards = canon

        # the gradient reduction at the accumulation boundary: the "comm"
        # block's wire, else the fp32 mean over the same buckets
        self.comm = GradReducer(
            config.comm_config() or CommConfig(mode="fp32"), self.mesh,
            registry=(self.monitor.registry if self.monitor is not None
                      else None), canonical=self.canonical_shards)
        self.comm.build_plan(params)
        self._comm_state = self.comm.init_state(self.device)
        self._init_overlap(config)
        self.scaler_state = self._loss_scaler.init()
        self.skipped = 0          # overflow-skipped optimizer steps
        self.optimizer_steps = 0  # applied optimizer steps

        # the input pipeline: a "datapipe" block swaps the synchronous
        # loader for datapipe/ (memory-mapped shards or training_data,
        # the prefetch thread staging each batch on the device, the
        # checkpointable DataState)
        self.datapipe = None
        if config.datapipe_config() is not None:
            from ..datapipe import build_datapipe

            self.datapipe = build_datapipe(
                config.datapipe_config(), dataset=training_data,
                global_rows=self._global_rows(),
                place_fn=self._place_batch,
                bs_schedule=(self.batch_size_scheduler.schedule
                             if self.batch_size_scheduler is not None
                             else None),
                collate_fn=collate_fn, device=self.device)

        # the synchronous loader (the datapipe owns the data when its
        # block is configured)
        self.training_dataloader = None
        if training_data is not None and self.datapipe is None:
            self.training_dataloader = self.deepspeed_io(
                training_data, collate_fn=collate_fn)
        log_dist(f"engine ready: precision={config.precision} "
                 f"device={self.device} master={self._use_master} "
                 f"zero_stage={self.zero_stage} mesh={self.mesh.shape} "
                 f"dp={self.data_parallel_size}", ranks=[0])

    def _init_overlap(self, config):
        """The backward-overlap scheduler (runtime/comm/overlap.py) when
        the comm block's ``overlap`` resolves on, else None; and the map
        from the reducer's (sorted) leaf ids to this engine's leaf order."""
        old = getattr(self, "_comm_overlap", None)
        if old is not None:
            old.close()
        cc = config.comm_config()
        self._comm_overlap = (
            OverlapScheduler() if cc is not None and resolve_overlap(
                cc, world=self.comm.world, canonical=self.canonical_shards)
            else None)
        self._overlap_futs = None
        self.overlap_launched_in_backward = 0
        ids = tree_unflatten(self.params, range(len(self._specs)))
        self._sorted_leaf = tuple(bucketing.tree_flatten_sorted(ids)[0])

    def _init_mesh(self, config, mesh=None):
        """The mesh (``mesh``, else the "mesh" block's, else every rank on
        the legacy data axis), the data-parallel and ZeRO groups of this
        rank."""
        mc = config.mesh_config()
        if mesh is None:
            mesh = (mesh_lib.from_config(mc) if mc is not None
                    else mesh_lib.default_mesh())
        self.mesh = mesh
        self.batch_axes = rules.batch_axes(mesh)
        self.data_parallel_size = rules.data_parallel_size(mesh)
        self.dp_world_size = self.data_parallel_size
        self.dp_rank = rules.batch_index(mesh)
        if config.world_size != self.data_parallel_size:
            raise ValueError(
                f"the config's batch triple was derived for world size "
                f"{config.world_size}, the mesh {mesh.shape} has "
                f"{self.data_parallel_size} data-parallel ranks")
        self._dp = Transport(mesh.group(self.batch_axes))
        self.zero_stage = config.zero_optimization_stage
        zaxis = rules.zero_axis(mesh)
        self._zero_size = rules.zero_size(mesh)
        self._zero_index = (mesh.axis_index((zaxis,)) if zaxis is not None
                            else 0)
        self._zero = Transport(mesh.group((zaxis,)) if zaxis else None)
        # the whole world (a save's barrier) and the sequence-parallel axis
        # (the grads' sum); the model axes' groups come with the cut leaves
        self._world = Transport(mesh.group(tuple(mesh.shape)))
        sp = rules.sp_axis(mesh)
        self._sp = mesh.transport((sp,) if sp else ())

    def _init_model_cuts(self, params, param_specs):
        """This rank's part of the params: a leaf whose spec names a live
        model axis (``make_gpt``'s specs: the tensor-parallel axis, the
        expert axis) keeps this rank's part of it (``rules.model_cut``);
        every other leaf is whole. ``_cuts`` (one entry a leaf,
        ``tree_leaves`` order: the ``ModelCut`` or None) serves the clip
        norm, the checkpoint's gathers and cuts and the optimizers."""
        mesh = self.mesh
        coords = mesh.coords()
        cuts = []

        def leaf(p, spec):
            cut = rules.model_cut(spec, tuple(p.shape), mesh)
            cuts.append(cut)
            if cut is None:
                return p
            return cut.part(torch.as_tensor(p), coords[cut.axis])

        if param_specs is None:
            local = params
            cuts = [None] * len(tree_leaves(params))
        else:
            local = tree_map(leaf, params, param_specs)
        self._cuts = cuts
        self._has_cuts = any(c is not None for c in cuts)
        self._cut_groups = {c.axis: mesh.transport((c.axis,))
                            for c in cuts if c is not None}
        cut_axes = set(self._cut_groups)
        for axis in rules.model_axes(mesh):
            if axis not in cut_axes:
                raise ValueError(
                    f"the mesh {mesh.shape} has a live {axis!r} axis but no "
                    f"param spec names it: pass initialize param_specs "
                    f"(make_gpt's)")
        moe = (mesh_lib.EXPERT_AXIS in cut_axes
               or _has_moe_layers(params))
        if moe and self.data_parallel_size > 1:
            cc = self._config.comm_config()
            if cc is not None:
                raise NotImplementedError(
                    "a Mixture-of-Experts model with a \"comm\" block over "
                    f"{self.data_parallel_size} data ranks: the reference's "
                    "comm step runs the loss per shard (shard_map, per-shard "
                    "capacity), the port's MoE computes the global batch's; "
                    "drop the comm block (ROADMAP.md section 3)")
        return local

    def _init_optimizer_cuts(self, params):
        """The optimizers that need a whole leaf's statistic where a rank
        keeps part of a leaf (cut over a model axis, a ZeRO shard over the
        data group, or both) get the group of each such leaf: the 1-bit
        optimizers' scale (mean |m + e|) and LAMB's trust-ratio norms
        (FusedLamb's ``norm_groups``, 1-bit LAMB's ``scale_groups``) are
        summed over the leaf's axes."""
        attr = part_groups_attr(self.optimizer)
        if attr is None:
            return
        zaxis = rules.zero_axis(self.mesh)

        def group(cut, spec):
            axes = (((cut.axis,) if cut is not None else ())
                    + ((zaxis,) if spec.sharded else ()))
            if not axes:
                return None
            return self.mesh.transport(
                tuple(a for a in self.mesh.axis_names if a in axes))

        groups = [group(c, sp) for c, sp in zip(self._cuts, self._specs)]
        setattr(self.optimizer, attr,
                tree_unflatten(params, groups)
                if any(g is not None for g in groups) else None)

    def _model_whole(self, tree, keep=True, host=False):
        """A tree like the params whose cut leaves are gathered whole over
        their model axis (collective: every rank calls it). A rank that
        does not ``keep`` them gets its own parts back (a save's ranks
        other than the writer); ``host`` moves each whole leaf to the host
        as soon as it is joined, so a save never holds every whole leaf
        on the card."""
        if not self._has_cuts:
            return tree

        def whole(t, c):
            group = self._cut_groups[c.axis]
            if host and group.backend == "gloo":
                # gloo gathers host tensors to the group's first rank (the
                # writer's): no staging buffer, no copy of the whole leaf
                # to the card and back, no whole leaf on the other ranks
                parts = group.gather(t.detach().cpu(), 0)
            else:
                parts = group.all_gather(t.detach())
            if not keep:
                return t
            out = c.join(parts.unbind(0))
            del parts
            return out.cpu() if host else out

        with torch.no_grad():
            leaves = [t if c is None else whole(t, c)
                      for t, c in zip(tree_leaves(tree), self._cuts)]
        return tree_unflatten(tree, leaves)

    def _model_part(self, t, cut):
        """This rank's part of a whole leaf over its model axis."""
        if cut is None:
            return t
        return cut.part(t, self.mesh.coords()[cut.axis])

    def _init_lifecycle(self, config):
        """A "lifecycle" block arms the live re-mesh signal handler and the
        weight-version publisher as resilience step-boundary hooks; the
        publisher needs a checkpoint dir, so without resilience.save_dir
        only the re-mesh hook is wired (pool shrinks still work)."""
        self._lifecycle = None
        self._remesh_epoch = 0
        lc_cfg = config.lifecycle_config()
        if lc_cfg is None:
            return
        ckpt_dir = (self._resilience.save_dir
                    if self._resilience is not None else None)
        if ckpt_dir is not None:
            from ..lifecycle.controller import LifecycleController

            self._lifecycle = LifecycleController(
                ckpt_dir, cfg=lc_cfg).attach(self)
            return
        from ..lifecycle.remesh import RemeshHook

        hook = RemeshHook(lc_cfg)
        if lc_cfg.remesh_enabled:
            hook.install()
        if self._resilience is not None:
            self._resilience.attach_lifecycle(hook)
        self._lifecycle = hook

    def _init_monitor(self, config):
        """The monitor this engine reports to: the config's (built and
        installed here) or an installed one, else None. A rank of a
        multi-process run first takes its own role lane, as the
        reference's distributed bootstrap gives every process one."""
        if self._planning:
            return None
        mesh = self.mesh
        if mesh.size > 1:
            base = os.environ.get(runctx.ROLE_ENV, "trainer")
            if not base.endswith(f".h{mesh.rank}"):
                os.environ[runctx.ROLE_ENV] = runctx.host_role(
                    base, mesh.rank, mesh.size)
        monitor = (init_monitor(config.monitor_config())
                   if config.monitor_config() is not None else get_monitor())
        if monitor is not None:
            # anchors the run's trace lane: run id + which incarnation
            # this process is
            rc = monitor.run_context
            trace_instant("run/start", lane="run", run_id=rc.run_id or "",
                          role=rc.role, incarnation=rc.incarnation)
            trace_instant("mesh/build", lane="mesh",
                          axes={k: int(v) for k, v in mesh.shape.items()},
                          devices=int(mesh.size))
            if self._config.distributed_config() is not None:
                from ..distributed.bootstrap import emit_init_span

                emit_init_span()
        return monitor

    def _capture(self, name, sigs, *args):
        """The monitor's hook around one call of entry ``name``
        (``Monitor.capture``); a no-op context without a monitor."""
        if self.monitor is None:
            return nullcontext()
        return self.monitor.capture(name, sigs, self.device, *args)

    def _annotate(self, span, phase):
        if self.monitor is not None and self.monitor.memwatch is not None:
            self.monitor.memwatch.annotate(span, phase)

    # ------------------------------------------------------------------ #
    # construction helpers
    # ------------------------------------------------------------------ #

    def _configure_basic_optimizer(self):
        """Build the optimizer named in the config."""
        name = (self._config.optimizer_name or "adam").lower()
        params = dict(self._config.optimizer_params or {})
        params.pop("torch_adam", None)
        betas = tuple(params.pop("betas", (0.9, 0.999)))
        lr = params.pop("lr", 1e-3)
        eps = params.pop("eps", 1e-8)
        wd = params.pop("weight_decay", 0.0)
        if name in (ADAM_OPTIMIZER, ADAMW_OPTIMIZER):
            if name == ADAMW_OPTIMIZER:
                # AdamW always runs decoupled weight decay
                params.pop("adam_w_mode", None)
                adam_w_mode = True
            else:
                adam_w_mode = params.pop("adam_w_mode", True)
            return FusedAdam(
                lr=lr, betas=betas, eps=eps, weight_decay=wd,
                adam_w_mode=bool(adam_w_mode),
                bias_correction=params.pop("bias_correction", True),
                # bf16 moments in masterless mode (fp32 exactly when a
                # master exists or compute is fp32, like the grads)
                state_dtype=self._grad_dtype)
        if name == LAMB_OPTIMIZER:
            # plain per-leaf update: the reference has no LAMB kernel, and
            # no "kernels" surface routes it
            return FusedLamb(
                lr=lr, betas=betas, eps=eps, weight_decay=wd,
                max_coeff=params.pop("max_coeff", 10.0),
                min_coeff=params.pop("min_coeff", 0.01))
        if name in (ONEBIT_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER):
            cls = OnebitAdam if name == ONEBIT_ADAM_OPTIMIZER else OnebitLamb
            return cls(lr=lr, betas=betas, eps=eps, weight_decay=wd,
                       freeze_step=params.pop("freeze_step", 100000))
        if name == SGD_OPTIMIZER:
            return SGD(lr=lr, momentum=params.pop("momentum", 0.0),
                       weight_decay=wd,
                       nesterov=params.pop("nesterov", False))
        if name in _UNPORTED_OPTIMIZERS:
            raise NotImplementedError(
                f"optimizer '{name}' is not ported to the PyTorch package "
                f"yet (ROADMAP.md queue 1, item "
                f"'{_UNPORTED_OPTIMIZERS[name]}')")
        raise ValueError(f"unknown optimizer '{name}'")

    def _configure_lr_scheduler(self):
        if self._config.scheduler_name:
            return lr_schedules.get_scheduler(
                self._config.scheduler_name,
                self._config.scheduler_params or {})
        return None

    # ------------------------------------------------------------------ #
    # reference-API accessors
    # ------------------------------------------------------------------ #

    def current_batch_size(self):
        """The scheduled global batch size (train_batch_size unless a
        "batch_scheduler" block is configured)."""
        if self.batch_size_scheduler is not None:
            return self.batch_size_scheduler.current_batch_size
        return self._config.train_batch_size

    def _global_rows(self) -> int:
        """Rows consumed per optimizer step, micro * dp * gas: the unit the
        datapipe cursor advances by."""
        return (self.train_micro_batch_size_per_gpu()
                * self.data_parallel_size
                * self.gradient_accumulation_steps())

    def get_global_grad_norm(self):
        if self._pending_metrics is None:
            return 0.0
        return float(self._pending_metrics["grad_norm"])

    @property
    def skipped_steps(self):
        """Overflow-skipped optimizer steps."""
        return self.skipped

    def loss_scale(self):
        return float(self.scaler_state.loss_scale)

    def train(self, mode=True):
        self._mode = "train" if mode else "eval"

    def eval(self):
        self._mode = "eval"

    def is_gradient_accumulation_boundary(self):
        return ((self.micro_steps + 1)
                % self.gradient_accumulation_steps() == 0)

    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None,
                     shuffle=False):
        """A loader of global micro-batches (micro * data-parallel size
        rows, as the reference's): every rank loads the same rows and
        ``train_batch`` keeps its block of them."""
        batch_size = batch_size or (self.train_micro_batch_size_per_gpu()
                                    * self.data_parallel_size)
        return DeepSpeedDataLoader(dataset, batch_size=batch_size,
                                   collate_fn=collate_fn, shuffle=shuffle)

    def _train_iter(self):
        if self._train_data_iter is None:
            if self.training_dataloader is None:
                raise RuntimeError("train_batch() without a batch needs "
                                   "training_data at initialize()")
            self._train_data_iter = iter(
                RepeatingLoader(self.training_dataloader))
        return self._train_data_iter

    # ------------------------------------------------------------------ #
    # the computation
    # ------------------------------------------------------------------ #

    def _place_batch(self, batch):
        """This rank's rows of a global batch (numpy arrays or tensors, or
        tuples/lists/dicts of them; the leading dim split over the
        data-parallel ranks) on the engine's device; integer arrays
        become int64. Host arrays bound for CUDA are pinned and copied
        without blocking, on the caller's current stream (the datapipe's
        staging stream when its producer calls this)."""
        return self._to_device(rules.place_batch(self.mesh, batch))

    def _to_device(self, batch):
        if isinstance(batch, dict):
            return {k: self._to_device(v) for k, v in batch.items()}
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._to_device(v) for v in batch)
        if isinstance(batch, torch.Tensor):
            return batch.to(self.device)
        a = np.asarray(batch)
        if a.dtype.kind in "ui":
            a = a.astype(np.int64)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _rng(self) -> torch.Generator:
        """This call's generator: seeded from (engine seed, call count), the
        counterpart of the reference's fold_in(base_key, ticket)."""
        tick = self._rng_tick
        self._rng_tick += 1
        seed = (self._seed * 0x9E3779B97F4A7C15 + tick + 1) % (2 ** 63)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _replay_rng(self) -> torch.Generator:
        """The generator of the layer-output replay: seeded from the
        engine seed and the step, drawn outside the call count, so a
        replay leaves the training stream's generators as they were."""
        seed = (self._seed * 0x9E3779B97F4A7C15 + 2 ** 62
                + self.global_steps) % (2 ** 63)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _call_loss(self, batch, rng=None):
        # the active mesh gives a model built without one (make_gpt(cfg))
        # its collectives
        with mesh_lib.use_mesh(self.mesh):
            out = (self.loss_fn(self.params, batch,
                                self._rng() if rng is None else rng)
                   if self._takes_rng else self.loss_fn(self.params, batch))
        loss = out[0] if isinstance(out, tuple) else out
        return loss

    def _micro_grads(self, loss):
        """Grads of ``loss * loss_scale`` w.r.t. every param leaf, in the
        grad storage dtype (a param the loss does not reach gets zeros)."""
        leaves = tree_leaves(self.params)
        grads = torch.autograd.grad(
            loss.float() * self.scaler_state.loss_scale, leaves,
            allow_unused=True)
        return [torch.zeros_like(p, dtype=self._grad_dtype) if g is None
                else g.to(self._grad_dtype) for p, g in zip(leaves, grads)]

    def _bank(self, grads):
        """Add one micro-batch's grads to the accumulation carry, kept in
        the configured accumulation dtype (grad_accum_dtype)."""
        if self._grad_acc is None:
            # the engine's own buffers: autograd may hand back an expanded
            # view, or one tensor for two leaves, and the carry is written
            # in place from here on
            self._grad_acc = [
                torch.empty(g.shape, dtype=self._grad_accum_dtype,
                            device=g.device).copy_(g) for g in grads]
        else:
            for a, g in zip(self._grad_acc, grads):
                a.add_(g.to(a.dtype))
        self._acc_count += 1

    @torch.no_grad()
    def _postprocess_grads(self, grads, gas, clip):
        """Unscale by loss_scale * gas, global-norm clip, overflow flag, in
        one reduction pass and one in-place multiply pass over the grads.
        A non-finite norm means an inf/nan grad; the caller then skips the
        update, whatever the scaled grads hold."""
        inv = 1.0 / (self.scaler_state.loss_scale * gas)
        sq = [g.float().square().sum() for g in grads]
        raw_sq = torch.stack(sq).sum()
        if self._has_cuts:
            # each part counted once: a cut leaf's squares summed over its
            # model axis, every whole leaf once
            raw_sq = torch.stack([q for q, c in zip(sq, self._cuts)
                                  if c is None] or [sq[0].new_zeros(())]
                                 ).sum()
            for axis, group in self._cut_groups.items():
                part = torch.stack([q for q, c in zip(sq, self._cuts)
                                    if c is not None and c.axis == axis])
                raw_sq = raw_sq + group.all_reduce_sum(
                    part.sum().reshape(1))[0]
        gnorm = torch.sqrt(raw_sq) * inv  # norm of the UNSCALED grads
        coef = inv
        if clip > 0:
            coef = torch.clamp(clip / (gnorm + 1e-6), max=1.0) * inv
        for g in grads:
            g.copy_(g.float() * coef)
        return gnorm, bool(torch.isfinite(gnorm))

    @torch.no_grad()
    def _reduce_grads(self, grads):
        """The mean over the data-parallel ranks of each rank's local
        (scaled, micro-batch-summed) grads, the same bits on every rank,
        bucket by bucket through the GradReducer. Identity on one rank."""
        if self.canonical_shards:
            raise NotImplementedError(
                "the imperative backward()/step() path does not support "
                "the canonical-slot elastic mode (residuals are per-slot, "
                "not per-device); use the fused train_batch() API")
        grads = self._sum_over_sp(grads)
        if self.data_parallel_size == 1:
            return grads
        grads = [g.to(self._grad_dtype) for g in grads]
        mean, self._comm_state = self.comm.reduce_dispatch(
            tree_unflatten(self.params, grads), self._comm_state)
        return tree_leaves(mean)

    def _sum_over_sp(self, grads):
        """The grads summed over the sequence-parallel axis (each rank's
        loss is its share of the global mean, so the sum is the
        reference's grad): one flat all-reduce a dtype. Identity without a
        live sp axis."""
        if self._sp.size == 1:
            return grads
        out = list(grads)
        with torch.no_grad():
            for dt in {g.dtype for g in grads}:
                idx = [i for i, g in enumerate(grads) if g.dtype == dt]
                flat = torch.cat([grads[i].reshape(-1) for i in idx])
                flat = self._sp.all_reduce_sum(flat)
                start = 0
                for i in idx:
                    n = grads[i].numel()
                    out[i] = flat[start:start + n].view_as(grads[i])
                    start += n
        return out

    def _overlaps(self) -> bool:
        # the overlapped buckets leave before the sum over the sp axis
        return (self._comm_overlap is not None and self.data_parallel_size > 1
                and self._sp.size == 1)

    def _bank_overlapped(self, loss):
        """The accumulation boundary's backward under the overlap schedule:
        the grads of ``loss * loss_scale`` banked as ``_bank`` banks them,
        leaf by leaf from a hook on each param as autograd finishes it, and
        each bucket launched onto the comm thread as soon as its last leaf
        is banked (buckets whose leaves no grad reached go last, in plan
        order, with zeros as ``_micro_grads`` gives them). The Futures wait
        in ``_overlap_futs`` for ``_collect_overlapped``."""
        leaves = tree_leaves(self.params)
        plan = self.comm.plan
        acc = self._grad_acc
        final = [None] * len(leaves)
        left = [len(b.leaf_ids) for b in plan.buckets]
        bucket_of = {}
        for j, b in enumerate(plan.buckets):
            for sid in b.leaf_ids:
                bucket_of[self._sorted_leaf[sid]] = j
        futs = [None] * len(plan.buckets)

        def launch(j):
            b = plan.buckets[j]
            futs[j] = self.comm.launch_bucket(
                j, [final[self._sorted_leaf[sid]].to(self._grad_dtype)
                    for sid in b.leaf_ids], self._comm_state[j],
                self._comm_overlap)

        def land(i, g):
            g = g.to(self._grad_dtype)
            if acc is None:
                final[i] = torch.empty(g.shape, dtype=self._grad_accum_dtype,
                                       device=g.device).copy_(g)
            else:
                final[i] = acc[i].add_(g.to(acc[i].dtype))
            j = bucket_of[i]
            left[j] -= 1
            if left[j] == 0:
                launch(j)

        def hook(i):
            def fn(g):
                land(i, g)
            return fn

        handles = [p.register_hook(hook(i)) for i, p in enumerate(leaves)]
        try:
            torch.autograd.grad(loss.float() * self.scaler_state.loss_scale,
                                leaves, allow_unused=True)
        finally:
            for h in handles:
                h.remove()
        # buckets on the wire before the backward returned
        self.overlap_launched_in_backward = sum(f is not None for f in futs)
        for i, p in enumerate(leaves):
            if final[i] is None:  # a param the loss does not reach
                land(i, torch.zeros_like(p, dtype=self._grad_dtype))
        self._grad_acc = final
        self._acc_count += 1
        self._overlap_futs = futs

    def _collect_overlapped(self):
        """Drain the overlapped buckets (``comm/overlap_window``) and return
        the reduced grads in this engine's leaf order."""
        futs, self._overlap_futs = self._overlap_futs, None
        self._comm_overlap.drain()
        mean, self._comm_state = self.comm.collect(
            futs, bucketing.tree_flatten_sorted(self.params)[1])
        return tree_leaves(mean)

    def _mean_loss(self, loss):
        """The mean over the data-parallel ranks of each rank's loss."""
        if self.data_parallel_size == 1:
            return loss
        return self._dp.all_reduce_sum(loss.reshape(1))[0] / \
            self.data_parallel_size

    def _apply_update(self, grads, lr, gas):
        """Unscale, clip and, unless the grads overflowed, step the
        optimizer on this rank's shards, then all-gather the updated
        params of the sharded leaves; returns the step's metrics. The norm
        and the clip are taken on the full reduced grads, so every ZeRO
        stage computes the same update."""
        grads = [g.to(self._grad_dtype) for g in grads]
        clip = float(self._config.gradient_clipping or 0.0)
        loss_scale = self.scaler_state.loss_scale
        gnorm, finite = self._postprocess_grads(grads, gas, clip)
        overflow = not finite
        if not overflow:
            with torch.no_grad():
                target = self._opt_target
                grads = tree_unflatten(target, [
                    partition.shard_of(g, sp, self._zero_index)
                    for g, sp in zip(grads, self._specs)])
                if isinstance(self.optimizer, FusedAdam):
                    # the compute-dtype params (or their shards) are
                    # written in the update's own pass (the fused kernel's
                    # cast output)
                    _, self.opt_state = self.optimizer.update(
                        grads, self.opt_state, target, lr,
                        cast=self._cast_target)
                else:
                    _, self.opt_state = self.optimizer.update(
                        grads, self.opt_state, target, lr)
                    if self._use_master:
                        tree_map(lambda c, m: c.copy_(m), self._cast_target,
                                 self.master)
                del grads
                updated = tree_leaves(self._cast_target if self._use_master
                                      else target)
                for p, u, sp in zip(tree_leaves(self.params), updated,
                                    self._specs):
                    if sp.sharded:
                        partition.gather_into(p, u, sp, self._zero)
            self.optimizer_steps += 1
        else:
            self.skipped += 1
        self.scaler_state = self._loss_scaler.update(self.scaler_state,
                                                     overflow)
        return {"overflow": overflow, "grad_norm": gnorm,
                "loss_scale": loss_scale}

    # ------------------------------------------------------------------ #
    # public training API
    # ------------------------------------------------------------------ #

    def __call__(self, batch):
        return self.forward(batch)

    def forward(self, batch):
        """The loss of one micro-batch. In train mode its graph is kept for
        ``backward()``; in eval mode no graph is built."""
        batch = self._place_batch(batch)
        if self._mode != "train":
            with torch.no_grad():
                return self._call_loss(batch)
        wall = self._config.wall_clock_breakdown
        if wall:
            self.timers(FORWARD_MICRO_TIMER).safe_start()
        with trace_span("engine/forward", lane="engine",
                        micro_step=self.micro_steps) as _sp:
            with self._capture("engine/forward", self._fwd_sigs,
                               self.params, batch):
                loss = self._call_loss(batch)
            self._annotate(_sp, "forward")
        if wall:
            self.timers(FORWARD_MICRO_TIMER).stop(sync_with=loss)
        self._stashed = loss
        return loss

    def backward(self, loss=None, allreduce_gradients=True):
        """Bank the gradients of the last ``forward()``'s loss. The
        reduction over the data-parallel ranks runs once, in ``step()`` at
        the accumulation boundary, so ``allreduce_gradients`` is accepted
        for API compatibility."""
        if self._stashed is None:
            raise RuntimeError("backward() requires a prior forward()")
        stashed, self._stashed = self._stashed, None
        self._last_micro_loss = stashed.detach()  # for the TB scalars
        wall = self._config.wall_clock_breakdown
        if wall:
            self.timers(BACKWARD_MICRO_TIMER).safe_start()
        with trace_span("engine/backward", lane="engine",
                        micro_step=self.micro_steps) as _sp:
            with self._capture("engine/backward", self._bwd_sigs,
                               self.params, stashed):
                if (self._overlaps() and self._acc_count + 1
                        >= self.gradient_accumulation_steps()):
                    # the boundary's backward: buckets leave as their
                    # grads land; step() drains them
                    self._bank_overlapped(stashed)
                else:
                    self._bank(self._micro_grads(stashed))
            self._annotate(_sp, "backward")
        if wall:
            self.timers(BACKWARD_MICRO_TIMER).stop(sync=True)
        return loss if loss is not None else stashed

    def step(self):
        """Apply the optimizer at the accumulation boundary (micro_steps
        advances on every call, so is_gradient_accumulation_boundary()
        reads True after the last micro-batch's backward())."""
        wall = self._config.wall_clock_breakdown
        if wall:
            self.timers(STEP_MICRO_TIMER).safe_start()
        if self._acc_count >= self.gradient_accumulation_steps():
            with trace_span("engine/step", lane="engine",
                            step=self.global_steps) as _sp:
                with self._capture("engine/apply_update", self._upd_sigs,
                                   self.params, self._grad_acc):
                    grads = (self._collect_overlapped()
                             if self._overlap_futs is not None
                             else self._reduce_grads(self._grad_acc))
                    if self.store_gradients:
                        self._store_grads(grads)
                    metrics = self._apply_update(
                        grads, self._current_lr(), float(self._acc_count))
                    del grads
                self._annotate(_sp, "step")
            self._grad_acc = None
            self._acc_count = 0
            self._after_optimizer_step(metrics)
        if wall:
            self.timers(STEP_MICRO_TIMER).stop(sync=True)
            self.timers.log([FORWARD_MICRO_TIMER, BACKWARD_MICRO_TIMER,
                             STEP_MICRO_TIMER], ranks=[0])
        self.micro_steps += 1

    def train_batch(self, batch=None, data_iter=None):
        """One optimizer step over a whole batch: its leading dim is
        gas * micro rows, or it is pulled from the engine's dataloader (or
        ``data_iter``) micro-batch by micro-batch. Returns the mean loss
        over the micro-batches (fp32 scalar tensor)."""
        gas = self.gradient_accumulation_steps()
        if self._grad_acc is not None:
            raise RuntimeError("train_batch() inside an unfinished "
                               "forward/backward/step accumulation cycle")
        placed = False
        if batch is None:
            if self.datapipe is not None and data_iter is None:
                # a whole global batch, usually already on the device
                # (copied by the pipe's producer thread)
                batch, placed = self.datapipe.next_global_batch()
            else:
                it = data_iter or self._train_iter()
                batch = _concat([next(it) for _ in range(gas)])
        wall = self._config.wall_clock_breakdown
        if wall:
            self.timers(TRAIN_BATCH_TIMER).safe_start()
        self.tput_timer.start()
        if not placed:
            batch = self._place_batch(batch)
        collector = self._layer_collector
        if collector is not None:
            # the taps stay quiet in the step; the replay below fills them
            collector.clear()
            hooks.set_active(None)
        mon = self.monitor
        wd = mon.watchdog if mon is not None else None
        ci = mon.cost_index if mon is not None else None
        with trace_span("engine/train_batch", lane="engine",
                        step=self.global_steps) as _tb_sp:
            if wd is not None:
                # the step must keep one argument signature; a new one
                # past the warm baseline means a shape/dtype is varying
                wd.watch("engine/train_step", self._step_sigs)
            # the device time of the span, for the live MFU (perf only)
            timer = StepTimer(self.device) if ci is not None else None
            with self._capture("engine/train_step", self._step_sigs,
                               self.params, batch):
                metrics = self._train_step(batch, gas)
            if ci is not None:
                stats = ci.note_step("engine/train_step", timer.seconds())
                if stats is not None:
                    _tb_sp.note(mfu=round(stats["mfu"], 6),
                                tflops=round(stats["tflops"], 4),
                                verdict=stats["verdict"])
            self._annotate(_tb_sp, "train_batch")
        if collector is not None:
            # the layer outputs of the step's batch under the updated
            # params, one forward with the taps on, as the reference
            # replays its forward-only program after the step
            hooks.set_active(collector)
            with torch.no_grad():
                self._call_loss(batch, self._replay_rng())
        if wd is not None:
            wd.observe(step=self.global_steps)
        self.micro_steps += gas
        self._after_optimizer_step(metrics)
        self.tput_timer.stop(global_step=True, sync_with=metrics["loss"])
        if wall:
            self.timers(TRAIN_BATCH_TIMER).stop(sync_with=metrics["loss"])
            if self.global_steps % max(self._config.steps_per_print, 1) == 0:
                self.timers.log([TRAIN_BATCH_TIMER], ranks=[0])
        return metrics["loss"]

    def _train_step(self, batch, gas):
        """The micro-batch loop, the reduction and the update of one
        ``train_batch``; returns the step's metrics."""
        if self.canonical_shards:
            return self._train_step_canonical(batch)
        loss_sum = None
        overlap = self._overlaps()
        for i in range(gas):
            mb = _micro_batch(batch, i, gas)
            loss = self._call_loss(mb)
            if overlap and i == gas - 1:
                self._bank_overlapped(loss)
            else:
                self._bank(self._micro_grads(loss))
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            del loss
        grads = (self._collect_overlapped() if overlap
                 else self._reduce_grads(self._grad_acc))
        if self.store_gradients:
            self._store_grads(grads)
        metrics = self._apply_update(grads, self._current_lr(), float(gas))
        del grads
        self._grad_acc = None
        self._acc_count = 0
        metrics["loss"] = self._mean_loss(loss_sum / gas)
        return metrics

    def _slot_rng(self, tick: int, slot: int) -> torch.Generator:
        """The generator of canonical slot ``slot`` in the step that drew
        call count ``tick``: keyed by the slot, never by how the slots are
        spread over ranks (the reference's ``fold_in(rng, slot)``)."""
        seed = ((self._seed * 0x9E3779B97F4A7C15 + tick + 1)
                * 0x100000001B3 + slot + 1) % (2 ** 63)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _train_step_canonical(self, batch):
        """One ``train_batch`` in the canonical-slot mode. The global batch
        is C slots of consecutive rows and this rank's rows are its C/W
        slots (``rules.place_batch`` gives rank r the r-th block); each
        slot's loss and scaled grads come from one forward and backward
        with the slot's own generator, the reducer takes the slot means
        through gathered fp32 rows and the pairwise tree (never an
        all-reduce), and the update unscales with gas 1. The loss is the
        same exact mean of the C slot losses."""
        C = self.canonical_shards
        local = self.comm.local_slots
        first = self.comm.rank * local
        tick = self._rng_tick
        self._rng_tick += 1
        losses, slot_grads = [], []
        for k in range(local):
            mb = _micro_batch(batch, k, local)
            loss = self._call_loss(mb, self._slot_rng(tick, first + k))
            grads = self._micro_grads(loss)
            losses.append(loss.detach().float().reshape(1))
            slot_grads.append(tree_unflatten(self.params, grads))
            del loss, grads
        mean, self._comm_state = self.comm.reduce_canonical(
            slot_grads, self._comm_state)
        del slot_grads
        grads = [g.to(self._grad_dtype) for g in tree_leaves(mean)]
        del mean
        if self.store_gradients:
            self._store_grads(grads)
        metrics = self._apply_update(grads, self._current_lr(), 1.0)
        del grads
        metrics["loss"] = exact_slot_mean(torch.cat(losses),
                                          self.comm.transport, C)
        return metrics

    def eval_batch(self, batch):
        with torch.no_grad():
            return self._call_loss(self._place_batch(batch))

    # ------------------------------------------------------------------ #
    # the fork's extras: layer-output hooks and gradient stashing
    # ------------------------------------------------------------------ #

    def register_forward_hook(self, layers_to_hook="all",
                              layer_name_pattern=None):
        """Capture the outputs the models tap with
        ``utils.hooks.record_layer_output`` (the reference's forward
        hooks): after each ``train_batch``, ``layer_outputs`` holds those
        of a forward of its batch under the updated params."""
        self._layer_collector = hooks.LayerOutputCollector(
            layers_to_hook, layer_name_pattern)
        hooks.set_active(self._layer_collector)

    def remove_forward_hooks(self):
        hooks.set_active(None)
        self._layer_collector = None

    @property
    def layer_outputs(self):
        if self._layer_collector is None:
            return {}
        return self._layer_collector.layer_outputs

    def _store_grads(self, grads):
        """Keep a copy of one optimizer step's gradients (summed over the
        micro-batches, scaled by the loss scale, reduced over the ranks),
        as a tree like the params: on the device, or as host numpy arrays
        with ``store_gradients_cpu`` (bf16 arrives as fp32)."""
        with torch.no_grad():
            copies = [g.to(self._grad_dtype, copy=True) for g in grads]
        if self.store_gradients_cpu:
            copies = [hooks._to_host(g) for g in copies]
        self.stored_gradients = tree_unflatten(self.params, copies)

    def _after_optimizer_step(self, metrics):
        """Bookkeeping after an optimizer step (applied or skipped). An
        overflow-skipped step leaves the LR schedule where it was under a
        dynamic loss scaler, as the reference does."""
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        if self.batch_size_scheduler is not None:
            self.batch_size_scheduler.step(self.global_steps)
        if self.summary_writer is not None:
            # the PREVIOUS step's scalars: its values have settled, so
            # reading them does not stall this step
            self._tb_write_pending()
            self._tb_pending = (metrics, self._current_lr(),
                                self.global_samples)
        if self.monitor is not None:
            self.monitor.registry.counter(
                "train_steps_total", "optimizer steps taken").inc()
            self.monitor.registry.gauge(
                "train_global_samples", "samples consumed").set(
                    self.global_samples)
            ivl = self.monitor.config.tb_export_interval
            if ivl and self.global_steps % ivl == 0:
                self.monitor.export_tensorboard(self.summary_writer,
                                                self.global_samples)
        self._pending_metrics = metrics
        if self._loss_scaler.dynamic and metrics["overflow"]:
            log_dist(f"OVERFLOW! skipping step; loss scale -> "
                     f"{self.loss_scale()}", ranks=[0])
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step()
            self._lr_override = None
        self._end_of_step_resilience()

    def _end_of_step_resilience(self):
        """The step-boundary resilience hook: fault injection, preemption
        (urgent checkpoint + sentinel exit), interval autosaves. Shared by
        ``train_batch`` and the imperative ``step()``."""
        if self._resilience is not None:
            self._resilience.on_step_boundary(self)

    def _tb_write_pending(self):
        """Write the previous step's tensorboard scalars. Called on the
        next boundary and before checkpoints."""
        pending = self._tb_pending
        if self.summary_writer is None or pending is None:
            return
        self._tb_pending = None
        metrics, lr, samples = pending
        scalars = {"Train/Samples/lr": lr}
        loss = metrics.get("loss", self._last_micro_loss)
        if loss is not None:
            scalars["Train/Samples/train_loss"] = float(loss)
        if self._loss_scaler.dynamic:
            scalars["Train/Samples/loss_scale"] = float(
                metrics["loss_scale"])
        self.summary_writer.write_scalars(scalars, samples)
        self.summary_writer.flush()

    def module_state_dict(self):
        """The params (compute dtype) as a tree of detached tensors."""
        return tree_map(lambda p: p.detach(), self.params)

    # ------------------------------------------------------------------ #
    # checkpoints
    # ------------------------------------------------------------------ #

    def _full(self, tree):
        """A tree like the params whose sharded leaves (ZeRO) are gathered
        whole from every rank of the ZeRO group: collective, every rank
        calls it."""
        def leaf(t, sp):
            if not sp.sharded:
                return t
            shape = list(t.shape)
            shape[sp.dim] *= sp.size
            full = torch.empty(shape, dtype=t.dtype, device=t.device)
            partition.gather_into(full, t, sp, self._zero)
            return full
        return tree_map(leaf, tree, self.master_specs)

    def _host_checkpoint_payload(self, client_state=None):
        """What a checkpoint stores, keyed by file name: the reference's
        model-state and optimizer-state trees, with the same leaf names,
        dtypes and nesting (step counters as int32 0-d arrays, the loss
        scaler's fields as 0-d float32/int32), the master and the moments
        whole (gathered from the ZeRO shards), and with a comm block the
        error-feedback residuals of every rank, (world, n) per bucket and
        key, with their fingerprint and plan. Collective under data
        parallelism: every rank builds it. Tensors stay where they are;
        ``save_tree`` copies each to the host as it writes it."""
        st = self.opt_state
        scaler = self.scaler_state
        # the whole leaves cut over a model axis go to the host of the rank
        # that writes (rank 0) as they are gathered
        writer = self.mesh.rank == 0
        model_states = {
            "module": self._model_whole(self.params, writer, True),
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "skipped_steps": self.skipped_steps,
            "micro_steps": self.micro_steps,
            "dp_world_size": self.data_parallel_size,
            # the reference's field: the legacy ``model`` axis's extent
            "mp_world_size": int(self.mesh.shape.get(mesh_lib.MODEL_AXIS,
                                                     1)),
            # rows per optimizer step, micro * dp * gas: a resume under
            # another row count re-bases the datapipe's step schedules
            "global_rows": self._global_rows(),
            "process_count": self.mesh.size,
            "lr_scheduler": (self.lr_scheduler.state_dict()
                             if self.lr_scheduler else {}),
            "datapipe": (self.datapipe.state_dict()
                         if self.datapipe is not None else {}),
            "client_state": client_state or {},
        }
        whole = lambda t: self._model_whole(  # noqa: E731
            self._full(t), writer, True)
        optim_states = {
            "master": (whole(self.master) if self.master is not None
                       else {}),
            "opt_state": type(st)(np.asarray(st.step, np.int32),
                                  *(whole(t) for t in st[1:])),
            "scaler": {
                "loss_scale": np.asarray(scaler.loss_scale, np.float32),
                "good_steps": np.asarray(scaler.good_steps, np.int32),
                "hysteresis": np.asarray(scaler.hysteresis, np.int32)},
            "step": self.optimizer_steps,
            "zero_stage": self.zero_stage,
        }
        if self._config.comm_config() is not None:
            # error-feedback residuals, (world, n) per key or (C, n) in the
            # canonical-slot mode: a quantized mode resumes bit for bit only
            # with them
            optim_states["comm"] = [
                {k: self._gather_residual(v) for k, v in res.items()}
                for res in self._comm_state]
            optim_states["comm_fingerprint"] = repr(
                self.comm.state_fingerprint())
            optim_states["comm_plan"] = self.comm.plan_summary()
        return {model_state_filename(): model_states,
                optim_state_filename(): optim_states}

    def _gather_residual(self, v):
        g = self.comm.transport.all_gather(v)
        if self.canonical_shards:
            return g.reshape((self.canonical_shards,) + tuple(v.shape[1:]))
        return g

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """Write the engine's state under ``save_dir/tag`` (default tag
        ``global_step<N>``), then repoint ``latest`` unless
        ``save_latest`` is False. Returns True. Under data parallelism
        every rank calls it (the ZeRO shards and residuals are gathered);
        rank 0 writes, and every rank returns once the files are there."""
        if tag is None:
            tag = f"global_step{self.global_steps}"
        tag = str(tag)
        if self._config.checkpoint_tag_validation_enabled:
            validate_tag_across_processes(
                tag, self._config.checkpoint_tag_validation_fail)
        self._tb_write_pending()
        if self._resilience is not None:
            self._resilience.note_save_dir(save_dir)
            if self._resilience.handles_save():
                return self._resilience.save_checkpoint(
                    self, save_dir, tag, client_state,
                    save_latest=save_latest)
        ck = CheckpointEngine(save_dir, tag)
        with torch.no_grad():
            payload = self._host_checkpoint_payload(client_state)
            if self.mesh.rank == 0:
                for fname, tree in payload.items():
                    ck.save(fname, tree)
                if save_latest:
                    write_latest(save_dir, tag)
                write_recovery_stub(ck.ckpt_dir)
        del payload
        self._world.barrier()
        log_dist(f"saved checkpoint {ck.ckpt_dir}", ranks=[0])
        return True

    def load_checkpoint(self, load_dir, tag=None, load_module_only=False,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True):
        """Restore a checkpoint written by either engine: ``tag`` or the
        one ``latest`` names, or, when that one is missing, partial or
        corrupt, the newest older valid tag. Returns (tag directory,
        client_state), or (None, {}) when nothing is loadable.

        Each leaf is copied into the engine's existing tensors, cast to
        their dtype; under ZeRO each rank copies its shard of the master
        and the moments, and with a comm block its row of the residuals
        (dropped, with a warning, when their fingerprint is not the running
        reducer's). Unlike the reference, a master path whose master was
        not restored (``load_module_only``, or a file without one) takes
        its fp32 master from the loaded module, so the next step trains
        from the loaded weights."""
        if tag is None:
            tag = read_latest(load_dir)
            if tag is None:
                logger.warning("no 'latest' file in %s; nothing loaded",
                               load_dir)
                return None, {}
        # never load a torn/corrupt tag: committed tags verify against
        # their manifest, and an unloadable requested tag falls back to
        # the newest older valid one
        verify = (self._resilience.cfg.verify_on_load
                  if self._resilience is not None else True)
        requested = str(tag)
        tag, fell_back = resolve_load_tag(load_dir, requested,
                                          verify_checksums=verify)
        if tag is None:
            return None, {}
        if fell_back and self._resilience is not None:
            self._resilience.note_fallback(skipped_tag=requested)
        ck = CheckpointEngine(load_dir, tag)
        if os.path.isdir(ck.path(SHARDED_STATE_DIR)):
            raise NotImplementedError(
                f"{ck.ckpt_dir} holds the orbax sharded_state layout, which "
                f"the PyTorch package does not read yet (ROADMAP.md queue "
                f"1, item 'Sharded checkpoints')")
        if not ck.exists(model_state_filename()):
            logger.warning("checkpoint %s not found", ck.ckpt_dir)
            return None, {}
        model_states = ck.load(model_state_filename(), unchunk=False)
        master_loaded = False
        # whole leaves from the file: this rank's part over its model axis,
        # then its ZeRO shard
        cuts = (tree_unflatten(self.params, [
            (lambda t, c=c: self._model_part(t, c))
            for c in self._cuts]) if self._has_cuts else None)
        shard = (self.master_specs, self._zero_index, cuts)
        with torch.no_grad():
            _copy_into(self.params, model_states["module"], "module",
                       None, 0, cuts)
            if (not load_module_only and load_optimizer_states
                    and ck.exists(optim_state_filename())):
                optim = ck.load(optim_state_filename(), unchunk=False)
                if self.master is not None and optim.get("master"):
                    _copy_into(self.master, optim["master"], "master",
                               *shard)
                    master_loaded = True
                saved = optim["opt_state"]
                for i, field in enumerate(self.opt_state._fields[1:], 1):
                    _copy_into(self.opt_state[i], saved[field],
                               f"opt_state/{field}", *shard)
                self.opt_state = self.opt_state._replace(
                    step=int(saved["step"]))
                sc = optim["scaler"]
                self.scaler_state = LossScaleState(
                    float(sc["loss_scale"]), int(sc["good_steps"]),
                    int(sc["hysteresis"]))
                self.optimizer_steps = int(optim["step"])
                if self._config.comm_config() is not None:
                    self._restore_comm_state(optim.get("comm"),
                                             optim.get("comm_fingerprint"),
                                             optim.get("comm_plan"))
            if self.master is not None and not master_loaded:
                tree_map(lambda m, p, sp: m.copy_(partition.shard_of(
                    p.detach(), sp, self._zero_index)), self.master,
                    self.params, self.master_specs)
            if self.master is None:
                # masterless: the optimizer's shards of the loaded params
                tree_map(lambda t, p, sp: t.copy_(partition.shard_of(
                    p.detach(), sp, self._zero_index)) if sp.sharded
                    else None, self._opt_target, self.params,
                    self.master_specs)
        self.skipped = int(model_states.get("skipped_steps", 0))
        self.global_steps = int(model_states.get("global_steps", 0))
        self.global_samples = int(model_states.get("global_samples", 0))
        self.micro_steps = int(model_states.get("micro_steps", 0))
        if self.batch_size_scheduler is not None:
            self.batch_size_scheduler.step(self.global_steps)
        if self.datapipe is not None:
            if model_states.get("datapipe"):
                self.datapipe.load_state_dict(remap_data_state(
                    model_states["datapipe"],
                    model_states.get("global_rows"), self._global_rows()))
            else:
                logger.warning(
                    "checkpoint %s carries no datapipe state (saved "
                    "before the datapipe existed?): the input pipe "
                    "restarts from epoch 0 and will NOT replay the "
                    "original batch stream; seeding its curriculum step "
                    "from global_steps=%d so the seq-len/batch-size "
                    "schedules stay consistent", ck.ckpt_dir,
                    self.global_steps)
                self.datapipe.seed_step(self.global_steps)
        if (load_lr_scheduler_states and self.lr_scheduler is not None
                and model_states.get("lr_scheduler")):
            self.lr_scheduler.load_state_dict(model_states["lr_scheduler"])
        log_dist(f"loaded checkpoint {ck.ckpt_dir}", ranks=[0])
        if self._resilience is not None:
            self._resilience.note_resumed(tag)
        return ck.ckpt_dir, model_states.get("client_state", {})

    def _my_rows(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a checkpointed (world, n) residual, or of a
        (C, n) one in the canonical-slot mode."""
        if self.canonical_shards:
            n = self.comm.local_slots
            return full[self.comm.rank * n:(self.comm.rank + 1) * n]
        return full[self.comm.rank]

    def _restore_comm_state(self, saved, fingerprint, comm_plan=None):
        """This rank's rows of checkpointed error-feedback residuals. Rows
        saved under another bucket layout or mode are useless, and
        misapplied they corrupt the gradients: on a fingerprint mismatch
        the residuals are resharded when only the world size differs and
        a compatible plan rode along (resilience/reshard.py), else they
        stay zero. Canonical-slot residuals carry no world term in their
        fingerprint: they restore verbatim at any world size."""
        if saved is None:
            if any(self._comm_state):
                logger.warning("checkpoint carries no comm residuals: error "
                               "feedback restarts from zero")
            return
        if isinstance(saved, dict):  # msgpack keeps a list as index keys
            saved = [saved[k] for k in sorted(saved, key=int)]
        if fingerprint != repr(self.comm.state_fingerprint()):
            if self._reshard_comm_residuals(saved, comm_plan):
                return
            logger.warning(
                "checkpointed comm residuals were saved under a different "
                "bucket layout/mode/world (fingerprint mismatch): error "
                "feedback restarts from zero")
            return
        for res, rows in zip(self._comm_state, saved):
            for k, t in res.items():
                t.copy_(self._my_rows(_host_tensor(rows[k])))

    def _reshard_comm_residuals(self, saved, saved_plan) -> bool:
        """Residuals whose checkpointed shape bakes in another world size,
        rebuilt for this one by ``reshard_comm_residuals``; True on
        success (and a ``resilience/comm_reshard`` instant)."""
        from ..resilience.reshard import reshard_comm_residuals

        target = self.comm.plan_summary()
        host = [{k: _host_tensor(v).numpy() for k, v in b.items()}
                if isinstance(b, dict) else b for b in saved]
        resharded = reshard_comm_residuals(host, saved_plan, target)
        if resharded is None:
            return False
        if len(resharded) != len(self._comm_state) or any(
                set(r) != set(w) for r, w in zip(resharded,
                                                 self._comm_state)):
            logger.warning(
                "resharded comm residuals do not match the running "
                "reducer's residual keys: error feedback restarts from zero")
            return False
        for r, w in zip(resharded, self._comm_state):
            for k, t in w.items():
                t.copy_(self._my_rows(torch.from_numpy(r[k])))
        w_from = (saved_plan.get("world") if isinstance(saved_plan, dict)
                  else None)
        logger.info("comm residuals resharded for the new topology (world "
                    "%s -> %s)", w_from, target["world"])
        trace_instant("resilience/comm_reshard", lane="resilience",
                      world_from=w_from, world_to=target["world"])
        return True

    # ------------------------------------------------------------------ #
    # live re-mesh (lifecycle/)
    # ------------------------------------------------------------------ #

    def agree_remesh(self, ready: bool, pool: Optional[int]):
        """The live re-mesh's agreement at a step boundary, collective over
        the data-parallel ranks: each rank's (ready, pool read) gathered;
        returns (any rank ready, the smallest pool a ready rank read, or
        None), the same on every rank."""
        dev = (self.device if self._dp.backend == "nccl"
               else torch.device("cpu"))
        mine = torch.tensor([int(bool(ready)), -1 if pool is None
                             else int(pool)], dtype=torch.int64, device=dev)
        rows = self._dp.all_gather(mine).cpu().tolist()
        pools = [p for r, p in rows if r and p >= 0]
        return any(r for r, _ in rows), (min(pools) if pools else None)

    def remesh(self, world_size: int):
        """Shrink the data-parallel world LIVE at a step boundary: the
        counterpart of the supervisor's elastic relaunch without a
        checkpoint round trip or a re-exec of the survivors.

        Every rank calls it at the same optimizer-step boundary with the
        same ``world_size`` (``RemeshHook.poll`` agrees on it). The ranks
        ``>= world_size`` retire: they take part in the gathers of the
        state, leave the process group and exit with ``RETIRE_EXIT_CODE``
        (0), which the supervisors count as done. The survivors form a new
        group over the old group's store, re-solve the batch triple from
        the ``"elasticity"`` block at the new world (the global batch, and
        so the datapipe's row stream, invariant), re-cut their ZeRO shards
        of the master and the optimizer state from the gathered whole, and
        rebuild the ``GradReducer`` plan with its error-feedback residuals
        restored (canonical rows verbatim) or resharded
        (``resilience/reshard.py``). With ``elasticity.canonical_shards``
        the loss curve continues bit-identically, as a kill-restart resume
        would. Returns the new data-parallel size. Growth past the
        processes alive needs a relaunch (the fleet supervisor)."""
        world_size = int(world_size)
        if world_size == self.data_parallel_size:
            return self.data_parallel_size
        if self._config.zero_config.offload_optimizer.enabled:
            raise RuntimeError(
                "live re-mesh is not supported with optimizer offload "
                "(host-side state is keyed to the old placement)")
        if self._has_cuts or self.mesh.size != self.data_parallel_size:
            raise RuntimeError(
                "live re-mesh re-forms a data-only world; a mesh with an "
                "expert, tensor- or sequence-parallel axis needs a relaunch")
        if self._acc_count or self._stashed is not None:
            raise RuntimeError(
                "live re-mesh must happen at an optimizer-step boundary "
                "(gradients are banked mid-accumulation)")
        if not self._config.elasticity_enabled:
            raise RuntimeError(
                "live re-mesh needs an elasticity block: the batch "
                "triple must re-solve at the new world size with the "
                "global batch invariant")
        valid = self._config.elastic_valid_world_sizes or []
        if valid and world_size not in valid:
            raise ValueError(
                f"world_size {world_size} is not an admissible elastic "
                f"world size (valid: {sorted(valid)})")
        if world_size > self.data_parallel_size:
            raise ValueError(
                f"cannot re-mesh to {world_size} ranks live: only "
                f"{self.data_parallel_size} processes exist (growth needs a "
                f"relaunch)")
        old_world = self.data_parallel_size
        rank = self.mesh.rank
        t0 = time.time()
        # the span COVERS the survivors' stall: the goodput ledger's
        # `remesh` bucket is carved from exactly this interval
        span = (trace_span("lifecycle/remesh", lane="lifecycle",
                           world_from=old_world, world_to=world_size)
                if rank < world_size else nullcontext())
        with span:
            new_dp = self._remesh_apply(world_size)
        if new_dp is None:
            self._retire(old_world, world_size)
        stall_ms = (time.time() - t0) * 1000.0
        log_dist(f"live re-mesh: world {old_world} -> {new_dp} in "
                 f"{stall_ms:.0f}ms (step {self.global_steps}, "
                 f"mesh={self.mesh.shape})", ranks=[0])
        return new_dp

    def _remesh_config(self, world_size: int) -> TrainingConfig:
        """The config re-solved at ``world_size``, checked before any rank
        leaves the group: the same global rows, a data-parallel size of
        ``world_size``, and canonical slots that still divide over it."""
        raw = copy.deepcopy(self._config._param_dict)
        # elasticity rewrote the batch triple at init; the re-parse
        # re-derives micro/gas for the new world (the global batch is
        # pinned by the elasticity block)
        for key in ("train_batch_size", "train_micro_batch_size_per_gpu",
                    "gradient_accumulation_steps"):
            raw.pop(key, None)
        cfg = TrainingConfig(raw, world_size=world_size)
        mc = cfg.mesh_config()
        new_dp = world_size
        if mc is not None:
            # every axis but tp/sp is a data-parallel (batch) axis
            dims = mc.resolve(world_size)
            new_dp //= dims[mesh_lib.TP_AXIS] * dims[mesh_lib.SP_AXIS]
        if new_dp != world_size:
            raise ValueError(
                f"the new mesh resolves to data-parallel size {new_dp}, not "
                f"the requested {world_size}: fix the mesh block's axis "
                f"extents (use -1 to infer from the world size)")
        rows = (cfg.train_micro_batch_size_per_gpu * world_size
                * cfg.gradient_accumulation_steps)
        if rows != self._global_rows():
            raise RuntimeError(
                f"elastic re-solve changed the global batch rows "
                f"({self._global_rows()} -> {rows}); the datapipe stream "
                f"would diverge: the elasticity block must pin one global "
                f"batch across its world sizes")
        if self.canonical_shards and self.canonical_shards % new_dp:
            raise RuntimeError(
                f"elasticity.canonical_shards={self.canonical_shards} is "
                f"not a multiple of the new data-parallel size {new_dp}; "
                f"bit-identical reduction cannot continue")
        return cfg

    def _remesh_apply(self, world_size: int):
        """The flip itself; None on a rank the new world retires."""
        new_config = self._remesh_config(world_size)
        rank = self.mesh.rank
        # ---- snapshots the new topology inherits (collective, old group)
        with torch.no_grad():
            full_master = (self._full(self.master)
                           if self.master is not None else None)
            st = self.opt_state
            full_opt = [self._full(t) for t in st[1:]]
            old_comm = [{k: self._gather_residual(v).cpu()
                         for k, v in res.items()} for res in self._comm_state]
        old_fp = repr(self.comm.state_fingerprint())
        old_plan = self.comm.plan_summary()
        self._rejoin_world(world_size)
        if rank >= world_size:
            return None

        # ---- swap topology + config, re-cut the shards ----
        self._config = new_config
        self._init_mesh(new_config)
        self.master_specs = rules.zero_tree_specs(self.params, None,
                                                  self.zero_stage, self.mesh,
                                                  "master")
        self._specs = tree_leaves(self.master_specs)
        self._init_optimizer_cuts(self.params)
        idx = self._zero_index

        def cut(full, sp):
            return partition.shard_of(full, sp, idx).clone(
                memory_format=torch.contiguous_format)

        with torch.no_grad():
            if self._use_master:
                self.master = tree_map(cut, full_master, self.master_specs)
                self._opt_target = self.master
                self._cast_target = tree_map(
                    lambda p, sp: p if not sp.sharded else torch.empty(
                        cut(p.detach(), sp).shape, dtype=p.dtype,
                        device=p.device), self.params, self.master_specs)
            else:
                self._opt_target = tree_map(
                    lambda p, sp: partition.shard_of(p.detach(), sp, idx),
                    self.params, self.master_specs)
            self.opt_state = type(st)(st.step, *(
                tree_map(cut, f, self.master_specs) for f in full_opt))
        del full_master, full_opt

        # ---- rebuild the reducer; restore or reshard its residuals ----
        self.comm = GradReducer(
            new_config.comm_config() or CommConfig(mode="fp32"), self.mesh,
            registry=(self.monitor.registry if self.monitor is not None
                      else None), canonical=self.canonical_shards)
        self.comm.build_plan(self.params)
        self._comm_state = self.comm.init_state(self.device)
        self._init_overlap(new_config)
        with torch.no_grad():
            self._restore_comm_state(old_comm, old_fp, old_plan)

        # the new topology brings new argument signatures (this rank's
        # rows): the watchdog's and the cost index's warmup starts over
        self._step_sigs = SignatureCache()
        self._fwd_sigs = SignatureCache()
        self._bwd_sigs = SignatureCache()
        self._upd_sigs = SignatureCache()

        # ---- restart data production against the new mesh (the cursor
        # is world-agnostic: the global rows a step are invariant) ----
        if self.datapipe is not None:
            self.datapipe.load_state_dict(self.datapipe.state_dict())
        self.tput_timer = ThroughputTimer(
            batch_size=new_config.train_micro_batch_size_per_gpu
            * new_config.gradient_accumulation_steps,
            num_workers=1, steps_per_output=new_config.steps_per_print)
        return self.data_parallel_size

    def _rejoin_world(self, world_size: int) -> None:
        """Leave the default process group; ranks below ``world_size`` form
        a new one over the old group's store (under a fresh prefix), with
        the same backend. A world of one rank runs without a group."""
        import torch.distributed as dist
        from torch.distributed import distributed_c10d as c10d

        if not dist.is_initialized():
            return
        backend = dist.get_backend()
        rank = dist.get_rank()
        # the store outlives the group: rank 0 (a survivor) may host it
        self._remesh_store = c10d._get_default_store()
        self._remesh_epoch += 1
        dist.destroy_process_group()
        if rank < world_size and world_size > 1:
            dist.init_process_group(
                backend, rank=rank, world_size=world_size,
                store=dist.PrefixStore(f"ds_remesh/{self._remesh_epoch}",
                                       self._remesh_store))

    def _retire(self, old_world: int, world_size: int) -> None:
        """A rank the live re-mesh leaves out: stop the input pipe, let
        pending saves finish, exit with ``RETIRE_EXIT_CODE``."""
        logger.info("live re-mesh: world %d -> %d at step %d; this rank "
                    "retires", old_world, world_size, self.global_steps)
        if self.datapipe is not None:
            self.datapipe.close()
        if self._resilience is not None:
            self._resilience.wait_for_pending_saves()
        raise SystemExit(RETIRE_EXIT_CODE)


def _host_tensor(src) -> torch.Tensor:
    """A restored leaf (a numpy array, a CPU tensor, or flax's chunked dict)
    as one CPU tensor."""
    shape = msgpack.leaf_shape(src) if isinstance(src, dict) else tuple(
        np.shape(src))
    parts = [p if isinstance(p, torch.Tensor) else torch.from_numpy(
        np.asarray(p)) for p in msgpack.chunked_parts(src)]
    flat = parts[0].reshape(-1) if len(parts) == 1 else torch.cat(
        [p.reshape(-1) for p in parts])
    return flat.reshape(shape)


def _copy_into(dst, src, path, specs=None, index=0, cuts=None):
    """Copy a restored tree (numpy arrays, bf16 CPU tensors, or flax's
    chunked dicts) into the tensors of ``dst`` leaf by leaf, casting to
    each tensor's dtype; keys ``dst`` has and ``src`` lacks raise, keys
    only ``src`` has are ignored (as flax's ``from_state_dict``). With
    ``cuts`` (a tree like ``dst`` of functions, the whole leaf -> this
    rank's part over its model axis) the whole leaf in ``src`` is cut
    first; with
    ``specs`` (ZeRO shard specs like ``dst``), a sharded leaf of ``dst``
    then takes shard ``index`` of it."""
    if isinstance(dst, dict):
        missing = [k for k in dst if k not in src]
        if missing:
            raise ValueError(f"checkpoint {path} lacks {missing}")
        for k, v in dst.items():
            _copy_into(v, src[k], f"{path}/{k}",
                       None if specs is None else specs[k], index,
                       None if cuts is None else cuts[k])
        return
    if cuts is not None:
        whole = _host_tensor(src)
        src = cuts(whole)
        if src.shape == whole.shape:
            src = whole
        else:
            src = src.contiguous()
    shape = (msgpack.leaf_shape(src) if isinstance(src, dict)
             else tuple(src.shape) if isinstance(src, torch.Tensor)
             else tuple(np.shape(src)))
    if specs is not None and specs.sharded:
        want = list(dst.shape)
        want[specs.dim] *= specs.size
        if shape != tuple(want):
            raise ValueError(f"checkpoint {path} has shape {shape}, the "
                             f"engine {tuple(want)}")
        dst.copy_(partition.shard_of(_host_tensor(src), specs, index))
        return
    if shape != tuple(dst.shape):
        raise ValueError(f"checkpoint {path} has shape {shape}, the engine "
                         f"{tuple(dst.shape)}")
    flat = dst.view(-1)
    start = 0
    for part in msgpack.chunked_parts(src):
        t = part if isinstance(part, torch.Tensor) else torch.from_numpy(
            np.asarray(part))
        flat[start:start + t.numel()].copy_(t.reshape(-1))
        start += t.numel()


def _has_moe_layers(params) -> bool:
    """Whether a params tree holds GPT Mixture-of-Experts layers (the
    ``layers/moe`` subtree of models/gpt.py)."""
    layers = params.get("layers") if isinstance(params, dict) else None
    return isinstance(layers, dict) and "moe" in layers


def _concat(parts):
    """Micro-batches from the loader joined along rows."""
    first = parts[0]
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_concat([p[i] for p in parts])
                           for i in range(len(first)))
    return np.concatenate([np.asarray(p) for p in parts], axis=0)


def _micro_batch(batch, i, gas):
    """Rows [i * m, (i + 1) * m) of every leaf, m = rows // gas: the
    reference's reshape to (gas, m, ...) then scan."""
    if isinstance(batch, dict):
        return {k: _micro_batch(v, i, gas) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_micro_batch(v, i, gas) for v in batch)
    rows = batch.shape[0]
    if rows % gas:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{gas} micro-batches")
    m = rows // gas
    return batch[i * m:(i + 1) * m]


def _loss_fn_takes_rng(fn) -> bool:
    try:
        sig = inspect.signature(fn)
        kinds = [p.kind for p in sig.parameters.values()]
        if inspect.Parameter.VAR_POSITIONAL in kinds:
            return True  # *args catches the rng
        return len([p for p in sig.parameters.values()
                    if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                    and p.name != "pld_theta"]) >= 3
    except (TypeError, ValueError):
        return False


def _bootstrap_from_raw_config(config) -> None:
    """Join the process group a config's ``"distributed"`` block
    describes, before ``TrainingConfig`` reads the world size for the
    batch triple (the block lives inside the config, so the raw dict is
    peeked here, as the reference peeks its ``"mesh"`` block)."""
    if isinstance(config, TrainingConfig):
        dc = config.distributed_config()
    else:
        from ..distributed.config import DistributedConfig
        from .config_utils import load_config

        block = load_config(config).get("distributed")
        if not isinstance(block, dict) or block.get("enabled") is False:
            return
        dc = DistributedConfig.from_dict(dict(block, enabled=True))
    if dc is not None:
        from ..distributed import bootstrap as _dist_bootstrap

        _dist_bootstrap.bootstrap(dc)


def _mesh_from_raw_config(config):
    """The mesh a config's ``"mesh"`` block lays out over the world, or
    None without one (the raw dict is peeked, as the reference peeks it
    before its ``TrainingConfig``)."""
    if isinstance(config, TrainingConfig):
        mc = config.mesh_config()
        return mesh_lib.from_config(mc) if mc is not None else None
    from .config_utils import load_config

    block = load_config(config).get("mesh")
    if not isinstance(block, dict) or block.get("enabled") is False:
        return None
    return mesh_lib.from_config(dict(block, enabled=True))


def _optimizer_base_lr(opt, config):
    lr = getattr(opt, "lr", None)
    if lr is not None:
        return lr
    return (config.optimizer_params or {}).get("lr", 1e-3)


# ---------------------------------------------------------------------- #
# initialize()
# ---------------------------------------------------------------------- #


def initialize(
    args=None,
    model: Callable = None,
    optimizer=None,
    model_parameters=None,
    training_data=None,
    lr_scheduler=None,
    mpu=None,
    dist_init_required=None,
    collate_fn=None,
    config=None,
    config_params=None,
    device: Optional[str] = None,
    rng: Optional[int] = None,
    mesh=None,
    param_specs=None,
):
    """Build an Engine, as the reference's ``initialize``.

    Returns (engine, optimizer, training_dataloader, lr_scheduler).
    ``model`` is a loss callable ``loss_fn(params, batch[, rng])``;
    ``model_parameters`` is the initial params tree. A ``PipelineModule``
    builds a ``PipelineEngine`` (runtime/pipe/engine.py) over ``mesh``
    (``build_mesh({"pipe": P, ...})``, else the ``"mesh"`` block, else
    ``{"pipe": num_stages, "data": -1}``), its params drawn from ``rng``
    on each stage. A model config
    (``GPTConfig``) with a config that enables streaming builds the
    streamed ZeRO-Infinity engine instead (runtime/offload/streaming.py;
    ``model_parameters`` then optional, a fresh init from the streaming
    seed without them) and returns ``(engine, engine.opt, None, None)``;
    a ``BertConfig`` raises there. ``device`` defaults
    to CUDA. ``rng`` seeds the generators handed to a loss that takes one
    (default 0). Each process is one rank: the world size comes from an
    initialized ``torch.distributed`` group (1 without one), laid out by
    ``mesh`` (parallel/topology.build_mesh, e.g. a legacy ``{"data": d,
    "expert": e}`` mesh), else the config's ``"mesh"`` block, else every
    rank on the legacy ``data`` axis. The batch triple is derived for the
    mesh's data-parallel size (the ``expert``, tensor- and
    sequence-parallel axes hold the same rows).
    ``param_specs`` (``make_gpt``'s) mark the leaves split over the
    mesh's model axes (``model``/``tp``, ``expert``): each rank keeps its
    part of the whole params it is given. ``mpu`` (e.g.
    ``parallel.tp.ModelParallelUnit``) is kept as ``engine.mpu``. A
    ``"distributed"`` block joins the process group first
    (distributed/bootstrap.py)."""
    if model is None:
        raise ValueError("deepspeed.initialize requires a model")
    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if config is None:
        raise ValueError("a config (dict or json path) is required")
    if isinstance(model, (GPTConfig, BertConfig)):
        # the streamed ZeRO-Infinity route: a model config plus a config
        # that enables streaming (a "streaming" block, or ZeRO stage 3
        # with offload_param on cpu or nvme), as the reference routes it
        world = mesh_lib.world_size()
        ds_config = (config if isinstance(config, TrainingConfig)
                     else TrainingConfig(config, world_size=world))
        if not ds_config.streaming_enabled:
            raise ValueError(
                "initialize() got a model config (GPTConfig/BertConfig) "
                "but the ds_config does not enable the streaming engine — "
                'add a "streaming" block or zero stage 3 with '
                "offload_param.device cpu/nvme, or pass a loss callable "
                "instead of a model config")
        from .offload.streaming import build_streamed_engine

        # the streamed engine runs one rank: a world of several ranks, or a
        # "mesh" block with a data-parallel extent above 1, takes
        # build_streamed_engine's refusal
        mc = ds_config.mesh_config()
        mesh = None
        if world > 1 or (mc is not None and max(mc.dp, mc.fsdp) > 1):
            mesh = mc if mc is not None else mesh_lib.default_mesh()
        # the "kernels" block is process-global, as Engine applies it (a
        # refused config leaves it untouched)
        if ds_config.kernels_params and mesh is None:
            kernel_config.configure(**ds_config.kernels_params)
        engine = build_streamed_engine(model, ds_config,
                                       host_params=model_parameters,
                                       device=device, mesh=mesh)
        return engine, engine.opt, None, None
    from .pipe.module import PipelineModule

    if isinstance(model, PipelineModule):
        # the reference builds a PipelineEngine for a PipelineModule; its
        # batch triple counts the data axes only (pipe and model ranks
        # hold the same rows)
        from .pipe.engine import PipelineEngine

        _bootstrap_from_raw_config(config)
        if mesh is None:
            mesh = _mesh_from_raw_config(config)
        if mesh is None:
            from ..parallel.topology import PIPE_AXIS, build_mesh

            mesh = build_mesh({PIPE_AXIS: model.num_stages, "data": -1})
        ds_config = (config if isinstance(config, TrainingConfig)
                     else TrainingConfig(
                         config, world_size=rules.data_parallel_size(mesh)))
        engine = PipelineEngine(module=model, config=ds_config, mesh=mesh,
                                optimizer=optimizer,
                                lr_scheduler=lr_scheduler,
                                training_data=training_data, rng=rng,
                                device=device)
        return (engine, engine.optimizer, engine.training_dataloader,
                engine.lr_scheduler)
    if not callable(model):
        raise TypeError(
            "initialize() takes a loss callable, a PipelineModule or a "
            "model config")
    if model_parameters is None:
        raise ValueError("model_parameters (params pytree) required")
    _bootstrap_from_raw_config(config)
    if mesh is None:
        # a "mesh" block lays out the world before the batch triple reads
        # its data-parallel size (tp and sp ranks hold the same rows)
        mesh = _mesh_from_raw_config(config)
    world = (rules.data_parallel_size(mesh) if mesh is not None
             else mesh_lib.world_size())
    ds_config = (config if isinstance(config, TrainingConfig)
                 else TrainingConfig(config, world_size=world))
    engine = Engine(model=model, params=model_parameters, config=ds_config,
                    optimizer=optimizer, lr_scheduler=lr_scheduler,
                    training_data=training_data, collate_fn=collate_fn,
                    device=device, rng=rng, mesh=mesh,
                    param_specs=param_specs, mpu=mpu)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)

