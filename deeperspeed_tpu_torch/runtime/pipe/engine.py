"""The pipeline engine, one process a stage.

Counterpart of deeperspeed_tpu/runtime/pipe/engine.py (``PipelineEngine``:
``train_batch``, ``eval_batch``, ``inference_batch``, ``_exec_schedule``
with the instruction executors, tied-weight and data-parallel gradient
reduction, checkpoints in the reference's format).

The reference's engine is single-controller: one process drives every
stage and a send is a ``device_put`` between sub-meshes. A process of the
port is one rank, so the mesh's ``pipe`` axis is a process axis like the
others: the process at (pipe=s, data=d, model=m) owns stage s's layers
and runs only stage s's instruction stream of the reference's schedules
(runtime/pipe/schedule.py). ``SendActivation``/``RecvActivation``/
``SendGrad``/``RecvGrad`` are messages over the process group of one pipe
edge (runtime/pipe/p2p.py: gloo through host copies when the ranks share
one card, NCCL between cards). Sends are ``isend`` whose handles and
buffers are kept until they complete (all of them before
``OptimizerStep``); receives block. The reference issues every send of a
step before any receive; a rank cannot see the other ranks' order, and
what keeps them out of deadlock is the per-edge FIFO order of the
messages (the reference's send/recv pairing).

A stage keeps fp32 params (the master) and, under fp16 or bf16, a
compute-dtype copy the forward runs on. The forward of a micro-batch runs
without a graph; the backward re-runs the stage forward from the saved
stage input and differentiates it (the reference's full-stage
rematerialisation), so a stage holds at most ``num_pipe_buffers`` inputs
and none of their graphs. Grads are banked in fp32, each micro-batch's
scaled by 1 / (micro_batches * loss_scale).

At the end of the schedule: ``ReduceTiedGrads`` sums a tied key's grads
over the stages sharing it (one group a key); ``ReduceGrads`` takes the
mean over the stage's data group in fp32, then, under a ``"comm"``
block, the reducer's transform-only path (quantize -> dequantize with
error feedback, runtime/comm/reducer.py), as the reference does after
its GSPMD mean; ``OptimizerStep`` takes the global grad norm from each
stage's squares (a tied key counted at its owner stage only, a leaf cut
over the model axis summed over it), gathered over the pipe group and
summed in stage order, so every rank skips the same overflow step and
clips by the same coefficient. The loss and the last stage's outputs are
broadcast over the pipe group: every rank returns the same value.

Checkpoints: each stage writes its layer files (whole leaves, gathered
over the model axis) and pipe rank 0 gathers the optimizer states and
writes ``pipeline_engine_states.msgpack``; the files are the reference's,
so each package loads the other's, and a checkpoint saved at one stage
count loads at another (the layer files and the optimizer states are
keyed by layer).

ZeRO above stage 1 is refused, as in the reference; stage 1 keeps the
optimizer state whole on every rank, as the reference's pipeline does.
"""

import os
from typing import Any, List

import numpy as np
import torch

from ...checkpoint.serialization import (CheckpointEngine, read_latest,
                                         write_latest)
from ...monitor.tracer import trace_span
from ...ops import kernel_config
from ...ops.adam import FusedAdam, tree_leaves, tree_map
from ...parallel.topology import PIPE_AXIS, PipelineParallelGrid, build_mesh
from ...sharding import mesh as mesh_lib
from ...sharding import rules
from ...utils.logging import log_dist, logger
from ...utils.timer import SynchronizedWallClockTimer, ThroughputTimer
from .. import lr_schedules
from ..accessors import ConfigAccessorsMixin, make_summary_writer
from ..comm.collectives import Transport
from ..comm.config import CommConfig
from ..comm.reducer import GradReducer
from ..config import TrainingConfig
from ..dataloader import DeepSpeedDataLoader, RepeatingLoader
from ..fp16.loss_scaler import LossScaleState, create_loss_scaler
from . import p2p
from . import schedule as sched_mod
from .module import PipelineModule, TiedLayerSpec

STATE_FILE = "pipeline_engine_states.msgpack"


def _key(i: int) -> str:
    """A layer's key in a stage tree: zero-padded, so sorted keys (the
    reducer's bucket order) are layer order, as the reference's list."""
    return f"{i:05d}"


def _empty(tree) -> bool:
    return tree is None or (isinstance(tree, dict) and not tree_leaves(tree))


def _unflatten(like, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _floats(x):
    """The floating tensors of a stage input (a tensor or a tuple/list):
    what the backward differentiates with respect to."""
    items = list(x) if isinstance(x, (tuple, list)) else [x]
    return [t for t in items if isinstance(t, torch.Tensor)
            and t.is_floating_point()]


def _with_grads(x, grads):
    """``x``'s structure with each floating leaf replaced by its grad (in
    order) and every other leaf by None."""
    it = iter(grads)
    if isinstance(x, (tuple, list)):
        out = [next(it) if isinstance(t, torch.Tensor)
               and t.is_floating_point() else None for t in x]
        return type(x)(out)
    return next(it) if x.is_floating_point() else None


def _detached_input(x):
    """``x`` with its floating leaves detached as new autograd leaves."""
    def leaf(t):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            return t.detach().requires_grad_(True)
        return t
    if isinstance(x, (tuple, list)):
        return type(x)(leaf(t) for t in x)
    return leaf(x)


class PipelineEngine(ConfigAccessorsMixin):
    """Executes this rank's stage of the PipeSchedules over a
    PipelineModule (module docstring)."""

    def __init__(self, module: PipelineModule, config: TrainingConfig,
                 mesh=None, optimizer=None, lr_scheduler=None,
                 training_data=None, rng=None, device=None):
        if not isinstance(module, PipelineModule):
            raise TypeError("PipelineEngine takes a PipelineModule")
        if config.distributed_config() is not None:
            from ...distributed import bootstrap as _dist_bootstrap

            _dist_bootstrap.bootstrap(config.distributed_config())
        self.module = module
        self._config = config
        self.num_stages = module.num_stages
        self.micro_batches = config.gradient_accumulation_steps
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "PipelineEngine runs on CUDA unless given device='cpu', and "
                "no CUDA device is available")
        if mesh is None:
            mesh = build_mesh({PIPE_AXIS: self.num_stages, "data": -1})
        if int(mesh.shape.get(PIPE_AXIS, 1)) != self.num_stages:
            raise ValueError(
                f"PipelineEngine needs a mesh whose '{PIPE_AXIS}' axis has "
                f"num_stages={self.num_stages} ranks; got {mesh.shape}. "
                f"Build one with build_mesh({{'{PIPE_AXIS}': "
                f"{self.num_stages}, 'data': -1}}).")
        self.mesh = self.global_mesh = mesh
        self.grid = PipelineParallelGrid.from_mesh(mesh).make_groups(
            {k: module.tied_stages(k) for k in module.tied_specs})
        self._make_layer_groups()
        self.stage_id = self.grid.get_stage_id()
        self.is_first_stage = self.stage_id == 0
        self.is_last_stage = self.stage_id == self.num_stages - 1
        self.dp_world_size = self.data_parallel_size = \
            rules.data_parallel_size(mesh)
        if config.world_size != self.data_parallel_size:
            raise ValueError(
                f"the config's batch triple was derived for world size "
                f"{config.world_size}, the mesh {mesh.shape} has "
                f"{self.data_parallel_size} data-parallel ranks")
        self._compute_dtype = {"fp16": torch.float16,
                               "bfloat16": torch.bfloat16,
                               "fp32": torch.float32}[config.precision]
        # the pipeline always keeps fp32 params (the master) under fp16 or
        # bf16, as the reference's; grads are banked in fp32
        self._use_master = self._compute_dtype != torch.float32
        self._grad_dtype = torch.float32
        self._loss_scaler = create_loss_scaler(
            config.precision, static_loss_scale=config.loss_scale,
            dynamic_args=config.dynamic_loss_scale_args)
        self._dyn_scaler = (self._loss_scaler if self._loss_scaler.dynamic
                            else None)
        self.scaler_state = self._loss_scaler.init()
        self.loss_scale_value = float(self.scaler_state.loss_scale)
        if config.zero_optimization_stage > 1:
            raise AssertionError(
                "ZeRO stages 2/3 are incompatible with pipeline "
                "parallelism; use stage 0/1")
        if config.kernels_params:
            kernel_config.configure(**config.kernels_params)

        from ..engine import Engine, _optimizer_base_lr

        self.optimizer = optimizer or Engine._configure_basic_optimizer(self)
        self.lr_scheduler = lr_scheduler
        if self.lr_scheduler is None and config.scheduler_name:
            self.lr_scheduler = lr_schedules.get_scheduler(
                config.scheduler_name, config.scheduler_params or {})
        self._client_lr = _optimizer_base_lr(self.optimizer, config)
        self._lr_override = None
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._last_grad_norm = 0.0
        self._last_step_skipped = False
        self.summary_writer = make_summary_writer(config, mesh.rank)

        self._init_stage_state(0 if rng is None else rng)
        self._fwd = module.stage_forward(self.stage_id)
        self._init_reducers(config)
        self._pending: List[p2p.Pending] = []
        self._compute_loss = True
        self._reset_buffers(2)

        self.training_dataloader = None
        self._train_iter = None
        if training_data is not None:
            self.set_dataloader(DeepSpeedDataLoader(
                training_data, batch_size=(
                    config.train_micro_batch_size_per_gpu
                    * self.data_parallel_size)))
        self.tput_timer = ThroughputTimer(
            batch_size=config.train_batch_size, num_workers=1,
            steps_per_output=config.steps_per_print)
        self.timers = SynchronizedWallClockTimer()
        log_dist(f"pipeline engine: stages={self.num_stages} micro_batches="
                 f"{self.micro_batches} dp={self.data_parallel_size} "
                 f"mesh={mesh.shape} device={self.device}", ranks=[0])

    # -------------------------------------------------------------- #
    # groups and state
    # -------------------------------------------------------------- #

    def _make_layer_groups(self):
        """The tensor-parallel groups of every layer's own mesh, made here
        on every rank in layer order (``new_group`` is collective, and a
        stage would otherwise make them at its first forward, while the
        other stages do not)."""
        from ...parallel.tp import tp_transport

        for i in range(self.module.num_layers()):
            layer = self.module.layer(i)
            for obj in [layer] + list(vars(layer).values()):
                m = getattr(obj, "mesh", None)
                if isinstance(m, mesh_lib.Mesh):
                    tp_transport(m)

    def _stage_keys(self):
        """This stage's layer indices that hold params, and its tied
        keys."""
        own = list(self.module.stage_layer_indices(self.stage_id))
        tied = [k for k in self.module.tied_specs
                if self.stage_id in self.module.tied_stages(k)]
        return own, tied

    def _specs_of(self, layer_idx: int):
        return getattr(self.module.layer(layer_idx), "specs", None)

    def _tree_of(self, params_all):
        """The stage tree ``{"layers": {key: dict}, "tied": {key: dict}}``
        of a module params dict (its slots of this stage that hold
        params)."""
        own, tied = self._stage_keys()
        layers = {_key(i): params_all["layers"][i] for i in own
                  if not isinstance(self.module.layer_spec(i), TiedLayerSpec)
                  and not _empty(params_all["layers"][i])}
        return {"layers": layers,
                "tied": {k: params_all["tied"][k] for k in tied
                         if not _empty(params_all["tied"].get(k))}}

    def _params_all(self, tree):
        """The module params dict around a stage tree (other slots
        None)."""
        layers = [None] * self.module.num_layers()
        for k, v in tree["layers"].items():
            layers[int(k)] = v
        return {"layers": layers, "tied": tree["tied"]}

    def _spec_tree(self, tree):
        """The specs of a stage tree's leaves (None where a layer has
        none)."""
        def layer_specs(idx, sub):
            specs = self._specs_of(idx)
            return tree_map(lambda _: None, sub) if specs is None else \
                _fill_specs(sub, specs)
        return {"layers": {k: layer_specs(int(k), v)
                           for k, v in tree["layers"].items()},
                "tied": {k: layer_specs(self.module.tied_specs[k][0], v)
                         for k, v in tree["tied"].items()}}

    def _init_stage_state(self, seed):
        params_all = self.module.init_params(seed, self.device,
                                             stages=[self.stage_id])
        whole = self._tree_of(params_all)
        del params_all
        coords = self.mesh.coords()
        cuts = []

        def cut_leaf(p, spec):
            cut = rules.model_cut(spec, tuple(p.shape), self.mesh)
            cuts.append(cut)
            return p if cut is None else \
                cut.part(p, coords[cut.axis]).contiguous()

        self._specs = self._spec_tree(whole)
        with torch.no_grad():
            part = tree_map(cut_leaf, whole, self._specs)
        del whole
        self._cuts = cuts
        self._has_cuts = any(c is not None for c in cuts)
        self._cut_group = self.grid.model_group
        with torch.no_grad():
            if self._use_master:
                self.master = tree_map(lambda p: p.float().contiguous(), part)
                self.params = tree_map(
                    lambda p: p.to(self._compute_dtype).requires_grad_(True),
                    self.master)
            else:
                self.master = None
                self.params = tree_map(
                    lambda p: p.float().contiguous().requires_grad_(True),
                    part)
        del part
        self._opt_target = self.master if self._use_master else self.params
        from ..engine import part_groups_attr

        attr = part_groups_attr(self.optimizer)
        if self._has_cuts and attr is not None:
            # a cut leaf's whole-leaf statistics (the 1-bit scale, LAMB's
            # trust-ratio norms) are summed over the model axis
            group = self._cut_group
            setattr(self.optimizer, attr, _unflatten(
                self._opt_target, [group if c is not None else None
                                   for c in self._cuts]))
        self.opt_state = self.optimizer.init(self._opt_target)
        self._acc = None
        self._tied_transports = {
            k: Transport(self.grid.tied_group(k))
            for k in self._stage_keys()[1]
            if self.grid.tied_group(k) is not None}

    def _init_reducers(self, config):
        """The stage's fp32 data-parallel mean and, under a "comm" block,
        the transform-only reducer (both planned over the stage tree)."""
        self._comm_cfg = config.comm_config()
        self._dp_reducer = self._comm_reducer = None
        self._comm_state = None
        if _empty(self.params):
            return
        if self.data_parallel_size > 1:
            self._dp_reducer = GradReducer(CommConfig(mode="fp32"), self.mesh)
            self._dp_reducer.build_plan(self._opt_target)
            self._dp_state = self._dp_reducer.init_state(self.device)
        if self._comm_cfg is not None:
            self._comm_reducer = GradReducer(self._comm_cfg, self.mesh)
            self._comm_reducer.build_plan(self._opt_target)
            self._comm_state = self._comm_reducer.init_transform_state(
                self.device)

    def _reset_buffers(self, n: int):
        self.buffers = {"inputs": [None] * n, "labels": [None] * n,
                        "outputs": [None] * n, "in_grads": [None] * n,
                        "out_grads": [None] * n}
        self._losses: List[torch.Tensor] = []

    # -------------------------------------------------------------- #
    # the stage computation
    # -------------------------------------------------------------- #

    def _forward(self, x):
        with mesh_lib.use_mesh(self.mesh):
            return self._fwd(self._params_all(self.params), x)

    def _with_loss(self, buffer_id) -> bool:
        return (self.is_last_stage and self._compute_loss
                and self.module.loss_fn is not None
                and self.buffers["labels"][buffer_id] is not None)

    def _place(self, tree):
        """This data rank's rows of a micro-batch (numpy arrays or
        tensors, or tuples/lists of them) on the engine's device."""
        def leaf(a):
            if isinstance(a, torch.Tensor):
                return a.to(self.device)
            a = np.asarray(a)
            if a.dtype.kind in "ui":
                a = a.astype(np.int64)
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        tree = rules.place_batch(self.mesh, tree)
        if isinstance(tree, (tuple, list)):
            return type(tree)(leaf(a) for a in tree)
        return leaf(tree)

    def _exec_load_micro_batch(self, buffer_id):
        """Stage 0 keeps the inputs, the last stage the labels; every rank
        reads its micro-batches in order."""
        inputs, labels = self._micro_batch(self._mb_count)
        self._mb_count += 1
        if self.is_first_stage:
            self.buffers["inputs"][buffer_id] = self._place(inputs)
        if self.is_last_stage and labels is not None:
            self.buffers["labels"][buffer_id] = self._place(labels)

    def _exec_forward_pass(self, buffer_id):
        x = self.buffers["inputs"][buffer_id]
        with torch.no_grad():
            y = self._forward(x)
            if self._with_loss(buffer_id):
                loss = self.module.loss_fn(
                    y, self.buffers["labels"][buffer_id]).float()
                self._losses.append(loss.detach())
                return
        self.buffers["outputs"][buffer_id] = y
        if self.is_last_stage:
            self._outputs_final.append(y)

    def _exec_backward_pass(self, buffer_id):
        x = _detached_input(self.buffers["inputs"][buffer_id])
        wrt = _floats(x) if not self.is_first_stage else []
        leaves = tree_leaves(self.params)
        with torch.enable_grad():
            y = self._forward(x)
            if self.is_last_stage and self.module.loss_fn is not None:
                loss = self.module.loss_fn(
                    y, self.buffers["labels"][buffer_id]).float()
                outs, gouts = [loss * self.loss_scale_value], None
            else:
                g = self.buffers["in_grads"][buffer_id]
                outs = list(y) if isinstance(y, (tuple, list)) else [y]
                gouts = list(g) if isinstance(g, (tuple, list)) else [g]
                keep = [i for i, t in enumerate(gouts) if t is not None]
                outs = [outs[i] for i in keep]
                gouts = [gouts[i].to(outs[j].dtype)
                         for j, i in enumerate(keep)]
            grads = torch.autograd.grad(outs, leaves + wrt,
                                        grad_outputs=gouts,
                                        allow_unused=True)
        del y, outs
        scale = 1.0 / (self.micro_batches * self.loss_scale_value)
        dp = grads[:len(leaves)]
        with torch.no_grad():
            if self._acc is None:
                self._acc = [torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device) for p in leaves]
            for a, g in zip(self._acc, dp):
                if g is not None:
                    a.add_(g.float() * scale)
        if wrt:
            dx = [torch.zeros_like(t) if g is None else g
                  for t, g in zip(wrt, grads[len(leaves):])]
            self.buffers["out_grads"][buffer_id] = _with_grads(x, dx)
        self.buffers["inputs"][buffer_id] = None
        self.buffers["labels"][buffer_id] = None
        self.buffers["in_grads"][buffer_id] = None

    # -------------------------------------------------------------- #
    # p2p
    # -------------------------------------------------------------- #

    def _peer(self, stage):
        return (self.grid.stage_to_global_rank(stage),
                self.grid.edge_group(self.stage_id, stage))

    def _exec_send_activation(self, buffer_id):
        dst, group = self._peer(self.stage_id + 1)
        self._pending.append(p2p.send(self.buffers["outputs"][buffer_id],
                                      dst, group, self.device))
        self.buffers["outputs"][buffer_id] = None

    def _exec_recv_activation(self, buffer_id):
        src, group = self._peer(self.stage_id - 1)
        self.buffers["inputs"][buffer_id] = p2p.recv(src, group, self.device)

    def _exec_send_grad(self, buffer_id):
        dst, group = self._peer(self.stage_id - 1)
        self._pending.append(p2p.send(self.buffers["out_grads"][buffer_id],
                                      dst, group, self.device))
        self.buffers["out_grads"][buffer_id] = None

    def _exec_recv_grad(self, buffer_id):
        src, group = self._peer(self.stage_id + 1)
        self.buffers["in_grads"][buffer_id] = p2p.recv(src, group,
                                                       self.device)

    # -------------------------------------------------------------- #
    # reductions and the update
    # -------------------------------------------------------------- #

    def _acc_tree(self):
        return _unflatten(self._opt_target, self._acc)

    @torch.no_grad()
    def _exec_reduce_tied_grads(self):
        """A tied key's grads summed over the stages sharing it, so their
        identical updates keep the copies in step."""
        if self._acc is None or not self._tied_transports:
            return
        tree = self._acc_tree()
        for key, tr in self._tied_transports.items():
            for g in tree_leaves(tree["tied"][key]):
                g.copy_(tr.all_reduce_sum(g))

    @torch.no_grad()
    def _exec_reduce_grads(self):
        """The mean over the stage's data group in fp32; under a "comm"
        block, then the transform-only wire path with error feedback."""
        if self._acc is None:
            return
        tree = self._acc_tree()
        if self._dp_reducer is not None:
            tree, self._dp_state = self._dp_reducer.reduce_dispatch(
                tree, self._dp_state)
        if self._comm_reducer is not None:
            tree, self._comm_state = self._comm_reducer.transform_dispatch(
                tree, self._comm_state)
        self._acc = [g.float() for g in tree_leaves(tree)]

    def _stage_sqnorm(self) -> torch.Tensor:
        """This stage's squared grad norm (fp32): a tied key counted at its
        owner stage only, a leaf cut over the model axis summed over
        it."""
        owner = {k: self.module.tied_owner_stage(k) == self.stage_id
                 for k in self.module.tied_specs}
        mask = _unflatten(self._opt_target, [True] * len(self._acc))
        for k in mask["tied"]:
            mask["tied"][k] = tree_map(lambda _, o=owner[k]: o,
                                       mask["tied"][k])
        counted = tree_leaves(mask)
        sq = [g.float().square().sum() for g in self._acc]
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        whole = [q for q, c, m in zip(sq, self._cuts, counted)
                 if m and c is None]
        total = torch.stack(whole).sum() if whole else zero
        cut = [q for q, c, m in zip(sq, self._cuts, counted)
               if m and c is not None]
        if cut:
            total = total + self._cut_group.all_reduce_sum(
                torch.stack(cut).sum().reshape(1))[0]
        return total

    def _update_loss_scale(self, overflow: bool):
        self.scaler_state = self._loss_scaler.update(self.scaler_state,
                                                     overflow)
        self.loss_scale_value = float(self.scaler_state.loss_scale)

    @torch.no_grad()
    def _exec_optimizer_step(self):
        p2p.wait_all(self._pending)
        clip = float(self._config.gradient_clipping or 0.0)
        mine = (self._stage_sqnorm() if self._acc is not None
                else torch.zeros((), dtype=torch.float32,
                                 device=self.device))
        per_stage = self.grid.pipe_group.all_gather(mine.reshape(1))
        sq = 0.0
        for v in per_stage.reshape(-1).tolist():
            sq += float(np.float32(v))
        gnorm = float(np.sqrt(sq))
        if not np.isfinite(gnorm):
            self.skipped_steps += 1
            self._acc = None
            self._last_grad_norm = gnorm
            self._last_step_skipped = True
            self._update_loss_scale(overflow=True)
            log_dist(f"non-finite grad norm {gnorm}; skipping step (loss "
                     f"scale -> {self.loss_scale_value})", ranks=[0])
            return
        self._update_loss_scale(overflow=False)
        coef = 1.0 if clip <= 0 else min(1.0, clip / (gnorm + 1e-6))
        lr = self._current_lr()
        self._last_applied_lr = float(lr)
        self._last_step_skipped = False
        if self._acc is not None:
            for g in self._acc:
                g.mul_(coef)
            grads = self._acc_tree()
            if isinstance(self.optimizer, FusedAdam) and self._use_master:
                _, self.opt_state = self.optimizer.update(
                    grads, self.opt_state, self.master, lr,
                    cast=self.params)
            else:
                _, self.opt_state = self.optimizer.update(
                    grads, self.opt_state, self._opt_target, lr)
                if self._use_master:
                    tree_map(lambda c, m: c.copy_(m), self.params,
                             self.master)
            del grads
            self._acc = None
        self._last_grad_norm = gnorm
        self.global_steps += 1
        self.global_samples += self._config.train_batch_size
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
            self._lr_override = None

    def load_module_params(self, params_all):
        """Copy a whole module's params (``{"layers": [...], "tied":
        {...}}``, whole leaves: tensors or numpy arrays, e.g.
        ``models.convert.from_jax_pipeline_params``'s) into this stage:
        its layers' leaves, cut to this rank's part over the model axis,
        into the fp32 params and their compute-dtype copy."""
        with torch.no_grad():
            self._copy_whole(self._opt_target, self._tree_of(params_all),
                             "params")
            if self._use_master:
                tree_map(lambda c, m: c.copy_(m), self.params, self.master)

    def stage_params(self):
        """This stage's fp32 params in the module layout (``{"layers":
        [dict | None], "tied": {...}}``, other stages' slots None), this
        rank's parts of the cut leaves."""
        return self._params_all(self._opt_target)

    def get_global_grad_norm(self):
        return self._last_grad_norm

    def loss_scale(self):
        return self.loss_scale_value

    # -------------------------------------------------------------- #
    # schedule execution
    # -------------------------------------------------------------- #

    _SEND_TYPES = (sched_mod.SendActivation, sched_mod.SendGrad)

    def _exec_schedule(self, make_schedule, train: bool,
                       compute_loss: bool = True):
        sched = make_schedule(self.micro_batches, self.num_stages,
                              self.stage_id)
        self._reset_buffers(sched.num_pipe_buffers())
        self._outputs_final: List[Any] = []
        self._compute_loss = compute_loss
        self._mb_count = 0
        wall = self._config.wall_clock_breakdown and train
        lane = f"pipe/stage{self.stage_id}"
        executors = {
            sched_mod.SendActivation: ("comms", self._exec_send_activation),
            sched_mod.SendGrad: ("comms", self._exec_send_grad),
            sched_mod.RecvActivation: ("comms", self._exec_recv_activation),
            sched_mod.RecvGrad: ("comms", self._exec_recv_grad),
            sched_mod.LoadMicroBatch: (None, self._exec_load_micro_batch),
            sched_mod.ForwardPass: ("fwd", self._exec_forward_pass),
            sched_mod.BackwardPass: ("bwd", self._exec_backward_pass),
            sched_mod.ReduceTiedGrads: ("comms",
                                        self._exec_reduce_tied_grads),
            sched_mod.ReduceGrads: ("comms", self._exec_reduce_grads),
            sched_mod.OptimizerStep: ("step", self._exec_optimizer_step),
        }
        for cmds in sched.steps():
            # this stage's sends first (they ship what earlier steps made),
            # as the reference's step runs every send before the rest
            ordered = ([c for c in cmds if isinstance(c, self._SEND_TYPES)]
                       + [c for c in cmds
                          if not isinstance(c, self._SEND_TYPES)])
            for cmd in ordered:
                if type(cmd) not in executors:
                    raise RuntimeError(f"unknown instruction {cmd!r}")
                phase, fn = executors[type(cmd)]
                args = ((cmd.buffer_id,)
                        if isinstance(cmd, sched_mod.BufferOpInstruction)
                        else ())
                span = "pipe/" + fn.__name__.replace("_exec_", "")
                with trace_span(span, lane=lane, stage=self.stage_id):
                    if not wall or phase is None:
                        fn(*args)
                        continue
                    # the device finishes each instruction's work inside
                    # its own interval
                    tm = self.timers(f"pipe_{phase}")
                    tm.safe_start(sync=True)
                    fn(*args)
                    tm.stop(sync=True)
        p2p.wait_all(self._pending)

    # -------------------------------------------------------------- #
    # data plumbing
    # -------------------------------------------------------------- #

    def _micro_batch(self, index: int):
        mb = self._current_micro_batches[index]
        if isinstance(mb, (tuple, list)) and len(mb) == 2:
            return mb[0], mb[1]
        return mb, None

    def _pull_micro_batches(self, data_iter):
        self._current_micro_batches = [next(data_iter)
                                       for _ in range(self.micro_batches)]

    def set_dataloader(self, loader):
        self.training_dataloader = loader
        self._train_iter = iter(RepeatingLoader(loader))

    def _pipe_sum(self, value: float) -> float:
        """``value`` of the last stage on every rank of the pipe group
        (the others add 0.0: the same bits everywhere)."""
        t = torch.tensor([value if self.is_last_stage else 0.0],
                         dtype=torch.float64)
        return float(self.grid.pipe_group.all_reduce_sum(t)[0])

    def _aggregate_total_loss(self):
        """The mean over the micro-batches of each micro-batch's loss
        (itself the mean over the data ranks), the same on every rank."""
        mean = 0.0
        if self.is_last_stage and self._losses:
            losses = torch.stack(self._losses).float()
            if self.data_parallel_size > 1:
                losses = self.grid.data_group.all_reduce_sum(losses) / \
                    self.data_parallel_size
            vals = losses.tolist()
            mean = sum(vals) / len(vals)
        return self._pipe_sum(mean)

    # -------------------------------------------------------------- #
    # public API
    # -------------------------------------------------------------- #

    def train_batch(self, data_iter=None):
        """One optimizer step over ``micro_batches`` micro-batches drawn
        from ``data_iter`` (each an ``(inputs, labels)`` pair of micro *
        dp rows); returns the mean loss, the same on every rank."""
        if data_iter is None:
            if self._train_iter is None:
                raise RuntimeError("train_batch() without a data iterator "
                                   "needs training_data at initialize()")
            data_iter = self._train_iter
        wall = self._config.wall_clock_breakdown
        if wall:
            self.timers("pipe_batch").safe_start(sync=True)
        self.tput_timer.start()
        with trace_span("pipe/train_batch", lane="pipe",
                        step=self.global_steps):
            self._pull_micro_batches(data_iter)
            self._exec_schedule(sched_mod.TrainSchedule, train=True)
            self.micro_steps += self.micro_batches
            loss = self._aggregate_total_loss()
        self.tput_timer.stop(global_step=True)
        if self.summary_writer is not None and not self._last_step_skipped:
            scalars = {"Train/Samples/lr": getattr(
                self, "_last_applied_lr", self._current_lr()),
                "Train/Samples/train_loss": float(loss)}
            if self._dyn_scaler is not None:
                scalars["Train/Samples/loss_scale"] = self.loss_scale_value
            self.summary_writer.write_scalars(scalars, self.global_samples)
            if self.global_steps % self._config.steps_per_print == 0:
                self.summary_writer.flush()
        if wall:
            self.timers("pipe_batch").stop(sync=True)
        if self.global_steps % self._config.steps_per_print == 0:
            log_dist(f"step={self.global_steps} loss={loss:.4f} "
                     f"lr={self._current_lr():.3e}", ranks=[0])
            if wall:
                self._log_phase_breakdown()
        return loss

    def phase_seconds(self):
        """This rank's seconds in each phase since the last reading (the
        ``wall_clock_breakdown`` timers, the device synchronized at each
        instruction's ends): fwd, bwd, comms (p2p and the reductions),
        step, and the whole batch; the timers restart from zero."""
        out = {p: self.timers(f"pipe_{p}").elapsed(reset=True)
               for p in ("fwd", "bwd", "comms", "step")}
        out["batch"] = self.timers("pipe_batch").elapsed(reset=True)
        return out

    def _log_phase_breakdown(self):
        """fwd/bwd/comms/step shares of this rank's batch time, and the
        rest (data loading, loss aggregation) as 'other'."""
        sec = self.phase_seconds()
        total = sec.pop("batch")
        elapsed = {f"pipe_{p}": v for p, v in sec.items()}
        total = total if total > 0 else (sum(elapsed.values()) or 1.0)
        other = max(total - sum(elapsed.values()), 0.0)
        parts = " | ".join(
            f"{p.removeprefix('pipe_')}: {1e3 * v:.1f}ms "
            f"({100 * v / total:.0f}%)" for p, v in elapsed.items())
        msg = (f"pipe batch breakdown (stage {self.stage_id}, of "
               f"{1e3 * total:.1f}ms): {parts} | other: {1e3 * other:.1f}ms "
               f"({100 * other / total:.0f}%)")
        log_dist(msg, ranks=[self.mesh.rank])
        return msg

    def eval_batch(self, data_iter):
        """Forward-only pipelined evaluation: the mean loss, the same on
        every rank."""
        self._pull_micro_batches(data_iter)
        self._exec_schedule(sched_mod.InferenceSchedule, train=False)
        return self._aggregate_total_loss()

    def inference_batch(self, inputs):
        """Forward-only pipelined inference of one micro-batch: the last
        stage's output (a tensor on the engine's device), broadcast to
        every rank of the pipe group and gathered over the data ranks."""
        rows = int(np.shape(inputs)[0])
        if rows % self.data_parallel_size:
            raise ValueError(f"inference_batch: {rows} rows do not split "
                             f"over {self.data_parallel_size} data ranks")
        self._current_micro_batches = [(inputs, None)]
        saved = self.micro_batches
        self.micro_batches = 1
        try:
            with trace_span("pipe/inference_batch", lane="pipe"):
                self._exec_schedule(sched_mod.InferenceSchedule,
                                    train=False, compute_loss=False)
        finally:
            self.micro_batches = saved
        out = self._outputs_final[-1] if self.is_last_stage else None
        self._outputs_final = []
        last = self.grid.stage_to_global_rank(self.num_stages - 1)
        out = p2p.broadcast(out, last, self.grid.pipe_group.group,
                            self.device)
        if self.data_parallel_size > 1:
            g = self.grid.data_group.all_gather(out)
            out = g.reshape((-1,) + tuple(out.shape[1:]))
        return out

    def serving_logits_fn(self):
        """The logits function the serving bridge drives
        (serving.PipelineServingBridge.from_pipeline_engine): one
        full-prefix forward a call through the pipelined stages."""
        return self.inference_batch

    def is_gradient_accumulation_boundary(self):
        return True

    # -------------------------------------------------------------- #
    # checkpoints
    # -------------------------------------------------------------- #

    def _whole(self, tree):
        """A stage tree with its cut leaves gathered whole over the model
        axis (collective over the model group), on the host."""
        def leaf(t, c):
            if c is None:
                return t.detach().cpu()
            parts = self._cut_group.all_gather(t.detach())
            return c.join(parts.unbind(0)).cpu()
        with torch.no_grad():
            return _unflatten(tree, [leaf(t, c) for t, c in
                                     zip(tree_leaves(tree), self._cuts)])

    def _writes(self) -> bool:
        """This rank writes its stage's files: data and model rank 0."""
        c = self.mesh.coords()
        return all(v == 0 for a, v in c.items() if a != PIPE_AXIS)

    def _gather_stage_trees(self, tree, info=None):
        """Every stage's host ``tree`` (nested dicts of tensors) and
        picklable ``info`` on pipe rank 0, a list of (tree, info) by stage
        (None on the other ranks): each stage sends its leaves' paths and
        its info, then its leaves, one message a leaf, over the pipe
        group."""
        import torch.distributed as dist

        if self.num_stages == 1:
            return [(tree, info)]
        group = self.grid.pipe_group.group
        root = self.grid.stage_to_global_rank(0)
        if not self.is_first_stage:
            items = list(_paths(tree))
            dist.send_object_list([[p for p, _ in items], info], root,
                                  group=group)
            pend = [p2p.send(t, root, group, self.device) for _, t in items]
            p2p.wait_all(pend)
            return None
        out = [(tree, info)]
        for s in range(1, self.num_stages):
            src = self.grid.stage_to_global_rank(s)
            box = [None, None]
            dist.recv_object_list(box, src, group=group)
            got = {}
            for path in box[0]:
                node = got
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = p2p.recv(src, group, self.device).cpu()
            out.append((got, box[1]))
        return out

    def _reference_tree(self, tree):
        """A stage tree in the reference's layout: ``{"layers": [dict |
        None] (every layer of the module), "tied": {...}}``, dict keys
        sorted."""
        layers = [None] * self.module.num_layers()
        for k, v in tree.get("layers", {}).items():
            layers[int(k)] = v
        return {"layers": layers,
                "tied": dict(sorted(tree.get("tied", {}).items()))}

    def _opt_host_tree(self):
        """This stage's optimizer state, whole leaves on the host: (step,
        [field trees])."""
        st = self.opt_state
        fields = [self._whole(t) for t in st[1:]]
        return int(st.step), fields

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """Every rank calls it. Each stage's data-0/model-0 rank writes its
        layer files; pipe rank 0 of that row gathers the optimizer states
        and writes ``pipeline_engine_states.msgpack`` and ``latest``."""
        if tag is None:
            tag = f"global_step{self.global_steps}"
        tag = str(tag)
        ck = CheckpointEngine(save_dir, tag)
        writes = self._writes()
        params = self._whole(self._opt_target)
        step, fields = self._opt_host_tree()
        comm = (None if self._comm_state is None else
                [{k: v.detach().cpu() for k, v in b.items()}
                 for b in self._comm_state])
        if writes:
            self.module.save_state_dict(
                ck.ckpt_dir, self._params_all(params),
                layers=self.module.stage_layer_indices(self.stage_id))
            gathered = self._gather_stage_trees(
                {"fields": {str(j): f for j, f in enumerate(fields)},
                 "comm": {str(j): b for j, b in enumerate(comm or [])}},
                None if self._comm_reducer is None
                else self._comm_reducer.plan_summary())
            if self.is_first_stage:
                self._write_state_file(ck, gathered, step, client_state)
                if save_latest:
                    write_latest(save_dir, tag)
        del params, fields
        Transport(self.mesh.group(tuple(self.mesh.shape))).barrier()
        log_dist(f"saved pipeline checkpoint {ck.ckpt_dir}", ranks=[0])
        return True

    def _write_state_file(self, ck, gathered, step, client_state):
        st_type = type(self.opt_state)
        opt_states = []
        for g, _ in gathered:
            fields = [self._reference_tree(g["fields"].get(str(j), {}))
                      for j in range(len(st_type._fields) - 1)]
            opt_states.append(st_type(np.asarray(step, np.int32), *fields))
        sc = self.scaler_state
        meta = {
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "micro_steps": self.micro_steps,
            "num_stages": self.num_stages,
            "parts": list(self.module.parts),
            "lr_scheduler": (self.lr_scheduler.state_dict()
                             if self.lr_scheduler else {}),
            "client_state": client_state or {},
            "opt_states": opt_states,
            "skipped_steps": self.skipped_steps,
            "loss_scaler": {
                "good_steps": np.asarray(sc.good_steps, np.int32),
                "hysteresis": np.asarray(sc.hysteresis, np.int32),
                "loss_scale": np.asarray(sc.loss_scale, np.float32)},
        }
        if self._comm_cfg is not None:
            meta["comm_states"] = [_as_list(g.get("comm", {})) or None
                                   for g, _ in gathered]
            meta["comm_plans"] = [plan for _, plan in gathered]
        ck.save(STATE_FILE, meta)

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True):
        """Restore a checkpoint of either package, at any stage count:
        this stage's layers from their files, its optimizer state from
        the saved stages that held its layers. Returns (tag directory,
        client_state), or (None, {}) when nothing is loadable."""
        if tag is None:
            tag = read_latest(load_dir)
            if tag is None:
                logger.warning("no 'latest' file in %s; nothing loaded",
                               load_dir)
                return None, {}
        ck = CheckpointEngine(load_dir, str(tag))
        if not ck.exists(STATE_FILE):
            logger.warning("pipeline checkpoint %s missing", ck.ckpt_dir)
            return None, {}
        meta = ck.load(STATE_FILE)
        skel = self._params_all(tree_map(lambda _: 0, self._opt_target))
        loaded = self._tree_of(self.module.load_state_dir(ck.ckpt_dir, skel))
        with torch.no_grad():
            self._copy_whole(self._opt_target, loaded, "layer files")
            if self._use_master:
                tree_map(lambda c, m: c.copy_(m), self.params, self.master)
        self.global_steps = int(meta.get("global_steps", 0))
        self.global_samples = int(meta.get("global_samples", 0))
        self.micro_steps = int(meta.get("micro_steps", 0))
        if load_optimizer_states:
            self.skipped_steps = int(meta.get("skipped_steps", 0))
        if (load_optimizer_states and self._dyn_scaler is not None
                and meta.get("loss_scaler")):
            sc = meta["loss_scaler"]
            self.scaler_state = LossScaleState(
                float(sc["loss_scale"]), int(sc["good_steps"]),
                int(sc["hysteresis"]))
            self.loss_scale_value = float(self.scaler_state.loss_scale)
        if load_optimizer_states and meta.get("opt_states"):
            self._load_opt_states(meta["opt_states"], meta.get("parts"))
        if (load_optimizer_states and self._comm_reducer is not None
                and meta.get("comm_states") is not None):
            self._load_comm_state(meta)
        if (load_lr_scheduler_states and self.lr_scheduler is not None
                and meta.get("lr_scheduler")):
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        log_dist(f"loaded pipeline checkpoint {ck.ckpt_dir}", ranks=[0])
        return ck.ckpt_dir, meta.get("client_state", {})

    def _copy_whole(self, target, whole, what):
        """Copy a tree of whole leaves (host arrays) into ``target``'s
        tensors, each cut to this rank's part over the model axis."""
        coords = self.mesh.coords()
        for (path, t), c in zip(_paths(target), self._cuts):
            src = _at(whole, path)
            if src is None or isinstance(src, int):
                raise KeyError(f"{what}: no entry for {'/'.join(path)}")
            src = torch.as_tensor(np.asarray(src) if not isinstance(
                src, torch.Tensor) else src)
            if c is not None:
                src = c.part(src, coords[c.axis])
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{what}: {'/'.join(path)} has shape "
                                 f"{tuple(src.shape)}, the engine's "
                                 f"{tuple(t.shape)}")
            t.copy_(src.to(t.device, t.dtype))

    def _load_opt_states(self, saved, parts):
        """Each field of this stage's optimizer state from the saved
        stage that held the layer (or tied key)."""
        saved = _as_list(saved)
        parts = ([int(p) for p in _as_list(parts)] if parts is not None
                 else list(self.module.parts))

        def owner(i):
            for s in range(len(parts) - 1):
                if parts[s] <= i < parts[s + 1]:
                    return s
            raise IndexError(i)

        st = self.opt_state
        with torch.no_grad():
            for j, field in enumerate(st._fields[1:], 1):
                whole = {"layers": {}, "tied": {}}
                for k in st[j]["layers"]:
                    entry = saved[owner(int(k))][field]["layers"]
                    whole["layers"][k] = entry[k.lstrip("0") or "0"] \
                        if isinstance(entry, dict) else entry[int(k)]
                for k in st[j]["tied"]:
                    src = next(s for s in saved
                               if k in (s[field].get("tied") or {}))
                    whole["tied"][k] = src[field]["tied"][k]
                self._copy_whole(st[j], whole, f"opt_states/{field}")
        step = saved[0]["step"]
        self.opt_state = st._replace(step=int(np.asarray(step)))

    def _load_comm_state(self, meta):
        """This stage's transform residuals from the checkpoint, reshaped
        onto the running bucket plan (another world size pads the buckets
        otherwise); zeros, with a warning, when the layout differs."""
        from ...resilience.reshard import reshard_transform_residuals

        states = _as_list(meta["comm_states"])
        plans = meta.get("comm_plans")
        s = self.stage_id
        saved = states[s] if s < len(states) else None
        plan = (_as_list(plans)[s] if plans is not None and s < len(plans)
                else None)
        resharded = (None if saved is None else reshard_transform_residuals(
            saved, plan, self._comm_reducer.plan_summary()))
        if resharded is None:
            logger.warning("stage %d comm residuals not restored: error "
                           "feedback restarts from zero", s)
            return
        with torch.no_grad():
            for res, got in zip(self._comm_state, resharded):
                for k, v in res.items():
                    v.copy_(torch.as_tensor(got[k]))

    def save_fp16_model(self, save_dir, save_filename="model_fp16.msgpack"):
        """The whole module's params in the compute dtype, written by rank
        0 (every rank calls it)."""
        from ...checkpoint.serialization import save_tree

        cast = tree_map(lambda t: t.to(self._compute_dtype),
                        self._whole(self._opt_target))
        gathered = (self._gather_stage_trees(cast) if self._writes()
                    else None)
        path = os.path.join(save_dir, save_filename)
        if gathered is not None and self.is_first_stage:
            merged = {"layers": {}, "tied": {}}
            for g, _ in gathered:
                merged["layers"].update(g.get("layers", {}))
                for k, v in g.get("tied", {}).items():
                    merged["tied"].setdefault(k, v)
            os.makedirs(save_dir, exist_ok=True)
            save_tree(path, self._reference_tree(merged))
        Transport(self.mesh.group(tuple(self.mesh.shape))).barrier()
        log_dist(f"saved fp16 model weights to {path}", ranks=[0])
        return path


def _as_list(x):
    """A list restored from msgpack (flax writes lists as {"0": ...})."""
    if isinstance(x, dict):
        return [x[str(i)] for i in range(len(x))]
    return list(x)


def _fill_specs(tree, specs):
    """``specs`` (nested like a layer's params, possibly partial) laid
    over ``tree``: None where no spec is given."""
    if isinstance(tree, dict):
        return {k: _fill_specs(v, specs.get(k) if isinstance(specs, dict)
                               else None) for k, v in tree.items()}
    return None if isinstance(specs, dict) else specs


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _at(tree, path):
    for k in path:
        if tree is None:
            return None
        tree = tree.get(k) if isinstance(tree, dict) else None
    return tree
