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

Not ported yet (ROADMAP.md): checkpoint save/load, ZeRO and the mesh,
comm, monitor hooks, ``store_gradients``, layer-output hooks, the flops
profiler, offload and the pipeline engine.
"""

import inspect
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.adam import FusedAdam, tree_leaves, tree_map
from ..ops import kernel_config
from ..utils.logging import log_dist
from ..utils.timer import SynchronizedWallClockTimer, ThroughputTimer
from . import lr_schedules
from .accessors import ConfigAccessorsMixin
from .config import TrainingConfig
from .dataloader import DeepSpeedDataLoader, RepeatingLoader
from .fp16.loss_scaler import create_loss_scaler

FORWARD_MICRO_TIMER = "forward_microstep"
BACKWARD_MICRO_TIMER = "backward_microstep"
STEP_MICRO_TIMER = "step_microstep"
TRAIN_BATCH_TIMER = "train_batch"

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
# known to the reference, not ported yet: name -> ROADMAP.md queue 1 item
_UNPORTED_OPTIMIZERS = {
    "lamb": "Training follow-ups",
    "sgd": "Training follow-ups",
    "cpuadam": "Offload and ZeRO-Infinity",
    "onebitadam": "runtime/comm/",
    "onebitlamb": "runtime/comm/",
}


def _dtype_of(precision: str) -> torch.dtype:
    return {"fp16": torch.float16, "bfloat16": torch.bfloat16,
            "fp32": torch.float32}[precision]


def tree_unflatten(like, leaves):
    """Rebuild the nested-dict structure of ``like`` from ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


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
    ):
        self._config = config
        self.loss_fn = model
        self.module = model  # reference-compatible alias
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Engine runs on CUDA unless given device='cpu', and no CUDA "
                "device is available")
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
        self.zero_stage = 0

        self.timers = SynchronizedWallClockTimer()
        self.tput_timer = ThroughputTimer(
            batch_size=config.train_micro_batch_size_per_gpu
            * config.gradient_accumulation_steps,
            num_workers=1, steps_per_output=config.steps_per_print)

        # the "kernels" block is process-global (the consumers are free
        # functions deep inside model code); it must land before the
        # optimizer checks its route
        if config.kernels_params:
            kernel_config.configure(**config.kernels_params)

        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self._mode = "train"
        self._stashed = None   # the loss of forward(), pending backward()
        self._grad_acc = None  # banked grads between backward() and step()
        self._acc_count = 0
        self._pending_metrics = None
        self._lr_override = None
        self._train_data_iter = None

        self._loss_scaler = create_loss_scaler(
            config.precision, static_loss_scale=config.loss_scale,
            dynamic_args=config.dynamic_loss_scale_args)
        self.optimizer = optimizer or self._configure_basic_optimizer()
        self.lr_scheduler = lr_scheduler or self._configure_lr_scheduler()
        self._client_lr = _optimizer_base_lr(self.optimizer, config)
        if isinstance(self.optimizer, FusedAdam):
            self.optimizer.check_kernel_route(self.device)

        # the engine owns its state: copies, never aliases of the caller's
        with torch.no_grad():
            self.params = tree_map(
                lambda p: torch.as_tensor(p).to(
                    self.device, self._compute_dtype, copy=True
                ).requires_grad_(True), params)
            # the fp32 master starts from the caller's values, not from
            # their compute-dtype cast
            self.master = (tree_map(lambda p: torch.as_tensor(p).to(
                self.device, torch.float32, copy=True), params)
                           if self._use_master else None)
        self.opt_state = self.optimizer.init(
            self.master if self._use_master else self.params)
        self.scaler_state = self._loss_scaler.init()
        self.skipped = 0          # overflow-skipped optimizer steps
        self.optimizer_steps = 0  # applied optimizer steps

        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(
                training_data, collate_fn=collate_fn)
        log_dist(f"engine ready: precision={config.precision} "
                 f"device={self.device} master={self._use_master}",
                 ranks=[0])

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
        batch_size = batch_size or self.train_micro_batch_size_per_gpu()
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
        """A host batch (numpy arrays or tensors, or tuples/lists/dicts of
        them) on the engine's device; integer arrays become int64."""
        if isinstance(batch, dict):
            return {k: self._place_batch(v) for k, v in batch.items()}
        if isinstance(batch, (tuple, list)):
            return type(batch)(self._place_batch(v) for v in batch)
        if isinstance(batch, torch.Tensor):
            return batch.to(self.device)
        a = np.asarray(batch)
        if a.dtype.kind in "ui":
            a = a.astype(np.int64)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _rng(self) -> torch.Generator:
        """This call's generator: seeded from (engine seed, call count), the
        counterpart of the reference's fold_in(base_key, ticket)."""
        tick = self._rng_tick
        self._rng_tick += 1
        seed = (self._seed * 0x9E3779B97F4A7C15 + tick + 1) % (2 ** 63)
        return torch.Generator(device=self.device).manual_seed(seed)

    def _call_loss(self, batch):
        out = (self.loss_fn(self.params, batch, self._rng())
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
        raw_sq = torch.stack([g.float().square().sum() for g in grads]).sum()
        gnorm = torch.sqrt(raw_sq) * inv  # norm of the UNSCALED grads
        coef = inv
        if clip > 0:
            coef = torch.clamp(clip / (gnorm + 1e-6), max=1.0) * inv
        for g in grads:
            g.copy_(g.float() * coef)
        return gnorm, bool(torch.isfinite(gnorm))

    def _apply_update(self, grads, lr, gas):
        """Unscale, clip and, unless the grads overflowed, step the
        optimizer; returns the step's metrics."""
        grads = [g.to(self._grad_dtype) for g in grads]
        clip = float(self._config.gradient_clipping or 0.0)
        loss_scale = self.scaler_state.loss_scale
        gnorm, finite = self._postprocess_grads(grads, gas, clip)
        overflow = not finite
        if not overflow:
            with torch.no_grad():
                target = self.master if self._use_master else self.params
                _, self.opt_state = self.optimizer.update(
                    tree_unflatten(target, grads), self.opt_state, target,
                    lr)
                if self._use_master:
                    tree_map(lambda p, m: p.copy_(m), self.params,
                             self.master)
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
        loss = self._call_loss(batch)
        if wall:
            self.timers(FORWARD_MICRO_TIMER).stop(sync_with=loss)
        self._stashed = loss
        return loss

    def backward(self, loss=None, allreduce_gradients=True):
        """Bank the gradients of the last ``forward()``'s loss. With one
        device there is no reduction to route, so ``allreduce_gradients``
        is accepted for API compatibility."""
        if self._stashed is None:
            raise RuntimeError("backward() requires a prior forward()")
        stashed, self._stashed = self._stashed, None
        wall = self._config.wall_clock_breakdown
        if wall:
            self.timers(BACKWARD_MICRO_TIMER).safe_start()
        self._bank(self._micro_grads(stashed))
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
            metrics = self._apply_update(self._grad_acc, self._current_lr(),
                                         float(self._acc_count))
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
        if batch is None:
            it = data_iter or self._train_iter()
            batch = _concat([next(it) for _ in range(gas)])
        wall = self._config.wall_clock_breakdown
        if wall:
            self.timers(TRAIN_BATCH_TIMER).safe_start()
        self.tput_timer.start()
        batch = self._place_batch(batch)
        loss_sum = None
        for i in range(gas):
            mb = _micro_batch(batch, i, gas)
            loss = self._call_loss(mb)
            self._bank(self._micro_grads(loss))
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            del loss
        metrics = self._apply_update(self._grad_acc, self._current_lr(),
                                     float(gas))
        self._grad_acc = None
        self._acc_count = 0
        metrics["loss"] = loss_sum / gas
        self.micro_steps += gas
        self._after_optimizer_step(metrics)
        self.tput_timer.stop(global_step=True, sync_with=metrics["loss"])
        if wall:
            self.timers(TRAIN_BATCH_TIMER).stop(sync_with=metrics["loss"])
            if self.global_steps % max(self._config.steps_per_print, 1) == 0:
                self.timers.log([TRAIN_BATCH_TIMER], ranks=[0])
        return metrics["loss"]

    def eval_batch(self, batch):
        with torch.no_grad():
            return self._call_loss(self._place_batch(batch))

    def _after_optimizer_step(self, metrics):
        """Bookkeeping after an optimizer step (applied or skipped). An
        overflow-skipped step leaves the LR schedule where it was under a
        dynamic loss scaler, as the reference does."""
        self.global_steps += 1
        self.global_samples += self.train_batch_size()
        self._pending_metrics = metrics
        if self._loss_scaler.dynamic and metrics["overflow"]:
            log_dist(f"OVERFLOW! skipping step; loss scale -> "
                     f"{self.loss_scale()}", ranks=[0])
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step()
            self._lr_override = None

    def module_state_dict(self):
        """The params (compute dtype) as a tree of detached tensors."""
        return tree_map(lambda p: p.detach(), self.params)


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
):
    """Build an Engine, as the reference's ``initialize``.

    Returns (engine, optimizer, training_dataloader, lr_scheduler).
    ``model`` is a loss callable ``loss_fn(params, batch[, rng])``;
    ``model_parameters`` is the initial params tree. ``device`` defaults
    to CUDA. ``rng`` seeds the generators handed to a loss that takes one
    (default 0). One process drives one device (world size 1)."""
    if model is None:
        raise ValueError("deepspeed.initialize requires a model")
    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if config is None:
        raise ValueError("a config (dict or json path) is required")
    if mpu is not None:
        raise NotImplementedError(
            "mpu (tensor parallelism) is not ported to the PyTorch package "
            "yet (ROADMAP.md queue 1, item 'MoE, TP and pipeline')")
    if not callable(model) or hasattr(model, "n_layer"):
        raise NotImplementedError(
            "initialize() takes a loss callable in the PyTorch package; the "
            "streaming engine for a model config and the PipelineModule "
            "engine are not ported yet (ROADMAP.md queue 1, items "
            "'Offload and ZeRO-Infinity' and 'MoE, TP and pipeline')")
    if model_parameters is None:
        raise ValueError("model_parameters (params pytree) required")
    ds_config = (config if isinstance(config, TrainingConfig)
                 else TrainingConfig(config, world_size=1))
    engine = Engine(model=model, params=model_parameters, config=ds_config,
                    optimizer=optimizer, lr_scheduler=lr_scheduler,
                    training_data=training_data, collate_fn=collate_fn,
                    device=device, rng=rng)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)
