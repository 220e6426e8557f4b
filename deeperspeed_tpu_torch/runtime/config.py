"""Master training config.

Counterpart of deeperspeed_tpu/runtime/config.py (``TrainingConfig``):
the same JSON keys and defaults, the same batch-triple derivation and
assertion, the same precision selection (fp16 / bf16 / the fork's
``fp16.type: bfloat16``, ``master_weights``, ``grad_accum_dtype``, loss
scale keys), the same optimizer/scheduler/clipping/logging fields and the
same error messages.

The port does not run every subsystem of the reference yet. A block that
turns one of them on raises ``ConfigError`` naming the ROADMAP.md item
that ports it; nothing is ignored. The blocks the port runs: the batch
triple, precision, ``optimizer``, ``scheduler``, ``gradient_clipping``,
``steps_per_print``, ``wall_clock_breakdown``, ``kernels``, ``serving``,
``monitor`` (``monitor_config``), ``tensorboard``, ``sparse_attention``
(read by ``get_sparse_attention``, as in the reference),
``zero_optimization`` (``zero_config``: stages 0-2 for ``Engine``; stage
3 and the offload devices for the streamed engine, which ``Engine``
refuses), ``streaming`` (``streaming_enabled``, ``streaming_params``),
``aio`` (``aio_config``), ``mesh`` with dp and fsdp (``mesh_config``),
``pipeline`` (stored as ``pipeline``, as the reference stores it),
``comm`` (``comm_config``), ``datapipe`` (``datapipe_config``),
``batch_scheduler``, ``checkpoint`` (tag validation; ``sharded_io:
true``, the orbax layout, raises until sharded checkpoints are ported),
``resilience`` (``resilience_config``), ``distributed``
(``distributed_config``) and ``elasticity`` (the batch rewrite and
``elastic_canonical_shards``, as the reference's ``_handle_elasticity``).
"""

import copy

from ..elasticity import (compute_elastic_config,
                          ensure_immutable_elastic_config)
from ..elasticity import constants as ec
from ..sharding.config import MeshConfig
from ..utils.logging import logger
from . import constants as c
from .comm.config import CommConfig
from .config_utils import load_config
from .offload.aio_config import AioConfig
from .zero.config import ZeroConfig


class ConfigError(Exception):
    pass


def _unported(what: str, item: str) -> ConfigError:
    return ConfigError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP.md "
        f"queue 1, item '{item}'); remove it or use the JAX package")


def _block_enabled(pd, key, enabled_key="enabled"):
    """A presence-enabled block: on when present, unless {"enabled": false};
    a non-dict value is a ConfigError, as in the reference."""
    block = pd.get(key, None)
    if block is None:
        return False
    if not isinstance(block, dict):
        raise ConfigError(f'"{key}" must be a dict (or {{"enabled": false}})')
    explicit = block.get(enabled_key)
    return bool(explicit) if explicit is not None else True


class TrainingConfig:
    """The port's DeepSpeedConfig."""

    def __init__(self, config, world_size=1):
        # deep-copy so nothing here ever mutates caller data
        self._param_dict = copy.deepcopy(load_config(config))
        self.world_size = world_size
        self.elasticity_enabled = False
        self.elastic_valid_world_sizes = None
        # canonical reduction-slot count (0 = off): when set, the gradient
        # reduction is restructured to be bit-identical across every
        # admissible world size (Engine._train_step_canonical)
        self.elastic_canonical_shards = 0
        self._refuse_unported(self._param_dict)
        # the autotuner's record: only its keys are checked here, as the
        # reference does (its config.py); the knob hash is
        # autotune.provenance.verify_provenance's
        self.provenance_params = self._param_dict.get(c.PROVENANCE, None)
        if self.provenance_params is not None:
            from ..autotune.provenance import PROVENANCE_REQUIRED_KEYS

            if not isinstance(self.provenance_params, dict):
                raise ConfigError(
                    '"provenance" must be the record emitted by '
                    'deeperspeed_tpu.autotune (a dict)')
            missing = [k for k in PROVENANCE_REQUIRED_KEYS
                       if k not in self.provenance_params]
            if missing:
                raise ConfigError(
                    f'"provenance" record is missing keys {missing} — '
                    f"re-run the autotuner or drop the block")
        self._handle_elasticity()
        self._initialize_params(self._param_dict)
        self._set_batch_related_parameters()
        self._do_sanity_check()

    # ------------------------------------------------------------------ #

    def _refuse_unported(self, pd):
        zero = pd.get(c.ZERO_OPTIMIZATION, {})
        if isinstance(zero, bool):
            # legacy: "zero_optimization": true  => stage 1
            zero = {c.ZERO_STAGE: 1 if zero else 0}
        stage = zero.get(c.ZERO_STAGE, 0)
        if not (0 <= stage <= c.MAX_STAGE_ZERO_OPTIMIZATION):
            raise ValueError(f"ZeRO stage must be in [0, 3], got {stage}")

        if _block_enabled(pd, c.AUTOTUNE):
            raise _unported(f'the "{c.AUTOTUNE}" block', "Tooling")

        flag_blocks = (
            (c.PROGRESSIVE_LAYER_DROP, c.PLD_ENABLED, "Tooling"),
            (c.FLOPS_PROFILER, "enabled", "Tooling"),
        )
        for key, flag, item in flag_blocks:
            if (pd.get(key) or {}).get(flag, False):
                raise _unported(f'the "{key}" block', item)
        if pd.get(c.ACTIVATION_CHECKPOINTING):
            raise _unported(f'the "{c.ACTIVATION_CHECKPOINTING}" block',
                            "Tooling")

    def _handle_elasticity(self):
        """The reference's elasticity batch rewrite: an enabled
        ``"elasticity"`` block picks the global batch and the micro batch
        for this world size (``compute_elastic_config``) and rewrites the
        batch triple; the batch keys must then be absent unless
        ``ignore_non_elastic_batch_info``."""
        pd = self._param_dict
        elastic_dict = pd.get(ec.ELASTICITY, {})
        if not elastic_dict.get(ec.ENABLED, ec.ENABLED_DEFAULT):
            return
        self.elasticity_enabled = True
        ensure_immutable_elastic_config(elastic_dict)
        final_batch_size, valid_gpus, micro_batch = compute_elastic_config(
            pd, world_size=self.world_size)
        self.elastic_valid_world_sizes = valid_gpus
        self.elastic_canonical_shards = int(
            elastic_dict.get(ec.CANONICAL_SHARDS,
                             ec.CANONICAL_SHARDS_DEFAULT))
        if self.elastic_canonical_shards < 0:
            raise ConfigError(
                "elasticity.canonical_shards must be >= 0, got "
                f"{self.elastic_canonical_shards}")
        ignore = elastic_dict.get(ec.IGNORE_NON_ELASTIC_BATCH_INFO,
                                  ec.IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT)
        batch_keys = (c.TRAIN_BATCH_SIZE, c.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
                      c.GRADIENT_ACCUMULATION_STEPS)
        if not ignore and any(k in pd for k in batch_keys):
            raise ConfigError(
                "elasticity is enabled — batch parameters "
                f"{batch_keys} must not be set (or set "
                f"elasticity.{ec.IGNORE_NON_ELASTIC_BATCH_INFO}: true)")
        gas = final_batch_size // (micro_batch * self.world_size)
        pd[c.TRAIN_BATCH_SIZE] = final_batch_size
        pd[c.TRAIN_MICRO_BATCH_SIZE_PER_GPU] = micro_batch
        pd[c.GRADIENT_ACCUMULATION_STEPS] = gas
        logger.info("elasticity rewrote batch params: train=%d micro=%d "
                    "gas=%d", final_batch_size, micro_batch, gas)

    def _initialize_params(self, pd):
        self.train_batch_size = pd.get(c.TRAIN_BATCH_SIZE,
                                       c.TRAIN_BATCH_SIZE_DEFAULT)
        self.train_micro_batch_size_per_gpu = pd.get(
            c.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
            c.TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT)
        self.gradient_accumulation_steps = pd.get(
            c.GRADIENT_ACCUMULATION_STEPS,
            c.GRADIENT_ACCUMULATION_STEPS_DEFAULT)
        self.steps_per_print = pd.get(c.STEPS_PER_PRINT,
                                      c.STEPS_PER_PRINT_DEFAULT)
        self.dump_state = pd.get(c.DUMP_STATE, c.DUMP_STATE_DEFAULT)

        self.gradient_clipping = pd.get(c.GRADIENT_CLIPPING,
                                        c.GRADIENT_CLIPPING_DEFAULT)
        self.prescale_gradients = pd.get(c.PRESCALE_GRADIENTS,
                                         c.PRESCALE_GRADIENTS_DEFAULT)
        self.gradient_predivide_factor = pd.get(
            c.GRADIENT_PREDIVIDE_FACTOR, c.GRADIENT_PREDIVIDE_FACTOR_DEFAULT)
        self.sparse_gradients_enabled = pd.get(c.SPARSE_GRADIENTS,
                                               c.SPARSE_GRADIENTS_DEFAULT)
        self.fp32_allreduce = pd.get(c.FP32_ALLREDUCE,
                                     c.FP32_ALLREDUCE_DEFAULT)
        self.allgather_size = pd.get(c.ALLGATHER_SIZE,
                                     c.ALLGATHER_SIZE_DEFAULT)

        # ---- precision ----
        fp16_dict = pd.get(c.FP16, {})
        bf16_dict = pd.get(c.BFLOAT16, {})
        self.fp16_enabled = fp16_dict.get(c.FP16_ENABLED,
                                          c.FP16_ENABLED_DEFAULT)
        fp16_type = fp16_dict.get(c.FP16_TYPE, c.FP16_TYPE_DEFAULT)
        bf16_enabled = bf16_dict.get(c.BFLOAT16_ENABLED,
                                     c.BFLOAT16_ENABLED_DEFAULT)
        if self.fp16_enabled and fp16_type in ("bfloat16", "bf16"):
            self.precision = c.PRECISION_BF16
        elif self.fp16_enabled:
            self.precision = c.PRECISION_FP16
        elif bf16_enabled:
            self.precision = c.PRECISION_BF16
        else:
            self.precision = c.PRECISION_FP32
        self.bfloat16_enabled = self.precision == c.PRECISION_BF16
        # masterless bf16: no fp32 master copy, bf16-stored optimizer
        # moments, bf16 grads. bf16-only — fp16 needs the master for
        # loss-scale unscaling precision
        self.master_weights = bool(
            bf16_dict.get(c.BFLOAT16_MASTER_WEIGHTS,
                          fp16_dict.get(c.BFLOAT16_MASTER_WEIGHTS,
                                        c.BFLOAT16_MASTER_WEIGHTS_DEFAULT))
        )
        if not self.master_weights and self.precision == c.PRECISION_FP16:
            raise ValueError(
                "master_weights: false is not supported with fp16 — fp16 "
                "must keep an fp32 master for loss-scale unscaling (use "
                "bf16 for the masterless memory-lean mode)"
            )

        self.grad_accum_dtype = bf16_dict.get(
            c.BFLOAT16_GRAD_ACCUM_DTYPE,
            fp16_dict.get(c.BFLOAT16_GRAD_ACCUM_DTYPE,
                          c.BFLOAT16_GRAD_ACCUM_DTYPE_DEFAULT)
        )
        if self.grad_accum_dtype not in (None, "fp32", "float32",
                                         "bf16", "bfloat16"):
            raise ValueError(
                f"grad_accum_dtype must be fp32/bf16/None, got "
                f"{self.grad_accum_dtype!r}"
            )

        self.loss_scale = fp16_dict.get(c.FP16_LOSS_SCALE,
                                        c.FP16_LOSS_SCALE_DEFAULT)
        self.initial_scale_power = fp16_dict.get(
            c.FP16_INITIAL_SCALE_POWER, c.FP16_INITIAL_SCALE_POWER_DEFAULT)
        self.loss_scale_window = fp16_dict.get(
            c.FP16_LOSS_SCALE_WINDOW, c.FP16_LOSS_SCALE_WINDOW_DEFAULT)
        self.hysteresis = fp16_dict.get(c.FP16_HYSTERESIS,
                                        c.FP16_HYSTERESIS_DEFAULT)
        self.min_loss_scale = fp16_dict.get(c.FP16_MIN_LOSS_SCALE,
                                            c.FP16_MIN_LOSS_SCALE_DEFAULT)
        # bf16 trains without loss scaling (static scale 1.0), like the fork
        if (self.precision == c.PRECISION_BF16
                and c.FP16_LOSS_SCALE not in fp16_dict):
            self.loss_scale = 1.0

        # ---- optimizer / scheduler ----
        optimizer_dict = pd.get(c.OPTIMIZER, None)
        self.optimizer_name = None
        self.optimizer_params = None
        self.optimizer_legacy_fusion = c.LEGACY_FUSION_DEFAULT
        if optimizer_dict is not None:
            self.optimizer_name = optimizer_dict.get(c.TYPE, None)
            self.optimizer_params = optimizer_dict.get(c.OPTIMIZER_PARAMS, {})
            self.optimizer_legacy_fusion = optimizer_dict.get(
                c.LEGACY_FUSION, c.LEGACY_FUSION_DEFAULT)
        scheduler_dict = pd.get(c.SCHEDULER, None)
        self.scheduler_name = None
        self.scheduler_params = None
        if scheduler_dict is not None:
            self.scheduler_name = scheduler_dict.get(c.TYPE, None)
            self.scheduler_params = scheduler_dict.get(c.SCHEDULER_PARAMS, {})

        self.zero_allow_untested_optimizer = pd.get(
            c.ZERO_ALLOW_UNTESTED_OPTIMIZER,
            c.ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT)
        self.zero_config = ZeroConfig(pd)
        self.zero_enabled = self.zero_config.enabled
        self.zero_optimization_stage = self.zero_config.stage
        self.aio_config = AioConfig(pd)

        # ---- streamed ZeRO-Infinity engine ----
        # A "streaming" block opts in (and carries StreamConfig field
        # overrides); ZeRO stage 3 with offload_param on cpu or nvme also
        # routes initialize() with a model config to the streamed engine
        self.streaming_params = pd.get(c.STREAMING, None)
        if self.streaming_params is not None and not isinstance(
                self.streaming_params, dict):
            raise ConfigError('"streaming" must be a dict of StreamConfig '
                              'overrides (or {"enabled": false})')
        explicit = (self.streaming_params or {}).get(c.STREAMING_ENABLED)
        self.streaming_enabled = (
            explicit if explicit is not None else (
                self.streaming_params is not None
                or (self.zero_optimization_stage == 3
                    and self.zero_config.offload_param.enabled)))

        # ---- comm (bucketed / quantized gradient collectives) ----
        self.comm_params = pd.get(c.COMM, None)
        if self.comm_params is not None and not isinstance(
                self.comm_params, dict):
            raise ConfigError('"comm" must be a dict of CommConfig '
                              'overrides (or {"enabled": false})')
        self.comm_enabled = _block_enabled(pd, c.COMM)
        self._comm_config = None
        if self.comm_enabled:
            try:
                self._comm_config = CommConfig.from_dict(
                    dict(self.comm_params, enabled=True))
            except ValueError as e:
                raise ConfigError(f'invalid "comm" block: {e}') from e

        # ---- named mesh (dp x fsdp x tp x sp layout) ----
        self.mesh_params = pd.get(c.MESH, None)
        if self.mesh_params is not None and not isinstance(
                self.mesh_params, dict):
            raise ConfigError('"mesh" must be a dict of axis extents like '
                              '{"dp": 2, "fsdp": 4} (or {"enabled": false})')
        self.mesh_enabled = _block_enabled(pd, c.MESH)
        self._mesh_config = None
        if self.mesh_enabled:
            try:
                self._mesh_config = MeshConfig.from_dict(
                    dict(self.mesh_params, enabled=True))
            except ValueError as e:
                raise ConfigError(f'invalid "mesh" block: {e}') from e

        self.wall_clock_breakdown = pd.get(c.WALL_CLOCK_BREAKDOWN,
                                           c.WALL_CLOCK_BREAKDOWN_DEFAULT)
        tb = pd.get(c.TENSORBOARD, {})
        self.tensorboard_enabled = tb.get(c.TENSORBOARD_ENABLED,
                                          c.TENSORBOARD_ENABLED_DEFAULT)
        self.tensorboard_output_path = tb.get(
            c.TENSORBOARD_OUTPUT_PATH, c.TENSORBOARD_OUTPUT_PATH_DEFAULT)
        self.tensorboard_job_name = tb.get(c.TENSORBOARD_JOB_NAME,
                                           c.TENSORBOARD_JOB_NAME_DEFAULT)
        self.memory_breakdown = pd.get(c.MEMORY_BREAKDOWN,
                                       c.MEMORY_BREAKDOWN_DEFAULT)

        ckpt = pd.get(c.CHECKPOINT, {})
        validation_mode = ckpt.get(c.CHECKPOINT_TAG_VALIDATION,
                                   c.CHECKPOINT_TAG_VALIDATION_DEFAULT)
        self.checkpoint_tag_validation_mode = str(validation_mode).capitalize()
        if (self.checkpoint_tag_validation_mode
                not in c.CHECKPOINT_TAG_VALIDATION_MODES):
            raise ConfigError(
                f"{c.CHECKPOINT_TAG_VALIDATION}: {validation_mode} invalid, "
                f"must be one of {c.CHECKPOINT_TAG_VALIDATION_MODES}"
            )
        self.checkpoint_tag_validation_enabled = (
            self.checkpoint_tag_validation_mode != "Ignore")
        self.checkpoint_tag_validation_fail = (
            self.checkpoint_tag_validation_mode == "Fail")
        if ckpt.get(c.CHECKPOINT_SHARDED_IO, c.CHECKPOINT_SHARDED_IO_DEFAULT):
            raise _unported("checkpoint.sharded_io (the orbax per-shard "
                            "layout)", "Sharded checkpoints")
        self.load_from_fp32_weights = pd.get(c.LOAD_FROM_FP32_WEIGHTS, True)

        # ---- continuous-batching serving ----
        self.serving_params = pd.get(c.SERVING, None)
        self.serving_enabled = _block_enabled(pd, c.SERVING)
        self._serving_config = None
        if self.serving_enabled:
            from ..serving.config import ServingConfig

            try:
                self._serving_config = ServingConfig.from_dict(
                    self.serving_params)
            except ValueError as e:
                raise ConfigError(f'invalid "serving" block: {e}') from e

        # ---- unified telemetry ----
        # A "monitor" block turns on step tracing / the recompile
        # watchdog / the metrics endpoint (monitor/ package). Validated
        # eagerly like "serving" so typos fail at load time.
        self.monitor_params = pd.get(c.MONITOR, None)
        if self.monitor_params is not None and not isinstance(
                self.monitor_params, dict):
            raise ConfigError('"monitor" must be a dict of MonitorConfig '
                              'overrides (or {"enabled": false})')
        self.monitor_enabled = _block_enabled(pd, c.MONITOR)
        self._monitor_config = None
        if self.monitor_enabled:
            from ..monitor.config import MonitorConfig

            try:
                self._monitor_config = MonitorConfig.from_dict(
                    dict(self.monitor_params, enabled=True))
            except ValueError as e:
                raise ConfigError(f'invalid "monitor" block: {e}') from e

        # ---- resilience (async checkpointing / preemption / resume) ----
        # A "resilience" block turns on resilience/: async two-phase-commit
        # saves, manifest verification at load, the preemption guard,
        # fault injection. Validated eagerly like "serving"/"monitor".
        self.resilience_params = pd.get(c.RESILIENCE, None)
        if self.resilience_params is not None and not isinstance(
                self.resilience_params, dict):
            raise ConfigError('"resilience" must be a dict of '
                              'ResilienceConfig overrides (or {"enabled": '
                              'false})')
        self.resilience_enabled = _block_enabled(pd, c.RESILIENCE)
        self._resilience_config = None
        if self.resilience_enabled:
            from ..resilience.config import ResilienceConfig

            try:
                self._resilience_config = ResilienceConfig.from_dict(
                    dict(self.resilience_params, enabled=True))
            except ValueError as e:
                raise ConfigError(f'invalid "resilience" block: {e}') from e

        # ---- lifecycle (the train->serve control plane) ----
        # A "lifecycle" block arms the live re-mesh (pool-change signal ->
        # a coordinated topology flip at a step boundary) and weight-
        # version publishing (COMMITTED tags -> VERSIONS.json records the
        # serving fleet rolls onto). Validated eagerly so a typo'd signal
        # name fails at load time.
        self.lifecycle_params = pd.get(c.LIFECYCLE, None)
        if self.lifecycle_params is not None and not isinstance(
                self.lifecycle_params, dict):
            raise ConfigError('"lifecycle" must be a dict of '
                              'LifecycleConfig overrides (or {"enabled": '
                              'false})')
        self.lifecycle_enabled = _block_enabled(pd, c.LIFECYCLE)
        self._lifecycle_config = None
        if self.lifecycle_enabled:
            from ..lifecycle.config import LifecycleConfig

            try:
                self._lifecycle_config = LifecycleConfig.from_dict(
                    dict(self.lifecycle_params, enabled=True))
            except ValueError as e:
                raise ConfigError(f'invalid "lifecycle" block: {e}') from e

        # ---- distributed (the multi-process runtime) ----
        # A "distributed" block configures the process-group rendezvous:
        # coordinator address and process shape (or environment
        # discovery), init timeout with retry backoff, the host-tensor
        # backend, the per-host rendezvous record directory. Validated
        # eagerly so a typo'd coordinator address fails at load.
        self.distributed_params = pd.get(c.DISTRIBUTED, None)
        if self.distributed_params is not None and not isinstance(
                self.distributed_params, dict):
            raise ConfigError('"distributed" must be a dict of '
                              'DistributedConfig overrides (or {"enabled": '
                              'false})')
        self.distributed_enabled = _block_enabled(pd, c.DISTRIBUTED)
        self._distributed_config = None
        if self.distributed_enabled:
            from ..distributed.config import DistributedConfig

            try:
                self._distributed_config = DistributedConfig.from_dict(
                    dict(self.distributed_params, enabled=True))
            except ValueError as e:
                raise ConfigError(
                    f'invalid "distributed" block: {e}') from e

        # ---- fused kernels ----
        # validated eagerly so typos fail at load; applied process-globally
        # at engine init (the consumers are free functions deep inside
        # model code)
        self.kernels_params = pd.get(c.KERNELS, None)
        self.kernels_mode = c.KERNELS_MODE_DEFAULT
        if self.kernels_params is not None:
            from ..ops import kernel_config

            try:
                self.kernels_params = kernel_config.validate(
                    self.kernels_params)
            except ValueError as e:
                raise ConfigError(f'invalid "kernels" block: {e}') from e
            self.kernels_mode = self.kernels_params.get(
                c.KERNELS_MODE, c.KERNELS_MODE_DEFAULT)

        # ---- datapipe (the streaming, prefetching input pipeline) ----
        # A "datapipe" block turns on datapipe/: memory-mapped token
        # shards, the prefetch thread with device staging, the
        # checkpointable DataState, curriculum and packing. Validated
        # eagerly like "serving"/"monitor".
        self.datapipe_params = pd.get(c.DATAPIPE, None)
        if self.datapipe_params is not None and not isinstance(
                self.datapipe_params, dict):
            raise ConfigError(
                '"datapipe" must be a dict of DataPipeConfig '
                'overrides (or {"enabled": false})')
        self.datapipe_enabled = _block_enabled(pd, c.DATAPIPE,
                                               c.DATAPIPE_ENABLED)
        self._datapipe_config = None
        if self.datapipe_enabled:
            from ..datapipe.config import DataPipeConfig

            try:
                self._datapipe_config = DataPipeConfig.from_dict(
                    dict(self.datapipe_params, enabled=True))
            except ValueError as e:
                raise ConfigError(f'invalid "datapipe" block: {e}') from e

        # ---- batch-size warmup (runtime/bs_schedules.py) ----
        bs_sched = pd.get(c.BATCH_SCHEDULER, {})
        if isinstance(bs_sched, dict):
            self.batch_scheduler_enabled = bs_sched.get(
                c.BATCH_SCHEDULER_ENABLED, c.BATCH_SCHEDULER_ENABLED_DEFAULT)
            self.batch_scheduler_params = bs_sched
        else:
            self.batch_scheduler_enabled = bool(bs_sched)
            self.batch_scheduler_params = {}

        self.gradient_noise_scale = pd.get(c.GRADIENT_NOISE_SCALE, None)
        # read, not built: get_sparse_attention builds (and checks) it, as
        # the reference does
        # stored as the reference stores it; the pipeline engine takes
        # its layout from the PipelineModule and the mesh
        self.pipeline = pd.get(c.PIPELINE, {})
        self.sparse_attention = pd.get(c.SPARSE_ATTENTION, None)

    def monitor_config(self):
        """The "monitor" block as a MonitorConfig (None when absent or
        disabled), validated at parse time."""
        return self._monitor_config

    def resilience_config(self):
        """The "resilience" block as a ResilienceConfig (None when absent
        or disabled)."""
        return self._resilience_config

    def lifecycle_config(self):
        """The "lifecycle" block as a LifecycleConfig (None when absent or
        disabled), validated at parse time."""
        return self._lifecycle_config

    def distributed_config(self):
        """The "distributed" block as a DistributedConfig (None when
        absent or disabled)."""
        return self._distributed_config

    def datapipe_config(self):
        """The "datapipe" block as a DataPipeConfig (None when absent or
        disabled), validated at parse time."""
        return self._datapipe_config

    def comm_config(self):
        """The "comm" block as a CommConfig (None when absent or
        disabled), validated at parse time."""
        return self._comm_config

    def mesh_config(self):
        """The "mesh" block as a sharding.MeshConfig (None when absent or
        disabled), validated at parse time."""
        return self._mesh_config

    def serving_config(self):
        """The "serving" block as a ServingConfig (None when the block is
        absent or disabled), validated at parse time."""
        return self._serving_config

    def get_sparse_attention(self, num_heads: int):
        """Build the configured SparsityConfig (DeepSpeed's
        runtime/config.py:213 get_sparse_attention); None when the block is
        absent. An unknown mode or a bad argument raises here, as in the
        reference."""
        if not self.sparse_attention:
            return None
        from ..ops.sparse_attention import sparsity_config_from_dict

        return sparsity_config_from_dict(num_heads, self.sparse_attention)

    # ------------------------------------------------------------------ #

    def _batch_assertion(self):
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        assert train > 0, f"Train batch size: {train} has to be greater than 0"
        assert micro > 0, f"Micro batch size per gpu: {micro} has to be greater than 0"
        assert gas > 0, f"Gradient accumulation steps: {gas} has to be greater than 0"
        assert train == micro * gas * self.world_size, (
            f"Check batch related parameters. train_batch_size is not equal "
            f"to micro_batch_per_gpu * gradient_acc_step * world_size "
            f"{train} != {micro} * {gas} * {self.world_size}"
        )

    def _set_batch_related_parameters(self):
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps

        # all three parameters provided — just validate below
        if all(x is not None for x in (train, micro, gas)):
            pass
        # global + micro -> derive gas
        elif train is not None and micro is not None:
            gas = train // (micro * self.world_size)
            self.gradient_accumulation_steps = gas
        # global + gas -> derive micro
        elif train is not None and gas is not None:
            micro = train // (self.world_size * gas)
            self.train_micro_batch_size_per_gpu = micro
        # only global -> gas 1, derive micro
        elif train is not None:
            self.gradient_accumulation_steps = 1
            self.train_micro_batch_size_per_gpu = train // self.world_size
        # micro (+ maybe gas) -> derive global
        elif micro is not None:
            if gas is None:
                gas = 1
                self.gradient_accumulation_steps = 1
            self.train_batch_size = micro * gas * self.world_size
        else:
            raise ConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu "
                "needs to be provided"
            )
        self._batch_assertion()

    def _do_sanity_check(self):
        if self.fp16_enabled and self.precision == c.PRECISION_FP16:
            if self.loss_scale < 0:
                raise ConfigError("loss_scale must be >= 0 (0 means dynamic)")

    # ------------------------------------------------------------------ #

    @property
    def dynamic_loss_scale(self):
        return self.loss_scale == 0

    @property
    def initial_dynamic_scale(self):
        return 2**self.initial_scale_power

    @property
    def dynamic_loss_scale_args(self):
        if not self.dynamic_loss_scale:
            return None
        return {
            "init_scale": 2**self.initial_scale_power,
            "scale_window": self.loss_scale_window,
            "delayed_shift": self.hysteresis,
            "min_scale": self.min_loss_scale,
        }

    def print(self, name="TrainingConfig"):
        logger.info("%s:", name)
        for key in sorted(self.__dict__):
            if key == "_param_dict":
                continue
            logger.info("  %s = %s", key, self.__dict__[key])


# Back-compat alias matching the reference class name
DeepSpeedConfig = TrainingConfig
