"""ZeRO configuration block.

Counterpart of deeperspeed_tpu/runtime/zero/config.py (``ZeroConfig``,
``OffloadConfig``): the same keys, defaults, legacy forms and errors. What
each stage means in the port (runtime/zero/partition.py):

  stage 0 -- params, grads and optimizer state replicated on every rank
  stage 1 -- the fp32 master and the optimizer moments sharded over the
             ZeRO axis: each rank updates its shard, then the updated
             compute params are all-gathered
  stage 2 -- stage 1, and the reduced gradients cut to the same shards
  stage 3 -- with offload_param on cpu or nvme, the streamed offload
             engine (runtime/offload/streaming.py), which initialize builds
             for a model config; Engine refuses stage 3 and the offload
             devices (ROADMAP.md queue 1, item 10)
"""

from . import constants as zc


def get_scalar_param(d, key, default):
    return d.get(key, default)


class ConfigObject:
    def __repr__(self):
        return f"{type(self).__name__}({vars(self)})"



class OffloadConfig(ConfigObject):
    """offload_param / offload_optimizer sub-block (ZeRO-3 / Infinity)."""

    def __init__(self, d, is_optimizer=False):
        d = d or {}
        self.device = get_scalar_param(d, zc.OFFLOAD_DEVICE, zc.OFFLOAD_DEVICE_NONE)
        if self.device not in zc.VALID_OFFLOAD_DEVICES:
            raise ValueError(
                f"offload device must be one of {zc.VALID_OFFLOAD_DEVICES}, got {self.device}"
            )
        self.nvme_path = get_scalar_param(d, zc.OFFLOAD_NVME_PATH, None)
        self.buffer_count = get_scalar_param(d, zc.OFFLOAD_BUFFER_COUNT, 5 if not is_optimizer else 4)
        self.buffer_size = get_scalar_param(d, zc.OFFLOAD_BUFFER_SIZE, 100000000)
        self.max_in_cpu = get_scalar_param(d, zc.OFFLOAD_MAX_IN_CPU, 1000000000)
        self.pin_memory = get_scalar_param(d, zc.OFFLOAD_PIN_MEMORY, False)
        self.pipeline_read = get_scalar_param(d, zc.OFFLOAD_PIPELINE_READ, False)
        self.pipeline_write = get_scalar_param(d, zc.OFFLOAD_PIPELINE_WRITE, False)
        self.fast_init = get_scalar_param(d, zc.OFFLOAD_FAST_INIT, False)

    @property
    def enabled(self):
        return self.device != zc.OFFLOAD_DEVICE_NONE


class ZeroConfig(ConfigObject):
    def __init__(self, param_dict=None):
        zero_dict = (param_dict or {}).get(zc.ZERO_OPTIMIZATION, {})
        if isinstance(zero_dict, bool):
            # legacy: "zero_optimization": true  => stage 1
            zero_dict = {zc.ZERO_OPTIMIZATION_STAGE: 1 if zero_dict else 0}

        self.stage = get_scalar_param(
            zero_dict, zc.ZERO_OPTIMIZATION_STAGE, zc.ZERO_OPTIMIZATION_STAGE_DEFAULT
        )
        if not (0 <= self.stage <= zc.MAX_STAGE_ZERO_OPTIMIZATION):
            raise ValueError(f"ZeRO stage must be in [0, 3], got {self.stage}")

        self.allgather_partitions = get_scalar_param(
            zero_dict,
            zc.ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS,
            zc.ZERO_OPTIMIZATION_ALLGATHER_PARTITIONS_DEFAULT,
        )
        self.reduce_scatter = get_scalar_param(
            zero_dict,
            zc.ZERO_OPTIMIZATION_REDUCE_SCATTER,
            zc.ZERO_OPTIMIZATION_REDUCE_SCATTER_DEFAULT,
        )
        self.overlap_comm = get_scalar_param(
            zero_dict,
            zc.ZERO_OPTIMIZATION_OVERLAP_COMM,
            zc.ZERO_OPTIMIZATION_OVERLAP_COMM_DEFAULT,
        )
        self.contiguous_gradients = get_scalar_param(
            zero_dict,
            zc.ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS,
            zc.ZERO_OPTIMIZATION_CONTIGUOUS_GRADIENTS_DEFAULT,
        )
        self.reduce_bucket_size = get_scalar_param(
            zero_dict,
            zc.ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE,
            zc.ZERO_OPTIMIZATION_REDUCE_BUCKET_SIZE_DEFAULT,
        )
        self.allgather_bucket_size = get_scalar_param(
            zero_dict,
            zc.ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE,
            zc.ZERO_OPTIMIZATION_ALLGATHER_BUCKET_SIZE_DEFAULT,
        )
        self.cpu_offload = get_scalar_param(
            zero_dict,
            zc.ZERO_OPTIMIZATION_CPU_OFFLOAD,
            zc.ZERO_OPTIMIZATION_CPU_OFFLOAD_DEFAULT,
        )
        self.cpu_offload_params = get_scalar_param(
            zero_dict,
            zc.ZERO_OPTIMIZATION_CPU_OFFLOAD_PARAMS,
            zc.ZERO_OPTIMIZATION_CPU_OFFLOAD_PARAMS_DEFAULT,
        )
        self.cpu_offload_use_pin_memory = get_scalar_param(
            zero_dict,
            zc.ZERO_OPTIMIZATION_CPU_OFFLOAD_USE_PIN_MEMORY,
            zc.ZERO_OPTIMIZATION_CPU_OFFLOAD_USE_PIN_MEMORY_DEFAULT,
        )

        self.offload_param = OffloadConfig(zero_dict.get(zc.OFFLOAD_PARAM))
        self.offload_optimizer = OffloadConfig(
            zero_dict.get(zc.OFFLOAD_OPTIMIZER), is_optimizer=True
        )
        # legacy cpu_offload flag implies optimizer offload to cpu
        if self.cpu_offload and not self.offload_optimizer.enabled:
            self.offload_optimizer.device = zc.OFFLOAD_DEVICE_CPU

        self.sub_group_size = get_scalar_param(
            zero_dict,
            zc.ZERO_OPTIMIZATION_SUB_GROUP_SIZE,
            zc.ZERO_OPTIMIZATION_SUB_GROUP_SIZE_DEFAULT,
        )
        self.max_live_parameters = get_scalar_param(
            zero_dict,
            zc.ZERO_OPTIMIZATION_MAX_LIVE_PARAMETERS,
            zc.ZERO_OPTIMIZATION_MAX_LIVE_PARAMETERS_DEFAULT,
        )
        self.max_reuse_distance = get_scalar_param(
            zero_dict,
            zc.ZERO_OPTIMIZATION_MAX_REUSE_DISTANCE,
            zc.ZERO_OPTIMIZATION_MAX_REUSE_DISTANCE_DEFAULT,
        )
        self.prefetch_bucket_size = get_scalar_param(
            zero_dict,
            zc.ZERO_OPTIMIZATION_PREFETCH_BUCKET_SIZE,
            zc.ZERO_OPTIMIZATION_PREFETCH_BUCKET_SIZE_DEFAULT,
        )
        self.param_persistence_threshold = get_scalar_param(
            zero_dict,
            zc.ZERO_OPTIMIZATION_PARAM_PERSISTENCE_THRESHOLD,
            zc.ZERO_OPTIMIZATION_PARAM_PERSISTENCE_THRESHOLD_DEFAULT,
        )
        self.gather_fp16_weights_on_model_save = get_scalar_param(
            zero_dict,
            zc.ZERO_OPTIMIZATION_GATHER_FP16_WEIGHTS_ON_MODEL_SAVE,
            zc.ZERO_OPTIMIZATION_GATHER_FP16_WEIGHTS_ON_MODEL_SAVE_DEFAULT,
        )
        self.elastic_checkpoint = get_scalar_param(
            zero_dict,
            zc.ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT,
            zc.ZERO_OPTIMIZATION_ELASTIC_CHECKPOINT_DEFAULT,
        )

    @property
    def enabled(self):
        return self.stage > 0
