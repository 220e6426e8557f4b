"""Elastic batch-size / world-size co-design.

Counterpart of deeperspeed_tpu/elasticity/elasticity.py, whole (DeepSpeed's
``compute_elastic_config`` and ``_get_compatible_gpus_v01``): statically
choose a final train batch size whose set of compatible accelerator counts
is maximal, so a scheduler can restart the job at a different device
count without changing convergence behavior. A "gpu" here is one
data-parallel rank.
"""

from ..utils.logging import logger
from . import constants as ec


class ElasticityError(Exception):
    pass


class ElasticityConfigError(ElasticityError):
    pass


class ElasticityIncompatibleWorldSize(ElasticityError):
    pass


class ElasticityConfig:
    def __init__(self, param_dict):
        self.enabled = param_dict.get(ec.ENABLED, ec.ENABLED_DEFAULT)
        if self.enabled:
            if ec.MAX_ACCEPTABLE_BATCH_SIZE not in param_dict:
                raise ElasticityConfigError(
                    f"Elasticity config missing {ec.MAX_ACCEPTABLE_BATCH_SIZE}"
                )
            if ec.MICRO_BATCHES not in param_dict:
                raise ElasticityConfigError(f"Elasticity config missing {ec.MICRO_BATCHES}")
        self.max_acceptable_batch_size = param_dict.get(
            ec.MAX_ACCEPTABLE_BATCH_SIZE, ec.MAX_ACCEPTABLE_BATCH_SIZE_DEFAULT
        )
        self.micro_batches = param_dict.get(ec.MICRO_BATCHES, ec.MICRO_BATCHES_DEFAULT)
        if not isinstance(self.micro_batches, list) or not self.micro_batches:
            raise ElasticityConfigError(
                f"{ec.MICRO_BATCHES} must be a non-empty list, got {self.micro_batches}"
            )
        if any((not isinstance(m, int)) or m <= 0 for m in self.micro_batches):
            raise ElasticityConfigError(
                f"{ec.MICRO_BATCHES} values must be positive ints, got {self.micro_batches}"
            )
        self.min_gpus = param_dict.get(ec.MIN_GPUS, ec.MIN_GPUS_DEFAULT)
        self.max_gpus = param_dict.get(ec.MAX_GPUS, ec.MAX_GPUS_DEFAULT)
        if self.min_gpus < 1 or self.max_gpus < self.min_gpus:
            raise ElasticityConfigError(
                f"invalid gpu range [{self.min_gpus}, {self.max_gpus}]"
            )
        self.min_time = param_dict.get(ec.MIN_TIME, ec.MIN_TIME_DEFAULT)
        self.version = param_dict.get(ec.VERSION, ec.VERSION_DEFAULT)
        self.prefer_larger_batch_size = param_dict.get(
            ec.PREFER_LARGER_BATCH, ec.PREFER_LARGER_BATCH_DEFAULT
        )
        self.ignore_non_elastic_batch_info = param_dict.get(
            ec.IGNORE_NON_ELASTIC_BATCH_INFO, ec.IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT
        )

    def repr(self):
        return self.__dict__


def _get_candidate_batch_sizes(base_list, max_acceptable_batch_size):
    candidates = set()
    for base in base_list:
        batch = base
        while batch <= max_acceptable_batch_size:
            candidates.add(batch)
            batch += base
    return sorted(candidates)


def _get_compatible_gpus_v01(micro_batches, final_batch_size, min_gpus, max_gpus):
    """All accelerator counts g in [min, max] such that some micro batch m
    satisfies final_batch_size % (m * g) == 0 (i.e. grad-accum steps integral)."""
    valid = set()
    for m in micro_batches:
        if final_batch_size % m != 0:
            continue
        max_slots = final_batch_size // m
        for g in range(min_gpus, min(max_gpus, max_slots) + 1):
            if max_slots % g == 0:
                valid.add(g)
    return sorted(valid)


def get_best_candidate_batch_size(
    micro_batches, max_acceptable_batch_size, min_gpus, max_gpus, prefer_larger=True
):
    candidates = _get_candidate_batch_sizes(micro_batches, max_acceptable_batch_size)
    best = None
    best_gpus = []
    for batch in candidates:
        valid = _get_compatible_gpus_v01(micro_batches, batch, min_gpus, max_gpus)
        better = len(valid) > len(best_gpus) or (
            len(valid) == len(best_gpus)
            and best is not None
            and (batch > best if prefer_larger else batch < best)
        )
        if best is None or better:
            best, best_gpus = batch, valid
    if best is None or not best_gpus:
        raise ElasticityError(
            "no valid batch size found for "
            f"micro_batches={micro_batches}, max={max_acceptable_batch_size}"
        )
    return best, best_gpus


def compute_elastic_config(ds_config, target_deepspeed_version=None, world_size=0):
    """Returns (final_batch_size, valid_gpus[, micro_batch]) — with world_size>0
    also resolves the per-chip micro batch size for that world size."""
    if isinstance(ds_config, dict):
        elastic_dict = ds_config.get(ec.ELASTICITY, {})
    else:
        elastic_dict = ds_config
    cfg = ElasticityConfig(elastic_dict)
    if cfg.version > ec.LATEST_ELASTICITY_VERSION:
        raise ElasticityConfigError(
            f"Unsupported elasticity version {cfg.version}; latest is "
            f"{ec.LATEST_ELASTICITY_VERSION}"
        )

    final_batch_size, valid_gpus = get_best_candidate_batch_size(
        cfg.micro_batches,
        cfg.max_acceptable_batch_size,
        cfg.min_gpus,
        cfg.max_gpus,
        prefer_larger=cfg.prefer_larger_batch_size,
    )
    logger.info(
        "elasticity: final_batch_size=%d valid world sizes=%s", final_batch_size, valid_gpus
    )
    if world_size > 0:
        if world_size not in valid_gpus:
            raise ElasticityIncompatibleWorldSize(
                f"world size {world_size} not in valid set {valid_gpus} for "
                f"batch size {final_batch_size}"
            )
        # pick the largest compatible micro batch for throughput
        micro = None
        for m in sorted(cfg.micro_batches, reverse=cfg.prefer_larger_batch_size):
            if final_batch_size % (m * world_size) == 0:
                micro = m
                break
        assert micro is not None
        return final_batch_size, valid_gpus, micro
    return final_batch_size, valid_gpus


def elastic_world_sizes(ds_config):
    """Valid world sizes for a config with an elasticity block, [] when
    the block is absent/disabled or unsatisfiable. The resilience
    supervisor exports these to restarted children so a resume on a
    shrunken pool can pick a compatible chip count without
    re-deriving the elastic schedule."""
    if not isinstance(ds_config, dict):
        return []
    elastic_dict = ds_config.get(ec.ELASTICITY, {})
    if not elastic_dict.get(ec.ENABLED, ec.ENABLED_DEFAULT):
        return []
    try:
        _batch, valid_gpus = compute_elastic_config(ds_config)
    except ElasticityError:
        return []
    return sorted(valid_gpus)


def ensure_immutable_elastic_config(runtime_elastic_config_dict):
    """Guard that scheduler-time and runtime elastic configs agree
    (parity with elasticity/elasticity.py:207)."""
    import json
    import os

    env_key = "DEEPSPEED_ELASTICITY_CONFIG"
    if env_key in os.environ:
        scheduler_config = json.loads(os.environ[env_key])
        scheduler = ElasticityConfig(scheduler_config)
        runtime = ElasticityConfig(runtime_elastic_config_dict)
        err = (
            "Elastic config '{}' seen by scheduler ({}) != runtime ({}); "
            "elastic config cannot change after scheduling"
        )
        for field in ("max_acceptable_batch_size", "micro_batches", "version"):
            if getattr(scheduler, field) != getattr(runtime, field):
                raise ElasticityConfigError(
                    err.format(field, getattr(scheduler, field), getattr(runtime, field))
                )
