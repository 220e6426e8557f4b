"""Elasticity config keys. Counterpart of
deeperspeed_tpu/elasticity/constants.py, whole (the schema of DeepSpeed's
elasticity/constants.py)."""

ELASTICITY = "elasticity"

ENABLED = "enabled"
ENABLED_DEFAULT = False

MAX_ACCEPTABLE_BATCH_SIZE = "max_train_batch_size"
MAX_ACCEPTABLE_BATCH_SIZE_DEFAULT = 2000

MICRO_BATCHES = "micro_batch_sizes"
MICRO_BATCHES_DEFAULT = [2, 4, 6]

MIN_GPUS = "min_gpus"
MIN_GPUS_DEFAULT = 1
MAX_GPUS = "max_gpus"
MAX_GPUS_DEFAULT = 10000

MIN_TIME = "min_time"
MIN_TIME_DEFAULT = 0

IGNORE_NON_ELASTIC_BATCH_INFO = "ignore_non_elastic_batch_info"
IGNORE_NON_ELASTIC_BATCH_INFO_DEFAULT = False

CANONICAL_SHARDS = "canonical_shards"
CANONICAL_SHARDS_DEFAULT = 0

PREFER_LARGER_BATCH = "prefer_larger_batch"
PREFER_LARGER_BATCH_DEFAULT = True

VERSION = "version"
VERSION_DEFAULT = 0.1
LATEST_ELASTICITY_VERSION = 0.1
MINIMUM_DEEPSPEED_VERSION = "0.3.8"
