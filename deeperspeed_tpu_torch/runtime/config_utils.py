"""JSON config helpers: duplicate-key rejection, dict-or-path loading.

Counterpart of deeperspeed_tpu/runtime/config_utils.py. The port reads
the ``"serving"`` and ``"kernels"`` blocks of a config file through
``load_config``.
"""

import json
from typing import Any, Dict


def dict_raise_error_on_duplicate_keys(ordered_pairs):
    """Reject duplicate keys while parsing JSON."""
    d = dict(ordered_pairs)
    if len(d) != len(ordered_pairs):
        counter = {}
        for k, _ in ordered_pairs:
            counter[k] = counter.get(k, 0) + 1
        keys = [k for k, v in counter.items() if v > 1]
        raise ValueError(f"Duplicate keys in DeepSpeed config: {keys}")
    return d


def load_config(config: Any) -> Dict:
    """Accept a dict, a JSON string, or a path to a JSON file."""
    if config is None:
        return {}
    if isinstance(config, dict):
        return config
    if isinstance(config, str):
        try:
            with open(config, "r") as f:
                return json.load(f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        except FileNotFoundError:
            # maybe an inline JSON string
            stripped = config.strip()
            if stripped.startswith("{"):
                return json.loads(
                    stripped, object_pairs_hook=dict_raise_error_on_duplicate_keys
                )
            raise
    raise TypeError(f"Unsupported config type: {type(config)}")

