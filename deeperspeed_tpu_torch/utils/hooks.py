"""Layer-output capture: the fork's cooperative tap.

Counterpart of deeperspeed_tpu/utils/hooks.py. The reference framework
hangs forward hooks on modules matching a name pattern and stashes their
outputs on the host in ``engine.layer_outputs``, for logit-lens style
inspection. The models here are functions with no modules to hook, so
they call ``record_layer_output(key, value, index)`` at the points they
make observable (models/gpt.py after each decoder layer, models/bert.py
after each encoder layer and for the MLM head's dropped count). With no
collector active the tap returns its value and does nothing else. With
one active (``set_active``), it copies the value to the host, detached,
into the collector (bf16 arrives as fp32, since numpy has no bf16).
``Engine.register_forward_hook`` turns capture on (runtime/engine.py).

The active collector is process-global, as in the reference: the taps sit
deep inside model code.
"""

import re
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

_ACTIVE: Optional["LayerOutputCollector"] = None


def _to_host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(value)


class LayerOutputCollector:
    """Holds captured outputs: key -> list of host arrays (one per call,
    or one per index). ``layer_name_pattern`` additionally filters string
    keys, as the reference's regex filter over module names does."""

    def __init__(self, layers_to_hook: Union[str, List] = "all",
                 layer_name_pattern: Optional[str] = None):
        self.layers_to_hook = layers_to_hook
        self.pattern = (re.compile(layer_name_pattern, re.IGNORECASE)
                        if layer_name_pattern else None)
        self.layer_outputs: Dict[Any, list] = {}

    def wants(self, key) -> bool:
        if (self.pattern is not None and isinstance(key, str)
                and not self.pattern.search(key)):
            return False
        if self.layers_to_hook == "all":
            return True
        return key in self.layers_to_hook

    def _store(self, key, value, index=None):
        lst = self.layer_outputs.setdefault(key, [])
        if index is None:
            lst.append(_to_host(value))
            return
        i = int(index)
        while len(lst) <= i:
            lst.append(None)
        lst[i] = _to_host(value)

    def clear(self):
        self.layer_outputs = {}


def capture_active() -> bool:
    return _ACTIVE is not None


def set_active(collector: Optional[LayerOutputCollector]):
    global _ACTIVE
    _ACTIVE = collector


def record_layer_output(key, value, index=None):
    """Tap point for models. Returns ``value`` unchanged; when a collector
    that wants ``key`` is active, also stores a host copy of it, at slot
    ``index`` (a layer counter) when one is given, else appended."""
    if _ACTIVE is None or not _ACTIVE.wants(key):
        return value
    _ACTIVE._store(key, value, index)
    return value
