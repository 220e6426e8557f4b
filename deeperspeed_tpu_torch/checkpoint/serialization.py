"""Checkpoint serialization and directory layout.

Counterpart of deeperspeed_tpu/checkpoint/serialization.py: tag
directories, a ``latest`` pointer file, model-state and optimizer-state
files named by rank, tag-consistency validation, and the ``zero_to_fp32``
consolidation. The files are the reference's: flax msgpack, written and
read by this package's own codec (checkpoint/msgpack.py), so each package
loads the other's checkpoints.

Saves stream leaf by leaf to a temporary file, fsync it, rename it into
place and fsync the directory. Loads map the file and decode views into
the mapping, so a caller can copy each leaf where it belongs without a
second host copy of the whole tree.

Not ported: the orbax ``sharded_state`` layout (``checkpoint.sharded_io``;
ROADMAP.md queue 1, item 'Sharded checkpoints').
"""

import mmap
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..resilience.manifest import fsync_dir
from ..utils.logging import logger
from . import msgpack

LATEST_FILE = "latest"
SHARDED_STATE_DIR = "sharded_state"


def model_state_filename(mp_rank: int = 0) -> str:
    return f"mp_rank_{mp_rank:02d}_model_states.msgpack"


def optim_state_filename(dp_rank: int = 0, mp_rank: int = 0) -> str:
    return f"zero_pp_rank_{dp_rank}_mp_rank_{mp_rank:02d}_optim_states.msgpack"


def _jax_order(tree, leaf):
    """``leaf`` over a tree's leaves, with every dict's keys sorted as the
    reference's ``jax.tree.map`` orders them, so that the two packages
    write the same bytes."""
    if isinstance(tree, dict):
        return {k: _jax_order(tree[k], leaf) for k in sorted(tree)}
    if msgpack._is_namedtuple(tree):
        return type(tree)(*(_jax_order(v, leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_jax_order(v, leaf) for v in tree)
    if isinstance(tree, (str, bytes, bool, int, float, type(None))):
        return tree
    return leaf(tree)


def _host_leaf(x):
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return t.contiguous() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(x)


def _save_leaf(x):
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def to_host(tree):
    """Tensors to numpy (bf16, which numpy cannot hold here, to a CPU bf16
    tensor with the same bytes), numpy scalars to 0-d arrays; Python
    scalars, strings and None pass through; dict keys sorted, as the
    reference's ``jax.tree.map`` leaves them."""
    return _jax_order(tree, _host_leaf)


def save_tree(path: str, tree: Any):
    """Write ``tree`` as the reference's ``save_tree`` does (``to_host``,
    then flax msgpack), streamed to ``path + ".tmp"``, fsynced, then
    renamed into place. A tensor is copied to the host as it is written,
    one at a time, so a tree on the card needs no host copy of its own."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        msgpack.dump(_jax_order(tree, _save_leaf), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    if parent:
        fsync_dir(parent)


def load_tree(path: str, target: Optional[Any] = None,
              unchunk: bool = True):
    """The tree in ``path``: a state dict of numpy arrays (bf16 as CPU
    tensors) that are copy-on-write views of the mapped file, or
    ``target``'s structure around them. ``unchunk=False`` leaves arrays
    over 1 GiB in flax's chunked form (``msgpack.chunked_parts``)."""
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            raise ValueError(f"{path} is empty")
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    state = msgpack.restore(buf, unchunk=unchunk)
    if target is not None:
        return msgpack.from_state_dict(target, state)
    return state


def write_latest(save_dir: str, tag: str):
    """Atomically repoint ``latest``: the temp file is fsynced before the
    rename and the directory after it."""
    os.makedirs(save_dir, exist_ok=True)
    tmp = os.path.join(save_dir, LATEST_FILE + ".tmp")
    with open(tmp, "w") as f:
        f.write(tag)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(save_dir, LATEST_FILE))
    fsync_dir(save_dir)


def read_latest(load_dir: str) -> Optional[str]:
    p = os.path.join(load_dir, LATEST_FILE)
    if not os.path.isfile(p):
        return None
    with open(p) as f:
        return f.read().strip()


def validate_tag_across_processes(tag: str, fail_on_mismatch: bool) -> bool:
    """Cross-process checkpoint-tag consistency: every rank of the
    initialized world must save under the same tag (one process: trivially
    true). A mismatch raises when ``fail_on_mismatch``, else warns."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return True
    tags = [None] * dist.get_world_size()
    dist.all_gather_object(tags, str(tag))
    ok = all(t == str(tag) for t in tags)
    if not ok:
        if fail_on_mismatch:
            raise ValueError(f"checkpoint tag '{tag}' differs across "
                             f"processes: {tags}")
        logger.warning("checkpoint tag '%s' differs across processes: %s",
                       tag, tags)
    return ok


class CheckpointEngine:
    """File layout and IO for one checkpoint directory."""

    def __init__(self, save_dir: str, tag: str):
        self.ckpt_dir = os.path.join(save_dir, str(tag))

    def path(self, filename: str) -> str:
        return os.path.join(self.ckpt_dir, filename)

    def save(self, filename: str, tree: Any):
        save_tree(self.path(filename), tree)

    def load(self, filename: str, target: Optional[Any] = None,
             unchunk: bool = True):
        return load_tree(self.path(filename), target, unchunk)

    def exists(self, filename: str) -> bool:
        return os.path.isfile(self.path(filename))


def consolidate_fp32_state(checkpoint_dir: str) -> Dict:
    """The consolidated fp32 master weights of a checkpoint directory in
    the msgpack layout: the optimizer file's ``master``, else (fp32
    training keeps none) the model file's ``module``."""
    if os.path.isdir(os.path.join(checkpoint_dir, SHARDED_STATE_DIR)):
        raise NotImplementedError(
            f"{checkpoint_dir} holds the orbax sharded_state layout, which "
            f"the PyTorch package does not read yet (ROADMAP.md queue 1, "
            f"item 'Sharded checkpoints')")
    for fname in sorted(os.listdir(checkpoint_dir)):
        if fname.startswith("zero_pp_rank_") and fname.endswith(".msgpack"):
            optim = load_tree(os.path.join(checkpoint_dir, fname))
            if isinstance(optim, dict) and optim.get("master"):
                return optim["master"]
    for fname in sorted(os.listdir(checkpoint_dir)):
        if fname.endswith("model_states.msgpack"):
            state = load_tree(os.path.join(checkpoint_dir, fname))
            if "module" not in state:
                raise FileNotFoundError(
                    f"{fname} carries no module weights (metadata only?) in "
                    f"{checkpoint_dir}")
            logger.info("no fp32 master in %s; returning the module",
                        checkpoint_dir)
            return state["module"]
    raise FileNotFoundError(f"no checkpoint states found in {checkpoint_dir}")
