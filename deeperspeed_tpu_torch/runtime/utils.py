"""Runtime utilities.

Counterpart of deeperspeed_tpu/runtime/utils.py: ``call_to_str``,
``partition_uniform`` / ``partition_balanced`` (pipeline layer
balancing), the global-norm helpers over params trees
(``global_sqnorm``, ``global_norm``, ``clip_by_global_norm``) and
torch's ``clip_grad_norm_`` over a list of tensors, ``CheckOverflow``,
and the memory readers ``memory_status``, ``see_memory_usage`` and
``mem_status`` on the CUDA caching allocator's statistics.

Not ported yet (ROADMAP.md queue 1, item 'Training follow-ups'):
``GradientNoiseScale``; ``PartitionedTensor``, which nothing calls yet
(the pipeline engine included).
"""

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..ops.adam import tree_leaves, tree_map
from ..utils.logging import logger


def call_to_str(base, *args, **kwargs) -> str:
    """Render a function-call-like string, e.g. ``ForwardPass(buffer_id=0)``."""
    name = f"{base}("
    if args:
        name += ", ".join(repr(arg) for arg in args)
        if kwargs:
            name += ", "
    if kwargs:
        name += ", ".join(f"{key}={repr(arg)}" for key, arg in kwargs.items())
    name += ")"
    return name


# ------------------------------------------------------------------ #
# partitioning (pipeline layer balancing)
# ------------------------------------------------------------------ #


def partition_uniform(num_items: int, num_parts: int) -> List[int]:
    """Evenly split ``num_items`` into ``num_parts`` contiguous ranges:
    ``num_parts + 1`` boundaries, the remainder on the leading parts."""
    base = num_items // num_parts
    extra = num_items % num_parts
    parts = [0]
    for p in range(num_parts):
        parts.append(parts[-1] + base + (1 if p < extra else 0))
    return parts


def _feasible(weights: Sequence[int], num_parts: int,
              cap: int) -> Optional[List[int]]:
    """Can ``weights`` split into at most ``num_parts`` contiguous chunks
    each summing to at most ``cap``? The boundaries if so."""
    bounds = [0]
    running = 0
    for i, w in enumerate(weights):
        if w > cap:
            return None
        if running + w > cap:
            bounds.append(i)
            running = 0
            if len(bounds) > num_parts:
                return None
        running += w
    bounds.append(len(weights))
    return bounds


def partition_balanced(weights: Sequence[int], num_parts: int) -> List[int]:
    """Contiguous partition of ``weights`` into ``num_parts`` ranges that
    minimises the heaviest range (binary search over the bottleneck).
    Returns ``num_parts + 1`` boundaries."""
    n = len(weights)
    if n == 0:
        return [0] * (num_parts + 1)
    if num_parts >= n:
        # one item per part, trailing parts empty
        parts = list(range(n + 1))
        parts += [n] * (num_parts - n)
        return parts
    lo = max(weights)
    hi = sum(weights)
    best = None
    while lo <= hi:
        mid = (lo + hi) // 2
        bounds = _feasible(weights, num_parts, mid)
        if bounds is not None:
            best = bounds
            hi = mid - 1
        else:
            lo = mid + 1
    assert best is not None
    # pad to exactly num_parts ranges (the greedy split may use fewer)
    while len(best) < num_parts + 1:
        best.append(n)
    return best


# ------------------------------------------------------------------ #
# norms and clipping
# ------------------------------------------------------------------ #


def global_sqnorm(tree) -> torch.Tensor:
    """Sum of squares over every leaf of a tree, fp32 0-d tensor."""
    leaves = [x.float().square().sum() for x in tree_leaves(tree)
              if isinstance(x, torch.Tensor)]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack(leaves).sum()


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every leaf of a tree."""
    return torch.sqrt(global_sqnorm(tree))


def clip_by_global_norm(tree, max_norm: float, norm=None):
    """A copy of ``tree`` scaled so its global norm is at most
    ``max_norm`` (each leaf in its own dtype), and the norm before:
    coef = min(1, max_norm / (norm + 1e-6))."""
    if norm is None:
        norm = global_norm(tree)
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda x: (x * coef).to(x.dtype), tree), norm


@torch.no_grad()
def clip_grad_norm_(tensors, max_norm: float, norm_type: float = 2.0):
    """torch's ``clip_grad_norm_`` over a list of tensors (gradients): the
    total ``norm_type`` norm of all of them, taken before clipping, and
    every tensor scaled in place by min(1, max_norm / (norm + 1e-6))."""
    if isinstance(tensors, torch.Tensor):
        tensors = [tensors]
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    norm_type = float(norm_type)
    if norm_type == float("inf"):
        total = torch.stack([t.detach().abs().max().float()
                             for t in tensors]).max()
    else:
        total = torch.linalg.vector_norm(torch.stack([
            torch.linalg.vector_norm(t.detach().float(), norm_type)
            for t in tensors]), norm_type)
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for t in tensors:
        t.mul_(coef.to(t.device, t.dtype))
    return total


# ------------------------------------------------------------------ #
# memory introspection
# ------------------------------------------------------------------ #


def memory_status() -> Dict[str, int]:
    """Bytes in use and the peak on the current CUDA device (the caching
    allocator's counters); zeros without a CUDA device."""
    if not torch.cuda.is_available():
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0}
    return {"bytes_in_use": int(torch.cuda.memory_allocated()),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated())}


def see_memory_usage(message: str, force: bool = False):
    """Log the current device memory use (only with ``force``)."""
    if not force:
        return
    s = memory_status()
    logger.info(
        "%s | in_use: %.2f GB | peak: %.2f GB",
        message,
        s["bytes_in_use"] / 2**30,
        s["peak_bytes_in_use"] / 2**30,
    )


def mem_status(msg: str, print_rank: int = -1, reset_max: bool = False):
    """Log memory through ``see_memory_usage`` on rank ``print_rank`` (-1:
    every process) and return ``memory_status()``. ``reset_max`` resets
    the allocator's peak counter after logging."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    if print_rank >= 0 and rank != print_rank:
        return memory_status()
    see_memory_usage(f"MEM {msg}", force=True)
    status = memory_status()
    if reset_max and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    return status


class CheckOverflow:
    """Overflow detector over gradient trees: one finiteness reduction,
    combined over a ``torch.distributed`` group when one is given (the
    reference combines it over mesh axes), so every rank agrees."""

    def __init__(self, param_groups=None, mpu=None):
        self.mpu = mpu
        self.params = param_groups

    @staticmethod
    def has_overflow_serial(grads) -> torch.Tensor:
        """bool 0-d tensor: any leaf holds an inf or a nan."""
        flags = [~torch.isfinite(g.float()).all()
                 for g in tree_leaves(grads) if isinstance(g, torch.Tensor)]
        if not flags:
            return torch.zeros((), dtype=torch.bool)
        return torch.stack(flags).any()

    def check(self, grads, group=None) -> torch.Tensor:
        """bool 0-d tensor, the same on every rank of ``group``."""
        flag = self.has_overflow_serial(grads)
        if group is not None and dist.is_initialized():
            f = flag.to(torch.int32).reshape(1)
            dist.all_reduce(f, op=dist.ReduceOp.MAX, group=group)
            flag = f[0] > 0
        return flag

    def has_overflow(self, grads) -> bool:
        return bool(self.has_overflow_serial(grads))
