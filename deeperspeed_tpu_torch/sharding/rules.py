"""Placement rules: batch axes, the ZeRO axis, and ZeRO stages as specs.

Counterpart of the parts of deeperspeed_tpu/sharding/rules.py that data
parallelism and ZeRO use. A spec here is what a PartitionSpec is there,
without jax: a tuple with one entry per tensor dim, ``None`` or the mesh
axis that dim is sharded over. :func:`zero_tree_specs` turns a params
tree into :class:`ShardSpec` leaves: the one dim a leaf is sharded along
(or None) and the axis, whose process group ``mesh.group((axis,))``
gives. The engine keeps each rank's shard as a contiguous copy.

Tensor and sequence parallelism (the ``heads``/``mlp``/``seq`` rules of
the reference's table) are not ported; a mesh carries them only at
extent 1.
"""

import dataclasses
from typing import Any, Optional, Sequence, Tuple

from .mesh import DATA_AXIS, DP_AXIS, FSDP_AXIS

__all__ = [
    "ShardSpec", "batch_axes", "zero_axis", "data_parallel_size",
    "zero_size", "batch_index", "place_batch", "choose_shard_dim",
    "add_zero_axis", "zero_tree_specs",
]

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How one leaf lies over the ZeRO axis: sharded along ``dim`` over
    ``axis`` (``size`` ranks), or replicated (``dim`` None)."""
    dim: Optional[int]
    axis: Optional[str]
    size: int

    @property
    def sharded(self) -> bool:
        return self.dim is not None


# ---------------------------------------------------------------------- #
# per-mesh axis resolvers
# ---------------------------------------------------------------------- #


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes the batch dimension shards over (the gradient reduction runs
    over these): ``(dp, fsdp)`` on a canonical mesh, ``(data,)`` on a
    legacy one."""
    if mesh is None:
        return ()
    if DP_AXIS in mesh.shape or FSDP_AXIS in mesh.shape:
        return tuple(a for a in (DP_AXIS, FSDP_AXIS) if a in mesh.shape)
    return (DATA_AXIS,) if DATA_AXIS in mesh.shape else ()


def zero_axis(mesh) -> Optional[str]:
    """The axis ZeRO shards the optimizer state over: ``fsdp`` on a
    canonical mesh (dp replicates), ``data`` on a legacy one."""
    if mesh is None:
        return None
    if FSDP_AXIS in mesh.shape:
        return FSDP_AXIS
    if DP_AXIS in mesh.shape:
        return None
    return DATA_AXIS if DATA_AXIS in mesh.shape else None


def _size(mesh, axis: Optional[str]) -> int:
    return (int(mesh.shape[axis]) if mesh is not None and axis is not None
            and axis in mesh.shape else 1)


def data_parallel_size(mesh) -> int:
    """Product of the batch-axis extents (what the batch triple and the
    gradient mean divide by)."""
    n = 1
    for a in batch_axes(mesh):
        n *= _size(mesh, a)
    return n


def zero_size(mesh) -> int:
    return _size(mesh, zero_axis(mesh))


def batch_index(mesh) -> int:
    """This rank's position along the batch axes: which block of rows of
    the global batch it takes."""
    return mesh.axis_index(batch_axes(mesh)) if mesh is not None else 0


# ---------------------------------------------------------------------- #
# batch placement
# ---------------------------------------------------------------------- #


def place_batch(mesh, batch):
    """This rank's rows of a global batch: the leading dim split into
    ``data_parallel_size`` contiguous blocks, block ``batch_index`` kept
    (the reference's ``place_batch`` shards the leading dim over the batch
    axes the same way). Works on nested dicts, tuples and lists of arrays
    or tensors; 0-d leaves are kept whole."""
    n = data_parallel_size(mesh)
    i = batch_index(mesh)

    def leaf(x):
        if n == 1 or getattr(x, "ndim", 0) == 0:
            return x
        rows = x.shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{n} data-parallel ranks")
        m = rows // n
        return x[i * m:(i + 1) * m]

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v) for v in t)
        return leaf(t)

    return walk(batch)


# ---------------------------------------------------------------------- #
# ZeRO stages as zero-axis specs
# ---------------------------------------------------------------------- #


def choose_shard_dim(shape, spec: Sequence, size: int) -> Optional[int]:
    """Pick the dim to shard over the zero axis: the largest dim
    divisible by ``size`` and not already sharded by another axis."""
    best = None
    best_size = 0
    for i, d in enumerate(shape):
        taken = i < len(spec) and spec[i] is not None
        if taken:
            continue
        if d % size == 0 and d >= size and d > best_size:
            best, best_size = i, d
    return best


def add_zero_axis(spec: Optional[Sequence], shape, axis: Optional[str],
                  size: int) -> Spec:
    """Extend a (possibly empty) spec with zero-axis sharding on one dim.
    Leaves with no divisible free dim stay replicated (biases and norms:
    a negligible fraction)."""
    spec = tuple(spec) if spec is not None else ()
    if size <= 1 or axis is None:
        return spec
    idx = choose_shard_dim(shape, spec, size)
    if idx is None:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    parts[idx] = axis
    return tuple(parts)


_THRESHOLD = {"param": 3, "grad": 2, "master": 1}


def _zero_leaf_spec(shape, stage: int, kind: str, axis: Optional[str],
                    size: int) -> ShardSpec:
    if stage >= _THRESHOLD[kind]:
        entries = add_zero_axis((), shape, axis, size)
        if axis is not None and axis in entries:
            return ShardSpec(entries.index(axis), axis, size)
    return ShardSpec(None, None, 1)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def zero_tree_specs(params: Any, tp_specs, stage: int, mesh, kind: str):
    """Map a params tree to :class:`ShardSpec` leaves over the mesh's zero
    axis. kind: ``'param'`` (sharded from stage 3), ``'grad'`` (stage 2),
    ``'master'`` (stage 1: the fp32 master and the optimizer moments).
    ``tp_specs`` (the tensor-parallel specs of the reference's signature)
    must be None: tensor parallelism is not ported."""
    if tp_specs is not None:
        raise NotImplementedError(
            "tensor-parallel specs are not ported to the PyTorch package yet "
            "(ROADMAP.md queue 1, item 'MoE, TP and pipeline')")
    if kind not in _THRESHOLD:
        raise ValueError(f"kind must be one of {sorted(_THRESHOLD)}, got "
                         f"{kind!r}")
    axis = zero_axis(mesh)
    size = zero_size(mesh)
    return _tree_map(
        lambda p: _zero_leaf_spec(tuple(p.shape), stage, kind, axis, size),
        params)
