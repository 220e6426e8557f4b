"""Placement rules: the logical-axis table, spec translation, batch
axes, the ZeRO axis, and ZeRO stages as specs.

Counterpart of deeperspeed_tpu/sharding/rules.py. A spec here is what a
PartitionSpec is there, without jax: a tuple with one entry per tensor
dim, ``None``, a mesh axis or a tuple of axes that dim is sharded over.

* :data:`DEFAULT_RULES` maps logical dims (``batch``, ``seq``, ``heads``,
  ``mlp``, ``vocab``, ...) to the canonical axes; :func:`logical_spec`
  reads it.
* :func:`translate_spec` maps a spec named in either generation
  (``data``/``model``/``seq`` or ``dp``/``fsdp``/``tp``/``sp``) onto the
  axes a mesh carries, dropping the ones it lacks or holds at extent 1.
* :func:`tp_axis`/:func:`sp_axis` (and their sizes) name the mesh's
  tensor- and sequence-parallel axes: ``model``/``seq`` on a legacy mesh,
  ``tp``/``sp`` on a canonical one.
* :class:`ModelCut` (from :func:`model_cut`) is how one leaf lies over a
  model axis (``model``/``tp`` or ``expert``): the dim, the axis and the
  sections of that dim cut one by one (:class:`SectionSpec`: the fused
  qkv projection, whose q, k and v blocks each split by heads). The
  engine, the model converter and serving cut whole leaves and gather
  them whole with it, one rule for every model-sharded leaf.
* :func:`zero_tree_specs` turns a params tree into :class:`ShardSpec`
  leaves: the one dim a leaf is sharded along over the zero axis (or
  None), skipping the dim tensor parallelism took, and the axis, whose
  process group ``mesh.group((axis,))`` gives. The engine keeps each
  rank's shard of its own (tensor-parallel) chunk as a contiguous copy.
"""

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from .mesh import (DATA_AXIS, DP_AXIS, FSDP_AXIS, MODEL_AXIS, SEQ_AXIS,
                   SP_AXIS, TP_AXIS)

__all__ = [
    "DEFAULT_RULES", "resolve_rules", "logical_spec", "translate_spec",
    "ShardSpec", "batch_axes", "zero_axis", "tp_axis", "sp_axis",
    "data_parallel_size", "zero_size", "tp_size", "sp_size",
    "batch_index", "place_batch", "choose_shard_dim", "add_zero_axis",
    "zero_tree_specs", "SectionSpec", "ModelCut", "model_axes",
    "model_cut",
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
# the logical-axis rule table
# ---------------------------------------------------------------------- #

# logical dim -> canonical mesh axis (None = replicated). The batch dim
# spans both data-parallel axes: dp replicates params, fsdp additionally
# shards them (ZeRO), but each contributes a factor of batch parallelism.
DEFAULT_RULES: Dict[str, Union[None, str, Tuple[str, ...]]] = {
    "batch": (DP_AXIS, FSDP_AXIS),
    "seq": SP_AXIS,        # sequence parallel: ring / Ulysses attention
    "embed": None,         # the residual stream stays replicated
    "heads": TP_AXIS,
    "kv": None,
    "joined_kv": TP_AXIS,
    "mlp": TP_AXIS,
    "vocab": TP_AXIS,      # the embedding DIM split (see
                           # parallel/tp.vocab_parallel_spec)
    "layers": None,        # the stacked layer axis
    "expert": "expert",
}

# legacy mesh axis name -> canonical candidates (and the reverse); used by
# translate_spec so one spec tree works on both naming generations
_LEGACY_TO_CANONICAL: Dict[str, Tuple[str, ...]] = {
    DATA_AXIS: (DP_AXIS, FSDP_AXIS),
    MODEL_AXIS: (TP_AXIS,),
    SEQ_AXIS: (SP_AXIS,),
}
_CANONICAL_TO_LEGACY: Dict[str, Tuple[str, ...]] = {
    DP_AXIS: (DATA_AXIS,),
    FSDP_AXIS: (DATA_AXIS,),
    TP_AXIS: (MODEL_AXIS,),
    SP_AXIS: (SEQ_AXIS,),
}


def resolve_rules(overrides: Optional[Dict] = None) -> Dict:
    """The rule table with per-run overrides (the mesh block's ``rules``
    sub-dict) applied."""
    out = dict(DEFAULT_RULES)
    if overrides:
        out.update(overrides)
    return out


def _expand_name(name: str, mesh) -> Tuple[str, ...]:
    """One spec axis name -> the axes this mesh carries for it."""
    if name in mesh.shape:
        return (name,)
    for table in (_LEGACY_TO_CANONICAL, _CANONICAL_TO_LEGACY):
        if name in table:
            return tuple(a for a in table[name] if a in mesh.shape)
    return ()


def translate_spec(spec: Optional[Sequence], mesh):
    """Map a spec onto whatever axes ``mesh`` carries: entries are first
    translated across naming generations (``data`` <-> dp/fsdp,
    ``model`` <-> tp, ``seq`` <-> sp), then axes the mesh lacks, or holds
    at extent 1, are dropped; a mesh axis lands on at most one dim (the
    first). ``None`` passes through."""
    if spec is None or mesh is None:
        return None if spec is None else tuple(spec)

    def keep(a):
        return mesh.shape.get(a, 0) > 1

    parts = []
    used = set()
    for entry in tuple(spec):
        if entry is None:
            parts.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        kept = []
        for n in names:
            for a in _expand_name(n, mesh):
                if keep(a) and a not in used:
                    kept.append(a)
                    used.add(a)
        parts.append(tuple(kept) if len(kept) > 1
                     else (kept[0] if kept else None))
    return tuple(parts)


def logical_spec(logical_dims: Sequence[Optional[str]], mesh=None,
                 rules: Optional[Dict] = None) -> Spec:
    """``("batch", "seq", "embed")`` -> a spec: canonical axes without a
    mesh, translated onto the mesh's axes with one. Unknown logical names
    raise."""
    table = resolve_rules(rules)
    parts = []
    for name in logical_dims:
        if name is None:
            parts.append(None)
            continue
        if name not in table:
            raise ValueError(
                f"unknown logical axis {name!r}; known: {sorted(table)}")
        parts.append(table[name])
    spec = tuple(parts)
    return translate_spec(spec, mesh) if mesh is not None else spec


# ---------------------------------------------------------------------- #
# model-sharded leaves: the cut over a model axis
# ---------------------------------------------------------------------- #


class SectionSpec(tuple):
    """A spec whose sharded dim is made of ``sections`` (lengths along
    that dim), each split evenly over the axis, a rank's part being its
    piece of every section in order. The reference's GSPMD reshards the
    fused ``[q | k | v]`` projection globally; a rank of the port needs
    its heads of q, of k and of v."""

    def __new__(cls, entries, sections):
        obj = super().__new__(cls, tuple(entries))
        obj.sections = tuple(int(n) for n in sections)
        return obj

    def __reduce__(self):
        return (SectionSpec, (tuple(self), self.sections))


def model_axes(mesh) -> Tuple[str, ...]:
    """The axes that cut leaves on ``mesh`` (live ones only): the
    tensor-parallel axis and the expert axis."""
    out = []
    for a in (tp_axis(mesh), "expert"):
        if a is not None and mesh.shape.get(a, 1) > 1 and a not in out:
            out.append(a)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ModelCut:
    """How one leaf lies over a model axis: dim ``dim`` cut over ``axis``
    (``size`` ranks), section by section (``sections``, lengths along
    the dim of the WHOLE leaf; one section is a plain even split)."""
    axis: str
    dim: int
    size: int
    sections: Tuple[int, ...]

    def part(self, whole, index: int):
        """Rank ``index``'s part of a whole leaf (a view where it can
        be)."""
        if len(self.sections) == 1:
            m = whole.shape[self.dim] // self.size
            return whole.narrow(self.dim, index * m, m)
        import torch

        out, start = [], 0
        for n in self.sections:
            m = n // self.size
            out.append(whole.narrow(self.dim, start + index * m, m))
            start += n
        return torch.cat(out, dim=self.dim)

    def join(self, parts):
        """The whole leaf from every rank's part (a sequence, rank
        order)."""
        import torch

        if len(self.sections) == 1:
            return torch.cat(list(parts), dim=self.dim)
        out, start = [], 0
        for n in self.sections:
            m = n // self.size
            out.extend(p.narrow(self.dim, start, m) for p in parts)
            start += m
        return torch.cat(out, dim=self.dim)


def model_cut(spec: Optional[Sequence], shape, mesh) -> Optional[ModelCut]:
    """The :class:`ModelCut` of a leaf of ``shape`` whose spec is ``spec``
    on ``mesh``, or None when no live model axis cuts it. A dim a model
    axis does not divide raises, naming the leaf's shape."""
    if spec is None or mesh is None:
        return None
    live = model_axes(mesh)
    if not live:
        return None
    t = translate_spec(spec, mesh)
    found = [(d, e) for d, e in enumerate(t) if e in live]
    if not found:
        return None
    if len(found) > 1:
        raise ValueError(f"spec {tuple(spec)} cuts a leaf over two model "
                         f"axes; the port cuts a leaf over one")
    dim, axis = found[0]
    size = int(mesh.shape[axis])
    sections = tuple(getattr(spec, "sections", None) or (shape[dim],))
    if sum(sections) != shape[dim] or any(n % size for n in sections):
        raise ValueError(
            f"a leaf of shape {tuple(shape)} splits dim {dim} (sections "
            f"{list(sections)}) over the {axis!r} axis ({size} ranks): not "
            f"divisible")
    return ModelCut(axis, dim, size, sections)


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


def tp_axis(mesh) -> Optional[str]:
    """The tensor-parallel axis: ``tp`` on a canonical mesh, ``model`` on
    a legacy one."""
    if mesh is None:
        return None
    if TP_AXIS in mesh.shape:
        return TP_AXIS
    return MODEL_AXIS if MODEL_AXIS in mesh.shape else None


def sp_axis(mesh) -> Optional[str]:
    """The sequence-parallel axis: ``sp`` on a canonical mesh, ``seq`` on
    a legacy one."""
    if mesh is None:
        return None
    if SP_AXIS in mesh.shape:
        return SP_AXIS
    return SEQ_AXIS if SEQ_AXIS in mesh.shape else None


def _size(mesh, axis: Optional[str]) -> int:
    return (int(mesh.shape[axis]) if mesh is not None and axis is not None
            and axis in mesh.shape else 1)


def data_parallel_size(mesh) -> int:
    """Product of the batch-axis extents (what the batch triple and the
    gradient mean divide by). Neither tp nor sp counts: their ranks hold
    the same rows."""
    n = 1
    for a in batch_axes(mesh):
        n *= _size(mesh, a)
    return n


def zero_size(mesh) -> int:
    return _size(mesh, zero_axis(mesh))


def tp_size(mesh) -> int:
    return _size(mesh, tp_axis(mesh))


def sp_size(mesh) -> int:
    return _size(mesh, sp_axis(mesh))


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


def _zero_leaf_spec(shape, tp_spec: Spec, stage: int, kind: str,
                    axis: Optional[str], size: int) -> ShardSpec:
    if stage >= _THRESHOLD[kind]:
        entries = add_zero_axis(tp_spec, shape, axis, size)
        if axis is not None and axis in entries:
            return ShardSpec(entries.index(axis), axis, size)
    return ShardSpec(None, None, 1)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] if r is not None else None
                                      for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def zero_tree_specs(params: Any, tp_specs, stage: int, mesh, kind: str):
    """Map a params tree to :class:`ShardSpec` leaves over the mesh's zero
    axis. kind: ``'param'`` (sharded from stage 3), ``'grad'`` (stage 2),
    ``'master'`` (stage 1: the fp32 master and the optimizer moments).
    ``tp_specs`` (a tree like ``params`` of specs, or None) are the
    model's tensor-parallel specs: the zero axis skips a dim they shard
    over a live axis, as the reference's does."""
    if kind not in _THRESHOLD:
        raise ValueError(f"kind must be one of {sorted(_THRESHOLD)}, got "
                         f"{kind!r}")
    axis = zero_axis(mesh)
    size = zero_size(mesh)

    def leaf(p, spec=None):
        base = translate_spec(spec, mesh) if spec is not None else ()
        return _zero_leaf_spec(tuple(p.shape), base, stage, kind, axis,
                               size)

    if tp_specs is None:
        return _tree_map(leaf, params)
    return _tree_map(leaf, params, tp_specs)
