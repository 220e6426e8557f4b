"""Size-bounded gradient bucketing in layer order.

Counterpart of deeperspeed_tpu/runtime/comm/bucketing.py. A
:class:`BucketPlan` is built once from the parameter tree's shapes;
``pack``/``unpack`` move between a bucket's leaves and its flat fp32 view.

Leaves fill buckets greedily in the reference's leaf order and never
split: a leaf larger than ``bucket_bytes`` gets a bucket of its own. Each
bucket's flat length is padded up to a multiple of ``pad_to`` (the reducer
passes ``world * block``) so the quantized wire formats see whole blocks
and whole per-rank chunks.

The reference's leaf order is ``jax.tree.leaves``: dict keys sorted at
every level. The port's params trees keep their insertion order
(``ops/adam.tree_leaves``), so the plan walks them through
:func:`tree_flatten_sorted`, and a plan built here equals the reference's
on the same tree: the same leaf ids, offsets, lengths and padding.
"""

import dataclasses
from typing import Callable, List, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Bucket:
    index: int
    leaf_ids: Tuple[int, ...]     # indices into the sorted leaf list
    shapes: Tuple[Tuple[int, ...], ...]
    offsets: Tuple[int, ...]      # start of each leaf in the flat bucket
    length: int                   # unpadded element count
    padded: int                   # length rounded up to pad_to

    @property
    def pad(self) -> int:
        return self.padded - self.length


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    buckets: Tuple[Bucket, ...]
    n_leaves: int
    total_elements: int
    pad_to: int

    def fingerprint(self) -> Tuple:
        """Static identity of the layout, compared on checkpoint restore so
        residuals from a different plan are dropped, not misapplied."""
        return tuple(
            (b.leaf_ids, b.shapes, b.padded) for b in self.buckets)


def tree_flatten_sorted(tree) -> Tuple[list, Callable[[Sequence], object]]:
    """The leaves of nested dicts with keys sorted at every level (jax's
    order), and a function that rebuilds the tree (in its own key order)
    from such a list."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            leaves.append(t)

    walk(tree)

    def unflatten(values):
        values = list(values)
        pos = {}

        def index(t, path):
            if isinstance(t, dict):
                for k in sorted(t):
                    index(t[k], path + (k,))
            else:
                pos[path] = len(pos)

        index(tree, ())

        def build(t, path):
            if isinstance(t, dict):
                return {k: build(v, path + (k,)) for k, v in t.items()}
            return values[pos[path]]

        return build(tree, ())

    return leaves, unflatten


def build_plan(tree, bucket_bytes: int, pad_to: int = 1) -> BucketPlan:
    """Plan buckets from a tree of tensors (or anything with ``.shape``).

    Bucket fill is measured in fp32 bytes of the flat view (4 bytes per
    element) whatever the leaves' storage dtype, because the reducer packs
    buckets in fp32 before the wire format."""
    leaves, _ = tree_flatten_sorted(tree)
    if not leaves:
        raise ValueError("cannot build a bucket plan from an empty tree")
    cap = max(1, int(bucket_bytes) // 4)  # elements per bucket
    buckets: List[Bucket] = []
    ids: List[int] = []
    shapes: List[Tuple[int, ...]] = []
    offsets: List[int] = []
    fill = 0

    def flush():
        nonlocal ids, shapes, offsets, fill
        if not ids:
            return
        padded = -(-fill // pad_to) * pad_to
        buckets.append(Bucket(
            index=len(buckets), leaf_ids=tuple(ids), shapes=tuple(shapes),
            offsets=tuple(offsets), length=fill, padded=padded))
        ids, shapes, offsets, fill = [], [], [], 0

    for i, leaf in enumerate(leaves):
        size = 1
        for d in leaf.shape:
            size *= int(d)
        if ids and fill + size > cap:
            flush()
        ids.append(i)
        shapes.append(tuple(int(d) for d in leaf.shape))
        offsets.append(fill)
        fill += size
    flush()
    return BucketPlan(
        buckets=tuple(buckets), n_leaves=len(leaves),
        total_elements=sum(b.length for b in buckets), pad_to=pad_to)


def pack(bucket: Bucket, leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate a bucket's leaves into its flat fp32 (padded,) view."""
    parts = [leaf.reshape(-1).float() for leaf in leaves]
    if bucket.pad:
        parts.append(torch.zeros((bucket.pad,), dtype=torch.float32,
                                 device=parts[0].device))
    return parts[0].contiguous() if len(parts) == 1 else torch.cat(parts)


def unpack(bucket: Bucket, flat: torch.Tensor) -> List[torch.Tensor]:
    """Split a flat (padded,) view back into the bucket's fp32 leaves
    (views into ``flat``)."""
    out = []
    for shape, off in zip(bucket.shapes, bucket.offsets):
        size = 1
        for d in shape:
            size *= d
        out.append(flat[off:off + size].reshape(shape))
    return out
