"""Placement audit: stable digests of how an engine's leaves lie over its
ranks.

Counterpart of deeperspeed_tpu/sharding/audit.py: the same digests and the
same summary, so a test or a bench can assert "this layout cut the MLP
over tp" or "ZeRO sharded the moments" instead of eyeballing.

A jax array carries its sharding; a tensor of the port is one rank's part
and carries nothing, so a leaf is described by its engine's spec of it
(:func:`placements`): the model-axis cut (``rules.model_cut``, the tp and
expert axes) and, for the fp32 master and the optimizer moments, the ZeRO
shard (``rules.zero_tree_specs``). A :class:`Placement` writes that spec
in the reference's ``PartitionSpec`` string form (one entry a dim: the
mesh axis that splits it, or None), so :func:`audit_tree`'s ``digest``
equals the reference's for the same layout:

* :func:`spec_digest` -- one leaf -> ``{"spec", "shape" (the whole leaf),
  "n_shards" (the mesh's size, as the reference counts the addressable
  shards), "shard_shape" (this rank's part), "viz_sha1"}``. ``viz_sha1``
  hashes the port's own text rendering of the shard grid
  (:func:`render_grid`): jax's ``visualize_array_sharding`` has no
  counterpart, so it does not equal the reference's.
* :func:`tree_digest` -- a tree -> per-leaf digests keyed by the leaf's
  path in ``jax.tree_util.keystr`` form (``['layers']['mlp']['wi']``).
* :func:`audit_tree` -- the summary: leaf counts, sharded elements and
  fraction, and the digest over every leaf's path, spec and shard shape.
"""

import dataclasses
import hashlib
from typing import Any, Dict, Optional, Tuple

__all__ = ["Placement", "audit_tree", "placements", "render_grid",
           "spec_digest", "tree_digest"]


@dataclasses.dataclass(frozen=True)
class Placement:
    """How one leaf lies over a mesh: ``entries`` (one a dim: the axis
    that splits it, or None) and the whole leaf's ``shape``."""

    entries: Tuple[Optional[str], ...]
    shape: Tuple[int, ...]

    @property
    def spec(self) -> str:
        """The reference's ``str(PartitionSpec(*entries))``."""
        return f"PartitionSpec{tuple(self.entries)!r}"


def placements(engine, kind: str = "params"):
    """The :class:`Placement` of every leaf of ``engine``'s params
    (``kind="params"``: the model-axis cuts; below ZeRO stage 3 a param is
    whole over the data axes) or of its fp32 master and optimizer moments
    (``kind="state"``: the cuts and the ZeRO shards), as a tree like the
    params."""
    from ..ops.adam import tree_leaves, tree_map

    if kind not in ("params", "state"):
        raise ValueError(f"kind must be 'params' or 'state', got {kind!r}")
    out = []
    for p, cut, zs in zip(tree_leaves(engine.params), engine._cuts,
                          engine._specs):
        entries = [None] * p.dim()
        shape = list(p.shape)
        if cut is not None:
            entries[cut.dim] = cut.axis
            shape[cut.dim] *= cut.size
        if kind == "state" and zs.sharded:
            entries[zs.dim] = zs.axis
        out.append(Placement(tuple(entries), tuple(shape)))
    it = iter(out)
    return tree_map(lambda _: next(it), engine.params)


def render_grid(placement: Placement, mesh) -> str:
    """A text rendering of the shard grid: one line a distinct block of
    the leaf (its index range along every dim) and the ranks that hold
    it."""
    blocks: Dict[tuple, list] = {}
    for r in range(mesh.size if mesh is not None else 1):
        coords = mesh.coords(r) if mesh is not None else {}
        block = []
        for n, axis in zip(placement.shape, placement.entries):
            if axis is None:
                block.append((0, n))
            else:
                m = n // mesh.shape[axis]
                block.append((coords[axis] * m, (coords[axis] + 1) * m))
        blocks.setdefault(tuple(block), []).append(r)
    return "\n".join(
        f"[{', '.join(f'{lo}:{hi}' for lo, hi in block)}] -> ranks {ranks}"
        for block, ranks in sorted(blocks.items()))


def spec_digest(x, placement: Optional[Placement] = None,
                mesh=None) -> Dict[str, Any]:
    """Digest of one leaf: ``x`` is this rank's part, ``placement`` its
    engine's spec of it (None: a whole tensor on one device, the
    reference's "unsharded")."""
    local = [int(n) for n in x.shape]
    if placement is None:
        return {"spec": "unsharded", "shape": local, "n_shards": 1,
                "shard_shape": local, "viz_sha1": ""}
    viz = render_grid(placement, mesh)
    return {
        "spec": placement.spec,
        "shape": [int(n) for n in placement.shape],
        "n_shards": int(mesh.size) if mesh is not None else 1,
        "shard_shape": local,
        "viz_sha1": hashlib.sha1(viz.encode()).hexdigest()[:12],
    }


def _keyed(tree, prefix=""):
    """(path, leaf) in the reference's flatten order (sorted dict keys)
    and ``jax.tree_util.keystr`` form."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _keyed(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


def tree_digest(tree, specs=None, mesh=None) -> Dict[str, Dict[str, Any]]:
    """Per-leaf digests keyed by path; ``specs`` a tree like ``tree`` of
    :class:`Placement` (:func:`placements`), or None."""
    spec_of = dict(_keyed(specs)) if specs is not None else {}
    return {path: spec_digest(leaf, spec_of.get(path), mesh)
            for path, leaf in _keyed(tree)}


def describe(mesh) -> dict:
    """JSON-able layout descriptor, as the reference's ``describe``."""
    from .config import CANONICAL_AXES

    if mesh is None:
        return {"axes": {}, "devices": 0, "generation": "none"}
    return {
        "axes": {a: int(s) for a, s in mesh.shape.items()},
        "devices": int(mesh.size),
        "generation": ("canonical" if tuple(mesh.shape) == CANONICAL_AXES
                       else "legacy"),
    }


def audit_tree(tree, mesh=None, specs=None) -> Dict[str, Any]:
    """Placement summary of a whole tree (params, master, a moment tree):
    ``sharded_elems`` counts the leaves one of whose dims a mesh axis
    splits; a ZeRO run over an fsdp axis shows nearly all the moments'
    elements there, a pure-dp run none."""
    leaves = tree_digest(tree, specs, mesh)
    total = sharded_elems = 0
    sharded = replicated = 0
    for d in leaves.values():
        n = 1
        for s in d["shape"]:
            n *= int(s)
        total += n
        if d["n_shards"] > 1 and d["shard_shape"] != d["shape"]:
            sharded += 1
            sharded_elems += n
        else:
            replicated += 1
    out = {
        "leaves": len(leaves),
        "sharded_leaves": sharded,
        "replicated_leaves": replicated,
        "total_elems": int(total),
        "sharded_elems": int(sharded_elems),
        "sharded_frac": round(sharded_elems / total, 4) if total else 0.0,
        "digest": hashlib.sha1(
            "".join(sorted(f"{k}:{v['spec']}:{v['shard_shape']}"
                           for k, v in leaves.items())).encode()
        ).hexdigest()[:12],
    }
    if mesh is not None:
        out["mesh"] = describe(mesh)
    return out
