"""Mesh factory: named axes over the ranks of ``torch.distributed``.

Counterpart of deeperspeed_tpu/sharding/mesh.py. Where the reference
builds a ``jax.sharding.Mesh`` of devices, the port's :class:`Mesh` names
axes over the ranks of the world the caller initialized (one process a
rank, ranks laid out row-major over the axes) and hands out the process
groups a collective along some of those axes needs. The groups use the
backend the caller chose for the world: NCCL on a node of cards, gloo
for CPU tests, or gloo for several ranks sharing one card (NCCL refuses
two ranks on one device).

It is not a ``torch.distributed.DeviceMesh``: ``init_device_mesh("cuda")``
maps rank r to device r % device_count and builds NCCL groups, which
would refuse the shared-card layout; plain process groups take any.

* :func:`from_config` -- the ``"mesh"`` block -> a canonical mesh over
  ``dp x fsdp x tp x sp`` (size-1 axes kept), the ``-1`` extent inferred
  from the world size.
* :func:`default_mesh` -- what an engine gets with no block: every rank on
  the legacy ``data`` axis.
* a legacy mesh of ``data``, ``model``, ``seq`` and ``expert`` axes
  (parallel/topology.py's ``build_mesh``): the batch splits over
  ``data``, the heads and FFN columns over ``model`` (parallel/tp.py),
  the sequence over ``seq`` (ops/ring_attention.py), each layer's experts
  over ``expert`` (models/moe.py).

Without an initialized process group the world is one rank; a mesh of any
shape can still be built for planning (``zero_tree_specs``), and asking it
for a group wider than one rank raises.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist

from .config import CANONICAL_AXES, MeshConfig

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "EXPERT_AXIS", "DP_AXIS",
    "FSDP_AXIS", "TP_AXIS", "SP_AXIS", "CANONICAL_AXES", "Mesh",
    "world_size", "world_rank", "from_config", "default_mesh",
    "active_mesh", "use_mesh",
]

# the reference's legacy axis names (deeperspeed_tpu/parallel/topology.py)
DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
# Mixture-of-Experts: the experts of each layer split over this axis
# (parallel/topology.build_mesh({"data": d, "expert": e}))
EXPERT_AXIS = "expert"
# the canonical axes
DP_AXIS = "dp"
FSDP_AXIS = "fsdp"
TP_AXIS = "tp"
SP_AXIS = "sp"


_ACTIVE = []


def active_mesh():
    """The mesh of the engine whose loss is running (``use_mesh``), else
    None: a model built without a mesh (``make_gpt(cfg)``) takes its
    collectives from it, as the reference's single jit sees the engine's
    mesh."""
    return _ACTIVE[-1] if _ACTIVE else None


class use_mesh:
    """Context that makes ``mesh`` the :func:`active_mesh`."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        _ACTIVE.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        _ACTIVE.pop()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class Mesh:
    """Named axes (``shape``: axis -> extent, in order) over the ranks of
    the world. ``rank`` is this process's rank in the world."""

    def __init__(self, shape: Dict[str, int], rank: Optional[int] = None):
        self.shape = {str(a): int(n) for a, n in shape.items()}
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.size = 1
        for n in self.shape.values():
            self.size *= n
        self.rank = world_rank() if rank is None else int(rank)
        if dist.is_initialized() and self.size != world_size():
            raise ValueError(f"mesh {self.shape} has {self.size} ranks, the "
                             f"world {world_size()}")
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._transports: Dict[Tuple[str, ...], object] = {}

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Row-major coordinates of ``rank`` (default: this rank)."""
        r = self.rank if rank is None else rank
        out = {}
        for a in reversed(self.axis_names):
            out[a] = r % self.shape[a]
            r //= self.shape[a]
        return {a: out[a] for a in self.axis_names}

    def _rank_of(self, coords: Dict[str, int]) -> int:
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def axis_size(self, axes: Sequence[str]) -> int:
        n = 1
        for a in axes:
            n *= self.shape.get(a, 1)
        return n

    def axis_index(self, axes: Sequence[str],
                   rank: Optional[int] = None) -> int:
        """This rank's position along ``axes`` (row-major over them)."""
        c = self.coords(rank)
        i = 0
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i

    def ranks_along(self, axes: Sequence[str],
                    rank: Optional[int] = None) -> List[int]:
        """The world ranks that share this rank's coordinates on every
        other axis, ordered by their position along ``axes``."""
        base = self.coords(rank)
        out = []
        for i in range(self.axis_size(axes)):
            c = dict(base)
            for a in reversed(list(axes)):
                c[a] = i % self.shape[a]
                i //= self.shape[a]
            out.append(self._rank_of(c))
        return out

    def group(self, axes: Sequence[str]):
        """The process group over ``axes`` for this rank (None for one
        rank). Every rank must ask for the same axes in the same order:
        ``new_group`` is collective, so each partition is created on every
        rank."""
        axes = tuple(a for a in axes if a in self.shape)
        if self.axis_size(axes) <= 1:
            return None
        if not dist.is_initialized():
            raise RuntimeError(f"a group over {axes} of {self.shape} needs an "
                               f"initialized torch.distributed world")
        if axes not in self._groups:
            if self.axis_size(axes) == self.size:
                self._groups[axes] = dist.group.WORLD
            else:
                mine = None
                seen = set()
                for r in range(self.size):
                    ranks = tuple(self.ranks_along(axes, r))
                    if ranks in seen:
                        continue
                    seen.add(ranks)
                    g = dist.new_group(list(ranks))
                    if self.rank in ranks:
                        mine = g
                self._groups[axes] = mine
        return self._groups[axes]

    def transport(self, axes: Sequence[str]):
        """The collectives over ``axes`` (runtime/comm/collectives.py's
        ``Transport`` on ``group(axes)``): one a set of axes, so every
        user of an axis shares its staging buffers and its clock. Built on
        first use, as ``group``."""
        from ..runtime.comm.collectives import Transport

        axes = tuple(a for a in axes if a in self.shape)
        if axes not in self._transports:
            self._transports[axes] = Transport(self.group(axes))
        return self._transports[axes]

    def subgroups(self, partition: Sequence[Sequence[int]]):
        """The group of this rank among ``partition`` (lists of world ranks
        covering the world; every rank passes the same partition)."""
        mine = None
        for ranks in partition:
            g = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if self.rank in ranks:
                mine = g
        return mine


def from_config(cfg, world: Optional[int] = None) -> Mesh:
    """``"mesh"`` block (dict or :class:`MeshConfig`) -> canonical Mesh over
    the world (``world`` ranks, default the initialized world's size).
    Keeps all four named axes, size-1 ones too; ranks lie row-major over
    ``dp x fsdp x tp x sp``, so the ranks of one tp (or sp) group are
    consecutive."""
    if not isinstance(cfg, MeshConfig):
        cfg = MeshConfig.from_dict(cfg)
    dims = cfg.resolve(world_size() if world is None else world)
    return Mesh(dims, rank=None if world is None else 0)


def default_mesh(world: Optional[int] = None) -> Mesh:
    """Every rank on the legacy ``data`` axis: the engine's mesh when no
    ``"mesh"`` block is given."""
    n = world_size() if world is None else world
    return Mesh({DATA_AXIS: n}, rank=None if world is None else 0)
