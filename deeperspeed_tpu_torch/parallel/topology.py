"""Process and mesh topology over ``torch.distributed`` ranks.

Counterpart of deeperspeed_tpu/parallel/topology.py: the axis names, the
pure coordinate math that the pipeline engine, tensor parallelism and
checkpoint naming use (``ProcessTopology``, ``PipeDataParallelTopology``,
``PipeModelDataParallelTopology``, ``PipelineParallelGrid``, as the
reference keeps them), :func:`build_mesh` over the ranks of the world the
caller initialized (the reference builds a ``jax.sharding.Mesh`` of
devices; here it is the port's :class:`~..sharding.mesh.Mesh`, ranks
row-major over the axes, as the reference reshapes its devices), and
:func:`filter_spec`. A spec is a tuple with one entry per dim: ``None``,
an axis name or a tuple of names.

``build_mesh`` takes the ``pipe`` (pipeline stages, runtime/pipe/),
``data``, ``model`` (tensor parallelism, parallel/tp.py), ``seq``
(sequence parallelism, ops/ring_attention.py) and ``expert`` axes. Every
axis is a process axis: the process at (pipe=s, data=d, model=m) runs
stage s's instruction stream. ``PipelineParallelGrid.from_mesh`` gives
the pipeline engine its coordinates and, through ``make_groups``, the
process groups it needs (the pipe axis, each pipe edge, the stage's data
and model groups, one group per tied key), made once, on every rank, in
the same order.
"""

from collections import namedtuple
from itertools import product
from typing import Dict, List, Optional, Sequence

from ..sharding import mesh as mesh_lib

# the reference's axis names; 'seq' and 'expert' are first-class there
PIPE_AXIS = "pipe"
DATA_AXIS = mesh_lib.DATA_AXIS
MODEL_AXIS = mesh_lib.MODEL_AXIS
SEQ_AXIS = mesh_lib.SEQ_AXIS
EXPERT_AXIS = mesh_lib.EXPERT_AXIS


class ProcessTopology:
    """Cartesian rank <-> coordinate mapping over named axes.

    Axes are ordered major to minor: the last axis has stride 1.
    """

    def __init__(self, axes: Sequence[str], dims: Sequence[int]):
        assert len(axes) == len(dims)
        self.axes = list(axes)
        self.dims = list(dims)
        self.ProcessCoord = namedtuple("ProcessCoord", self.axes)
        self.mapping = {}
        ranges = [range(d) for d in self.dims]
        for global_rank, coord in enumerate(product(*ranges)):
            key = dict(zip(self.axes, coord))
            self.mapping[self.ProcessCoord(**key)] = global_rank

    def get_rank(self, **coord_kwargs) -> int:
        if len(coord_kwargs) != len(self.axes):
            raise ValueError(f"get_rank() needs all axes {self.axes}")
        return self.mapping[self.ProcessCoord(**coord_kwargs)]

    def get_axis_names(self) -> List[str]:
        return self.axes

    def get_rank_repr(self, rank, omit_axes=("data", "pipe"), inner_sep="_",
                      outer_sep="-"):
        omit_axes = list(omit_axes)
        axes = [a for a in self.axes if a not in omit_axes]
        names = []
        for ax in axes:
            ax_rank = getattr(self.get_coord(rank=rank), ax)
            names.append(f"{ax}{inner_sep}{ax_rank:02d}")
        return outer_sep.join(names)

    def get_dim(self, axis: str) -> int:
        if axis not in self.axes:
            return 0
        return self.dims[self.axes.index(axis)]

    def get_coord(self, rank: int):
        for coord, idx in self.mapping.items():
            if idx == rank:
                return coord
        raise ValueError(f"rank {rank} not found in topology")

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """Groups of ranks that communicate along `axis` (all other coords
        equal)."""
        if axis not in self.axes:
            return []
        other_axes = [a for a in self.axes if a != axis]
        lists = []
        ranges = [range(self.get_dim(a)) for a in other_axes]
        for other in product(*ranges):
            other_keys = dict(zip(other_axes, other))
            group = [
                self.get_rank(**{axis: ax_idx, **other_keys})
                for ax_idx in range(self.get_dim(axis))
            ]
            lists.append(group)
        return lists

    def filter_match(self, **filter_kwargs) -> List[int]:
        def criterion(x):
            for key, val in filter_kwargs.items():
                if getattr(x, key) != val:
                    return False
            return True

        return sorted(idx for coord, idx in self.mapping.items()
                      if criterion(coord))

    def get_axis_list(self, axis: str, idx: int) -> List[int]:
        return sorted(rank for coord, rank in self.mapping.items()
                      if getattr(coord, axis) == idx)

    def world_size(self) -> int:
        n = 1
        for d in self.dims:
            n *= int(d)
        return n

    def __str__(self):
        return str(self.mapping)


class PipeDataParallelTopology(ProcessTopology):
    """Pipeline-major hybrid PP+DP (reference topology.py:238)."""

    def __init__(self, num_pp, num_dp):
        super().__init__(axes=[PIPE_AXIS, DATA_AXIS], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """3D PP x DP x TP (reference topology.py:250)."""

    def __init__(self, num_pp, num_mp, num_dp):
        super().__init__(axes=[PIPE_AXIS, DATA_AXIS, MODEL_AXIS],
                         dims=[num_pp, num_dp, num_mp])


class PipelineParallelGrid:
    """Axis-rank bookkeeping for a topology (reference topology.py:257):
    "who am I on each axis" for the pipeline engine, checkpoint naming and
    mpu-compatible callers. The process groups themselves come from the
    port's :class:`~..sharding.mesh.Mesh`."""

    def __init__(self, topology: ProcessTopology, global_rank: int = 0):
        self._topo = topology
        self.global_rank = global_rank
        self.world_size = topology.world_size()
        self.data_parallel_size = max(1, topology.get_dim(DATA_AXIS))
        self.pipe_parallel_size = max(1, topology.get_dim(PIPE_AXIS))
        self.model_parallel_size = max(1, topology.get_dim(MODEL_AXIS))
        self.seq_parallel_size = max(1, topology.get_dim(SEQ_AXIS))
        self.expert_parallel_size = max(1, topology.get_dim(EXPERT_AXIS))
        coord = topology.get_coord(global_rank)
        self.stage_id = (getattr(coord, PIPE_AXIS, 0)
                         if PIPE_AXIS in topology.axes else 0)
        self.data_parallel_id = (getattr(coord, DATA_AXIS, 0)
                                 if DATA_AXIS in topology.axes else 0)
        self.model_parallel_id = (getattr(coord, MODEL_AXIS, 0)
                                  if MODEL_AXIS in topology.axes else 0)
        # p2p neighbours on the pipe axis
        self.stage_to_global = {}
        if PIPE_AXIS in topology.axes:
            kwargs = {a: getattr(coord, a) for a in topology.axes
                      if a != PIPE_AXIS}
            for s in range(self.pipe_parallel_size):
                self.stage_to_global[s] = topology.get_rank(
                    **{PIPE_AXIS: s, **kwargs})

    def get_stage_id(self):
        return self.stage_id

    def get_data_parallel_id(self):
        return self.data_parallel_id

    def get_model_parallel_id(self):
        return self.model_parallel_id

    def get_pipe_parallel_rank(self):
        return self.stage_id

    def get_pipe_parallel_world_size(self):
        return self.pipe_parallel_size

    def get_data_parallel_rank(self):
        return self.data_parallel_id

    def get_data_parallel_world_size(self):
        return self.data_parallel_size

    def get_model_parallel_rank(self):
        return self.model_parallel_id

    def get_model_parallel_world_size(self):
        return self.model_parallel_size

    def get_global_rank(self):
        return self.global_rank

    def is_first_stage(self):
        return self.stage_id == 0

    def is_last_stage(self):
        return self.stage_id == self.pipe_parallel_size - 1

    def stage_to_global_rank(self, stage_id):
        return self.stage_to_global[stage_id]

    @property
    def topology(self):
        return self._topo

    # -------------------------------------------------------------- #
    # over a mesh of processes
    # -------------------------------------------------------------- #

    @classmethod
    def from_mesh(cls, mesh):
        """The grid of a port :class:`~..sharding.mesh.Mesh` (axes in its
        order, this process's rank), holding the mesh for
        :meth:`make_groups`."""
        grid = cls(ProcessTopology(list(mesh.axis_names),
                                   [mesh.shape[a] for a in mesh.axis_names]),
                   mesh.rank)
        grid.mesh = mesh
        grid.pipe_group = grid.data_group = grid.model_group = None
        grid._edges = {}
        grid._tied = {}
        return grid

    def make_groups(self, tied_stages: Optional[Dict[str, List[int]]] = None):
        """Every process group the pipeline engine uses, made at once
        (``new_group`` is collective: each rank makes every group, in the
        same order): the pipe axis, the data axes (``rules.batch_axes``),
        the tensor-parallel axis, each pipe edge (stage s and s + 1 at the
        same other coordinates) and, per tied key of ``tied_stages`` (key
        -> its stages), the ranks of those stages at the same other
        coordinates. A group of one rank is None."""
        from ..sharding import rules

        mesh = self.mesh
        self.pipe_group = mesh.transport((PIPE_AXIS,))
        self.data_group = mesh.transport(rules.batch_axes(mesh))
        tp = rules.tp_axis(mesh)
        self.model_group = mesh.transport((tp,) if tp else ())
        pipes = sorted({tuple(mesh.ranks_along((PIPE_AXIS,), r))
                        for r in range(mesh.size)})
        for s in range(self.pipe_parallel_size - 1):
            self._edges[s] = mesh.subgroups([[p[s], p[s + 1]]
                                             for p in pipes])
        for key, stages in sorted((tied_stages or {}).items()):
            self._tied[key] = (mesh.subgroups([[p[s] for s in stages]
                                               for p in pipes])
                               if len(stages) > 1 else None)
        return self

    def edge_group(self, stage_a: int, stage_b: int):
        """The group of this rank's pipe edge between two adjacent
        stages."""
        return self._edges[min(stage_a, stage_b)]

    def tied_group(self, key: str):
        """The group of the stages sharing tied ``key`` at this rank's
        other coordinates (None where one stage holds it)."""
        return self._tied.get(key)


def build_mesh(axis_dims: Dict[str, int], world: Optional[int] = None):
    """A :class:`~..sharding.mesh.Mesh` with named axes from an
    ``{axis: dim}`` dict over the initialized world (``world`` ranks for a
    mesh built only to plan). Axis order follows the dict; one dim of -1
    (or None) is inferred. The legacy names (``data``, ``expert``, ...)
    are kept as given."""
    n = mesh_lib.world_size() if world is None else int(world)
    dims = dict(axis_dims)
    unknown = [a for a, d in dims.items() if d in (-1, None)]
    known = 1
    for d in dims.values():
        if d not in (-1, None):
            known *= int(d)
    if len(unknown) > 1:
        raise ValueError("at most one axis dim may be -1")
    if unknown:
        if n % known != 0:
            raise ValueError(f"{n} devices not divisible by {known}")
        dims[unknown[0]] = n // known
    total = 1
    for d in dims.values():
        total *= int(d)
    if total != n:
        raise ValueError(
            f"mesh dims {dims} require {total} devices but {n} are available")
    return mesh_lib.Mesh({a: int(d) for a, d in dims.items()},
                         rank=None if world is None else 0)


def filter_spec(spec: Optional[Sequence], mesh):
    """Drop axis names a mesh doesn't carry (or carries at size 1), so a
    model's specs work on any mesh shape; ``None`` passes through."""
    if spec is None or mesh is None:
        return spec

    def keep(a):
        return a in mesh.shape and mesh.shape[a] > 1

    parts = []
    for a in tuple(spec):
        if a is None:
            parts.append(a)
        elif isinstance(a, tuple):
            kept = tuple(x for x in a if keep(x))
            parts.append(kept if len(kept) > 1
                         else (kept[0] if kept else None))
        else:
            parts.append(a if keep(a) else None)
    return tuple(parts)


def single_device_mesh(axis_names=(DATA_AXIS,)):
    """A trivial mesh over one rank."""
    return mesh_lib.Mesh({a: 1 for a in axis_names}, rank=0)
