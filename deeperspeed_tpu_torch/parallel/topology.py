"""Mesh axes over ``torch.distributed`` ranks: the part MoE needs.

Counterpart of deeperspeed_tpu/parallel/topology.py for expert
parallelism: the axis names, :func:`build_mesh` over the ranks of the
world the caller initialized (the reference builds a ``jax.sharding.Mesh``
of devices; here it is the port's :class:`~..sharding.mesh.Mesh`, ranks
row-major over the axes, as the reference reshapes its devices), and
:func:`filter_spec`. A spec is a tuple with one entry per dim: ``None``,
an axis name or a tuple of names.

``ProcessTopology``, ``PipeDataParallelTopology``,
``PipeModelDataParallelTopology`` and ``PipelineParallelGrid`` serve the
pipeline engine and tensor parallelism, which are not ported yet: they
raise, naming ROADMAP.md's item.
"""

from typing import Dict, Optional, Sequence

from ..sharding import mesh as mesh_lib

# the reference's axis names; 'seq' and 'expert' are first-class there
PIPE_AXIS = "pipe"
DATA_AXIS = mesh_lib.DATA_AXIS
MODEL_AXIS = mesh_lib.MODEL_AXIS
SEQ_AXIS = mesh_lib.SEQ_AXIS
EXPERT_AXIS = mesh_lib.EXPERT_AXIS

_ITEM = "ROADMAP.md queue 1, item 'MoE, TP and pipeline'"


def _unported(name):
    class Unported:
        def __init__(self, *args, **kwargs):
            raise NotImplementedError(
                f"{name} (the pipeline and tensor-parallel topology) is not "
                f"ported to the PyTorch package yet ({_ITEM})")

    Unported.__name__ = Unported.__qualname__ = name
    return Unported


ProcessTopology = _unported("ProcessTopology")
PipeDataParallelTopology = _unported("PipeDataParallelTopology")
PipeModelDataParallelTopology = _unported("PipeModelDataParallelTopology")
PipelineParallelGrid = _unported("PipelineParallelGrid")


def build_mesh(axis_dims: Dict[str, int], world: Optional[int] = None):
    """A :class:`~..sharding.mesh.Mesh` with named axes from an
    ``{axis: dim}`` dict over the initialized world (``world`` ranks for a
    mesh built only to plan). Axis order follows the dict; one dim of -1
    (or None) is inferred. The legacy names (``data``, ``expert``, ...)
    are kept as given. A ``pipe``, ``model`` or ``seq`` extent above 1
    raises: those axes are not ported."""
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
    for axis in (PIPE_AXIS, MODEL_AXIS, SEQ_AXIS):
        if int(dims.get(axis, 1)) > 1:
            raise NotImplementedError(
                f"mesh {dims}: the {axis!r} axis is not ported to the "
                f"PyTorch package yet ({_ITEM})")
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
