"""Tensor (model) parallelism: Megatron's column and row splits.

Counterpart of deeperspeed_tpu/parallel/tp.py. The reference expresses
tensor parallelism as PartitionSpecs over the ``model`` mesh axis and
lets XLA insert the collectives; a process of the port is one rank, so
every collective GSPMD would insert is written here by hand, over the
process group of the mesh's tensor-parallel axis (``model`` on a legacy
mesh, ``tp`` on a canonical one), through ``runtime/comm/collectives
.Transport`` (host copies on gloo with CUDA tensors, as the data axes).

* The spec functions (``column_parallel_spec``, ``row_parallel_spec``,
  ``vocab_parallel_spec``): a spec names the axis a dim is split over.
* Megatron's f and g as autograd Functions over a group:
  ``copy_to_tp_region`` (identity forward, all-reduce backward: the input
  of a column-parallel layer) and ``reduce_from_tp_region`` (all-reduce
  forward, identity backward: the output of a row-parallel layer). A
  plain ``torch.distributed.nn`` all-reduce in place of g would
  all-reduce the backward too and count the grads ``size`` times: the
  reference's "psum's transpose is psum" (its tp.py:96-107). The
  ``*_model_parallel_region`` mappings take a mesh and use its tp group;
  ``scatter_to`` keeps this rank's columns (its backward all-gathers),
  ``gather_from`` all-gathers them (its backward keeps this rank's).
* The layers (``ColumnParallelLinear``, ``RowParallelLinear``,
  ``VocabParallelEmbedding``, ``ParallelMLP``), on the layer protocol of
  runtime/pipe/module.py: ``init`` gives the WHOLE params (the
  reference's layout), ``shard`` cuts this rank's part by the layer's
  ``specs``, ``apply`` computes on that part.
* ``ModelParallelUnit``: the mpu facade ``initialize(mpu=)`` takes; its
  ``get_*_group`` return the port's process groups where the
  reference's return axis names.
"""

from typing import Any, Optional

import torch
import torch.nn.functional as F

from ..runtime.comm.collectives import Transport
from ..runtime.pipe.module import Layer as _PipeLayer
from ..sharding import rules
from ..utils.init import normal_drawer
from .topology import MODEL_AXIS, PIPE_AXIS, SEQ_AXIS

__all__ = [
    "column_parallel_spec", "row_parallel_spec", "vocab_parallel_spec",
    "axis_transport", "tp_transport", "sp_transport", "copy_to_tp_region",
    "reduce_from_tp_region", "scatter_to_tp_region",
    "gather_from_tp_region", "copy_to_model_parallel_region",
    "reduce_from_model_parallel_region", "scatter_to_model_parallel_region",
    "gather_from_model_parallel_region", "shard_tree", "gather_tree",
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
    "ParallelMLP", "ModelParallelUnit",
]


# ------------------------------------------------------------------ #
# spec functions
# ------------------------------------------------------------------ #


def column_parallel_spec(stacked: bool = False):
    """Weight (in, out) split on the OUTPUT dim: Megatron column parallel.
    ``stacked=True`` prepends a layer axis."""
    return (None, None, MODEL_AXIS) if stacked else (None, MODEL_AXIS)


def row_parallel_spec(stacked: bool = False):
    """Weight (in, out) split on the INPUT dim: Megatron row parallel."""
    return (None, MODEL_AXIS, None) if stacked else (MODEL_AXIS, None)


def vocab_parallel_spec():
    """Embedding table (vocab, dim) split over the embedding DIM, not the
    vocab rows, as the reference splits it (its tp.py:54-61): each rank
    gathers its columns of every token's row, and the columns are then
    all-gathered."""
    return (None, MODEL_AXIS)


# ------------------------------------------------------------------ #
# the groups of a mesh's tp and sp axes
# ------------------------------------------------------------------ #


def axis_transport(mesh, axis: Optional[str]) -> Optional[Transport]:
    """The collectives of one axis of ``mesh`` (``Mesh.transport``: one a
    mesh and axis, built on first use), or None for an axis of one
    rank."""
    if mesh is None or axis is None or mesh.shape.get(axis, 1) <= 1:
        return None
    return mesh.transport((axis,))


def tp_transport(mesh) -> Optional[Transport]:
    """The collectives of ``mesh``'s tensor-parallel axis, or None
    without a live one."""
    return axis_transport(mesh, rules.tp_axis(mesh))


def sp_transport(mesh) -> Optional[Transport]:
    """The collectives of ``mesh``'s sequence-parallel axis, or None."""
    return axis_transport(mesh, rules.sp_axis(mesh))


def _live(group) -> bool:
    return group is not None and group.size > 1


# ------------------------------------------------------------------ #
# Megatron's f / g and the column scatter / gather
# ------------------------------------------------------------------ #


class _CopyToRegion(torch.autograd.Function):
    """f: identity forward, the sum over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_sum(g.contiguous()), None


class _ReduceFromRegion(torch.autograd.Function):
    """g: the sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce_sum(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


def _last_cols(x, group):
    n = x.shape[-1] // group.size
    return x.narrow(-1, group.rank * n, n).contiguous()


def _gather_last(x, group):
    parts = group.all_gather(x.contiguous())  # (size, *x.shape)
    return torch.cat(parts.unbind(0), dim=-1)


class _ScatterToRegion(torch.autograd.Function):
    """This rank's columns of the last dim; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _last_cols(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.group), None


class _GatherFromRegion(torch.autograd.Function):
    """Every rank's columns of the last dim, concatenated; the backward
    keeps this rank's columns (the loss downstream is the same on every
    rank of the group)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _last_cols(g, ctx.group), None


def copy_to_tp_region(x, group: Optional[Transport]):
    """Megatron f over ``group`` (a Transport; None or one rank: x)."""
    return _CopyToRegion.apply(x, group) if _live(group) else x


def reduce_from_tp_region(x, group: Optional[Transport]):
    """Megatron g over ``group``: use this, not a bare all-reduce, to
    complete a row-parallel matmul."""
    return _ReduceFromRegion.apply(x, group) if _live(group) else x


def scatter_to_tp_region(x, group: Optional[Transport]):
    return _ScatterToRegion.apply(x, group) if _live(group) else x


def gather_from_tp_region(x, group: Optional[Transport]):
    return _GatherFromRegion.apply(x, group) if _live(group) else x


def copy_to_model_parallel_region(x, mesh=None):
    """Identity forward, all-reduce over the mesh's tp axis backward."""
    return copy_to_tp_region(x, tp_transport(mesh))


def reduce_from_model_parallel_region(x, mesh=None):
    """Partial sums -> the sum over the mesh's tp axis (identity
    backward)."""
    return reduce_from_tp_region(x, tp_transport(mesh))


def scatter_to_model_parallel_region(x, mesh=None):
    """-> this rank's columns of the last dim."""
    return scatter_to_tp_region(x, tp_transport(mesh))


def gather_from_model_parallel_region(x, mesh=None):
    """Columns of the last dim -> all of them (all-gather)."""
    return gather_from_tp_region(x, tp_transport(mesh))


# ------------------------------------------------------------------ #
# whole <-> this rank's part, by spec
# ------------------------------------------------------------------ #


def _walk(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _walk(fn, v, None if specs is None else specs.get(k))
                for k, v in tree.items()}
    return fn(tree, specs)


def shard_tree(params, specs, mesh):
    """This rank's part of a tree of WHOLE leaves: each leaf cut over the
    model axis its spec names (``rules.model_cut``), every other leaf
    whole. The same rule the engine's load and the converter use."""
    coords = mesh.coords() if mesh is not None else {}

    def leaf(p, spec):
        cut = rules.model_cut(spec, tuple(p.shape), mesh)
        if cut is None:
            return p
        return cut.part(p, coords[cut.axis]).contiguous()

    return _walk(leaf, params, specs)


def gather_tree(params, specs, mesh):
    """The whole leaves of a tree of this rank's parts (collective over
    each model axis: every rank calls it)."""
    def leaf(p, spec):
        whole_shape = list(p.shape)
        cut = None
        if spec is not None and mesh is not None:
            t = rules.translate_spec(spec, mesh)
            for d, e in enumerate(t):
                if e in rules.model_axes(mesh):
                    whole_shape[d] *= int(mesh.shape[e])
            cut = rules.model_cut(spec, tuple(whole_shape), mesh)
        if cut is None:
            return p
        group = axis_transport(mesh, cut.axis)
        with torch.no_grad():
            return cut.join(group.all_gather(p.detach()).unbind(0))

    return _walk(leaf, params, specs)


# ------------------------------------------------------------------ #
# TP layers (pipeline-layer compatible)
# ------------------------------------------------------------------ #


class _TPLayerBase(_PipeLayer):
    """A layer of the pipeline protocol carrying its specs in ``.specs``;
    ``shard(params)`` cuts this rank's part of the whole params."""

    specs: Any = None
    mesh: Any = None

    def shard(self, params):
        return shard_tree(params, self.specs, self.mesh)

    @property
    def group(self):
        return tp_transport(self.mesh)


class ColumnParallelLinear(_TPLayerBase):
    """Y = X W + b with W (in, out) split on out. ``gather_output=True``
    all-gathers Y; by default Y stays split for a following
    RowParallelLinear."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 gather_output: bool = False, mesh=None,
                 init_scale: float = 0.02):
        self.in_dim, self.out_dim, self.bias = in_dim, out_dim, bias
        self.gather_output = gather_output
        self.mesh = mesh
        self.init_scale = init_scale
        self.specs = {"w": column_parallel_spec()}
        if bias:
            self.specs["b"] = (MODEL_AXIS,)

    def init(self, seed, device="cpu"):
        p = {"w": normal_drawer(seed, device)((self.in_dim, self.out_dim),
                                              self.init_scale)}
        if self.bias:
            p["b"] = torch.zeros(self.out_dim, dtype=torch.float32,
                                 device=device)
        return p

    def apply(self, params, x, rng=None):
        x = copy_to_tp_region(x, self.group)
        y = x @ params["w"].to(x.dtype)
        if self.bias:
            y = y + params["b"].to(x.dtype)
        if self.gather_output:
            y = gather_from_tp_region(y, self.group)
        return y


class RowParallelLinear(_TPLayerBase):
    """Y = X W + b with W (in, out) split on in. ``input_is_parallel``:
    X arrives split from a ColumnParallelLinear (else this rank's columns
    are taken); the partial products are summed over the group (g), then
    the bias is added once."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 input_is_parallel: bool = True, mesh=None,
                 init_scale: float = 0.02):
        self.in_dim, self.out_dim, self.bias = in_dim, out_dim, bias
        self.input_is_parallel = input_is_parallel
        self.mesh = mesh
        self.init_scale = init_scale
        self.specs = {"w": row_parallel_spec()}
        if bias:
            self.specs["b"] = (None,)

    def init(self, seed, device="cpu"):
        p = {"w": normal_drawer(seed, device)((self.in_dim, self.out_dim),
                                              self.init_scale)}
        if self.bias:
            p["b"] = torch.zeros(self.out_dim, dtype=torch.float32,
                                 device=device)
        return p

    def apply(self, params, x, rng=None):
        if not self.input_is_parallel:
            x = scatter_to_tp_region(x, self.group)
        y = reduce_from_tp_region(x @ params["w"].to(x.dtype), self.group)
        if self.bias:
            y = y + params["b"].to(x.dtype)
        return y


class VocabParallelEmbedding(_TPLayerBase):
    """Embedding with the table split over its d_model columns (the
    reference's layout): each rank gathers its columns of the tokens'
    rows, then the columns are all-gathered (split in the backward)."""

    def __init__(self, vocab: int, dim: int, mesh=None):
        self.vocab, self.dim, self.mesh = vocab, dim, mesh
        self.specs = {"w": vocab_parallel_spec()}

    def init(self, seed, device="cpu"):
        return {"w": normal_drawer(seed, device)((self.vocab, self.dim),
                                                 0.02)}

    def apply(self, params, x, rng=None):
        y = F.embedding(x.long(), params["w"])
        return gather_from_tp_region(y, self.group)


class ParallelMLP(_TPLayerBase):
    """Column-parallel up-projection, tanh GeLU, row-parallel
    down-projection: one all-reduce a forward (and one a backward)."""

    def __init__(self, d_model: int, d_ff: int, mesh=None):
        self.mesh = mesh
        self.up = ColumnParallelLinear(d_model, d_ff, mesh=mesh)
        self.down = RowParallelLinear(d_ff, d_model, mesh=mesh)
        self.specs = {"up": self.up.specs, "down": self.down.specs}

    def init(self, seed, device="cpu"):
        gen = seed
        if (not isinstance(gen, torch.Generator)
                and torch.device(device).type != "meta"):
            gen = torch.Generator(device=device).manual_seed(int(seed))
        return {"up": self.up.init(gen, device),
                "down": self.down.init(gen, device)}

    def apply(self, params, x, rng=None):
        h = self.up.apply(params["up"], x)
        h = F.gelu(h, approximate="tanh")
        return self.down.apply(params["down"], h)


# ------------------------------------------------------------------ #
# mpu-compatible adapter
# ------------------------------------------------------------------ #


class ModelParallelUnit:
    """Megatron-mpu-compatible facade over the port's mesh: the rank and
    size queries a caller of ``initialize(mpu=...)`` makes, answered from
    the mesh's coordinates. ``get_*_group`` return this rank's
    ``torch.distributed`` process group of the axis (None for an axis of
    one rank), where the reference returns the axis name."""

    def __init__(self, mesh, process_index: Optional[int] = None):
        self.mesh = mesh
        self._rank = mesh.rank if process_index is None else process_index
        self._tp = rules.tp_axis(mesh) or MODEL_AXIS
        self._sp = rules.sp_axis(mesh) or SEQ_AXIS
        self._data = rules.batch_axes(mesh)

    def _coord(self, axis: str) -> int:
        if axis not in self.mesh.shape:
            return 0
        return self.mesh.coords(self._rank)[axis]

    def _group(self, axes):
        axes = tuple(a for a in axes if a in self.mesh.shape)
        return self.mesh.group(axes)

    def get_model_parallel_rank(self) -> int:
        return self._coord(self._tp)

    def get_model_parallel_world_size(self) -> int:
        return int(self.mesh.shape.get(self._tp, 1))

    def get_model_parallel_group(self):
        return self._group((self._tp,))

    def get_data_parallel_rank(self) -> int:
        return (self.mesh.axis_index(self._data, self._rank)
                if self._data else 0)

    def get_data_parallel_world_size(self) -> int:
        return rules.data_parallel_size(self.mesh)

    def get_data_parallel_group(self):
        return self._group(self._data)

    def get_pipe_parallel_rank(self) -> int:
        return self._coord(PIPE_AXIS)

    def get_pipe_parallel_world_size(self) -> int:
        return int(self.mesh.shape.get(PIPE_AXIS, 1))

    def get_pipe_parallel_group(self):
        return self._group((PIPE_AXIS,))

    def get_sequence_parallel_world_size(self) -> int:
        return int(self.mesh.shape.get(self._sp, 1))

    def get_sequence_parallel_group(self):
        return self._group((self._sp,))

