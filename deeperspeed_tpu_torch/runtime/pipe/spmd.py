"""Single-program SPMD pipeline: every rank of the pipe group runs the
same tick loop.

Counterpart of deeperspeed_tpu/runtime/pipe/spmd.py
(``make_spmd_pipeline``, ``make_spmd_pipeline_train_step``). The
reference jits the whole microbatch schedule as one XLA program over the
``pipe`` mesh axis (shard_map) and rotates activations with
``lax.ppermute``. In the port the pipe axis is a process axis (one
process a stage, as in engine.py), so "single-program" means that every
rank of the pipe group runs the same tick loop, and a rotation is a
message to the neighbour stage over the process group of one pipe edge
(p2p.py: gloo through host copies when the ranks share one card, NCCL
between cards). Sends are ``isend``; receives block; what pairs them is
the per-edge FIFO order of the messages, as in the pipeline engine. A
slot the reference masks (a microbatch outside [0, M)) is skipped: no
compute and no message.

Two schedules, as the reference's:

* ``"1f1b"``: T = M + 2(S-1) ticks; at tick t stage s runs the forward
  of microbatch m_f = t - s and the backward of microbatch
  m_b = t - 2(S-1) + s. A stage keeps its forward inputs in a ring of
  2S-1 slots, so the live activations are O(S) and flat in M. The
  backward recomputes the stage forward from the saved input and
  differentiates it (``torch.autograd.grad``, the counterpart of
  ``jax.vjp``); the last stage takes the gradient of
  ``loss_fn(y[None], label[None]) / M`` of the microbatch it forwarded
  that tick (its forward runs once, under autograd). Grads are summed in
  fp32 over the M backward slots. CONTRACT: ``loss_fn`` over the full
  (M, mb, ...) batch must equal the mean of its per-microbatch values.
* ``"gpipe"``: M + S - 1 forward waves, the last stage's outputs stacked
  into the full (M, mb, ...) batch and ``loss_fn`` taken over it, then
  the backward through each stage's saved work, microbatch by
  microbatch, the input grads sent back. Exact for any ``loss_fn``;
  ~M stage activations live (``remat`` keeps the inputs only and
  recomputes each stage forward in the backward).

3D composition: a ``data`` axis (the mesh's batch axes) splits the
microbatch rows; the loss and then the grads are averaged over it (a
mean: a sum would scale the learning rate by dp). A ``model`` axis goes
to the ``stage_fn``, which completes its row-parallel matmuls with
parallel/tp.py's f/g over ``tp_transport(mesh)``. The loss is broadcast
from the last stage to every stage.

Ownership: a rank holds and updates only its own stage's part of the
params and of the optimizer state, its leaves of shape (1, ...) (the
stage axis of size one, cut over a model axis by ``param_specs``), the
local view the reference's shard_map gives each shard.
``stage_part`` cuts a whole (S, ...) tree to this rank's part and
``gather_stages`` gathers the parts back, whole, on every rank.

Activations: torch refuses a product of mixed dtypes that jax promotes,
so the stage input is cast to the promotion of the microbatch dtype and
the params' floating dtypes (what the reference's abstract evaluation
of such a stage gives it); the activations then take the dtype and
shape of the stage output, as in the reference.
"""

from typing import Callable, Optional

import torch

from ...ops.adam import tree_leaves, tree_map
from ...parallel.topology import PIPE_AXIS, PipelineParallelGrid
from ...sharding import mesh as mesh_lib
from ...sharding import rules
from . import p2p

__all__ = ["make_spmd_pipeline", "make_spmd_pipeline_train_step",
           "stage_part", "gather_stages", "SCHEDULES"]

SCHEDULES = ("1f1b", "gpipe")


# ------------------------------------------------------------------ #
# the mesh, the specs and the parts
# ------------------------------------------------------------------ #


def _check_mesh(mesh, num_stages):
    assert PIPE_AXIS in mesh.axis_names, f"mesh needs a '{PIPE_AXIS}' axis"
    assert mesh.shape[PIPE_AXIS] == num_stages, (
        f"mesh '{PIPE_AXIS}' axis is {mesh.shape[PIPE_AXIS]}, "
        f"expected num_stages={num_stages}")


def _check_specs(param_specs):
    for spec in tree_leaves(param_specs):
        assert tuple(spec)[:1] == (PIPE_AXIS,), (
            f"every param spec must lead with '{PIPE_AXIS}' (stage axis); "
            f"got {spec}")


def _grid(mesh):
    """The pipe, data and model groups and the pipe edges of ``mesh``,
    made once a mesh (``new_group`` is collective: every rank of the
    world calls this the first time together)."""
    grid = mesh.__dict__.get("_spmd_grid")
    if grid is None:
        grid = mesh.__dict__["_spmd_grid"] = \
            PipelineParallelGrid.from_mesh(mesh).make_groups()
    return grid


def _specs_like(tree, param_specs):
    if param_specs is None:
        return tree_map(lambda _: (PIPE_AXIS,), tree)
    return param_specs


def stage_part(tree, mesh, param_specs=None):
    """This rank's part of a whole tree of (S, ...) leaves: its stage's
    slice (kept as a leading axis of one) cut over a model axis where
    its spec names one (``rules.model_cut``), in storage of its own."""
    coords = mesh.coords()
    s = coords[PIPE_AXIS]

    def leaf(t, spec):
        part = t.narrow(0, s, 1)
        cut = rules.model_cut(spec, tuple(t.shape), mesh)
        if cut is not None:
            part = cut.part(part, coords[cut.axis])
        # a copy of its own: a view would keep the whole leaf alive
        return part.clone(memory_format=torch.contiguous_format)

    return tree_map(leaf, tree, _specs_like(tree, param_specs))


def gather_stages(tree, mesh, param_specs=None):
    """The whole (S, ...) tree on every rank from each rank's part
    (collective over the world: every rank calls it)."""
    grid = _grid(mesh)

    live = rules.model_axes(mesh)

    def leaf(t, spec):
        whole_shape = list(t.shape)
        whole_shape[0] = mesh.shape[PIPE_AXIS]
        for d, e in enumerate(rules.translate_spec(spec, mesh)):
            if e in live:
                whole_shape[d] *= mesh.shape[e]
        cut = rules.model_cut(spec, tuple(whole_shape), mesh)
        if cut is not None:
            t = cut.join(grid.model_group.all_gather(
                t.detach().contiguous()).unbind(0))
        stages = grid.pipe_group.all_gather(t.detach().contiguous())
        return torch.cat(stages.unbind(0), dim=0)

    with torch.no_grad():
        return tree_map(leaf, tree, _specs_like(tree, param_specs))


class _Stage:
    """What one rank of the pipeline needs in its tick loop."""

    def __init__(self, stage_fn, num_stages, mesh, device):
        self.fn = stage_fn
        self.S = num_stages
        self.mesh = mesh
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "the SPMD pipeline runs on CUDA unless given device='cpu', "
                "and no CUDA device is available")
        self.grid = _grid(mesh)
        self.s = mesh.coords()[PIPE_AXIS]
        self.first, self.last = self.s == 0, self.s == num_stages - 1
        self.dp = rules.data_parallel_size(mesh)
        self.pending = []

    def local(self, params):
        """The stage's params with the stage axis taken off (views)."""
        return tree_map(lambda p: p[0], params)

    def apply(self, params, x):
        with mesh_lib.use_mesh(self.mesh):
            return self.fn(params, x)

    def act_dtype(self, params, x):
        if not x.is_floating_point():
            return x.dtype
        dt = x.dtype
        for p in tree_leaves(params):
            if p.is_floating_point():
                dt = torch.promote_types(dt, p.dtype)
        return dt

    def rows(self, batch):
        """This data rank's rows of each microbatch (dim 1)."""
        batch = torch.as_tensor(batch).to(self.device)
        if self.dp == 1:
            return batch
        return rules.place_batch(self.mesh, batch.transpose(0, 1)) \
            .transpose(0, 1)

    def send(self, t, stage):
        dst = self.grid.stage_to_global_rank(stage)
        self.pending.append(p2p.send(
            t, dst, self.grid.edge_group(self.s, stage), self.device))

    def recv(self, stage):
        src = self.grid.stage_to_global_rank(stage)
        return p2p.recv(src, self.grid.edge_group(self.s, stage),
                        self.device)

    def drain(self):
        p2p.wait_all(self.pending)

    def broadcast_last(self, tree):
        """The last stage's ``tree`` on every stage."""
        last = self.grid.stage_to_global_rank(self.S - 1)
        return p2p.broadcast(tree if self.last else None, last,
                             self.grid.pipe_group.group, self.device)

    def data_mean(self, tensors):
        """Each fp32 tensor's mean over the data group, in one
        all-reduce."""
        if self.dp == 1 or not tensors:
            return tensors
        flat = torch.cat([t.reshape(-1) for t in tensors])
        flat = self.grid.data_group.all_reduce_sum(flat) / self.dp
        out, off = [], 0
        for t in tensors:
            out.append(flat[off: off + t.numel()].view_as(t))
            off += t.numel()
        return out


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ------------------------------------------------------------------ #
# the forward waves
# ------------------------------------------------------------------ #


def _forward_waves(st: _Stage, p, microbatches, M, keep_graph):
    """M + S - 1 waves: stage s forwards microbatch t - s at wave t.
    Returns (inputs, outputs) of this stage by microbatch: the inputs as
    autograd leaves where ``keep_graph`` (and not the first stage), the
    outputs with their graphs where ``keep_graph``."""
    xs, ys = [None] * M, [None] * M
    dt = None
    for t in range(M + st.S - 1):
        m = t - st.s
        if not 0 <= m < M:
            continue
        if st.first:
            x = microbatches[m]
            dt = dt or st.act_dtype(p, x)
            x = x.to(dt)
        else:
            x = st.recv(st.s - 1)
            if keep_graph:
                x = x.detach().requires_grad_(x.is_floating_point())
        with torch.set_grad_enabled(keep_graph):
            y = st.apply(p, x)
        if not st.last:
            st.send(y.detach(), st.s + 1)
        xs[m], ys[m] = x, y
    return xs, ys


def make_spmd_pipeline(stage_fn: Callable, num_stages: int,
                       micro_batches: int, mesh, remat: bool = True,
                       device=None):
    """(stage_params, microbatches) -> the last stage's outputs
    (M, mb, ...), on every rank.

    ``stage_params``: this rank's part (``stage_part``), leaves (1, ...);
    ``microbatches``: (M, mb, ...), the same on every rank. ``remat``
    changes nothing in a forward without autodiff; it is kept for the
    reference's signature."""
    _check_mesh(mesh, num_stages)
    st = _Stage(stage_fn, num_stages, mesh, device)
    M = micro_batches

    @torch.no_grad()
    def fwd(stage_params, microbatches):
        mbs = torch.as_tensor(microbatches).to(st.device)
        _, ys = _forward_waves(st, st.local(stage_params), mbs, M, False)
        st.drain()
        out = torch.stack(ys) if st.last else None
        return st.broadcast_last(out)

    return fwd


# ------------------------------------------------------------------ #
# the train step
# ------------------------------------------------------------------ #


def _grads_1f1b(st: _Stage, p, mbs, labels, loss_fn, M, stats):
    """The hand-scheduled 1F1B tick loop (module docstring). Returns the
    fp32 grads of this stage's leaves summed over its M backward slots
    (each microbatch's loss scaled 1/M) and, on the last stage, the mean
    per-microbatch loss (0 elsewhere)."""
    S, s = st.S, st.s
    nslots = 2 * S - 1
    leaves = tree_leaves(p)
    gacc = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
            for q in leaves]
    lacc = torch.zeros((), dtype=torch.float32, device=st.device)
    saved = [None] * nslots
    dt = None
    ring_bytes = 0
    for t in range(M + 2 * (S - 1)):
        m_f = t - s
        m_b = t - 2 * (S - 1) + s
        # ---- forward slot ----
        y_last = x_last = None
        if 0 <= m_f < M:
            if st.first:
                x = mbs[m_f]
                dt = dt or st.act_dtype(p, x)
                x = x.to(dt)
            else:
                x = st.recv(s - 1)
            saved[m_f % nslots] = x
            ring_bytes = max(ring_bytes, _nbytes(saved))
            if st.last:
                # this tick's backward slot is this microbatch: one
                # forward, under autograd
                x_last = x.detach().requires_grad_(
                    x.is_floating_point() and not st.first)
                with torch.enable_grad():
                    y_last = st.apply(p, x_last)
            else:
                with torch.no_grad():
                    y = st.apply(p, x)
                st.send(y, s + 1)
        # ---- backward slot ----
        if not 0 <= m_b < M:
            continue
        slot = m_b % nslots
        if st.last:
            x_b, y_b = x_last, y_last
            with torch.enable_grad():
                loss_m = loss_fn(y_b.unsqueeze(0),
                                 labels[m_b].unsqueeze(0)).float() / M
            outs, gouts = [loss_m], None
            lacc = lacc + loss_m.detach()
        else:
            x_b = saved[slot].detach().requires_grad_(
                saved[slot].is_floating_point() and not st.first)
            with torch.enable_grad():
                y_b = st.apply(p, x_b)
            dy = st.recv(s + 1)
            outs, gouts = [y_b], [dy.to(y_b.dtype)]
        wrt = leaves + ([x_b] if x_b.requires_grad else [])
        with torch.enable_grad():
            grads = torch.autograd.grad(outs, wrt, grad_outputs=gouts,
                                        allow_unused=True)
        for a, g in zip(gacc, grads):
            if g is not None:
                a.add_(g.float())
        if not st.first:
            dx = grads[len(leaves)]
            st.send(torch.zeros_like(x_b) if dx is None else dx.detach(),
                    s - 1)
        saved[slot] = None
        del outs, grads, y_b, x_b
    stats["ring_bytes"] = ring_bytes
    return gacc, lacc


def _grads_gpipe(st: _Stage, p, mbs, labels, loss_fn, M, remat, stats):
    """GPipe: the forward waves, the full-batch loss on the last stage,
    then the backward microbatch by microbatch, the input grads sent
    back. Returns (fp32 grads, loss on the last stage or 0)."""
    leaves = tree_leaves(p)
    gacc = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
            for q in leaves]
    xs, ys = _forward_waves(st, p, mbs, M, keep_graph=not remat)
    stats["saved_bytes"] = _nbytes(xs) + (0 if remat else _nbytes(ys))
    loss = torch.zeros((), dtype=torch.float32, device=st.device)
    dys = [None] * M
    if st.last:
        outs = torch.stack([y.detach() for y in ys]).requires_grad_(True)
        with torch.enable_grad():
            loss_t = loss_fn(outs, labels).float()
            (d_outs,) = torch.autograd.grad(loss_t, [outs])
        loss = loss_t.detach()
        dys = list(d_outs.unbind(0))
    for m in range(M):
        x, y = xs[m], ys[m]
        if remat:
            x = x.detach().requires_grad_(
                x.is_floating_point() and not st.first)
            with torch.enable_grad():
                y = st.apply(p, x)
        dy = dys[m] if st.last else st.recv(st.s + 1)
        wrt = leaves + ([x] if x.requires_grad else [])
        with torch.enable_grad():
            grads = torch.autograd.grad([y], wrt,
                                        grad_outputs=[dy.to(y.dtype)],
                                        allow_unused=True)
        for a, g in zip(gacc, grads):
            if g is not None:
                a.add_(g.float())
        if not st.first:
            dx = grads[len(leaves)]
            st.send(torch.zeros_like(x) if dx is None else dx.detach(),
                    st.s - 1)
        xs[m] = ys[m] = None
        del grads, y, x
    return gacc, loss


def make_spmd_pipeline_train_step(stage_fn: Callable, loss_fn: Callable,
                                  optimizer, num_stages: int,
                                  micro_batches: int, mesh,
                                  remat: bool = True, param_specs=None,
                                  schedule: Optional[str] = None,
                                  device=None):
    """The pipelined train step over PP x DP x TP (module docstring).

    ``loss_fn(outputs, labels)`` -> scalar, outputs (M, mb, ...);
    ``optimizer``: a functional optimizer of the port (``init`` /
    ``update``: ops/adam.py, ops/sgd.py, ops/lamb.py), its state built
    over this rank's part. Returns ``step(params, opt_state,
    microbatches, labels, lr) -> ((params, opt_state), loss)``: params and
    state this rank's parts, updated in place; microbatches and labels
    (M, mb, ...) whole, the same on every rank; the loss the same on
    every rank. ``step.stats`` holds the last call's ``ring_bytes``
    (1f1b: the most bytes the saved-input ring held) or
    ``saved_bytes`` (gpipe: the stage inputs, and without ``remat`` the
    outputs, kept for the backward).

    ``param_specs``: a tree like the params of spec tuples, each leading
    with ``'pipe'`` (a ``'model'`` entry cuts that dim over the model
    axis; the stage_fn completes its row-parallel sums with f/g).
    ``remat`` applies to "gpipe" only; "1f1b" always recomputes."""
    _check_mesh(mesh, num_stages)
    if schedule is None:
        # no default: 1f1b's gradients are exact only for losses that
        # decompose as a per-microbatch mean
        raise ValueError(
            "make_spmd_pipeline_train_step requires an explicit schedule: "
            "pass schedule='1f1b' (O(stages) live activations; REQUIRES "
            "loss_fn over the full (M, mb, ...) batch to equal the mean of "
            "its per-microbatch values — true for mean-reduced losses, "
            "false for sum-reduced or count-weighted/masked ones) or "
            "schedule='gpipe' (exact gradients for any loss_fn, ~M live "
            "activations).")
    assert schedule in SCHEDULES, f"unknown schedule {schedule!r}"
    if param_specs is not None:
        _check_specs(param_specs)
    st = _Stage(stage_fn, num_stages, mesh, device)
    M = micro_batches

    def step(params, opt_state, microbatches, labels, lr):
        mbs = st.rows(microbatches)
        lbl = st.rows(labels)
        # the stage's leaves as fresh autograd leaves over the same
        # storage (the update writes the params after the backward)
        p = tree_map(lambda q: q[0].detach().requires_grad_(
            q.is_floating_point()), params)
        stats = {}
        if schedule == "1f1b":
            gacc, loss = _grads_1f1b(st, p, mbs, lbl, loss_fn, M, stats)
        else:
            gacc, loss = _grads_gpipe(st, p, mbs, lbl, loss_fn, M, remat,
                                      stats)
        st.drain()
        loss, *gacc = st.data_mean([loss.reshape(1)] + gacc)
        # the loss lives on the last stage: every stage gets its value
        loss = st.grid.pipe_group.all_reduce_sum(
            loss if st.last else torch.zeros_like(loss))[0]
        it = iter(gacc)
        grads = tree_map(lambda q: next(it).to(q.dtype).unsqueeze(0),
                         params)
        with torch.no_grad():
            params, opt_state = optimizer.update(grads, opt_state, params,
                                                 lr=lr)
        step.stats = stats
        return (params, opt_state), loss

    step.stats = {}
    return step
