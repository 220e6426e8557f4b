"""Mixture-of-Experts layer with expert parallelism, in PyTorch.

Counterpart of deeperspeed_tpu/models/moe.py: GShard/Switch-style
fixed-capacity top-k routing ("dense" and "sorted" dispatch), the
MegaBlocks-style dropless dispatch, and dropless expert parallelism over
an ``expert`` mesh axis; the Switch load-balancing loss and the router
z-loss.

The reference computes one global batch under GSPMD; the port runs one
process a rank, each on its own rows (the ``data`` axis) and, along the
``expert`` axis, on the same rows with ``E/ep`` of each layer's experts
(``moe_param_specs``). Its collectives make the result the reference's:

* capacity ``ceil(k·T/E·cf)`` counts the global T, and a token's buffer
  position ranks it among every data rank's tokens, choice-major (every
  rank's choice 0 before any choice 1): one all-gather of each rank's
  ``(k, E)`` assignment counts gives the offsets, the global top-1
  fractions and the kept count;
* the aux terms take global means: one all-reduce of ``mean_prob`` and
  the z-loss, with autograd (:class:`_AllReduceMean`);
* along the expert axis, a rank computes only its own experts: the slice
  of the expert inputs and the all-gather of the expert outputs are a
  conjugate autograd pair (:class:`_Scatter`, :class:`_Gather`), so the
  dense leaves' grads (the router's included) come out whole and equal on
  every expert rank and are reduced over ``data`` only;
* dropless EP (``_moe_ffn_dropless_ep``) splits the tokens over data ×
  expert, exchanges fixed ``cap_pp`` slots with ``all_to_all_single``
  (:class:`_AllToAll`, its own adjoint), takes the router's grad summed
  over the expert group (:class:`_ExpertSum`) and ``pmean``s its aux over
  both axes.

The "dense" dispatch builds its ``(E, C, D)`` buffers by index, as
"sorted" does, not with ``(T, E, C)`` one-hot einsums (0.67 GB a layer at
the chip's size); :func:`top_k_gating` keeps the reference's one-hot
tensors, and the tests hold both to the reference's buffers. The
reference's ``ragged_dot`` becomes one matmul a contiguous expert group.
Router math and the combine accumulate in fp32. No kernel: the expert
FFNs are ``bmm``/``matmul`` and the activation is the plain tanh GeLU
after a per-expert bias, as in the reference.
"""

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..runtime.comm.reducer import _div
from ..sharding import mesh as mesh_lib
from ..sharding import rules

DATA_AXIS = mesh_lib.DATA_AXIS
EXPERT_AXIS = mesh_lib.EXPERT_AXIS


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    # capacity per expert = ceil(top_k * tokens / num_experts * cf)
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    z_loss_coef: float = 1e-3
    # "dense" | "sorted" (identical buffers and drops) | "dropless" (no
    # capacity; with a live expert axis the EP all-to-all) | "auto"
    # (sorted from 16 experts, else dense)
    dispatch_impl: str = "auto"
    # dropless EP receive slots: ep_buffer_factor * (k * T / world) rows a
    # shard; overflow drops deterministically; >= the expert axis size
    # never drops
    ep_buffer_factor: float = 2.0
    # combine weights: raw softmax probabilities (Switch), or the chosen
    # top-k renormalized to sum to 1 (GShard/Mixtral)
    normalize_gates: bool = False

    def resolved_dispatch_impl(self) -> str:
        if self.dispatch_impl != "auto":
            return self.dispatch_impl
        return "sorted" if self.num_experts >= 16 else "dense"


def init_moe_params(gen: torch.Generator, d_model: int, d_ff: int,
                    cfg: MoEConfig, out_std: Optional[float] = None,
                    device=None):
    """Expert FFN params stacked on a leading E axis, and the router: the
    reference's shapes and stds (N(0, 0.02), ``wo`` N(0, out_std), biases
    0), drawn from ``gen`` (a ``torch.Generator`` on ``device``). The
    draws differ from jax.random's; models/convert.py carries the
    reference's."""
    device = torch.device(gen.device if device is None else device)
    E, D, Fd = cfg.num_experts, d_model, d_ff
    std = 0.02
    out_std = std if out_std is None else out_std

    def norm(shape, s):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * s

    return {
        "router": {"wg": norm((D, E), std)},
        "experts": {
            "wi": norm((E, D, Fd), std),
            "bi": torch.zeros((E, Fd), dtype=torch.float32, device=device),
            "wo": norm((E, Fd, D), out_std),
            "bo": torch.zeros((E, D), dtype=torch.float32, device=device),
        },
    }


def moe_param_specs():
    """Experts sharded over the ``expert`` axis; the router replicated
    (a spec: one entry a dim, None or the axis)."""
    return {
        "router": {"wg": (None, None)},
        "experts": {
            "wi": (EXPERT_AXIS, None, None),
            "bi": (EXPERT_AXIS, None),
            "wo": (EXPERT_AXIS, None, None),
            "bo": (EXPERT_AXIS, None),
        },
    }


# ---------------------------------------------------------------------- #
# collectives with autograd
# ---------------------------------------------------------------------- #


class _AllReduceMean(torch.autograd.Function):
    """The mean over a group, replicated. The backward is the mean of the
    incoming grads over the group divided by ``replicas``, the number of
    ranks that hold one copy of the loss (the expert ranks of a data
    rank): each rank's share of the global mean's gradient, so the
    engine's mean over the data ranks gives the reference's."""

    @staticmethod
    def forward(ctx, x, transport, replicas):
        ctx.transport, ctx.replicas = transport, replicas
        return _div(transport.all_reduce_sum(x), transport.size)

    @staticmethod
    def backward(ctx, g):
        t = ctx.transport
        return (_div(t.all_reduce_sum(g.contiguous()),
                     t.size * ctx.replicas), None, None)


class _Scatter(torch.autograd.Function):
    """This rank's chunk of ``dim`` (the group holds the whole tensor);
    the backward all-gathers the chunks' grads, so the input's grad is
    whole on every rank."""

    @staticmethod
    def forward(ctx, x, transport, dim):
        ctx.transport, ctx.dim = transport, dim
        n = x.shape[dim] // transport.size
        return x.narrow(dim, transport.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.transport, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    """Every rank's chunk concatenated along ``dim``; the backward takes
    this rank's chunk of the grad (the loss downstream is the same on every
    rank of the group)."""

    @staticmethod
    def forward(ctx, x, transport, dim):
        ctx.transport, ctx.dim = transport, dim
        return _gather(x, transport, dim)

    @staticmethod
    def backward(ctx, g):
        t, dim = ctx.transport, ctx.dim
        n = g.shape[dim] // t.size
        return g.narrow(dim, t.rank * n, n).contiguous(), None, None


def _gather(x, transport, dim):
    parts = transport.all_gather(x.contiguous())  # (size, *x.shape)
    return torch.cat(parts.unbind(0), dim=dim)


class _ExpertSum(torch.autograd.Function):
    """Identity forward; the backward sums the grad over the group: a
    replicated leaf that each rank uses on its own share of the tokens."""

    @staticmethod
    def forward(ctx, x, transport):
        ctx.transport = transport
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.transport.all_reduce_sum(g.contiguous()), None


class _AllToAll(torch.autograd.Function):
    """``(size, n, ...)`` blocks: block j goes to rank j; its own adjoint."""

    @staticmethod
    def forward(ctx, x, transport):
        ctx.transport = transport
        return _all_to_all(x, transport)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.transport), None


def _all_to_all(x, transport):
    shape = x.shape
    out = transport.all_to_all(x.contiguous().reshape(shape[0], -1))
    return out.reshape(shape)


class _Groups:
    """The transports one MoE layer uses on a mesh: the data group (the
    batch axes), the expert group and the token group of dropless EP
    (data × expert)."""

    def __init__(self, mesh):
        from ..runtime.comm.collectives import Transport

        self.data_axes = rules.batch_axes(mesh)
        self.data = Transport(mesh.group(self.data_axes))
        ep_axes = (EXPERT_AXIS,) if EXPERT_AXIS in mesh.shape else ()
        self.expert = Transport(mesh.group(ep_axes))
        self.tokens = Transport(mesh.group(
            tuple(a for a in self.data_axes + ep_axes
                  if mesh.shape.get(a, 1) > 1)))
        self.ep = self.expert.size
        self.my = self.expert.rank


def groups(mesh) -> Optional[_Groups]:
    """The MoE transports of ``mesh`` (built once a mesh, on first use:
    every rank must first ask in the same order, as ``new_group`` is
    collective), or None for no mesh / one rank."""
    if mesh is None or mesh.size == 1:
        return None
    g = getattr(mesh, "_moe_groups", None)
    if g is None:
        g = mesh._moe_groups = _Groups(mesh)
    return g


# ---------------------------------------------------------------------- #
# routing
# ---------------------------------------------------------------------- #


def router_topk(logits, top_k: int, normalize_gates: bool = False):
    """Shared routing decision: (probs (T, E), expert_idx (T, k), gate
    (T, k)). Ties go to the lower expert index, as ``lax.top_k``'s."""
    probs = torch.softmax(logits.float(), dim=-1)
    gate, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    gate, expert_idx = gate[:, :top_k], expert_idx[:, :top_k]
    if normalize_gates:
        gate = gate / (gate.sum(dim=1, keepdim=True) + 1e-9)
    return probs, expert_idx, gate


def top_k_gating(logits, top_k: int, capacity: int,
                 normalize_gates: bool = False):
    """The reference's GShard-style dense routing tensors from router
    logits (T, E) fp32: (dispatch (T, E, C), combine (T, E, C), aux dict
    with ``mean_prob``, ``top1_frac`` and ``dropped_frac``). One-hot, for
    small shapes and tests: ``moe_ffn`` builds the same buffers by index."""
    T, E = logits.shape
    probs, expert_idx, gate = router_topk(logits, top_k, normalize_gates)
    mask = F.one_hot(expert_idx, E).float()  # (T, k, E)
    mask_kt = mask.transpose(0, 1).reshape(top_k * T, E)
    pos_kt = torch.cumsum(mask_kt, dim=0) - mask_kt
    pos = pos_kt.reshape(top_k, T, E).transpose(0, 1)  # (T, k, E)
    keep = (pos < capacity).float() * mask
    at = (pos * mask).sum(-1).long()  # (T, k); past capacity: no slot
    pos_c = (F.one_hot(at.clamp(max=capacity - 1), capacity).float()
             * (at < capacity).float()[..., None])
    dispatch = torch.einsum("tke,tkc->tec", keep, pos_c)
    combine = torch.einsum("tke,tkc,tk->tec", keep, pos_c, gate)
    aux = {
        "mean_prob": probs.mean(dim=0),
        "top1_frac": mask[:, 0, :].mean(dim=0),
        "dropped_frac": 1.0 - keep.sum() / (T * top_k),
    }
    return dispatch, combine, aux


def sorted_assignments(expert_idx, capacity: int, num_experts: int):
    """(token, choice) assignments sorted by expert, flattened choice-major
    before a stable sort: (order, tid, expert, pos, keep), each (k*T,),
    with the rank of each inside its expert's buffer and whether it fits
    under ``capacity`` (the dense path's drops exactly)."""
    T, k = expert_idx.shape
    e_flat = expert_idx.t().reshape(-1)
    tid_flat = torch.arange(T, device=expert_idx.device).repeat(k)
    order = torch.sort(e_flat, stable=True).indices
    e_s = e_flat[order]
    tid_s = tid_flat[order]
    starts = torch.searchsorted(
        e_s, torch.arange(num_experts, device=e_s.device))
    pos_s = torch.arange(k * T, device=e_s.device) - starts[e_s]
    keep_s = pos_s < capacity
    return order, tid_s, e_s, pos_s, keep_s


def load_balancing_loss(mean_prob, top1_frac, num_experts: int):
    """Switch Transformer eq. 4: E * sum_e me_e * ce_e (1 when uniform)."""
    return num_experts * torch.sum(mean_prob * top1_frac)


def router_z_loss(logits):
    """ST-MoE's router z-loss: mean logsumexp^2."""
    return torch.mean(torch.logsumexp(logits, dim=-1) ** 2)


def _gelu(h):
    return F.gelu(h, approximate="tanh")


def _choice_positions(expert_idx, E, grp):
    """Buffer positions of the choice-major (k*T,) assignments among every
    data rank's, and the global (k, E) counts: the reference's cumsum over
    the global batch's flattened (k, T) order. Returns (pos (k*T,), counts
    (k, E) summed over the ranks, global token count)."""
    T, k = expert_idx.shape
    mask = F.one_hot(expert_idx.t(), E)  # (k, T, E) int
    local = mask.sum(dim=1)  # (k, E)
    within = torch.cumsum(mask, dim=1) - mask  # rank inside the choice
    if grp is None or grp.data.size == 1:
        every = local[None]
        before = torch.zeros_like(local)
    else:
        every = grp.data.all_gather(local)  # (dp, k, E)
        before = every[:grp.data.rank].sum(dim=0)
    counts = every.sum(dim=0)
    # all ranks' earlier choices, then this choice on earlier ranks
    offset = torch.cumsum(counts, dim=0) - counts + before  # (k, E)
    pos = (within + offset[:, None, :]).gather(
        2, expert_idx.t()[..., None])[..., 0]  # (k, T)
    return pos.reshape(-1), counts, T * every.shape[0]


def _global_aux(probs, logits, counts, T_global, E, grp, replicas=1):
    """mean_prob and the z-loss as global means (one all-reduce with
    autograd over the data ranks), top1_frac from the global counts."""
    mean_prob = probs.mean(dim=0)
    z = router_z_loss(logits)
    if grp is not None and grp.data.size > 1:
        both = _AllReduceMean.apply(torch.cat([mean_prob, z.reshape(1)]),
                                    grp.data, replicas)
        mean_prob, z = both[:E], both[E]
    top1 = counts[0].float() / T_global
    return mean_prob, z, top1


# ---------------------------------------------------------------------- #
# the FFNs
# ---------------------------------------------------------------------- #


def _expert_ffn(expert_in, ex, dtype):
    """(e, C, D) buffers through each expert's FFN, in ``dtype``."""
    h = torch.bmm(expert_in, ex["wi"].to(dtype))
    h = _gelu(h + ex["bi"].to(dtype)[:, None, :])
    eo = torch.bmm(h, ex["wo"].to(dtype))
    return eo + ex["bo"].to(dtype)[:, None, :]


def _grouped_ffn(xs, sizes, ex, dtype):
    """Rows sorted by expert (``sizes`` a group, leading groups only)
    through their experts' FFNs: one matmul a contiguous group, the
    reference's ``ragged_dot``."""
    outs, start = [], 0
    for e, n in enumerate(sizes):
        if not n:
            continue
        rows = xs[start:start + n]
        h = _gelu(rows @ ex["wi"][e].to(dtype) + ex["bi"][e].to(dtype))
        outs.append(h @ ex["wo"][e].to(dtype) + ex["bo"][e].to(dtype))
        start += n
    if start < xs.shape[0]:  # the padding group: zero weights, zero rows
        outs.append(xs.new_zeros((xs.shape[0] - start, xs.shape[1])))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _local_experts(params, cfg, grp):
    """This rank's expert params and the expert transport (None when the
    rank holds all E)."""
    ex = params["experts"]
    e_here = ex["wi"].shape[0]
    if e_here == cfg.num_experts:
        return ex, None
    if grp is None or grp.ep * e_here != cfg.num_experts:
        raise ValueError(
            f"the params hold {e_here} of {cfg.num_experts} experts; the "
            f"mesh's expert axis must split them "
            f"({'no mesh' if grp is None else f'ep {grp.ep}'})")
    return ex, grp.expert


def _moe_ffn_dropless(params, x, cfg: MoEConfig, logits, grp):
    """MegaBlocks-style dropless dispatch: every assignment, sorted by
    expert, through one matmul a group; no capacity, no drops."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    probs, expert_idx, gate = router_topk(logits, k, cfg.normalize_gates)
    order, tid_s, e_s, _, _ = sorted_assignments(expert_idx, k * T, E)
    gate_s = gate.t().reshape(-1)[order]
    ex, ep_t = _local_experts(params, cfg, grp)
    if ep_t is not None:
        raise ValueError("dropless dispatch over a live expert axis takes "
                         "the EP path (moe_ffn)")
    sizes = torch.bincount(e_s, minlength=E).tolist()
    eo = _grouped_ffn(xt[tid_s], sizes, ex, x.dtype)
    contrib = (eo * gate_s.to(x.dtype)[:, None]).float()
    # back to choice-major order: the k terms of a token sum in a fixed
    # order (fp32)
    y = torch.empty_like(contrib).index_copy(0, order, contrib)
    y = y.reshape(k, T, D).sum(dim=0).to(x.dtype).reshape(B, S, D)
    _, counts, T_global = _choice_positions(expert_idx, E, grp)
    mean_prob, z, top1 = _global_aux(probs, logits, counts, T_global, E, grp)
    aux = {"aux_loss": load_balancing_loss(mean_prob, top1, E),
           "z_loss": z,
           "dropped_frac": torch.zeros((), dtype=torch.float32,
                                       device=x.device)}
    return y, aux


def _moe_ffn_dropless_ep(params, x, cfg: MoEConfig, grp):
    """Dropless dispatch with expert parallelism: the data rank's tokens
    split over its expert ranks (``t_loc = T/world`` of the reference's
    global T, the same chunks), each chunk's assignments sorted by global
    expert id and packed into ``cap_pp`` slots a destination, exchanged
    with an all-to-all, run through the rank's experts, and brought home by
    the reverse exchange. ``ep_buffer_factor >= ep`` never drops."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = B * S
    ep, my = grp.ep, grp.my
    world = grp.tokens.size
    if E % ep:
        raise ValueError(f"num_experts {E} not divisible by expert axis {ep}")
    e_loc = E // ep
    if (T * grp.data.size) % world:
        raise ValueError(f"tokens {T * grp.data.size} not divisible by mesh "
                         f"world {world}")
    t_loc = T // ep
    cap_pp = max(1, int(math.ceil(cfg.ep_buffer_factor * k * t_loc / ep)))
    cap = ep * cap_pp
    ex, _ = _local_experts(params, cfg, grp)

    xt = _Scatter.apply(x.reshape(T, D), grp.expert, 0)  # (t_loc, D)
    wg = _ExpertSum.apply(params["router"]["wg"], grp.expert)
    logits = xt.float() @ wg.float()
    probs, expert_idx, gate = router_topk(logits, k, cfg.normalize_gates)
    e_flat = expert_idx.t().reshape(-1)
    tid = torch.arange(t_loc, device=x.device).repeat(k)
    order = torch.sort(e_flat, stable=True).indices
    e_s, tid_s = e_flat[order], tid[order]
    gate_s = gate.t().reshape(-1)[order]
    dest = torch.div(e_s, e_loc, rounding_mode="floor")
    starts = torch.searchsorted(
        e_s, torch.arange(ep, device=x.device) * e_loc)
    pos = torch.arange(k * t_loc, device=x.device) - starts[dest]
    ok = pos < cap_pp
    dropped = (~ok).sum().float()
    slot = torch.where(ok, dest * cap_pp + pos, torch.full_like(pos, cap))

    sendx = xt.new_zeros((cap + 1, D)).index_copy(0, slot, xt[tid_s])[:cap]
    sende = torch.full((cap + 1,), E, dtype=torch.int64,
                       device=x.device).index_copy(0, slot, e_s)[:cap]
    x_recv = _AllToAll.apply(sendx.reshape(ep, cap_pp, D),
                             grp.expert).reshape(cap, D)
    e_recv = _all_to_all(sende.reshape(ep, cap_pp), grp.expert).reshape(cap)

    # group the received rows by local expert; empty slots sort last
    e_local = torch.where(e_recv >= E, torch.full_like(e_recv, e_loc),
                          e_recv - my * e_loc)
    order2 = torch.sort(e_local, stable=True).indices
    sizes = torch.bincount(e_local, minlength=e_loc + 1).tolist()[:e_loc]
    eo2 = _grouped_ffn(x_recv[order2], sizes, ex, x.dtype)
    eo = torch.empty_like(eo2).index_copy(0, order2, eo2)  # receive order
    eo_home = _AllToAll.apply(eo.reshape(ep, cap_pp, D),
                              grp.expert).reshape(cap, D)

    # fp32 combine at home; dropped assignments contribute zero
    eo_s = eo_home[slot.clamp(0, cap - 1)]
    contrib = eo_s.float() * (gate_s.float() * ok.float())[:, None]
    yt = torch.empty_like(contrib).index_copy(0, order, contrib)
    yt = yt.reshape(k, t_loc, D).sum(dim=0).to(x.dtype)
    y = _Gather.apply(yt, grp.expert, 0).reshape(B, S, D)

    top1 = torch.bincount(expert_idx[:, 0], minlength=E).float() / t_loc
    local = torch.cat([probs.mean(dim=0), top1,
                       (dropped / (k * t_loc)).reshape(1),
                       router_z_loss(logits).reshape(1)])
    # pmean over data x expert; the loss is replicated over the ep ranks
    # of a data rank
    both = _AllReduceMean.apply(local, grp.tokens, ep)
    aux = {"aux_loss": load_balancing_loss(both[:E], both[E:2 * E], E),
           "z_loss": both[2 * E + 1],
           "dropped_frac": both[2 * E].detach()}
    return y, aux


def expert_buffers(xt, expert_idx, pos, capacity: int, num_experts: int,
                   impl: str = "dense"):
    """The (E, C, D) expert input buffers of ``xt`` (T, D): assignment
    (choice c, token t) at its buffer position ``pos`` (choice-major,
    (k*T,)) if below ``capacity``. "sorted" scatter-adds in expert order
    as the reference's sorted path does (a dropped row adds zero at its
    expert's last slot); "dense" writes the kept rows by index, the same
    buffers as the reference's one-hot ``einsum("tec,td->ecd")``."""
    T, D = xt.shape
    k = expert_idx.shape[1]
    E = num_experts
    keep = pos < capacity
    slot = expert_idx.t().reshape(-1) * capacity + pos.clamp(
        max=capacity - 1)
    if impl == "sorted":
        order, tid_s, _, _, _ = sorted_assignments(expert_idx, T, E)
        contrib = xt[tid_s] * keep[order].to(xt.dtype)[:, None]
        buf = xt.new_zeros((E * capacity, D)).index_add(
            0, slot[order], contrib)
    else:
        # a slot holds at most one token
        kept = keep.nonzero()[:, 0]
        tid = torch.arange(T, device=xt.device).repeat(k)
        buf = xt.new_zeros((E * capacity, D)).index_copy(
            0, slot[kept], xt[tid[kept]])
    return buf.reshape(E, capacity, D)


def _live_expert_axis(mesh) -> bool:
    return (mesh is not None and EXPERT_AXIS in mesh.shape
            and mesh.shape[EXPERT_AXIS] > 1)


def moe_ffn(params, x, cfg: MoEConfig, mesh=None, activation=None):
    """Drop-in MoE replacement for a dense FFN block: (y (B, S, D), aux
    with ``aux_loss``, ``z_loss`` and ``dropped_frac``). ``x`` holds this
    rank's rows; ``mesh`` (default: the engine's ``active_mesh``) gives
    the data and expert groups. ``activation`` must be None: the
    reference's tanh GeLU."""
    if activation is not None:
        raise NotImplementedError("moe_ffn takes the reference's default "
                                  "activation (tanh GeLU) only")
    mesh = mesh if mesh is not None else mesh_lib.active_mesh()
    grp = groups(mesh)
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = B * S

    impl = cfg.resolved_dispatch_impl()
    if impl == "dropless" and _live_expert_axis(mesh):
        return _moe_ffn_dropless_ep(params, x, cfg, grp)

    xt = x.reshape(T, D)
    logits = xt.float() @ params["router"]["wg"].float()  # (T, E)
    if impl == "dropless":
        return _moe_ffn_dropless(params, x, cfg, logits, grp)
    if impl not in ("dense", "sorted"):
        raise ValueError(f"unknown moe dispatch_impl {cfg.dispatch_impl!r}")

    probs, expert_idx, gate = router_topk(logits, k, cfg.normalize_gates)
    pos, counts, T_global = _choice_positions(expert_idx, E, grp)
    # k*T assignments over E buffers of the GLOBAL batch
    capacity = max(1, math.ceil(k * T_global / E * cfg.capacity_factor))
    keep = pos < capacity
    slot = expert_idx.t().reshape(-1) * capacity + pos.clamp(
        max=capacity - 1)
    expert_in = expert_buffers(xt, expert_idx, pos, capacity, E, impl)

    ex, ep_t = _local_experts(params, cfg, grp)
    if ep_t is not None:
        expert_in = _Scatter.apply(expert_in, ep_t, 0)
    eo = _expert_ffn(expert_in, ex, x.dtype)
    if ep_t is not None:
        eo = _Gather.apply(eo, ep_t, 0)
    eo = eo.reshape(E * capacity, D)

    gate_cm = gate.t().reshape(-1)
    if impl == "sorted":
        w = (gate_cm * keep).to(x.dtype)[:, None]
        contrib = (eo[slot] * w).float()
    else:
        # the combine einsum: bf16 operands, fp32 accumulation
        contrib = eo[slot].float() * (gate_cm.to(x.dtype).float()
                                      * keep.float())[:, None]
    y = contrib.reshape(k, T, D).sum(dim=0).to(x.dtype).reshape(B, S, D)

    mean_prob, z, top1 = _global_aux(probs, logits, counts, T_global, E, grp)
    kept_total = torch.clamp(counts.sum(dim=0), max=capacity).sum()
    aux = {
        "aux_loss": load_balancing_loss(mean_prob, top1, E),
        "z_loss": z,
        "dropped_frac": 1.0 - kept_total.float() / (T_global * k),
    }
    return y, aux


def moe_loss(aux, cfg: MoEConfig):
    """Total auxiliary loss term for one (or summed) moe_ffn aux dicts."""
    return cfg.aux_loss_coef * aux["aux_loss"] + cfg.z_loss_coef * aux["z_loss"]
