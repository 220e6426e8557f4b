"""GradReducer: bucketed, quantized gradient collectives.

Counterpart of deeperspeed_tpu/runtime/comm/reducer.py. Each rank holds
its LOCAL gradients (the sum over its micro-batches); the reducer flattens
them into size-bounded buckets in the reference's leaf order
(:mod:`.bucketing`) and reduces each bucket to the mean over the
data-parallel ranks under one wire format:

* ``fp32``: all-reduce and divide by the world size;
* ``bf16``: all-reduce of the bf16-rounded values, with error feedback;
* ``int8``: the two-phase schedule. Each rank quantizes its bucket in
  W chunks (``quantize_rows``, blocks of ``block`` values with fp32
  scales, the residual from the same pass), ships chunk j to rank j in
  one packed payload (``all_to_all``), sums the W received chunks
  (``dequant_sum_rows``), re-quantizes its partial sum
  (``quantize_rows``) and all-gathers it; every rank then rebuilds the
  mean (``dequant_rows``, divisor W). With error feedback, two kernels
  of ``quantize_rows``, one of ``dequant_sum_rows`` and one of
  ``dequant_rows`` per bucket and step;
* ``compressed``: fp16 mantissas with per-block int8 exponents, all-gathered
  and summed as ``dequant_sum_rows`` with scales 2^e (exact);
* ``lossless``: every rank's exact fp32 bytes, gathered as byte planes and
  summed in the fixed pairwise tree.

The ``hierarchical`` schedule (int8 and lossless, hosts of ``k`` ranks)
reduce-scatters in fp32 inside a host, gathers the quantized (or
byte-plane) partial sums across hosts, and all-gathers the re-quantized
result inside the host. Lossy modes keep per-rank error-feedback residuals:
the quantization error of step t is added back to the gradient at step t+1.

The wire math goes through the ``fused_quant`` kernels
(ops/fused_quant.py, csrc/fused_quant.cu) when the "kernels" block routes
that surface (mode fused, or auto on a Hopper card), otherwise through
their plain versions: the same packed payloads and the same numbers, bit
for bit, as the reference's XLA route. Collectives run on the process group
the mesh gives, over :class:`.collectives.Transport` (gloo on a CUDA
tensor goes through pinned host buffers).

Each bucket is one eager dispatch inside a ``comm/reduce`` span of the
port's tracer (the reference's ``reduce_dispatch``), or, under the
backward-overlap schedule (runtime/comm/overlap.py), a launch onto the
scheduler's comm thread (``launch_bucket``); with a metrics
registry (the monitor's) each bucket bumps the reference's
``comm_buckets`` and ``comm_wire_bytes`` counters.

The elastic **canonical-slot** mode (``canonical=C``,
``elasticity.canonical_shards``) reduces C fixed slots instead of the
ranks (:meth:`GradReducer.reduce_canonical`): each rank owns C/W slots,
runs the wire math on each slot's row with per-slot error feedback
(``quantize_rows`` and ``dequant_rows`` under int8), all-gathers the
dequantized fp32 rows (exact bit transport on any wire) and sums them in
the fixed pairwise tree locally, so the mean is bit-identical at every
admissible world size, world 1 included. Residuals are (C, n), free of the
world size; each rank keeps its rows. :func:`exact_slot_mean` is the same
gather and tree without a wire.

The **transform-only** path (``init_transform_state``,
``transform_dispatch``) runs a bucket's wire format without a
collective: quantize -> dequantize with error feedback on a grad tree
that is already reduced. The pipeline engine (runtime/pipe/engine.py)
takes a stage's data-parallel mean in fp32 and then routes it through
this path under a ``"comm"`` block, as the reference does after its
GSPMD mean, so every data rank of a stage applies the same transform and
keeps the same residuals.

Not ported: the jitted whole-tree ``reduce_stacked``.
"""

import logging
from typing import Dict, List, Optional, Tuple

import torch

from ...distributed import topology as dist_topology
from ...monitor.tracer import trace_span
from ...ops import fused_quant
from ...sharding import rules
from . import bucketing
from .collectives import Transport
from .compressed import _compress_blocks, _decompress_blocks
from .config import CommConfig

logger = logging.getLogger(__name__)


def _div(t: torch.Tensor, divisor) -> torch.Tensor:
    """``t / divisor`` as a true fp32 division on every device (PyTorch's
    CUDA division by a Python number multiplies by its reciprocal)."""
    return t / torch.full((), float(divisor), dtype=torch.float32,
                          device=t.device)


def pairwise_slot_sum(x: torch.Tensor) -> torch.Tensor:
    """Graph-fixed pairwise tree sum over the leading axis: the grouping of
    adds depends only on ``x.shape[0]``. An odd remainder folds into slot 0
    before each halving."""
    c = x.shape[0]
    while c > 1:
        if c % 2:
            x = torch.cat([x[:1] + x[c - 1:c], x[1:c - 1]], dim=0)
            c -= 1
        x = x[0::2] + x[1::2]
        c //= 2
    return x[0]


def exact_slot_mean(rows: torch.Tensor, transport: Transport,
                    canonical: int) -> torch.Tensor:
    """Layout-invariant mean over the slot axis. ``rows`` are this rank's
    consecutive slots ``(C/W, ...)`` of C; every rank's rows are
    all-gathered (exact bit transport) and summed in the graph-fixed
    pairwise tree locally, so the result is the same bits on any process
    layout, world 1 included."""
    gathered = transport.all_gather(rows)  # (W, C/W, ...)
    full = gathered.reshape((canonical,) + tuple(rows.shape[1:]))
    return _div(pairwise_slot_sum(full), canonical)


def _to_byte_planes(x: torch.Tensor) -> torch.Tensor:
    """(L,) fp32 -> (4, L) int8 byte planes (each element's sign/exponent
    byte lands contiguous on the wire)."""
    return x.contiguous().view(torch.int8).reshape(-1, 4).t().contiguous()


def _from_byte_planes(planes: torch.Tensor) -> torch.Tensor:
    """(..., 4, L) int8 byte planes -> (..., L) fp32, bit-exact."""
    return planes.transpose(-1, -2).contiguous().view(
        torch.float32).squeeze(-1)


class GradReducer:
    """Bucketed gradient reduction over the batch axes of a mesh
    (``rules.batch_axes``).

    Built once per engine; owns the :class:`~.bucketing.BucketPlan` and
    the rank's error-feedback residuals (a list over buckets of dicts of
    fp32 tensors: this rank's (n,) row of the reference's (world, n)
    state, or in canonical mode its (C/W, n) rows of the (C, n) state)."""

    def __init__(self, config: CommConfig, mesh, registry=None,
                 canonical: int = 0):
        self.cfg = config
        self.mesh = mesh
        axes = self.axes = rules.batch_axes(mesh)
        self.world = mesh.axis_size(axes)
        self.rank = mesh.axis_index(axes)
        self.transport = Transport(mesh.group(axes))
        self.plan: Optional[bucketing.BucketPlan] = None
        # canonical-slot mode (elastic training): residuals and reduction
        # math are keyed to C fixed slots instead of the world size, so
        # checkpointed state is valid on any world size
        self.canonical = int(canonical or 0)
        if self.canonical and self.canonical % self.world:
            raise ValueError(
                f"canonical_shards={self.canonical} must be a multiple of "
                f"the data-parallel size {self.world}")
        self.hier_k = self._resolve_hierarchy()
        if self.canonical and self.hier_k:
            logger.warning(
                "comm: hierarchical schedule is incompatible with the "
                "canonical-slot elastic mode (per-group residuals are "
                "world-size-shaped); using the flat schedule")
            self.hier_k = None
        self._intra = self._inter = None
        if self.hier_k:
            ranks = mesh.ranks_along(axes)
            intra, inter = dist_topology.intra_inter_split(self.world,
                                                           self.hier_k)
            self._intra = Transport(mesh.subgroups(
                [[ranks[i] for i in g] for g in intra]))
            self._inter = Transport(mesh.subgroups(
                [[ranks[i] for i in g] for g in inter]))
        self._c_buckets = self._c_wire = None
        if registry is not None:
            self._c_buckets = registry.counter(
                "comm_buckets", "gradient buckets reduced")
            self._c_wire = registry.counter(
                "comm_wire_bytes", "modeled per-device bytes on the wire")

    # ------------------------------------------------------------------ #
    # setup
    # ------------------------------------------------------------------ #

    def _resolve_hierarchy(self) -> Optional[int]:
        cfg = self.cfg
        if cfg.hierarchical == "off":
            return None
        k = cfg.intra_size
        if k is None:
            k = dist_topology.derive_intra_size(self.mesh, self.axes)
            if k is None:
                # one host (or no equal host blocks): nothing to split
                if cfg.hierarchical == "on":
                    logger.warning(
                        "comm: hierarchical schedule found no host blocks "
                        "among %d ranks; using the flat schedule",
                        self.world)
                return None
        k = int(k)
        if not (1 < k < self.world) or self.world % k:
            logger.warning(
                "comm: hierarchical schedule needs 1 < intra_size < world "
                "with intra_size | world (got intra_size=%d, world=%d); "
                "falling back to the flat schedule", k, self.world)
            return None
        if cfg.mode not in ("int8", "lossless"):
            logger.warning(
                'comm: hierarchical schedule applies to modes "int8" and '
                '"lossless" only (got "%s"); using the flat schedule',
                cfg.mode)
            return None
        return k

    def build_plan(self, tree) -> bucketing.BucketPlan:
        """Plan buckets from the parameter/grad tree."""
        if self.canonical:
            # world-free layout: bucket lengths (and so residual shapes and
            # the plan fingerprint) must not change with the world size
            self.plan = bucketing.build_plan(tree, self.cfg.bucket_bytes,
                                             self.cfg.block)
            return self.plan
        pad_to = self.cfg.block * (self.world if self.world > 1 else 1)
        self.plan = bucketing.build_plan(tree, self.cfg.bucket_bytes, pad_to)
        return self.plan

    @property
    def n_buckets(self) -> int:
        return len(self.plan.buckets)

    def _residual_shapes(self, b: bucketing.Bucket) -> Dict[str, int]:
        """This rank's residual lengths for bucket ``b``."""
        L = b.padded
        if self.canonical:
            # per-SLOT single-phase residuals, C rows whatever the world
            # size (world 1 included, so any tag restores at any world)
            return ({} if self.cfg.mode in ("fp32", "lossless")
                    else {"e": L})
        if self.world == 1 or self.cfg.mode in ("fp32", "lossless"):
            return {}  # lossless: exact transport, nothing to feed back
        if self.cfg.mode in ("bf16", "compressed"):
            return {"e": L}
        if self.hier_k:  # int8 hierarchical: both phases act on L/k chunks
            return {"e1": L // self.hier_k, "e2": L // self.hier_k}
        return {"e": L, "e2": L // self.world}  # int8 flat two-phase

    @property
    def local_slots(self) -> int:
        """Canonical slots this rank owns (C/W); 0 outside the mode."""
        return self.canonical // self.world if self.canonical else 0

    def init_state(self, device) -> List[Dict[str, torch.Tensor]]:
        """Zero residuals for this rank, one dict per bucket: (n,) rows,
        or (C/W, n) in canonical mode."""
        lead = (self.local_slots,) if self.canonical else ()
        return [{k: torch.zeros(lead + (n,), dtype=torch.float32,
                                device=device)
                 for k, n in self._residual_shapes(b).items()}
                for b in self.plan.buckets]

    def state_fingerprint(self) -> Tuple:
        """Identity of (layout, mode, world): residuals restored from a
        checkpoint with another fingerprint are dropped (or, when only the
        world size differs and a compatible plan rode along, resharded by
        resilience/reshard.py). The canonical mode replaces the world
        term with ``("canonical", C)`` so residuals match verbatim across
        world sizes."""
        world_term = (("canonical", self.canonical) if self.canonical
                      else self.world)
        return (self.cfg.mode, world_term, self.hier_k or 0, self.cfg.block,
                self.plan.fingerprint())

    def plan_summary(self) -> Dict:
        """JSON-serializable layout descriptor saved next to checkpointed
        residuals."""
        return {
            "mode": self.cfg.mode,
            "world": self.world,
            "axes": list(self.axes),
            "block": self.cfg.block,
            "hier_k": self.hier_k or 0,
            "canonical": self.canonical,
            "error_feedback": bool(self.cfg.error_feedback),
            "bucket_lengths": [b.length for b in self.plan.buckets],
            "bucket_padded": [b.padded for b in self.plan.buckets],
        }

    # ------------------------------------------------------------------ #
    # the wire math: kernel wrappers or their plain versions
    # ------------------------------------------------------------------ #

    def _ops(self, device):
        if fused_quant.routing(device):
            return (fused_quant.quantize_rows, fused_quant.dequant_sum_rows,
                    fused_quant.dequant_rows)
        return (fused_quant.quantize_rows_plain,
                fused_quant.dequant_sum_rows_plain,
                fused_quant.dequant_rows_plain)

    # ------------------------------------------------------------------ #
    # per-bucket wire formats (this rank's (L,) fp32 contribution)
    # ------------------------------------------------------------------ #

    def _reduce_flat(self, v, res):
        """One bucket: this rank's (L,) fp32 contribution -> the mean over
        the ranks, bit-identical on every rank. Returns ``(mean,
        new_residuals)``."""
        cfg, W = self.cfg, self.world
        if W == 1:
            return v, res
        ef = cfg.error_feedback
        if cfg.mode == "fp32":
            return _div(self.transport.all_reduce_sum(v), W), res
        if cfg.mode == "bf16":
            c = v + res["e"] if ef else v
            sent = c.to(torch.bfloat16)
            out = _div(self.transport.all_reduce_sum(sent).float(), W)
            return out, {"e": c - sent.float() if ef else res["e"]}
        if cfg.mode == "compressed":
            return self._reduce_compressed_flat(v, res)
        if cfg.mode == "lossless":
            if self.hier_k:
                return self._reduce_lossless_hier(v, res)
            return self._reduce_lossless_flat(v, res)
        if self.hier_k:
            return self._reduce_int8_hier(v, res)
        return self._reduce_int8_flat(v, res)

    def _reduce_compressed_flat(self, v, res):
        """24-bit block-exponent gather: compress -> all_gather of one
        packed payload (mantissa bytes and the exponent) -> the sum of the
        W contributions as one dequant-accumulate with scales 2^e."""
        W, block = self.world, self.cfg.block
        ef = self.cfg.error_feedback
        L = v.shape[0]
        nb = L // block
        c = v + res["e"] if ef else v
        m, e = _compress_blocks(c, block)  # (nb, block) f16, (nb,) s8
        new_e = c - _decompress_blocks(m, e, L) if ef else res["e"]
        payload = torch.cat([m.contiguous().view(torch.int8),
                             e[:, None]], dim=1)  # (nb, 2*block + 1) int8
        g = self.transport.all_gather(payload)  # (W, nb, 2*block + 1)
        gm = g[:, :, :2 * block].contiguous().view(torch.float16)
        scales = torch.exp2(g[:, :, -1].float())  # exact 2^e
        _, dsum, _ = self._ops(v.device)
        total = dsum(gm.reshape(W, L), scales, block)
        return _div(total, W), {"e": new_e}

    def _reduce_int8_flat(self, v, res):
        """Two-phase int8: quantize in W chunks -> all_to_all -> exact
        partial sum of my chunk -> re-quantize -> all_gather -> rebuild.
        Scales ride bitcast in the value payload: one collective a phase."""
        W, block = self.world, self.cfg.block
        ef = self.cfg.error_feedback
        quant, dsum, deq = self._ops(v.device)
        L = v.shape[0]
        chunk = L // W
        c = v + res["e"] if ef else v
        q, s, r = quant(c.reshape(W, chunk), block, want_residual=ef)
        new_e = r.reshape(-1) if ef else res["e"]
        # chunk j of every rank's contribution to rank j
        rwire = self.transport.all_to_all(fused_quant.pack_wire(q, s))
        rq, rs = fused_quant.unpack_wire(rwire, chunk, block)
        ssum = dsum(rq, rs, block)
        c2 = ssum + res["e2"] if ef else ssum
        q2, s2, r2 = quant(c2.reshape(1, chunk), block, want_residual=ef)
        new_e2 = r2.reshape(-1) if ef else res["e2"]
        gwire = self.transport.all_gather(
            fused_quant.pack_wire(q2, s2).reshape(-1))  # (W, chunk + 4bpc)
        gq, gs = fused_quant.unpack_wire(gwire, chunk, block)
        out = deq(gq, gs, block, W).reshape(-1)
        return out, {"e": new_e, "e2": new_e2}

    def _reduce_int8_hier(self, v, res):
        """Two-level int8: intra-host fp32 reduce-scatter, int8 all_gather
        across hosts, int8 all_gather rebuild inside the host. Both
        quantizations carry their own residual."""
        W, block = self.world, self.cfg.block
        ef = self.cfg.error_feedback
        quant, dsum, deq = self._ops(v.device)
        chunk = self._intra.reduce_scatter_sum(v)
        c1 = chunk + res["e1"] if ef else chunk
        L1 = c1.shape[0]
        q, s, r = quant(c1.reshape(1, L1), block, want_residual=ef)
        new_e1 = r.reshape(-1) if ef else res["e1"]
        gw = self._inter.all_gather(fused_quant.pack_wire(q, s).reshape(-1))
        gq, gs = fused_quant.unpack_wire(gw, L1, block)  # (nn, L1)
        gsum = dsum(gq, gs, block)
        c2 = gsum + res["e2"] if ef else gsum
        q2, s2, r2 = quant(c2.reshape(1, L1), block, want_residual=ef)
        new_e2 = r2.reshape(-1) if ef else res["e2"]
        fw = self._intra.all_gather(fused_quant.pack_wire(q2, s2).reshape(-1))
        fq, fs = fused_quant.unpack_wire(fw, L1, block)  # (k, L1)
        out = deq(fq, fs, block, W).reshape(-1)
        return out, {"e1": new_e1, "e2": new_e2}

    def _reduce_lossless_flat(self, v, res):
        """Every rank's exact fp32 contribution as byte planes, gathered,
        reassembled bit for bit and summed in the pairwise tree."""
        g = self.transport.all_gather(_to_byte_planes(v))  # (W, 4, L)
        return _div(pairwise_slot_sum(_from_byte_planes(g)), self.world), res

    def _reduce_lossless_hier(self, v, res):
        """Intra-host fp32 reduce-scatter, byte-plane all_gather and the
        pairwise tree across hosts, fp32 all_gather inside the host."""
        chunk = self._intra.reduce_scatter_sum(v)
        g = self._inter.all_gather(_to_byte_planes(chunk))  # (nn, 4, L/k)
        total = _div(pairwise_slot_sum(_from_byte_planes(g)), self.world)
        return self._intra.all_gather(total).reshape(-1), res

    # ------------------------------------------------------------------ #
    # wire model
    # ------------------------------------------------------------------ #

    def bucket_wire_bytes(self, b: bucketing.Bucket) -> int:
        """Modeled per-rank bytes on the wire for one bucket (ring
        all-reduce 2(W-1)/W x result, gather/scatter/all-to-all (W-1)/W x
        result), the reference's model."""
        W = self.world
        if W == 1:
            return 0
        f = (W - 1) / W
        L = b.padded
        nb = L // self.cfg.block
        mode = self.cfg.mode
        if mode == "fp32":
            return int(2 * f * 4 * L)
        if mode == "bf16":
            return int(2 * f * 2 * L)
        if mode == "compressed":
            return int(f * (2 * L * W + nb * W))
        if mode == "lossless":
            if self.hier_k:
                k, nn = self.hier_k, W // self.hier_k
                return int(f * (4 * L // k + nn * 4 * (L // k) + 4 * L))
            return int(f * 4 * L * W)
        if self.hier_k:
            k, nn = self.hier_k, W // self.hier_k
            nb1 = (L // k) // self.cfg.block
            return int(f * (4 * L // k + nn * (L // k) + 4 * nn * nb1
                            + L + 4 * k * nb1))
        return int(2 * f * (L + 4 * nb))

    def total_wire_bytes(self) -> int:
        return sum(self.bucket_wire_bytes(b) for b in self.plan.buckets)

    # ------------------------------------------------------------------ #
    # per-bucket dispatch
    # ------------------------------------------------------------------ #

    def _reduce_bucket(self, j, bucket_leaves, res):
        """Bucket ``j``'s wire math on its leaves (the plan's order):
        ``(reduced fp32 leaves, new residuals)``."""
        b = self.plan.buckets[j]
        red, nr = self._reduce_flat(bucketing.pack(b, bucket_leaves), res)
        return bucketing.unpack(b, red), nr

    def _count(self, wire):
        if self._c_buckets is not None:
            self._c_buckets.inc()
            self._c_wire.inc(wire)

    def launch_bucket(self, j, bucket_leaves, res, scheduler):
        """Hand bucket ``j`` to the overlap ``scheduler``'s comm thread
        (runtime/comm/overlap.py) and return its Future of ``(reduced
        leaves, new residuals)``; the ``comm/reduce`` span records the
        launch (``overlapped: true``)."""
        b = self.plan.buckets[j]
        wire = self.bucket_wire_bytes(b)
        with trace_span("comm/reduce", lane="comm", bucket=j,
                        mode=self.cfg.mode, elements=b.length,
                        wire_bytes=wire, overlapped=True):
            fut = scheduler.submit(self._reduce_bucket, j,
                                   list(bucket_leaves), res)
        scheduler.note(fut, 1)
        self._count(wire)
        return fut

    def reduce_dispatch(self, tree, state, overlap=None):
        """Reduce this rank's local gradient tree bucket by bucket, each
        dispatch in a ``comm/reduce`` span. Returns ``(mean tree (fp32, the
        caller's key order), new_state)``; the mean is bit-identical on
        every rank. With ``overlap`` (an ``OverlapScheduler``) every bucket
        is launched on its comm thread first and the results are taken
        after its drain: the same bits."""
        leaves, unflatten = bucketing.tree_flatten_sorted(tree)
        if len(leaves) != self.plan.n_leaves:
            raise ValueError(
                f"grad tree has {len(leaves)} leaves but the bucket plan "
                f"was built for {self.plan.n_leaves}")
        if overlap is not None:
            futs = [self.launch_bucket(j, [leaves[i] for i in b.leaf_ids],
                                       state[j], overlap)
                    for j, b in enumerate(self.plan.buckets)]
            overlap.drain()
            return self.collect(futs, unflatten)
        outs = [None] * self.plan.n_leaves
        new_state = []
        for j, b in enumerate(self.plan.buckets):
            wire = self.bucket_wire_bytes(b)
            with trace_span("comm/reduce", lane="comm", bucket=j,
                            mode=self.cfg.mode, elements=b.length,
                            wire_bytes=wire, overlapped=False):
                red, nr = self._reduce_bucket(
                    j, [leaves[i] for i in b.leaf_ids], state[j])
            for i, leaf in zip(b.leaf_ids, red):
                outs[i] = leaf
            new_state.append(nr)
            self._count(wire)
        return unflatten(outs), new_state

    def collect(self, futures, unflatten):
        """The mean tree and new residuals from the drained Futures of
        :meth:`launch_bucket`, one a bucket in plan order."""
        outs = [None] * self.plan.n_leaves
        new_state = []
        for b, fut in zip(self.plan.buckets, futures):
            red, nr = fut.result()
            for i, leaf in zip(b.leaf_ids, red):
                outs[i] = leaf
            new_state.append(nr)
        return unflatten(outs), new_state

    # ------------------------------------------------------------------ #
    # transform-only path (the pipeline engine's stage grads)
    # ------------------------------------------------------------------ #

    def _transform_flat(self, v, res):
        """One bucket's wire format on an already reduced (L,) fp32 flat,
        no collective: quantize -> dequantize, the error fed back."""
        cfg = self.cfg
        ef = cfg.error_feedback
        if cfg.mode in ("fp32", "lossless"):
            return v, res  # exact wire formats: the identity
        c = v + res["e"] if ef else v
        if cfg.mode == "bf16":
            out = c.to(torch.bfloat16).float()
        elif cfg.mode == "compressed":
            m, e = _compress_blocks(c, cfg.block)
            out = _decompress_blocks(m, e, v.shape[0])
        else:  # int8
            quant, _, deq = self._ops(v.device)
            q, sc, _ = quant(c.reshape(1, -1), cfg.block,
                             want_residual=False)
            out = deq(q, sc, cfg.block, 1.0).reshape(-1)
        return out, {"e": c - out if ef else res["e"]}

    def init_transform_state(self, device) -> List[Dict[str, torch.Tensor]]:
        """Zero residuals of the transform-only path: one (padded,) fp32
        row a bucket (none for the exact modes), the same on every data
        rank."""
        if self.cfg.mode in ("fp32", "lossless"):
            return [{} for _ in self.plan.buckets]
        return [{"e": torch.zeros(b.padded, dtype=torch.float32,
                                  device=device)}
                for b in self.plan.buckets]

    def transform_dispatch(self, tree, state):
        """The wire format of every bucket applied to a whole (already
        reduced) grad tree, one ``comm/reduce`` span a bucket
        (``transform_only``). Returns ``(tree (fp32, the caller's key
        order), new_state)``."""
        leaves, unflatten = bucketing.tree_flatten_sorted(tree)
        if len(leaves) != self.plan.n_leaves:
            raise ValueError(
                f"grad tree has {len(leaves)} leaves but the bucket plan "
                f"was built for {self.plan.n_leaves}")
        outs = [None] * self.plan.n_leaves
        new_state = []
        for j, b in enumerate(self.plan.buckets):
            with trace_span("comm/reduce", lane="comm", bucket=j,
                            mode=self.cfg.mode, elements=b.length,
                            transform_only=True):
                flat = bucketing.pack(b, [leaves[i] for i in b.leaf_ids])
                out, nr = self._transform_flat(flat, state[j])
            for i, leaf in zip(b.leaf_ids, bucketing.unpack(b, out)):
                outs[i] = leaf
            new_state.append(nr)
            if self._c_buckets is not None:
                self._c_buckets.inc()
        return unflatten(outs), new_state

    # ------------------------------------------------------------------ #
    # canonical-slot reduction (elastic training)
    # ------------------------------------------------------------------ #

    def _canonical_wire_rows(self, v, res):
        """Per-slot wire math: quantize->dequantize each (slot) row of
        ``v`` ((C/W, L) fp32) with per-slot error feedback. Row-local, so
        it gives the same bits whichever rank owns the slot."""
        cfg = self.cfg
        ef = cfg.error_feedback
        if cfg.mode in ("fp32", "lossless"):
            # lossless is exact transport: per slot it IS the fp32 math
            return v, res
        c = v + res["e"] if ef else v
        if cfg.mode == "bf16":
            out = c.to(torch.bfloat16).float()
        elif cfg.mode == "compressed":
            m, e = _compress_blocks(c.reshape(-1), cfg.block)
            out = _decompress_blocks(m, e, c.numel()).reshape(c.shape)
        else:  # int8
            quant, _, deq = self._ops(v.device)
            q, s, _ = quant(c, cfg.block, want_residual=False)
            out = deq(q, s, cfg.block, 1.0)
        new_res = {"e": c - out} if ef else res
        return out, new_res

    def canonical_wire_launches(self) -> Dict[str, int]:
        """The fused_quant launches one :meth:`reduce_canonical` makes on
        a routed device: one ``quantize_rows`` and one ``dequant_rows``
        per bucket under int8 (all of the rank's slot rows in one call),
        none otherwise."""
        n = self.n_buckets if self.cfg.mode == "int8" else 0
        return {"quantize_rows": n, "dequant_rows": n,
                "dequant_sum_rows": 0}

    def canonical_wire_bytes(self, b: bucketing.Bucket) -> int:
        """Per-rank bytes of one bucket's slot-row gather: the fp32 rows
        of the other ranks' slots."""
        return int(4 * b.padded * (self.canonical - self.local_slots))

    def reduce_canonical(self, slot_trees, state):
        """Reduce this rank's per-slot grads (a list of C/W trees like the
        params, its slots in order) to the tree of slot means over all C
        slots, bucket by bucket, each in a ``comm/reduce`` span. Returns
        ``(mean tree (fp32, the caller's key order), new_state)``; the
        mean is bit-identical on every rank and at every world size."""
        if not self.canonical:
            raise ValueError("reduce_canonical requires canonical mode")
        if len(slot_trees) != self.local_slots:
            raise ValueError(
                f"got {len(slot_trees)} slot trees, this rank owns "
                f"{self.local_slots} of {self.canonical} slots")
        flat = [bucketing.tree_flatten_sorted(t) for t in slot_trees]
        unflatten = flat[0][1]
        slot_leaves = [f[0] for f in flat]
        if len(slot_leaves[0]) != self.plan.n_leaves:
            raise ValueError(
                f"grad tree has {len(slot_leaves[0])} leaves but the bucket "
                f"plan was built for {self.plan.n_leaves}")
        outs = [None] * self.plan.n_leaves
        new_state = []
        for j, b in enumerate(self.plan.buckets):
            wire = self.canonical_wire_bytes(b)
            with trace_span("comm/reduce", lane="comm", bucket=j,
                            mode=self.cfg.mode, elements=b.length,
                            wire_bytes=wire, overlapped=False,
                            canonical=self.canonical):
                rows = torch.stack([
                    bucketing.pack(b, [ls[i] for i in b.leaf_ids])
                    for ls in slot_leaves])  # (C/W, padded)
                out, nr = self._canonical_wire_rows(rows, state[j])
                red = exact_slot_mean(out, self.transport, self.canonical)
            for i, leaf in zip(b.leaf_ids, bucketing.unpack(b, red)):
                outs[i] = leaf
            new_state.append(nr)
            self._count(wire)
        return unflatten(outs), new_state
