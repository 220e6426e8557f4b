"""ZeRO stages as shards of each leaf over the mesh's ZeRO axis.

Counterpart of deeperspeed_tpu/runtime/zero/partition.py. The reference
states each stage as sharding specs and lets XLA emit the collectives;
the port runs them eagerly, per rank:

  stage 0: params, grads and optimizer state replicated; the gradients
           are all-reduced (or reduced by the comm GradReducer).
  stage 1: the fp32 master and the Adam moments of each leaf are sharded
           along its ``choose_shard_dim``: each rank keeps and updates its
           shard, then the updated compute-dtype params are all-gathered.
  stage 2: stage 1, and the reduced gradients are cut to the same shards
           (a slice of the replicated mean) before the update.
  stage 3: refused (ROADMAP.md queue 1, item 'Offload and ZeRO-Infinity').

A shard whose dim is not 0 is not contiguous in the full leaf, and the
fused Adam kernel takes flat contiguous leaves, so each rank's shards are
contiguous copies owned by the optimizer (:func:`shard_of`), never views.
A leaf for which ``choose_shard_dim`` finds no dim divisible by the ZeRO
size stays replicated (biases and norms).
"""

import torch

from ...sharding import rules

__all__ = ["shard_of", "gather_into"]


def shard_of(full: torch.Tensor, spec: rules.ShardSpec,
             index: int) -> torch.Tensor:
    """Shard ``index`` of ``full`` under ``spec`` as a contiguous tensor of
    its own (the leaf itself when ``spec`` replicates it)."""
    if not spec.sharded:
        return full
    n = full.shape[spec.dim] // spec.size
    return full.narrow(spec.dim, index * n, n).clone(
        memory_format=torch.contiguous_format)


def gather_into(full: torch.Tensor, shard: torch.Tensor,
                spec: rules.ShardSpec, transport) -> None:
    """All-gather every rank's ``shard`` over ``transport`` (the ZeRO
    axis's group) into ``full``, in place, along ``spec.dim``."""
    g = transport.all_gather(shard)  # (size, *shard.shape)
    full.copy_(g.movedim(0, spec.dim).reshape(full.shape))
