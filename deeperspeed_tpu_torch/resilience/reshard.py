"""Checkpoint remapping across world sizes.

Counterpart of deeperspeed_tpu/resilience/reshard.py. A checkpoint
written at world size W must be loadable at any admissible W'. What
needs help:

* **comm error-feedback residuals** in the classic (non-canonical)
  layout are ``(W, n)`` stacks, one row per rank, so their shape bakes in
  the world size. :func:`reshard_comm_residuals` rebuilds them for W'
  from the saved ``GradReducer.plan_summary``:

  - ``"e"`` rows are per-rank quantization errors of the same padded
    bucket vector. Error feedback only needs their SUM over ranks, so
    rows regroup sum-preservingly (``new[i % W'] += old[i]``);
  - ``"e2"`` rows (int8 flat second phase) are POSITIONAL chunks of the
    padded bucket vector: the global vector is reassembled, re-padded to
    the new plan's length and re-sliced into W' chunks (the pad region's
    residual is zero);
  - hierarchical residuals are per-group and reset to zero with a
    warning.

  Canonical-slot residuals (``elasticity.canonical_shards``) are ``(C,
  n)`` whatever the world size: their fingerprint carries no world term,
  so the engine restores them verbatim and never calls this.

* **datapipe cursors** (:func:`remap_data_state`): ``DataState`` counters
  are global, and under elasticity the global batch rows are invariant
  across world sizes, so the remap is the identity; a changed row count
  resumes the exact sample stream but re-bases step-keyed schedules,
  with a warning.

Everything here is host-side numpy on checkpoint data; the engine copies
the results into its tensors.
"""

from typing import Dict, List, Optional

import numpy as np

from ..utils.logging import logger

#: keys of a reducer plan summary that must match (world excluded) for
#: residuals to reshard instead of reset
_PLAN_MATCH_KEYS = ("mode", "block", "error_feedback", "bucket_lengths")


def _normalize_buckets(buckets) -> Optional[List[Dict[str, np.ndarray]]]:
    """Checkpoint codecs differ on list encoding: msgpack round-trips a
    list as an index-keyed dict ({'0': ..., '1': ...}), orbax keeps the
    list. Normalize to a list of dicts of numpy arrays."""
    if buckets is None:
        return None
    if isinstance(buckets, dict):
        try:
            buckets = [buckets[k] for k in sorted(buckets, key=int)]
        except (ValueError, TypeError):
            return None
    out = []
    for b in buckets:
        if not isinstance(b, dict):
            return None
        out.append({k: np.asarray(v, dtype=np.float32)
                    for k, v in b.items()})
    return out


def _normalize_plan(plan) -> Optional[dict]:
    """Undo codec damage on a saved plan summary: msgpack round-trips
    lists as index-keyed dicts and may widen ints. Returns a clean dict
    (or None for non-dicts)."""
    if not isinstance(plan, dict):
        return None
    out = dict(plan)
    for k in ("bucket_lengths", "bucket_padded"):
        v = out.get(k)
        if isinstance(v, dict):
            try:
                v = [v[i] for i in sorted(v, key=int)]
            except (ValueError, TypeError):
                return None
        if isinstance(v, (list, tuple)):
            out[k] = [int(n) for n in v]
    for k in ("world", "block", "hier_k", "canonical"):
        if k in out and out[k] is not None:
            out[k] = int(out[k])
    if "error_feedback" in out:
        out["error_feedback"] = bool(out["error_feedback"])
    return out


def plans_reshardable(saved_plan: Optional[dict],
                      target_plan: dict) -> Optional[str]:
    """None when residuals saved under ``saved_plan`` can be resharded
    onto ``target_plan`` (same layout, only the world size differs);
    otherwise the human-readable reason they cannot."""
    saved_plan = _normalize_plan(saved_plan)
    if saved_plan is None:
        return "checkpoint predates comm_plan metadata"
    for k in _PLAN_MATCH_KEYS:
        if saved_plan.get(k) != target_plan.get(k):
            return (f"comm layout changed: {k} "
                    f"{saved_plan.get(k)!r} -> {target_plan.get(k)!r}")
    if saved_plan.get("canonical", 0) != target_plan.get("canonical", 0):
        return ("canonical_shards changed: "
                f"{saved_plan.get('canonical', 0)} -> "
                f"{target_plan.get('canonical', 0)}")
    if int(saved_plan.get("hier_k", 0) or 0):
        return "hierarchical residuals are per-group; they reset to zero"
    if int(target_plan.get("hier_k", 0) or 0):
        return "restoring onto a hierarchical schedule resets residuals"
    return None


def reshard_comm_residuals(saved_buckets, saved_plan: dict,
                           target_plan: dict
                           ) -> Optional[List[Dict[str, np.ndarray]]]:
    """Reshape (W, n)-stacked comm residuals from ``saved_plan``'s world
    size onto ``target_plan``'s. Returns the new per-bucket residual
    dicts (host numpy, shaped for the target plan), or None when the
    layouts are incompatible (caller falls back to zeros)."""
    reason = plans_reshardable(saved_plan, target_plan)
    if reason is not None:
        logger.warning("comm residuals cannot be resharded (%s)", reason)
        return None
    saved_plan = _normalize_plan(saved_plan)
    buckets = _normalize_buckets(saved_buckets)
    if buckets is None:
        logger.warning("comm residuals have an unrecognized container "
                       "layout; resetting to zero")
        return None
    w_old = int(saved_plan["world"])
    w_new = int(target_plan["world"])
    lengths = [int(n) for n in target_plan["bucket_lengths"]]
    padded_old = [int(n) for n in saved_plan["bucket_padded"]]
    padded_new = [int(n) for n in target_plan["bucket_padded"]]
    if len(buckets) != len(lengths):
        logger.warning(
            "comm residuals carry %d buckets but the plan has %d; "
            "resetting to zero", len(buckets), len(lengths))
        return None

    out: List[Dict[str, np.ndarray]] = []
    for j, res in enumerate(buckets):
        length, lo, ln = lengths[j], padded_old[j], padded_new[j]
        new_res: Dict[str, np.ndarray] = {}
        for key, arr in res.items():
            if key == "e":
                if arr.shape != (w_old, lo):
                    logger.warning(
                        "bucket %d residual 'e' has shape %s, expected "
                        "%s; resetting to zero", j, arr.shape, (w_old, lo))
                    return None
                new = np.zeros((w_new, ln), np.float32)
                for i in range(w_old):
                    # sum-preserving regroup of per-device errors; the
                    # pad region [length:] is identically zero
                    new[i % w_new, :length] += arr[i, :length]
                new_res[key] = new
            elif key == "e2":
                chunk_old, chunk_new = lo // w_old, ln // w_new
                if arr.shape != (w_old, chunk_old):
                    logger.warning(
                        "bucket %d residual 'e2' has shape %s, expected "
                        "%s; resetting to zero", j, arr.shape,
                        (w_old, chunk_old))
                    return None
                flat = arr.reshape(-1)  # the padded global vector
                if flat.shape[0] < ln:
                    flat = np.pad(flat, (0, ln - flat.shape[0]))
                new_res[key] = flat[:ln].reshape(w_new, chunk_new).astype(
                    np.float32)
            else:
                logger.warning(
                    "bucket %d carries unknown residual key %r; "
                    "resetting to zero", j, key)
                return None
        out.append(new_res)
    return out


def reshard_transform_residuals(saved_buckets, saved_plan: Optional[dict],
                                target_plan: dict
                                ) -> Optional[List[Dict[str, np.ndarray]]]:
    """The pipeline engine's transform-only residuals (one ``(padded,)``
    vector a bucket) on a new plan. Past each bucket's unpadded length a
    residual is zero, and the padding is the only part of the layout
    that depends on the world size, so the remap is exact: each vector
    cut or zero-extended to the target's padded length (the identity
    when the world size did not change). None when the bucket layout
    itself differs (the caller keeps zeros)."""
    saved_plan = _normalize_plan(saved_plan)
    if saved_plan is None:
        logger.warning("comm transform residuals predate plan metadata; "
                       "resetting to zero")
        return None
    for k in ("mode", "block", "error_feedback", "bucket_lengths"):
        if saved_plan.get(k) != target_plan.get(k):
            logger.warning(
                "comm transform residuals cannot be reshaped (%s changed: "
                "%r -> %r); resetting to zero",
                k, saved_plan.get(k), target_plan.get(k))
            return None
    buckets = _normalize_buckets(saved_buckets)
    if buckets is None:
        logger.warning("comm transform residuals have an unrecognized "
                       "container layout; resetting to zero")
        return None
    padded_new = [int(n) for n in target_plan["bucket_padded"]]
    if len(buckets) != len(padded_new):
        logger.warning(
            "comm transform residuals carry %d buckets but the plan has "
            "%d; resetting to zero", len(buckets), len(padded_new))
        return None
    out: List[Dict[str, np.ndarray]] = []
    for j, res in enumerate(buckets):
        ln = padded_new[j]
        new_res: Dict[str, np.ndarray] = {}
        for key, arr in res.items():
            flat = np.asarray(arr, np.float32).reshape(-1)
            if flat.shape[0] < ln:
                flat = np.pad(flat, (0, ln - flat.shape[0]))
            new_res[key] = flat[:ln]
        out.append(new_res)
    return out


def remap_data_state(state_dict: Optional[dict], saved_rows: Optional[int],
                     target_rows: int) -> Optional[dict]:
    """Remap a checkpointed ``DataState`` dict to the running global batch
    layout. Its counters are global (cursor and samples index the sample
    stream itself), so a resume under the same global batch is the
    identity. A changed row count still resumes the exact sample stream
    but re-bases the step-keyed schedules, which is worth a warning."""
    if state_dict is None:
        return None
    if saved_rows is not None and int(saved_rows) != int(target_rows):
        logger.warning(
            "datapipe: global batch rows changed %s -> %s across resume; "
            "the sample cursor resumes the exact stream, but step-keyed "
            "schedules (curriculum, batch-size ramps) now advance at the "
            "new per-step granularity", saved_rows, target_rows)
    return state_dict
