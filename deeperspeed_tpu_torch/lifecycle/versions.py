"""Weight-version registry: COMMITTED checkpoint tags -> serving rollouts.

Counterpart of deeperspeed_tpu/lifecycle/versions.py, whole, and
byte-compatible with it: both packages read and extend one
``VERSIONS.json`` (the same keys, ``indent=1``, sorted keys).

The train->serve hinge of the lifecycle subsystem. The trainer side
publishes a checkpoint tag as a :class:`WeightVersion`, a monotonically
numbered, manifest-backed record, and the serving side rolls the fleet
onto it (``FleetRouter.rolling_update``). The registry is a single JSON
file (``VERSIONS.json``) living next to the checkpoint tags it points
at, written with the same atomic tmp+fsync+rename discipline as
``resilience/manifest.py`` so a torn write can never present a
half-published version.

Invariants:

  * only COMMITTED tags are publishable: ``publish`` re-verifies the
    two-phase-commit marker via ``manifest.tag_status`` and refuses
    anything else (staging/partial/corrupt tags stay invisible to the
    fleet); a tag written by a multi-process run's legacy save path
    (no marker, status ``legacy``) is publishable too, as in the
    reference;
  * version numbers are assigned here, monotonically, and are never
    reused: a replica pinned to v3 means one exact weight set forever;
  * a version is ``live`` until retired; ``resilience/manager.py``'s
    keep_last pruning reads ``live_tags`` so a tag the fleet may still
    be serving (or rolling onto) is never deleted out from under it;
  * the retire window (``keep_live``) keeps the last N versions live so
    a rolling update in flight can still fail back one version.

Stdlib-only (json/os/time): the supervisor, the router side and the
operator CLI read it without touching torch.
"""

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

from ..resilience.manifest import tag_status, tag_step

__all__ = [
    "VERSIONS_FILE",
    "WeightVersion",
    "VersionRegistry",
    "live_tags",
]

VERSIONS_FILE = "VERSIONS.json"


@dataclasses.dataclass(frozen=True)
class WeightVersion:
    """One published weight set: an immutable (version, tag) pairing.

    When speculative decoding serves this version, ``drafter`` names
    the drafter checkpoint tag published WITH the target — the rollout
    ships both as one unit, because token-identical failover across a
    mixed spec-on/spec-off fleet only needs the target weights pinned,
    but acceptance-rate comparability needs the drafter pinned too.
    Absent in pre-pair registry files (serde defaults it to None)."""

    version: int               # monotonic, never reused
    tag: str                   # COMMITTED checkpoint tag in load_dir
    step: Optional[int]        # trainer step the tag was saved at
    published_ts: float        # wall-clock publish time
    live: bool = True          # still routable / prune-protected
    drafter: Optional[str] = None   # paired drafter checkpoint tag

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "WeightVersion":
        return WeightVersion(
            version=int(d["version"]),
            tag=str(d["tag"]),
            step=(int(d["step"]) if d.get("step") is not None else None),
            published_ts=float(d.get("published_ts", 0.0)),
            live=bool(d.get("live", True)),
            drafter=(str(d["drafter"])
                     if d.get("drafter") is not None else None),
        )


class VersionRegistry:
    """The ``VERSIONS.json`` ledger in a checkpoint directory.

    Every mutation re-reads the file, applies the change, and rewrites
    atomically — the registry is tiny and the publish/retire rate is
    per-checkpoint, so last-writer-wins over a fresh read is plenty
    (trainer publishes; the serving side only reads).
    """

    def __init__(self, ckpt_dir: str, keep_live: int = 2):
        if keep_live < 1:
            raise ValueError(f"keep_live must be >= 1, got {keep_live}")
        self.ckpt_dir = ckpt_dir
        self.keep_live = keep_live

    @property
    def path(self) -> str:
        return os.path.join(self.ckpt_dir, VERSIONS_FILE)

    # -------------------------------------------------------------- #
    # file plumbing

    def _read(self) -> List[WeightVersion]:
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            return []
        out = []
        for rec in doc.get("versions", []):
            try:
                out.append(WeightVersion.from_dict(rec))
            except (KeyError, TypeError, ValueError):
                continue  # one bad record never hides the rest
        out.sort(key=lambda v: v.version)
        return out

    def _write(self, versions: List[WeightVersion]) -> None:
        doc = {"versions": [v.to_dict() for v in sorted(
            versions, key=lambda v: v.version)]}
        tmp = self.path + ".tmp"
        os.makedirs(self.ckpt_dir, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    # -------------------------------------------------------------- #
    # queries

    def list(self) -> List[WeightVersion]:
        """All versions ever published, oldest first."""
        return self._read()

    def latest(self) -> Optional[WeightVersion]:
        """Newest LIVE version (what a rollout should target)."""
        live = [v for v in self._read() if v.live]
        return live[-1] if live else None

    def get(self, version: int) -> Optional[WeightVersion]:
        for v in self._read():
            if v.version == version:
                return v
        return None

    def live_tags(self) -> Dict[str, int]:
        """tag -> version for every live version (prune protection)."""
        return {v.tag: v.version for v in self._read() if v.live}

    # -------------------------------------------------------------- #
    # mutations (trainer side)

    def publish(self, tag: str, step: Optional[int] = None,
                now: Optional[float] = None,
                drafter: Optional[str] = None) -> WeightVersion:
        """Publish a COMMITTED checkpoint tag as the next version.

        Re-publishing the tag of an existing live version with the same
        drafter pairing is idempotent (returns the existing record) —
        the controller may call this on every save interval without
        minting duplicate versions. The same target tag with a NEW
        drafter mints a new version: the pair is the routable unit.

        ``drafter`` names the drafter checkpoint tag published with the
        target (speculative decoding); it must also be COMMITTED.
        """
        status = tag_status(os.path.join(self.ckpt_dir, str(tag)))
        if status not in ("committed", "legacy"):
            raise ValueError(
                f"refusing to publish tag {tag!r}: status is {status!r} "
                "(only committed checkpoints become weight versions)")
        if drafter is not None:
            dstatus = tag_status(os.path.join(self.ckpt_dir, str(drafter)))
            if dstatus not in ("committed", "legacy"):
                raise ValueError(
                    f"refusing to publish drafter tag {drafter!r}: status "
                    f"is {dstatus!r} (the pair rolls out as one unit, so "
                    "both sides must be committed)")
        versions = self._read()
        for v in versions:
            if v.live and v.tag == tag and v.drafter == drafter:
                return v
        number = versions[-1].version + 1 if versions else 1
        rec = WeightVersion(
            version=number, tag=tag,
            step=step if step is not None else tag_step(tag),
            published_ts=float(now if now is not None else time.time()),
            drafter=drafter,
        )
        versions.append(rec)
        # retire past the live window, never the newest keep_live
        live = [v for v in versions if v.live]
        to_retire = {v.version for v in live[:-self.keep_live]}
        if to_retire:
            versions = [
                dataclasses.replace(v, live=False)
                if v.version in to_retire else v
                for v in versions
            ]
        self._write(versions)
        return rec

    def retire(self, version: int) -> bool:
        """Mark one version non-live (a tag the fleet must not pin to
        anymore). True when a live record was retired."""
        versions = self._read()
        hit = False
        out = []
        for v in versions:
            if v.version == version and v.live:
                out.append(dataclasses.replace(v, live=False))
                hit = True
            else:
                out.append(v)
        if hit:
            self._write(out)
        return hit


def live_tags(ckpt_dir: str) -> Dict[str, int]:
    """tag -> version for the live versions published under
    ``ckpt_dir`` (empty when no registry exists). Free-function form so
    the checkpoint pruner can consult the registry without constructing
    one."""
    try:
        return VersionRegistry(ckpt_dir).live_tags()
    except Exception:
        return {}
