"""Checkpoint manifest, two-phase commit and valid-tag discovery.

Counterpart of deeperspeed_tpu/resilience/manifest.py, the stdlib half of
the reference's resilience subsystem that a load needs (the two-phase
commit, the manager, the background writer and the supervisor come with
ROADMAP.md queue 1, item 'Resilience and multi-process runtime'):

  * a committed save (the reference's resilience writer) leaves every
    file of ``<tag>`` listed in a ``MANIFEST.json`` of per-file sizes and
    sha256 checksums, and a ``COMMITTED`` marker;
  * a load verifies the manifest (``verify_manifest``) and, when the
    requested tag is missing, partial or corrupt, falls back to the newest
    older tag that still verifies (``resolve_load_tag``).

Tag states (``tag_status``): ``committed`` (marker present and, when
asked, every checksum matches), ``legacy`` (no marker and no manifest, but
model states on disk: what ``Engine.save_checkpoint`` writes),
``partial`` (a manifest without a marker, or neither states nor marker),
``corrupt`` (marker present, a checksum or size mismatch), ``staging`` and
``missing``.

Stdlib only (os, json, hashlib), the same as the reference's module.
"""

import hashlib
import json
import os
import re
from typing import Iterable, List, Optional, Set, Tuple

from ..utils.logging import logger

MANIFEST_FILE = "MANIFEST.json"
COMMITTED_MARKER = "COMMITTED"
STAGING_SUFFIX = ".tmp"
MANIFEST_VERSION = 1

# files a manifest never covers: itself, the marker, and the `latest`
# pointer (which lives in the parent dir anyway)
_UNMANIFESTED = frozenset({MANIFEST_FILE, COMMITTED_MARKER})

VALID_STATES = ("committed", "legacy")

_TAG_STEP_RE = re.compile(r"(\d+)\s*$")


# --------------------------------------------------------------------- #
# fsync helpers
# --------------------------------------------------------------------- #


def fsync_dir(path: str) -> None:
    """fsync a directory so the entries inside it (renames, creates)
    survive power loss; a no-op on filesystems that refuse the open."""
    flags = os.O_RDONLY | getattr(os, "O_DIRECTORY", 0)
    try:
        fd = os.open(path, flags)
    except OSError:  # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


# --------------------------------------------------------------------- #
# manifest write / verify
# --------------------------------------------------------------------- #


def file_checksum(path: str, chunk_bytes: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk_bytes)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _walk_files(ckpt_dir: str) -> Iterable[str]:
    for root, _dirs, files in os.walk(ckpt_dir):
        for fname in sorted(files):
            rel = os.path.relpath(os.path.join(root, fname), ckpt_dir)
            if rel in _UNMANIFESTED:
                continue
            yield rel


def write_manifest(ckpt_dir: str, extra: Optional[dict] = None) -> str:
    """Record size + sha256 for every file under ``ckpt_dir`` into
    ``MANIFEST.json`` (written atomically and fsynced). Returns the
    manifest path."""
    files = {}
    for rel in _walk_files(ckpt_dir):
        full = os.path.join(ckpt_dir, rel)
        files[rel] = {
            "bytes": os.path.getsize(full),
            "sha256": file_checksum(full),
        }
    manifest = {"version": MANIFEST_VERSION, "files": files}
    if extra:
        manifest["meta"] = dict(extra)
    path = os.path.join(ckpt_dir, MANIFEST_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(ckpt_dir)
    return path


def verify_manifest(ckpt_dir: str,
                    check_checksums: bool = True) -> Tuple[bool, List[str]]:
    """Check every manifest entry against the on-disk files. Returns
    (ok, problems); a missing manifest is itself a problem."""
    path = os.path.join(ckpt_dir, MANIFEST_FILE)
    try:
        with open(path) as f:
            manifest = json.load(f)
        entries = manifest["files"]
    except (OSError, ValueError, KeyError) as e:
        return False, [f"unreadable manifest: {e}"]
    problems = []
    for rel, want in sorted(entries.items()):
        full = os.path.join(ckpt_dir, rel)
        if not os.path.isfile(full):
            problems.append(f"{rel}: missing")
            continue
        size = os.path.getsize(full)
        if size != want.get("bytes"):
            problems.append(
                f"{rel}: size {size} != manifest {want.get('bytes')}")
            continue
        if check_checksums:
            digest = file_checksum(full)
            if digest != want.get("sha256"):
                problems.append(f"{rel}: sha256 mismatch")
    return not problems, problems


def is_committed(ckpt_dir: str) -> bool:
    return os.path.isfile(os.path.join(ckpt_dir, COMMITTED_MARKER))


# --------------------------------------------------------------------- #
# tag state + discovery
# --------------------------------------------------------------------- #


def _looks_like_checkpoint(ckpt_dir: str) -> bool:
    """Pre-resilience layouts: msgpack model-state shards or the orbax
    ``sharded_state`` directory (patterns mirrored from
    checkpoint/serialization.py, kept literal so this module stays
    stdlib-only)."""
    if os.path.isdir(os.path.join(ckpt_dir, "sharded_state")):
        return True
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return False
    return any(n.endswith("model_states.msgpack") for n in names)


def tag_status(ckpt_dir: str, verify_checksums: bool = True) -> str:
    if os.path.basename(ckpt_dir).endswith(STAGING_SUFFIX):
        return "staging"
    if not os.path.isdir(ckpt_dir):
        return "missing"
    if is_committed(ckpt_dir):
        if os.path.isfile(os.path.join(ckpt_dir, MANIFEST_FILE)):
            ok, _problems = verify_manifest(
                ckpt_dir, check_checksums=verify_checksums)
            return "committed" if ok else "corrupt"
        return "committed"
    if os.path.isfile(os.path.join(ckpt_dir, MANIFEST_FILE)):
        return "partial"  # died between manifest and commit
    if _looks_like_checkpoint(ckpt_dir):
        return "legacy"
    return "partial"


def tag_step(tag: str) -> Optional[int]:
    """Trailing integer of a tag (``global_step120`` -> 120); None for
    tags with no step suffix (ranked by mtime instead)."""
    m = _TAG_STEP_RE.search(str(tag))
    return int(m.group(1)) if m else None


def list_tags(load_dir: str) -> List[str]:
    """Candidate tag dirs under ``load_dir``, newest first (by parsed
    step number, then mtime); staging dirs excluded."""
    try:
        names = os.listdir(load_dir)
    except OSError:
        return []
    cands = []
    for name in names:
        full = os.path.join(load_dir, name)
        if not os.path.isdir(full) or name.endswith(STAGING_SUFFIX):
            continue
        step = tag_step(name)
        try:
            mtime = os.path.getmtime(full)
        except OSError:
            mtime = 0.0
        cands.append((0 if step is None else 1, step or 0, mtime, name))
    cands.sort(reverse=True)
    return [name for _, _, _, name in cands]


def find_latest_valid_tag(load_dir: str,
                          exclude: Set[str] = frozenset(),
                          verify_checksums: bool = True) -> Optional[str]:
    for tag in list_tags(load_dir):
        if tag in exclude:
            continue
        if tag_status(os.path.join(load_dir, tag), verify_checksums) \
                in VALID_STATES:
            return tag
    return None


def resolve_load_tag(load_dir: str, requested: Optional[str],
                     verify_checksums: bool = True,
                     ) -> Tuple[Optional[str], bool]:
    """Map a requested tag (explicit, or from the ``latest`` pointer) to
    a loadable one. Returns (tag, fell_back): the requested tag itself
    when it verifies, else the newest older valid tag with a warning —
    a crash mid-save must cost at most one checkpoint interval, never
    the run. (None, False) when nothing on disk is loadable."""
    if requested is None:
        return None, False
    status = tag_status(os.path.join(load_dir, str(requested)),
                        verify_checksums)
    if status in VALID_STATES:
        return str(requested), False
    fallback = find_latest_valid_tag(
        load_dir, exclude={str(requested)}, verify_checksums=verify_checksums)
    if fallback is None:
        logger.warning(
            "checkpoint tag %r in %s is not loadable (%s) and no older "
            "valid tag exists", requested, load_dir, status)
        return None, False
    logger.warning(
        "checkpoint tag %r in %s is not loadable (%s); falling back to "
        "newest valid tag %r", requested, load_dir, status, fallback)
    return fallback, True
