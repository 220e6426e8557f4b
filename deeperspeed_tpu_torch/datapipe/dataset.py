"""Memory-mapped token-shard dataset and its deterministic order.

Counterpart of deeperspeed_tpu/datapipe/dataset.py. Both are numpy, and
the port's gives the same windows, the same permutations and the same
fingerprints as the reference for the same source, seed and epoch.

``TokenShardDataset`` indexes fixed ``seq_len + 1``-token windows over a
token corpus: one ``.npy`` file, a directory of ``*.npy`` shards, or an
in-memory array. Files are memory-mapped, so nothing is read until a
window is fetched.

``epoch_order(seed, epoch, n)`` derives the whole epoch's order from the
Philox counter RNG keyed by ``(seed, epoch)``: there is no mutable RNG
state to save, and any ``(seed, epoch, cursor)`` triple reconstructs the
remaining sample sequence. ``order_fingerprint`` names that order (and
the dataset's identity) in a short hash the checkpoint carries.
"""

import hashlib
import os
from typing import List, Optional

import numpy as np

__all__ = [
    "TokenShardDataset",
    "epoch_order",
    "order_fingerprint",
]


def _load_shard(path: str):
    arr = np.load(path, mmap_mode="r")
    if arr.ndim != 1:
        raise ValueError(
            f"token shard {path} must be a 1-D token array, got shape "
            f"{arr.shape}")
    return arr


class TokenShardDataset:
    """Indexable windows of ``seq_len + 1`` tokens over mmap'd shards.

    Windows never straddle a shard boundary (each shard's ragged tail is
    dropped); shards are taken in sorted-filename order.
    """

    def __init__(self, source, seq_len: int, dtype=np.int32):
        self.seq_len = int(seq_len)
        if self.seq_len < 1:
            raise ValueError(f"seq_len must be >= 1, got {seq_len}")
        self.dtype = np.dtype(dtype)
        self._window = self.seq_len + 1
        if isinstance(source, np.ndarray):
            shards: List[np.ndarray] = [source]
            self.paths = ["<in-memory>"]
        else:
            source = str(source)
            if os.path.isdir(source):
                self.paths = sorted(
                    os.path.join(source, f) for f in os.listdir(source)
                    if f.endswith(".npy"))
                if not self.paths:
                    raise FileNotFoundError(
                        f"no .npy token shards in directory {source}")
            elif os.path.isfile(source):
                self.paths = [source]
            else:
                raise FileNotFoundError(f"token source {source} not found")
            shards = [_load_shard(p) for p in self.paths]
        self._shards = shards
        per_shard = [s.size // self._window for s in shards]
        if sum(per_shard) == 0:
            raise ValueError(
                f"token source holds no full window of {self._window} "
                f"tokens (sizes: {[s.size for s in shards]})")
        # window i lives in shard searchsorted(cum, i, "right") - 1
        self._cum = np.cumsum([0] + per_shard)
        self._len = int(self._cum[-1])

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, i: int) -> np.ndarray:
        i = int(i)
        if not 0 <= i < self._len:
            raise IndexError(f"window {i} out of range [0, {self._len})")
        s = int(np.searchsorted(self._cum, i, side="right")) - 1
        local = i - int(self._cum[s])
        w = self._window
        chunk = self._shards[s][local * w:(local + 1) * w]
        return np.asarray(chunk, dtype=self.dtype)

    def identity(self) -> dict:
        """What the checkpoint fingerprint binds to: the shard layout."""
        return {
            "n_windows": self._len,
            "seq_len": self.seq_len,
            "shards": [os.path.basename(p) for p in self.paths],
        }


def epoch_order(seed: int, epoch: int, n: int,
                shuffle: bool = True) -> np.ndarray:
    """The epoch's sample order, a pure function of (seed, epoch, n):
    Philox keyed by (seed, epoch), int64."""
    if not shuffle:
        return np.arange(n, dtype=np.int64)
    key = (int(seed) & (2**64 - 1)) << 64 | (int(epoch) & (2**64 - 1))
    rng = np.random.Generator(np.random.Philox(key=key))
    return rng.permutation(n).astype(np.int64)


def order_fingerprint(seed: int, epoch: int, n: int,
                      shuffle: bool = True,
                      identity: Optional[dict] = None) -> str:
    """Short stable hash naming the epoch order and the dataset identity.
    The order is a pure function of ``(seed, epoch, n, shuffle)``, so
    hashing those binds the fingerprint to it without materializing the
    permutation."""
    h = hashlib.sha256()
    h.update(
        f"{int(seed)}:{int(epoch)}:{int(n)}:{int(bool(shuffle))}".encode())
    if identity:
        h.update(repr(sorted(identity.items())).encode())
    return h.hexdigest()[:16]
