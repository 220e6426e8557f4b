"""Host input pipeline.

Counterpart of deeperspeed_tpu/runtime/dataloader.py (``DeepSpeedDataLoader``,
``RepeatingLoader``), kept as this package's own copy: the loader yields
numpy batches and the engine moves each one to its device.
"""

import math

import numpy as np


class RepeatingLoader:
    def __init__(self, loader):
        """Wrap an iterator to restart from the beginning when it ends.

        Each wrap-around counts as a new epoch: loaders that expose
        ``set_epoch`` (DeepSpeedDataLoader, torch samplers) are advanced
        so a shuffling loader reshuffles every pass instead of replaying
        epoch 0's order forever.
        """
        self.loader = loader
        self.epoch = 0
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.epoch += 1
            if hasattr(self.loader, "set_epoch"):
                self.loader.set_epoch(self.epoch)
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        return batch


class DeepSpeedDataLoader:
    """Batches an indexable dataset of numpy-convertible samples.

    dataset: sequence of samples; each sample is an array, tuple of arrays, or
    dict of arrays. batch_size is the micro batch one forward/backward
    consumes.
    """

    def __init__(
        self,
        dataset,
        batch_size,
        shuffle=False,
        seed=0,
        drop_last=True,
        collate_fn=None,
        num_local_io_workers=None,  # accepted for API compat; IO is in-process
        data_parallel_world_size=None,
        data_parallel_rank=None,
    ):
        n = len(dataset)
        if not isinstance(batch_size, int) or batch_size <= 0:
            raise ValueError(
                f"batch_size must be a positive int, got {batch_size!r}")
        if batch_size > n:
            raise ValueError(
                f"batch_size {batch_size} exceeds the dataset ({n} samples); "
                "every batch would be short — shrink the batch or add data")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn or _default_collate
        self.epoch = 0
        self.len = n // batch_size if drop_last else math.ceil(n / batch_size)

    def __len__(self):
        return self.len

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        usable = self.len * self.batch_size if self.drop_last else n
        for start in range(0, usable, self.batch_size):
            idx = order[start : start + self.batch_size]
            samples = [self.dataset[int(i)] for i in idx]
            yield self.collate_fn(samples)


def _default_collate(samples):
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(
            np.stack([np.asarray(s[i]) for s in samples]) for i in range(len(first))
        )
    return np.stack([np.asarray(s) for s in samples])
