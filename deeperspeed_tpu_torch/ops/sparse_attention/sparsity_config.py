"""Block-sparsity layout configurations.

The port's own copy of deeperspeed_tpu/ops/sparse_attention/
sparsity_config.py (numpy only): the same classes, arguments, errors and
layouts. Each config builds a ``(num_heads, num_blocks, num_blocks)`` 0/1
layout where entry (h, qb, kb) = 1 means the block pair takes part in
attention. Layouts are plain numpy, built on the host once; the CUDA
kernel pair consumes them as CSR look-up tables (kernels.py).

Variable and BigBird draw their random blocks from one
``np.random.default_rng(seed)`` made in ``__init__``, in the reference's
order, so a second ``make_layout`` gives another layout, as there.

Patterns: Dense, Fixed (Sparse Transformers, arxiv 1904.10509), Variable,
BigBird (arxiv 2007.14062), BSLongformer (arxiv 2004.05150, block-sparse
variant), LocalSlidingWindow.
"""

from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Base: shared block/head bookkeeping for all patterns."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"Sequence Length, {seq_len}, needs to be divisible by "
                f"Block size {self.block}!"
            )
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks), np.int64)

    def check_and_propagate_first_head_layout(self, layout: np.ndarray):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks on; kept for comparison (DeepSpeed :63)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


def _sliding_window(layout, h, num_window_blocks, bidirectional):
    """Band fill: each block row attends +-w neighbours (w = window // 2);
    unidirectional drops the upper band. Shared by BigBird / BSLongformer /
    LocalSlidingWindow."""
    nb = layout.shape[1]
    if nb < num_window_blocks:
        raise ValueError(
            f"Number of sliding window blocks, {num_window_blocks}, must be "
            f"smaller than overall number of blocks in a row, {nb}!"
        )
    w = num_window_blocks // 2
    rows = np.arange(nb)[:, None]
    cols = np.arange(nb)[None, :]
    band = (cols >= rows - w) & (cols <= (rows + w if bidirectional else rows))
    layout[h][band] = 1
    return layout


def _local_windows(layout, h, boundaries, unidirectional):
    """Fill dense windows [b_i, b_{i+1}) (lower-triangular if unidirectional)."""
    nb = layout.shape[1]
    rows = np.arange(nb)[:, None]
    cols = np.arange(nb)[None, :]
    for start, end in boundaries:
        end = min(end, nb)
        in_win = (rows >= start) & (rows < end) & (cols >= start) & (cols < end)
        if unidirectional:
            in_win &= cols <= rows
        layout[h][in_win] = 1


class FixedSparsityConfig(SparsityConfig):
    """Fixed pattern of Sparse Transformers (DeepSpeed :94): dense local
    windows of `num_local_blocks`, plus per-window global representative
    blocks attended by (and, if horizontal, attending to) everyone."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional", horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        if num_global_blocks > 0 and num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"Number of blocks in a local window, {num_local_blocks}, "
                f"must be divisible by number of global blocks, "
                f"{num_global_blocks}!"
            )
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                'only "uni/bi-directional" attentions are supported for now!'
            )
        self.attention = attention
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                'only "bi-directional" attentions can support horizontal '
                "global attention!"
            )
        self.horizontal_global_attention = horizontal_global_attention
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "Number of different layouts cannot be more than one when "
                "you have set a single layout for all heads! Set "
                "different_layout_per_head to True."
            )
        if num_global_blocks > 0 and (
            num_different_global_patterns > num_local_blocks // num_global_blocks
        ):
            raise ValueError(
                f"Number of layout versions (num_different_global_patterns), "
                f"{num_different_global_patterns}, cannot be larger than "
                f"number of local window blocks divided by number of global "
                f"blocks, {num_local_blocks} / {num_global_blocks} = "
                f"{num_local_blocks // num_global_blocks}!"
            )
        self.num_different_global_patterns = num_different_global_patterns

    def set_local_layout(self, h, layout):
        nb = layout.shape[1]
        bounds = [
            (i, i + self.num_local_blocks)
            for i in range(0, nb, self.num_local_blocks)
        ]
        _local_windows(layout, h, bounds, self.attention == "unidirectional")
        return layout

    def set_global_layout(self, h, layout):
        nb = layout.shape[1]
        first = self.num_local_blocks - (
            1 + h % self.num_different_global_patterns
        ) * self.num_global_blocks
        end = nb - (nb % self.num_local_blocks)
        uni = self.attention == "unidirectional"
        for i in range(first, end, self.num_local_blocks):
            first_row = i if uni else 0
            layout[h, first_row:, i:i + self.num_global_blocks] = 1
            if self.horizontal_global_attention:
                layout[h, i:i + self.num_global_blocks, :] = 1
        if end < nb:  # short trailing window
            start = min(end + first, nb - self.num_global_blocks)
            stop = start + self.num_global_blocks
            first_row = start if uni else 0
            layout[h, first_row:, start:stop] = 1
            if self.horizontal_global_attention:
                layout[h, start:stop, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_local_layout(h, layout)
            if self.num_global_blocks > 0:
                self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Fixed pattern generalized (DeepSpeed :244): per-window sizes list,
    explicit global block indices/ranges, optional random blocks."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention="bidirectional", horizontal_global_attention=False,
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = (
            global_block_indices if global_block_indices is not None else [0]
        )
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    f"Global block start indices length, "
                    f"{len(self.global_block_indices)}, must be same as global "
                    f"block end indices length, {len(global_block_end_indices)}!"
                )
            for start_idx, end_idx in zip(self.global_block_indices,
                                          global_block_end_indices):
                if start_idx >= end_idx:
                    raise ValueError(
                        f"Global block start index, {start_idx}, must be "
                        f"smaller than global block end index, {end_idx}!"
                    )
        self.global_block_end_indices = global_block_end_indices
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                'only "uni/bi-directional" attentions are supported for now!'
            )
        self.attention = attention
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError(
                'only "bi-directional" attentions can support horizontal '
                "global attention!"
            )
        self.horizontal_global_attention = horizontal_global_attention
        self._rng = np.random.default_rng(seed)

    def set_random_layout(self, h, layout):
        nb = layout.shape[1]
        if nb < self.num_random_blocks:
            raise ValueError(
                f"Number of random blocks, {self.num_random_blocks}, must be "
                f"smaller than overall number of blocks in a row, {nb}!"
            )
        for row in range(nb):
            cols = self._rng.choice(nb, self.num_random_blocks, replace=False)
            layout[h, row, cols] = 1
        return layout

    def set_local_layout(self, h, layout):
        nb = layout.shape[1]
        uni = self.attention == "unidirectional"
        bounds = []
        start = 0
        for size in self.local_window_blocks:
            bounds.append((start, start + size))
            start += size
        # remaining windows reuse the last size
        last = self.local_window_blocks[-1]
        while start < nb:
            bounds.append((start, start + last))
            start += last
        _local_windows(layout, h, bounds, uni)
        return layout

    def set_global_layout(self, h, layout):
        nb = layout.shape[1]
        uni = self.attention == "unidirectional"
        if self.global_block_end_indices is None:
            ranges = [(i, i + 1) for i in self.global_block_indices]
        else:
            ranges = list(zip(self.global_block_indices,
                              self.global_block_end_indices))
        for start, end in ranges:
            if start >= nb:
                continue
            end = min(end, nb)
            if self.horizontal_global_attention:
                layout[h, start:end, :] = 1
            first_row = start if uni else 0
            layout[h, first_row:, start:end] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_random_layout(h, layout)
            self.set_local_layout(h, layout)
            self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird (DeepSpeed :422): random + sliding window + ITC global."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional", seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self._rng = np.random.default_rng(seed)

    def set_random_layout(self, h, layout):
        nb = layout.shape[1]
        if nb < self.num_random_blocks:
            raise ValueError(
                f"Number of random blocks, {self.num_random_blocks}, must be "
                f"smaller than overall number of blocks in a row, {nb}!"
            )
        for row in range(nb):
            hi = nb if self.attention == "bidirectional" else row + 1
            n = min(self.num_random_blocks, hi)
            cols = self._rng.choice(hi, n, replace=False)
            layout[h, row, cols] = 1
        return layout

    def set_sliding_window_layout(self, h, layout):
        return _sliding_window(layout, h, self.num_sliding_window_blocks,
                               self.attention == "bidirectional")

    def set_global_layout_itc(self, h, layout):
        nb = layout.shape[1]
        if nb < self.num_global_blocks:
            raise ValueError(
                f"Number of global blocks, {self.num_global_blocks}, must be "
                f"smaller than overall number of blocks in a row, {nb}!"
            )
        layout[h, : self.num_global_blocks, :] = 1
        layout[h, :, : self.num_global_blocks] = 1
        if self.attention == "unidirectional":
            layout[h] = np.tril(layout[h])
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_random_layout(h, layout)
            self.set_sliding_window_layout(h, layout)
            self.set_global_layout_itc(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer (DeepSpeed :552): sliding window + global
    rows/columns at given block indices."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = (
            global_block_indices if global_block_indices is not None else [0]
        )
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    f"Global block start indices length, "
                    f"{len(self.global_block_indices)}, must be same as global "
                    f"block end indices length, {len(global_block_end_indices)}!"
                )
            for start_idx, end_idx in zip(self.global_block_indices,
                                          global_block_end_indices):
                if start_idx >= end_idx:
                    raise ValueError(
                        f"Global block start index, {start_idx}, must be "
                        f"smaller than global block end index, {end_idx}!"
                    )
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def set_sliding_window_layout(self, h, layout):
        # BSLongformer's window is symmetric regardless of attention mode;
        # unidirectionality is applied by tril in set_global_layout
        return _sliding_window(layout, h, self.num_sliding_window_blocks, True)

    def set_global_layout(self, h, layout):
        nb = layout.shape[1]
        if self.global_block_end_indices is None:
            ranges = [(i, i + 1) for i in self.global_block_indices]
        else:
            ranges = list(zip(self.global_block_indices,
                              self.global_block_end_indices))
        for start, end in ranges:
            if start >= nb:
                continue
            end = min(end, nb)
            layout[h, start:end, :] = 1
            layout[h, :, start:end] = 1
        if self.attention == "unidirectional":
            layout[h] = np.tril(layout[h])
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_sliding_window_layout(h, layout)
            self.set_global_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)


def sparsity_config_from_dict(num_heads: int, cfg: dict) -> "SparsityConfig":
    """Build a SparsityConfig from a JSON ``sparse_attention`` block (the
    get_sparse_attention of upstream DeepSpeed, runtime/config.py:213): keys ``mode``
    ('dense'|'fixed'|'variable'|'bigbird'|'bslongformer'|
    'local_sliding_window') plus the per-mode kwargs of the classes above."""
    cfg = dict(cfg)
    mode = cfg.pop("mode", "fixed")
    classes = {
        "dense": DenseSparsityConfig,
        "fixed": FixedSparsityConfig,
        "variable": VariableSparsityConfig,
        "bigbird": BigBirdSparsityConfig,
        "bslongformer": BSLongformerSparsityConfig,
        "local_sliding_window": LocalSlidingWindowSparsityConfig,
    }
    if mode not in classes:
        raise NotImplementedError(
            f"Given sparsity mode, {mode}, has not been implemented yet!"
        )
    return classes[mode](num_heads=num_heads, **cfg)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Plain sliding window (DeepSpeed :678); fork addition for GPT-NeoX."""

    def __init__(self, num_heads, block=16, num_sliding_window_blocks=3,
                 attention="unidirectional"):
        super().__init__(num_heads, block)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def set_sliding_window_layout(self, h, layout):
        return _sliding_window(layout, h, self.num_sliding_window_blocks,
                               self.attention == "bidirectional")

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            self.set_sliding_window_layout(h, layout)
        return self.check_and_propagate_first_head_layout(layout)
