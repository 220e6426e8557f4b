"""Collation: fixed-window stacking and ragged-document packing.

Counterpart of deeperspeed_tpu/datapipe/collator.py. ``stack_collate``
is the synchronous loader's collate (runtime/dataloader.py), so the two
cannot diverge. ``SequencePacker`` packs the tokens of consecutive
documents greedily, in order, into fixed ``(rows, seq_len + 1)`` batches
with an optional EOS separator and per-token segment ids. Packing is
deterministic, and a document split by a batch boundary is named by its
``(cursor, tail offset)`` pair, so the next batch resumes its remainder:
no token is lost to packing.
"""

from typing import Iterable, Optional, Tuple

import numpy as np

from ..runtime.dataloader import _default_collate as stack_collate

__all__ = ["SequencePacker", "stack_collate"]


class SequencePacker:
    """Greedy in-order packer of 1-D token arrays into fixed rows.

    A document longer than the space left in a row spills into the next
    row, where its continuation becomes that row's segment 1. Segment
    ids are 1-based per row; 0 marks padding.
    """

    def __init__(self, seq_len: int, pad_id: int = 0,
                 eos_id: Optional[int] = None, dtype=np.int32):
        self.row_len = int(seq_len) + 1
        self.pad_id = int(pad_id)
        self.eos_id = eos_id
        self.dtype = np.dtype(dtype)

    def doc_tokens(self, doc) -> np.ndarray:
        doc = np.asarray(doc).reshape(-1)
        if self.eos_id is not None:
            doc = np.concatenate(
                [doc, np.array([self.eos_id], dtype=doc.dtype)])
        return doc

    def pack(self, docs: Iterable, rows: int,
             first_offset: int = 0
             ) -> Tuple[np.ndarray, np.ndarray, int, int]:
        """Pack ``docs`` into ``(tokens, segment_ids, used, tail_offset)``.

        ``docs`` may be a lazy iterable; it is consumed only until the
        ``rows`` rows are full. ``used`` counts documents consumed
        completely. A document cut off by the end of the batch is not
        counted: ``tail_offset`` says how far into its (EOS-augmented)
        tokens the batch reached, and the next batch resumes there via
        ``first_offset``.
        """
        tokens = np.full((rows, self.row_len), self.pad_id, self.dtype)
        segs = np.zeros((rows, self.row_len), np.int32)
        r, col, seg = 0, 0, 0
        used = 0
        first = True
        for doc in docs:
            flat = self.doc_tokens(doc)
            start = 0
            if first:
                start = min(int(first_offset), flat.size)
                first = False
            if r >= rows:
                break
            # a document that cannot start in the remaining space of the
            # last row is left for the next batch; mid-batch it spills
            # into the next row instead
            if col >= self.row_len:
                r, col, seg = r + 1, 0, 0
                if r >= rows:
                    break
            seg += 1
            pos = start
            while pos < flat.size and r < rows:
                space = self.row_len - col
                take = min(space, flat.size - pos)
                tokens[r, col:col + take] = flat[pos:pos + take]
                segs[r, col:col + take] = seg
                col += take
                pos += take
                if col >= self.row_len and pos < flat.size:
                    r, col = r + 1, 0
                    seg = 1  # a new row restarts the segment numbering
            if pos < flat.size:
                # out of rows mid-document: the next batch resumes at pos
                return tokens, segs, used, pos
            used += 1
        return tokens, segs, used, 0
