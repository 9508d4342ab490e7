"""SeqBatch — a fixed-width batch of 2-bit packed reads.

The device-side replacement for the reference's `vector<Read*>` of
heap-allocated Bitset objects (ref: include/Global.h:124, Read.h:26).
All per-read metadata lives in parallel arrays so every stage can operate
as a vectorized array program.

Removed reads are represented by `valid=False` (the reference nulls the
pointer, ref: Global.cpp:48-59); lengths of invalid reads are kept so id
arithmetic (revcomp/pair) stays intact.

A copy of alga_tpu/core/seqbatch.py, kept in step with it: the port
imports nothing of alga_tpu, whose package imports jax.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from alga_tpu_torch.core import packing


@dataclass
class SeqBatch:
    packed: np.ndarray            # uint32[N, W]
    lengths: np.ndarray           # int32[N]
    valid: np.ndarray             # bool[N]
    # paired_offset[i] in {0,1,2}: 0 = no paired read, 1 = paired read at
    # i+2, 2 = paired read at i-2 (ref: Global::pairedReadOffset,
    # Read::getIdOfPairedRead(int), Read.cpp:261-291)
    paired_offset: np.ndarray = field(default=None)

    def __post_init__(self):
        if self.paired_offset is None:
            self.paired_offset = np.zeros(len(self.lengths), dtype=np.int8)

    # --- constructors -----------------------------------------------------

    @staticmethod
    def from_strings(seqs: list[str], width_words: int | None = None) -> "SeqBatch":
        packed, lengths = packing.pack_strings(seqs, width_words)
        return SeqBatch(packed, lengths, np.ones(len(seqs), dtype=bool))

    @staticmethod
    def from_codes(codes: np.ndarray, lengths: np.ndarray,
                   width_words: int | None = None) -> "SeqBatch":
        packed = packing.codes_to_packed(codes, lengths, width_words)
        return SeqBatch(packed, np.asarray(lengths, dtype=np.int32),
                        np.ones(len(lengths), dtype=bool))

    # --- accessors --------------------------------------------------------

    def __len__(self) -> int:
        return self.packed.shape[0]

    @property
    def width_words(self) -> int:
        return self.packed.shape[1]

    def to_strings(self) -> list[str]:
        return packing.unpack_to_strings(self.packed, self.lengths)

    def sequence(self, i: int) -> str:
        return packing.unpack_to_strings(self.packed[i : i + 1], self.lengths[i : i + 1])[0]

    def codes(self, max_len: int | None = None) -> np.ndarray:
        return packing.packed_to_codes(self.packed, max_len)

    def base_at(self, rows, positions) -> np.ndarray:
        return packing.base_at(self.packed, rows, positions)

    # --- id arithmetic (ref: Read.cpp:229-291) ----------------------------

    @staticmethod
    def revcomp_id(ids):
        """Reverse complement lives at id^1 (ref: Read::getIdOfCompRevRead)."""
        return np.asarray(ids) ^ 1

    def paired_id(self, ids):
        """Paired read id via the per-read offset table."""
        ids = np.asarray(ids)
        off = self.paired_offset[ids]
        return ids + np.where(off == 1, 2, np.where(off == 2, -2, 0))

    # --- mutation ---------------------------------------------------------

    def invalidate(self, ids) -> None:
        self.valid[np.asarray(ids)] = False

    def count_valid(self) -> int:
        return int(self.valid.sum())

    def avg_read_length(self) -> float:
        """Average over valid reads (ref: Global.h:133-145)."""
        if not self.valid.any():
            return 0.0
        return float(self.lengths[self.valid].mean())

    def compact(self) -> tuple["SeqBatch", np.ndarray]:
        """Drop invalid reads, returning (new batch, old-id -> new-id map).

        Mirror of the dense re-mapping in ref main.cpp:150-232 but as a pure
        function.  The caller is responsible for keeping the (r, rc, pair)
        block structure intact before calling (see pipeline.remap_reads).
        """
        keep = np.flatnonzero(self.valid)
        remap = np.full(len(self), -1, dtype=np.int64)
        remap[keep] = np.arange(len(keep))
        nb = SeqBatch(
            self.packed[keep],
            self.lengths[keep],
            np.ones(len(keep), dtype=bool),
            self.paired_offset[keep],
        )
        return nb, remap

    def copy(self) -> "SeqBatch":
        return SeqBatch(self.packed.copy(), self.lengths.copy(),
                        self.valid.copy(), self.paired_offset.copy())
