"""2-bit packed DNA sequence codec (host side, vectorized numpy).

Replaces the reference's dynamic `Bitset` + `Read` classes
(ref: src/DataStructures/Bitset.cpp, src/DataStructures/Read.cpp:40-68)
with fixed-width array layout: a batch of N reads is

    packed : uint32[N, W]   (base i of a read lives in word i//16,
                             bits 2*(i%16) .. 2*(i%16)+1, little-endian —
                             the same bit order as the reference Bitset,
                             so block-level comparisons agree)
    lengths: int32[N]

Encoding A=0, C=1, G=2, T=3 (ref: Read.cpp:45-65; N encodes as 0 there,
but N-containing reads are dropped/randomized upstream like
InputReader.cpp:317-336).  Complement is `base ^ 3`.

A copy of alga_tpu/core/packing.py, kept in step with it: the port
imports nothing of alga_tpu, whose package imports jax.
"""

from __future__ import annotations

import numpy as np

BASES_PER_WORD = 16
BASE_BITS = 2

# byte value -> 2-bit code; everything unknown maps to 0 (like ref 'N'->00)
_CODE_LUT = np.zeros(256, dtype=np.uint8)
_CODE_LUT[ord("A")] = 0
_CODE_LUT[ord("C")] = 1
_CODE_LUT[ord("G")] = 2
_CODE_LUT[ord("T")] = 3
_CODE_LUT[ord("a")] = 0
_CODE_LUT[ord("c")] = 1
_CODE_LUT[ord("g")] = 2
_CODE_LUT[ord("t")] = 3

_BASE_CHARS = np.frombuffer(b"ACGT", dtype=np.uint8)

_SHIFTS = (np.arange(BASES_PER_WORD, dtype=np.uint32) * BASE_BITS).astype(np.uint32)


def words_for(length: int) -> int:
    return -(-int(length) // BASES_PER_WORD)


def codes_to_packed(codes: np.ndarray, lengths: np.ndarray, width_words: int | None = None) -> np.ndarray:
    """Pack a base-code matrix uint8[N, Lpad] into uint32[N, W] words.

    Two uint8 halving passes + a little-endian uint32 reinterpret — ~10x
    cheaper than widening every base to uint32 and summing 16 shifts."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n, lpad = codes.shape
    w = words_for(lpad) if width_words is None else width_words
    full = np.zeros((n, w * BASES_PER_WORD), dtype=np.uint8)
    full[:, :lpad] = codes
    # zero out any junk beyond each read's length so padded tails are 0 (='A'
    # but masked everywhere by `lengths`)
    col = np.arange(w * BASES_PER_WORD, dtype=np.int64)[None, :]
    full[col >= np.asarray(lengths, dtype=np.int64)[:, None]] = 0
    # 2-bit -> 4-bit -> 8-bit combine, then 4 bytes/word reinterpret
    a = full[:, 0::2] | (full[:, 1::2] << 2)
    b = a[:, 0::2] | (a[:, 1::2] << 4)
    return np.ascontiguousarray(b).view(np.uint32)


def packed_to_codes(packed: np.ndarray, max_len: int | None = None) -> np.ndarray:
    """Unpack uint32[N, W] to uint8[N, W*16] base codes (caller masks by
    length).  Little-endian byte reinterpret + two uint8 doubling passes —
    ~8x cheaper than widening every word to uint32 lanes."""
    n, w = packed.shape
    by = np.ascontiguousarray(packed, dtype=np.uint32).view(np.uint8)
    a = np.empty((n, w * 8), dtype=np.uint8)        # 2 bases per nibble
    a[:, 0::2] = by & 0xF
    a[:, 1::2] = by >> 4
    codes = np.empty((n, w * BASES_PER_WORD), dtype=np.uint8)
    codes[:, 0::2] = a & 3
    codes[:, 1::2] = a >> 2
    if max_len is not None:
        codes = codes[:, :max_len]
    return codes


def strings_to_byte_matrix(seqs: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """Raw ASCII byte matrix uint8[N, Lpad] (0-padded) + lengths, built by
    one concatenation + boolean scatter (no per-read Python loop)."""
    n = len(seqs)
    lengths = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=n)
    lpad = int(lengths.max()) if n else 0
    mat = np.zeros((n, lpad), dtype=np.uint8)
    if n and lpad:
        flat = np.frombuffer("".join(seqs).encode("ascii"), dtype=np.uint8)
        mask = np.arange(lpad, dtype=np.int64)[None, :] < lengths[:, None]
        mat[mask] = flat          # row-major mask order == concatenation order
    return mat, lengths


def strings_to_codes(seqs: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """Encode python strings into a padded uint8 code matrix + lengths."""
    mat, lengths = strings_to_byte_matrix(seqs)
    return _CODE_LUT[mat], lengths.astype(np.int32)


def pack_strings(seqs: list[str], width_words: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    codes, lengths = strings_to_codes(seqs)
    return codes_to_packed(codes, lengths, width_words), lengths


def unpack_to_strings(packed: np.ndarray, lengths: np.ndarray) -> list[str]:
    codes = packed_to_codes(packed)
    out = []
    for i in range(packed.shape[0]):
        row = codes[i, : int(lengths[i])]
        out.append(_BASE_CHARS[row].tobytes().decode("ascii"))
    return out


def revcomp_codes(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Reverse-complement each row of a code matrix in place of its length.

    Vectorized: complement = code ^ 3 (A<->T, C<->G), then per-row reversal
    via index arithmetic (position j -> length-1-j, padded tail stays 0).
    """
    n, lpad = codes.shape
    comp = codes ^ np.uint8(3)
    lengths = np.asarray(lengths, dtype=np.int64)
    col = np.arange(lpad, dtype=np.int64)[None, :]
    src = lengths[:, None] - 1 - col
    valid = src >= 0
    src = np.where(valid, src, 0)
    out = np.take_along_axis(comp, src, axis=1)
    out[~valid] = 0
    return out


def base_at(packed: np.ndarray, rows: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """Gather base codes at (row, position) pairs from packed words (numpy)."""
    rows = np.asarray(rows, dtype=np.int64)
    positions = np.asarray(positions, dtype=np.int64)
    words = packed[rows, positions >> 4]
    return ((words >> ((positions & 15) * BASE_BITS).astype(np.uint32)) & np.uint32(3)).astype(np.uint8)
