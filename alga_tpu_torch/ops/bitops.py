"""Packed-bit comparisons (port of alga_tpu/ops/bitops.py).

Layout: base i of a read sits at bits (2*(i%16), +1) of word i//16.  The
words arrive as int32 (the uint32 bits) and are widened to int64 masked
to 32 bits, so that right shifts are logical.  A substring view of read
A starting at base s is a funnel shift of two adjacent words.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def words64(packed: torch.Tensor) -> torch.Tensor:
    """int64 copy of int32-held uint32 words, in [0, 2^32)."""
    return packed.to(torch.int64) & M32


def _pad_words(packed: torch.Tensor) -> torch.Tensor:
    """int64 words with one zero word column appended, so that funnel
    shifts never index out of bounds."""
    w = words64(packed)
    return torch.cat([w, w.new_zeros((w.shape[0], 1))], dim=1)


def _low_mask(nbits: torch.Tensor) -> torch.Tensor:
    """int64 mask of the low `nbits` bits (0 <= nbits <= 32)."""
    return (torch.ones_like(nbits) << nbits) - 1


def _shifted_words(packed_pad, ids, start, w: int):
    """Word w of the 2-bit stream of read `ids` starting at base `start`."""
    sw = (start >> 4) + w
    sb = (start & 15) * 2
    wmax = packed_pad.shape[1] - 1
    lo = packed_pad[ids, sw.clamp(max=wmax)]
    hi = packed_pad[ids, (sw + 1).clamp(max=wmax)]
    # funnel shift; when sb == 0 the hi part must contribute nothing
    hi_part = torch.where(sb == 0, 0, (hi << (32 - sb)) & M32)
    return (lo >> sb) | hi_part


def substr_equal(packed, a_ids, a_starts, b_ids, match_lens,
                 num_words: int) -> torch.Tensor:
    """bool[M]: for each query, A[a_start + t] == B[t] for all t < match_len.

    num_words must be >= ceil(max(match_lens)/16)."""
    packed_pad = _pad_words(packed)
    a_ids = a_ids.to(torch.int64)
    b_ids = b_ids.to(torch.int64)
    a_starts = a_starts.to(torch.int64)
    match_lens = match_lens.to(torch.int64)
    ok = torch.ones(a_ids.shape[0], dtype=torch.bool, device=packed.device)
    for w in range(num_words):
        a_word = _shifted_words(packed_pad, a_ids, a_starts, w)
        b_word = packed_pad[b_ids, min(w, packed.shape[1] - 1)]
        # bases covered by this word: [16w, 16w+16); mask beyond match_len
        rem = (match_lens - 16 * w).clamp(0, 16)
        ok &= ((a_word ^ b_word) & _low_mask(2 * rem)) == 0
    return ok


def overlap_mismatch_count(packed, a_ids, a_starts, b_ids, match_lens,
                           num_words: int) -> torch.Tensor:
    """int64[M]: the number of bases t < match_len where A[a_start + t] !=
    B[t]; a base differs iff either of its two bits does."""
    packed_pad = _pad_words(packed)
    a_ids = a_ids.to(torch.int64)
    b_ids = b_ids.to(torch.int64)
    a_starts = a_starts.to(torch.int64)
    match_lens = match_lens.to(torch.int64)
    total = torch.zeros_like(a_ids)
    for w in range(num_words):
        a_word = _shifted_words(packed_pad, a_ids, a_starts, w)
        b_word = packed_pad[b_ids, min(w, packed.shape[1] - 1)]
        rem = (match_lens - 16 * w).clamp(0, 16)
        diff = (a_word ^ b_word) & _low_mask(2 * rem)
        total += popcount32((diff | (diff >> 1)) & 0x55555555)
    return total


def np_mismatch_count(codes, a_id, a_start, b_id, match_len) -> int:
    """Host oracle of overlap_mismatch_count for one query over a base-code
    matrix."""
    a = codes[a_id, a_start: a_start + match_len]
    b = codes[b_id, :match_len]
    return int((a != b).sum())


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in [0, 2^32) (SWAR: torch has no popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24
