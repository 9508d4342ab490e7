"""Fused small-batch GCPS (port of alga_tpu/graph/device_join.py), and the
row-prefetched packed compares that graph/device_scale.py shares.

The GCPS graph of a short-read batch in one pass over all of its windows,
with no split into source blocks (ref GraphCreatorPrefSuf.cpp:73-126,
397-483, in the order-free form documented in alga_tpu/graph/prefsuf.py):

  1. `_keys_and_counts`: hash every window, sort the window keys, and
     probe each prefix read's key into them once (`searchsorted`);
  2. `_expand_verify`: expand the candidates by segments, keep those
     whose exact packed compare holds;
  3. `_post_join_stage`: the regime-1 ring survivors, the max-ell
     instance per (src, dst) pair, and the regime-2 removers sorted by
     (dst, off) with each pair's count of eligible removers;
  4. `_dominate_and_compact`: the expansion over (pair, eligible
     remover), the domination predicate, and the surviving edges.

The JAX module packs `(id << 10) | field` into uint32 keys and sorts two
of them; here both fold into one int64 key (`_fold`) under one sort.
That needs ids < 2^22 and fields < 1024, which `gcps_graph_device`
checks, and which the routing in graph/prefsuf.py respects.

Every tensor is sized from the data: each stage reads its total on the
host and allocates that much.  So the JAX module's capacity machinery has
no counterpart: not `_round_cap`, `_caps`, the hint file
`gcps_cap_hints.json` (device_join.py:345-423), nor the retry loop
(:487-518).  Nor has its sentinel key 0xFFFFFFFF: invalid windows and
padded rows are dropped before a sort instead of sorting last in it.
The edges, and their (src, dst) row order, equal the JAX module's.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from alga_tpu_torch import device as device_mod
from alga_tpu_torch.core import packing
from alga_tpu_torch.graph.overlap_graph import OverlapGraph
from alga_tpu_torch.ops import hashes
from alga_tpu_torch.ops.bitops import M32, _low_mask, _pad_words
from alga_tpu_torch.store import words_as_int32
from alga_tpu_torch.utils import timers

# the exact overlaps, as native.gcps_from_matches reads them
Matches = namedtuple("Matches", "src dst ell")

_VERIFY_CHUNK = 1 << 22  # candidate compares per row-gather batch


def _word_at(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """rows[m, idx[m]] for int64 rows[M, Wp] and a per-row word index."""
    return rows.gather(1, idx[:, None])[:, 0]


def _substr_eq_rows(rows_a, start, rows_b, match_len,
                    num_words: int) -> torch.Tensor:
    """bool[M]: A[start+t] == B[t] for t < min(match_len, 16*num_words),
    on prefetched padded int64 rows (one row gather upstream)."""
    wa = rows_a.shape[1] - 1
    wb = rows_b.shape[1] - 1
    sb = (start & 15) * 2
    sw0 = start >> 4
    eq = torch.ones(rows_a.shape[0], dtype=torch.bool, device=rows_a.device)
    for w in range(num_words):
        lo = _word_at(rows_a, (sw0 + w).clamp(max=wa))
        hi = _word_at(rows_a, (sw0 + w + 1).clamp(max=wa))
        a_word = (lo >> sb) | torch.where(sb == 0, 0, (hi << (32 - sb)) & M32)
        b_word = rows_b[:, min(w, wb - 1)]
        rem = (match_len - 16 * w).clamp(0, 16)
        eq &= ((a_word ^ b_word) & _low_mask(2 * rem)) == 0
    return eq


def _verify(packed_pad, a, start, b, length, num_words: int) -> torch.Tensor:
    """_substr_eq_rows over row gathers, in bounded batches."""
    out = torch.empty(a.shape[0], dtype=torch.bool, device=a.device)
    for i in range(0, a.shape[0], _VERIFY_CHUNK):
        s = slice(i, i + _VERIFY_CHUNK)
        out[s] = _substr_eq_rows(packed_pad[a[s]], start[s], packed_pad[b[s]],
                                 length[s], num_words)
    return out


def _ragged_arange(counts: torch.Tensor, total: int):
    """(owner, rank): for t < total, the index of the count block holding
    slot t and t's rank inside that block."""
    owner = torch.repeat_interleave(counts, output_size=total)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(total, device=counts.device) - starts[owner]
    return owner, rank


def _dom_cond(A, ellA, offA, Br, ellB, offB) -> torch.Tensor:
    """bool per (pair A, remover B) slot: the domination predicate short
    of the packed compare (ref GCPS.cpp:434-451): B is later (larger ell,
    then larger id), offB > 0, offA >= offB, A != B, and B ends at or past
    A's end."""
    later = (ellB > ellA) | ((ellB == ellA) & (Br > A))
    return (later & (Br != A) & (offB > 0) & (offA >= offB)
            & ((offB + ellB) + (offA - offB) - (offA + ellA) >= 0))


def _dominated(packed_pad, A, ellA, offA, Br, ellB, offB,
               W3: int) -> torch.Tensor:
    """bool per (pair A, remover B) slot: B dominates A: `_dom_cond` and
    A[offA-offB : offA] == B[0 : offB]."""
    cond = _dom_cond(A, ellA, offA, Br, ellB, offB)
    sel = cond.nonzero()[:, 0]
    cond[sel] = _verify(packed_pad, A[sel], (offA - offB)[sel], Br[sel],
                        offB[sel], W3)
    return cond


def _as_tensor(x, dtype, dev, default_len: int | None = None):
    """`x` (numpy or tensor) on `dev`; None becomes all ones of
    `default_len`.  uint32 words become their int32 bits."""
    if x is None:
        return torch.ones(default_len, dtype=dtype, device=dev)
    if isinstance(x, np.ndarray):
        if dtype == torch.int32 and x.dtype == np.uint32:
            x = words_as_int32(x)
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=dev, dtype=dtype)


def _fold(k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """One int64 key per row whose order is the unsigned lexicographic
    order of the 32-bit keys (k1, k2).  k1 is shifted down by 2^31 first,
    so that k1 * 2^32 stays inside int64."""
    return (k1 - (1 << 31)) * (1 << 32) + k2


# ---------------------------------------------------------------------------
# stage 1: window keys and per-prefix candidate counts

def _keys_and_counts(packed, lengths, af, at, k: int, num_windows: int,
                     cap: int):
    """(wB, wp, lo, counts): the live windows (B, p) in the order of their
    sorted A1 keys, and for every read the first rank `lo` and the number
    `counts` of windows sharing its prefix key (0 unless len >= k and
    at).

    A window (B, p) is live iff p + k <= len_B, af[B] and p >= len_B - cap
    (overlap ell = len_B - p <= cap).  Only the A1 hash is needed: every
    candidate is verified by exact packed compare (the reference trusts
    its double hash instead, GCPS.cpp:385-387)."""
    k1 = hashes._rolling_hash(packed, k, num_windows, hashes.A1)
    lens = lengths.to(torch.int64)
    pos = torch.arange(num_windows, device=packed.device)[None, :]
    wvalid = ((pos + k <= lens[:, None]) & af[:, None]
              & (pos >= lens[:, None] - cap))
    wB, wp = wvalid.nonzero(as_tuple=True)
    wkeys, worder = torch.sort(k1[wB, wp], stable=True)
    pvalid = (lens >= k) & at
    pk1 = k1[:, 0].contiguous()
    lo = torch.searchsorted(wkeys, pk1)
    counts = torch.where(
        pvalid, torch.searchsorted(wkeys, pk1, right=True) - lo, 0)
    return wB[worder], wp[worder], lo, counts


# ---------------------------------------------------------------------------
# stage 2: candidate expansion and exact verification

def _expand_verify(packed_pad, lengths, wB, wp, lo, counts, W: int):
    """(src, dst, ell) int64 of the verified matches, and the candidate
    total.  Candidate t belongs to prefix read C (its segment under
    counts); its window is (B, p) at rank lo[C] + rank(t), and it claims
    B[p : len_B] == C[0 : ell], ell = len_B - p."""
    total = int(counts.sum())
    C, rank = _ragged_arange(counts, total)
    widx = lo[C] + rank
    B, p = wB[widx], wp[widx]
    ell = lengths[B].to(torch.int64) - p
    idx = ((B != C) & (lengths[C] >= ell)).nonzero()[:, 0]
    B, C, p, ell = B[idx], C[idx], p[idx], ell[idx]
    ok = _verify(packed_pad, B, p, C, ell, W)
    return B[ok], C[ok], ell[ok], total


# ---------------------------------------------------------------------------
# stage 3: ring survivors, pair dedup, removers

def _post_join_stage(B, C, E, lengths, rsoe: int, soes: int):
    """From the matches produce
      pairs (src, dst, ell, off, first eligible remover) sorted by
        (src, dst), one per pair: the max-ell instance among the regime-1
        ring survivors and the regime-2 matches;
      removers (src, ell, off): the regime-2 matches sorted by (dst, off);
      cnt: each pair's number of eligible removers (same dst, off <= the
        pair's off), which with that sort are a prefix of its dst run."""
    lens = lengths.to(torch.int64)
    dev = B.device

    # regime-1 ring: per src the last `soes` in (ell asc, dst asc) order
    r1 = E < rsoe
    b1, e1, c1 = B[r1], E[r1], C[r1]
    _, perm = torch.sort(_fold((b1 << 10) | e1, c1))
    b1, e1, c1 = b1[perm], e1[perm], c1[perm]
    _, sizes = torch.unique_consecutive(b1, return_counts=True)
    group_end = torch.repeat_interleave(torch.cumsum(sizes, 0), sizes)
    ring = group_end - torch.arange(b1.numel(), device=dev) <= soes

    # pair instances = ring survivors + regime 2; the max-ell one per pair
    r2 = ~r1
    i_src = torch.cat([b1[ring], B[r2]])
    i_dst = torch.cat([c1[ring], C[r2]])
    i_ell = torch.cat([e1[ring], E[r2]])
    _, perm = torch.sort(_fold(i_src, (i_dst << 10) | i_ell))
    i_src, i_dst, i_ell = i_src[perm], i_dst[perm], i_ell[perm]
    last = torch.ones_like(i_src, dtype=torch.bool)
    last[:-1] = (i_src[1:] != i_src[:-1]) | (i_dst[1:] != i_dst[:-1])
    psrc, pdst, pell = i_src[last], i_dst[last], i_ell[last]
    p_off = lens[psrc] - pell

    # removers keyed (dst, off); ties may fall either way, since a pair is
    # dropped when ANY eligible remover dominates it
    rs, rd, re_ = B[r2], C[r2], E[r2]
    ro = lens[rs] - re_
    rkey, perm = torch.sort((rd << 10) | ro)
    rs, re_, ro = rs[perm], re_[perm], ro[perm]
    r_counts = torch.bincount(rd, minlength=lens.numel())
    p_rs = (torch.cumsum(r_counts, 0) - r_counts)[pdst]
    cnt = torch.searchsorted(rkey, (pdst << 10) | p_off, right=True) - p_rs
    return (psrc, pdst, pell, p_off, p_rs), (rs, re_, ro), cnt


# ---------------------------------------------------------------------------
# stage 4: domination and edge compaction

def _dominate_and_compact(packed_pad, pairs, removers, cnt, W3: int):
    """(src, dst, off) of the pairs that no eligible remover dominates,
    in pair order, and the number of (pair, remover) checks."""
    psrc, pdst, pell, p_off, p_rs = pairs
    rs, re_, ro = removers
    total = int(cnt.sum())
    pj, rank = _ragged_arange(cnt, total)
    ridx = p_rs[pj] + rank
    dom = _dominated(packed_pad, psrc[pj], pell[pj], p_off[pj],
                     rs[ridx], re_[ridx], ro[ridx], W3)
    keep = torch.ones_like(psrc, dtype=torch.bool)
    keep[pj[dom]] = False
    return psrc[keep], pdst[keep], p_off[keep], total


def _gcps_fused(packed, lengths, af, at, k: int, num_windows: int,
                cap: int, rsoe: int, soes: int, W: int):
    """The four stages chained: (src, dst, off) of the edges and the
    totals (candidates, matches, domination checks)."""
    packed_pad = _pad_words(packed)
    wB, wp, lo, counts = _keys_and_counts(packed, lengths, af, at, k,
                                          num_windows, cap)
    B, C, E, total = _expand_verify(packed_pad, lengths, wB, wp, lo,
                                    counts, W)
    del wB, wp, lo, counts
    pairs, removers, cnt = _post_join_stage(B, C, E, lengths, rsoe, soes)
    # domination compare width equals the host oracle's W_verify
    # (alga_tpu/graph/prefsuf.py:187)
    src, dst, off, exp_total = _dominate_and_compact(packed_pad, pairs,
                                                     removers, cnt, W)
    return (src, dst, off), (total, B.numel(), exp_total)


def _inputs(packed, lengths, n, align_from, align_to, device):
    dev = device_mod.resolve(device)
    packed = _as_tensor(packed, torch.int32, dev)
    lengths = _as_tensor(lengths, torch.int32, dev)
    af = _as_tensor(align_from, torch.bool, dev, n)
    at = _as_tensor(align_to, torch.bool, dev, n)
    return packed, lengths, af, at


def gcps_graph_device(packed, lengths, n: int, ell_min: int, cap: int,
                      rsoe: int, soes: int, align_from=None,
                      align_to=None, *, device=None):
    """Full GCPS graph on `device` in one pass: the same edges, in the
    same (src, dst) row order, as
    alga_tpu.graph.device_join.gcps_graph_device.

    Requires n < 2^22 and read length < 1024 (the packed sort keys) and
    raises ValueError otherwise.  `packed` is uint32[n, W] numpy or its
    int32 tensor; the other arrays are numpy arrays or tensors."""
    packed, lengths, af, at = _inputs(packed, lengths, n, align_from,
                                      align_to, device)
    max_len = int(lengths.max()) if n else 0
    k = int(ell_min)
    if n == 0 or max_len < k:
        return OverlapGraph.empty(n)
    if n >= (1 << 22) or max_len >= 1024:
        raise ValueError(
            "gcps_graph_device requires n < 2^22 and read length < 1024 "
            "(packed sort keys); route larger inputs through the host or "
            "sharded paths")
    W = packing.words_for(min(max_len, cap))
    (src, dst, off), (total, nmatch, exp_total) = _gcps_fused(
        packed, lengths, af, at, k, max_len - k + 1, int(cap), int(rsoe),
        int(soes), W)
    bump = timers.bump
    bump("gcps_candidates", total)
    bump("gcps_matches", nmatch)
    bump("gcps_domination_checks", exp_total)
    return OverlapGraph(n, *(x.to(torch.int32).cpu().numpy()
                                   for x in (src, dst, off)))


def find_exact_overlaps_device(packed, lengths, ell_min: int, cap: int,
                               align_from=None, align_to=None, *,
                               device=None) -> Matches:
    """The exact overlaps (src, dst, ell) as int64 numpy arrays: the match
    list of stages 1-2, the same matches in the same order as
    alga_tpu.graph.device_join.find_exact_overlaps_device."""
    n = len(lengths)
    packed, lengths, af, at = _inputs(packed, lengths, n, align_from,
                                      align_to, device)
    max_len = int(lengths.max()) if n else 0
    k = int(ell_min)
    if n == 0 or max_len < k:
        z = np.zeros(0, dtype=np.int64)
        return Matches(z, z.copy(), z.copy())
    wB, wp, lo, counts = _keys_and_counts(packed, lengths, af, at, k,
                                          max_len - k + 1, int(cap))
    B, C, E, _ = _expand_verify(_pad_words(packed), lengths, wB, wp, lo,
                                counts, packing.words_for(
                                    min(max_len, cap)))
    return Matches(*(x.cpu().numpy() for x in (B, C, E)))
