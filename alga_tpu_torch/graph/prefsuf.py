"""GCPS graph routing (port of alga_tpu/graph/prefsuf.py).

Three engines build the same graph: the fused one-pass device path
(graph/device_join.py) for short-read batches under its packed-key
limits, the blocked device path (graph/device_scale.py) at any size, and
the host route, which takes long sequences: the contig-trim graph.  The
host route is the native engine's fused join, which rolls only the last
`cap` windows of each sequence (alga_tpu/graph/prefsuf.py:97-119,312-315),
or, when the engine is not loaded, `find_exact_overlaps` (one window-hash
join and a packed verify, both on the host or on the device by size)
followed by the numpy post-match build `gcps_from_matches`
(alga_tpu/graph/prefsuf.py:121-227,316-387).

ALGA_GCPS_DEVICE=small|wide|off forces the fused path, the blocked path
or the host route, as it does in the JAX package; `small` falls through
with a notice when the input breaks the fused path's limits.  Without
it, a CUDA device follows the JAX package's accelerator rule
(alga_tpu/graph/prefsuf.py:275-309): graphs of 2^18 windows or more take
the fused path under its limits and the blocked path above them, smaller
ones the host route.  On the CPU every short-read graph takes the
blocked path.  Sequences longer than cap + cap/4 stay on the host.

The native fused join packs each prefix-key run's length into 24 bits
(native/alga_host.cpp:1857,2441); a run of NATIVE_RUN_LIMIT rows or more
takes `find_exact_overlaps` instead, whose join keeps 64-bit counts.

The graph is order-free: ring survivors are the last `soes` matches per
source below `rsoe`, the latest instance of a pair wins, and a pair is
cut iff a later regime-2 match dominates it (the JAX module's docstring
derives this from ref GraphCreatorPrefSuf.cpp:397-483).
"""

from __future__ import annotations

import os
import sys
from typing import NamedTuple

import numpy as np

from alga_tpu_torch import device as device_mod
from alga_tpu_torch import native
from alga_tpu_torch.core import packing
from alga_tpu_torch.graph.device_join import gcps_graph_device
from alga_tpu_torch.graph.device_scale import gcps_graph_device_scale
from alga_tpu_torch.graph.overlap_graph import OverlapGraph
from alga_tpu_torch.ops import bitops, hashes
from alga_tpu_torch.utils import timers

# the native fused join's table holds a key run's length in 24 bits
NATIVE_RUN_LIMIT = 1 << 24


class OverlapMatches(NamedTuple):
    """All exact suffix(B)-prefix(C) matches: B[lenB-ell:] == C[:ell]
    (alga_tpu's dataclass, as a tuple: the device path's callers unpack
    it)."""
    src: np.ndarray   # B  int64[M]
    dst: np.ndarray   # C  int64[M]
    ell: np.ndarray   # overlap length int64[M]


def _no_matches() -> OverlapMatches:
    z = np.zeros(0, dtype=np.int64)
    return OverlapMatches(z, z.copy(), z.copy())


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated."""
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.repeat(np.cumsum(counts) - counts, counts)
    return np.arange(total, dtype=np.int64) - starts


def find_exact_overlaps(packed, lengths, ell_min: int, cap: int,
                        align_from=None, align_to=None,
                        chunk: int = 4_000_000, codes=None, *,
                        device=None) -> OverlapMatches:
    """Every exact suffix-prefix overlap of length in [ell_min, cap] of
    the numpy read store (`packed` uint32[N, W]): ell_min <= ell <=
    min(len_B, len_C, cap), B != C (ref GCPS sweep semantics).

    One join of window k-mer keys (k = ell_min) against prefix keys, then
    a packed verify of every candidate; the hashes and the verify run on
    the host or on `device` by batch size (hashes.window_keys,
    bitops.substr_equal_auto).  Sequences longer than cap + cap/4 hash a
    tail-compacted matrix: only their last `cap` bases can hold a suffix
    window."""
    lengths = np.asarray(lengths, dtype=np.int64)
    n = len(lengths)
    if n == 0 or ell_min <= 0:
        return _no_matches()
    max_len = int(lengths.max())
    k = int(ell_min)
    if max_len < k:
        return _no_matches()
    af = (np.ones(n, dtype=bool) if align_from is None
          else np.asarray(align_from, dtype=bool))
    at = (np.ones(n, dtype=bool) if align_to is None
          else np.asarray(align_to, dtype=bool))

    if max_len > cap + (cap >> 2):
        if codes is None:
            codes = packing.packed_to_codes(packed, max_len)
        eff = np.minimum(lengths, cap)
        start = lengths - eff
        capm = int(eff.max())
        cols = np.arange(capm, dtype=np.int64)[None, :]
        src = np.minimum(start[:, None] + cols, max_len - 1)
        tail = np.take_along_axis(codes[:, :max_len], src, axis=1)
        keys, wvalid = hashes.window_keys(None, tail, eff, k, capm - k + 1,
                                          device=device)
        wvalid = wvalid & af[:, None]
        pref_key_arr = hashes.window_keys(None, codes[:, :k], lengths, k, 1,
                                          device=device)[0][:, 0]
        wB, wp_t = np.nonzero(wvalid)
        wp = start[wB] + wp_t                 # original window position
        wkeys = keys[wB, wp_t]
    else:
        num_windows = max_len - k + 1
        keys, wvalid = hashes.window_keys(packed, codes, lengths, k,
                                          num_windows, device=device)
        # window (B, p) is the candidate overlap ell = len_B - p; keep
        # ell <= cap  <=>  p >= len_B - cap
        pos = np.arange(num_windows, dtype=np.int64)[None, :]
        wvalid = wvalid & af[:, None] & (pos >= (lengths[:, None] - cap))
        pref_key_arr = keys[:, 0]
        wB, wp = np.nonzero(wvalid)
        wkeys = keys[wB, wp]

    # prefix side
    pref_ids = np.flatnonzero((lengths >= k) & at)
    pref_keys = pref_key_arr[pref_ids]
    order = np.argsort(pref_keys, kind="stable")
    pref_ids_sorted = pref_ids[order]
    pref_keys_sorted = pref_keys[order]

    out_src, out_dst, out_ell = [], [], []
    W_verify = packing.words_for(min(max_len, cap))
    use_native_join = native.available()
    for lo_i in range(0, len(wB), chunk):
        sl = slice(lo_i, lo_i + chunk)
        cB, cp, ck = wB[sl], wp[sl], wkeys[sl]
        if use_native_join:
            lo, counts = native.join_ranges(pref_keys_sorted, ck)
        else:
            lo = np.searchsorted(pref_keys_sorted, ck, side="left")
            counts = np.searchsorted(pref_keys_sorted, ck, side="right") - lo
        if counts.sum() == 0:
            continue
        B_rep = np.repeat(cB, counts)
        p_rep = np.repeat(cp, counts)
        C = pref_ids_sorted[_ragged_arange(counts) + np.repeat(lo, counts)]
        ell = lengths[B_rep] - p_rep
        keep = (B_rep != C) & (lengths[C] >= ell)
        B_rep, p_rep, C, ell = B_rep[keep], p_rep[keep], C[keep], ell[keep]
        if len(B_rep) == 0:
            continue
        ok = bitops.substr_equal_auto(packed, codes, B_rep, p_rep, C, ell,
                                      W_verify, device=device)
        out_src.append(B_rep[ok])
        out_dst.append(C[ok])
        out_ell.append(ell[ok])

    if not out_src:
        return _no_matches()
    m = OverlapMatches(np.concatenate(out_src), np.concatenate(out_dst),
                       np.concatenate(out_ell))
    timers.bump("gcps_matches", len(m.src))   # ref GCPS.h:111-118 counters
    return m


def _regime1_ring_survivors(m: OverlapMatches, rsoe: int, soes: int):
    """Per source B, the last `soes` matches with ell < rsoe in the
    canonical arrival order (ell asc, then dst asc): the ring buffer of
    ref GCPS.cpp:397-401."""
    r1 = m.ell < rsoe
    src, dst, ell = m.src[r1], m.dst[r1], m.ell[r1]
    if len(src) == 0:
        return src, dst, ell
    order = np.lexsort((dst, ell, src))
    src, dst, ell = src[order], dst[order], ell[order]
    # position within each src group, from the end
    group_start = np.ones(len(src), dtype=bool)
    group_start[1:] = src[1:] != src[:-1]
    starts_idx = np.flatnonzero(group_start)
    group_id = np.cumsum(group_start) - 1
    counts = np.diff(np.append(starts_idx, len(src)))
    pos_in_group = np.arange(len(src)) - starts_idx[group_id]
    keep = pos_in_group >= (counts[group_id] - soes)
    return src[keep], dst[keep], ell[keep]


def gcps_from_matches(n: int, m: OverlapMatches, packed, lengths,
                      rsoe: int, soes: int = 3, pair_chunk: int = 4_000_000,
                      codes=None, *, device=None) -> OverlapGraph:
    """The GCPS graph of the matches `m` (numpy twin of
    native.gcps_from_matches): ring survivors plus every regime-2 match,
    the latest instance (max ell) of each (src, dst) pair, less the pairs
    dominated by a later regime-2 arrival B->C: offset_b > 0,
    offset_a >= offset_b, A != B, len_B + (offset_a-offset_b) - len_A >= 0
    and A[offset_a-offset_b : offset_a] == B[0 : offset_b]."""
    lengths = np.asarray(lengths, dtype=np.int64)
    s1, d1, e1 = _regime1_ring_survivors(m, rsoe, soes)
    r2 = m.ell >= rsoe
    s2, d2, e2 = m.src[r2], m.dst[r2], m.ell[r2]

    ps = np.concatenate([s1, s2])
    pd = np.concatenate([d1, d2])
    pe = np.concatenate([e1, e2])
    if len(ps) == 0:
        return OverlapGraph.empty(n)
    order = np.lexsort((pe, pd, ps))
    ps, pd, pe = ps[order], pd[order], pe[order]
    last = np.ones(len(ps), dtype=bool)
    last[:-1] = (ps[1:] != ps[:-1]) | (pd[1:] != pd[:-1])
    ps, pd, pe = ps[last], pd[last], pe[last]
    p_off = lengths[ps] - pe

    # ---- domination pruning by regime-2 arrivals --------------------------
    removed = np.zeros(len(ps), dtype=bool)
    if len(s2):
        r_off = lengths[s2] - e2
        # removers grouped by dst
        rorder = np.lexsort((s2, e2, d2))
        rs, rd, re_, ro = s2[rorder], d2[rorder], e2[rorder], r_off[rorder]
        r_start = np.searchsorted(rd, np.arange(n))
        r_end = np.searchsorted(rd, np.arange(n), side="right")
        cnt = r_end[pd] - r_start[pd]
        # chunk over pair instances to bound the cross-product
        i = 0
        csum = np.cumsum(cnt)
        while i < len(ps):
            base = csum[i - 1] if i > 0 else 0
            j = int(np.searchsorted(csum, base + pair_chunk)) + 1
            j = min(max(j, i + 1), len(ps))
            c = cnt[i:j]
            if c.sum() > 0:
                pair_rep = np.repeat(np.arange(i, j), c)
                ridx = _ragged_arange(c) + np.repeat(r_start[pd[i:j]], c)
                A, offA, ellA = ps[pair_rep], p_off[pair_rep], pe[pair_rep]
                B, offB, ellB = rs[ridx], ro[ridx], re_[ridx]
                # stamp order: (ell, src) lexicographic, remover strictly later
                later = (ellB > ellA) | ((ellB == ellA) & (B > A))
                cond = (later & (B != A) & (offB > 0) & (offA >= offB)
                        & (lengths[B] + (offA - offB) - lengths[A] >= 0))
                if cond.any():
                    ci = np.flatnonzero(cond)
                    # words of the longest compare (the JAX module passes
                    # min(max_len, cap), which its numpy twin ignores and
                    # its device verify would cut short past cap)
                    okm = bitops.substr_equal_auto(
                        packed, codes, A[ci], (offA - offB)[ci], B[ci],
                        offB[ci], packing.words_for(int(offB[ci].max())),
                        device=device)
                    removed[pair_rep[ci[okm]]] = True
            i = j

    keep = ~removed
    return OverlapGraph(n, ps[keep].astype(np.int32),
                        pd[keep].astype(np.int32),
                        p_off[keep].astype(np.int32))


def _longest_run(sorted_keys: np.ndarray) -> int:
    """Length of the longest run of equal values in `sorted_keys`."""
    if len(sorted_keys) == 0:
        return 0
    starts = np.flatnonzero(np.r_[True, sorted_keys[1:] != sorted_keys[:-1]])
    return int(np.diff(np.r_[starts, len(sorted_keys)]).max())


def host_gcps_graph(packed, lengths, n: int, ell_min: int, cap: int,
                    rsoe: int, soes: int = 3, align_from=None,
                    align_to=None, *, device=None):
    """GCPS graph on the host route: the native engine's prefix keys,
    fused join + verify straight from the packed store and post-match
    stages when it is loaded (`find_exact_overlaps` in place of the fused
    join when a prefix-key run reaches NATIVE_RUN_LIMIT rows); else
    `find_exact_overlaps` and `gcps_from_matches`, their hashes and
    verifies on `device` for large batches."""
    lengths = np.asarray(lengths, dtype=np.int64)
    k = int(ell_min)
    max_len = int(lengths.max(initial=0))
    if n == 0 or k <= 0 or max_len < k:
        return OverlapGraph.empty(n)
    packed = np.asarray(packed)
    if not native.available():
        # one unpack for the window hashes and both verifies
        codes = packing.packed_to_codes(packed, max_len)
        m = find_exact_overlaps(packed, lengths, ell_min, cap, align_from,
                                align_to, codes=codes, device=device)
        return gcps_from_matches(n, m, packed, lengths, rsoe, soes,
                                 codes=codes, device=device)
    af = (np.ones(n, dtype=bool) if align_from is None
          else np.asarray(align_from, dtype=bool))
    at = (np.ones(n, dtype=bool) if align_to is None
          else np.asarray(align_to, dtype=bool))
    pref_ids = np.flatnonzero((lengths >= k) & at)
    pk = native.prefix_keys(packed, pref_ids, k, hashes.A1, hashes.A2)
    order = np.argsort(pk, kind="stable")
    if _longest_run(pk[order]) >= NATIVE_RUN_LIMIT:
        m = find_exact_overlaps(packed, lengths, ell_min, cap, af, at,
                                device=device)
        return native.gcps_from_matches(n, m, packed, lengths, rsoe, soes)
    src, dst, ell = native.gcps_join_verify_packed(
        n, max_len - k + 1, lengths, af & (lengths >= k), k, cap,
        hashes.A1, hashes.A2, pk[order], pref_ids[order].astype(np.int32),
        packed)
    timers.bump("gcps_matches", len(src))
    return native.gcps_from_matches(n, OverlapMatches(src, dst, ell), packed,
                                    lengths, rsoe, soes)


def build_gcps_graph(packed, lengths, n: int, ell_min: int, cap: int,
                     rsoe: int, soes: int = 3, align_from=None,
                     align_to=None, *, device=None):
    """Full GCPS graph: orientation src→dst where dst's prefix equals
    src's suffix, offset = len(src) - ell.  Deterministic."""
    lengths_np = _numpy(lengths)
    max_len = int(lengths_np.max(initial=0))
    n_windows = max(0, max_len - int(ell_min) + 1)
    force = os.environ.get("ALGA_GCPS_DEVICE", "")
    # the fused path's packed sort keys need ids < 2^22 and lengths < 1024;
    # its automatic use stops at 2^19 reads, as in the JAX package
    small_safe = n_windows <= 4096 and n < (1 << 22) and max_len < 1024
    if force == "small" and not small_safe:
        print("[alga_tpu] ALGA_GCPS_DEVICE=small ignored: input "
              f"violates fused-path preconditions (n={n}, "
              f"max_len={max_len}, n_windows={n_windows}); "
              "falling through to wide/host routing", file=sys.stderr)
        force = ""
    args = (packed, lengths, n, ell_min, cap, rsoe, soes, align_from,
            align_to)
    on_cuda = device_mod.resolve(device).type == "cuda"
    # on CUDA a device path needs alga_tpu's accelerator size term; the
    # CPU keeps the blocked path for every short-read graph
    big_enough = len(lengths_np) * n_windows >= 1 << 18
    if force == "small" or (not force and on_cuda and big_enough
                            and small_safe and n < (1 << 19)):
        return gcps_graph_device(*args, device=device)
    if force == "wide" or (not force and max_len <= cap + (cap >> 2)
                           and (big_enough or not on_cuda)):
        return gcps_graph_device_scale(*args, device=device)
    packed = _numpy(packed)
    if packed.dtype == np.int32:
        packed = packed.view(np.uint32)
    return host_gcps_graph(packed, lengths_np, n, ell_min, cap, rsoe, soes,
                           _numpy(align_from), _numpy(align_to),
                           device=device)


def _numpy(x):
    """numpy array of a tensor (fetched from its device) or array-like;
    None stays None."""
    if x is None:
        return None
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
