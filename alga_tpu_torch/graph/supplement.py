"""Error-tolerant graph supplement: LI minimizer k-mers + pairwise-kmer
branch verification (port of alga_tpu/graph/supplement.py).

The JAX module is host code except for its pair verification, but it
imports ops.align (and so jax) at the top.  This port keeps its calls
and its routing: the native engine, when it is loaded, extracts the LI
k-mers, sorts them, generates the PKB candidate pairs and replays the
reference's branch-marker loop; without it the numpy twins and the
Python replay do the same.  The unique (id1, id2, offset) triples are
verified by this package's `ach_batch_auto` on the given device, or
split over the ranks of a mesh by `ach_batch_mesh` in the ACLER-only
configuration.  See the JAX module's docstring for the execution model
(ref GraphCreatorLI.cpp, GraphCreatorPairwiseKmerBranch.cpp,
main.cpp:300-355).
"""

from __future__ import annotations

import numpy as np

from alga_tpu_torch import native
from alga_tpu_torch.core import packing
from alga_tpu_torch.ops.align import ach_batch_auto, ach_batch_mesh

_U64MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def li_kmers(codes, lengths, valid, priorities: list[int], k: int,
             intervals: int, chunk_cells: int = 1 << 24, packed=None):
    """(read_id, ind_in_read, key_hi, key_lo): for each valid read of
    length >= k and each of `intervals` position intervals, the window
    whose sequence remapped through `priorities` is lexicographically
    smallest, the first on ties (ref Read.cpp:145-226, strict '<').

    The native pass reads `packed` when the engine is loaded.  Otherwise
    numpy runs over `codes` uint8[N, L], or, when `codes` is None,
    unpacks each chunk's rows from `packed`, so that no uint8[N, L]
    matrix of the whole store is built.  Rows come in (interval, read)
    order, the native pass's in (read, interval): callers re-sort, so
    only the multiset matters."""
    lengths = np.asarray(lengths, dtype=np.int64)
    ids_all = np.flatnonzero(np.asarray(valid, dtype=bool) & (lengths >= k))
    if len(ids_all) == 0:
        return ((np.zeros(0, dtype=np.int64),) * 2
                + (np.zeros(0, dtype=np.uint64),) * 2)
    if packed is not None and native.available():
        return native.li_kmers_native(packed, lengths, ids_all, priorities,
                                      k, intervals)

    pr = np.asarray(priorities, dtype=np.uint64)
    hi_len = min(k, 32)
    out_id, out_ind, out_hi, out_lo = [], [], [], []
    nwin_all = lengths[ids_all] - k + 1
    rows_per_chunk = max(1, chunk_cells // max(1, int(nwin_all.max())))
    for c0 in range(0, len(ids_all), rows_per_chunk):
        ids = ids_all[c0: c0 + rows_per_chunk]
        nwin = nwin_all[c0: c0 + rows_per_chunk]
        nwin_max = int(nwin.max())
        need = nwin_max + k - 1
        if codes is None:
            sub = packing.packed_to_codes(np.asarray(packed)[ids], need)
        else:
            sub = codes[ids, :min(need, codes.shape[1])]
        if sub.shape[1] < need:
            sub = np.pad(sub, ((0, 0), (0, need - sub.shape[1])))
        rc = pr[sub]  # remapped codes, uint64

        # big-endian base-4 window keys by Horner over the k window slots
        hi = np.zeros((len(ids), nwin_max), dtype=np.uint64)
        for t in range(hi_len):
            hi = hi * np.uint64(4) + rc[:, t: t + nwin_max]
        lo = np.zeros((len(ids), nwin_max), dtype=np.uint64)
        for t in range(hi_len, k):
            lo = lo * np.uint64(4) + rc[:, t: t + nwin_max]

        p = np.arange(nwin_max, dtype=np.int64)[None, :]
        win_ok = p < nwin[:, None]
        il = -(-nwin // intervals)          # ceil (ref Read.cpp:180)
        iv = p // il[:, None]               # interval of window p (ref :199)
        for v in range(intervals):
            m = win_ok & (iv == v)
            has = m.any(axis=1)
            if not has.any():
                break                        # iv is monotone in p per read
            # hierarchical (hi, lo, first position) minimum per read
            h1 = np.where(m, hi, _U64MAX).min(axis=1)
            m2 = m & (hi == h1[:, None])
            l1 = np.where(m2, lo, _U64MAX).min(axis=1)
            m3 = m2 & (lo == l1[:, None])
            p1 = np.where(m3, p, np.int64(1) << 62).min(axis=1)
            out_id.append(ids[has])
            out_ind.append(p1[has])
            out_hi.append(h1[has])
            out_lo.append(l1[has])
    return (np.concatenate(out_id), np.concatenate(out_ind),
            np.concatenate(out_hi), np.concatenate(out_lo))


def _canonical_runs(rid, ind, hi, lo, read_lens):
    """Sort kmer records by key then (ind desc, read length, id) and return
    (sorted rid, sorted ind, run starts, run ends) for runs of size >= 2
    (ref Kmer.cpp:58-64).  The three tie-break fields pack into one
    uint64 when they fit: the native stable sort takes it when the engine
    is loaded, a 3-key lexsort otherwise."""
    lens_r = np.asarray(read_lens, dtype=np.int64)[rid]
    if len(ind) and (ind.max() < 2048 and lens_r.max() < 2048
                     and (len(read_lens) >> 32) == 0):
        rest = (((2047 - ind).astype(np.uint64) << np.uint64(43))
                | (lens_r.astype(np.uint64) << np.uint64(32))
                | rid.astype(np.uint64))
        if native.available():
            order = native.sort3_u64(hi, lo, rest)
        else:
            order = np.lexsort((rest, lo, hi))
    else:
        order = np.lexsort((rid, lens_r, -ind, lo, hi))
    rid_s, ind_s = rid[order], ind[order]
    hi_s, lo_s = hi[order], lo[order]
    boundary = np.ones(len(order), dtype=bool)
    boundary[1:] = (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])
    starts = np.flatnonzero(boundary)
    ends = np.append(starts[1:], len(order))
    big = (ends - starts) >= 2
    return rid_s, ind_s, starts[big], ends[big]


def _gen_candidate_pairs(rid_s, ind_s, starts, ends, read_lens, cfg,
                         align_from, align_to):
    """(pi, pj, pass_static): every PKB candidate pair (i, j > i) of the
    runs, grouped by i in (i asc, j asc) order, with the reference's
    static `continue` guards.  j runs up to the reference's monotone
    `break` cutoff 100*(ind_i - ind_j) > MOC*len_i (PKB.cpp:52-62; ind_j
    does not increase with j, so the cutoff is a prefix).  Native pass
    when the engine is loaded, numpy otherwise."""
    nrec = len(rid_s)
    if nrec == 0 or len(starts) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), np.zeros(0, dtype=bool)
    if native.available():
        return native.pkb_pairgen(
            rid_s, ind_s, starts, ends, read_lens,
            cfg.max_offset_considered_for_alignment,
            cfg.min_offset_for_alignment, cfg.min_overlap_area,
            align_from, align_to)

    sizes = ends - starts
    tot_members = int(sizes.sum())
    member = np.repeat(starts, sizes) + (
        np.arange(tot_members, dtype=np.int64)
        - np.repeat(np.cumsum(sizes) - sizes, sizes))
    run_id = np.full(nrec, -1, dtype=np.int64)
    run_id[member] = np.repeat(np.arange(len(starts), dtype=np.int64), sizes)
    in_run = run_id >= 0

    lens = np.asarray(read_lens, dtype=np.int64)
    moc = cfg.max_offset_considered_for_alignment
    # composite key (run, -ind): non-decreasing over the run entries
    K = 2048
    keys_sorted = (run_id * K + (1024 - ind_s))[in_run]
    gidx = np.flatnonzero(in_run)
    # keep j iff 100*ind_j >= 100*ind_i - moc*len_i  <=>  ind_j >= T_i
    a = 100 * ind_s - moc * lens[rid_s]
    T = np.clip(-((-a) // 100), -1023, 1023)
    j_hi_local = np.searchsorted(keys_sorted, run_id * K + (1024 - T),
                                 side="right")
    j_hi = np.where(j_hi_local > 0,
                    gidx[np.maximum(j_hi_local - 1, 0)] + 1, 0)

    i_pos = np.arange(nrec, dtype=np.int64)
    counts = np.clip(j_hi - (i_pos + 1), 0, None)
    counts = np.where(in_run & align_from[rid_s], counts, 0)
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), np.zeros(0, dtype=bool)
    cum = np.zeros(nrec + 1, dtype=np.int64)
    np.cumsum(counts, out=cum[1:])
    pi = np.repeat(i_pos, counts)
    pj = np.arange(total, dtype=np.int64) - cum[pi] + pi + 1

    a1 = rid_s[pi]
    a2 = rid_s[pj]
    off = ind_s[pi] - ind_s[pj]
    len1 = lens[a1]
    len2 = lens[a2]
    overlap = np.minimum(len1, len2 + off) - off
    ok = align_to[a2] & (a1 != a2)
    ok &= off >= cfg.min_offset_for_alignment
    ok &= overlap >= cfg.min_overlap_area
    ok &= (len2 + off - len1) >= 0
    return pi, pj, ok


def _verify_pairs(a1, a2, off, codes, packed, read_lens, cfg,
                  min_device_batch, device=None, mesh=None):
    """Batch ACH verification over unique (id1, id2, offset) triples."""
    if len(a1) == 0:
        return np.zeros(0, dtype=bool)
    n_reads = len(read_lens)
    if n_reads < (1 << 27) and off.min() >= 0 and off.max() < 1024:
        # (a1, a2, off) packed into one u64: unique on a flat u64
        key = ((a1.astype(np.uint64) << np.uint64(37))
               | (a2.astype(np.uint64) << np.uint64(10))
               | off.astype(np.uint64))
        ukey, inv = np.unique(key, return_inverse=True)
        u1 = (ukey >> np.uint64(37)).astype(np.int64)
        u2 = ((ukey >> np.uint64(10)) & np.uint64((1 << 27) - 1)).astype(np.int64)
        uo = (ukey & np.uint64(1023)).astype(np.int64)
    else:
        trip = np.stack([a1, a2, off], axis=1)
        uniq, inv = np.unique(trip, axis=0, return_inverse=True)
        u1, u2, uo = uniq[:, 0], uniq[:, 1], uniq[:, 2]
    if mesh is not None and cfg.use_acler_instead_of_aclcs:
        can = ach_batch_mesh(mesh, packed, read_lens, u1, u2, uo, cfg)
    else:
        can = ach_batch_auto(packed, codes, read_lens, u1, u2, uo, cfg,
                             min_device_batch=min_device_batch,
                             device=device)
    return can[inv]


def _replay_runs(adj_add, rid_s, ind_s, starts, ends, pi, pj, pass_static,
                 pair_can):
    """Replay the reference's sequential PKB loop (PKB.cpp:16-98) in
    Python, with the verification results as lookups.

    Branch markers: reach[i] is the bitmask of run-local j reachable from
    i through the edges known so far; a pair (i, j) already covered is
    skipped without adding an edge.  The skip decides the final edge set,
    so it is replayed exactly."""
    nrec = len(rid_s)
    counts = np.bincount(pi, minlength=nrec).astype(np.int64)
    cum = np.zeros(nrec + 1, dtype=np.int64)
    np.cumsum(counts, out=cum[1:])

    rid_l = rid_s.tolist()
    pj_l = pj.tolist()
    off_all = (ind_s[pi] - ind_s[pj]).tolist()
    ok_l = pass_static.tolist()
    can_l = pair_can.tolist()
    cum_l = cum.tolist()
    get_offset = adj_add.get_offset
    add_min = adj_add.add_min

    for s, e in zip(starts.tolist(), ends.tolist()):
        if cum_l[e] == cum_l[s]:
            continue
        reach = [0] * (e - s)
        for gi in range(e - 1, s - 1, -1):
            p0, p1 = cum_l[gi], cum_l[gi + 1]
            if p0 == p1:
                continue
            i_local = gi - s
            ri = reach[i_local]
            id1 = rid_l[gi]
            for idx in range(p0, p1):
                if not ok_l[idx]:
                    continue
                j_local = pj_l[idx] - s
                if (ri >> j_local) & 1:
                    continue
                id2 = rid_l[pj_l[idx]]
                o = off_all[idx]
                cur = get_offset(id1, id2)
                if cur is None or cur > o:
                    if can_l[idx]:
                        add_min(id1, id2, o)
                        cur = o
                if cur is not None:
                    ri |= (1 << j_local) | reach[j_local]
            reach[i_local] = ri


def _replay_runs_auto(adj_add, rid_s, ind_s, starts, ends, pi, pj,
                      pass_static, pair_can):
    """The branch-marker replay in the native engine when it is loaded and
    the adapter exposes its sorted base keys (SupplementAdj), else in
    Python (`_replay_runs`)."""
    if (native.available() and hasattr(adj_add, "_keys")
            and hasattr(adj_add, "overlay")):
        adj_add.overlay = native.pkb_replay(
            rid_s, ind_s, starts, ends, pi, pj, pass_static, pair_can,
            adj_add.n, adj_add._keys, adj_add._offs, adj_add.overlay)
        return
    _replay_runs(adj_add, rid_s, ind_s, starts, ends, pi, pj, pass_static,
                 pair_can)


def pkb_supplement(adj_add, codes, lengths, read_lens, cfg,
                   align_from: np.ndarray, align_to: np.ndarray,
                   priorities_rotations: int = 4, packed=None,
                   min_device_batch: int = 200_000, *, device=None,
                   mesh=None):
    """Run the LI/PKB supplement: extraction, pair generation and replay
    on the host (native or numpy/Python), batched ACH verification on
    `device`, or over `mesh` for ACLER.

    `adj_add` has .get_offset(a, b) -> int | None and .add_min(a, b,
    offset) (the pipeline's SupplementAdj, whose sorted base keys the
    native replay reads); `packed` is the uint32[N, W] read store."""
    k = cfg.li_kmer_length
    intervals = cfg.li_kmer_intervals
    valid = (align_from | align_to) & (np.asarray(read_lens) >= k)
    # the masks gate kmer EXTRACTION only: the reference's pair loop runs on
    # a clone() whose alignFrom/alignTo default to all true
    # (GraphCreatorKmerBased.cpp:109, GraphCreator.cpp:10-13)
    all_true = np.ones(len(valid), dtype=bool)

    priorities = [0, 1, 2, 3]
    for _rot in range(min(4, priorities_rotations)):
        rid, ind, hi, lo = li_kmers(codes, read_lens, valid, priorities, k,
                                    intervals, packed=packed)
        if len(rid):
            rid_s, ind_s, starts, ends = _canonical_runs(
                rid, ind, hi, lo, read_lens)
            pi, pj, ok = _gen_candidate_pairs(
                rid_s, ind_s, starts, ends, read_lens, cfg,
                all_true, all_true)
            sel = np.flatnonzero(ok)
            can = np.zeros(len(pi), dtype=bool)
            if len(sel):
                can[sel] = _verify_pairs(
                    rid_s[pi[sel]], rid_s[pj[sel]],
                    ind_s[pi[sel]] - ind_s[pj[sel]],
                    codes, packed, read_lens, cfg, min_device_batch,
                    device=device, mesh=mesh)
            _replay_runs_auto(adj_add, rid_s, ind_s, starts, ends, pi, pj,
                              ok, can)
        priorities = priorities[1:] + priorities[:1]   # rotate (ref LI.cpp:25)
