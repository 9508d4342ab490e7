"""Error-tolerant graph supplement: LI minimizer k-mers + pairwise-kmer
branch verification (port of alga_tpu/graph/supplement.py).

The JAX module is host code except for its pair verification, but it
imports ops.align (and so jax) at the top.  This port keeps its calls:
the native engine extracts the LI k-mers, generates the PKB candidate
pairs and replays the reference's branch-marker loop; the unique
(id1, id2, offset) triples are verified by this package's
`ach_batch_auto` on the given device.  See the JAX module's docstring
for the execution model (ref GraphCreatorLI.cpp,
GraphCreatorPairwiseKmerBranch.cpp, main.cpp:300-355).
"""

from __future__ import annotations

import numpy as np

from alga_tpu_torch import native
from alga_tpu_torch.ops.align import ach_batch_auto


def _native():
    if not native.available():
        raise RuntimeError("alga_tpu_torch: the error-tolerant supplement "
                           "needs the native host engine "
                           "(native/libalga_host.so)")
    return native


def li_kmers(packed, lengths, valid, priorities: list[int], k: int,
             intervals: int):
    """(read_id, ind_in_read, key_hi, key_lo) of the per-interval LI
    minimizer k-mers of every valid read of length >= k (native pass)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    ids_all = np.flatnonzero(np.asarray(valid, dtype=bool) & (lengths >= k))
    if len(ids_all) == 0:
        return ((np.zeros(0, dtype=np.int64),) * 2
                + (np.zeros(0, dtype=np.uint64),) * 2)
    return _native().li_kmers_native(packed, lengths, ids_all, priorities,
                                     k, intervals)


def _canonical_runs(rid, ind, hi, lo, read_lens):
    """Sort kmer records by key then (ind desc, read length, id) and return
    (sorted rid, sorted ind, run starts, run ends) for runs of size >= 2
    (ref Kmer.cpp:58-64).  The three tie-break fields pack into one
    uint64 when they fit."""
    lens_r = np.asarray(read_lens, dtype=np.int64)[rid]
    if len(ind) and (ind.max() < 2048 and lens_r.max() < 2048
                     and (len(read_lens) >> 32) == 0):
        rest = (((2047 - ind).astype(np.uint64) << np.uint64(43))
                | (lens_r.astype(np.uint64) << np.uint64(32))
                | rid.astype(np.uint64))
        order = _native().sort3_u64(hi, lo, rest)
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
    """(pi, pj, pass_static): every PKB candidate pair (i, j) of the runs,
    grouped by i, with the reference's static `continue` guards."""
    if len(rid_s) == 0 or len(starts) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), np.zeros(0, dtype=bool)
    return _native().pkb_pairgen(
        rid_s, ind_s, starts, ends, read_lens,
        cfg.max_offset_considered_for_alignment,
        cfg.min_offset_for_alignment, cfg.min_overlap_area,
        align_from, align_to)


def _verify_pairs(a1, a2, off, codes, packed, read_lens, cfg,
                  min_device_batch, device=None):
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
    can = ach_batch_auto(packed, codes, read_lens, u1, u2, uo, cfg,
                         min_device_batch=min_device_batch, device=device)
    return can[inv]


def _replay_runs_auto(adj_add, rid_s, ind_s, starts, ends, pi, pj,
                      pass_static, pair_can):
    """Replay the reference's sequential PKB loop (PKB.cpp:16-98) in the
    native engine, with the verification results as lookups."""
    adj_add.overlay = _native().pkb_replay(
        rid_s, ind_s, starts, ends, pi, pj, pass_static, pair_can,
        adj_add.n, adj_add._keys, adj_add._offs, adj_add.overlay)


def pkb_supplement(adj_add, codes, lengths, read_lens, cfg,
                   align_from: np.ndarray, align_to: np.ndarray,
                   priorities_rotations: int = 4, packed=None,
                   min_device_batch: int = 200_000, *, device=None):
    """Run the LI/PKB supplement (native extraction and replay, batched
    ACH verification on `device`).

    `adj_add` is the pipeline's SupplementAdj (sorted base keys plus an
    overlay of added edges); `packed` is the uint32[N, W] read store."""
    k = cfg.li_kmer_length
    intervals = cfg.li_kmer_intervals
    valid = (align_from | align_to) & (np.asarray(read_lens) >= k)
    # the masks gate kmer EXTRACTION only: the reference's pair loop runs on
    # a clone() whose alignFrom/alignTo default to all true
    # (GraphCreatorKmerBased.cpp:109, GraphCreator.cpp:10-13)
    all_true = np.ones(len(valid), dtype=bool)

    priorities = [0, 1, 2, 3]
    for _rot in range(min(4, priorities_rotations)):
        rid, ind, hi, lo = li_kmers(packed, read_lens, valid, priorities, k,
                                    intervals)
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
                    device=device)
            _replay_runs_auto(adj_add, rid_s, ind_s, starts, ends, pi, pj,
                              ok, can)
        priorities = priorities[1:] + priorities[:1]   # rotate (ref LI.cpp:25)
