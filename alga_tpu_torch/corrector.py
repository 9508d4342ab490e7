"""K-mer spectrum read correction (ref: src/Corrector/ReadCorrector.cpp).

Musket-like: every position of every read contributes a (big-context,
small-mer) observation — the 30-mer at [p, p+30) keys the 5-mer at [p-5, p)
(ref addReadDataToMap:36-93).  Pairs seen < 2 times are pruned
(createFrequenciesMap:96-157).  Correction: a 5-mer whose context exists
but which itself is unsupported is replaced by the Hamming-closest
supported candidate, <= 1 SNP, with interior mer-boundary positions
immutable (applyCorrectionToRead:188-294).  The whole procedure runs
forward then on index-reversed reads (correct:20-24).

Vectorized spectrum building (numpy rolling hashes over all reads at once);
the per-read sequential fix-up loop only runs for reads that have at least
one unsupported window (vectorized pre-screen), matching the reference's
sequential semantics exactly on those reads.

A copy of alga_tpu/corrector.py, kept in step with it: the port
imports nothing of alga_tpu, whose package imports jax.
"""

from __future__ import annotations

import numpy as np

SMALL = 5
BIG = 30
CANDIDATE_THRESHOLD = 2          # ref ReadCorrector.h:36
MAX_SNPS_TO_CORRECT = 1          # ref ReadCorrector.cpp:258
MAX_HASH = 10**18 + 3            # ref Params.cpp:721

_BIG_POW = 4 ** (BIG - 1)
_SMALL_POW = 4 ** (SMALL - 1)


def _window_hashes(codes: np.ndarray, lengths: np.ndarray):
    """For every read and start p (small window at [p-SMALL, p), big at
    [p, p+BIG)), return (bH mod MAX_HASH, sH) arrays [N, P] + validity.

    p ranges over [SMALL, len - BIG] (ref loop :58-91)."""
    n, lpad = codes.shape
    c = codes.astype(np.int64)
    num_p = max(0, lpad - BIG - SMALL + 1)
    if num_p == 0:
        z = np.zeros((n, 0), dtype=np.int64)
        return z, z.copy(), np.zeros((n, 0), dtype=bool)

    bH = np.zeros((n, num_p), dtype=np.int64)
    sH = np.zeros((n, num_p), dtype=np.int64)

    # initial window at p = SMALL
    s0 = np.zeros(n, dtype=np.int64)
    for i in range(SMALL):
        s0 = s0 * 4 + c[:, i]
    b0 = np.zeros(n, dtype=np.int64)
    for i in range(SMALL, SMALL + BIG):
        b0 = b0 * 4 + c[:, i]
        # full reduction: 4*b0+c < 4*MAX_HASH needs up to THREE
        # subtractions (the reference's `while (bH >= MAX) bH -= MAX`,
        # ReadCorrector.cpp:55 — a single conditional subtraction here
        # desynchronized every window hash past the first collision)
        b0 %= MAX_HASH
    sH[:, 0] = s0
    bH[:, 0] = b0

    for j in range(1, num_p):
        p = SMALL + j          # small window now [p-SMALL, p)
        q = SMALL + BIG + j - 1  # big window now [p, p+BIG), last base q
        s0 = (s0 - _SMALL_POW * c[:, p - SMALL - 1]) * 4 + c[:, p - 1]
        b0 = b0 - _BIG_POW * c[:, q - BIG]
        # negative reduction replicates the reference's signed/unsigned
        # quirk (ReadCorrector.cpp:76: `bH %= MAX_HASH_CONSIDERED` with LL
        # bH but ULL modulus -> computes (bH + 2^64) mod M, NOT bH mod M);
        # uint64 reinterpretation of the negative int64 gives 2^64 + b0
        b0 = np.where(b0 < 0,
                      (b0.astype(np.uint64) % np.uint64(MAX_HASH))
                      .astype(np.int64), b0)
        b0 = b0 * 4 + c[:, q]
        b0 %= MAX_HASH
        sH[:, j] = s0
        bH[:, j] = b0

    pos = np.arange(num_p)[None, :]
    valid = (pos + SMALL + BIG) <= lengths[:, None]
    return bH, sH, valid


def spectrum_pairs(codes: np.ndarray, lengths: np.ndarray, valid_reads):
    """Sorted supported (bH, sH) pair arrays (count >= threshold kept)."""
    ok = np.asarray(valid_reads, dtype=bool) & (lengths >= SMALL + BIG)
    bH, sH, wvalid = _window_hashes(codes, lengths)
    wvalid = wvalid & ok[:, None]
    b = bH[wvalid]
    s = sH[wvalid]
    if len(b) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy()
    order = np.lexsort((s, b))
    b, s = b[order], s[order]
    first = np.ones(len(b), dtype=bool)
    first[1:] = (b[1:] != b[:-1]) | (s[1:] != s[:-1])
    idx = np.flatnonzero(first)
    counts = np.diff(np.append(idx, len(b)))
    keep = counts >= CANDIDATE_THRESHOLD
    return b[idx[keep]], s[idx[keep]]


def build_spectrum(codes: np.ndarray, lengths: np.ndarray, valid_reads) -> dict:
    """bH -> {sH} support map (dict view of spectrum_pairs; insertion order
    = sH ascending within each bH, which fixes candidate iteration order)."""
    bk, sk = spectrum_pairs(codes, lengths, valid_reads)
    spectrum: dict[int, dict[int, int]] = {}
    for bb, ss in zip(bk.tolist(), sk.tolist()):
        spectrum.setdefault(bb, {})[ss] = 1
    return spectrum


def _correct_one(row: np.ndarray, length: int, spectrum: dict) -> bool:
    """Sequential per-read correction (ref applyCorrectionToRead:188-294).
    Mutates `row` in place; returns True if anything changed."""
    if length < SMALL + BIG:
        return False
    changed = False
    sH = 0
    for i in range(SMALL):
        sH = (sH << 2) + int(row[i])
    bH = 0
    for i in range(SMALL, SMALL + BIG):
        bH = (bH << 2) + int(row[i])
        while bH >= MAX_HASH:
            bH -= MAX_HASH
    p = SMALL
    q = SMALL + BIG

    def correct_local(p, sH):
        nonlocal changed
        cand = spectrum.get(bH)
        if cand is None:
            return sH
        if sH in cand:
            return sH
        closest = None
        min_dst = 10**9
        for smer in cand:
            dst = 0
            same_boundaries = True
            for i in range(SMALL):
                smer_pos = (smer >> (2 * i)) & 3
                # NB the reference compares bit-pair i (which holds mer base
                # SMALL-1-i) against READ position p-SMALL+i — i.e. the mer
                # is compared against the reversed window (ref :231-247) —
                # while the write-back goes to p-1-i (ref :263).  Replicated
                # verbatim for parity.
                read_pos = int(row[p - SMALL + i])
                if smer_pos != read_pos:
                    dst += 1
                    if (i == 0 or i == SMALL - 1) and p > SMALL:
                        same_boundaries = False
                        break
            if same_boundaries and dst < min_dst:
                min_dst = dst
                closest = smer
        if min_dst > MAX_SNPS_TO_CORRECT or closest is None:
            return sH
        for i in range(SMALL):
            row[p - 1 - i] = (closest >> (2 * i)) & 3
        changed = True
        return closest

    sH = correct_local(p, sH)
    while q < length:
        sH = ((sH - _SMALL_POW * int(row[p - SMALL])) << 2) + int(row[p])
        bH = bH - _BIG_POW * int(row[q - BIG])
        if bH < 0:
            # (bH + 2^64) mod M — the reference's signed/unsigned quirk
            # (ReadCorrector.cpp:280), see _window_hashes
            bH = ((1 << 64) + bH) % MAX_HASH
        bH = (bH << 2) + int(row[q])
        while bH >= MAX_HASH:
            bH -= MAX_HASH
        p += 1
        q += 1
        sH = correct_local(p, sH)
    return changed


def correct_reads(codes: np.ndarray, lengths: np.ndarray, valid) -> int:
    """Two-direction correction over the whole batch; mutates `codes`.
    Returns number of (read, direction) fix-ups applied.

    Fast path: the native multithreaded fix-up loop (alga_correct_pass),
    sub-linear in Python ops; `correct_reads_py` is the oracle."""
    from alga_tpu_torch import native
    lengths = np.asarray(lengths, dtype=np.int64)
    valid = np.asarray(valid, dtype=bool)
    if not native.available():
        return correct_reads_py(codes, lengths, valid)

    total_changed = 0
    for reversed_dir in (False, True):
        view = codes
        if reversed_dir:
            # index-reversed (NOT complemented) per-read view
            # (ref accessReadPosition:315-321)
            view = _reverse_rows(codes, lengths)
        bk, sk = spectrum_pairs(view, lengths, valid)
        view = np.ascontiguousarray(view)
        total_changed += native.correct_pass(view, lengths, valid, bk, sk)
        if reversed_dir:
            codes[:] = _reverse_rows(view, lengths)
        else:
            codes[:] = view
    return total_changed


def _merge_pair_counts(acc, b, s):
    """Merge a chunk's (b, s) window-hash pairs into the running unique
    (b, s, count) arrays (kept lexsorted)."""
    if len(b) == 0:
        return acc
    order = np.lexsort((s, b))
    b, s = b[order], s[order]
    first = np.ones(len(b), dtype=bool)
    first[1:] = (b[1:] != b[:-1]) | (s[1:] != s[:-1])
    idx = np.flatnonzero(first)
    cnt = np.diff(np.append(idx, len(b))).astype(np.int64)
    b, s = b[idx], s[idx]
    if acc is None:
        return b, s, cnt
    ab, as_, ac = acc
    mb = np.concatenate([ab, b])
    ms = np.concatenate([as_, s])
    mc = np.concatenate([ac, cnt])
    order = np.lexsort((ms, mb))
    mb, ms, mc = mb[order], ms[order], mc[order]
    first = np.ones(len(mb), dtype=bool)
    first[1:] = (mb[1:] != mb[:-1]) | (ms[1:] != ms[:-1])
    gid = np.cumsum(first) - 1
    out_c = np.zeros(int(gid[-1]) + 1, dtype=np.int64)
    np.add.at(out_c, gid, mc)
    return mb[first], ms[first], out_c


def correct_reads_batch(batch, chunk_rows: int = 1 << 16) -> int:
    """Two-direction correction straight on the packed store, chunked:
    unpack -> spectrum-accumulate / correct -> repack per read range, so
    the uint8[N, L] code matrix is never materialized (memory diet; the
    reference streams per-read, Read.cpp:40-68).  Identical results to
    correct_reads on the unpacked matrix (differential-tested)."""
    from alga_tpu_torch import native
    from alga_tpu_torch.core import packing

    n = len(batch)
    lengths = np.asarray(batch.lengths, dtype=np.int64)
    valid = np.asarray(batch.valid, dtype=bool)
    if not native.available():
        codes = batch.codes()
        changed = correct_reads_py(codes, lengths, valid)
        batch.packed = packing.codes_to_packed(codes, lengths,
                                               batch.width_words)
        return changed

    total_changed = 0
    for reversed_dir in (False, True):
        acc = None
        for a in range(0, n, chunk_rows):
            sl = slice(a, min(n, a + chunk_rows))
            codes_c = packing.packed_to_codes(batch.packed[sl])
            if reversed_dir:
                codes_c = _reverse_rows(codes_c, lengths[sl])
            bH, sH, wvalid = _window_hashes(codes_c, lengths[sl])
            ok = valid[sl] & (lengths[sl] >= SMALL + BIG)
            wvalid &= ok[:, None]
            acc = _merge_pair_counts(acc, bH[wvalid], sH[wvalid])
        if acc is None:
            continue
        ub, us, uc = acc
        keep = uc >= CANDIDATE_THRESHOLD
        bk, sk = ub[keep], us[keep]
        for a in range(0, n, chunk_rows):
            sl = slice(a, min(n, a + chunk_rows))
            codes_c = packing.packed_to_codes(batch.packed[sl])
            if reversed_dir:
                codes_c = _reverse_rows(codes_c, lengths[sl])
            codes_c = np.ascontiguousarray(codes_c)
            total_changed += native.correct_pass(
                codes_c, lengths[sl], valid[sl], bk, sk)
            if reversed_dir:
                codes_c = _reverse_rows(codes_c, lengths[sl])
            batch.packed[sl] = packing.codes_to_packed(
                codes_c, lengths[sl], batch.width_words)
    return total_changed


def correct_reads_py(codes: np.ndarray, lengths: np.ndarray, valid) -> int:
    """Pure-Python twin of correct_reads (differential oracle)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    total_changed = 0
    for reversed_dir in (False, True):
        view = codes
        if reversed_dir:
            view = _reverse_rows(codes, lengths)
        spectrum = build_spectrum(view, lengths, valid)

        # pre-screen: reads with any unsupported (bH present, sH absent)
        bH, sH, wvalid = _window_hashes(view, lengths)
        wvalid &= np.asarray(valid, dtype=bool)[:, None]
        needs = np.zeros(len(lengths), dtype=bool)
        rows, cols = np.nonzero(wvalid)
        for r, c in zip(rows.tolist(), cols.tolist()):
            if needs[r]:
                continue
            cand = spectrum.get(int(bH[r, c]))
            if cand is not None and int(sH[r, c]) not in cand:
                needs[r] = True

        for r in np.flatnonzero(needs):
            row = view[r]
            if _correct_one(row, int(lengths[r]), spectrum):
                total_changed += 1
        if reversed_dir:
            codes[:] = _reverse_rows(view, lengths)
        else:
            codes[:] = view
    return total_changed


def _reverse_rows(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    n, lpad = codes.shape
    cols = np.arange(lpad, dtype=np.int64)[None, :]
    src = lengths[:, None] - 1 - cols
    ok = src >= 0
    out = np.take_along_axis(codes, np.where(ok, src, 0), axis=1)
    out[~ok] = 0
    return out
