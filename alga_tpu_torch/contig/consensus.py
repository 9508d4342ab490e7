"""Per-column SNP consensus over a contig's contained reads.

Ref: Contig::correctSnipsInContig (src/DataStructures/Contig.cpp:33-92):
every column of the contig is re-voted by the reads covering it (majority,
ties broken toward the smallest base code A<C<G<T = max_element-first), and
both ends are trimmed while column support <= 3.

The reference advances a per-read cursor column by column under a mutex-free
single thread; here each contig's votes are one scatter-add into a
(length, 4) count matrix — a pure segment-sum, batched across contigs on
demand.  Observationally equivalent: read i (start s_i, length l_i) votes
base r_i[c - s_i] in every column c in [s_i, s_i + l_i).

The host pass runs here; under ALGA_DEVICE_CONSENSUS, `correct_all`
hands the contigs to the port's device twin
(contig/device_consensus.py), which also holds COVERAGE_TRIM_THRESHOLD.

A copy of alga_tpu/contig/consensus.py, kept in step with it: the port
imports nothing of alga_tpu, whose package imports jax.
"""

from __future__ import annotations

import os

import numpy as np

from alga_tpu_torch import native as native_mod
from alga_tpu_torch.contig.device_consensus import (  # noqa: F401
    COVERAGE_TRIM_THRESHOLD, correct_all_device)
from alga_tpu_torch.contig.walk import Contig
from alga_tpu_torch.core.seqbatch import SeqBatch

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def correct_all(contigs: list[Contig], batch: SeqBatch, *,
                device=None) -> None:
    """Batched consensus: ONE scatter-add over the concatenated coordinate
    space of every contig, then per-contig argmax + end trim.  Uses the
    native engine when available; under ALGA_DEVICE_CONSENSUS the votes
    and trim run on `device` instead."""
    if not contigs:
        return
    if os.environ.get("ALGA_DEVICE_CONSENSUS"):
        # bit-identical; opt-in, as in alga_tpu
        correct_all_device(contigs, batch, device=device)
        return
    if native_mod.available():
        # vote directly from the 2-bit packed store — the uint8[N, L] code
        # matrix is never materialized (memory diet; ref streams per-read,
        # Read.cpp:40-68)
        native_mod.consensus_native(contigs, batch, None,
                                    COVERAGE_TRIM_THRESHOLD)
        return
    codes = batch.codes()
    lengths = batch.lengths.astype(np.int64)

    # per-contig absolute starts/lengths
    ctg_total = np.zeros(len(contigs), dtype=np.int64)
    all_ids = []
    all_starts = []       # within-contig start of each read
    all_ctg = []          # contig index per read
    for ci, c in enumerate(contigs):
        offs = np.array([0] + [off for _, off in c.reads[1:]], dtype=np.int64)
        starts = np.cumsum(offs)
        ids = np.array([rid for rid, _ in c.reads], dtype=np.int64)
        ctg_total[ci] = starts[-1] + lengths[ids[-1]]
        all_ids.append(ids)
        all_starts.append(starts)
        all_ctg.append(np.full(len(ids), ci, dtype=np.int64))
    ids = np.concatenate(all_ids)
    starts = np.concatenate(all_starts)
    ctg_of = np.concatenate(all_ctg)

    ctg_base = np.zeros(len(contigs) + 1, dtype=np.int64)
    np.cumsum(ctg_total, out=ctg_base[1:])
    grand_total = int(ctg_base[-1])

    lens_c = np.minimum(lengths[ids], ctg_total[ctg_of] - starts)
    lens_c = np.maximum(lens_c, 0)
    abs_start = ctg_base[ctg_of] + starts

    # chunked bincount voting: bounded temporaries, no ufunc.at
    counts = np.zeros(grand_total * 4, dtype=np.int32)
    CHUNK_VOTES = 16_000_000
    csum = np.cumsum(lens_c)
    i = 0
    nreads = len(ids)
    while i < nreads:
        base_v = csum[i - 1] if i > 0 else 0
        j = int(np.searchsorted(csum, base_v + CHUNK_VOTES)) + 1
        j = min(max(j, i + 1), nreads)
        lc = lens_c[i:j]
        tot = int(lc.sum())
        if tot:
            row_rep = np.repeat(np.arange(i, j), lc)
            within = np.arange(tot, dtype=np.int64) - np.repeat(
                np.cumsum(lc) - lc, lc)
            pos = abs_start[row_rep] + within
            bases = codes[ids[row_rep], within].astype(np.int64)
            counts += np.bincount(pos * 4 + bases, minlength=grand_total * 4
                                  ).astype(np.int32)
        i = j
    counts = counts.reshape(grand_total, 4)

    best = counts.argmax(axis=1)
    freqs = counts.max(axis=1)
    thr = COVERAGE_TRIM_THRESHOLD
    ok = freqs > thr
    for ci, c in enumerate(contigs):
        a, b = int(ctg_base[ci]), int(ctg_base[ci + 1])
        seg_ok = ok[a:b]
        nz = np.flatnonzero(seg_ok)
        if len(nz) == 0:
            c.seq = ""
            continue
        p, q = int(nz[0]), int(nz[-1])
        c.seq = _BASES[best[a + p : a + q + 1]].tobytes().decode("ascii")
