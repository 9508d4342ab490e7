"""Per-column SNP consensus on the device (port of
alga_tpu/contig/device_consensus.py).

Ref Contig::correctSnipsInContig (src/DataStructures/Contig.cpp:33-92):
majority vote per contig column over the reads it contains, ties to the
smallest base code, then both ends trimmed while column support <= 3.
All contigs share one concatenated column space of G columns:

  1. `_vote_chunk`: a chunk of reads is unpacked from the 2-bit words on
     the device and its votes land in a flat int32 [4G+1] count vector
     through one scatter-add (slot 4G takes the votes past a read's end,
     as the JAX version's `mode="drop"` drops them);
  2. `_decide_trim`: argmax per column (the first maximum, so the lowest
     code) and the support mask, then each contig's first and last
     supported column by scatter-min/max.

Only the decided bases and the per-contig bounds come back to the host,
which builds the strings.  The same sequences as
contig/consensus.correct_all, the host version.
"""

from __future__ import annotations

import numpy as np
import torch

from alga_tpu_torch import device as device_mod
from alga_tpu_torch.store import words_as_int32

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)

# ref Contig.cpp:82 (THR); here rather than in contig/consensus.py, which
# imports this module
COVERAGE_TRIM_THRESHOLD = 3


def _vote_chunk(packed, ids_c, start_c, len_c, counts, G: int) -> None:
    """Add the votes of one chunk of reads to counts int32[4G+1].

    packed: int32[N, W] words; ids_c, start_c, len_c: int64[R] read id,
    first absolute column and number of voting bases of each read."""
    L = 16 * packed.shape[1]
    t = torch.arange(L, device=packed.device)
    words = packed[ids_c][:, t >> 4]                        # [R, L]
    # arithmetic shifts of the int32 words are fine: `& 3` keeps two bits
    codes = (words >> (2 * (t & 15))) & 3
    flat = torch.where(t < len_c[:, None],
                       (start_c[:, None] + t) * 4 + codes, 4 * G)
    counts.index_add_(0, flat.ravel(),
                      torch.ones(flat.numel(), dtype=torch.int32,
                                 device=packed.device))


def _decide_trim(counts_flat, ctg_start_marks, NC: int):
    """(best uint8[G], p int64[NC], q int64[NC], empty bool[NC]): the
    winning base of every column and each contig's first and last column
    with support above COVERAGE_TRIM_THRESHOLD (q = -1 when none)."""
    G = counts_flat.shape[0] // 4
    counts = counts_flat.view(G, 4)
    best = counts.argmax(dim=1)                 # the first maximum
    freqs = counts.amax(dim=1)
    ok = freqs > COVERAGE_TRIM_THRESHOLD
    ctg_of = torch.cumsum(ctg_start_marks, 0) - 1
    col = torch.arange(G, device=counts.device)
    tgt = torch.where(ok, ctg_of, NC)
    p = torch.full((NC + 1,), np.iinfo(np.int64).max,
                   device=counts.device).scatter_reduce(0, tgt, col, "amin")
    q = torch.full((NC + 1,), -1, device=counts.device).scatter_reduce(
        0, tgt, col, "amax")
    return best.to(torch.uint8), p[:NC], q[:NC], q[:NC] < 0


def correct_all_device(contigs, batch, chunk_reads: int = 1 << 20, *,
                       device=None) -> None:
    """Device twin of contig/consensus.correct_all: sets every contig's
    seq from the votes of its reads, on `device`."""
    if not contigs:
        return
    dev = device_mod.resolve(device)
    lengths = batch.lengths.astype(np.int64)

    ctg_total = np.zeros(len(contigs), dtype=np.int64)
    all_ids, all_starts, all_ctg = [], [], []
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
    G = int(ctg_base[-1])
    if 4 * G >= (1 << 31):
        raise ValueError("device consensus: 4 x the column space "
                         f"({G} columns) exceeds int32 counts")

    lens_c = np.maximum(np.minimum(lengths[ids], ctg_total[ctg_of] - starts),
                        0)
    abs_start = ctg_base[ctg_of] + starts

    packed = torch.from_numpy(words_as_int32(batch.packed)).to(dev)
    ids_d, st_d, ln_d = (torch.from_numpy(x).to(dev)
                         for x in (ids, abs_start, lens_c))
    counts = torch.zeros(4 * G + 1, dtype=torch.int32, device=dev)
    for i in range(0, len(ids), chunk_reads):
        s = slice(i, i + chunk_reads)
        _vote_chunk(packed, ids_d[s], st_d[s], ln_d[s], counts, G)

    # marks COUNT contig starts per column: a contig of no columns starts
    # where the next one does, and must still advance the contig id
    marks = np.bincount(ctg_base[:-1][ctg_base[:-1] < G],
                        minlength=G)[:G]
    best, p, q, empty = _decide_trim(counts[:4 * G],
                                     torch.from_numpy(marks).to(dev),
                                     len(contigs))
    best_h = best.cpu().numpy()
    p_h, q_h, e_h = (x.cpu().numpy() for x in (p, q, empty))
    for ci, c in enumerate(contigs):
        if e_h[ci]:
            c.seq = ""
            continue
        c.seq = _BASES[best_h[p_h[ci]:q_h[ci] + 1]].tobytes().decode("ascii")
