"""Contig filtering, end-trimming and FASTA output (port of
alga_tpu/io/output.py; ref src/IO/OutputWriterNew.cpp, trim pass in
src/main.cpp:633-725).  Only the trim graph differs from the JAX
module: it is built by this package's graph routing."""

from __future__ import annotations

import numpy as np

from alga_tpu_torch import native
from alga_tpu_torch.core import packing
from alga_tpu_torch.core.seqbatch import SeqBatch
from alga_tpu_torch.graph import prefsuf
from alga_tpu_torch.utils.libstdcxx_sort import libstdcxx_sort


def filter_contigs(contigs, n_reads: int, min_output_length: int,
                   new_reads_percentage: int = 95,
                   mark_revcomp: bool = True):
    """Greedy longest-first dedup (ref OutputWriterNew::filterContigs,
    OutputWriterNew.cpp:150-187): a contig passes if it is long enough and
    >= new_reads_percentage% of its reads were not claimed by an earlier
    (longer) contig; passing contigs claim their reads and revcomps.  The
    order is libstdc++'s unstable std::sort, as the reference's."""
    was_in_contig = np.zeros(n_reads, dtype=bool)
    if native.available():
        lens = np.fromiter((len(c) for c in contigs), dtype=np.int64,
                           count=len(contigs))
        order = native.sort_len_desc(lens).tolist()
    else:
        order = libstdcxx_sort(
            list(range(len(contigs))),
            lambda i, j: len(contigs[i]) > len(contigs[j]))
    out = []
    new_id = 0
    for i in order:
        ctg = contigs[i]
        if len(ctg) < min_output_length:
            continue
        rids = np.array([rid for rid, _ in ctg.reads], dtype=np.int64)
        all_reads = len(rids)
        new_reads = int((~was_in_contig[rids]).sum())
        if all_reads == 0 or 100.0 * new_reads / all_reads < new_reads_percentage:
            continue
        was_in_contig[rids] = True
        if mark_revcomp:
            was_in_contig[SeqBatch.revcomp_id(rids)] = True
        ctg.cid = new_id
        new_id += 1
        out.append(ctg)
    return out


def trim_contigs(contigs, threshold: int = 25, read_cap: int = 500, *,
                 device=None) -> None:
    """Contig end-dedup via a second overlap graph over contigs + revcomps
    (ref main.cpp:633-725): per contig, trimLeft = the largest overlap of
    any incoming contig→contig edge (both forward-strand); sequences with
    trimLeft + 10 >= length collapse to "CCCC"."""
    if not contigs:
        return
    m = len(contigs)
    seqs = [c.seq for c in contigs] + [_revcomp(c.seq) for c in contigs]
    if native.available():
        packed, lengths = native.pack_ragged(seqs)
    else:
        packed, lengths = packing.pack_strings(seqs)
    g = prefsuf.build_gcps_graph(
        packed, lengths, len(seqs), ell_min=threshold, cap=read_cap,
        rsoe=threshold, device=device)
    g = g.retain_min_offset()

    trim_left = np.zeros(m, dtype=np.int64)
    for s, d, off in zip(g.src.tolist(), g.dst.tolist(), g.offset.tolist()):
        if s < m and d < m:
            trim_left[d] = max(trim_left[d], int(lengths[s]) - off)

    for i, c in enumerate(contigs):
        tl = int(trim_left[i])
        if tl + 10 < len(c.seq):
            c.seq = c.seq[tl:] if tl else c.seq
        else:
            c.seq = "CCCC"


def _revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def write_contigs(contigs, path: str, rna: bool = False) -> None:
    """FASTA emit (ref OutputWriterNew::writeContigsNoFilter,
    OutputWriterNew.cpp:189-207): header >contig_id=<id>_length=<len>."""
    with open(path, "w") as f:
        for c in contigs:
            s = c.seq.replace("T", "U") if rna else c.seq
            f.write(f">contig_id={c.cid}_length={len(s)}\n{s}\n")


def write_corrected_fasta(batch, paired: bool, prefix: str) -> None:
    """Corrected-read FASTA dump for --correct_reads=2 (ref
    Global::generateFasta, Global.cpp:78-119): <prefix>_1.fasta and
    <prefix>_2.fasta with headers '>i'.  Revcomp rows (even ids) are
    skipped in both files and the mate split (i%4==3 from _1, i%4==1 from
    _2) applies even to single-end input, as in the reference; invalidated
    reads are written as 100 Ns."""
    n_string = "N" * 100
    codes = batch.codes()
    lengths = batch.lengths
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)

    def seq(i: int) -> str:
        if not batch.valid[i]:
            return n_string
        return lut[codes[i, : int(lengths[i])]].tobytes().decode()

    for fileno in (1, 2):
        skip_mod = 3 if fileno == 1 else 1
        with open(f"{prefix}_{fileno}.fasta", "w") as f:
            for i in range(len(batch)):
                if i % 2 == 0 or i % 4 == skip_mod:
                    continue
                f.write(f">{i}\n{seq(i)}\n")
