"""ctypes binding for the native host graph engine (native/alga_host.cpp).

Loads native/libalga_host.so (built via `make -C native`; auto-built on
first use when a compiler is available).  Falls back to the pure-Python
twin implementations when unavailable — the Python versions are the
differential-test oracles and stay authoritative for semantics.

A copy of alga_tpu/native.py, kept in step with it: the port
imports nothing of alga_tpu, whose package imports jax.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SO = os.path.join(_NATIVE_DIR, "libalga_host.so")

_lib = None


def _try_build() -> bool:
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True, timeout=120)
        return os.path.exists(_SO)
    except Exception:
        return False


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SO) and not _try_build():
        return None
    lib = ctypes.CDLL(_SO)

    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

    lib.alga_simplify_graph_old.restype = ctypes.c_int64
    lib.alga_simplify_graph_old.argtypes = [
        ctypes.c_int32, ctypes.c_int64, i32p, i32p, i32p, u8p, i32p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p]
    lib.alga_mst_pass.restype = ctypes.c_int64
    lib.alga_mst_pass.argtypes = [
        ctypes.c_int32, ctypes.c_int64, i32p, i32p, i32p,
        ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p]
    lib.alga_mst_pops.restype = ctypes.c_int64
    lib.alga_mst_pops.argtypes = [
        ctypes.c_int32, ctypes.c_int64, i32p, i32p, i32p,
        i32p, ctypes.c_int64, ctypes.c_int32, i32p, i32p, i32p]

    lib.alga_consensus.restype = None
    lib.alga_consensus.argtypes = [
        ctypes.c_int64, i64p, i32p, i32p,
        u8p, ctypes.c_int64, i32p, i64p, ctypes.c_int32,
        u8p, i64p, i64p]

    u32p_ = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.alga_consensus_packed.restype = None
    lib.alga_consensus_packed.argtypes = [
        ctypes.c_int64, i64p, i32p, i32p,
        u32p_, ctypes.c_int64, i32p, i64p, ctypes.c_int32,
        u8p, i64p, i64p, ctypes.c_int32]

    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.alga_gcps_from_matches.restype = ctypes.c_int64
    lib.alga_gcps_from_matches.argtypes = [
        ctypes.c_int32, ctypes.c_int64, i32p, i32p, i32p,
        u32p, ctypes.c_int64, i32p,
        ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, i64p]

    u64po = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.alga_li_kmers.restype = None
    lib.alga_li_kmers.argtypes = [
        u32p, ctypes.c_int64, i32p, i64p, ctypes.c_int64,
        u8p, ctypes.c_int32, ctypes.c_int32,
        i64p, i64p, i64p, u64po, u64po, ctypes.c_int32]

    lib.alga_acler_batch.restype = None
    lib.alga_acler_batch.argtypes = [
        u32p, ctypes.c_int64, i32p, i64p, i64p, i64p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, u8p, ctypes.c_int32]

    lib.alga_preprocess_pack.restype = None
    lib.alga_preprocess_pack.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, i64p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        u32p, i32p, u8p, ctypes.c_int32]

    lib.alga_contract_and_walk.restype = ctypes.c_int64
    lib.alga_contract_and_walk.argtypes = [
        ctypes.c_int32, ctypes.c_int64, i32p, i32p, i32p, u8p, i32p,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, i8p, ctypes.c_double,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64,
        i64p, i32p, i32p, ctypes.c_int32]

    lib.alga_pkb_replay.restype = ctypes.c_int64
    lib.alga_pkb_replay.argtypes = [
        ctypes.c_int64, i32p,
        ctypes.c_int64, i32p, i32p, u8p, u8p,
        i64p,
        ctypes.c_int64, i64p, i64p,
        ctypes.c_int64,
        i64p, i32p, ctypes.c_int64,
        i64p, i32p, ctypes.c_int64,
        i64p, i32p]

    lib.alga_correct_pass.restype = ctypes.c_int64
    lib.alga_correct_pass.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, i64p, u8p, i64p, i64p,
        ctypes.c_int64, ctypes.c_int32]

    lib.alga_graph_record_starts.restype = ctypes.c_int64
    lib.alga_graph_record_starts.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.alga_graph_pack.restype = ctypes.c_int64
    lib.alga_graph_pack.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i32p, i32p, i32p, i64p, i32p]
    lib.alga_graph_unpack.restype = ctypes.c_int64
    lib.alga_graph_unpack.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int64, i32p, i32p, i32p]

    lib.alga_fastx_scan.restype = ctypes.c_int64
    lib.alga_fastx_scan.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int32, i64p, i64p, ctypes.c_int64,
        i64p, ctypes.c_int32]
    lib.alga_fastx_fill.restype = None
    lib.alga_fastx_fill.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, u8p, i64p,
        ctypes.c_int64, i64p, ctypes.c_int64]
    lib.alga_fastx_fill_range.restype = None
    lib.alga_fastx_fill_range.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64, u8p, i64p,
        ctypes.c_int64, ctypes.c_int64, i64p, ctypes.c_int64]
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.alga_join_ranges.restype = None
    lib.alga_join_ranges.argtypes = [
        u64p, ctypes.c_int64, u64p, ctypes.c_int64, i64p, i64p,
        ctypes.c_int32]
    lib.alga_window_hash.restype = None
    lib.alga_window_hash.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_uint32, ctypes.c_uint32, u64p, ctypes.c_int32]
    lib.alga_gcps_join_verify.restype = ctypes.c_int64
    lib.alga_gcps_join_verify.argtypes = [
        u64p, ctypes.c_int64, ctypes.c_int64, i64p, u8p,
        ctypes.c_int32, ctypes.c_int32,
        u64p, i32p, ctypes.c_int64,
        u32p, ctypes.c_int64,
        i32p, i32p, i32p, ctypes.c_int64, ctypes.c_int32, i64p]
    lib.alga_pkb_pairgen.restype = ctypes.c_int64
    lib.alga_pkb_pairgen.argtypes = [
        i64p, i64p, ctypes.c_int64, i64p, i64p, ctypes.c_int64, i64p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        u8p, u8p, ctypes.c_int32, i64p, i64p, u8p, ctypes.c_int32]
    lib.alga_sort3_u64.restype = None
    lib.alga_sort3_u64.argtypes = [
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, i64p, ctypes.c_int32]
    lib.alga_pack_ragged.restype = None
    lib.alga_pack_ragged.argtypes = [
        u8p, i64p, ctypes.c_int64, ctypes.c_int64, u32p, ctypes.c_int32]
    lib.alga_mark_prefix.restype = None
    lib.alga_mark_prefix.argtypes = [
        u32p, ctypes.c_int64, i64p, i64p, ctypes.c_int64,
        u8p, u8p, ctypes.c_int32]
    lib.alga_sort_len_desc.restype = None
    lib.alga_sort_len_desc.argtypes = [ctypes.c_int64, i64p, i32p]
    lib.alga_prefix_keys.restype = None
    lib.alga_prefix_keys.argtypes = [
        u32p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_uint32, ctypes.c_uint32, u64p, ctypes.c_int32]
    lib.alga_gcps_join_verify_packed.restype = ctypes.c_int64
    lib.alga_gcps_join_verify_packed.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, u8p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_uint32, ctypes.c_uint32,
        u64p, i32p, ctypes.c_int64,
        u32p, ctypes.c_int64,
        i32p, i32p, i32p, ctypes.c_int64, ctypes.c_int32, i64p]
    _lib = lib
    return lib


def available() -> bool:
    return get_lib() is not None


def preprocess_pack(raw, raw_lens, *, trim_left: int, trim_right: int,
                    rna: bool, str_period: int,
                    out_base: int, out_step: int,
                    out_packed, out_lengths, out_dropped,
                    nthreads: int = 0) -> None:
    """Fused trim/N-drop/STR-filter/encode/revcomp/pack from the raw ASCII
    byte matrix into pre-allocated interleaved SeqBatch rows.  Only valid
    for the remove_reads_with_n path (N randomization stays in Python)."""
    lib = get_lib()
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    raw_lens = np.ascontiguousarray(raw_lens, dtype=np.int64)
    lib.alga_preprocess_pack(
        raw, raw.shape[0], raw.shape[1], raw_lens,
        trim_left, trim_right, 1 if rna else 0, str_period,
        out_base, out_step, out_packed.shape[1],
        out_packed, out_lengths, out_dropped, nthreads)


_FX_FMT = {"my_input": 0, "fasta": 1, "fastq": 2}


def fastx_scan(buf: np.ndarray, fmt: str, nthreads: int = 0):
    """Pass-1 parallel scan only: (record count, max record length, meta,
    nchunks) — cheap (line counting), used by every process of a
    multi-host ingest to agree on the global record layout."""
    lib = get_lib()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    maxlen = np.zeros(1, dtype=np.int64)
    cap = max(256, (os.cpu_count() or 1) * 4)
    meta = np.zeros(3 * cap, dtype=np.int64)
    nchunks = np.zeros(1, dtype=np.int64)
    n = int(lib.alga_fastx_scan(buf, len(buf), _FX_FMT[fmt], maxlen, meta,
                                cap, nchunks, nthreads))
    return n, int(maxlen[0]), meta, int(nchunks[0])


def fastx_fill_range(buf: np.ndarray, fmt: str, lpad: int,
                     rec_lo: int, rec_hi: int, meta, nchunks: int):
    """Pass-2 fill of records [rec_lo, rec_hi) into a dense byte matrix
    (the per-process slice of a multi-host ingest)."""
    lib = get_lib()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    m = max(0, rec_hi - rec_lo)
    mat = np.zeros((m, max(1, lpad)), dtype=np.uint8)
    lens = np.zeros(m, dtype=np.int64)
    if m:
        lib.alga_fastx_fill_range(buf, len(buf), _FX_FMT[fmt], mat.shape[1],
                                  mat, lens, rec_lo, rec_hi, meta, nchunks)
    return mat, lens


def fastx_parse(buf: np.ndarray, fmt: str, nthreads: int = 0):
    """Parallel FASTX parse of a raw file buffer (uint8[size]) into a dense
    byte matrix (uint8[n, maxlen]) + lengths (int64[n]) — the P7 ingest
    (ref InputReader.cpp:272-391) with chunked threads over one mmap'd
    buffer instead of T file handles."""
    lib = get_lib()
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    fmt_i = _FX_FMT[fmt]
    maxlen = np.zeros(1, dtype=np.int64)
    cap = max(256, (os.cpu_count() or 1) * 4)
    meta = np.zeros(3 * cap, dtype=np.int64)
    nchunks = np.zeros(1, dtype=np.int64)
    n = int(lib.alga_fastx_scan(buf, len(buf), fmt_i, maxlen, meta, cap,
                                nchunks, nthreads))
    lpad = max(1, int(maxlen[0]))
    mat = np.zeros((n, lpad), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int64)
    if n:
        lib.alga_fastx_fill(buf, len(buf), fmt_i, lpad, mat, lens, n,
                            meta, int(nchunks[0]))
    return mat, lens


def pkb_replay(rid_s, ind_s, starts, ends, pi, pj, pass_static, pair_can,
               n: int, base_keys, base_offs, overlay: dict) -> dict:
    """Native twin of supplement._replay_runs: sequential PKB branch-marker
    replay over equal-hash runs with precomputed alignment verdicts.
    Returns the UPDATED overlay dict (input overlay merged with the edges
    added by the replay, min-offset semantics)."""
    lib = get_lib()
    nrec = len(rid_s)
    pi = np.asarray(pi)
    counts = np.bincount(pi, minlength=nrec).astype(np.int64)
    cum = np.zeros(nrec + 1, dtype=np.int64)
    np.cumsum(counts, out=cum[1:])
    ind_s = np.asarray(ind_s)
    pj = np.ascontiguousarray(pj, dtype=np.int32)
    off_all = np.ascontiguousarray(ind_s[pi] - ind_s[np.asarray(pj)],
                                   dtype=np.int32)
    rid32 = np.ascontiguousarray(rid_s, dtype=np.int32)
    okv = np.ascontiguousarray(np.asarray(pass_static, bool).view(np.uint8))
    canv = np.ascontiguousarray(np.asarray(pair_can, bool).view(np.uint8))
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    base_keys = np.ascontiguousarray(base_keys, dtype=np.int64)
    base_offs = np.ascontiguousarray(base_offs, dtype=np.int32)
    nin = len(overlay)
    in_keys = np.fromiter(overlay.keys(), dtype=np.int64, count=nin)
    in_offs = np.fromiter(overlay.values(), dtype=np.int32, count=nin)
    cap = nin + len(pj) + 1
    out_keys = np.empty(cap, dtype=np.int64)
    out_offs = np.empty(cap, dtype=np.int32)
    m = int(lib.alga_pkb_replay(
        nrec, rid32, len(pj), pj, off_all, okv, canv, cum,
        len(starts), starts, ends, n, base_keys, base_offs, len(base_keys),
        in_keys, in_offs, nin, out_keys, out_offs))
    return dict(zip(out_keys[:m].tolist(), out_offs[:m].tolist()))


def correct_pass(codes: np.ndarray, lengths, valid, spec_b, spec_s,
                 nthreads: int = 0) -> int:
    """One direction of the k-mer-spectrum corrector fix-up, parallel over
    reads (ref ReadCorrector::applyCorrectionToRead).  Mutates `codes` in
    place; returns the number of reads changed."""
    lib = get_lib()
    assert codes.flags["C_CONTIGUOUS"]
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    valid = np.ascontiguousarray(np.asarray(valid, dtype=bool).view(np.uint8))
    spec_b = np.ascontiguousarray(spec_b, dtype=np.int64)
    spec_s = np.ascontiguousarray(spec_s, dtype=np.int64)
    return int(lib.alga_correct_pass(
        codes, codes.shape[0], codes.shape[1], lengths, valid,
        spec_b, spec_s, len(spec_b), nthreads))


def simplify_graph_old(g, batch, mopp: int, modb: int, threads: int = 6):
    """Native twin of alga_tpu_torch.graph.simplify.simplify_graph_old; updates
    batch.valid in place, returns the simplified OverlapGraph."""
    from alga_tpu_torch.graph.overlap_graph import OverlapGraph

    lib = get_lib()
    n = g.n
    ne = g.num_edges
    src = np.ascontiguousarray(g.src, dtype=np.int32)
    dst = np.ascontiguousarray(g.dst, dtype=np.int32)
    off = np.ascontiguousarray(g.offset, dtype=np.int32)
    valid = np.ascontiguousarray(batch.valid.astype(np.uint8))
    lens = np.ascontiguousarray(batch.lengths, dtype=np.int32)
    out_src = np.empty(ne, dtype=np.int32)
    out_dst = np.empty(ne, dtype=np.int32)
    out_off = np.empty(ne, dtype=np.int32)
    m = lib.alga_simplify_graph_old(n, ne, src, dst, off, valid, lens,
                                    mopp, modb, threads,
                                    out_src, out_dst, out_off)
    batch.valid &= valid.astype(bool)
    return OverlapGraph(n, out_src[:m].copy(), out_dst[:m].copy(), out_off[:m].copy())


def mst_pass(g, mopp_scaled: int, threads: int = 6):
    """Native removeShortParallelPaths alone (used by the sharded
    simplifier orchestration); returns the post-pass OverlapGraph in
    canonical (src, offset, dst) order."""
    from alga_tpu_torch.graph.overlap_graph import OverlapGraph
    lib = get_lib()
    ne = g.num_edges
    src = np.ascontiguousarray(g.src, dtype=np.int32)
    dst = np.ascontiguousarray(g.dst, dtype=np.int32)
    off = np.ascontiguousarray(g.offset, dtype=np.int32)
    out_src = np.empty(max(ne, 1), dtype=np.int32)
    out_dst = np.empty(max(ne, 1), dtype=np.int32)
    out_off = np.empty(max(ne, 1), dtype=np.int32)
    m = lib.alga_mst_pass(g.n, ne, src, dst, off, mopp_scaled, threads,
                          out_src, out_dst, out_off)
    return OverlapGraph(g.n, out_src[:m].copy(), out_dst[:m].copy(),
                        out_off[:m].copy())


def contract_and_walk(g, batch, mopp: int, min_output_length: int,
                      paired: bool, min_paired_connections: int,
                      max_insert_size: int, threads: int = 6):
    """Native contraction + walk; returns list of contig read-lists
    [(read_id, offset), ...] in creation order."""
    lib = get_lib()
    n = g.n
    ne = g.num_edges
    src = np.ascontiguousarray(g.src, dtype=np.int32)
    dst = np.ascontiguousarray(g.dst, dtype=np.int32)
    off = np.ascontiguousarray(g.offset, dtype=np.int32)
    valid = np.ascontiguousarray(batch.valid.astype(np.uint8))
    lens = np.ascontiguousarray(batch.lengths, dtype=np.int32)
    po = np.ascontiguousarray(batch.paired_offset, dtype=np.int8)

    max_contigs = max(1024, 2 * n)
    cap_reads = max(4096, 4 * (ne + n))
    while True:
        indptr = np.zeros(max_contigs + 1, dtype=np.int64)
        creads = np.empty(cap_reads, dtype=np.int32)
        coffs = np.empty(cap_reads, dtype=np.int32)
        nc = lib.alga_contract_and_walk(
            n, ne, src, dst, off, valid, lens, mopp, min_output_length,
            1 if paired else 0, po, float(batch.avg_read_length()),
            min_paired_connections, max_insert_size,
            max_contigs, cap_reads, indptr, creads, coffs, threads)
        if nc >= 0:
            break
        max_contigs *= 2
        cap_reads *= 2

    out = []
    for c in range(nc):
        a, b = indptr[c], indptr[c + 1]
        out.append(list(zip(creads[a:b].tolist(), coffs[a:b].tolist())))
    return out


def consensus_native(contigs, batch, codes, coverage_thr: int,
                     threads: int = 0):
    """Native consensus voting; fills contig.seq.  contigs carry read lists.

    When `codes` is None the vote reads the 2-bit packed store directly
    (alga_consensus_packed) — no uint8[N, L] matrix is ever materialized
    (the memory-diet path; ref streams per-read, Read.cpp:40-68)."""
    lib = get_lib()
    nc = len(contigs)
    indptr = np.zeros(nc + 1, dtype=np.int64)
    reads_flat, offs_flat = [], []
    lengths = batch.lengths.astype(np.int64)
    col_base = np.zeros(nc + 1, dtype=np.int64)
    for i, c in enumerate(contigs):
        rids = np.fromiter((r for r, _ in c.reads), dtype=np.int32, count=len(c.reads))
        offs = np.fromiter((o for _, o in c.reads), dtype=np.int32, count=len(c.reads))
        reads_flat.append(rids)
        offs_flat.append(offs)
        indptr[i + 1] = indptr[i] + len(rids)
        ncols = int(offs[1:].sum() + lengths[rids[-1]])
        col_base[i + 1] = col_base[i] + ncols
    creads = np.ascontiguousarray(np.concatenate(reads_flat), dtype=np.int32)
    coffs = np.ascontiguousarray(np.concatenate(offs_flat), dtype=np.int32)
    rl = np.ascontiguousarray(batch.lengths, dtype=np.int32)
    out_bases = np.empty(int(col_base[-1]), dtype=np.uint8)
    out_begin = np.empty(nc, dtype=np.int64)
    out_end = np.empty(nc, dtype=np.int64)
    if codes is None:
        packed = np.ascontiguousarray(batch.packed, dtype=np.uint32)
        lib.alga_consensus_packed(nc, indptr, creads, coffs, packed,
                                  packed.shape[1], rl, col_base,
                                  coverage_thr, out_bases, out_begin,
                                  out_end, threads)
    else:
        codes = np.ascontiguousarray(codes)
        lib.alga_consensus(nc, indptr, creads, coffs, codes, codes.shape[1],
                           rl, col_base, coverage_thr, out_bases, out_begin,
                           out_end)
    basechars = np.frombuffer(b"ACGT", dtype=np.uint8)
    for i, c in enumerate(contigs):
        b, e = int(out_begin[i]), int(out_end[i])
        if b >= e:
            c.seq = ""
        else:
            a0 = int(col_base[i])
            c.seq = basechars[out_bases[a0 + b : a0 + e]].tobytes().decode("ascii")


def window_hash(codes: np.ndarray, k: int, num_windows: int,
                a1, a2, threads: int = 0) -> np.ndarray:
    """uint64[N, num_windows] combined window keys — native twin of
    hashes.np_window_kmer_keys + combine_keys (one rolling multiply-add
    pass per base, multithreaded; bit-identical incl. padded positions)."""
    lib = get_lib()
    c = np.ascontiguousarray(codes, dtype=np.uint8)
    n, lpad = c.shape
    out = np.empty((max(n, 1), max(num_windows, 1)), dtype=np.uint64)
    lib.alga_window_hash(c, n, lpad, k, num_windows,
                         int(a1), int(a2), out, threads)
    return out[:n, :num_windows]


def gcps_join_verify(keys: np.ndarray, lengths: np.ndarray, af: np.ndarray,
                     k: int, cap: int,
                     table_keys_sorted: np.ndarray, table_ids: np.ndarray,
                     packed: np.ndarray, threads: int = 0):
    """(src, dst, ell) int32 arrays: fused window-key join + packed exact
    verification — native twin of the probe/expand/verify chain in
    prefsuf.find_exact_overlaps (row-major probe order, table-run order
    within a key: identical match order)."""
    lib = get_lib()
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n, nw = keys.shape
    lens = np.ascontiguousarray(lengths, dtype=np.int64)
    afc = np.ascontiguousarray(af, dtype=np.uint8)
    tk = np.ascontiguousarray(table_keys_sorted, dtype=np.uint64)
    ti = np.ascontiguousarray(table_ids, dtype=np.int32)
    pk = np.ascontiguousarray(packed, dtype=np.uint32)
    out_cap = max(4 * n, 1 << 16)
    cand = np.zeros(1, dtype=np.int64)
    while True:
        src = np.empty(out_cap, dtype=np.int32)
        dst = np.empty(out_cap, dtype=np.int32)
        ell = np.empty(out_cap, dtype=np.int32)
        m = lib.alga_gcps_join_verify(
            keys, n, nw, lens, afc, k, cap, tk, ti, len(tk),
            pk, pk.shape[1], src, dst, ell, out_cap, threads, cand)
        if m <= out_cap:
            from alga_tpu_torch.utils.timers import bump
            bump("gcps_candidates", int(cand[0]))
            return src[:m].copy(), dst[:m].copy(), ell[:m].copy()
        out_cap = m


def join_ranges(table_keys_sorted: np.ndarray, probe_keys: np.ndarray,
                threads: int = 0):
    """(lo int64[M], cnt int64[M]): equal-key range of each probe key in
    the SORTED table — hash-join twin of the two np.searchsorted calls
    (left/right) in prefsuf.find_exact_overlaps.  The port reaches it
    only from find_exact_overlaps, when the engine is loaded (its own
    GCPS host route takes the fused gcps_join_verify_packed then)."""
    lib = get_lib()
    t = np.ascontiguousarray(table_keys_sorted, dtype=np.uint64)
    p = np.ascontiguousarray(probe_keys, dtype=np.uint64)
    lo = np.empty(max(len(p), 1), dtype=np.int64)
    cnt = np.empty(max(len(p), 1), dtype=np.int64)
    lib.alga_join_ranges(t, len(t), p, len(p), lo, cnt, threads)
    return lo[: len(p)], cnt[: len(p)]


def gcps_from_matches(n, matches, packed, lengths, rsoe: int, soes: int):
    """Native twin of prefsuf.build_gcps_graph's post-match stages."""
    from alga_tpu_torch.graph.overlap_graph import OverlapGraph
    lib = get_lib()
    nm = len(matches.src)
    msrc = np.ascontiguousarray(matches.src, dtype=np.int32)
    mdst = np.ascontiguousarray(matches.dst, dtype=np.int32)
    mell = np.ascontiguousarray(matches.ell, dtype=np.int32)
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    lens = np.ascontiguousarray(lengths, dtype=np.int32)
    out_src = np.empty(max(nm, 1), dtype=np.int32)
    out_dst = np.empty(max(nm, 1), dtype=np.int32)
    out_off = np.empty(max(nm, 1), dtype=np.int32)
    dom = np.zeros(1, dtype=np.int64)
    m = lib.alga_gcps_from_matches(n, nm, msrc, mdst, mell, packed,
                                   packed.shape[1], lens, rsoe, soes,
                                   out_src, out_dst, out_off, dom)
    from alga_tpu_torch.utils.timers import bump
    bump("gcps_domination_checks", int(dom[0]))
    return OverlapGraph(n, out_src[:m].copy(), out_dst[:m].copy(),
                        out_off[:m].copy())


def li_kmers_native(packed, lengths, ids, priorities, k: int,
                    intervals: int, threads: int = 0):
    """(rid, ind, hi, lo): native LI minimizer extraction — twin of
    supplement.li_kmers restricted to the given read ids (each with
    length >= k).  Output in (read, interval) order; same multiset."""
    lib = get_lib()
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    lens = np.ascontiguousarray(lengths, dtype=np.int32)
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    pr = np.ascontiguousarray(priorities, dtype=np.uint8)
    nwin = lens[ids].astype(np.int64) - k + 1
    # per-read emission count = number of NONEMPTY intervals =
    # ceil(nwin / il) with il = ceil(nwin / intervals) (ref Read.cpp:180)
    il = np.maximum(-(-nwin // intervals), 1)
    cnt = np.where(nwin > 0, -(-nwin // il), 0)
    base = np.zeros(len(ids), dtype=np.int64)
    np.cumsum(cnt[:-1], out=base[1:])
    total = int(cnt.sum())
    out_id = np.empty(total, dtype=np.int64)
    out_ind = np.empty(total, dtype=np.int64)
    out_hi = np.empty(total, dtype=np.uint64)
    out_lo = np.empty(total, dtype=np.uint64)
    lib.alga_li_kmers(packed, packed.shape[1], lens, ids, len(ids), pr,
                      k, intervals, base, out_id, out_ind, out_hi, out_lo,
                      threads)
    return out_id, out_ind, out_hi, out_lo


def acler_batch_native(packed, lengths, r1, r2, offsets, cfg,
                       threads: int = 0) -> np.ndarray:
    """bool[M]: native packed ACLER + ACH guards — twin of
    ops/align._np_ach_chunk in its ACLER-only (default) configuration."""
    lib = get_lib()
    packed = np.ascontiguousarray(packed, dtype=np.uint32)
    lens = np.ascontiguousarray(lengths, dtype=np.int32)
    r1 = np.ascontiguousarray(r1, dtype=np.int64)
    r2 = np.ascontiguousarray(r2, dtype=np.int64)
    off = np.ascontiguousarray(offsets, dtype=np.int64)
    out = np.zeros(max(len(r1), 1), dtype=np.uint8)
    lib.alga_acler_batch(packed, packed.shape[1], lens, r1, r2, off,
                         len(r1), cfg.max_offset_considered_for_alignment,
                         cfg.min_offset_for_alignment,
                         cfg.min_overlap_area,
                         cfg.minimal_overlap_for_lcs_low_error,
                         cfg.alignment_controller_same_ends_length,
                         out, threads)
    return out[: len(r1)].astype(bool)

def graph_record_starts(data: np.ndarray, n: int) -> np.ndarray:
    """int64[n] record-start positions in a reference-format graph stream
    (ref Graph.cpp:220-266 layout; the data-dependent scan in C)."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.int32)
    starts = np.empty(max(n, 1), dtype=np.int64)
    end = lib.alga_graph_record_starts(data, len(data), n, starts)
    if end < 0 or end > len(data):
        raise ValueError("truncated reference graph file")
    return starts[:n]

def graph_pack(n: int, src, dst, off) -> np.ndarray:
    """int32 reference-format graph stream from unsorted edge arrays
    (counting sort by src in one native pass; ref Graph.cpp:268-295)."""
    lib = get_lib()
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    off = np.ascontiguousarray(off, dtype=np.int32)
    m = len(src)
    indptr = np.zeros(n + 1, dtype=np.int64)
    out = np.empty(1 + 2 * n + 2 * m, dtype=np.int32)
    length = lib.alga_graph_pack(n, m, src, dst, off, indptr, out)
    return out[:length]

def graph_unpack(data: np.ndarray, n: int, m: int):
    """(src, dst, off) int32 edge arrays from a reference-format graph
    stream in one native pass."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.int32)
    src = np.empty(max(m, 1), dtype=np.int32)
    dst = np.empty(max(m, 1), dtype=np.int32)
    off = np.empty(max(m, 1), dtype=np.int32)
    e = lib.alga_graph_unpack(data, len(data), n, src, dst, off)
    if e < 0 or e != m:
        raise ValueError("truncated reference graph file")
    return src[:m], dst[:m], off[:m]

def prefix_keys(packed, ids, k: int, a1, a2, threads: int = 0) -> np.ndarray:
    """uint64[len(ids)] window-0 double-hash keys straight from the packed
    store (twin of window_hash(...)[ids, 0] without the codes unpack)."""
    lib = get_lib()
    pk = np.ascontiguousarray(packed, dtype=np.uint32)
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    out = np.empty(max(len(ids), 1), dtype=np.uint64)
    lib.alga_prefix_keys(pk, pk.shape[1], ids, len(ids), k,
                         int(a1), int(a2), out, threads)
    return out[: len(ids)]


def gcps_join_verify_packed(n: int, nw: int, lengths, af, k: int, cap: int,
                            a1, a2, table_keys_sorted, table_ids,
                            packed, threads: int = 0):
    """(src, dst, ell): like gcps_join_verify but the probe-side window
    hashes roll inline from the packed store — no uint64[n, nw] key
    matrix, no codes unpack (match order identical)."""
    lib = get_lib()
    lens = np.ascontiguousarray(lengths, dtype=np.int64)
    afc = np.ascontiguousarray(af, dtype=np.uint8)
    tk = np.ascontiguousarray(table_keys_sorted, dtype=np.uint64)
    ti = np.ascontiguousarray(table_ids, dtype=np.int32)
    pk = np.ascontiguousarray(packed, dtype=np.uint32)
    out_cap = max(4 * n, 1 << 16)
    cand = np.zeros(1, dtype=np.int64)
    while True:
        src = np.empty(out_cap, dtype=np.int32)
        dst = np.empty(out_cap, dtype=np.int32)
        ell = np.empty(out_cap, dtype=np.int32)
        m = lib.alga_gcps_join_verify_packed(
            n, nw, lens, afc, k, cap, int(a1), int(a2), tk, ti, len(tk),
            pk, pk.shape[1], src, dst, ell, out_cap, threads, cand)
        if m <= out_cap:
            from alga_tpu_torch.utils.timers import bump
            bump("gcps_candidates", int(cand[0]))
            return src[:m].copy(), dst[:m].copy(), ell[:m].copy()
        out_cap = m

def mark_prefix(packed, ids, lengths, threads: int = 0):
    """(rm bool[nv], rm_rc bool[nv]) for the valid rows `ids`: native twin
    of fastx.mark_prefix_reads' sort + adjacent-LCP scan."""
    lib = get_lib()
    pk = np.ascontiguousarray(packed, dtype=np.uint32)
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    lens = np.ascontiguousarray(lengths, dtype=np.int64)
    nv = len(ids)
    rm = np.zeros(max(nv, 1), dtype=np.uint8)
    rmrc = np.zeros(max(nv, 1), dtype=np.uint8)
    if nv:
        lib.alga_mark_prefix(pk, pk.shape[1], ids, lens, nv, rm, rmrc,
                             threads)
    return rm[:nv].astype(bool), rmrc[:nv].astype(bool)


def sort_len_desc(keys) -> np.ndarray:
    """int32[n] index permutation of libstdc++ std::sort by key DESC (the
    reference's contig-length sort; oracle: utils/libstdcxx_sort.py)."""
    lib = get_lib()
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    idx = np.empty(max(len(keys), 1), dtype=np.int32)
    lib.alga_sort_len_desc(len(keys), keys, idx)
    return idx[: len(keys)]

def pack_ragged(seqs, width_words: int | None = None):
    """(packed uint32[n, W], lengths int64[n]) from a list of ACGT strings
    without the padded byte/code matrices of packing.pack_strings."""
    lib = get_lib()
    n = len(seqs)
    buf = "".join(seqs).encode("ascii")
    lens = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    max_len = int(lens.max(initial=0))
    W = width_words if width_words is not None else max(1, (max_len + 15) // 16)
    out = np.zeros((max(n, 1), W), dtype=np.uint32)
    if n:
        b = np.frombuffer(buf, dtype=np.uint8)
        if len(b) == 0:
            b = np.zeros(1, dtype=np.uint8)
        lib.alga_pack_ragged(np.ascontiguousarray(b), offsets, n, W, out, 0)
    return out[:n], lens

def sort3_u64(hi, lo, rest, threads: int = 0) -> np.ndarray:
    """int64[n] stable permutation == np.lexsort((rest, lo, hi))."""
    lib = get_lib()
    hi = np.ascontiguousarray(hi, dtype=np.uint64)
    lo = np.ascontiguousarray(lo, dtype=np.uint64)
    rest = np.ascontiguousarray(rest, dtype=np.uint64)
    order = np.empty(max(len(hi), 1), dtype=np.int64)
    lib.alga_sort3_u64(hi, lo, rest, len(hi), order, threads)
    return order[: len(hi)]

def mst_pops(g, seeds, mopp_scaled: int):
    """Apply MST pops for an explicit seed plan (wave order) — the host's
    O(changes) application step of the sharded MST pass."""
    from alga_tpu_torch.graph.overlap_graph import OverlapGraph
    lib = get_lib()
    ne = g.num_edges
    src = np.ascontiguousarray(g.src, dtype=np.int32)
    dst = np.ascontiguousarray(g.dst, dtype=np.int32)
    off = np.ascontiguousarray(g.offset, dtype=np.int32)
    seeds = np.ascontiguousarray(seeds, dtype=np.int32)
    out_src = np.empty(max(ne, 1), dtype=np.int32)
    out_dst = np.empty(max(ne, 1), dtype=np.int32)
    out_off = np.empty(max(ne, 1), dtype=np.int32)
    m = lib.alga_mst_pops(g.n, ne, src, dst, off, seeds, len(seeds),
                          mopp_scaled, out_src, out_dst, out_off)
    return OverlapGraph(g.n, out_src[:m].copy(), out_dst[:m].copy(),
                        out_off[:m].copy())


def pkb_pairgen(rid_s, ind_s, starts, ends, lens, moc: int, min_off: int,
                min_ovl: int, af, at, threads: int = 0):
    """(pi, pj, ok): native twin of supplement._gen_candidate_pairs
    (identical layout: i asc, j asc, grouped per i)."""
    lib = get_lib()
    rid_s = np.ascontiguousarray(rid_s, dtype=np.int64)
    ind_s = np.ascontiguousarray(ind_s, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    afc = np.ascontiguousarray(af, dtype=np.uint8)
    atc = np.ascontiguousarray(at, dtype=np.uint8)
    z = np.zeros(1, dtype=np.int64)
    zb = np.zeros(1, dtype=np.uint8)
    total = lib.alga_pkb_pairgen(rid_s, ind_s, len(rid_s), starts, ends,
                                 len(starts), lens, moc, min_off, min_ovl,
                                 afc, atc, 0, z, z, zb, threads)
    pi = np.empty(max(total, 1), dtype=np.int64)
    pj = np.empty(max(total, 1), dtype=np.int64)
    ok = np.empty(max(total, 1), dtype=np.uint8)
    if total:
        lib.alga_pkb_pairgen(rid_s, ind_s, len(rid_s), starts, ends,
                             len(starts), lens, moc, min_off, min_ovl,
                             afc, atc, 1, pi, pj, ok, threads)
    return pi[:total], pj[:total], ok[:total].astype(bool)
