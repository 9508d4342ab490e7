"""Read ingest + preprocessing (ref: src/IO/InputReader.cpp,
src/IO/ReadPreprocess.cpp).

Produces the reference's exact read layout:
  unpaired: [rc(r0), r0, rc(r1), r1, ...]
  paired:   blocks of 4 [rc(a), a, rc(b), b] for mate pairs (a, b)
(the reference appends (r, rc) at read time then swaps each pair —
ref InputReader.cpp:78-80 — so the reverse complement sits at the even id).

Filters (vectorized over a byte matrix instead of per-read loops):
  * end trim (default 3/3, skipped for reads shorter than trims+10 —
    ref InputReader.cpp:298-303),
  * N handling: drop read (+rc) when remove_reads_with_n, else randomize
    (ref :317-336),
  * short-tandem-repeat drop: min word period <= 20, computed as
    "exists p<=20 with s[i]==s[i+p] for all i" instead of per-read KMP
    (ref :341-353, MyUtils.h:160-171),
  * U->T for RNA.

Duplicate/prefix-read removal (ref ReadPreprocess::getPrefixReads):
lexicographic sort of all packed reads (prefix-consistent order), adjacent
LCP scan marks any read that is a prefix of its successor; strictly shorter
prefixes also mark their own revcomp (a proper suffix of the longer read).

A copy of alga_tpu/io/fastx.py, kept in step with it: the port
imports nothing of alga_tpu, whose package imports jax.
"""

from __future__ import annotations

import numpy as np

from alga_tpu_torch.core import packing
from alga_tpu_torch.core.seqbatch import SeqBatch


def detect_format(path: str) -> str:
    p = path.lower()
    if p.endswith((".fastq", ".fq")):
        return "fastq"
    if p.endswith(".pfasta"):
        return "pfasta"
    if p.endswith((".fasta", ".fa")):
        return "fasta"
    return "my_input"   # one sequence per line (ref Params::MY_INPUT)


def read_sequences(path: str, fmt: str | None = None,
                   add_paired_reads: bool = True) -> list[str]:
    fmt = fmt or detect_format(path)
    seqs = []
    with open(path) as f:
        if fmt == "pfasta":
            # PFASTA is a distinct live format (ref InputReader.cpp:156-165):
            # strict getline pairs (header, seq) with mates INTERLEAVED in
            # one file; when ADD_PAIRED_READS is off each record instead
            # spans 4 lines and the mate lines 3-4 are consumed and
            # discarded.  NB the paired offsets the reference assigns to
            # these reads have no live consumer without --file2 (reliable-
            # predecessor marking early-outs, ContigCreatorSinglePath.cpp:272),
            # so the assembly path treats the interleaved read order as-is.
            lines = f.read().split("\n")
            step = 2 if add_paired_reads else 4
            for i in range(0, len(lines) - 1, step):
                seqs.append(lines[i + 1].strip().split(" ")[0])
            return seqs
        if fmt == "fastq":
            for i, line in enumerate(f):
                if i % 4 == 1:
                    seqs.append(line.strip().split(" ")[0])
        elif fmt == "fasta":
            # reference reads single-line FASTA records (getline pairs,
            # ref InputReader.cpp:151-155); tolerate multi-line here
            cur = []
            for line in f:
                line = line.strip()
                if line.startswith(">"):
                    if cur:
                        seqs.append("".join(cur))
                        cur = []
                else:
                    cur.append(line.split(" ")[0])
            if cur:
                seqs.append("".join(cur))
        else:
            for line in f:
                s = line.strip().split(" ")[0]
                if s:
                    seqs.append(s)
    return seqs


def _min_period_leq(codes: np.ndarray, lengths: np.ndarray, thresh: int) -> np.ndarray:
    """bool[N]: min word period <= thresh (drops all reads of length <=
    thresh as a degenerate case, like the reference KMP formula)."""
    n, lpad = codes.shape
    lengths = lengths.astype(np.int64)
    out = np.zeros(n, dtype=bool)
    cols = np.arange(lpad, dtype=np.int64)[None, :]
    for p in range(1, thresh + 1):
        if p >= lpad:
            out |= lengths <= p
            continue
        eq = codes[:, :-p] == codes[:, p:]
        validc = cols[:, : lpad - p] < (lengths[:, None] - p)
        out |= np.where(validc, eq, True).all(axis=1)
    return out


def preprocess_reads(seqs: list[str], *, trim_left: int = 3, trim_right: int = 3,
                     remove_reads_with_n: bool = True, rna: bool = False,
                     str_period: int = 20, rng_seed: int = 7):
    """Trim/filter, returning (codes uint8[N, L], lengths, dropped bool[N]).

    dropped[i] marks reads removed by the N or STR filter (the read slot is
    kept, like the reference's nullptr entries).
    """
    n = len(seqs)
    raw, lengths = packing.strings_to_byte_matrix(seqs)
    lpad = raw.shape[1]

    if rna:
        raw[raw == ord("U")] = ord("T")

    # end trim (ref InputReader.cpp:298-303)
    do_trim = lengths >= trim_left + trim_right + 10
    new_len = np.where(do_trim, lengths - trim_left - trim_right, lengths)
    cols = np.arange(lpad, dtype=np.int64)[None, :]
    src = cols + np.where(do_trim, trim_left, 0)[:, None]
    src = np.minimum(src, lpad - 1)
    trimmed = np.take_along_axis(raw, src, axis=1)
    trimmed[cols >= new_len[:, None]] = 0
    lengths = new_len

    has_n = ((trimmed == ord("N")) & (cols < lengths[:, None])).any(axis=1)
    dropped = np.zeros(n, dtype=bool)
    if remove_reads_with_n:
        dropped |= has_n
    else:
        rng = np.random.default_rng(rng_seed)
        pos = np.where((trimmed == ord("N")) & (cols < lengths[:, None]))
        trimmed[pos] = np.frombuffer(b"ACGT", dtype=np.uint8)[
            rng.integers(0, 4, size=len(pos[0]))]

    # encode to 2-bit codes
    lut = np.zeros(256, dtype=np.uint8)
    lut[ord("C")] = 1
    lut[ord("G")] = 2
    lut[ord("T")] = 3
    codes = lut[trimmed]
    codes[cols >= lengths[:, None]] = 0

    dropped |= _min_period_leq(codes, lengths, str_period)
    return codes, lengths, dropped


def _build_read_batch_native_mats(r1, rl1, r2=None, rl2=None, *,
                                  trim_left=3, trim_right=3, rna=False,
                                  str_period=20) -> SeqBatch:
    """Native fast path from raw ASCII byte matrices: one fused
    multithreaded C++ pass to the interleaved [rc, fwd] packed rows
    (alga_preprocess_pack)."""
    from alga_tpu_torch import native

    paired = r2 is not None
    m = r1.shape[0]
    if paired:
        assert r2.shape[0] == m, "mate files must align"
        lpad = max(r1.shape[1], r2.shape[1])
        nrows, step = 4 * m, 4
    else:
        lpad = r1.shape[1]
        nrows, step = 2 * m, 2
    wpad = packing.words_for(lpad)
    packed = np.zeros((nrows, wpad), dtype=np.uint32)
    lengths = np.zeros(nrows, dtype=np.int32)
    dropped = np.zeros(nrows, dtype=np.uint8)
    kw = dict(trim_left=trim_left, trim_right=trim_right, rna=rna,
              str_period=str_period, out_step=step, out_packed=packed,
              out_lengths=lengths, out_dropped=dropped)
    native.preprocess_pack(r1, rl1, out_base=1, **kw)
    if paired:
        native.preprocess_pack(r2, rl2, out_base=3, **kw)
    batch = SeqBatch(packed, lengths, ~dropped.astype(bool))
    return batch


def _build_read_batch_native(file1_seqs, file2_seqs, **kw) -> SeqBatch:
    """List-of-str front end of the native fast path (kept for callers that
    already materialized sequences)."""
    paired = file2_seqs is not None and len(file2_seqs) > 0
    r1, rl1 = packing.strings_to_byte_matrix(file1_seqs)
    r2 = rl2 = None
    if paired:
        r2, rl2 = packing.strings_to_byte_matrix(file2_seqs)
    return _build_read_batch_native_mats(r1, rl1, r2, rl2, **kw)


def load_read_batch(file1: str, file2: str | None = None,
                    add_paired_reads: bool = True,
                    **pre_kwargs) -> SeqBatch:
    """File path -> SeqBatch without a list[str] detour: the file bytes are
    read in one gulp and parsed by the multithreaded native scanner
    (native.fastx_parse, the P7 parallel-ingest equivalent of ref
    InputReader.cpp:272-391), feeding the fused preprocess+pack pass.
    Python-heap overhead is O(1); falls back to the list[str] path when the
    native library is unavailable or N-randomization is requested."""
    from alga_tpu_torch import native

    def _fmt(path):
        fmt = detect_format(path)
        if fmt == "pfasta":
            # 2-line interleaved framing == strict FASTA framing; the
            # 4-line unpaired mode needs the python parser below
            return "fasta" if add_paired_reads else None
        return fmt

    native_ok = all(_fmt(p) is not None for p in (file1, file2) if p)
    if (native_ok and pre_kwargs.get("remove_reads_with_n", True)
            and native.available()):
        kw = {k: v for k, v in pre_kwargs.items()
              if k in ("trim_left", "trim_right", "rna", "str_period")}
        def _parse(path):
            # mmap the file: the parser reads pages straight from the page
            # cache, no extra copy
            buf = np.memmap(path, dtype=np.uint8, mode="r")
            if len(buf) == 0:
                return (np.zeros((0, 1), np.uint8), np.zeros(0, np.int64))
            return native.fastx_parse(np.asarray(buf), _fmt(path))

        r1, rl1 = _parse(file1)
        r2 = rl2 = None
        if file2:
            r2, rl2 = _parse(file2)
        return _build_read_batch_native_mats(r1, rl1, r2, rl2, **kw)

    seqs1 = read_sequences(file1, add_paired_reads=add_paired_reads)
    seqs2 = (read_sequences(file2, add_paired_reads=add_paired_reads)
             if file2 else None)
    return build_read_batch(seqs1, seqs2, **pre_kwargs)


def build_read_batch(file1_seqs: list[str], file2_seqs: list[str] | None = None,
                     **pre_kwargs) -> SeqBatch:
    """Assemble the (rc, r) interleaved batch with paired-offset table."""
    paired = file2_seqs is not None and len(file2_seqs) > 0
    if paired:
        assert len(file1_seqs) == len(file2_seqs), "mate files must align"

    from alga_tpu_torch import native
    if pre_kwargs.get("remove_reads_with_n", True) and native.available():
        kw = {k: v for k, v in pre_kwargs.items()
              if k in ("trim_left", "trim_right", "rna", "str_period")}
        return _build_read_batch_native(file1_seqs, file2_seqs, **kw)

    c1, l1, d1 = preprocess_reads(file1_seqs, **pre_kwargs)
    if paired:
        c2, l2, d2 = preprocess_reads(file2_seqs, **pre_kwargs)
        lpad = max(c1.shape[1], c2.shape[1])
        if c1.shape[1] < lpad:
            c1 = np.pad(c1, ((0, 0), (0, lpad - c1.shape[1])))
        if c2.shape[1] < lpad:
            c2 = np.pad(c2, ((0, 0), (0, lpad - c2.shape[1])))
        m = len(file1_seqs)
        codes = np.zeros((4 * m, lpad), dtype=np.uint8)
        lengths = np.zeros(4 * m, dtype=np.int64)
        dropped = np.zeros(4 * m, dtype=bool)
        # block [rc(a), a, rc(b), b]
        codes[1::4] = c1
        codes[3::4] = c2
        codes[0::4] = packing.revcomp_codes(c1, l1)
        codes[2::4] = packing.revcomp_codes(c2, l2)
        lengths[1::4] = l1
        lengths[3::4] = l2
        lengths[0::4] = l1
        lengths[2::4] = l2
        dropped[1::4] = d1
        dropped[3::4] = d2
        dropped[0::4] = d1
        dropped[2::4] = d2
    else:
        m = len(file1_seqs)
        lpad = c1.shape[1]
        codes = np.zeros((2 * m, lpad), dtype=np.uint8)
        lengths = np.zeros(2 * m, dtype=np.int64)
        dropped = np.zeros(2 * m, dtype=bool)
        codes[1::2] = c1
        codes[0::2] = packing.revcomp_codes(c1, l1)
        lengths[1::2] = l1
        lengths[0::2] = l1
        dropped[1::2] = d1
        dropped[0::2] = d1

    batch = SeqBatch.from_codes(codes, lengths)
    batch.valid = ~dropped
    return batch


def _reverse_2bit_fields(w: np.ndarray) -> np.ndarray:
    """uint32: reverse the 16 little-endian 2-bit fields of each word, so
    base 0 lands in the most significant field — numeric (and big-endian
    memcmp) order of the result IS base-lexicographic order.  The same
    trick as the reference's bit-reversed bucket keys
    (ref ReadPreprocess.cpp:79-152)."""
    w = w.copy()
    m1, m2, m3 = np.uint32(0x33333333), np.uint32(0x0F0F0F0F), np.uint32(0x00FF00FF)
    w = ((w & m1) << np.uint32(2)) | ((w >> np.uint32(2)) & m1)
    w = ((w & m2) << np.uint32(4)) | ((w >> np.uint32(4)) & m2)
    w = ((w & m3) << np.uint32(8)) | ((w >> np.uint32(8)) & m3)
    return (w << np.uint32(16)) | (w >> np.uint32(16))


# first differing 2-bit field (from the most significant) of a nonzero
# xor byte: (8 - bit_length) // 2
_FIRST_FIELD = np.array([(8 - int(b).bit_length()) // 2 if b else 0
                         for b in range(256)], dtype=np.int64)


def mark_prefix_reads(batch: SeqBatch) -> np.ndarray:
    """bool[N]: reads to remove as duplicates/prefixes of other reads
    (ref ReadPreprocess::getPrefixReads, mode PREF_READS_ALL_PREFIX_READS).
    Only valid reads participate.

    Runs PACKED-native: sort keys are the field-reversed packed words
    stored big-endian (memcmp == base-lex order; a read's A-padded tail +
    an explicit length tail gives the same total order as the previous
    unpacked 0-sentinel keys — proof in the pull notes), so the whole
    pass never materializes the uint8[N, L] code matrix (which was ~2/3
    of the phase's wall time and memory)."""
    n = len(batch)
    marked = np.zeros(n, dtype=bool)
    ids = np.flatnonzero(batch.valid)
    if len(ids) == 0:
        return marked
    from alga_tpu_torch import native as _nat
    if _nat.available():
        # native twin: key build + 2-way parallel merge sort + adjacent
        # scan in C (differential-tested against the numpy path below)
        rm, rm_rc = _nat.mark_prefix(np.asarray(batch.packed), ids,
                                     batch.lengths[ids].astype(np.int64))
        marked[ids[rm]] = True
        marked[SeqBatch.revcomp_id(ids[rm_rc])] = True
        return marked
    packed = np.asarray(batch.packed)[ids]
    lengths = batch.lengths[ids].astype(np.int64)
    # the sort key's length tie-break is 2 big-endian bytes (ADVICE r3):
    # reads are hard-capped well below this, but fail loudly if violated
    assert int(lengths.max(initial=0)) <= 0xFFFF, \
        "mark_prefix_reads: 16-bit length tie-break overflow"
    W = packed.shape[1]

    rev = _reverse_2bit_fields(packed.astype(np.uint32))
    kb = np.empty((len(ids), 4 * W + 2), dtype=np.uint8)
    kb[:, : 4 * W] = rev.astype(">u4").view(np.uint8).reshape(len(ids), 4 * W)
    kb[:, 4 * W] = (lengths >> 8).astype(np.uint8)
    kb[:, 4 * W + 1] = (lengths & 0xFF).astype(np.uint8)
    skeys = np.ascontiguousarray(kb).view(f"S{4 * W + 2}").ravel()
    order = np.argsort(skeys, kind="stable")

    sc = kb[order]
    sl = lengths[order]
    sid = ids[order]
    neq = sc[:-1] != sc[1:]
    any_neq = neq.any(axis=1)
    bidx = neq.argmax(axis=1)
    rows = np.arange(len(sc) - 1)
    xorb = sc[:-1][rows, bidx] ^ sc[1:][rows, bidx]
    fm = bidx * 4 + _FIRST_FIELD[xorb]
    # mismatch in the length tail (or full equality) = content equal
    first_mismatch = np.where(any_neq & (bidx < 4 * W), fm, 16 * W)
    is_prefix = first_mismatch >= sl[:-1]
    marked[sid[:-1][is_prefix]] = True
    strict = is_prefix & (sl[:-1] < sl[1:])
    marked[SeqBatch.revcomp_id(sid[:-1][strict])] = True
    return marked
