#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (alga_tpu_torch) on one NVIDIA GPU and check
what it computes.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit code:

  1 device   CUDA is present; the card's name and power limit.
  2 build    nvcc builds alga_tpu_torch/csrc for sm_90a, one process per
             object (seconds, ptxas).
  3 kernels  each CUDA kernel against its plain PyTorch version on the card,
             exact integer equality (K2 at E = 1, 2, 3, 7, and on pairs
             of unequal lengths at E = 0, 1, 2, 3, 7, 15), at two shapes:
             the large one (K1: a 920k-row table, 2^20 indices; K2: 2^18
             pairs) here, and configuration B's own (the median table rows
             and pairs per launch that phase 6 logs) after phase 6.  Device
             milliseconds of each kernel (a CUDA graph of 20 launches), of
             its plain version and of the one library call that computes
             the same gather (K1: index_select), the bound (the least time
             for the bytes or the integer operations the inputs need, from
             H100 SXM peaks) and the kernel's share of it.
  4 graph    configuration A's graph on the bench's 40k-read dataset by
             the fused device path (ALGA_GCPS_DEVICE=small, and
             device_join.gcps_graph_device called directly), the blocked
             device path (ALGA_GCPS_DEVICE=wide) and the native host
             engine: the same edges, field for field; first-call and
             second-call seconds of each.
  5 A        configuration A (the default CLI run, error_rate=0) at E. coli
             scale (4.6 Mb genome, 2x100 bp, 10x: 920k read slots) through
             `python -m alga_tpu_torch.cli`; every contig must be an exact
             substring of the genome or of its reverse complement.
  6 B        configuration B (2% substitutions, error_rate=0.02, ACLCS
             fallback on) at the same scale through
             pipeline.assemble_to_file; both kernels must have launched on
             this main path, K1 once per LCS batch; the output of every
             launch on the path must equal the plain version's on the
             same inputs; the contigs must share >= 90% of their sampled
             31-mers with the genome.
  7 A fused  configuration A through the CLI with ALGA_GCPS_DEVICE=small
             and ALGA_DEVICE_CONSENSUS=1 (the fused GCPS path at 920k slots
             and the device consensus): FASTA byte-identical to phase 5's;
             reads/s, phase seconds and peak device memory.
  8 trace    configuration A through the CLI with --profile_dir: FASTA
             byte-identical to phase 5's, a trace with CUDA kernel events,
             and the device-busy share of the assembly span (the union of
             kernel intervals over the span's length).
  9 mesh     the mesh layer (alga_tpu_torch/parallel) on a one-rank NCCL
             group from make_mesh(): (a) gcps_graph_sharded on phase 4's
             40k reads and on A's 920k-slot batch, edges identical field
             for field to prefsuf.build_gcps_graph's (first and second
             call timed); (b) A through
             assemble_distributed, FASTA byte-identical to phase 5's;
             (c) B through pipeline.assemble(mesh=...), FASTA
             byte-identical to phase 6's, both kernels launched and every
             launch equal to its plain version; seconds and peak device
             memory of each, reads/s of (b) and (c).  (d) With two or more
             cards, (b) again on min(cards, 4) NCCL ranks, one per card;
             with one card, a line saying that traffic across cards was
             not exercised.

The kernels' launch counts are those of phases 6 and 9c together (each
counted from 0 just before its run).  The last three lines of standard
output are the card's nvidia-smi line, the kernels' JSON record and the
result line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Datasets and logs go to build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

GENOME_LEN = 4_600_000          # E. coli K-12 scale (BASELINE.md target)
COVERAGE = 10.0
READ_LEN = 100
INSERT = 300
SEED = 42                       # bench.py _ensure_scale_dataset
ERR_SEED = 11
ERR_RATE = 0.02

KERNEL_SOURCES = {"gather_planes": "alga_tpu_torch/csrc/banded_dp.cu",
                  "banded_lcs": "alga_tpu_torch/csrc/banded_lcs.cu"}


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    raise SystemExit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() on the current stream (CUDA events
    around each call: host work inside fn counts, so this times the plain
    versions, whose host syncs rule out a CUDA graph)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call of fn(), which must launch work only:
    `reps` calls captured in one CUDA graph, replayed warm, the median of
    five replays over `reps`.  Host overhead is left out, so small
    launches are timed as the card runs them back to back."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


# H100 SXM, NVIDIA's data sheet: HBM3 at 3.35 TB/s; 64 INT32 lanes per SM
# at the 1.98 GHz boost clock (the SM count is read from the card)
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
SM_CLOCK_HZ = 1.98e9
# the least integer instructions one band cell of v = max(up, diag + match,
# left) needs on sm_90: its match bit out of the row's XOR (the XOR, one
# per row, is shared by the band's cells and not counted), max(diag +
# match, up) as one DPX add-max (VIADDMNMX, which ptxas emits for K2), and
# the max with left
LCS_OPS_PER_CELL = 3


def k1_bound(packed, idx):
    """(ms, "bytes"): the index words, each table row (W words and the
    length) an index of the run touches, and the output, moved once."""
    import torch
    n, W = packed.shape
    ok = idx[(idx >= 0) & (idx < n)]
    rows = int(torch.unique(ok).numel())
    nbytes = 4 * (idx.numel() + rows * (W + 1) + idx.numel() * (W + 1))
    return 1e3 * nbytes / HBM_BYTES_PER_S, "bytes"


def k2_bound(w1T, len1, len2, off, E, n_sm):
    """(ms, kind): the larger of LCS_OPS_PER_CELL integer operations per
    band cell these pairs need (rows p_beg..p* times 2E+1) at the card's
    INT32 rate, and their words, lengths, offsets and result moved once."""
    import torch
    W, M = w1T.shape
    l1 = len1.long().clamp(max=16 * W)
    l2 = len2.long().clamp(max=16 * W)
    o = off.long()
    rows = (torch.minimum(l1 - 1, l2 - 1 + o) - (o - E).clamp(min=0) + 1)
    cells = int(rows.clamp(min=0).sum()) * (2 * E + 1)
    ops_ms = 1e3 * LCS_OPS_PER_CELL * cells / (
        n_sm * INT32_LANES_PER_SM * SM_CLOCK_HZ)
    bytes_ms = 1e3 * 4 * (2 * W + 4) * M / HBM_BYTES_PER_S
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def kernel_phase(dev, banded_dp, tag, n_rows, m_k1, m_k2):
    """Both kernels against their plain versions at one shape, exact
    (K2 at E = 1, 2, 3, 7, and at E = 0, 1, 2, 3, 7, 15 on pairs of
    unequal lengths), with their device times, plain and library times
    and bounds.  K1: a table of n_rows reads of 100 bp and m_k1 pairs; K2:
    m_k2 pairs of 100 bp reads."""
    import torch
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    W = 7                                 # words of a 100 bp read
    packed = torch.randint(-2**31, 2**31 - 1, (n_rows, W), generator=gen,
                           device=dev, dtype=torch.int32)
    lengths = torch.randint(60, 113, (n_rows,), generator=gen, device=dev,
                            dtype=torch.int32)
    idx = torch.randint(0, n_rows, (2, m_k1), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[:, ::97] = -1                     # a few indices out of range
    idx[:, 1::89] = n_rows
    out = {}

    k1 = banded_dp.gather_planes(packed, lengths, idx)
    k1_err = int((k1.long() - banded_dp.gather_planes_plain(
        packed, lengths, idx).long()).abs().max())
    if k1_err != 0:
        fail(f"{tag}: gather_planes differs from its plain version "
             f"({k1_err})")
    # the one library call that gathers the same words pair-major (from a
    # plane table [W+1, N], in-range indices)
    planes = torch.cat([packed.T, lengths[None, :]]).contiguous()
    idx_in = idx.clamp(0, n_rows - 1).reshape(-1)
    bound, kind = k1_bound(packed, idx)
    res = {"shape": f"table [{n_rows}, {W}] + lengths, idx [2, {m_k1}]",
           "max_abs_err": k1_err, "bound_ms": bound, "bound_by": kind,
           "plain_ms": median_ms(lambda: banded_dp.gather_planes_plain(
               packed, lengths, idx), 10),
           "library_ms": graph_ms(lambda: planes.index_select(1, idx_in))}
    res["ms"] = graph_ms(lambda: banded_dp.gather_planes(packed, lengths,
                                                          idx))
    out["gather_planes"] = res
    log(f"K1 gather_planes at {tag} shape ({res['shape']}): exact; "
        + json.dumps({k: v for k, v in res.items() if k != "shape"}))
    del k1, planes, idx_in

    pairs = lcs_pairs(m_k2, 1, dev)
    ragged = ragged_lcs_pairs(m_k2, 2, dev)
    k2_err = 0
    for name, args, Es in (("100 bp", pairs, (1, 2, 3, 7)),
                           ("ragged", ragged, (0, 1, 2, 3, 7, 15))):
        for E in Es:
            err = int((banded_dp.banded_lcs(*args, E).long()
                       - banded_dp.banded_lcs_batch(*args, E).long())
                      .abs().max())
            if err != 0:
                fail(f"{tag}: banded_lcs (E={E}, {name} pairs) differs "
                     f"from its plain version ({err})")
            k2_err = max(k2_err, err)
    del ragged
    bound, kind = k2_bound(pairs[0], *pairs[2:], 2, n_sm)
    res = {"shape": f"{m_k2} pairs of 100 bp, E=2",
           "max_abs_err": k2_err, "bound_ms": bound, "bound_by": kind,
           "plain_ms": median_ms(
               lambda: banded_dp.banded_lcs_batch(*pairs, 2), 5),
           "library_ms": None}
    res["ms"] = graph_ms(lambda: banded_dp.banded_lcs(*pairs, 2))
    out["banded_lcs"] = res
    log(f"K2 banded_lcs at {tag} shape ({res['shape']}; E=1,2,3,7 exact; "
        f"ragged pairs at E=0,1,2,3,7,15 exact): "
        + json.dumps({k: v for k, v in res.items() if k != "shape"}))
    for name, r in out.items():
        log(f"{name} at {tag} shape: {r['ms']:.4f} ms, bound "
            f"{1e3 * r['bound_ms']:.2f} us ({r['bound_by']}), bound share "
            f"{r['bound_ms'] / r['ms']:.3f}")
    return out


def logged_run(banded_dp, fn):
    """(fn()'s result, launches, shapes, seen): fn run with both kernel
    wrappers logging every launch's shape (to time the kernels at B's own
    shapes) and its inputs and output (to hold them against the plain
    versions), the launch counts set to 0 just before the run and read
    just after."""
    import torch
    shapes = {"gather_planes": [], "banded_lcs": []}
    seen = {"gather_planes": [], "banded_lcs": []}
    real_k1, real_k2 = banded_dp.gather_planes, banded_dp.banded_lcs

    def k1_logged(packed, lengths, idx):
        shapes["gather_planes"].append((packed.shape[0], idx.shape[1]))
        out = real_k1(packed, lengths, idx)
        seen["gather_planes"].append(
            ((packed.clone(), lengths.clone(), idx.clone()), out.clone()))
        return out

    def k2_logged(*args):
        shapes["banded_lcs"].append(args[0].shape[1])
        out = real_k2(*args)
        seen["banded_lcs"].append(
            (tuple(a.clone() if torch.is_tensor(a) else a for a in args),
             out.clone()))
        return out
    banded_dp.gather_planes, banded_dp.banded_lcs = k1_logged, k2_logged
    banded_dp.reset_launches()
    try:
        res = fn()
        torch.cuda.synchronize()
    finally:
        banded_dp.gather_planes, banded_dp.banded_lcs = real_k1, real_k2
    return res, dict(banded_dp.LAUNCHES), shapes, seen


def real_launch_errors(banded_dp, seen, tag: str = "B") -> dict:
    """{kernel: max abs error}: the output of each launch phase 6 saw on
    B's path against the plain version on the same inputs (B's own read
    table, pairs, lengths and offsets), exact."""
    import torch
    errs = {}
    for name, plain in (("gather_planes", banded_dp.gather_planes_plain),
                        ("banded_lcs", banded_dp.banded_lcs_batch)):
        errs[name] = 0
        for args, got in seen[name]:
            errs[name] = max(errs[name], int(
                (got.long() - plain(*args).long()).abs().max()))
        if errs[name] != 0:
            fail(f"{tag}: a launch of {name} differs from its plain "
                 f"version on the same inputs ({errs[name]})")
    lcs = [a for a, _ in seen["banded_lcs"]]
    log(f"{tag}: every launch exact against its plain version on its own "
        f"inputs ({len(seen['gather_planes'])} K1, {len(lcs)} K2); K2 "
        "lengths " + ", ".join(
            f"{int(a[2].min())}-{int(a[2].max())}/"
            f"{int(a[3].min())}-{int(a[3].max())}" for a in lcs)
        + ", offsets " + ", ".join(
            f"{int(a[4].min())}-{int(a[4].max())}" for a in lcs)
        + f", E {sorted({a[5] for a in lcs})}")
    return errs


# ---------------------------------------------------------------------------
# datasets

def scale_datasets():
    """(genome, A's r1/r2 FASTQ paths, B's r1/r2 FASTQ paths).

    A is bench.py's 920k-slot recipe (seed 42: 230k 300 bp fragments,
    2x100 bp mates, mates swapped half the time).  B is the same reads
    with bench.py's error-path substitutions (bench.py:336-343): each base
    is replaced with probability 2% by a different base."""
    import numpy as np
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    rng = np.random.default_rng(SEED)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, size=GENOME_LEN)].tobytes()
    n_frags = int(GENOME_LEN * COVERAGE / 200)
    mates = np.empty((2, n_frags, READ_LEN), dtype=np.uint8)
    for i in range(n_frags):
        p = int(rng.integers(0, GENOME_LEN - INSERT + 1))
        frag = genome[p:p + INSERT]
        a = frag[:READ_LEN]
        b = frag[-READ_LEN:].translate(comp)[::-1]
        if rng.random() < 0.5:
            a, b = b.translate(comp)[::-1], a.translate(comp)[::-1]
        mates[0, i] = np.frombuffer(a, dtype=np.uint8)
        mates[1, i] = np.frombuffer(b, dtype=np.uint8)

    erng = np.random.default_rng(ERR_SEED)
    noisy = mates.copy()
    err = erng.random(noisy.shape) < ERR_RATE
    repl = bases[erng.integers(0, 4, int(err.sum()))]
    same = repl == noisy[err]
    repl[same] = bases[(np.searchsorted(bases, repl[same]) + 1) % 4]
    noisy[err] = repl

    WORK.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, mat in (("A", mates), ("B", noisy)):
        paths[name] = []
        for m in range(2):
            path = WORK / f"{name}_r{m + 1}.fastq"
            qual = b"I" * READ_LEN
            with open(path, "wb") as f:
                for i in range(n_frags):
                    f.write(b"@r%d\n%s\n+\n%s\n" % (i, mat[m, i].tobytes(),
                                                    qual))
            paths[name].append(str(path))
    return genome, paths["A"], paths["B"], 2 * n_frags


def bench_40k_reads():
    """bench.py _simulate: 200 kb genome, 20x of 100 bp reads, seed 123."""
    import numpy as np
    comp = str.maketrans("ACGT", "TGCA")
    rng = np.random.default_rng(123)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, size=200_000)].tobytes().decode()
    reads = []
    for _ in range(200_000 * 20 // 100):
        p = int(rng.integers(0, 200_000 - 100 + 1))
        r = genome[p:p + 100]
        if rng.random() < 0.5:
            r = r.translate(comp)[::-1]
        reads.append(r)
    return reads


class GenomeIndex:
    """The k-mers of a genome and of its reverse complement as sorted
    2-bit integer keys, with their positions in `text` (genome, a
    separator, reverse complement)."""

    def __init__(self, genome: bytes, k: int = 31):
        import numpy as np
        self.k = k
        rc = genome.translate(bytes.maketrans(b"ACGT", b"TGCA"))[::-1]
        self.text = genome + b"|" + rc
        keys = np.concatenate([self.keys(genome), self.keys(rc)])
        pos = np.concatenate([np.arange(len(genome) - k + 1),
                              len(genome) + 1 + np.arange(len(rc) - k + 1)])
        order = np.argsort(keys, kind="stable")
        self.sorted_keys, self.pos = keys[order], pos[order]

    def keys(self, seq: bytes, positions=None):
        import numpy as np
        lut = np.zeros(256, dtype=np.int64)
        lut[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4)
        c = lut[np.frombuffer(seq, dtype=np.uint8)]
        if positions is None:
            positions = np.arange(len(c) - self.k + 1)
        out = np.zeros(len(positions), dtype=np.int64)
        for j in range(self.k):
            out = out * 4 + c[positions + j]
        return out

    def _hits(self, key):
        import numpy as np
        lo, hi = np.searchsorted(self.sorted_keys, [key, key + 1])
        return self.pos[lo:hi]

    def contains(self, s: str) -> bool:
        """s is an exact substring of the genome or its reverse complement."""
        b = s.encode()
        if len(b) < self.k:
            return b in self.text
        return any(self.text[p:p + len(b)] == b
                   for p in self._hits(self.keys(b[:self.k])[0]))

    def kmer_share(self, seqs, step: int = 7) -> float:
        """Share of the k-mers sampled every `step` bases from `seqs` that
        occur in the genome or its reverse complement."""
        import numpy as np
        hits = total = 0
        for s in seqs:
            b = s.encode()
            if len(b) < self.k:
                continue
            q = self.keys(b, np.arange(0, len(b) - self.k + 1, step))
            at = np.searchsorted(self.sorted_keys, q).clip(
                max=len(self.sorted_keys) - 1)
            total += len(q)
            hits += int((self.sorted_keys[at] == q).sum())
        return hits / max(total, 1)


def lcs_pairs(m: int, seed: int, dev):
    """Pair-major words of m pairs of 100 bp reads: read 2 is read 1
    from offset 0-45 on, with 2% substitutions, then random bases."""
    import torch
    W = 7
    g = torch.Generator(device=dev).manual_seed(seed)
    c1 = torch.randint(0, 4, (m, 112), generator=g, device=dev)
    off = torch.randint(0, 46, (m,), generator=g, device=dev)
    cols = torch.arange(112, device=dev)[None, :]
    src = (cols + off[:, None]).clamp(max=111)
    c2 = torch.where(cols + off[:, None] < 100, c1.gather(1, src),
                     torch.randint(0, 4, (m, 112), generator=g,
                                   device=dev))
    noise = torch.rand((m, 112), generator=g, device=dev) < ERR_RATE
    c2 = torch.where(noise, (c2 + 1) % 4, c2)
    c1[:, 100:] = 0
    c2[:, 100:] = 0
    lens = torch.full((m,), READ_LEN, dtype=torch.int32, device=dev)
    return (pair_major_words(c1), pair_major_words(c2), lens, lens.clone(),
            off.to(torch.int32))


def ragged_lcs_pairs(m: int, seed: int, dev):
    """Pair-major words (W = 8) of m pairs of reads of unequal lengths,
    mostly 60-128 bases and one in ten 1-128: read 2 is read 1 from offset
    0-70 on (one in twenty 0-129, often past read 1's end), with 4%
    substitutions; random bases past each read's length, which the
    kernels must ignore."""
    import torch
    L = 128
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda hi, lo=0: torch.randint(  # noqa: E731
        lo, hi, (m,), generator=g, device=dev)
    c1 = torch.randint(0, 4, (m, L), generator=g, device=dev)
    off = torch.where(rnd(20) == 0, rnd(130), rnd(71))
    src = torch.arange(L, device=dev)[None, :] + off[:, None]
    c2 = torch.where(src < L, c1.gather(1, src.clamp(max=L - 1)),
                     torch.randint(0, 4, (m, L), generator=g, device=dev))
    noise = torch.rand((m, L), generator=g, device=dev) < 0.04
    c2 = torch.where(noise, (c2 + 1) % 4, c2)
    lens = [torch.where(rnd(10) == 0, rnd(L + 1, 1), rnd(L + 1, 60))
            .to(torch.int32) for _ in range(2)]
    return (pair_major_words(c1), pair_major_words(c2), *lens,
            off.to(torch.int32))


def pair_major_words(c):
    """int32[W, m] packed words of base codes c [m, 16W] (2 bits a base,
    base 0 in the low bits)."""
    import torch
    m, L = c.shape
    sh = 2 * torch.arange(16, device=c.device)
    w = (c.view(m, L // 16, 16) << sh).sum(-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32).T \
        .contiguous()


def run_cli(tag: str, paths, n_reads: int, extra_args=(), env=None):
    """Configuration A through `python -m alga_tpu_torch.cli` in a process
    of its own; (FASTA bytes, report with the CLI's wall seconds)."""
    out = WORK / f"{tag}_contigs.fasta"
    errlog = WORK / f"{tag}_cli.log"
    t0 = time.perf_counter()
    with open(errlog, "w") as err:
        rc = subprocess.run(
            [sys.executable, "-m", "alga_tpu_torch.cli", "--file1", paths[0],
             "--file2", paths[1], "--output", str(out), *extra_args],
            cwd=str(ROOT), stderr=err, timeout=900,
            env=dict(os.environ, **(env or {}))).returncode
    wall = time.perf_counter() - t0
    lines = errlog.read_text().splitlines()
    if rc != 0:
        fail(f"{tag} CLI exited {rc}:\n" + "\n".join(lines[-30:]))
    stats = json.loads(next(ln for ln in reversed(lines)
                            if ln.startswith('{"count"')))
    res = report(tag, stats, n_reads)
    res["cli_wall_s"] = wall
    return out.read_bytes(), res


def busy_share(trace_path: Path, span: str):
    """(share, span ms, kernel count, top kernels): the union of the CUDA
    kernel intervals of a torch.profiler Chrome trace inside the
    annotation `span`, over the span's length."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    win = [e for e in events if e.get("name") == span and "dur" in e
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        fail(f"trace: {len(win)} spans named {span}")
    t0, t1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    kernels = sorted((max(float(e["ts"]), t0),
                      min(float(e["ts"]) + float(e["dur"]), t1), e["name"])
                     for e in events if e.get("cat") == "kernel")
    kernels = [k for k in kernels if k[1] > k[0]]
    busy, end, by_name = 0.0, t0, {}
    for a, b, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return busy / (t1 - t0), (t1 - t0) / 1e3, len(kernels), top


def report(tag: str, stats: dict, n_reads: int) -> dict:
    total = stats["phase_seconds"]["total"]
    out = {"reads": n_reads, "assembly_s": total,
           "reads_per_s": n_reads / total, "contigs": stats["count"],
           "n50": stats["n50"],
           "peak_device_mb": stats["memory_peaks_mb"]["device_mb"],
           "phase_seconds": stats["phase_seconds"]}
    log(f"{tag}: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 9: the mesh layer

RANK_SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from alga_tpu_torch.config import AssemblyConfig
from alga_tpu_torch.parallel.distributed import assemble_distributed
from alga_tpu_torch.parallel.mesh import make_mesh
mesh = make_mesh(sys.argv[5])
res = assemble_distributed(AssemblyConfig(file1=sys.argv[2], file2=sys.argv[3],
                                          output=sys.argv[4]), mesh)
counters = res.stats["counters"]
print(json.dumps({"rank": mesh.rank, "d": mesh.d,
                  "phase_seconds": res.stats["phase_seconds"],
                  "peak_device_mb": res.stats["memory_peaks_mb"]["device_mb"],
                  "a2a_bytes": {k: v for k, v in counters.items()
                                if k.startswith("a2a_bytes_")}}),
      flush=True)
torch.distributed.destroy_process_group()
"""


def spawn_ranks(n: int, paths, out: Path, device: str = "cuda",
                timeout: float = 900) -> list[dict]:
    """assemble_distributed on n ranks, one process each (one card each on
    CUDA), rendezvous over localhost; each rank's JSON report.  A rank
    that fails ends the others and the run."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    logs = [open(WORK / f"rank{r}.log", "w+") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT, str(ROOT), paths[0], paths[1],
         str(out), device], stdout=logs[r], stderr=subprocess.STDOUT,
        env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                 WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                 MASTER_PORT=str(port))) for r in range(n)]
    t_end = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > t_end):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    reports = []
    for r, (p, f) in enumerate(zip(procs, logs)):
        f.seek(0)
        text = f.read()
        f.close()
        if p.returncode != 0:
            fail(f"mesh (d): rank {r} of {n} exited {p.returncode}:\n"
                 + text[-3000:])
        reports.append(json.loads(next(
            ln for ln in reversed(text.splitlines())
            if ln.startswith('{"rank"'))))
    return reports


def mesh_phase(dev, gargs, g_40k, a_paths, b_paths, fasta_a, n_reads,
               banded_dp) -> dict:
    """Phase 9 (see the module docstring); its record for summary.json."""
    import numpy as np
    import torch
    from alga_tpu_torch import config, pipeline
    from alga_tpu_torch.graph import prefsuf
    from alga_tpu_torch.io import fastx
    from alga_tpu_torch.parallel import mesh as mesh_mod
    from alga_tpu_torch.parallel.distributed import assemble_distributed
    from alga_tpu_torch.parallel.sharded_gcps import gcps_graph_sharded

    mesh = mesh_mod.make_mesh()
    log(f"mesh: rank {mesh.rank} of {mesh.d} on {mesh.device}, backend "
        f"{torch.distributed.get_backend()}")
    rec = {}

    def measured(fn):
        """(fn(), seconds, peak device MB over the call)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return (r, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated(dev) / 1e6)

    def same(g, h):
        return all(np.array_equal(getattr(g, f), getattr(h, f))
                   for f in ("src", "dst", "offset"))

    # (a) sharded GCPS against the one-device graph, at 40k and 920k slots
    cfg = config.AssemblyConfig()
    batch = fastx.load_read_batch(
        a_paths[0], a_paths[1], add_paired_reads=cfg.add_paired_reads,
        trim_left=cfg.read_end_trim_left, trim_right=cfg.read_end_trim_right,
        remove_reads_with_n=cfg.remove_reads_with_n, rna=cfg.rna,
        str_period=cfg.str_period_threshold)
    batch.valid &= ~fastx.mark_prefix_reads(batch)
    batch = pipeline.remap_paired_offsets(batch, paired=True)
    tcfg = config.autotune(cfg, batch.avg_read_length())
    batch.valid &= (batch.lengths
                    >= tcfg.li_kmer_intervals + tcfg.li_kmer_length)
    a_args = (batch.packed, batch.lengths, len(batch),
              tcfg.min_overlap_pref_suf, tcfg.read_length_cap,
              tcfg.rsoe_min_overlap, tcfg.soes, batch.valid, batch.valid)
    for tag, args, want in (("40k", gargs, g_40k), ("A_920k", a_args, None)):
        g1, s1, mb1 = measured(lambda: prefsuf.build_gcps_graph(
            *args, device=dev))
        want = (want if want is not None else g1).sorted_by_src_offset()
        g, s, mb = measured(lambda: gcps_graph_sharded(mesh, *args))
        if not same(g, want) or g.num_edges == 0:
            fail(f"mesh (a) {tag}: sharded GCPS edges ({g.num_edges}) "
                 f"differ from the one-device graph's ({want.num_edges})")
        s2 = measured(lambda: gcps_graph_sharded(mesh, *args))[1]
        rec[f"gcps_{tag}"] = {"reads": args[2], "edges": g.num_edges,
                              "sharded_s": s, "sharded_second_s": s2,
                              "sharded_peak_mb": mb, "one_device_s": s1,
                              "one_device_peak_mb": mb1}
        log(f"mesh (a) {tag}: {args[2]} reads, {g.num_edges} edges "
            "identical field for field; " + json.dumps(rec[f"gcps_{tag}"]))
    del batch, a_args

    # (b) configuration A through the distributed driver
    cfg_a = config.AssemblyConfig(file1=a_paths[0], file2=a_paths[1],
                                  output=str(WORK / "A_dist_contigs.fasta"))
    res, s, mb = measured(lambda: assemble_distributed(cfg_a, mesh))
    if (WORK / "A_dist_contigs.fasta").read_bytes() != fasta_a:
        fail("mesh (b): assemble_distributed's FASTA differs from phase 5's")
    rec["A_dist"] = {**report("A_dist", res.stats, n_reads), "wall_s": s,
                     "peak_mb": mb}
    log("mesh (b): A through assemble_distributed, FASTA byte-identical to "
        "phase 5's")

    # (c) configuration B through pipeline.assemble(mesh=...)
    cfg_b = config.AssemblyConfig(
        file1=b_paths[0], file2=b_paths[1],
        output=str(WORK / "B_mesh_contigs.fasta"), error_rate=ERR_RATE,
        use_acler_instead_of_aclcs=False)
    res, launches, shapes, seen = logged_run(
        banded_dp, lambda: pipeline.assemble_to_file(cfg_b, mesh=mesh))
    if ((WORK / "B_mesh_contigs.fasta").read_bytes()
            != (WORK / "B_contigs.fasta").read_bytes()):
        fail("mesh (c): B on the mesh wrote other bytes than phase 6")
    if min(launches.values()) == 0:
        fail(f"mesh (c): B on the mesh did not launch every kernel: "
             f"{launches}")
    errs = real_launch_errors(banded_dp, seen, "B on the mesh")
    rec["B_mesh"] = {**report("B_mesh", res.stats, n_reads),
                     "launches": launches, "launch_errors": errs}
    log(f"mesh (c): B on the mesh, FASTA byte-identical to phase 6's; "
        f"kernel launches {launches}")

    torch.distributed.destroy_process_group()
    rec.update(across_cards(a_paths, fasta_a))
    return rec


def across_cards(a_paths, fasta_a) -> dict:
    """Phase 9d: A through assemble_distributed on min(cards, 4) NCCL
    ranks, one card each, against phase 5's FASTA; with one card, a line
    saying so."""
    import torch
    cards = torch.cuda.device_count()
    if cards < 2:
        log("mesh (d): one card visible; traffic across cards was not "
            "exercised")
        return {}
    n = min(cards, 4)
    out = WORK / f"A_dist{n}_contigs.fasta"
    t0 = time.perf_counter()
    reports = spawn_ranks(n, a_paths, out)
    wall = time.perf_counter() - t0
    if out.read_bytes() != fasta_a:
        fail(f"mesh (d): rank 0's FASTA on {n} cards differs from phase 5's")
    log(f"mesh (d): A on {n} NCCL ranks, one card each, FASTA "
        f"byte-identical to phase 5's; {wall:.1f}s with the ranks' start; "
        + json.dumps(reports))
    return {f"A_dist_{n}_cards": reports}


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]) \
        .parse_args()
    if not (ROOT / "alga_tpu_torch").is_dir():
        fail(f"alga_tpu_torch/ not found beside {Path(__file__).name}: run "
             "from a checkout of the repository")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    from alga_tpu_torch import cli, config, native, pipeline
    from alga_tpu_torch.graph import device_join, prefsuf
    from alga_tpu_torch.io import fastx
    from alga_tpu_torch.ops import _cuda, banded_dp

    # --- 1 device ---------------------------------------------------------
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"device: {kind} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not native.available():
        fail("native host engine native/libalga_host.so unavailable")
    log("native host engine: available")

    # --- 2 build ----------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.lib()
    log(f"build: {time.perf_counter() - t0:.1f}s "
        f"(nvcc {_cuda.BUILD_INFO.get('seconds', 0.0):.1f}s)")
    for line in _cuda.BUILD_INFO.get("ptxas", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"ptxas: {line.strip()}")

    # --- 3 kernels against their plain versions, main shapes -------------
    k_main = kernel_phase(dev, banded_dp, "main", 920_000, 1 << 19, 1 << 18)

    # --- 4 device GCPS against the native engine -------------------------
    cfg = config.AssemblyConfig()
    batch = fastx.build_read_batch(
        bench_40k_reads(), None, trim_left=cfg.read_end_trim_left,
        trim_right=cfg.read_end_trim_right,
        remove_reads_with_n=cfg.remove_reads_with_n, rna=cfg.rna,
        str_period=cfg.str_period_threshold)
    batch.valid &= ~fastx.mark_prefix_reads(batch)
    batch = pipeline.remap_paired_offsets(batch, paired=False)
    tcfg = config.autotune(cfg, batch.avg_read_length())
    batch.valid &= batch.lengths >= tcfg.li_kmer_intervals + tcfg.li_kmer_length
    gargs = (batch.packed, batch.lengths, len(batch), tcfg.min_overlap_pref_suf,
             tcfg.read_length_cap, tcfg.rsoe_min_overlap, tcfg.soes,
             batch.valid, batch.valid)

    def timed(fn):
        t0 = time.perf_counter()
        g = fn()
        torch.cuda.synchronize()
        return g, time.perf_counter() - t0

    def forced(mode):
        os.environ["ALGA_GCPS_DEVICE"] = mode
        try:
            return prefsuf.build_gcps_graph(*gargs, device=dev)
        finally:
            del os.environ["ALGA_GCPS_DEVICE"]

    graphs, secs = {}, {}
    for name, fn in (("small", lambda: forced("small")),
                     ("wide", lambda: forced("wide")),
                     ("native", lambda: prefsuf.host_gcps_graph(*gargs)),
                     ("direct", lambda: device_join.gcps_graph_device(
                         *gargs, device=dev))):
        graphs[name], first = timed(fn)
        second = timed(fn)[1]
        secs[name] = (first, second)

    def same(g, h):
        return all(np.array_equal(getattr(g, f), getattr(h, f))
                   for f in ("src", "dst", "offset"))
    g_dev = graphs["small"]
    if g_dev.num_edges == 0:
        fail("fused GCPS: no edges on the 40k-read dataset")
    for name in ("wide", "direct"):
        if not same(g_dev, graphs[name]):
            fail(f"fused GCPS edges ({g_dev.num_edges}) differ from {name}'s "
                 f"({graphs[name].num_edges})")
    if not same(g_dev.retain_min_offset(),
                graphs["native"].retain_min_offset()):
        fail(f"device GCPS edges ({g_dev.num_edges}) differ from the native "
             f"engine's ({graphs['native'].num_edges})")
    log(f"graph: 40k-read bench dataset, {len(batch)} reads, "
        f"{g_dev.num_edges} edges identical (small, direct, wide; native "
        f"after retain_min_offset); seconds first/second call: " + ", ".join(
            f"{k} {a:.4f}/{b:.4f}" for k, (a, b) in secs.items()))

    # --- 5 configuration A through the CLI --------------------------------
    t0 = time.perf_counter()
    genome, a_paths, b_paths, n_file_reads = scale_datasets()
    log(f"datasets: {n_file_reads} file reads per configuration "
        f"({time.perf_counter() - t0:.1f}s)")
    fasta_a, res_a = run_cli("A", a_paths, n_file_reads)
    contigs_a = [ln for ln in fasta_a.decode().splitlines()
                 if not ln.startswith(">") and ln != "CCCC"]
    if not contigs_a or res_a["n50"] <= 2 * READ_LEN:
        fail(f"configuration A: {len(contigs_a)} contigs, "
             f"N50 {res_a['n50']}")
    index = GenomeIndex(genome)
    if not all(index.contains(c) for c in contigs_a):
        fail("configuration A: a contig is not a substring of the genome")
    log(f"A: {len(contigs_a)} contigs, all exact genome substrings; "
        f"CLI wall {res_a['cli_wall_s']:.1f}s")

    # --- 6 configuration B: the main path through both kernels -----------
    cfg_b = config.AssemblyConfig(
        file1=b_paths[0], file2=b_paths[1],
        output=str(WORK / "B_contigs.fasta"), error_rate=ERR_RATE,
        use_acler_instead_of_aclcs=False)
    res, launches, shapes, seen = logged_run(
        banded_dp, lambda: pipeline.assemble_to_file(cfg_b, device=dev))
    res_b = report("B", res.stats, n_file_reads)
    lcs_pairs_b = res.stats["counters"].get("ach_lcs_pairs", 0)
    log(f"B: kernel launches {launches}; pairs through K2: {lcs_pairs_b}; "
        f"K1 (table rows, pairs) per launch {shapes['gather_planes']}; K2 "
        f"pairs per launch {shapes['banded_lcs']}")
    if min(launches.values()) == 0:
        fail(f"configuration B did not launch every kernel: {launches}")
    if launches["gather_planes"] != launches["banded_lcs"]:
        fail(f"configuration B: K1 did not launch once per LCS batch "
             f"({launches})")
    real_err = real_launch_errors(banded_dp, seen)
    contigs_b = [c.seq for c in res.contigs if c.seq != "CCCC"]
    ident = index.kmer_share(contigs_b)
    if not contigs_b or ident < 0.9:
        fail(f"configuration B: {len(contigs_b)} contigs, 31-mer identity "
             f"{ident:.3f}")
    log(f"B: {len(contigs_b)} contigs, 31-mer identity {ident:.4f}")

    # --- 3 (continued) the kernels at B's own shapes ----------------------
    b_rows = int(statistics.median(n for n, _ in shapes["gather_planes"]))
    b_pairs = int(statistics.median(shapes["banded_lcs"]))
    k_b = kernel_phase(dev, banded_dp, "B", b_rows, b_pairs, b_pairs)

    # --- 7 configuration A on the fused GCPS path and device consensus ---
    fasta_7, res_7 = run_cli(
        "A_fused", a_paths, n_file_reads,
        env={"ALGA_GCPS_DEVICE": "small", "ALGA_DEVICE_CONSENSUS": "1"})
    if fasta_7 != fasta_a:
        fail("phase 7: FASTA differs from phase 5's")
    log(f"A fused: FASTA byte-identical to phase 5's; "
        f"{res_7['reads_per_s']:.1f} reads/s, peak device memory "
        f"{res_7['peak_device_mb']} MB (phase 5: {res_a['reads_per_s']:.1f} "
        f"reads/s, {res_a['peak_device_mb']} MB)")

    # --- 8 configuration A under torch.profiler --------------------------
    trace_dir = WORK / "trace"
    if trace_dir.exists():
        for old in trace_dir.iterdir():
            old.unlink()
    fasta_8, res_8 = run_cli("A_trace", a_paths, n_file_reads,
                                ("--profile_dir", str(trace_dir)))
    if fasta_8 != fasta_a:
        fail("phase 8: FASTA differs from phase 5's")
    traces = sorted(trace_dir.glob("*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"phase 8: {len(traces)} trace files in {trace_dir}")
    share, span_ms, n_kernels, top = busy_share(traces[0], cli.TRACE_SPAN)
    if n_kernels == 0:
        fail("phase 8: the trace holds no CUDA kernel events")
    log(f"A trace: FASTA byte-identical to phase 5's; {n_kernels} kernels; "
        f"device-busy share of the assembly span {share:.4f} "
        f"({span_ms:.1f} ms span; {kind}, {smi}); top kernels (ms): "
        + "; ".join(f"{name[:60]} {us / 1e3:.2f}" for name, us in top))

    # --- 9 the mesh layer --------------------------------------------------
    mesh_rec = mesh_phase(dev, gargs, g_dev, a_paths, b_paths, fasta_a,
                          n_file_reads, banded_dp)
    launches_mesh = mesh_rec["B_mesh"]["launches"]

    (WORK / "summary.json").write_text(json.dumps(
        {"nvidia_smi": smi, "A": res_a, "B": res_b, "A_fused": res_7,
         "A_trace": res_8, "A_busy_share": share, "A_span_ms": span_ms,
         "A_trace_kernels": n_kernels,
         "B_lcs_pairs": lcs_pairs_b, "B_launches": launches,
         "B_kmer_identity": ident, "build": _cuda.BUILD_INFO.get("seconds"),
         "B_launch_shapes": shapes, "B_launch_errors": real_err,
         "kernels_main": k_main, "kernels_B": k_b,
         "graph_40k": {"edges": g_dev.num_edges, "seconds": secs},
         "mesh": mesh_rec},
        indent=1))

    kernels = []
    for name, replaces in (("gather_planes", "banded_dp.py:69"),
                           ("banded_lcs", "banded_dp.py:152")):
        main, at_b = k_main[name], k_b[name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCES[name],
            "replaces": f"alga_tpu/ops/pallas/{replaces}",
            "launches": launches[name] + launches_mesh[name],
            "launches_by_path": {"B": launches[name],
                                 "B_mesh": launches_mesh[name]},
            "max_abs_err": max(main["max_abs_err"], at_b["max_abs_err"],
                               real_err[name],
                               mesh_rec["B_mesh"]["launch_errors"][name]),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "shape")},
            "at_B_shape": {k: at_b[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "shape")}})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
