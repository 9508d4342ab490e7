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
             of unequal lengths at E = 0, 1, 2, 3, 7, 15; here also the
             wide K2 kernel at E = 16, 24, 31, 63, one past the widest
             band of its earlier shared-memory design for the pairs' width
             (848, 847, 839), 1,000 and 10,000 on both and on pairs of
             250-base reads (with E = 2, 15), and at E = 16-63 and 848 on
             pairs aligned along the band's edges, each with the lanes per
             pair the launch picks and forced to every count that holds
             the row), at the large shape (K1: a 920k-row table, 2^20 indices;
             K2: 2^18 pairs of 100 bp) here, and at configuration B's own
             (the median table rows and pairs per launch that phase 6
             logs) after phase 6.  Device milliseconds of each kernel (a
             CUDA graph of 20 launches; the wide one at E = 16, 63 and
             1,000, and at every lane count), of its plain version and of
             the one library call that computes the same gather (K1:
             index_select), the bound (the least time for the bytes or the
             integer operations the inputs need, from H100 SXM peaks; K2
             counts the band's cells inside read 2, and logs the count of
             every row's 2E+1 cells beside it) and the kernel's share of
             it.
  4 graph    configuration A's graph on the bench's 40k-read dataset by
             the fused device path (ALGA_GCPS_DEVICE=small, and
             device_join.gcps_graph_device called directly), the blocked
             device path (ALGA_GCPS_DEVICE=wide) and the native host
             engine: the same edges, field for field; first-call and
             second-call seconds of each.
  5 A        the four FASTQ files of scale_datasets() must have the
             recipe's sha256 (DATASET_SHA256; else "dataset differs from
             the recipe's").  Configuration A (the default CLI run,
             error_rate=0) at E. coli scale (4.6 Mb genome, 2x100 bp, 10x:
             920k read slots) through `python -m alga_tpu_torch.cli`: the
             FASTA's sha256 must equal alga_tpu's (REFERENCE_SHA256), and
             every contig must be an exact substring of the genome or of
             its reverse complement.
  6 B        configuration B (2% substitutions, error_rate=0.02, ACLCS
             fallback on) at the same scale through
             pipeline.assemble_to_file; both kernels must have launched on
             this main path, K1 once per LCS batch; the output of every
             launch on the path must equal the plain version's on the
             same inputs; the FASTA's sha256 must equal alga_tpu's; the
             contigs must share >= 90% of their sampled 31-mers with the
             genome.
  6c C       configuration C, the CLI's own error path (B's reads through
             `python -m alga_tpu_torch.cli --error-rate 0.02`: ACLER, no
             LCS fallback): the FASTA's sha256 must equal alga_tpu's, and
             no pair may reach the LCS fallback (ach_lcs_pairs absent or
             0); reads/s, phase seconds, peak device memory, ACH counters.
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
             launch equal to its plain version; (e) C through
             pipeline.assemble(mesh=...), whose pairs go through
             ach_batch_mesh and the device ACLER (acler_batch) on the
             card: FASTA byte-identical to phase 6c's and alga_tpu's,
             ach_low_error_approved > 0 (only the device ACLER bumps it),
             no kernel launch; seconds and peak device memory of each,
             reads/s of (b), (c) and (e).  (d) With two or more
             cards, (b) again on min(cards, 4) NCCL ranks, one per card;
             with one card, a line saying that traffic across cards was
             not exercised.
 10 no engine configurations A and B without the native host engine
             (`alga_tpu_torch.native.available` patched to return False:
             the numpy/Python twins of the engine's passes, the device
             GCPS and, in B, both kernels) on the bench's 40k-read recipe
             (200 kb genome, 20x of 100 bp, seed 123; B with the 2%
             substitutions) through pipeline.assemble_to_file, each beside
             the same run with the engine loaded: the read lists' sha256
             equal to the recipe's, the same FASTA bytes, equal to
             alga_tpu's (A_40k, B_40k in REFERENCE_SHA256);
             A's contigs exact genome substrings, B's sharing >= 90% of
             sampled 31-mers with the genome; in B both kernels launched
             and every launch equal to its plain version on its own
             inputs; phase seconds of all four runs.  The 920k-slot runs
             are cut to 40k reads here because the engine-free route runs
             the simplifier, contraction, walk and PKB replay in Python
             loops.
 11 flagship alga_tpu's own larger recipes (FLAGSHIP: 20 Mb genome, 20x,
             4,000,000 file reads, 7,248,412 reads after marking; CONFIG3:
             12 Mb, 20x, seed 9, 2,400,000 file reads with the 2%
             substitutions), their FASTQ files' sha256 checked first.
             A-20M: FLAGSHIP through the CLI with ALGA_SCALE_LOG=1; the
             FASTA's sha256 must equal alga_tpu's (A_20M), the blocked
             GCPS must log 2 or more source blocks and domination chunks
             run (5 and 7 expected) and the matches, pairs, removers,
             domination slots and edges of the same run on the CPU.
             B-12M: CONFIG3 through pipeline.assemble_to_file with B_KW,
             as phase 6 (both kernels once per LCS batch, every launch
             exact against its plain version on its own inputs,
             alga_tpu's sha256 and ach_lcs_alignments); then phase 3's
             kernel checks and times at B-12M's median launch shape.
             C-12M: CONFIG3 through the CLI with --error-rate 0.02:
             alga_tpu's sha256, no LCS fallback, and alga_tpu's
             ach_total_alignments and ach_low_error_approved (only the
             device ACLER bumps the latter, so it ran on one card).
             Phase seconds and peak device memory of each.
 12 lengths  the read lengths users sequence, on A's genome at 30x:
             NOVASEQ150 (2x150 bp, 400 bp inserts, 920k file reads: A150
             clean, B150 with the 2% substitutions, T150 = B150 with each
             mate trimmed to 75-150 bases) and MISEQ250 (2x250 bp, 550 bp
             inserts: A250, B250), their FASTQ files' sha256 checked first.
             A-150, A-250 through the CLI with ALGA_SCALE_LOG=1: alga_tpu's
             sha256, the CPU run's GCPS stage counts, every contig an exact
             genome substring.  B-150, T-150, B-250 through
             pipeline.assemble_to_file with B_KW, as phase 6: K1 and K2
             once per LCS batch, every launch exact against its plain
             version on its own inputs, alga_tpu's sha256 and
             ach_lcs_alignments; then phase 3's kernel checks and times at
             B-150's and B-250's median launch shapes.  B_40k_E16: phase
             10's noisy 40k reads with B_E16_KW (B_KW and
             max_error_rate_for_lcs=16); B-E16: B's 920k-slot reads with
             B_E16_KW.  Each: the wide K2 kernel once per LCS batch,
             every launch exact, and exact again re-run at E = 1,000,
             alga_tpu's sha256, the kernel timed at its median launch.
             Phase seconds, file reads/s, contigs and peak device memory of
             each run.

Phases 7, 8 and 9 compare their FASTA with phases 5, 6 and 6c, so every
assembly of the run is held byte for byte against alga_tpu's output.
The kernels' launch counts are those of phases 6, 9c, 10's two B runs,
11's B-12M and 12's B-150, T-150, B-250, B_40k_E16 and B-E16 together
(each counted from 0 just before its run).  The last three lines of standard
output are the card's nvidia-smi line, the kernels' JSON record and the
result line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Datasets and logs go to build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import argparse
import contextlib
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
                  "banded_lcs": "alga_tpu_torch/csrc/banded_lcs.cu",
                  "banded_lcs_wide": "alga_tpu_torch/csrc/banded_lcs_wide.cu"}
# the band half-widths phase 3 checks the wide K2 kernel at, with one
# past the widest band its shared-memory design took for reads of W words
# (SMEM_BAND_LIMIT[W]: 847, 846, 838 for the 100 bp, ragged and 250 bp
# pairs) and two far past the reads (the row frame); it is timed at
# WIDE_TIMED on the 100 bp pairs
WIDE_E = (16, 24, 31, 63)
SMEM_BAND_LIMIT = {7: 847, 8: 846, 16: 838}
FAR_E = (1000, 10_000)
WIDE_TIMED = (16, 63, 1000)

# the configurations beside A (the default run): B runs the ACLCS fallback
# (both kernels), C is the CLI's `--error-rate 0.02` (ACLER only)
B_KW = {"error_rate": ERR_RATE, "use_acler_instead_of_aclcs": False}
C_CLI_ARGS = ("--error-rate", str(ERR_RATE))

# alga_tpu's own larger recipes, as scale_datasets() arguments: its
# flagship (BASELINE.md:118,246-262: 20 Mb at 20x, 4,000,000 file reads,
# 7,248,412 reads after marking), clean as set F, and its "config-3"
# (BASELINE.md:205,291,390-398: 12 Mb at 20x, seed 9, 2,400,000 file
# reads), with the 2% substitutions as set G
FLAGSHIP = {"genome_len": 20_000_000, "coverage": 20, "seed": 42,
            "sets": (("F", False),)}
CONFIG3 = {"genome_len": 12_000_000, "coverage": 20, "seed": 9,
           "sets": (("G", True),)}
# the read lengths users sequence, on A's 4.6 Mb genome (seed 42) at 30x:
# 2x150 bp mates of 400 bp inserts as a NovaSeq or HiSeq X run gives them
# (460,000 fragments = 920,000 file reads = 1,840,000 read slots, twice
# A's), clean (A150), with the 2% substitutions (B150) and those reads
# quality-trimmed to 75-150 bases (T150); 2x250 bp mates of 550 bp
# inserts as a MiSeq run gives them (276,000 fragments), clean (A250) and
# noisy (B250)
NOVASEQ150 = {"genome_len": GENOME_LEN, "coverage": 30, "seed": SEED,
              "read_len": 150, "insert": 400,
              "sets": (("A150", False), ("B150", True),
                       ("T150", True, True))}
MISEQ250 = {"genome_len": GENOME_LEN, "coverage": 30, "seed": SEED,
            "read_len": 250, "insert": 550,
            "sets": (("A250", False), ("B250", True))}

# sha256 of alga_tpu's FASTA on the CPU for each run this script holds the
# port's bytes against: A and C as alga_tpu's CLI writes them, B through
# alga_tpu.pipeline.assemble_to_file with B_KW, all on scale_datasets();
# A_40k and B_40k as phase 10 runs them (bench_40k's reads, single-end);
# A_20M, B_12M and C_12M the same three runs on the FLAGSHIP (A) and
# CONFIG3 (B, C) recipes; A_150, B_150, T_150 on NOVASEQ150 and A_250,
# B_250 on MISEQ250 (A through the CLI, B and T with B_KW); B_40k_E16 and
# B_E16 as phase 12 runs them (B_40k's and B's reads with B_E16_KW).  The card has no jax, so they
# are constants here; re-derive them with `python -m pytest
# tests/test_torch_reference_digests.py` (add `-m slow` for the large and
# read-length ones), which holds them against alga_tpu, whenever a recipe
# changes.
REFERENCE_SHA256 = {
    "A": "95ba0ec7af646a4c243e5b49454eb1b9170cad4b7d53c77c310daef59e4837ae",
    "B": "a445242a67161209983586b2fcab7587f6f57599529c9f67ed4295bb43c2c410",
    "C": "6dc6cd6bc8ccc8d080f5286f478480e747ff18de00b2594ba35839fdb4acc908",
    "A_40k": "a2e78481419cbcd7d60b3a15053c9d578ed56be661a56696338211fbaf1e59f2",
    "B_40k": "7e7c56154336f1de9e9f7d48b744cfa493c1c6dbe8107b592ebbeb1ead1ac75d",
    "A_20M":
        "bc38f34da262aaf922e67403ede113fd6cce9972cd06532756bfa07dc9a95a22",
    "B_12M":
        "336aca2bbfcc3f7bbd70e6e54b24cd04269b44870e17c263657946b0ab02bf93",
    "C_12M":
        "7c6f00f3e2ca1cb82e7a4d2e98c87675e10b7e611ca105eade118fa3a87af7ee",
    "A_150":
        "f31df4b3e0d59882f33b881ecbbd2d1324fb99245dd4f47ead1b6dda301fe667",
    "B_150":
        "83e783c6c9a90cced133343292af2450e990f94aad710123b6a14399999ea4c9",
    "T_150":
        "b187e7d060671b599633437efded2b9e0cd0c99d8a8a36a40a52a788babc32e2",
    "A_250":
        "e77130bd47a83e4da0d7d6398e965b78cd0eec004f56b7293fa4306110b6c8f3",
    "B_250":
        "fd15bab8199be2eff4717c53e99b40841f26f839f009f6c67437716cd5da9674",
    "B_40k_E16":
        "f01ba48f0f3212c7ec6e048a6319a40db0f0ad19ad927ab59b60a80f821bd3b9",
    "B_E16":
        "0cccc54b96ab7e88839f96bcc1b37fb2604904991db57ff33984da9f8ce6d492",
}
# sha256 of the inputs those runs read: scale_datasets()'s FASTQ files (with
# its defaults, FLAGSHIP, CONFIG3, NOVASEQ150 and MISEQ250) and
# bench_40k()'s read list, clean and with noisy_40k()'s substitutions
DATASET_SHA256 = {
    "A_r1.fastq":
        "be6b4c6fb01cbca345e353e6269ef26a05a65011ba2dfb3989a3ed5a45765668",
    "A_r2.fastq":
        "268000f0e6e489e17c96a4da9bbe94cfc221a23617bff7fa312cbc6041a31549",
    "B_r1.fastq":
        "62f65bd5fd0917009bc6ea3bd4afd0c32faa550dd55d2476a5f077cc9f01ec85",
    "B_r2.fastq":
        "cfa282c5f9e6fd25176feb329f3cfefbae5dfbaa5f46d800ab0a2dc1cb693ffc",
    "reads_40k":
        "094d579b6dedf4fbcc0a18f0ea12f7d34eeeb171c157ebad9840b3e07a95e603",
    "reads_40k_B":
        "69e28902a115469d572c45dec770d321316d97965f00238b630f084688eb081b",
    "F_r1.fastq":
        "1cf1f57c4197e592a83c2415a81f0c71cd812ccc2626373ca89c77770e88de27",
    "F_r2.fastq":
        "7a6e76a9cbf78bd8e08c90bff7b6cc709314bb7c4b2f893e6b6fabe4de96e33f",
    "G_r1.fastq":
        "75430b35842af9919c1fd70e14381f467909fbcd226630a852a34f4177a9b07a",
    "G_r2.fastq":
        "ffbd34c746bf5e67f1865473271175eaeec4c9c635e87f112f6253b9b1dec872",
    "A150_r1.fastq":
        "08c256025e3eaa7168d511530e6cfb8d08637c36dffcfeb9e7636c353d826cbd",
    "A150_r2.fastq":
        "8ef63524dff7c533f416f585bb3f54330ea3d9513dfb4d8def8fedd13982c688",
    "B150_r1.fastq":
        "24e0517af1769e823b29bb16f70f0b355c0720466151c1901e6feb121ed3262b",
    "B150_r2.fastq":
        "3bc5f641cb6431d254c21b3eb46d92df5699d20cd9e249e61b11e8244db2c5f3",
    "T150_r1.fastq":
        "740ef29a123f89652c0d4e7a791984da51bdf25b47f72bc058a04cf341493707",
    "T150_r2.fastq":
        "329ea8a0f2b7110aeb93ba56c348c63f7b199b3a318a420ec96906ccb4d9d5ae",
    "A250_r1.fastq":
        "2f0d3d34d70289ae4d8a7004342ddc0ed186ab34cab7165b59569a8003841069",
    "A250_r2.fastq":
        "fc808696434e97cba071aee98f0d8bc8f85f7e1d09b59a7e1dddfb0dfdeb2295",
    "B250_r1.fastq":
        "ff4c63c9b52db9242adedf1c2bf96bc6f21847d34cab4889e4eae50b611edba5",
    "B250_r2.fastq":
        "13469325cc6dd8a43bcfa19156adacfcf73c88b5fbbc11531167b7cf018f1ceb",
}


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
    """(ms, kind, band_ms): the larger of LCS_OPS_PER_CELL integer
    operations per cell the recurrence needs for these pairs (per row
    p_beg..p*, the band's cells with 0 <= q < len2) at the card's INT32
    rate, and their words, lengths, offsets and result moved once;
    band_ms counts every row's 2E+1 cells instead, the count used until
    the band was clipped to the reads."""
    import torch
    W, M = w1T.shape
    l1 = len1.long().clamp(max=16 * W)
    l2 = len2.long().clamp(max=16 * W)
    o = off.long()
    p_beg = (o - E).clamp(min=0)
    p_star = torch.minimum(l1 - 1, l2 - 1 + o)
    rows = (p_star - p_beg + 1).clamp(min=0)
    cells = torch.zeros((), dtype=torch.int64, device=w1T.device)
    for p in range(int(p_beg.min()), int(p_star.max()) + 1):
        lo = (p - o - E).clamp(min=0)
        hi = torch.minimum(l2 - 1, p - o + E)
        in_row = (p >= p_beg) & (p <= p_star)
        cells += ((hi - lo + 1).clamp(min=0) * in_row).sum()
    rate = n_sm * INT32_LANES_PER_SM * SM_CLOCK_HZ
    ops_ms = 1e3 * LCS_OPS_PER_CELL * int(cells) / rate
    band_ms = 1e3 * LCS_OPS_PER_CELL * int(rows.sum()) * (2 * E + 1) / rate
    bytes_ms = 1e3 * 4 * (2 * W + 4) * M / HBM_BYTES_PER_S
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", max(band_ms, bytes_ms)
    return bytes_ms, "bytes", max(band_ms, bytes_ms)


def wide_lanes_ms(banded_dp, args, E, n_sm) -> dict:
    """{lanes: device ms} of the wide kernel at each lane count that holds
    the row (banded_dp.WIDE_LANES), beside the launch's own choice
    ("auto": its lanes and cells)."""
    W, M = args[0].shape
    g, k = banded_dp.wide_shape(W, E, M, n_sm=n_sm)
    out = {"auto": f"{g} lanes x {k} cells"}
    for lanes in banded_dp.WIDE_LANES:
        try:
            banded_dp.wide_shape(W, E, M, lanes)
        except ValueError:
            continue
        out[lanes] = graph_ms(lambda: banded_dp.banded_lcs(
            *args, E, _lanes=lanes))
    return out


def k2_record(banded_dp, args, E, n_sm, shape: str, err: int,
              plain_reps: int = 3) -> dict:
    """The K2 kernel's record at one shape: device ms, plain ms, bound
    (and the bound under the count of every row's 2E+1 cells), and for
    the wide kernel the time at every lane count."""
    bound, kind, band = k2_bound(args[0], *args[2:5], E, n_sm)
    res = {"shape": shape, "max_abs_err": err, "bound_ms": bound,
           "bound_by": kind, "bound_ms_rows_x_band": band,
           "plain_ms": median_ms(
               lambda: banded_dp.banded_lcs_batch(*args[:5], E), plain_reps),
           "library_ms": None,
           "ms": graph_ms(lambda: banded_dp.banded_lcs(*args[:5], E))}
    if E > banded_dp.MAX_E:
        res["ms_by_lanes"] = wide_lanes_ms(banded_dp, args[:5], E, n_sm)
    return res


def kernel_phase(dev, banded_dp, tag, n_rows, m_k1, m_k2,
                 read_len: int = READ_LEN, wide: bool = False):
    """Both kernels against their plain versions at one shape, exact
    (K2 at E = 1, 2, 3, 7, and at E = 0, 1, 2, 3, 7, 15 on pairs of
    unequal lengths), with their device times, plain and library times
    and bounds.  K1: a table of n_rows reads of read_len bases and m_k1
    pairs; K2: m_k2 pairs of read_len-base reads.  With `wide`, also the
    wide K2 kernel: exact at E = 16, 24, 31, 63 on those pairs and on the
    ragged ones, and on pairs of 250-base reads at E = 2, 15, 16, 63 (both
    K2 kernels), timed at E = 16 on the read_len-base pairs."""
    import torch
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    W = (read_len + 15) // 16             # words of a read_len-base read
    packed = torch.randint(-2**31, 2**31 - 1, (n_rows, W), generator=gen,
                           device=dev, dtype=torch.int32)
    lengths = torch.randint(read_len * 6 // 10, 16 * W + 1, (n_rows,),
                            generator=gen, device=dev, dtype=torch.int32)
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

    pairs = lcs_pairs(m_k2, 1, dev, read_len)
    ragged = ragged_lcs_pairs(m_k2, 2, dev)
    checks = [(f"{read_len} bp", pairs, (1, 2, 3, 7)),
              ("ragged", ragged, (0, 1, 2, 3, 7, 15))]
    if wide:
        p250 = lcs_pairs(m_k2, 3, dev, 250)
        checks += [(name, args, WIDE_E + (
            SMEM_BAND_LIMIT[args[0].shape[0]] + 1,) + FAR_E)
            for name, args in ((f"{read_len} bp", pairs), ("ragged", ragged),
                               ("250 bp", p250))]
        checks.append(("250 bp", p250, (2, 15)))
        # pairs aligned along the band's edges, where the masks decide
        checks += [(f"{read_len} bp band-edge", lcs_pairs(
            m_k2 // 4, 4 + E, dev, read_len, edge=E), (E,))
            for E in WIDE_E + (SMEM_BAND_LIMIT[pairs[0].shape[0]] + 1,)]
    errs = {"banded_lcs": 0, "banded_lcs_wide": 0}
    checked = [(name, Es) for name, _, Es in checks]
    forced = 0
    for name, args, Es in checks:
        for E in Es:
            want = banded_dp.banded_lcs_batch(*args, E)
            runs = [None]
            if E > banded_dp.MAX_E:      # and every lane count that fits
                runs += [g for g in banded_dp.WIDE_LANES
                         if g * banded_dp.WIDE_CELLS[-1]
                         >= min(2 * E + 1, 16 * args[0].shape[0])]
            for lanes in runs:
                err = int((banded_dp.banded_lcs(*args, E, _lanes=lanes)
                           .long() - want.long()).abs().max())
                if err != 0:
                    fail(f"{tag}: banded_lcs (E={E}, {name} pairs, lanes "
                         f"{lanes or 'auto'}) differs from its plain "
                         f"version ({err})")
                k = ("banded_lcs" if E <= banded_dp.MAX_E
                     else "banded_lcs_wide")
                errs[k] = max(errs[k], err)
                forced += lanes is not None
            del want
    if wide:
        log(f"{tag}: the wide kernel exact at every E on each pair set, "
            f"with its own lane count and {forced} forced ones")
    del ragged, checks
    # keys: each kernel at its first E, the wide one also "@E<E>" after
    timed = [("banded_lcs", 2)] + [("banded_lcs_wide", E)
                                   for E in WIDE_TIMED] * wide
    for name, E in timed:
        res = k2_record(banded_dp, pairs, E, n_sm,
                        f"{m_k2} pairs of {read_len} bp, E={E}", errs[name],
                        5 if E == 2 else 3)
        out[name if E in (2, WIDE_TIMED[0]) else f"{name}@E{E}"] = res
        log(f"K2 {name} at {tag} shape ({res['shape']}; exact at E = "
            + "; ".join(f"{n}: {','.join(map(str, Es))}"
                        for n, Es in checked) + "): "
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
    """{kernel: max abs error}: the output of each launch a run saw on
    its path against the plain version on the same inputs (the run's own
    read table, pairs, lengths and offsets), exact; K2's launches count
    under the kernel their band half-width took."""
    errs = {"gather_planes": 0, "banded_lcs": 0, "banded_lcs_wide": 0}
    for wrapper, plain in (("gather_planes", banded_dp.gather_planes_plain),
                           ("banded_lcs", banded_dp.banded_lcs_batch)):
        for args, got in seen[wrapper]:
            name = (wrapper if wrapper == "gather_planes"
                    or args[5] <= banded_dp.MAX_E else "banded_lcs_wide")
            errs[name] = max(errs[name], int(
                (got.long() - plain(*args).long()).abs().max()))
    for name, err in errs.items():
        if err != 0:
            fail(f"{tag}: a launch of {name} differs from its plain "
                 f"version on the same inputs ({err})")
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


def check_lcs_launches(tag: str, launches: dict,
                       lcs: str = "banded_lcs") -> None:
    """Fail unless K1 and the K2 kernel `lcs` (banded_lcs for E <= 15,
    banded_lcs_wide above) launched once per LCS batch, at least once,
    and the other K2 kernel never."""
    other = ({"banded_lcs", "banded_lcs_wide"} - {lcs}).pop()
    if (launches["gather_planes"] == 0 or launches[other] != 0
            or launches["gather_planes"] != launches[lcs]):
        fail(f"{tag}: K1 and {lcs} did not launch once per LCS batch: "
             f"{launches}")


# ---------------------------------------------------------------------------
# datasets

def scale_datasets(out_dir: Path = WORK, genome_len: int = GENOME_LEN,
                   coverage: float = COVERAGE, seed: int = SEED,
                   sets=(("A", False), ("B", True)),
                   read_len: int = READ_LEN, insert: int = INSERT):
    """(genome, {set name: [r1, r2] FASTQ paths}, file reads per set), the
    files `<name>_r1.fastq` and `<name>_r2.fastq` written into `out_dir`
    for each (name, noisy) or (name, noisy, trim) of `sets`.

    The reads: a random genome of `genome_len` bases (seed `seed`),
    genome_len * coverage / (2 * read_len) fragments of `insert` bases,
    2 x read_len mates, mates swapped half the time; a noisy set carries
    bench.py's error-path substitutions (`substituted`); a trimmed set
    has each mate's 3' end cut to a length drawn uniformly from
    [read_len // 2, read_len] (generator seed + 1, so the other sets keep
    their bytes).  The defaults are bench.py's 920k-slot recipe (seed 42,
    2x100 bp, 300 bp inserts: 230k fragments), A clean and B noisy;
    FLAGSHIP, CONFIG3, NOVASEQ150 and MISEQ250 are larger or longer
    ones."""
    import numpy as np
    out_dir = Path(out_dir)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = bases[rng.integers(0, 4, size=genome_len)].tobytes()
    n_frags = int(genome_len * coverage / (2 * read_len))
    mates = np.empty((2, n_frags, read_len), dtype=np.uint8)
    for i in range(n_frags):
        p = int(rng.integers(0, genome_len - insert + 1))
        frag = genome[p:p + insert]
        a = frag[:read_len]
        b = frag[-read_len:].translate(comp)[::-1]
        if rng.random() < 0.5:
            a, b = b.translate(comp)[::-1], a.translate(comp)[::-1]
        mates[0, i] = np.frombuffer(a, dtype=np.uint8)
        mates[1, i] = np.frombuffer(b, dtype=np.uint8)
    trim_lens = (np.random.default_rng(seed + 1).integers(
        read_len // 2, read_len + 1, size=(2, n_frags))
        if any(any(s[2:]) for s in sets) else None)

    out_dir.mkdir(parents=True, exist_ok=True)
    quals = [b"I" * k for k in range(read_len + 1)]
    paths = {}
    for name, noisy, *trim in sets:
        mat = substituted(mates) if noisy else mates
        paths[name] = []
        for m in range(2):
            path = out_dir / f"{name}_r{m + 1}.fastq"
            seqs = mat[m].view(f"S{read_len}").ravel().tolist()
            if any(trim):
                seqs = [s[:k] for s, k in zip(seqs, trim_lens[m].tolist())]
            with open(path, "wb") as f:
                for lo in range(0, n_frags, 1 << 16):
                    f.write(b"".join(
                        b"@r%d\n%s\n+\n%s\n" % (i, s, quals[len(s)])
                        for i, s in enumerate(seqs[lo:lo + (1 << 16)], lo)))
            paths[name].append(str(path))
    return genome, paths, 2 * n_frags


def sha256_of(data) -> str:
    """sha256 hex digest of bytes, of a file's bytes (a Path), or of a read
    list (its reads joined by newlines)."""
    import hashlib
    if isinstance(data, Path):
        h = hashlib.sha256()
        with open(data, "rb") as f:
            for block in iter(lambda: f.read(1 << 24), b""):
                h.update(block)
        return h.hexdigest()
    if isinstance(data, list):
        data = "\n".join(data).encode()
    return hashlib.sha256(data).hexdigest()


def dataset_digests(*path_lists) -> dict:
    """{file name: sha256} of the FASTQ files scale_datasets wrote."""
    return {Path(p).name: sha256_of(Path(p))
            for paths in path_lists for p in paths}


def check_digest(tag: str, data, key: str, table=REFERENCE_SHA256) -> None:
    """Fail unless the sha256 of `data` (or `data` itself, a hex digest) is
    the recorded digest `key`: of alga_tpu's FASTA (REFERENCE_SHA256), or
    of a dataset (DATASET_SHA256, with its own message); log it."""
    got = data if isinstance(data, str) else sha256_of(data)
    whose = "the recipe's" if table is DATASET_SHA256 else "alga_tpu's"
    if got != table[key]:
        if table is DATASET_SHA256:
            fail(f"{tag}: dataset differs from the recipe's ({key}: sha256 "
                 f"{got}, recipe {table[key]})")
        fail(f"{tag}: FASTA sha256 {got} differs from alga_tpu's "
             f"{table[key]} ({key})")
    log(f"{tag}: sha256 {got} equal to {whose} ({key})")


def noisy_40k(reads):
    """The 40k-read list with bench.py's error-path substitutions
    (configuration B's reads at 40k)."""
    import numpy as np
    mat = np.frombuffer("".join(reads).encode(), dtype=np.uint8)
    return [r.tobytes().decode()
            for r in substituted(mat.reshape(len(reads), -1))]


def substituted(mat):
    """A copy of the base matrix `mat` (uint8 ASCII) with bench.py's
    error-path substitutions (bench.py:336-343): each base is replaced
    with probability 2% by a different base (seed ERR_SEED)."""
    import numpy as np
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    erng = np.random.default_rng(ERR_SEED)
    noisy = mat.copy()
    err = erng.random(noisy.shape) < ERR_RATE
    repl = bases[erng.integers(0, 4, int(err.sum()))]
    same = repl == noisy[err]
    repl[same] = bases[(np.searchsorted(bases, repl[same]) + 1) % 4]
    noisy[err] = repl
    return noisy


def bench_40k():
    """(genome, reads) of bench.py _simulate: 200 kb genome, 20x of 100 bp
    reads, seed 123."""
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
    return genome, reads


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


def lcs_pairs(m: int, seed: int, dev, read_len: int = READ_LEN,
              edge: int | None = None):
    """Pair-major words of m pairs of read_len-base reads: read 2 is read
    1 from offset 0 to 46% of read_len on, with 2% substitutions, then
    random bases.  With `edge` (a band half-width E), every other pair's
    read 2 follows read 1 along the band's last or first diagonal or the
    one past it (read 1 from off - E, off + E, off - E - 1, off + E + 1
    on, random bases where that falls outside read 1)."""
    import torch
    L = 16 * ((read_len + 15) // 16)
    g = torch.Generator(device=dev).manual_seed(seed)
    c1 = torch.randint(0, 4, (m, L), generator=g, device=dev)
    off = torch.randint(0, read_len * 46 // 100, (m,), generator=g,
                        device=dev)
    shift = off.clone()
    if edge is not None:
        i = torch.arange(m, device=dev)
        side = torch.tensor([-edge, edge, -edge - 1, edge + 1], device=dev)
        shift = torch.where(i % 2 == 0, off + side[(i // 2) % 4], off)
    cols = torch.arange(L, device=dev)[None, :]
    src = cols + shift[:, None]
    c2 = torch.where((src >= 0) & (src < read_len),
                     c1.gather(1, src.clamp(0, L - 1)),
                     torch.randint(0, 4, (m, L), generator=g, device=dev))
    noise = torch.rand((m, L), generator=g, device=dev) < ERR_RATE
    c2 = torch.where(noise, (c2 + 1) % 4, c2)
    c1[:, read_len:] = 0
    c2[:, read_len:] = 0
    lens = torch.full((m,), read_len, dtype=torch.int32, device=dev)
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
    """The reads `paths` through `python -m alga_tpu_torch.cli` in a
    process of its own; (FASTA bytes, report with the CLI's wall seconds
    and counters)."""
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
    res.update(cli_wall_s=wall, counters=stats["counters"])
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


def mesh_phase(dev, gargs, g_40k, a_paths, b_paths, fasta_a, fasta_c,
               n_reads, banded_dp) -> dict:
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
        output=str(WORK / "B_mesh_contigs.fasta"), **B_KW)
    res, launches, shapes, seen = logged_run(
        banded_dp, lambda: pipeline.assemble_to_file(cfg_b, mesh=mesh))
    if ((WORK / "B_mesh_contigs.fasta").read_bytes()
            != (WORK / "B_contigs.fasta").read_bytes()):
        fail("mesh (c): B on the mesh wrote other bytes than phase 6")
    check_lcs_launches("mesh (c): B on the mesh", launches)
    errs = real_launch_errors(banded_dp, seen, "B on the mesh")
    rec["B_mesh"] = {**report("B_mesh", res.stats, n_reads),
                     "launches": launches, "launch_errors": errs}
    log(f"mesh (c): B on the mesh, FASTA byte-identical to phase 6's; "
        f"kernel launches {launches}")

    # (e) configuration C through pipeline.assemble(mesh=...): its pairs
    # go through ach_batch_mesh, the device ACLER (acler_batch) on the card
    out_c = WORK / "C_mesh_contigs.fasta"
    cfg_c = config.AssemblyConfig(file1=b_paths[0], file2=b_paths[1],
                                  output=str(out_c), error_rate=ERR_RATE)
    res, launches, _shapes, _seen = logged_run(
        banded_dp, lambda: pipeline.assemble_to_file(cfg_c, mesh=mesh))
    if out_c.read_bytes() != fasta_c:
        fail("mesh (e): C on the mesh wrote other bytes than phase 6c")
    check_digest("mesh (e)", out_c, "C")
    counters = res.stats["counters"]
    if counters.get("ach_low_error_approved", 0) <= 0:
        fail(f"mesh (e): the device ACLER approved no pair: {counters}")
    if max(launches.values()) != 0 or counters.get("ach_lcs_pairs", 0):
        fail(f"mesh (e): C reached the LCS fallback: launches {launches}")
    rec["C_mesh"] = {**report("C_mesh", res.stats, n_reads),
                     "launches": launches,
                     "ach": {k: v for k, v in counters.items()
                             if k.startswith("ach_")}}
    log("mesh (e): C on the mesh, FASTA byte-identical to phase 6c's; "
        "ACH counters " + json.dumps(rec["C_mesh"]["ach"]))

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


# ---------------------------------------------------------------------------
# phase 11: alga_tpu's flagship and config-3 sizes

# counts of the same runs on the CPU, which the card's must equal: the
# blocked GCPS stages that ALGA_SCALE_LOG=1 prints in A_20M (the port's
# CLI with --device cpu, whose FASTA is alga_tpu's), alga_tpu's ACH
# counters in B_12M and C_12M
FLAGSHIP_STAGES = {"matches": 51_230_420, "pairs": 41_929_504,
                   "removers": 22_329_390, "exp_total": 105_048_101,
                   "edges": 7_970_657}
ACH_12M = {"B_12M": {"ach_lcs_alignments": 1_155_513},
           "C_12M": {"ach_total_alignments": 3_792_181,
                     "ach_low_error_approved": 2_636_668}}


def scale_stages(text: str) -> dict:
    """{key: int} of the key=value fields of the [device_scale ...] stage
    lines (ALGA_SCALE_LOG=1) in a log's text; a key logged more than once
    (candidates, one per block) keeps its sum."""
    out = {}
    for line in text.splitlines():
        if not line.startswith("[device_scale +"):
            continue
        for tok in line.split("] ", 1)[1].split():
            key, eq, val = tok.partition("=")
            if eq and val.isdigit():
                out[key] = out.get(key, 0) + int(val)
    return out


def check_counters(tag: str, counters: dict, want: dict,
                   whose: str = "alga_tpu's") -> None:
    """Fail unless `counters` hold the values `want` (alga_tpu's, or those
    of the same run on the CPU); log them."""
    got = {k: counters.get(k, 0) for k in want}
    if got != want:
        fail(f"{tag}: counters {got} differ from {whose} {want}")
    log(f"{tag}: counters equal to {whose}: {json.dumps(got)}")


def flagship_phase(dev, banded_dp) -> dict:
    """Phase 11 (see the module docstring); its record for summary.json."""
    import torch
    from alga_tpu_torch import config, pipeline
    t0 = time.perf_counter()
    _, f_paths, f_reads = scale_datasets(WORK, **FLAGSHIP)
    _, g_paths, g_reads = scale_datasets(WORK, **CONFIG3)
    f_paths, g_paths = f_paths["F"], g_paths["G"]
    log(f"flagship: datasets F ({f_reads} file reads) and G ({g_reads}) "
        f"written in {time.perf_counter() - t0:.1f}s")
    for name, digest in dataset_digests(f_paths, g_paths).items():
        check_digest("flagship", digest, name, DATASET_SHA256)
    rec = {"datasets_s": time.perf_counter() - t0}

    # A-20M: the blocked GCPS in 5 source blocks and 7 domination chunks
    fasta, res = run_cli("A_20M", f_paths, f_reads,
                         env={"ALGA_SCALE_LOG": "1"})
    check_digest("A-20M", fasta, "A_20M")
    stages = scale_stages((WORK / "A_20M_cli.log").read_text())
    if min(stages.get(k, 0) for k in ("blocks", "dom_chunks",
                                      "dom_chunks_run")) < 2:
        fail(f"A-20M: the blocked GCPS ran fewer than 2 source blocks or "
             f"domination chunks: {stages}")
    got = {k: stages.get(k) for k in FLAGSHIP_STAGES}
    if got != FLAGSHIP_STAGES:
        fail(f"A-20M: GCPS stages {got} differ from the CPU run's "
             f"{FLAGSHIP_STAGES}")
    rec["A_20M"] = {**res, "stages": stages}
    log(f"A-20M: {res['contigs']} contigs; GCPS stages " + json.dumps(
        stages) + " (matches, pairs, removers, exp_total and edges equal "
        "to the CPU run's)")

    # B-12M in-process: K1 and K2 at a real assembly's launch sizes
    cfg = config.AssemblyConfig(file1=g_paths[0], file2=g_paths[1],
                                output=str(WORK / "B_12M_contigs.fasta"),
                                **B_KW)
    torch.cuda.reset_peak_memory_stats(dev)
    res, launches, shapes, seen = logged_run(
        banded_dp, lambda: pipeline.assemble_to_file(cfg, device=dev))
    check_lcs_launches("B-12M", launches)
    errs = real_launch_errors(banded_dp, seen, "B-12M")
    del seen
    check_digest("B-12M", WORK / "B_12M_contigs.fasta", "B_12M")
    check_counters("B-12M", res.stats["counters"], ACH_12M["B_12M"])
    rec["B_12M"] = {**report("B_12M", res.stats, g_reads),
                    "launches": launches, "launch_errors": errs,
                    "launch_shapes": shapes}
    log(f"B-12M: kernel launches {launches}; K1 (table rows, pairs) per "
        f"launch {shapes['gather_planes']}; K2 pairs per launch "
        f"{shapes['banded_lcs']}")

    # C-12M: the CLI's error path, the device ACLER on one card
    fasta, res = run_cli("C_12M", g_paths, g_reads, C_CLI_ARGS)
    check_digest("C-12M", fasta, "C_12M")
    if res["counters"].get("ach_lcs_pairs", 0) != 0:
        fail(f"C-12M sent pairs to the LCS fallback: {res['counters']}")
    check_counters("C-12M", res["counters"], ACH_12M["C_12M"])
    rec["C_12M"] = res
    torch.cuda.synchronize()
    return rec


# ---------------------------------------------------------------------------
# phase 12: the read lengths users sequence

# counts of the same runs on the CPU, which the card's must equal: the
# blocked GCPS stages of A_150 and A_250 (the port's CLI with --device cpu,
# whose FASTA is alga_tpu's), alga_tpu's ACLCS pairs in the B runs (its
# batches of fewer than 200k pairs take the host branch, which does not
# count them)
READ_LENGTH_STAGES = {
    "A_150": {"matches": 18_729_840, "pairs": 13_377_641,
              "removers": 8_459_122, "exp_total": 50_506_402,
              "edges": 1_698_553},
    "A_250": {"matches": 12_590_832, "pairs": 9_067_680,
              "removers": 5_998_766, "exp_total": 38_167_420,
              "edges": 1_052_379},
}
ACH_READ_LENGTHS = {"B_150": {"ach_lcs_alignments": 217_755},
                    "T_150": {"ach_lcs_alignments": 0},
                    "B_250": {"ach_lcs_alignments": 0}}
# B with the band half-width of the wide K2 kernel (phase 12's B_40k_E16
# on phase 10's noisy 40k reads, B-E16 on B's)
B_E16_KW = {**B_KW, "max_error_rate_for_lcs": 16}


def read_length_phase(dev, banded_dp, index, b_paths, b_reads) -> dict:
    """Phase 12 (see the module docstring); its record for summary.json.
    `index` is phase 5's GenomeIndex: both recipes draw A's genome;
    b_paths and b_reads are B's FASTQ files and their file reads."""
    import torch
    from alga_tpu_torch import config, pipeline
    t0 = time.perf_counter()
    paths, n_reads = {}, {}
    for recipe in (NOVASEQ150, MISEQ250):
        _, got, n = scale_datasets(WORK, **recipe)
        paths.update(got)
        n_reads.update({name: n for name in got})
    log(f"read lengths: datasets {sorted(paths)} written in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, digest in dataset_digests(*paths.values()).items():
        check_digest("read lengths", digest, name, DATASET_SHA256)
    rec = {"datasets_s": time.perf_counter() - t0}

    # A-150, A-250: fresh CLI processes, the blocked GCPS at its new widths
    for tag, name in (("A_150", "A150"), ("A_250", "A250")):
        fasta, res = run_cli(tag, paths[name], n_reads[name],
                             env={"ALGA_SCALE_LOG": "1"})
        check_digest(tag, fasta, tag)
        stages = scale_stages((WORK / f"{tag}_cli.log").read_text())
        check_counters(f"{tag} GCPS stages", stages, READ_LENGTH_STAGES[tag],
                       "the CPU run's")
        contigs = [ln for ln in fasta.decode().splitlines()
                   if not ln.startswith(">") and ln != "CCCC"]
        if not contigs or not all(index.contains(c) for c in contigs):
            fail(f"{tag}: {len(contigs)} contigs, not all exact genome "
                 "substrings")
        rec[tag] = {**res, "stages": stages}
        log(f"{tag}: {len(contigs)} contigs, all exact genome substrings")

    # B-150, T-150, B-250 in-process: K1 and K2 at their widths
    shapes_by = {}
    for tag, name in (("B_150", "B150"), ("T_150", "T150"),
                      ("B_250", "B250")):
        out = WORK / f"{tag}_contigs.fasta"
        cfg = config.AssemblyConfig(file1=paths[name][0],
                                    file2=paths[name][1], output=str(out),
                                    **B_KW)
        res, launches, shapes, seen = logged_run(
            banded_dp, lambda: pipeline.assemble_to_file(cfg, device=dev))
        check_lcs_launches(tag, launches)
        errs = real_launch_errors(banded_dp, seen, tag)
        del seen
        check_digest(tag, out, tag)
        check_counters(tag, res.stats["counters"], ACH_READ_LENGTHS[tag])
        rec[tag] = {**report(tag, res.stats, n_reads[name]),
                    "launches": launches, "launch_errors": errs,
                    "lcs_pairs": res.stats["counters"].get("ach_lcs_pairs",
                                                           0),
                    "launch_shapes": shapes}
        shapes_by[tag] = shapes
        log(f"{tag}: kernel launches {launches}; "
            f"{rec[tag]['lcs_pairs']} pairs through K2; K1 (table rows, "
            f"pairs) per launch {shapes['gather_planes']}")

    # K1 and K2 at B-150's and B-250's median launch shapes
    for tag, read_len in (("B_150", 150), ("B_250", 250)):
        sh = shapes_by[tag]
        rec[f"kernels_{tag}"] = kernel_phase(
            dev, banded_dp, tag.replace("_", "-"),
            int(statistics.median(n for n, _ in sh["gather_planes"])),
            int(statistics.median(m for _, m in sh["gather_planes"])),
            int(statistics.median(sh["banded_lcs"])), read_len)

    # B_40k_E16 and B-E16: the wide K2 kernel on real assemblies' pairs
    genome, reads = bench_40k()
    noisy = noisy_40k(reads)
    check_digest("B_40k_E16", noisy, "reads_40k_B", DATASET_SHA256)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for tag, kw in (("B_40k_E16", {"file1_seqs": noisy}),
                    ("B_E16", {})):
        out = WORK / f"{tag}_contigs.fasta"
        files = ({} if kw else {"file1": b_paths[0], "file2": b_paths[1]})
        cfg = config.AssemblyConfig(output=str(out), **files, **B_E16_KW)
        res, launches, shapes, seen = logged_run(
            banded_dp, lambda: pipeline.assemble_to_file(cfg, device=dev,
                                                         **kw))
        check_lcs_launches(tag, launches, "banded_lcs_wide")
        errs = real_launch_errors(banded_dp, seen, tag)
        check_digest(tag, out, tag)
        n_reads = len(noisy) if kw else b_reads
        rec[tag] = {**report(tag, res.stats, n_reads),
                    "launches": launches, "launch_errors": errs,
                    "lcs_pairs": res.stats["counters"].get(
                        "ach_lcs_pairs", 0),
                    "launch_shapes": shapes}
        # every launch again at E = 1,000 (the row frame), exact
        far = 0
        for args, _ in seen["banded_lcs"]:
            far = max(far, int((banded_dp.banded_lcs(*args[:5], 1000).long()
                                - banded_dp.banded_lcs_batch(
                                    *args[:5], 1000).long()).abs().max()))
        if far != 0:
            fail(f"{tag}: a launch re-run at E=1000 differs from the plain "
                 f"version ({far})")
        # the wide kernel timed at the run's median launch, on its inputs
        args = sorted((a for a, _ in seen["banded_lcs"]),
                      key=lambda a: a[0].shape[1])[
                          len(seen["banded_lcs"]) // 2]
        del seen
        t = k2_record(banded_dp, args, 16, n_sm,
                      f"{args[0].shape[1]} pairs of {tag}, E=16",
                      errs["banded_lcs_wide"])
        rec[f"kernels_{tag}"] = {"banded_lcs_wide": t}
        log(f"{tag}: kernel launches {launches}; every launch also exact "
            f"at E=1000; banded_lcs_wide at its median launch: "
            + json.dumps(t))
    torch.cuda.synchronize()
    rec["phase_s"] = time.perf_counter() - t0
    log(f"read lengths: phase 12 took {rec['phase_s']:.1f}s")
    return rec


# ---------------------------------------------------------------------------
# phase 10: without the native host engine

def nonative_phase(dev, banded_dp) -> dict:
    """Phase 10 (see the module docstring); its record for summary.json."""
    from unittest import mock

    import torch
    from alga_tpu_torch import config, native, pipeline

    genome, reads = bench_40k()
    noisy = noisy_40k(reads)
    check_digest("no engine", reads, "reads_40k", DATASET_SHA256)
    check_digest("no engine", noisy, "reads_40k_B", DATASET_SHA256)
    index = GenomeIndex(genome.encode())
    rec = {}
    for name, seqs, kw in (("A", reads, {}), ("B", noisy, B_KW)):
        fasta = {}
        for engine in ("engine", "no_engine"):
            tag = f"{name}_40k_{engine}"
            out = WORK / f"{tag}.fasta"
            cfg = config.AssemblyConfig(output=str(out), **kw)
            patch = (mock.patch.object(native, "available", lambda: False)
                     if engine == "no_engine" else contextlib.nullcontext())
            with patch:
                res, launches, _shapes, seen = logged_run(
                    banded_dp, lambda: pipeline.assemble_to_file(
                        cfg, file1_seqs=seqs, device=dev))
            ran_native = "contract_walk_native" in res.stats["phase_seconds"]
            if ran_native != (engine == "engine"):
                fail(f"no engine: {tag} ran the native contraction: "
                     f"{ran_native}")
            rec[tag] = report(tag, res.stats, len(seqs))
            fasta[engine] = out.read_bytes()
            check_digest(f"no engine: {tag}", fasta[engine], f"{name}_40k")
            if name == "B":
                check_lcs_launches(f"no engine: {tag}", launches)
                rec[tag].update(
                    launches=launches,
                    lcs_pairs=res.stats["counters"].get("ach_lcs_pairs", 0),
                    launch_errors=real_launch_errors(banded_dp, seen, tag))
                log(f"{tag}: kernel launches {launches}, "
                    f"{rec[tag]['lcs_pairs']} pairs through K2")
            del seen
        if fasta["engine"] != fasta["no_engine"]:
            fail(f"no engine: {name} wrote other FASTA bytes without the "
                 "engine than with it")
        contigs = [ln for ln in fasta["engine"].decode().splitlines()
                   if not ln.startswith(">") and ln != "CCCC"]
        if not contigs:
            fail(f"no engine: {name} at 40k reads wrote no contig")
        if name == "A" and not all(index.contains(c) for c in contigs):
            fail("no engine: an A contig is not a substring of the genome")
        share = index.kmer_share(contigs)
        if share < 0.9:
            fail(f"no engine: {name}'s contigs share {share:.3f} of their "
                 "31-mers with the genome")
        rec[f"{name}_kmer_share"] = share
        log(f"no engine: {name} at 40k reads, {len(contigs)} contigs, FASTA "
            "byte-identical with and without the engine; 31-mer share "
            f"{share:.4f}; seconds with / without "
            f"{rec[name + '_40k_engine']['assembly_s']:.3f} / "
            f"{rec[name + '_40k_no_engine']['assembly_s']:.3f}")
    torch.cuda.synchronize()
    return rec


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
        if any(w in line for w in ("registers", "spill", "Compiling entry")):
            log(f"ptxas: {line.strip()}")

    # --- 3 kernels against their plain versions, main shapes -------------
    k_main = kernel_phase(dev, banded_dp, "main", 920_000, 1 << 19, 1 << 18,
                          wide=True)

    # --- 4 device GCPS against the native engine -------------------------
    cfg = config.AssemblyConfig()
    batch = fastx.build_read_batch(
        bench_40k()[1], None, trim_left=cfg.read_end_trim_left,
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
    genome, paths, n_file_reads = scale_datasets()
    a_paths, b_paths = paths["A"], paths["B"]
    log(f"datasets: {n_file_reads} file reads per configuration "
        f"({time.perf_counter() - t0:.1f}s)")
    for name, digest in dataset_digests(a_paths, b_paths).items():
        check_digest("datasets", digest, name, DATASET_SHA256)
    fasta_a, res_a = run_cli("A", a_paths, n_file_reads)
    check_digest("configuration A", fasta_a, "A")
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
        output=str(WORK / "B_contigs.fasta"), **B_KW)
    res, launches, shapes, seen = logged_run(
        banded_dp, lambda: pipeline.assemble_to_file(cfg_b, device=dev))
    res_b = report("B", res.stats, n_file_reads)
    lcs_pairs_b = res.stats["counters"].get("ach_lcs_pairs", 0)
    log(f"B: kernel launches {launches}; pairs through K2: {lcs_pairs_b}; "
        f"K1 (table rows, pairs) per launch {shapes['gather_planes']}; K2 "
        f"pairs per launch {shapes['banded_lcs']}")
    check_lcs_launches("configuration B", launches)
    real_err = real_launch_errors(banded_dp, seen)
    contigs_b = [c.seq for c in res.contigs if c.seq != "CCCC"]
    ident = index.kmer_share(contigs_b)
    if not contigs_b or ident < 0.9:
        fail(f"configuration B: {len(contigs_b)} contigs, 31-mer identity "
             f"{ident:.3f}")
    check_digest("configuration B", WORK / "B_contigs.fasta", "B")
    log(f"B: {len(contigs_b)} contigs, 31-mer identity {ident:.4f}")

    # --- 6c configuration C: the CLI's own error path (ACLER) ------------
    fasta_c, res_c = run_cli("C", b_paths, n_file_reads, C_CLI_ARGS)
    check_digest("configuration C", fasta_c, "C")
    if res_c["counters"].get("ach_lcs_pairs", 0) != 0:
        fail(f"configuration C sent pairs to the LCS fallback: "
             f"{res_c['counters']}")
    log(f"C: {res_c['contigs']} contigs; "
        f"{res_c['reads_per_s']:.1f} reads/s, peak device memory "
        f"{res_c['peak_device_mb']} MB; ACH counters "
        + json.dumps({k: v for k, v in res_c["counters"].items()
                      if k.startswith("ach_")}))

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
                          fasta_c, n_file_reads, banded_dp)
    launches_mesh = mesh_rec["B_mesh"]["launches"]

    # --- 10 configurations A and B without the native host engine --------
    nonative = nonative_phase(dev, banded_dp)

    # --- 11 alga_tpu's flagship (A-20M) and config-3 (B-12M, C-12M) ------
    flagship = flagship_phase(dev, banded_dp)
    b12 = flagship["B_12M"]["launch_shapes"]
    k_b12 = kernel_phase(
        dev, banded_dp, "B-12M",
        int(statistics.median(n for n, _ in b12["gather_planes"])),
        int(statistics.median(m for _, m in b12["gather_planes"])),
        int(statistics.median(b12["banded_lcs"])))

    # --- 12 the read lengths users sequence (2x150, 2x250, trimmed) -----
    lengths = read_length_phase(dev, banded_dp, index, b_paths,
                                n_file_reads)
    lcs_runs = {"B": {"launches": launches, "launch_errors": real_err},
                "B_mesh": mesh_rec["B_mesh"],
                **{tag: nonative[tag]
                   for tag in ("B_40k_engine", "B_40k_no_engine")},
                "B_12M": flagship["B_12M"],
                **{tag: lengths[tag] for tag in (
                    "B_150", "T_150", "B_250", "B_40k_E16", "B_E16")}}
    by_path = {tag: r["launches"] for tag, r in lcs_runs.items()}
    at_shape = {"B": k_b, "B_12M": k_b12, "B_150": lengths["kernels_B_150"],
                "B_250": lengths["kernels_B_250"],
                "B_40k_E16": lengths["kernels_B_40k_E16"],
                "B_E16": lengths["kernels_B_E16"],
                **{f"K-wide-E{E}": {"banded_lcs_wide":
                                    k_main[f"banded_lcs_wide@E{E}"]}
                   for E in WIDE_TIMED[1:]}}

    (WORK / "summary.json").write_text(json.dumps(
        {"nvidia_smi": smi, "A": res_a, "B": res_b, "C": res_c,
         "reference_sha256": REFERENCE_SHA256, "A_fused": res_7,
         "A_trace": res_8, "A_busy_share": share, "A_span_ms": span_ms,
         "A_trace_kernels": n_kernels,
         "B_lcs_pairs": lcs_pairs_b, "B_launches": launches,
         "B_kmer_identity": ident, "build": _cuda.BUILD_INFO.get("seconds"),
         "B_launch_shapes": shapes, "B_launch_errors": real_err,
         "kernels_main": k_main, "kernels_B": k_b,
         "graph_40k": {"edges": g_dev.num_edges, "seconds": secs},
         "mesh": mesh_rec, "no_engine": nonative, "flagship": flagship,
         "kernels_B_12M": k_b12, "read_lengths": lengths},
        indent=1))

    timed_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "shape")
    kernels = []
    for name, replaces in (("gather_planes", "banded_dp.py:69"),
                           ("banded_lcs", "banded_dp.py:152"),
                           ("banded_lcs_wide", "banded_dp.py:259")):
        main = k_main[name]
        shaped = {tag: k[name] for tag, k in at_shape.items() if name in k}
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCES[name],
            "replaces": f"alga_tpu/ops/pallas/{replaces}",
            "launches": sum(n[name] for n in by_path.values()),
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
            "max_abs_err": max(
                main["max_abs_err"],
                *(r["max_abs_err"] for r in shaped.values()),
                *(r["launch_errors"][name] for r in lcs_runs.values())),
            **{k: main[k] for k in timed_keys},
            **{f"at_{tag}_shape": {k: r[k] for k in timed_keys}
               for tag, r in shaped.items()}})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
