"""The port's assembly (alga_tpu_torch.pipeline.assemble, device="cpu")
against alga_tpu.pipeline.assemble at the read lengths users sequence:
2x150 bp (NovaSeq, HiSeq X), 2x250 and 2x300 bp (MiSeq), and mates
quality-trimmed to between half and all of their length, on ~10 kb
genomes with a repeat: byte-identical contigs, paired and unpaired, in
configuration A (error_rate=0) and B (error_rate=0.02 with the ACLCS
banded-LCS fallback on), under the default routing and, for paired 150
and 250 bp reads in A, with the fused (ALGA_GCPS_DEVICE=small) and the
blocked (wide) GCPS path forced.  Read length sets the shapes of the
device code: windows per read, the words of the verify and domination
compares, and K1's and K2's rows.

Also the band half-widths E >= 16 (AssemblyConfig.max_error_rate_for_lcs),
which alga_tpu runs through its XLA row scan and the port through the
wide K2 kernel on a card: the plain banded LCS against alga_tpu's oracle,
and whole assemblies against alga_tpu's."""

import numpy as np
import pytest
import torch

from alga_tpu import pipeline as jpipeline
from alga_tpu.config import AssemblyConfig
from alga_tpu.core import packing
from alga_tpu.ops import align as jalign
from alga_tpu_torch import pipeline
from alga_tpu_torch.ops import banded_dp
from tests.simulate import random_genome, simulate_paired, simulate_single

torch.set_num_threads(2)

CONFIGS = {
    "A": dict(),
    "B": dict(error_rate=0.02, use_acler_instead_of_aclcs=False),
}
# read length -> insert (fragment) length, as the recipes in chip_smoke.py
INSERTS = {150: 400, 250: 550, 300: 650}


def _reads(read_len: int, trim: bool, paired: bool, error_rate: float,
           seed: int):
    """Reads of a ~10 kb genome with a 600 bp repeat at 25x; with `trim`,
    each read's 3' end cut to a length drawn from [read_len // 2,
    read_len]."""
    rng = np.random.default_rng(seed)
    rep = random_genome(rng, 600)
    genome = (random_genome(rng, 3000) + rep + random_genome(rng, 3000)
              + rep + random_genome(rng, 3000))
    if paired:
        mates = list(simulate_paired(genome, rng, read_len=read_len,
                                     insert=INSERTS[read_len], coverage=25,
                                     error_rate=error_rate))
    else:
        mates = [simulate_single(genome, rng, read_len=read_len,
                                 coverage=25, error_rate=error_rate)]
    if trim:
        mates = [[r[:int(rng.integers(read_len // 2, read_len + 1))]
                  for r in m] for m in mates]
    return dict(zip(("file1_seqs", "file2_seqs"), mates))


def _contigs(res):
    return [(c.cid, c.seq) for c in res.contigs]


# (read length, trimmed, paired, configuration, ALGA_GCPS_DEVICE)
CASES = [(n, trim, paired, config, None)
         for n, trim in ((150, False), (250, False), (300, False),
                         (150, True), (250, True))
         for paired in (False, True) for config in ("A", "B")]
CASES += [(n, False, True, "A", route) for n in (150, 250)
          for route in ("small", "wide")]


def _case_id(case):
    n, trim, paired, config, route = case
    return (f"{n}{'trim' if trim else ''}-{'paired' if paired else 'single'}"
            f"-{config}" + (f"-{route}" if route else ""))


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_assemble_matches_jax_at_read_length(case, monkeypatch):
    n, trim, paired, config, route = case
    kw = _reads(n, trim, paired, 0.01 if config == "B" else 0.0,
                seed=n + 2 * trim + paired)
    lens = [len(r) for m in kw.values() for r in m]
    assert max(lens) == n and (min(lens) < n) == trim
    cfg = AssemblyConfig(file2="x" if paired else "", **CONFIGS[config])
    want = jpipeline.assemble(cfg, **kw)
    if route:
        monkeypatch.setenv("ALGA_GCPS_DEVICE", route)
    got = pipeline.assemble(cfg, device="cpu", **kw)
    assert len(got.contigs) >= 1
    assert _contigs(got) == _contigs(want)
    if config == "B":
        # pairs reached the port's banded LCS (its plain version here)
        assert got.stats["counters"]["ach_lcs_pairs"] > 0


@pytest.mark.parametrize("E", [16, 24, 31, 63])
def test_wide_band_lcs_matches_oracle(E):
    """The port's banded LCS at band half-widths the wide kernel takes on
    a card, against alga_tpu's literal oracle, on reads of 125-250 bases:
    80 pairs whose read 2 is a noisy suffix of read 1 from offset 0-60 on,
    35 random pairs at offsets 0-125 and 5 pairs with no row."""
    rng = np.random.default_rng(E)
    n, L = 200, 256
    lens = rng.integers(125, 251, n)
    codes = np.zeros((n, L), dtype=np.uint8)
    for i, k in enumerate(lens):
        codes[i, :k] = rng.integers(0, 4, k)
    r1 = np.concatenate([2 * np.arange(80), rng.integers(0, n, 40)])
    r2 = (r1 + 1) % n
    offs = np.concatenate([rng.integers(0, 61, 80),
                           rng.integers(0, 126, 40)])
    for a, o in zip(r1[:80], offs[:80]):      # noisy overlaps
        seg = codes[a, o:].copy()
        noise = rng.random(len(seg)) < 0.05
        seg[noise] = rng.integers(0, 4, noise.sum())
        codes[a + 1, :len(seg)] = seg
    offs[-5:] = lens[r1[-5:]] + E + 1          # past read 1's end
    packed = packing.codes_to_packed(codes, lens)
    w = torch.from_numpy(packed.view(np.int32).T.copy())
    l32 = torch.from_numpy(lens.astype(np.int32))
    t1, t2 = torch.from_numpy(r1), torch.from_numpy(r2)
    got = banded_dp.banded_lcs(
        w[:, t1].contiguous(), w[:, t2].contiguous(), l32[t1], l32[t2],
        torch.from_numpy(offs.astype(np.int32)), E).numpy()
    want = np.array([jalign.np_banded_lcs(codes, lens, a, b, int(o), E)
                     for a, b, o in zip(r1, r2, offs)])
    np.testing.assert_array_equal(got, want)
    assert np.median(want[:80]) > 60 and not want[-5:].any()


@pytest.mark.parametrize("E", [16, 24])
def test_assemble_wide_band_matches_jax(E):
    """Configuration B with max_error_rate_for_lcs = E >= 16 on 2x150 bp
    reads at 1% errors: the port wrote no contig before the wide kernel
    (its banded LCS raised past E = 15), alga_tpu's XLA route does."""
    kw = _reads(150, False, True, 0.01, seed=11)
    cfg = AssemblyConfig(file2="x", max_error_rate_for_lcs=E,
                         **CONFIGS["B"])
    got = pipeline.assemble(cfg, device="cpu", **kw)
    assert got.stats["counters"]["ach_lcs_pairs"] > 0
    assert len(got.contigs) >= 1
    assert _contigs(got) == _contigs(jpipeline.assemble(cfg, **kw))
