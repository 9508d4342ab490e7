"""The port's device GCPS (alga_tpu_torch/graph/device_scale.py) on the CPU
against the JAX package's device_scale (identical edge arrays, row order
included) and its host graph construction prefsuf.build_gcps_graph (identical
after the pipeline's canonical retain_min_offset).  The cases mirror
tests/test_device_scale.py, the over-cap domination-width fixture
included; a small `block_elems` forces several source blocks."""

import numpy as np
import pytest
import torch

from alga_tpu.core import packing
from alga_tpu.graph import device_scale as jds
from alga_tpu.graph import prefsuf as jprefsuf
from alga_tpu_torch.graph import device_scale, prefsuf
from tests.test_device_scale import (_over_cap_fixture, random_genome,
                                     simulate_reads)

torch.set_num_threads(2)


def _assert_same(g_ref, g):
    assert g.n == g_ref.n
    np.testing.assert_array_equal(g.src, g_ref.src)
    np.testing.assert_array_equal(g.dst, g_ref.dst)
    np.testing.assert_array_equal(g.offset, g_ref.offset)


def _check(seqs, ell_min, cap, rsoe, soes=3, af=None, at=None,
           block_elems=1 << 26):
    packed, lengths = packing.pack_strings(seqs)
    n = len(seqs)
    g = device_scale.gcps_graph_device_scale(
        packed, lengths, n, ell_min, cap, rsoe, soes, af, at,
        block_elems=block_elems, device="cpu")
    _assert_same(jds.gcps_graph_device_scale(
        packed, lengths, n, ell_min, cap, rsoe, soes, af, at), g)
    g_host = jprefsuf.build_gcps_graph(packed, lengths, n, ell_min, cap,
                                       rsoe, soes, align_from=af, align_to=at)
    _assert_same(g_host.retain_min_offset(), g.retain_min_offset())
    return g


def test_gcps_basic(rng):
    seqs = simulate_reads(rng, random_genome(rng, 2000), 60, 300)
    assert _check(seqs, 20, 500, 40).num_edges > 0


def test_gcps_multiblock(rng):
    """Blocks of 13 source reads over 700 reads, the last one ragged."""
    seqs = simulate_reads(rng, random_genome(rng, 1500), 50, 700)
    assert _check(seqs, 18, 500, 33, block_elems=13 * (50 - 18 + 1)).num_edges


def test_gcps_varlen_and_masks(rng):
    genome = random_genome(rng, 1200)
    seqs = []
    for L in rng.integers(35, 90, size=400):
        p = int(rng.integers(0, len(genome) - int(L)))
        seqs.append(genome[p : p + int(L)])
    af = rng.random(len(seqs)) < 0.8
    at = rng.random(len(seqs)) < 0.8
    assert _check(seqs, 15, 500, 30, af=af, at=at,
                  block_elems=5000).num_edges > 0


def test_gcps_ring_regime(rng):
    """Both regimes and the soes ring live, with more than soes matches
    per source (repeat-rich genome)."""
    core = random_genome(rng, 80)
    genome = (random_genome(rng, 150) + core + random_genome(rng, 100)
              + core + random_genome(rng, 120) + core
              + random_genome(rng, 150))
    seqs = [genome[p : p + 45] for p in range(0, len(genome) - 45, 3)]
    assert _check(seqs, 12, 500, 30, soes=2).num_edges > 0


def test_gcps_domination_pruning(rng):
    genome = random_genome(rng, 900)
    seqs = [genome[p : p + 60] for p in range(0, len(genome) - 60, 10)]
    g = _check(seqs, 20, 500, 25, block_elems=200)
    m = jprefsuf.find_exact_overlaps(*packing.pack_strings(seqs), 20, 500)
    assert g.num_edges < len(m.src)


def test_gcps_long_reads_over_cap(rng):
    """The W3 case: reads in (cap, 1.25*cap] and an adversarial trio whose
    domination compare diverges only past words_for(cap - rsoe)."""
    g = _check(_over_cap_fixture(rng, 64), 16, 64, 20)
    assert (0, 2, 60) in g.edge_set()


def test_gcps_empty_and_degenerate():
    packed, lengths = packing.pack_strings(["ACGTACGTAA"])
    for k, rsoe in ((20, 30), (4, 6)):
        g = device_scale.gcps_graph_device_scale(packed, lengths, 1, k, 500,
                                                 rsoe, 3, device="cpu")
        assert g.num_edges == 0


@pytest.mark.parametrize("long_seqs", [False, True])
def test_build_gcps_graph_routing(rng, long_seqs):
    """Reads go to the device path, sequences longer than 1.25*cap (the
    contig-trim graph) to the native engine; both equal the JAX version."""
    genome = random_genome(rng, 3000)
    L = 700 if long_seqs else 100
    seqs = [genome[p : p + L] for p in range(0, len(genome) - L, 37)]
    packed, lengths = packing.pack_strings(seqs)
    n = len(seqs)
    g = prefsuf.build_gcps_graph(packed, lengths, n, 25, 500, 25,
                                 device="cpu")
    g_ref = jprefsuf.build_gcps_graph(packed, lengths, n, 25, 500, 25)
    assert g_ref.num_edges > 0
    _assert_same(g_ref.retain_min_offset(), g.retain_min_offset())


def _logged(err: str) -> dict:
    """key=value fields of the [device_scale ...] stage lines."""
    out = {}
    for line in err.splitlines():
        assert line.startswith("[device_scale +"), line
        for tok in line.split("] ", 1)[1].replace(";", "").split():
            if "=" in tok:
                key, val = tok.split("=", 1)
                out[key] = val
    return out


def test_scale_log(rng, monkeypatch, capsys):
    """ALGA_SCALE_LOG=1 prints the stages to stderr; the totals it logs
    are alga_tpu's, and without it nothing is printed."""
    seqs = simulate_reads(rng, random_genome(rng, 1500), 50, 700)
    packed, lengths = packing.pack_strings(seqs)
    args = (packed, lengths, len(seqs), 18, 500, 33, 3)
    device_scale.gcps_graph_device_scale(*args, block_elems=13 * 33,
                                         device="cpu")
    assert capsys.readouterr().err == ""
    monkeypatch.setenv("ALGA_SCALE_LOG", "1")
    g = device_scale.gcps_graph_device_scale(*args, block_elems=13 * 33,
                                             device="cpu")
    err = capsys.readouterr().err
    got = _logged(err)
    assert err.count(": candidates=") == -(-len(seqs) // 13)
    assert err.rstrip().endswith("] done")
    assert int(got["edges"]) == g.num_edges
    jds.gcps_graph_device_scale(*args)
    want = _logged(capsys.readouterr().err)
    for key in ("n", "nw", "matches", "pairs", "removers", "exp_total",
                "edges"):
        assert got[key] == want[key], key
