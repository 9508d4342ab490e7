"""The port without its C++ host engine: with `native.available` patched
to return False in both packages (as tests/test_prefsuf.py and
tests/test_supplement.py do for alga_tpu), every engine-free function of
the port equals alga_tpu's on the same seeded inputs with tolerance 0 —
find_exact_overlaps on its tail-compacted and full-window branches, the
numpy GCPS build, window_keys and substr_equal_auto on their host and
device branches (the device branch forced on device="cpu"), the LI
k-mers, pair generation and the Python branch-marker replay (also
against alga_tpu's sequential oracles) — and `pipeline.assemble` writes
the same contigs as alga_tpu's engine-free run and as the port's own run
with the engine loaded, in configurations A and B, paired and unpaired.
Also: npz phase checkpoints written by either package load in the other,
and the simplifier's warning above 100,000 nodes."""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

from alga_tpu import native as jnative
from alga_tpu import pipeline as jpipeline
from alga_tpu.config import AssemblyConfig, autotune, supplement_retune
from alga_tpu.core import packing as jpacking
from alga_tpu.core.seqbatch import SeqBatch as JSeqBatch
from alga_tpu.graph import prefsuf as jprefsuf
from alga_tpu.graph import supplement as jsupp
from alga_tpu.graph.overlap_graph import OverlapGraph as JOverlapGraph
from alga_tpu.ops import bitops as jbitops
from alga_tpu.ops import hashes as jhashes
from alga_tpu.utils import serialize as jserialize
from alga_tpu_torch import native, pipeline
from alga_tpu_torch.core.seqbatch import SeqBatch
from alga_tpu_torch.graph import prefsuf, supplement
from alga_tpu_torch.graph.overlap_graph import OverlapGraph
from alga_tpu_torch.ops import bitops, hashes
from alga_tpu_torch.utils import serialize
from tests.simulate import random_genome, simulate_single
from tests.test_supplement import DictAdj
from tests.test_torch_pipeline import CONFIGS, _contigs, _reads

torch.set_num_threads(2)


@contextlib.contextmanager
def no_engine():
    """native.available() is False in both packages."""
    with mock.patch.object(jnative, "available", lambda: False), \
            mock.patch.object(native, "available", lambda: False):
        yield


@pytest.fixture
def engine_off():
    with no_engine():
        yield


def _seqs(rng, kind):
    """Reads of a genome with a repeat: `short` 60-100 bp reads (the
    full-window branch at cap 500), `long` 150-700 bp sequences (the
    tail-compacted branch at cap 100, the contig-trim graph's shape).  A
    tenth are suffixes of another read, so that pairs tie on their
    overlap and the domination's stamp order decides."""
    rep = random_genome(rng, 150)
    genome = (random_genome(rng, 900) + rep + random_genome(rng, 900) + rep
              + random_genome(rng, 900))
    comp = str.maketrans("ACGT", "TGCA")
    lo, hi, count = (60, 101, 300) if kind == "short" else (150, 701, 60)
    out = []
    for L in rng.integers(lo, hi, size=count):
        p = int(rng.integers(0, len(genome) - int(L)))
        s = genome[p:p + int(L)]
        out.append(s.translate(comp)[::-1] if rng.random() < 0.5 else s)
    for i in rng.integers(0, len(out), len(out) // 10):
        cut = int(rng.integers(1, len(out[i]) // 3))
        out.insert(int(rng.integers(0, len(out))), out[i][cut:])
    return out


def _store(rng, kind, masks):
    seqs = _seqs(rng, kind)
    packed, lengths = jpacking.pack_strings(seqs)
    n = len(seqs)
    af = at = None
    if masks:
        af = rng.random(n) < 0.7
        at = rng.random(n) < 0.7
    ell_min, cap, rsoe = (20, 500, 40) if kind == "short" else (25, 100, 50)
    return packed, lengths, n, ell_min, cap, rsoe, af, at


def _same_matches(m, want):
    for f in ("src", "dst", "ell"):
        np.testing.assert_array_equal(getattr(m, f), getattr(want, f))


@contextlib.contextmanager
def device_branches():
    """The port's window_keys and substr_equal_auto take their device
    branch (on device="cpu") whatever the batch size."""
    with mock.patch.object(hashes.window_keys, "__defaults__", (True,)), \
            mock.patch.object(bitops.substr_equal_auto, "__defaults__",
                              (1,)):
        yield


@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("masks", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("kind", ["short", "long"])
def test_find_exact_overlaps(kind, masks, route, rng):
    packed, lengths, n, ell_min, cap, _, af, at = _store(rng, kind, masks)
    assert (int(lengths.max()) > cap + (cap >> 2)) == (kind == "long")
    ctx = device_branches() if route == "device" else contextlib.nullcontext()
    with no_engine():
        want = jprefsuf.find_exact_overlaps(packed, lengths, ell_min, cap,
                                            af, at)
        with ctx:
            got = prefsuf.find_exact_overlaps(packed, lengths, ell_min, cap,
                                              af, at, device="cpu")
    assert len(want.src) > 0
    _same_matches(got, want)
    if native.available():
        # with the engine loaded the join probes through join_ranges
        _same_matches(prefsuf.find_exact_overlaps(
            packed, lengths, ell_min, cap, af, at, device="cpu"), want)


@pytest.mark.parametrize("kind", ["short", "long"])
def test_engine_free_gcps_graph(kind, rng, monkeypatch):
    """prefsuf.build_gcps_graph under ALGA_GCPS_DEVICE=off in both
    packages: the port's host route (find_exact_overlaps +
    gcps_from_matches) against alga_tpu's numpy build, row for row."""
    packed, lengths, n, ell_min, cap, rsoe, af, at = _store(rng, kind, True)
    monkeypatch.setenv("ALGA_GCPS_DEVICE", "off")
    with no_engine():
        want = jprefsuf.build_gcps_graph(packed, lengths, n, ell_min, cap,
                                         rsoe, 3, af, at)
        got = prefsuf.build_gcps_graph(packed, lengths, n, ell_min, cap,
                                       rsoe, 3, af, at, device="cpu")
        # the numpy build with its domination verify on the device branch
        m = prefsuf.find_exact_overlaps(packed, lengths, ell_min, cap, af,
                                        at, device="cpu")
        with device_branches():
            dev = prefsuf.gcps_from_matches(n, m, packed, lengths, rsoe, 3,
                                            device="cpu")
    assert want.num_edges > 0
    for g in (got, dev):
        for f in ("src", "dst", "offset"):
            np.testing.assert_array_equal(getattr(g, f), getattr(want, f))


@pytest.mark.parametrize("prefer_device", [None, False, True])
@pytest.mark.parametrize("engine", ["off", "on"])
def test_window_keys(prefer_device, engine, rng):
    n, L, k = 50, 90, 17
    codes = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    lengths = rng.integers(k - 2, L + 1, size=n).astype(np.int64)
    packed = jpacking.codes_to_packed(codes, lengths)
    codes = jpacking.packed_to_codes(packed, L)
    nw = L - k + 1
    ctx = no_engine() if engine == "off" else contextlib.nullcontext()
    with ctx:
        want = jhashes.window_keys(packed, None, lengths, k, nw,
                                   prefer_device)
        got = hashes.window_keys(packed, None, lengths, k, nw, prefer_device,
                                 device="cpu")
        from_codes = hashes.window_keys(None, codes, lengths, k, nw,
                                        device="cpu")
    for g in (got, from_codes):
        assert g[0].dtype == np.uint64
        np.testing.assert_array_equal(g[0], want[0])
        np.testing.assert_array_equal(g[1], want[1])
    k1, k2, valid = hashes.np_window_kmer_keys(codes, lengths, k, nw)
    np.testing.assert_array_equal(hashes.combine_keys(k1, k2), want[0])
    np.testing.assert_array_equal(valid, want[1])
    assert want[0][0, 0] == jhashes.np_window_hash(codes[0], 0, k)


@pytest.mark.parametrize("with_codes", [False, True],
                         ids=["packed", "codes"])
@pytest.mark.parametrize("min_device_batch", [1, 200_000],
                         ids=["device", "host"])
def test_substr_equal_auto(min_device_batch, with_codes, rng):
    n, L, m = 80, 120, 3000
    codes = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    lengths = np.full(n, L, dtype=np.int64)
    codes[1::2, :60] = codes[0::2, 30:90]      # equal stretches to find
    packed = jpacking.codes_to_packed(codes, lengths)
    a = rng.integers(0, n, m)
    b = np.where(rng.random(m) < 0.5, a + 1 - 2 * (a % 2), rng.integers(0, n, m))
    start = np.where(rng.random(m) < 0.5, 30, rng.integers(0, 60, m))
    ell = rng.integers(1, 61, m)
    c = codes if with_codes else None
    want = jbitops.substr_equal_auto(packed, c, a, start, b, ell, 4,
                                     min_device_batch)
    got = bitops.substr_equal_auto(packed, c, a, start, b, ell, 4,
                                   min_device_batch, device="cpu")
    assert got.dtype == bool and 0 < got.sum() < m
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        bitops.np_substr_equal_batch(codes, a, start, b, ell), want)


def _error_reads(seed, n_genome=2000, coverage=12.0):
    """Reads with 2% errors, each cut to 70-100 bases."""
    rng = np.random.default_rng(seed)
    reads = simulate_single(random_genome(rng, n_genome), rng, read_len=100,
                            coverage=coverage, error_rate=0.02)
    reads = [r[:int(n)] for r, n in zip(reads, rng.integers(70, 101,
                                                            len(reads)))]
    batch = JSeqBatch.from_strings(reads)
    cfg = supplement_retune(autotune(AssemblyConfig(error_rate=0.02),
                                     batch.avg_read_length()),
                            batch.avg_read_length())
    return batch, cfg, rng


@pytest.mark.parametrize("source", ["codes", "packed"])
def test_li_kmers(source, engine_off):
    batch, cfg, rng = _error_reads(5)
    codes = batch.codes()
    valid = rng.random(len(batch)) < 0.8
    k, iv = cfg.li_kmer_length, cfg.li_kmer_intervals
    for pri in ([0, 1, 2, 3], [2, 3, 0, 1]):
        want = jsupp.li_kmers(codes, batch.lengths, valid, pri, k, iv,
                              chunk_cells=1 << 12)
        kw = (dict(codes=codes) if source == "codes"
              else dict(codes=None, packed=batch.packed))
        got = supplement.li_kmers(lengths=batch.lengths, valid=valid,
                                  priorities=pri, k=k, intervals=iv,
                                  chunk_cells=1 << 12, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        ref = jsupp.li_kmers_ref(codes, batch.lengths, valid, pri, k, iv)
        assert (sorted(zip(*(a.tolist() for a in got)))
                == sorted(zip(*(a.tolist() for a in ref))))


def _runs_and_pairs(pkg, batch, cfg, af, at):
    rid, ind, hi, lo = pkg.li_kmers(batch.codes(), batch.lengths,
                                    np.ones(len(batch), bool), [0, 1, 2, 3],
                                    cfg.li_kmer_length, cfg.li_kmer_intervals)
    runs = pkg._canonical_runs(rid, ind, hi, lo, batch.lengths)
    return runs, pkg._gen_candidate_pairs(*runs, batch.lengths, cfg, af, at)


def test_runs_pairs_and_replay(engine_off):
    """_canonical_runs (the lexsort), the numpy pair generation and the
    Python replay against alga_tpu's, on both packages' SupplementAdj over
    the same graph; the replay with the engine loaded gives the same
    overlay."""
    batch, cfg, rng = _error_reads(6)
    n = len(batch)
    af = rng.random(n) < 0.8
    at = rng.random(n) < 0.8
    want_runs, want_pairs = _runs_and_pairs(jsupp, batch, cfg, af, at)
    runs, pairs = _runs_and_pairs(supplement, batch, cfg, af, at)
    for g, w in zip(runs + pairs, want_runs + want_pairs):
        np.testing.assert_array_equal(g, w)
    pi, pj, ok = pairs
    assert ok.any() and not ok.all()
    can = rng.random(len(pi)) < 0.5

    src, dst = rng.integers(0, n, 400), rng.integers(0, n, 400)
    off = rng.integers(1, 60, 400)
    jadj = jpipeline.SupplementAdj(JOverlapGraph(n, *(a.astype(np.int32)
                                                      for a in (src, dst, off))))
    adj = pipeline.SupplementAdj(OverlapGraph(n, *(a.astype(np.int32)
                                                   for a in (src, dst, off))))
    jsupp._replay_runs(jadj, *runs, pi, pj, ok, can)
    supplement._replay_runs_auto(adj, *runs, pi, pj, ok, can)
    assert len(jadj.overlay) > 0
    assert adj.overlay == jadj.overlay
    assert (adj.to_graph().edge_set() == jadj.to_graph().edge_set())
    if native.get_lib() is not None:
        nat = pipeline.SupplementAdj(OverlapGraph(
            n, *(a.astype(np.int32) for a in (src, dst, off))))
        with mock.patch.object(native, "available", lambda: True):
            supplement._replay_runs_auto(nat, *runs, pi, pj, ok, can)
        assert nat.overlay == jadj.overlay


@pytest.mark.parametrize("min_device_batch", [1, 200_000],
                         ids=["device", "host"])
def test_pkb_supplement_matches_sequential_oracle(min_device_batch,
                                                  engine_off):
    """The engine-free supplement (numpy extraction and pairs, Python
    replay) against alga_tpu's literal transcription of the reference
    loop, with pre-existing edges."""
    batch, cfg, rng = _error_reads(7, n_genome=1500)
    n = len(batch)
    af = rng.random(n) < 0.6
    at = rng.random(n) < 0.6
    pre = [(int(a), int(b), int(o)) for a, b, o in
           zip(rng.integers(0, n, 30), rng.integers(0, n, 30),
               rng.integers(1, 40, 30)) if a != b]
    codes = batch.codes()
    ref = DictAdj(pre)
    jsupp.pkb_supplement_ref(ref, codes, batch.lengths, batch.lengths, cfg,
                             af, at)
    got = DictAdj(pre)
    supplement.pkb_supplement(got, None, batch.lengths, batch.lengths, cfg,
                              af, at, packed=batch.packed,
                              min_device_batch=min_device_batch,
                              device="cpu")
    assert len(ref.edge_set()) > len(pre)
    assert got.edge_set() == ref.edge_set()


@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
@pytest.mark.parametrize("config", ["A", "B"])
def test_assemble_without_engine(config, paired):
    kw = _reads(paired, 0.01 if config == "B" else 0.0)
    cfg = AssemblyConfig(file2="x" if paired else "", **CONFIGS[config])
    with_engine = _contigs(pipeline.assemble(cfg, device="cpu", **kw))
    with no_engine():
        got = pipeline.assemble(cfg, device="cpu", **kw)
        want = _contigs(jpipeline.assemble(cfg, **kw))
    assert "contract_walk_native" not in got.stats["phase_seconds"]
    assert len(want) >= 2
    assert _contigs(got) == want
    assert _contigs(got) == with_engine
    if config == "B":
        assert got.stats["counters"]["ach_lcs_pairs"] > 0


@pytest.mark.parametrize("writer", ["alga_tpu", "port"])
def test_checkpoints_load_in_the_other_package(writer, tmp_path, rng):
    seqs = [random_genome(rng, int(L)) for L in rng.integers(40, 120, 30)]
    batch = JSeqBatch.from_strings(seqs)
    batch.valid[rng.random(30) < 0.3] = False
    batch.paired_offset = rng.integers(0, 3, 30).astype(np.int8)
    src, dst = rng.integers(0, 30, 80), rng.integers(0, 30, 80)
    off = rng.integers(1, 60, 80)
    g = JOverlapGraph(30, *(a.astype(np.int32) for a in (src, dst, off)))
    meta = {"phase": "graph", "k": 55}
    path = str(tmp_path / "ck.npz")
    save, load = ((jserialize.save_checkpoint, serialize.load_checkpoint)
                  if writer == "alga_tpu" else
                  (serialize.save_checkpoint, jserialize.load_checkpoint))
    if writer == "port":
        batch = SeqBatch(batch.packed, batch.lengths, batch.valid,
                         batch.paired_offset)
        g = OverlapGraph(g.n, g.src, g.dst, g.offset)
    save(path, batch=batch, graph=g, meta=meta)
    b2, g2, meta2 = load(path)
    assert type(b2).__module__.startswith(
        "alga_tpu_torch" if writer == "alga_tpu" else "alga_tpu.")
    for f in ("packed", "lengths", "valid", "paired_offset"):
        np.testing.assert_array_equal(getattr(b2, f), getattr(batch, f))
        assert getattr(b2, f).dtype == getattr(batch, f).dtype
    assert b2.to_strings() == seqs
    assert g2.n == 30
    for f in ("src", "dst", "offset"):
        np.testing.assert_array_equal(getattr(g2, f), getattr(g, f))
    assert {k: v.item() for k, v in meta2.items()} == meta
    # a checkpoint of the graph alone
    save(path, graph=g)
    assert load(path)[0] is None and load(path)[1].num_edges == g.num_edges


class _Stop(Exception):
    pass


def test_simplifier_warns_above_100k_nodes_without_engine(capsys,
                                                          monkeypatch,
                                                          engine_off):
    """Without the engine, a graph of more than 100,000 nodes logs
    alga_tpu's WARNING before the Python simplifier runs.  Prefix marking,
    the graph build and the simplifier itself are patched out: a batch of
    100,002 valid reads reaches the simplifier with an empty graph."""
    from alga_tpu.graph import simplify as jsimplify
    from alga_tpu.io import fastx as jfastx
    from alga_tpu_torch.graph import simplify
    from alga_tpu_torch.io import fastx

    def stop(*a, **k):
        raise _Stop

    n = 100_002
    logs = []
    for pkg, fx, simp, make_batch, make_graph in (
            (pipeline, fastx, simplify, SeqBatch, OverlapGraph.empty),
            (jpipeline, jfastx, jsimplify, JSeqBatch, JOverlapGraph.empty)):
        monkeypatch.setattr(fx, "mark_prefix_reads",
                            lambda b: np.zeros(len(b), dtype=bool))
        monkeypatch.setattr(pkg, "build_graph_phase",
                            lambda b, *a, **k: make_graph(len(b)))
        monkeypatch.setattr(simp, "simplify_graph_old", stop)
        batch = make_batch(np.zeros((n, 7), dtype=np.uint32),
                           np.full(n, 100, dtype=np.int32),
                           np.ones(n, dtype=bool))
        kw = dict(device="cpu") if pkg is pipeline else {}
        capsys.readouterr()
        with pytest.raises(_Stop):
            pkg.assemble(AssemblyConfig(), batch=batch, paired=False, **kw)
        logs.append([ln for ln in capsys.readouterr().err.splitlines()
                     if ln.startswith("WARNING")])
    assert logs[0] == logs[1]
    assert logs[0] == [
        "WARNING: native engine unavailable — the Python twin simplifier "
        f"walks nodes in Python loops and will be very slow at {n} nodes "
        "(build native/libalga_host.so, or run on a mesh)"]
