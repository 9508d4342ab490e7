"""The port's fused small-batch GCPS (alga_tpu_torch/graph/device_join.py)
on the CPU against alga_tpu.graph.device_join: identical edge arrays with
their row order, identical match lists, the same preconditions and the
same counters; and the ALGA_GCPS_DEVICE routing of
alga_tpu_torch/graph/prefsuf.py against alga_tpu's.  The genomes and
masks are those of tests/test_prefsuf.py:149-213."""

import numpy as np
import pytest
import torch

from alga_tpu.core import packing
from alga_tpu.graph import device_join as jdj
from alga_tpu.graph import device_scale as jds
from alga_tpu.graph import prefsuf as jprefsuf
from alga_tpu.utils import timers as jtimers
from alga_tpu_torch.graph import device_join, device_scale, prefsuf
from alga_tpu_torch.utils import timers
from tests.test_prefsuf import random_genome, reads_from_genome

torch.set_num_threads(2)


def _assert_same(g_ref, g):
    assert g.n == g_ref.n
    np.testing.assert_array_equal(g.src, g_ref.src)
    np.testing.assert_array_equal(g.dst, g_ref.dst)
    np.testing.assert_array_equal(g.offset, g_ref.offset)


def _repeat_rich(rng):
    """Reads of a genome with tandem duplications: regime-1/regime-2
    interactions, full rings and dominated edges."""
    core = random_genome(rng, 120)
    g = core + core[:60] + random_genome(rng, 150) + core[40:100]
    return packing.pack_strings(reads_from_genome(g, 50, 3))


@pytest.mark.parametrize("trial", range(4))
def test_gcps_graph_device_matches_jax(rng, trial):
    for _ in range(trial):           # the genome of this trial
        _repeat_rich(rng)
    packed, lengths = _repeat_rich(rng)
    n = len(lengths)
    args = (packed, lengths, n, 14 + trial, 500, 25 + 3 * trial, 3)
    g = device_join.gcps_graph_device(*args, device="cpu")
    assert g.num_edges > 0
    _assert_same(jdj.gcps_graph_device(*args), g)
    # the blocked path computes the same arrays
    _assert_same(device_scale.gcps_graph_device_scale(*args, device="cpu"),
                 g)


def test_gcps_graph_device_with_masks(rng):
    seqs = reads_from_genome(random_genome(rng, 400), 40, 4)
    packed, lengths = packing.pack_strings(seqs)
    n = len(seqs)
    af = rng.random(n) > 0.25
    at = rng.random(n) > 0.25
    args = (packed, lengths, n, 12, 500, 20, 3, af, at)
    g = device_join.gcps_graph_device(*args, device="cpu")
    assert g.num_edges > 0
    _assert_same(jdj.gcps_graph_device(*args), g)


@pytest.mark.parametrize("case", ["one_read", "no_overlaps", "too_short"])
def test_gcps_graph_device_degenerate(rng, case):
    seqs = {"one_read": ["ACGTACGTAA"],
            "no_overlaps": [random_genome(rng, 60) for _ in range(30)],
            "too_short": ["ACG", "TTT"]}[case]
    packed, lengths = packing.pack_strings(seqs)
    args = (packed, lengths, len(seqs), 12, 500, 13, 3)
    g = device_join.gcps_graph_device(*args, device="cpu")
    assert g.num_edges == 0
    _assert_same(jdj.gcps_graph_device(*args), g)


def test_find_exact_overlaps_device(rng):
    seqs = reads_from_genome(random_genome(rng, 300), 40, 5)
    packed, lengths = packing.pack_strings(seqs)
    n = len(seqs)
    af = rng.random(n) > 0.3
    at = rng.random(n) > 0.3
    m = device_join.find_exact_overlaps_device(packed, lengths, 12, 500, af,
                                               at, device="cpu")
    want = jdj.find_exact_overlaps_device(packed, lengths, 12, 500, af, at)
    assert len(m.src) > 0
    for a, b in zip(m, (want.src, want.dst, want.ell)):
        np.testing.assert_array_equal(a, b)       # same matches, same order
    host = jprefsuf.find_exact_overlaps(packed, lengths, 12, 500, af, at)
    assert (set(zip(*(x.tolist() for x in m)))
            == set(zip(host.src.tolist(), host.dst.tolist(),
                       host.ell.tolist())))


@pytest.mark.parametrize("case", ["many_reads", "long_reads"])
def test_gcps_graph_device_preconditions(case):
    if case == "many_reads":
        n, L = 1 << 22, 30
        packed = np.zeros((n, 2), dtype=np.uint32)
        lengths = np.full(n, L, dtype=np.int32)
    else:
        packed, lengths = packing.pack_strings(["ACGT" * 256, "ACGT" * 10])
        n = 2
    for fn in (jdj.gcps_graph_device,
               lambda *a: device_join.gcps_graph_device(*a, device="cpu")):
        with pytest.raises(ValueError, match="n < 2\\^22"):
            fn(packed, lengths, n, 20, 500, 25, 3)


@pytest.mark.parametrize("path", ["fused", "scale"])
def test_counters_match_jax(rng, path):
    packed, lengths = _repeat_rich(rng)
    args = (packed, lengths, len(lengths), 14, 500, 25, 3)
    port, ref = {"fused": (device_join.gcps_graph_device,
                           jdj.gcps_graph_device),
                 "scale": (device_scale.gcps_graph_device_scale,
                           jds.gcps_graph_device_scale)}[path]
    # each package bumps its own counters
    jtimers.reset_counters()
    timers.reset_counters()
    ref(*args)
    want = jtimers.counters_report()
    assert timers.counters_report() == {}
    # a capacity retry of the JAX version; the port sizes from the data
    want.pop("gcps_scale_retries", None)
    jtimers.reset_counters()
    port(*args, device="cpu")
    got = timers.counters_report()
    assert jtimers.counters_report() == {}
    assert set(want) == {"gcps_candidates", "gcps_matches",
                         "gcps_domination_checks"}
    assert got == want


def _graph_inputs(rng, L=100, step=37):
    seqs = [g[p:p + L] for g in [random_genome(rng, 3000)]
            for p in range(0, len(g) - L, step)]
    packed, lengths = packing.pack_strings(seqs)
    return packed, lengths, len(seqs)


@pytest.mark.parametrize("mode", ["small", "wide", "off"])
def test_routing_override(rng, monkeypatch, mode):
    """ALGA_GCPS_DEVICE takes the named engine, and only it."""
    packed, lengths, n = _graph_inputs(rng)
    entered = []
    engines = {"small": "gcps_graph_device",
               "wide": "gcps_graph_device_scale",
               "off": "host_gcps_graph"}
    for name in engines.values():
        fn = getattr(prefsuf, name)
        monkeypatch.setattr(prefsuf, name,
                            lambda *a, _fn=fn, _n=name, **kw:
                            entered.append(_n) or _fn(*a, **kw))
    monkeypatch.setenv("ALGA_GCPS_DEVICE", mode)
    g = prefsuf.build_gcps_graph(packed, lengths, n, 25, 500, 25,
                                 device="cpu")
    assert entered == [engines[mode]]
    g_ref = jprefsuf.build_gcps_graph(packed, lengths, n, 25, 500, 25)
    assert g_ref.num_edges > 0
    _assert_same(g_ref.retain_min_offset(), g.retain_min_offset())


def _spy_engines(monkeypatch, compute=("host_gcps_graph",)):
    """The names of the GCPS engines build_gcps_graph enters, in order;
    an engine not in `compute` returns None instead of running."""
    entered = []
    for name in ("gcps_graph_device", "gcps_graph_device_scale",
                 "host_gcps_graph"):
        fn = getattr(prefsuf, name) if name in compute else None
        monkeypatch.setattr(prefsuf, name,
                            lambda *a, _fn=fn, _n=name, **kw:
                            entered.append(_n) or (_fn and _fn(*a, **kw)))
    return entered


@pytest.mark.parametrize("case", ["cuda_small", "cuda_fused", "cuda_blocked",
                                  "cpu_small"])
def test_cuda_routing_size_term(rng, monkeypatch, case):
    """Without ALGA_GCPS_DEVICE, a CUDA device (device.resolve patched to
    report one) routes by alga_tpu's accelerator rule: under 2^18 windows
    the host route, with the edges and counters of alga_tpu's host route;
    at 2^18 or more the fused path under 2^19 reads, else the blocked
    path.  The CPU keeps the blocked path for small graphs."""
    monkeypatch.delenv("ALGA_GCPS_DEVICE", raising=False)
    if case.startswith("cuda"):
        monkeypatch.setattr(prefsuf.device_mod, "resolve",
                            lambda device=None: torch.device("cuda"))
    if case.endswith("small"):
        packed, lengths, n = _graph_inputs(rng)
        assert n * (int(lengths.max()) - 25 + 1) < 1 << 18
    else:
        # 4096 reads x 76 windows, or 2^19 reads x 11 windows: >= 2^18
        n, L, ell = {"cuda_fused": (4096, 100, 25),
                     "cuda_blocked": (1 << 19, 30, 20)}[case]
        packed = np.zeros((n, packing.words_for(L)), dtype=np.uint32)
        lengths = np.full(n, L, dtype=np.int32)
    engine = {"cuda_small": "host_gcps_graph",
              "cuda_fused": "gcps_graph_device",
              "cuda_blocked": "gcps_graph_device_scale",
              "cpu_small": "gcps_graph_device_scale"}[case]
    entered = _spy_engines(monkeypatch, compute=(
        (engine,) if case.endswith("small") else ()))
    if not case.endswith("small"):
        prefsuf.build_gcps_graph(packed, lengths, n, ell, 500, 25,
                                 device="cpu")
        assert entered == [engine]
        return
    jtimers.reset_counters()
    g_ref = jprefsuf.build_gcps_graph(packed, lengths, n, 25, 500, 25)
    want = jtimers.counters_report()
    timers.reset_counters()
    g = prefsuf.build_gcps_graph(packed, lengths, n, 25, 500, 25,
                                 device="cpu")
    assert entered == [engine]
    assert g_ref.num_edges > 0
    if case == "cuda_small":
        # the same engine as alga_tpu's: the same arrays and counters
        _assert_same(g_ref, g)
        assert want["gcps_candidates"] > 0
        assert timers.counters_report() == want
    else:
        _assert_same(g_ref.retain_min_offset(), g.retain_min_offset())


@pytest.mark.parametrize("case", ["short", "masked", "long"])
def test_long_prefix_key_run_skips_native_join(rng, monkeypatch, case):
    """A prefix-key run of NATIVE_RUN_LIMIT rows or more (the limit lowered
    to 4 here) keeps out of the native fused join, whose table packs a
    run's length into 24 bits: host_gcps_graph takes find_exact_overlaps,
    and its edges equal alga_tpu's, row for row.  `long` has reads past
    cap + cap/4 (the contig-trim graph's tail windows)."""
    g = random_genome(rng, 2500)
    seqs = [g[p:p + 70 + p % 31] for p in range(0, len(g) - 100, 17)]
    # five reads from one position: one prefix key, five rows
    seqs += [g[400:400 + L] for L in (40, 48, 55, 63, 90)]
    packed, lengths = packing.pack_strings(seqs)
    n = len(seqs)
    af = at = None
    if case == "masked":
        af, at = rng.random(n) > 0.2, rng.random(n) > 0.2
        at[-5:] = True
    cap = 60 if case == "long" else 500
    assert (int(lengths.max()) > cap + (cap >> 2)) == (case == "long")

    def refuse(*a, **kw):
        raise AssertionError("native fused join called")
    monkeypatch.setattr(prefsuf, "NATIVE_RUN_LIMIT", 4)
    monkeypatch.setattr(prefsuf.native, "gcps_join_verify_packed", refuse)
    args = (packed, lengths, n, 25, cap, 35, 3, af, at)
    got = prefsuf.host_gcps_graph(*args, device="cpu")
    g_ref = jprefsuf.build_gcps_graph(*args)
    assert g_ref.num_edges > 0
    _assert_same(g_ref, got)


def test_small_falls_through_on_long_reads(rng, monkeypatch, capsys):
    """`small` with reads of 1024 bases or more prints alga_tpu's notice
    and routes as if unset (here: the blocked path, reads <= 1.25 cap)."""
    packed, lengths, n = _graph_inputs(rng, L=1100, step=50)

    def refuse(*a, **kw):
        raise AssertionError("fused path entered")
    monkeypatch.setattr(prefsuf, "gcps_graph_device", refuse)
    monkeypatch.setenv("ALGA_GCPS_DEVICE", "small")
    g = prefsuf.build_gcps_graph(packed, lengths, n, 25, 1000, 25,
                                 device="cpu")
    notice = capsys.readouterr().err
    g_ref = jprefsuf.build_gcps_graph(packed, lengths, n, 25, 1000, 25)
    assert "ALGA_GCPS_DEVICE=small ignored" in notice
    assert notice == capsys.readouterr().err
    assert g_ref.num_edges > 0
    _assert_same(g_ref.retain_min_offset(), g.retain_min_offset())
