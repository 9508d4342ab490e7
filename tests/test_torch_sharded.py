"""The port's sharded passes (alga_tpu_torch/parallel/sharded_*.py) on 1, 2
and 3 gloo ranks against alga_tpu, exactly: the sharded GCPS graph
(n = 186, ragged against every world size, with and without masks) against
alga_tpu's sharded graph on its 8-device mesh and the port's single-device
graph, with each rank's store shard asserted; prefix marking; the triangle
cut, retain-min-offset, dangling collection, MST pass and the whole
simplifyGraphOld (edges and valid); and the pointer-doubling chain
discovery, a pure cycle included."""

import numpy as np
import pytest
import torch

from alga_tpu.core import packing
from alga_tpu.core.seqbatch import SeqBatch
from alga_tpu.graph import simplify
from alga_tpu.graph.overlap_graph import OverlapGraph
from alga_tpu.io import fastx
from alga_tpu.parallel import mesh as jmesh
from alga_tpu.parallel.sharded_contract import np_chain_terminals
from alga_tpu.parallel.sharded_gcps import gcps_graph_sharded
from alga_tpu.parallel.sharded_simplify import cut_triangles_sharded
from alga_tpu.utils.glibc_rand import workload_covered
from alga_tpu_torch import native as tnative
from alga_tpu_torch.core.seqbatch import SeqBatch as TSeqBatch
from alga_tpu_torch.graph import contract as tcontract
from alga_tpu_torch.graph import prefsuf as tprefsuf
from alga_tpu_torch.graph.overlap_graph import OverlapGraph as TGraph
from alga_tpu_torch.io import fastx as tfastx
from alga_tpu_torch.parallel import sharded_contract as tsc
from alga_tpu_torch.parallel import sharded_preprocess as tsp

from tests.test_torch_mesh import gen, run_ranks

GEN_GRAPHS = r"""
def assembly_like_edges(rng, n, nchains=60):
    # chains with bubbles, metric triangles and dangling tips
    edges = {}
    def add(a, b, w):
        if a != b:
            edges.setdefault((int(a), int(b)), int(w))
    nodes = np.arange(n)
    rng.shuffle(nodes)
    pos = 0
    for _ in range(nchains):
        L = int(rng.integers(4, 16))
        chain = nodes[pos: pos + L]
        pos += L
        if len(chain) < 4 or pos + L >= n:
            break
        for a, b in zip(chain, chain[1:]):
            add(a, b, rng.integers(3, 15))
        a, b, c = chain[0], chain[1], chain[2]
        add(a, c, edges[(int(a), int(b))] + edges[(int(b), int(c))])
        mid = chain[len(chain) // 2]
        tip = nodes[pos % n]
        add(mid, tip, rng.integers(3, 15))
        add(chain[1], chain[3], rng.integers(5, 30))
    for a, b in rng.integers(0, n, (n // 6, 2)):
        add(a, b, rng.integers(10, 40))
    return [(a, b, w) for (a, b), w in edges.items()]


def random_edges(seed, n, m):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    off = rng.integers(1, 50, m).astype(np.int32)
    keep = src != dst
    return src[keep], dst[keep], off[keep]


def chain_graph_arrays(seed, n, extra):
    # a permutation-path backbone plus random extra edges
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n).astype(np.int32)
    src = np.concatenate([perm[:-1], rng.integers(0, n, extra)])
    dst = np.concatenate([perm[1:], rng.integers(0, n, extra)])
    off = np.concatenate([rng.integers(1, 50, n - 1),
                          rng.integers(1, 50, extra)])
    return src.astype(np.int32), dst.astype(np.int32), off.astype(np.int32)


def prefix_rows(seed):
    # reads and their reverse complements interleaved (slot ^ 1), with
    # exact duplicates and prefixes of earlier reads
    rng = np.random.default_rng(seed)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, size=400))
    reads = []
    for i in range(70):
        r = rng.random()
        if reads and r < 0.15:
            reads.append(reads[rng.integers(0, len(reads))])
        elif reads and r < 0.35:
            s = reads[rng.integers(0, len(reads))]
            reads.append(s[: rng.integers(16, len(s) + 1)])
        else:
            p = int(rng.integers(0, 340))
            reads.append(genome[p: p + int(rng.integers(16, 61))])
    comp = str.maketrans("ACGT", "TGCA")
    return [x for s in reads for x in (s, s.translate(comp)[::-1])]


CHAIN_CASES = [(0, 300, 40), (1, 513, 10), (2, 64, 200)]
"""

_BODY = r"""
from alga_tpu_torch.core import packing
from alga_tpu_torch.graph.overlap_graph import OverlapGraph
from alga_tpu_torch.parallel import sharded_simplify as ss
from alga_tpu_torch.parallel.sharded_contract import chain_terminals_sharded
from alga_tpu_torch.parallel.sharded_gcps import (gcps_graph_sharded,
                                                  local_block)
from alga_tpu_torch.parallel.sharded_preprocess import mark_prefix_sharded

def edges(g):
    return (g.src.tolist(), g.dst.tolist(), g.offset.tolist())

for seed in (7, 3, 11, 0):
    seqs = overlapping_reads(seed or 7)[:185 if seed == 0 else None]
    packed, lengths = packing.pack_strings(seqs)
    n = len(seqs)
    kw = {}
    if seed == 11:
        rng = np.random.default_rng(11)
        kw = dict(align_from=rng.random(n) < 0.6, align_to=rng.random(n) < 0.6)
    out[f"gcps{seed}"] = edges(gcps_graph_sharded(mesh, packed, lengths, n, 20,
                                                  500, 35, **kw))
out["shard"] = tuple(local_block(mesh, packed, n)[0].shape)

rows = prefix_rows(5)
packed, lengths = packing.pack_strings(rows)
n = len(rows)
npad, per = mesh_mod.block(mesh, n, 2)
pk = np.zeros((npad, packed.shape[1]), np.uint32)
pk[:n] = packed
ln = np.zeros(npad, np.int64)
ln[:n] = lengths
vd = np.arange(npad) < n
block = torch.from_numpy(pk[rank * per:(rank + 1) * per].view(np.int32))
out["mark"] = mark_prefix_sharded(mesh, block, ln, vd).tolist()

class Batch:
    def __init__(self, n):
        self.valid = np.ones(n, dtype=bool)
        self.lengths = np.full(n, 100, dtype=np.int32)
    def avg_read_length(self):
        v = self.valid
        return float(self.lengths[v].mean()) if v.any() else 0.0

graph = lambda seed, n, c=60: OverlapGraph.from_edges(
    n, assembly_like_edges(np.random.default_rng(seed), n, c))
for seed in (0, 1):
    g, cut = ss.cut_triangles_sharded(mesh, graph(seed, 801), 250)
    out[f"tri{seed}"] = (edges(g), cut)
out["retain"] = edges(ss.retain_min_offset_sharded(
    mesh, OverlapGraph(300, *random_edges(5, 300, 2000))))
for seed in (2, 3):
    g = graph(100 + seed, 640, 40).retain_min_offset()
    out[f"dangling{seed}"] = sorted(set(ss.collect_dangling_sharded(
        mesh, g, 80, threads=6)))
for seed in (4, 5):
    b = Batch(520)
    g = ss.simplify_graph_old_sharded(mesh, graph(200 + seed, 520, 35), b,
                                      250, 250, threads=6)
    out[f"simplify{seed}"] = (edges(g), b.valid.tolist())
for seed in (6, 7, 8):
    g = graph(300 + seed, 480, 32).retain_min_offset()
    out[f"mst{seed}"] = edges(ss.mst_pass_sharded(mesh, g, 80, threads=6))
for seed, n, extra in CHAIN_CASES + [(3, 200, 30)]:
    out[f"chain{seed}"] = [x.tolist() for x in chain_terminals_sharded(
        mesh, OverlapGraph(n, *chain_graph_arrays(seed, n, extra)))]
ids = np.arange(12, dtype=np.int32)
out["cycle"] = [x.tolist() for x in chain_terminals_sharded(
    mesh, OverlapGraph(12, ids, np.roll(ids, -1), np.full(12, 7, np.int32)))]
"""


def G():
    ns = gen()
    exec(GEN_GRAPHS, ns)
    return ns


@pytest.fixture(scope="module", params=[1, 2, 3], ids=["d1", "d2", "d3"])
def ranks(request, tmp_path_factory):
    d = request.param
    return d, run_ranks(tmp_path_factory.mktemp(f"sharded{d}"), d,
                        GEN_GRAPHS + _BODY)


@pytest.fixture(scope="module")
def mesh8():
    return jmesh.make_mesh(8)


def _edges(g):
    return (g.src.tolist(), g.dst.tolist(), g.offset.tolist())


@pytest.mark.parametrize("seed", [7, 3, 11, 0],
                         ids=["s7", "s3", "masks", "ragged"])
def test_gcps_sharded_matches_alga_tpu_and_single_device(ranks, mesh8, seed):
    """n = 186 as in alga_tpu's tests (ragged against its 8 devices), and
    n = 185, ragged against 2 and 3 ranks."""
    d, outs = ranks
    seqs = gen()["overlapping_reads"](seed or 7)[:185 if seed == 0 else None]
    packed, lengths = packing.pack_strings(seqs)
    n = len(seqs)
    assert n == (185 if seed == 0 else 186)
    kw = {}
    if seed == 11:
        rng = np.random.default_rng(11)
        kw = dict(align_from=rng.random(n) < 0.6, align_to=rng.random(n) < 0.6)
    want = _edges(gcps_graph_sharded(mesh8, packed, lengths, n, 20, 500, 35,
                                     **kw))
    single = tprefsuf.build_gcps_graph(packed, lengths, n, 20, 500, 35,
                                       device="cpu", **kw)
    assert _edges(single.sorted_by_src_offset()) == want
    assert len(want[0]) > 0
    for o in outs:
        assert o[f"gcps{seed}"] == want


def test_store_shard_per_rank(ranks):
    """Each rank holds its block of ceil(n / d) rows, never the store."""
    d, outs = ranks
    for o in outs:
        assert o["shard"] == (-(-185 // d), 3)


def test_mark_prefix_sharded_matches_alga_tpu(ranks):
    """The marks equal alga_tpu's host pass (which its own tests hold
    equal to its sharded pass) and the port's."""
    d, outs = ranks
    rows = G()["prefix_rows"](5)
    want = fastx.mark_prefix_reads(SeqBatch.from_strings(rows))
    assert 0 < want.sum() < len(rows)
    np.testing.assert_array_equal(
        tfastx.mark_prefix_reads(TSeqBatch.from_strings(rows)), want)
    for o in outs:
        assert o["mark"][:len(rows)] == want.tolist()
        assert not any(o["mark"][len(rows):])


def test_mark_prefix_sharded_short_reads_raise():
    """A read under 16 bases cannot be range-partitioned by its first 16
    bases: a named error, raised before any exchange."""
    from alga_tpu_torch.parallel.mesh import Mesh
    mesh = Mesh(None, 0, 1, torch.device("cpu"))
    block = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(tsp.ShortReadError, match="16 bases"):
        tsp.mark_prefix_sharded(mesh, block, np.array([20, 20, 12, 12]),
                                np.ones(4, bool))


def _graph(seed, n, nchains=60):
    return OverlapGraph.from_edges(n, G()["assembly_like_edges"](
        np.random.default_rng(seed), n, nchains))


@pytest.mark.parametrize("seed", [0, 1])
def test_cut_triangles_sharded_matches_alga_tpu(ranks, mesh8, seed):
    d, outs = ranks
    g = _graph(seed, 801)
    gh, nh = simplify.cut_triangles(g.copy(), 250)
    gs, ns = cut_triangles_sharded(mesh8, g.copy(), 250)
    assert ns == nh > 0 and _edges(gs) == _edges(gh)
    for o in outs:
        assert o[f"tri{seed}"] == (_edges(gh), nh)


def test_retain_min_offset_sharded_matches_alga_tpu(ranks):
    d, outs = ranks
    g = OverlapGraph(300, *G()["random_edges"](5, 300, 2000))
    want = _edges(g.retain_min_offset().sorted_by_src_offset())
    for o in outs:
        assert o["retain"] == want


@pytest.mark.parametrize("seed", [2, 3])
def test_dangling_collection_matches_alga_tpu(ranks, seed):
    d, outs = ranks
    n = 640
    g = _graph(100 + seed, n, 40).retain_min_offset()
    adj = simplify._Adjacency(g, order="neighbor")
    want = set()
    for s in range(workload_covered(n, 10 * 6)):
        if len(adj.out[s]) >= 2:
            want.update(simplify._dangling_edges_from_seed(adj.out, s, 80))
    assert want
    for o in outs:
        assert o[f"dangling{seed}"] == sorted(want)


class _Batch:
    def __init__(self, n):
        self.valid = np.ones(n, dtype=bool)
        self.lengths = np.full(n, 100, dtype=np.int32)

    def avg_read_length(self):
        v = self.valid
        return float(self.lengths[v].mean()) if v.any() else 0.0


@pytest.mark.parametrize("seed", [4, 5])
def test_simplify_graph_old_sharded_matches_alga_tpu(ranks, seed):
    d, outs = ranks
    bh = _Batch(520)
    gh = simplify.simplify_graph_old(_graph(200 + seed, 520, 35), bh, 250,
                                     250, threads=6)
    for o in outs:
        assert o[f"simplify{seed}"] == (_edges(gh), bh.valid.tolist())


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_mst_pass_sharded_matches_alga_tpu(ranks, seed):
    d, outs = ranks
    g = _graph(300 + seed, 480, 32).retain_min_offset()
    gh = simplify.remove_short_parallel_paths(g.copy(), 80, threads=6)
    want = _edges(gh.sorted_by_src_offset())
    assert len(want[0]) < g.num_edges          # pops happened
    assert _edges(tnative.mst_pass(TGraph(g.n, g.src, g.dst, g.offset),
                                   80, 6)) == want
    for o in outs:
        assert o[f"mst{seed}"] == want


@pytest.mark.parametrize("case", [0, 1, 2])
def test_chain_terminals_sharded_matches_oracle(ranks, case):
    d, outs = ranks
    seed, n, extra = G()["CHAIN_CASES"][case]
    g = OverlapGraph(n, *G()["chain_graph_arrays"](seed, n, extra))
    chain_h, term_h, rank_h, wsum_h = np_chain_terminals(g)
    tg = TGraph(n, g.src, g.dst, g.offset)
    for a, b in zip(tsc.np_chain_terminals(tg), (chain_h, term_h, rank_h,
                                                 wsum_h)):
        np.testing.assert_array_equal(a, b)
    ok = chain_h & (rank_h >= 0)
    for o in outs:
        chain, term, rank, wsum = (np.asarray(x) for x in o[f"chain{seed}"])
        np.testing.assert_array_equal(chain, chain_h)
        np.testing.assert_array_equal(rank >= 0, rank_h >= 0)
        for a, b in ((term, term_h), (rank, rank_h), (wsum, wsum_h)):
            np.testing.assert_array_equal(a[ok], b[ok])


def test_chain_terminals_pure_cycle(ranks):
    d, outs = ranks
    for o in outs:
        chain, _term, rank, _wsum = o["cycle"]
        assert all(chain) and rank == [-1] * 12


def test_contraction_seeded_by_chain_mask_is_identical(ranks):
    d, outs = ranks
    g = TGraph(200, *G()["chain_graph_arrays"](3, 200, 30))
    mask = np.asarray(outs[-1]["chain3"][0])
    a = tcontract.ContractedGraph(g)
    a.contract_path_nodes(10**9)
    b = tcontract.ContractedGraph(g)
    b.contract_path_nodes(10**9, path_node=mask)
    ga, gb = a.to_overlap_graph(), b.to_overlap_graph()
    assert _edges(ga) == _edges(gb) and a.cedges == b.cedges


def test_oracle_matches_alga_tpu():
    """utils/oracle flags the same edges as alga_tpu's: the GCPS graph's
    edges hold, and edges with a shifted offset or a wrong dst fail."""
    from alga_tpu.utils import oracle
    from alga_tpu_torch.utils import oracle as toracle
    seqs = gen()["overlapping_reads"](7)
    packed, lengths = packing.pack_strings(seqs)
    g = tprefsuf.build_gcps_graph(packed, lengths, len(seqs), 20, 500, 35,
                                  device="cpu")
    rng = np.random.default_rng(1)
    bad = rng.random(g.num_edges) < 0.3
    off = np.where(bad, g.offset + 1, g.offset).astype(np.int32)
    dst = np.where(rng.random(g.num_edges) < 0.1, (g.dst + 5) % len(seqs),
                   g.dst).astype(np.int32)
    for gg in (OverlapGraph(g.n, g.src, g.dst, g.offset),
               OverlapGraph(g.n, g.src, dst, off)):
        want = oracle.check_olc_graph(gg, packed, lengths)
        got = toracle.check_olc_graph(TGraph(gg.n, gg.src, gg.dst, gg.offset),
                                      packed, lengths, device="cpu")
        np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
    toracle.assert_olc_graph_correct(TGraph(g.n, g.src, g.dst, g.offset),
                                     packed, lengths, device="cpu")


def test_visualize_matches_alga_tpu(tmp_path):
    """The three Graphviz dumps are byte-identical to alga_tpu's."""
    from types import SimpleNamespace

    from alga_tpu.utils import visualize
    from alga_tpu_torch.utils import visualize as tvisualize
    g = _graph(4, 200, 20)
    tg = TGraph(g.n, g.src, g.dst, g.offset)
    contigs = [SimpleNamespace(reads=[(int(a), 0), (int(b), 5)])
               for a, b in zip(g.src[:9], g.dst[:9])]
    for name, args, kw in (("write_whole_graph", (), dict(max_edges=50)),
                           ("write_contig_paths", (contigs,), {}),
                           ("write_component_view", (contigs,),
                            dict(max_edges=120))):
        getattr(visualize, name)(g, *args, str(tmp_path / "a.dot"), **kw)
        getattr(tvisualize, name)(tg, *args, str(tmp_path / "b.dot"), **kw)
        a = (tmp_path / "a.dot").read_bytes()
        assert a == (tmp_path / "b.dot").read_bytes() and a.count(b"->") > 5
