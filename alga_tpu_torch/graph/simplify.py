"""Graph simplification passes (ref: src/GraphSimplifiers/GraphSimplifier.cpp).

Pass inventory (reference default path, GCPS graphs — the non-GCPS-only
passes removeSmallOverlapEdges / mergeLength0Edges are skipped exactly as
ref GraphSimplifier.cpp:96-111 skips them):

  cut_triangles            — cutNonAndWeaklyMetricTriangles (:228-348):
                             remove direct edge i→b iff some 2-hop path
                             i→a→b has total weight == w(i,b), and
                             w(i,b) <= MAX_OFFSET_PARALLEL_PATHS.
                             Two-phase (collect on the frozen graph, then
                             delete) → vectorized wedge join here.
  remove_short_parallel_paths — removeShortParallelPaths /
                             tryToRemoveShortPathsMST (:351-518): per seed
                             with outdeg>=2, bounded-offset BFS collects
                             edges, deletes them, re-adds in (offset, edge)
                             order such that each node keeps at most one
                             incoming — directed-MST bubble popping.
                             Mutating + seed-order-dependent in the
                             reference; canonical order = seed id ascending.
  remove_dangling_branches — removeDanglingBranches (:577-808): from each
                             fork walk outdeg-1 chains to dead ends within
                             max offset; keep the longest branch (keep one
                             only if ALL branches dangle), remove the rest.
                             Read-only collection per seed → parallelizable;
                             edges dedup'd then removed (two-phase).
  remove_dangling_upper    — same on the reversed graph (:811-820).
  simplify_graph_old       — orchestration (:85-226).

A copy of alga_tpu/graph/simplify.py, kept in step with it: the port
imports nothing of alga_tpu, whose package imports jax.
"""

from __future__ import annotations

import numpy as np

from alga_tpu_torch.graph.overlap_graph import OverlapGraph
from alga_tpu_torch.utils.glibc_rand import GlibcRand, random_shuffle, workload_covered


def _pair_codes(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    return a.astype(np.int64) * np.int64(n) + b.astype(np.int64)


def cut_triangles(g: OverlapGraph, max_offset: int) -> tuple[OverlapGraph, int]:
    """Remove i→b where min 2-hop distance i→a→b equals w(i,b)
    (ref GraphSimplifier.cpp:284-348, equal-distance predicate :319)."""
    if g.num_edges == 0:
        return g, 0
    n = g.n
    gs = g.sorted_by_src_offset()
    src, dst, off = gs.src, gs.dst, gs.offset
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])

    # wedges: for each edge e1=(i,a,w1), expand over out-edges of a
    outdeg = (indptr[1:] - indptr[:-1])
    wedge_counts = outdeg[dst]
    total = int(wedge_counts.sum())
    if total == 0:
        return g, 0
    e1_idx = np.repeat(np.arange(len(src)), wedge_counts)
    starts = np.repeat(indptr[dst], wedge_counts)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(wedge_counts) - wedge_counts, wedge_counts)
    e2_idx = starts + within

    wi = src[e1_idx].astype(np.int64)
    wb = dst[e2_idx].astype(np.int64)
    wsum = off[e1_idx].astype(np.int64) + off[e2_idx].astype(np.int64)

    # min 2-hop distance per (i, b)
    codes = _pair_codes(wi, wb, n)
    order = np.argsort(codes, kind="stable")
    codes_s = codes[order]
    wsum_s = wsum[order]
    uniq_first = np.ones(len(codes_s), dtype=bool)
    uniq_first[1:] = codes_s[1:] != codes_s[:-1]
    group_ids = np.cumsum(uniq_first) - 1
    nmin = np.full(int(group_ids[-1]) + 1, np.iinfo(np.int64).max)
    np.minimum.at(nmin, group_ids, wsum_s)
    uniq_codes = codes_s[uniq_first]

    # test each direct edge against the 2-hop min of its (i, b) pair
    ecodes = _pair_codes(src.astype(np.int64), dst.astype(np.int64), n)
    pos = np.searchsorted(uniq_codes, ecodes)
    pos_c = np.clip(pos, 0, max(len(uniq_codes) - 1, 0))
    has2hop = uniq_codes[pos_c] == ecodes
    d2 = nmin[pos_c]
    remove = has2hop & (d2 == off) & (off <= max_offset)
    return gs.remove_edges_mask(remove), int(remove.sum())


class _Adjacency:
    """Mutable per-node adjacency for the sequential passes.

    order="offset": per-node (offset, dst) ascending (ref
    sortEdgesByIncreasingOffset, Graph.cpp:603-607).
    order="neighbor": per-node dst ascending — the canonical layout after
    retainOnlySmallestOffset (Graph.cpp:367-386) and after every
    reverseGraphInPlace round trip (Graph.cpp:926-971 appends by scanning
    source ids ascending), i.e. the layout the reference's dangling loop
    actually iterates."""

    def __init__(self, g: OverlapGraph, order: str = "offset"):
        self.n = g.n
        if order == "neighbor":
            order_idx = np.lexsort((g.offset, g.dst, g.src))
            src = g.src[order_idx]
            dst = g.dst[order_idx]
            off = g.offset[order_idx]
        else:
            gs = g.sorted_by_src_offset()
            src, dst, off = gs.src, gs.dst, gs.offset
        self.out = [[] for _ in range(g.n)]
        for s, d, o in zip(src.tolist(), dst.tolist(), off.tolist()):
            self.out[s].append((d, o))

    def remove_edge(self, a: int, b: int) -> bool:
        """Remove ALL (a,b) instances via back-to-front swap-pop — the exact
        reference layout semantics (Graph::removeDirectedEdge,
        Graph.cpp:96-119); the resulting neighbour ORDER feeds later
        passes' iteration order, so it must match."""
        la = self.out[a]
        removed = False
        p = len(la) - 1
        for i in range(len(la) - 1, -1, -1):
            if la[i][0] == b:
                la[i], la[p] = la[p], la[i]
                la.pop()
                p -= 1
                removed = True
        return removed

    def to_graph(self) -> OverlapGraph:
        src, dst, off = [], [], []
        for a, la in enumerate(self.out):
            for d, o in la:
                src.append(a)
                dst.append(d)
                off.append(o)
        return OverlapGraph(
            self.n,
            np.asarray(src, dtype=np.int32),
            np.asarray(dst, dtype=np.int32),
            np.asarray(off, dtype=np.int32),
        )


def remove_short_parallel_paths(g: OverlapGraph, max_offset: int,
                                threads: int = 6) -> OverlapGraph:
    """Directed-MST bubble popping (ref tryToRemoveShortPathsMST,
    GraphSimplifier.cpp:431-518), seeds processed in id order.  Seed
    coverage replicates the WorkloadManager quirk (blocks=50*T,
    GraphSimplifier.cpp:375): when 50*T divides n-1 the last node is
    never a seed."""
    adj = _Adjacency(g)
    for beg in range(workload_covered(adj.n, 50 * threads)):
        if len(adj.out[beg]) < 2:
            continue
        _mst_pop(adj, beg, max_offset)
    return adj.to_graph()


def _mst_pop(adj: _Adjacency, beg: int, max_offset: int) -> None:
    edges = []                    # ((a, b), offset) in discovery order
    neigh = [beg]
    dst = {beg: 0}
    was = set()
    i = 0
    while i < len(neigh):
        a = neigh[i]
        i += 1
        if a in was or dst[a] > max_offset:
            continue
        was.add(a)
        for b, offset in list(adj.out[a]):
            if b in dst and dst[b] < dst[a] + offset:
                continue
            dst[b] = dst[a] + offset
            edges.append(((a, b), offset))
            neigh.append(b)

    for (a, b), _ in edges:
        adj.remove_edge(a, b)

    edges.sort(key=lambda e: (e[1], e[0]))

    re_added = set()
    for (a, b), offset in edges:
        if b in re_added:
            continue
        adj.out[a].append((b, offset))
        re_added.add(b)


def _dangling_edges_from_seed(adj_out, seed: int, max_offset: int):
    """Collect edges of removable dangling branches from one fork
    (ref removeDanglingBranchesFromNode, GraphSimplifier.cpp:725-808)."""
    branch_ends = []
    par = {seed: seed}
    was = set()
    for v0, offset0 in adj_out[seed]:
        v = v0
        par[v] = seed          # unconditional overwrite (ref :739)
        was.add(v)
        offset = offset0
        while len(adj_out[v]) == 1:
            son = adj_out[v][0][0]
            if son in was:
                break
            was.add(son)
            par[son] = v
            offset += adj_out[v][0][1]
            v = son
            if offset > max_offset:
                break
        if len(adj_out[v]) == 0 and offset <= max_offset:
            branch_ends.append((offset, v))

    branch_ends.sort()
    # keep the longest branch only if ALL out-branches end dangling
    # (ref :782-784)
    div = 1 if len(branch_ends) == len(adj_out[seed]) else 0
    edges = []
    for offset, v in branch_ends[: len(branch_ends) - div]:
        while v != seed:
            edges.append((par[v], v))
            v = par[v]
    return edges


def remove_dangling_branches(g: OverlapGraph, max_offset: int,
                             threads: int = 6,
                             rng: GlibcRand | None = None) -> tuple[OverlapGraph, int]:
    """Two-phase: collect removable branch edges from forks on the frozen
    graph, dedup, then remove (ref GraphSimplifier.cpp:577-723).

    Bug-compatible reference quirks (both rand()-replayed):
      * seed coverage: WorkloadManager blocks=10*T (ref :641) can drop the
        last node as a seed,
      * the collected list is sort+unique'd then std::random_shuffle'd with
        the never-seeded glibc rand() stream (ref :658-678), and the
        removal WorkloadManager (blocks=3*T, ref :679) drops the LAST
        shuffled edge whenever 3*T divides len-1, and removes NOTHING from
        a single-edge list.
    Adjacency iterates neighbor-ascending (the post-retain / post-reverse
    canonical layout the reference's loop sees at t=1)."""
    adj = _Adjacency(g, order="neighbor")
    to_remove = set()
    for seed in range(workload_covered(adj.n, 10 * threads)):
        if len(adj.out[seed]) >= 2:
            for e in _dangling_edges_from_seed(adj.out, seed, max_offset):
                to_remove.add(e)
    lst = sorted(to_remove)
    if rng is not None:
        if len(lst) >= 2:
            random_shuffle(lst, rng)
        lst = lst[: workload_covered(len(lst), 3 * threads)]
    removed = 0
    for a, b in lst:
        if adj.remove_edge(a, b):
            removed += 1
    return adj.to_graph(), removed


def remove_dangling_upper_branches(g: OverlapGraph, max_offset: int,
                                   threads: int = 6,
                                   rng: GlibcRand | None = None) -> tuple[OverlapGraph, int]:
    rg, removed = remove_dangling_branches(g.reverse(), max_offset, threads,
                                           rng)
    return rg.reverse(), removed


def simplify_graph_old(g: OverlapGraph, batch,
                       max_offset_parallel_paths: int,
                       max_offset_dangling_branches: int,
                       log=lambda *a: None,
                       threads: int = 6) -> OverlapGraph:
    """Orchestration of the first simplification stage
    (ref GraphSimplifier::simplifyGraphOld, GraphSimplifier.cpp:85-226,
    GCPS default path).  `batch` is updated in place: isolated reads are
    invalidated mid-pass exactly where the reference calls
    removeIsolatedReads, because the average read length that scales the
    bubble/tip offsets is computed AFTER the triangle cut (ref :117, :179).
    """
    g, ncut = cut_triangles(g, max_offset_parallel_paths)
    log(f"triangle cut removed {ncut} edges")
    batch.valid &= ~g.isolated_nodes()
    avg_read_length = batch.avg_read_length()

    mopp_scaled = int(max_offset_parallel_paths * avg_read_length / 100.0)
    g = remove_short_parallel_paths(g, mopp_scaled, threads)
    log("short parallel paths removed")
    batch.valid &= ~g.isolated_nodes()
    g = g.retain_min_offset()

    modb_scaled = int(max_offset_dangling_branches * avg_read_length / 100.0)
    # the reference's rand() stream: never seeded (= seed 1), consumed only
    # by the dangling-removal shuffles, program-wide — fresh per assembly
    rng = GlibcRand(1)
    iterations = 0
    while True:
        g, r1 = remove_dangling_branches(g, modb_scaled, threads, rng)
        g, r2 = remove_dangling_upper_branches(g, modb_scaled, threads, rng)
        removed = r1 + r2
        iterations += 1
        log(f"dangling iteration {iterations}: removed {removed}")
        if removed == 0:
            break
        if iterations >= 16 and removed <= 30:
            # ref early break :212-214 (0-based i >= 15)
            break
    batch.valid &= ~g.isolated_nodes()
    # canonical (src, offset, dst) order on exit: the reference sorts right
    # after simplifyGraphOld anyway (retainOnlySmallestOffset, main.cpp:416),
    # and a deterministic exit order makes the native twin byte-comparable
    return g.sorted_by_src_offset()
