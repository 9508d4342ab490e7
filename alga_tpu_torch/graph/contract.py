"""Path contraction on the simplified overlap graph.

Replaces the reference's `Graph::contractPath` splice-under-lock machinery
(ref: src/DataStructures/Graph.cpp:390-469) and the contraction pass
`GraphSimplifier::contractPathNodes` (ref: GraphSimplifier.cpp:823-958,
parallel variant :910-958).  A contracted edge (a→c) records the interior
(node, offset) hops so contig extraction can expand it back to bases and
contained reads (ref: Graph::getContractedEdgePath, ContigCreatorSinglePath
::addContractedPathToString).

By this stage the graph has shrunk drastically (chains dominate), so a
host-side sequential pass in canonical node order is both deterministic and
cheap; the heavy lifting happened in the device passes upstream.

A copy of alga_tpu/graph/contract.py, kept in step with it: the port
imports nothing of alga_tpu, whose package imports jax.
"""

from __future__ import annotations

import numpy as np

from alga_tpu_torch.graph.overlap_graph import OverlapGraph


class ContractedGraph:
    """Mutable adjacency + contracted-path map.

    Mutation semantics replicate the reference's `Graph` exactly so that
    downstream iteration order (and therefore contig creation order, which
    feeds the unstable filter sort) is byte-reproducible:
      * remove_edge: back-to-front swap-pop (ref Graph.cpp:96-119), and
        purges the contracted-path entry like removeDirectedEdge does;
      * add_edge_min: in-place min update or append (ref Graph.cpp:53-71);
      * retain_min_offset_inplace: per-node sort by (dst, offset) + keep
        first per dst (ref Graph.cpp:348-387) — the adjacency order in
        effect when contigs are walked (ref main.cpp:429).
    """

    def __init__(self, g: OverlapGraph):
        self.n = g.n
        gs = g.sorted_by_src_offset()
        self.adj: list[list[tuple[int, int]]] = [[] for _ in range(g.n)]
        for s, d, o in zip(gs.src.tolist(), gs.dst.tolist(), gs.offset.tolist()):
            self.adj[s].append((d, o))
        # cedges[a][c] = [(n1, w1), ..., (c, wk)] interior hops
        self.cedges: list[dict[int, list[tuple[int, int]]]] = [dict() for _ in range(g.n)]

    # ------------------------------------------------------------------

    def find_weight(self, a: int, b: int) -> int:
        for d, o in self.adj[a]:
            if d == b:
                return o
        return -1

    def contains_edge(self, a: int, b: int) -> bool:
        return any(d == b for d, _ in self.adj[a])

    def contains_edge_longer_or_equal(self, a: int, b: int, offset: int) -> bool:
        return any(d == b and o >= offset for d, o in self.adj[a])

    def remove_edge(self, a: int, b: int) -> bool:
        """removeDirectedEdge: back-to-front swap-pop (ref Graph.cpp:96-119);
        also drops the contracted-path entry (ref :98-102)."""
        self.cedges[a].pop(b, None)
        la = self.adj[a]
        removed = False
        p = len(la) - 1
        for i in range(len(la) - 1, -1, -1):
            if la[i][0] == b:
                la[i], la[p] = la[p], la[i]
                la.pop()
                p -= 1
                removed = True
        return removed

    def retain_min_offset_inplace(self) -> None:
        """ref Graph::retainOnlySmallestOffset: per-node sort by
        (dst, offset), keep first instance per dst."""
        for i in range(self.n):
            la = sorted(self.adj[i])
            out = []
            p = 0
            while p < len(la):
                out.append(la[p])
                p += 1
                while p < len(la) and la[p - 1][0] == la[p][0]:
                    p += 1
            self.adj[i] = out

    def add_edge_min(self, a: int, b: int, offset: int) -> None:
        """addDirectedEdge dedup+min semantics (ref Graph.cpp:53-71)."""
        if a == b:
            return
        for i, (d, o) in enumerate(self.adj[a]):
            if d == b:
                if offset < o:
                    self.adj[a][i] = (d, offset)
                return
        self.adj[a].append((b, offset))

    def path(self, a: int, b: int) -> list[tuple[int, int]]:
        """ref Graph::getContractedEdgePath (Graph.cpp:486-497)."""
        p = self.cedges[a].get(b)
        if p:
            return p
        w = self.find_weight(a, b)
        if w >= 0:
            return [(b, w)]
        return []

    # ------------------------------------------------------------------

    def contract_path(self, a: int, b: int, c: int, threshold: int) -> bool:
        """ref Graph::contractPath (Graph.cpp:390-469).  threshold =
        Params::MAX_OFFSET_PARALLEL_PATHS (raw, not %-scaled)."""
        if a == c:
            return False
        if len(self.adj[b]) != 1:
            return False
        wab = self.find_weight(a, b)
        if wab < 0:
            return False
        wbc = self.adj[b][0][1]
        wabc = wab + wbc

        exists_ac = self.contains_edge(a, c)
        if exists_ac and wabc >= threshold:
            return False
        if self.contains_edge_longer_or_equal(a, c, threshold):
            return False

        path_ab = self.cedges[a].pop(b, None) or [(b, wab)]
        path_bc = self.cedges[b].pop(c, None) or [(c, wbc)]

        self.remove_edge(a, c)        # purges old (a,c) path too
        self.cedges[a][c] = path_ab + path_bc
        self.remove_edge(a, b)
        # clearNode(b): V[b] and every contracted entry sourced at b
        # (ref Graph.cpp:197-207)
        self.adj[b] = []
        self.cedges[b] = dict()
        self.add_edge_min(a, c, wabc)
        return True

    def contract_path_nodes(self, threshold: int, path_node=None) -> int:
        """One contraction sweep (ref GraphSimplifier.cpp:910-958): absorb
        indeg-1/outdeg-1 chains into their anchoring predecessor's edge.
        Returns number of contractions.

        `path_node` optionally supplies the chain-node mask computed
        elsewhere (the sharded pointer-doubling discovery,
        parallel/sharded_contract.py); it must equal the host derivation
        below — the sweep itself is unchanged."""
        if path_node is None:
            indeg = np.zeros(self.n, dtype=np.int64)
            outdeg = np.zeros(self.n, dtype=np.int64)
            for s in range(self.n):
                outdeg[s] = len(self.adj[s])
                for d, _ in self.adj[s]:
                    indeg[d] += 1
            path_node = (indeg == 1) & (outdeg == 1)

        done = 0
        for i in range(self.n):
            if path_node[i]:
                continue
            j = 0
            while j < len(self.adj[i]):
                b = self.adj[i][j][0]
                if not path_node[b] or len(self.adj[b]) != 1:
                    j += 1
                    continue
                c = self.adj[b][0][0]
                if i == c:
                    j += 1
                    continue
                if self.contract_path(i, b, c, threshold):
                    done += 1
                    # retry same slot (ref :947 j--)
                else:
                    j += 1
        return done

    # ------------------------------------------------------------------

    def to_overlap_graph(self) -> OverlapGraph:
        src, dst, off = [], [], []
        for a, la in enumerate(self.adj):
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

    def set_edges(self, g: OverlapGraph) -> None:
        """Replace adjacency (contracted-path map kept; stale entries are
        only ever queried for existing edges, like the reference)."""
        self.adj = [[] for _ in range(self.n)]
        gs = g.sorted_by_src_offset()
        for s, d, o in zip(gs.src.tolist(), gs.dst.tolist(), gs.offset.tolist()):
            self.adj[s].append((d, o))


def cut_triangles_inplace(cg: ContractedGraph, max_offset: int) -> int:
    """cutNonAndWeaklyMetricTriangles on the mutable adjacency: two-phase —
    collect (node-id, slot ascending, ref GraphSimplifier.cpp:284-348), then
    remove in collection order with swap-pop semantics."""
    to_remove = []
    for i in range(cg.n):
        dst = {}
        for a, w1 in cg.adj[i]:
            for b, w2 in cg.adj[a]:
                d = w1 + w2
                if b not in dst or d < dst[b]:
                    dst[b] = d
        for b, w in cg.adj[i]:
            if w > max_offset:
                continue
            if dst.get(b) == w:
                to_remove.append((i, b))
    for a, b in to_remove:
        cg.remove_edge(a, b)
    return len(to_remove)


def simplify_contract(cg: ContractedGraph, max_offset_parallel_paths: int,
                      log=lambda *a: None, chain_mask_fn=None) -> None:
    """Second-stage simplification (ref GraphSimplifier::simplifyGraph,
    GraphSimplifier.cpp:49-82): alternate triangle cutting and path
    contraction until no contraction happens.

    `chain_mask_fn(cg)` optionally computes the indeg-1/outdeg-1 chain
    mask externally (the sharded pointer-doubling discovery in
    parallel/sharded_contract.py) — it must equal the host derivation."""
    while True:
        ncut = cut_triangles_inplace(cg, max_offset_parallel_paths)
        mask = chain_mask_fn(cg) if chain_mask_fn is not None else None
        ncontr = cg.contract_path_nodes(max_offset_parallel_paths,
                                        path_node=mask)
        log(f"simplify_contract: cut {ncut}, contracted {ncontr}")
        if ncontr == 0:
            break
