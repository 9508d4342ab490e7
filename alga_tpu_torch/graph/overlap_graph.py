"""Overlap graph as flat COO/CSR arrays.

Replaces the reference's `Graph` of per-node `vector<pair<node,offset>>`
adjacency mutated under striped mutexes (ref:
include/DataStructures/Graph.h:46-365, src/DataStructures/Graph.cpp) with
immutable-ish numpy edge arrays: every pass is a whole-graph vectorized
transformation instead of lock-guarded pointwise surgery.

Orientation: edge (src → dst, offset) means dst's prefix overlaps src's
suffix; dst's sequence starts `offset` bases into src.  Overlap length =
len(src) - offset (ref: Read::calculateReadOverlap, Read.h:84-87).

A copy of alga_tpu/graph/overlap_graph.py, kept in step with it: the port
imports nothing of alga_tpu, whose package imports jax.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class OverlapGraph:
    n: int
    src: np.ndarray     # int32[E]
    dst: np.ndarray     # int32[E]
    offset: np.ndarray  # int32[E]

    # ------------------------------------------------------------------

    @staticmethod
    def empty(n: int) -> "OverlapGraph":
        z = np.zeros(0, dtype=np.int32)
        return OverlapGraph(n, z.copy(), z.copy(), z.copy())

    @staticmethod
    def from_edges(n: int, edges) -> "OverlapGraph":
        """edges: iterable of (src, dst, offset)."""
        e = np.asarray(list(edges), dtype=np.int32).reshape(-1, 3)
        return OverlapGraph(n, e[:, 0].copy(), e[:, 1].copy(), e[:, 2].copy())

    @property
    def num_edges(self) -> int:
        return len(self.src)

    def copy(self) -> "OverlapGraph":
        return OverlapGraph(self.n, self.src.copy(), self.dst.copy(), self.offset.copy())

    def edge_set(self) -> set:
        return set(zip(self.src.tolist(), self.dst.tolist(), self.offset.tolist()))

    # ------------------------------------------------------------------

    def retain_min_offset(self) -> "OverlapGraph":
        """Dedup multi-edges keeping the smallest offset per (src, dst)
        (ref: Graph::retainOnlySmallestOffset, Graph.cpp:348-387)."""
        if self.num_edges == 0:
            return self
        order = np.lexsort((self.offset, self.dst, self.src))
        s, d, o = self.src[order], self.dst[order], self.offset[order]
        first = np.ones(len(s), dtype=bool)
        first[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
        return OverlapGraph(self.n, s[first], d[first], o[first])

    def reverse(self) -> "OverlapGraph":
        """Edge direction flip (ref: Graph::reverseGraphInPlace)."""
        return OverlapGraph(self.n, self.dst.copy(), self.src.copy(), self.offset.copy())

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n).astype(np.int64)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.n).astype(np.int64)

    def sorted_by_src_offset(self) -> "OverlapGraph":
        """Edges sorted by (src, offset, dst) — the canonical order used by
        simplification passes (ref: Graph::sortEdgesByIncreasingOffset)."""
        order = np.lexsort((self.dst, self.offset, self.src))
        return OverlapGraph(self.n, self.src[order], self.dst[order], self.offset[order])

    def csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(indptr int64[n+1], dst, offset) with edges sorted by
        (src, offset, dst)."""
        g = self.sorted_by_src_offset()
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(np.bincount(g.src, minlength=self.n), out=indptr[1:])
        return indptr, g.dst, g.offset

    def remove_edges_mask(self, remove: np.ndarray) -> "OverlapGraph":
        keep = ~remove
        return OverlapGraph(self.n, self.src[keep], self.dst[keep], self.offset[keep])

    def degree_stats(self) -> dict:
        """Degree histogram summary (ref Graph::writeBasicStatistics,
        Graph.cpp:973-1007 — short-circuited in the reference; live here)."""
        outd = self.out_degrees()
        ind = self.in_degrees()
        return {
            "edges": int(self.num_edges),
            "nodes_with_out": int((outd > 0).sum()),
            "nodes_with_in": int((ind > 0).sum()),
            "max_out_degree": int(outd.max()) if self.n else 0,
            "max_in_degree": int(ind.max()) if self.n else 0,
            "avg_out_degree": float(outd.mean()) if self.n else 0.0,
            "forks": int((outd >= 2).sum()),
            "merges": int((ind >= 2).sum()),
        }

    def isolated_nodes(self) -> np.ndarray:
        """bool[n]: nodes with neither in- nor out-edges
        (ref: Global::removeIsolatedReads, Global.cpp:61-76)."""
        has = np.zeros(self.n, dtype=bool)
        has[self.src] = True
        has[self.dst] = True
        return ~has
