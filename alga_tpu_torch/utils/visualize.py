"""Graphviz export (ref src/Utils/GraphVisualizer.cpp): whole-graph dumps
and contig-focused views for debugging assemblies.

A copy of alga_tpu/utils/visualize.py, kept in step with it: the port
imports nothing of alga_tpu, whose package imports jax."""

from __future__ import annotations

from alga_tpu_torch.graph.overlap_graph import OverlapGraph

_PALETTE = ["red", "blue", "green", "orange", "purple", "brown", "cyan"]


def write_whole_graph(g: OverlapGraph, path: str, max_edges: int = 200_000) -> None:
    """ref GraphVisualizer::writeWholeGraph (GraphVisualizer.cpp:234-263)."""
    with open(path, "w") as f:
        f.write("digraph G {\n")
        for i, (s, d, o) in enumerate(zip(g.src.tolist(), g.dst.tolist(),
                                          g.offset.tolist())):
            if i >= max_edges:
                f.write(f'  // truncated at {max_edges} edges\n')
                break
            f.write(f'  {s} -> {d} [label="{o}"];\n')
        f.write("}\n")


def write_contig_paths(g: OverlapGraph, contigs, path: str) -> None:
    """Contig-focused view: each contig's read path in its own color
    (ref GraphVisualizer::writeInGraphvizFormat, :14-45)."""
    with open(path, "w") as f:
        f.write("digraph G {\n")
        for ci, ctg in enumerate(contigs):
            color = _PALETTE[ci % len(_PALETTE)]
            reads = [r for r, _ in ctg.reads]
            for a, b in zip(reads, reads[1:]):
                f.write(f'  {a} -> {b} [color={color}];\n')
        f.write("}\n")


class FAU:
    """Union-find with path compression + weighted union (ref FAU.h:9-46;
    its only reference consumer is GraphVisualizer's component selection,
    GraphVisualizer.cpp:101-135)."""

    def __init__(self, n: int):
        self.p = list(range(n))
        self.w = [1] * n

    def find(self, x: int) -> int:
        root = x
        p = self.p
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        if self.w[ra] < self.w[rb]:
            ra, rb = rb, ra
        self.p[rb] = ra
        self.w[ra] += self.w[rb]


def write_component_view(g: OverlapGraph, contigs, path: str,
                         max_edges: int = 100_000) -> None:
    """Contig-focused component dump (ref
    GraphVisualizer::writeInGraphvizFormat + createRelevantNodes,
    GraphVisualizer.cpp:14-45,101-135,205-231): relevant nodes are contig
    endpoints and forks; weak components containing a relevant node are
    selected via union-find, their edges dumped, and each contig's read
    path drawn in its own color."""
    fau = FAU(g.n)
    for s, d in zip(g.src.tolist(), g.dst.tolist()):
        fau.union(s, d)

    outdeg = g.out_degrees()
    indeg = g.in_degrees()
    relevant = set()
    for ctg in contigs:
        reads = [r for r, _ in ctg.reads]
        if reads:
            relevant.add(reads[0])
            relevant.add(reads[-1])
    for v in range(g.n):
        if outdeg[v] >= 2 or indeg[v] >= 2:
            relevant.add(int(v))
    chosen = {fau.find(v) for v in relevant}

    with open(path, "w") as f:
        f.write("digraph G {\n")
        written = 0
        for s, d, o in zip(g.src.tolist(), g.dst.tolist(),
                           g.offset.tolist()):
            if fau.find(s) not in chosen:
                continue
            if written >= max_edges:
                f.write(f"  // truncated at {max_edges} edges\n")
                break
            f.write(f'  {s} -> {d} [label="{o}"];\n')
            written += 1
        for ci, ctg in enumerate(contigs):
            color = _PALETTE[ci % len(_PALETTE)]
            reads = [r for r, _ in ctg.reads]
            for a, b in zip(reads, reads[1:]):
                f.write(f'  {a} -> {b} [color={color}, penwidth=2];\n')
        f.write("}\n")
