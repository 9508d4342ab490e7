"""Contig extraction by unambiguous path walking on the contracted graph.

Ref: src/ContigCreators/ContigCreatorSinglePath.cpp.  Without paired-end
reliable-predecessor marks every fork (or chain end) terminates the contig
(canBeNextStepCandidate returns false unless the (node, predecessor) pair
was marked — ref :230-241), so for unpaired input a contig is exactly one
contracted edge expanded to bases.  With paired input, chains of contracted
edges supported by >= min_paired_connections read pairs are walked through
(ref :268-415).

A copy of alga_tpu/contig/walk.py, kept in step with it: the port
imports nothing of alga_tpu, whose package imports jax.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from alga_tpu_torch.core.seqbatch import SeqBatch
from alga_tpu_torch.graph.contract import ContractedGraph


@dataclass
class Contig:
    cid: int
    seq: str                 # bases (pre-consensus: walked string)
    # (read_id, offset_from_previous); first entry has offset -1
    # (ref ContigCreatorSinglePath.cpp:134)
    reads: list = field(default_factory=list)
    ends_in_fork: bool = False

    def __len__(self):
        return len(self.seq)


def _expand_path(cg: ContractedGraph, batch: SeqBatch, a: int, b: int,
                 out_parts: list, reads_in_contig: list) -> None:
    """Append the contracted path a→b to the contig string and read list
    (ref addContractedPathToString, ContigCreatorSinglePath.cpp:244-266):
    for each hop (node, offset), append `offset` leading bases of the
    current head read, then advance."""
    head = a
    for node, offset in cg.path(a, b):
        reads_in_contig.append((node, offset))
        if offset > 0:
            out_parts.append(batch.sequence(head)[:offset])
        head = node


def mark_reliable_predecessors(cg: ContractedGraph, batch: SeqBatch,
                               paired: bool, avg_read_length: float,
                               min_paired_connections: int = 5,
                               max_insert_size: int = 1000) -> dict:
    """reliable_predecessors[node] = set of predecessors d such that the
    contracted edges (d→node) and (node→successor) share enough paired
    reads (ref markReliablePredecessorsByPairedConnections, :268-415)."""
    if not paired:
        return {}
    min_edge_len = int(avg_read_length) * 2

    # reverse adjacency
    grev: dict[int, list] = {}
    for a in range(cg.n):
        for d, o in cg.adj[a]:
            grev.setdefault(d, []).append((a, o))

    reliable: dict[int, set] = {}
    for a in range(cg.n):
        if a not in grev:
            continue
        if not (len(cg.adj[a]) == 1 and cg.adj[a][0][1] >= min_edge_len
                and len(grev[a]) >= 1):
            continue
        b = cg.adj[a][0][0]
        edge_ab = cg.path(a, b)
        # reads at the beginning of edge (a,b), within insert size
        beg_of_ab = set()
        dst = 0
        for node, off in edge_ab:
            if dst > max_insert_size:
                break
            dst += off
            beg_of_ab.add(node)
        for d, length in grev[a]:
            if length < min_edge_len:
                continue
            edge_da = list(cg.path(d, a))
            dst = 0
            cnt = 0
            for node, off in reversed(edge_da):
                if dst > max_insert_size:
                    break
                dst += off
                paired_id = int(batch.paired_id(np.array([node]))[0])
                paired_rc = paired_id ^ 1
                if paired_id in beg_of_ab or paired_rc in beg_of_ab:
                    cnt += 1
            if cnt >= min_paired_connections:
                reliable.setdefault(a, set()).add(d)
    return reliable


def get_all_contigs(cg: ContractedGraph, batch: SeqBatch,
                    min_output_length: int,
                    reliable: dict | None = None) -> list[Contig]:
    """Parallel-walk equivalent, canonical node order
    (ref getAllContigs + getContigOmitShortCyclesFrom, :21-210)."""
    reliable = reliable or {}
    contigs: list[Contig] = []
    next_id = 0

    def next_candidates(predecessor: int, p: int):
        if p in reliable and predecessor in reliable[p]:
            return list(cg.adj[p])
        return []

    for beg in range(cg.n):
        if not batch.valid[beg] or len(cg.adj[beg]) == 0:
            continue
        for p0, offset0 in cg.adj[beg]:
            parts: list[str] = []
            reads_in_contig = [(beg, -1)]
            was = {beg}
            predecessor = beg
            p = p0
            _expand_path(cg, batch, beg, p, parts, reads_in_contig)
            was.add(p)

            cands = next_candidates(predecessor, p)
            can_be_next = len(cands)
            if can_be_next == 1:
                nxt = cands[0][0]
                _expand_path(cg, batch, p, nxt, parts, reads_in_contig)
                predecessor, p = p, nxt

            while can_be_next == 1:
                was.add(p)
                cands = next_candidates(predecessor, p)
                can_be_next = len(cands)
                if can_be_next == 1:
                    nxt = cands[0][0]
                    _expand_path(cg, batch, p, nxt, parts, reads_in_contig)
                    predecessor, p = p, nxt
                if p == -1 or p in was:
                    break

            parts.append(batch.sequence(p))
            s = "".join(parts)
            if len(s) >= min_output_length:
                contigs.append(Contig(next_id, s, reads_in_contig,
                                      ends_in_fork=can_be_next > 1))
                next_id += 1
    return contigs
