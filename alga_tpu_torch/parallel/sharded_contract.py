"""Chain discovery for path contraction over the mesh, by pointer doubling
(port of alga_tpu/parallel/sharded_contract.py).

For every indeg-1/outdeg-1 chain node of the simplified graph, in
O(log N) synchronized rounds:

    terminal[i]  the first non-chain node reached by following the unique
                 out-edges from i,
    rank[i]      the number of hops to it,
    wsum[i]      the total offset on the way.

The node table (ptr, wsum, rank, active) is block-sharded by node id;
each round every active row fetches the row its pointer names from that
row's home rank (parallel/mesh.fetch_rows) and folds it in.  Pure cycles
of chain nodes never reach a terminal and get rank -1; the reference
never contracts them either (contraction starts only at non-chain
anchors, ref GraphSimplifier.cpp:910-958).

The host half (graph/contract.ContractedGraph.contract_path_nodes) then
applies the order-sensitive splices, seeded with the chain mask.
"""

from __future__ import annotations

import numpy as np
import torch

from alga_tpu_torch.graph.overlap_graph import OverlapGraph
from alga_tpu_torch.parallel import mesh as mesh_mod


def _chains(g: OverlapGraph, m: int):
    """(chain bool[m], succ, wsucc) over m >= n node slots: chain nodes,
    and the unique out-edge of every out-degree-1 node."""
    outdeg = np.bincount(g.src, minlength=m)
    indeg = np.bincount(g.dst, minlength=m)
    chain = (outdeg == 1) & (indeg == 1)
    succ = np.zeros(m, dtype=np.int32)
    wsucc = np.zeros(m, dtype=np.int32)
    sel = (outdeg == 1)[g.src]
    succ[g.src[sel]] = g.dst[sel]
    wsucc[g.src[sel]] = g.offset[sel]
    return chain, succ, wsucc


def chain_terminals_sharded(mesh, g: OverlapGraph):
    """(chain bool[n], terminal int32[n], rank int32[n], wsum int32[n]),
    the same on every rank; terminal, rank and wsum mean something for
    chain nodes only, and nodes on pure chain cycles get rank -1."""
    n = g.n
    npad, per = mesh_mod.block(mesh, n)
    chain, succ, wsucc = _chains(g, npad)
    ids = np.arange(npad, dtype=np.int64)
    ptr0 = np.where(chain, succ, ids)
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    tab = np.stack([ptr0, np.where(chain, wsucc, 0), chain,
                    chain & chain[ptr0]], axis=1)[rows]
    tab_l = torch.from_numpy(tab.astype(np.int64)).to(mesh.device)
    for _ in range(max(1, int(np.ceil(np.log2(max(npad, 2)))) + 1)):
        act = tab_l[:, 3].nonzero()[:, 0]
        t = mesh_mod.fetch_rows(mesh, tab_l, tab_l[act, 0], per, "chain_rows")
        tab_l[act] = torch.stack([t[:, 0], tab_l[act, 1] + t[:, 1],
                                  tab_l[act, 2] + t[:, 2], t[:, 3]], dim=1)
        if mesh_mod.all_sum(mesh, int(tab_l[:, 3].sum())) == 0:
            break
    out = mesh_mod.gather_all(mesh, tab_l, "chain_table").cpu().numpy()[:n]
    rank = out[:, 2].astype(np.int32)
    rank[out[:, 3] > 0] = -1             # pure chain cycles never converge
    return (chain[:n].copy(), out[:, 0].astype(np.int32), rank,
            out[:, 1].astype(np.int32))


def np_chain_terminals(g: OverlapGraph):
    """Host oracle: the same outputs by sequential walks."""
    n = g.n
    chain, succ, wsucc = _chains(g, n)
    terminal = np.arange(n, dtype=np.int32)
    rank = np.zeros(n, dtype=np.int32)
    wsum = np.zeros(n, dtype=np.int32)
    for i in np.flatnonzero(chain):
        x, r, w = i, 0, 0
        while chain[x]:
            w += int(wsucc[x])
            x = int(succ[x])
            r += 1
            if x == i:          # pure cycle
                r = -1
                break
        terminal[i] = x
        rank[i] = r
        wsum[i] = w
    return chain, terminal, rank, wsum
