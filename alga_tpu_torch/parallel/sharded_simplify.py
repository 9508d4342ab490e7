"""Graph simplification over the mesh (port of
alga_tpu/parallel/sharded_simplify.py; ref
src/GraphSimplifiers/GraphSimplifier.cpp).

Every rank holds the whole host graph, as every process of alga_tpu does;
the device work is split by source node: rank r owns the edges whose src
lies in [r*per, (r+1)*per).  Every function returns the same result on
every rank, identical to the host passes of graph/simplify.py.

  * cut_triangles_sharded (ref :228-348): each edge (i, a, w1) goes to
    owner(a) as a query, which expands it against a's out-edges into
    wedges (i, b, w1 + w2); the wedges go to owner(i), which drops its
    edge (i, b, w) when the least wedge weight of (i, b) equals w and
    w <= max_offset (the predicate at :319).
  * retain_min_offset_sharded (ref Graph.cpp:348-387): purely local, as
    all edges of a source live on one rank.
  * collect_dangling_sharded (ref :725-808): the chain walks from all
    forks of a rank run together in synchronized steps, one remote fetch
    of node records (outdeg, next dst, next offset) per step; each seed's
    visited set and `par` links are sorted (seed, node) keys.  Every rank
    leaves a walk on the same all-reduced count of walking lanes.  The
    host then replays the reference's sort, unique, never-seeded glibc
    rand() shuffle and WorkloadManager truncation (ref :658-679).
  * mst_footprints_sharded / mst_pass_sharded (ref :351-518): each fork's
    footprint, ball(seed, max_offset) plus its out-neighbours, by label
    relaxation over the ranks; the host orders the seeds in waves of
    disjoint footprints and applies the pops with the native `mst_pops`
    (native/alga_host.cpp:246-336 shows the wave order is bit-identical
    to the sequential pass).
  * simplify_graph_old_sharded: the simplifyGraphOld orchestration
    (ref :85-226).

The exchanges are sized by the counts the ranks swap, so alga_tpu's edge,
seed, label and walk capacities, their retry loops and its host fallback
for out-degrees over 64 have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from alga_tpu_torch import native
from alga_tpu_torch.graph import simplify
from alga_tpu_torch.graph.device_join import _ragged_arange
from alga_tpu_torch.graph.device_scale import _lexsort
from alga_tpu_torch.graph.overlap_graph import OverlapGraph
from alga_tpu_torch.parallel import mesh as mesh_mod
from alga_tpu_torch.utils import timers
from alga_tpu_torch.utils.glibc_rand import (GlibcRand, random_shuffle,
                                             workload_covered)


def _owned_edges(mesh, g: OverlapGraph, per: int, order: str = "offset"):
    """(src, dst, off) int64 tensors of the edges this rank owns, in
    (src, offset, dst) order, or (src, dst, offset) order for
    order="neighbor"."""
    if order == "neighbor":
        idx = np.lexsort((g.offset, g.dst, g.src))
        src, dst, off = g.src[idx], g.dst[idx], g.offset[idx]
    else:
        gs = g.sorted_by_src_offset()
        src, dst, off = gs.src, gs.dst, gs.offset
    lo, hi = np.searchsorted(src, [mesh.rank * per, (mesh.rank + 1) * per])
    return tuple(torch.from_numpy(a[lo:hi].astype(np.int64)).to(mesh.device)
                 for a in (src, dst, off))


def _csr(src: torch.Tensor, base: int, per: int):
    """(outdeg, first edge) per node of this rank's range, for edges
    grouped by src."""
    outdeg = torch.bincount(src - base, minlength=per)
    return outdeg, torch.cumsum(outdeg, 0) - outdeg


def _gathered_graph(mesh, n: int, edges: torch.Tensor) -> OverlapGraph:
    """OverlapGraph of every rank's (src, dst, off) rows, canonical order."""
    e = mesh_mod.gather_all(mesh, edges, "simplify_graph").cpu()
    e = e.to(torch.int32).numpy()
    return OverlapGraph(n, e[:, 0].copy(), e[:, 1].copy(),
                        e[:, 2].copy()).sorted_by_src_offset()


# ---------------------------------------------------------------------------
# triangle cut and retain-min-offset


def cut_triangles_sharded(mesh, g: OverlapGraph,
                          max_offset: int) -> tuple[OverlapGraph, int]:
    """Sharded twin of simplify.cut_triangles: (graph, edges cut)."""
    if g.num_edges == 0:
        return g, 0
    npad, per = mesh_mod.block(mesh, g.n)
    base = mesh.rank * per
    src, dst, off = _owned_edges(mesh, g, per)
    outdeg, first = _csr(src, base, per)
    q = mesh_mod.route(mesh, dst // per, torch.stack([src, dst, off], dim=1),
                       "tri_queries")
    qa = q[:, 1] - base
    cnt = outdeg[qa]
    qi, rank = _ragged_arange(cnt, int(cnt.sum()))
    e2 = first[qa[qi]] + rank
    wedges = torch.stack([q[qi, 0], dst[e2], q[qi, 2] + off[e2]], dim=1)
    wr = mesh_mod.route(mesh, wedges[:, 0] // per, wedges, "tri_wedges")
    ukey, inv = torch.unique(wr[:, 0] * npad + wr[:, 1], return_inverse=True)
    wmin = torch.full_like(ukey, torch.iinfo(torch.int64).max).scatter_reduce(
        0, inv, wr[:, 2], "amin")
    ekey = src * npad + dst
    pos = torch.searchsorted(ukey, ekey).clamp(max=max(ukey.numel() - 1, 0))
    if ukey.numel():
        remove = (ukey[pos] == ekey) & (wmin[pos] == off) & (off <= max_offset)
    else:
        remove = torch.zeros_like(ekey, dtype=torch.bool)
    keep = ~remove
    out = _gathered_graph(mesh, g.n, torch.stack(
        [src[keep], dst[keep], off[keep]], dim=1))
    return out, mesh_mod.all_sum(mesh, int(remove.sum()))


def retain_min_offset_sharded(mesh, g: OverlapGraph) -> OverlapGraph:
    """Sharded twin of OverlapGraph.retain_min_offset (canonical order)."""
    if g.num_edges == 0:
        return g
    _, per = mesh_mod.block(mesh, g.n)
    src, dst, off = _owned_edges(mesh, g, per)
    order = _lexsort([off, dst, src])
    e = torch.stack([src, dst, off], dim=1)[order]
    first = torch.ones(e.shape[0], dtype=torch.bool, device=e.device)
    first[1:] = (e[1:, 0] != e[:-1, 0]) | (e[1:, 1] != e[:-1, 1])
    return _gathered_graph(mesh, g.n, e[first])


# ---------------------------------------------------------------------------
# dangling branches


def _walk_branches(mesh, tab_l, per: int, npad: int, seeds, nbr, bdst, bw,
                   max_offset: int):
    """Run all branch walks of this rank's seeds (lanes) in synchronized
    steps.  Returns (visited keys lane*npad + node, their par, branch ends
    as (lane, offset, node) rows)."""
    dev = seeds.device
    vkey = torch.zeros(0, dtype=torch.int64, device=dev)
    vpar = torch.zeros(0, dtype=torch.int64, device=dev)
    ends = []
    lanes_all = torch.arange(seeds.numel(), device=dev)
    bstart = torch.cumsum(nbr, 0) - nbr

    def lookup(keys):
        """(found, position) of each key among the visited keys."""
        if vkey.numel() == 0:
            return torch.zeros_like(keys, dtype=torch.bool), keys
        pos = torch.searchsorted(vkey, keys).clamp(max=vkey.numel() - 1)
        return vkey[pos] == keys, pos

    def insert(keys, pars):
        nonlocal vkey, vpar
        vkey, order = torch.sort(torch.cat([vkey, keys]))
        vpar = torch.cat([vpar, pars])[order]

    B = mesh_mod.all_max(mesh, int(nbr.max()) if nbr.numel() else 0)
    for k in range(B):
        lane = lanes_all[nbr > k]
        v = bdst[bstart[lane] + k]
        offv = bw[bstart[lane] + k]
        # unconditional was-add and par[v0] = seed (ref :737-740)
        key = lane * npad + v
        hit, pos = lookup(key)
        vpar[pos[hit]] = seeds[lane[hit]]
        insert(key[~hit], seeds[lane[~hit]])
        # the chain walk (ref :745-760)
        walk = torch.arange(lane.numel(), device=dev)
        last_odeg = torch.full_like(lane, -1)
        while mesh_mod.all_sum(mesh, walk.numel()):
            rec = mesh_mod.fetch_rows(mesh, tab_l, v[walk], per,
                                      "dangling_nodes")
            last_odeg[walk] = rec[:, 0]
            son = rec[:, 1]
            sk = lane[walk] * npad + son
            hit, _ = lookup(sk)
            step = (rec[:, 0] == 1) & ~hit
            insert(sk[step], v[walk][step])
            ws = walk[step]
            offv[ws] += rec[step, 2]
            v[ws] = son[step]
            walk = ws[offv[ws] <= max_offset]
        end = (last_odeg == 0) & (offv <= max_offset)
        ends.append(torch.stack([lane[end], offv[end], v[end]], dim=1))
    ends = (torch.cat(ends) if ends else
            torch.zeros((0, 3), dtype=torch.int64, device=dev))
    return vkey, vpar, ends


def collect_dangling_sharded(mesh, g: OverlapGraph, max_offset: int,
                             threads: int) -> list[tuple[int, int]]:
    """The removable dangling-branch edges (a, b) of every fork within the
    WorkloadManager coverage (blocks = 10*T, ref :641), before the dedup
    and shuffle: simplify._dangling_edges_from_seed over all seeds, with
    the adjacency in neighbour order.  Every rank returns the same list."""
    npad, per = mesh_mod.block(mesh, g.n)
    base = mesh.rank * per
    src, dst, off = _owned_edges(mesh, g, per, order="neighbor")
    outdeg, first = _csr(src, base, per)
    # node records: out-degree and the first out-edge (the only one that
    # a walk follows, from nodes of out-degree 1)
    has = outdeg > 0
    nx = torch.zeros((per, 2), dtype=torch.int64, device=mesh.device)
    nx[has] = torch.stack([dst, off], dim=1)[first[has]]
    tab_l = torch.cat([outdeg[:, None], nx], dim=1)
    ids = torch.arange(base, base + per, device=mesh.device)
    seeds = ids[(outdeg >= 2) & (ids < workload_covered(g.n, 10 * threads))]
    nbr = outdeg[seeds - base]
    eidx, rank = _ragged_arange(nbr, int(nbr.sum()))
    ei = first[seeds - base][eidx] + rank
    vkey, vpar, ends = _walk_branches(mesh, tab_l, per, npad, seeds, nbr,
                                      dst[ei], off[ei], int(max_offset))

    # the backwalk (ref :780-800): per seed its ends in (offset, node)
    # order, the longest dropped when every branch ends dangling, and the
    # par chain of each kept end back to the seed
    ends = ends[_lexsort([ends[:, 2], ends[:, 1], ends[:, 0]])]
    lane = ends[:, 0]
    last = torch.ones_like(lane, dtype=torch.bool)
    last[:-1] = lane[1:] != lane[:-1]
    nend = torch.bincount(lane, minlength=seeds.numel())
    kept = ~(last & (nend[lane] == nbr[lane]))
    lane, v = lane[kept], ends[kept, 2]
    stop = seeds[lane]
    edges = []
    while v.numel():
        p = vpar[torch.searchsorted(vkey, lane * npad + v)]
        edges.append(torch.stack([p, v], dim=1))
        go = p != stop
        lane, v, stop = lane[go], p[go], stop[go]
    e = mesh_mod.gather_all(mesh, torch.cat(edges) if edges else
                            torch.zeros((0, 2), dtype=torch.int64,
                                        device=mesh.device),
                            "dangling_edges")
    return [tuple(x) for x in e.tolist()]


def remove_dangling_sharded(mesh, g: OverlapGraph, max_offset: int,
                            threads: int,
                            rng: GlibcRand | None) -> tuple[OverlapGraph, int]:
    """Sharded twin of simplify.remove_dangling_branches: the collection
    over the mesh, then the host's dedup, shuffle and truncation."""
    lst = sorted(set(collect_dangling_sharded(mesh, g, max_offset, threads)))
    if rng is not None:
        if len(lst) >= 2:
            random_shuffle(lst, rng)
        lst = lst[: workload_covered(len(lst), 3 * threads)]
    if not lst:
        return g, 0
    key = np.asarray([a * np.int64(g.n) + b for a, b in lst], dtype=np.int64)
    ekey = g.src.astype(np.int64) * np.int64(g.n) + g.dst
    remove = np.isin(ekey, key)
    return g.remove_edges_mask(remove), int(remove.sum())


# ---------------------------------------------------------------------------
# MST bubble popping


def mst_footprints_sharded(mesh, g: OverlapGraph, seeds: np.ndarray,
                           max_offset: int):
    """(seed_idx int32[M], node int32[M]), the same on every rank: the
    footprint of each seed (seed_idx indexes `seeds`) by label relaxation.
    Labels (seed_idx, node, dist) live on owner(node); each round every
    improved label with dist <= max_offset expands through its node's
    out-edges, which are local, and the new labels go to the owners of
    their nodes, which keep the least dist per (seed_idx, node)."""
    npad, per = mesh_mod.block(mesh, g.n)
    base = mesh.rank * per
    dev = mesh.device
    src, dst, off = _owned_edges(mesh, g, per)
    outdeg, first = _csr(src, base, per)
    sd = torch.from_numpy(np.asarray(seeds, dtype=np.int64)).to(dev)
    mine = (sd // per == mesh.rank).nonzero()[:, 0]
    # (key = seed_idx * npad + node, dist) rows, sorted by key
    best = torch.stack([mine * npad + sd[mine], torch.zeros_like(mine)], 1)
    front = best
    while mesh_mod.all_sum(mesh, front.shape[0]):
        front = front[front[:, 1] <= max_offset]
        node = front[:, 0] % npad - base
        li, rank = _ragged_arange(outdeg[node], int(outdeg[node].sum()))
        e = first[node[li]] + rank
        new = torch.stack([front[li, 0] - front[li, 0] % npad + dst[e],
                           (front[li, 1] + off[e]).clamp(max=1 << 30)], 1)
        new = mesh_mod.route(mesh, (new[:, 0] % npad) // per, new,
                             "mst_labels")
        # merge: the least dist per key, existing labels first on ties
        m = torch.cat([best, new])
        tag = torch.cat([torch.zeros(best.shape[0], dtype=torch.int64,
                                     device=dev),
                         torch.ones(new.shape[0], dtype=torch.int64,
                                    device=dev)])
        order = _lexsort([m[:, 1] * 2 + tag, m[:, 0]])
        m, tag = m[order], tag[order]
        keep = torch.ones(m.shape[0], dtype=torch.bool, device=dev)
        keep[1:] = m[1:, 0] != m[:-1, 0]
        best = m[keep]
        front = m[keep & (tag == 1)]
    out = mesh_mod.gather_all(mesh, best[:, 0], "mst_best").cpu().numpy()
    return ((out // npad).astype(np.int32), (out % npad).astype(np.int32))


def mst_pass_sharded(mesh, g: OverlapGraph, mopp_scaled: int,
                     threads: int = 6, log=lambda *a: None) -> OverlapGraph:
    """removeShortParallelPaths with the footprints found over the mesh
    and the pops applied on the host in wave order; bit-identical to the
    host engines."""
    nrange = workload_covered(g.n, 50 * threads)
    outdeg = np.bincount(g.src, minlength=g.n)
    seeds = np.flatnonzero(outdeg[:nrange] >= 2).astype(np.int32)
    if len(seeds) == 0:
        return g.sorted_by_src_offset()
    sidx, snode = mst_footprints_sharded(mesh, g, seeds, mopp_scaled)

    # wave(i) = 1 + the largest wave of an earlier seed sharing a footprint
    # node (native/alga_host.cpp:307-318)
    order = np.argsort(sidx, kind="stable")
    sidx, snode = sidx[order], snode[order]
    node_wave = np.full(g.n, -1, dtype=np.int32)
    waves = np.zeros(len(seeds), dtype=np.int32)
    bnd = np.searchsorted(sidx, np.arange(len(seeds) + 1))
    for i in range(len(seeds)):
        nodes = snode[bnd[i]:bnd[i + 1]]
        w = int(node_wave[nodes].max(initial=-1)) + 1
        waves[i] = w
        node_wave[nodes] = w
    nw = int(waves.max()) + 1
    timers.bump("sharded_mst_waves", nw)
    log(f"[sharded] MST: {len(seeds)} seeds in {nw} waves "
        f"({len(sidx)} footprint labels)")
    wave_order = np.concatenate([seeds[waves == w] for w in range(nw)])
    if native.available():
        return native.mst_pops(g, wave_order, mopp_scaled)
    adj = simplify._Adjacency(g)
    for beg in wave_order:
        if len(adj.out[beg]) >= 2:
            simplify._mst_pop(adj, int(beg), mopp_scaled)
    return adj.to_graph()


# ---------------------------------------------------------------------------
# orchestration


def simplify_graph_old_sharded(mesh, g: OverlapGraph, batch,
                               max_offset_parallel_paths: int,
                               max_offset_dangling_branches: int,
                               threads: int = 6,
                               log=lambda *a: None) -> OverlapGraph:
    """simplifyGraphOld (ref :85-226) with the triangle cut, the MST
    footprints, retain-min-offset and the dangling walks on the mesh;
    the same edges and batch.valid as the host engines."""
    g, ncut = cut_triangles_sharded(mesh, g, max_offset_parallel_paths)
    log(f"[sharded] triangle cut removed {ncut} edges")
    batch.valid &= ~g.isolated_nodes()
    avg = batch.avg_read_length()

    mopp_scaled = int(max_offset_parallel_paths * avg / 100.0)
    g = mst_pass_sharded(mesh, g, mopp_scaled, threads, log=log)
    log("[sharded] short parallel paths removed (mesh footprints + "
        "wave pops)")
    batch.valid &= ~g.isolated_nodes()
    g = retain_min_offset_sharded(mesh, g)

    modb_scaled = int(max_offset_dangling_branches * avg / 100.0)
    rng = GlibcRand(1)
    iterations = 0
    while True:
        g, r1 = remove_dangling_sharded(mesh, g, modb_scaled, threads, rng)
        gr, r2 = remove_dangling_sharded(mesh, g.reverse(), modb_scaled,
                                         threads, rng)
        g = gr.reverse()
        removed = r1 + r2
        iterations += 1
        log(f"[sharded] dangling iteration {iterations}: removed {removed}")
        if removed == 0:
            break
        if iterations >= 16 and removed <= 30:
            break
    batch.valid &= ~g.isolated_nodes()
    return g.sorted_by_src_offset()
