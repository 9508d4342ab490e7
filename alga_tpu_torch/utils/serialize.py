"""Checkpoint / resume: graph serialization.

Two formats:
  * the reference's binary graph format (ref Graph::serializeGraph /
    deserializeGraph, src/DataStructures/Graph.cpp:220-297) —
    interoperable with the reference's --serialize/--deserialize_graph
    workflow;
  * npz phase checkpoints (packed reads + edge arrays) for a resume at a
    phase boundary, in the same layout as alga_tpu's, so that a file
    written by either package loads in the other.

A copy of alga_tpu/utils/serialize.py, kept in step with it: the port
imports nothing of alga_tpu, whose package imports jax.
"""

from __future__ import annotations

import numpy as np

from alga_tpu_torch.graph.overlap_graph import OverlapGraph


def write_reference_graph(g: OverlapGraph, path: str) -> None:
    """Binary layout (ref Graph::serializeGraph, Graph.cpp:268-295):
    u32 n, then per node: i32 id, i32 degree, (i32 dst, i32 offset)*degree
    — node-major, (dst, offset) order not normative (the reference
    re-sorts on use).

    Array-level construction (VERDICT r4 #7): one native counting-sort
    pass (no comparison sort, no per-edge Python loop) when the host
    engine is built; numpy scatters otherwise.  The per-node edge order
    is not normative (the reference re-sorts on use)."""
    from alga_tpu_torch import native
    if native.available():
        native.graph_pack(g.n, g.src, g.dst, g.offset).tofile(path)
        return
    gs = g.sorted_by_src_offset()
    n = g.n
    src = np.asarray(gs.src, dtype=np.int64)
    deg = np.bincount(src, minlength=n).astype(np.int64)
    rec_len = 2 + 2 * deg                       # ints per node record
    starts = np.empty(n, dtype=np.int64)        # record starts, past the u32
    if n:
        starts[0] = 1
        np.cumsum(rec_len[:-1], out=starts[1:])
        starts[1:] += 1
    out = np.empty(1 + int(rec_len.sum()), dtype=np.int32)
    out[0] = np.uint32(n).view(np.int32) if n < (1 << 31) else n
    out[starts] = np.arange(n, dtype=np.int32)
    out[starts + 1] = deg.astype(np.int32)
    m = len(src)
    if m:
        deg_csum_ex = np.cumsum(deg) - deg
        erank = np.arange(m, dtype=np.int64) - deg_csum_ex[src]
        pos = starts[src] + 2 + 2 * erank
        out[pos] = np.asarray(gs.dst, dtype=np.int32)
        out[pos + 1] = np.asarray(gs.offset, dtype=np.int32)
    out.tofile(path)


def _record_starts(data: np.ndarray, n: int) -> np.ndarray:
    """int64[n] record start indices into the int32 stream (the scan is a
    data-dependent recurrence: start[i+1] = start[i] + 2 + 2*deg[i])."""
    from alga_tpu_torch import native
    if native.available():
        return native.graph_record_starts(data, n)
    starts = np.empty(n, dtype=np.int64)
    p = 1
    d = data  # local for the O(n) python fallback (no per-edge work)
    for i in range(n):
        starts[i] = p
        p += 2 + 2 * int(d[p + 1])
    if p > len(data):
        raise ValueError("truncated reference graph file")
    return starts


def read_reference_graph(path: str) -> OverlapGraph:
    data = np.fromfile(path, dtype=np.int32)
    if len(data) == 0:
        raise ValueError(f"empty reference graph file: {path}")
    n = int(data[0].view(np.uint32) if data[0] < 0 else data[0])
    from alga_tpu_torch import native
    if native.available():
        m = (len(data) - 1 - 2 * n) // 2
        src, dst, wts = native.graph_unpack(data, n, m)
        return OverlapGraph(n, src, dst, wts)
    starts = _record_starts(data, n)
    ids = data[starts].astype(np.int64)         # the stored vertex id wins
    deg = data[starts + 1].astype(np.int64)     # (ref deserialize V[id])
    m = int(deg.sum())
    src = np.repeat(ids, deg).astype(np.int32)
    if m:
        deg_csum_ex = np.cumsum(deg) - deg
        erank = np.arange(m, dtype=np.int64) - np.repeat(deg_csum_ex, deg)
        pos = np.repeat(starts, deg) + 2 + 2 * erank
        dst = data[pos]
        wts = data[pos + 1]
    else:
        dst = np.zeros(0, dtype=np.int32)
        wts = np.zeros(0, dtype=np.int32)
    return OverlapGraph(n, src, np.asarray(dst, dtype=np.int32),
                        np.asarray(wts, dtype=np.int32))


def save_checkpoint(path: str, *, batch=None, graph: OverlapGraph | None = None,
                    meta: dict | None = None) -> None:
    """npz phase checkpoint: packed reads and/or edge arrays."""
    payload = {}
    if batch is not None:
        payload.update(
            packed=batch.packed, lengths=batch.lengths, valid=batch.valid,
            paired_offset=batch.paired_offset)
    if graph is not None:
        payload.update(g_n=np.int64(graph.n), g_src=graph.src,
                       g_dst=graph.dst, g_off=graph.offset)
    if meta:
        for k, v in meta.items():
            payload[f"meta_{k}"] = np.asarray(v)
    np.savez_compressed(path, **payload)


def load_checkpoint(path: str):
    """Returns (batch | None, graph | None, meta dict)."""
    from alga_tpu_torch.core.seqbatch import SeqBatch
    z = np.load(path)
    batch = None
    if "packed" in z:
        batch = SeqBatch(z["packed"], z["lengths"], z["valid"],
                         z["paired_offset"])
    graph = None
    if "g_n" in z:
        graph = OverlapGraph(int(z["g_n"]), z["g_src"], z["g_dst"], z["g_off"])
    meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
    return batch, graph, meta
