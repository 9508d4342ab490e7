"""Single-device GCPS overlap graph (port of alga_tpu/graph/device_scale.py).

The order-free GCPS reformulation (see alga_tpu/graph/prefsuf.py, ref
src/GraphCreators/GraphCreatorPrefSuf.cpp:73-126,397-483) as tensor code:

  1. per block of source reads, hash every window, join the window keys
     against the sorted prefix keys (`searchsorted` ranges plus a ragged
     expansion), and keep the candidates whose exact packed compare holds
     (`_block_join`);
  2. per source keep the last `soes` regime-1 matches in (ell, dst) order,
     then the max-ell instance per (src, dst) pair; regime-2 matches are
     the removers, sorted by (dst, off) (`_post_wide`);
  3. a pair is dropped when a later remover into the same dst dominates
     it, checked over the (pair, eligible remover) expansion in chunks
     (`_dom_chunk`);
  4. the surviving pairs are the edges, in (src, dst) order
     (`_final_compact`).

Tensors are sized from the data, so the JAX version's capacity hints and
retry loops (device_scale.py:385-423,493-602) have no counterpart, and
neither have `_concat_compact` and `_nz_pairs`, which only compact
fixed-capacity buffers.  Multi-key sorts are chains of stable sorts.  The
edges, and their row order, equal the JAX version's.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from alga_tpu_torch import device as device_mod
from alga_tpu_torch.core import packing
from alga_tpu_torch.graph.device_join import (_as_tensor, _dominated,
                                              _ragged_arange, _verify)
from alga_tpu_torch.graph.overlap_graph import OverlapGraph
from alga_tpu_torch.ops import hashes
from alga_tpu_torch.ops.bitops import _pad_words
from alga_tpu_torch.utils import timers

_C3 = 1 << 24          # domination expansion slots per chunk


def _lexsort(keys) -> torch.Tensor:
    """Permutation that sorts by keys[-1], then keys[-2], ... (the order
    of numpy.lexsort), as a chain of stable sorts."""
    perm = torch.argsort(keys[0], stable=True)
    for key in keys[1:]:
        perm = perm[torch.argsort(key[perm], stable=True)]
    return perm


def _stage_log():
    """A function that prints a stage line to stderr with the seconds
    since this call when ALGA_SCALE_LOG is set, and does nothing
    otherwise (the JAX version's `_vlog`)."""
    if not os.environ.get("ALGA_SCALE_LOG"):
        return lambda msg: None
    t0 = time.perf_counter()

    def log(msg: str) -> None:
        print(f"[device_scale +{time.perf_counter() - t0:7.1f}s] {msg}",
              file=sys.stderr, flush=True)
    return log


# ---------------------------------------------------------------------------
# stage 0: one prefix key per read

def _prefix_keys(packed, lengths, at, k: int):
    """(h1 int64[n], valid bool[n]): the A1 hash of window [0, k) of every
    read, and whether the read can be a prefix side (len >= k and at)."""
    h = torch.zeros(packed.shape[0], dtype=torch.int64, device=packed.device)
    for j in range(k):
        h = (h * hashes.A1 + hashes._base_column(packed, j)) & hashes.M32
    return h, (lengths >= k) & at


# ---------------------------------------------------------------------------
# stage 1: per-block join + exact verification

def _block_join(packed, packed_pad, lengths, af, pk_sorted, pk_ids,
                base: int, BS: int, k: int, nw: int, cap: int, W: int):
    """Matches (src, dst, ell, off) int64 for source reads [base, base+BS),
    and the block's candidate count.

    A window (B, p) is a live suffix candidate iff p + k <= len_B, af[B]
    and p >= len_B - cap; its candidates are the prefix reads C with the
    same A1 key, C != B and len_C >= ell = len_B - p.  Each is verified
    by exact packed compare B[p : p+ell] == C[0 : ell]."""
    blk = packed[base:base + BS]
    blens = lengths[base:base + BS].to(torch.int64)
    k1 = hashes._rolling_hash(blk, k, nw, hashes.A1)
    pos = torch.arange(nw, device=packed.device)[None, :]
    wvalid = ((pos + k <= blens[:, None]) & af[base:base + BS, None]
              & (pos >= blens[:, None] - cap))
    bloc, p = wvalid.nonzero(as_tuple=True)
    wk = k1[bloc, p]
    lo = torch.searchsorted(pk_sorted, wk)
    cnt = torch.searchsorted(pk_sorted, wk, right=True) - lo
    total = int(cnt.sum())
    if total == 0:
        z = torch.zeros(0, dtype=torch.int64, device=packed.device)
        return (z, z, z, z), 0
    win, rank = _ragged_arange(cnt, total)
    C = pk_ids[lo[win] + rank]
    src_loc = bloc[win]
    B = base + src_loc
    off = p[win]
    ell = blens[src_loc] - off
    ok = (C != B) & (lengths[C].to(torch.int64) >= ell)
    idx = ok.nonzero()[:, 0]
    B, C, ell, off = B[idx], C[idx], ell[idx], off[idx]
    eq = _verify(packed_pad, B, off, C, ell, W)
    return (B[eq], C[eq], ell[eq], off[eq]), total


# ---------------------------------------------------------------------------
# stage 2: ring survivors, per-pair max ell, removers

def _post_wide(ms, md, me, mo, rsoe: int, soes: int):
    """From the matches produce
      pairs (src, dst, ell, off) sorted by (src, dst), and
      removers (dst, src, ell, off), the regime-2 matches sorted by
      (dst, off)."""
    # regime-1 ring: per src keep the LAST `soes` in (ell, dst) order
    r1 = me < rsoe
    s, e, d, o = ms[r1], me[r1], md[r1], mo[r1]
    order = _lexsort([d, e, s])
    s, e, d, o = s[order], e[order], d[order], o[order]
    if s.numel():
        _, sizes = torch.unique_consecutive(s, return_counts=True)
        group_end = torch.repeat_interleave(torch.cumsum(sizes, 0), sizes)
        ring = group_end - torch.arange(s.numel(), device=s.device) <= soes
        s, e, d, o = s[ring], e[ring], d[ring], o[ring]

    # pair instances = ring survivors + regime 2; the max-ell one per pair
    r2 = ~r1
    i_src = torch.cat([s, ms[r2]])
    i_dst = torch.cat([d, md[r2]])
    i_ell = torch.cat([e, me[r2]])
    i_off = torch.cat([o, mo[r2]])
    order = _lexsort([i_ell, i_dst, i_src])
    i_src, i_dst, i_ell, i_off = (i_src[order], i_dst[order], i_ell[order],
                                  i_off[order])
    last = torch.ones_like(i_src, dtype=torch.bool)
    last[:-1] = (i_src[1:] != i_src[:-1]) | (i_dst[1:] != i_dst[:-1])
    pairs = (i_src[last], i_dst[last], i_ell[last], i_off[last])

    rd, rs, re_, ro = md[r2], ms[r2], me[r2], mo[r2]
    order = _lexsort([ro, rd])
    removers = (rd[order], rs[order], re_[order], ro[order])
    return pairs, removers


# ---------------------------------------------------------------------------
# stage 3: chunked domination

def _eligible_removers(pairs, removers):
    """(first, count) per pair: its eligible removers are rows
    [first, first+count) of the remover arrays — same dst, off <= the
    pair's off."""
    _, p_dst, _, p_off = pairs
    rd, _, _, ro = removers
    if rd.numel() == 0:
        z = torch.zeros_like(p_dst)
        return z, z
    span = int(torch.maximum(ro.max(), p_off.max())) + 1
    rkey = rd * span + ro
    first = torch.searchsorted(rkey, p_dst * span)
    last = torch.searchsorted(rkey, p_dst * span + p_off, right=True)
    return first, last - first


def _dom_chunk(packed_pad, pairs, removers, first, cnt, removed,
               i: int, j: int, W3: int) -> None:
    """Mark pairs [i, j) that an eligible remover dominates."""
    c = cnt[i:j]
    total = int(c.sum())
    if total == 0:
        return
    local, rank = _ragged_arange(c, total)
    pj = i + local
    p_src, _, p_ell, p_off = pairs
    _, rs, re_, ro = removers
    ridx = first[pj] + rank
    dom = _dominated(packed_pad, p_src[pj], p_ell[pj], p_off[pj], rs[ridx],
                     re_[ridx], ro[ridx], W3)
    removed[pj[dom]] = True


def _final_compact(pairs, removed):
    """(src, dst, off) int32 numpy arrays of the pairs that survive."""
    p_src, p_dst, _, p_off = pairs
    keep = ~removed
    return tuple(x[keep].to(torch.int32).cpu().numpy()
                 for x in (p_src, p_dst, p_off))


def gcps_graph_device_scale(packed, lengths, n: int, ell_min: int, cap: int,
                            rsoe: int, soes: int, align_from=None,
                            align_to=None, block_elems: int = 1 << 26, *,
                            device=None):
    """Full GCPS graph on `device`: the same edges, in the same (src, dst)
    row order, as alga_tpu.graph.device_scale.gcps_graph_device_scale.

    `packed` is uint32[n, W] numpy or its int32 tensor; `lengths`,
    `align_from` and `align_to` are numpy arrays or tensors.  With
    ALGA_SCALE_LOG set it prints its stages to stderr."""
    vlog = _stage_log()
    dev = device_mod.resolve(device)
    packed = _as_tensor(packed, torch.int32, dev)
    lengths = _as_tensor(lengths, torch.int32, dev)
    max_len = int(lengths.max()) if n else 0
    k = int(ell_min)
    if n == 0 or max_len < k:
        return OverlapGraph.empty(n)
    af = _as_tensor(align_from, torch.bool, dev, n)
    at = _as_tensor(align_to, torch.bool, dev, n)

    nw = max_len - k + 1
    BS = max(1, min(n, block_elems // nw))
    packed_pad = _pad_words(packed)
    pk, pvalid = _prefix_keys(packed, lengths, at, k)
    pref_ids = pvalid.nonzero()[:, 0]
    pk_sorted, order = torch.sort(pk[pref_ids], stable=True)
    pk_ids = pref_ids[order]
    W = packing.words_for(min(max_len, cap))
    nblocks = -(-n // BS)
    vlog(f"store on device: n={n} BS={BS} blocks={nblocks} nw={nw}")

    parts = []
    for b, base in enumerate(range(0, n, BS)):
        found, total = _block_join(packed, packed_pad, lengths, af,
                                   pk_sorted, pk_ids, base, BS, k, nw,
                                   int(cap), W)
        parts.append(found)
        vlog(f"block {b + 1}/{nblocks}: candidates={total}")
    ms, md, me, mo = (torch.cat(f) for f in zip(*parts))
    nmatch = ms.numel()
    vlog(f"matches={nmatch}")

    pairs, removers = _post_wide(ms, md, me, mo, int(rsoe), int(soes))
    del ms, md, me, mo
    first, cnt = _eligible_removers(pairs, removers)
    removed = torch.zeros(pairs[0].numel(), dtype=torch.bool, device=dev)
    csum = torch.cumsum(cnt, 0).cpu().numpy()
    exp_total = int(csum[-1]) if len(csum) else 0
    # the JAX version counts its matches as candidates too
    # (alga_tpu/graph/device_scale.py:542,572)
    bump = timers.bump
    bump("gcps_matches", nmatch)
    bump("gcps_candidates", nmatch)
    bump("gcps_domination_checks", exp_total)
    vlog(f"pairs={pairs[0].numel()} removers={removers[0].numel()} "
         f"exp_total={exp_total} dom_chunks={max(1, -(-exp_total // _C3))}")
    # chunks of whole pairs, each expanding to at most _C3 slots (a pair
    # with more eligible removers than that forms a chunk of its own)
    i = 0
    while i < len(csum):
        base = csum[i - 1] if i else 0
        j = max(i + 1, int(np.searchsorted(csum, base + _C3, side="right")))
        _dom_chunk(packed_pad, pairs, removers, first, cnt, removed, i, j, W)
        i = j

    src, dst, off = _final_compact(pairs, removed)
    vlog(f"edges={len(src)}")
    vlog("done")
    return OverlapGraph(n, src, dst, off)
