"""GCPS over the mesh with the read store sharded by rows (port of
alga_tpu/parallel/sharded_gcps.py).

Read g lives on rank g // per; no rank ever holds another rank's rows
except the ones it fetches for a compare.  Five stages, each a plain
function on this rank's tensors, with the exchanges of parallel/mesh.py
between them:

  1. `_route_records`: every live window (key, B, ell, p) and every
     prefix (key, C, len) goes to its key owner, rank key % d, which
     sorts the windows by key and probes each prefix key into them
     (the reference's hash buckets, GraphCreatorPrefSuf.cpp:41-48);
  2. `_expand_verify`: the owner expands the candidates, fetches the two
     packed rows of each from their home ranks and keeps the exact
     matches (src B, dst C, ell, off p);
  3. matches go to their src owner, which keeps the regime-1 ring
     survivors and the max-ell instance per (src, dst) pair
     (graph/device_scale._post_wide: both are per-src rules);
  4. pairs and regime-2 removers go to their dst owner, which finds each
     pair's eligible removers (device_scale._eligible_removers);
  5. `_dominate`: the (pair, remover) slots whose predicate holds fetch
     both rows and compare; the pairs no remover dominates are the edges.

Counts are exchanged before every payload, so the stages allocate what
the data needs: alga_tpu's capacities, overflow flags, retry loops and
ALGA_SHARDED_TINY_CAPS have no counterpart.  Candidates and domination
slots are processed in rounds of at most _CHUNK slots, every rank taking
part in each round's exchange.  The edges equal the single-device graph's
after `sorted_by_src_offset()`, for any world size, with or without the
align_from/align_to masks.
"""

from __future__ import annotations

import numpy as np
import torch

from alga_tpu_torch.core import packing
from alga_tpu_torch.graph.device_join import _dom_cond, _substr_eq_rows
from alga_tpu_torch.graph.device_scale import (_eligible_removers, _lexsort,
                                               _post_wide)
from alga_tpu_torch.graph.overlap_graph import OverlapGraph
from alga_tpu_torch.ops import hashes
from alga_tpu_torch.ops.bitops import _pad_words
from alga_tpu_torch.parallel import mesh as mesh_mod
from alga_tpu_torch.store import words_as_int32
from alga_tpu_torch.utils import timers

_CHUNK = 1 << 22          # candidate or domination slots per round


def _rounds(mesh, total: int) -> int:
    """Rounds of _CHUNK slots that the rank with the most slots needs."""
    return mesh_mod.all_max(mesh, -(-total // _CHUNK))


def _slots(csum: torch.Tensor, s0: int, s1: int):
    """(segment, rank in segment) of the slots [s0, s1) of segments whose
    inclusive prefix sums are `csum`."""
    t = torch.arange(s0, s1, device=csum.device)
    seg = torch.searchsorted(csum, t, right=True)
    start = torch.where(seg > 0, csum[(seg - 1).clamp(min=0)], 0)
    return seg, t - start


def local_block(mesh, packed_np, n: int):
    """(int32[per, W] rows [rank*per, (rank+1)*per) of a numpy store of n
    reads, zero rows past n; npad; per) on the mesh's device."""
    npad, per = mesh_mod.block(mesh, n)
    lo, hi = mesh.rank * per, min((mesh.rank + 1) * per, n)
    rows = np.zeros((per, packed_np.shape[1]), dtype=np.uint32)
    rows[:max(0, hi - lo)] = packed_np[lo:hi]
    return torch.from_numpy(words_as_int32(rows)).to(mesh.device), npad, per


def _route_records(mesh, packed_l, lens_l, af_l, at_l, base: int, k: int,
                   nw: int, cap: int):
    """Stage 1 on the key owner: (windows int64[M, 4] = (key, B, ell, p)
    sorted by key, prefixes int64[P, 3] = (key, C, len), first window
    rank `lo` and candidate count of each prefix)."""
    d = mesh.d
    k1 = hashes._rolling_hash(packed_l, k, nw, hashes.A1)
    pos = torch.arange(nw, device=packed_l.device)[None, :]
    wvalid = ((pos + k <= lens_l[:, None]) & af_l[:, None]
              & (pos >= lens_l[:, None] - cap))
    bl, p = wvalid.nonzero(as_tuple=True)
    wk = k1[bl, p]
    win = mesh_mod.route(mesh, wk % d, torch.stack(
        [wk, base + bl, lens_l[bl] - p, p], dim=1), "gcps_windows")
    pid = ((lens_l >= k) & at_l).nonzero()[:, 0]
    pk = k1[pid, 0]
    del k1, wvalid, bl, p, wk
    pre = mesh_mod.route(mesh, pk % d, torch.stack(
        [pk, base + pid, lens_l[pid]], dim=1), "gcps_prefixes")
    keys, order = torch.sort(win[:, 0], stable=True)
    win = win[order]
    probe = pre[:, 0].contiguous()
    lo = torch.searchsorted(keys, probe)
    cnt = torch.searchsorted(keys, probe, right=True) - lo
    return win, pre, lo, cnt


def _expand_verify(mesh, packed_l, per: int, win, pre, lo, cnt, W: int):
    """Stage 2: the exact matches (src, dst, ell, off) int64[M, 4] of the
    candidates this rank owns, and their number before the compare."""
    csum = torch.cumsum(cnt, 0)
    total = int(csum[-1]) if csum.numel() else 0
    found = []
    for r in range(_rounds(mesh, total)):
        seg, rank = _slots(csum, min(r * _CHUNK, total),
                           min((r + 1) * _CHUNK, total))
        w = win[lo[seg] + rank]
        B, ell, p = w[:, 1], w[:, 2], w[:, 3]
        C, len_c = pre[seg, 1], pre[seg, 2]
        ok = ((B != C) & (len_c >= ell)).nonzero()[:, 0]
        B, C, ell, p = B[ok], C[ok], ell[ok], p[ok]
        rows = _pad_words(mesh_mod.fetch_rows(
            mesh, packed_l, torch.cat([B, C]), per, "gcps_rows"))
        m = B.numel()
        eq = _substr_eq_rows(rows[:m], p, rows[m:], ell, W)
        found.append(torch.stack([B, C, ell, p], dim=1)[eq])
    out = (torch.cat(found) if found else
           torch.zeros((0, 4), dtype=torch.int64, device=packed_l.device))
    return out, total


def _dominate(mesh, packed_l, per: int, pairs, removers, W: int):
    """Stage 5: bool per pair, True when an eligible remover dominates it,
    and the number of (pair, remover) slots."""
    first, cnt = _eligible_removers(pairs, removers)
    p_src, _, p_ell, p_off = pairs
    _, rs, re_, ro = removers
    removed = torch.zeros(p_src.numel(), dtype=torch.bool,
                          device=p_src.device)
    csum = torch.cumsum(cnt, 0)
    total = int(csum[-1]) if csum.numel() else 0
    for r in range(_rounds(mesh, total)):
        pj, rank = _slots(csum, min(r * _CHUNK, total),
                          min((r + 1) * _CHUNK, total))
        ridx = first[pj] + rank
        A, offA, offB, Br = p_src[pj], p_off[pj], ro[ridx], rs[ridx]
        sel = _dom_cond(A, p_ell[pj], offA, Br, re_[ridx], offB) \
            .nonzero()[:, 0]
        A, offA, offB, Br, pj = A[sel], offA[sel], offB[sel], Br[sel], pj[sel]
        rows = _pad_words(mesh_mod.fetch_rows(
            mesh, packed_l, torch.cat([A, Br]), per, "gcps_dom_rows"))
        m = A.numel()
        removed[pj[_substr_eq_rows(rows[:m], offA - offB, rows[m:], offB,
                                   W)]] = True
    return removed, total


def gcps_graph_sharded(mesh, packed, lengths, n: int, ell_min: int,
                       cap: int, rsoe: int, soes: int = 3, align_from=None,
                       align_to=None) -> OverlapGraph:
    """The GCPS graph of n reads over the mesh, the same edges in the same
    canonical (src, offset, dst) order as the single-device path; every
    rank returns the whole graph.

    `packed` is the uint32[n, W] numpy store (each rank moves only its
    own block to its device), or this rank's int32[per, W] block as a
    tensor (io/multihost's layout: n = per * d rows, lengths and masks
    covering all of them, padding rows masked out).  `lengths` and the
    masks are host arrays over all n reads."""
    lengths = np.asarray(lengths, dtype=np.int64)
    max_len = int(lengths.max()) if n else 0
    k = int(ell_min)
    if n == 0 or max_len < k:
        return OverlapGraph.empty(n)
    if torch.is_tensor(packed):
        packed_l = packed
        per = packed_l.shape[0]
        npad = per * mesh.d
    else:
        packed_l, npad, per = local_block(mesh, packed, n)
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)

    def local(a, default, dtype):
        """This rank's rows of a per-read host array (zero past n)."""
        full = np.zeros(npad, dtype=dtype)
        full[:n] = default if a is None else np.asarray(a)[:n]
        return torch.from_numpy(full[rows]).to(mesh.device)
    lens_l = local(lengths, 0, np.int64)
    af_l = local(align_from, True, bool)
    at_l = local(align_to, True, bool)
    W = packing.words_for(min(max_len, cap))

    win, pre, lo, cnt = _route_records(mesh, packed_l, lens_l, af_l, at_l,
                                       mesh.rank * per, k, max_len - k + 1,
                                       int(cap))
    matches, total = _expand_verify(mesh, packed_l, per, win, pre, lo, cnt, W)
    del win, pre, lo, cnt
    matches = mesh_mod.route(mesh, matches[:, 0] // per, matches,
                             "gcps_matches")
    pairs, removers = _post_wide(*matches.unbind(1), int(rsoe), int(soes))
    nmatch = matches.shape[0]
    del matches
    pairs = mesh_mod.route(mesh, pairs[1] // per, torch.stack(pairs, dim=1),
                           "gcps_pairs").unbind(1)
    rem = mesh_mod.route(mesh, removers[0] // per,
                         torch.stack(removers, dim=1), "gcps_removers")
    removers = rem[_lexsort([rem[:, 3], rem[:, 0]])].unbind(1)   # (dst, off)
    removed, exp_total = _dominate(mesh, packed_l, per, pairs, removers, W)
    keep = ~removed
    edges = mesh_mod.gather_all(mesh, torch.stack(
        [pairs[0][keep], pairs[1][keep], pairs[3][keep]], dim=1),
        "gcps_edges").cpu()
    timers.bump("gcps_candidates", total)
    timers.bump("gcps_matches", nmatch)
    timers.bump("gcps_domination_checks", exp_total)
    src, dst, off = edges.to(torch.int32).numpy().T
    return OverlapGraph(n, src.copy(), dst.copy(), off.copy()) \
        .sorted_by_src_offset()
