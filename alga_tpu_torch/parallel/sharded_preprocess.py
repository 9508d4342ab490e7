"""Duplicate and prefix read marking over the mesh (port of
alga_tpu/parallel/sharded_preprocess.py).

The host pass (io/fastx.mark_prefix_reads, ref
ReadPreprocess::getPrefixReads) sorts the field-reversed packed keys of
all reads and compares neighbours.  Here the reads are range-partitioned
by their first reversed key word, the first 16 bases:

  * owner(read) = (rev_word0 * d) >> 32 is monotone in rev_word0, so the
    ranks' sorted runs, concatenated, are the global order;
  * a prefix pair shares its first min(len) >= 16 bases, so both rows
    carry the same rev_word0 and meet on one rank: no compare crosses a
    rank boundary.  Reads under 16 bases would break that, so they raise
    `ShortReadError` (the reference's STR filter drops every read of
    period <= 20 before this, ref InputReader.cpp:341-353);
  * each owner sorts the rows it receives by (key words, length, id) with
    stable sorts, compares neighbours, and routes each verdict (slot,
    strict) back to the slot's home rank, which marks the slot and, for
    a strict prefix, its reverse complement (slot ^ 1, on the same rank
    since `per` is even).
"""

from __future__ import annotations

import numpy as np
import torch

from alga_tpu_torch.graph.device_scale import _lexsort
from alga_tpu_torch.ops.bitops import words64
from alga_tpu_torch.parallel import mesh as mesh_mod


class ShortReadError(ValueError):
    """A valid read is shorter than 16 bases, which the range partition
    by the first 16 bases cannot place."""


def _rev_fields(w: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 2-bit fields of each 32-bit word (int64 in
    [0, 2^32)): base 0 lands in the top field, so numeric order is base
    order (fastx._reverse_2bit_fields)."""
    w = ((w & 0x33333333) << 2) | ((w >> 2) & 0x33333333)
    w = ((w & 0x0F0F0F0F) << 4) | ((w >> 4) & 0x0F0F0F0F)
    w = ((w & 0x00FF00FF) << 8) | ((w >> 8) & 0x00FF00FF)
    return ((w << 16) | (w >> 16)) & 0xFFFFFFFF


def _bit_length32(x: torch.Tensor) -> torch.Tensor:
    """Bit length of int64 values in [0, 2^32)."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        n += big * s
        x = torch.where(big, x >> s, x)
    return n + (x > 0)


def mark_prefix_sharded(mesh, packed_l, lengths, valid) -> np.ndarray:
    """bool[npad] marks, equal to fastx.mark_prefix_reads on the gathered
    store.  `packed_l` is this rank's int32[per, W] block of the store;
    `lengths` and `valid` are host arrays over all npad = per * d rows,
    ingest padding included."""
    per, W = packed_l.shape
    if per % 2:
        raise ValueError("mark_prefix_sharded: rows per rank must be even "
                         "(a read's reverse complement is slot ^ 1)")
    lengths = np.asarray(lengths, dtype=np.int64)
    valid = np.asarray(valid, dtype=bool)
    if valid.any() and int(lengths[valid].min()) < 16:
        raise ShortReadError("mark_prefix_sharded requires reads of at least "
                             "16 bases")
    d, dev = mesh.d, mesh.device
    base = mesh.rank * per
    rows = slice(base, base + per)
    lens_l = torch.from_numpy(lengths[rows]).to(dev)
    ids = torch.from_numpy(np.flatnonzero(valid[rows])).to(dev)

    rev = _rev_fields(words64(packed_l[ids]))
    recv = mesh_mod.route(mesh, (rev[:, 0] * d) >> 32, torch.cat(
        [rev, lens_l[ids, None], (base + ids)[:, None]], dim=1), "mark_rows")
    order = _lexsort([recv[:, W + 1], recv[:, W]]
                     + [recv[:, w] for w in range(W - 1, -1, -1)])
    recv = recv[order]
    keys, sl, sid = recv[:, :W], recv[:, W], recv[:, W + 1]

    # first mismatching base of neighbours, from the front
    x = keys[:-1] ^ keys[1:]
    nz = x != 0
    fm_w = nz.to(torch.int8).argmax(dim=1)
    xw = x.gather(1, fm_w[:, None])[:, 0]
    fm = torch.where(nz.any(dim=1), 16 * fm_w + (32 - _bit_length32(xw)) // 2,
                     16 * W)
    is_prefix = fm >= sl[:-1]
    strict = is_prefix & (sl[:-1] < sl[1:])
    vid = sid[:-1][is_prefix]
    back = mesh_mod.route(mesh, vid // per, torch.stack(
        [vid, strict[is_prefix].to(torch.int64)], dim=1), "mark_verdicts")
    mark_l = torch.zeros(per, dtype=torch.bool, device=dev)
    mark_l[back[:, 0] - base] = True
    mark_l[(back[:, 0][back[:, 1] == 1] ^ 1) - base] = True
    return (mesh_mod.gather_all(mesh, mark_l, "mark_gather").cpu().numpy()
            & valid)
