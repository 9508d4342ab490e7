"""Alignment for the error-tolerant path (port of alga_tpu/ops/align.py).

  * ACLER (ref AlignmentControllerLowErrorRate.cpp:15-49): XOR/popcount
    mismatch filter with the same-ends requirement — `acler_batch`.
  * ACLCS (ref AlignmentControllerLCS.cpp:30-150): banded LCS, band
    half-width E — `banded_lcs`, which runs the two kernels of
    ops/banded_dp.py on the tensors' device.
  * ACH (ref AlignmentControllerHybrid.cpp:46-86): guards + dispatch —
    `ach_batch_auto`, with the numpy twin `np_ach_batch` for small
    batches, and `ach_batch_mesh`, its ACLER-only form split over the
    ranks of a mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from alga_tpu_torch import device as device_mod
from alga_tpu_torch import native
from alga_tpu_torch.core import packing
from alga_tpu_torch.ops import banded_dp
from alga_tpu_torch.ops.bitops import (M32, _low_mask, _pad_words,
                                       _shifted_words, popcount32)
from alga_tpu_torch.store import words_as_int32
from alga_tpu_torch.utils import timers


# ---------------------------------------------------------------------------
# ACLER

def acler_batch(packed, lengths, r1, r2, offsets, num_words: int,
                max_offset_percent: int, min_overlap_area: int,
                min_overlap_for_lcs_low_error: int,
                same_ends_length: int = 3) -> torch.Tensor:
    """bool[M]: ACLER.canAlign for pairs (r1[i], r2[i], offset).

    matched = overlap - popcount(xor over the overlap BITS)/2 — bit-level
    (ref ACLER.cpp:29-36).  The same-ends check covers bits [0, 2*SEL]
    inclusive at the front (2*SEL+1 bits — a reference quirk kept here)
    and [2*(ov-SEL), 2*ov-1] at the back."""
    packed_pad = _pad_words(packed)
    lengths = lengths.to(torch.int64)
    r1 = r1.to(torch.int64)
    r2 = r2.to(torch.int64)
    offsets = offsets.to(torch.int64)

    len1 = lengths[r1]
    len2 = lengths[r2]
    overlap = torch.minimum(len1, len2 + offsets) - offsets
    ok_guard = ((100 * offsets <= max_offset_percent * len1)
                & (overlap >= min_overlap_area) & (offsets >= 0))

    bitdiff = torch.zeros_like(r1)
    front_bits = torch.zeros_like(r1)
    back_bits = torch.zeros_like(r1)
    ov_bits = overlap * 2
    front_hi = 2 * same_ends_length          # inclusive bit index
    back_lo = ov_bits - 2 * same_ends_length
    for w in range(num_words):
        a_word = _shifted_words(packed_pad, r1, offsets, w)
        b_word = packed_pad[r2, min(w, packed.shape[1] - 1)]
        base_bit = 32 * w
        mdiff = (a_word ^ b_word) & _low_mask((ov_bits - base_bit).clamp(0, 32))
        bitdiff += popcount32(mdiff)
        fr = min(max(front_hi + 1 - base_bit, 0), 32)
        front_bits += popcount32(mdiff & ((1 << fr) - 1))
        # mdiff already excludes bits >= ov_bits: cut the bits below back_lo
        lowcut = (back_lo - base_bit).clamp(0, 32)
        back_bits += popcount32(mdiff & ((M32 << lowcut) & M32))

    seq_overlap = (ov_bits - bitdiff) >> 1
    same_ends = (front_bits == 0) & (back_bits == 0)
    accept = 100 * seq_overlap >= min_overlap_for_lcs_low_error * overlap
    return ok_guard & same_ends & accept


# ---------------------------------------------------------------------------
# banded LCS

def banded_lcs(packed, lengths, r1, r2, offsets, E: int = 2) -> torch.Tensor:
    """int32[M]: the banded LCS of pairs (r1[i], r2[i], offsets[i]) of the
    packed read table (int32[N, W] words, int32[N] lengths).

    Dispatches on the tensors' device: K1 (gather_planes) fetches both
    reads' words and lengths pair-major in one launch and K2
    (banded_dp.banded_lcs) runs the DP — CUDA kernels for GPU tensors,
    their plain versions for CPU tensors."""
    timers.bump("ach_lcs_pairs", r1.shape[0])
    rows = banded_dp.gather_planes(packed, lengths,
                                   torch.stack([r1, r2]).to(torch.int32))
    return banded_dp.banded_lcs(rows[0, :-1], rows[1, :-1], rows[0, -1],
                                rows[1, -1],
                                offsets.to(torch.int32).contiguous(), E)


def _table(packed_np, lengths, device):
    """(int32 words, int32 lengths) of a numpy read table on `device`."""
    dev = device_mod.resolve(device)
    return (torch.from_numpy(words_as_int32(packed_np)).to(dev),
            torch.from_numpy(np.asarray(lengths, dtype=np.int32)).to(dev))


def _lcs_accept(table, r1, r2, offsets, overlap, cfg) -> np.ndarray:
    """bool[M]: the ACLCS verdict for pairs whose ACLER check failed
    (ref ACHybrid.cpp:64-75), on the device of `table`."""
    dev = table[0].device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    lcs = banded_lcs(*table, t(r1), t(r2), t(offsets),
                     cfg.max_error_rate_for_lcs)
    return 100 * lcs.cpu().numpy() > cfg.minimal_overlap_rate_for_lcs * overlap


# ---------------------------------------------------------------------------
# batched ACH with host/device dispatch

def np_ach_batch(codes, lengths, r1, r2, offsets, cfg, chunk: int = 1 << 18,
                 *, packed=None, device=None) -> np.ndarray:
    """bool[M]: vectorized numpy ACH over pairs.  The banded-LCS fallback
    runs on `device` over `packed` (packed from `codes` when absent)."""
    r1 = np.asarray(r1, dtype=np.int64)
    r2 = np.asarray(r2, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    m = len(r1)
    out = np.zeros(m, dtype=bool)
    for a in range(0, m, chunk):
        b = min(a + chunk, m)
        out[a:b] = _np_ach_chunk(codes, lengths, r1[a:b], r2[a:b],
                                 offsets[a:b], cfg, packed, device)
    return out


def _np_ach_chunk(codes, lengths, r1, r2, offsets, cfg, packed, device):
    len1 = lengths[r1]
    len2 = lengths[r2]
    ok = 100 * offsets <= cfg.max_offset_considered_for_alignment * len1
    ok &= offsets >= cfg.min_offset_for_alignment
    overlap = np.minimum(len1, len2 + offsets) - offsets
    ok &= overlap >= cfg.min_overlap_area
    ok &= (len2 + offsets - len1) >= 0
    if not ok.any():
        return ok

    lpad = codes.shape[1]
    ovmax = int(np.where(ok, overlap, 0).max())
    cols = np.arange(ovmax, dtype=np.int64)[None, :]
    av = codes[r1[:, None], np.minimum(offsets[:, None] + cols, lpad - 1)]
    bv = codes[r2[:, None], np.minimum(cols, lpad - 1)]
    in_ov = cols < overlap[:, None]
    x = (av ^ bv).astype(np.uint8)
    x = np.where(in_ov, x, 0)
    # bit-level diff count (ref ACLER.cpp:29-36)
    bitdiff = ((x & 1) + (x >> 1)).sum(axis=1, dtype=np.int64)
    seq_overlap = (2 * overlap - bitdiff) >> 1

    sel = cfg.alignment_controller_same_ends_length
    front_bad = ((x != 0) & (cols < sel)).any(axis=1)
    # the front window covers bit [0, 2*sel] inclusive: the low bit of base
    # `sel` also participates (reference quirk, ref ACLER.cpp:42-45)
    if ovmax > sel:
        front_bad |= ((x[:, sel] & 1) != 0) & (overlap > sel)
    back_bad = ((x != 0) & (cols >= (overlap - sel)[:, None])).any(axis=1)

    acler = ok & ~front_bad & ~back_bad & \
        (100 * seq_overlap >= cfg.minimal_overlap_for_lcs_low_error * overlap)

    if cfg.use_acler_instead_of_aclcs:
        return acler

    need = ok & ~acler
    if need.any():
        idx = np.flatnonzero(need)
        if packed is None:
            packed = packing.codes_to_packed(codes, lengths)
        acler[idx] = _lcs_accept(_table(packed, lengths, device), r1[idx],
                                 r2[idx], offsets[idx], overlap[idx], cfg)
    return acler


def ach_batch_auto(packed, codes, lengths, r1, r2, offsets, cfg,
                   min_device_batch: int = 200_000, *,
                   device=None) -> np.ndarray:
    """bool[M]: ACH over pairs — the numpy twin (or the native ACLER) for
    small batches, `acler_batch` and `banded_lcs` on `device` for large
    ones.  `packed` is the uint32[N, W] numpy read store."""
    bump = timers.bump
    m = len(r1)
    bump("ach_total_alignments", m)     # ref ACHybrid.h:31-36 counters
    if m == 0:
        return np.zeros(0, dtype=bool)
    if m < min_device_batch or packed is None:
        if (packed is not None and cfg.use_acler_instead_of_aclcs
                and native.available()):
            return native.acler_batch_native(
                np.asarray(packed), lengths, r1, r2, offsets, cfg)
        if codes is None:
            # unpack only the rows this batch touches; the LCS fallback
            # gets the same rows packed
            uniq, inv = np.unique(np.concatenate([r1, r2]),
                                  return_inverse=True)
            sub = np.asarray(packed)[uniq]
            return np_ach_batch(packing.packed_to_codes(sub),
                                np.asarray(lengths)[uniq], inv[:m], inv[m:],
                                offsets, cfg, packed=sub, device=device)
        return np_ach_batch(codes, lengths, r1, r2, offsets, cfg,
                            packed=packed, device=device)

    packed = np.asarray(packed)
    lengths = np.asarray(lengths, dtype=np.int64)
    r1 = np.asarray(r1, dtype=np.int64)
    r2 = np.asarray(r2, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    table = _table(packed, lengths, device)
    t = lambda a: torch.from_numpy(a).to(table[0].device)  # noqa: E731
    acler = acler_batch(
        *table, t(r1), t(r2), t(offsets),
        packed.shape[1], cfg.max_offset_considered_for_alignment,
        cfg.min_overlap_area, cfg.minimal_overlap_for_lcs_low_error,
        cfg.alignment_controller_same_ends_length).cpu().numpy()

    len1 = lengths[r1]
    len2 = lengths[r2]
    # ACH-level guards the ACLER kernel does not apply
    guards = (offsets >= cfg.min_offset_for_alignment) & \
             (len2 + offsets - len1 >= 0)
    ok = acler & guards
    bump("ach_low_error_approved", int(ok.sum()))
    if cfg.use_acler_instead_of_aclcs:
        return ok

    overlap = np.minimum(len1, len2 + offsets) - offsets
    full_guard = guards & \
        (100 * offsets <= cfg.max_offset_considered_for_alignment * len1) & \
        (overlap >= cfg.min_overlap_area)
    need = full_guard & ~ok
    if need.any():
        bump("ach_lcs_alignments", int(need.sum()))
        idx = np.flatnonzero(need)
        ok[idx] = _lcs_accept(table, r1[idx], r2[idx], offsets[idx],
                              overlap[idx], cfg)
    return ok


def ach_batch_mesh(mesh, packed, lengths, r1, r2, offsets, cfg) -> np.ndarray:
    """bool[M]: ACH over pairs split over the ranks of `mesh` (alga_tpu's
    ach_batch_mesh, ops/align.py:410): each rank runs `acler_batch` on its
    contiguous share of the pairs against the whole store on its device,
    and every rank gets all verdicts.  ACLER only (the supplement's retuned
    configuration, use_acler_instead_of_aclcs=True); the ACLCS fallback
    takes ach_batch_auto on each rank."""
    if not cfg.use_acler_instead_of_aclcs:
        raise ValueError("ach_batch_mesh is ACLER-only; configurations with "
                         "the LCS fallback use ach_batch_auto")
    from alga_tpu_torch.parallel.mesh import gather_all
    m = len(r1)
    timers.bump("ach_total_alignments", m)
    if m == 0:
        return np.zeros(0, dtype=bool)
    lengths = np.asarray(lengths, dtype=np.int64)
    r1 = np.asarray(r1, dtype=np.int64)
    r2 = np.asarray(r2, dtype=np.int64)
    offsets = np.asarray(offsets, dtype=np.int64)
    share = slice(mesh.rank * m // mesh.d, (mesh.rank + 1) * m // mesh.d)
    table = _table(np.asarray(packed), lengths, mesh.device)
    t = lambda a: torch.from_numpy(a[share]).to(mesh.device)  # noqa: E731
    acler = gather_all(mesh, acler_batch(
        *table, t(r1), t(r2), t(offsets), table[0].shape[1],
        cfg.max_offset_considered_for_alignment, cfg.min_overlap_area,
        cfg.minimal_overlap_for_lcs_low_error,
        cfg.alignment_controller_same_ends_length), "ach_acler").cpu().numpy()
    guards = ((offsets >= cfg.min_offset_for_alignment)
              & (lengths[r2] + offsets - lengths[r1] >= 0))
    ok = acler & guards
    timers.bump("ach_low_error_approved", int(ok.sum()))
    return ok
