"""The wide band of the ACLCS banded LCS (band half-widths E > 15) on the
CPU, against alga_tpu's scalar oracles `np_banded_lcs` and
`np_ach_can_align`: the port's plain version in both of its frames (the
band's 2E+1 cells, or the read's 16W cells once the band is wider), the
result past the read, ACH at E = 1,000, the wide kernel's launch shapes,
and a numpy emulation of the wide kernel (csrc/banded_lcs_wide.cu) lane
by lane: g lanes per pair, k cells a lane, each row a prefix max taken
across the lanes with the shuffles' semantics.  alga_tpu's XLA route is
not run at these band widths: it unrolls the band, and its compile grows
with 2E+1."""

import numpy as np
import pytest
import torch

from alga_tpu.config import AssemblyConfig, autotune, supplement_retune
from alga_tpu.core import packing
from alga_tpu.ops import align as jalign
from alga_tpu_torch.ops import align, banded_dp

torch.set_num_threads(2)

LANES = 0x55555555              # bit 0 of every 2-bit base
M32 = 0xFFFFFFFF


def _pairs(seed, n_pairs, read_lo, read_hi, off_lo, off_hi, edge=None):
    """(codes, lens, r1, r2, offs) of n_pairs pairs of reads of read_lo to
    read_hi - 1 bases, offsets in [off_lo, off_hi) (negative ones too):
    read 2 of half the pairs is a noisy copy of read 1 from its offset
    on; with `edge` (a band half-width E), read 2 of a quarter copies
    read 1 along the band's last or first diagonal or the one past it
    (from offset off - E, off + E, off - E - 1, off + E + 1 on), where
    the kernels' masks decide the result; the rest are random."""
    rng = np.random.default_rng(seed)
    n = 2 * n_pairs
    lens = rng.integers(read_lo, read_hi, n)
    codes = np.zeros((n, read_hi), dtype=np.uint8)
    for i, k in enumerate(lens):
        codes[i, :k] = rng.integers(0, 4, k)
    r1 = 2 * np.arange(n_pairs)
    r2 = r1 + 1
    offs = rng.integers(off_lo, off_hi, n_pairs)
    shifts = offs.copy()
    if edge is not None:
        at = np.arange(n_pairs // 2, 3 * n_pairs // 4)
        shifts[at] += np.array([-edge, edge, -edge - 1, edge + 1])[at % 4]
    copies = np.arange(3 * n_pairs // 4 if edge is not None
                       else n_pairs // 2)
    for a, o in zip(r1[copies], shifts[copies]):
        seg = codes[a, max(o, 0):].copy()
        noise = rng.random(len(seg)) < 0.05
        seg[noise] = rng.integers(0, 4, noise.sum())
        codes[a + 1, max(-o, 0):max(-o, 0) + len(seg)] = \
            seg[:read_hi - max(-o, 0)]
    return codes, lens, r1, r2, offs


def _args(codes, lens, r1, r2, offs):
    """banded_dp.banded_lcs's arguments for the pairs."""
    w = torch.from_numpy(
        packing.codes_to_packed(codes, lens).view(np.int32).T.copy())
    l32 = torch.from_numpy(lens.astype(np.int32))
    t1, t2 = torch.from_numpy(r1), torch.from_numpy(r2)
    return (w[:, t1].contiguous(), w[:, t2].contiguous(), l32[t1], l32[t2],
            torch.from_numpy(offs.astype(np.int32)))


def _oracle(codes, lens, r1, r2, offs, E):
    return np.array([jalign.np_banded_lcs(codes, lens, a, b, int(o), E)
                     for a, b, o in zip(r1, r2, offs)])


# reads of 60-111 bases (W = 7 words, 16W = 112): the frames switch
# between E = 55 (2E+1 = 111 = 16W - 1) and E = 56 (113 = 16W + 1)
@pytest.mark.parametrize("E", [16, 55, 56, 100, 1000, 10_000])
def test_plain_version_matches_oracle_in_both_frames(E):
    pairs = _pairs(E, 80, 60, 112, -30, 80, edge=E)
    args = _args(*pairs)
    assert args[0].shape[0] == 7
    got = banded_dp.banded_lcs(*args, E).numpy()
    want = _oracle(*pairs, E)
    np.testing.assert_array_equal(got, want)
    assert np.median(want[:40]) > 30


def test_result_is_the_same_past_the_read():
    """Once E reaches 16W + the largest |offset|, every row's band holds
    the whole read 2 and q* = len2 - 1: every wider band gives the same
    result, up to the largest int32 E."""
    pairs = _pairs(3, 40, 90, 160, -60, 120)
    args = _args(*pairs)
    e0 = 16 * args[0].shape[0] + int(np.abs(pairs[4]).max())
    want = _oracle(*pairs, e0)
    for E in (e0, e0 + 1, 3 * e0, 10**6, 2**31 - 1):
        np.testing.assert_array_equal(banded_dp.banded_lcs(*args, E).numpy(),
                                      want)


@pytest.mark.parametrize("min_device_batch", [0, 10**9])
def test_ach_batch_auto_at_e1000_matches_oracle(min_device_batch):
    """ACH with the LCS fallback (use_acler_instead_of_aclcs=False) at
    max_error_rate_for_lcs = 1,000, through the device branch (acler_batch
    + banded_lcs) and the numpy one, against np_ach_can_align."""
    codes, lens, r1, r2, offs = _pairs(7, 300, 70, 100, 0, 50)
    cfg = supplement_retune(autotune(AssemblyConfig(
        error_rate=0.02, use_acler_instead_of_aclcs=False,
        max_error_rate_for_lcs=1000), 85), 85)
    packed = packing.codes_to_packed(codes, lens)
    got = align.ach_batch_auto(packed, None, lens, r1, r2, offs, cfg,
                               min_device_batch=min_device_batch,
                               device="cpu")
    want = np.array([jalign.np_ach_can_align(codes, lens, a, b, int(o), cfg)
                     for a, b, o in zip(r1, r2, offs)])
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("W", [1, 7, 16, 32, 64, 128])
@pytest.mark.parametrize("E", [16, 63, 823, 1023, 10_000])
def test_wide_shape_holds_every_row(W, E):
    """Every (lanes, cells) the launch takes holds the row, min(2E+1, 16W)
    cells, which stops growing with E past the read; every lane count is
    either taken as asked or refused, on the CPU as on a card."""
    cells = min(2 * E + 1, 16 * W)
    for M in (1, 628, 4906, 17_055, 1 << 18):
        g, k = banded_dp.wide_shape(W, E, M)
        assert g in banded_dp.WIDE_LANES and k in banded_dp.WIDE_CELLS
        assert g * k >= cells
    for lanes in banded_dp.WIDE_LANES:
        if lanes * banded_dp.WIDE_CELLS[-1] >= cells:
            g, k = banded_dp.wide_shape(W, E, 100, lanes)
            assert g == lanes and g * k >= cells
            assert g * k < cells + g * k // 4 + g    # k no wider than needed
        else:
            with pytest.raises(ValueError, match="cannot hold a row"):
                banded_dp.wide_shape(W, E, 100, lanes)


def test_rows_past_the_kernel_are_refused_on_the_cpu():
    """Reads of 129 words (2,064 bases) at E = 1,024: a row of 2,049
    cells, more than 32 lanes of 64 cells hold; refused as on a card.  At
    E = 1,023 the band's 2,047 cells fit (offsets near the reads' ends
    keep the oracle's rows few)."""
    codes, lens, r1, r2, offs = _pairs(5, 2, 2040, 2064, 1990, 2020)
    args = _args(codes, lens, r1, r2, offs)
    assert args[0].shape[0] == 129
    with pytest.raises(ValueError, match="longer than the wide kernel"):
        banded_dp.banded_lcs(*args, 1024)
    np.testing.assert_array_equal(banded_dp.banded_lcs(*args, 1023).numpy(),
                                  _oracle(codes, lens, r1, r2, offs, 1023))


# ---------------------------------------------------------------------------
# the wide kernel, lane by lane

def _funnel(lo, hi, r):
    """__funnelshift_r(lo, hi, r) for r in [0, 31], on int64 words (bits
    r .. r+31 of hi:lo never reach the sign bit's wrap)."""
    return (((hi << 32) | lo) >> r) & M32


def _window_mask(first, lo, hi):
    """The kernel's window_mask: bits 2i of the 16 cells from `first` that
    lie in [lo, hi]."""
    a = np.clip(lo - first, 0, 16)
    b = np.clip(hi - first + 1, 0, 16)
    return (M32 << (2 * a)) & (M32 >> (32 - 2 * b)) & M32


def _shfl_up(x, delta):
    """__shfl_up_sync(x, delta, g) on [M, g]: a lane below delta keeps its
    own value."""
    out = x.copy()
    out[:, delta:] = x[:, :-delta]
    return out


def _shfl_down(x, delta):
    out = x.copy()
    out[:, :-delta] = x[:, delta:]
    return out


def emulate_wide_kernel(w1T, w2T, len1, len2, offsets, E, g, k):
    """int64[M]: csrc/banded_lcs_wide.cu's arithmetic in numpy, all pairs
    walking rows in step as a warp does: the staged streams, the frame,
    the match windows (the pad past the row's cells in every row, the
    band's ends in the rows a warp needs them), the k cells of each of
    the g lanes of a pair, the shuffles, the lane scan and the result
    row.  The kernel keeps read 1's word and read 2's window in registers
    across rows; here they are indexed afresh each row."""
    W, M = w1T.shape
    raw1 = w1T.T.astype(np.int64) & M32
    raw2 = w2T.T.astype(np.int64) & M32
    l1 = np.minimum(len1, 16 * W).astype(np.int64)
    l2 = np.minimum(len2, 16 * W).astype(np.int64)
    off = offsets.astype(np.int64)
    e = np.minimum(E, 16 * W + np.abs(off))
    p_beg = np.maximum(0, off - e)
    p_star = np.minimum(l1 - 1, l2 - 1 + off)
    q_star = np.minimum(l2 - 1, p_star - off + e)
    n = np.where(q_star < 0, 0, np.maximum(0, p_star - p_beg + 1))
    row = 2 * E + 1 > 16 * W
    assert min(2 * E + 1, 16 * W) <= g * k
    q0 = np.zeros(M, np.int64) if row else p_beg - off - e
    d_star = q_star if row else q_star - (p_star - off - e)
    n2 = W + (g * k + 15) // 16 + 1            # stream-2 words staged

    def stage(raw, n_words, u):
        def word(i):
            ok = (i >= 0) & (i < W)
            return np.where(ok, raw[np.arange(M), np.clip(i, 0, W - 1)], 0)
        kk, sh = u >> 4, 2 * (u & 15)
        return np.stack([_funnel(word(kk + c), word(kk + c + 1), sh)
                         for c in range(n_words)], 1)
    s1, s2 = stage(raw1, W, p_beg), stage(raw2, n2, q0)

    first = np.arange(g) * k                   # each lane's first cell
    cells = 16 * W if row else 2 * e[:, None] + 1
    warp = np.arange(M) // (32 // g)           # the warp of each pair
    v = np.zeros((M, g, k), np.int64)
    result = np.zeros(M, np.int64)
    for t in range(int(n.max(initial=0))):
        bc = ((s1[:, t >> 4] >> (2 * (t & 15))) & 3) * LANES
        p = p_beg + t
        qrow = q0 + (0 if row else t)
        lo = (np.maximum(0, p - off - e) - qrow)[:, None]
        hi = (p - off + e - qrow)[:, None]
        # the window mask runs in a warp where some lane has cells outside
        # [lo, hi] that the pad leaves set
        need = ((lo > first) | (hi < np.minimum(first + k, cells) - 1)).any(1)
        need = np.isin(warp, warp[need])[:, None]
        x = (0 if row else t) + first
        c, r = x >> 4, 2 * (x & 15)
        match = np.zeros((M, g, k), np.int64)
        for j in range((k + 15) // 16):
            assert (c + j + 1).max() < n2
            w = _funnel(s2[:, c + j], s2[:, c + j + 1], r) ^ bc[:, None]
            mb = (~(w | (w >> 1)) & LANES
                  & _window_mask(first + 16 * j, 0, cells - 1))
            mb = np.where(need, mb & _window_mask(first + 16 * j, lo, hi), mb)
            for i in range(16 * j, min(k, 16 * j + 16)):
                match[:, :, i] = (mb >> (2 * (i - 16 * j))) & 1
        if row:                # up keeps the cell, diag is the one before
            dg = _shfl_up(v[:, :, k - 1], 1)
            dg[:, 0] = 0
            diag = np.concatenate([dg[:, :, None], v[:, :, :-1]], 2)
            up = v
        else:                  # up is the next cell, diag the cell itself
            up = np.concatenate([v[:, :, 1:],
                                 _shfl_down(v[:, :, 0], 1)[:, :, None]], 2)
            diag = v
        run = np.maximum.accumulate(np.maximum(diag + match, up), axis=2)
        incl = run[:, :, k - 1]
        s = 1
        while s < g:
            incl = np.maximum(incl, _shfl_up(incl, s))
            s *= 2
        ex = _shfl_up(incl, 1)
        ex[:, 0] = 0
        v = np.maximum(run, ex[:, :, None])
        hit = np.flatnonzero(t == n - 1)
        result[hit] = v[hit].reshape(len(hit), g * k)[
            np.arange(len(hit)), d_star[hit]]
    return result


@pytest.mark.parametrize("lanes", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("E", [16, 24, 55, 56, 63, 1000])
def test_wide_kernel_emulation_matches_oracle(E, lanes):
    """The wide kernel's design, emulated, equals np_banded_lcs at every
    lane count, in the band frame (E <= 55 for reads of 7 words) and the
    row frame (E >= 56): ragged reads of 20-111 bases, offsets from -40
    to 110 (some past read 1's end), pairs aligned along the band's
    edges, a few reads of 1-3 bases."""
    codes, lens, r1, r2, offs = _pairs(100 + E, 64, 20, 112, -40, 110,
                                       edge=E)
    lens[r2[-3:]] = [1, 2, 3]
    args = [a.numpy() for a in _args(codes, lens, r1, r2, offs)]
    if lanes * banded_dp.WIDE_CELLS[-1] < min(2 * E + 1, 112):
        pytest.fail("every lane count holds a row of reads of 7 words")
    g, k = banded_dp.wide_shape(7, E, len(r1), lanes)
    got = emulate_wide_kernel(*args, E, g, k)
    np.testing.assert_array_equal(got, _oracle(codes, lens, r1, r2, offs, E))


def test_wide_cells_match_the_c_interface():
    """The C switch of alga_banded_lcs (csrc/banded_dp.cu) launches the
    wide kernel for exactly the cells per lane that wide_shape picks
    from, and the build instantiates each (ops/_cuda.py)."""
    import re
    from pathlib import Path
    src = (Path(banded_dp.__file__).parents[1] / "csrc" / "banded_dp.cu")
    cases = re.findall(r"ALGA_LCS_WIDE_CASE\((\d+)\)", src.read_text())
    assert tuple(sorted(map(int, cases))) == banded_dp.WIDE_CELLS
