"""Banded LCS of read pairs: two CUDA kernels and their plain versions
(port of alga_tpu/ops/pallas/banded_dp.py).

  gather_planes  K1, replaces _gather_kernel / mxu_gather_planes with
                 _table_planes and _rows_from_planes around it: the words
                 and length of each pair's reads, pair-major, straight
                 from the row-major read table.
  banded_lcs     K2, replaces _dp_kernel / _banded_lcs_pallas_x32: the
                 ACLCS banded LCS of pairs whose words are laid out
                 pair-major ([W, M]).  Band half-widths 0..MAX_E run the
                 register-band kernel (csrc/banded_lcs.cu), wider ones
                 the lane kernel (csrc/banded_lcs_wide.cu: g lanes a
                 pair, each row a prefix max across them), which stands
                 in for alga_tpu's XLA route for 2E+1 > 16.

The kernels are in csrc/banded_dp.cu (K1, and the C interface of all
three), csrc/banded_lcs.cu and csrc/banded_lcs_wide.cu (K2).  Each
wrapper runs its plain PyTorch version (`gather_planes_plain`,
`banded_lcs_batch`) for a tensor on the CPU, launches its kernel for a
tensor on a GPU, and raises for anything else.  `LAUNCHES` counts kernel
launches, the two K2 kernels under their own names.
"""

from __future__ import annotations

import functools

import torch

from alga_tpu_torch.ops.bitops import M32

MAX_E = 15      # band half-widths 0..MAX_E are instantiated in K2
# the wide kernel (E > MAX_E): lanes per pair, and the row cells a lane
# holds in registers (csrc/banded_lcs_wide.cu is built once for each)
WIDE_LANES = (2, 4, 8, 16, 32)
WIDE_CELLS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 17, 20, 24, 28, 32, 40,
              48, 56, 64)
WIDE_FILL = 32     # threads per SM the lane choice gives the card at least

LAUNCHES = {"gather_planes": 0, "banded_lcs": 0, "banded_lcs_wide": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_gpu(what: str, *tensors) -> bool:
    """False for CPU tensors, True for CUDA ones; raises otherwise."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors on different devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    return True


def _check_int32(what: str, name: str, t: torch.Tensor, ndim: int) -> None:
    if t.dtype != torch.int32 or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous int32 tensor "
                         f"of {ndim} dims, got {t.dtype} {tuple(t.shape)}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# K1: pair rows of the read table

def gather_planes_plain(packed: torch.Tensor, lengths: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """int32[S, W+1, M]: for each side s, the words packed[idx[s, m]] and
    then lengths[idx[s, m]], pair-major; zeros where idx is outside
    [0, N)."""
    n, W = packed.shape
    S, M = idx.shape
    if n == 0:
        return torch.zeros((S, W + 1, M), dtype=torch.int32,
                           device=packed.device)
    table = torch.cat([packed.to(torch.int32),
                       lengths.to(torch.int32)[:, None]], 1)    # [N, W+1]
    ok = (idx >= 0) & (idx < n)
    got = table[idx.clamp(0, n - 1).to(torch.int64)]            # [S, M, W+1]
    return torch.where(ok[..., None], got, 0).transpose(1, 2).contiguous()


def gather_planes(packed: torch.Tensor, lengths: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    """int32[2, W+1, M]: the words and length of rows idx[s, m] of a read
    table (int32 packed [N, W], int32 lengths [N]) for both sides s of M
    pairs, pair-major; zeros where idx is outside [0, N).  out[s, :W] and
    out[s, W] are the contiguous [W, M] words and [M] lengths that K2
    takes."""
    if not _on_gpu("gather_planes", packed, lengths, idx):
        return gather_planes_plain(packed, lengths, idx)
    _check_int32("gather_planes", "packed", packed, 2)
    _check_int32("gather_planes", "lengths", lengths, 1)
    _check_int32("gather_planes", "idx", idx, 2)
    N, W = packed.shape
    if lengths.shape[0] != N or idx.shape[0] != 2:
        raise ValueError("gather_planes: lengths must be [N] beside packed "
                         "[N, W], and idx [2, M]")
    M = idx.shape[1]
    out = torch.empty((2, W + 1, M), dtype=torch.int32, device=packed.device)
    if M == 0:
        return out
    from alga_tpu_torch.ops import _cuda
    with torch.cuda.device(packed.device):
        rc = _cuda.lib().alga_gather_planes(
            packed.data_ptr(), lengths.data_ptr(), N, W, idx.data_ptr(), M,
            out.data_ptr(), _stream(packed.device))
    _cuda.check(rc, "gather_planes")
    LAUNCHES["gather_planes"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: banded LCS

def _unpack_words(wT: torch.Tensor) -> torch.Tensor:
    """int64[M, 16W] base codes of pair-major words int32[W, M]."""
    w = wT.T.to(torch.int64) & M32
    sh = 2 * torch.arange(16, device=wT.device)
    return ((w[:, :, None] >> sh) & 3).reshape(w.shape[0], -1)


def banded_lcs_batch(w1T, w2T, len1, len2, offsets, E: int = 2):
    """int32[M]: the banded LCS of ACLCS::calculateLCS (ref
    AlignmentControllerLCS.cpp:61-150), alga_tpu/ops/align.py:
    banded_lcs_batch's row scan: rows p in [max(0, off-E), len1), band q
    in [p-off-E, p-off+E] clipped to [0, len2); result cell
    p* = min(len1-1, len2-1+off), q* = min(len2-1, p*-off+E).

    Each row is computed as the wide kernel computes it: a[d] = diag + 1
    at a match, else up, over the whole row at once; then the row is the
    running max of a (`torch.cummax`), which is the `left` term (at a
    match left never exceeds diag + 1).  Cells outside the band or the
    read are 0, as in alga_tpu.  The row holds the band's 2E+1 cells
    (q = p-off-E+d), or, when the band is wider than the packed read
    (2E+1 > 16W), the read's 16W cells (q = d)."""
    c1 = _unpack_words(w1T)
    c2 = _unpack_words(w2T)
    M, L = c1.shape
    dev = w1T.device
    len1 = len1.to(torch.int64)
    len2 = len2.to(torch.int64)
    off = offsets.to(torch.int64)
    row_frame = 2 * E + 1 > L
    C = L if row_frame else 2 * E + 1
    p_beg = (off - E).clamp(min=0)
    p_star = torch.minimum(len1 - 1, len2 - 1 + off)
    q_star = torch.minimum(len2 - 1, p_star - off + E)
    if M == 0 or C == 0:
        return torch.zeros(M, dtype=torch.int32, device=dev)
    prev = torch.zeros((M, C), dtype=torch.int32, device=dev)
    cols = torch.arange(C, device=dev)[None, :]
    zero = torch.zeros((M, 1), dtype=torch.int32, device=dev)
    for p in range(int(p_beg.min()), min(L, int(p_star.max()) + 1)):
        in_row = (p >= p_beg) & (p <= p_star)
        q_lo = (p - off - E)[:, None]                   # the band's first q
        q = cols.expand(M, C) if row_frame else q_lo + cols
        valid = ((q >= 0) & (q < len2[:, None]) & (q >= q_lo)
                 & (q <= q_lo + 2 * E))
        match = (c1[:, p, None] == c2.gather(1, q.clamp(0, L - 1))) & valid
        if row_frame:                                   # up keeps d
            up, diag = prev, torch.cat([zero, prev[:, :-1]], 1)
        else:                                           # up is d + 1
            up, diag = torch.cat([prev[:, 1:], zero], 1), prev
        a = torch.where(match, diag + 1, torch.where(valid, up, 0))
        row = torch.where(valid, torch.cummax(a, 1).values, 0)
        prev = torch.where(in_row[:, None], row, prev)
    # a pair without rows, or with q* < 0 (len2 = 0), reads a cell of 0
    d_star = q_star if row_frame else q_star - (p_star - off - E)
    return prev.gather(1, d_star.clamp(0, C - 1)[:, None])[:, 0]


def wide_shape(W: int, E: int, M: int, lanes: int | None = None,
               n_sm: int = 132) -> tuple[int, int]:
    """(g, k) of a wide-kernel launch: g lanes per pair (WIDE_LANES), k
    row cells per lane (WIDE_CELLS), g * k >= the row's cells, which are
    min(2E+1, 16W) and do not grow with E past the read.  Without
    `lanes`, g is the fewest lanes that hold the row and give the n_sm
    SMs a warp each (M * g >= WIDE_FILL * n_sm), else the most: each lane
    more a pair adds its scan and its row overhead, which cost more than
    the latency they hide down to ~1 warp an SM (on an H100 at E = 16,
    2 lanes were fastest at 2^18, 17,067 and 4,888 pairs; chip_smoke.py
    times every lane count).  Raises when no (g, k) holds the row (reads
    of more than 2048 bases at E > 1023)."""
    cells = max(1, min(2 * E + 1, 16 * W))

    def k_for(g):
        return next((k for k in WIDE_CELLS if g * k >= cells), None)
    if lanes is not None:
        if lanes not in WIDE_LANES or k_for(lanes) is None:
            raise ValueError(f"banded_lcs: {lanes} lanes per pair cannot "
                             f"hold a row of {cells} cells (lanes "
                             f"{WIDE_LANES}, at most {WIDE_CELLS[-1]} cells "
                             "a lane)")
        return lanes, k_for(lanes)
    fits = [g for g in WIDE_LANES if k_for(g) is not None]
    if not fits:
        raise ValueError(f"banded_lcs: a row of {cells} cells (E={E}, "
                         f"W={W}) is longer than the wide kernel holds, "
                         f"{WIDE_LANES[-1] * WIDE_CELLS[-1]} cells")
    g = next((g for g in fits if M * g >= WIDE_FILL * n_sm), fits[-1])
    return g, k_for(g)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def banded_lcs(w1T, w2T, len1, len2, offsets, E: int = 2, *,
               _lanes: int | None = None) -> torch.Tensor:
    """int32[M]: banded LCS of M pairs given pair-major words int32[W, M]
    of both reads, their lengths and offsets (int32[M]), at any band
    half-width E >= 0.  `_lanes` forces the wide kernel's lanes per pair
    (E > MAX_E; for tests and chip_smoke.py).  The wide kernel's shape
    (wide_shape) is checked on every device, so a row the card cannot
    hold is refused on the CPU too."""
    if E < 0:
        raise ValueError(f"banded_lcs: band half-width E={E} < 0")
    gpu = _on_gpu("banded_lcs", w1T, w2T, len1, len2, offsets)
    g = k = 0
    if E > MAX_E:
        g, k = wide_shape(w1T.shape[0], E, w1T.shape[-1], _lanes,
                          _sm_count(w1T.device.index) if gpu else 132)
    if not gpu:
        return banded_lcs_batch(w1T, w2T, len1, len2, offsets, E)
    for name, t, nd in (("w1T", w1T, 2), ("w2T", w2T, 2), ("len1", len1, 1),
                        ("len2", len2, 1), ("offsets", offsets, 1)):
        _check_int32("banded_lcs", name, t, nd)
    W, M = w1T.shape
    if w2T.shape != w1T.shape or any(t.shape[0] != M
                                     for t in (len1, len2, offsets)):
        raise ValueError("banded_lcs: w1T and w2T must be [W, M] and the "
                         "lengths and offsets [M]")
    out = torch.empty(M, dtype=torch.int32, device=w1T.device)
    if M == 0:
        return out
    from alga_tpu_torch.ops import _cuda
    with torch.cuda.device(w1T.device):
        rc = _cuda.lib().alga_banded_lcs(
            w1T.data_ptr(), w2T.data_ptr(), W, M, len1.data_ptr(),
            len2.data_ptr(), offsets.data_ptr(), E, g, k, out.data_ptr(),
            _stream(w1T.device))
    name = "banded_lcs" if E <= MAX_E else "banded_lcs_wide"
    _cuda.check(rc, name)
    LAUNCHES[name] += 1
    return out
