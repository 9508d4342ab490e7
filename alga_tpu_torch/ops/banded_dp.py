"""Banded LCS of read pairs: two CUDA kernels and their plain versions
(port of alga_tpu/ops/pallas/banded_dp.py).

  gather_planes  K1, replaces _gather_kernel / mxu_gather_planes with
                 _table_planes and _rows_from_planes around it: the words
                 and length of each pair's reads, pair-major, straight
                 from the row-major read table.
  banded_lcs     K2, replaces _dp_kernel / _banded_lcs_pallas_x32: the
                 ACLCS banded LCS of pairs whose words are laid out
                 pair-major ([W, M]).

The kernels are in csrc/banded_dp.cu (K1, and the C interface of both)
and csrc/banded_lcs.cu (K2).  Each wrapper runs its plain
PyTorch version (`gather_planes_plain`, `banded_lcs_batch`) for a tensor
on the CPU, launches its kernel for a tensor on a GPU, and raises for
anything else.  `LAUNCHES` counts kernel launches per wrapper.
"""

from __future__ import annotations

import torch

from alga_tpu_torch.ops.bitops import M32

MAX_E = 15      # band half-widths 0..MAX_E are instantiated in K2

LAUNCHES = {"gather_planes": 0, "banded_lcs": 0}


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
    AlignmentControllerLCS.cpp:61-150), the row loop of
    alga_tpu/ops/align.py:banded_lcs_batch on [M, B] tensors: rows p in
    [max(0, off-E), len1), band q in [p-off-E, p-off+E] clipped to
    [0, len2); result cell p* = min(len1-1, len2-1+off),
    q* = min(len2-1, p*-off+E)."""
    c1 = _unpack_words(w1T)
    c2 = _unpack_words(w2T)
    M, L = c1.shape
    B = 2 * E + 1
    len1 = len1.to(torch.int64)
    len2 = len2.to(torch.int64)
    off = offsets.to(torch.int64)
    p_beg = (off - E).clamp(min=0)
    p_star = torch.minimum(len1 - 1, len2 - 1 + off)
    q_star = torch.minimum(len2 - 1, p_star - off + E)
    prev = torch.zeros((M, B), dtype=torch.int64, device=w1T.device)
    if M == 0:
        return prev[:, 0].to(torch.int32)
    band = torch.arange(-E, E + 1, device=w1T.device)[None, :]
    zero = torch.zeros(M, dtype=torch.int64, device=w1T.device)
    for p in range(min(L, int(p_star.max()) + 1)):
        q_of = p - off[:, None] + band                      # [M, B]
        in_row = (p >= p_beg) & (p <= p_star) & (p < len1)
        q_valid = (q_of >= 0) & (q_of < len2[:, None]) & in_row[:, None]
        a = c1[:, p]
        b = c2.gather(1, q_of.clamp(0, L - 1))
        match = (a[:, None] == b) & q_valid
        left = zero
        cols = []
        for e in range(B):
            up = prev[:, e + 1] if e + 1 < B else zero
            val = torch.where(match[:, e], prev[:, e] + 1,
                              torch.maximum(up, left))
            val = torch.where(q_valid[:, e], val, 0)
            left = val
            cols.append(val)
        prev = torch.where(in_row[:, None], torch.stack(cols, 1), prev)
    e_star = (q_star - (p_star - off) + E).clamp(0, B - 1)
    return prev.gather(1, e_star[:, None])[:, 0].to(torch.int32)


def banded_lcs(w1T, w2T, len1, len2, offsets, E: int = 2) -> torch.Tensor:
    """int32[M]: banded LCS of M pairs given pair-major words int32[W, M]
    of both reads, their lengths and offsets (int32[M])."""
    if not 0 <= E <= MAX_E:
        raise ValueError(f"banded_lcs: band half-width E={E} is outside "
                         f"[0, {MAX_E}]")
    if not _on_gpu("banded_lcs", w1T, w2T, len1, len2, offsets):
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
            len2.data_ptr(), offsets.data_ptr(), E, out.data_ptr(),
            _stream(w1T.device))
    _cuda.check(rc, "banded_lcs")
    LAUNCHES["banded_lcs"] += 1
    return out
