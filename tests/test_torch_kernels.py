"""The CUDA kernels of alga_tpu_torch against their plain PyTorch
versions, on a GPU.  Every test is marked `cuda` and skips without a
CUDA device.  The file imports no jax, so that it also runs on a machine
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from alga_tpu_torch.core import packing
from alga_tpu_torch.ops import align, banded_dp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _pairs(rng, n_reads, m, E, read_len=120, edge=False):
    """Pair-major words of m pairs of reads of read_len/2 to read_len - 1
    bases, read 2 a noisy suffix of read 1, as banded_dp.banded_lcs takes
    them.  With `edge`, half the pairs' read 2 follows read 1 along the
    band's last or first diagonal or the one past it (a copy from offset
    off - E, off + E, off - E - 1 or off + E + 1 on)."""
    lens = rng.integers(read_len // 2, read_len, n_reads)
    codes = rng.integers(0, 4, (n_reads, read_len)).astype(np.uint8)
    r1 = rng.integers(0, n_reads, m)
    r2 = (r1 + 1) % n_reads
    offs = rng.integers(0, read_len // 2, m)
    shifts = offs.copy()
    if edge:
        at = np.arange(0, m, 2)
        shifts[at] += np.array([-E, E, -E - 1, E + 1])[(at // 2) % 4]
    for a, o in zip(r1, shifts):
        seg = codes[a, max(o, 0):].copy()
        noise = rng.random(len(seg)) < 0.04
        seg[noise] = rng.integers(0, 4, noise.sum())
        codes[(a + 1) % n_reads, max(-o, 0):max(-o, 0) + len(seg)] = \
            seg[:read_len - max(-o, 0)]
    words = torch.from_numpy(
        packing.codes_to_packed(codes, lens).view(np.int32).T.copy())
    l32 = torch.from_numpy(lens.astype(np.int32))
    r1, r2 = torch.from_numpy(r1), torch.from_numpy(r2)
    return (words[:, r1].contiguous(), words[:, r2].contiguous(), l32[r1],
            l32[r2], torch.from_numpy(offs.astype(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 7, 8])
def test_gather_planes_kernel_matches_plain(W, cuda_device):
    rng = np.random.default_rng(W)
    n = 5000
    packed = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, (n, W)).astype(np.int32))
    lengths = torch.from_numpy(rng.integers(0, 16 * W + 1, n)
                               .astype(np.int32))
    idx = torch.from_numpy(rng.integers(-100, n + 100, (2, 20001))
                           .astype(np.int32))
    before = banded_dp.LAUNCHES["gather_planes"]
    got = banded_dp.gather_planes(packed.to(cuda_device),
                                  lengths.to(cuda_device),
                                  idx.to(cuda_device))
    torch.cuda.synchronize()
    assert banded_dp.LAUNCHES["gather_planes"] == before + 1
    want = banded_dp.gather_planes_plain(packed, lengths, idx)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3001, 270_337], ids=["small", "large"])
@pytest.mark.parametrize("read_len", [120, 250])
@pytest.mark.parametrize("E", list(range(banded_dp.MAX_E + 1))
                         + [16, 24, 31, 63, 255, 1000, 10_000])
def test_banded_lcs_kernel_matches_plain(E, read_len, m, cuda_device):
    """Every band half-width of the register-band kernel and band
    half-widths of the wide one (E >= 16; from E = 63 at 120 bases and
    E = 255 at 250 the row frame of the read's 16W cells), at fewer pairs
    than the card has threads and at more than it holds at once; reads of
    60-119 and of 125-249 bases (unequal, mostly not a multiple of 16) at
    offsets up to half their length.  Each launch counts under its
    kernel's name."""
    args = [a.to(cuda_device) for a in _pairs(
        np.random.default_rng(E), 300, m, E, read_len)]
    want = banded_dp.banded_lcs_batch(*args, E)
    banded_dp.reset_launches()
    got = banded_dp.banded_lcs(*args, E)
    torch.cuda.synchronize()
    name = "banded_lcs" if E <= banded_dp.MAX_E else "banded_lcs_wide"
    assert banded_dp.LAUNCHES[name] == 1
    assert sum(banded_dp.LAUNCHES.values()) == 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", list(banded_dp.WIDE_LANES))
@pytest.mark.parametrize("read_len", [120, 250])
@pytest.mark.parametrize("E", [16, 31, 55, 1000])
def test_banded_lcs_wide_kernel_at_every_lane_count(E, read_len, lanes,
                                                    cuda_device):
    """The wide kernel with its lanes per pair forced to each of
    WIDE_LANES, on 20,001 pairs, half of them aligned along the band's
    edges: equal to the plain version wherever that many lanes hold the
    row (2E+1 cells, or 16W past the read), refused with a ValueError
    where they do not, on the card and the CPU alike."""
    args = [a.to(cuda_device) for a in _pairs(
        np.random.default_rng(E + lanes), 300, 20_001, E, read_len,
        edge=True)]
    W = args[0].shape[0]
    if lanes * banded_dp.WIDE_CELLS[-1] < min(2 * E + 1, 16 * W):
        for a in (args, [t.cpu() for t in args]):
            with pytest.raises(ValueError, match="cannot hold a row"):
                banded_dp.banded_lcs(*a, E, _lanes=lanes)
        return
    want = banded_dp.banded_lcs_batch(*args, E)
    banded_dp.reset_launches()
    got = banded_dp.banded_lcs(*args, E, _lanes=lanes)
    torch.cuda.synchronize()
    assert banded_dp.LAUNCHES["banded_lcs_wide"] == 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_align_banded_lcs_launches_each_kernel_once(cuda_device):
    rng = np.random.default_rng(5)
    lens = rng.integers(60, 120, 400)
    codes = rng.integers(0, 4, (400, 120)).astype(np.uint8)
    packed = torch.from_numpy(packing.codes_to_packed(codes, lens)
                              .view(np.int32))
    lengths = torch.from_numpy(lens.astype(np.int32))
    r1, r2 = (torch.from_numpy(rng.integers(0, 400, 3000)) for _ in "ab")
    offs = torch.from_numpy(rng.integers(0, 50, 3000))
    want = align.banded_lcs(packed, lengths, r1, r2, offs, 3)
    banded_dp.reset_launches()
    got = align.banded_lcs(*(t.to(cuda_device) for t in
                             (packed, lengths, r1, r2, offs)), 3)
    assert banded_dp.LAUNCHES == {"gather_planes": 1, "banded_lcs": 1,
                                  "banded_lcs_wide": 0}
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_kernels_refuse_bad_input(cuda_device):
    """Past the band limit the port had until the wide kernel held its row
    in registers (847 at W = 8), and at E = 10,000, the kernel equals the
    plain version; a negative band half-width, and tensors of the wrong
    type or shape, raise."""
    args = [a.to(cuda_device) for a in _pairs(np.random.default_rng(1),
                                              50, 100, 2)]
    assert args[0].shape[0] == 8
    for E in (847, 10_000):
        np.testing.assert_array_equal(
            banded_dp.banded_lcs(*args, E).cpu().numpy(),
            banded_dp.banded_lcs_batch(*args, E).cpu().numpy())
    with pytest.raises(ValueError, match="E=-1 < 0"):
        banded_dp.banded_lcs(*args, -1)
    with pytest.raises(ValueError):
        banded_dp.banded_lcs(args[0].to(torch.int64), *args[1:], 2)
    idx = torch.zeros((2, 10), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        banded_dp.gather_planes(args[0].T, args[2], idx)
    with pytest.raises(ValueError):
        banded_dp.gather_planes(args[0].T.contiguous(), args[2], idx[0])
