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


def _pairs(rng, n_reads, m, E, read_len=120):
    """Pair-major words of m pairs of reads of read_len/2 to read_len - 1
    bases, read 2 a noisy suffix of read 1, as banded_dp.banded_lcs takes
    them."""
    lens = rng.integers(read_len // 2, read_len, n_reads)
    codes = rng.integers(0, 4, (n_reads, read_len)).astype(np.uint8)
    r1 = rng.integers(0, n_reads, m)
    r2 = (r1 + 1) % n_reads
    offs = rng.integers(0, read_len // 2, m)
    for a, o in zip(r1, offs):
        seg = codes[a, o:].copy()
        noise = rng.random(len(seg)) < 0.04
        seg[noise] = rng.integers(0, 4, noise.sum())
        codes[(a + 1) % n_reads, : len(seg)] = seg
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
                         + [16, 24, 31, 63, 255])
def test_banded_lcs_kernel_matches_plain(E, read_len, m, cuda_device):
    """Every band half-width of the register-band kernel and band
    half-widths of the wide one (E >= 16), at fewer pairs than the card
    has threads and at more than it holds at once; reads of 60-119 and of
    125-249 bases (unequal, mostly not a multiple of 16) at offsets up to
    half their length.  Each launch counts under its kernel's name."""
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
    args = [a.to(cuda_device) for a in _pairs(np.random.default_rng(1),
                                              50, 100, 2)]
    limit = banded_dp.max_band_half_width(args[0].shape[0])
    with pytest.raises(ValueError, match=f"outside \\[0, {limit}\\]"):
        banded_dp.banded_lcs(*args, limit + 1)
    assert banded_dp.banded_lcs(*args, limit).shape == (100,)
    with pytest.raises(ValueError):
        banded_dp.banded_lcs(args[0].to(torch.int64), *args[1:], 2)
    idx = torch.zeros((2, 10), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        banded_dp.gather_planes(args[0].T, args[2], idx)
    with pytest.raises(ValueError):
        banded_dp.gather_planes(args[0].T.contiguous(), args[2], idx[0])
