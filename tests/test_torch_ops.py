"""The port's ops (alga_tpu_torch/ops) against the JAX package's, on the
CPU: window hashes, packed compares, ACLER, the banded LCS and its row
gather.  Every output is an integer or a bool, so every comparison is
exact.  The CUDA kernels themselves are held against these plain
versions on a GPU by tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

from alga_tpu.config import AssemblyConfig, autotune, supplement_retune
from alga_tpu.core import packing
from alga_tpu.ops import align as jalign
from alga_tpu.ops import bitops as jbitops
from alga_tpu.ops import hashes as jhashes
from alga_tpu.ops.pallas import banded_dp as jbd
from alga_tpu_torch.graph import device_scale
from alga_tpu_torch.ops import align, banded_dp, bitops, hashes

torch.set_num_threads(2)


def _t(a, dtype=torch.int64):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _words(packed):
    return torch.from_numpy(packed.view(np.int32).copy())


def _random_reads(rng, n, lo, hi):
    lens = rng.integers(lo, hi, size=n)
    codes = np.zeros((n, hi), dtype=np.uint8)
    for i, L in enumerate(lens):
        codes[i, :L] = rng.integers(0, 4, size=L)
    return codes, lens.astype(np.int64), packing.codes_to_packed(codes, lens)


def _overlapping_pairs(rng, codes, m, err):
    """r2 = a noisy suffix of r1 at a random offset (varied lengths)."""
    n, L = codes.shape
    r1 = rng.integers(0, n, m)
    offs = rng.integers(0, L // 2, m)
    for a, o in zip(r1, offs):
        seg = codes[a, o:].copy()
        noise = rng.random(len(seg)) < err
        seg[noise] = rng.integers(0, 4, noise.sum())
        codes[(a + 1) % n, : len(seg)] = seg
    return r1, (r1 + 1) % n, offs


@pytest.mark.parametrize("k", [5, 12, 31])
def test_window_keys_bit_identical(rng, k):
    """All keys, valid or not, equal the JAX scan's, including reads
    shorter than k and hashes with the top bit set."""
    codes, lens, _ = _random_reads(rng, 60, 3, 90)
    lens[:3] = [1, k - 1, k]
    packed = packing.codes_to_packed(codes, lens)
    nw = 90 - k + 1
    k1, k2, v = jhashes.window_kmer_keys_u32(packed, lens, k, nw)
    t1, t2, tv = hashes.window_kmer_keys_u32(_words(packed), _t(lens), k, nw)
    np.testing.assert_array_equal(t1.numpy(), np.asarray(k1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(k2))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v))
    assert (lens < k).any() and int(t1.max()) >= 1 << 31


def test_prefix_keys_are_window_zero(rng):
    _, lens, packed = _random_reads(rng, 40, 10, 70)
    k1, _, _ = jhashes.window_kmer_keys_u32(packed, lens, 20, 1)
    at = rng.random(40) < 0.7
    h, valid = device_scale._prefix_keys(_words(packed), _t(lens),
                                         _t(at, torch.bool), 20)
    np.testing.assert_array_equal(h.numpy(), np.asarray(k1)[:, 0])
    np.testing.assert_array_equal(valid.numpy(), (lens >= 20) & at)


def test_substr_equal_matches_jax(rng):
    codes, lens, packed = _random_reads(rng, 50, 40, 80)
    m = 400
    a = rng.integers(0, 50, m)
    b = rng.integers(0, 50, m)
    starts = rng.integers(0, 30, m)
    ml = rng.integers(0, 40, m)
    for i in range(0, m, 3):                 # plant true matches
        codes[b[i], : ml[i]] = codes[a[i], starts[i]: starts[i] + ml[i]]
    packed = packing.codes_to_packed(codes, lens)
    want = np.asarray(jbitops.substr_equal(packed, a, starts, b, ml, 3))
    got = bitops.substr_equal(_words(packed), _t(a), _t(starts), _t(b),
                              _t(ml), 3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_acler_batch_matches_jax(rng):
    codes, lens, _ = _random_reads(rng, 40, 60, 100)
    r1, r2, offs = _overlapping_pairs(rng, codes, 300, 0.02)
    packed = packing.codes_to_packed(codes, lens)
    args = (packing.words_for(100), 70, 20, 90, 3)
    want = np.asarray(jalign.acler_batch(packed, lens, r1, r2, offs, *args))
    got = align.acler_batch(_words(packed), _t(lens), _t(r1), _t(r2),
                            _t(offs), *args)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def _pair_words(packed, lens, r1, r2):
    """Pair-major words and lengths, as the kernel wrapper takes them."""
    w = torch.from_numpy(packed.view(np.int32).T.copy())
    l32 = _t(lens, torch.int32)
    r1, r2 = _t(r1), _t(r2)
    return (w[:, r1].contiguous(), w[:, r2].contiguous(), l32[r1], l32[r2])


@pytest.mark.parametrize("E", [1, 2, 3, 7])
def test_banded_lcs_batch_matches_jax(E):
    """The plain version against the literal oracle, the XLA row loop and
    the Pallas kernel in interpret mode (as tests/test_pallas.py runs it)."""
    rng = np.random.default_rng(100 + E)
    codes, lens, _ = _random_reads(rng, 25, 40, 64)
    r1, r2, offs = _overlapping_pairs(rng, codes, 200, 0.05)
    packed = packing.codes_to_packed(codes, lens)
    w1T, w2T, len1, len2 = _pair_words(packed, lens, r1, r2)
    got = banded_dp.banded_lcs_batch(w1T, w2T, len1, len2,
                                     _t(offs, torch.int32), E).numpy()
    oracle = np.array([jalign.np_banded_lcs(codes, lens, a, b, int(o), E)
                       for a, b, o in zip(r1, r2, offs)])
    xla = np.asarray(jalign.banded_lcs_batch(codes, lens, r1, r2, offs, 64, E))
    pallas = np.asarray(jbd.banded_lcs_pallas(codes, lens, r1, r2, offs, 64,
                                              E, interpret=True))
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("M", [1, 333])
@pytest.mark.parametrize("W", [1, 7, 8])
def test_gather_planes_plain_matches_jax(rng, W, M):
    """K1's plain version against the TPU path it replaces end to end:
    _rows_from_planes(mxu_gather_planes(_table_planes(...), idx)), the
    Pallas gather in interpret mode, for each side of the pairs; indices
    outside [0, N) give zeros."""
    import jax
    import jax.numpy as jnp
    n = 100
    packed = rng.integers(0, 2**32, (n, W), dtype=np.uint64).astype(np.uint32)
    lengths = rng.integers(0, 16 * W + 1, n).astype(np.int32)
    idx = rng.integers(-20, n + 30, (2, M)).astype(np.int32)
    idx[0, 0] = -1                       # out of range on both sides
    idx[1, -1] = n
    want = []
    with jax.enable_x64(False):
        planes = jbd._table_planes(jnp.asarray(packed), jnp.asarray(lengths))
        for side in idx:
            words, lens = jbd._rows_from_planes(jbd.mxu_gather_planes(
                planes, jnp.asarray(side), interpret=True), W)
            want.append(np.concatenate([np.asarray(words).view(np.int32),
                                        np.asarray(lens)[None]]))
    want = np.stack(want)
    args = (torch.from_numpy(packed.view(np.int32)),
            torch.from_numpy(lengths), torch.from_numpy(idx))
    got = banded_dp.gather_planes_plain(*args)
    assert got.shape == (2, W + 1, M)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[0, :, 0].any() and not want[1, :, -1].any()
    # the wrapper takes the plain version for a CPU tensor and counts no launch
    banded_dp.reset_launches()
    np.testing.assert_array_equal(banded_dp.gather_planes(*args).numpy(), want)
    assert banded_dp.LAUNCHES == {"gather_planes": 0, "banded_lcs": 0,
                                  "banded_lcs_wide": 0}


def test_align_banded_lcs_on_packed_table(rng):
    """The ACLCS entry: row gather + DP from the packed table equals the
    oracle, at E = 2 and at E = 16 (the wide kernel's band on a card,
    which alga_tpu runs through its XLA route); band half-widths past the
    kernels' limit for the table's width raise, on the CPU as on a card."""
    codes, lens, _ = _random_reads(rng, 30, 50, 100)
    r1, r2, offs = _overlapping_pairs(rng, codes, 150, 0.04)
    packed = packing.codes_to_packed(codes, lens)
    args = (_words(packed), _t(lens, torch.int32), _t(r1), _t(r2), _t(offs))
    for E in (2, 16):
        got = align.banded_lcs(*args, E)
        want = [jalign.np_banded_lcs(codes, lens, a, b, int(o), E)
                for a, b, o in zip(r1, r2, offs)]
        np.testing.assert_array_equal(got.numpy(), want)
    limit = banded_dp.max_band_half_width(packed.shape[1])
    assert limit >= 255
    for E in (-1, limit + 1):
        with pytest.raises(ValueError, match=f"outside \\[0, {limit}\\]"):
            align.banded_lcs(*args, E)


@pytest.mark.parametrize("min_device_batch", [0, 10**9])
def test_ach_batch_auto_aclcs_matches_jax(rng, min_device_batch):
    """ACH with the LCS fallback on (use_acler_instead_of_aclcs=False),
    through the device path (acler_batch + banded_lcs) and the numpy path."""
    codes, lens, _ = _random_reads(rng, 60, 80, 100)
    r1, r2, offs = _overlapping_pairs(rng, codes, 400, 0.03)
    packed = packing.codes_to_packed(codes, lens)
    cfg = supplement_retune(
        autotune(AssemblyConfig(error_rate=0.02,
                                use_acler_instead_of_aclcs=False), 90), 90)
    want = jalign.ach_batch_auto(packed, None, lens, r1, r2, offs, cfg,
                                 min_device_batch=min_device_batch)
    got = align.ach_batch_auto(packed, None, lens, r1, r2, offs, cfg,
                               min_device_batch=min_device_batch,
                               device="cpu")
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
