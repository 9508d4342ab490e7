"""Rolling polynomial window hashes over packed 2-bit reads
(port of alga_tpu/ops/hashes.py).

h(window) = sum_j code[p+j] * A^(k-1-j) mod 2^32, for the two odd
multipliers A1 and A2.  Torch has no logical shifts or searchsorted on
uint32, so hashes are carried as int64 masked to 32 bits: the product of
two 32-bit values wraps in int64 but keeps its low 32 bits, and every
value is masked before it is compared, sorted or shifted.  The keys are
bit-identical to the JAX kernel's, because join order follows them.
(The JAX module's `_pows` table is Python's `pow(a, k, 2**32)` here.)

`window_keys` picks the device scan or a host pass (the native rolling
hash, else the numpy closed form `np_window_kmer_keys`) by the JAX
module's rule, and returns the combined uint64 keys of the host join.
"""

from __future__ import annotations

import numpy as np
import torch

from alga_tpu_torch import device as device_mod
from alga_tpu_torch import native
from alga_tpu_torch.core import packing
from alga_tpu_torch.store import words_as_int32

A1 = 0x9E3779B1
A2 = 0x85EBCA6B
M32 = 0xFFFFFFFF


def _base_column(packed: torch.Tensor, p: int) -> torch.Tensor:
    """int64 base code of every read at position p.  The word index is
    clamped to the last word, as the JAX kernel's dynamic_slice clamps."""
    w = min(p >> 4, packed.shape[1] - 1)
    return (packed[:, w].to(torch.int64) >> (2 * (p & 15))) & 3


def _rolling_hash(packed: torch.Tensor, k: int, num_windows: int,
                  a: int) -> torch.Tensor:
    """int64[N, num_windows]: the hash of window [p, p+k) of every read
    under multiplier `a`, rolled one position at a time."""
    n = packed.shape[0]
    ak = pow(a, k, 1 << 32)
    h = torch.zeros(n, dtype=torch.int64, device=packed.device)
    for j in range(k):
        h = (h * a + _base_column(packed, j)) & M32
    max_pos = packed.shape[1] * 16 - 1
    out = torch.empty((n, num_windows), dtype=torch.int64,
                      device=packed.device)
    for p in range(num_windows):
        out[:, p] = h
        b_out = _base_column(packed, p)
        b_in = _base_column(packed, min(p + k, max_pos))
        h = (h * a + b_in - b_out * ak) & M32
    return out


def window_kmer_keys_u32(packed: torch.Tensor, lengths: torch.Tensor,
                         k: int, num_windows: int):
    """(h1 int64[N, P], h2 int64[N, P], valid bool[N, P]): h(i, p) hashes
    read i bases [p, p+k); valid iff p + k <= len_i.  `packed` holds the
    uint32 words as int32."""
    k1 = _rolling_hash(packed, k, num_windows, A1)
    k2 = _rolling_hash(packed, k, num_windows, A2)
    pos = torch.arange(num_windows, device=packed.device)[None, :]
    valid = pos + k <= lengths.to(torch.int64)[:, None]
    return k1, k2, valid


# ---------------------------------------------------------------------------
# host side (port of alga_tpu/ops/hashes.py:47-56,115-182)

def combine_keys(h1: np.ndarray, h2: np.ndarray) -> np.ndarray:
    """uint64 key h1 << 32 | h2 of two uint32 hashes, built in place."""
    out = h1.astype(np.uint64)
    out <<= np.uint64(32)
    out |= h2
    return out


def np_window_kmer_keys(codes: np.ndarray, lengths, k: int,
                        num_windows: int):
    """(h1 uint32[N, P], h2 uint32[N, P], valid bool[N, P]) over a base-code
    matrix uint8[N, L], in closed form with no loop over positions:

        h(p) = sum_j c[p+j] * A^(k-1-j)          (mod 2^32)
             = A^(k-1+p) * (T(p+k) - T(p)),  T(m) = sum_{i<m} c[i] * A^-i

    (A odd, so invertible mod 2^32; cumsum and cumprod wrap in uint32)."""
    n, lpad = codes.shape
    lengths = np.asarray(lengths, dtype=np.int64)
    L = max(lpad, k + num_windows)
    c = codes.astype(np.uint32)
    if lpad < L:
        c = np.pad(c, ((0, 0), (0, L - lpad)))

    def _keys(a: int) -> np.ndarray:
        inv_pows = np.ones(L, dtype=np.uint32)
        inv_pows[1:] = pow(a, -1, 1 << 32)
        np.cumprod(inv_pows, out=inv_pows)          # A^-i
        fwd_pows = np.ones(k + num_windows, dtype=np.uint32)
        fwd_pows[1:] = a
        np.cumprod(fwd_pows, out=fwd_pows)          # A^i
        T = np.zeros((n, L + 1), dtype=np.uint32)
        np.cumsum(c * inv_pows[None, :], axis=1, out=T[:, 1:])
        p = np.arange(num_windows)
        return fwd_pows[k - 1 + p][None, :] * (T[:, p + k] - T[:, p])

    pos = np.arange(num_windows, dtype=np.int64)[None, :]
    return _keys(A1), _keys(A2), pos + k <= lengths[:, None]


def window_keys(packed, codes_or_none, lengths, k: int, num_windows: int,
                prefer_device: bool | None = None, *, device=None):
    """(key uint64[N, P], valid bool[N, P]) of the numpy read store
    (`packed` uint32[N, W], or only the codes uint8[N, L]).

    The device scan wins for large batches of short reads, the host for
    tiny batches or very long sequences; on the CPU the native rolling
    hash beats the scan and is taken whenever the engine is loaded."""
    n = packed.shape[0] if packed is not None else codes_or_none.shape[0]
    if prefer_device is None:
        prefer_device = (n * num_windows >= 1 << 18) and (num_windows <= 4096)
        if device_mod.resolve(device).type == "cpu" and native.available():
            prefer_device = False
    if prefer_device and packed is not None:
        dev = device_mod.resolve(device)
        k1, k2, valid = window_kmer_keys_u32(
            torch.from_numpy(words_as_int32(packed)).to(dev),
            torch.from_numpy(np.asarray(lengths, dtype=np.int64)).to(dev),
            k, num_windows)
        return (combine_keys(*(h.cpu().numpy().astype(np.uint32)
                               for h in (k1, k2))), valid.cpu().numpy())
    if codes_or_none is None:
        codes_or_none = packing.packed_to_codes(packed)
    lengths = np.asarray(lengths, dtype=np.int64)
    pos = np.arange(num_windows, dtype=np.int64)[None, :]
    valid = pos + k <= lengths[:, None]
    if native.available():
        return native.window_hash(codes_or_none, k, num_windows, A1,
                                  A2), valid
    k1, k2, _ = np_window_kmer_keys(codes_or_none, lengths, k, num_windows)
    return combine_keys(k1, k2), valid
