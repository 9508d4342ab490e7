// K2 banded_lcs_wide, the hand-written Hopper (sm_90a) kernel of the
// ACLCS banded LCS for band half-widths E >= 16; banded_dp.cu holds the C
// interface that launches it (alga_banded_lcs sends E >= 16 here, and
// E = 0..15 to the register-band kernel of banded_lcs.cu).
//
//   Replaces: alga_tpu's XLA route for bands wider than 16 cells.  The
//     entry of _dp_kernel (banded_lcs_pallas,
//     alga_tpu/ops/pallas/banded_dp.py:259) sends 2E+1 > 16 to the XLA
//     row scan banded_lcs_batch (:274-279, alga_tpu/ops/align.py:104),
//     because the Pallas kernel extracts a band from one 32-bit window.
//   Computes: the same ACLCS banded LCS as banded_lcs.cu (ref
//   AlignmentControllerLCS.cpp:61-150), with E a runtime argument: rows
//   p >= max(0, off-E), band of B = 2E+1 cells d at q = p-off-E+d, a cell
//   valid for 0 <= q < len2, result at (p*, q*) with
//   p* = min(len1-1, len2-1+off), q* = min(len2-1, p*-off+E).
//   Bound: integer ALU, 3 operations per band cell (the match bit, one
//   add-max, the max with left; chip_smoke.k2_bound); words read once.
//   Design:
//   - One pair per thread, as in banded_lcs.cu, and the same frame: rows
//     counted from each pair's first row, both reads staged once in
//     shared memory already shifted into that frame (stream 2 position t
//     holds the read-2 base of row t's band cell 0), so a warp walks its
//     rows in step and the row loop touches no device memory.
//   - The band (2E+2 cells, the last the `up` value past the band's end,
//     always 0) lives in shared memory, column j for thread j, so that a
//     warp's accesses fall in 32 different banks.  Each cell reads `up`
//     once and writes itself once; `diag` is the previous cell's `up`,
//     `left` the previous cell's value, both in registers.
//   - The band is walked in slices of 16 cells: one funnel shift of two
//     stream-2 words and one XOR with read 1's base broadcast over the
//     2-bit lanes give a slice's 16 match bits.  Read 2's window is
//     ceil((2E+1)/16) + 1 stream words.
//   - Cell update v = max(up, diag + match, left), no validity test, as in
//     banded_lcs.cu: cells with q >= len2 never flow into the result cell;
//     cells with q < 0 stay 0 because their match bits are cleared in the
//     first 2E rows.
//   - The thread reads its result, band[d*] after row p*, at that row;
//     later rows compute values nobody reads.
//   - Block size: 128 threads where the block's shared memory,
//     (2W + ceil((2E+1)/16) + 2E+2) words a pair, fits 227 KB, else 64,
//     else 32.  At 32 that is E <= 823 for W = 32 (reads of 512 bases);
//     ops/banded_dp.py:max_band_half_width refuses wider bands first.

#include <cuda_runtime.h>

namespace alga_k2w {

constexpr unsigned kLanes = 0x55555555u;  // bit 0 of every 2-bit lane
constexpr size_t kSmemLimit = 232448;     // a block's shared memory, bytes

__global__ void banded_lcs_wide_kernel(const int* __restrict__ w1T,
                                       const int* __restrict__ w2T, int W,
                                       long long M,
                                       const int* __restrict__ len1,
                                       const int* __restrict__ len2,
                                       const int* __restrict__ offsets,
                                       int E, int* __restrict__ out) {
  extern __shared__ unsigned smem[];
  const int T = blockDim.x;
  const int j = threadIdx.x;          // each thread owns column j
  const int B = 2 * E + 1;
  const int K = (B + 15) >> 4;        // slices of 16 band cells
  unsigned* s1 = smem;                // [W][T]: stream 1
  unsigned* s2 = s1 + W * T;          // [W + K][T]: stream 2
  int* band = (int*)(s2 + (W + K) * T) + j;  // [B + 1][T]: band[d * T]
  const long long m = (long long)blockIdx.x * T + j;
  const bool live = m < M;

  // lengths never exceed the packed width; the clamp keeps reads in range
  const int l1 = live ? min(len1[m], 16 * W) : 0;
  const int l2 = live ? min(len2[m], 16 * W) : 0;
  const int off = live ? offsets[m] : 0;
  const int p_beg = max(0, off - E);
  const int p_star = min(l1 - 1, l2 - 1 + off);
  const int q_star = min(l2 - 1, p_star - off + E);
  const int n = max(0, p_star - p_beg + 1);
  const int z0 = off + E - p_beg;     // cells with q < 0 in row t = 0
  const int d_star = max(0, min(B - 1, q_star - (p_star - off) + E));
  for (int d = 0; d <= B; ++d) band[d * T] = 0;

  // stream word c of a read = its bases 16c+u .. 16c+u+15, a funnel of
  // raw words (16c+u)>>4 and the next; the thread writes only column j,
  // so no barrier is needed
  auto stage = [&](unsigned* dst, int n_words, const int* wT, int u) {
    auto raw = [&](int i) -> unsigned {
      return (live && i >= 0 && i < W) ? (unsigned)wT[(long long)i * M + m]
                                       : 0u;
    };
    const int kk = u >> 4;
    const unsigned sh = 2u * (unsigned)(u & 15);
    unsigned lo = raw(kk);
    for (int c = 0; c < n_words; ++c) {
      const unsigned hi = raw(kk + c + 1);
      dst[c * T + j] = __funnelshift_r(lo, hi, sh);
      lo = hi;
    }
  };
  stage(s1, W, w1T, p_beg);
  stage(s2, W + K, w2T, p_beg - off - E);

  // the warp walks its longest pair's rows.  n <= len1 <= 16W, so row t
  // reads stream-1 word t/16 < W and stream-2 words up to t/16 + K < W + K.
  const int n_max = __reduce_max_sync(0xffffffffu, n);
  int result = 0;
  for (int t = 0; t < n_max; ++t) {
    const int c = t >> 4;
    const unsigned r2 = 2u * (unsigned)(t & 15);
    const unsigned bc = ((s1[c * T + j] >> r2) & 3u) * kLanes;
    const int nq = z0 - t;            // cells d < nq have q < 0
    int left = 0;
    int diag = band[0];
    for (int k = 0; k < K; ++k) {
      const unsigned x =
          __funnelshift_r(s2[(c + k) * T + j], s2[(c + k + 1) * T + j], r2) ^
          bc;
      unsigned mb = ~(x | (x >> 1)) & kLanes;  // bit 2i: match at 16k+i
      const int nqk = nq - 16 * k;
      if (nqk > 0) mb &= nqk >= 16 ? 0u : ~0u << (2 * nqk);
      int* cell = band + 16 * k * T;
      const int cells = min(16, B - 16 * k);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (i < cells) {
          const int up = cell[(i + 1) * T];
          const int v =
              max(max(up, diag + (int)((mb >> (2 * i)) & 1u)), left);
          cell[i * T] = v;
          left = v;
          diag = up;
        }
      }
    }
    if (t == n - 1) result = band[d_star * T];
  }
  if (live) out[m] = result;
}

}  // namespace alga_k2w

namespace alga_k2 {

int launch_lcs_wide(const int* w1T, const int* w2T, int W, long long M,
                    const int* len1, const int* len2, const int* offsets,
                    int E, int* out, cudaStream_t s) {
  if (E < 0 || W < 0) return (int)cudaErrorInvalidValue;
  const int B = 2 * E + 1;
  const size_t words = (size_t)(2 * W + ((B + 15) >> 4) + B + 1);
  int threads = 128;
  while (threads > 32 && words * threads * 4 > alga_k2w::kSmemLimit)
    threads >>= 1;
  const size_t bytes = words * threads * 4;
  if (bytes > alga_k2w::kSmemLimit) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        alga_k2w::banded_lcs_wide_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((M + threads - 1) / threads);
  alga_k2w::banded_lcs_wide_kernel<<<blocks, threads, bytes, s>>>(
      w1T, w2T, W, M, len1, len2, offsets, E, out);
  return (int)cudaGetLastError();
}

}  // namespace alga_k2
