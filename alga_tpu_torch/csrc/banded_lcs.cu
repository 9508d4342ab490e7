// K2 banded_lcs, the hand-written Hopper (sm_90a) kernel of the ACLCS
// banded-LCS path; banded_dp.cu holds the C interface that launches it.
// The build compiles this file once per band half-width E, with
// -DALGA_LCS_E=E, so the 16 unrolled instantiations build in parallel.
//
//   Replaces: _dp_kernel, alga_tpu/ops/pallas/banded_dp.py:152
//     (launched by _banded_lcs_pallas_x32, :301).
//   Computes: the ACLCS banded LCS of M read pairs (ref
//   AlignmentControllerLCS.cpp:61-150): rows p >= max(0, off-E), band of
//   B = 2E+1 cells d at q = p-off-E+d, a cell valid for 0 <= q < len2,
//   result at (p*, q*) with p* = min(len1-1, len2-1+off),
//   q* = min(len2-1, p*-off+E).
//   Bound: integer ALU.  A pair needs rows x B dependent cell updates; its
//   words are read once.
//   Design:
//   - Rows are counted from each pair's first row p_beg (t = p - p_beg),
//     so a warp walks its rows in step: chunks of 16 rows, one refill of
//     the row words per chunk, the same shifts in every lane, no branch
//     per row.
//   - The block stages its pairs' words in shared memory once (coalesced
//     loads), both reads already shifted into that row frame: stream 1
//     position t holds read-1 base p_beg+t, stream 2 position t holds the
//     read-2 base of row t's band cell 0 (q = p_beg+t-off-E), so row t's
//     band is stream-2 positions t .. t+B-1.  The row loop touches no
//     device memory.
//   - Read 2's window is two (B <= 16) or three stream words in registers.
//     One funnel shift gives the row's 2-bit bases; one XOR with read 1's
//     base broadcast over the 2-bit lanes gives all B match bits.
//   - Cell update: v = max(up, diag + match, left).  For E >= 1 this equals
//     the reference's `match ? diag + 1 : max(up, left)`: inside the band
//     up and left never exceed diag + 1, and diag never exceeds
//     max(up, left).  E = 0 has no up or left cell and keeps the select.
//     ptxas emits max(diag + match, up) as one DPX add-max (VIADDMNMX);
//     __vimax3_s32 or __viaddmax_s32 written out were not faster.
//   - No cell tests its validity.  Cells with q >= len2 hold values that
//     only ever flow into other such cells (up keeps q; diag and left
//     raise it), never into the result cell (q* < len2).  Cells with q < 0
//     stay 0: their match bits are cleared in the first chunks of rows.
//   - Each pair's result, band[d*] after its row p*, is caught in the
//     chunks that hold some lane's last row; the band is stored to shared
//     memory and read back at d* (ptxas 12.9 at -O3 was seen to
//     miscompile an unrolled select over the band).  Later rows of a pair
//     compute values nobody reads.
//   - One pair per thread, 128-thread blocks, at every M.  Two
//     interleaved pairs per thread, and blocks of 32 to 256 threads, were
//     tried on the card at 17k, 2^18 and 2^20 pairs and were not faster.
//   - E is a template parameter (0..15), so the band lives in registers.

#include <cuda_runtime.h>

namespace alga_k2 {

constexpr unsigned kLanes = 0x55555555u;  // bit 0 of every 2-bit lane

// One pair's state in the kernel: its band, result, and the stream words
// of the current chunk of rows.
template <int E>
struct Lane {
  static constexpr int B = 2 * E + 1;
  int band[B + 1];  // band[B] stays 0: the `up` value past the band's end
  int result;       // band[d*] after row p*, 0 for a pair with no rows
  int last;         // t of row p*, -1 for none
  int z0;           // cells with q < 0 in row t = 0: off+E-p_beg
  int d_star;
  unsigned a_w, r0, r1, r2;
};

// Row t = 16c + r.  HEAD rows may have cells with q < 0 (t < 2E); TAIL
// rows may be some lane's last row; the rows between skip both tests.
template <int E, bool HEAD, bool TAIL>
__device__ __forceinline__ void lcs_row(Lane<E>& L, int r, int t,
                                        unsigned* res_col, int T) {
  constexpr int B = 2 * E + 1;
  const unsigned bc = ((L.a_w >> (2 * r)) & 3u) * kLanes;
  unsigned x = __funnelshift_r(L.r0, L.r1, 2 * r) ^ bc;
  unsigned m_lo = ~(x | (x >> 1)) & kLanes;  // bit 2d: match at cell d
  unsigned m_hi = 0u;
  if constexpr (B > 16) {
    x = __funnelshift_r(L.r1, L.r2, 2 * r) ^ bc;
    m_hi = ~(x | (x >> 1)) & kLanes;          // cells 16 .. B-1
  }
  if constexpr (HEAD) {                       // clear cells with q < 0
    const int nq = max(0, L.z0 - t);
    m_lo &= nq >= 16 ? 0u : ~0u << (2 * nq);
    if constexpr (B > 16) m_hi &= nq <= 16 ? ~0u : ~0u << (2 * (nq - 16));
  }
  int left = 0;
#pragma unroll
  for (int d = 0; d < B; ++d) {
    const int m = (int)(((d < 16 ? m_lo : m_hi) >> (2 * (d & 15))) & 1u);
    int v;
    if constexpr (E == 0) {
      v = m ? L.band[0] + 1 : 0;
    } else {
      v = max(max(L.band[d + 1], L.band[d] + m), left);
    }
    L.band[d] = v;
    left = v;
  }
  if constexpr (TAIL) {
    if (t == L.last) {
#pragma unroll
      for (int d = 0; d < B; ++d) res_col[d * T] = (unsigned)L.band[d];
      L.result = (int)res_col[L.d_star * T];
    }
  }
}

template <int E, bool HEAD, bool TAIL>
__device__ __forceinline__ void lcs_chunk(Lane<E>& L, int c,
                                          unsigned* res_col, int T) {
  if constexpr (2 * E + 1 <= 16) {   // constant shifts in every row
#pragma unroll
    for (int r = 0; r < 16; ++r)
      lcs_row<E, HEAD, TAIL>(L, r, 16 * c + r, res_col, T);
  } else {                           // wide bands: keep the code small
#pragma unroll 1
    for (int r = 0; r < 16; ++r)
      lcs_row<E, HEAD, TAIL>(L, r, 16 * c + r, res_col, T);
  }
}

template <int E>
__global__ void banded_lcs_kernel(const int* __restrict__ w1T,
                                  const int* __restrict__ w2T, int W,
                                  long long M,
                                  const int* __restrict__ len1,
                                  const int* __restrict__ len2,
                                  const int* __restrict__ offsets,
                                  int* __restrict__ out) {
  constexpr int B = 2 * E + 1;
  extern __shared__ unsigned smem[];
  const int T = blockDim.x;
  const int j = threadIdx.x;          // each thread owns column j
  unsigned* s1 = smem;                // [W][T]: stream 1
  unsigned* s2 = s1 + W * T;          // [W + 2][T]: stream 2
  unsigned* res_col = s2 + (W + 2) * T + j;  // [B][T]: a band, to read d*
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
  Lane<E> L;
  L.last = n - 1;
  L.result = 0;
  L.z0 = off + E - p_beg;
  L.d_star = max(0, min(B - 1, q_star - (p_star - off) + E));
#pragma unroll
  for (int d = 0; d <= B; ++d) L.band[d] = 0;

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
  stage(s2, W + 2, w2T, p_beg - off - E);

  // the warp walks its longest pair's rows; HEAD chunks hold rows t < 2E,
  // TAIL chunks the rows from its shortest pair's last row on (both tests
  // are the same in every lane).  n <= len1 <= 16W, so chunk c < W reads
  // stream words c .. c+2 < W+2.
  const int n_max = __reduce_max_sync(0xffffffffu, n);
  const int n_min = __reduce_min_sync(0xffffffffu, n);
  const int chunks = (n_max + 15) >> 4;
  for (int c = 0; c < chunks; ++c) {
    L.a_w = s1[c * T + j];
    L.r0 = s2[c * T + j];
    L.r1 = s2[(c + 1) * T + j];
    if constexpr (B > 16) L.r2 = s2[(c + 2) * T + j];
    if (16 * c < 2 * E)
      lcs_chunk<E, true, true>(L, c, res_col, T);
    else if (16 * c + 16 >= n_min)
      lcs_chunk<E, false, true>(L, c, res_col, T);
    else
      lcs_chunk<E, false, false>(L, c, res_col, T);
  }
  if (live) out[m] = L.result;
}

template <int E>
int launch_lcs(const int* w1T, const int* w2T, int W, long long M,
               const int* len1, const int* len2, const int* offsets,
               int* out, cudaStream_t s) {
  constexpr int B = 2 * E + 1;
  constexpr int threads = 128;
  const size_t bytes = (size_t)(2 * W + 2 + B) * threads * sizeof(unsigned);
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        banded_lcs_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((M + threads - 1) / threads);
  banded_lcs_kernel<E><<<blocks, threads, bytes, s>>>(
      w1T, w2T, W, M, len1, len2, offsets, out);
  return (int)cudaGetLastError();
}

#ifdef ALGA_LCS_E
template int launch_lcs<ALGA_LCS_E>(const int*, const int*, int, long long,
                                    const int*, const int*, const int*,
                                    int*, cudaStream_t);
#endif

}  // namespace alga_k2
