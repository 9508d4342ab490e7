// K2 banded_lcs_wide, the hand-written Hopper (sm_90a) kernel of the
// ACLCS banded LCS for band half-widths E >= 16; banded_dp.cu holds the C
// interface that launches it (alga_banded_lcs sends E >= 16 here, and
// E = 0..15 to the register-band kernel of banded_lcs.cu).  The build
// compiles this file once per cells-per-lane K (-DALGA_LCS_WIDE_K=K, the
// values of ops/banded_dp.py:WIDE_CELLS), each in both frames.
//
//   Replaces: alga_tpu's XLA route for bands wider than 16 cells.  The
//     entry of _dp_kernel (banded_lcs_pallas,
//     alga_tpu/ops/pallas/banded_dp.py:259) sends 2E+1 > 16 to the XLA
//     row scan banded_lcs_batch (:274-279, alga_tpu/ops/align.py:103),
//     because the Pallas kernel extracts a band from one 32-bit window.
//   Computes: the same ACLCS banded LCS as banded_lcs.cu (ref
//   AlignmentControllerLCS.cpp:61-150), at any E: rows p >= max(0, off-E),
//   cells q in [p-off-E, p-off+E] clipped to [0, len2), result at
//   (p*, q*) with p* = min(len1-1, len2-1+off), q* = min(len2-1, p*-off+E).
//   Bound: integer ALU, 3 operations per band cell of the reads
//   (chip_smoke.k2_bound); the words are read once.  The chain is a row's
//   cells, each depending on the one before it.
//   Design:
//   - Each row is a prefix max.  With a[d] = max(up, diag + match), the
//     row is v[d] = max(v[d-1], a[d]), v[-1] = 0.  So a pair's row is cut
//     over g lanes of one warp (g = 2..32, a power of two), k consecutive
//     cells each, in registers: each lane takes its k values of a and
//     their running max, a log2(g)-step __shfl_up_sync max scan of the
//     lane totals (width g: segmented by pair) gives each lane the max of
//     the lanes before it, and one max folds that in.  No cell goes to
//     shared memory.  The launch picks g so that M * g threads fill the
//     card where M allows (banded_dp.wide_shape), and k = the smallest
//     instantiated K with g * K >= the row's cells.
//   - The frame is clipped to the reads.  The band frame holds the band's
//     2E+1 cells (q = p-off-E+d: up is cell d+1 of the row before, diag
//     cell d).  When 2E+1 > 16W it holds the read's 16W cells (q = d: up
//     is cell d, diag cell d-1).  A row then has min(2E+1, 16W) <= 2048
//     cells, so no register, shared memory or block size depends on E.
//   - Only match bits are masked: outside [max(0, p-off-E),
//     min(len2-1, p-off+E)] a cell has none.  Cell values need no mask
//     because every row is nondecreasing (a prefix max), so up >= diag.
//     Past the band's right end the cells repeat its last value: the
//     edge cell's up is then its diag, and max(diag, diag + m) is what
//     the reference's 0 gives.  Left of the band (the row frame) a cell
//     holds at most the row before's value there, which the first band
//     cell's a already reaches.  Cells with q < 0 (the band frame) stay 0.
//     The last lane's __shfl_down_sync returns its own first cell, never
//     more than its last cell's diag, so it needs no select either.
//   - Streams: both reads are staged once per pair in shared memory,
//     shifted into the frame (stream 1 position t holds read-1 base
//     p_beg+t; stream 2 position x the read-2 base at q = q0 + x), the
//     lanes of a pair writing alternate words.  A row reads one stream-1
//     word (the same for the pair's lanes) and, per 16 cells of a lane,
//     two stream-2 words: one funnel shift and one XOR with read 1's base
//     over the 2-bit lanes give 16 match bits.  Staged words a pair:
//     W and W + ceil(g*k/16) + 1, each rounded up to an odd count (pairs
//     then start in different banks), fixed by W, g and k.
//   - The pair's result, cell d* after row p*, is caught by the lane that
//     holds d*, which stores its k cells to shared memory and reads d*
//     back (ptxas 12.9 at -O3 was seen to miscompile an unrolled select
//     over a band held in registers, banded_lcs.cu).
//   - The warp walks its longest pair's rows; later rows of a pair
//     compute values nobody reads.  128 threads a block, 64 or 32 where
//     the staged words of 128 / g pairs pass 227 KB (W in the thousands).

#include <cuda_runtime.h>

namespace alga_k2w {

constexpr unsigned kLanes = 0x55555555u;  // bit 0 of every 2-bit lane
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemLimit = 232448;     // a block's shared memory, bytes

// bits 2i of the 16 cells first .. first+15 that lie in [lo, hi]; the
// clamping funnel shifts give 0 for a shift of 32
__device__ __forceinline__ unsigned window_mask(int first, int lo, int hi) {
  const int below = min(max(lo - first, 0), 16);
  const int upto = min(max(hi - first + 1, 0), 16);
  return __funnelshift_lc(0u, kFull, 2 * below) &
         __funnelshift_rc(kFull, 0u, 32 - 2 * upto);
}

template <int K, bool ROW>
__global__ void __launch_bounds__(128)
    banded_lcs_wide_kernel(const int* __restrict__ w1T,
                           const int* __restrict__ w2T, int W, long long M,
                           const int* __restrict__ len1,
                           const int* __restrict__ len2,
                           const int* __restrict__ offsets, int E, int glog,
                           int S1, int S2, int* __restrict__ out) {
  constexpr int J = (K + 15) / 16;     // 16-cell match windows a lane
  extern __shared__ unsigned smem[];
  const int g = 1 << glog;
  const int P = blockDim.x >> glog;    // pairs in the block
  const int pp = threadIdx.x >> glog;  // this thread's pair in the block
  const int l = threadIdx.x & (g - 1); // its lane in the pair
  const long long m = (long long)blockIdx.x * P + pp;
  const bool live = m < M;
  unsigned* s1 = smem + pp * S1;                 // [S1]: stream 1
  unsigned* s2 = smem + P * S1 + pp * S2;        // [S2]: stream 2
  int* cut = (int*)(smem + P * (S1 + S2)) + pp * K;  // [K]: the result row

  // lengths never exceed the packed width; the clamp keeps reads in range
  const int l1 = live ? min(len1[m], 16 * W) : 0;
  const int l2 = live ? min(len2[m], 16 * W) : 0;
  const int off = live ? offsets[m] : 0;
  // from 16W + |off| on, every row's band holds all of read 2 and
  // q* = len2-1: a wider band gives the same result, and the clamp keeps
  // the sums below in range at any E
  const int e = (int)min((long long)E, 16LL * W + llabs((long long)off));
  const int p_beg = max(0, off - e);
  const int p_star = min(l1 - 1, l2 - 1 + off);
  const int q_star = min(l2 - 1, p_star - off + e);
  const int n = q_star < 0 ? 0 : max(0, p_star - p_beg + 1);
  const int q0 = ROW ? 0 : p_beg - off - e;  // q of cell 0 in row 0
  const int d_star = ROW ? q_star : q_star - (p_star - off - e);
  const int holder = n > 0 ? d_star / K : 0;
  const int first = l * K;                   // this lane's first cell

  // stream word c of a read = its bases 16c+u .. 16c+u+15, a funnel of
  // raw words (16c+u)>>4 and the next; the lanes of a pair write
  // alternate words of its own streams, so a warp barrier suffices
  auto stage = [&](unsigned* dst, int n_words, const int* wT, int u) {
    auto raw = [&](int i) -> unsigned {
      return (live && i >= 0 && i < W) ? (unsigned)wT[(long long)i * M + m]
                                       : 0u;
    };
    const int kk = u >> 4;
    const unsigned sh = 2u * (unsigned)(u & 15);
    for (int c = l; c < n_words; c += g)
      dst[c] = __funnelshift_r(raw(kk + c), raw(kk + c + 1), sh);
  };
  stage(s1, S1, w1T, p_beg);
  stage(s2, S2, w2T, q0);
  __syncwarp();

  int v[K];
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = 0;
  int result = 0;
  // the row's cells: match bits past them stay cleared (pad), so that the
  // band frame's cells after 2E repeat cell 2E's value
  const int cells = ROW ? 16 * W : 2 * e + 1;
  unsigned pad[J];
#pragma unroll
  for (int j = 0; j < J; ++j) pad[j] = window_mask(first + 16 * j, 0, cells - 1);
  // read 2's window: stream-2 words c0 .. c0+J of the lane's first cell's
  // position x (x = first + t in the band frame, first in the row frame)
  unsigned win[J + 1];
#pragma unroll
  for (int j = 0; j <= J; ++j) win[j] = s2[(first >> 4) + j];
  unsigned a_w = 0;                          // read 1's word of row t
  // n <= len1 <= 16W: row t reads stream-1 word t/16 < W, and stream-2
  // words up to (t + (g-1)K)/16 + J < W + ceil(gK/16) + 1 <= S2
  const int n_max = __reduce_max_sync(kFull, n);
  for (int t = 0; t < n_max; ++t) {
    if ((t & 15) == 0) a_w = s1[t >> 4];
    const unsigned bc = ((a_w >> (2 * (t & 15))) & 3u) * kLanes;
    const int x = (ROW ? 0 : t) + first;     // stream-2 position of cell first
    if (!ROW && t > 0 && (x & 15) == 0) {    // the window moves a word on
#pragma unroll
      for (int j = 0; j < J; ++j) win[j] = win[j + 1];
      win[J] = s2[(x >> 4) + J];
    }
    const unsigned r = 2u * (unsigned)(x & 15);
    unsigned mb[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const unsigned w = __funnelshift_r(win[j], win[j + 1], r) ^ bc;
      mb[j] = ~(w | (w >> 1)) & kLanes & pad[j];
    }
    // cells with match bits: q in [max(0, p-off-E), p-off+E] (cells with
    // q >= len2 never reach the result); masked in the rows where some
    // lane of the warp has cells outside that the pad leaves set
    const int p = p_beg + t;
    const int qrow = ROW ? 0 : q0 + t;       // q of cell 0 in row t
    const int lo = max(0, p - off - e) - qrow;
    const int hi = p - off + e - qrow;
    if (__any_sync(kFull, lo > first || hi < min(first + K, cells) - 1)) {
#pragma unroll
      for (int j = 0; j < J; ++j) mb[j] &= window_mask(first + 16 * j, lo, hi);
    }
    int run = 0;
    if constexpr (ROW) {
      int dg = __shfl_up_sync(kFull, v[K - 1], 1, g);  // diag of cell first
      if (l == 0) dg = 0;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int mt = (int)((mb[i >> 4] >> (2 * (i & 15))) & 1u);
        const int up = v[i];
        run = max(run, max(dg + mt, up));
        dg = up;
        v[i] = run;
      }
    } else {
      const int up_last = __shfl_down_sync(kFull, v[0], 1, g);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int mt = (int)((mb[i >> 4] >> (2 * (i & 15))) & 1u);
        const int up = i + 1 < K ? v[i + 1] : up_last;
        run = max(run, max(v[i] + mt, up));
        v[i] = run;
      }
    }
    // the max of the lanes before this one: an inclusive scan of the lane
    // totals (a lane below the stride gets its own value back), shifted
    int incl = run;
    for (int s = 1; s < g; s <<= 1)
      incl = max(incl, __shfl_up_sync(kFull, incl, s, g));
    int carry = __shfl_up_sync(kFull, incl, 1, g);
    if (l == 0) carry = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = max(v[i], carry);
    if (t == n - 1 && l == holder) {
#pragma unroll
      for (int i = 0; i < K; ++i) cut[i] = v[i];
      result = cut[d_star - first];
    }
  }
  if (live && l == holder) out[m] = result;
}

template <int K, bool ROW>
int launch(const int* w1T, const int* w2T, int W, long long M,
           const int* len1, const int* len2, const int* offsets, int E,
           int glog, int S1, int S2, int* out, cudaStream_t s) {
  const int g = 1 << glog;
  int threads = 128;
  size_t bytes = 0;
  for (;; threads >>= 1) {
    bytes = (size_t)(threads / g) * (S1 + S2 + K) * sizeof(unsigned);
    if (bytes <= kSmemLimit || threads == 32) break;
  }
  if (bytes > kSmemLimit) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        banded_lcs_wide_kernel<K, ROW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const long long pairs = threads / g;
  const unsigned blocks = (unsigned)((M + pairs - 1) / pairs);
  banded_lcs_wide_kernel<K, ROW><<<blocks, threads, bytes, s>>>(
      w1T, w2T, W, M, len1, len2, offsets, E, glog, S1, S2, out);
  return (int)cudaGetLastError();
}

}  // namespace alga_k2w

namespace alga_k2 {

// g lanes per pair, K cells a lane: the row of min(2E+1, 16W) cells must
// fit in g * K
template <int K>
int launch_lcs_wide(const int* w1T, const int* w2T, int W, long long M,
                    const int* len1, const int* len2, const int* offsets,
                    int E, int g, int* out, cudaStream_t s) {
  int glog = 1;
  while (glog < 5 && (1 << glog) != g) ++glog;
  if (E < 0 || W < 1 || (1 << glog) != g) return (int)cudaErrorInvalidValue;
  const bool row = 2LL * E + 1 > 16LL * W;
  const long long cells = row ? 16LL * W : 2LL * E + 1;
  if (cells > (long long)g * K) return (int)cudaErrorInvalidValue;
  const int S1 = W | 1;                      // odd strides: pairs in
  const int S2 = (W + (g * K + 15) / 16 + 1) | 1;  // different banks
  return row ? alga_k2w::launch<K, true>(w1T, w2T, W, M, len1, len2,
                                         offsets, E, glog, S1, S2, out, s)
             : alga_k2w::launch<K, false>(w1T, w2T, W, M, len1, len2,
                                          offsets, E, glog, S1, S2, out, s);
}

#ifdef ALGA_LCS_WIDE_K
template int launch_lcs_wide<ALGA_LCS_WIDE_K>(const int*, const int*, int,
                                              long long, const int*,
                                              const int*, const int*, int,
                                              int, int*, cudaStream_t);
#endif

}  // namespace alga_k2
