// Hand-written Hopper (sm_90a) kernels of the ACLCS banded-LCS path,
// behind a plain C interface that alga_tpu_torch/ops/_cuda.py loads with
// ctypes.  Each kernel launches on the caller's stream, allocates nothing
// and returns cudaGetLastError() of its launch.
//
// K1 gather_planes
//   Replaces: _gather_kernel, alga_tpu/ops/pallas/banded_dp.py:69
//     (launched by mxu_gather_planes, :89), together with the table
//     transpose before it (_table_planes, :120) and the unpacking after it
//     (_rows_from_planes, :139).
//   Computes: for both sides s of a batch of pairs, out[s, w, m] =
//   packed[idx[s, m], w] for w < W and out[s, W, m] = lengths[idx[s, m]];
//   zeros where idx[s, m] is outside [0, N).  On the TPU the gather was a
//   one-hot bf16 matmul over byte planes, because TPU gathers are slow; on
//   this card a gather is a load.
//   Bound: memory.  Per index: the 4-byte index, one (W+1)-word row of the
//   table, (W+1) output words; no arithmetic.
//   Design: one thread per (side, index) reads its index once and its row
//   straight from the row-major table (W consecutive words: one or two
//   32-byte sectors, the later words from L1), then writes its W+1 output
//   words, each store coalesced across the warp (neighbouring m).  Both
//   sides in one launch (gridDim.y = 2); no division, no transposed copy
//   of the table.
//
// K2 banded_lcs: in banded_lcs.cu, built once per band half-width E =
// 0..15, and for E >= 16 in banded_lcs_wide.cu (E a runtime argument); the
// switch in alga_banded_lcs below picks the instantiation or the wide
// kernel by E alone.

#include <cuda_runtime.h>

namespace {

__global__ void gather_rows_kernel(const int* __restrict__ packed,
                                   const int* __restrict__ lengths,
                                   long long n_rows, int W,
                                   const int* __restrict__ idx, long long M,
                                   int* __restrict__ out) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int s = blockIdx.y;
  const int c = idx[s * M + m];
  const bool ok = c >= 0 && c < n_rows;
  const int* row = packed + (long long)(ok ? c : 0) * W;
  int* o = out + (long long)s * (W + 1) * M + m;
  for (int w = 0; w < W; ++w) o[(long long)w * M] = ok ? row[w] : 0;
  o[(long long)W * M] = ok ? lengths[c] : 0;
}

}  // namespace

namespace alga_k2 {
template <int E>
int launch_lcs(const int* w1T, const int* w2T, int W, long long M,
               const int* len1, const int* len2, const int* offsets,
               int* out, cudaStream_t s);
int launch_lcs_wide(const int* w1T, const int* w2T, int W, long long M,
                    const int* len1, const int* len2, const int* offsets,
                    int E, int* out, cudaStream_t s);
}  // namespace alga_k2

extern "C" {

int alga_gather_planes(const int* packed, const int* lengths, long long N,
                       int W, const int* idx, long long M, int* out,
                       void* stream) {
  const int threads = 256;
  const dim3 grid((unsigned)((M + threads - 1) / threads), 2);
  gather_rows_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      packed, lengths, N, W, idx, M, out);
  return (int)cudaGetLastError();
}

#define ALGA_LCS_CASE(e)                                                  \
  case e:                                                                 \
    return alga_k2::launch_lcs<e>(w1T, w2T, W, M, len1, len2, offsets,    \
                                  out, s);

int alga_banded_lcs(const int* w1T, const int* w2T, int W, long long M,
                    const int* len1, const int* len2, const int* offsets,
                    int E, int* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (E) {
    ALGA_LCS_CASE(0) ALGA_LCS_CASE(1) ALGA_LCS_CASE(2) ALGA_LCS_CASE(3)
    ALGA_LCS_CASE(4) ALGA_LCS_CASE(5) ALGA_LCS_CASE(6) ALGA_LCS_CASE(7)
    ALGA_LCS_CASE(8) ALGA_LCS_CASE(9) ALGA_LCS_CASE(10) ALGA_LCS_CASE(11)
    ALGA_LCS_CASE(12) ALGA_LCS_CASE(13) ALGA_LCS_CASE(14) ALGA_LCS_CASE(15)
    default:
      return alga_k2::launch_lcs_wide(w1T, w2T, W, M, len1, len2, offsets,
                                      E, out, s);
  }
}

const char* alga_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
