// SYRK (G = A^T A for a tall, skinny A), written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/syrk_pallas.py `_kernel` (launched by
// `syrk_pallas_call`), the "Mat A^TA" routine of CP-ALS.
//
// A is (rows, R) float32 or bfloat16, row-major; G is (R, R) float32.
//
// What bounds it: at the factor shapes of CP-ALS (tens of thousands of rows,
// R = 35) the work is tiny: about 10 MB to read and 2 * rows * R^2 flops,
// a few microseconds either way, so launch overhead dominates.
//
// Design: the TPU kernel accumulates every row block into one output tile
// over a sequential grid, which serialises the reduction.  Here the row
// tiles are spread over `nparts` CTAs.  Each CTA stages a tile of
// kTileRows rows in shared memory (widened to float) and each thread owns
// a fixed set of entries of G, which it sums over the tile's rows into a
// per-CTA partial G in shared memory.  Each CTA writes its partial G to
// `partial`, and a second small kernel sums the partials in a fixed order,
// so the result is the same from run to run.  No padding of rows or rank.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;

template <typename T>
__global__ void __launch_bounds__(kThreads)
syrk_partial_kernel(const T* __restrict__ a, float* __restrict__ partial,
                    long long rows, int rank) {
  extern __shared__ float smem[];
  float* tile = smem;                    // kTileRows * rank
  float* g = tile + kTileRows * rank;    // rank * rank
  const int rr = rank * rank;
  for (int e = threadIdx.x; e < rr; e += blockDim.x) g[e] = 0.f;

  const long long ntiles = (rows + kTileRows - 1) / kTileRows;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long r0 = t * kTileRows;
    const int nr = static_cast<int>(min(static_cast<long long>(kTileRows), rows - r0));
    __syncthreads();  // the previous tile is no longer read
    for (int e = threadIdx.x; e < nr * rank; e += blockDim.x)
      tile[e] = load_f32(a + r0 * rank + e);
    __syncthreads();
    // thread-owned entries: g[e] is only ever touched by this thread
    for (int e = threadIdx.x; e < rr; e += blockDim.x) {
      const int i = e / rank;
      const int j = e - i * rank;
      float s = 0.f;
      for (int k = 0; k < nr; ++k) s += tile[k * rank + i] * tile[k * rank + j];
      g[e] += s;
    }
  }
  for (int e = threadIdx.x; e < rr; e += blockDim.x)
    partial[static_cast<long long>(blockIdx.x) * rr + e] = g[e];
}

__global__ void syrk_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int nparts,
                                   int rr) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rr) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += partial[static_cast<long long>(p) * rr + e];
  out[e] = s;
}

template <typename T>
int launch(const void* a, void* partial, void* out, long long rows, int rank,
           int nparts, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(kTileRows) * rank +
                                       static_cast<size_t>(rank) * rank);
  auto kernel = syrk_partial_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<nparts, kThreads, smem, stream>>>(static_cast<const T*>(a),
                                             static_cast<float*>(partial), rows,
                                             rank);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rr = rank * rank;
  syrk_reduce_kernel<<<(rr + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), nparts, rr);
  return cudaGetLastError();
}

}  // namespace

// partial: (nparts, rank * rank) float32 scratch; out: (rank, rank) float32.
// Returns a cudaError_t.
extern "C" int syrk_launch(const void* a, int a_bf16, void* partial, void* out,
                           long long rows, int rank, int nparts,
                           void* stream) {
  if (rank < 1 || nparts < 1 || rows < 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return a_bf16 ? launch<__nv_bfloat16>(a, partial, out, rows, rank, nparts, s)
                : launch<float>(a, partial, out, rows, rank, nparts, s);
}
