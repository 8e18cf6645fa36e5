// SYRK (G = A^T A for a tall, skinny A), written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/syrk_pallas.py `_kernel` (launched by
// `syrk_pallas_call`), the "Mat A^TA" routine of CP-ALS.
//
// A is (rows, R) float32 or bfloat16, row-major; G is (R, R) float32.
//
// What bounds it: at the factor shapes of CP-ALS (tens of thousands of rows,
// R = 35) the work is tiny: 1.5-10 MB to read once (a 0.5-3 us bound) and
// 2 * rows * R^2 flops.  So what sets its time is the fixed cost of a call:
// launches, a serial reduction, and host work.  The design keeps each of
// those to one:
//  * One launch.  The rows are cut into tiles and the tiles spread over
//    `gridDim.x` CTAs, about one per SM (split-K).  A CTA stages a tile in
//    shared memory, widened to float, with 16-byte loads: a tile of rows is
//    one contiguous run of A, whatever R is.
//  * One triangle, blocked in registers.  G is cut into 4 x 4 blocks and
//    only the blocks on or above the diagonal are summed: at R = 35 that is
//    45 blocks (720 sums) against 1225 sums for all of G.  Each thread owns
//    one block in 16 registers, so two 16-byte shared loads feed 16 FMAs;
//    the CTA's spare threads split the tile's rows (`splits`), summed in
//    order at the end.  Past 256 blocks (R over 88), `gridDim.y` slices
//    the blocks and each slice reads the rows again.
//  * The reduction in the same launch.  Each CTA writes its blocks to the
//    `partial` scratch and takes a ticket with an atomic after a
//    __threadfence().  One CTA reading all ~130 partials (380 KB at R = 35)
//    would take microseconds on one SM's share of L2, so it goes in two
//    levels of about sqrt(CTAs) each: the CTA that draws the last ticket of
//    its group sums the group's partials in CTA order, and the group that
//    finishes last sums the group sums in order and writes both triangles
//    of G, each thread with 8 partials' loads in flight.  Each resets its
//    ticket for the next call.  The order never changes for a shape, so
//    the result is the same bits from run to run.
//  * No per-call host work beyond the launch: the shared memory stays
//    under 48 KB (no opt-in attribute), the wrapper keeps the SM count,
//    the tickets and the scratch, and it picks the geometry (tile rows,
//    CTAs, slices, groups) in kernels/syrk_cuda.py::syrk_geometry.
// Arithmetic is fp32 FMA, accumulated in float32: TF32 tensor cores would
// not hold the 1e-4 relative limit against the plain A^T A.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlk = 4;                // a thread's kBlk x kBlk block of G
constexpr int kBlkSize = kBlk * kBlk;  // floats of one block
constexpr size_t kSmemBytes = 48 * 1024;

// The blocks (bi, bj), bi <= bj, of pair p, counted row by row over the
// upper triangle of the nb x nb grid of blocks.
__device__ __forceinline__ void pair_blocks(int p, int nb, int& bi, int& bj) {
  bi = 0;
  while (p >= nb - bi) {
    p -= nb - bi;
    ++bi;
  }
  bj = bi + p;
}

// Copies n = nr * rank consecutive elements of A (rows [r0, r0 + nr)) into
// the tile, row k at tile + k * rp, widened to float.
template <typename T>
__device__ void stage(const T* __restrict__ src, int n, int rank, int rp,
                      float* __restrict__ tile) {
  constexpr int kV = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const int nv = aligned ? n / kV : 0;
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    float x[kV];
    load_run<kV>(src + v * kV, x);
    int k = v * kV / rank;
    int c = v * kV - k * rank;
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      tile[k * rp + c] = x[u];
      if (++c == rank) {
        c = 0;
        ++k;
      }
    }
  }
  for (int e = nv * kV + threadIdx.x; e < n; e += blockDim.x) {
    const int k = e / rank;
    tile[k * rp + e - k * rank] = load_f32(src + e);
  }
}

__device__ __forceinline__ void add4(float4& s, const float4 v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// Row ii of block pair p, one float4 of G's sum: written to both triangles.
__device__ __forceinline__ void write_row(int q, float4 v, int nb, int rank,
                                          float* __restrict__ out) {
  int bi, bj;
  pair_blocks(q / kBlk, nb, bi, bj);
  const int ii = q % kBlk;
  const int i = bi * kBlk + ii;
  const float s[kBlk] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int jj = 0; jj < kBlk; ++jj) {
    const int j = bj * kBlk + jj;
    if (i < rank && j < rank && (bi < bj || ii <= jj)) {
      out[i * rank + j] = s[jj];
      out[j * rank + i] = s[jj];
    }
  }
}

// Partials a thread reads at once in sum_partials.
constexpr int kSumInFlight = 8;

// Sums `count` partials of nq float4 columns each, src[x * nq + q] for x in
// order, kSumInFlight loads in flight a thread, each into its own running
// sum, the sums then added in a fixed tree: a fixed order for a given shape.
// The partials were written by other CTAs of this launch, so they are read
// past L1.  The sum goes to dst, or to both triangles of G when dst is null.
__device__ void sum_partials(const float4* __restrict__ src, int count,
                             int nq, float4* __restrict__ dst, int nb,
                             int rank, float* __restrict__ out) {
  for (int q = threadIdx.x; q < nq; q += blockDim.x) {
    float4 acc[kSumInFlight] = {};
    for (int x = 0; x < count; x += kSumInFlight) {
#pragma unroll
      for (int u = 0; u < kSumInFlight; ++u)
        if (x + u < count)
          add4(acc[u], __ldcg(src + static_cast<long long>(x + u) * nq + q));
    }
#pragma unroll
    for (int w = kSumInFlight / 2; w > 0; w /= 2)
#pragma unroll
      for (int u = 0; u < w; ++u) add4(acc[u], acc[u + w]);
    if (dst != nullptr)
      dst[q] = acc[0];
    else
      write_row(q, acc[0], nb, rank, out);
  }
}

// Takes a ticket from *ticket after this CTA's writes; true in the CTA
// whose ticket is the last of `of`, once it may read what the others wrote.
__device__ __forceinline__ bool last_to_finish(unsigned int* ticket,
                                               unsigned int of) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == of - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
syrk_kernel(const T* __restrict__ a, float* __restrict__ partial,
            unsigned int* __restrict__ tickets, float* __restrict__ out,
            long long rows, int rank, int tile_rows, int group) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nb = (rank + kBlk - 1) / kBlk;
  const int rp = nb * kBlk;  // the tile's row stride, 16-byte aligned
  const int pairs = nb * (nb + 1) / 2;
  const int p0 = blockIdx.y * kThreads;  // this slice's first pair
  const int np = min(kThreads, pairs - p0);
  const int splits = kThreads / np;  // of the tile's rows
  const int sp = threadIdx.x / np;
  const int lp = threadIdx.x - sp * np;
  const bool active = sp < splits;
  int bi = 0, bj = 0;
  if (active) pair_blocks(p0 + lp, nb, bi, bj);

  // Columns R..rp-1 of the tile are never written: they feed only sums
  // outside G, which are dropped.
  float acc[kBlk][kBlk] = {};
  const long long ntiles = (rows + tile_rows - 1) / tile_rows;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long r0 = t * tile_rows;
    const int nr = static_cast<int>(min(static_cast<long long>(tile_rows),
                                        rows - r0));
    __syncthreads();  // the previous tile is no longer read
    stage(a + r0 * rank, nr * rank, rank, rp, smem);
    __syncthreads();
    if (active) {
      const float* xi = smem + bi * kBlk;
      const float* xj = smem + bj * kBlk;
      for (int k = sp; k < nr; k += splits) {
        const float4 u = *reinterpret_cast<const float4*>(xi + k * rp);
        const float4 v = *reinterpret_cast<const float4*>(xj + k * rp);
        const float uu[kBlk] = {u.x, u.y, u.z, u.w};
        const float vv[kBlk] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int ii = 0; ii < kBlk; ++ii)
#pragma unroll
          for (int jj = 0; jj < kBlk; ++jj)
            acc[ii][jj] = fmaf(uu[ii], vv[jj], acc[ii][jj]);
      }
    }
  }

  // The CTA's partial: its splits summed in order.
  __syncthreads();
  if (active) {
#pragma unroll
    for (int e = 0; e < kBlkSize; ++e)
      smem[(sp * np + lp) * kBlkSize + e] = acc[e / kBlk][e % kBlk];
  }
  __syncthreads();
  float* mine = partial + (static_cast<long long>(blockIdx.x) * pairs + p0) *
                              kBlkSize;
  for (int e = threadIdx.x; e < np * kBlkSize; e += blockDim.x) {
    float s = smem[e];
    for (int q = 1; q < splits; ++q) s += smem[q * np * kBlkSize + e];
    mine[e] = s;
  }

  // Two levels of tickets: the last CTA of each group of `group` CTAs
  // along the rows (all slices) sums the group's partials in order, then the
  // last group to finish sums the group sums in order and writes G.  Each
  // last CTA sets its ticket back to 0 for the next launch.
  const int nq = pairs * kBlk;  // float4 columns of one partial
  const int groups = (gridDim.x + group - 1) / group;
  const int gi = blockIdx.x / group;
  const int g0 = gi * group;
  const int gn = min(group, static_cast<int>(gridDim.x) - g0);
  const float4* p4 = reinterpret_cast<const float4*>(partial);
  float4* sums = reinterpret_cast<float4*>(partial) +
                 static_cast<long long>(gridDim.x) * nq;
  if (!last_to_finish(tickets + gi, gn * gridDim.y)) return;
  sum_partials(p4 + static_cast<long long>(g0) * nq, gn, nq,
               sums + static_cast<long long>(gi) * nq, nb, rank, out);
  if (threadIdx.x == 0) tickets[gi] = 0u;
  if (!last_to_finish(tickets + groups, groups)) return;
  sum_partials(sums, groups, nq, nullptr, nb, rank, out);
  if (threadIdx.x == 0) tickets[groups] = 0u;
}

template <typename T>
int launch(const void* a, void* partial, void* tickets, void* out,
           long long rows, int rank, int tile_rows, int nparts, int slices,
           int group, cudaStream_t stream) {
  const int nb = (rank + kBlk - 1) / kBlk;
  const long long pairs = static_cast<long long>(nb) * (nb + 1) / 2;
  const size_t smem = sizeof(float) *
      max(static_cast<size_t>(tile_rows) * nb * kBlk,
          static_cast<size_t>(kThreads) * kBlkSize);
  // every slice holds at least one pair, and the slices hold them all
  if (smem > kSmemBytes || static_cast<long long>(slices) * kThreads < pairs ||
      static_cast<long long>(slices - 1) * kThreads >= pairs)
    return cudaErrorInvalidValue;
  syrk_kernel<T><<<dim3(nparts, slices), kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<float*>(partial),
      static_cast<unsigned int*>(tickets), static_cast<float*>(out), rows,
      rank, tile_rows, group);
  return cudaGetLastError();
}

}  // namespace

// partial: (nparts + groups, pairs, 16) float32 scratch, pairs =
// nb (nb + 1) / 2, nb = ceil(rank / 4) and groups = ceil(nparts / group);
// tickets: groups + 1 zeroed uint32 that no other launch uses at the same
// time (the kernel leaves them zero); out: (rank, rank) float32.  Returns a
// cudaError_t.
extern "C" int syrk_launch(const void* a, int a_bf16, void* partial,
                           void* tickets, void* out, long long rows, int rank,
                           int tile_rows, int nparts, int slices, int group,
                           void* stream) {
  if (rank < 1 || rows < 0 || tile_rows < 1 || nparts < 1 || slices < 1 ||
      group < 1)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return a_bf16
             ? launch<__nv_bfloat16>(a, partial, tickets, out, rows, rank,
                                     tile_rows, nparts, slices, group, s)
             : launch<float>(a, partial, tickets, out, rows, rank, tile_rows,
                             nparts, slices, group, s);
}
