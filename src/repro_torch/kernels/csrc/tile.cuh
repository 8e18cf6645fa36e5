// The shared-memory output tile that K3's MTTKRP (linearized.cu, lin_launch
// with kronecker = 0) sums one block of stored entries into, and its flush
// to the output.  It now serves K3-MTTKRP alone: K1's MTTKRP and TTMc and
// K3's TTMc run the row-segmented kernel of segmented.cuh.
//
// Replaces, for K3-MTTKRP: the VMEM output tile of
// src/repro/kernels/linearized_pallas.py `_kernel` (pl.pallas_call at :97),
// which the TPU zeroes on a tile's first visit of a sequential grid.  What
// bounds it on this card: the stream (12 B an entry) and the factor rows it
// gathers from L2; what holds it well under that is this tile's shared
// atomics (one per entry and column, colliding on yelp's hot rows), three
// __syncthreads a block and a global atomic per touched (row, column).
//
// A CTA first stages its block of entries in shared memory: each entry's
// row inside the CTA's row tile (or -1 for an entry to leave out), its value
// widened to float, and the ids of its factor rows in the other modes,
// decoded from the packed index.  Then accumulate_and_flush zeroes the rows
// the block touches, adds every entry's row product into them with shared
// atomics, and adds the touched rows to the output with global atomics (the
// wrapper zeroes the output).
//
// What an entry adds to output column c is val * prod_i F_i[id_i, c] (the
// KhatriRao column policy: one shared rank, column c in every factor).
//
// The output is R columns wide.  The shared tile holds row_tile x `chunk`
// floats, so a wide rank is split across CTAs: blockIdx.y owns columns
// [y * chunk, y * chunk + chunk) and stages the block again.  launch_tiled
// picks chunk so that the tile and the staging fit the shared memory a CTA
// may opt in to on the device.
#pragma once

#include "segmented.cuh"

struct KhatriRao {
  int rank;
  __device__ __forceinline__ int stride(int) const { return rank; }
  __device__ __forceinline__ void split(int c, int,
                                        int (&col)[kMaxOther]) const {
#pragma unroll
    for (int i = 0; i < kMaxOther; ++i) col[i] = c;
  }
};

// The CTA's dynamic shared memory: the row_tile x chunk float tile, then
// per staged entry its local row, its value and its n_other factor-row ids.
struct TileSmem {
  float* acc;
  int* local;
  float* val;
  int* ids;
};

__device__ __forceinline__ TileSmem tile_smem(float* smem, int row_tile,
                                              int chunk, int block) {
  TileSmem s;
  s.acc = smem;
  s.local = reinterpret_cast<int*>(s.acc + row_tile * chunk);
  s.val = reinterpret_cast<float*>(s.local + block);
  s.ids = reinterpret_cast<int*>(s.val + block);
  return s;
}

inline size_t tile_smem_bytes(int row_tile, int chunk, int block,
                              int n_other) {
  return sizeof(float) * (static_cast<size_t>(row_tile) * chunk +
                          static_cast<size_t>(block) * (2 + n_other));
}

// The output columns a CTA owns: [c0, c0 + cw).
struct Columns {
  int c0;
  int cw;
};

__device__ __forceinline__ Columns cta_columns(int width, int chunk) {
  const int c0 = blockIdx.y * chunk;
  return Columns{c0, min(chunk, width - c0)};
}

template <typename TF, typename Cols>
__device__ __forceinline__ float contribution(const FactorPtrs& factors,
                                             const Cols& cols,
                                             const int* ids,
                                             const int (&col)[kMaxOther],
                                             int n_other, float val) {
  float p = val;
#pragma unroll
  for (int i = 0; i < kMaxOther; ++i) {
    if (i >= n_other) break;
    const TF* f = static_cast<const TF*>(factors.p[i]);
    p *= load_f32(f + static_cast<long long>(ids[i]) * cols.stride(i) +
                  col[i]);
  }
  return p;
}

// Called by every thread of the CTA after its staging loop, with the lowest
// and highest local row that thread staged (row_tile and -1 if none).
template <typename TF, typename Cols>
__device__ void accumulate_and_flush(const TileSmem& s,
                                     const FactorPtrs& factors,
                                     const Cols& cols, int n_other, int lo,
                                     int hi, int block, int row_tile,
                                     int base, int num_rows, int width,
                                     Columns own, float* __restrict__ out) {
  __shared__ int s_lo, s_hi;
  if (threadIdx.x == 0) {
    s_lo = row_tile;
    s_hi = -1;
  }
  __syncthreads();  // also publishes the staged entries
  atomicMin(&s_lo, lo);
  atomicMax(&s_hi, hi);
  __syncthreads();
  lo = s_lo;
  hi = s_hi;
  const int cw = own.cw;
  // only the rows between the block's first and last are touched
  const int span = hi >= lo ? (hi - lo + 1) * cw : 0;
  float* acc_lo = s.acc + (hi >= lo ? lo * cw : 0);
  for (int e = threadIdx.x; e < span; e += blockDim.x) acc_lo[e] = 0.f;
  __syncthreads();

  int col[kMaxOther];
  if (cw <= static_cast<int>(blockDim.x)) {
    // groups of cw consecutive threads, one entry per group at a time, so
    // a group's gathers of one factor row are contiguous; a thread's
    // column is fixed, so its factor columns are split once
    const int groups = blockDim.x / cw;
    const int g = threadIdx.x / cw;
    const int r = threadIdx.x - g * cw;
    if (g < groups) {
      cols.split(own.c0 + r, n_other, col);
      for (int n = g; n < block; n += groups) {
        const int local = s.local[n];
        if (local < 0) continue;
        atomicAdd(&s.acc[local * cw + r],
                  contribution<TF>(factors, cols, s.ids + n * n_other, col,
                                   n_other, s.val[n]));
      }
    }
  } else {
    for (int e = threadIdx.x; e < block * cw; e += blockDim.x) {
      const int n = e / cw;
      const int r = e - n * cw;
      const int local = s.local[n];
      if (local < 0) continue;
      cols.split(own.c0 + r, n_other, col);
      atomicAdd(&s.acc[local * cw + r],
                contribution<TF>(factors, cols, s.ids + n * n_other, col,
                                 n_other, s.val[n]));
    }
  }
  __syncthreads();

  // flush the touched rows; rows left at zero need no atomic
  for (int e = threadIdx.x; e < span; e += blockDim.x) {
    const float a = acc_lo[e];
    const int row = base + lo + e / cw;
    if (a != 0.f && row < num_rows)
      atomicAdd(out + static_cast<long long>(row) * width + own.c0 + e % cw,
                a);
  }
}

// Picks the CTA's columns, sets the kernel's dynamic shared memory and
// launches it over (nblocks, ceil(width / chunk)) CTAs, chunk passed as the
// kernel's last argument: the fewest CTAs across the width whose tile and
// staging fit the device's opt-in shared memory (less the kernel's static
// shared memory), the columns spread evenly over them.  Returns a
// cudaError_t.
template <typename Kernel, typename... Args>
int launch_tiled(Kernel kernel, int nblocks, int width, int row_tile,
                 int block, int n_other, cudaStream_t stream, Args... args) {
  if (width < 1 || block < 1 || row_tile < 1) return cudaErrorInvalidValue;
  int device = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  const long long room = static_cast<long long>(optin) -
                         static_cast<long long>(attr.sharedSizeBytes) -
                         static_cast<long long>(
                             tile_smem_bytes(0, 0, block, n_other));
  const long long widest =
      room / (static_cast<long long>(sizeof(float)) * row_tile);
  if (widest < 1) return cudaErrorInvalidValue;  // not one column fits
  const long long ctas = (width + widest - 1) / widest;
  const int chunk = static_cast<int>((width + ctas - 1) / ctas);
  const size_t smem = tile_smem_bytes(row_tile, chunk, block, n_other);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (nblocks == 0) return cudaSuccess;
  const dim3 grid(nblocks, (width + chunk - 1) / chunk);
  kernel<<<grid, kThreads, smem, stream>>>(args..., chunk);
  return cudaGetLastError();
}
