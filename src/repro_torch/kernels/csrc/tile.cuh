// The shared-memory output tile that K1 (mttkrp.cu) and K3 (linearized.cu)
// sum one block of stored entries into, and its flush to the output.
//
// A CTA first stages its block of entries in shared memory: each entry's
// row inside the CTA's row tile (or -1 for an entry to leave out), its value
// widened to float, and the ids of its factor rows in the other modes.  The
// two kernels differ only there (K1 reads rows and ids from arrays, K3
// decodes them from the packed index).  Then accumulate_and_flush zeroes the
// rows the block touches, adds every entry's Khatri-Rao row product into
// them with shared atomics, and adds the touched rows to the output with
// global atomics (the wrapper zeroes the output).
#pragma once

#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kMaxOther = 7;  // tensor order up to 8

struct FactorPtrs {
  const void* p[kMaxOther];
};

// The CTA's dynamic shared memory: the row_tile x rank float tile, then per
// staged entry its local row, its value and its n_other factor-row ids.
struct TileSmem {
  float* acc;
  int* local;
  float* val;
  int* ids;
};

__device__ __forceinline__ TileSmem tile_smem(float* smem, int row_tile,
                                              int rank, int block) {
  TileSmem s;
  s.acc = smem;
  s.local = reinterpret_cast<int*>(s.acc + row_tile * rank);
  s.val = reinterpret_cast<float*>(s.local + block);
  s.ids = reinterpret_cast<int*>(s.val + block);
  return s;
}

inline size_t tile_smem_bytes(int row_tile, int rank, int block,
                              int n_other) {
  return sizeof(float) * (static_cast<size_t>(row_tile) * rank +
                          static_cast<size_t>(block) * (2 + n_other));
}

template <typename TF>
__device__ __forceinline__ float contribution(const FactorPtrs& factors,
                                             const int* s_ids, int n_other,
                                             int n, int r, int rank,
                                             float val) {
  float p = val;
  for (int i = 0; i < n_other; ++i) {
    const TF* f = static_cast<const TF*>(factors.p[i]);
    p *= load_f32(f + static_cast<long long>(s_ids[n * n_other + i]) * rank + r);
  }
  return p;
}

// Called by every thread of the CTA after its staging loop, with the lowest
// and highest local row that thread staged (row_tile and -1 if none).
template <typename TF>
__device__ void accumulate_and_flush(const TileSmem& s,
                                     const FactorPtrs& factors, int n_other,
                                     int lo, int hi, int block, int row_tile,
                                     int base, int num_rows, int rank,
                                     float* __restrict__ out) {
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
  // only the rows between the block's first and last are touched
  const int span = hi >= lo ? (hi - lo + 1) * rank : 0;
  float* acc_lo = s.acc + (hi >= lo ? lo * rank : 0);
  for (int e = threadIdx.x; e < span; e += blockDim.x) acc_lo[e] = 0.f;
  __syncthreads();

  if (rank <= static_cast<int>(blockDim.x)) {
    // groups of rank consecutive threads, one entry per group at a time, so
    // a group's gathers of one factor row are contiguous
    const int groups = blockDim.x / rank;
    const int g = threadIdx.x / rank;
    const int r = threadIdx.x - g * rank;
    if (g < groups) {
      for (int n = g; n < block; n += groups) {
        const int local = s.local[n];
        if (local < 0) continue;
        atomicAdd(&s.acc[local * rank + r],
                  contribution<TF>(factors, s.ids, n_other, n, r, rank,
                                   s.val[n]));
      }
    }
  } else {
    for (int e = threadIdx.x; e < block * rank; e += blockDim.x) {
      const int n = e / rank;
      const int r = e - n * rank;
      const int local = s.local[n];
      if (local < 0) continue;
      atomicAdd(&s.acc[local * rank + r],
                contribution<TF>(factors, s.ids, n_other, n, r, rank,
                                 s.val[n]));
    }
  }
  __syncthreads();

  // flush the touched rows; rows left at zero need no atomic
  for (int e = threadIdx.x; e < span; e += blockDim.x) {
    const float a = acc_lo[e];
    const int row = base + lo + e / rank;
    if (a != 0.f && row < num_rows)
      atomicAdd(out + static_cast<long long>(row) * rank + e % rank, a);
  }
}
