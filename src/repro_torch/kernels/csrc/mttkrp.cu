// MTTKRP and TTMc over one mode's CSF workspace, written by hand for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mttkrp_pallas.py `_kernel` (launched by
// `mttkrp_pallas_call`) in both its uses, together with what its callers
// ran in XLA before calling it: the factor-row gathers of
// src/repro/kernels/ops.py `mttkrp`, and the gathers, the row-wise
// Kronecker product and the all-ones operand of `ops.ttmc`.
//
// Computes, for every stored entry n of the workspace, with float32
// accumulation, for tensor order 2..8:
//   MTTKRP (csf_launch with kronecker = 0), any rank R:
//     out[row[n], r] += vals[n] * prod_i F_i[other_ids[n, i], r]
//   TTMc (kronecker = 1), factor i of rank R_i, W = prod_i R_i:
//     out[row[n], c] += vals[n] * prod_i F_i[other_ids[n, i], d_i(c)]
//   with d_i(c) the digits of c in the mixed radix (R_i), the last fastest.
//
// MTTKRP (csf_kernel, through tile.cuh).  What bounds it: memory traffic.
// Each stored non-zero brings 16 B from device memory (row, two other ids,
// value) and does about 3 flops per rank column: at R = 35 some 6.5 flops
// per byte, under the ~20 fp32 flops per byte at which the card stops being
// memory-bound.  The (order - 1) factor rows each entry gathers (about
// 18 MB of factors at yelp's shape) stay in the 50 MB L2.  Design:
//  * The TPU kernel keeps one output tile in VMEM across a sequential grid
//    and zeroes it on the tile's first visit.  CUDA blocks run in parallel
//    and in no order, so here one CTA takes one block of `block` non-zeros,
//    sums it into a row_tile x R float tile in shared memory, and then adds
//    the rows the block touched to the output with atomicAdd (the wrapper
//    zeroes the output).  Every CTA does the same work, so skewed tensors
//    (yelp's hot rows) stay balanced; the cost is one global atomic per
//    touched (row, r) per block, and an order of summation that changes from
//    run to run in the last bits.
//  * Collisions inside a block, which the TPU sums with a one-hot matmul,
//    are shared-memory atomics here.
//  * The factor rows are gathered inside the kernel from other_ids; the TPU
//    path materialised them as (pnnz x 128) buffers.
//  * No lane padding of the rank.  Threads form groups of R consecutive
//    lanes, one group per non-zero at a time, so a group's gathers of one
//    factor row are contiguous.
//
// TTMc (ttmc_kernel).  What bounds it: the factor-row gathers.  At W = 256
// (ranks 16 x 16) an entry needs 528 flops but gathers 2 x 16 x 4 = 128 B
// of factor rows from L2, about 1 GB a call at yelp's 8 M entries, against
// 16 B it reads from device memory: at about 4 flops a gathered byte the
// L2 gather stream sets the pace, not arithmetic, and so no tensor cores
// (TF32 would also break the 1e-4 limit against the plain version).  The
// reference's (pnnz x W) Kronecker buffer and all-ones operand (2 x 8.2 GB
// a call at yelp's size) are not formed.  Design, row-segmented as in
// SPLATT's CSF, with no shared output tile:
//  * The CSF stream is sorted by output row, padding included (padding
//    points at a row of its own tile and carries value 0), so row ids never
//    decrease.  Each warp takes `segment` consecutive stored entries: every
//    warp does the same work, so a hot row spreads over many warps.
//  * Each lane owns `CPL` consecutive output columns of the CTA's slice of
//    W (blockIdx.y; 32 x CPL columns a slice, CPL <= 16) and keeps their
//    running sum in registers.  The wrapper picks CPL to divide the last
//    factor's rank, so the digits of the other factors stay fixed over the
//    lane's run and are split once: an entry costs a lane one gather per
//    factor but the last, and CPL contiguous values of the last factor's
//    row in 16-byte loads (at W = 256: one value of F_1 and 8 of F_2).
//  * The warp loads 32 entries' rows, ids and values at a time, one per
//    lane, and broadcasts each by shuffle; the next 32 are loaded while
//    these are used.  The gathers of a group of entries (4 at 8 columns a
//    lane) are issued together before any is used, so a warp waits on one
//    L2 round trip per group, not per entry.  That needs the factor loops
//    free of branches: order 3 (two other modes, the Tucker main path) has
//    them unrolled at compile time, other orders predicate their loads.
//    It takes 96 registers a thread at W = 256 in float32, so two CTAs
//    (16 warps) share an SM; capping it at 80 for a third spills.
//  * When the row changes the lane flushes its sums.  A row that starts and
//    ends inside the warp's range is the warp's alone: a plain store.  The
//    range's first and last rows may be shared with the neighbouring warps:
//    atomicAdd into the zeroed output.  So a call writes about (rows + warp
//    ranges) x W floats, and the summation order of a shared row still
//    changes from run to run in the last bits.
#include "tile.cuh"

namespace {

template <typename TV, typename TF, typename Cols>
__global__ void __launch_bounds__(kThreads)
csf_kernel(const int* __restrict__ rows, const int* __restrict__ other_ids,
           const TV* __restrict__ vals, FactorPtrs factors, Cols cols,
           int n_other, const int* __restrict__ block_tile,
           float* __restrict__ out, int block, int row_tile, int num_rows,
           int width, int chunk) {
  extern __shared__ float smem[];
  const TileSmem s = tile_smem(smem, row_tile, chunk, block);
  const long long first = static_cast<long long>(blockIdx.x) * block;
  const int base = block_tile[blockIdx.x] * row_tile;

  // Stage the block's local rows, values and other-mode ids.  The CSF
  // contract puts every row of a block inside its tile; an entry outside it
  // would write past the shared tile, so it is marked and left out.
  int lo = row_tile, hi = -1;
  for (int n = threadIdx.x; n < block; n += blockDim.x) {
    const int local = rows[first + n] - base;
    const bool inside = local >= 0 && local < row_tile;
    s.local[n] = inside ? local : -1;
    s.val[n] = load_f32(vals + first + n);
    for (int i = 0; i < n_other; ++i)
      s.ids[n * n_other + i] = other_ids[(first + n) * n_other + i];
    if (inside) {
      lo = min(lo, local);
      hi = max(hi, local);
    }
  }
  accumulate_and_flush<TF>(s, factors, cols, n_other, lo, hi, block,
                           row_tile, base, num_rows, width,
                           cta_columns(width, chunk), out);
}

constexpr int kLanes = 32;
constexpr int kWarps = kThreads / kLanes;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

// 32 consecutive stored entries of a warp's range, lane l holding entry
// base + l (zeros past the range's end, never used).
struct Batch {
  int row;
  int ids[kMaxOther];
  float val;
};

template <typename TV>
__device__ __forceinline__ Batch load_batch(const int* __restrict__ rows,
                                            const int* __restrict__ other_ids,
                                            const TV* __restrict__ vals,
                                            int n_other, long long n,
                                            long long end) {
  Batch b = {};
  if (n < end) {
    b.row = __ldg(rows + n);
    b.val = load_f32(vals + n);
#pragma unroll
    for (int i = 0; i < kMaxOther; ++i)
      if (i < n_other) b.ids[i] = __ldg(other_ids + n * n_other + i);
  }
  return b;
}

// One entry as a lane needs it: its row and value, the values of the
// factors before the last at the lane's fixed digits (1 past n_other - 1),
// and the lane's CPL values of the last factor's row.  The product is
// formed where the entry is used, so no gather waits on another.
template <int CPL>
struct Item {
  int row;
  float val;
  float p[kMaxOther - 1];
  float x[CPL];
};

// A lane's view of the factors: each one's first element at the lane's
// digit, its rank (the row stride), and the same for the last factor.
template <typename TF>
struct LaneFactors {
  const TF* f[kMaxOther];
  int rank[kMaxOther];
  const TF* last;
  int last_rank;
};

// Entry j of batch b, broadcast from lane j; every lane of the warp calls
// it, with NO (the number of other modes, 0 when only known at run time as
// n_other) the same in all, so no branch separates the gathers.
template <typename TF, int CPL, int NO>
__device__ __forceinline__ void fetch(const Batch& b, int j,
                                      const LaneFactors<TF>& lf, int n_other,
                                      Item<CPL>& it) {
  const int no = NO > 0 ? NO : n_other;
  it.row = __shfl_sync(kFullMask, b.row, j);
  it.val = __shfl_sync(kFullMask, b.val, j);
  int ids[kMaxOther] = {};
#pragma unroll
  for (int i = 0; i < kMaxOther; ++i)
    if (i < no) ids[i] = __shfl_sync(kFullMask, b.ids[i], j);
  int id_last = 0;
#pragma unroll
  for (int i = 0; i < kMaxOther; ++i)
    if (i == no - 1) id_last = ids[i];
#pragma unroll
  for (int i = 0; i < kMaxOther - 1; ++i)
    it.p[i] = i < no - 1
                  ? load_f32(lf.f[i] + static_cast<long long>(ids[i]) *
                                           lf.rank[i])
                  : 1.f;
  load_run<CPL>(lf.last + static_cast<long long>(id_last) * lf.last_rank,
                it.x);
}

template <int CPL>
__device__ __forceinline__ void flush(float* __restrict__ p,
                                      const float (&acc)[CPL], bool shared) {
  if (shared) {
#pragma unroll
    for (int c = 0; c < CPL; ++c) atomicAdd(p + c, acc[c]);
  } else if constexpr (CPL % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CPL; c += 4)
      *reinterpret_cast<float4*>(p + c) =
          make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
  } else if constexpr (CPL == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(acc[0], acc[1]);
  } else {
    p[0] = acc[0];
  }
}

// Entries a warp gathers for at once (independent gathers in flight before
// the first is used): fewer as a lane's columns, and so its registers, grow.
template <int CPL>
constexpr int kInFlight = CPL >= 16 ? 2 : (CPL >= 8 ? 4 : 8);

// One warp per `segment` stored entries, one lane per CPL output columns of
// slice blockIdx.y; see the header.  CPL divides the last factor's rank (so
// also the width), which keeps a lane's run inside one digit of every other
// factor and its loads and stores aligned.  NO is the number of other modes
// when fixed at compile time (2: order 3), else 0 and n_other says.
template <typename TV, typename TF, int CPL, int NO>
__global__ void __launch_bounds__(kThreads)
ttmc_kernel(const int* __restrict__ rows, const int* __restrict__ other_ids,
            const TV* __restrict__ vals, FactorPtrs factors, Kronecker cols,
            int n_other, long long pnnz, int segment, int width,
            float* __restrict__ out) {
  constexpr int G = kInFlight<CPL>;
  static_assert(kLanes % G == 0, "a group never straddles two batches");
  const int no = NO > 0 ? NO : n_other;
  const int lane = threadIdx.x % kLanes;
  const long long start =
      (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / kLanes) *
      segment;
  if (start >= pnnz) return;  // the whole warp
  const long long end = min(pnnz, start + segment);
  // a lane past the width gathers at column 0 and never writes
  const int c0 = (blockIdx.y * kLanes + lane) * CPL;
  const bool active = c0 < width;
  int digit[kMaxOther] = {};
  cols.split(active ? c0 : 0, no, digit);
  LaneFactors<TF> lf = {};
#pragma unroll
  for (int i = 0; i < kMaxOther; ++i) {
    if (i < no) {
      lf.f[i] = static_cast<const TF*>(factors.p[i]) + digit[i];
      lf.rank[i] = cols.ranks[i];
    }
    if (i == no - 1) {
      lf.last = lf.f[i];
      lf.last_rank = lf.rank[i];
    }
  }

  const int first_row = __ldg(rows + start);
  Batch now = load_batch(rows, other_ids, vals, no, start + lane, end);
  Batch next = load_batch(rows, other_ids, vals, no, start + kLanes + lane,
                          end);
  float acc[CPL] = {};
  int cur = first_row;
  for (long long base = start; base < end; base += kLanes) {
    const int count = static_cast<int>(min(static_cast<long long>(kLanes),
                                           end - base));
    for (int j0 = 0; j0 < count; j0 += G) {
      // G entries' gathers in flight at once; past `count` (the range's
      // last batch only) they read valid rows and are not used
      Item<CPL> its[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        fetch<TF, CPL, NO>(now, j0 + g, lf, n_other, its[g]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (j0 + g >= count) break;
        if (its[g].row != cur) {
          if (active)
            flush(out + static_cast<long long>(cur) * width + c0, acc,
                  cur == first_row);
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[c] = 0.f;
          cur = its[g].row;
        }
        float pre = its[g].val;
#pragma unroll
        for (int i = 0; i < kMaxOther - 1; ++i) pre *= its[g].p[i];
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[c] = fmaf(pre, its[g].x[c], acc[c]);
      }
    }
    now = next;
    next = load_batch(rows, other_ids, vals, no, base + 2 * kLanes + lane,
                      end);
  }
  if (active)
    flush(out + static_cast<long long>(cur) * width + c0, acc, true);
}

struct CsfArgs {
  const int* rows;
  const int* other_ids;
  const void* vals;
  FactorPtrs factors;
  int n_other;
  const int* block_tile;
  float* out;
  int nblocks, block, row_tile, num_rows, width;
  cudaStream_t stream;
};

// The TTMc launch, picked by the wrapper (kernels/mttkrp_cuda.py::
// ttmc_geometry): CPL columns a lane, `segment` entries a warp, `ctas` x
// `slices` CTAs.
struct TtmcGeometry {
  int cols_per_lane, segment, ctas, slices;
};

// Order 3 (two other modes, the Tucker main path) has its own kernel with
// the factor loops resolved at compile time; other orders share one.
template <typename TV, typename TF, int CPL>
int launch_ttmc(const CsfArgs& a, const Kronecker& cols,
                const TtmcGeometry& g) {
  const dim3 grid(g.ctas, g.slices);
  const long long pnnz = static_cast<long long>(a.nblocks) * a.block;
  const TV* vals = static_cast<const TV*>(a.vals);
  if (a.n_other == 2)
    ttmc_kernel<TV, TF, CPL, 2><<<grid, kThreads, 0, a.stream>>>(
        a.rows, a.other_ids, vals, a.factors, cols, a.n_other, pnnz,
        g.segment, a.width, a.out);
  else
    ttmc_kernel<TV, TF, CPL, 0><<<grid, kThreads, 0, a.stream>>>(
        a.rows, a.other_ids, vals, a.factors, cols, a.n_other, pnnz,
        g.segment, a.width, a.out);
  return cudaGetLastError();
}

template <typename TV, typename TF>
int launch(const CsfArgs& a, const Kronecker& cols, const TtmcGeometry& g) {
  switch (g.cols_per_lane) {
    case 1: return launch_ttmc<TV, TF, 1>(a, cols, g);
    case 2: return launch_ttmc<TV, TF, 2>(a, cols, g);
    case 4: return launch_ttmc<TV, TF, 4>(a, cols, g);
    case 8: return launch_ttmc<TV, TF, 8>(a, cols, g);
    case 16: return launch_ttmc<TV, TF, 16>(a, cols, g);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TV, typename TF>
int launch(const CsfArgs& a, const KhatriRao& cols, const TtmcGeometry&) {
  return launch_tiled(csf_kernel<TV, TF, KhatriRao>, a.nblocks, a.width,
                      a.row_tile, a.block, a.n_other, a.stream, a.rows,
                      a.other_ids, static_cast<const TV*>(a.vals), a.factors,
                      cols, a.n_other, a.block_tile, a.out, a.block,
                      a.row_tile, a.num_rows, a.width);
}

template <typename Cols>
int launch_typed(const CsfArgs& a, const Cols& cols, const TtmcGeometry& g,
                 int vals_bf16, int factors_bf16) {
  using bf16 = __nv_bfloat16;
  if (vals_bf16)
    return factors_bf16 ? launch<bf16, bf16>(a, cols, g)
                        : launch<bf16, float>(a, cols, g);
  return factors_bf16 ? launch<float, bf16>(a, cols, g)
                      : launch<float, float>(a, cols, g);
}

// The geometry covers every stored entry and every column, CPL divides the
// last factor's rank, and no slice is empty.
bool ttmc_geometry_ok(const TtmcGeometry& g, const int* ranks, int n_other,
                      long long pnnz, long long width) {
  const long long cpl = g.cols_per_lane;
  return cpl >= 1 && ranks[n_other - 1] % cpl == 0 && g.segment >= 1 &&
         g.ctas >= 1 && g.slices >= 1 && g.slices <= 65535 &&
         static_cast<long long>(g.ctas) * kWarps * g.segment >= pnnz &&
         g.slices * kLanes * cpl >= width &&
         (g.slices - 1) * kLanes * cpl < width;
}

}  // namespace

// factors: n_other device pointers, one per other mode in ascending mode
// order, each a contiguous (dim, ranks[i]) matrix; ranks: a host array of
// n_other ints, all equal for MTTKRP (kronecker = 0).  out: a zeroed
// (num_rows, width) float32 matrix, width = the rank (MTTKRP) or prod ranks
// (TTMc, kronecker = 1).  vals_bf16 / factors_bf16 select bfloat16 over
// float32.  TTMc only: cols_per_lane (1, 2, 4, 8 or 16), segment, ctas and
// slices give its launch, and every factor starts on 16 bytes; MTTKRP
// ignores them.  Returns a cudaError_t.
extern "C" int csf_launch(const void* rows, const void* other_ids,
                          const void* vals, int vals_bf16,
                          const void* const* factors, const int* ranks,
                          int n_other, int factors_bf16,
                          const void* block_tile, void* out, int nblocks,
                          int block, int row_tile, int num_rows,
                          int kronecker, int cols_per_lane, int segment,
                          int ctas, int slices, void* stream) {
  const long long width = output_width(ranks, n_other, kronecker != 0);
  if (width < 1) return cudaErrorInvalidValue;
  CsfArgs a = {};
  a.rows = static_cast<const int*>(rows);
  a.other_ids = static_cast<const int*>(other_ids);
  a.vals = vals;
  for (int i = 0; i < n_other; ++i) a.factors.p[i] = factors[i];
  a.n_other = n_other;
  a.block_tile = static_cast<const int*>(block_tile);
  a.out = static_cast<float*>(out);
  a.nblocks = nblocks;
  a.block = block;
  a.row_tile = row_tile;
  a.num_rows = num_rows;
  a.width = static_cast<int>(width);
  a.stream = static_cast<cudaStream_t>(stream);
  const TtmcGeometry g = {cols_per_lane, segment, ctas, slices};
  if (kronecker) {
    if (!ttmc_geometry_ok(g, ranks, n_other,
                          static_cast<long long>(nblocks) * block, width))
      return cudaErrorInvalidValue;
    Kronecker cols = {};
    for (int i = 0; i < n_other; ++i) cols.ranks[i] = ranks[i];
    return launch_typed(a, cols, g, vals_bf16, factors_bf16);
  }
  return launch_typed(a, KhatriRao{ranks[0]}, g, vals_bf16, factors_bf16);
}
