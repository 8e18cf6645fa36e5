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
// What bounds it: memory traffic.  Each stored non-zero brings 16 B from
// device memory (row, two other ids, value) and does about 3 flops per rank
// column: at R = 35 that is some 6.5 flops per byte, under the ~20 fp32
// flops per byte at which the card stops being memory-bound.  Besides that
// stream, every entry gathers (order - 1) factor rows of R values at random;
// the factors (about 18 MB at yelp's shape) stay in the 50 MB L2, so the
// gathers are L2 traffic, not device-memory traffic.
//
// Design:
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
//    path materialised them as (pnnz x 128) buffers, about 4 GB of traffic
//    per mode at yelp's size.
//  * No lane padding of the rank.  Threads form groups of R consecutive
//    lanes, one group per non-zero at a time, so a group's gathers of one
//    factor row are contiguous.
//  * TTMc forms the Kronecker row inside the kernel, as it gathers the
//    factor rows: the reference's (pnnz x W) Kronecker buffer and all-ones
//    operand were 2 x 8.2 GB a call at yelp's size and W = 256.  Each
//    thread keeps one output column, so it splits that column into its
//    factor columns once (tile.cuh's Kronecker policy).  The work per entry
//    is W columns of (order - 1) gathers and products and one add: 768
//    flops a stored entry at W = 256, against 16 B read.  The function
//    itself needs fewer (528: val * F_1's row once, then one product and
//    one add a column), which is still enough to bound it by operations
//    once W is in the hundreds.
//  * The shared tile is row_tile x W floats; past the CTA's 227 KB (W over
//    about 440 at row tile 128) the width is split across CTAs
//    (blockIdx.y), each staging the block again.
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

template <typename TV, typename TF, typename Cols>
int launch(const CsfArgs& a, const Cols& cols) {
  return launch_tiled(csf_kernel<TV, TF, Cols>, a.nblocks, a.width,
                      a.row_tile, a.block, a.n_other, a.stream, a.rows,
                      a.other_ids, static_cast<const TV*>(a.vals), a.factors,
                      cols, a.n_other, a.block_tile, a.out, a.block,
                      a.row_tile, a.num_rows, a.width);
}

template <typename Cols>
int launch_typed(const CsfArgs& a, const Cols& cols, int vals_bf16,
                 int factors_bf16) {
  using bf16 = __nv_bfloat16;
  if (vals_bf16)
    return factors_bf16 ? launch<bf16, bf16>(a, cols)
                        : launch<bf16, float>(a, cols);
  return factors_bf16 ? launch<float, bf16>(a, cols)
                      : launch<float, float>(a, cols);
}

}  // namespace

// factors: n_other device pointers, one per other mode in ascending mode
// order, each a contiguous (dim, ranks[i]) matrix; ranks: a host array of
// n_other ints, all equal for MTTKRP (kronecker = 0).  out: a zeroed
// (num_rows, width) float32 matrix, width = the rank (MTTKRP) or prod ranks
// (TTMc, kronecker = 1).  vals_bf16 / factors_bf16 select bfloat16 over
// float32.  Returns a cudaError_t.
extern "C" int csf_launch(const void* rows, const void* other_ids,
                          const void* vals, int vals_bf16,
                          const void* const* factors, const int* ranks,
                          int n_other, int factors_bf16,
                          const void* block_tile, void* out, int nblocks,
                          int block, int row_tile, int num_rows,
                          int kronecker, void* stream) {
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
  if (kronecker) {
    Kronecker cols = {};
    for (int i = 0; i < n_other; ++i) cols.ranks[i] = ranks[i];
    return launch_typed(a, cols, vals_bf16, factors_bf16);
  }
  return launch_typed(a, KhatriRao{ranks[0]}, vals_bf16, factors_bf16);
}
