// MTTKRP over one mode's CSF workspace, written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mttkrp_pallas.py `_kernel` (launched by
// `mttkrp_pallas_call`), together with the factor-row gathers that
// src/repro/kernels/ops.py `mttkrp` ran in XLA before calling it.
//
// Computes, for every stored entry n of the workspace:
//   out[row[n], r] += vals[n] * prod_i F_i[other_ids[n, i], r]
// with float32 accumulation, for any rank R and tensor order 2..8.
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
#include "tile.cuh"

namespace {

template <typename TV, typename TF>
__global__ void __launch_bounds__(kThreads)
mttkrp_csf_kernel(const int* __restrict__ rows,
                  const int* __restrict__ other_ids,
                  const TV* __restrict__ vals, FactorPtrs factors, int n_other,
                  const int* __restrict__ block_tile, float* __restrict__ out,
                  int block, int row_tile, int num_rows, int rank) {
  extern __shared__ float smem[];
  const TileSmem s = tile_smem(smem, row_tile, rank, block);
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
  accumulate_and_flush<TF>(s, factors, n_other, lo, hi, block, row_tile,
                           base, num_rows, rank, out);
}

template <typename TV, typename TF>
int launch(const void* rows, const void* other_ids, const void* vals,
           const FactorPtrs& factors, int n_other, const void* block_tile,
           void* out, int nblocks, int block, int row_tile, int num_rows,
           int rank, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(row_tile, rank, block, n_other);
  auto kernel = mttkrp_csf_kernel<TV, TF>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (nblocks == 0) return cudaSuccess;
  kernel<<<nblocks, kThreads, smem, stream>>>(
      static_cast<const int*>(rows), static_cast<const int*>(other_ids),
      static_cast<const TV*>(vals), factors, n_other,
      static_cast<const int*>(block_tile), static_cast<float*>(out), block,
      row_tile, num_rows, rank);
  return cudaGetLastError();
}

}  // namespace

// factors: n_other device pointers, one per other mode in ascending mode
// order, each a contiguous (dim, rank) matrix.  vals_bf16 / factors_bf16
// select bfloat16 over float32.  Returns a cudaError_t.
extern "C" int mttkrp_csf_launch(const void* rows, const void* other_ids,
                                 const void* vals, int vals_bf16,
                                 const void* const* factors, int n_other,
                                 int factors_bf16, const void* block_tile,
                                 void* out, int nblocks, int block,
                                 int row_tile, int num_rows, int rank,
                                 void* stream) {
  if (n_other < 1 || n_other > kMaxOther || rank < 1 || block < 1 ||
      row_tile < 1)
    return cudaErrorInvalidValue;
  FactorPtrs fp = {};
  for (int i = 0; i < n_other; ++i) fp.p[i] = factors[i];
  auto s = static_cast<cudaStream_t>(stream);
  if (vals_bf16) {
    return factors_bf16
               ? launch<__nv_bfloat16, __nv_bfloat16>(rows, other_ids, vals, fp, n_other, block_tile, out, nblocks, block, row_tile, num_rows, rank, s)
               : launch<__nv_bfloat16, float>(rows, other_ids, vals, fp, n_other, block_tile, out, nblocks, block, row_tile, num_rows, rank, s);
  }
  return factors_bf16
             ? launch<float, __nv_bfloat16>(rows, other_ids, vals, fp, n_other, block_tile, out, nblocks, block, row_tile, num_rows, rank, s)
             : launch<float, float>(rows, other_ids, vals, fp, n_other, block_tile, out, nblocks, block, row_tile, num_rows, rank, s);
}
