// MTTKRP and TTMc on the sort mode of the linearized (ALTO-style)
// workspace, written by hand for Hopper (sm_90a), with every coordinate
// decoded in the kernel.
//
// Replaces: src/repro/kernels/linearized_pallas.py `_kernel` (launched by
// `mttkrp_lin_pallas_call`) in both its uses, together with what its
// callers ran in XLA before calling it: the decodes and factor-row gathers
// of src/repro/kernels/ops.py `mttkrp_lin`, and those plus the row-wise
// Kronecker product and the all-ones operand of `ops.ttmc_lin`.
//
// Computes, for every stored entry n of the workspace, on the sort mode s,
// with float32 accumulation, for tensor order 2..8:
//   MTTKRP (lin_launch with kronecker = 0), any rank R:
//     out[row(n), r] += vals[n] * prod_{m != s} F_m[coord_m(n), r]
//   TTMc (kronecker = 1), W = prod_{m != s} R_m:
//     out[row(n), c] += vals[n] * prod_{m != s} F_m[coord_m(n), d_m(c)]
//   with d_m(c) the digits of c in the mixed radix (R_m), the last fastest.
// row(n) and every coord_m(n) are bit fields of the entry's packed 64-bit
// index, stored as two 32-bit words (hi, lo); each field is decoded here
// with a shift and a mask, and may straddle the two words.
//
// What bounds it: as for K1 (mttkrp.cu), memory traffic for MTTKRP and
// operations for a TTMc hundreds of columns wide.  Each stored entry
// brings 12 B from device memory (hi, lo, value) against K1's 16 B (row, two
// ids, value); the decodes are a few integer operations per entry.  The
// factor rows are gathered at random but stay in the 50 MB L2 at yelp's
// shape.
//
// Design: K1's, through tile.cuh.  One CTA takes one block of `block`
// stored entries (the stream is sorted by the sort mode's row and
// tile-aligned, so a block's rows lie in one row tile), decodes them into
// shared memory, sums them into a row_tile x R float tile with shared
// atomics, and adds the touched rows to the zeroed output with global
// atomics.  The TPU kernel took the gathered factor rows as operands; here
// the other modes' ids are decoded from the same two words and the rows
// gathered inside the kernel.  TTMc forms the Kronecker row inside the
// kernel and splits a wide output across CTAs, as K1 does (tile.cuh).
#include <cstdint>

#include "tile.cuh"

namespace {

constexpr int kMaxOrder = kMaxOther + 1;

struct Field {
  int offset;
  int width;
};

struct OtherFields {
  Field f[kMaxOther];
};

// One static (offset, width) field of the packed index; shifts on unsigned
// words are logical, and every shift count lies in [0, 31].
__device__ __forceinline__ int decode_field(uint32_t hi, uint32_t lo,
                                            Field field) {
  const uint32_t mask =
      field.width >= 32 ? 0xFFFFFFFFu : ((1u << field.width) - 1u);
  uint32_t word;
  if (field.offset >= 32) {
    word = hi >> (field.offset - 32);
  } else if (field.offset + field.width <= 32) {
    word = lo >> field.offset;
  } else {  // straddles: low part from lo, the rest from hi
    word = (lo >> field.offset) | (hi << (32 - field.offset));
  }
  return static_cast<int>(word & mask);
}

template <typename TV, typename TF, typename Cols>
__global__ void __launch_bounds__(kThreads)
lin_kernel(const uint32_t* __restrict__ hi_words,
           const uint32_t* __restrict__ lo_words, const TV* __restrict__ vals,
           FactorPtrs factors, Cols cols, int n_other, Field row_field,
           OtherFields other, const int* __restrict__ block_tile,
           float* __restrict__ out, int block, int row_tile, int num_rows,
           int width, int chunk) {
  extern __shared__ float smem[];
  const TileSmem s = tile_smem(smem, row_tile, chunk, block);
  const long long first = static_cast<long long>(blockIdx.x) * block;
  const int base = block_tile[blockIdx.x] * row_tile;

  // Stage the block: decode each entry's row and other-mode ids.  The
  // layout puts every row of a block inside its tile; an entry outside it
  // would write past the shared tile, so it is marked and left out.
  int lo = row_tile, hi = -1;
  for (int n = threadIdx.x; n < block; n += blockDim.x) {
    const uint32_t h = __ldg(hi_words + first + n);
    const uint32_t l = __ldg(lo_words + first + n);
    const int local = decode_field(h, l, row_field) - base;
    const bool inside = local >= 0 && local < row_tile;
    s.local[n] = inside ? local : -1;
    s.val[n] = load_f32(vals + first + n);
    for (int i = 0; i < n_other; ++i)
      s.ids[n * n_other + i] = decode_field(h, l, other.f[i]);
    if (inside) {
      lo = min(lo, local);
      hi = max(hi, local);
    }
  }
  accumulate_and_flush<TF>(s, factors, cols, n_other, lo, hi, block,
                           row_tile, base, num_rows, width,
                           cta_columns(width, chunk), out);
}

struct LinArgs {
  const uint32_t* hi_words;
  const uint32_t* lo_words;
  const void* vals;
  FactorPtrs factors;
  int n_other;
  Field row_field;
  OtherFields other;
  const int* block_tile;
  float* out;
  int nblocks, block, row_tile, num_rows, width;
  cudaStream_t stream;
};

template <typename TV, typename TF, typename Cols>
int launch(const LinArgs& a, const Cols& cols) {
  return launch_tiled(lin_kernel<TV, TF, Cols>, a.nblocks, a.width,
                      a.row_tile, a.block, a.n_other, a.stream, a.hi_words,
                      a.lo_words, static_cast<const TV*>(a.vals), a.factors,
                      cols, a.n_other, a.row_field, a.other, a.block_tile,
                      a.out, a.block, a.row_tile, a.num_rows, a.width);
}

template <typename Cols>
int launch_typed(const LinArgs& a, const Cols& cols, int vals_bf16,
                 int factors_bf16) {
  using bf16 = __nv_bfloat16;
  if (vals_bf16)
    return factors_bf16 ? launch<bf16, bf16>(a, cols)
                        : launch<bf16, float>(a, cols);
  return factors_bf16 ? launch<float, bf16>(a, cols)
                      : launch<float, float>(a, cols);
}

}  // namespace

// hi/lo: the packed index's 32-bit words.  factors: order - 1 device
// pointers, one per mode other than sort_mode in ascending mode order, each
// a contiguous (dim, ranks[i]) matrix; ranks: a host array of order - 1
// ints, all equal for MTTKRP (kronecker = 0).  offsets/widths: every mode's
// bit field (host arrays of `order` ints).  out: a zeroed (num_rows, width)
// float32 matrix, width = the rank (MTTKRP) or prod ranks (TTMc,
// kronecker = 1).  vals_bf16 / factors_bf16 select bfloat16 over float32.
// Returns a cudaError_t.
extern "C" int lin_launch(const void* hi_words, const void* lo_words,
                          const void* vals, int vals_bf16,
                          const void* const* factors, const int* ranks,
                          int factors_bf16, const int* offsets,
                          const int* widths, int order, int sort_mode,
                          const void* block_tile, void* out, int nblocks,
                          int block, int row_tile, int num_rows,
                          int kronecker, void* stream) {
  if (order < 2 || order > kMaxOrder || sort_mode < 0 || sort_mode >= order)
    return cudaErrorInvalidValue;
  for (int m = 0; m < order; ++m)
    if (offsets[m] < 0 || widths[m] < 1 || widths[m] > 32 ||
        offsets[m] + widths[m] > 64)
      return cudaErrorInvalidValue;
  const int n_other = order - 1;
  const long long width = output_width(ranks, n_other, kronecker != 0);
  if (width < 1) return cudaErrorInvalidValue;
  LinArgs a = {};
  a.hi_words = static_cast<const uint32_t*>(hi_words);
  a.lo_words = static_cast<const uint32_t*>(lo_words);
  a.vals = vals;
  a.n_other = n_other;
  for (int m = 0, i = 0; m < order; ++m) {
    if (m == sort_mode) continue;
    a.factors.p[i] = factors[i];
    a.other.f[i] = Field{offsets[m], widths[m]};
    ++i;
  }
  a.row_field = Field{offsets[sort_mode], widths[sort_mode]};
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
