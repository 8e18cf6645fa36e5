// K3: MTTKRP and TTMc on the sort mode of the linearized (ALTO-style)
// workspace, written by hand for Hopper (sm_90a), with every coordinate
// decoded in the kernel.
//
// Replaces: src/repro/kernels/linearized_pallas.py `_kernel` (pl.pallas_call
// at :97, launched by `mttkrp_lin_pallas_call`) in both its uses, together
// with what its callers ran in XLA before calling it: the decodes and
// factor-row gathers of src/repro/kernels/ops.py `mttkrp_lin` (:114), and
// those plus the row-wise Kronecker product and the all-ones operand of
// `ops.ttmc_lin` (:158).
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
// with a shift and a mask (segmented.cuh::decode_field), and may straddle
// the two words (yelp's sort mode 0 puts the row at bits 31..46).
//
// What bounds it on this card: the stream is 12 B an entry from device
// memory (hi, lo, value) against K1's 16 B; the factor rows gathered from
// L2 dominate, as for K1 (mttkrp.cu): at W = 256 the 64-B rows of F_1 and
// F_2, 2 sectors each, an entry.  The decodes are a few integer operations
// an entry.
//
// TTMc runs the row-segmented kernel of segmented.cuh on LinStream: the
// sort mode's stream never decreases in row, padding included (field_offsets
// makes the sort mode the most significant field, and padding packs its
// tile's last real row, or an empty tile's first, with value 0), so each
// warp takes a range of entries, each lane sums its Kronecker run of columns
// in registers, a group of entries' gathers is in flight at once, and a row
// is flushed when it changes.  Each entry's fields are decoded once, by the
// lane that loaded it, before the warp's shuffles broadcast them.
//
// MTTKRP still runs the shared tile of tile.cuh: one CTA takes one block of
// `block` stored entries (the stream is tile-aligned, so a block's rows lie
// in one row tile), decodes them into shared memory, sums them into a
// row_tile x R float tile with shared atomics, and adds the touched rows to
// the zeroed output with global atomics.
#include <cstdint>

#include "tile.cuh"

namespace {

constexpr int kMaxOrder = kMaxOther + 1;

template <typename TV, typename TF, typename Cols>
__global__ void __launch_bounds__(kThreads)
lin_kernel(const uint32_t* __restrict__ hi_words,
           const uint32_t* __restrict__ lo_words, const TV* __restrict__ vals,
           FactorPtrs factors, Cols cols, int n_other, Field row_field,
           Fields other, const int* __restrict__ block_tile,
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
  Fields other;
  const int* block_tile;
  float* out;
  int nblocks, block, row_tile, num_rows, width;
  cudaStream_t stream;
};

template <typename TV, typename TF>
int launch_tile(const LinArgs& a) {
  return launch_tiled(lin_kernel<TV, TF, KhatriRao>, a.nblocks, a.width,
                      a.row_tile, a.block, a.n_other, a.stream, a.hi_words,
                      a.lo_words, static_cast<const TV*>(a.vals), a.factors,
                      KhatriRao{a.width}, a.n_other, a.row_field, a.other,
                      a.block_tile, a.out, a.block, a.row_tile, a.num_rows,
                      a.width);
}

}  // namespace

// hi/lo: the packed index's 32-bit words.  factors: order - 1 device
// pointers, one per mode other than sort_mode in ascending mode order, each
// a contiguous (dim, ranks[i]) matrix; ranks: a host array of order - 1
// ints, all equal for MTTKRP (kronecker = 0).  offsets/widths: every mode's
// bit field (host arrays of `order` ints).  out: a zeroed (num_rows, width)
// float32 matrix, width = the rank (MTTKRP) or prod ranks (TTMc,
// kronecker = 1).  vals_bf16 / factors_bf16 select bfloat16 over float32.
// TTMc only: cols_per_lane, segment, ctas and slices give its launch
// (kernels/mttkrp_cuda.py::ttmc_geometry), and every factor starts on 16
// bytes; MTTKRP ignores them.  Returns a cudaError_t.
extern "C" int lin_launch(const void* hi_words, const void* lo_words,
                          const void* vals, int vals_bf16,
                          const void* const* factors, const int* ranks,
                          int factors_bf16, const int* offsets,
                          const int* widths, int order, int sort_mode,
                          const void* block_tile, void* out, int nblocks,
                          int block, int row_tile, int num_rows,
                          int kronecker, int cols_per_lane, int segment,
                          int ctas, int slices, void* stream) {
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
  const long long pnnz = static_cast<long long>(nblocks) * block;
  const SegmentedGeometry g = {cols_per_lane, segment, ctas, slices};
  if (kronecker &&
      !segmented_geometry_ok(g, ranks, n_other, pnnz, width, true))
    return cudaErrorInvalidValue;
  return dispatch_types(vals_bf16, factors_bf16, [&](auto tv, auto tf) {
    using TV = typename decltype(tv)::type;
    using TF = typename decltype(tf)::type;
    if (!kronecker) return launch_tile<TV, TF>(a);
    const LinStream<TV> s = {a.hi_words, a.lo_words,
                             static_cast<const TV*>(vals), a.row_field,
                             a.other};
    return launch_ttmc<TF>(s, a.factors, ranks, n_other, a.width, pnnz, g,
                           a.out, a.stream);
  });
}
