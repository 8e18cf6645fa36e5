// K3: MTTKRP and TTMc on the linearized (ALTO-style) workspace, written by
// hand for Hopper (sm_90a), with every coordinate decoded in the kernel: on
// the workspace's sort mode, and on each of its other modes.
//
// Replaces: src/repro/kernels/linearized_pallas.py `_kernel` (pl.pallas_call
// at :97, launched by `mttkrp_lin_pallas_call`) in both its uses, together
// with what its callers ran in XLA before calling it: the decodes and
// factor-row gathers of src/repro/kernels/ops.py `mttkrp_lin` (:114), and
// those plus the row-wise Kronecker product and the all-ones operand of
// `ops.ttmc_lin` (:158).  On the other modes, where the reference has no
// kernel, it replaces the jnp decode, gather and scatter of
// src/repro/core/mttkrp.py `mttkrp_linearized` (:239) and
// src/repro/core/ttmc.py `ttmc_linearized` (:157).
//
// Computes, for every stored entry n of the workspace, on a target mode t,
// with float32 accumulation, for tensor order 2..8:
//   MTTKRP (lin_launch with kronecker = 0), any rank R:
//     out[coord_t(n), r] += vals[n] * prod_{m != t} F_m[coord_m(n), r]
//   TTMc (kronecker = 1), W = prod_{m != t} R_m:
//     out[coord_t(n), c] += vals[n] * prod_{m != t} F_m[coord_m(n), d_m(c)]
//   with d_m(c) the digits of c in the mixed radix (R_m), the last fastest.
// Every coord_m(n) is a bit field of the entry's packed 64-bit index,
// stored as two 32-bit words (hi, lo), decoded here with one 64-bit shift
// and a mask (segmented.cuh::decode_field); a field may straddle the two
// words (yelp's sort mode 0 puts mode 0 at bits 31..46, sort mode 1 puts
// mode 0 at bits 17..32).
//
// Both uses, on every mode, run the row-segmented kernel of segmented.cuh
// on LinStream (12 B an entry: hi, lo, value), with the row decoded from
// the target mode's field: MTTKRP with the Khatri-Rao column map (lane l
// owns columns l + 32 k), TTMc with the Kronecker one.  Every stream it
// walks is ordered by the target's row, so a row is stored once when it
// changes and only a warp range's first and last rows are added with
// atomics.  On the sort mode the stream is the workspace itself
// (field_offsets makes the sort mode the most significant field, and
// padding packs its tile's last real row, or an empty tile's first, with
// value 0).  On another mode, whose rows recur anywhere in the workspace,
// it is the workspace's entries stably re-sorted by that mode's field
// (core/linearized.py::ordered_stream, padding left out), built once per
// workspace and mode on the card by the wrapper; its words are unchanged,
// so the same fields decode them.  Adding every run of the workspace's own
// order with atomics instead took 1.1 GB of REDs a call at R = 35 and 8.2
// GB at W = 256 on yelp; the ordered stream leaves at most 2 rows a warp
// range (about 4 and 32 MB).  What bounds every mode then, as for K1
// (mttkrp.cu): the factor rows gathered from L2.
#include <cstdint>

#include "segmented.cuh"

// hi/lo: the packed index's 32-bit words, vals: the values, pnnz of each
// (padding included, where the stream has any).  The target mode's coordinate is the bit field
// (row_offset, row_width); factors: n_other device pointers, one per other
// mode in ascending mode order, each a contiguous (dim, ranks[i]) matrix
// indexed by the field (offsets[i], widths[i]); ranks: a host array of
// n_other ints, all equal for MTTKRP (kronecker = 0).  The stream's target
// rows must never decrease.  out: a zeroed (dims[target], width) float32 matrix,
// width = the rank (MTTKRP) or prod ranks (TTMc, kronecker = 1).
// vals_bf16 / factors_bf16 select bfloat16 over float32.  cols_per_lane,
// segment, ctas and slices give the launch (kernels/mttkrp_cuda.py::
// mttkrp_geometry or ttmc_geometry); for TTMc every factor starts on 16
// bytes.  Returns a cudaError_t.
extern "C" int lin_launch(const void* hi_words, const void* lo_words,
                          const void* vals, int vals_bf16,
                          const void* const* factors, const int* ranks,
                          int n_other, int factors_bf16, int row_offset,
                          int row_width, const int* offsets,
                          const int* widths, void* out,
                          long long pnnz, int kronecker, int cols_per_lane,
                          int segment, int ctas, int slices, void* stream) {
  const auto field_ok = [](int offset, int width) {
    return offset >= 0 && width >= 1 && width <= 32 && offset + width <= 64;
  };
  const long long width = output_width(ranks, n_other, kronecker != 0);
  const SegmentedGeometry g = {cols_per_lane, segment, ctas, slices};
  if (width < 1 || pnnz < 0 || !field_ok(row_offset, row_width) ||
      !segmented_geometry_ok(g, ranks, n_other, pnnz, width, kronecker != 0))
    return cudaErrorInvalidValue;
  FactorPtrs f = {};
  Fields other = {};
  for (int i = 0; i < n_other; ++i) {
    if (!field_ok(offsets[i], widths[i])) return cudaErrorInvalidValue;
    f.p[i] = factors[i];
    other.f[i] = Field{offsets[i], widths[i]};
  }
  const Field row = {row_offset, row_width};
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_types(vals_bf16, factors_bf16, [&](auto tv, auto tf) {
    using TV = typename decltype(tv)::type;
    using TF = typename decltype(tf)::type;
    const LinStream<TV> s = {static_cast<const uint32_t*>(hi_words),
                             static_cast<const uint32_t*>(lo_words),
                             static_cast<const TV*>(vals), row, other};
    const int w = static_cast<int>(width);
    return kronecker ? launch_ttmc<TF>(s, f, ranks, n_other, w, pnnz, g, o,
                                       st)
                     : launch_mttkrp<TF>(s, f, w, n_other, pnnz, g, o, st);
  });
}
