// K1: MTTKRP and TTMc over one mode's CSF workspace, written by hand for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mttkrp_pallas.py `_kernel` (pl.pallas_call at
// :106, launched by `mttkrp_pallas_call`) in both its uses, together with
// what its callers ran in XLA before calling it: the factor-row gathers of
// src/repro/kernels/ops.py `mttkrp` (:43), and the gathers, the row-wise
// Kronecker product and the all-ones operand of `ops.ttmc` (:77).
//
// Computes, for every stored entry n of the workspace, with float32
// accumulation, for tensor order 2..8:
//   MTTKRP (csf_launch with kronecker = 0), any rank R:
//     out[row[n], r] += vals[n] * prod_i F_i[other_ids[n, i], r]
//   TTMc (kronecker = 1), factor i of rank R_i, W = prod_i R_i:
//     out[row[n], c] += vals[n] * prod_i F_i[other_ids[n, i], d_i(c)]
//   with d_i(c) the digits of c in the mixed radix (R_i), the last fastest.
//
// Both uses run the row-segmented kernel of segmented.cuh on the CSF stream
// (CsfStream: row, other ids and value, 16 B an entry at order 3), MTTKRP
// with the Khatri-Rao column map and TTMc with the Kronecker one.  What
// bounds them on this card is the factor rows gathered from L2: at R = 35
// two rows of 140 B an entry, 5-6 32-B sectors each; at W = 256 two rows
// of 64 B, 2 sectors each.  The stream from device memory and the
// arithmetic are each a small share of that.  The design (segmented.cuh)
// keeps a warp's running sums in registers, a group of entries' gathers in
// flight at once, and a row's sums flushed once when the row changes: no
// shared tile, no shared atomics, no per-call device query.  The reference's
// (pnnz x R) gathered rows and, for TTMc, its (pnnz x W) Kronecker buffer
// and all-ones operand (2 x 8.2 GB a call at yelp's size) are not formed.
#include "segmented.cuh"

// factors: n_other device pointers, one per other mode in ascending mode
// order, each a contiguous (dim, ranks[i]) matrix; ranks: a host array of
// n_other ints, all equal for MTTKRP (kronecker = 0).  out: a zeroed
// (num_rows, width) float32 matrix, width = the rank (MTTKRP) or prod ranks
// (TTMc, kronecker = 1).  pnnz: the stored entries, padding included.
// vals_bf16 / factors_bf16 select bfloat16 over float32.  cols_per_lane,
// segment, ctas and slices give the launch (kernels/mttkrp_cuda.py::
// mttkrp_geometry or ttmc_geometry); for TTMc every factor starts on 16
// bytes.  Returns a cudaError_t.
extern "C" int csf_launch(const void* rows, const void* other_ids,
                          const void* vals, int vals_bf16,
                          const void* const* factors, const int* ranks,
                          int n_other, int factors_bf16, void* out,
                          long long pnnz, int kronecker, int cols_per_lane,
                          int segment, int ctas, int slices, void* stream) {
  const long long width = output_width(ranks, n_other, kronecker != 0);
  const SegmentedGeometry g = {cols_per_lane, segment, ctas, slices};
  if (width < 1 || pnnz < 0 ||
      !segmented_geometry_ok(g, ranks, n_other, pnnz, width, kronecker != 0))
    return cudaErrorInvalidValue;
  FactorPtrs f = {};
  for (int i = 0; i < n_other; ++i) f.p[i] = factors[i];
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_types(vals_bf16, factors_bf16, [&](auto tv, auto tf) {
    using TV = typename decltype(tv)::type;
    using TF = typename decltype(tf)::type;
    const CsfStream<TV> s = {static_cast<const int*>(rows),
                             static_cast<const int*>(other_ids),
                             static_cast<const TV*>(vals)};
    // the CSF is sorted by row, as the kernel body needs
    if (kronecker)
      return launch_ttmc<TF>(s, f, ranks, n_other, static_cast<int>(width),
                             pnnz, g, o, st);
    return launch_mttkrp<TF>(s, f, ranks[0], n_other, pnnz, g, o, st);
  });
}
