// The row-segmented kernel body of K1 (mttkrp.cu: MTTKRP and TTMc over one
// mode's CSF) and K3 (linearized.cu: MTTKRP and TTMc on the linearized
// workspace, on its sort mode and on every other mode), written by hand for
// Hopper (sm_90a).
//
// Replaces, through its two callers: src/repro/kernels/mttkrp_pallas.py
// `_kernel` (pl.pallas_call at :106) in both its uses,
// src/repro/kernels/linearized_pallas.py `_kernel` (pl.pallas_call at :97)
// in both its uses, and the jnp scatter the reference runs on the linearized
// workspace's other modes (src/repro/core/mttkrp.py:239,
// src/repro/core/ttmc.py:157).  The TPU kernels sum a block of entries into
// a VMEM output tile with a one-hot matmul over a sequential grid; here no
// output tile is kept at all.
//
// Computes, for every stored entry n of a stream, with float32
// accumulation, for tensor order 2..8 (k = order - 1 other modes):
//   out[row(n), c] += val(n) * prod_{i<k} F_i[id_i(n), col_i(c)]
// under one of two column maps:
//   KhatriRaoStrided (MTTKRP): one shared rank R, col_i(c) = c;
//   KroneckerRun (TTMc): factor i of rank R_i, W = prod R_i columns, and
//     col_i(c) the digits of c in the mixed radix (R_i), the last fastest
//     (the column order of core/ttmc.py::kron_chain).
//
// What bounds it on this card: the factor rows it gathers.  The stream is
// 12-16 B an entry from device memory (yelp: 8 M entries, 96-128 MB, about
// 0.04 ms at 3.35 TB/s); the gathered rows stay in the 50 MB L2 (yelp's
// factors are 4-18 MB) but are read at random, in 32-B sectors, each entry
// the whole row of every other factor across the warp's lanes: at R = 35
// two rows of 140 B, 5-6 sectors each (about 2.7 GB of sectors a call at
// yelp's size); at W = 256 two rows of 64 B, 2 sectors each (1.0 GB).
// Against that the arithmetic (3 flops a column at R = 35, 528 an entry at
// W = 256) is light, and float32 FMA keeps the 1e-4 limit that TF32 would
// break.  So the design is about keeping many independent gathers in flight
// and nothing else in their way:
//  * Row-segmented, as in SPLATT's CSF: each warp takes `segment`
//    consecutive stored entries, so every warp does the same work and a hot
//    row spreads over many warps.
//  * A stream policy fills a Batch, 32 consecutive entries, one per lane:
//    CsfStream reads rows, other ids and values; LinStream reads the packed
//    index's two words and the value (12 B) and decodes the row (any mode's
//    field) and every other mode's id in the lane that loaded the entry,
//    once per entry.  The next batch's loads are issued a batch ahead and
//    decoded when it becomes current, so their latency hides behind a batch
//    of work.  Each entry is broadcast to the warp by shuffles.
//  * A column map says which output columns a lane owns; it keeps their
//    running sums in registers (no shared memory, no shared atomics):
//    - KroneckerRun: CPL consecutive columns of the CTA's slice of W
//      (blockIdx.y; 32 x CPL a slice, CPL <= 16), CPL dividing the last
//      rank, so the other factors' digits stay fixed over the run and are
//      split once: an entry costs a lane one value of each factor but the
//      last and CPL values of the last one's row, in 16-byte loads.
//    - KhatriRaoStrided: lane l owns columns l + 32 k, k < K (K in 1, 2,
//      4, 8; 32 K a slice), the columns past R predicated off: the warp's
//      gather of one factor row is one coalesced run of R values, and so is
//      a plain-store flush.  At R = 35, K = 2, and the second group runs on
//      lanes 0-2 only.
//  * The gathers of a group of G entries are issued before any is used,
//    so a warp waits on one L2 round trip per group, not per entry.  That
//    needs the factor loops free of branches: order 3 (two other modes, the
//    main paths) is compiled with NO = 2 and its loops resolve at compile
//    time; other orders predicate their loads.
//  * A run of equal rows is summed in registers and flushed when the row
//    changes, under one of two flush policies, fixed at compile time:
//    - Sorted (the CSF, and the linearized workspace's sort mode): the
//      stream never decreases in row, padding included (padding points at a
//      row of its own tile and carries value 0).  A row that starts and
//      ends inside the warp's range is the warp's alone: a plain store.  The
//      range's first and last rows may be shared with the neighbouring
//      warps: atomicAdd into the output, which the wrapper zeroes.  So a
//      call writes about (rows + 2 x warp ranges) x width floats.
//    - Unsorted (the linearized workspace's other modes, whose stream is
//      ordered by the sort mode's field): a row may recur anywhere, so every
//      run is added with atomics (RED), 16 bytes at a time where the map's
//      columns allow (sm_90's vector atomicAdd); runs of equal rows still
//      merge in registers, and the padding (value 0, zero fields) is one run
//      a tile.  A call adds about runs x width floats, one run an entry
//      at yelp's sparsity: the REDs, not the gathers, may bound it.
//    Either way a row's sum changes order, in the last bits, from run to
//    run.
//  * No dynamic shared memory and no per-call device query: the wrappers
//    pick the launch in kernels/mttkrp_cuda.py (ttmc_geometry,
//    mttkrp_geometry) and the launch is the only host work.
#pragma once

#include <cstdint>

#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kMaxOther = 7;  // tensor order up to 8
constexpr int kLanes = 32;
constexpr int kWarps = kThreads / kLanes;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

struct FactorPtrs {
  const void* p[kMaxOther];
};

// Checks the ranks shared by every entry point and returns the output
// width, or -1 when they are invalid.  Khatri-Rao needs every rank equal;
// Kronecker multiplies them.
inline long long output_width(const int* ranks, int n_other, bool kronecker) {
  if (n_other < 1 || n_other > kMaxOther) return -1;
  long long width = kronecker ? 1 : ranks[0];
  for (int i = 0; i < n_other; ++i) {
    if (ranks[i] < 1) return -1;
    if (kronecker) {
      width *= ranks[i];
      if (width > (1 << 30)) return -1;
    } else if (ranks[i] != ranks[0]) {
      return -1;
    }
  }
  return width;
}

// One (offset, width) field of the packed 64-bit index, stored as the
// 32-bit words (hi, lo): a shift and a mask, the field may straddle the
// words.  width is 1..32 and offset + width at most 64 (checked on entry).
struct Field {
  int offset;
  int width;
};

struct Fields {
  Field f[kMaxOther];
};

__device__ __forceinline__ int decode_field(uint32_t hi, uint32_t lo,
                                            Field field) {
  const uint64_t word = (static_cast<uint64_t>(hi) << 32) | lo;
  const uint64_t mask = (uint64_t{1} << field.width) - 1u;
  return static_cast<int>((word >> field.offset) & mask);
}

// 32 consecutive stored entries of a warp's range, decoded, lane l holding
// entry base + l (zeros past the range's end, never used).
struct Batch {
  int row;
  int ids[kMaxOther];
  float val;
};

// The CSF stream: rows, other-mode ids (n_other a row) and values, read as
// they are.
template <typename TV>
struct CsfStream {
  const int* rows;
  const int* other_ids;
  const TV* vals;

  using Raw = Batch;

  __device__ __forceinline__ Raw load(int no, long long n,
                                      long long end) const {
    Raw b = {};
    if (n < end) {
      b.row = __ldg(rows + n);
      b.val = load_f32(vals + n);
#pragma unroll
      for (int i = 0; i < kMaxOther; ++i)
        if (i < no) b.ids[i] = __ldg(other_ids + n * no + i);
    }
    return b;
  }

  __device__ __forceinline__ Batch decode(const Raw& raw, int) const {
    return raw;
  }
};

// The linearized workspace's stream: the two words of the packed index and
// the value, 12 B an entry; `row` is the target mode's field and `other`
// the other modes' in ascending mode order (the sort mode among them when it
// is not the target).
template <typename TV>
struct LinStream {
  const uint32_t* hi_words;
  const uint32_t* lo_words;
  const TV* vals;
  Field row;
  Fields other;

  struct Raw {
    uint32_t hi;
    uint32_t lo;
    float val;
  };

  __device__ __forceinline__ Raw load(int, long long n, long long end) const {
    Raw r = {};
    if (n < end) {
      r.hi = __ldg(hi_words + n);
      r.lo = __ldg(lo_words + n);
      r.val = load_f32(vals + n);
    }
    return r;
  }

  __device__ __forceinline__ Batch decode(const Raw& raw, int no) const {
    Batch b = {};
    b.row = decode_field(raw.hi, raw.lo, row);
    b.val = raw.val;
#pragma unroll
    for (int i = 0; i < kMaxOther; ++i)
      if (i < no) b.ids[i] = decode_field(raw.hi, raw.lo, other.f[i]);
    return b;
  }
};

// The digits of column c in the mixed radix (ranks[0], ..., ranks[n - 1]),
// the last fastest.
struct Kronecker {
  int ranks[kMaxOther];
  __device__ __forceinline__ void split(int c, int n_other,
                                        int (&col)[kMaxOther]) const {
#pragma unroll
    for (int i = kMaxOther - 1; i >= 0; --i) {
      if (i < n_other) {
        col[i] = c % ranks[i];
        c /= ranks[i];
      }
    }
  }
};

// Entries in flight a group (their gathers issued before the first is
// used) at order 3, for each column map.  The Kronecker map's falls as a
// lane's columns, and so its registers, grow.  The Khatri-Rao map's is 2: at
// R = 35 that keeps the kernel at 48 registers, 5 CTAs a SM, which ran
// faster than deeper groups at fewer CTAs.  The variants for a run-time
// number of modes, whose items hold a slot for every factor, take half as
// many (at least 1): that keeps them free of spills.
template <int CPL>
constexpr int kKroneckerGroup = CPL >= 16 ? 2 : (CPL >= 8 ? 4 : 8);
constexpr int kKhatriRaoGroup = 2;
template <int G, int NO>
constexpr int kGroupAt = NO > 0 ? G : (G > 1 ? G / 2 : 1);

// TTMc: a lane owns CPL consecutive columns of W; see the header.
template <typename TF, int CPL>
struct KroneckerRun {
  FactorPtrs factors;
  Kronecker cols;
  int width;

  static constexpr int kCols = CPL;
  template <int NO>
  static constexpr int kGroup = kGroupAt<kKroneckerGroup<CPL>, NO>;

  // each factor's first element at the lane's digit, its rank (the row
  // stride), and the same for the last factor
  struct Lane {
    const TF* f[kMaxOther];
    int rank[kMaxOther];
    const TF* last;
    int last_rank;
    int c0;
    bool active;
  };

  // one entry as a lane needs it: its value, the factors before the last at
  // the lane's digits (1 past n_other - 1), and the lane's CPL values of the
  // last factor's row; the product is formed where the entry is used, so no
  // gather waits on another
  template <int NO>
  struct Item {
    float val;
    float p[kMaxOther - 1];
    float x[CPL];
  };

  __device__ __forceinline__ Lane lane(int l, int no) const {
    Lane ln = {};
    ln.c0 = (blockIdx.y * kLanes + l) * CPL;
    // a lane past the width gathers at column 0 and never writes
    ln.active = ln.c0 < width;
    int digit[kMaxOther] = {};
    cols.split(ln.active ? ln.c0 : 0, no, digit);
#pragma unroll
    for (int i = 0; i < kMaxOther; ++i) {
      if (i < no) {
        ln.f[i] = static_cast<const TF*>(factors.p[i]) + digit[i];
        ln.rank[i] = cols.ranks[i];
      }
      if (i == no - 1) {
        ln.last = ln.f[i];
        ln.last_rank = ln.rank[i];
      }
    }
    return ln;
  }

  template <int NO>
  __device__ __forceinline__ void gather(const int (&ids)[kMaxOther], int no,
                                         const Lane& ln, Item<NO>& it) const {
    int id_last = 0;
#pragma unroll
    for (int i = 0; i < kMaxOther; ++i)
      if (i == no - 1) id_last = ids[i];
#pragma unroll
    for (int i = 0; i < kMaxOther - 1; ++i)
      it.p[i] = i < no - 1
                    ? load_f32(ln.f[i] + static_cast<long long>(ids[i]) *
                                             ln.rank[i])
                    : 1.f;
    load_run<CPL>(ln.last + static_cast<long long>(id_last) * ln.last_rank,
                  it.x);
  }

  template <int NO>
  __device__ __forceinline__ void add(float (&acc)[CPL],
                                      const Item<NO>& it) const {
    float pre = it.val;
#pragma unroll
    for (int i = 0; i < kMaxOther - 1; ++i) pre *= it.p[i];
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[c] = fmaf(pre, it.x[c], acc[c]);
  }

  __device__ __forceinline__ void flush(float* __restrict__ out, int row,
                                        const Lane& ln,
                                        const float (&acc)[CPL],
                                        bool shared) const {
    if (!ln.active) return;
    float* p = out + static_cast<long long>(row) * width + ln.c0;
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

  // a run of an unsorted stream, added to its row: the lane's run of
  // columns in vector atomics (16 or 8 bytes; the width is a multiple of
  // CPL, so they are aligned)
  __device__ __forceinline__ void add_to(float* __restrict__ out, int row,
                                         const Lane& ln,
                                         const float (&acc)[CPL]) const {
    if (!ln.active) return;
    float* p = out + static_cast<long long>(row) * width + ln.c0;
    if constexpr (CPL % 4 == 0) {
#pragma unroll
      for (int c = 0; c < CPL; c += 4)
        atomicAdd(reinterpret_cast<float4*>(p + c),
                  make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]));
    } else if constexpr (CPL == 2) {
      atomicAdd(reinterpret_cast<float2*>(p), make_float2(acc[0], acc[1]));
    } else {
      atomicAdd(p, acc[0]);
    }
  }
};

// MTTKRP: lane l owns columns c0 + 32 k, k < K, of the CTA's slice of R
// (c0 = 32 K blockIdx.y + l); see the header.
template <typename TF, int K>
struct KhatriRaoStrided {
  FactorPtrs factors;
  int rank;

  static constexpr int kCols = K;
  template <int NO>
  static constexpr int kGroup = kGroupAt<kKhatriRaoGroup, NO>;

  struct Lane {
    int c0;
    bool active[K];  // column c0 + 32 k lies inside the rank
  };

  // one entry as a lane needs it: its value and, at the lane's K columns,
  // each factor's values (order 3), or their product (other orders, whose
  // loads are predicated); multiplied by the value where the entry is used
  template <int NO>
  static constexpr int kHeld = NO > 0 ? NO : 1;

  template <int NO>
  struct Item {
    float val;
    float f[kHeld<NO>][K];
  };

  __device__ __forceinline__ Lane lane(int l, int) const {
    Lane ln;
    ln.c0 = blockIdx.y * kLanes * K + l;
#pragma unroll
    for (int k = 0; k < K; ++k) ln.active[k] = ln.c0 + k * kLanes < rank;
    return ln;
  }

  template <int NO>
  __device__ __forceinline__ void gather(const int (&ids)[kMaxOther], int no,
                                         const Lane& ln, Item<NO>& it) const {
    if constexpr (NO == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) it.f[0][k] = 1.f;
    }
#pragma unroll
    for (int i = 0; i < (NO > 0 ? NO : kMaxOther); ++i) {
      const TF* row = static_cast<const TF*>(factors.p[i]) +
                      static_cast<long long>(ids[i]) * rank + ln.c0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if constexpr (NO > 0)
          it.f[i][k] = ln.active[k] ? load_f32(row + k * kLanes) : 0.f;
        else
          it.f[0][k] *=
              i < no && ln.active[k] ? load_f32(row + k * kLanes) : 1.f;
      }
    }
  }

  template <int NO>
  __device__ __forceinline__ void add(float (&acc)[K],
                                      const Item<NO>& it) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float x = it.val;
#pragma unroll
      for (int i = 0; i < kHeld<NO>; ++i) x *= it.f[i][k];
      acc[k] += x;
    }
  }

  __device__ __forceinline__ void flush(float* __restrict__ out, int row,
                                        const Lane& ln, const float (&acc)[K],
                                        bool shared) const {
    float* p = out + static_cast<long long>(row) * rank + ln.c0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!ln.active[k]) continue;
      if (shared)
        atomicAdd(p + k * kLanes, acc[k]);
      else
        p[k * kLanes] = acc[k];
    }
  }

  // a run of an unsorted stream, added to its row: each of the lane's
  // columns in a scalar atomic, the warp's 32 of a group side by side
  __device__ __forceinline__ void add_to(float* __restrict__ out, int row,
                                         const Lane& ln,
                                         const float (&acc)[K]) const {
    flush(out, row, ln, acc, true);
  }
};

// One warp per `segment` stored entries of `stream`, each lane summing the
// columns `map` gives it; see the header.  NO is the number of other modes
// when fixed at compile time (2: order 3), else 0 and n_other says.  Sorted:
// the stream never decreases in row (the flush policy; see the header).
// Left to pick the CTAs a SM (a second bound of 0), ptxas traded a few
// bytes of spill for one more CTA in some unsorted instances (24 B at order
// 3, bfloat16 factors, 16 columns a lane); at a bound of 1 CTA none spills
// and the main paths' unsorted kernels ran as fast.  The sorted instances
// keep the choice they were tuned with.
template <typename Stream, typename Map, int NO, bool Sorted>
__global__ void __launch_bounds__(kThreads, Sorted ? 0 : 1)
segmented_kernel(Stream stream, Map map, int n_other, long long pnnz,
                 int segment, float* __restrict__ out) {
  constexpr int G = Map::template kGroup<NO>;
  constexpr int C = Map::kCols;
  static_assert(kLanes % G == 0, "a group never straddles two batches");
  using Item = typename Map::template Item<NO>;
  const int no = NO > 0 ? NO : n_other;
  const int lane = threadIdx.x % kLanes;
  const long long start =
      (static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / kLanes) *
      segment;
  if (start >= pnnz) return;  // the whole warp
  const long long end = min(pnnz, start + segment);
  const typename Map::Lane ln = map.lane(lane, no);

  typename Stream::Raw ahead = stream.load(no, start + kLanes + lane, end);
  Batch now = stream.decode(stream.load(no, start + lane, end), no);
  const int first_row = __shfl_sync(kFullMask, now.row, 0);
  float acc[C] = {};
  int cur = first_row;
  for (long long base = start; base < end; base += kLanes) {
    const int count = static_cast<int>(min(static_cast<long long>(kLanes),
                                           end - base));
    for (int j0 = 0; j0 < count; j0 += G) {
      // G entries' gathers in flight at once; past `count` (the range's
      // last batch only) they read valid rows and are not used
      int rows[G];
      Item its[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int j = j0 + g;
        rows[g] = __shfl_sync(kFullMask, now.row, j);
        its[g].val = __shfl_sync(kFullMask, now.val, j);
        int ids[kMaxOther] = {};
#pragma unroll
        for (int i = 0; i < kMaxOther; ++i)
          if (i < no) ids[i] = __shfl_sync(kFullMask, now.ids[i], j);
        map.template gather<NO>(ids, no, ln, its[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (j0 + g >= count) break;
        if (rows[g] != cur) {
          if constexpr (Sorted)
            map.flush(out, cur, ln, acc, cur == first_row);
          else
            map.add_to(out, cur, ln, acc);
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] = 0.f;
          cur = rows[g];
        }
        map.template add<NO>(acc, its[g]);
      }
    }
    now = stream.decode(ahead, no);
    ahead = stream.load(no, base + 2 * kLanes + lane, end);
  }
  if constexpr (Sorted)
    map.flush(out, cur, ln, acc, true);
  else
    map.add_to(out, cur, ln, acc);
}

// A launch, picked by the wrapper (kernels/mttkrp_cuda.py): `cols_per_lane`
// columns a lane (CPL or K), `segment` entries a warp, `ctas` x `slices`
// CTAs.
struct SegmentedGeometry {
  int cols_per_lane, segment, ctas, slices;
};

// The geometry covers every stored entry and every column, and no slice is
// empty.  TTMc (kronecker): CPL is 1, 2, 4, 8 or 16 and divides the last
// rank; MTTKRP: K is 1, 2, 4 or 8.
inline bool segmented_geometry_ok(const SegmentedGeometry& g,
                                  const int* ranks, int n_other,
                                  long long pnnz, long long width,
                                  bool kronecker) {
  const long long c = g.cols_per_lane;
  const bool cols_ok =
      kronecker ? (c == 1 || c == 2 || c == 4 || c == 8 || c == 16) &&
                      ranks[n_other - 1] % c == 0
                : c == 1 || c == 2 || c == 4 || c == 8;
  return cols_ok && g.segment >= 1 && g.ctas >= 1 && g.slices >= 1 &&
         g.slices <= 65535 &&
         static_cast<long long>(g.ctas) * kWarps * g.segment >= pnnz &&
         g.slices * kLanes * c >= width &&
         (g.slices - 1) * kLanes * c < width;
}

template <bool Sorted, typename Stream, typename Map>
int launch_segmented(const Stream& s, const Map& map, int n_other,
                     long long pnnz, const SegmentedGeometry& g, float* out,
                     cudaStream_t stream) {
  const dim3 grid(g.ctas, g.slices);
  if (n_other == 2)
    segmented_kernel<Stream, Map, 2, Sorted><<<grid, kThreads, 0, stream>>>(
        s, map, n_other, pnnz, g.segment, out);
  else
    segmented_kernel<Stream, Map, 0, Sorted><<<grid, kThreads, 0, stream>>>(
        s, map, n_other, pnnz, g.segment, out);
  return cudaGetLastError();
}

// TTMc of `s` at Kronecker width over the factors of `ranks`, under the
// flush policy `Sorted`.
template <bool Sorted, typename TF, typename Stream>
int launch_ttmc(const Stream& s, const FactorPtrs& factors, const int* ranks,
                int n_other, int width, long long pnnz,
                const SegmentedGeometry& g, float* out, cudaStream_t stream) {
  Kronecker cols = {};
  for (int i = 0; i < n_other; ++i) cols.ranks[i] = ranks[i];
  switch (g.cols_per_lane) {
#define SEGMENTED_TTMC_CASE(CPL)                                         \
  case CPL:                                                              \
    return launch_segmented<Sorted>(                                     \
        s, KroneckerRun<TF, CPL>{factors, cols, width}, n_other, pnnz, g, \
        out, stream);
    SEGMENTED_TTMC_CASE(1)
    SEGMENTED_TTMC_CASE(2)
    SEGMENTED_TTMC_CASE(4)
    SEGMENTED_TTMC_CASE(8)
    SEGMENTED_TTMC_CASE(16)
#undef SEGMENTED_TTMC_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// MTTKRP of `s` at rank `rank`, under the flush policy `Sorted`.
template <bool Sorted, typename TF, typename Stream>
int launch_mttkrp(const Stream& s, const FactorPtrs& factors, int rank,
                  int n_other, long long pnnz, const SegmentedGeometry& g,
                  float* out, cudaStream_t stream) {
  switch (g.cols_per_lane) {
#define SEGMENTED_MTTKRP_CASE(K)                                          \
  case K:                                                                 \
    return launch_segmented<Sorted>(                                      \
        s, KhatriRaoStrided<TF, K>{factors, rank}, n_other, pnnz, g, out, \
        stream);
    SEGMENTED_MTTKRP_CASE(1)
    SEGMENTED_MTTKRP_CASE(2)
    SEGMENTED_MTTKRP_CASE(4)
    SEGMENTED_MTTKRP_CASE(8)
#undef SEGMENTED_MTTKRP_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
struct TypeTag {
  using type = T;
};

// Calls fn(TypeTag<TV>{}, TypeTag<TF>{}) for the values' and the factors'
// types, bfloat16 where the flag says so and float32 otherwise.
template <typename Fn>
int dispatch_types(int vals_bf16, int factors_bf16, Fn&& fn) {
  using bf16 = __nv_bfloat16;
  if (vals_bf16)
    return factors_bf16 ? fn(TypeTag<bf16>{}, TypeTag<bf16>{})
                        : fn(TypeTag<bf16>{}, TypeTag<float>{});
  return factors_bf16 ? fn(TypeTag<float>{}, TypeTag<bf16>{})
                      : fn(TypeTag<float>{}, TypeTag<float>{});
}
