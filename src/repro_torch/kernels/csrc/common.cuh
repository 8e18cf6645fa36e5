// Helpers shared by the kernels' sources.  Each kernel source is built into
// its own shared library with a plain C interface (kernels/_build.py), so
// each includes this header once.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Loads through the read-only path, widened to float for accumulation.
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// A bfloat16 is the high half of a float32, so widening is a shift; x[j]
// and x[j + 1] take the low and the high value of the word w.
template <int N>
__device__ __forceinline__ void widen_bf16x2(uint32_t w, float (&x)[N],
                                             int j) {
  x[j] = __uint_as_float(w << 16);
  x[j + 1] = __uint_as_float(w & 0xFFFF0000u);
}

// N consecutive values from p, widened to float, through the read-only path
// in loads of 16 bytes (of N * sizeof(T) bytes when that is less).  p must
// be aligned to the load's size; N is a power of two.
template <int N>
__device__ __forceinline__ void load_run(const float* p, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + j));
      x[j] = v.x;
      x[j + 1] = v.y;
      x[j + 2] = v.z;
      x[j + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <int N>
__device__ __forceinline__ void load_run(const __nv_bfloat16* p,
                                         float (&x)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 8) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + j));
      widen_bf16x2(v.x, x, j);
      widen_bf16x2(v.y, x, j + 2);
      widen_bf16x2(v.z, x, j + 4);
      widen_bf16x2(v.w, x, j + 6);
    }
  } else if constexpr (N == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    widen_bf16x2(v.x, x, 0);
    widen_bf16x2(v.y, x, 2);
  } else if constexpr (N == 2) {
    widen_bf16x2(__ldg(reinterpret_cast<const unsigned int*>(p)), x, 0);
  } else {
    x[0] = load_f32(p);
  }
}

// The launchers return a cudaError_t as an int; the Python wrapper turns a
// non-zero code into an exception with this text.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
