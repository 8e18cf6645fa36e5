// Helpers shared by the kernels' sources.  Each kernel source is built into
// its own shared library with a plain C interface (kernels/_build.py), so
// each includes this header once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Loads through the read-only path, widened to float for accumulation.
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// The launchers return a cudaError_t as an int; the Python wrapper turns a
// non-zero code into an exception with this text.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
