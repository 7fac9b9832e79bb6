// Shared pieces of the kernel sources: the error-string export every
// library carries, and the int64 grid-stride index.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define KART_ERROR_STRING_EXPORT                                   \
  extern "C" const char* kart_error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }

__device__ __forceinline__ int64_t grid_start() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_stride() {
  return static_cast<int64_t>(gridDim.x) * blockDim.x;
}
