// Shared pieces of the port's CUDA kernels: element-type traits that load
// a stored element as float and round a float back for storing (float32,
// bfloat16), and the error-string export every kernel library carries so
// its ctypes wrapper can name a failed launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

struct F32 {
  using raw = float;
  static __device__ __forceinline__ float load(raw x) { return x; }
  static __device__ __forceinline__ raw store(float x) { return x; }
};

struct BF16 {
  using raw = uint16_t;
  static __device__ __forceinline__ float load(raw x) {
    return __bfloat162float(__ushort_as_bfloat16(x));
  }
  static __device__ __forceinline__ raw store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16(x));
  }
};

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
