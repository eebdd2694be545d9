// Shared helpers for the tpudl_torch Hopper kernels (sm_90a).
//
// Every kernel library exposes a plain C interface: pointers and the
// stream arrive as void* (ctypes.c_void_p), each entry point launches
// on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tpudl {

// Element types the kernels take, as the wrappers encode them.
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// Elements per 16-byte vector access.
template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int value = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int value = 8; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
// Round to nearest even, as XLA's f32 -> bf16 convert.
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Load the i-th 16-byte vector of `base` (which must be 16-byte aligned)
// and widen it to f32.
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ base, int64_t i,
                                         float (&out)[VecWidth<T>::value]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(base) + i);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < VecWidth<T>::value; ++j) out[j] = to_f32(e[j]);
}

// Narrow f32 values to T and store them as the i-th 16-byte vector.
template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ base, int64_t i,
                                          const float (&in)[VecWidth<T>::value]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < VecWidth<T>::value; ++j) e[j] = from_f32<T>(in[j]);
  reinterpret_cast<uint4*>(base)[i] = raw;
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace tpudl

extern "C" const char* tpudl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
