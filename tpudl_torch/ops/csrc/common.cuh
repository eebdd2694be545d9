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

// The i-th 16-byte vector of `base` (which must be 16-byte aligned), as
// loaded: a kernel that keeps loads in flight holds these and widens them
// later with unpack_vec.
template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* __restrict__ base, int64_t i) {
  return __ldg(reinterpret_cast<const uint4*>(base) + i);
}

template <typename T>
__device__ __forceinline__ void unpack_vec(const uint4& raw, float (&out)[VecWidth<T>::value]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < VecWidth<T>::value; ++j) out[j] = to_f32(e[j]);
}

// Load the i-th 16-byte vector of `base` (which must be 16-byte aligned)
// and widen it to f32.
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ base, int64_t i,
                                         float (&out)[VecWidth<T>::value]) {
  unpack_vec<T>(load_raw(base, i), out);
}

// The W f32 values [i * W, i * W + W) of `base` (16-byte aligned) as W / 4
// 16-byte loads: a kernel's f32 scale or bias beside a vector of T.
template <int W>
__device__ __forceinline__ void load_f32(const float* __restrict__ base, int64_t i,
                                         float (&out)[W]) {
  static_assert(W % 4 == 0, "whole 16-byte vectors of f32");
  const float4* p = reinterpret_cast<const float4*>(base) + i * (W / 4);
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const float4 f = __ldg(p + q);
    out[4 * q] = f.x;
    out[4 * q + 1] = f.y;
    out[4 * q + 2] = f.z;
    out[4 * q + 3] = f.w;
  }
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

// Chunks of W elements: W == VecWidth<T> is one 16-byte vector access
// (the base must be 16-byte aligned), W == 1 one scalar access. Chunk i
// covers elements [i * W, i * W + W).
template <typename T, int W>
__device__ __forceinline__ void load_chunk(const T* __restrict__ base, int64_t i,
                                           float (&out)[W]) {
  if constexpr (W == 1) {
    out[0] = to_f32(base[i]);
  } else {
    static_assert(W == VecWidth<T>::value, "a chunk is one element or one 16-byte vector");
    load_vec(base, i, out);
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_chunk(T* __restrict__ base, int64_t i,
                                            const float (&in)[W]) {
  if constexpr (W == 1) {
    base[i] = from_f32<T>(in[0]);
  } else {
    static_assert(W == VecWidth<T>::value, "a chunk is one element or one 16-byte vector");
    store_vec(base, i, in);
  }
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Programmatic dependent launch (Hopper). A kernel started by launch_pdl
// may begin while the kernel before it on the stream is still running,
// once every block of that kernel has called pdl_launch_dependents() (or
// exited). So it may do address arithmetic and shared-memory set-up
// first, but must neither read nor write device memory before
// pdl_wait(), which returns once the kernel before has finished and its
// writes are visible. Launched without the attribute, both are no-ops.
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Launch `kernel` on `stream` with programmatic stream serialization.
// Returns the launch's error code: a refused launch is reported, never
// replaced by a plain one.
template <typename... Params, typename... Args>
__host__ int launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block, cudaStream_t stream,
                        Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// Second pass of the cross-row reductions (dscale, dbias, db): the first
// pass leaves one f32 partial row per block in `in` ([gridDim.y][rows][cols]);
// this sums the `rows` partials of each column in a fixed order, so a
// backward is bitwise repeatable (no float atomics). blockDim is (32, 8):
// 32 neighbouring columns, each summed by 8 threads over every 8th row,
// then the 8 sums added in order. gridDim.x covers the columns; gridDim.y
// selects one of several stacked partial arrays and its output row.
__global__ void column_sum_kernel(const float* __restrict__ in, float* __restrict__ out,
                                  int64_t rows, int cols) {
  __shared__ float part[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const float* src = in + static_cast<int64_t>(blockIdx.y) * rows * cols;
  float acc = 0.0f;
  if (c < cols) {
    for (int64_t b = threadIdx.y; b < rows; b += 8) acc += src[b * cols + c];
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += part[j][threadIdx.x];
    out[static_cast<int64_t>(blockIdx.y) * cols + c] = s;
  }
}

__host__ inline int launch_column_sum(const float* in, float* out, int64_t rows, int cols,
                                      int arrays, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid(static_cast<unsigned>((cols + 31) / 32), static_cast<unsigned>(arrays));
  column_sum_kernel<<<grid, block, 0, stream>>>(in, out, rows, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tpudl

extern "C" const char* tpudl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
