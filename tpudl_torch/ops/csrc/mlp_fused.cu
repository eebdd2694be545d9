// SwiGLU forward, y = silu(gate) * up, for Hopper (sm_90a).
//
// Replaces tpudl/ops/mlp_fused.py::_sw_fwd_kernel, launched by
// tpudl/ops/mlp_fused.py::_sw_call via pl.pallas_call.
//
// Computes elementwise, in f32: y = (g * (1 / (1 + exp(-g)))) * u, then
// rounds to the inputs' dtype.
//
// What bounds it on the H100: memory traffic. Per element it reads two
// values and writes one (6 bytes in bf16) for a handful of f32
// operations and one exp, well under the ~20 operations per byte where
// the f32 units would become the limit. On the Llama-3-8B path it runs
// on [N, 14336]: 344 KB at decode (N = 4 slots), 11 MB at a 128-token
// prefill.
//
// What the design does about that: a grid-stride loop in which every
// thread moves 16-byte vectors (8 bf16 or 4 f32 values) of gate, up and
// y, so each warp issues fully coalesced 512-byte accesses; the grid is
// capped at a few waves of the 132 SMs and each thread walks the rest.
// Elements past the last whole vector (or all of them, when a pointer is
// not 16-byte aligned) take a scalar path. The exponential is the
// accurate expf: this first version keeps the numerics of the f32
// composite before it is made fast.
#include "common.cuh"

namespace {

using tpudl::VecWidth;
using tpudl::from_f32;
using tpudl::load_vec;
using tpudl::store_vec;
using tpudl::to_f32;

__device__ __forceinline__ float swiglu_f32(float g, float u) {
  return (g * (1.0f / (1.0f + expf(-g)))) * u;
}

template <typename T, bool VEC>
__global__ void swiglu_fwd_kernel(const T* __restrict__ gate, const T* __restrict__ up,
                                  T* __restrict__ y, int64_t n) {
  constexpr int V = VecWidth<T>::value;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t scalar0 = 0;
  if (VEC) {
    const int64_t nvec = n / V;
    for (int64_t i = tid; i < nvec; i += stride) {
      float g[V], u[V];
      load_vec(gate, i, g);
      load_vec(up, i, u);
#pragma unroll
      for (int j = 0; j < V; ++j) g[j] = swiglu_f32(g[j], u[j]);
      store_vec(y, i, g);
    }
    scalar0 = nvec * V;
  }
  for (int64_t c = scalar0 + tid; c < n; c += stride) {
    y[c] = from_f32<T>(swiglu_f32(to_f32(gate[c]), to_f32(up[c])));
  }
}

template <typename T>
int launch(const void* gate, const void* up, void* y, int64_t n, cudaStream_t stream) {
  constexpr int V = VecWidth<T>::value;
  constexpr int kThreads = 256;
  // A few waves of 132 SMs at 8 blocks each; the grid-stride loop covers
  // the rest.
  constexpr int64_t kMaxBlocks = 132 * 8 * 4;
  const bool vec = tpudl::aligned16(gate) && tpudl::aligned16(up) && tpudl::aligned16(y);
  const int64_t work = vec ? (n + V - 1) / V : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const T* g = static_cast<const T*>(gate);
  const T* u = static_cast<const T*>(up);
  T* out = static_cast<T*>(y);
  if (vec) {
    swiglu_fwd_kernel<T, true><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(g, u, out, n);
  } else {
    swiglu_fwd_kernel<T, false><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(g, u, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// gate, up, y: n contiguous elements of tpudl::DType `dtype`.
extern "C" int tpudl_swiglu_fwd(const void* gate, const void* up, void* y, int64_t n,
                                int dtype, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tpudl::kFloat32:
      return launch<float>(gate, up, y, n, st);
    case tpudl::kBFloat16:
      return launch<__nv_bfloat16>(gate, up, y, n, st);
    default:
      return cudaErrorInvalidValue;
  }
}
