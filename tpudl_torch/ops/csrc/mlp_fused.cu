// Fused MLP epilogues for Hopper (sm_90a): SwiGLU forward and backward, and
// bias+GeLU forward and backward.
//
// Replaces, in tpudl/ops/mlp_fused.py:
//   _sw_fwd_kernel and _sw_bwd_kernel, launched by _sw_call via pl.pallas_call;
//   _bg_fwd_kernel and _bg_bwd_kernel, launched by _bg_call via pl.pallas_call.
//
// Computes, in f32, rounding once to the inputs' dtype:
//   SwiGLU:          y = (g * (1 / (1 + exp(-g)))) * u
//   its backward:    with s = sigmoid(g) and silu = g * s,
//                    dg = go * u * (s + silu * (1 - s)), du = go * silu
//   bias+GeLU:       y = gelu(x + b), gelu(u) = u * 0.5 * (1 + erf(u / sqrt(2)))
//   its backward:    du = g * (Phi(u) + u * phi(u)) with u = x + b (no forward
//                    recompute beyond u), and db = sum over rows of du (f32).
//
// What bounds them on the H100: memory traffic. Per element they read two
// values and write one (6 bytes in bf16; the backward also one partial per
// column per block) for a handful of f32 operations and one exp or erf,
// well under the ~20 operations per byte where the f32 units would become
// the limit. On the Llama-3-8B path SwiGLU runs on [N, 14336]: 344 KB at
// decode (N = 4 slots), 11 MB at a 128-token prefill; its backward, on the
// Llama-3-8B LoRA step's [8192, 14336] bf16, reads three and writes two
// values per element (~1.17 GB, ~350 us at 3.35 TB/s). On the BERT-base
// train step bias+GeLU runs on [32768, 3072] bf16: ~403 MB forward
// (~120 us at 3.35 TB/s) and ~604 MB backward (~180 us).
//
// At decode (N = 4) SwiGLU's 344 KB take 0.1 us at the memory rate, so
// the launch and one load's latency are its whole time.
//
// What the design does about that:
// - SwiGLU forward: every thread moves 16-byte vectors (8 bf16 or 4 f32
//   values) of gate, up and y, so each warp issues fully coalesced
//   512-byte accesses. Small calls (decode) take one vector a thread in
//   blocks of 64 threads, so even [4, 14336]'s 7168 vectors spread over
//   112 SMs; larger ones blocks of 256 threads of two vectors of each
//   input a thread, all four loads issued before any math (a walk of 2, 4
//   or 8 such steps a thread with the next step's loads in flight was
//   slower at [8192, 14336] in kernel_ab). exp is one multiply
//   and ex2.approx, the reciprocal rcp.approx (relative error ~1e-6 in
//   f32). It is a programmatic dependent launch (common.cuh launch_pdl):
//   no device memory is touched before griddepcontrol.wait, and the next
//   dependent launch may start once the first loads are issued.
// - The SwiGLU backward: the forward's grid-stride loop with five 16-byte
//   streams (gate, up, go in; dg, du out), each output rounded once.
// - bias+GeLU: a 2-D grid, x over column chunks (one 16-byte vector each)
//   and y over runs of rows, so a thread loads its bias chunk once and
//   walks down its column chunk; no per-element index division.
// - The backward's db: the Pallas kernel sums it across its sequential
//   grid in VMEM scratch. Here each block keeps its column partials in
//   registers over a contiguous run of rows and writes one f32 partial row
//   to a workspace; a second kernel sums each column's partials in a fixed
//   order. No float atomics, so the backward is bitwise repeatable.
// Elements past the last whole vector (or all of them, when a pointer is
// not 16-byte aligned or a row is not a whole number of vectors) take the
// scalar path. The backward and bias+GeLU keep the accurate expf / erff.
#include "common.cuh"

namespace {

using tpudl::VecWidth;
using tpudl::from_f32;
using tpudl::load_chunk;
using tpudl::load_vec;
using tpudl::store_chunk;
using tpudl::store_vec;
using tpudl::to_f32;

// silu(g) * u in f32: exp(-g) as ex2.approx of -g * log2(e), the
// reciprocal as rcp.approx (a large negative g gives exp(-g) = inf and a
// reciprocal of 0, as expf and the division do).
__device__ __forceinline__ float swiglu_f32(float g, float u) {
  float e, q;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(g * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(q) : "f"(1.0f + e));
  return (g * q) * u;
}

// Block b takes the vectors [b * blockDim.x * VPT, (b + 1) * blockDim.x *
// VPT); thread t moves vectors base + k * blockDim.x (k < VPT), all its
// loads issued before any math. The elements past the last whole vector
// (fewer than one vector) go to block 0.
template <typename T, int VPT>
__global__ void __launch_bounds__(256)
    swiglu_fwd_kernel(const T* __restrict__ gate, const T* __restrict__ up, T* __restrict__ y,
                      int64_t n) {
  constexpr int V = VecWidth<T>::value;
  const int64_t nvec = n / V;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x * VPT + threadIdx.x;
  tpudl::pdl_wait();
  uint4 ga[VPT], ua[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int64_t i = base + k * blockDim.x;
    if (i < nvec) {
      ga[k] = tpudl::load_raw(gate, i);
      ua[k] = tpudl::load_raw(up, i);
    }
  }
  tpudl::pdl_launch_dependents();
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int64_t i = base + k * blockDim.x;
    if (i < nvec) {
      float g[V], u[V];
      tpudl::unpack_vec<T>(ga[k], g);
      tpudl::unpack_vec<T>(ua[k], u);
#pragma unroll
      for (int j = 0; j < V; ++j) g[j] = swiglu_f32(g[j], u[j]);
      store_vec(y, i, g);
    }
  }
  const int64_t tail = nvec * V + threadIdx.x;
  if (blockIdx.x == 0 && tail < n) {
    y[tail] = from_f32<T>(swiglu_f32(to_f32(gate[tail]), to_f32(up[tail])));
  }
}

// Pointers off a 16-byte boundary: one element a thread, grid-stride.
template <typename T>
__global__ void __launch_bounds__(256)
    swiglu_fwd_scalar_kernel(const T* __restrict__ gate, const T* __restrict__ up,
                             T* __restrict__ y, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  tpudl::pdl_wait();
  tpudl::pdl_launch_dependents();
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; c < n;
       c += stride) {
    y[c] = from_f32<T>(swiglu_f32(to_f32(gate[c]), to_f32(up[c])));
  }
}

template <typename T>
int launch(const void* gate, const void* up, void* y, int64_t n, cudaStream_t stream) {
  constexpr int V = VecWidth<T>::value;
  const T* g = static_cast<const T*>(gate);
  const T* u = static_cast<const T*>(up);
  T* out = static_cast<T*>(y);
  if (!(tpudl::aligned16(gate) && tpudl::aligned16(up) && tpudl::aligned16(y))) {
    int64_t blocks = (n + 255) / 256;
    if (blocks > 132 * 8 * 4) blocks = 132 * 8 * 4;
    return tpudl::launch_pdl(swiglu_fwd_scalar_kernel<T>, dim3(static_cast<unsigned>(blocks)),
                             dim3(256), stream, g, u, out, n);
  }
  const int64_t nvec = n / V;
  // Up to two blocks of 64 threads per SM at one vector a thread; past
  // that, 256 threads of two vectors.
  if (nvec <= 64 * 132 * 2) {
    const int64_t blocks = nvec > 0 ? (nvec + 63) / 64 : 1;
    return tpudl::launch_pdl(swiglu_fwd_kernel<T, 1>, dim3(static_cast<unsigned>(blocks)),
                             dim3(64), stream, g, u, out, n);
  }
  return tpudl::launch_pdl(swiglu_fwd_kernel<T, 2>,
                           dim3(static_cast<unsigned>((nvec + 511) / 512)), dim3(256), stream,
                           g, u, out, n);
}

// dg, du of y = silu(g) * u, in f32, each rounded once to T.
__device__ __forceinline__ void swiglu_grad_f32(float g, float u, float go, float& dg,
                                                float& du) {
  const float s = 1.0f / (1.0f + expf(-g));
  const float silu = g * s;
  dg = go * u * (s + silu * (1.0f - s));
  du = go * silu;
}

template <typename T, bool VEC>
__global__ void swiglu_bwd_kernel(const T* __restrict__ gate, const T* __restrict__ up,
                                  const T* __restrict__ go, T* __restrict__ dg,
                                  T* __restrict__ du, int64_t n) {
  constexpr int V = VecWidth<T>::value;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t scalar0 = 0;
  if (VEC) {
    const int64_t nvec = n / V;
    for (int64_t i = tid; i < nvec; i += stride) {
      float g[V], u[V], o[V];
      load_vec(gate, i, g);
      load_vec(up, i, u);
      load_vec(go, i, o);
#pragma unroll
      for (int j = 0; j < V; ++j) swiglu_grad_f32(g[j], u[j], o[j], g[j], u[j]);
      store_vec(dg, i, g);
      store_vec(du, i, u);
    }
    scalar0 = nvec * V;
  }
  for (int64_t c = scalar0 + tid; c < n; c += stride) {
    float a, b;
    swiglu_grad_f32(to_f32(gate[c]), to_f32(up[c]), to_f32(go[c]), a, b);
    dg[c] = from_f32<T>(a);
    du[c] = from_f32<T>(b);
  }
}

template <typename T>
int launch_bwd(const void* gate, const void* up, const void* go, void* dg, void* du,
               int64_t n, cudaStream_t stream) {
  constexpr int V = VecWidth<T>::value;
  constexpr int kThreads = 256;
  constexpr int64_t kMaxBlocks = 132 * 8 * 4;
  const bool vec = tpudl::aligned16(gate) && tpudl::aligned16(up) && tpudl::aligned16(go) &&
                   tpudl::aligned16(dg) && tpudl::aligned16(du);
  const int64_t work = vec ? (n + V - 1) / V : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const T* g = static_cast<const T*>(gate);
  const T* u = static_cast<const T*>(up);
  const T* o = static_cast<const T*>(go);
  T* a = static_cast<T*>(dg);
  T* b = static_cast<T*>(du);
  if (vec) {
    swiglu_bwd_kernel<T, true><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(g, u, o, a, b, n);
  } else {
    swiglu_bwd_kernel<T, false><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(g, u, o, a, b, n);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr float kInvSqrt2 = 0.70710678118654752440f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;

__device__ __forceinline__ float gelu_f32(float u) {
  return u * 0.5f * (1.0f + erff(u * kInvSqrt2));
}

// d/du gelu(u) = Phi(u) + u * phi(u).
__device__ __forceinline__ float gelu_grad_f32(float u) {
  const float phi = expf(-0.5f * u * u) * kInvSqrt2Pi;
  return 0.5f * (1.0f + erff(u * kInvSqrt2)) + u * phi;
}

// Thread (blockIdx.x * blockDim.x + threadIdx.x) owns column chunk c (W
// columns); block row blockIdx.y walks rows blockIdx.y, + gridDim.y, ...
template <typename T, int W>
__global__ void bias_gelu_fwd_kernel(const T* __restrict__ x, const float* __restrict__ b,
                                     T* __restrict__ y, int64_t n, int f) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= f / W) return;
  float bc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) bc[j] = __ldg(b + c * W + j);
  const int64_t chunks = f / W;
#pragma unroll 4
  for (int64_t row = blockIdx.y; row < n; row += gridDim.y) {
    float v[W];
    load_chunk<T, W>(x, row * chunks + c, v);
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = gelu_f32(v[j] + bc[j]);
    store_chunk<T, W>(y, row * chunks + c, v);
  }
}

// Same ownership; block row blockIdx.y takes rows [blockIdx.y *
// rows_per_block, + rows_per_block) and leaves its db partial in
// ws[blockIdx.y][:].
template <typename T, int W>
__global__ void bias_gelu_bwd_kernel(const T* __restrict__ x, const float* __restrict__ b,
                                     const T* __restrict__ g, T* __restrict__ dx,
                                     float* __restrict__ ws, int64_t n, int f,
                                     int rows_per_block) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= f / W) return;
  float bc[W], acc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    bc[j] = __ldg(b + c * W + j);
    acc[j] = 0.0f;
  }
  const int64_t chunks = f / W;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * rows_per_block;
  int64_t row1 = row0 + rows_per_block;
  if (row1 > n) row1 = n;
#pragma unroll 4
  for (int64_t row = row0; row < row1; ++row) {
    float v[W], gv[W];
    load_chunk<T, W>(x, row * chunks + c, v);
    load_chunk<T, W>(g, row * chunks + c, gv);
#pragma unroll
    for (int j = 0; j < W; ++j) {
      v[j] = gv[j] * gelu_grad_f32(v[j] + bc[j]);
      acc[j] += v[j];
    }
    store_chunk<T, W>(dx, row * chunks + c, v);
  }
  float* out = ws + static_cast<int64_t>(blockIdx.y) * f + c * W;
#pragma unroll
  for (int j = 0; j < W; ++j) out[j] = acc[j];
}

constexpr int kBgThreads = 128;

template <typename T>
bool bg_vec(const void* x, const void* y, const void* g, int f) {
  return tpudl::aligned16(x) && tpudl::aligned16(y) && (g == nullptr || tpudl::aligned16(g)) &&
         (f * sizeof(T)) % 16 == 0;
}

template <typename T>
int launch_bg_fwd(const void* x, const void* b, void* y, int64_t n, int f,
                  cudaStream_t stream) {
  constexpr int V = VecWidth<T>::value;
  const bool vec = bg_vec<T>(x, y, nullptr, f);
  const int chunks = vec ? f / V : f;
  const unsigned gx = static_cast<unsigned>((chunks + kBgThreads - 1) / kBgThreads);
  // Enough row runs for several waves of 132 SMs; each block walks the rest.
  int64_t gy = (132 * 16 + gx - 1) / gx;
  if (gy > n) gy = n;
  if (gy > 65535) gy = 65535;
  const dim3 grid(gx, static_cast<unsigned>(gy));
  const T* xp = static_cast<const T*>(x);
  const float* bp = static_cast<const float*>(b);
  T* yp = static_cast<T*>(y);
  if (vec) {
    bias_gelu_fwd_kernel<T, V><<<grid, kBgThreads, 0, stream>>>(xp, bp, yp, n, f);
  } else {
    bias_gelu_fwd_kernel<T, 1><<<grid, kBgThreads, 0, stream>>>(xp, bp, yp, n, f);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bg_bwd(const void* x, const void* b, const void* g, void* dx, void* db, void* ws,
                  int64_t n, int f, int rows_per_block, cudaStream_t stream) {
  constexpr int V = VecWidth<T>::value;
  const bool vec = bg_vec<T>(x, dx, g, f);
  const int chunks = vec ? f / V : f;
  const unsigned gx = static_cast<unsigned>((chunks + kBgThreads - 1) / kBgThreads);
  const int64_t nblocks = (n + rows_per_block - 1) / rows_per_block;
  if (nblocks > 65535) return cudaErrorInvalidValue;
  const dim3 grid(gx, static_cast<unsigned>(nblocks));
  const T* xp = static_cast<const T*>(x);
  const float* bp = static_cast<const float*>(b);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  float* wsp = static_cast<float*>(ws);
  if (vec) {
    bias_gelu_bwd_kernel<T, V><<<grid, kBgThreads, 0, stream>>>(xp, bp, gp, dxp, wsp, n, f,
                                                                rows_per_block);
  } else {
    bias_gelu_bwd_kernel<T, 1><<<grid, kBgThreads, 0, stream>>>(xp, bp, gp, dxp, wsp, n, f,
                                                                rows_per_block);
  }
  const int code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  return tpudl::launch_column_sum(wsp, static_cast<float*>(db), nblocks, f, 1, stream);
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

// gate, up, go, dg, du: n contiguous elements of tpudl::DType `dtype`.
extern "C" int tpudl_swiglu_bwd(const void* gate, const void* up, const void* go, void* dg,
                                void* du, int64_t n, int dtype, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tpudl::kFloat32:
      return launch_bwd<float>(gate, up, go, dg, du, n, st);
    case tpudl::kBFloat16:
      return launch_bwd<__nv_bfloat16>(gate, up, go, dg, du, n, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// x, y: [n, f] contiguous of tpudl::DType `dtype`; b: [f] f32.
extern "C" int tpudl_bias_gelu_fwd(const void* x, const void* b, void* y, int64_t n, int f,
                                   int dtype, void* stream) {
  if (n <= 0 || f <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tpudl::kFloat32:
      return launch_bg_fwd<float>(x, b, y, n, f, st);
    case tpudl::kBFloat16:
      return launch_bg_fwd<__nv_bfloat16>(x, b, y, n, f, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// x, g, dx: [n, f] contiguous of tpudl::DType `dtype`; b, db: [f] f32. ws:
// f32 workspace of ceil(n / rows_per_block) * f values (at most 65535 row
// runs).
extern "C" int tpudl_bias_gelu_bwd(const void* x, const void* b, const void* g, void* dx,
                                   void* db, void* ws, int64_t n, int f, int rows_per_block,
                                   int dtype, void* stream) {
  if (n <= 0 || f <= 0 || rows_per_block <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tpudl::kFloat32:
      return launch_bg_bwd<float>(x, b, g, dx, db, ws, n, f, rows_per_block, st);
    case tpudl::kBFloat16:
      return launch_bg_bwd<__nv_bfloat16>(x, b, g, dx, db, ws, n, f, rows_per_block, st);
    default:
      return cudaErrorInvalidValue;
  }
}
