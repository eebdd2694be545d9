// RMSNorm forward with an optional fused residual add, for Hopper (sm_90a).
//
// Replaces tpudl/ops/norms.py::_norm_fwd_kernel (kind="rms"), launched
// by tpudl/ops/norms.py::_norm_fwd via pl.pallas_call.
//
// Computes, per row of x [N, H] (and r [N, H] when given):
//   s = x + r                        (f32; written back in x's dtype when
//                                     the caller wants the sum)
//   y = (s * rsqrt(sum(s*s)/H + eps)) * scale   (f32 statistics, y in x's dtype)
//
// What bounds it on the H100: memory traffic. It reads each input byte
// once and writes each output byte once, about one multiply-add per
// byte, far below the ~20 f32 operations per byte where compute would
// start to matter. At decode (N = number of slots, 4 rows of 4096) the
// whole call moves ~100 KB, so launch latency bounds it instead.
//
// What the design does about that: one block per row, each thread
// loading 16-byte vectors (8 bf16 or 4 f32 values) so neighbouring
// threads touch neighbouring addresses; the block is sized so most
// threads load exactly one vector, which keeps a short row's latency to
// one load, one block reduction and one store. The sum of squares is
// reduced in f32 through warp shuffles and one shared-memory exchange.
// The second pass (normalize and scale) re-reads the row it has just
// read, which is still in L1, instead of holding it in registers, so any
// H works with one code path. Rows that cannot be read as aligned
// 16-byte vectors (H not a multiple of 8 bf16 or 4 f32 values, a row
// stride or pointer off a 16-byte boundary) take the scalar loop instead.
#include "common.cuh"

namespace {

using tpudl::VecWidth;
using tpudl::from_f32;
using tpudl::load_vec;
using tpudl::store_vec;
using tpudl::to_f32;

// Sum of `v` over the block; every thread gets the result. blockDim.x is
// a multiple of 32 and at most 1024.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    v = lane < nwarps ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) warp_sums[0] = v;
  }
  __syncthreads();
  return warp_sums[0];
}

template <typename T, bool HAS_RES, bool EMIT_SUM, bool VEC>
__global__ void rms_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                                    const float* __restrict__ scale, T* __restrict__ y,
                                    T* __restrict__ s, int h, int64_t x_stride,
                                    int64_t r_stride, float eps) {
  constexpr int V = VecWidth<T>::value;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * x_stride;
  const T* rr = HAS_RES ? r + row * r_stride : nullptr;
  T* yr = y + row * static_cast<int64_t>(h);
  T* sr = EMIT_SUM ? s + row * static_cast<int64_t>(h) : nullptr;
  const int nvec = VEC ? h / V : 0;
  const int tail0 = nvec * V;

  // Pass 1: residual add in f32, optional sum write, sum of squares.
  float sumsq = 0.0f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[V];
    load_vec(xr, i, v);
    if (HAS_RES) {
      float w[V];
      load_vec(rr, i, w);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] += w[j];
    }
    if (EMIT_SUM) store_vec(sr, i, v);
#pragma unroll
    for (int j = 0; j < V; ++j) sumsq += v[j] * v[j];
  }
  for (int c = tail0 + threadIdx.x; c < h; c += blockDim.x) {
    float v = to_f32(xr[c]);
    if (HAS_RES) v += to_f32(rr[c]);
    if (EMIT_SUM) sr[c] = from_f32<T>(v);
    sumsq += v * v;
  }
  const float rstd = rsqrtf(block_sum(sumsq) / static_cast<float>(h) + eps);

  // Pass 2: normalize and scale (the row is re-read from L1).
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[V];
    load_vec(xr, i, v);
    if (HAS_RES) {
      float w[V];
      load_vec(rr, i, w);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] += w[j];
    }
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = (v[j] * rstd) * __ldg(scale + i * V + j);
    store_vec(yr, i, v);
  }
  for (int c = tail0 + threadIdx.x; c < h; c += blockDim.x) {
    float v = to_f32(xr[c]);
    if (HAS_RES) v += to_f32(rr[c]);
    yr[c] = from_f32<T>((v * rstd) * __ldg(scale + c));
  }
}

template <typename T>
int launch(const void* x, const void* r, const void* scale, void* y, void* s, int64_t n,
           int h, int64_t x_stride, int64_t r_stride, float eps, cudaStream_t stream) {
  constexpr int V = VecWidth<T>::value;
  const bool has_res = r != nullptr;
  const bool emit_sum = s != nullptr;
  // 16-byte vectors need every row start 16-byte aligned.
  bool vec = tpudl::aligned16(x) && tpudl::aligned16(y) &&
             (x_stride * sizeof(T)) % 16 == 0 && (h * sizeof(T)) % 16 == 0;
  if (has_res) vec = vec && tpudl::aligned16(r) && (r_stride * sizeof(T)) % 16 == 0;
  if (emit_sum) vec = vec && tpudl::aligned16(s);
  const int work = vec ? (h + V - 1) / V : h;
  int threads = ((work + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const dim3 grid(static_cast<unsigned>(n));
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(r);
  const float* sc = static_cast<const float*>(scale);
  T* yp = static_cast<T*>(y);
  T* sp = static_cast<T*>(s);
#define TPUDL_RMS_LAUNCH(RES, SUM, VEC)                                        \
  rms_norm_fwd_kernel<T, RES, SUM, VEC><<<grid, threads, 0, stream>>>(        \
      xp, rp, sc, yp, sp, h, x_stride, r_stride, eps)
  if (vec) {
    if (!has_res) TPUDL_RMS_LAUNCH(false, false, true);
    else if (emit_sum) TPUDL_RMS_LAUNCH(true, true, true);
    else TPUDL_RMS_LAUNCH(true, false, true);
  } else {
    if (!has_res) TPUDL_RMS_LAUNCH(false, false, false);
    else if (emit_sum) TPUDL_RMS_LAUNCH(true, true, false);
    else TPUDL_RMS_LAUNCH(true, false, false);
  }
#undef TPUDL_RMS_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, r: [n, h] rows with last-dimension stride 1 and row strides x_stride,
// r_stride (elements); r may be null. scale: [h] f32. y: [n, h]
// contiguous. s: [n, h] contiguous, or null to skip the sum write (it must
// be null when r is). dtype: tpudl::DType of x, r, y, s.
extern "C" int tpudl_rms_norm_fwd(const void* x, const void* r, const void* scale, void* y,
                                  void* s, int64_t n, int h, int64_t x_stride,
                                  int64_t r_stride, float eps, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || (s != nullptr && r == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tpudl::kFloat32:
      return launch<float>(x, r, scale, y, s, n, h, x_stride, r_stride, eps, st);
    case tpudl::kBFloat16:
      return launch<__nv_bfloat16>(x, r, scale, y, s, n, h, x_stride, r_stride, eps, st);
    default:
      return cudaErrorInvalidValue;
  }
}
