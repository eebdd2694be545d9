// LayerNorm and RMSNorm, forward (with an optional fused residual add)
// and backward, for Hopper (sm_90a).
//
// Replaces, in tpudl/ops/norms.py:
//   _norm_fwd_kernel (both kinds), launched by _norm_fwd via pl.pallas_call;
//   _norm_bwd_kernel (both kinds), launched by _norm_bwd via pl.pallas_call.
//
// Forward, per row of x [N, H] (and r [N, H] when given), in f32:
//   s = x + r                     (written back in x's dtype when the caller
//                                  wants the sum)
//   LayerNorm: mean = sum(s)/H, var = max(sum(s*s)/H - mean^2, 0),
//              rstd = rsqrt(var + eps), y = ((s - mean) * rstd) * scale + bias
//   RMSNorm:   rstd = rsqrt(sum(s*s)/H + eps), y = (s * rstd) * scale
// and, when the caller passes somewhere to put them (autograd will need
// them), the row statistics mean [N] and rstd [N] in f32.
//
// Backward, per row, from the saved statistics (x-hat is recomputed from
// the raw inputs, never stored), in f32:
//   xhat = (s - mean) * rstd  (LayerNorm)  or  s * rstd  (RMSNorm)
//   dxhat = g * scale, m1 = sum(dxhat)/H, m2 = sum(dxhat * xhat)/H
//   dx = rstd * (dxhat - m1 - xhat * m2)   (LayerNorm; RMSNorm drops m1)
//        (+ gs, the gradient of the summed output, when given)
// and over all rows dscale = sum(g * xhat), dbias = sum(g) (LayerNorm).
//
// What bounds them on the H100: memory traffic. Each reads its inputs once
// and writes its outputs once at a few f32 operations per byte, far below
// the ~20 f32 operations per byte where the arithmetic would matter. At
// BERT-base's [32768, 768] bf16 the residual forward moves ~151 MB (~45 us
// at 3.35 TB/s) and the residual backward ~201 MB (~60 us); at Llama
// decode (4 rows of 4096) the forward moves ~100 KB and launch latency
// bounds it instead.
//
// What the design does about that:
// - Forward: one block per row, each thread loading 16-byte vectors (8 bf16
//   or 4 f32 values) so neighbouring threads touch neighbouring addresses;
//   the block is sized so most threads load exactly one vector. The row's
//   sums are reduced in f32 through warp shuffles and one shared-memory
//   exchange; the second pass re-reads the row, still in L1, instead of
//   holding it in registers, so any H works with one code path. RMSNorm
//   without statistics (inference) has a kernel of its own with no
//   statistics or bias code, so the decode step keeps its first kernel.
// - Backward: the Pallas kernel carries dscale/dbias across its sequential
//   grid in VMEM scratch. Hopper's blocks run in no order, so each block
//   walks a contiguous run of rows, keeps its column partials of dscale and
//   dbias in registers (each thread owns K chunks of columns), and writes
//   one f32 partial row to a workspace; a second kernel sums the partials
//   of each column in a fixed order. No float atomics, so the backward is
//   bitwise repeatable. The grid is one wave (8 blocks per SM), so the
//   partials add ~3% to the bytes at BERT-base's shape.
// - Rows that cannot be read as aligned 16-byte vectors (H not a multiple
//   of 8 bf16 or 4 f32 values, a row stride or pointer off a 16-byte
//   boundary) take the scalar path of the same kernels (chunks of one).
#include "common.cuh"

namespace {

using tpudl::VecWidth;
using tpudl::from_f32;
using tpudl::load_chunk;
using tpudl::load_vec;
using tpudl::store_chunk;
using tpudl::store_vec;
using tpudl::to_f32;

enum Kind : int { kRms = 0, kLayer = 1 };

// Sum of `v` over the block; every thread gets the result. blockDim.x is
// a multiple of 32 and at most 1024. One call per kernel (the result slot
// is reused without a trailing barrier).
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

// Two sums over the block at once; every thread gets both. Ends with a
// barrier, so it may be called again in a loop.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 warp_sums[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    float2 v = lane < nwarps ? warp_sums[lane] : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    }
    if (lane == 0) warp_sums[0] = v;
  }
  __syncthreads();
  const float2 out = warp_sums[0];
  __syncthreads();
  return out;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// RMSNorm without statistics: the inference path (65 calls per Llama decode
// step). Kept apart from norm_fwd_kernel so the decode step's kernel carries
// no bias, mean or statistics code; its timing is the serving slice's.
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

// The block shape of both forward kernels: one row per block, sized so
// most threads load exactly one 16-byte vector (or one element on the
// scalar path). Returns whether the vector path applies.
template <typename T>
bool fwd_shape(const void* x, const void* r, const void* y, const void* s, int h,
               int64_t x_stride, int64_t r_stride, int* threads) {
  constexpr int V = VecWidth<T>::value;
  // 16-byte vectors need every row start 16-byte aligned.
  bool vec = tpudl::aligned16(x) && tpudl::aligned16(y) &&
             (x_stride * sizeof(T)) % 16 == 0 && (h * sizeof(T)) % 16 == 0;
  if (r != nullptr) vec = vec && tpudl::aligned16(r) && (r_stride * sizeof(T)) % 16 == 0;
  if (s != nullptr) vec = vec && tpudl::aligned16(s);
  const int work = vec ? (h + V - 1) / V : h;
  int t = ((work + 31) / 32) * 32;
  *threads = t < 32 ? 32 : (t > 1024 ? 1024 : t);
  return vec;
}

template <typename T>
int launch_rms(const void* x, const void* r, const void* scale, void* y, void* s, int64_t n,
               int h, int64_t x_stride, int64_t r_stride, float eps, cudaStream_t stream) {
  int threads;
  const bool vec = fwd_shape<T>(x, r, y, s, h, x_stride, r_stride, &threads);
  const bool has_res = r != nullptr;
  const bool emit_sum = s != nullptr;
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

// Both kinds, writing the row statistics when asked: the training path.
template <typename T, int KIND, bool HAS_RES, bool EMIT_SUM, bool VEC>
__global__ void norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias, T* __restrict__ y,
                                T* __restrict__ s, float* __restrict__ mean_out,
                                float* __restrict__ rstd_out, int h, int64_t x_stride,
                                int64_t r_stride, float eps) {
  constexpr int V = VecWidth<T>::value;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * x_stride;
  const T* rr = HAS_RES ? r + row * r_stride : nullptr;
  T* yr = y + row * static_cast<int64_t>(h);
  T* sr = EMIT_SUM ? s + row * static_cast<int64_t>(h) : nullptr;
  const int nvec = VEC ? h / V : 0;
  const int tail0 = nvec * V;

  // Pass 1: residual add in f32, optional sum write, row sums.
  float sum = 0.0f, sumsq = 0.0f;
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
    for (int j = 0; j < V; ++j) {
      sum += v[j];
      sumsq += v[j] * v[j];
    }
  }
  for (int c = tail0 + threadIdx.x; c < h; c += blockDim.x) {
    float v = to_f32(xr[c]);
    if (HAS_RES) v += to_f32(rr[c]);
    if (EMIT_SUM) sr[c] = from_f32<T>(v);
    sum += v;
    sumsq += v * v;
  }
  const float hf = static_cast<float>(h);
  float mean = 0.0f, rstd;
  if constexpr (KIND == kLayer) {
    const float2 t = block_sum2(sum, sumsq);
    mean = t.x / hf;
    rstd = rsqrtf(fmaxf(t.y / hf - mean * mean, 0.0f) + eps);
  } else {
    rstd = rsqrtf(block_sum(sumsq) / hf + eps);
  }
  if (threadIdx.x == 0) {
    if (KIND == kLayer && mean_out != nullptr) mean_out[row] = mean;
    if (rstd_out != nullptr) rstd_out[row] = rstd;
  }

  // Pass 2: normalize, scale (and shift); the row is re-read from L1.
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
    for (int j = 0; j < V; ++j) {
      const int c = i * V + j;
      if constexpr (KIND == kLayer) {
        v[j] = ((v[j] - mean) * rstd) * __ldg(scale + c) + __ldg(bias + c);
      } else {
        v[j] = (v[j] * rstd) * __ldg(scale + c);
      }
    }
    store_vec(yr, i, v);
  }
  for (int c = tail0 + threadIdx.x; c < h; c += blockDim.x) {
    float v = to_f32(xr[c]);
    if (HAS_RES) v += to_f32(rr[c]);
    if constexpr (KIND == kLayer) {
      v = ((v - mean) * rstd) * __ldg(scale + c) + __ldg(bias + c);
    } else {
      v = (v * rstd) * __ldg(scale + c);
    }
    yr[c] = from_f32<T>(v);
  }
}

template <typename T, int KIND>
int launch_fwd(const void* x, const void* r, const void* scale, const void* bias, void* y,
               void* s, void* mean, void* rstd, int64_t n, int h, int64_t x_stride,
               int64_t r_stride, float eps, cudaStream_t stream) {
  int threads;
  const bool vec = fwd_shape<T>(x, r, y, s, h, x_stride, r_stride, &threads);
  const bool has_res = r != nullptr;
  const bool emit_sum = s != nullptr;
  const dim3 grid(static_cast<unsigned>(n));
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(r);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  T* yp = static_cast<T*>(y);
  T* sp = static_cast<T*>(s);
  float* mp = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
#define TPUDL_NORM_LAUNCH(RES, SUM, VEC)                                       \
  norm_fwd_kernel<T, KIND, RES, SUM, VEC><<<grid, threads, 0, stream>>>(      \
      xp, rp, sc, bi, yp, sp, mp, rs, h, x_stride, r_stride, eps)
  if (vec) {
    if (!has_res) TPUDL_NORM_LAUNCH(false, false, true);
    else if (emit_sum) TPUDL_NORM_LAUNCH(true, true, true);
    else TPUDL_NORM_LAUNCH(true, false, true);
  } else {
    if (!has_res) TPUDL_NORM_LAUNCH(false, false, false);
    else if (emit_sum) TPUDL_NORM_LAUNCH(true, true, false);
    else TPUDL_NORM_LAUNCH(true, false, false);
  }
#undef TPUDL_NORM_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// Block b takes rows [b * rows_per_block, (b + 1) * rows_per_block) in
// order. Thread t owns column chunks t, t + blockDim.x, ... (K of them,
// W elements each); nchunks = H / W. The dscale (and dbias) partials of
// the block go to ws[0][b][:] (and ws[1][b][:]); a null ws skips them.
template <typename T, int KIND, int W, int K>
__global__ void __launch_bounds__(512) norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                                const float* __restrict__ scale, const T* __restrict__ g,
                                const T* __restrict__ gs, const float* __restrict__ mean,
                                const float* __restrict__ rstd, T* __restrict__ dx,
                                float* __restrict__ ws, int64_t n, int h, int64_t x_stride,
                                int64_t r_stride, int rows_per_block, int nblocks) {
  const int nchunks = h / W;
  const float hf = static_cast<float>(h);
  float sc[K][W];
  float acc_s[K][W];
  float acc_b[K][W];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      sc[k][j] = c < nchunks ? __ldg(scale + c * W + j) : 0.0f;
      acc_s[k][j] = 0.0f;
      acc_b[k][j] = 0.0f;
    }
  }
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  int64_t row1 = row0 + rows_per_block;
  if (row1 > n) row1 = n;
  for (int64_t row = row0; row < row1; ++row) {
    const T* xr = x + row * x_stride;
    const T* rr = r != nullptr ? r + row * r_stride : nullptr;
    const T* gr = g + row * static_cast<int64_t>(h);
    const float m = KIND == kLayer ? __ldg(mean + row) : 0.0f;
    const float rs = __ldg(rstd + row);
    float xh[K][W], gv[K][W];
    float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c < nchunks) {
        load_chunk<T, W>(xr, c, xh[k]);
        load_chunk<T, W>(gr, c, gv[k]);
        if (rr != nullptr) {
          float w[W];
          load_chunk<T, W>(rr, c, w);
#pragma unroll
          for (int j = 0; j < W; ++j) xh[k][j] += w[j];
        }
#pragma unroll
        for (int j = 0; j < W; ++j) {
          xh[k][j] = KIND == kLayer ? (xh[k][j] - m) * rs : xh[k][j] * rs;
          const float d = gv[k][j] * sc[k][j];
          a1 += d;
          a2 += d * xh[k][j];
        }
      }
    }
    const float2 t = block_sum2(a1, a2);
    const float m1 = t.x / hf;
    const float m2 = t.y / hf;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c < nchunks) {
        float out[W];
        if (gs != nullptr) {
          load_chunk<T, W>(gs + row * static_cast<int64_t>(h), c, out);
        } else {
#pragma unroll
          for (int j = 0; j < W; ++j) out[j] = 0.0f;
        }
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const float d = gv[k][j] * sc[k][j];
          const float ds = KIND == kLayer ? rs * (d - m1 - xh[k][j] * m2)
                                          : rs * (d - xh[k][j] * m2);
          out[j] += ds;
          acc_s[k][j] += gv[k][j] * xh[k][j];
          acc_b[k][j] += gv[k][j];
        }
        store_chunk<T, W>(dx + row * static_cast<int64_t>(h), c, out);
      }
    }
  }
  if (ws == nullptr) return;
  float* ws_s = ws + static_cast<int64_t>(blockIdx.x) * h;
  float* ws_b = ws + (static_cast<int64_t>(nblocks) + blockIdx.x) * h;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < nchunks) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        ws_s[c * W + j] = acc_s[k][j];
        if (KIND == kLayer) ws_b[c * W + j] = acc_b[k][j];
      }
    }
  }
}

// Largest chunk count a thread may own (register budget) and the thread cap.
constexpr int kBwdMaxThreads = 512;

template <typename T, int KIND, int W>
int launch_bwd_w(const T* x, const T* r, const float* scale, const T* g, const T* gs,
                 const float* mean, const float* rstd, T* dx, float* ws, int64_t n, int h,
                 int64_t x_stride, int64_t r_stride, int rows_per_block, int nblocks,
                 cudaStream_t stream) {
  const int nchunks = h / W;
  int k = 1;
  while (k < (W == 1 ? 8 : 4) && (nchunks + k - 1) / k > kBwdMaxThreads) k *= 2;
  int threads = (nchunks + k - 1) / k;
  if (threads > kBwdMaxThreads) return cudaErrorInvalidValue;  // H too wide
  threads = ((threads + 31) / 32) * 32;
  const dim3 grid(static_cast<unsigned>(nblocks));
#define TPUDL_BWD_LAUNCH(K)                                                     \
  norm_bwd_kernel<T, KIND, W, K><<<grid, threads, 0, stream>>>(                \
      x, r, scale, g, gs, mean, rstd, dx, ws, n, h, x_stride, r_stride,        \
      rows_per_block, nblocks)
  switch (k) {
    case 1: TPUDL_BWD_LAUNCH(1); break;
    case 2: TPUDL_BWD_LAUNCH(2); break;
    case 4: TPUDL_BWD_LAUNCH(4); break;
    default:
      if constexpr (W == 1) TPUDL_BWD_LAUNCH(8);
      break;
  }
#undef TPUDL_BWD_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KIND>
int launch_bwd(const void* x, const void* r, const void* scale, const void* g,
               const void* gs, const void* mean, const void* rstd, void* dx, void* dscale,
               void* ws, int64_t n, int h, int64_t x_stride, int64_t r_stride,
               int rows_per_block, cudaStream_t stream) {
  constexpr int V = VecWidth<T>::value;
  const int nblocks = static_cast<int>((n + rows_per_block - 1) / rows_per_block);
  bool vec = tpudl::aligned16(x) && tpudl::aligned16(g) && tpudl::aligned16(dx) &&
             (x_stride * sizeof(T)) % 16 == 0 && (h * sizeof(T)) % 16 == 0;
  if (r != nullptr) vec = vec && tpudl::aligned16(r) && (r_stride * sizeof(T)) % 16 == 0;
  if (gs != nullptr) vec = vec && tpudl::aligned16(gs);
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(r);
  const float* sc = static_cast<const float*>(scale);
  const T* gp = static_cast<const T*>(g);
  const T* gsp = static_cast<const T*>(gs);
  const float* mp = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  T* dxp = static_cast<T*>(dx);
  float* wsp = static_cast<float*>(ws);
  const int code =
      vec ? launch_bwd_w<T, KIND, V>(xp, rp, sc, gp, gsp, mp, rs, dxp, wsp, n, h, x_stride,
                                     r_stride, rows_per_block, nblocks, stream)
          : launch_bwd_w<T, KIND, 1>(xp, rp, sc, gp, gsp, mp, rs, dxp, wsp, n, h, x_stride,
                                     r_stride, rows_per_block, nblocks, stream);
  if (code != 0 || dscale == nullptr) return code;
  return tpudl::launch_column_sum(wsp, static_cast<float*>(dscale), nblocks, h,
                                  KIND == kLayer ? 2 : 1, stream);
}

}  // namespace

// Forward. kind: 0 RMSNorm, 1 LayerNorm. x, r: [n, h] rows with
// last-dimension stride 1 and row strides x_stride, r_stride (elements);
// r may be null. scale (and, for LayerNorm, bias): [h] f32. y: [n, h]
// contiguous. s: [n, h] contiguous, or null to skip the sum write (it must
// be null when r is). mean (LayerNorm only), rstd: [n] f32, or null to skip
// the statistics. dtype: tpudl::DType of x, r, y, s.
extern "C" int tpudl_norm_fwd(int kind, const void* x, const void* r, const void* scale,
                              const void* bias, void* y, void* s, void* mean, void* rstd,
                              int64_t n, int h, int64_t x_stride, int64_t r_stride, float eps,
                              int dtype, void* stream) {
  if (n <= 0 || h <= 0 || (s != nullptr && r == nullptr)) return cudaErrorInvalidValue;
  if (kind == kLayer && bias == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind != kRms && kind != kLayer) return cudaErrorInvalidValue;
  const bool rms_plain = kind == kRms && rstd == nullptr;
  switch (dtype) {
    case tpudl::kFloat32:
      if (rms_plain) return launch_rms<float>(x, r, scale, y, s, n, h, x_stride, r_stride, eps, st);
      return kind == kLayer
                 ? launch_fwd<float, kLayer>(x, r, scale, bias, y, s, mean, rstd, n, h,
                                             x_stride, r_stride, eps, st)
                 : launch_fwd<float, kRms>(x, r, scale, bias, y, s, mean, rstd, n, h,
                                           x_stride, r_stride, eps, st);
    case tpudl::kBFloat16:
      if (rms_plain) {
        return launch_rms<__nv_bfloat16>(x, r, scale, y, s, n, h, x_stride, r_stride, eps, st);
      }
      return kind == kLayer
                 ? launch_fwd<__nv_bfloat16, kLayer>(x, r, scale, bias, y, s, mean, rstd, n,
                                                     h, x_stride, r_stride, eps, st)
                 : launch_fwd<__nv_bfloat16, kRms>(x, r, scale, bias, y, s, mean, rstd, n, h,
                                                   x_stride, r_stride, eps, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Backward. kind as above. x, r (r may be null): the forward's inputs, row
// strides x_stride, r_stride. g: [n, h] contiguous gradient of y; gs:
// [n, h] contiguous gradient of the summed output, or null. mean
// (LayerNorm only; null for RMSNorm), rstd: [n] f32 from the forward.
// dx: [n, h] contiguous, the gradient of x (and of r). dscale: [h] f32,
// followed directly by dbias [h] f32 for LayerNorm (one [2, h] buffer).
// ws: f32 workspace of (LayerNorm ? 2 : 1) * ceil(n / rows_per_block) * h
// values. dscale and ws both null compute dx alone (frozen scales). dtype: tpudl::DType of x, r, g, gs, dx. h at most 512 * 4 16-byte
// vectors per row (16384 f32, 32768 bf16) on the vector path and 4096 on
// the scalar path; wider rows return cudaErrorInvalidValue.
extern "C" int tpudl_norm_bwd(int kind, const void* x, const void* r, const void* scale,
                              const void* g, const void* gs, const void* mean,
                              const void* rstd, void* dx, void* dscale, void* ws, int64_t n,
                              int h, int64_t x_stride, int64_t r_stride, int rows_per_block,
                              int dtype, void* stream) {
  if (n <= 0 || h <= 0 || rows_per_block <= 0) return cudaErrorInvalidValue;
  if (kind == kLayer && mean == nullptr) return cudaErrorInvalidValue;
  if (kind != kRms && kind != kLayer) return cudaErrorInvalidValue;
  if ((dscale == nullptr) != (ws == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tpudl::kFloat32:
      return kind == kLayer
                 ? launch_bwd<float, kLayer>(x, r, scale, g, gs, mean, rstd, dx, dscale, ws,
                                             n, h, x_stride, r_stride, rows_per_block, st)
                 : launch_bwd<float, kRms>(x, r, scale, g, gs, mean, rstd, dx, dscale, ws, n,
                                           h, x_stride, r_stride, rows_per_block, st);
    case tpudl::kBFloat16:
      return kind == kLayer
                 ? launch_bwd<__nv_bfloat16, kLayer>(x, r, scale, g, gs, mean, rstd, dx,
                                                     dscale, ws, n, h, x_stride, r_stride,
                                                     rows_per_block, st)
                 : launch_bwd<__nv_bfloat16, kRms>(x, r, scale, g, gs, mean, rstd, dx,
                                                   dscale, ws, n, h, x_stride, r_stride,
                                                   rows_per_block, st);
    default:
      return cudaErrorInvalidValue;
  }
}
