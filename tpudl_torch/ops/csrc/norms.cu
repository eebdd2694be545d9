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
// What bounds them on the H100: memory traffic at the training shapes,
// launch latency at decode. Each reads its inputs once and writes its
// outputs once at a few f32 operations per byte, far below the ~20 f32
// operations per byte where the arithmetic would matter. At BERT-base's
// [32768, 768] bf16 the residual forward moves ~151 MB (~45 us at 3.35
// TB/s), at the Llama-3-8B LoRA step's [8192, 4096] the residual+sum
// forward ~268 MB (~80 us); the residual backward at BERT-base ~201 MB
// (~60 us). At Llama decode (4 rows of 4096) the forward moves ~100 KB
// (0.03 us) and the launch and one load's latency are the whole time.
//
// What the forward's design does about that (every variant, both kinds):
// - Each thread holds its part of the row in registers from the load to
//   the store: one pass over device memory, no second read. The f32 scale
//   (and bias) arrive as 16-byte vectors issued with the row's loads.
// - Rows of at most 1024 values (BERT's 768): one warp per row, several
//   rows per warp, shuffle-only sums (no barrier), the scale and bias
//   loaded once per warp and held for all its rows, and the next row's
//   loads issued before this row's math.
// - Wider rows (Llama's 4096): one block per row of at most 256 threads,
//   each holding up to 4 vectors (8 for wider rows), one barrier for the
//   row's sums. At decode (4 rows) the row's bytes are few and a load's
//   latency, not the bandwidth of the 4 SMs, sets the time: splitting a
//   row over a thread block cluster of 2, 4 or 8 CTAs, with the partial
//   sums read back through distributed shared memory, was slower at every
//   size at [4, 4096] and [128, 4096] (kernel_ab against copies of this
//   file; PERF.md section 6), so there is no cluster path.
// - Every forward is a programmatic dependent launch (launch_pdl): it
//   touches no device memory, not even the scale (an optimizer step may
//   write it), before griddepcontrol.wait, and lets the next dependent
//   launch start once its loads are issued, so back-to-back launches
//   overlap their launch latency with this one's tail.
// - Rows that cannot be read as aligned 16-byte vectors (H not a multiple
//   of 8 bf16 or 4 f32 values, a row stride, scale, bias or pointer off a
//   16-byte boundary) take a scalar kernel of one block per row and two
//   passes over the row.
//
// Backward:
// - The Pallas kernel carries dscale/dbias across its sequential grid in
//   VMEM scratch. Hopper's blocks run in no order, so each block walks a
//   contiguous run of rows, keeps its column partials of dscale and dbias
//   in registers (each thread owns K chunks of columns), and writes one
//   f32 partial row to a workspace; a second kernel sums the partials of
//   each column in a fixed order. No float atomics, so the backward is
//   bitwise repeatable. The grid is one wave (8 blocks per SM), so the
//   partials add ~3% to the bytes at BERT-base's shape.
// - Rows that cannot be read as aligned 16-byte vectors take the scalar
//   path of the same kernel (chunks of one).
#include "common.cuh"

namespace {

using tpudl::VecWidth;
using tpudl::from_f32;
using tpudl::load_chunk;
using tpudl::load_f32;
using tpudl::load_raw;
using tpudl::store_chunk;
using tpudl::store_vec;
using tpudl::to_f32;
using tpudl::unpack_vec;

enum Kind : int { kRms = 0, kLayer = 1 };

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

// The forward's operands, passed by value to every forward kernel.
template <typename T>
struct FwdArgs {
  const T* x;
  const T* r;          // null without a residual
  const float* scale;
  const float* bias;   // LayerNorm only
  T* y;
  T* s;                // null unless the sum is written
  float* mean;         // LayerNorm statistics, or null
  float* rstd;         // or null
  int64_t n;
  int h;
  int64_t x_stride;
  int64_t r_stride;
  float eps;
};

// Sum of v over the warp by xor shuffles: every lane ends with the same
// bits (each step adds two values, and a + b == b + a).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The row's statistics from its sum and sum of squares: (mean, rstd).
template <int KIND>
__device__ __forceinline__ float2 row_stats(float sum, float sumsq, float hf, float eps) {
  if constexpr (KIND == kLayer) {
    const float mean = sum / hf;
    return make_float2(mean, rsqrtf(fmaxf(sumsq / hf - mean * mean, 0.0f) + eps));
  } else {
    return make_float2(0.0f, rsqrtf(sumsq / hf + eps));
  }
}

// One vector of the output from the f32 sum v, its scale and bias.
template <int KIND, int V>
__device__ __forceinline__ void normalize(float (&v)[V], const float (&sc)[V],
                                          const float (&bi)[V], float2 st) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if constexpr (KIND == kLayer) {
      v[j] = ((v[j] - st.x) * st.y) * sc[j] + bi[j];
    } else {
      v[j] = (v[j] * st.y) * sc[j];
    }
  }
}

// Rows of at most 32 * VPL vectors: warp w of block b takes rows
// [(b * kRowWarps + w) * rows_per_warp, + rows_per_warp); lane l owns the
// row's vectors l, l + 32, ... (VPL of them) and the matching scale and
// bias, loaded once. The next row's loads are issued before this row's
// math.
constexpr int kRowWarps = 4;

template <typename T, int KIND, bool HAS_RES, bool EMIT_SUM, int VPL>
__global__ void __launch_bounds__(kRowWarps * 32)
    norm_fwd_rows_kernel(FwdArgs<T> a, int rows_per_warp) {
  constexpr int V = VecWidth<T>::value;
  const int lane = threadIdx.x & 31;
  const int nvec = a.h / V;
  const float hf = static_cast<float>(a.h);
  const int64_t row0 =
      (static_cast<int64_t>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5)) * rows_per_warp;
  const int64_t row1 = row0 + rows_per_warp < a.n ? row0 + rows_per_warp : a.n;
  tpudl::pdl_wait();
  if (row0 >= a.n) return;

  uint4 xa[VPL], ra[VPL];
  auto issue = [&](int64_t row) {
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = lane + 32 * k;
      if (i < nvec) {
        xa[k] = load_raw(a.x + row * a.x_stride, i);
        if (HAS_RES) ra[k] = load_raw(a.r + row * a.r_stride, i);
      }
    }
  };
  issue(row0);
  float sc[VPL][V], bi[VPL][V];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = lane + 32 * k;
    if (i < nvec) {
      load_f32<V>(a.scale, i, sc[k]);
      if (KIND == kLayer) load_f32<V>(a.bias, i, bi[k]);
    }
  }
  tpudl::pdl_launch_dependents();

  for (int64_t row = row0; row < row1; ++row) {
    float v[VPL][V];
    float sum = 0.0f, sumsq = 0.0f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (lane + 32 * k < nvec) {
        unpack_vec<T>(xa[k], v[k]);
        if (HAS_RES) {
          float w[V];
          unpack_vec<T>(ra[k], w);
#pragma unroll
          for (int j = 0; j < V; ++j) v[k][j] += w[j];
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (KIND == kLayer) sum += v[k][j];
          sumsq += v[k][j] * v[k][j];
        }
      }
    }
    if (row + 1 < row1) issue(row + 1);
    if (KIND == kLayer) sum = warp_sum(sum);
    sumsq = warp_sum(sumsq);
    const float2 st = row_stats<KIND>(sum, sumsq, hf, a.eps);
    if (lane == 0) {
      if (KIND == kLayer && a.mean != nullptr) a.mean[row] = st.x;
      if (a.rstd != nullptr) a.rstd[row] = st.y;
    }
    T* yr = a.y + row * static_cast<int64_t>(a.h);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = lane + 32 * k;
      if (i < nvec) {
        if (EMIT_SUM) store_vec(a.s + row * static_cast<int64_t>(a.h), i, v[k]);
        normalize<KIND, V>(v[k], sc[k], bi[k], st);
        store_vec(yr, i, v[k]);
      }
    }
  }
}

// Wider rows: one block per row; thread t owns the row's vectors t,
// t + blockDim.x, ... (VPL of them). Each warp leaves its (sum, sumsq) in
// shared memory; after one barrier lane j of every warp loads warp j's
// and the warp adds them by xor shuffles, so every thread holds the same
// bits.
constexpr int kWideThreads = 512;

template <typename T, int KIND, bool HAS_RES, bool EMIT_SUM, int VPL>
__global__ void __launch_bounds__(kWideThreads) norm_fwd_wide_kernel(FwdArgs<T> a) {
  constexpr int V = VecWidth<T>::value;
  __shared__ float2 part[kWideThreads / 32];
  const int64_t row = blockIdx.x;
  const int nvec = a.h / V;
  const T* xr = a.x + row * a.x_stride;
  const T* rr = HAS_RES ? a.r + row * a.r_stride : nullptr;
  const int lane = threadIdx.x & 31;
  tpudl::pdl_wait();

  uint4 xa[VPL], ra[VPL];
  float sc[VPL][V], bi[VPL][V];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      xa[k] = load_raw(xr, i);
      if (HAS_RES) ra[k] = load_raw(rr, i);
    }
  }
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      load_f32<V>(a.scale, i, sc[k]);
      if (KIND == kLayer) load_f32<V>(a.bias, i, bi[k]);
    }
  }
  tpudl::pdl_launch_dependents();

  float v[VPL][V];
  float sum = 0.0f, sumsq = 0.0f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    if (threadIdx.x + k * blockDim.x < nvec) {
      unpack_vec<T>(xa[k], v[k]);
      if (HAS_RES) {
        float w[V];
        unpack_vec<T>(ra[k], w);
#pragma unroll
        for (int j = 0; j < V; ++j) v[k][j] += w[j];
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (KIND == kLayer) sum += v[k][j];
        sumsq += v[k][j] * v[k][j];
      }
    }
  }
  if (KIND == kLayer) sum = warp_sum(sum);
  sumsq = warp_sum(sumsq);
  if (lane == 0) part[threadIdx.x >> 5] = make_float2(sum, sumsq);
  __syncthreads();
  const float2 p = lane < static_cast<int>(blockDim.x >> 5) ? part[lane] : make_float2(0.0f, 0.0f);
  if (KIND == kLayer) sum = warp_sum(p.x);
  sumsq = warp_sum(p.y);
  const float2 st = row_stats<KIND>(sum, sumsq, static_cast<float>(a.h), a.eps);
  if (threadIdx.x == 0) {
    if (KIND == kLayer && a.mean != nullptr) a.mean[row] = st.x;
    if (a.rstd != nullptr) a.rstd[row] = st.y;
  }
  T* yr = a.y + row * static_cast<int64_t>(a.h);
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = threadIdx.x + k * blockDim.x;
    if (i < nvec) {
      if (EMIT_SUM) store_vec(a.s + row * static_cast<int64_t>(a.h), i, v[k]);
      normalize<KIND, V>(v[k], sc[k], bi[k], st);
      store_vec(yr, i, v[k]);
    }
  }
}

// Rows that are not whole aligned 16-byte vectors: one block per row, one
// element a thread per step, two passes (the second re-reads the row).
template <typename T, int KIND, bool HAS_RES, bool EMIT_SUM>
__global__ void __launch_bounds__(1024) norm_fwd_scalar_kernel(FwdArgs<T> a) {
  const int64_t row = blockIdx.x;
  const T* xr = a.x + row * a.x_stride;
  const T* rr = HAS_RES ? a.r + row * a.r_stride : nullptr;
  T* yr = a.y + row * static_cast<int64_t>(a.h);
  T* sr = EMIT_SUM ? a.s + row * static_cast<int64_t>(a.h) : nullptr;
  tpudl::pdl_wait();
  tpudl::pdl_launch_dependents();
  float sum = 0.0f, sumsq = 0.0f;
  for (int c = threadIdx.x; c < a.h; c += blockDim.x) {
    float v = to_f32(xr[c]);
    if (HAS_RES) v += to_f32(rr[c]);
    if (EMIT_SUM) sr[c] = from_f32<T>(v);
    sum += v;
    sumsq += v * v;
  }
  const float2 t = block_sum2(sum, sumsq);
  const float2 st = row_stats<KIND>(t.x, t.y, static_cast<float>(a.h), a.eps);
  if (threadIdx.x == 0) {
    if (KIND == kLayer && a.mean != nullptr) a.mean[row] = st.x;
    if (a.rstd != nullptr) a.rstd[row] = st.y;
  }
  for (int c = threadIdx.x; c < a.h; c += blockDim.x) {
    float v = to_f32(xr[c]);
    if (HAS_RES) v += to_f32(rr[c]);
    float out[1] = {v};
    const float sc[1] = {__ldg(a.scale + c)};
    const float bi[1] = {KIND == kLayer ? __ldg(a.bias + c) : 0.0f};
    normalize<KIND, 1>(out, sc, bi, st);
    yr[c] = from_f32<T>(out[0]);
  }
}

// Vectors per thread of the wide kernel for a row of `nvec` vectors: the
// fewest (1, 2, 4 or 8) that keep a block within 256 threads, else 8
// (kernel_ab at H 4096: 256 threads of 2 bf16 vectors beat 128 of 4 and
// 512 of 1 at decode, and 128 of 4 at the training shape's residual+sum).
int wide_vpl(int nvec) {
  for (int v = 1; v < 8; v *= 2) {
    if ((nvec + v - 1) / v <= 256) return v;
  }
  return 8;
}

// Rows per warp of the rows kernel: up to 4 (kernel_ab at [32768, 768]:
// 4 beat 8, 8 beat 16), fewer when the call has too few rows to give each
// of the 132 SMs a few blocks.
int rows_per_warp(int64_t n) {
  int64_t r = n / (132 * 4 * kRowWarps);
  return static_cast<int>(r < 1 ? 1 : (r > 4 ? 4 : r));
}

template <typename T, int KIND, bool HAS_RES, bool EMIT_SUM>
int launch_fwd_variant(const FwdArgs<T>& a, bool vec, cudaStream_t stream) {
  constexpr int V = VecWidth<T>::value;
  if (!vec) {
    int t = ((a.h + 31) / 32) * 32;
    t = t > 1024 ? 1024 : t;
    return tpudl::launch_pdl(norm_fwd_scalar_kernel<T, KIND, HAS_RES, EMIT_SUM>,
                             dim3(static_cast<unsigned>(a.n)), dim3(t), stream, a);
  }
  const int nvec = a.h / V;
  if (nvec <= 32 * (V == 8 ? 4 : 8)) {  // at most 1024 values a row
    const int vpl = (nvec + 31) / 32;
    const int rpw = rows_per_warp(a.n);
    const int64_t rows_per_block = static_cast<int64_t>(rpw) * kRowWarps;
    const dim3 grid(static_cast<unsigned>((a.n + rows_per_block - 1) / rows_per_block));
    const dim3 block(kRowWarps * 32);
#define TPUDL_ROWS(VPL)                                                                     \
  return tpudl::launch_pdl(norm_fwd_rows_kernel<T, KIND, HAS_RES, EMIT_SUM, VPL>, grid, block, \
                           stream, a, rpw)
    if constexpr (V == 8) {
      switch (vpl) {
        case 1: TPUDL_ROWS(1);
        case 2: TPUDL_ROWS(2);
        case 3: TPUDL_ROWS(3);
        default: TPUDL_ROWS(4);
      }
    } else {
      switch (vpl) {
        case 1: TPUDL_ROWS(1);
        case 2: TPUDL_ROWS(2);
        case 3: TPUDL_ROWS(3);
        case 4: TPUDL_ROWS(4);
        case 5:
        case 6: TPUDL_ROWS(6);
        default: TPUDL_ROWS(8);
      }
    }
#undef TPUDL_ROWS
  }
  const int vpl = wide_vpl(nvec);
  const int threads = (((nvec + vpl - 1) / vpl + 31) / 32) * 32;
  if (threads > kWideThreads) return cudaErrorInvalidValue;  // H too wide to hold in registers
  const dim3 grid(static_cast<unsigned>(a.n)), block(threads);
#define TPUDL_WIDE(VPL)                                                                     \
  return tpudl::launch_pdl(norm_fwd_wide_kernel<T, KIND, HAS_RES, EMIT_SUM, VPL>, grid, block, \
                           stream, a)
  switch (vpl) {
    case 1: TPUDL_WIDE(1);
    case 2: TPUDL_WIDE(2);
    case 4: TPUDL_WIDE(4);
    default: TPUDL_WIDE(8);
  }
#undef TPUDL_WIDE
}

template <typename T, int KIND>
int launch_fwd(const FwdArgs<T>& a, cudaStream_t stream) {
  // 16-byte vectors need every row start, the scale and the bias 16-byte
  // aligned.
  bool vec = tpudl::aligned16(a.x) && tpudl::aligned16(a.y) && tpudl::aligned16(a.scale) &&
             (a.x_stride * sizeof(T)) % 16 == 0 && (a.h * sizeof(T)) % 16 == 0;
  if (KIND == kLayer) vec = vec && tpudl::aligned16(a.bias);
  if (a.r != nullptr) vec = vec && tpudl::aligned16(a.r) && (a.r_stride * sizeof(T)) % 16 == 0;
  if (a.s != nullptr) vec = vec && tpudl::aligned16(a.s);
  if (a.r == nullptr) return launch_fwd_variant<T, KIND, false, false>(a, vec, stream);
  if (a.s != nullptr) return launch_fwd_variant<T, KIND, true, true>(a, vec, stream);
  return launch_fwd_variant<T, KIND, true, false>(a, vec, stream);
}

template <typename T>
int launch_fwd_kind(int kind, const void* x, const void* r, const void* scale, const void* bias,
                    void* y, void* s, void* mean, void* rstd, int64_t n, int h, int64_t x_stride,
                    int64_t r_stride, float eps, cudaStream_t stream) {
  const FwdArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(r),
                     static_cast<const float*>(scale), static_cast<const float*>(bias),
                     static_cast<T*>(y), static_cast<T*>(s),
                     kind == kLayer ? static_cast<float*>(mean) : nullptr,
                     static_cast<float*>(rstd), n, h, x_stride, r_stride, eps};
  return kind == kLayer ? launch_fwd<T, kLayer>(a, stream) : launch_fwd<T, kRms>(a, stream);
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

// An empty one-block kernel: the launch floor the short kernels are held
// against. Launched plain, or as the forwards launch (launch_pdl), it
// waits on the kernel before and lets the next one start.
__global__ void launch_floor_kernel() {
  tpudl::pdl_wait();
  tpudl::pdl_launch_dependents();
}

}  // namespace

// One launch of launch_floor_kernel (one block of 32 threads): plain
// (pdl 0) or as the forwards launch (pdl 1).
extern "C" int tpudl_launch_floor(int pdl, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!pdl) {
    launch_floor_kernel<<<1, 32, 0, st>>>();
    return static_cast<int>(cudaGetLastError());
  }
  return tpudl::launch_pdl(launch_floor_kernel, dim3(1), dim3(32), st);
}

// Forward. kind: 0 RMSNorm, 1 LayerNorm. x, r: [n, h] rows with
// last-dimension stride 1 and row strides x_stride, r_stride (elements);
// r may be null. scale (and, for LayerNorm, bias): [h] f32. y: [n, h]
// contiguous. s: [n, h] contiguous, or null to skip the sum write (it must
// be null when r is). mean (LayerNorm only), rstd: [n] f32, or null to skip
// the statistics. dtype: tpudl::DType of x, r, y, s. On the vector path h
// is at most 4096 16-byte vectors (16384 f32, 32768 bf16, as the
// backward); wider rows return cudaErrorInvalidValue. Launched as a programmatic dependent
// launch (see common.cuh launch_pdl).
extern "C" int tpudl_norm_fwd(int kind, const void* x, const void* r, const void* scale,
                              const void* bias, void* y, void* s, void* mean, void* rstd,
                              int64_t n, int h, int64_t x_stride, int64_t r_stride, float eps,
                              int dtype, void* stream) {
  if (n <= 0 || h <= 0 || (s != nullptr && r == nullptr)) return cudaErrorInvalidValue;
  if (kind != kRms && kind != kLayer) return cudaErrorInvalidValue;
  if (kind == kLayer && bias == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tpudl::kFloat32:
      return launch_fwd_kind<float>(kind, x, r, scale, bias, y, s, mean, rstd, n, h, x_stride,
                                    r_stride, eps, st);
    case tpudl::kBFloat16:
      return launch_fwd_kind<__nv_bfloat16>(kind, x, r, scale, bias, y, s, mean, rstd, n, h,
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
