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
// Backward (redesigned for Hopper: every block of the grid lives at once,
// each walks a contiguous stripe of rows and keeps its columns' dscale /
// dbias partials in registers):
// - The Pallas kernel carries dscale/dbias across its sequential grid in
//   VMEM scratch. Hopper's blocks run in no order, so each block writes one
//   f32 partial row per array to a workspace and a second, dependent
//   launch sums each column's partials in a fixed order (32 threads a
//   column, then their 32 sums in order). No float atomics, and the order
//   depends on n and H alone: the backward is bitwise repeatable.
// - Rows of at most 1024 values (BERT-base's 768, BERT-large's 1024, the
//   f32 embeddings' call): a warp a row, as the forward. A lane holds its
//   share of x, r, g and gs from the loads to the stores, both row sums are
//   xor shuffles with no barrier, and the next row's loads are issued
//   before this row's sums and stores. 2 x 132 blocks of 4 warps; each
//   warp walks a stripe of rows and the block adds its warps' partials in
//   shared memory in order, so the workspace is (blocks x H x arrays) f32
//   (2.2 MB at [8192, 1024]).
// - Wider rows (Llama's 4096): a block a row, 2 x 132 blocks each walking
//   a stripe, the next row's loads in flight during this row's sums and
//   stores, and one barrier a row (two alternating slots for the warps'
//   sums).
// - Frozen scales (the Llama LoRA path) write no partials and launch no
//   second pass.
// - Rows that cannot be read as aligned 16-byte vectors take a scalar
//   kernel: a block of up to 512 threads on a stripe, one element a thread
//   per step, block_sum2 for the row's sums.
// The launch plan (route, blocks, rows a warp or block, threads, vectors
// a thread) is computed in tpudl_torch/ops/norms.py bwd_plan alone, where
// the CPU tests check it covers every row once; the launcher only checks
// that the plan fits the kernels and refuses one that does not.
#include "common.cuh"

namespace {

using tpudl::VecWidth;
using tpudl::from_f32;
using tpudl::load_f32;
using tpudl::load_raw;
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

// The backward's operands, passed by value to every backward kernel. g,
// gs and dx are contiguous [n, h] rows.
template <typename T>
struct BwdArgs {
  const T* x;
  const T* r;          // null without a residual
  const float* scale;
  const T* g;
  const T* gs;         // null without the summed output's gradient
  const float* mean;   // LayerNorm only
  const float* rstd;
  T* dx;
  float* ws;           // [arrays][parts][h] f32 partials, or null (frozen scales)
  int64_t n;
  int h;
  int64_t x_stride;
  int64_t r_stride;
  int rows;            // rows a warp (rows route) or a block (wide and scalar routes)
  int parts;           // blocks in the grid: partial rows in each array of ws
};

// The launch plan's routes (tpudl_torch/ops/norms.py bwd_plan).
enum BwdRoute : int { kRouteScalar = 0, kRouteRows = 1, kRouteWide = 2 };

// The 16-byte vector i of the f32 values at `base` (shared memory) as V
// floats.
template <int V>
__device__ __forceinline__ void load_shared_f32(const float* base, int i, float (&out)[V]) {
  const float4* p = reinterpret_cast<const float4*>(base) + i * (V / 4);
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float4 f = p[q];
    out[4 * q] = f.x;
    out[4 * q + 1] = f.y;
    out[4 * q + 2] = f.z;
    out[4 * q + 3] = f.w;
  }
}

// One thread's share of a row held from its loads to its stores: the raw
// 16-byte vectors of x, r, g and gs it owns (thread vectors first, first +
// step, ...). `issue` loads the row's x, r, g and statistics; `issue_gs`
// its gs, which is read only at the stores (so the next row's gs loads go
// out after this row's stores).
template <typename T, int KIND, int VPL>
struct BwdRow {
  uint4 x[VPL], r[VPL], g[VPL], gs[VPL], gs_next[VPL];
  float mean = 0.0f, rstd = 0.0f;

  __device__ __forceinline__ void issue(const BwdArgs<T>& a, int64_t row, int first, int step,
                                        int nvec) {
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = first + k * step;
      if (i < nvec) {
        x[k] = tpudl::load_raw(a.x + row * a.x_stride, i);
        if (a.r != nullptr) r[k] = tpudl::load_raw(a.r + row * a.r_stride, i);
        g[k] = tpudl::load_raw(a.g + row * static_cast<int64_t>(a.h), i);
      }
    }
    if (KIND == kLayer) mean = __ldg(a.mean + row);
    rstd = __ldg(a.rstd + row);
  }
  __device__ __forceinline__ void issue_gs(const BwdArgs<T>& a, int64_t row, int first, int step,
                                           int nvec) {
    if (a.gs == nullptr) return;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = first + k * step;
      if (i < nvec) gs[k] = tpudl::load_raw(a.gs + row * static_cast<int64_t>(a.h), i);
    }
  }
  // The early form: the next row's gs, issued with its other loads, held
  // apart until this row's stores are done (`advance` moves it in).
  __device__ __forceinline__ void issue_gs_next(const BwdArgs<T>& a, int64_t row, int first,
                                                int step, int nvec) {
    if (a.gs == nullptr) return;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = first + k * step;
      if (i < nvec) gs_next[k] = tpudl::load_raw(a.gs + row * static_cast<int64_t>(a.h), i);
    }
  }
  __device__ __forceinline__ void advance() {
#pragma unroll
    for (int k = 0; k < VPL; ++k) gs[k] = gs_next[k];
  }
};

// The scale of vector i (the thread's k-th): from shared memory, or from
// the registers the thread holds it in.
template <typename T, int VPL, bool kScaleShared>
__device__ __forceinline__ void scale_vec(const float* sc_shared,
                                          const float (&sc_regs)[VPL][VecWidth<T>::value], int k,
                                          int i, float (&out)[VecWidth<T>::value]) {
  constexpr int V = VecWidth<T>::value;
  if constexpr (kScaleShared) {
    load_shared_f32<V>(sc_shared, i, out);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = sc_regs[k][j];
  }
}

// The row's first pass: x-hat and g in f32 from the raw vectors, and this
// thread's shares of sum(dxhat) (a1) and sum(dxhat * xhat) (a2).
template <typename T, int KIND, int VPL, bool kScaleShared>
__device__ __forceinline__ void bwd_first_pass(const BwdRow<T, KIND, VPL>& in, bool has_res,
                                               float mean, float rstd, int first, int step,
                                               int nvec, const float* sc_shared,
                                               const float (&sc_regs)[VPL][VecWidth<T>::value],
                                               float (&xh)[VPL][VecWidth<T>::value],
                                               float (&gv)[VPL][VecWidth<T>::value], float& a1,
                                               float& a2) {
  constexpr int V = VecWidth<T>::value;
  a1 = 0.0f;
  a2 = 0.0f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = first + k * step;
    if (i < nvec) {
      unpack_vec<T>(in.x[k], xh[k]);
      if (has_res) {
        float w[V];
        unpack_vec<T>(in.r[k], w);
#pragma unroll
        for (int j = 0; j < V; ++j) xh[k][j] += w[j];
      }
      unpack_vec<T>(in.g[k], gv[k]);
      float sc[V];
      scale_vec<T, VPL, kScaleShared>(sc_shared, sc_regs, k, i, sc);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        xh[k][j] = KIND == kLayer ? (xh[k][j] - mean) * rstd : xh[k][j] * rstd;
        const float d = gv[k][j] * sc[j];
        a1 += d;
        a2 += d * xh[k][j];
      }
    }
  }
}

// The row's second pass: dx (+ gs) stored, and this thread's column
// partials of dscale and dbias (when params) updated.
template <typename T, int KIND, int VPL, bool kScaleShared>
__device__ __forceinline__ void bwd_second_pass(const BwdRow<T, KIND, VPL>& in, bool has_gs,
                                                bool params, float rstd, int first, int step,
                                                int nvec, const float* sc_shared,
                                                const float (&sc_regs)[VPL][VecWidth<T>::value],
                                                T* dxr, float m1, float m2,
                                                const float (&xh)[VPL][VecWidth<T>::value],
                                                const float (&gv)[VPL][VecWidth<T>::value],
                                                float (&acc_s)[VPL][VecWidth<T>::value],
                                                float (&acc_b)[VPL][VecWidth<T>::value]) {
  constexpr int V = VecWidth<T>::value;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = first + k * step;
    if (i < nvec) {
      float out[V];
      if (has_gs) {
        unpack_vec<T>(in.gs[k], out);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) out[j] = 0.0f;
      }
      float sc[V];
      scale_vec<T, VPL, kScaleShared>(sc_shared, sc_regs, k, i, sc);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = gv[k][j] * sc[j];
        const float ds = KIND == kLayer ? rstd * (d - m1 - xh[k][j] * m2)
                                        : rstd * (d - xh[k][j] * m2);
        out[j] += ds;
        if (params) {
          acc_s[k][j] += gv[k][j] * xh[k][j];
          acc_b[k][j] += gv[k][j];
        }
      }
      store_vec(dxr, i, out);
    }
  }
}

// Rows of at most 1024 values and 192 vectors (BERT's 768 and 1024 in
// bf16, 768 in f32): a warp a row. Warp w
// of block b walks rows [(4 b + w) * rows, + rows) in order; lane l owns
// the row's vectors l, l + 32, ... (VPL of them), holds them in registers
// from the loads to the stores and keeps its columns' dscale / dbias
// partials in registers across the stripe. Both row sums are xor
// shuffles (no barrier), and the next row's x, r, g and statistics are
// issued before this row's sums and stores. The scale sits in shared
// memory. At the end the block adds its 4 warps' partials in order 0..3
// and writes one partial row per array to ws[arr][b].
constexpr int kBwdRowWarps = 4;
constexpr int kBwdRowsMaxH = 1024;

template <typename T, int KIND, int VPL>
__global__ void __launch_bounds__(kBwdRowWarps * 32, 2) norm_bwd_rows_kernel(BwdArgs<T> a) {
  constexpr int V = VecWidth<T>::value;
  constexpr int kArrays = KIND == kLayer ? 2 : 1;
  __shared__ __align__(16) float sc_s[kBwdRowsMaxH];
  __shared__ __align__(16) float part[kBwdRowWarps][kArrays][kBwdRowsMaxH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = a.h / V;
  const float hf = static_cast<float>(a.h);
  const bool params = a.ws != nullptr, has_res = a.r != nullptr, has_gs = a.gs != nullptr;
  const int64_t row0 =
      (static_cast<int64_t>(blockIdx.x) * kBwdRowWarps + warp) * static_cast<int64_t>(a.rows);
  const int64_t row1 = row0 + a.rows < a.n ? row0 + a.rows : a.n;
  tpudl::pdl_wait();
  for (int c = threadIdx.x; c < a.h; c += blockDim.x) sc_s[c] = __ldg(a.scale + c);
  __syncthreads();
  float none[VPL][V];  // the scale is read from shared memory

  float acc_s[VPL][V], acc_b[VPL][V];
#pragma unroll
  for (int k = 0; k < VPL; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) acc_s[k][j] = acc_b[k][j] = 0.0f;

  BwdRow<T, KIND, VPL> in;
  if (row0 < row1) {
    in.issue(a, row0, lane, 32, nvec);
    in.issue_gs(a, row0, lane, 32, nvec);
  }
  for (int64_t row = row0; row < row1; ++row) {
    const float rstd = in.rstd;
    float xh[VPL][V], gv[VPL][V], a1, a2;
    bwd_first_pass<T, KIND, VPL, true>(in, has_res, in.mean, rstd, lane, 32, nvec, sc_s, none,
                                       xh, gv, a1, a2);
    if (row + 1 < row1) in.issue(a, row + 1, lane, 32, nvec);
    if (KIND == kLayer) a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    bwd_second_pass<T, KIND, VPL, true>(in, has_gs, params, rstd, lane, 32, nvec, sc_s, none,
                                        a.dx + row * static_cast<int64_t>(a.h), a1 / hf,
                                        a2 / hf, xh, gv, acc_s, acc_b);
    if (row + 1 < row1) in.issue_gs(a, row + 1, lane, 32, nvec);
  }
  tpudl::pdl_launch_dependents();
  if (!params) return;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = lane + 32 * k;
    if (i < nvec) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        part[warp][0][i * V + j] = acc_s[k][j];
        if (KIND == kLayer) part[warp][kArrays - 1][i * V + j] = acc_b[k][j];
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < a.h; c += blockDim.x) {
#pragma unroll
    for (int arr = 0; arr < kArrays; ++arr) {
      float s = part[0][arr][c];
#pragma unroll
      for (int w = 1; w < kBwdRowWarps; ++w) s += part[w][arr][c];
      a.ws[(static_cast<int64_t>(arr) * a.parts + blockIdx.x) * a.h + c] = s;
    }
  }
}

// Wider rows (Llama's 4096, up to 2048 16-byte vectors): a block a row, of
// up to 256 threads with the fewest vectors a thread (1, 2, 4 or 8): two
// at H 4096 in bf16. Block b walks rows [b * rows, + rows) in order; thread t
// owns the row's vectors t, t + blockDim.x, ... (VPL of them), with its
// scale and its
// columns' dscale / dbias partials in registers across the stripe. The
// next row's x, r, g and statistics are in flight while this row is
// summed and stored, so two rows are in flight. The row sums take one
// barrier a row: each warp leaves its (a1, a2) in one of two shared slots
// (alternating by row, so a warp that runs ahead never overwrites a slot
// another warp still reads), and every warp adds the slots in the same
// order, so every thread holds the same bits. The next row's gs goes out
// with its other loads (the rows kernel, short of registers, issues it
// after this row's stores). At the end each thread
// writes its columns of the block's partial row.
constexpr int kBwdWideThreads = 256;

template <typename T, int KIND, int VPL>
__global__ void __launch_bounds__(kBwdWideThreads, 2) norm_bwd_wide_kernel(BwdArgs<T> a) {
  constexpr int V = VecWidth<T>::value;
  __shared__ float2 sums[2][kBwdWideThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = static_cast<int>(blockDim.x >> 5);
  const int nvec = a.h / V;
  const float hf = static_cast<float>(a.h);
  const bool params = a.ws != nullptr, has_res = a.r != nullptr, has_gs = a.gs != nullptr;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * a.rows;
  const int64_t row1 = row0 + a.rows < a.n ? row0 + a.rows : a.n;
  const int step = static_cast<int>(blockDim.x);
  tpudl::pdl_wait();

  float sc[VPL][V], acc_s[VPL][V], acc_b[VPL][V];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = threadIdx.x + k * step;
    if (i < nvec) load_f32<V>(a.scale, i, sc[k]);
#pragma unroll
    for (int j = 0; j < V; ++j) acc_s[k][j] = acc_b[k][j] = 0.0f;
  }

  BwdRow<T, KIND, VPL> in;
  if (row0 < row1) {
    in.issue(a, row0, threadIdx.x, step, nvec);
    in.issue_gs(a, row0, threadIdx.x, step, nvec);
  }
  int slot = 0;
  for (int64_t row = row0; row < row1; ++row, slot ^= 1) {
    const float rstd = in.rstd;
    float xh[VPL][V], gv[VPL][V], a1, a2;
    bwd_first_pass<T, KIND, VPL, false>(in, has_res, in.mean, rstd, threadIdx.x, step, nvec,
                                        nullptr, sc, xh, gv, a1, a2);
    if (row + 1 < row1) {
      in.issue(a, row + 1, threadIdx.x, step, nvec);
      in.issue_gs_next(a, row + 1, threadIdx.x, step, nvec);
    }
    if (KIND == kLayer) a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    if (lane == 0) sums[slot][warp] = make_float2(a1, a2);
    __syncthreads();
    const float2 p = lane < nwarps ? sums[slot][lane] : make_float2(0.0f, 0.0f);
    if (KIND == kLayer) a1 = warp_sum(p.x);
    a2 = warp_sum(p.y);
    bwd_second_pass<T, KIND, VPL, false>(in, has_gs, params, rstd, threadIdx.x, step, nvec,
                                         nullptr, sc, a.dx + row * static_cast<int64_t>(a.h),
                                         a1 / hf, a2 / hf, xh, gv, acc_s, acc_b);
    if (has_gs) in.advance();
  }
  tpudl::pdl_launch_dependents();
  if (!params) return;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = threadIdx.x + k * step;
    if (i < nvec) {
      float* ws_s = a.ws + static_cast<int64_t>(blockIdx.x) * a.h;
#pragma unroll
      for (int q = 0; q < V / 4; ++q) {
        reinterpret_cast<float4*>(ws_s)[i * (V / 4) + q] =
            make_float4(acc_s[k][4 * q], acc_s[k][4 * q + 1], acc_s[k][4 * q + 2],
                        acc_s[k][4 * q + 3]);
        if (KIND == kLayer) {
          float* ws_b = ws_s + static_cast<int64_t>(a.parts) * a.h;
          reinterpret_cast<float4*>(ws_b)[i * (V / 4) + q] =
              make_float4(acc_b[k][4 * q], acc_b[k][4 * q + 1], acc_b[k][4 * q + 2],
                          acc_b[k][4 * q + 3]);
        }
      }
    }
  }
}

// Rows that cannot be read as aligned 16-byte vectors: block b takes rows
// [b * rows_per_block, (b + 1) * rows_per_block) in order, thread t owns
// columns t, t + blockDim.x, ... (K of them), and the row's sums take
// block_sum2. The block's dscale (and dbias) partials go to ws[0][b][:]
// (and ws[1][b][:]); a null ws skips them.
constexpr int kBwdScalarThreads = 512;

template <typename T, int KIND, int K>
__global__ void __launch_bounds__(kBwdScalarThreads) norm_bwd_scalar_kernel(BwdArgs<T> a) {
  const int h = a.h;
  const float hf = static_cast<float>(h);
  float sc[K], acc_s[K], acc_b[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    sc[k] = c < h ? __ldg(a.scale + c) : 0.0f;
    acc_s[k] = 0.0f;
    acc_b[k] = 0.0f;
  }
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * a.rows;
  const int64_t row1 = row0 + a.rows < a.n ? row0 + a.rows : a.n;
  for (int64_t row = row0; row < row1; ++row) {
    const T* xr = a.x + row * a.x_stride;
    const T* rr = a.r != nullptr ? a.r + row * a.r_stride : nullptr;
    const T* gr = a.g + row * static_cast<int64_t>(h);
    const float m = KIND == kLayer ? __ldg(a.mean + row) : 0.0f;
    const float rs = __ldg(a.rstd + row);
    float xh[K], gv[K];
    float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c < h) {
        xh[k] = to_f32(xr[c]);
        gv[k] = to_f32(gr[c]);
        if (rr != nullptr) xh[k] += to_f32(rr[c]);
        xh[k] = KIND == kLayer ? (xh[k] - m) * rs : xh[k] * rs;
        const float d = gv[k] * sc[k];
        a1 += d;
        a2 += d * xh[k];
      }
    }
    const float2 t = block_sum2(a1, a2);
    const float m1 = t.x / hf;
    const float m2 = t.y / hf;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c < h) {
        float out = a.gs != nullptr ? to_f32(a.gs[row * static_cast<int64_t>(h) + c]) : 0.0f;
        const float d = gv[k] * sc[k];
        out += KIND == kLayer ? rs * (d - m1 - xh[k] * m2) : rs * (d - xh[k] * m2);
        acc_s[k] += gv[k] * xh[k];
        acc_b[k] += gv[k];
        a.dx[row * static_cast<int64_t>(h) + c] = from_f32<T>(out);
      }
    }
  }
  if (a.ws == nullptr) return;
  float* ws_s = a.ws + static_cast<int64_t>(blockIdx.x) * h;
  float* ws_b = a.ws + (static_cast<int64_t>(a.parts) + blockIdx.x) * h;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < h) {
      ws_s[c] = acc_s[k];
      if (KIND == kLayer) ws_b[c] = acc_b[k];
    }
  }
}

// The second pass: out[arr][c] = the sum over p of ws[arr][p][c], in a
// fixed order whatever the timing: thread (x, y) of a 32 x 32 block sums
// partial rows y, y + 32, ... of column blockIdx.x * 32 + x, then row
// y = 0 adds the 32 sums in order. blockIdx.y is the array. A dependent
// launch: the grid starts while the first pass finishes and reads nothing
// before it has.
__global__ void __launch_bounds__(1024)
    norm_colsum_kernel(const float* __restrict__ ws, float* __restrict__ out, int parts, int h) {
  __shared__ float sums[32][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const float* src = ws + static_cast<int64_t>(blockIdx.y) * parts * h;
  tpudl::pdl_wait();
  float acc = 0.0f;
  if (c < h) {
#pragma unroll 4
    for (int p = threadIdx.y; p < parts; p += 32) acc += src[static_cast<int64_t>(p) * h + c];
  }
  sums[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < h) {
    float s = 0.0f;
#pragma unroll
    for (int y = 0; y < 32; ++y) s += sums[y][threadIdx.x];
    out[static_cast<int64_t>(blockIdx.y) * h + c] = s;
  }
}

// Launch the plan's route with `threads` threads a block and `vpl`
// vectors (values, on the scalar route) a thread or lane. A plan that does
// not cover the rows or the row, or that the kernels do not take, returns
// cudaErrorInvalidValue.
template <typename T, int KIND>
int launch_bwd_route(const BwdArgs<T>& a, int route, int threads, int vpl,
                     cudaStream_t stream) {
  constexpr int V = VecWidth<T>::value;
  const int per_block = route == kRouteRows ? kBwdRowWarps : 1;
  // The plan covers every row, and the last block has rows.
  if (static_cast<int64_t>(a.parts) * per_block * a.rows < a.n ||
      (static_cast<int64_t>(a.parts) - 1) * per_block * a.rows >= a.n) {
    return cudaErrorInvalidValue;
  }
  if (threads < 32 || threads % 32 != 0) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(a.parts));
  if (route == kRouteScalar) {
    if (threads > kBwdScalarThreads || threads * vpl < a.h) return cudaErrorInvalidValue;
    switch (vpl) {
      case 1: norm_bwd_scalar_kernel<T, KIND, 1><<<grid, threads, 0, stream>>>(a); break;
      case 2: norm_bwd_scalar_kernel<T, KIND, 2><<<grid, threads, 0, stream>>>(a); break;
      case 4: norm_bwd_scalar_kernel<T, KIND, 4><<<grid, threads, 0, stream>>>(a); break;
      case 8: norm_bwd_scalar_kernel<T, KIND, 8><<<grid, threads, 0, stream>>>(a); break;
      default: return cudaErrorInvalidValue;
    }
    return static_cast<int>(cudaGetLastError());
  }
  // 16-byte vectors need every row start 16-byte aligned.
  bool vec = tpudl::aligned16(a.x) && tpudl::aligned16(a.g) && tpudl::aligned16(a.dx) &&
             tpudl::aligned16(a.scale) && (a.x_stride * sizeof(T)) % 16 == 0 &&
             (a.h * sizeof(T)) % 16 == 0;
  if (a.r != nullptr) vec = vec && tpudl::aligned16(a.r) && (a.r_stride * sizeof(T)) % 16 == 0;
  if (a.gs != nullptr) vec = vec && tpudl::aligned16(a.gs);
  if (a.ws != nullptr) vec = vec && tpudl::aligned16(a.ws);
  if (!vec) return cudaErrorInvalidValue;
  const int nvec = a.h / V;
  if (route == kRouteRows) {
    if (threads != kBwdRowWarps * 32 || a.h > kBwdRowsMaxH || 32 * vpl < nvec) {
      return cudaErrorInvalidValue;
    }
#define TPUDL_BWD_ROWS(VPL) \
  return tpudl::launch_pdl(norm_bwd_rows_kernel<T, KIND, VPL>, grid, dim3(threads), stream, a)
    switch (vpl) {
      case 1: TPUDL_BWD_ROWS(1);
      case 2: TPUDL_BWD_ROWS(2);
      case 3: TPUDL_BWD_ROWS(3);
      case 4: TPUDL_BWD_ROWS(4);
      case 6:
        if constexpr (V == 4) TPUDL_BWD_ROWS(6);  // f32 rows of up to 768
        return cudaErrorInvalidValue;
      default:
        return cudaErrorInvalidValue;
    }
#undef TPUDL_BWD_ROWS
  }
  if (route != kRouteWide || threads > kBwdWideThreads || threads * vpl < nvec) {
    return cudaErrorInvalidValue;
  }
#define TPUDL_BWD_WIDE(VPL) \
  return tpudl::launch_pdl(norm_bwd_wide_kernel<T, KIND, VPL>, grid, dim3(threads), stream, a)
  switch (vpl) {
    case 1: TPUDL_BWD_WIDE(1);
    case 2: TPUDL_BWD_WIDE(2);
    case 4: TPUDL_BWD_WIDE(4);
    case 8: TPUDL_BWD_WIDE(8);
    default: return cudaErrorInvalidValue;
  }
#undef TPUDL_BWD_WIDE
}

template <typename T, int KIND>
int launch_bwd(const BwdArgs<T>& a, int route, int threads, int vpl, float* dparams,
               cudaStream_t stream) {
  const int code = launch_bwd_route<T, KIND>(a, route, threads, vpl, stream);
  if (code != 0 || dparams == nullptr) return code;
  const dim3 grid(static_cast<unsigned>((a.h + 31) / 32), KIND == kLayer ? 2u : 1u);
  return tpudl::launch_pdl(norm_colsum_kernel, grid, dim3(32, 32), stream,
                           static_cast<const float*>(a.ws), dparams, a.parts, a.h);
}

template <typename T>
int launch_bwd_kind(int kind, const void* x, const void* r, const void* scale, const void* g,
                    const void* gs, const void* mean, const void* rstd, void* dx, void* dscale,
                    void* ws, int64_t n, int h, int64_t x_stride, int64_t r_stride, int route,
                    int parts, int rows, int threads, int vpl, cudaStream_t stream) {
  const BwdArgs<T> a{static_cast<const T*>(x),     static_cast<const T*>(r),
                     static_cast<const float*>(scale), static_cast<const T*>(g),
                     static_cast<const T*>(gs),    static_cast<const float*>(mean),
                     static_cast<const float*>(rstd), static_cast<T*>(dx),
                     static_cast<float*>(ws),      n,
                     h,                            x_stride,
                     r_stride,                     rows,
                     parts};
  float* dp = static_cast<float*>(dscale);
  return kind == kLayer ? launch_bwd<T, kLayer>(a, route, threads, vpl, dp, stream)
                        : launch_bwd<T, kRms>(a, route, threads, vpl, dp, stream);
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
// The launch plan (tpudl_torch/ops/norms.py bwd_plan): route (BwdRoute),
// parts blocks, rows a warp (rows route) or a block, threads a block, vpl
// 16-byte vectors (values, on the scalar route) a lane or thread; ws: f32
// workspace of (LayerNorm ? 2 : 1) * parts * h values. dscale and ws both
// null compute dx alone (frozen scales). dtype: tpudl::DType of x, r, g,
// gs, dx. The rows route takes blocks of 4 warps and h <= 1024 with 1-4
// (or, f32, 6) vectors a lane, the wide route at most 256 threads of 1,
// 2, 4 or 8 vectors, both whole aligned vectors; the scalar route at most
// 512 threads of 1, 2, 4 or 8 values. A plan that does not cover the rows,
// or that the operands or kernels do not take, returns
// cudaErrorInvalidValue.
extern "C" int tpudl_norm_bwd(int kind, const void* x, const void* r, const void* scale,
                              const void* g, const void* gs, const void* mean,
                              const void* rstd, void* dx, void* dscale, void* ws, int64_t n,
                              int h, int64_t x_stride, int64_t r_stride, int route, int parts,
                              int rows, int threads, int vpl, int dtype, void* stream) {
  if (n <= 0 || h <= 0 || parts <= 0 || rows <= 0) return cudaErrorInvalidValue;
  if (kind == kLayer && mean == nullptr) return cudaErrorInvalidValue;
  if (kind != kRms && kind != kLayer) return cudaErrorInvalidValue;
  if ((dscale == nullptr) != (ws == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tpudl::kFloat32:
      return launch_bwd_kind<float>(kind, x, r, scale, g, gs, mean, rstd, dx, dscale, ws, n, h,
                                    x_stride, r_stride, route, parts, rows, threads, vpl, st);
    case tpudl::kBFloat16:
      return launch_bwd_kind<__nv_bfloat16>(kind, x, r, scale, g, gs, mean, rstd, dx, dscale,
                                            ws, n, h, x_stride, r_stride, route, parts, rows,
                                            threads, vpl, st);
    default:
      return cudaErrorInvalidValue;
  }
}
