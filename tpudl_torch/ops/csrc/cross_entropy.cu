// Softmax cross-entropy over integer labels for Hopper (sm_90a), streaming
// the vocabulary: forward and backward over [B, V] logits.
//
// Replaces, in tpudl/ops/cross_entropy.py:
//   _xent_fwd_kernel, launched by _xent_fwd_call via pl.pallas_call;
//   _xent_bwd_kernel, launched by _xent_bwd_call via pl.pallas_call.
//
// Computes, per row b, in f32 (s = label smoothing, t_b the label):
//   fwd: lse_b  = log sum_j exp(z_bj), by the online recurrence (a running
//                 max and a running sum rescaled when the max moves);
//        loss_b = lse_b - (1 - s) * z_b[t_b] - (s / V) * sum_j z_bj;
//        both written as f32 [B];
//   bwd: dz_bj = g_b * (exp(z_bj - lse_b) - q_bj), q the (1 - s) one-hot
//        plus s / V, written in the logits' dtype.
// The [B, V] probabilities never exist outside the registers: the forward
// keeps four numbers per row, the backward recomputes each exp. Columns
// >= V are never read, so the card needs no padding of V.
//
// What bounds them on the H100: memory traffic. The forward reads the
// logits once (about two f32 operations and one exp per element); the
// backward reads them and writes dz. At the vocab-sized head shape
// [4096, 30522] bf16 that is 250.0 MB forward and 500.1 MB backward: 74.6 us
// and 149.3 us at the 3.35 TB/s of an NVIDIA H100 80GB HBM3 at its 700 W
// limit (data sheet rate, not a measurement). On the BERT-base classifier
// ([256, 2] f32, one call each way per step) both are bound by launch
// latency.
//
// What the design does about that:
// - Forward: one block of 256 threads per row. Each thread walks the row's
//   16-byte vectors (8 bf16 or 4 f32 values) at a stride of the block,
//   keeping its own running max, sum, label logit and row sum; a scalar
//   head up to the first 16-byte boundary and a scalar tail take the rest,
//   since a row of V = 30522 bf16 starts at any 4-byte offset. The block
//   then merges the 256 partial (max, sum) pairs by warp shuffles and one
//   round through shared memory, in a fixed order.
// - Backward: a grid over (vector chunks of a row) x rows, each thread one
//   16-byte vector in and out; the row's statistics are three scalars.
// - Rows of at most kRowMaxV = 256 logits (BERT's [256, 2] classifier
//   loss) take the small-row path instead: a group of lanes a row, sized
//   to V (one lane at V <= 8, a warp from V = 129), at most 8 values a
//   lane held in registers: every load is issued before the first exp,
//   the max and the exp-sum are two passes over registers (no serial
//   online recurrence), and the group merges by shuffles alone; the
//   backward likewise, loads first. A block of 256 threads a row spent
//   most of its time on its shared-memory merge and idle lanes (V = 2:
//   two lanes of 256 hold data). Both small-row kernels are programmatic
//   dependent launches (common.cuh launch_pdl): they touch no device
//   memory before pdl_wait(). At ResNet-50's [128, 1000] one warp a row
//   (online, or 32 values a lane in registers) measured slower than the
//   block a row both ways, so wider rows keep it.
// - No atomics: all kernels are bitwise repeatable.
// exp and log are the accurate expf and logf.
#include <float.h>

#include "common.cuh"

namespace {

using tpudl::from_f32;
using tpudl::load_vec;
using tpudl::store_vec;
using tpudl::to_f32;
using tpudl::VecWidth;

// tpudl.ops.attention.MASK_VALUE, the forward's initial running max.
constexpr float kMaskValue = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));
constexpr int kThreads = 256;

// Elements before the first 16-byte boundary of `row` (at most n).
template <typename T>
__device__ __forceinline__ int64_t head_len(const T* row, int64_t n) {
  const int64_t mis = static_cast<int64_t>((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15);
  const int64_t h = mis / static_cast<int64_t>(sizeof(T));
  return h < n ? h : n;
}

struct Online {
  float m = kMaskValue;  // running max
  float l = 0.0f;        // sum of exp(z - m)
  float t = 0.0f;        // the label's logit
  float s = 0.0f;        // the row sum (label smoothing)

  __device__ __forceinline__ void add(float z, int64_t col, int64_t label, bool smooth) {
    if (z > m) {
      l = l * expf(m - z) + 1.0f;
      m = z;
    } else {
      l += expf(z - m);
    }
    if (col == label) t += z;
    if (smooth) s += z;
  }

  __device__ __forceinline__ void merge(float m2, float l2, float t2, float s2) {
    const float mn = fmaxf(m, m2);
    l = l * expf(m - mn) + l2 * expf(m2 - mn);
    m = mn;
    t += t2;
    s += s2;
  }

  __device__ __forceinline__ void warp_merge() {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      merge(__shfl_xor_sync(0xffffffffu, m, o), __shfl_xor_sync(0xffffffffu, l, o),
            __shfl_xor_sync(0xffffffffu, t, o), __shfl_xor_sync(0xffffffffu, s, o));
    }
  }
};

template <typename T, bool SMOOTH>
__global__ void __launch_bounds__(kThreads)
    xent_fwd_kernel(const T* __restrict__ z, const int64_t* __restrict__ labels,
                    float* __restrict__ loss, float* __restrict__ lse, int64_t rows, int64_t v,
                    float one_minus_s, float s_over_v) {
  constexpr int W = VecWidth<T>::value;
  __shared__ float part[4][kThreads / 32];
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* zr = z + row * v;
    const int64_t label = labels[row];
    Online o;
    const int64_t head = head_len(zr, v);
    const int64_t nvec = (v - head) / W;
    const int64_t tail0 = head + nvec * W;
    for (int64_t c = threadIdx.x; c < head; c += kThreads) o.add(to_f32(zr[c]), c, label, SMOOTH);
    const T* body = zr + head;
    for (int64_t i = threadIdx.x; i < nvec; i += kThreads) {
      float e[W];
      load_vec(body, i, e);
#pragma unroll
      for (int j = 0; j < W; ++j) o.add(e[j], head + i * W + j, label, SMOOTH);
    }
    for (int64_t c = tail0 + threadIdx.x; c < v; c += kThreads) {
      o.add(to_f32(zr[c]), c, label, SMOOTH);
    }
    o.warp_merge();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
      part[0][warp] = o.m;
      part[1][warp] = o.l;
      part[2][warp] = o.t;
      part[3][warp] = o.s;
    }
    __syncthreads();
    if (warp == 0) {
      Online f;
      if (lane < kThreads / 32) {
        f.m = part[0][lane];
        f.l = part[1][lane];
        f.t = part[2][lane];
        f.s = part[3][lane];
      }
      f.warp_merge();
      if (lane == 0) {
        const float lse_b = f.m + logf(f.l);
        float loss_b = lse_b - one_minus_s * f.t;
        if (SMOOTH) loss_b = loss_b - s_over_v * f.s;
        loss[row] = loss_b;
        lse[row] = lse_b;
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float xent_grad(float zv, int64_t col, int64_t label, float g,
                                           float lse, float one_minus_s, float s_over_v) {
  const float q = (col == label ? one_minus_s : 0.0f) + s_over_v;
  return g * (expf(zv - lse) - q);
}

// blockIdx.y walks the rows (stride gridDim.y); blockIdx.x * kThreads +
// threadIdx.x is the thread's 16-byte vector of the row's aligned body
// (VEC), or its element (scalar path, stride gridDim.x * kThreads).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
    xent_bwd_kernel(const T* __restrict__ z, const int64_t* __restrict__ labels,
                    const float* __restrict__ lse, const float* __restrict__ g,
                    T* __restrict__ dz, int64_t rows, int64_t v, float one_minus_s,
                    float s_over_v) {
  constexpr int W = VecWidth<T>::value;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const T* zr = z + row * v;
    T* dr = dz + row * v;
    const int64_t label = labels[row];
    const float gb = g[row], lb = lse[row];
    if (VEC) {
      const int64_t head = head_len(zr, v);
      const int64_t nvec = (v - head) / W;
      const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
      if (i < nvec) {
        float e[W];
        load_vec(zr + head, i, e);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          e[j] = xent_grad(e[j], head + i * W + j, label, gb, lb, one_minus_s, s_over_v);
        }
        store_vec(dr + head, i, e);
      }
      if (blockIdx.x == 0) {
        // The scalar head and tail (fewer than W elements each).
        const int64_t tail0 = head + nvec * W;
        const int64_t c = threadIdx.x < head ? threadIdx.x : tail0 + (threadIdx.x - head);
        if (threadIdx.x < head || (c >= tail0 && c < v)) {
          dr[c] = from_f32<T>(
              xent_grad(to_f32(zr[c]), c, label, gb, lb, one_minus_s, s_over_v));
        }
      }
    } else {
      const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
      for (int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; c < v;
           c += stride) {
        dr[c] = from_f32<T>(xent_grad(to_f32(zr[c]), c, label, gb, lb, one_minus_s, s_over_v));
      }
    }
  }
}

// The small-row path: rows of at most kRowMaxV logits. A group of LANES
// lanes (a power of two, at most a warp) holds a row in registers, NV
// values a lane (element i * LANES + lane of the group), so every load is
// issued before the first exp and the max, the exp-sum and the label's
// logit come from registers; the group's partials then merge by
// shuffles, log2(LANES) rounds. kRowThreads / LANES rows a block.
constexpr int64_t kRowMaxV = 256;
constexpr int kRowThreads = 256;

template <int LANES, int NV, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ zr, int64_t v, int sub, bool live,
                                         float (&x)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int64_t c = static_cast<int64_t>(i) * LANES + sub;
    x[i] = live && c < v ? to_f32(zr[c]) : kMaskValue;
  }
}

template <typename T, bool SMOOTH, int LANES, int NV>
__global__ void __launch_bounds__(kRowThreads)
    xent_fwd_rows_kernel(const T* __restrict__ z, const int64_t* __restrict__ labels,
                         float* __restrict__ loss, float* __restrict__ lse, int64_t rows,
                         int64_t v, float one_minus_s, float s_over_v) {
  const int sub = threadIdx.x % LANES;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kRowThreads / LANES) + threadIdx.x / LANES;
  const bool live = row < rows;
  tpudl::pdl_wait();
  // Every lane of a warp takes part in the shuffles below, rows past the
  // end included (they load nothing and write nothing).
  const T* zr = z + (live ? row : 0) * v;
  const int64_t label = live ? labels[row] : -1;
  float x[NV];
  load_row<LANES>(zr, v, sub, live, x);
  tpudl::pdl_launch_dependents();
  float m = kMaskValue;
#pragma unroll
  for (int i = 0; i < NV; ++i) m = fmaxf(m, x[i]);
  float l = 0.0f, t = 0.0f, sum = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int64_t c = static_cast<int64_t>(i) * LANES + sub;
    if (c < v) {
      l += expf(x[i] - m);
      if (c == label) t += x[i];
      if (SMOOTH) sum += x[i];
    }
  }
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    const float mn = fmaxf(m, m2);
    l = l * expf(m - mn) + l2 * expf(m2 - mn);
    m = mn;
    t += __shfl_xor_sync(0xffffffffu, t, o);
    if (SMOOTH) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  }
  if (live && sub == 0) {
    const float lse_b = m + logf(l);
    float loss_b = lse_b - one_minus_s * t;
    if (SMOOTH) loss_b = loss_b - s_over_v * sum;
    loss[row] = loss_b;
    lse[row] = lse_b;
  }
}

template <typename T, int LANES, int NV>
__global__ void __launch_bounds__(kRowThreads)
    xent_bwd_rows_kernel(const T* __restrict__ z, const int64_t* __restrict__ labels,
                         const float* __restrict__ lse, const float* __restrict__ g,
                         T* __restrict__ dz, int64_t rows, int64_t v, float one_minus_s,
                         float s_over_v) {
  const int sub = threadIdx.x % LANES;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kRowThreads / LANES) + threadIdx.x / LANES;
  tpudl::pdl_wait();
  if (row >= rows) return;
  float x[NV];
  load_row<LANES>(z + row * v, v, sub, true, x);
  const int64_t label = labels[row];
  const float gb = g[row], lb = lse[row];
  tpudl::pdl_launch_dependents();
  T* dr = dz + row * v;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int64_t c = static_cast<int64_t>(i) * LANES + sub;
    if (c < v) dr[c] = from_f32<T>(xent_grad(x[i], c, label, gb, lb, one_minus_s, s_over_v));
  }
}

template <typename T, int LANES, int NV>
int launch_fwd_rows(const T* z, const int64_t* labels, float* loss, float* lse, int64_t rows,
                    int64_t v, float one_minus_s, float s_over_v, int smooth, cudaStream_t st) {
  constexpr int64_t per_block = kRowThreads / LANES;
  const dim3 grid(static_cast<unsigned>((rows + per_block - 1) / per_block));
  const dim3 block(kRowThreads);
  return smooth ? tpudl::launch_pdl(xent_fwd_rows_kernel<T, true, LANES, NV>, grid, block, st,
                                    z, labels, loss, lse, rows, v, one_minus_s, s_over_v)
                : tpudl::launch_pdl(xent_fwd_rows_kernel<T, false, LANES, NV>, grid, block, st,
                                    z, labels, loss, lse, rows, v, one_minus_s, s_over_v);
}

template <typename T, int LANES, int NV>
int launch_bwd_rows(const T* z, const int64_t* labels, const float* lse, const float* g, T* dz,
                    int64_t rows, int64_t v, float one_minus_s, float s_over_v,
                    cudaStream_t st) {
  constexpr int64_t per_block = kRowThreads / LANES;
  const dim3 grid(static_cast<unsigned>((rows + per_block - 1) / per_block));
  return tpudl::launch_pdl(xent_bwd_rows_kernel<T, LANES, NV>, grid, dim3(kRowThreads), st, z,
                           labels, lse, g, dz, rows, v, one_minus_s, s_over_v);
}

// The lane group (LANES, NV) that holds a row of v <= kRowMaxV logits: the
// fewest lanes that hold it at 8 values a lane.
#define TPUDL_XENT_ROW_SHAPE(v, CALL) \
  ((v) <= 8     ? CALL(1, 8)        \
   : (v) <= 16  ? CALL(2, 8)        \
   : (v) <= 32  ? CALL(4, 8)        \
   : (v) <= 64  ? CALL(8, 8)        \
   : (v) <= 128 ? CALL(16, 8)       \
                : CALL(32, 8))

constexpr int64_t kMaxRowBlocks = 65535;

template <typename T>
int launch_fwd(const void* z, const void* labels, void* loss, void* lse, int64_t rows,
               int64_t v, float one_minus_s, float s_over_v, int smooth, cudaStream_t st) {
  const int64_t blocks = rows < 132 * 64 ? rows : 132 * 64;
  const T* zp = static_cast<const T*>(z);
  const int64_t* lp = static_cast<const int64_t*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  if (v <= kRowMaxV) {
#define TPUDL_XENT_FWD_ROWS(L, N) \
  launch_fwd_rows<T, L, N>(zp, lp, lo, ls, rows, v, one_minus_s, s_over_v, smooth, st)
    return TPUDL_XENT_ROW_SHAPE(v, TPUDL_XENT_FWD_ROWS);
#undef TPUDL_XENT_FWD_ROWS
  }
  if (smooth) {
    xent_fwd_kernel<T, true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        zp, lp, lo, ls, rows, v, one_minus_s, s_over_v);
  } else {
    xent_fwd_kernel<T, false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        zp, lp, lo, ls, rows, v, one_minus_s, s_over_v);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* z, const void* labels, const void* lse, const void* g, void* dz,
               int64_t rows, int64_t v, float one_minus_s, float s_over_v, cudaStream_t st) {
  constexpr int W = VecWidth<T>::value;
  if (v <= kRowMaxV) {
#define TPUDL_XENT_BWD_ROWS(L, N)                                                             \
  launch_bwd_rows<T, L, N>(static_cast<const T*>(z), static_cast<const int64_t*>(labels),     \
                           static_cast<const float*>(lse), static_cast<const float*>(g),      \
                           static_cast<T*>(dz), rows, v, one_minus_s, s_over_v, st)
    return TPUDL_XENT_ROW_SHAPE(v, TPUDL_XENT_BWD_ROWS);
#undef TPUDL_XENT_BWD_ROWS
  }
  // Both rows start at the same offset from a 16-byte boundary when both
  // bases are aligned (the same row stride), so one head serves both.
  const bool vec = tpudl::aligned16(z) && tpudl::aligned16(dz);
  const int64_t per_row = vec ? (v + W - 1) / W : v;
  int64_t gx = (per_row + kThreads - 1) / kThreads;
  if (gx < 1) gx = 1;
  if (!vec && gx > 132 * 8) gx = 132 * 8;
  const int64_t gy = rows < kMaxRowBlocks ? rows : kMaxRowBlocks;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const T* zp = static_cast<const T*>(z);
  const int64_t* lp = static_cast<const int64_t*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* gp = static_cast<const float*>(g);
  T* dp = static_cast<T*>(dz);
  if (vec) {
    xent_bwd_kernel<T, true><<<grid, kThreads, 0, st>>>(zp, lp, ls, gp, dp, rows, v,
                                                        one_minus_s, s_over_v);
  } else {
    xent_bwd_kernel<T, false><<<grid, kThreads, 0, st>>>(zp, lp, ls, gp, dp, rows, v,
                                                         one_minus_s, s_over_v);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// z: [rows, v] contiguous logits of tpudl::DType `dtype`; labels: [rows]
// int64; loss, lse: [rows] f32. one_minus_s = 1 - s and s_over_v = s / V,
// each rounded to f32; smooth = s > 0.
extern "C" int tpudl_xent_fwd(const void* z, const void* labels, void* loss, void* lse,
                              int64_t rows, int64_t v, float one_minus_s, float s_over_v,
                              int smooth, int dtype, void* stream) {
  if (rows <= 0 || v <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tpudl::kFloat32:
      return launch_fwd<float>(z, labels, loss, lse, rows, v, one_minus_s, s_over_v, smooth, st);
    case tpudl::kBFloat16:
      return launch_fwd<__nv_bfloat16>(z, labels, loss, lse, rows, v, one_minus_s, s_over_v,
                                       smooth, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// z, dz: [rows, v] contiguous of `dtype`; labels [rows] int64; lse, g: [rows]
// f32 (the forward's log-sum-exp and the loss's per-row gradient).
extern "C" int tpudl_xent_bwd(const void* z, const void* labels, const void* lse,
                              const void* g, void* dz, int64_t rows, int64_t v,
                              float one_minus_s, float s_over_v, int dtype, void* stream) {
  if (rows <= 0 || v <= 0) return cudaErrorInvalidValue;
  if ((v + 7) / 8 > static_cast<int64_t>(kThreads) * 0x7fffffff) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tpudl::kFloat32:
      return launch_bwd<float>(z, labels, lse, g, dz, rows, v, one_minus_s, s_over_v, st);
    case tpudl::kBFloat16:
      return launch_bwd<__nv_bfloat16>(z, labels, lse, g, dz, rows, v, one_minus_s, s_over_v,
                                       st);
    default:
      return cudaErrorInvalidValue;
  }
}
