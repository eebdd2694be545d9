// Segmented LoRA for Hopper (sm_90a): the heterogeneous-adapter batched
// LoRA delta of one projection site, every slot through its own adapter's
// pages, in one launch.
//
// Replaces, in tpudl/ops/segmented_lora.py:
//   _seg_lora_kernel (site 16), launched by segmented_lora_fused via
//   pl.pallas_call.
//
// Computes, for x [B, S, IN] (S = 1 for the decode step's [B, IN]) in T
// (f32 or bf16), pools a [NP, IN] and b [NP, OUT] (f32, or int8 with f32
// a_scale, b_scale [NP]: a page's rows dequantize as q * scale), the table
// [B, R] of page ids and scale [B]:
//   coef[b, s, r] = sum_i x[b, s, i] * A(table[b, r])[i]      (f32)
//   delta[b, s, o] = round_T(scale[b] * sum_r coef[b, s, r] *
//                            B(table[b, r])[o])              (f32, r in order)
// and, given a base output y [B, S, OUT] in T, y + delta rounded to T (the
// caller's ``y + delta``, one pass fewer).
// Page 0 is all zeros by the pool contract, so ranks short of R and slots
// with no adapter map there and contribute nothing: their entries are
// skipped. One page is one rank unit: a row of A^T and the matching row of
// B.
//
// What bounds it on the H100: bytes. At the decode step (4 slots, r 16,
// f32 pages) a q_proj call reads 4 x 16 pages x (4096 + 4096) x 4 B = 2.1
// MB (0.63 us at 3.35 TB/s) for 1 MFLOP: launch-bound. Over the 224 sites
// of a Llama-3-8B decode step the pages are 671 MB (200 us; int8 pages
// 50 us).
//
// What the design does (a first version that is right, not yet fast): a
// block takes one slot's token rows (1 for the decode step's [B, IN]; 16
// of a prefill) and a tile of output columns (256 for one row, 1024 for
// 16). It loads the slot's table row, then forms coef for its rows: each
// warp takes two ranks and runs its lanes along IN (x read straight from
// memory for one row, four columns a lane at a time where IN allows; for
// 16 rows staged in shared memory as f32, 512 columns at a time), one f32
// accumulator per (row, rank), reduced across
// the warp by a fixed butterfly and added to the block's coef in chunk
// order (no atomics: every block forms the same coef, bit for bit). Then
// each thread takes output columns and sums the ranks' B rows against
// coef in rank order, applies scale and rounds once. The TPU kernel forms
// coef once per slot; here every column tile forms it again and re-reads
// the A pages from L2 (256 KB per slot per site at q_proj, r 16, f32).
#include "common.cuh"

namespace {

using tpudl::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;   // IN columns of x staged at a time (16 rows)
constexpr int kMaxRank = 64;  // table width the kernel takes

// Output columns per block: one per thread for a single row (the decode
// step: more blocks), four for 16 rows (fewer re-formings of coef).
template <int ROWS> struct Cols { static constexpr int value = ROWS == 1 ? 256 : 1024; };

__device__ __forceinline__ float page_value(const float* pool, const float*, int64_t i, int) {
  return pool[i];
}
__device__ __forceinline__ float page_value(const int8_t* pool, const float* scales, int64_t i,
                                            int page) {
  return static_cast<float>(pool[i]) * scales[page];
}

// Elements [i, i + 4) as f32, in one access (i a multiple of 4; the
// caller checks the alignment).
__device__ __forceinline__ void load4(const float* p, int64_t i, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p + i);
  v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int64_t i, float (&v)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p + i);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(e[j]);
}
__device__ __forceinline__ void load4(const int8_t* p, int64_t i, float (&v)[4]) {
  const char4 r = *reinterpret_cast<const char4*>(p + i);
  v[0] = r.x, v[1] = r.y, v[2] = r.z, v[3] = r.w;
}
__device__ __forceinline__ void page_values4(const float* pool, const float*, int64_t i, int,
                                             float (&v)[4]) {
  load4(pool, i, v);
}
__device__ __forceinline__ void page_values4(const int8_t* pool, const float* scales, int64_t i,
                                             int page, float (&v)[4]) {
  load4(pool, i, v);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] *= scales[page];
}

// A warp's two rank accumulators per row, reduced across its lanes by a
// fixed butterfly and added into the block's coef by lane 0.
template <int ROWS>
__device__ __forceinline__ void add_coef(float (&acc0)[ROWS], float (&acc1)[ROWS],
                                         float (*sCoef)[kMaxRank], int r0, int r1, int lane) {
#pragma unroll
  for (int s = 0; s < ROWS; ++s) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      acc0[s] += __shfl_xor_sync(0xffffffffu, acc0[s], m);
      acc1[s] += __shfl_xor_sync(0xffffffffu, acc1[s], m);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < ROWS; ++s) {
      sCoef[s][r0] += acc0[s];
      if (r1 >= 0) sCoef[s][r1] += acc1[s];
    }
  }
}

// ROWS token rows of one slot per block: 1 (the decode step) or 16.
template <typename T, typename P, int ROWS>
__global__ void __launch_bounds__(kThreads)
    seg_lora_kernel(const T* __restrict__ x, const P* __restrict__ pa, const P* __restrict__ pb,
                    const float* __restrict__ a_scale, const float* __restrict__ b_scale,
                    const int* __restrict__ table, const float* __restrict__ scale,
                    const T* __restrict__ base, T* __restrict__ out, int S, int IN, int OUT,
                    int R, int vec) {
  constexpr int kCols = Cols<ROWS>::value;
  __shared__ float sX[ROWS > 1 ? ROWS : 1][ROWS > 1 ? kChunk : 1];
  __shared__ float sCoef[ROWS][kMaxRank];
  __shared__ int sPage[kMaxRank];
  const int b = blockIdx.z, s0 = blockIdx.y * ROWS, c0 = blockIdx.x * kCols;
  const int rows = min(ROWS, S - s0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < R; i += kThreads) sPage[i] = table[static_cast<int64_t>(b) * R + i];
  for (int i = threadIdx.x; i < ROWS * kMaxRank; i += kThreads) {
    sCoef[i / kMaxRank][i % kMaxRank] = 0.0f;
  }
  const T* xb = x + (static_cast<int64_t>(b) * S + s0) * IN;
  __syncthreads();

  if constexpr (ROWS == 1) {
    // coef of the one row: lanes along IN, x straight from memory.
    for (int r0 = 2 * warp; r0 < R; r0 += 2 * kWarps) {
      const int r1 = r0 + 1 < R ? r0 + 1 : -1;
      const int p0 = sPage[r0], p1 = r1 >= 0 ? sPage[r1] : 0;
      if (p0 == 0 && p1 == 0) continue;  // the all-zero page: nothing to add
      float acc0[1] = {0.0f}, acc1[1] = {0.0f};
      const int64_t o0 = static_cast<int64_t>(p0) * IN, o1 = static_cast<int64_t>(p1) * IN;
      if (vec) {
        for (int i = 4 * lane; i < IN; i += 128) {
          float xv[4], a0[4], a1[4];
          load4(xb, i, xv);
          page_values4(pa, a_scale, o0 + i, p0, a0);
          page_values4(pa, a_scale, o1 + i, p1, a1);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc0[0] = fmaf(xv[j], a0[j], acc0[0]);
            acc1[0] = fmaf(xv[j], a1[j], acc1[0]);
          }
        }
      } else {
        for (int i = lane; i < IN; i += 32) {
          const float xv = to_f32(xb[i]);
          acc0[0] = fmaf(xv, page_value(pa, a_scale, o0 + i, p0), acc0[0]);
          acc1[0] = fmaf(xv, page_value(pa, a_scale, o1 + i, p1), acc1[0]);
        }
      }
      add_coef<1>(acc0, acc1, sCoef, r0, r1, lane);
    }
  } else {
    // coef: IN in chunks of kChunk; each warp takes rank pairs.
    for (int i0 = 0; i0 < IN; i0 += kChunk) {
      __syncthreads();  // the previous chunk's readers are done
      const int n = min(kChunk, IN - i0);
      for (int e = threadIdx.x; e < ROWS * kChunk; e += kThreads) {
        const int s = e / kChunk, i = e % kChunk;
        sX[s][i] = s < rows && i < n ? to_f32(xb[static_cast<int64_t>(s) * IN + i0 + i]) : 0.0f;
      }
      __syncthreads();
      for (int r0 = 2 * warp; r0 < R; r0 += 2 * kWarps) {
        const int r1 = r0 + 1 < R ? r0 + 1 : -1;
        const int p0 = sPage[r0], p1 = r1 >= 0 ? sPage[r1] : 0;
        if (p0 == 0 && p1 == 0) continue;  // the all-zero page: nothing to add
        float acc0[ROWS], acc1[ROWS];
#pragma unroll
        for (int s = 0; s < ROWS; ++s) acc0[s] = acc1[s] = 0.0f;
        for (int i = lane; i < n; i += 32) {
          const float a0 = page_value(pa, a_scale, static_cast<int64_t>(p0) * IN + i0 + i, p0);
          const float a1 = page_value(pa, a_scale, static_cast<int64_t>(p1) * IN + i0 + i, p1);
#pragma unroll
          for (int s = 0; s < ROWS; ++s) {
            acc0[s] = fmaf(sX[s][i], a0, acc0[s]);
            acc1[s] = fmaf(sX[s][i], a1, acc1[s]);
          }
        }
        add_coef<ROWS>(acc0, acc1, sCoef, r0, r1, lane);
      }
    }
  }
  __syncthreads();

  // delta: each thread's columns, the ranks in order.
  const float sc = scale[b];
  const int c_end = min(c0 + kCols, OUT);
  for (int c = c0 + threadIdx.x; c < c_end; c += kThreads) {
    float acc[ROWS];
#pragma unroll
    for (int s = 0; s < ROWS; ++s) acc[s] = 0.0f;
    for (int r = 0; r < R; ++r) {
      const int page = sPage[r];
      if (page == 0) continue;
      const float bv = page_value(pb, b_scale, static_cast<int64_t>(page) * OUT + c, page);
#pragma unroll
      for (int s = 0; s < ROWS; ++s) acc[s] = fmaf(sCoef[s][r], bv, acc[s]);
    }
    for (int s = 0; s < rows; ++s) {
      const int64_t o = (static_cast<int64_t>(b) * S + s0 + s) * OUT + c;
      const T d = tpudl::from_f32<T>(acc[s] * sc);
      out[o] = base == nullptr ? d : tpudl::from_f32<T>(to_f32(base[o]) + to_f32(d));
    }
  }
}

template <typename T, typename P, int ROWS>
int launch_rows(const void* x, const void* a, const void* b, const void* a_scale,
                const void* b_scale, const void* table, const void* scale, const void* base,
                void* out, int B, int S, int IN, int OUT, int R, int vec, cudaStream_t stream) {
  constexpr int kCols = Cols<ROWS>::value;
  const dim3 grid(static_cast<unsigned>((OUT + kCols - 1) / kCols),
                  static_cast<unsigned>((S + ROWS - 1) / ROWS), static_cast<unsigned>(B));
  seg_lora_kernel<T, P, ROWS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const P*>(a), static_cast<const P*>(b),
      static_cast<const float*>(a_scale), static_cast<const float*>(b_scale),
      static_cast<const int*>(table), static_cast<const float*>(scale),
      static_cast<const T*>(base), static_cast<T*>(out), S, IN, OUT, R, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int launch(const void* x, const void* a, const void* b, const void* a_scale, const void* b_scale,
           const void* table, const void* scale, const void* base, void* out, int B, int S,
           int IN, int OUT, int R, int vec, cudaStream_t stream) {
  if (S == 1) {
    return launch_rows<T, P, 1>(x, a, b, a_scale, b_scale, table, scale, base, out, B, S, IN,
                                OUT, R, vec, stream);
  }
  return launch_rows<T, P, 16>(x, a, b, a_scale, b_scale, table, scale, base, out, B, S, IN, OUT,
                               R, vec, stream);
}

template <typename T>
int launch_t(int quantized, const void* x, const void* a, const void* b, const void* a_scale,
             const void* b_scale, const void* table, const void* scale, const void* base,
             void* out, int B, int S, int IN, int OUT, int R, int vec, cudaStream_t stream) {
  if (quantized) {
    return launch<T, int8_t>(x, a, b, a_scale, b_scale, table, scale, base, out, B, S, IN, OUT,
                             R, vec, stream);
  }
  return launch<T, float>(x, a, b, a_scale, b_scale, table, scale, base, out, B, S, IN, OUT, R,
                          vec, stream);
}

}  // namespace

// x: [B, S, IN] of tpudl::DType `dtype`; a: [NP, IN], b: [NP, OUT], f32 or
// (quantized != 0) int8 with a_scale, b_scale: [NP] f32; table: [B, R]
// int32 with every entry in [0, NP); scale: [B] f32; base: [B, S, OUT] of
// `dtype` or null; out: [B, S, OUT] of `dtype`. All contiguous; 1 <= R <=
// 64. vec != 0: IN is a multiple of 4 and x 16-byte aligned.
extern "C" int tpudl_seg_lora(const void* x, const void* a, const void* b, const void* a_scale,
                              const void* b_scale, const void* table, const void* scale,
                              const void* base, void* out, int B, int S, int IN, int OUT, int R,
                              int vec, int dtype, int quantized, void* stream) {
  if (B <= 0 || S <= 0 || IN <= 0 || OUT <= 0 || R <= 0 || R > kMaxRank || B > 65535 ||
      (S + 15) / 16 > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tpudl::kFloat32:
      return launch_t<float>(quantized, x, a, b, a_scale, b_scale, table, scale, base, out, B, S,
                             IN, OUT, R, vec, st);
    case tpudl::kBFloat16:
      return launch_t<__nv_bfloat16>(quantized, x, a, b, a_scale, b_scale, table, scale, base,
                                     out, B, S, IN, OUT, R, vec, st);
    default:
      return cudaErrorInvalidValue;
  }
}
