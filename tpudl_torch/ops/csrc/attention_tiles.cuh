// Tile helpers shared by the attention kernels for Hopper (sm_90a):
// flash_attention.cu (flash forward, dQ, dK/dV) and fused_attention.cu
// (the whole-attention forward and two-launch backward).
//
// A block of 4 warps owns 64 rows of its own side; each warp keeps 16 of
// them in registers in mma.sync m16n8k16 fragment layout, and the other
// side streams through shared memory (cp.async). bf16 products run on the
// tensor cores with f32 accumulation, operands by ldmatrix; f32 products
// run in full f32 on the CUDA cores (never TF32) with the same fragment
// ownership. Params, the mask predicates and the dropout draw are the
// attention contract both kernel files implement: q [B, Sq, H, D], k, v
// [B, Skv, H, D], a [B, Skv] kv mask or none, causal bottom-right aligned
// (kv <= q + Skv - Sq), dropout bits of element ((b * H + h) * Sq + q) *
// Skv + kv of philox.cuh's contract.
#pragma once

#include <float.h>

#include "common.cuh"
#include "philox.cuh"

namespace tpudl {
namespace attn {

// tpudl.ops.attention.MASK_VALUE: -0.7 * FLT_MAX in double, rounded to
// f32 as the callers round it; finite in f32 and bf16.
constexpr float kMaskValue = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));
constexpr int kRows = 64;     // rows of the block's own side
constexpr int kThreads = 128; // 4 warps of 16 rows

// Shared-memory row padding (elements): keeps rows 16-byte aligned and
// spreads the fragment loads over the banks.
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int value = 4; };
template <> struct Pad<__nv_bfloat16> { static constexpr int value = 8; };

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. Without .trans lane (g, t) receives row g,
// columns 2t, 2t + 1 of each matrix; with .trans, rows 2t, 2t + 1 of
// column g.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Warp tile products. C is [16, 8 * NT] in m16n8 fragment layout: lane
// (g = lane / 4, t = lane % 4) holds, for n-tile j, c[j][0..1] at row g,
// columns 8j + 2t, 8j + 2t + 1 and c[j][2..3] at row g + 8, same columns.
//
// abt:     C += A B^T, A [16, K] and B [8 * NT, K] row-major in shared
//          memory (row strides lda, ldb).
// ab_frag: C += P B, P [16, K] given in the fragment layout above (K / 8
//          n-tiles of f32 values, rounded to T here: tpudl's
//          p.astype(v.dtype)), B [K, 8 * NT] row-major in shared memory.
//          `pw` is the warp's [16, K] scratch (row stride ldp) where a type
//          without a register path stages P.
template <typename T, int NT, int K> struct WarpMma;

// bf16: mma.sync m16n8k16 on the tensor cores, operands by ldmatrix; P
// goes from the accumulator registers straight into the A fragments.
template <int NT, int K> struct WarpMma<__nv_bfloat16, NT, K> {
  using T = __nv_bfloat16;
  static_assert(NT % 2 == 0 && K % 16 == 0, "whole 16 x 16 fragments");
  static __device__ __forceinline__ void abt(const T* a, int lda, const T* b, int ldb,
                                             float (&c)[NT][4]) {
    const int lane = threadIdx.x & 31;
    const T* pa = a + (lane % 16) * lda + (lane / 16) * 8;
    const T* pb = b + ((lane % 8) + (lane / 16) * 8) * ldb + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
      uint32_t fa[4];
      ldsm_x4(fa, pa + kk);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t fb[4];
        ldsm_x4(fb, pb + 8 * j * ldb + kk);
        mma_bf16(c[j], fa[0], fa[1], fa[2], fa[3], fb[0], fb[1]);
        mma_bf16(c[j + 1], fa[0], fa[1], fa[2], fa[3], fb[2], fb[3]);
      }
    }
  }
  static __device__ __forceinline__ void ab_frag(const float (&p)[K / 8][4], T*, int,
                                                 const T* b, int ldb, float (&c)[NT][4]) {
    const int lane = threadIdx.x & 31;
    const T* pb = b + ((lane % 8) + ((lane / 8) % 2) * 8) * ldb + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      const uint32_t a0 = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      const uint32_t a1 = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
      const uint32_t a2 = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t fb[4];
        ldsm_x4_trans(fb, pb + 16 * kk * ldb + 8 * j);
        mma_bf16(c[j], a0, a1, a2, a3, fb[0], fb[1]);
        mma_bf16(c[j + 1], a0, a1, a2, a3, fb[2], fb[3]);
      }
    }
  }
};

// f32: the same ownership, full-f32 FMAs on the CUDA cores; P is staged
// in the warp's scratch.
template <int NT, int K> struct WarpMma<float, NT, K> {
  static __device__ __forceinline__ void abt(const float* a, int lda, const float* b, int ldb,
                                             float (&c)[NT][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float x0 = a[g * lda + k], x8 = a[(g + 8) * lda + k];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float y0 = b[(8 * j + 2 * t) * ldb + k], y1 = b[(8 * j + 2 * t + 1) * ldb + k];
        c[j][0] = fmaf(x0, y0, c[j][0]);
        c[j][1] = fmaf(x0, y1, c[j][1]);
        c[j][2] = fmaf(x8, y0, c[j][2]);
        c[j][3] = fmaf(x8, y1, c[j][3]);
      }
    }
  }
  static __device__ __forceinline__ void ab_frag(const float (&p)[K / 8][4], float* pw, int ldp,
                                                 const float* b, int ldb, float (&c)[NT][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < K / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pw[(g + 8 * (e >> 1)) * ldp + 8 * j + 2 * t + (e & 1)] = p[j][e];
    }
    __syncwarp();
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float x0 = pw[g * ldp + k], x8 = pw[(g + 8) * ldp + k];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float y0 = b[k * ldb + 8 * j + 2 * t], y1 = b[k * ldb + 8 * j + 2 * t + 1];
        c[j][0] = fmaf(x0, y0, c[j][0]);
        c[j][1] = fmaf(x0, y1, c[j][1]);
        c[j][2] = fmaf(x8, y0, c[j][2]);
        c[j][3] = fmaf(x8, y1, c[j][3]);
      }
    }
    __syncwarp();
  }
};

template <typename T> struct HasScratch { static constexpr bool value = false; };
template <> struct HasScratch<float> { static constexpr bool value = true; };

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
}

// Asynchronous copies into shared memory (cp.async): 16 bytes, or 4;
// src_bytes = 0 fills zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying `rows` rows of D elements from a [*, S, H, D] tensor (row
// `row0` of the batch at batch_off, head h) into shared memory (row stride
// ld); rows at or past `limit` become zeros. 16-byte pieces: D * sizeof(T)
// is a multiple of 16.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* s, int ld, const T* __restrict__ base,
                                          int64_t batch_off, int H, int h, int row0, int rows,
                                          int limit) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += blockDim.x) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const bool in = row0 + r < limit;
    const T* src = base + batch_off + (static_cast<int64_t>(in ? row0 + r : 0) * H + h) * D + c;
    cp_async16(s + r * ld + c, src, in ? 16 : 0);
  }
}

// Store a warp's [16, D] f32 fragment (rows row0 + 0..15 of batch b, head
// h) to a [*, S, H, D] tensor, rows at or past `limit` skipped, each value
// rounded to T.
template <typename T, int D>
__device__ __forceinline__ void store_frag(T* __restrict__ base, int64_t batch_off, int H, int h,
                                           int row0, int limit, const float (&c)[D / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= limit) continue;
    T* out = base + batch_off + (static_cast<int64_t>(r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      out[8 * j + 2 * t] = from_f32<T>(c[j][2 * half]);
      out[8 * j + 2 * t + 1] = from_f32<T>(c[j][2 * half + 1]);
    }
  }
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* kvmask;  // [B, Skv] or null
  const int64_t* seed;    // [2] words (dropout only)
  const void* dout;       // backward: do [B, Sq, H, D]
  const float* lse;       // [B, H, Sq]
  const float* delta;     // [B, H, Sq]
  void* o;                // forward: o; dQ: dq; dK/dV: dk; whole backward: dq
  void* o2;               // dK/dV: dv; whole backward: dk
  void* o3;               // whole backward: dv
  float* lse_out;         // forward: lse
  float* delta_out;       // whole backward, dQ launch: delta [B, H, Sq]
  // Whole backward with dropout: the keep bits, [B, H, Sq, drop_words]
  // u32, bit kv % 32 of word kv / 32; the dQ launch writes them as it
  // draws them, the dK/dV launch reads them.
  uint32_t* drop_bits;
  int drop_words;
  int B, Sq, Skv, H;
  int causal;
  float scale;
  uint32_t threshold;  // keep when bits >= threshold
  float inv_keep;      // 1 / (1 - rate)
  int dropout;
};

// Whether (q row, kv column) attends, before dropout.
__device__ __forceinline__ bool attends(const Params& p, const uint8_t* mrow, int q, int kv) {
  if (q >= p.Sq || kv >= p.Skv) return false;
  if (mrow != nullptr && !mrow[kv]) return false;
  return !p.causal || kv <= q + (p.Skv - p.Sq);
}

// Whether every (q, kv) of the rectangle [q0, q0 + nq) x [kv0, kv0 + nk)
// attends, given `mask_ok` (no kv mask zero in the kv range): then the
// tile needs no per-element check.
__device__ __forceinline__ bool whole_tile(const Params& p, int q0, int nq, int kv0, int nk,
                                           bool mask_ok) {
  return mask_ok && q0 + nq <= p.Sq && kv0 + nk <= p.Skv &&
         (!p.causal || kv0 + nk - 1 <= q0 + (p.Skv - p.Sq));
}

// Whether the kv range [kv0, kv0 + n) of this batch row has a zero in the
// kv mask (or runs past Skv), across the block: every thread must call it.
__device__ __forceinline__ bool block_mask_gap(const Params& p, const uint8_t* mrow, int kv0, int n) {
  bool gap = false;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int kv = kv0 + i;
    gap = gap || kv >= p.Skv || (mrow != nullptr && !mrow[kv]);
  }
  return __syncthreads_or(gap) != 0;
}

__device__ __forceinline__ bool drop_keep(const Params& p, uint32_t k0, uint32_t k1, int b, int h,
                                          int q, int kv) {
  const uint64_t idx =
      ((static_cast<uint64_t>(b) * p.H + h) * p.Sq + q) * static_cast<uint64_t>(p.Skv) + kv;
  return tpudl::philox_bits(idx, k0, k1) >= p.threshold;
}

// Row sums and maxima across the 4 lanes that share a fragment row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// exp: the accurate expf for f32 (held to 1e-4 against the plain
// version), the MUFU-based __expf for bf16 (its error is far below a bf16
// step).
__device__ __forceinline__ float exp_t(float x, float) { return expf(x); }
__device__ __forceinline__ float exp_t(float x, __nv_bfloat16) { return __expf(x); }

template <typename T, int D, int N>
struct Smem {
  static constexpr int ldd = D + Pad<T>::value;
  static constexpr int ldn = N + Pad<T>::value;
  // The f32 path's P scratch, [kRows, N]; none for bf16.
  static constexpr int pbuf = HasScratch<T>::value ? kRows * ldn : 0;
};

// The Params fields every entry point sets.
inline Params make_params(const void* q, const void* k, const void* v, const void* kvmask,
                          const void* seed, int b, int sq, int skv, int h, int causal,
                          float scale, uint32_t threshold, float inv_keep, int dropout) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.kvmask = static_cast<const uint8_t*>(kvmask);
  p.seed = static_cast<const int64_t*>(seed);
  p.B = b;
  p.Sq = sq;
  p.Skv = skv;
  p.H = h;
  p.causal = causal;
  p.scale = scale;
  p.threshold = threshold;
  p.inv_keep = inv_keep;
  p.dropout = dropout;
  return p;
}

}  // namespace attn
}  // namespace tpudl
