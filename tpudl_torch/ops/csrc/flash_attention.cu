// Flash attention for Hopper (sm_90a): the forward (o and the row
// logsumexp), the dQ backward and the dK/dV backward.
//
// Replaces, in tpudl/ops/flash_attention.py:
//   _fwd_kernel, launched by _fwd via pl.pallas_call;
//   _dq_kernel and _dkv_kernel, launched by _bwd_core via pl.pallas_call.
//
// Computes, on q [B, Sq, H, D] and k, v [B, Skv, H, D] (the layout of the
// callers: no transpose, no padding in device memory), with
// s = (q k^T) * scale in f32 and keep = kv < Skv && kvmask[b, kv] &&
// (!causal || kv <= q + Skv - Sq):
//   forward: p = keep ? exp(s - m) : 0 over an online running max m,
//            l = sum p (undropped), o = (sum_j dropkeep_j * round_T(p_j) v_j)
//            / l * 1 / (1 - rate), lse = m + log(l); a row that keeps
//            nothing gives o = 0 and lse = MASK_VALUE (l = 0 -> 1);
//   dQ:      p = keep ? exp(s - lse) : 0, dp = do v^T (dropped entries 0,
//            kept ones / (1 - rate)), ds = p * (dp - delta) * scale,
//            dq = round_T(ds) k;
//   dK/dV:   the same p, dp and ds per (kv, q) pair, dv = round_T(p')^T do
//            with p' = dropkeep ? p / (1 - rate) : 0, dk = round_T(ds)^T q.
// delta = sum(do * o) (minus the lse cotangent) comes in from the caller.
// Dropout bits are the contract of philox.cuh, element index
// ((b * H + h) * Sq + q) * Skv + kv of the unpadded [B, H, Sq, Skv] tensor,
// so the forward, both backward kernels and the plain PyTorch version draw
// the same mask.
//
// What bounds them on the H100: operations. At the Llama-3-8B LoRA step
// ([4, 2048, 32, 128] bf16, causal) each causal-halved product is 68.7
// GFLOP; the forward does two, dQ three, dK/dV four, against ~200 MB of
// operands (~60 us at 3.35 TB/s) — far above the card's ~295 operations
// per byte, so the tensor cores are the limit: 139, 208 and 278 us at
// 989 TFLOP/s.
//
// What the design does about that (a first version that is right, not
// yet fast):
// - bf16 products run on the tensor cores with mma.sync m16n8k16 and f32
//   accumulation, operands loaded by ldmatrix (.trans for the [k, n]
//   operands V, K, Q, do); f32 operands run in full f32 on the CUDA cores
//   (never TF32) with the same fragment ownership, so one body serves
//   both.
// - One block of 4 warps takes 64 rows of its own side (q rows for the
//   forward and dQ, kv rows for dK/dV); each warp owns 16 of them and
//   keeps their accumulator in registers in mma fragment layout. The
//   other side streams through shared memory a tile at a time, two
//   buffers deep (cp.async: the next tile's copy runs during this tile's
//   products). The online-softmax rescale multiplies the fragment rows in
//   registers, and the probabilities (and ds) go from the accumulator
//   registers straight into the next product's A fragments, rounded to
//   the inputs' type there (tpudl's p.astype(v.dtype), ds.astype(k.dtype));
//   the f32 path stages them in shared memory.
// - The Pallas grid carries accumulators across a sequential grid axis;
//   here the loop over the streamed side runs inside the block, and the
//   two backward kernels stay separate so each accumulator has one owner:
//   no float atomics, so the backward is bitwise repeatable.
// - Causal tiles that cannot contribute are skipped; a tile that every
//   (q, kv) pair attends (below the diagonal, in range, no kv-mask zero)
//   skips the per-element mask checks; ragged Sq and Skv are bounds
//   checks (rows past the end load as zeros and never store).
// wgmma, TMA and warp specialisation are later work.
#include <float.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

using tpudl::from_f32;
using tpudl::to_f32;

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
  void* o;                // forward: o; dQ: dq; dK/dV: dk
  void* o2;               // dK/dV: dv
  float* lse_out;         // forward: lse
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

// ---------------------------------------------------------------------------
// forward: block = (q block, h, b); kv tiles of N stream through, two
// buffers deep (the next tile's copy runs during this tile's products).
// ---------------------------------------------------------------------------
template <typename T, int D, int N>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  using S = Smem<T, D, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kRows * S::ldd;   // [2][N][ldd]
  T* sV = sK + 2 * N * S::ldd;   // [2][N][ldd]
  T* sP = sV + 2 * N * S::ldd;   // f32 only
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int64_t qoff = static_cast<int64_t>(b) * p.Sq * p.H * D;
  const int64_t koff = static_cast<int64_t>(b) * p.Skv * p.H * D;
  const uint8_t* mrow = p.kvmask ? p.kvmask + static_cast<int64_t>(b) * p.Skv : nullptr;
  uint32_t k0 = 0, k1 = 0;
  if (p.dropout) {
    k0 = static_cast<uint32_t>(p.seed[0]);
    k1 = static_cast<uint32_t>(p.seed[1]);
  }
  // kv tiles [0, tiles): those past the diagonal cannot contribute.
  int tiles = (p.Skv + N - 1) / N;
  if (p.causal) {
    const int q_last = min(q0 + kRows, p.Sq) - 1 + (p.Skv - p.Sq);
    tiles = q_last < 0 ? 0 : min(tiles, q_last / N + 1);
  }
  load_rows<T, D>(sQ, S::ldd, q, qoff, p.H, h, q0, kRows, p.Sq);
  if (tiles > 0) {
    load_rows<T, D>(sK, S::ldd, k, koff, p.H, h, 0, N, p.Skv);
    load_rows<T, D>(sV, S::ldd, v, koff, p.H, h, 0, N, p.Skv);
  }
  cp_async_commit();

  const int rw = warp * 16;  // this warp's first row in the block
  float acc[D / 8][4];
  zero(acc);
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.0f, 0.0f};
  for (int it = 0; it < tiles; ++it) {
    const int kv0 = it * N, buf = it & 1;
    if (it + 1 < tiles) {
      const int nb = buf ^ 1;
      load_rows<T, D>(sK + nb * N * S::ldd, S::ldd, k, koff, p.H, h, kv0 + N, N, p.Skv);
      load_rows<T, D>(sV + nb * N * S::ldd, S::ldd, v, koff, p.H, h, kv0 + N, N, p.Skv);
    }
    cp_async_commit();
    cp_async_wait_one();
    // The barrier that publishes this tile also tells whether it is whole.
    const bool full = whole_tile(p, q0, kRows, kv0, N, !block_mask_gap(p, mrow, kv0, N));
    const T* cK = sK + buf * N * S::ldd;
    const T* cV = sV + buf * N * S::ldd;
    float s[N / 8][4];
    zero(s);
    WarpMma<T, N / 8, D>::abt(sQ + rw * S::ldd, S::ldd, cK, S::ldd, s);
    float mt[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale;
        if (!full) {
          const int r = q0 + rw + g + 8 * (e >> 1), c = kv0 + 8 * j + 2 * t + (e & 1);
          if (!attends(p, mrow, r, c)) x = kMaskValue;
        }
        s[j][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float mn = fmaxf(m[hf], quad_max(mt[hf]));
      corr[hf] = exp_t(m[hf] - mn, T());
      m[hf] = mn;
    }
    float ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        // Masked logits hold MASK_VALUE: exactly the entries at or below it.
        float pe = s[j][e] > kMaskValue ? exp_t(s[j][e] - m[hf], T()) : 0.0f;
        ls[hf] += pe;
        if (p.dropout && pe != 0.0f) {
          const int r = q0 + rw + g + 8 * hf, c = kv0 + 8 * j + 2 * t + (e & 1);
          if (!drop_keep(p, k0, k1, b, h, r, c)) pe = 0.0f;
        }
        s[j][e] = pe;
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * corr[hf] + quad_sum(ls[hf]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    WarpMma<T, D / 8, N>::ab_frag(s, sP + rw * S::ldn, S::ldn, cV, S::ldd, acc);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait_all();  // the (empty) last group
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float l_safe = l[hf] > 0.0f ? l[hf] : 1.0f;
    const int r = q0 + rw + g + 8 * hf;
    if (t == 0 && r < p.Sq) {
      p.lse_out[(static_cast<int64_t>(b) * p.H + h) * p.Sq + r] = m[hf] + logf(l_safe);
    }
    // tpudl's order: acc / l_safe, then (with dropout) * 1 / (1 - rate).
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
        acc[j][e] = acc[j][e] / l_safe;
        if (p.dropout) acc[j][e] *= p.inv_keep;
      }
    }
  }
  store_frag<T, D>(static_cast<T*>(p.o), qoff, p.H, h, q0 + rw, p.Sq, acc);
}

// ---------------------------------------------------------------------------
// dQ: block = (q block, h, b); kv tiles of N stream through, two deep.
// ---------------------------------------------------------------------------
template <typename T, int D, int N>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Params p) {
  using S = Smem<T, D, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sO = sQ + kRows * S::ldd;      // do
  T* sK = sO + kRows * S::ldd;      // [2][N][ldd]
  T* sV = sK + 2 * N * S::ldd;      // [2][N][ldd]
  T* sP = sV + 2 * N * S::ldd;      // f32 only
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int64_t qoff = static_cast<int64_t>(b) * p.Sq * p.H * D;
  const int64_t koff = static_cast<int64_t>(b) * p.Skv * p.H * D;
  const uint8_t* mrow = p.kvmask ? p.kvmask + static_cast<int64_t>(b) * p.Skv : nullptr;
  uint32_t k0 = 0, k1 = 0;
  if (p.dropout) {
    k0 = static_cast<uint32_t>(p.seed[0]);
    k1 = static_cast<uint32_t>(p.seed[1]);
  }
  int tiles = (p.Skv + N - 1) / N;
  if (p.causal) {
    const int q_last = min(q0 + kRows, p.Sq) - 1 + (p.Skv - p.Sq);
    tiles = q_last < 0 ? 0 : min(tiles, q_last / N + 1);
  }
  load_rows<T, D>(sQ, S::ldd, static_cast<const T*>(p.q), qoff, p.H, h, q0, kRows, p.Sq);
  load_rows<T, D>(sO, S::ldd, static_cast<const T*>(p.dout), qoff, p.H, h, q0, kRows, p.Sq);
  if (tiles > 0) {
    load_rows<T, D>(sK, S::ldd, k, koff, p.H, h, 0, N, p.Skv);
    load_rows<T, D>(sV, S::ldd, v, koff, p.H, h, 0, N, p.Skv);
  }
  cp_async_commit();
  const int rw = warp * 16;
  float lse[2], dlt[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + rw + g + 8 * hf;
    const int64_t i = (static_cast<int64_t>(b) * p.H + h) * p.Sq + r;
    lse[hf] = r < p.Sq ? p.lse[i] : 0.0f;
    dlt[hf] = r < p.Sq ? p.delta[i] : 0.0f;
  }
  float dq[D / 8][4];
  zero(dq);
  for (int it = 0; it < tiles; ++it) {
    const int kv0 = it * N, buf = it & 1;
    if (it + 1 < tiles) {
      const int nb = buf ^ 1;
      load_rows<T, D>(sK + nb * N * S::ldd, S::ldd, k, koff, p.H, h, kv0 + N, N, p.Skv);
      load_rows<T, D>(sV + nb * N * S::ldd, S::ldd, v, koff, p.H, h, kv0 + N, N, p.Skv);
    }
    cp_async_commit();
    cp_async_wait_one();
    const bool full = whole_tile(p, q0, kRows, kv0, N, !block_mask_gap(p, mrow, kv0, N));
    const T* cK = sK + buf * N * S::ldd;
    const T* cV = sV + buf * N * S::ldd;
    float s[N / 8][4], dp[N / 8][4];
    zero(s);
    zero(dp);
    WarpMma<T, N / 8, D>::abt(sQ + rw * S::ldd, S::ldd, cK, S::ldd, s);
    WarpMma<T, N / 8, D>::abt(sO + rw * S::ldd, S::ldd, cV, S::ldd, dp);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const int r = q0 + rw + g + 8 * hf, c = kv0 + 8 * j + 2 * t + (e & 1);
        float ds = 0.0f;
        if (full || attends(p, mrow, r, c)) {
          const float pe = exp_t(s[j][e] * p.scale - lse[hf], T());
          float d = dp[j][e];
          if (p.dropout) d = drop_keep(p, k0, k1, b, h, r, c) ? d * p.inv_keep : 0.0f;
          ds = pe * (d - dlt[hf]) * p.scale;
        }
        s[j][e] = ds;
      }
    }
    WarpMma<T, D / 8, N>::ab_frag(s, sP + rw * S::ldn, S::ldn, cK, S::ldd, dq);
    __syncthreads();
  }
  cp_async_wait_all();
  store_frag<T, D>(static_cast<T*>(p.o), qoff, p.H, h, q0 + rw, p.Sq, dq);
}

// ---------------------------------------------------------------------------
// dK/dV: block = (kv block, h, b); q tiles of N stream through, two deep.
// ---------------------------------------------------------------------------
template <typename T, int D, int N>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Params p) {
  using S = Smem<T, D, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kRows * S::ldd;
  T* sQ = sV + kRows * S::ldd;    // [2][N][ldd]
  T* sO = sQ + 2 * N * S::ldd;    // do, [2][N][ldd]
  T* sP = sO + 2 * N * S::ldd;    // f32 only
  float* sLse = reinterpret_cast<float*>(sP + S::pbuf);  // [2][N]
  float* sDlt = sLse + 2 * N;                             // [2][N]
  const int b = blockIdx.z, h = blockIdx.y, kv0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* q = static_cast<const T*>(p.q);
  const T* dout = static_cast<const T*>(p.dout);
  const int64_t qoff = static_cast<int64_t>(b) * p.Sq * p.H * D;
  const int64_t koff = static_cast<int64_t>(b) * p.Skv * p.H * D;
  const uint8_t* mrow = p.kvmask ? p.kvmask + static_cast<int64_t>(b) * p.Skv : nullptr;
  uint32_t k0 = 0, k1 = 0;
  if (p.dropout) {
    k0 = static_cast<uint32_t>(p.seed[0]);
    k1 = static_cast<uint32_t>(p.seed[1]);
  }
  const int64_t row_off = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
  // q tiles [first, tiles): a tile contributes iff its last row reaches
  // this block's first kv (kv <= q + Skv - Sq).
  const int tiles = (p.Sq + N - 1) / N;
  int first = 0;
  if (p.causal) {
    const int need = kv0 - (p.Skv - p.Sq) - (N - 1);  // qt0 >= need
    first = need <= 0 ? 0 : (need + N - 1) / N;
  }
  auto prefetch = [&](int it, int buf) {
    const int qt0 = it * N;
    load_rows<T, D>(sQ + buf * N * S::ldd, S::ldd, q, qoff, p.H, h, qt0, N, p.Sq);
    load_rows<T, D>(sO + buf * N * S::ldd, S::ldd, dout, qoff, p.H, h, qt0, N, p.Sq);
    for (int i = threadIdx.x; i < 2 * N; i += blockDim.x) {
      const int r = qt0 + (i % N);
      const bool in = r < p.Sq;
      const float* src = (i < N ? p.lse : p.delta) + row_off + (in ? r : 0);
      cp_async4((i < N ? sLse : sDlt) + buf * N + (i % N), src, in ? 4 : 0);
    }
  };
  load_rows<T, D>(sK, S::ldd, static_cast<const T*>(p.k), koff, p.H, h, kv0, kRows, p.Skv);
  load_rows<T, D>(sV, S::ldd, static_cast<const T*>(p.v), koff, p.H, h, kv0, kRows, p.Skv);
  if (first < tiles) prefetch(first, 0);
  cp_async_commit();
  const bool kv_ok = !block_mask_gap(p, mrow, kv0, kRows);
  const int rw = warp * 16;
  float dk[D / 8][4], dv[D / 8][4];
  zero(dk);
  zero(dv);
  for (int it = first; it < tiles; ++it) {
    const int qt0 = it * N, buf = (it - first) & 1;
    if (it + 1 < tiles) prefetch(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    // Whole when every (q, kv) pair of the tile attends: q rows in range,
    // the kv block unmasked, and (causal) below the diagonal.
    const bool full = kv_ok && qt0 + N <= p.Sq &&
                      (!p.causal || kv0 + kRows - 1 <= qt0 + (p.Skv - p.Sq));
    const T* cQ = sQ + buf * N * S::ldd;
    const T* cO = sO + buf * N * S::ldd;
    const float* cLse = sLse + buf * N;
    const float* cDlt = sDlt + buf * N;
    // Transposed tiles: rows are this warp's kv rows, columns q rows.
    float s[N / 8][4], dp[N / 8][4];
    zero(s);
    zero(dp);
    WarpMma<T, N / 8, D>::abt(sK + rw * S::ldd, S::ldd, cQ, S::ldd, s);
    WarpMma<T, N / 8, D>::abt(sV + rw * S::ldd, S::ldd, cO, S::ldd, dp);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = kv0 + rw + g + 8 * (e >> 1);
        const int qi = 8 * j + 2 * t + (e & 1), r = qt0 + qi;
        float pn = 0.0f, ds = 0.0f;
        if (full || attends(p, mrow, r, c)) {
          const float pe = exp_t(s[j][e] * p.scale - cLse[qi], T());
          float d = dp[j][e];
          pn = pe;
          if (p.dropout) {
            const bool kd = drop_keep(p, k0, k1, b, h, r, c);
            pn = kd ? pe * p.inv_keep : 0.0f;
            d = kd ? d * p.inv_keep : 0.0f;
          }
          ds = pe * (d - cDlt[qi]) * p.scale;
        }
        s[j][e] = pn;
        dp[j][e] = ds;
      }
    }
    WarpMma<T, D / 8, N>::ab_frag(s, sP + rw * S::ldn, S::ldn, cO, S::ldd, dv);
    WarpMma<T, D / 8, N>::ab_frag(dp, sP + rw * S::ldn, S::ldn, cQ, S::ldd, dk);
    __syncthreads();
  }
  cp_async_wait_all();
  store_frag<T, D>(static_cast<T*>(p.o), koff, p.H, h, kv0 + rw, p.Skv, dk);
  store_frag<T, D>(static_cast<T*>(p.o2), koff, p.H, h, kv0 + rw, p.Skv, dv);
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D, int N>
size_t smem_bytes(Which which) {
  using S = Smem<T, D, N>;
  const size_t own = kRows * S::ldd, stream = 2 * 2 * N * S::ldd;  // 2 tensors, 2 buffers
  switch (which) {
    case kFwd:  // Q; K, V x 2; P
      return (own + stream + S::pbuf) * sizeof(T);
    case kDq:  // Q, do; K, V x 2; dS
      return (2 * own + stream + S::pbuf) * sizeof(T);
    default:  // K, V; Q, do x 2; P; lse, delta x 2
      return (2 * own + stream + S::pbuf) * sizeof(T) + 4 * N * sizeof(float);
  }
}

template <typename T, int D, int N>
int launch_one(Which which, const Params& p, cudaStream_t stream) {
  void (*kernel)(Params) = which == kFwd  ? flash_fwd_kernel<T, D, N>
                           : which == kDq ? flash_dq_kernel<T, D, N>
                                          : flash_dkv_kernel<T, D, N>;
  const size_t smem = smem_bytes<T, D, N>(which);
  // Above 48 KB only as opted-in dynamic shared memory; set once per kernel
  // (before any graph capture: the first call of each runs eagerly).
  static bool opted[3] = {false, false, false};
  if (!opted[which]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[which] = true;
  }
  const int rows = which == kDkv ? p.Skv : p.Sq;
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), static_cast<unsigned>(p.H),
                  static_cast<unsigned>(p.B));
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The streamed tile: 64 rows, 32 for the dK/dV kernel at D = 128 (its two
// [16, D] accumulators already hold 128 f32 registers per thread).
template <typename T, int D>
int launch_d(Which which, const Params& p, cudaStream_t stream) {
  if (which == kDkv && D == 128) return launch_one<T, D, 32>(which, p, stream);
  return launch_one<T, D, 64>(which, p, stream);
}

template <typename T>
int launch_t(Which which, int d, const Params& p, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_d<T, 32>(which, p, stream);
    case 64:
      return launch_d<T, 64>(which, p, stream);
    case 128:
      return launch_d<T, 128>(which, p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int launch(Which which, int d, int dtype, const Params& p, void* stream) {
  if (p.B <= 0 || p.H <= 0 || p.Sq <= 0 || p.Skv <= 0 || p.H > 65535 || p.B > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tpudl::kFloat32:
      return launch_t<float>(which, d, p, st);
    case tpudl::kBFloat16:
      return launch_t<__nv_bfloat16>(which, d, p, st);
    default:
      return cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* kvmask,
                   const void* seed, int b, int sq, int skv, int h, int causal, float scale,
                   uint32_t threshold, float inv_keep, int dropout) {
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

}  // namespace

// q, o: [b, sq, h, d]; k, v: [b, skv, h, d], contiguous, 16-byte aligned, of
// tpudl::DType `dtype`; d in {32, 64, 128}. kvmask: [b, skv] bool or null.
// seed: int64 [2] (read only when dropout != 0). lse: [b, h, sq] f32.
extern "C" int tpudl_flash_fwd(const void* q, const void* k, const void* v, const void* kvmask,
                               const void* seed, void* o, void* lse, int b, int sq, int skv,
                               int h, int d, int causal, float scale, uint32_t threshold,
                               float inv_keep, int dropout, int dtype, void* stream) {
  Params p = make_params(q, k, v, kvmask, seed, b, sq, skv, h, causal, scale, threshold,
                         inv_keep, dropout);
  p.o = o;
  p.lse_out = static_cast<float*>(lse);
  return launch(kFwd, d, dtype, p, stream);
}

// As tpudl_flash_fwd; dout, dq: [b, sq, h, d]; lse, delta: [b, h, sq] f32.
extern "C" int tpudl_flash_dq(const void* q, const void* k, const void* v, const void* kvmask,
                              const void* seed, const void* dout, const void* lse,
                              const void* delta, void* dq, int b, int sq, int skv, int h, int d,
                              int causal, float scale, uint32_t threshold, float inv_keep,
                              int dropout, int dtype, void* stream) {
  Params p = make_params(q, k, v, kvmask, seed, b, sq, skv, h, causal, scale, threshold,
                         inv_keep, dropout);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.o = dq;
  return launch(kDq, d, dtype, p, stream);
}

// As tpudl_flash_dq; dk, dv: [b, skv, h, d].
extern "C" int tpudl_flash_dkv(const void* q, const void* k, const void* v, const void* kvmask,
                               const void* seed, const void* dout, const void* lse,
                               const void* delta, void* dk, void* dv, int b, int sq, int skv,
                               int h, int d, int causal, float scale, uint32_t threshold,
                               float inv_keep, int dropout, int dtype, void* stream) {
  Params p = make_params(q, k, v, kvmask, seed, b, sq, skv, h, causal, scale, threshold,
                         inv_keep, dropout);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.o = dk;
  p.o2 = dv;
  return launch(kDkv, d, dtype, p, stream);
}
