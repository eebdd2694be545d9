// The weight-only quantized product y[M, N] = (x[M, K] . q[N, K]^T) * scale[N]
// for Hopper (sm_90a): int8 or e4m3 weights stored [N, K] (the
// torch Linear layout, one row per output channel), one f32 scale per
// output channel, x in bf16 or f32, y in x's dtype, f32 accumulation.
//
// Replaces no Pallas kernel: tpudl's fused quantized product
// (tpudl/quant/dense.py quant_dot, "fused") is XLA's mixed-dtype
// dot_general with preferred_element_type=f32, then one per-channel
// multiply. Its point is that the full-precision weight never exists in
// device memory; no PyTorch call contracts bf16 activations against int8
// or e4m3 weights on CUDA without first writing the dequantized weight,
// so the port's fused form is this kernel.
//
// Two entry points:
//
// (a) tpudl_quant_gemv, M <= 16 (decode). Bound by the weight's bytes:
//     N * K bytes of int8/e4m3 streamed once. Each warp owns 2 output rows.
//     Each lane walks 16-byte vectors of its rows' weights (16 weights a
//     load), widens them to f32 once and reuses them for every row of x,
//     which it reads through the L1 path (every warp of an SM reads the
//     same few rows of x; staging them in shared memory was slower on the
//     H100); it keeps
//     2 x M f32 partial sums, and the warp reduces them with xor-shuffles
//     in a fixed order (no float atomics: bitwise repeatable). It is a
//     programmatic dependent launch: nothing touches device memory before
//     pdl_wait(), and the next kernel is let in after the last weight
//     load. A K that is not whole 16-byte vectors (or a misaligned
//     pointer) takes the scalar variant (one weight a lane a step), not
//     the plain version.
//
// (b) tpudl_quant_gemm, M > 16 (prefill, BERT). Bound by operations at
//     large M. 64 x 64 output tiles, 4 warps of 32 x 32, K in steps of
//     32, mma.sync m16n8k16 bf16 with f32 accumulation (int8 -> bf16 and
//     e4m3 -> bf16 are exact). For bf16 x with whole 16-byte vectors (the
//     main path) the x tile and the raw weight tile go global -> shared by
//     cp.async, four steps in flight, and the weights are widened to bf16
//     as the B fragments are read. Otherwise (f32 x, ragged K) the tiles
//     pass through registers, one step ahead, into two shared stages; an
//     f32 x is split into three bf16 terms (hi + mid + lo, each exact),
//     three mma per step, so the product keeps nearly all of f32's
//     mantissa. Ragged M, N and K are zero-filled in shared memory. No
//     wgmma, TMA or split-K yet: a grid of few tiles (M = 128) walks K
//     one block a tile.
//
// Weights are widened with integer tricks rather than conversion
// instructions (a quarter of the ALU rate): an int8 v becomes the f32
// 2^23 + (v + 128), less 2^23 + 128; an e4m3 byte's exponent and mantissa
// bits placed at f32's exponent field make 2^-120 times its value
// (subnormals included), times 2^120. Both are exact, and the high half of
// the f32 is the bf16 (at most 8 significant bits).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include "common.cuh"

namespace {

using tpudl::from_f32;
using tpudl::to_f32;

// Weight storage codes, as the wrapper encodes them.
enum QType : int { kInt8 = 0, kE4M3 = 1 };

// ---------------------------------------------------------------------------
// Weight element -> f32 (exact for both types).
// ---------------------------------------------------------------------------

template <int Q> __device__ __forceinline__ float q_to_f32(uint32_t b);
template <> __device__ __forceinline__ float q_to_f32<kInt8>(uint32_t b) {
  // b in the low byte: (b ^ 0x80) = v + 128 in [1, 255].
  return __int_as_float(0x4B000000u | ((b ^ 0x80u) & 0xffu)) - 8388736.0f;
}
template <> __device__ __forceinline__ float q_to_f32<kE4M3>(uint32_t b) {
  const uint32_t bits = ((b & 0x80u) << 24) | ((b & 0x7Fu) << 20);
  return __int_as_float(bits) * 0x1p120f;
}

// Sixteen weights (one 16-byte vector) -> f32.
template <int Q>
__device__ __forceinline__ void unpack_q16(const uint4& raw, float (&out)[16]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[4 * i + j] = q_to_f32<Q>(w[i] >> (8 * j));
  }
}

// 16 bytes global -> shared without registers (cp.async, L2 only); with
// pred false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// (a) the decode GEMV
// ---------------------------------------------------------------------------

constexpr int kGemvWarps = 4;
constexpr int kGemvRows = 2;  // output rows a warp

// Sixteen consecutive elements of T at p (16-byte aligned, read-only
// device memory) -> f32, as 16-byte loads through the L1 path.
template <typename T>
__device__ __forceinline__ void ldg16(const T* p, float (&out)[16]) {
  constexpr int W = tpudl::VecWidth<T>::value;
#pragma unroll
  for (int i = 0; i < 16 / W; ++i) {
    float part[W];
    tpudl::unpack_vec<T>(__ldg(reinterpret_cast<const uint4*>(p) + i), part);
#pragma unroll
    for (int j = 0; j < W; ++j) out[i * W + j] = part[j];
  }
}

// VEC = 16: 16-byte weight loads (K % 16 == 0, aligned); VEC = 1: scalar.
// MB rows of x are computed (a template bound: 4, 8 or 16); rows past
// m_rows re-read row m_rows - 1 (no branch in the loop) and are not
// written.
template <typename T, int Q, int VEC, int MB>
__global__ void __launch_bounds__(kGemvWarps * 32)
    quant_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                      const float* __restrict__ scale, T* __restrict__ y, int m_rows, int n,
                      int64_t k) {
  constexpr int R = kGemvRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kGemvWarps + warp) * R;
  // Rows past n read row n - 1 (in bounds) and are not written.
  int64_t qoff[R];
#pragma unroll
  for (int r = 0; r < R; ++r) qoff[r] = static_cast<int64_t>(min(row0 + r, n - 1)) * k;
  int64_t xoff[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) xoff[m] = static_cast<int64_t>(min(m, m_rows - 1)) * k;

  float acc[R][MB];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MB; ++m) acc[r][m] = 0.0f;

  tpudl::pdl_wait();

  if constexpr (VEC == 16) {
    const int nv = static_cast<int>(k / 16);
#pragma unroll 4
    for (int v = lane; v < nv; v += 32) {
      float w[R][16];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        unpack_q16<Q>(__ldg(reinterpret_cast<const uint4*>(q + qoff[r]) + v), w[r]);
      }
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        float xv[16];
        ldg16(x + xoff[m] + 16 * static_cast<int64_t>(v), xv);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float s = acc[r][m];
#pragma unroll
          for (int j = 0; j < 16; ++j) s = fmaf(xv[j], w[r][j], s);
          acc[r][m] = s;
        }
      }
    }
  } else {
    for (int64_t i = lane; i < k; i += 32) {
      float w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) w[r] = q_to_f32<Q>(q[qoff[r] + i]);
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const float xv = to_f32(x[xoff[m] + i]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][m] = fmaf(xv, w[r], acc[r][m]);
      }
    }
  }
  tpudl::pdl_launch_dependents();

  // Fixed-order butterfly: every lane ends with the warp's sum.
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][m] += __shfl_xor_sync(0xffffffffu, acc[r][m], off);

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = row0 + r;
      const float s = scale[min(row, n - 1)];
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        if (row < n && m < m_rows) {
          y[static_cast<int64_t>(m) * n + row] = from_f32<T>(acc[r][m] * s);
        }
      }
    }
  }
}

template <typename T, int Q, int VEC>
int launch_gemv_v(const void* x, const void* q, const void* scale, void* y, int m, int n,
                  int64_t k, cudaStream_t st) {
  constexpr int rows_per_block = kGemvWarps * kGemvRows;
  const dim3 grid(static_cast<unsigned>((n + rows_per_block - 1) / rows_per_block));
  const dim3 block(kGemvWarps * 32);
  const T* xp = static_cast<const T*>(x);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  T* yp = static_cast<T*>(y);
  if (m <= 4) {
    return tpudl::launch_pdl(quant_gemv_kernel<T, Q, VEC, 4>, grid, block, st, xp, qp, sp, yp,
                             m, n, k);
  }
  if (m <= 8) {
    return tpudl::launch_pdl(quant_gemv_kernel<T, Q, VEC, 8>, grid, block, st, xp, qp, sp, yp,
                             m, n, k);
  }
  return tpudl::launch_pdl(quant_gemv_kernel<T, Q, VEC, 16>, grid, block, st, xp, qp, sp, yp,
                           m, n, k);
}

template <typename T, int Q>
int launch_gemv(const void* x, const void* q, const void* scale, void* y, int m, int n,
                int64_t k, cudaStream_t st) {
  const bool vec = k % 16 == 0 && tpudl::aligned16(x) && tpudl::aligned16(q);
  return vec ? launch_gemv_v<T, Q, 16>(x, q, scale, y, m, n, k, st)
             : launch_gemv_v<T, Q, 1>(x, q, scale, y, m, n, k, st);
}

// ---------------------------------------------------------------------------
// (b) the tiled tensor-core product
// ---------------------------------------------------------------------------

constexpr int kBM = 64, kBN = 64, kBK = 32;
// Row stride of a shared tile in bf16 elements: 8 of padding make the
// fragment loads of 8 rows x 4 lanes hit 32 distinct banks.
constexpr int kLds = kBK + 8;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The high 16 bits of two f32 as one bf16 pair (exact for values with at
// most 8 significant bits, as widened weights are).
__device__ __forceinline__ uint32_t pack_hi16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// One thread's share of a step's tiles, held in registers between the
// loads and the shared-memory stores: 16 consecutive elements of one row
// of the x tile and of the weight tile, widened.
struct StepRegs {
  float xf[16];
  float w[16];
};

// SPLIT = 1 (bf16 x) or 3 (f32 x as hi + mid + lo bf16 terms).
// VEC = 16: whole 16-byte vectors (K % 16 == 0, aligned); VEC = 1:
// element loads. bf16 x in whole vectors takes quant_gemm_async_kernel,
// so bf16 x comes here only with VEC = 1.
template <typename T, int Q, int VEC, int SPLIT>
__global__ void __launch_bounds__(128)
    quant_gemm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
                      const float* __restrict__ scale, T* __restrict__ y, int m_rows, int n,
                      int64_t k) {
  __shared__ __align__(16) __nv_bfloat16 a_s[2][SPLIT][kBM * kLds];
  __shared__ __align__(16) __nv_bfloat16 bs[2][kBN * kLds];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;  // the warp's 32 x 32
  const int group = lane >> 2, tig = lane & 3;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  // This thread's row of each tile and its 16 columns.
  const int lr = tid >> 1, lc = (tid & 1) * 16;
  const int64_t gm = m0 + lr, gn = n0 + lr;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  StepRegs regs;
  auto load_step = [&](int64_t k0) {
    if constexpr (VEC == 16) {
      if (gm < m_rows && k0 + lc < k) {
        ldg16(x + gm * k + k0 + lc, regs.xf);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) regs.xf[j] = 0.0f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int64_t gk = k0 + lc + j;
        regs.xf[j] = (gm < m_rows && gk < k) ? to_f32(x[gm * k + gk]) : 0.0f;
      }
    }
    if constexpr (VEC == 16) {
      if (gn < n && k0 + lc < k) {
        unpack_q16<Q>(__ldg(reinterpret_cast<const uint4*>(q + gn * k + k0 + lc)), regs.w);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) regs.w[j] = 0.0f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int64_t gk = k0 + lc + j;
        regs.w[j] = (gn < n && gk < k) ? q_to_f32<Q>(q[gn * k + gk]) : 0.0f;
      }
    }
  };
  auto store_step = [&](int buf) {
    float v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = regs.xf[j];
#pragma unroll
    for (int sp = 0; sp < SPLIT; ++sp) {
      uint32_t* dst = reinterpret_cast<uint32_t*>(&a_s[buf][sp][lr * kLds + lc]);
#pragma unroll
      for (int j = 0; j < 16; j += 2) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[j], v[j + 1]);
        dst[j / 2] = *reinterpret_cast<const uint32_t*>(&h);
        // The remainder (exact in f32) feeds the next term.
        v[j] -= __low2float(h);
        v[j + 1] -= __high2float(h);
      }
    }
    uint32_t* dst = reinterpret_cast<uint32_t*>(&bs[buf][lr * kLds + lc]);
#pragma unroll
    for (int j = 0; j < 16; j += 2) dst[j / 2] = pack_hi16(regs.w[j], regs.w[j + 1]);
  };

  load_step(0);
  int buf = 0;
  for (int64_t k0 = 0; k0 < k; k0 += kBK, buf ^= 1) {
    store_step(buf);
    // One barrier a step: the other stage was last read a step ago, before
    // every thread reached this one.
    __syncthreads();
    if (k0 + kBK < k) load_step(k0 + kBK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t bfrag[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* b = &bs[buf][(wn + j * 8 + group) * kLds + kk + tig * 2];
        bfrag[j][0] = *reinterpret_cast<const uint32_t*>(b);
        bfrag[j][1] = *reinterpret_cast<const uint32_t*>(b + 8);
      }
#pragma unroll
      for (int sp = 0; sp < SPLIT; ++sp) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const __nv_bfloat16* a = &a_s[buf][sp][(wm + i * 16 + group) * kLds + kk + tig * 2];
          uint32_t afrag[4];
          afrag[0] = *reinterpret_cast<const uint32_t*>(a);
          afrag[1] = *reinterpret_cast<const uint32_t*>(a + 8 * kLds);
          afrag[2] = *reinterpret_cast<const uint32_t*>(a + 8);
          afrag[3] = *reinterpret_cast<const uint32_t*>(a + 8 * kLds + 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], afrag, bfrag[j]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t cn = n0 + wn + j * 8 + tig * 2;
    const float s0 = cn < n ? scale[cn] : 0.0f;
    const float s1 = cn + 1 < n ? scale[cn + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t cm = m0 + wm + i * 16 + group + 8 * h;
        if (cm >= m_rows) continue;
        if (cn < n) y[cm * n + cn] = from_f32<T>(acc[i][j][2 * h] * s0);
        if (cn + 1 < n) y[cm * n + cn + 1] = from_f32<T>(acc[i][j][2 * h + 1] * s1);
      }
    }
  }
}

// The tiled product for bf16 x with whole 16-byte vectors (the main
// path): the x tile and the raw weight tile go global -> shared by
// cp.async, kStages steps in flight; the weights are widened to bf16 as
// the B fragments are read.
constexpr int kStages = 4;
constexpr int kLdq = kBK + 16;  // bytes a weight row in shared memory

template <int Q>
__global__ void __launch_bounds__(128)
    quant_gemm_async_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                            const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                            int m_rows, int n, int64_t k) {
  __shared__ __align__(16) __nv_bfloat16 xs[kStages][kBM * kLds];
  __shared__ __align__(16) uint8_t qs[kStages][kBN * kLdq];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int group = lane >> 2, tig = lane & 3;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // A step's tiles: x [64][32] as 256 chunks of 8 (two a thread), the
  // weights [64][32] as 128 chunks of 16 bytes (one a thread).
  auto load_stage = [&](int stage, int64_t k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = tid + h * 128;
      const int r = c >> 2, kc = (c & 3) * 8;
      const bool in = m0 + r < m_rows && k0 + kc < k;
      cp_async16(&xs[stage][r * kLds + kc], in ? x + (m0 + r) * k + k0 + kc : x, in);
    }
    const int r = tid >> 1, kq = (tid & 1) * 16;
    const bool in = n0 + r < n && k0 + kq < k;
    cp_async16(&qs[stage][r * kLdq + kq], in ? q + (n0 + r) * k + k0 + kq : q, in);
  };

  const int steps = static_cast<int>((k + kBK - 1) / kBK);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load_stage(st, static_cast<int64_t>(st) * kBK);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();  // step t's tiles have landed
    __syncthreads();               // ... for every thread; step t - 1 is read
    const int next = t + kStages - 1;
    if (next < steps) load_stage(next % kStages, static_cast<int64_t>(next) * kBK);
    cp_async_commit();
    const int st = t % kStages;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t bfrag[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* b = &qs[st][(wn + j * 8 + group) * kLdq + kk + tig * 2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t pair = *reinterpret_cast<const uint16_t*>(b + 8 * h);
          bfrag[j][h] = pack_hi16(q_to_f32<Q>(pair), q_to_f32<Q>(pair >> 8));
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* a = &xs[st][(wm + i * 16 + group) * kLds + kk + tig * 2];
        uint32_t afrag[4];
        afrag[0] = *reinterpret_cast<const uint32_t*>(a);
        afrag[1] = *reinterpret_cast<const uint32_t*>(a + 8 * kLds);
        afrag[2] = *reinterpret_cast<const uint32_t*>(a + 8);
        afrag[3] = *reinterpret_cast<const uint32_t*>(a + 8 * kLds + 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], afrag, bfrag[j]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t cn = n0 + wn + j * 8 + tig * 2;
    const float s0 = cn < n ? scale[cn] : 0.0f;
    const float s1 = cn + 1 < n ? scale[cn + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t cm = m0 + wm + i * 16 + group + 8 * h;
        if (cm >= m_rows) continue;
        if (cn < n) y[cm * n + cn] = __float2bfloat16_rn(acc[i][j][2 * h] * s0);
        if (cn + 1 < n) y[cm * n + cn + 1] = __float2bfloat16_rn(acc[i][j][2 * h + 1] * s1);
      }
    }
  }
}

template <typename T, int Q, int SPLIT>
int launch_gemm(const void* x, const void* q, const void* scale, void* y, int m, int n,
                int64_t k, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((n + kBN - 1) / kBN),
                  static_cast<unsigned>((m + kBM - 1) / kBM));
  const T* xp = static_cast<const T*>(x);
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  T* yp = static_cast<T*>(y);
  const bool vec = k % 16 == 0 && tpudl::aligned16(q) && tpudl::aligned16(x);
  if (!vec) {
    quant_gemm_kernel<T, Q, 1, SPLIT><<<grid, 128, 0, st>>>(xp, qp, sp, yp, m, n, k);
  } else if constexpr (SPLIT == 1) {
    quant_gemm_async_kernel<Q><<<grid, 128, 0, st>>>(xp, qp, sp, yp, m, n, k);
  } else {
    quant_gemm_kernel<T, Q, 16, SPLIT><<<grid, 128, 0, st>>>(xp, qp, sp, yp, m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y [m, n] = (x [m, k] . q [n, k]^T) * scale [n]; dtype: tpudl::DType of
// x and y; qtype: QType of q. m <= 16.
extern "C" int tpudl_quant_gemv(const void* x, const void* q, const void* scale, void* y, int m,
                                int n, int64_t k, int dtype, int qtype, void* stream) {
  if (m <= 0 || m > 16 || n <= 0 || k <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tpudl::kBFloat16) {
    return qtype == kInt8 ? launch_gemv<__nv_bfloat16, kInt8>(x, q, scale, y, m, n, k, st)
                          : launch_gemv<__nv_bfloat16, kE4M3>(x, q, scale, y, m, n, k, st);
  }
  return qtype == kInt8 ? launch_gemv<float, kInt8>(x, q, scale, y, m, n, k, st)
                        : launch_gemv<float, kE4M3>(x, q, scale, y, m, n, k, st);
}

// The same product for any m (the wrapper sends m > 16 here).
extern "C" int tpudl_quant_gemm(const void* x, const void* q, const void* scale, void* y, int m,
                                int n, int64_t k, int dtype, int qtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || m > 65535 * kBM) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tpudl::kBFloat16) {
    return qtype == kInt8 ? launch_gemm<__nv_bfloat16, kInt8, 1>(x, q, scale, y, m, n, k, st)
                          : launch_gemm<__nv_bfloat16, kE4M3, 1>(x, q, scale, y, m, n, k, st);
  }
  return qtype == kInt8 ? launch_gemm<float, kInt8, 3>(x, q, scale, y, m, n, k, st)
                        : launch_gemm<float, kE4M3, 3>(x, q, scale, y, m, n, k, st);
}
