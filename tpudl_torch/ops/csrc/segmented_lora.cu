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
// What the design does: one thread block cluster of kCluster CTAs per
// slot and row block (1 token row at decode; kPrefillRows of a prefill),
// so each page byte is read once by the cluster, as the TPU kernel forms
// coef once per grid cell. (The first design, a block per column tile
// that formed coef again in every one, read each slot's A pages 16 times
// at q_proj and ran 9.36 us there against a 0.655 us bound.)
// - CTA c of the cluster takes IN slice c and OUT slice c (kCluster
//   slices, each a multiple of 4 columns). It first asks L2 for its B
//   slice (prefetch), then forms its partial coef over its IN slice:
//   each warp takes two of the slot's live ranks (page != 0, in order)
//   and runs its lanes along the slice with 16-byte page loads (f32
//   float4; int8 char4, dequantised by the page's scale on load), one f32
//   accumulator per (row, rank), reduced across the warp by a fixed
//   butterfly.
// - After cluster.sync() every CTA reads the other CTAs' partials
//   through distributed shared memory and sums them in CTA-rank order:
//   every CTA forms the same coef, bit for bit, with no atomics.
// - Then it expands its OUT slice from the B pages, ranks in order (16
//   pages' loads in flight before their FMAs), applies scale, rounds once
//   and adds the base with the caller's rounding. A prefill block's rows
//   split over the threads so that all of them take columns.
// The launch is a plain <<<>>>: the cluster shape is the kernel's
// (__cluster_dims__). Page 0 is skipped; a prefill's row blocks each read
// the slot's pages once (from L2 after the first).
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using tpudl::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRank = 64;     // table width the kernel takes
constexpr int kCluster = 16;     // CTAs per slot and row block (non-portable above 8)
constexpr int kPrefillRows = 8;  // token rows per cluster when S > 1
// vec's bits: the IN side (x and the A pages) and the OUT side (the B
// pages, base and out) in 16-byte groups of 4 elements.
constexpr int kVecIn = 1, kVecOut = 2;

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
  const float sc = scales[page];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] *= sc;
}
__device__ __forceinline__ void store4(float* p, int64_t i, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p + i) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, int64_t i, const float (&v)[4]) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]), __floats2bfloat162_rn(v[2], v[3])};
  *reinterpret_cast<uint2*>(p + i) = *reinterpret_cast<const uint2*>(h);
}

// The slice [lo, hi) of n columns that CTA c of the cluster takes.
__device__ __forceinline__ void slice(int n, int c, int& lo, int& hi) {
  const int len = ((n + kCluster - 1) / kCluster + 3) & ~3;
  lo = min(n, c * len);
  hi = min(n, lo + len);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ROWS token rows of one slot per cluster: 1 (the decode step) or
// kPrefillRows.
template <typename T, typename P, int ROWS>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    seg_lora_cluster_kernel(const T* __restrict__ x, const P* __restrict__ pa,
                            const P* __restrict__ pb, const float* __restrict__ a_scale,
                            const float* __restrict__ b_scale, const int* __restrict__ table,
                            const float* __restrict__ scale, const T* __restrict__ base,
                            T* __restrict__ out, int S, int IN, int OUT, int R, int vec) {
  __shared__ float sPart[ROWS][kMaxRank];  // this CTA's partial coef
  __shared__ float sCoef[ROWS][kMaxRank];  // the cluster's coef
  __shared__ int sPage[kMaxRank];          // the live ranks' pages, in rank order
  __shared__ int sLive;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.z, s0 = blockIdx.y * ROWS;
  const int rows = min(ROWS, S - s0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    // The live ranks (page != 0), compacted in order by ballot.
    int n = 0;
    for (int r0 = 0; r0 < R; r0 += 32) {
      const int r = r0 + lane;
      const int page = r < R ? table[static_cast<int64_t>(b) * R + r] : 0;
      const uint32_t live = __ballot_sync(0xffffffffu, page != 0);
      if (page != 0) sPage[n + __popc(live & ((1u << lane) - 1u))] = page;
      n += __popc(live);
    }
    if (lane == 0) sLive = n;
  }
  __syncthreads();
  const int live = sLive;
  int i0, i1, o0, o1;
  slice(IN, c, i0, i1);
  slice(OUT, c, o0, o1);
  // Ask L2 for this CTA's B slice while the coef forms: 128-byte lines.
  {
    const int lines = ((o1 - o0) * static_cast<int>(sizeof(P)) + 127) / 128;
    for (int e = threadIdx.x; e < live * lines; e += kThreads) {
      const char* at = reinterpret_cast<const char*>(
                           pb + static_cast<int64_t>(sPage[e / lines]) * OUT + o0) +
                       128 * (e % lines);
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(at));
    }
  }

  // This CTA's partial coef over [i0, i1): two live ranks per warp (every
  // live rank's entry written, an empty slice's as 0).
  const T* xb = x + (static_cast<int64_t>(b) * S + s0) * IN;
  for (int k0 = 2 * warp; k0 < live; k0 += 2 * kWarps) {
    const int k1 = k0 + 1 < live ? k0 + 1 : k0;  // an odd last rank: itself twice
    const int p0 = sPage[k0], p1 = sPage[k1];
    const int64_t a0 = static_cast<int64_t>(p0) * IN, a1 = static_cast<int64_t>(p1) * IN;
    float acc0[ROWS], acc1[ROWS];
#pragma unroll
    for (int s = 0; s < ROWS; ++s) acc0[s] = acc1[s] = 0.0f;
    if (vec & kVecIn) {
#pragma unroll 4
      for (int i = i0 + 4 * lane; i < i1; i += 128) {
        float v0[4], v1[4];
        page_values4(pa, a_scale, a0 + i, p0, v0);
        page_values4(pa, a_scale, a1 + i, p1, v1);
#pragma unroll
        for (int s = 0; s < ROWS; ++s) {
          float xv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (s < rows) load4(xb, static_cast<int64_t>(s) * IN + i, xv);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc0[s] = fmaf(xv[j], v0[j], acc0[s]);
            acc1[s] = fmaf(xv[j], v1[j], acc1[s]);
          }
        }
      }
    } else {
      for (int i = i0 + lane; i < i1; i += 32) {
        const float v0 = page_value(pa, a_scale, a0 + i, p0);
        const float v1 = page_value(pa, a_scale, a1 + i, p1);
#pragma unroll
        for (int s = 0; s < ROWS; ++s) {
          const float xv = s < rows ? to_f32(xb[static_cast<int64_t>(s) * IN + i]) : 0.0f;
          acc0[s] = fmaf(xv, v0, acc0[s]);
          acc1[s] = fmaf(xv, v1, acc1[s]);
        }
      }
    }
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
        sPart[s][k0] = acc0[s];
        sPart[s][k1] = acc1[s];
      }
    }
  }

  // Every CTA's partials are written: sum them in CTA-rank order.
  cluster.sync();
  for (int e = threadIdx.x; e < ROWS * live; e += kThreads) {
    const int s = e / live, k = e % live;
    float part[kCluster];
#pragma unroll
    for (int q = 0; q < kCluster; ++q) part[q] = cluster.map_shared_rank(&sPart[s][k], q)[0];
    float acc = part[0];
#pragma unroll
    for (int q = 1; q < kCluster; ++q) acc += part[q];
    sCoef[s][k] = acc;
  }
  // Done with the other CTAs' shared memory (each waits for all before it
  // exits); coef visible to the block.
  cluster_arrive();
  __syncthreads();

  // delta over [o0, o1): a thread takes 4 columns (or 1, unaligned) and
  // kRowsPer of the block's rows, the live ranks in order.
  constexpr int kSplit = ROWS >= 4 ? 4 : 1, kRowsPer = ROWS / kSplit;
  constexpr int kColThreads = kThreads / kSplit;
  const int rg = threadIdx.x / kColThreads, ct = threadIdx.x % kColThreads;
  const int sr0 = rg * kRowsPer;
  const float sc = scale[b];
  const int width = (vec & kVecOut) ? 4 : 1;
  for (int col = o0 + width * ct; col < o1; col += width * kColThreads) {
    float acc[kRowsPer][4];
#pragma unroll
    for (int s = 0; s < kRowsPer; ++s) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[s][j] = 0.0f;
    }
    auto add = [&](int k, const float (&bv)[4]) {
#pragma unroll
      for (int s = 0; s < kRowsPer; ++s) {
        const float cf = sCoef[sr0 + s][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[s][j] = fmaf(cf, bv[j], acc[s][j]);
      }
    };
    auto values = [&](int k, float (&bv)[4]) {
      const int page = sPage[k];
      const int64_t at = static_cast<int64_t>(page) * OUT + col;
      if (vec & kVecOut) {
        page_values4(pb, b_scale, at, page, bv);
      } else {
        bv[0] = page_value(pb, b_scale, at, page);
        bv[1] = bv[2] = bv[3] = 0.0f;
      }
    };
    // Up to 16 pages' loads in flight before their FMAs (one L2 round
    // trip at rank 16).
    int k = 0;
    for (; k + 16 <= live; k += 16) {
      float bv[16][4];
#pragma unroll
      for (int u = 0; u < 16; ++u) values(k + u, bv[u]);
#pragma unroll
      for (int u = 0; u < 16; ++u) add(k + u, bv[u]);
    }
    for (; k + 4 <= live; k += 4) {
      float bv[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) values(k + u, bv[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) add(k + u, bv[u]);
    }
    for (; k < live; ++k) {
      float bv[4];
      values(k, bv);
      add(k, bv);
    }
#pragma unroll
    for (int s = 0; s < kRowsPer; ++s) {
      if (sr0 + s >= rows) continue;
      const int64_t o = (static_cast<int64_t>(b) * S + s0 + sr0 + s) * OUT + col;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // The delta rounded to T, then the caller's y + delta rounded again.
        v[j] = to_f32(tpudl::from_f32<T>(acc[s][j] * sc));
      }
      if (width == 4) {
        if (base != nullptr) {
          float bb[4];
          load4(base, o, bb);
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = bb[j] + v[j];
        }
        store4(out, o, v);
      } else {
        out[o] = tpudl::from_f32<T>(base == nullptr ? v[0] : to_f32(base[o]) + v[0]);
      }
    }
  }
  cluster_wait();
}

template <typename T, typename P, int ROWS>
int launch_rows(const void* x, const void* a, const void* b, const void* a_scale,
                const void* b_scale, const void* table, const void* scale, const void* base,
                void* out, int B, int S, int IN, int OUT, int R, int vec, cudaStream_t stream) {
  const auto kernel = seg_lora_cluster_kernel<T, P, ROWS>;
  static bool opted = false;
  if (kCluster > 8 && !opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = true;
  }
  const dim3 grid(static_cast<unsigned>(kCluster), static_cast<unsigned>((S + ROWS - 1) / ROWS),
                  static_cast<unsigned>(B));
  kernel<<<grid, kThreads, 0, stream>>>(
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
  return launch_rows<T, P, kPrefillRows>(x, a, b, a_scale, b_scale, table, scale, base, out, B,
                                         S, IN, OUT, R, vec, stream);
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
// 64. vec: bit 0 when IN is a multiple of 4 and x and a are 16-byte
// aligned; bit 1 when OUT is a multiple of 4 and b, base and out are.
extern "C" int tpudl_seg_lora(const void* x, const void* a, const void* b, const void* a_scale,
                              const void* b_scale, const void* table, const void* scale,
                              const void* base, void* out, int B, int S, int IN, int OUT, int R,
                              int vec, int dtype, int quantized, void* stream) {
  if (B <= 0 || S <= 0 || IN <= 0 || OUT <= 0 || R <= 0 || R > kMaxRank || B > 65535 ||
      (S + kPrefillRows - 1) / kPrefillRows > 65535) {
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
