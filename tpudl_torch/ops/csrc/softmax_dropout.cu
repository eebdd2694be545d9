// Masked row softmax + attention dropout for Hopper (sm_90a): forward and
// backward over [B, H, Sq, Skv] attention logits.
//
// Replaces, in tpudl/ops/softmax_dropout.py:
//   _fwd_kernel, launched by _sd_fwd via pl.pallas_call;
//   _bwd_kernel, launched by _sd_bwd via pl.pallas_call.
//
// Computes, per row of Skv logits, in f32 registers:
//   s   = logit, or MASK_VALUE where the kv mask is 0 or (causal) the column
//         lies after the row's query position (bottom-right aligned);
//   p   = exp(s - max(s)), 0 where s <= MASK_VALUE; p /= sum(p) (a row with
//         nothing unmasked stays 0);
//   fwd: out = keep ? p / (1 - rate) : 0, in the output dtype;
//   bwd: g' = keep ? g / (1 - rate) : 0, dx = p * (g' - <g', p>), in the
//        logits' dtype, with the keep mask regenerated from the same seed.
// keep is the contract of philox.cuh: bits of the element's flat index in
// the unpadded tensor >= round(rate * 2^32).
//
// What bounds them on the H100: memory traffic. Per element the forward
// reads one logit and writes one probability (4 bytes in bf16) for a
// handful of f32 operations, one exp and a quarter of a Philox block (10
// rounds of two 32-bit multiplies); the backward reads the logit and the
// gradient and writes dx (6 bytes). On the BERT-base step ([256, 12, 128,
// 128] bf16, 12 calls each way per step) that is 201.3 MB forward and
// 302.0 MB backward: 60.1 us and 90.1 us at the 3.35 TB/s of an NVIDIA
// H100 80GB HBM3 at its 700 W limit (data sheet rate, not a measurement).
//
// What the design does about that:
// - One warp per row: a row of Skv <= 512 logits sits in the warp's
//   registers (4 consecutive columns per lane per 128-column chunk), so the
//   max and the sums are warp shuffles and nothing is staged in shared
//   memory. Each lane loads its 4 columns with one 8-byte (bf16) or 16-byte
//   (f32) access; a warp covers 256 or 512 contiguous bytes per access.
// - The dropout mask never touches device memory: each lane's 4 columns
//   are one Philox block (their flat index is a multiple of 4 whenever Skv
//   is), computed in registers. The backward redraws it from the seed
//   words, which both kernels read through a pointer from device memory.
// - No atomics and a fixed shuffle order: both kernels are bitwise
//   repeatable.
// Rows whose length is not a multiple of 4, or pointers not aligned to
// the 4-column access, take the scalar path (one Philox block per element).
// exp and the division are the accurate expf and IEEE division: this first
// version keeps the numerics of the f32 composite before it is made fast.
#include <float.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

using tpudl::from_f32;
using tpudl::to_f32;

// tpudl.ops.attention.MASK_VALUE: -0.7 * float32 max, formed in double and
// rounded once to f32, as the Python constant becomes an f32 operand.
constexpr float kMaskValue = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));
constexpr int kWarps = 4;

struct Rows {
  int64_t rows;      // B * H * Sq
  int64_t per_batch; // H * Sq rows per batch entry
  int sq;
  int skv;
  int causal_off;    // Skv - Sq: a row at query q attends to columns <= q + off
  int causal;
  const uint8_t* kvmask;  // [B, Skv], nonzero = attend; nullptr = no mask
  const int64_t* seed;    // [2] uint32 seed words held as int64
  uint32_t threshold;
  float scale;            // 1 / (1 - rate), rounded to f32
  int dropout;
};

template <typename T> struct Quad;
template <> struct Quad<float> { using raw = uint4; };
template <> struct Quad<__nv_bfloat16> { using raw = uint2; };

// 4 consecutive elements at p (aligned to their total size).
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
  using R = typename Quad<T>::raw;
  const R raw = __ldg(reinterpret_cast<const R*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = to_f32(e[j]);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]) {
  using R = typename Quad<T>::raw;
  R raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = from_f32<T>(v[j]);
  *reinterpret_cast<R*>(p) = raw;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Load the row's logits into s (masked entries as kMaskValue) and turn
// them into the normalised pre-dropout probabilities p. Lane `lane` owns
// columns 128 * c + 4 * lane + j.
template <typename TX, int C, bool VEC>
__device__ __forceinline__ void row_softmax(const TX* __restrict__ x, const Rows& r,
                                            int64_t row, int lane, float (&p)[C][4]) {
  const int64_t b = row / r.per_batch;
  const int q = static_cast<int>(row % r.sq);
  const TX* xr = x + row * r.skv;
  const uint8_t* mr = r.kvmask ? r.kvmask + b * r.skv : nullptr;
  float m = kMaskValue;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col0 = 128 * c + 4 * lane;
    if (VEC && col0 < r.skv) {
      load4(xr + col0, p[c]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) p[c][j] = col0 + j < r.skv ? to_f32(xr[col0 + j]) : kMaskValue;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + j;
      const bool masked = col >= r.skv || (mr && mr[col] == 0) ||
                          (r.causal && col > q + r.causal_off);
      if (masked) p[c][j] = kMaskValue;
      m = fmaxf(m, p[c][j]);
    }
  }
  m = warp_max(m);
  float l = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[c][j] = p[c][j] <= kMaskValue ? 0.0f : expf(p[c][j] - m);
      l += p[c][j];
    }
  }
  l = warp_sum(l);
  const float denom = l > 0.0f ? l : 1.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) p[c][j] = p[c][j] / denom;
  }
}

// keep[c][j] for the lane's columns of `row`, from the seed words.
template <int C, bool VEC>
__device__ __forceinline__ void row_keep(const Rows& r, int64_t row, int lane,
                                         bool (&keep)[C][4]) {
  const uint32_t k0 = static_cast<uint32_t>(r.seed[0]);
  const uint32_t k1 = static_cast<uint32_t>(r.seed[1]);
  const uint64_t base = static_cast<uint64_t>(row) * static_cast<uint64_t>(r.skv);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col0 = 128 * c + 4 * lane;
    if (col0 >= r.skv) {
#pragma unroll
      for (int j = 0; j < 4; ++j) keep[c][j] = false;
      continue;
    }
    if (VEC) {
      // Skv is a multiple of 4, so base + col0 is too: one block.
      const uint4 w = tpudl::philox_block((base + col0) >> 2, k0, k1);
      keep[c][0] = w.x >= r.threshold;
      keep[c][1] = w.y >= r.threshold;
      keep[c][2] = w.z >= r.threshold;
      keep[c][3] = w.w >= r.threshold;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        keep[c][j] = col0 + j < r.skv &&
                     tpudl::philox_bits(base + col0 + j, k0, k1) >= r.threshold;
      }
    }
  }
}

template <typename TX, typename TO, int C, bool VEC>
__global__ void __launch_bounds__(32 * kWarps)
    softmax_dropout_fwd_kernel(const TX* __restrict__ x, TO* __restrict__ out, Rows r) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= r.rows) return;
  float p[C][4];
  row_softmax<TX, C, VEC>(x, r, row, lane, p);
  if (r.dropout) {
    bool keep[C][4];
    row_keep<C, VEC>(r, row, lane, keep);
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) p[c][j] = keep[c][j] ? p[c][j] * r.scale : 0.0f;
    }
  }
  TO* orow = out + row * r.skv;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col0 = 128 * c + 4 * lane;
    if (VEC) {
      if (col0 < r.skv) store4(orow + col0, p[c]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (col0 + j < r.skv) orow[col0 + j] = from_f32<TO>(p[c][j]);
      }
    }
  }
}

template <typename TX, typename TG, int C, bool VEC>
__global__ void __launch_bounds__(32 * kWarps)
    softmax_dropout_bwd_kernel(const TX* __restrict__ x, const TG* __restrict__ g,
                               TX* __restrict__ dx, Rows r) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= r.rows) return;
  float p[C][4];
  row_softmax<TX, C, VEC>(x, r, row, lane, p);
  float gv[C][4];
  const TG* grow = g + row * r.skv;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col0 = 128 * c + 4 * lane;
    if (VEC && col0 < r.skv) {
      load4(grow + col0, gv[c]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[c][j] = col0 + j < r.skv ? to_f32(grow[col0 + j]) : 0.0f;
    }
  }
  if (r.dropout) {
    bool keep[C][4];
    row_keep<C, VEC>(r, row, lane, keep);
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) gv[c][j] = keep[c][j] ? gv[c][j] * r.scale : 0.0f;
    }
  }
  float dot = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dot += gv[c][j] * p[c][j];
  }
  dot = warp_sum(dot);
  TX* drow = dx + row * r.skv;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col0 = 128 * c + 4 * lane;
    float d[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) d[j] = p[c][j] * (gv[c][j] - dot);
    if (VEC) {
      if (col0 < r.skv) store4(drow + col0, d);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (col0 + j < r.skv) drow[col0 + j] = from_f32<TX>(d[j]);
      }
    }
  }
}

template <typename T>
bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T))) == 0;
}

template <typename TX, typename TO, int C>
int launch_fwd(const void* x, void* out, const Rows& r, cudaStream_t st) {
  const bool vec = r.skv % 4 == 0 && aligned4<TX>(x) && aligned4<TO>(out);
  const dim3 grid(static_cast<unsigned>((r.rows + kWarps - 1) / kWarps));
  const TX* xp = static_cast<const TX*>(x);
  TO* op = static_cast<TO*>(out);
  if (vec) {
    softmax_dropout_fwd_kernel<TX, TO, C, true><<<grid, 32 * kWarps, 0, st>>>(xp, op, r);
  } else {
    softmax_dropout_fwd_kernel<TX, TO, C, false><<<grid, 32 * kWarps, 0, st>>>(xp, op, r);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TG, int C>
int launch_bwd(const void* x, const void* g, void* dx, const Rows& r, cudaStream_t st) {
  const bool vec =
      r.skv % 4 == 0 && aligned4<TX>(x) && aligned4<TG>(g) && aligned4<TX>(dx);
  const dim3 grid(static_cast<unsigned>((r.rows + kWarps - 1) / kWarps));
  const TX* xp = static_cast<const TX*>(x);
  const TG* gp = static_cast<const TG*>(g);
  TX* dp = static_cast<TX*>(dx);
  if (vec) {
    softmax_dropout_bwd_kernel<TX, TG, C, true><<<grid, 32 * kWarps, 0, st>>>(xp, gp, dp, r);
  } else {
    softmax_dropout_bwd_kernel<TX, TG, C, false><<<grid, 32 * kWarps, 0, st>>>(xp, gp, dp, r);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TO>
int fwd_chunks(const void* x, void* out, const Rows& r, cudaStream_t st) {
  switch ((r.skv + 127) / 128) {
    case 1: return launch_fwd<TX, TO, 1>(x, out, r, st);
    case 2: return launch_fwd<TX, TO, 2>(x, out, r, st);
    case 3: return launch_fwd<TX, TO, 3>(x, out, r, st);
    case 4: return launch_fwd<TX, TO, 4>(x, out, r, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TX, typename TG>
int bwd_chunks(const void* x, const void* g, void* dx, const Rows& r, cudaStream_t st) {
  switch ((r.skv + 127) / 128) {
    case 1: return launch_bwd<TX, TG, 1>(x, g, dx, r, st);
    case 2: return launch_bwd<TX, TG, 2>(x, g, dx, r, st);
    case 3: return launch_bwd<TX, TG, 3>(x, g, dx, r, st);
    case 4: return launch_bwd<TX, TG, 4>(x, g, dx, r, st);
    default: return cudaErrorInvalidValue;
  }
}

bool make_rows(Rows* r, int64_t batch, int64_t heads, int sq, int skv, int causal,
               const void* kvmask, const void* seed, uint32_t threshold, float scale,
               int dropout) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || skv <= 0 || skv > 512 || seed == nullptr) {
    return false;
  }
  r->per_batch = heads * sq;
  r->rows = batch * r->per_batch;
  r->sq = sq;
  r->skv = skv;
  r->causal_off = skv - sq;
  r->causal = causal;
  r->kvmask = static_cast<const uint8_t*>(kvmask);
  r->seed = static_cast<const int64_t*>(seed);
  r->threshold = threshold;
  r->scale = scale;
  r->dropout = dropout;
  return (r->rows + kWarps - 1) / kWarps <= 0x7fffffff;
}

}  // namespace

// x: [batch, heads, sq, skv] contiguous logits of tpudl::DType x_dtype; out:
// the same shape in out_dtype; kvmask: [batch, skv] bytes (nonzero = attend)
// or null; seed: 2 int64 holding the uint32 seed words (read on the device).
// skv <= 512.
extern "C" int tpudl_softmax_dropout_fwd(const void* x, const void* kvmask, const void* seed,
                                         void* out, int64_t batch, int64_t heads, int sq,
                                         int skv, int causal, uint32_t threshold, float scale,
                                         int dropout, int x_dtype, int out_dtype,
                                         void* stream) {
  Rows r;
  if (!make_rows(&r, batch, heads, sq, skv, causal, kvmask, seed, threshold, scale, dropout)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const int combo = x_dtype * 2 + out_dtype;
  switch (combo) {
    case tpudl::kFloat32 * 2 + tpudl::kFloat32: return fwd_chunks<float, float>(x, out, r, st);
    case tpudl::kFloat32 * 2 + tpudl::kBFloat16: return fwd_chunks<float, bf16>(x, out, r, st);
    case tpudl::kBFloat16 * 2 + tpudl::kFloat32: return fwd_chunks<bf16, float>(x, out, r, st);
    case tpudl::kBFloat16 * 2 + tpudl::kBFloat16: return fwd_chunks<bf16, bf16>(x, out, r, st);
    default: return cudaErrorInvalidValue;
  }
}

// x, dx: [batch, heads, sq, skv] contiguous of x_dtype; g: the same shape in
// g_dtype (the forward output's dtype); the rest as the forward.
extern "C" int tpudl_softmax_dropout_bwd(const void* x, const void* kvmask, const void* seed,
                                         const void* g, void* dx, int64_t batch,
                                         int64_t heads, int sq, int skv, int causal,
                                         uint32_t threshold, float scale, int dropout,
                                         int x_dtype, int g_dtype, void* stream) {
  Rows r;
  if (!make_rows(&r, batch, heads, sq, skv, causal, kvmask, seed, threshold, scale, dropout)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const int combo = x_dtype * 2 + g_dtype;
  switch (combo) {
    case tpudl::kFloat32 * 2 + tpudl::kFloat32: return bwd_chunks<float, float>(x, g, dx, r, st);
    case tpudl::kFloat32 * 2 + tpudl::kBFloat16: return bwd_chunks<float, bf16>(x, g, dx, r, st);
    case tpudl::kBFloat16 * 2 + tpudl::kFloat32: return bwd_chunks<bf16, float>(x, g, dx, r, st);
    case tpudl::kBFloat16 * 2 + tpudl::kBFloat16: return bwd_chunks<bf16, bf16>(x, g, dx, r, st);
    default: return cudaErrorInvalidValue;
  }
}
