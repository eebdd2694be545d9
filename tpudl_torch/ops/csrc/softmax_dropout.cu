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
//   e   = exp(s - max(s)), 0 where s <= MASK_VALUE; l = sum(e) (a row with
//         nothing unmasked has l = 0 and stays 0);
//   fwd: out = keep ? e * (scale / l) : 0, in the output dtype, scale =
//        1 / (1 - rate) (1 without dropout);
//   bwd: p = e * (1 / l), g' = keep ? g * scale : 0, dx = p * (g' - <g', p>),
//        in the logits' dtype, with the keep mask regenerated from the seed.
// keep is the contract of philox.cuh: bits of the element's flat index in
// the unpadded tensor >= round(rate * 2^32).
//
// What bounds them on the H100: memory traffic, if the bytes keep coming
// and the issue slots keep up. Per element the forward reads one logit
// and writes one probability (4 bytes in bf16), the backward reads the
// logit and the gradient and writes dx (6 bytes). On the BERT-base step
// ([256, 12, 128, 128] bf16, 12 calls each way per step) that is 201.3 MB
// forward and 302.0 MB backward: 60.1 us and 90.1 us at the 3.35 TB/s of
// an NVIDIA H100 80GB HBM3 at its 700 W limit (data sheet rate, not a
// measurement). Keeping that rate wants ~18 KB in flight per SM at all
// times (3.35 TB/s times ~0.7 us of latency, over 132 SMs), and leaves
// ~25 instructions of issue per element, which an accurate expf, an IEEE
// division and a quarter of a textbook Philox block would already use up.
//
// What the design does about that:
// - Wide accesses, streamed: a lane owns runs of 16 bytes of logits (8
//   bf16 or 4 f32 columns) and loads and stores each run in one access
//   (the output and the gradient as wide in elements). A row takes L
//   lanes, L a power of two from 4 to 32, the fewest that cover Skv: at
//   Skv 128 in bf16 a half-warp, so a warp holds 2 rows side by side, and
//   the max and the sums are shuffles over the L lanes. A block walks
//   kPasses passes of contiguous rows, R rows a lane each pass (2 in the
//   forward, 1 in the backward, which holds the gradient too), and issues
//   the next pass's loads before this pass's math (two register buffers),
//   so one pass's Philox draw and math overlap the next pass's 1 KB a warp
//   (at BERT's shape) in flight. A persistent grid (one block per resident slot, walking a
//   contiguous or an interleaved range) was slower in every case timed.
// - Cheap arithmetic: exp is one FFMA and one MUFU.EX2 (ex2.approx.ftz) on
//   s * log2e - max * log2e, as the attention kernels do, and each row
//   takes one reciprocal, with the dropout scale folded into it. Against
//   the f32 composite (exp, then a division) this stays within one bf16
//   step in bf16 and 1e-5 in f32 (chip_smoke.py's FUSED_TOL, the card
//   tests' _sd_tol), as the whole-row attention forward does with the same
//   EX2. A masked entry is selected to exactly 0, so a fully masked row
//   writes 0.
// - The same Philox bits for fewer instructions: the round keys are formed
//   once per thread (philox.cuh's PhiloxKey; ptxas keeps them in uniform
//   registers), each product's halves come from one mul.wide.u32
//   (IMAD.WIDE.U32), and the counter's zero high words fold into the first
//   round. A run of 8 bf16 columns is 2 blocks; on rows whose length is
//   not a multiple of the run (the unaligned path) a run draws the blocks
//   of the aligned flat quads it touches (at most 3 for 8 columns) and
//   selects the words, so no element costs a whole block.
// - Little index and mask work: a block's rows are contiguous, so the
//   batch index and the query index are carried from pass to pass (one
//   division a block, and one a slot where a block enters a batch entry),
//   and a lane reads its columns of an entry's
//   kv-mask row once, as one word a run, into a bit mask; causal masking
//   is a compare against q + (Skv - Sq).
// - No atomics and a fixed shuffle order: both kernels are bitwise
//   repeatable.
// Rows whose bytes are not a multiple of 16 (or pointers not aligned to
// the run) take the unaligned path: the same runs, loaded and stored
// element by element.
#include <float.h>
#include <limits.h>

#include "common.cuh"
#include "philox.cuh"

namespace {

// tpudl.ops.attention.MASK_VALUE: -0.7 * float32 max, formed in double and
// rounded once to f32, as the Python constant becomes an f32 operand.
constexpr float kMaskValue = static_cast<float>(-0.7 * static_cast<double>(FLT_MAX));
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// Passes a block makes (a pass: kWarps warps' rows side by side).
constexpr int kPasses = 8;

struct Rows {
  int64_t batch;      // B
  int64_t per_batch;  // H * Sq rows per batch entry
  int64_t groups;     // passes per batch entry (a pass: a block's rows side by side)
  int64_t passes;     // batch * groups
  int q_step;         // rows per pass mod Sq: carries the query index
  int sq;
  int skv;
  int causal_off;     // Skv - Sq: a row at query q attends to columns <= q + off
  int causal;
  const uint8_t* kvmask;  // [B, Skv], nonzero = attend; nullptr = no mask
  const int64_t* seed;    // [2] uint32 seed words held as int64
  uint32_t threshold;
  float scale;            // 1 / (1 - rate), rounded to f32
  int dropout;
};

// How a launch lays rows on lanes: a lane owns C runs of E columns of a
// row that L lanes share, in R rows per pass.
template <typename TX_, int L_, int C_, int R_>
struct Geo {
  using TX = TX_;
  static constexpr int L = L_;
  static constexpr int C = C_;
  static constexpr int R = R_;
  static constexpr int E = 16 / static_cast<int>(sizeof(TX));  // columns a run
  static constexpr int N = C * E;                              // columns a lane
  static constexpr int RPW = 32 / L;                           // rows side by side
  static constexpr int RW = RPW * R;                           // rows a warp, a pass
  static constexpr int BW = kWarps * RW;                       // rows a block, a pass
  // Blocks an SM must hold: 8 (64 registers a thread) for one run a lane,
  // 4 (128) for the wide rows, whose lanes hold C runs of each operand.
  static constexpr int kMinBlocks = C == 1 ? 8 : 4;
  static_assert(L >= 4 && L <= 32 && (L & (L - 1)) == 0, "L lanes a row");
  static_assert(N <= 32, "a lane's columns fit one bit mask");
};

// E consecutive elements of T as 32-bit words.
template <typename T, int E>
struct Run {
  static constexpr int kWords = E * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[kWords];

  __device__ __forceinline__ float get(int j) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[j]);
    } else {
      return __uint_as_float((j & 1) ? (w[j >> 1] & 0xffff0000u) : (w[j >> 1] << 16));
    }
  }

  // v[0, E) narrowed to T (bf16 round to nearest even, as XLA's convert).
  __device__ __forceinline__ void set(const float* v) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int j = 0; j < E; ++j) w[j] = __float_as_uint(v[j]);
    } else {
#pragma unroll
      for (int i = 0; i < E / 2; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
  }
};

// The run at p, of which the first n elements lie in the tensor. VEC: n is
// 0 or E and p is aligned to the run's bytes (at most 16): one access per
// 16 bytes. Otherwise element by element. Elements not loaded are 0.
template <typename T, int E, bool VEC>
__device__ __forceinline__ void load_run(const T* __restrict__ p, int n, Run<T, E>& r) {
  constexpr int kW = Run<T, E>::kWords;
#pragma unroll
  for (int i = 0; i < kW; ++i) r.w[i] = 0u;
  if constexpr (VEC) {
    if (n > 0) {
      if constexpr (kW == 2) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
        r.w[0] = v.x;
        r.w[1] = v.y;
      } else {
#pragma unroll
        for (int i = 0; i < kW / 4; ++i) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
          r.w[4 * i] = v.x;
          r.w[4 * i + 1] = v.y;
          r.w[4 * i + 2] = v.z;
          r.w[4 * i + 3] = v.w;
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (j < n) {
        if constexpr (sizeof(T) == 4) {
          r.w[j] = __ldg(reinterpret_cast<const unsigned int*>(p) + j);
        } else {
          const uint32_t u = __ldg(reinterpret_cast<const unsigned short*>(p) + j);
          r.w[j >> 1] |= u << (16 * (j & 1));
        }
      }
    }
  }
}

template <typename T, int E, bool VEC>
__device__ __forceinline__ void store_run(T* __restrict__ p, int n, const Run<T, E>& r) {
  constexpr int kW = Run<T, E>::kWords;
  if constexpr (VEC) {
    if (n > 0) {
      if constexpr (kW == 2) {
        *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
      } else {
#pragma unroll
        for (int i = 0; i < kW / 4; ++i) {
          reinterpret_cast<uint4*>(p)[i] =
              make_uint4(r.w[4 * i], r.w[4 * i + 1], r.w[4 * i + 2], r.w[4 * i + 3]);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (j < n) {
        if constexpr (sizeof(T) == 4) {
          reinterpret_cast<unsigned int*>(p)[j] = r.w[j];
        } else {
          reinterpret_cast<unsigned short*>(p)[j] =
              static_cast<unsigned short>(r.w[j >> 1] >> (16 * (j & 1)));
        }
      }
    }
  }
}

// v[j] = keep(f0 + j) ? v[j] * f : 0 for the n (0 < n <= E) elements of a
// run at flat index f0. VEC: f0 is a multiple of 4 and n == E, so the run
// is E / 4 whole blocks. Otherwise the run draws the blocks of the aligned
// quads its n elements touch and selects each element's word.
template <int E, bool VEC>
__device__ __forceinline__ void drop_run(float* v, uint64_t f0, int n, float f,
                                         const tpudl::PhiloxKey& key, uint32_t threshold) {
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const uint4 w = tpudl::philox_block((f0 >> 2) + i, key);
      v[4 * i] = w.x >= threshold ? v[4 * i] * f : 0.0f;
      v[4 * i + 1] = w.y >= threshold ? v[4 * i + 1] * f : 0.0f;
      v[4 * i + 2] = w.z >= threshold ? v[4 * i + 2] * f : 0.0f;
      v[4 * i + 3] = w.w >= threshold ? v[4 * i + 3] * f : 0.0f;
    }
  } else {
    constexpr int kBlocks = E / 4 + 1;
    const int s0 = static_cast<int>(f0 & 3);
    uint32_t w[4 * kBlocks];
#pragma unroll
    for (int i = 0; i < kBlocks; ++i) {
      uint4 b = make_uint4(0u, 0u, 0u, 0u);
      if (4 * i < s0 + n) b = tpudl::philox_block((f0 >> 2) + i, key);
      w[4 * i] = b.x;
      w[4 * i + 1] = b.y;
      w[4 * i + 2] = b.z;
      w[4 * i + 3] = b.w;
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const uint32_t bits = s0 == 0 ? w[j] : s0 == 1 ? w[j + 1] : s0 == 2 ? w[j + 2] : w[j + 3];
      v[j] = bits >= threshold ? v[j] * f : 0.0f;
    }
  }
}

template <int L>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Bit j set where byte j of x is nonzero.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// Which of a lane's N columns of batch entry b attend by the kv mask and
// Skv: bit c * E + j for column c * L * E + col0 + j. VEC: each run's mask
// bytes in one access (the mask row is aligned to the run).
template <typename G, bool VEC>
__device__ __forceinline__ uint32_t attend_bits(const Rows& r, int b, int col0) {
  const uint8_t* mrow = r.kvmask ? r.kvmask + static_cast<int64_t>(b) * r.skv : nullptr;
  uint32_t valid = 0u;
#pragma unroll
  for (int c = 0; c < G::C; ++c) {
    const int col = c * G::L * G::E + col0;
    const int n = r.skv - col;
    uint32_t bits = n >= G::E ? (1u << G::E) - 1u : (n > 0 ? (1u << n) - 1u : 0u);
    if (mrow != nullptr && n > 0) {
      if constexpr (VEC && G::E == 8) {
        const uint2 m = __ldg(reinterpret_cast<const uint2*>(mrow + col));
        bits &= nonzero_bytes(m.x) | (nonzero_bytes(m.y) << 4);
      } else if constexpr (VEC) {
        bits &= nonzero_bytes(__ldg(reinterpret_cast<const unsigned int*>(mrow + col)));
      } else {
        uint32_t m = 0u;
#pragma unroll
        for (int j = 0; j < G::E; ++j) {
          if (j < n && mrow[col + j] != 0) m |= 1u << j;
        }
        bits &= m;
      }
    }
    valid |= bits << (c * G::E);
  }
  return valid;
}

// Where a lane is in its block's walk: the pass within the batch entry,
// its first slot's row (within the entry and in the tensor), the entry,
// each slot's query index and attend_bits of the entry.
template <typename G>
struct Walk {
  int64_t g;
  int64_t rin;
  int64_t row;
  int b;
  int q[G::R];
  uint32_t valid;
};

template <typename G, bool VEC>
__device__ __forceinline__ void enter(Walk<G>& w, const Rows& r, int b, int64_t g, int off,
                                      int col0) {
  w.g = g;
  w.b = b;
  w.rin = g * G::BW + off;
  w.row = static_cast<int64_t>(b) * r.per_batch + w.rin;
  if (r.causal) {
#pragma unroll
    for (int s = 0; s < G::R; ++s) {
      w.q[s] = static_cast<int>((w.rin + s * G::RPW) % r.sq);
    }
  } else {
#pragma unroll
    for (int s = 0; s < G::R; ++s) w.q[s] = 0;
  }
  // A walk steps one pass past its block's last; past the last batch
  // entry there is no kv-mask row to read (and that pass loads nothing).
  w.valid = b < r.batch ? attend_bits<G, VEC>(r, b, col0) : 0u;
}

// The next pass: BW rows on, or the next batch entry's first pass (every
// lane of the block crosses at once).
template <typename G, bool VEC>
__device__ __forceinline__ Walk<G> next(const Walk<G>& w, const Rows& r, int off, int col0) {
  Walk<G> n = w;
  if (w.g + 1 >= r.groups) {
    enter<G, VEC>(n, r, w.b + 1, 0, off, col0);
    return n;
  }
  n.g += 1;
  n.rin += G::BW;
  n.row += G::BW;
#pragma unroll
  for (int s = 0; s < G::R; ++s) {
    n.q[s] += r.q_step;
    if (n.q[s] >= r.sq) n.q[s] -= r.sq;
  }
  return n;
}

// Where a lane starts: block i walks passes [i kPasses, (i + 1) kPasses)
// of the P passes over all batch entries, a contiguous range of rows.
template <typename G, bool VEC>
struct Lane {
  int off;     // slot 0's row within a pass
  int col0;    // first column
  int passes;  // passes this block makes
  Walk<G> walk;

  __device__ __forceinline__ explicit Lane(const Rows& r) {
    const int lane = threadIdx.x & 31;
    off = (threadIdx.x >> 5) * G::RW + lane / G::L;
    col0 = (lane % G::L) * G::E;
    const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPasses;
    passes = r.passes - p0 < kPasses ? static_cast<int>(r.passes - p0) : kPasses;
    const int b = static_cast<int>(p0 / r.groups);
    enter<G, VEC>(walk, r, b, p0 - static_cast<int64_t>(b) * r.groups, off, col0);
  }
};

// Elements of slot s's run c that lie in the tensor (0 past the batch
// entry's rows or the row's end).
template <typename G>
__device__ __forceinline__ int run_len(const Rows& r, const Walk<G>& w, int col0, int s,
                                       int c) {
  if (w.rin + s * G::RPW >= r.per_batch) return 0;
  const int n = r.skv - (c * G::L * G::E + col0);
  return n < 0 ? 0 : (n > G::E ? G::E : n);
}

template <typename G, typename T, bool VEC>
__device__ __forceinline__ void load_pass(const T* __restrict__ base, const Rows& r,
                                          const Walk<G>& w, int col0,
                                          Run<T, G::E> (&buf)[G::R][G::C]) {
#pragma unroll
  for (int s = 0; s < G::R; ++s) {
    const T* p = base + (w.row + s * G::RPW) * r.skv + col0;
#pragma unroll
    for (int c = 0; c < G::C; ++c) {
      load_run<T, G::E, VEC>(p + c * G::L * G::E, run_len<G>(r, w, col0, s, c), buf[s][c]);
    }
  }
}

// The slots' logits -> e (unnormalised exp, 0 where masked) and each row's
// sum l, reduced over the row's L lanes.
template <typename G>
__device__ __forceinline__ void row_exp(const Rows& r, int col0, const Walk<G>& w,
                                        const Run<typename G::TX, G::E> (&xb)[G::R][G::C],
                                        float (&e)[G::R][G::N], float (&l)[G::R]) {
  float m[G::R];
#pragma unroll
  for (int s = 0; s < G::R; ++s) {
    const int lim = r.causal ? w.q[s] + r.causal_off - col0 : INT_MAX;
    m[s] = kMaskValue;
#pragma unroll
    for (int c = 0; c < G::C; ++c) {
#pragma unroll
      for (int j = 0; j < G::E; ++j) {
        const int i = c * G::E + j;
        const bool ok = ((w.valid >> i) & 1u) && c * G::L * G::E + j <= lim;
        e[s][i] = ok ? xb[s][c].get(j) : kMaskValue;
        m[s] = fmaxf(m[s], e[s][i]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < G::R; ++s) m[s] = group_max<G::L>(m[s]);
#pragma unroll
  for (int s = 0; s < G::R; ++s) {
    const float mk = m[s] * kLog2e;
    l[s] = 0.0f;
#pragma unroll
    for (int i = 0; i < G::N; ++i) {
      e[s][i] = e[s][i] <= kMaskValue ? 0.0f : ex2(fmaf(e[s][i], kLog2e, -mk));
      l[s] += e[s][i];
    }
  }
#pragma unroll
  for (int s = 0; s < G::R; ++s) l[s] = group_sum<G::L>(l[s]);
}

template <typename G, typename TO, bool VEC>
__device__ __forceinline__ void fwd_pass(TO* __restrict__ out, const Rows& r,
                                         const Lane<G, VEC>& ln,
                                         const Walk<G>& w,
                                         const Run<typename G::TX, G::E> (&xb)[G::R][G::C],
                                         const tpudl::PhiloxKey& key) {
  constexpr int E = G::E;
  float e[G::R][G::N];
  float l[G::R];
  row_exp<G>(r, ln.col0, w, xb, e, l);
  const float sc = r.dropout ? r.scale : 1.0f;
#pragma unroll
  for (int s = 0; s < G::R; ++s) {
    const float inv = l[s] > 0.0f ? sc / l[s] : 0.0f;
    const int64_t row = w.row + s * G::RPW;
#pragma unroll
    for (int c = 0; c < G::C; ++c) {
      const int n = run_len<G>(r, w, ln.col0, s, c);
      const int col = c * G::L * E + ln.col0;
      float* v = &e[s][c * E];
      if (r.dropout) {
        if (n > 0) {
          drop_run<E, VEC>(v, static_cast<uint64_t>(row) * r.skv + col, n, inv, key,
                           r.threshold);
        }
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j) v[j] *= inv;
      }
      Run<TO, E> o;
      o.set(v);
      store_run<TO, E, VEC>(out + row * r.skv + col, n, o);
    }
  }
}

template <typename TX, typename TO, int L, int C, int R, bool VEC>
__global__ void __launch_bounds__(kThreads, (Geo<TX, L, C, R>::kMinBlocks))
    softmax_dropout_fwd_kernel(const TX* __restrict__ x, TO* __restrict__ out, const Rows r) {
  using G = Geo<TX, L, C, R>;
  const Lane<G, VEC> ln(r);
  const tpudl::PhiloxKey key = tpudl::philox_key(static_cast<uint32_t>(r.seed[0]),
                                                 static_cast<uint32_t>(r.seed[1]));
  Run<TX, G::E> xa[R][C], xn[R][C];
  Walk<G> w = ln.walk;
  if (ln.passes > 0) load_pass<G, TX, VEC>(x, r, w, ln.col0, xa);
  // Two buffers in turn: the next pass's loads are issued before this
  // pass's math.
#pragma unroll 1
  for (int it = 0; it < ln.passes; it += 2) {
    const Walk<G> w1 = next<G, VEC>(w, r, ln.off, ln.col0);
    if (it + 1 < ln.passes) load_pass<G, TX, VEC>(x, r, w1, ln.col0, xn);
    fwd_pass<G, TO, VEC>(out, r, ln, w, xa, key);
    if (it + 1 >= ln.passes) break;
    w = next<G, VEC>(w1, r, ln.off, ln.col0);
    if (it + 2 < ln.passes) load_pass<G, TX, VEC>(x, r, w, ln.col0, xa);
    fwd_pass<G, TO, VEC>(out, r, ln, w1, xn, key);
  }
}

template <typename G, typename TG, bool VEC>
__device__ __forceinline__ void bwd_pass(typename G::TX* __restrict__ dx, const Rows& r,
                                         const Lane<G, VEC>& ln, const Walk<G>& w,
                                         const Run<typename G::TX, G::E> (&xb)[G::R][G::C],
                                         const Run<TG, G::E> (&gb)[G::R][G::C],
                                         const tpudl::PhiloxKey& key) {
  constexpr int E = G::E;
  float e[G::R][G::N];
  float l[G::R];
  row_exp<G>(r, ln.col0, w, xb, e, l);
  float gs[G::R][G::N];
  float dot[G::R];
#pragma unroll
  for (int s = 0; s < G::R; ++s) {
    const float inv = l[s] > 0.0f ? 1.0f / l[s] : 0.0f;
    const int64_t row = w.row + s * G::RPW;
    dot[s] = 0.0f;
#pragma unroll
    for (int c = 0; c < G::C; ++c) {
      float* g = &gs[s][c * E];
#pragma unroll
      for (int j = 0; j < E; ++j) g[j] = gb[s][c].get(j);
      const int n = run_len<G>(r, w, ln.col0, s, c);
      if (r.dropout && n > 0) {
        drop_run<E, VEC>(g, static_cast<uint64_t>(row) * r.skv + c * G::L * E + ln.col0, n,
                         r.scale, key, r.threshold);
      }
#pragma unroll
      for (int j = 0; j < E; ++j) {
        e[s][c * E + j] *= inv;
        dot[s] = fmaf(g[j], e[s][c * E + j], dot[s]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < G::R; ++s) dot[s] = group_sum<G::L>(dot[s]);
#pragma unroll
  for (int s = 0; s < G::R; ++s) {
    const int64_t row = w.row + s * G::RPW;
#pragma unroll
    for (int c = 0; c < G::C; ++c) {
      float d[E];
#pragma unroll
      for (int j = 0; j < E; ++j) d[j] = e[s][c * E + j] * (gs[s][c * E + j] - dot[s]);
      Run<typename G::TX, E> o;
      o.set(d);
      const int col = c * G::L * E + ln.col0;
      store_run<typename G::TX, E, VEC>(dx + row * r.skv + col, run_len<G>(r, w, ln.col0, s, c),
                                        o);
    }
  }
}

template <typename TX, typename TG, int L, int C, int R, bool VEC>
__global__ void __launch_bounds__(kThreads, (Geo<TX, L, C, R>::kMinBlocks))
    softmax_dropout_bwd_kernel(const TX* __restrict__ x, const TG* __restrict__ g,
                               TX* __restrict__ dx, const Rows r) {
  using G = Geo<TX, L, C, R>;
  const Lane<G, VEC> ln(r);
  const tpudl::PhiloxKey key = tpudl::philox_key(static_cast<uint32_t>(r.seed[0]),
                                                 static_cast<uint32_t>(r.seed[1]));
  Run<TX, G::E> xa[R][C], xn[R][C];
  Run<TG, G::E> ga[R][C], gn[R][C];
  Walk<G> w = ln.walk;
  if (ln.passes > 0) {
    load_pass<G, TX, VEC>(x, r, w, ln.col0, xa);
    load_pass<G, TG, VEC>(g, r, w, ln.col0, ga);
  }
#pragma unroll 1
  for (int it = 0; it < ln.passes; it += 2) {
    const Walk<G> w1 = next<G, VEC>(w, r, ln.off, ln.col0);
    if (it + 1 < ln.passes) {
      load_pass<G, TX, VEC>(x, r, w1, ln.col0, xn);
      load_pass<G, TG, VEC>(g, r, w1, ln.col0, gn);
    }
    bwd_pass<G, TG, VEC>(dx, r, ln, w, xa, ga, key);
    if (it + 1 >= ln.passes) break;
    w = next<G, VEC>(w1, r, ln.off, ln.col0);
    if (it + 2 < ln.passes) {
      load_pass<G, TX, VEC>(x, r, w, ln.col0, xa);
      load_pass<G, TG, VEC>(g, r, w, ln.col0, ga);
    }
    bwd_pass<G, TG, VEC>(dx, r, ln, w1, xn, gn, key);
  }
}

template <typename T>
bool aligned_run(const void* p, int elems) {
  const int bytes = elems * static_cast<int>(sizeof(T));
  return reinterpret_cast<uintptr_t>(p) % (bytes < 16 ? bytes : 16) == 0;
}

// About kPasses passes a block, so a block's set-up (its kv-mask bits, the
// round keys) is paid once for several passes and the card sees many
// short blocks (a persistent grid of one block per resident slot was
// slower in every variant timed, PERF.md §6).
unsigned plan(Rows* r, int64_t batch, int bw) {
  r->groups = (r->per_batch + bw - 1) / bw;
  r->passes = batch * r->groups;
  r->q_step = static_cast<int>(bw % r->sq);
  const int64_t grid = (r->passes + kPasses - 1) / kPasses;
  return grid > 0x7fffffff ? 0u : static_cast<unsigned>(grid);
}

template <typename TX, typename TO, int L, int C, int R>
int launch_fwd(const void* x, void* out, Rows r, int64_t batch, cudaStream_t st) {
  using G = Geo<TX, L, C, R>;
  const bool vec = r.skv % G::E == 0 && aligned_run<TX>(x, G::E) &&
                   aligned_run<TO>(out, G::E) && aligned_run<uint8_t>(r.kvmask, G::E);
  const TX* xp = static_cast<const TX*>(x);
  TO* op = static_cast<TO*>(out);
  const unsigned grid = plan(&r, batch, G::BW);
  if (grid == 0) return cudaErrorInvalidValue;
  if (vec) {
    softmax_dropout_fwd_kernel<TX, TO, L, C, R, true><<<grid, kThreads, 0, st>>>(xp, op, r);
  } else {
    softmax_dropout_fwd_kernel<TX, TO, L, C, R, false><<<grid, kThreads, 0, st>>>(xp, op, r);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TG, int L, int C, int R>
int launch_bwd(const void* x, const void* g, void* dx, Rows r, int64_t batch, cudaStream_t st) {
  using G = Geo<TX, L, C, R>;
  const bool vec = r.skv % G::E == 0 && aligned_run<TX>(x, G::E) &&
                   aligned_run<TG>(g, G::E) && aligned_run<TX>(dx, G::E) &&
                   aligned_run<uint8_t>(r.kvmask, G::E);
  const TX* xp = static_cast<const TX*>(x);
  const TG* gp = static_cast<const TG*>(g);
  TX* dp = static_cast<TX*>(dx);
  const unsigned grid = plan(&r, batch, G::BW);
  if (grid == 0) return cudaErrorInvalidValue;
  if (vec) {
    softmax_dropout_bwd_kernel<TX, TG, L, C, R, true><<<grid, kThreads, 0, st>>>(xp, gp, dp, r);
  } else {
    softmax_dropout_bwd_kernel<TX, TG, L, C, R, false><<<grid, kThreads, 0, st>>>(xp, gp, dp, r);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fewest lanes a row (a power of two, 4-32) whose 16-byte runs cover
// Skv; past 32 lanes, C runs a lane. Rows of one run a lane take two rows
// a pass in the forward, one in the backward (which holds the gradient
// too).
template <typename TX, typename TO>
int fwd_geo(const void* x, void* out, const Rows& r, int64_t batch, cudaStream_t st) {
  constexpr int E = 16 / static_cast<int>(sizeof(TX));
  const int runs = (r.skv + E - 1) / E;
  if (runs <= 4) return launch_fwd<TX, TO, 4, 1, 2>(x, out, r, batch, st);
  if (runs <= 8) return launch_fwd<TX, TO, 8, 1, 2>(x, out, r, batch, st);
  if (runs <= 16) return launch_fwd<TX, TO, 16, 1, 2>(x, out, r, batch, st);
  if (runs <= 32) return launch_fwd<TX, TO, 32, 1, 2>(x, out, r, batch, st);
  if (runs <= 64) return launch_fwd<TX, TO, 32, 2, 1>(x, out, r, batch, st);
  if constexpr (E == 4) {
    if (runs <= 96) return launch_fwd<TX, TO, 32, 3, 1>(x, out, r, batch, st);
    if (runs <= 128) return launch_fwd<TX, TO, 32, 4, 1>(x, out, r, batch, st);
  }
  return cudaErrorInvalidValue;
}

template <typename TX, typename TG>
int bwd_geo(const void* x, const void* g, void* dx, const Rows& r, int64_t batch,
            cudaStream_t st) {
  constexpr int E = 16 / static_cast<int>(sizeof(TX));
  const int runs = (r.skv + E - 1) / E;
  if (runs <= 4) return launch_bwd<TX, TG, 4, 1, 1>(x, g, dx, r, batch, st);
  if (runs <= 8) return launch_bwd<TX, TG, 8, 1, 1>(x, g, dx, r, batch, st);
  if (runs <= 16) return launch_bwd<TX, TG, 16, 1, 1>(x, g, dx, r, batch, st);
  if (runs <= 32) return launch_bwd<TX, TG, 32, 1, 1>(x, g, dx, r, batch, st);
  if (runs <= 64) return launch_bwd<TX, TG, 32, 2, 1>(x, g, dx, r, batch, st);
  if constexpr (E == 4) {
    if (runs <= 96) return launch_bwd<TX, TG, 32, 3, 1>(x, g, dx, r, batch, st);
    if (runs <= 128) return launch_bwd<TX, TG, 32, 4, 1>(x, g, dx, r, batch, st);
  }
  return cudaErrorInvalidValue;
}

bool make_rows(Rows* r, int64_t batch, int64_t heads, int sq, int skv, int causal,
               const void* kvmask, const void* seed, uint32_t threshold, float scale,
               int dropout) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || skv <= 0 || skv > 512 || seed == nullptr) {
    return false;
  }
  r->batch = batch;
  r->per_batch = heads * sq;
  r->sq = sq;
  r->skv = skv;
  r->causal_off = skv - sq;
  r->causal = causal;
  r->kvmask = static_cast<const uint8_t*>(kvmask);
  r->seed = static_cast<const int64_t*>(seed);
  r->threshold = threshold;
  r->scale = scale;
  r->dropout = dropout;
  return true;
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
    case tpudl::kFloat32 * 2 + tpudl::kFloat32: return fwd_geo<float, float>(x, out, r, batch, st);
    case tpudl::kFloat32 * 2 + tpudl::kBFloat16: return fwd_geo<float, bf16>(x, out, r, batch, st);
    case tpudl::kBFloat16 * 2 + tpudl::kFloat32: return fwd_geo<bf16, float>(x, out, r, batch, st);
    case tpudl::kBFloat16 * 2 + tpudl::kBFloat16: return fwd_geo<bf16, bf16>(x, out, r, batch, st);
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
    case tpudl::kFloat32 * 2 + tpudl::kFloat32:
      return bwd_geo<float, float>(x, g, dx, r, batch, st);
    case tpudl::kFloat32 * 2 + tpudl::kBFloat16:
      return bwd_geo<float, bf16>(x, g, dx, r, batch, st);
    case tpudl::kBFloat16 * 2 + tpudl::kFloat32:
      return bwd_geo<bf16, float>(x, g, dx, r, batch, st);
    case tpudl::kBFloat16 * 2 + tpudl::kBFloat16:
      return bwd_geo<bf16, bf16>(x, g, dx, r, batch, st);
    default: return cudaErrorInvalidValue;
  }
}
