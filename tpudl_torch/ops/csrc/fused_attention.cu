// Whole-row attention for Hopper (sm_90a), S <= 512: the forward and the
// backward.
//
// Replaces, in tpudl/ops/fused_attention.py:
//   _fwd_kernel (shared body _kernel_body), launched by _fused_fwd via
//   pl.pallas_call (site 12);
//   _bwd_kernel, launched by _fused_bwd via pl.pallas_call (site 13).
//
// Computes, on self-attention q, k, v [B, S, H, D] (the callers' layout:
// no transpose, no padding in device memory), with s = (q k^T) * scale in
// f32 and keep = kv < S && kvmask[b, kv] && (!causal || kv <= q):
//   forward:  m = max_kv s, l = sum_kv exp(s - m) over kept entries,
//             p = keep ? exp(s - m) / l : 0 (a row that keeps nothing: 0),
//             pd = dropkeep ? p / (1 - rate) : 0 (p without dropout),
//             o = round_T(pd) v, and for the backward the row statistic
//             lse = m + log(l) (MASK_VALUE for a row that keeps nothing);
//   backward: p = keep ? exp(s - lse) : 0, dp = dropkeep ? (do v^T) /
//             (1 - rate) : 0, delta = rowsum(dp * p),
//             ds = p * (dp - delta) * scale,
//             dq = round_T(ds) k, dk = round_T(ds)^T q,
//             dv = round_T(pd)^T do.
// The rounding points are the TPU kernel's: f32 logits and softmax, the
// probabilities normalized (and scaled for dropout) in f32 before they
// are rounded to v's type for P.V, delta summed in f32 from the f32 dp
// and p as the TPU kernel sums it, ds rounded to q's type before both
// its products, pd to do's type for dV. (delta taken instead as
// rowsum(do * o) from the bf16 o carries an error that is coherent over
// the row, and ds = p (dp - delta) magnifies it: the q and k gradients of
// a 2-layer BERT-base at seq 512 drifted 1.2-1.7x further from an f32
// oracle than the plain path's, on an H100 and in the plain versions on a
// CPU.)
// Dropout bits are the contract of philox.cuh at element index
// ((b * H + h) * S + q) * S + kv of the [B, H, S, S] tensor: the mask is
// flash's and hybrid_attention's for the same seed words.
//
// What bounds them on the H100, at BERT-base's seq-512 step ([32, 512,
// 12, 64] bf16, B H S^2 D = 6.44e9): the forward moves 100.7 MB (q, k, v
// in, o out: 30.0 us at 3.35 TB/s) for 4 x 6.44e9 operations (26.1 us at
// 989 TFLOP/s), so bytes; the backward does five products, 64.4 GFLOP
// (65.1 us), against 176 MB (53 us), so operations.
//
// The TPU kernel holds a head's whole [S, S] f32 score tile in VMEM; on
// this card that tile is 1 MB at S = 512 and fits no block. What the
// design does instead (a first version that is right, not yet fast):
// - Forward: a block of 4 warps owns 64 query rows of one (batch row,
//   head); each warp keeps 16 rows' accumulators in registers. The head's
//   kv tiles stream through shared memory (cp.async, two buffers deep)
//   three times: the row max, then the exp-sum under that max, then
//   P.V with the normalized probabilities — each row's full softmax
//   exactly, with no online rescaling of o, as the TPU computes it. The
//   logits are recomputed in each pass (three Q K^T products and one
//   P.V against the TPU's two): the forward is bound by bytes, and the
//   recompute reads K from L2.
// - Backward: two launches in stream order, so each accumulator has one
//   owner (no float atomics; the backward is bitwise repeatable). The dQ
//   launch: a block owns 64 query rows and streams the head's kv tiles
//   twice, first into delta = rowsum(dp * p) (the TPU kernel's row term;
//   the block writes it out), then into dq. The dK/dV launch: a block
//   owns 64 kv rows and streams the q, do, lse and delta tiles into dk
//   and dv. Both recompute p from the forward's row statistic. (One
//   launch of both roles would need delta before it: the dK/dV blocks
//   read every query row's, which only the dQ blocks form.)
// - Causal tiles past the diagonal are not visited; a tile that every
//   pair attends skips the per-element mask checks; ragged S is bounds
//   checks (rows past S load as zeros and never store).
// mma.sync fragments, cp.async and the mask and dropout predicates come
// from attention_tiles.cuh (shared with flash_attention.cu).
#include "attention_tiles.cuh"

namespace {

using namespace tpudl::attn;

// tpudl.ops.fused_attention.MAX_SEQ.
constexpr int kMaxSeq = 512;

__device__ __forceinline__ void seed_words(const Params& p, uint32_t& k0, uint32_t& k1) {
  k0 = k1 = 0;
  if (p.dropout) {
    k0 = static_cast<uint32_t>(p.seed[0]);
    k1 = static_cast<uint32_t>(p.seed[1]);
  }
}

// kv (or q) tiles of n rows that can reach a block whose own side starts
// at row0: all of them, or under causal masking those at or below the
// diagonal of the block's last row.
__device__ __forceinline__ int causal_tiles(const Params& p, int row0, int n) {
  const int tiles = (p.Skv + n - 1) / n;
  if (!p.causal) return tiles;
  const int last = min(row0 + kRows, p.Sq) - 1;
  return last < 0 ? 0 : min(tiles, last / n + 1);
}

// ---------------------------------------------------------------------------
// forward: block = (64 q rows, h, b); the kv tiles of N rows stream three
// times (max, exp-sum, P.V), two buffers deep across the passes.
// ---------------------------------------------------------------------------
template <typename T, int D, int N>
__global__ void __launch_bounds__(kThreads) whole_fwd_kernel(Params p) {
  using S = Smem<T, D, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kRows * S::ldd;  // [2][N][ldd]
  T* sV = sK + 2 * N * S::ldd;  // [2][N][ldd]
  T* sP = sV + 2 * N * S::ldd;  // f32 only
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int64_t off = static_cast<int64_t>(b) * p.Sq * p.H * D;
  const uint8_t* mrow = p.kvmask ? p.kvmask + static_cast<int64_t>(b) * p.Skv : nullptr;
  uint32_t k0, k1;
  seed_words(p, k0, k1);
  const int tiles = causal_tiles(p, q0, N);
  const int steps = 3 * tiles;  // pass 0: max; 1: exp-sum; 2: P.V
  load_rows<T, D>(sQ, S::ldd, static_cast<const T*>(p.q), off, p.H, h, q0, kRows, p.Sq);
  if (steps > 0) load_rows<T, D>(sK, S::ldd, k, off, p.H, h, 0, N, p.Skv);
  cp_async_commit();

  const int rw = warp * 16;  // this warp's first row in the block
  float acc[D / 8][4];
  zero(acc);
  // Per lane until the end of its pass, then reduced over the quad.
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.0f, 0.0f};
  for (int it = 0; it < steps; ++it) {
    const int pass = it / tiles, kv0 = (it % tiles) * N, buf = it & 1;
    if (it + 1 < steps) {
      const int nb = buf ^ 1, nkv0 = ((it + 1) % tiles) * N;
      load_rows<T, D>(sK + nb * N * S::ldd, S::ldd, k, off, p.H, h, nkv0, N, p.Skv);
      if ((it + 1) / tiles == 2) {
        load_rows<T, D>(sV + nb * N * S::ldd, S::ldd, v, off, p.H, h, nkv0, N, p.Skv);
      }
    }
    cp_async_commit();
    cp_async_wait_one();
    // The barrier that publishes this tile also tells whether it is whole.
    const bool full = whole_tile(p, q0, kRows, kv0, N, !block_mask_gap(p, mrow, kv0, N));
    const T* cK = sK + buf * N * S::ldd;
    float s[N / 8][4];
    zero(s);
    WarpMma<T, N / 8, D>::abt(sQ + rw * S::ldd, S::ldd, cK, S::ldd, s);
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
      }
    }
    const bool last = it % tiles == tiles - 1;
    if (pass == 0) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
      }
      if (last) {
        m[0] = quad_max(m[0]);
        m[1] = quad_max(m[1]);
      }
    } else if (pass == 1) {
      // Masked logits hold MASK_VALUE: exactly the entries at or below it.
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1;
          if (s[j][e] > kMaskValue) l[hf] += exp_t(s[j][e] - m[hf], T());
        }
      }
      if (last) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          l[hf] = quad_sum(l[hf]);
          if (!(l[hf] > 0.0f)) l[hf] = 1.0f;  // a row that keeps nothing
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hf = e >> 1;
          float pe = s[j][e] > kMaskValue ? exp_t(s[j][e] - m[hf], T()) / l[hf] : 0.0f;
          if (p.dropout && pe != 0.0f) {
            const int r = q0 + rw + g + 8 * hf, c = kv0 + 8 * j + 2 * t + (e & 1);
            pe = drop_keep(p, k0, k1, b, h, r, c) ? pe * p.inv_keep : 0.0f;
          }
          s[j][e] = pe;
        }
      }
      WarpMma<T, D / 8, N>::ab_frag(s, sP + rw * S::ldn, S::ldn, sV + buf * N * S::ldd, S::ldd,
                                    acc);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait_all();  // the (empty) last group
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + rw + g + 8 * hf;
    if (t == 0 && r < p.Sq) {
      // l is 1 where the row kept nothing (or there were no tiles).
      const float lsum = tiles > 0 ? l[hf] : 1.0f;
      p.lse_out[(static_cast<int64_t>(b) * p.H + h) * p.Sq + r] = m[hf] + logf(lsum);
    }
  }
  store_frag<T, D>(static_cast<T*>(p.o), off, p.H, h, q0 + rw, p.Sq, acc);
}

// ---------------------------------------------------------------------------
// backward, dQ launch: block = (64 q rows, h, b); the kv tiles of N rows
// stream twice, two buffers deep across the passes: pass 0 sums delta =
// rowsum(dp * p) and writes it for the dK/dV launch, pass 1 forms dq.
// ---------------------------------------------------------------------------
template <typename T, int D, int N>
__global__ void __launch_bounds__(kThreads) whole_dq_kernel(Params p) {
  using S = Smem<T, D, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sO = sQ + kRows * S::ldd;  // do
  T* sK = sO + kRows * S::ldd;  // [2][N][ldd]
  T* sV = sK + 2 * N * S::ldd;  // [2][N][ldd]
  T* sP = sV + 2 * N * S::ldd;  // f32 only
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int64_t off = static_cast<int64_t>(b) * p.Sq * p.H * D;
  const uint8_t* mrow = p.kvmask ? p.kvmask + static_cast<int64_t>(b) * p.Skv : nullptr;
  uint32_t k0, k1;
  seed_words(p, k0, k1);
  const int tiles = causal_tiles(p, q0, N);
  const int steps = 2 * tiles;  // pass 0: delta; 1: dq
  load_rows<T, D>(sQ, S::ldd, static_cast<const T*>(p.q), off, p.H, h, q0, kRows, p.Sq);
  load_rows<T, D>(sO, S::ldd, static_cast<const T*>(p.dout), off, p.H, h, q0, kRows, p.Sq);
  if (steps > 0) {
    load_rows<T, D>(sK, S::ldd, k, off, p.H, h, 0, N, p.Skv);
    load_rows<T, D>(sV, S::ldd, v, off, p.H, h, 0, N, p.Skv);
  }
  cp_async_commit();
  const int rw = warp * 16;
  float lse[2];
  int64_t row[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + rw + g + 8 * hf;
    row[hf] = (static_cast<int64_t>(b) * p.H + h) * p.Sq + r;
    lse[hf] = r < p.Sq ? p.lse[row[hf]] : 0.0f;
  }
  // Per lane until the end of pass 0, then summed over the quad.
  float dlt[2] = {0.0f, 0.0f};
  float dq[D / 8][4];
  zero(dq);
  for (int it = 0; it < steps; ++it) {
    const int pass = it / tiles, kv0 = (it % tiles) * N, buf = it & 1;
    if (it + 1 < steps) {
      const int nb = buf ^ 1, nkv0 = ((it + 1) % tiles) * N;
      load_rows<T, D>(sK + nb * N * S::ldd, S::ldd, k, off, p.H, h, nkv0, N, p.Skv);
      load_rows<T, D>(sV + nb * N * S::ldd, S::ldd, v, off, p.H, h, nkv0, N, p.Skv);
    }
    cp_async_commit();
    cp_async_wait_one();
    const bool full = whole_tile(p, q0, kRows, kv0, N, !block_mask_gap(p, mrow, kv0, N));
    const T* cK = sK + buf * N * S::ldd;
    float s[N / 8][4], dp[N / 8][4];
    zero(s);
    zero(dp);
    WarpMma<T, N / 8, D>::abt(sQ + rw * S::ldd, S::ldd, cK, S::ldd, s);
    WarpMma<T, N / 8, D>::abt(sO + rw * S::ldd, S::ldd, sV + buf * N * S::ldd, S::ldd, dp);
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
          if (pass == 0) {
            dlt[hf] += d * pe;
          } else {
            ds = pe * (d - dlt[hf]) * p.scale;
          }
        }
        s[j][e] = ds;
      }
    }
    if (pass == 0) {
      if (it == tiles - 1) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          dlt[hf] = quad_sum(dlt[hf]);
          if (t == 0 && q0 + rw + g + 8 * hf < p.Sq) p.delta_out[row[hf]] = dlt[hf];
        }
      }
    } else {
      WarpMma<T, D / 8, N>::ab_frag(s, sP + rw * S::ldn, S::ldn, cK, S::ldd, dq);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  cp_async_wait_all();
  store_frag<T, D>(static_cast<T*>(p.o), off, p.H, h, q0 + rw, p.Sq, dq);
}

// ---------------------------------------------------------------------------
// backward, dK/dV launch: block = (64 kv rows, h, b); the q, do, lse and
// delta tiles of N rows stream, two deep.
// ---------------------------------------------------------------------------
template <typename T, int D, int N>
__global__ void __launch_bounds__(kThreads) whole_dkv_kernel(Params p) {
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
  const int64_t off = static_cast<int64_t>(b) * p.Sq * p.H * D;
  const uint8_t* mrow = p.kvmask ? p.kvmask + static_cast<int64_t>(b) * p.Skv : nullptr;
  uint32_t k0, k1;
  seed_words(p, k0, k1);
  const int64_t row_off = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
  // q tiles [first, tiles): under causal masking a tile contributes iff
  // its last row reaches this block's first kv row (kv <= q).
  const int tiles = (p.Sq + N - 1) / N;
  const int first = p.causal ? kv0 / N : 0;
  auto prefetch = [&](int it, int buf) {
    const int qt0 = it * N;
    load_rows<T, D>(sQ + buf * N * S::ldd, S::ldd, q, off, p.H, h, qt0, N, p.Sq);
    load_rows<T, D>(sO + buf * N * S::ldd, S::ldd, dout, off, p.H, h, qt0, N, p.Sq);
    for (int i = threadIdx.x; i < 2 * N; i += blockDim.x) {
      const int r = qt0 + (i % N);
      const bool in = r < p.Sq;
      const float* src = (i < N ? p.lse : p.delta) + row_off + (in ? r : 0);
      cp_async4((i < N ? sLse : sDlt) + buf * N + (i % N), src, in ? 4 : 0);
    }
  };
  load_rows<T, D>(sK, S::ldd, static_cast<const T*>(p.k), off, p.H, h, kv0, kRows, p.Skv);
  load_rows<T, D>(sV, S::ldd, static_cast<const T*>(p.v), off, p.H, h, kv0, kRows, p.Skv);
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
    const bool full = kv_ok && qt0 + N <= p.Sq && (!p.causal || kv0 + kRows - 1 <= qt0);
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
        float pd = 0.0f, ds = 0.0f;
        if (full || attends(p, mrow, r, c)) {
          const float pe = exp_t(s[j][e] * p.scale - cLse[qi], T());
          float d = dp[j][e];
          pd = pe;
          if (p.dropout) {
            const bool kd = drop_keep(p, k0, k1, b, h, r, c);
            pd = kd ? pe * p.inv_keep : 0.0f;
            d = kd ? d * p.inv_keep : 0.0f;
          }
          ds = pe * (d - cDlt[qi]) * p.scale;
        }
        s[j][e] = pd;
        dp[j][e] = ds;
      }
    }
    WarpMma<T, D / 8, N>::ab_frag(s, sP + rw * S::ldn, S::ldn, cO, S::ldd, dv);
    WarpMma<T, D / 8, N>::ab_frag(dp, sP + rw * S::ldn, S::ldn, cQ, S::ldd, dk);
    __syncthreads();
  }
  cp_async_wait_all();
  store_frag<T, D>(static_cast<T*>(p.o2), off, p.H, h, kv0 + rw, p.Skv, dk);
  store_frag<T, D>(static_cast<T*>(p.o3), off, p.H, h, kv0 + rw, p.Skv, dv);
}

// The streamed tiles: 64 rows; the dK/dV role streams 32 at D = 128 (its
// two [16, D] accumulators already hold 128 f32 registers per thread).
template <int D> struct BwdTiles {
  static constexpr int nq = 64;
  static constexpr int nkv = D == 128 ? 32 : 64;
};

template <typename T, int D, int N>
size_t fwd_smem() {  // Q; K, V x 2; P
  using S = Smem<T, D, N>;
  return (kRows * S::ldd + 2 * 2 * N * S::ldd + S::pbuf) * sizeof(T);
}

template <typename T, int D>
size_t dq_smem() {  // Q, do; K, V x 2; dS
  using S = Smem<T, D, BwdTiles<D>::nq>;
  return (2 * kRows * S::ldd + 4 * BwdTiles<D>::nq * S::ldd + S::pbuf) * sizeof(T);
}

template <typename T, int D>
size_t dkv_smem() {  // K, V; Q, do x 2; P; lse, delta x 2
  using S = Smem<T, D, BwdTiles<D>::nkv>;
  return (2 * kRows * S::ldd + 4 * BwdTiles<D>::nkv * S::ldd + S::pbuf) * sizeof(T) +
         4 * BwdTiles<D>::nkv * sizeof(float);
}

// Above 48 KB only as opted-in dynamic shared memory; set once per kernel
// (before any graph capture: the first call of each runs eagerly).
template <typename Kernel>
int opt_in(Kernel kernel, size_t smem, bool& done) {
  if (done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  done = true;
  return 0;
}

template <typename T, int D>
int launch_d(bool backward, const Params& p, cudaStream_t stream) {
  const unsigned tiles = static_cast<unsigned>((p.Sq + kRows - 1) / kRows);
  const dim3 grid(tiles, static_cast<unsigned>(p.H), static_cast<unsigned>(p.B));
  if (backward) {
    // The dK/dV launch reads the delta the dQ launch writes: stream order.
    static bool opted_dq = false, opted_dkv = false;
    const size_t sdq = dq_smem<T, D>(), sdkv = dkv_smem<T, D>();
    constexpr int nq = BwdTiles<D>::nq, nkv = BwdTiles<D>::nkv;
    if (const int err = opt_in(whole_dq_kernel<T, D, nq>, sdq, opted_dq)) return err;
    if (const int err = opt_in(whole_dkv_kernel<T, D, nkv>, sdkv, opted_dkv)) return err;
    whole_dq_kernel<T, D, nq><<<grid, kThreads, sdq, stream>>>(p);
    if (const int err = static_cast<int>(cudaGetLastError())) return err;
    whole_dkv_kernel<T, D, nkv><<<grid, kThreads, sdkv, stream>>>(p);
  } else {
    static bool opted = false;
    const size_t smem = fwd_smem<T, D, 64>();
    if (const int err = opt_in(whole_fwd_kernel<T, D, 64>, smem, opted)) return err;
    whole_fwd_kernel<T, D, 64><<<grid, kThreads, smem, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(bool backward, int d, const Params& p, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_d<T, 32>(backward, p, stream);
    case 64:
      return launch_d<T, 64>(backward, p, stream);
    case 128:
      return launch_d<T, 128>(backward, p, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int launch(bool backward, int d, int dtype, const Params& p, void* stream) {
  if (p.B <= 0 || p.H <= 0 || p.Sq <= 0 || p.Sq > kMaxSeq || p.Skv != p.Sq || p.H > 65535 ||
      p.B > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case tpudl::kFloat32:
      return launch_t<float>(backward, d, p, st);
    case tpudl::kBFloat16:
      return launch_t<__nv_bfloat16>(backward, d, p, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: [b, s, h, d], contiguous, 16-byte aligned, of tpudl::DType
// `dtype`; 1 <= s <= 512; d in {32, 64, 128}. kvmask: [b, s] bool or null.
// seed: int64 [2] (read only when dropout != 0). lse: [b, h, s] f32, the
// row statistic the backward takes.
extern "C" int tpudl_fused_attn_fwd(const void* q, const void* k, const void* v,
                                    const void* kvmask, const void* seed, void* o, void* lse,
                                    int b, int s, int h, int d, int causal,
                                    float scale, uint32_t threshold, float inv_keep, int dropout,
                                    int dtype, void* stream) {
  Params p = make_params(q, k, v, kvmask, seed, b, s, s, h, causal, scale, threshold, inv_keep,
                         dropout);
  p.o = o;
  p.lse_out = static_cast<float*>(lse);
  return launch(false, d, dtype, p, stream);
}

// As tpudl_fused_attn_fwd; dout, dq, dk, dv: [b, s, h, d]; lse (the
// forward's): [b, h, s] f32; delta: [b, h, s] f32 scratch, written with
// rowsum(dp * p) by the first of the two launches and read by the second.
extern "C" int tpudl_fused_attn_bwd(const void* q, const void* k, const void* v,
                                    const void* kvmask, const void* seed, const void* dout,
                                    const void* lse, void* delta, void* dq, void* dk,
                                    void* dv, int b, int s, int h, int d, int causal, float scale,
                                    uint32_t threshold, float inv_keep, int dropout, int dtype,
                                    void* stream) {
  Params p = make_params(q, k, v, kvmask, seed, b, s, s, h, causal, scale, threshold, inv_keep,
                         dropout);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta_out = static_cast<float*>(delta);
  p.delta = p.delta_out;
  p.o = dq;
  p.o2 = dk;
  p.o3 = dv;
  return launch(true, d, dtype, p, stream);
}
