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
// 989 TFLOP/s), so bytes. The backward moves 176 MB (q, k, v, do in; dq,
// dk, dv out: 52.8 us) and does five products: 64.4 GFLOP (65.1 us) when
// every pair attends, so operations; under the step's padding mask
// (lengths uniform in [S/2, S]) about 3/4 of the pairs attend, 48 GFLOP
// (49 us), so bytes (52.83 us, the figure PERF.md's row 13 gives).
//
// The TPU kernel holds a head's whole [S, S] f32 score tile in VMEM; on
// this card that tile is 1 MB at S = 512 and fits no block. What the
// design does instead:
// - Forward, bf16: a Hopper kernel (attention_hopper.cuh). A block of 128
//   query rows (two consumer warpgroups of 64) and a producer warpgroup
//   that loads the tiles by TMA; S = Q K^T and O += P V are wgmma. Two
//   sweeps over the head's kv tiles: the first takes each row's max and
//   exp-sum (an online max per lane, l rescaled, no o), the second forms
//   p = exp(s - m) / l, drops it and runs P.V — each row's softmax
//   normalised in f32 before its bf16 rounding, as the TPU computes it,
//   with 2 Q K^T products and 1 P.V. At D <= 64 the head's K and V (S <=
//   512) land in shared memory once and stay; at D = 128 they stream
//   through a ring. One Philox block serves four elements of the dropout
//   draw.
// - Forward, f32 (CUDA cores, never TF32): a block of 4 warps owns 64
//   query rows; the kv tiles stream through shared memory (cp.async,
//   two buffers deep) three times: the row max, the exp-sum, then P.V.
// - Backward: two launches in stream order, so each accumulator has one
//   owner (no float atomics; the backward is bitwise repeatable). (One
//   launch of both roles would need delta before it: the dK/dV blocks
//   read every query row's, which only the dQ blocks form.) Both
//   recompute p from the forward's row statistic.
//   bf16, Hopper kernels on the forward's machinery. They replace the
//   first design's mma.sync kernels (4 warps, cp.async two deep, a
//   __syncthreads a tile, a Philox block per element drawn three times),
//   which ran 2458.79 us at the step shape with dropout. The dQ launch
//   (whole_dq_tma_kernel): 128 query rows, Q and dO loaded once, two
//   sweeps over the live kv tiles (resident at D <= 64), the first
//   forming and writing delta = rowsum(dp * p) (the TPU kernel's row
//   term), the second dq += round(ds) K; the producer warps draw each
//   tile's keep bits once (four elements per Philox block) into shared
//   memory during the first sweep, and write them to device memory in
//   row order. The dK/dV launch is attention_dkv.cuh's kernel, shared
//   with flash: a block owns kv rows, streams Q, dO, lse and delta
//   through a TMA ring, its producer transposes those keep bits into the
//   consumers' order (no second draw), and it writes zeros without a
//   product where the padding mask leaves its rows dead. The design's
//   cost beyond the bound: delta and the keep bits (a bit per pair)
//   written and read, and the dQ launch's second S and dP.
//   f32: the first design's two launches (CUDA cores).
// - Causal tiles past the diagonal are not visited; a tile that every
//   pair attends skips the per-element mask checks; ragged S is bounds
//   checks (rows past S load as zeros and never store).
// The f32 kernels take mma.sync fragments (their f32 form), cp.async and
// the mask and dropout predicates from attention_tiles.cuh (shared with
// flash_attention.cu).
#include <type_traits>

#include "attention_dkv.cuh"

namespace {

using namespace tpudl::attn;
namespace hopper = tpudl::hopper;

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
// forward, bf16: the Hopper kernel (attention_hopper.cuh). block = (128 q
// rows, h, b), longest first under causal masking; two sweeps over the
// head's kv tiles of N rows. Sweep 1: each lane keeps the running max of
// its own columns and their exp-sum, rescaling only l (no o); the quad
// then forms the row's m and l. Sweep 2: p = exp(s - m) / l in f32,
// dropped and scaled by 1 / (1 - rate), rounded to bf16 into P.V: the
// TPU kernel's rounding points, with 2 Q K^T products and 1 P.V.
// kResident (D <= 64): the head's whole K and V (S <= 512: 4 tiles) land
// once per block and stay, so sweep 2 reads nothing from L2; else the
// tiles stream through a ring of kSlots, K in sweep 1, K and V in sweep 2.
// With dropout, producer warps 1-3 draw the keep bits of every tile
// (draw_drop_bits: one Philox block per four elements) while the
// consumers run sweep 1; sweep 2 only tests them.
// ---------------------------------------------------------------------------
template <int D, int N, int kSlots, bool kResident>
__global__ void __launch_bounds__(hopper::kThreads, 1)
    whole_fwd_kernel(const Params p, const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap) {
  using namespace tpudl::hopper;
  constexpr int kTiles = kMaxSeq / N;  // kv tiles of the longest row
  using Pl = Plan<D, N, kSlots, kTiles>;
  static_assert(!kResident || kSlots >= kTiles, "resident: every kv tile has its slot");
  extern __shared__ __align__(1024) uint8_t hopper_smem[];
  const Shared<D, N, kSlots, kTiles> sm(hopper_smem);
  const int h = blockIdx.y, b = blockIdx.z;
  const int qblk = p.causal ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int q0 = qblk * kBlockRows;
  const uint8_t* mrow = p.kvmask ? p.kvmask + static_cast<int64_t>(b) * p.Skv : nullptr;
  // Dropout bits: all four producer warps once the loads are issued
  // (resident), or warps 1-3 beside the ring's loader.
  constexpr int kDrawWarps = kResident ? 4 : 3;
  block_setup(sm, p, mrow, kDrawWarps);
  const int tiles = reach_tiles(p, q0, kBlockRows, N);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(sm.qbar(), Pl::kQBytes);
      load_tile<D>(sm.q(), kBlockRows, qmap, sm.qbar(), b, h, q0);
      if constexpr (kResident) {
        // Every K tile first (sweep 1 needs only K), then every V tile.
        for (int t = 0; t < tiles; ++t) {
          if (!tile_bit(sm.live(), t)) continue;
          mbar_expect_tx(sm.kfull(t), Pl::kTileBytes);
          load_tile<D>(sm.k(t), N, kmap, sm.kfull(t), b, h, t * N);
        }
        for (int t = 0; t < tiles; ++t) {
          if (!tile_bit(sm.live(), t)) continue;
          mbar_expect_tx(sm.vfull(t), Pl::kTileBytes);
          load_tile<D>(sm.v(t), N, vmap, sm.vfull(t), b, h, t * N);
        }
      } else {
        int i = 0;
        for (int sweep = 0; sweep < 2; ++sweep) {
          for (int t = 0; t < tiles; ++t) {
            if (!tile_bit(sm.live(), t)) continue;
            const int slot = i % kSlots, round = i / kSlots;
            if (round > 0) mbar_wait(sm.empty(slot), (round - 1) & 1);
            mbar_expect_tx(sm.kfull(slot), (1 + sweep) * Pl::kTileBytes);
            load_tile<D>(sm.k(slot), N, kmap, sm.kfull(slot), b, h, t * N);
            if (sweep) load_tile<D>(sm.v(slot), N, vmap, sm.kfull(slot), b, h, t * N);
            ++i;
          }
        }
      }
    }
    if (p.dropout && threadIdx.x >= hopper::kThreads - 32 * kDrawWarps) {
      // The dropout keep bits, while the consumers run sweep 1.
      __syncwarp();
      uint32_t k0, k1;
      seed_words(p, k0, k1);
      draw_drop_bits(sm, p, b, h, q0, tiles, k0, k1, kDrawWarps);
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int r0 = q0 + wg * kWgRows;               // the warpgroup's rows
    const int row = r0 + 16 * warp + (lane >> 2);  // the thread's: row, row + 8
    const int mine = reach_tiles(p, r0, kWgRows, N);
    // The step counter of the ring (stream mode) and the hand-back of a
    // slot (every consumer warp, once the slot's products are done).
    int i = 0;
    auto slot_of = [&](int t) { return kResident ? t : i % kSlots; };
    auto parity_of = [&]() -> uint32_t { return kResident ? 0u : (i / kSlots) & 1; };
    auto release = [&](int slot) {
      if constexpr (!kResident) {
        __syncwarp();
        if (lane == 0) mbar_arrive(sm.empty(slot));
      }
      ++i;
    };
    mbar_wait(sm.qbar(), 0);
    // Sweep 1: per lane, the running max of its columns and their
    // exp-sum under it.
    float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.0f, 0.0f};
    for (int t = 0; t < tiles; ++t) {
      if (!tile_bit(sm.live(), t)) continue;
      const int slot = slot_of(t);
      mbar_wait(sm.kfull(slot), parity_of());
      if (t < mine) {
        const int kv0 = t * N;
        // A fresh array per Q K^T: no earlier value to carry into the
        // products' registers.
        float s[N / 2];
        qk<D, N>(s, sm.q(), sm.k(slot), wg);
        wgmma_wait_all();
        reg_fence(s);
        const bool whole = tile_whole(p, tile_bit(sm.gap(), t), r0, kv0, N);
        float mt[2] = {m[0], m[1]}, ls[2];
        if (whole) {
          tile_max<N, true>(s, p.scale, mt);
        } else {
          mask_tile<N>(s, p, mrow, row, kv0);
          tile_max<N, false>(s, p.scale, mt);
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          l[hf] *= ex2((m[hf] - mt[hf]) * kLog2e);
          m[hf] = mt[hf];
        }
        if (whole) {
          tile_exp<N, true>(s, p.scale, m, ls);
        } else {
          tile_exp<N, false>(s, p.scale, m, ls);
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) l[hf] += ls[hf];
      }
      release(slot);
    }
    // The row's m and l over the quad; l = 1 for a row that keeps nothing.
    float scale_row[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float mr = quad_max(m[hf]);
      l[hf] = quad_sum(l[hf] * ex2((m[hf] - mr) * kLog2e));
      if (!(l[hf] > 0.0f)) l[hf] = 1.0f;
      m[hf] = mr;
      scale_row[hf] = p.dropout ? p.inv_keep / l[hf] : 1.0f / l[hf];
    }
    // Sweep 2: the normalised, dropped probabilities into P.V.
    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.0f;
    auto next_live = [&](int t) {
      while (t < mine && !tile_bit(sm.live(), t)) ++t;
      return t;
    };
    for (int t = next_live(0); t < mine; t = next_live(t + 1)) {
      const int slot = slot_of(t), kv0 = t * N;
      const uint32_t parity = parity_of();
      mbar_wait(sm.kfull(slot), parity);
      float s[N / 2];
      qk<D, N>(s, sm.q(), sm.k(slot), wg);
      wgmma_wait_all();
      reg_fence(s);
      float ls[2];
      if (tile_whole(p, tile_bit(sm.gap(), t), r0, kv0, N)) {
        tile_exp<N, true>(s, p.scale, m, ls);
      } else {
        mask_tile<N>(s, p, mrow, row, kv0);
        tile_exp<N, false>(s, p.scale, m, ls);
      }
      // Normalised (and, with dropout, scaled to 1 / (1 - rate)) in f32.
#pragma unroll
      for (int e = 0; e < N / 2; ++e) s[e] *= scale_row[(e & 3) >> 1];
      if (p.dropout) {
        mbar_wait(sm.dbar(t), 0);
        apply_drop_bits<N>(s, sm.drop(), t, row - q0);
      }
      uint32_t pa[N / 4];
      pack_p<N>(s, pa);
      if constexpr (kResident) mbar_wait(sm.vfull(slot), 0);
      pv<D, N>(o, pa, sm.v(slot));
      wgmma_wait_all();
      reg_fence(o);
      reg_fence(pa);
      release(slot);
    }
    if constexpr (!kResident) {
      // Live tiles past this warpgroup's diagonal: handed back once landed.
      for (int u = mine; u < tiles; ++u) {
        if (!tile_bit(sm.live(), u)) continue;
        mbar_wait(sm.kfull(slot_of(u)), parity_of());
        release(slot_of(u));
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row + 8 * hf;
      if ((lane & 3) == 0 && r < p.Sq) {
        p.lse_out[(static_cast<int64_t>(b) * p.H + h) * p.Sq + r] = m[hf] + logf(l[hf]);
      }
    }
    store_o<D>(p, b, h, row, o);
  }
}

// ---------------------------------------------------------------------------
// backward, dQ launch, bf16: the Hopper kernel (attention_hopper.cuh).
// block = (128 q rows, h, b), longest first under causal masking; Q and
// dO land once, two sweeps over the head's live kv tiles of N rows. Sweep
// 1: S = Q K^T and dP = dO V^T (wgmma ss, fresh arrays, waited for), p =
// exp(s - lse), dp dropped and scaled, delta += dp * p per lane; the quad
// sums each row's delta and the block writes it for the dK/dV launch.
// Sweep 2: the same products, ds = p (dp - delta) scale in f32, rounded
// to bf16 into dq += dS K (wgmma rs, K through the transpose bit).
// kResident (D <= 64): the head's K and V (S <= 512) land once and stay;
// else they stream through a ring of kSlots, both in each sweep. With
// dropout, producer warps draw every live tile's keep bits into shared
// memory during sweep 1 (draw_drop_bits, one Philox block per four
// elements) and write them to p.drop_bits for the dK/dV launch; both
// sweeps test them.
// ---------------------------------------------------------------------------
template <int D, int N, int kSlots, bool kResident>
__global__ void __launch_bounds__(hopper::kThreads, 1)
    whole_dq_tma_kernel(const Params p, const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap dmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap) {
  using namespace tpudl::hopper;
  constexpr int kTiles = kMaxSeq / N;  // kv tiles of the longest row
  using Pl = Plan<D, N, kSlots, kTiles, 2>;
  static_assert(!kResident || kSlots >= kTiles, "resident: every kv tile has its slot");
  extern __shared__ __align__(1024) uint8_t hopper_smem[];
  const Shared<D, N, kSlots, kTiles, 2> sm(hopper_smem);
  const int h = blockIdx.y, b = blockIdx.z;
  const int qblk = p.causal ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int q0 = qblk * kBlockRows;
  const uint8_t* mrow = p.kvmask ? p.kvmask + static_cast<int64_t>(b) * p.Skv : nullptr;
  constexpr int kDrawWarps = kResident ? 4 : 3;
  block_setup(sm, p, mrow, kDrawWarps);
  const int tiles = reach_tiles(p, q0, kBlockRows, N);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(sm.qbar(), 2 * Pl::kQBytes);
      load_tile<D>(sm.own(0), kBlockRows, qmap, sm.qbar(), b, h, q0);
      load_tile<D>(sm.own(1), kBlockRows, dmap, sm.qbar(), b, h, q0);
      // Each tile's K and V together: both sweeps need both.
      int i = 0;
      for (int sweep = 0; sweep < (kResident ? 1 : 2); ++sweep) {
        for (int t = 0; t < tiles; ++t) {
          if (!tile_bit(sm.live(), t)) continue;
          const int slot = kResident ? t : i % kSlots, round = kResident ? 0 : i / kSlots;
          if (round > 0) mbar_wait(sm.empty(slot), (round - 1) & 1);
          mbar_expect_tx(sm.kfull(slot), 2 * Pl::kTileBytes);
          load_tile<D>(sm.k(slot), N, kmap, sm.kfull(slot), b, h, t * N);
          load_tile<D>(sm.v(slot), N, vmap, sm.kfull(slot), b, h, t * N);
          ++i;
        }
      }
    }
    if (p.dropout && threadIdx.x >= hopper::kThreads - 32 * kDrawWarps) {
      __syncwarp();
      uint32_t k0, k1;
      seed_words(p, k0, k1);
      draw_drop_bits(sm, p, b, h, q0, tiles, k0, k1, kDrawWarps);
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int r0 = q0 + wg * kWgRows;               // the warpgroup's rows
    const int row = r0 + 16 * warp + (lane >> 2);  // the thread's: row, row + 8
    const int mine = reach_tiles(p, r0, kWgRows, N);
    int i = 0;
    auto slot_of = [&](int t) { return kResident ? t : i % kSlots; };
    auto parity_of = [&]() -> uint32_t { return kResident ? 0u : (i / kSlots) & 1; };
    auto release = [&](int slot) {
      if constexpr (!kResident) {
        __syncwarp();
        if (lane == 0) mbar_arrive(sm.empty(slot));
      }
      ++i;
    };
    const int64_t rows = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
    float lsel[2];  // lse * log2 e of the thread's rows
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row + 8 * hf;
      lsel[hf] = r < p.Sq ? p.lse[rows + r] * kLog2e : 0.0f;
    }
    // Tile t (in `slot`): p into s, the dropped and scaled dp into dp.
    auto products = [&](int t, int slot, float(&s)[N / 2], float(&dp)[N / 2]) {
      qk<D, N>(s, sm.own(0), sm.k(slot), wg);
      qk<D, N>(dp, sm.own(1), sm.v(slot), wg);
      wgmma_wait_all();
      reg_fence(s);
      reg_fence(dp);
      const int kv0 = t * N;
      if (tile_whole(p, tile_bit(sm.gap(), t), r0, kv0, N)) {
        tile_p<N, true>(s, p, mrow, row, kv0, lsel);
      } else {
        tile_p<N, false>(s, p, mrow, row, kv0, lsel);
      }
      if (p.dropout) {
        mbar_wait(sm.dbar(t), 0);
        drop_scaled<N>(dp, sm.drop(), t, row - q0, p.inv_keep);
      }
    };
    mbar_wait(sm.qbar(), 0);
    // Sweep 1: delta = rowsum(dp * p), per lane, then over the quad.
    float dl[2] = {0.0f, 0.0f};
    for (int t = 0; t < tiles; ++t) {
      if (!tile_bit(sm.live(), t)) continue;
      const int slot = slot_of(t);
      mbar_wait(sm.kfull(slot), parity_of());
      if (t < mine) {
        float s[N / 2], dp[N / 2];
        products(t, slot, s, dp);
#pragma unroll
        for (int e = 0; e < N / 2; ++e) dl[(e & 3) >> 1] += dp[e] * s[e];
      }
      release(slot);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      dl[hf] = quad_sum(dl[hf]);
      const int r = row + 8 * hf;
      if ((lane & 3) == 0 && r < p.Sq) p.delta_out[rows + r] = dl[hf];
    }
    // Sweep 2: ds = p (dp - delta) scale, rounded to bf16 into dq += dS K.
    float dq[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dq[e] = 0.0f;
    auto next_live = [&](int t) {
      while (t < mine && !tile_bit(sm.live(), t)) ++t;
      return t;
    };
    for (int t = next_live(0); t < mine; t = next_live(t + 1)) {
      const int slot = slot_of(t);
      mbar_wait(sm.kfull(slot), parity_of());
      float s[N / 2], dp[N / 2];
      products(t, slot, s, dp);
#pragma unroll
      for (int e = 0; e < N / 2; ++e) s[e] = s[e] * (dp[e] - dl[(e & 3) >> 1]) * p.scale;
      uint32_t pa[N / 4];
      pack_p<N>(s, pa);
      pv<D, N>(dq, pa, sm.k(slot));
      wgmma_wait_all();
      reg_fence(dq);
      reg_fence(pa);
      release(slot);
    }
    if constexpr (!kResident) {
      // Live tiles past this warpgroup's diagonal: handed back once landed.
      for (int u = mine; u < tiles; ++u) {
        if (!tile_bit(sm.live(), u)) continue;
        mbar_wait(sm.kfull(slot_of(u)), parity_of());
        release(slot_of(u));
      }
    }
    store_rows<D>(p.o, p.Sq, p.H, b, h, row, dq);
  }
}

// ---------------------------------------------------------------------------
// forward, f32 (full f32 on the CUDA cores; wgmma has no f32 mode and the
// port never runs TF32): block = (64 q rows, h, b); the kv tiles of N
// rows stream three times (max, exp-sum, P.V), two buffers deep across
// the passes.
// ---------------------------------------------------------------------------
template <int D, int N>
__global__ void __launch_bounds__(kThreads) whole_fwd_f32_kernel(Params p) {
  using T = float;
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
// backward, dQ launch, the first design (launched for f32; bf16 takes
// whole_dq_tma_kernel): block = (64 q rows, h, b); the kv tiles of N rows
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
// backward, dK/dV launch, the first design (launched for f32; bf16 takes
// attention_dkv.cuh): block = (64 kv rows, h, b); the q, do, lse and
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

// The first design's streamed tiles: 64 rows; the dK/dV role streams 32
// at D = 128 (its two [16, D] accumulators hold 128 f32 registers a
// thread).
template <int D> struct BwdTiles {
  static constexpr int nq = 64;
  static constexpr int nkv = D == 128 ? 32 : 64;
};

template <int D, int N>
size_t fwd_f32_smem() {  // Q; K, V x 2; P
  using S = Smem<float, D, N>;
  return (kRows * S::ldd + 2 * 2 * N * S::ldd + S::pbuf) * sizeof(float);
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

// The bf16 forward: kv tiles of 128 rows, resident at D <= 64 (Q, 4 K
// and 4 V tiles: 144 KB at D = 64); at D = 128 tiles of 64 rows through
// a ring of 4 slots (160 KB with Q).
template <int D>
int launch_fwd_bf16(const Params& p, cudaStream_t stream) {
  constexpr bool kResident = D <= 64;
  constexpr int N = kResident ? 128 : 64;
  constexpr int kSlots = kResident ? kMaxSeq / N : 4;
  using Pl = hopper::Plan<D, N, kSlots, kMaxSeq / N>;
  hopper::Maps maps;
  if (const int err = hopper::encode_maps<D, N>(&maps, p)) return err;
  static bool opted = false;
  const auto kernel = whole_fwd_kernel<D, N, kSlots, kResident>;
  if (const int err = hopper::opt_in_smem(kernel, Pl::kBytes, opted)) return err;
  const dim3 grid(static_cast<unsigned>((p.Sq + hopper::kBlockRows - 1) / hopper::kBlockRows),
                  static_cast<unsigned>(p.H), static_cast<unsigned>(p.B));
  kernel<<<grid, hopper::kThreads, Pl::kBytes, stream>>>(p, maps.q, maps.k, maps.v);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 backward: the dQ launch (it writes delta), then in stream
// order the dK/dV launch (attention_dkv.cuh; dk, dv to p.o2, p.o3). dQ's
// kv tiles: 64 rows (S and dP in flight together at 128 spilled and made
// ptxas serialise the wgmmas, C7512), resident at D <= 64 (Q, dO, 8 K
// and 8 V tiles and the dropout bits: 177.5 KB at D = 64); at D = 128
// through a ring of 3 slots (177.4 KB).
template <int D>
int launch_bwd_bf16(const Params& p, cudaStream_t stream) {
  constexpr bool kResident = D <= 64;
  constexpr int N = 64;
  constexpr int kSlots = kResident ? kMaxSeq / N : 3;
  using Pl = hopper::Plan<D, N, kSlots, kMaxSeq / N, 2>;
  CUtensorMap qmap, dmap, kmap, vmap;
  if (const int e = hopper::encode_rows<D>(&qmap, p.q, p.B, p.Sq, p.H, hopper::kBlockRows)) {
    return e;
  }
  if (const int e = hopper::encode_rows<D>(&dmap, p.dout, p.B, p.Sq, p.H, hopper::kBlockRows)) {
    return e;
  }
  if (const int e = hopper::encode_rows<D>(&kmap, p.k, p.B, p.Skv, p.H, N)) return e;
  if (const int e = hopper::encode_rows<D>(&vmap, p.v, p.B, p.Skv, p.H, N)) return e;
  static bool opted = false;
  const auto kernel = whole_dq_tma_kernel<D, N, kSlots, kResident>;
  if (const int err = hopper::opt_in_smem(kernel, Pl::kBytes, opted)) return err;
  const dim3 grid(static_cast<unsigned>((p.Sq + hopper::kBlockRows - 1) / hopper::kBlockRows),
                  static_cast<unsigned>(p.H), static_cast<unsigned>(p.B));
  kernel<<<grid, hopper::kThreads, Pl::kBytes, stream>>>(p, qmap, dmap, kmap, vmap);
  if (const int err = static_cast<int>(cudaGetLastError())) return err;
  Params pkv = p;
  pkv.o = p.o2;
  pkv.o2 = p.o3;
  return hopper::launch_dkv<D>(pkv, stream);
}

// f32 (CUDA cores): the forward, and the two backward launches of the
// first design (attention_tiles.cuh) in stream order, the dK/dV launch
// reading the delta the dQ launch writes.
template <int D>
int launch_f32(bool backward, const Params& p, cudaStream_t stream) {
  using T = float;
  const unsigned tiles = static_cast<unsigned>((p.Sq + kRows - 1) / kRows);
  const dim3 grid(tiles, static_cast<unsigned>(p.H), static_cast<unsigned>(p.B));
  if (backward) {
    static bool opted_dq = false, opted_dkv = false;
    const size_t sdq = dq_smem<T, D>(), sdkv = dkv_smem<T, D>();
    constexpr int nq = BwdTiles<D>::nq, nkv = BwdTiles<D>::nkv;
    if (const int err = hopper::opt_in_smem(whole_dq_kernel<T, D, nq>, sdq, opted_dq)) {
      return err;
    }
    if (const int err = hopper::opt_in_smem(whole_dkv_kernel<T, D, nkv>, sdkv, opted_dkv)) {
      return err;
    }
    whole_dq_kernel<T, D, nq><<<grid, kThreads, sdq, stream>>>(p);
    if (const int err = static_cast<int>(cudaGetLastError())) return err;
    whole_dkv_kernel<T, D, nkv><<<grid, kThreads, sdkv, stream>>>(p);
  } else {
    static bool opted = false;
    const size_t smem = fwd_f32_smem<D, 64>();
    if (const int err = hopper::opt_in_smem(whole_fwd_f32_kernel<D, 64>, smem, opted)) return err;
    whole_fwd_f32_kernel<D, 64><<<grid, kThreads, smem, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_d(bool backward, const Params& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return backward ? launch_bwd_bf16<D>(p, stream) : launch_fwd_bf16<D>(p, stream);
  } else {
    return launch_f32<D>(backward, p, stream);
  }
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
// rowsum(dp * p) by the first of the two launches and read by the second;
// bits: with dropout and bf16, [b, h, s, (s + 31) / 32] u32 scratch for
// the keep bits the first launch draws and the second reads (else null).
extern "C" int tpudl_fused_attn_bwd(const void* q, const void* k, const void* v,
                                    const void* kvmask, const void* seed, const void* dout,
                                    const void* lse, void* delta, void* bits, void* dq, void* dk,
                                    void* dv, int b, int s, int h, int d, int causal, float scale,
                                    uint32_t threshold, float inv_keep, int dropout, int dtype,
                                    void* stream) {
  Params p = make_params(q, k, v, kvmask, seed, b, s, s, h, causal, scale, threshold, inv_keep,
                         dropout);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta_out = static_cast<float*>(delta);
  p.delta = p.delta_out;
  if (dropout && dtype == tpudl::kBFloat16) {
    if (bits == nullptr) return cudaErrorInvalidValue;
    p.drop_bits = static_cast<uint32_t*>(bits);
    p.drop_words = (s + 31) / 32;
  }
  p.o = dq;
  p.o2 = dk;
  p.o3 = dv;
  return launch(true, d, dtype, p, stream);
}
