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
// What the design does about that:
// - The bf16 forward is a Hopper kernel (attention_hopper.cuh): a block
//   of 128 q rows in two consumer warpgroups and a producer warpgroup
//   that streams the K and V tiles (128 rows) by TMA through a ring of
//   mbarrier-guarded slots; S = Q K^T and O += P V are wgmma, P goes from
//   the S accumulator registers into the second product's A operand,
//   rounded to bf16 there. Tiles past the causal diagonal, and kv tiles
//   the mask empties, are never loaded; q blocks run longest first. A
//   Philox block serves four elements of the dropout draw.
// - The bf16 dK/dV kernel is attention_dkv.cuh's, shared with the
//   whole-row backward: a block owns kv rows and keeps dK and dV in
//   registers, a producer warpgroup streams the Q and dO tiles by TMA
//   with each tile's lse and delta rows (and the dQ launch's keep bits)
//   beside them, and S^T, dP^T, dV and dK are wgmma, each waited for
//   inside its step. It replaces the first design's mma.sync kernel,
//   which ran 2328.91 us at the Llama step's shape against a 278.07 us
//   bound. At D = 128 a block owns 64
//   kv rows and each consumer warpgroup one of the two gradients: ptxas
//   keeps the consumers near 168 registers, and dK and dV together would
//   hold 128 of them.
// - The bf16 dQ kernel (flash_dq_tma_kernel) is on the same machinery:
//   a block of 128 q rows, Q and dO loaded once by TMA, K and V tiles of
//   64 rows through a ring, S = Q K^T and dP = dO V^T (wgmma ss) and dq
//   += round(dS) K (wgmma rs), delta from the caller. With dropout its
//   producer warps draw each tile's keep bits once and write them in row
//   order to a scratch that the dK/dV launch reads (no second draw). It
//   replaces the first design's mma.sync kernel (4 warps, cp.async two
//   deep, a __syncthreads a tile, a Philox block per element), which ran
//   1972.08 us at the Llama step's shape against a 208.55 us bound.
// - Everything f32 runs the first design: full f32 on the CUDA cores
//   (never TF32; wgmma has no f32 mode). One block of 4 warps takes 64
//   rows of its own side (q rows for dQ and the forward, kv rows for
//   dK/dV); each warp owns 16 and keeps their accumulator in registers.
//   The other side streams through shared memory a tile at a time, two
//   buffers deep (cp.async); probabilities and ds are staged in shared
//   memory for the second product. Each f32 kernel draws its own keep
//   bits.
// - The Pallas grid carries accumulators across a sequential grid axis;
//   here the loop over the streamed side runs inside the block, and the
//   two backward kernels stay separate so each accumulator has one owner:
//   no float atomics, so every kernel is bitwise repeatable.
// - Causal tiles that cannot contribute are skipped; a tile that every
//   (q, kv) pair attends (below the diagonal, in range, no kv-mask zero)
//   skips the per-element mask checks; ragged Sq and Skv are bounds
//   checks (rows past the end load as zeros and never store).
#include <type_traits>

#include "attention_dkv.cuh"

namespace {

using namespace tpudl::attn;
namespace hopper = tpudl::hopper;

// ---------------------------------------------------------------------------
// forward, bf16: the Hopper kernel (attention_hopper.cuh). block = (128 q
// rows, h, b), taken longest first under causal masking (the q block
// index reversed); kv tiles of N rows stream through a ring of kSlots.
// Each consumer warpgroup runs the online softmax on its 64 rows: per
// tile the row max over the quad, corr = exp(m_old - m), p = exp(s - m)
// (unnormalised, summed into l per lane, then dropped), P rounded to
// bf16 into the P.V product, o rescaled by corr; at the end o / l, then
// times 1 / (1 - rate), and lse = m + log(l).
// ---------------------------------------------------------------------------
template <int D, int N, int kSlots>
__global__ void __launch_bounds__(hopper::kThreads, 1)
    flash_fwd_kernel(const Params p, const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap) {
  using namespace tpudl::hopper;
  using Pl = Plan<D, N, kSlots>;
  extern __shared__ __align__(1024) uint8_t hopper_smem[];
  const Shared<D, N, kSlots> sm(hopper_smem);
  const int h = blockIdx.y, b = blockIdx.z;
  const int qblk = p.causal ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int q0 = qblk * kBlockRows;
  const uint8_t* mrow = p.kvmask ? p.kvmask + static_cast<int64_t>(b) * p.Skv : nullptr;
  block_setup(sm, p, mrow);
  const int tiles = reach_tiles(p, q0, kBlockRows, N);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: Q once, then the live kv tiles through the ring.
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(sm.qbar(), Pl::kQBytes);
      load_tile<D>(sm.q(), kBlockRows, qmap, sm.qbar(), b, h, q0);
      int i = 0;
      for (int t = 0; t < tiles; ++t) {
        if (!tile_bit(sm.live(), t)) continue;
        const int slot = i % kSlots, round = i / kSlots;
        if (round > 0) mbar_wait(sm.empty(slot), (round - 1) & 1);
        mbar_expect_tx(sm.kfull(slot), Pl::kTileBytes);
        load_tile<D>(sm.k(slot), N, kmap, sm.kfull(slot), b, h, t * N);
        mbar_expect_tx(sm.vfull(slot), Pl::kTileBytes);
        load_tile<D>(sm.v(slot), N, vmap, sm.vfull(slot), b, h, t * N);
        ++i;
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int r0 = q0 + wg * kWgRows;               // the warpgroup's rows
    const int row = r0 + 16 * warp + (lane >> 2);  // the thread's: row, row + 8
    const int mine = reach_tiles(p, r0, kWgRows, N);
    uint32_t k0 = 0, k1 = 0;
    if (p.dropout) {
      k0 = static_cast<uint32_t>(p.seed[0]);
      k1 = static_cast<uint32_t>(p.seed[1]);
    }
    uint64_t rowbase[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      rowbase[hf] = ((static_cast<uint64_t>(b) * p.H + h) * p.Sq + row + 8 * hf) *
                    static_cast<uint64_t>(p.Skv);
    }
    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.0f;
    // m is the quad's running row max; l the lane's share of the row sum.
    float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.0f, 0.0f};
    const uint32_t* live = sm.live();
    auto next_live = [&](int t) {
      while (t < mine && !tile_bit(live, t)) ++t;
      return t;
    };
    // Hand a slot back: every consumer warp, once the slot's products are done.
    auto release = [&](int slot) {
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(slot));
    };
    mbar_wait(sm.qbar(), 0);
    // Per live tile: S = Q K^T into a fresh array (no earlier value to
    // carry into the products' registers), waited for; the softmax; P.V,
    // waited for; the slot handed back. Each product completes inside its
    // step, so the two warpgroups' products and softmaxes interleave on
    // the SM rather than within a warpgroup.
    int i = 0;  // ring step
    for (int t = next_live(0); t < mine; t = next_live(t + 1)) {
      const int slot = i % kSlots;
      const uint32_t parity = (i / kSlots) & 1;
      const int kv0 = t * N;
      mbar_wait(sm.kfull(slot), parity);
      float s[N / 2];
      qk<D, N>(s, sm.q(), sm.k(slot), wg);
      wgmma_wait_all();
      reg_fence(s);
      const bool whole = tile_whole(p, tile_bit(sm.gap(), t), r0, kv0, N);
      float mt[2] = {m[0], m[1]}, corr[2], ls[2];
      if (whole) {
        tile_max<N, true>(s, p.scale, mt);
      } else {
        mask_tile<N>(s, p, mrow, row, kv0);
        tile_max<N, false>(s, p.scale, mt);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mt[hf] = quad_max(mt[hf]);
        corr[hf] = ex2((m[hf] - mt[hf]) * kLog2e);
        m[hf] = mt[hf];
      }
      if (whole) {
        tile_exp<N, true>(s, p.scale, m, ls);
      } else {
        tile_exp<N, false>(s, p.scale, m, ls);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * corr[hf] + ls[hf];
      if (p.dropout) dropout<N>(s, p, rowbase, kv0, k0, k1, 1.0f);
      uint32_t pa[N / 4];
      pack_p<N>(s, pa);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
      mbar_wait(sm.vfull(slot), parity);
      pv<D, N>(o, pa, sm.v(slot));
      wgmma_wait_all();
      reg_fence(o);
      reg_fence(pa);
      release(slot);
      ++i;
    }
    // Live tiles past this warpgroup's diagonal: handed back once they
    // landed (so each hand-back counts in its own round).
    for (int u = mine; u < tiles; ++u) {
      if (!tile_bit(live, u)) continue;
      mbar_wait(sm.kfull(i % kSlots), (i / kSlots) & 1);
      release(i % kSlots);
      ++i;
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float lt = quad_sum(l[hf]);
      const float l_safe = lt > 0.0f ? lt : 1.0f;
      const int r = row + 8 * hf;
      if ((lane & 3) == 0 && r < p.Sq) {
        p.lse_out[(static_cast<int64_t>(b) * p.H + h) * p.Sq + r] = m[hf] + logf(l_safe);
      }
      // tpudl's order: o / l_safe, then (with dropout) * 1 / (1 - rate).
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
#pragma unroll
        for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
          o[4 * j + e] = o[4 * j + e] / l_safe;
          if (p.dropout) o[4 * j + e] *= p.inv_keep;
        }
      }
    }
    store_o<D>(p, b, h, row, o);
  }
}

// ---------------------------------------------------------------------------
// forward, f32 (full f32 on the CUDA cores; wgmma has no f32 mode and the
// port never runs TF32): block = (64 q rows, h, b); kv tiles of N stream
// through, two buffers deep (the next tile's copy runs during this tile's
// products).
// ---------------------------------------------------------------------------
template <int D, int N>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(Params p) {
  using T = float;
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
// dQ, bf16: the Hopper kernel (attention_hopper.cuh). block = (128 q rows,
// h, b), longest first under causal masking; Q and dO land once by TMA,
// the live kv tiles of N rows (K and V together) stream through a ring of
// kSlots. Per tile each consumer warpgroup runs S = Q K^T and dP = dO V^T
// (wgmma ss, fresh arrays, waited for), the f32 element work in the
// accumulator registers (p by tile_p, specialised on whole tiles; dp
// dropped by the slot's keep bits, drop_scaled), and dq += round(dS) K
// (wgmma rs, K through the transpose bit). With dropout the last
// kDrawWarps warps of the producer warpgroup draw each live tile's keep
// bits once (one Philox block per four elements) into the tile's ring
// slot, arrive on the slot's dbar, and write them to p.drop_bits in row
// order for the dK/dV launch. Every consumer warpgroup waits on each
// slot's kfull (and dbar) every round, even for a tile past its causal
// reach, before it hands the slot back: else the producer warps could
// drift a round apart.
// ---------------------------------------------------------------------------

template <int D, int N, int kSlots>
__global__ void __launch_bounds__(hopper::kThreads, 1)
    flash_dq_tma_kernel(const Params p, const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap dmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap) {
  using namespace tpudl::hopper;
  // The keep bits go with the ring slot: kSlots tiles of them.
  using Sh = Shared<D, N, kSlots, kSlots, 2>;
  using Pl = typename Sh::P;
  constexpr int kDrawWarps = 3;
  extern __shared__ __align__(1024) uint8_t hopper_smem[];
  const Sh sm(hopper_smem);
  const int h = blockIdx.y, b = blockIdx.z;
  const int qblk = p.causal ? static_cast<int>(gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int q0 = qblk * kBlockRows;
  const uint8_t* mrow = p.kvmask ? p.kvmask + static_cast<int64_t>(b) * p.Skv : nullptr;
  block_setup(sm, p, mrow, kDrawWarps);
  const int tiles = reach_tiles(p, q0, kBlockRows, N);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(sm.qbar(), 2 * Pl::kQBytes);
      load_tile<D>(sm.own(0), kBlockRows, qmap, sm.qbar(), b, h, q0);
      load_tile<D>(sm.own(1), kBlockRows, dmap, sm.qbar(), b, h, q0);
      for (int t = 0, i = 0; t < tiles; ++t) {
        if (!tile_bit(sm.live(), t)) continue;
        const int slot = i % kSlots, round = i / kSlots;
        if (round > 0) mbar_wait(sm.empty(slot), (round - 1) & 1);
        mbar_expect_tx(sm.kfull(slot), 2 * Pl::kTileBytes);
        load_tile<D>(sm.k(slot), N, kmap, sm.kfull(slot), b, h, t * N);
        load_tile<D>(sm.v(slot), N, vmap, sm.kfull(slot), b, h, t * N);
        ++i;
      }
    } else if (p.dropout && threadIdx.x >= hopper::kThreads - 32 * kDrawWarps) {
      const uint32_t k0 = static_cast<uint32_t>(p.seed[0]), k1 = static_cast<uint32_t>(p.seed[1]);
      const int dt = threadIdx.x - (hopper::kThreads - 32 * kDrawWarps);
      for (int t = 0, i = 0; t < tiles; ++t) {
        if (!tile_bit(sm.live(), t)) continue;
        const int slot = i % kSlots, round = i / kSlots;
        if (round > 0) mbar_wait(sm.empty(slot), (round - 1) & 1);
        draw_tile_bits<N>(sm.drop() + slot * kBlockRows * 4, p, b, h, q0, t, k0, k1, dt,
                          32 * kDrawWarps);
        __syncwarp();
        if ((threadIdx.x & 31) == 0) mbar_arrive(sm.dbar(slot));
        ++i;
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int r0 = q0 + wg * kWgRows;               // the warpgroup's rows
    const int row = r0 + 16 * warp + (lane >> 2);  // the thread's: row, row + 8
    const int mine = reach_tiles(p, r0, kWgRows, N);
    const int64_t rows = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
    float lsel[2], dl[2];  // lse * log2 e and delta of the thread's rows
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row + 8 * hf;
      lsel[hf] = r < p.Sq ? p.lse[rows + r] * kLog2e : 0.0f;
      dl[hf] = r < p.Sq ? p.delta[rows + r] : 0.0f;
    }
    float dq[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dq[e] = 0.0f;
    mbar_wait(sm.qbar(), 0);
    for (int t = 0, i = 0; t < tiles; ++t) {
      if (!tile_bit(sm.live(), t)) continue;
      const int slot = i % kSlots;
      const uint32_t parity = (i / kSlots) & 1;
      mbar_wait(sm.kfull(slot), parity);
      if (t < mine) {
        // S = Q K^T and dP = dO V^T: fresh arrays, one group, waited for.
        float s[N / 2], dp[N / 2];
        wgmma_fence();
        qk<D, N, kBlockRows, false>(s, sm.own(0), sm.k(slot), wg);
        qk<D, N, kBlockRows, false>(dp, sm.own(1), sm.v(slot), wg);
        wgmma_commit();
        if (p.dropout) mbar_wait(sm.dbar(slot), parity);
        wgmma_wait_all();
        reg_fence(s);
        reg_fence(dp);
        const int kv0 = t * N;
        const bool whole = tile_whole(p, tile_bit(sm.gap(), t), r0, kv0, N);
        if (whole) {
          tile_p<N, true>(s, p, mrow, row, kv0, lsel);
        } else {
          tile_p<N, false>(s, p, mrow, row, kv0, lsel);
        }
        if (p.dropout) drop_scaled<N>(dp, sm.drop(), slot, row - q0, p.inv_keep);
        // ds = p (dp - delta) scale.
#pragma unroll
        for (int e = 0; e < N / 2; ++e) s[e] = s[e] * (dp[e] - dl[(e & 3) >> 1]) * p.scale;
        // dq += dS K, waited for.
        uint32_t pa[N / 4];
        pack_p<N>(s, pa);
        pv<D, N>(dq, pa, sm.k(slot));
        wgmma_wait_all();
        reg_fence(dq);
        reg_fence(pa);
      } else if (p.dropout) {
        mbar_wait(sm.dbar(slot), parity);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.empty(slot));
      ++i;
    }
    store_rows<D>(p.o, p.Sq, p.H, b, h, row, dq);
  }
}

// ---------------------------------------------------------------------------
// dQ, f32 (full f32 on the CUDA cores; wgmma has no f32 mode and the port
// never runs TF32): block = (64 q rows, h, b); kv tiles of N stream
// through, two deep.
// ---------------------------------------------------------------------------
template <int D, int N>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Params p) {
  using T = float;
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
// dK/dV, the first design (launched for f32; bf16 takes attention_dkv.cuh):
// block = (kv block, h, b); q tiles of N stream through, two deep.
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

// The first design's shared memory (f32).
template <int D, int N>
size_t smem_bytes(Which which) {
  using T = float;
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

// One f32 kernel of the first design (CUDA cores).
template <int D, int N>
int launch_f32(Which which, const Params& p, cudaStream_t stream) {
  void (*kernel)(Params) = which == kDq    ? flash_dq_kernel<D, N>
                           : which == kDkv ? flash_dkv_kernel<float, D, N>
                                           : flash_fwd_f32_kernel<D, N>;
  const size_t smem = smem_bytes<D, N>(which);
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

// The bf16 forward: kv tiles of 128 rows (64 at D = 128, where the
// [64, 128] f32 output already holds 64 registers a thread), a ring of 4
// slots (160 KB with Q at D = 128).
template <int D>
int launch_fwd_bf16(const Params& p, cudaStream_t stream) {
  constexpr int N = D == 128 ? 64 : 128, kSlots = 4;
  using Pl = hopper::Plan<D, N, kSlots>;
  hopper::Maps maps;
  if (const int err = hopper::encode_maps<D, N>(&maps, p)) return err;
  static bool opted = false;
  if (const int err = hopper::opt_in_smem(flash_fwd_kernel<D, N, kSlots>, Pl::kBytes, opted)) {
    return err;
  }
  const dim3 grid(static_cast<unsigned>((p.Sq + hopper::kBlockRows - 1) / hopper::kBlockRows),
                  static_cast<unsigned>(p.H), static_cast<unsigned>(p.B));
  flash_fwd_kernel<D, N, kSlots><<<grid, hopper::kThreads, Pl::kBytes, stream>>>(p, maps.q, maps.k,
                                                                                  maps.v);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 dQ launch's kv tiles and ring: N rows (at N 64 a consumer
// thread holds dq[D / 2], s[32], dp[32] and the 16 words of dS), kSlots
// K and V tile pairs with their keep bits (D 128: 4 slots, 197.6 KB
// with Q and dO).
template <int D> struct DqTiles {
  static constexpr int N = 64;
  static constexpr int kSlots = D == 128 ? 4 : 6;
};

template <int D>
int launch_dq_bf16(const Params& p, cudaStream_t stream) {
  constexpr int N = DqTiles<D>::N, kSlots = DqTiles<D>::kSlots;
  using Pl = hopper::Plan<D, N, kSlots, kSlots, 2>;
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
  const auto kernel = flash_dq_tma_kernel<D, N, kSlots>;
  if (const int err = hopper::opt_in_smem(kernel, Pl::kBytes, opted)) return err;
  const dim3 grid(static_cast<unsigned>((p.Sq + hopper::kBlockRows - 1) / hopper::kBlockRows),
                  static_cast<unsigned>(p.H), static_cast<unsigned>(p.B));
  kernel<<<grid, hopper::kThreads, Pl::kBytes, stream>>>(p, qmap, dmap, kmap, vmap);
  return static_cast<int>(cudaGetLastError());
}

// bf16: the Hopper kernels (dK/dV in attention_dkv.cuh, shared with the
// whole-row backward). f32: the first design; its streamed tile is 64
// rows, 32 for the dK/dV kernel at D = 128 (its two [16, D] accumulators
// already hold 128 f32 registers per thread).
template <typename T, int D>
int launch_d(Which which, const Params& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (which == kFwd) return launch_fwd_bf16<D>(p, stream);
    if (which == kDq) return launch_dq_bf16<D>(p, stream);
    return hopper::launch_dkv<D>(p, stream);
  } else {
    if constexpr (D == 128) {
      if (which == kDkv) return launch_f32<D, 32>(which, p, stream);
    }
    return launch_f32<D, 64>(which, p, stream);
  }
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

// The backward's Params: bits, with dropout in bf16, is the [b, h, sq,
// (skv + 31) / 32] u32 keep-bit scratch the dQ launch writes and the dK/dV
// launch reads (bit kv % 32 of word kv / 32); else unused.
static Params bwd_params(const void* q, const void* k, const void* v, const void* kvmask,
                         const void* seed, const void* dout, const void* lse, const void* delta,
                         void* bits, int b, int sq, int skv, int h, int causal,
                         float scale, uint32_t threshold, float inv_keep, int dropout,
                         int dtype) {
  Params p = make_params(q, k, v, kvmask, seed, b, sq, skv, h, causal, scale, threshold,
                         inv_keep, dropout);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  if (dropout && dtype == tpudl::kBFloat16) {
    p.drop_bits = static_cast<uint32_t*>(bits);
    p.drop_words = (skv + 31) / 32;
  }
  return p;
}

// As tpudl_flash_fwd; dout, dq: [b, sq, h, d]; lse, delta: [b, h, sq] f32;
// bits: see bwd_params (written here; required with dropout in bf16).
extern "C" int tpudl_flash_dq(const void* q, const void* k, const void* v, const void* kvmask,
                              const void* seed, const void* dout, const void* lse,
                              const void* delta, void* bits, void* dq, int b, int sq, int skv,
                              int h, int d, int causal, float scale, uint32_t threshold,
                              float inv_keep, int dropout, int dtype, void* stream) {
  Params p = bwd_params(q, k, v, kvmask, seed, dout, lse, delta, bits, b, sq, skv, h, causal,
                        scale, threshold, inv_keep, dropout, dtype);
  if (dropout && dtype == tpudl::kBFloat16 && bits == nullptr) return cudaErrorInvalidValue;
  p.o = dq;
  return launch(kDq, d, dtype, p, stream);
}

// As tpudl_flash_dq; dk, dv: [b, skv, h, d]; bits: the dQ launch's (read
// here, in stream order after it).
extern "C" int tpudl_flash_dkv(const void* q, const void* k, const void* v, const void* kvmask,
                               const void* seed, const void* dout, const void* lse,
                               const void* delta, void* bits, void* dk, void* dv, int b, int sq,
                               int skv, int h, int d, int causal, float scale,
                               uint32_t threshold, float inv_keep, int dropout, int dtype,
                               void* stream) {
  Params p = bwd_params(q, k, v, kvmask, seed, dout, lse, delta, bits, b, sq, skv, h, causal,
                        scale, threshold, inv_keep, dropout, dtype);
  if (dropout && dtype == tpudl::kBFloat16 && bits == nullptr) return cudaErrorInvalidValue;
  p.o = dk;
  p.o2 = dv;
  return launch(kDkv, d, dtype, p, stream);
}
