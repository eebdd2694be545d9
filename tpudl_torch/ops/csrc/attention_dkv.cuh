// The bf16 dK/dV backward of attention for Hopper (sm_90a): one kernel
// for the whole-row attention's dK/dV launch (fused_attention.cu, after
// its dQ launch has written delta) and flash's dK/dV (flash_attention.cu,
// delta from the caller). Both compute, per (kv, q) pair that attends,
//   p = exp(s * scale - lse[q]), dp = do v^T (dropped entries 0, kept
//   ones / (1 - rate)), ds = p * (dp - delta[q]) * scale,
//   dv = round(p')^T do with p' = dropkeep ? p / (1 - rate) : 0,
//   dk = round(ds)^T q,
// with the forward's lse and the callers' delta; the mask is a [B, Skv]
// kv mask and/or causal, bottom-right aligned (kv <= q + Skv - Sq).
//
// The machinery is the forwards' (attention_hopper.cuh) with the roles
// turned round. A block owns 128 kv rows of one (b, h) and runs three
// warpgroups:
// - warpgroup 2, the producer: one thread TMA-loads the block's K and V
//   once, then streams the Q and dO tiles of N q rows through a ring of
//   kSlots slots (completion on "full", hand-back on "empty"). All four
//   warps then fill the slot's side data: the tile's lse (times log2 e)
//   and delta rows, and with dropout its keep bits, and arrive on the
//   slot's "aux" barrier. The bits are never drawn here: both backwards'
//   dQ launches wrote them in row order (p.drop_bits), and the producer
//   transposes a tile's words into the consumers' order
//   (transpose_dkv_bits). Every consumer warpgroup waits on "aux" each
//   round before it hands the slot back, whether or not it computes the
//   tile: else the producer warps could drift a round apart on "aux".
// - warpgroups 0 and 1, the consumers, own 64 kv rows each and keep dK
//   and dV [64, D] in registers. Per tile S^T = K Q^T and dP^T = V dO^T
//   are wgmma ss (both operands K-major), issued into fresh arrays and
//   waited for (an accumulator live across a product, or a second score
//   buffer in flight, made ptxas serialise every wgmma, C7515); then p,
//   p', ds in f32 in the accumulator registers, on a path specialised for
//   whole tiles and for dropout (dkv_tile_math), rounded to bf16 into the
//   A fragments of dV += P'^T dO and dK += dS^T Q, wgmma rs with dO and Q
//   read through the transpose bit. At D = 128 a block owns 64 kv rows
//   and each consumer warpgroup one gradient (see launch_dkv).
// A block whose kv rows the padding mask leaves dead runs no product and
// writes zero dK and dV; a warpgroup whose 64 rows are dead, or lie past
// the causal reach of a q tile, skips that tile's products. Under causal
// masking q tiles above the block's reach are not loaded. Each
// accumulator has one owner: no atomics, bitwise repeatable.
#pragma once

#include "attention_hopper.cuh"

namespace tpudl {
namespace hopper {
// Internal linkage: both kernel libraries include this header, and a
// launcher's static opt-in flag shared between them (one vague-linkage
// object per process) would skip the second library's opt-in.
namespace {

// The dK/dV block's shared memory: K and V (kRows kv rows each), then
// kSlots ring slots of a Q and a dO tile (N rows), the tile's lse * log2 e
// and delta rows (N floats each) and its keep bits (kRows kv rows x 4
// words), then the staging of the dQ launch's row-order bits (two
// buffers of N q rows x kRows / 32 words), then the barriers: kv (K and
// V landed), full, empty and aux per slot.
template <int D, int N, int kSlots, int kRows> struct DkvPlan {
  static constexpr uint32_t kOwnBytes = kRows * D * 2;
  static constexpr uint32_t kTileBytes = N * D * 2;
  static constexpr uint32_t kQ = 2 * kOwnBytes;
  static constexpr uint32_t kDo = kQ + kSlots * kTileBytes;
  static constexpr uint32_t kStats = kDo + kSlots * kTileBytes;
  static constexpr uint32_t kDrop = kStats + kSlots * 2 * N * 4;
  static constexpr uint32_t kStage = kDrop + kSlots * kRows * 16;
  static constexpr uint32_t kBars = kStage + 2 * N * (kRows / 32) * 4;
  static constexpr uint32_t kEnd = kBars + 8 * (1 + 3 * kSlots);
  static constexpr size_t kBytes = kEnd + 1024;  // + slack to align the base
  static_assert(kBytes <= 232448, "shared memory of one block");
};

template <int D, int N, int kSlots, int kRows> struct DkvShared {
  using P = DkvPlan<D, N, kSlots, kRows>;
  uint8_t* base;  // 1024-byte aligned
  uint32_t addr;  // its shared address
  __device__ __forceinline__ explicit DkvShared(uint8_t* raw) {
    const uint32_t a = smem_u32(raw);
    const uint32_t pad = (1024u - (a & 1023u)) & 1023u;
    base = raw + pad;
    addr = a + pad;
  }
  __device__ __forceinline__ uint32_t k() const { return addr; }
  __device__ __forceinline__ uint32_t v() const { return addr + P::kOwnBytes; }
  __device__ __forceinline__ uint32_t q(int s) const { return addr + P::kQ + s * P::kTileBytes; }
  __device__ __forceinline__ uint32_t dout(int s) const {
    return addr + P::kDo + s * P::kTileBytes;
  }
  __device__ __forceinline__ float* lsel(int s) const {
    return reinterpret_cast<float*>(base + P::kStats) + s * 2 * N;
  }
  __device__ __forceinline__ float* delta(int s) const { return lsel(s) + N; }
  __device__ __forceinline__ uint32_t* drop(int s) const {
    return reinterpret_cast<uint32_t*>(base + P::kDrop) + s * kRows * 4;
  }
  __device__ __forceinline__ uint32_t* stage(int i) const {
    return reinterpret_cast<uint32_t*>(base + P::kStage) + (i & 1) * N * (kRows / 32);
  }
  __device__ __forceinline__ uint32_t kvbar() const { return addr + P::kBars; }
  __device__ __forceinline__ uint32_t full(int s) const { return addr + P::kBars + 8 * (1 + s); }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return addr + P::kBars + 8 * (1 + kSlots + s);
  }
  __device__ __forceinline__ uint32_t aux(int s) const {
    return addr + P::kBars + 8 * (1 + 2 * kSlots + s);
  }
};

// The producer warpgroup's share of dropout (thread pt of 128): the keep
// bits of q tile [qt0, qt0 + N) against the block's kRows kv rows, which
// the dQ launch wrote in row order to p.drop_bits, staged in shared
// memory; the producer warpgroup syncs (named barrier 1), and each thread
// gathers the consumers' words of its kv rows: bit 2j + e of word t' of
// row c is bit c of q row 8j + 2t' + e (the q columns thread t' of a quad
// holds in the m64nN layout of S^T). No Philox draw. The dQ launch drew
// only the (q, kv) words its blocks can reach; the consumers mask every
// other pair's bit with its attend bit before they use it.
template <int N, int kRows>
__device__ __forceinline__ void transpose_dkv_bits(uint32_t* words, uint32_t* stage,
                                                   const Params& p, int64_t row_off, int qt0,
                                                   int kv0, int pt) {
  constexpr int kW = kRows / 32;  // words of a q row in the block
  for (int x = pt; x < N * kW; x += 128) {
    const int q = qt0 + x / kW, word = kv0 / 32 + x % kW;
    stage[x] = q < p.Sq && word < p.drop_words
                   ? p.drop_bits[(row_off + q) * p.drop_words + word]
                   : 0u;
  }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  for (int item = pt; item < kRows * 4; item += 128) {
    const int c = item % kRows, tq = item / kRows;
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t row = stage[(8 * j + 2 * tq + e) * kW + c / 32];
        w |= ((row >> (c & 31)) & 1u) << (2 * j + e);
      }
    }
    words[c * 4 + tq] = w;
  }
}

// What a consumer warpgroup accumulates: both dK and dV for its own 64 kv
// rows, or (split blocks of 64 kv rows) one of them for all of them.
enum DkvRole { kBothGrads, kDvOnly, kDkOnly };

// A tile's f32 work in the accumulator registers: p = exp(s * scale -
// lse) from S^T (0 where the pair does not attend, unless kWhole), p' =
// the dropped, scaled p into s (kDv), ds = p (dp' - delta) scale into dp
// (kDk). Specialised on whole tiles and on dropout, so the path of a
// whole tile without dropout is an FFMA, an EX2 and (kDk) three f32
// operations an element. keep[hf]: bit 2j + e set where the pair of the
// thread's row rowblk + 8 hf and column 8j + 2t + e attends; w: the
// keep bits of dropout, the same layout.
template <int N, int kRole, bool kWhole, bool kDrop>
__device__ __forceinline__ void dkv_tile_math(float (&s)[N / 2],
                                              float (&dp)[kRole != kDvOnly ? N / 2 : 1],
                                              const float* lsel, const float* dlt,
                                              const uint32_t (&keep)[2], const uint32_t (&w)[2],
                                              const Params& p) {
  constexpr bool kDv = kRole != kDkOnly, kDk = kRole != kDvOnly;
  const int t = threadIdx.x & 3;
  const float sl = p.scale * kLog2e;
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj) {
    const float2 ls = *reinterpret_cast<const float2*>(lsel + 8 * jj + 2 * t);
    float2 dl;
    if constexpr (kDk) dl = *reinterpret_cast<const float2*>(dlt + 8 * jj + 2 * t);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = 4 * jj + x, hf = x >> 1, e = x & 1, bit = 2 * jj + e;
      float pe = ex2(fmaf(s[i], sl, -(e ? ls.y : ls.x)));
      if constexpr (!kWhole) pe = (keep[hf] >> bit) & 1u ? pe : 0.0f;
      if constexpr (kDrop) {
        const bool kd = (w[hf] >> bit) & 1u;
        if constexpr (kDv) s[i] = kd ? pe * p.inv_keep : 0.0f;
        if constexpr (kDk) {
          const float d = kd ? dp[i] * p.inv_keep : 0.0f;
          dp[i] = pe * (d - (e ? dl.y : dl.x)) * p.scale;
        }
      } else {
        if constexpr (kDv) s[i] = pe;
        if constexpr (kDk) dp[i] = pe * (dp[i] - (e ? dl.y : dl.x)) * p.scale;
      }
    }
  }
}

// A consumer warpgroup's loop over the block's q tiles (see the kernel).
template <int D, int N, int kSlots, int kRows, int kRole>
__device__ __forceinline__ void dkv_consume(const DkvShared<D, N, kSlots, kRows>& sm,
                                            const Params& p, const uint8_t* mrow, int b, int h,
                                            int kv0, int first, int tiles, bool rows_whole,
                                            bool mine, int wg) {
  constexpr bool kDv = kRole != kDkOnly, kDk = kRole != kDvOnly;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, t = lane & 3;
  const int awg = kRows == kBlockRows ? wg : 0;       // the warpgroup's rows in the block
  const int r0 = kv0 + awg * kWgRows;                 // its first kv row
  const int rowblk = awg * kWgRows + 16 * warp + (lane >> 2);  // the thread's: rowblk, + 8
  const int off = p.Skv - p.Sq;
  bool rowok[2];
  int qmin[2];  // causal: the pair attends iff q >= qmin
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int c = kv0 + rowblk + 8 * hf;
    rowok[hf] = c < p.Skv && (mrow == nullptr || mrow[c] != 0);
    qmin[hf] = p.causal ? c - off : INT_MIN;
  }
  float dk[kDk ? D / 2 : 1], dv[kDv ? D / 2 : 1];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) {
    if constexpr (kDk) dk[e] = 0.0f;
    if constexpr (kDv) dv[e] = 0.0f;
  }
  mbar_wait(sm.kvbar(), 0);
  for (int it = first, i = 0; it < tiles; ++it, ++i) {
    const int slot = i % kSlots, qt0 = it * N;
    const uint32_t parity = (i / kSlots) & 1;
    mbar_wait(sm.full(slot), parity);
    // Skipped: the warpgroup's rows are dead, or all past the tile's reach.
    if (mine && (!p.causal || qt0 + N - 1 + off >= r0)) {
      // S^T = K Q^T and dP^T = V dO^T: fresh arrays, one group, waited for.
      float s[N / 2], dp[kDk ? N / 2 : 1];
      wgmma_fence();
      qk<D, N, kRows, false>(s, sm.k(), sm.q(slot), awg);
      if constexpr (kDk) qk<D, N, kRows, false>(dp, sm.v(), sm.dout(slot), awg);
      wgmma_commit();
      mbar_wait(sm.aux(slot), parity);
      wgmma_wait_all();
      reg_fence(s);
      if constexpr (kDk) reg_fence(dp);
      const float* lsel = sm.lsel(slot);
      const float* dlt = sm.delta(slot);
      const bool whole = rows_whole && qt0 + N <= p.Sq &&
                         (!p.causal || r0 + kWgRows - 1 <= qt0 + off);
      uint32_t keep[2] = {0u, 0u};
      if (!whole) {
        // Column bits: q < Sq and, causal, q >= qmin of the row.
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = qt0 + 8 * j + 2 * t + e;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              keep[hf] |= static_cast<uint32_t>(rowok[hf] && q < p.Sq && q >= qmin[hf])
                          << (2 * j + e);
            }
          }
        }
      }
      uint32_t w[2] = {0u, 0u};
      if (p.dropout) {
        // Only the bits of pairs that attend: the dQ launch wrote no
        // other word.
        const uint32_t* words = sm.drop(slot);
        w[0] = words[rowblk * 4 + t];
        w[1] = words[(rowblk + 8) * 4 + t];
        if (!whole) {
          w[0] &= keep[0];
          w[1] &= keep[1];
        }
      }
      if (whole) {
        if (p.dropout) {
          dkv_tile_math<N, kRole, true, true>(s, dp, lsel, dlt, keep, w, p);
        } else {
          dkv_tile_math<N, kRole, true, false>(s, dp, lsel, dlt, keep, w, p);
        }
      } else if (p.dropout) {
        dkv_tile_math<N, kRole, false, true>(s, dp, lsel, dlt, keep, w, p);
      } else {
        dkv_tile_math<N, kRole, false, false>(s, dp, lsel, dlt, keep, w, p);
      }
      // dV += P'^T dO and dK += dS^T Q, one group, waited for.
      uint32_t pa[kDv ? N / 4 : 1], da[kDk ? N / 4 : 1];
      if constexpr (kDv) pack_p<N>(s, pa);
      if constexpr (kDk) pack_p<N>(dp, da);
      wgmma_fence();
      if constexpr (kDv) pv<D, N, false>(dv, pa, sm.dout(slot));
      if constexpr (kDk) pv<D, N, false>(dk, da, sm.q(slot));
      wgmma_commit();
      wgmma_wait_all();
      if constexpr (kDv) {
        reg_fence(dv);
        reg_fence(pa);
      }
      if constexpr (kDk) {
        reg_fence(dk);
        reg_fence(da);
      }
    } else {
      // The slot goes back only once every producer warp has filled it
      // for this round.
      mbar_wait(sm.aux(slot), parity);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty(slot));
  }
  if constexpr (kDk) store_rows<D>(p.o, p.Skv, p.H, b, h, kv0 + rowblk, dk);
  if constexpr (kDv) store_rows<D>(p.o2, p.Skv, p.H, b, h, kv0 + rowblk, dv);
}

// block = (kRows kv rows, h, b): kv blocks vary fastest, so the blocks of
// one head run together and share its Q and dO in L2, and under causal
// masking the blocks with the most q tiles (smallest kv0) start first.
// kSplit: blocks of 64 kv rows, consumer warpgroup 0 accumulates dV and 1
// dK (S^T computed by both: five products a tile for half the
// accumulator registers a thread); else blocks of 128 rows, each
// warpgroup both gradients for its 64. With dropout the keep bits come
// from p.drop_bits (the dQ launch's). Writes dk to p.o and dv to p.o2.
template <int D, int N, int kSlots, bool kSplit>
__global__ void __launch_bounds__(kThreads, 1)
    attn_dkv_tma_kernel(const Params p, const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap dmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap) {
  constexpr int kRows = kSplit ? kWgRows : kBlockRows;  // the block's kv rows
  using Pl = DkvPlan<D, N, kSlots, kRows>;
  extern __shared__ __align__(1024) uint8_t hopper_smem[];
  const DkvShared<D, N, kSlots, kRows> sm(hopper_smem);
  const int b = blockIdx.z, h = blockIdx.y, kv0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const uint8_t* mrow = p.kvmask ? p.kvmask + static_cast<int64_t>(b) * p.Skv : nullptr;
  // q tiles [first, tiles): under causal masking (kv <= q + Skv - Sq) a
  // tile contributes iff its last row reaches the block's first kv row.
  const int tiles = (p.Sq + N - 1) / N;
  int first = 0;
  if (p.causal) {
    const int need = kv0 - (p.Skv - p.Sq) - (N - 1);  // qt0 >= need
    first = need <= 0 ? 0 : (need + N - 1) / N;
  }
  // The block's kv rows (thread r < kRows tests row kv0 + r): which
  // 64-row halves hold a live row, and whether every row attends.
  bool ok = false;
  if (tid < kRows) ok = kv0 + tid < p.Skv && (mrow == nullptr || mrow[kv0 + tid] != 0);
  const bool rows_whole = __syncthreads_and(ok || tid >= kRows) != 0;
  const bool live0 = __syncthreads_or(ok && tid < kWgRows) != 0;
  const bool live1 = __syncthreads_or(ok && tid >= kWgRows) != 0;
  if ((!live0 && !live1) || first >= tiles) {
    // Nothing attends these kv rows: dK = dV = 0, no product.
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < kRows * D / 8; i += kThreads) {
      const int r = kv0 + i / (D / 8), c = 8 * (i % (D / 8));
      if (r >= p.Skv) continue;
      const int64_t at = ((static_cast<int64_t>(b) * p.Skv + r) * p.H + h) * D + c;
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.o) + at) = zero;
      *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.o2) + at) = zero;
    }
    return;
  }
  if (tid == 0) {
    mbar_init(sm.kvbar(), 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), 8);  // every consumer warp
      mbar_init(sm.aux(s), 4);    // every producer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = tid / 128;
  if (wg == 2) {
    reg_dealloc<kProducerRegs>();
    const int pt = tid - 2 * 128, lane = tid & 31;
    const int64_t row_off = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
    if (pt == 0) {
      mbar_expect_tx(sm.kvbar(), 2 * Pl::kOwnBytes);
      load_tile<D>(sm.k(), kRows, kmap, sm.kvbar(), b, h, kv0);
      load_tile<D>(sm.v(), kRows, vmap, sm.kvbar(), b, h, kv0);
    }
    for (int it = first, i = 0; it < tiles; ++it, ++i) {
      const int slot = i % kSlots, round = i / kSlots, qt0 = it * N;
      if (round > 0) mbar_wait(sm.empty(slot), (round - 1) & 1);
      if (pt == 0) {
        mbar_expect_tx(sm.full(slot), 2 * Pl::kTileBytes);
        load_tile<D>(sm.q(slot), N, qmap, sm.full(slot), b, h, qt0);
        load_tile<D>(sm.dout(slot), N, dmap, sm.full(slot), b, h, qt0);
      }
      if (pt < N) {
        const int q = qt0 + pt;
        const bool in = q < p.Sq;
        sm.lsel(slot)[pt] = in ? p.lse[row_off + q] * kLog2e : 0.0f;
        sm.delta(slot)[pt] = in ? p.delta[row_off + q] : 0.0f;
      }
      if (p.dropout) {
        transpose_dkv_bits<N, kRows>(sm.drop(slot), sm.stage(i), p, row_off, qt0, kv0, pt);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(sm.aux(slot));
    }
  } else {
    reg_alloc<kConsumerRegs>();
    if constexpr (kSplit) {
      if (wg == 0) {
        dkv_consume<D, N, kSlots, kRows, kDvOnly>(sm, p, mrow, b, h, kv0, first, tiles,
                                                   rows_whole, live0, wg);
      } else {
        dkv_consume<D, N, kSlots, kRows, kDkOnly>(sm, p, mrow, b, h, kv0, first, tiles,
                                                   rows_whole, live0, wg);
      }
    } else {
      dkv_consume<D, N, kSlots, kRows, kBothGrads>(sm, p, mrow, b, h, kv0, first, tiles,
                                                    rows_whole, wg == 0 ? live0 : live1, wg);
    }
  }
}

// One configuration of the bf16 dK/dV launch (dk to p.o, dv to p.o2).
template <int D, int N, int kSlots, bool kSplit>
int launch_dkv_with(const Params& p, cudaStream_t stream) {
  constexpr int kRows = kSplit ? kWgRows : kBlockRows;
  using Pl = DkvPlan<D, N, kSlots, kRows>;
  CUtensorMap qmap, dmap, kmap, vmap;
  if (const int e = encode_rows<D>(&qmap, p.q, p.B, p.Sq, p.H, N)) return e;
  if (const int e = encode_rows<D>(&dmap, p.dout, p.B, p.Sq, p.H, N)) return e;
  if (const int e = encode_rows<D>(&kmap, p.k, p.B, p.Skv, p.H, kRows)) return e;
  if (const int e = encode_rows<D>(&vmap, p.v, p.B, p.Skv, p.H, kRows)) return e;
  static bool opted = false;
  const auto kernel = attn_dkv_tma_kernel<D, N, kSlots, kSplit>;
  if (const int e = opt_in_smem(kernel, Pl::kBytes, opted)) return e;
  const dim3 grid(static_cast<unsigned>((p.Skv + kRows - 1) / kRows),
                  static_cast<unsigned>(p.H), static_cast<unsigned>(p.B));
  kernel<<<grid, kThreads, Pl::kBytes, stream>>>(p, qmap, dmap, kmap, vmap);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 dK/dV launch: ptxas keeps the consumers near 168 registers
// whatever setmaxnreg asks, so at D = 128, where dK and dV alone would
// hold 128 f32 registers a thread, blocks split (64 kv rows, one gradient
// per warpgroup); below, blocks of 128 kv rows. Q tiles of 64, rings of 4
// slots. With dropout p.drop_bits holds the keep bits the dQ launch
// wrote (both C entry points require them).
template <int D>
int launch_dkv(const Params& p, cudaStream_t stream) {
  return launch_dkv_with<D, 64, 4, D == 128>(p, stream);
}

}  // namespace
}  // namespace hopper
}  // namespace tpudl
