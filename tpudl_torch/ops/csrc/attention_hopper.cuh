// Hopper machinery shared by the bf16 attention kernels: the two
// forwards, flash_attention.cu (flash_fwd_kernel, the online softmax) and
// fused_attention.cu (whole_fwd_kernel, the whole-row softmax), the two
// dQ launches (flash_dq_tma_kernel, whole_dq_tma_kernel) and the dK/dV
// kernel of attention_dkv.cuh.
//
// One block takes 128 query rows of one (batch row, head) and runs three
// warpgroups (384 threads):
// - warpgroup 2, the producer, gives up registers (setmaxnreg) and one of
//   its threads issues every load: the block's Q tile, then the K and V
//   tiles, by TMA from the callers' [B, S, H, D] layout (a 4-D tensor
//   map over (D, H, S, B); rows past S arrive as zeros). Completion goes
//   to mbarriers ("full"); the consumers hand a ring slot back through
//   its "empty" mbarrier. No __syncthreads after the roles split.
// - warpgroups 0 and 1, the consumers, each own 64 query rows, so every
//   K/V tile that lands serves 128 rows. S = Q K^T is wgmma m64nNk16 with
//   Q and K both read from shared memory (K-major); O += P V is wgmma
//   m64nDk16 with P taken from the S accumulator registers (rounded to
//   bf16 there) and V read from shared memory through the transpose bit.
// Shared-memory tiles are TMA boxes of at most 128-byte rows, swizzled
// 128 B (64 B at D = 32: 64-byte rows), 1024-byte aligned; D = 128 is
// two 64-column boxes. The wgmma descriptors below name the same
// swizzle, so the tensor cores read what TMA wrote.
//
// The mask: before the roles split, the block turns its batch row's kv
// mask into two bits per kv tile: "gap" (some kv of the tile is masked or
// past Skv) and "live" (some kv is not masked). A tile that is not live
// is neither loaded nor computed (it adds nothing); a tile without a gap,
// below the causal diagonal and inside Sq needs no per-element check.
//
// Dropout: one Philox4x32-10 block for every four elements (philox.cuh's
// contract, bit for bit). In flash the consumers draw it: in the m64nN
// accumulator lanes t and t^1 hold four consecutive columns starting at
// a multiple of 4; each lane of the pair computes the block for one of
// two n-tiles and they trade words (dropout). In the whole-row forward
// the producer warps draw the keep bits of every tile into shared memory
// while the consumers run the first sweep (draw_drop_bits), and the
// second sweep only tests them (apply_drop_bits). In the dQ launches the
// producer warps draw each live tile's bits once (draw_tile_bits: flash
// into the tile's ring slot) and also write them in row order to device
// memory, for the dK/dV launch, which never draws.
//
// Why the products wait inside each step: a Q K^T issued while a P.V is
// in flight made ptxas serialise every wgmma of the kernel (C7515: the
// accumulator's earlier value copied into its registers inside the
// pipeline stage), and a second score array in flight spilled. Each Q K^T
// writes a fresh array; the two consumer warpgroups interleave on the SM.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <limits.h>

#include "attention_tiles.cuh"

namespace tpudl {
namespace hopper {

using attn::kMaskValue;
using attn::Params;

constexpr int kWgRows = 64;      // query rows per consumer warpgroup
constexpr int kBlockRows = 128;  // two consumer warpgroups
constexpr int kThreads = 384;    // and the producer warpgroup
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;  // 128 x 56 + 256 x 224 <= 65536
constexpr int kMaskWords = 32;      // gap / live bits for 1024 kv tiles

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` of the barrier has completed.
// A wait that never ends (a fault in the pipeline) traps after ~2^26
// tries, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// One TMA box of a 4-D tensor map into shared memory; completion (its
// bytes) goes to `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
template <int R>
__device__ __forceinline__ void reg_fence(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// The same for P's A fragments: a P.V in flight reads them, so they stay
// live (their registers unclaimed) until it has been waited for.
template <int R>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle (1: 128 B, 2: 64 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// wgmma.mma_async m64nNk16, bf16 operands, f32 accumulator: thread t of
// the warpgroup holds, for n-tile j (8 columns), d[4j], d[4j + 1] at row
// 16 (t / 32) + (t % 32) / 4, columns 8j + 2 (t % 4) + {0, 1}, and
// d[4j + 2], d[4j + 3] eight rows below. `accumulate` 0 ignores d.
template <int N> struct Wgmma;

template <> struct Wgmma<64> {
  // D[64, 64] (+)= A B, A and B from shared memory, both K-major.
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b,
                                            uint32_t accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // D[64, 64] (+)= A B, A from registers (the m16n8k16 A fragment per
  // warp), B from shared memory, MN-major (the transpose bit).
  static __device__ __forceinline__ void rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t b,
                                            uint32_t accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
  }
};

template <> struct Wgmma<128> {
  // D[64, 128] (+)= A B, A and B from shared memory, both K-major.
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b,
                                            uint32_t accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // D[64, 128] (+)= A B, A from registers (the m16n8k16 A fragment per
  // warp), B from shared memory, MN-major (the transpose bit).
  static __device__ __forceinline__ void rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t b,
                                            uint32_t accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
  }
};

template <> struct Wgmma<32> {
  // D[64, 32] (+)= A B, A from registers (the m16n8k16 A fragment per
  // warp), B from shared memory, MN-major (the transpose bit).
  static __device__ __forceinline__ void rs(float (&d)[16], uint32_t a0, uint32_t a1,
                                            uint32_t a2, uint32_t a3, uint64_t b,
                                            uint32_t accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(accumulate));
  }
};

// ---------------------------------------------------------------------------
// Tiles
// ---------------------------------------------------------------------------

// A [rows, D] bf16 tile as TMA lands it: D / kBoxCols boxes of [rows,
// kBoxCols], each row kRowBytes, swizzled.
template <int D> struct Geom {
  static_assert(D == 32 || D == 64 || D == 128, "head dims 32, 64, 128");
  static constexpr int kRowBytes = D == 32 ? 64 : 128;
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr uint32_t kLayout = D == 32 ? 2 : 1;
  static constexpr uint32_t kGroup = 8 * kRowBytes;  // 8 rows: one swizzle pattern
};

// The block's shared memory: kOwn tiles of the block's 128 rows (Q; the
// dQ launches also dO), kSlots K and V tiles of N rows, then the
// barriers (q, kfull, vfull, empty per slot; one per dropout tile), the
// tile bits and, for kDropTiles kv tiles (flash's dQ launch: one per
// ring slot), the dropout keep bits the producer warps draw (4 words per
// block row and tile, see draw_tile_bits).
template <int D, int N, int kSlots, int kDropTiles = 0, int kOwn = 1> struct Plan {
  static constexpr uint32_t kQBytes = kBlockRows * D * 2;
  static constexpr uint32_t kTileBytes = N * D * 2;
  static constexpr uint32_t kK = kOwn * kQBytes;
  static constexpr uint32_t kV = kK + kSlots * kTileBytes;
  static constexpr uint32_t kBars = kV + kSlots * kTileBytes;
  static constexpr uint32_t kDbars = kBars + 8 * (1 + 3 * kSlots);
  static constexpr uint32_t kBits = kDbars + 8 * kDropTiles;
  static constexpr uint32_t kDrop = (kBits + 2 * 4 * kMaskWords + 15) / 16 * 16;
  static constexpr uint32_t kEnd = kDrop + kDropTiles * kBlockRows * 4 * 4;
  // + slack to align the base to 1024 bytes.
  static constexpr size_t kBytes = kEnd + 1024;
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// The block's view of its shared memory.
template <int D, int N, int kSlots, int kDropTiles = 0, int kOwn = 1> struct Shared {
  using P = Plan<D, N, kSlots, kDropTiles, kOwn>;
  static constexpr int kN = N, kRing = kSlots, kDrops = kDropTiles;
  uint8_t* base;  // 1024-byte aligned
  uint32_t addr;  // its shared address
  __device__ __forceinline__ explicit Shared(uint8_t* raw) {
    const uint32_t a = smem_u32(raw);
    const uint32_t pad = (1024u - (a & 1023u)) & 1023u;
    base = raw + pad;
    addr = a + pad;
  }
  __device__ __forceinline__ uint32_t q() const { return addr; }
  // Own tile i (0: Q; 1: dO in the whole-row dQ launch).
  __device__ __forceinline__ uint32_t own(int i) const { return addr + i * P::kQBytes; }
  __device__ __forceinline__ uint32_t k(int slot) const {
    return addr + P::kK + slot * P::kTileBytes;
  }
  __device__ __forceinline__ uint32_t v(int slot) const {
    return addr + P::kV + slot * P::kTileBytes;
  }
  __device__ __forceinline__ uint32_t qbar() const { return addr + P::kBars; }
  __device__ __forceinline__ uint32_t kfull(int s) const { return addr + P::kBars + 8 * (1 + s); }
  __device__ __forceinline__ uint32_t vfull(int s) const {
    return addr + P::kBars + 8 * (1 + kSlots + s);
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return addr + P::kBars + 8 * (1 + 2 * kSlots + s);
  }
  // The keep bits of dropout tile t are written.
  __device__ __forceinline__ uint32_t dbar(int t) const { return addr + P::kDbars + 8 * t; }
  __device__ __forceinline__ uint32_t* gap() const {
    return reinterpret_cast<uint32_t*>(base + P::kBits);
  }
  __device__ __forceinline__ uint32_t* live() const { return gap() + kMaskWords; }
  __device__ __forceinline__ uint32_t* drop() const {
    return reinterpret_cast<uint32_t*>(base + P::kDrop);
  }
};

// Bits of kv tile t (tiles past the bit array: a gap, and live).
__device__ __forceinline__ bool tile_bit(const uint32_t* bits, int t) {
  return t >= 32 * kMaskWords || ((bits[t >> 5] >> (t & 31)) & 1u);
}

// Every thread of the block: initialise the barriers (empty ones take
// one arrival per consumer warp, dropout ones one per drawing producer
// warp) and form the gap / live bits of the
// batch row's kv tiles of N rows; ends with __syncthreads, before the
// roles split.
template <class Sh>
__device__ __forceinline__ void block_setup(const Sh& sm, const Params& p, const uint8_t* mrow,
                                            int draw_warps = 0) {
  constexpr int N = Sh::kN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(sm.qbar(), 1);
    for (int s = 0; s < Sh::kRing; ++s) {
      mbar_init(sm.kfull(s), 1);
      mbar_init(sm.vfull(s), 1);
      mbar_init(sm.empty(s), 8);
    }
    for (int t = 0; t < Sh::kDrops; ++t) mbar_init(sm.dbar(t), draw_warps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 2 * kMaskWords) sm.gap()[tid] = 0u;  // gap and live
  __syncthreads();
  // 32 kv per warp step; N is a multiple of 32, so a chunk is in one tile.
  const int chunks = min((p.Skv + 31) / 32, kMaskWords * N);
  for (int c = warp; c < chunks; c += kThreads / 32) {
    const int kv = 32 * c + lane;
    const bool on = kv < p.Skv && (mrow == nullptr || mrow[kv] != 0);
    const uint32_t ones = __ballot_sync(0xffffffffu, on);
    if (lane == 0) {
      const int t = 32 * c / N;
      if (ones != 0xffffffffu) atomicOr(sm.gap() + (t >> 5), 1u << (t & 31));
      if (ones != 0u) atomicOr(sm.live() + (t >> 5), 1u << (t & 31));
    }
  }
  __syncthreads();
}

// kv tiles of N rows that rows [r0, r0 + rows) can reach: all of them, or
// under causal masking (kv <= q + Skv - Sq) those up to the diagonal of
// the last row in range.
__device__ __forceinline__ int reach_tiles(const Params& p, int r0, int rows, int n) {
  const int all = (p.Skv + n - 1) / n;
  const int last = min(r0 + rows, p.Sq) - 1;
  if (last < r0) return 0;
  if (!p.causal) return all;
  const int kv_last = last + (p.Skv - p.Sq);
  return kv_last < 0 ? 0 : min(all, kv_last / n + 1);
}

// Whether every (q, kv) of the warpgroup's rows [r0, r0 + 64) and kv tile
// [kv0, kv0 + n) attends.
__device__ __forceinline__ bool tile_whole(const Params& p, bool gap, int r0, int kv0, int n) {
  return !gap && r0 + kWgRows <= p.Sq && kv0 + n <= p.Skv &&
         (!p.causal || kv0 + n - 1 <= r0 + (p.Skv - p.Sq));
}

// The producer's loads of a [rows, D] tile starting at sequence row
// `row` of (b, h) into `dst`; the caller has armed `bar`.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, int rows, const CUtensorMap& map,
                                          uint32_t bar, int b, int h, int row) {
  using G = Geom<D>;
#pragma unroll
  for (int box = 0; box < G::kBoxes; ++box) {
    tma_load(dst + box * rows * G::kRowBytes, map, bar, box * G::kBoxCols, h, row, b);
  }
}

// S = Q K^T for consumer warpgroup `wg`: its 64 rows of the kARows-row Q
// tile at `sq` against the N-row K tile at `sk`. Issued, not waited for;
// kGroup: fenced and committed as a group of its own, else the caller
// fences and commits.
template <int D, int N, int kARows = kBlockRows, bool kGroup = true>
__device__ __forceinline__ void qk(float (&s)[N / 2], uint32_t sq, uint32_t sk, int wg) {
  using G = Geom<D>;
  if constexpr (kGroup) wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk * 16 / G::kBoxCols, col = kk * 16 % G::kBoxCols;
    const uint32_t a = sq + box * kARows * G::kRowBytes + wg * kWgRows * G::kRowBytes + 2 * col;
    const uint32_t b = sk + box * N * G::kRowBytes + 2 * col;
    Wgmma<N>::ss(s, smem_desc(a, 0, G::kGroup, G::kLayout), smem_desc(b, 0, G::kGroup, G::kLayout),
                 kk > 0);
  }
  if constexpr (kGroup) wgmma_commit();
}

// O += P V: P [64, N] as bf16 A fragments (4 registers per 16 columns),
// V the N-row tile at `sv` (MN-major: D is contiguous). Issued, not
// waited for; kGroup as qk.
template <int D, int N, bool kGroup = true>
__device__ __forceinline__ void pv(float (&o)[D / 2], const uint32_t (&pa)[N / 4], uint32_t sv) {
  using G = Geom<D>;
  if constexpr (kGroup) wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t b = sv + kk * 16 * G::kRowBytes;
    Wgmma<D>::rs(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                 smem_desc(b, N * G::kRowBytes, G::kGroup, G::kLayout), 1);
  }
  if constexpr (kGroup) wgmma_commit();
}

// P's A fragments from the accumulator layout: 16 columns are n-tiles 2kk
// and 2kk + 1; rows g and g + 8.
template <int N>
__device__ __forceinline__ void pack_p(const float (&s)[N / 2], uint32_t (&pa)[N / 4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pa[4 * kk + r] = attn::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    }
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the MUFU unit (what __expf runs after its multiply by log2 e).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Which entries of a tile in the m64nN accumulator layout attend: the
// kv mask and Skv per column, Sq and the causal diagonal per row, as
// predicates (no branch per element). `row` is the thread's first row
// (g); the second is row + 8; columns kv0 + 8j + 2t + e.
template <int N> struct TileKeep {
  static_assert(N / 4 <= 32, "one bit per column of the thread");
  uint32_t cols = 0;  // bit 2j + e: column kv0 + 8j + 2t + e
  int lim[2];
  bool in[2];
  int first;  // kv0 + 2t: the thread's column of j = e = 0
  __device__ __forceinline__ TileKeep(const Params& p, const uint8_t* mrow, int row, int kv0) {
    const int t = threadIdx.x & 3;
    first = kv0 + 2 * t;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        cols |= static_cast<uint32_t>(first + 8 * j + e < p.Skv) << (2 * j + e);
      }
    }
    if (mrow != nullptr) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = min(first + 8 * j + e, p.Skv - 1);
          cols &= ~(static_cast<uint32_t>(mrow[c] == 0) << (2 * j + e));
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      in[hf] = row + 8 * hf < p.Sq;
      lim[hf] = p.causal ? row + 8 * hf + (p.Skv - p.Sq) : INT_MAX;
    }
  }
  // Element i of the thread's N / 2 (n-tile i / 4, row (i & 3) / 2, column i & 1).
  __device__ __forceinline__ bool operator()(int i) const {
    const int j = i >> 2, hf = (i & 3) >> 1, e = i & 1;
    return ((cols >> (2 * j + e)) & 1u) && in[hf] && first + 8 * j + e <= lim[hf];
  }
};

// A tile's logits (scaled) with the entries that do not attend set to
// MASK_VALUE.
template <int N>
__device__ __forceinline__ void mask_tile(float (&s)[N / 2], const Params& p, const uint8_t* mrow,
                                          int row, int kv0) {
  const TileKeep<N> keep(p, mrow, row, kv0);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] = keep(i) ? s[i] * p.scale : kMaskValue;
}

// The backward's probabilities in place: p = exp(s * scale - lse) from a
// tile's raw logits, one FFMA and one MUFU.EX2 each (lsel: the lse of the
// thread's two rows times log2 e); unless the tile is whole, 0 where the
// pair does not attend.
template <int N, bool kWhole>
__device__ __forceinline__ void tile_p(float (&s)[N / 2], const Params& p, const uint8_t* mrow,
                                       int row, int kv0, const float (&lsel)[2]) {
  const float k = p.scale * kLog2e;
  if constexpr (kWhole) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s[i] = ex2(fmaf(s[i], k, -lsel[(i & 3) >> 1]));
  } else {
    const TileKeep<N> keep(p, mrow, row, kv0);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float pe = ex2(fmaf(s[i], k, -lsel[(i & 3) >> 1]));
      s[i] = keep(i) ? pe : 0.0f;
    }
  }
}

// The thread's row maxima of a tile (rows g, g + 8), from `m`: of the raw
// logits times the scale when the tile is whole, of the masked, scaled
// logits otherwise.
template <int N, bool kWhole>
__device__ __forceinline__ void tile_max(const float (&s)[N / 2], float scale, float (&m)[2]) {
  float mt[2] = {s[0], s[2]};  // rows g, g + 8
#pragma unroll
  for (int i = 0; i < N / 2; ++i) mt[(i & 3) >> 1] = fmaxf(mt[(i & 3) >> 1], s[i]);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) m[hf] = fmaxf(m[hf], kWhole ? mt[hf] * scale : mt[hf]);
}

// p = exp(x - m[row]) in place (x = s * scale for a whole tile's raw
// logits; for a masked tile x = s and entries at MASK_VALUE give 0), one
// FFMA and one MUFU.EX2 each; returns the thread's row sums in `sum`.
template <int N, bool kWhole>
__device__ __forceinline__ void tile_exp(float (&s)[N / 2], float scale, const float (&m)[2],
                                         float (&sum)[2]) {
  const float k = kWhole ? scale * kLog2e : kLog2e;
  const float ml[2] = {m[0] * kLog2e, m[1] * kLog2e};
  sum[0] = sum[1] = 0.0f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int hf = (i & 3) >> 1;
    float pe = ex2(fmaf(s[i], k, -ml[hf]));
    // Masked logits hold MASK_VALUE: exactly the entries at or below it.
    if (!kWhole) pe = s[i] > kMaskValue ? pe : 0.0f;
    sum[hf] += pe;
    s[i] = pe;
  }
}

// Drop the probabilities of a tile (0 where the bits fall below the
// threshold, p * scale_kept elsewhere). rowbase[hf]: flat index of row
// g + 8 hf, column 0. When Skv % 4 == 0 every row starts on a Philox
// block: lanes t and t^1 hold four consecutive columns from a multiple
// of 4, each computes the block of one of two n-tiles and they trade the
// words the other holds. Otherwise a row's groups straddle two blocks:
// the words come element by element.
template <int N>
__device__ __forceinline__ void dropout(float (&s)[N / 2], const Params& p,
                                        const uint64_t (&rowbase)[2], int kv0, uint32_t k0,
                                        uint32_t k1, float scale_kept) {
  const int t = threadIdx.x & 3, odd = t & 1;
  if ((p.Skv & 3) == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int jj = 0; jj < N / 16; ++jj) {
        const uint64_t f = rowbase[hf] + kv0 + 8 * (2 * jj + odd) + 4 * (t >> 1);
        const uint4 blk = philox_block(f >> 2, k0, k1);
        const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? blk.x : blk.z, 1);
        const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? blk.y : blk.w, 1);
        // Columns 2t, 2t + 1 of n-tile 2jj, then of n-tile 2jj + 1.
        const uint32_t w[4] = {odd ? r0 : blk.x, odd ? r1 : blk.y, odd ? blk.z : r0,
                               odd ? blk.w : r1};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = s[8 * jj + 4 * (e >> 1) + 2 * hf + (e & 1)];
          x = w[e] >= p.threshold ? x * scale_kept : 0.0f;
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const int j = i >> 2, hf = (i & 3) >> 1, e = i & 1;
      const uint32_t w = philox_bits(rowbase[hf] + kv0 + 8 * j + 2 * t + e, k0, k1);
      s[i] = w >= p.threshold ? s[i] * scale_kept : 0.0f;
    }
  }
}

// Two keep bits (kept: bits >= threshold), the first in bit 0.
__device__ __forceinline__ uint32_t keep2(uint32_t a, uint32_t b, uint32_t threshold) {
  return static_cast<uint32_t>(a >= threshold) | static_cast<uint32_t>(b >= threshold) << 1;
}

// The keep bits of the block's rows against kv tile t of N columns, drawn
// by producer thread dt of `threads`: 4 words per block row into `words`
// (the tile's kBlockRows x 4 words) in the consumers' order: word t' holds,
// at bit 2j + e, column 8j + 2t' + e of the tile (the columns thread t' of
// a quad holds in the m64nN layout). Philox4x32-10 blocks of philox.cuh's
// contract; when Skv % 4 != 0 a row starts mid-block and its bits come
// element by element. With p.drop_bits set (the backwards' dQ launches)
// the bits also go to device memory in row order, for the dK/dV launch.
template <int N>
__device__ __forceinline__ void draw_tile_bits(uint32_t* words, const Params& p, int b, int h,
                                               int q0, int t, uint32_t k0, uint32_t k1, int dt,
                                               int threads) {
  static_assert(N % 32 == 0 && N / 4 <= 32, "a word per quad thread and row; whole row words");
  for (int r = dt; r < kBlockRows; r += threads) {
    uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;
    uint32_t pl[4] = {0u, 0u, 0u, 0u};  // row order: bit c % 32 of word c / 32
    // Column byte j (columns 8j .. 8j + 7) into the row-order words.
    auto put = [&](int j, uint32_t byte) {
      const uint32_t sh = byte << (8 * (j & 3));
#pragma unroll
      for (int x = 0; x < N / 32; ++x) pl[x] |= (j >> 2) == x ? sh : 0u;
    };
    const int q = q0 + r;
    if (q < p.Sq) {
      const uint64_t base = ((static_cast<uint64_t>(b) * p.H + h) * p.Sq + q) *
                                static_cast<uint64_t>(p.Skv) + static_cast<uint64_t>(t) * N;
      if ((p.Skv & 3) == 0) {
        // Unrolled for four independent Philox chains in flight.
#pragma unroll 2
        for (int j = 0; j < N / 8; ++j) {
          const uint4 lo = philox_block((base >> 2) + 2 * j, k0, k1);     // columns 8j .. 8j+3
          const uint4 hi = philox_block((base >> 2) + 2 * j + 1, k0, k1); // 8j+4 .. 8j+7
          const uint32_t a = keep2(lo.x, lo.y, p.threshold), c = keep2(lo.z, lo.w, p.threshold);
          const uint32_t d = keep2(hi.x, hi.y, p.threshold), f = keep2(hi.z, hi.w, p.threshold);
          w0 |= a << (2 * j);
          w1 |= c << (2 * j);
          w2 |= d << (2 * j);
          w3 |= f << (2 * j);
          put(j, a | c << 2 | d << 4 | f << 6);
        }
      } else {
        for (int j = 0; j < N / 8; ++j) {
          uint32_t e[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) e[u] = philox_bits(base + 8 * j + u, k0, k1) >= p.threshold;
          w0 |= (e[0] | e[1] << 1) << (2 * j);
          w1 |= (e[2] | e[3] << 1) << (2 * j);
          w2 |= (e[4] | e[5] << 1) << (2 * j);
          w3 |= (e[6] | e[7] << 1) << (2 * j);
          put(j, e[0] | e[1] << 1 | e[2] << 2 | e[3] << 3 | e[4] << 4 | e[5] << 5 | e[6] << 6 |
                     e[7] << 7);
        }
      }
      if (p.drop_bits != nullptr) {
        uint32_t* row = p.drop_bits + ((static_cast<int64_t>(b) * p.H + h) * p.Sq + q) *
                                          p.drop_words;
#pragma unroll
        for (int x = 0; x < N / 32; ++x) {
          const int word = t * (N / 32) + x;
          if (word < p.drop_words) row[word] = pl[x];
        }
      }
    }
    *reinterpret_cast<uint4*>(words + r * 4) = make_uint4(w0, w1, w2, w3);
  }
}

// The producer's share of dropout (the whole-row forward and dQ launch):
// the last `warps` warps of the producer warpgroup draw the keep bits of
// the block's rows for each live kv tile t < tiles of N columns
// (draw_tile_bits), while the consumers run the first sweep, and arrive
// on dbar(t) once a tile's bits are written.
template <class Sh>
__device__ __forceinline__ void draw_drop_bits(const Sh& sm, const Params& p, int b, int h, int q0,
                                               int tiles, uint32_t k0, uint32_t k1, int warps) {
  const int dt = threadIdx.x - (kThreads - 32 * warps);  // 0 .. 32 * warps - 1
  for (int t = 0; t < tiles; ++t) {
    if (!tile_bit(sm.live(), t)) continue;
    draw_tile_bits<Sh::kN>(sm.drop() + t * kBlockRows * 4, p, b, h, q0, t, k0, k1, dt, 32 * warps);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(sm.dbar(t));
  }
}

// Drop a tile's probabilities by the producer's bits (tile t; `rowblk`:
// the thread's first row within the block): kept entries stay as they
// are (the scale is folded into the normalisation), dropped ones are 0.
template <int N>
__device__ __forceinline__ void apply_drop_bits(float (&s)[N / 2], const uint32_t* words, int t,
                                                int rowblk) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const uint32_t w = words[(t * kBlockRows + rowblk + 8 * hf) * 4 + tq];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * hf + e];
        x = (w >> (2 * j + e)) & 1u ? x : 0.0f;
      }
    }
  }
}

// The backward's dp by the producer's bits (tile t, as apply_drop_bits):
// kept entries scaled by 1 / (1 - rate), dropped ones 0.
template <int N>
__device__ __forceinline__ void drop_scaled(float (&s)[N / 2], const uint32_t* words, int t,
                                            int rowblk, float inv_keep) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const uint32_t w = words[(t * kBlockRows + rowblk + 8 * hf) * 4 + tq];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * hf + e];
        x = (w >> (2 * j + e)) & 1u ? x * inv_keep : 0.0f;
      }
    }
  }
}

// Store a warpgroup's [64, D] accumulator rows (thread rows `row`, row +
// 8) of (b, h) to a [B, S, H, D] bf16 tensor, rounded; rows past S are
// not stored.
template <int D>
__device__ __forceinline__ void store_rows(void* base, int S, int H, int b, int h, int row,
                                           const float (&o)[D / 2]) {
  const int t = threadIdx.x & 3;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(base);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row + 8 * hf;
    if (r >= S) continue;
    __nv_bfloat16* dst = out + ((static_cast<int64_t>(b) * S + r) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * hf], o[4 * j + 2 * hf + 1]);
    }
  }
}

// The forward's O rows, rounded to bf16; rows past Sq are not stored.
template <int D>
__device__ __forceinline__ void store_o(const Params& p, int b, int h, int row,
                                        const float (&o)[D / 2]) {
  store_rows<D>(p.o, p.Sq, p.H, b, h, row, o);
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found{};
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
    if (found != cudaDriverEntryPointSuccess) return nullptr;
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault);
#endif
    if (err != cudaSuccess || ptr == nullptr) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The map of a [b, s, h, D] bf16 tensor at `base` (16-byte aligned):
// dims (D, h, s, b), boxes of (kBoxCols, 1, rows, 1), zero fill past s.
template <int D>
inline int encode_rows(CUtensorMap* map, const void* base, int b, int s, int h, int rows) {
  using G = Geom<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorInitializationError;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row_bytes, row_bytes * h, row_bytes * h * s};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(G::kBoxCols), 1u,
                             static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The q, k and v maps of a forward: q boxes of the block's 128 rows, k
// and v boxes of N rows.
struct Maps {
  CUtensorMap q, k, v;
};

template <int D, int N>
inline int encode_maps(Maps* m, const Params& p) {
  if (const int e = encode_rows<D>(&m->q, p.q, p.B, p.Sq, p.H, kBlockRows)) return e;
  if (const int e = encode_rows<D>(&m->k, p.k, p.B, p.Skv, p.H, N)) return e;
  return encode_rows<D>(&m->v, p.v, p.B, p.Skv, p.H, N);
}

// Above 48 KB only as opted-in dynamic shared memory; once per kernel,
// before any graph capture (the first call of each runs eagerly).
template <typename Kernel>
inline int opt_in_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  done = true;
  return 0;
}

}  // namespace hopper
}  // namespace tpudl
