// The in-kernel dropout contract of the tpudl_torch Hopper kernels: a keep
// mask that is a pure function of two uint32 seed words, the tensor's shape
// and each element's flat index.
//
// Replaces, in tpudl/ops/pallas_utils.py, seed_cell / keep_mask (the TPU
// hardware PRNG reseeded per grid cell, whose bits depend on the tiling).
// Here the bits of element i of the unpadded [B, H, Sq, Skv] tensor are
//
//   word (i mod 4) of Philox4x32-10(counter = (i / 4) as a 128-bit integer,
//                                   key = (seed[0], seed[1]))
//
// so they do not depend on how a kernel blocks its work, and the forward
// and the backward (and the plain PyTorch twin in ops/keep_mask.py, which
// runs the same rounds in int64 arithmetic) draw the same bits. An element
// is kept when bits >= threshold = round(rate * 2^32), as tpudl's
// keep_mask, and scaled by 1 / (1 - rate) at the nominal rate.
//
// The rounds are Salmon et al., "Parallel random numbers: as easy as
// 1, 2, 3" (SC'11), Philox4x32 with 10 rounds: the same function as
// cuRAND's curand_Philox4x32_10 (tests/test_torch_kernels_cuda.py holds
// them against each other on the card).
#pragma once

#include <stdint.h>

namespace tpudl {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox_round(uint4 c, uint32_t k0, uint32_t k1) {
  const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
  const uint32_t lo0 = kPhiloxM0 * c.x;
  const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
  const uint32_t lo1 = kPhiloxM1 * c.z;
  return make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
}

// Philox4x32-10 of the 128-bit counter c under the 64-bit key (k0, k1).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    c = philox_round(c, k0, k1);
  }
  return c;
}

// The four words of the block holding flat elements [4q, 4q + 4).
__device__ __forceinline__ uint4 philox_block(uint64_t q, uint32_t k0, uint32_t k1) {
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32), 0u, 0u), k0, k1);
}

__device__ __forceinline__ uint32_t philox_word(const uint4& w, int j) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

// The bits of one flat element index.
__device__ __forceinline__ uint32_t philox_bits(uint64_t index, uint32_t k0, uint32_t k1) {
  return philox_word(philox_block(index >> 2, k0, k1), static_cast<int>(index & 3));
}

// The ten round keys of (k0, k1), formed once by a thread that draws many
// blocks under one key.
struct PhiloxKey {
  uint32_t k0[10];
  uint32_t k1[10];
};

__device__ __forceinline__ PhiloxKey philox_key(uint32_t k0, uint32_t k1) {
  PhiloxKey k;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    k.k0[r] = k0 + static_cast<uint32_t>(r) * kPhiloxW0;
    k.k1[r] = k1 + static_cast<uint32_t>(r) * kPhiloxW1;
  }
  return k;
}

// Both halves of a * m from one mul.wide.u32 (one IMAD.WIDE.U32).
__device__ __forceinline__ void mul_wide(uint32_t a, uint32_t m, uint32_t& hi, uint32_t& lo) {
  uint64_t p;
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(p) : "r"(a), "r"(m));
  hi = static_cast<uint32_t>(p >> 32);
  lo = static_cast<uint32_t>(p);
}

// philox_block(q, k0, k1) bit for bit, in fewer instructions: the round
// keys come hoisted, each product's halves from one mul.wide.u32, and the
// counter's words 2 and 3 are 0, so the first round has one product.
__device__ __forceinline__ uint4 philox_block(uint64_t q, const PhiloxKey& k) {
  uint32_t hi0, lo0, hi1, lo1;
  mul_wide(static_cast<uint32_t>(q), kPhiloxM0, hi0, lo0);
  uint4 c = make_uint4(static_cast<uint32_t>(q >> 32) ^ k.k0[0], 0u, hi0 ^ k.k1[0], lo0);
#pragma unroll
  for (int r = 1; r < 10; ++r) {
    mul_wide(c.x, kPhiloxM0, hi0, lo0);
    mul_wide(c.z, kPhiloxM1, hi1, lo1);
    c = make_uint4(hi1 ^ c.y ^ k.k0[r], lo1, hi0 ^ c.w ^ k.k1[r], lo0);
  }
  return c;
}

}  // namespace tpudl
