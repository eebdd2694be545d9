// A check of the dropout contract's generator, not a kernel of any path:
// philox.cuh's Philox4x32-10 and cuRAND's curand_Philox4x32_10 (a device
// function of the CUDA toolkit's curand_philox4x32_x.h) on the same
// counters and keys, so a test on the card can show that the rounds
// written here are Philox4x32-10; and philox.cuh's keyed philox_block
// (hoisted round keys, one mul.wide.u32 a product) against philox_block,
// so a test can show that the cheaper draw gives the same bits.
#include "common.cuh"
#include "philox.cuh"

#include <curand_philox4x32_x.h>

namespace {

// in: n rows of 6 uint32 (counter words 0-3, key words 0-1); ours, theirs:
// n rows of the 4 output words.
__global__ void philox_pair_kernel(const uint32_t* in, uint32_t* ours, uint32_t* theirs,
                                   int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* r = in + 6 * i;
  const uint4 c = make_uint4(r[0], r[1], r[2], r[3]);
  const uint4 a = tpudl::philox4x32_10(c, r[4], r[5]);
  const uint4 b = curand_Philox4x32_10(c, make_uint2(r[4], r[5]));
  ours[4 * i + 0] = a.x;
  ours[4 * i + 1] = a.y;
  ours[4 * i + 2] = a.z;
  ours[4 * i + 3] = a.w;
  theirs[4 * i + 0] = b.x;
  theirs[4 * i + 1] = b.y;
  theirs[4 * i + 2] = b.z;
  theirs[4 * i + 3] = b.w;
}

// in: n rows of 4 uint32 (counter words 0-1, key words 0-1); keyed, plain:
// n rows of the 4 output words of the keyed and the plain philox_block.
__global__ void philox_keyed_kernel(const uint32_t* in, uint32_t* keyed, uint32_t* plain,
                                    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t* r = in + 4 * i;
  const uint64_t q = (static_cast<uint64_t>(r[1]) << 32) | r[0];
  const uint4 a = tpudl::philox_block(q, tpudl::philox_key(r[2], r[3]));
  const uint4 b = tpudl::philox_block(q, r[2], r[3]);
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w};
  const uint32_t wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    keyed[4 * i + j] = wa[j];
    plain[4 * i + j] = wb[j];
  }
}

}  // namespace

extern "C" int tpudl_philox_pair(const void* in, void* ours, void* theirs, int n,
                                 void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  philox_pair_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(ours),
      static_cast<uint32_t*>(theirs), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpudl_philox_keyed_pair(const void* in, void* keyed, void* plain, int n,
                                       void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  philox_keyed_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(keyed),
      static_cast<uint32_t*>(plain), n);
  return static_cast<int>(cudaGetLastError());
}
