// Philox4x32-10 (Salmon, Moraes, Dror and Shaw, "Parallel random numbers: as
// easy as 1, 2, 3", SC'11; the Random123 constants), shared by the attention
// dropout kernels so that the forward (attention_dropout.cu), the backward
// (attention_backward.cu) and the mask kernel draw identical bits.
//
// The attention-dropout mask is a pure function of two int32 seeds and
// (batch, head, query row, key column):
//   key     = (seed0, seed1) as u32,
//   counter = (col / 4, row, batch * heads + head, 0),
//   draw    = output word col % 4,
// and a weight is kept iff its draw is below keep_threshold(rate). The plain
// PyTorch version is ops/oneshot_attention.py:philox4x32.
#pragma once

#include <stdint.h>

namespace philox {

constexpr uint32_t kMultiplier0 = 0xD2511F53u;
constexpr uint32_t kMultiplier1 = 0xCD9E8D57u;
constexpr uint32_t kWeyl0 = 0x9E3779B9u;
constexpr uint32_t kWeyl1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 counter, uint32_t key0, uint32_t key1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      key0 += kWeyl0;
      key1 += kWeyl1;
    }
    const uint32_t high0 = __umulhi(kMultiplier0, counter.x);
    const uint32_t low0 = kMultiplier0 * counter.x;
    const uint32_t high1 = __umulhi(kMultiplier1, counter.z);
    const uint32_t low1 = kMultiplier1 * counter.z;
    counter = make_uint4(high1 ^ counter.y ^ key0, low1, high0 ^ counter.w ^ key1, low0);
  }
  return counter;
}

// The four draws of key columns 4 * column_quad .. 4 * column_quad + 3 of one
// (batch * heads + head, query row).
__device__ __forceinline__ uint4 dropout_draws(uint32_t seed0, uint32_t seed1, int batch_head, int row,
                                               int column_quad) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(column_quad), static_cast<uint32_t>(row),
                                  static_cast<uint32_t>(batch_head), 0u),
                       seed0, seed1);
}

__device__ __forceinline__ uint32_t word(const uint4& draws, int index) {
  return index == 0 ? draws.x : index == 1 ? draws.y : index == 2 ? draws.z : draws.w;
}

}  // namespace philox
