// Philox4x32-10 (Salmon, Moraes, Dror and Shaw, "Parallel random numbers: as
// easy as 1, 2, 3", SC'11; the Random123 constants), shared by the attention
// dropout kernels so that the forward (attention_dropout.cu), the backward
// (attention_backward.cu) and the mask kernel draw identical bits, with the
// mapping of the draws onto the tensor-core accumulator fragments that the
// bf16 forward and the backward's query kernel share.
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

// The keep bits of one call's four draws, word w in bit w.
__device__ __forceinline__ uint32_t keep_nibble(const uint4& draws, uint32_t threshold) {
  return static_cast<uint32_t>(draws.x < threshold) | static_cast<uint32_t>(draws.y < threshold) << 1 |
         static_cast<uint32_t>(draws.z < threshold) << 2 | static_cast<uint32_t>(draws.w < threshold) << 3;
}

// The keep bits of a lane's 32 mma.m16n8k16 accumulator entries of one
// 16 x 64 score tile whose rows are queries (bit 4j + e for entry e of n8
// tile j): query rows `row` (e < 2) and row + 8, key columns key_start + 8j +
// 2c + (e & 1), for lane = 4g + c. One call covers four key columns of one
// row, and a lane holds column pairs of two rows, so lanes c = 2m and 2m + 1
// need the two halves of the same calls: the even lane draws row `row`, the
// odd one row + 8, and one __shfl_xor_sync(1) of the 32 packed keep bits
// gives each lane the half of its partner's calls that it needs. No call is
// computed twice. The attention-dropout forward (K5) and the query kernel of
// its backward (K4) both take their mask from here. Every lane of the warp
// must call it.
__device__ __forceinline__ uint32_t query_tile_keep_bits(uint32_t seed0, uint32_t seed1, uint32_t threshold,
                                                         int batch_head, int row, int key_start, int lane) {
  const int column = lane & 3;
  const int odd = column & 1;
  uint32_t own = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint4 draws = dropout_draws(seed0, seed1, batch_head, row + 8 * odd, key_start / 4 + 2 * j + (column >> 1));
    own |= keep_nibble(draws, threshold) << (4 * j);
  }
  const uint32_t partner = __shfl_xor_sync(0xffffffffu, own, 1);
  const uint32_t low_row = odd ? partner : own;
  const uint32_t high_row = odd ? own : partner;
  uint32_t kept = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int shift = 4 * j + 2 * odd;  // words 2 * odd, 2 * odd + 1 of each call
    kept |= (((low_row >> shift) & 3u) | ((high_row >> shift) & 3u) << 2) << (4 * j);
  }
  return kept;
}

}  // namespace philox
