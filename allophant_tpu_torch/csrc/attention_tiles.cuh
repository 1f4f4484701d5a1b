// Tensor-core building blocks of the bf16 attention kernels (K1's forward in
// oneshot_attention.cu, K5's forward with dropout in attention_dropout.cu,
// K4's backward in attention_backward.cu): 64-row bf16
// tiles of one head in shared memory, filled by 16-byte cp.async, read into
// mma.sync.m16n8k16 fragments by ldmatrix.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), for lane
// = 4 * g + c of a warp (g = lane / 4, c = lane % 4):
//   A (16 x 16, row-major) a[0..3]: rows g, g + 8 x columns {2c, 2c + 1} and
//     {2c + 8, 2c + 9}, in the order (g, low), (g + 8, low), (g, high),
//     (g + 8, high), two bf16 to a register, the lower column in the low half;
//   B (16 x 8) b[0..1]: column g x rows {2c, 2c + 1} and {2c + 8, 2c + 9};
//   C (16 x 8, f32) d[0..3]: rows g, g, g + 8, g + 8 x columns 2c, 2c + 1.
// So the accumulators of two neighbouring n8 tiles of a product, rounded to
// bf16 and packed in pairs, are exactly an A fragment of the next product
// whose reduction runs over those 16 columns: scores become weights in
// registers, with no shared-memory round trip.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tiles {

constexpr int kRows = 64;     // rows (queries or keys) of a tile
constexpr int kHeadDim = 64;  // every released wav2vec2 / XLS-R encoder
constexpr int kThreads = 128;  // four warps, 16 rows each
// bf16 elements per shared-memory row: 144 bytes, so the eight 16-byte rows
// that one ldmatrix 8x8 reads fall on eight distinct groups of four banks.
constexpr int kStride = kHeadDim + 8;
constexpr int kTileElements = kRows * kStride;
constexpr int kTileBytes = kTileElements * 2;
// A key is valid iff its bias is above NEG_INF / 2 (ops/oneshot_attention.py).
constexpr float kValidBias = -5e8f;

__device__ __forceinline__ uint32_t shared_address(const void* pointer) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(pointer));
}

// Starts the copy of rows start .. start + 63 of one head (64 bf16 from
// `base + t * time_stride`) into `tile`; rows at or past `time` are zero-filled
// (cp.async reads 0 bytes of them). The caller commits the group.
__device__ __forceinline__ void copy_tile_async(__nv_bfloat16* tile, const __nv_bfloat16* base,
                                                long long time_stride, int start, int time) {
#pragma unroll
  for (int step = 0; step < kRows * 8 / kThreads; ++step) {
    const int chunk = threadIdx.x + step * kThreads;
    const int row = chunk >> 3;
    const int column = (chunk & 7) * 8;
    const int t = start + row;
    const bool inside = t < time;
    const __nv_bfloat16* source = base + static_cast<long long>(inside ? t : 0) * time_stride + column;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_address(tile + row * kStride + column)),
                 "l"(source), "r"(inside ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most `Pending` committed groups of this thread are in flight.
template <int Pending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&out)[4], const __nv_bfloat16* pointer) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(out[0]), "=r"(out[1]), "=r"(out[2]), "=r"(out[3])
               : "r"(shared_address(pointer))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&out)[4], const __nv_bfloat16* pointer) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(out[0]), "=r"(out[1]), "=r"(out[2]), "=r"(out[3])
               : "r"(shared_address(pointer))
               : "memory");
}

// d += a b on the tensor cores: bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9},"
      " {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 and packed, `low` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float low, float high) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(low, high);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

// The A fragments of rows row0 .. row0 + 15 over all 64 columns of a tile
// (a[k] covers columns 16k .. 16k + 15).
__device__ __forceinline__ void load_a_fragments(uint32_t (&a)[4][4], const __nv_bfloat16* tile, int row0, int lane) {
#pragma unroll
  for (int k = 0; k < 4; ++k) ldmatrix_x4(a[k], tile + (row0 + (lane & 15)) * kStride + 16 * k + (lane >> 4) * 8);
}

// B fragments of out[r][n] += sum_k a[r][k] tile[n][k]: the tile holds B
// transposed (rows n, e.g. keys for q.k^T). For rows n0 .. n0 + 15 and
// reduction columns k0 .. k0 + 15: b[0], b[1] of the n8 tile n0 and b[2], b[3]
// of the n8 tile n0 + 8.
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const __nv_bfloat16* tile, int n0, int k0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * kStride + k0 + ((lane >> 3) & 1) * 8);
}

// B fragments of out[r][n] += sum_k a[r][k] tile[k][n]: the tile holds B as
// it is (rows k, e.g. keys for p.v), read transposed by ldmatrix.trans. For
// reduction rows k0 .. k0 + 15 and columns n0 .. n0 + 15: b[0], b[1] of the
// n8 tile n0 and b[2], b[3] of the n8 tile n0 + 8.
__device__ __forceinline__ void load_b_columns(uint32_t (&b)[4], const __nv_bfloat16* tile, int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride + n0 + (lane >> 4) * 8);
}

// acc[j] (the n8 tile j of a 16 x 64 product) += a (16 x 64) . tile^T, the
// tile's rows being the 64 output columns.
__device__ __forceinline__ void product_rows(float (&acc)[8][4], const uint32_t (&a)[4][4], const __nv_bfloat16* tile,
                                             int lane) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      uint32_t b[4];
      load_b_rows(b, tile, 16 * n, 16 * k, lane);
      mma(acc[2 * n], a[k], b[0], b[1]);
      mma(acc[2 * n + 1], a[k], b[2], b[3]);
    }
}

// acc[j] (the n8 tile j of a 16 x 64 product) += a (16 x 64) . tile, the
// tile's rows being the 64 reduction rows.
__device__ __forceinline__ void product_columns(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                                const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      uint32_t b[4];
      load_b_columns(b, tile, 16 * k, 16 * n, lane);
      mma(acc[2 * n], a[k], b[0], b[1]);
      mma(acc[2 * n + 1], a[k], b[2], b[3]);
    }
}

// The A fragments of a 16 x 64 operand from f32 accumulator values already in
// C layout (value[j] of the n8 tile j), rounded to bf16.
__device__ __forceinline__ void pack_a_fragments(uint32_t (&a)[4][4], const float (&value)[8][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k][0] = pack_bf16(value[2 * k][0], value[2 * k][1]);
    a[k][1] = pack_bf16(value[2 * k][2], value[2 * k][3]);
    a[k][2] = pack_bf16(value[2 * k + 1][0], value[2 * k + 1][1]);
    a[k][3] = pack_bf16(value[2 * k + 1][2], value[2 * k + 1][3]);
  }
}

// The last key t < time whose bias marks it valid, or -1 if none (a
// zero-length row). Every thread of the block gets the answer; `scratch`
// holds kThreads / 32 ints of shared memory.
__device__ __forceinline__ int last_valid_key(const float* bias_row, int time, int* scratch) {
  int last = -1;
  for (int t = threadIdx.x; t < time; t += kThreads)
    if (bias_row[t] > kValidBias) last = t;
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) last = max(last, __shfl_xor_sync(0xffffffffu, last, offset));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = last;
  __syncthreads();
  last = scratch[0];
#pragma unroll
  for (int warp = 1; warp < kThreads / 32; ++warp) last = max(last, scratch[warp]);
  return last;
}

// Key tiles a query must visit: up to the tile of the last valid key, since
// the keys after it carry a -1e9 bias and their exponentials are exactly 0
// in f32 once a valid key sets the peak; every tile for a zero-length row,
// whose output averages all its values.
__device__ __forceinline__ int key_tiles_needed(int last_valid, int time) {
  return last_valid < 0 ? (time + kRows - 1) / kRows : last_valid / kRows + 1;
}

}  // namespace tiles
