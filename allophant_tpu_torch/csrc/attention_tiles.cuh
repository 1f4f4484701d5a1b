// Tensor-core building blocks of the bf16 attention kernels (K1's forward in
// oneshot_attention.cu, K5's forward with dropout in attention_dropout.cu,
// K4's backward in attention_backward.cu): 64-row bf16
// tiles of one head in shared memory, filled by 16-byte cp.async, read into
// mma.sync.m16n8k16 fragments by ldmatrix. Everything that depends on the
// head width HD is a template on it; the kernels are instantiated at the
// widths of HeadWidths below (wav2vec2 base and XLS-R 300M have 64-wide heads,
// XLS-R 1B 80, XLS-R 2B 120), and any other multiple of 8 up to 128 runs as
// the next of them, its extra columns zero-filled in shared memory and never
// stored. Wider heads take the chunked route of attention_wide.cuh, built
// from the same tiles at 128 columns.
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
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tiles {

constexpr int kRows = 64;     // rows (queries or keys) of a tile
constexpr int kThreads = 128;  // four warps, 16 rows each
// A key is valid iff its bias is above NEG_INF / 2 (ops/oneshot_attention.py).
constexpr float kValidBias = -5e8f;

// Calls launch(std::integral_constant<int, HD>(), std::bool_constant<padded>())
// with the head width HD that runs a head of `head_dim` columns, the first
// of 32, 64, 80, 96 and 128 at least head_dim, and whether head_dim falls
// short of it. A kernel built with padded false takes its column count as
// the constant HD, so an exact width compiles no column checks. A head_dim
// above 128 calls launch_wide() instead: the chunked route of
// attention_wide.cuh, whose blocks each own 128 output columns. A head_dim
// that is not a positive multiple of 8 returns cudaErrorInvalidValue (the
// wrappers zero-pad their heads to a multiple of 8 first).
template <int HD, typename Launch>
int with_padding(int head_dim, Launch&& launch) {
  if (head_dim == HD) return launch(std::integral_constant<int, HD>(), std::false_type());
  return launch(std::integral_constant<int, HD>(), std::true_type());
}

template <typename Launch, typename LaunchWide>
int with_head_width(int head_dim, Launch&& launch, LaunchWide&& launch_wide) {
  if (head_dim < 8 || head_dim % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim > 128) return launch_wide();
  if (head_dim <= 32) return with_padding<32>(head_dim, launch);
  if (head_dim <= 64) return with_padding<64>(head_dim, launch);
  if (head_dim <= 80) return with_padding<80>(head_dim, launch);
  if (head_dim <= 96) return with_padding<96>(head_dim, launch);
  return with_padding<128>(head_dim, launch);
}

// Every kernel built on these tiles names two blocks per SM in its
// __launch_bounds__ at the widths other than 64 (K4's query kernel: above
// 64): without it ptxas traded a few spilled registers for a third block at
// some widths. At 64 each keeps the register budget it had before it took
// other widths.
//
// The shapes of one head width's tiles and fragments.
template <int HD>
struct Head {
  static_assert(HD % 16 == 0 && HD <= 128, "a tile's head width is a multiple of 16, at most 128");
  // bf16 elements per shared-memory row: (HD + 8) * 2 bytes, an odd multiple
  // of 16 at every width above, so the eight 16-byte rows that one ldmatrix
  // 8x8 reads fall on eight distinct groups of four banks.
  static constexpr int kStride = HD + 8;
  static constexpr int kTileElements = kRows * kStride;
  static constexpr int kTileBytes = kTileElements * 2;
  static constexpr int kChunks = HD / 8;        // 16-byte chunks of a row
  static constexpr int kFragments = HD / 16;    // A fragments over a row's HD columns
  static constexpr int kAccumulators = HD / 8;  // n8 accumulator tiles over HD columns
};

__device__ __forceinline__ uint32_t shared_address(const void* pointer) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(pointer));
}

// Starts the copy of rows start .. start + 63 of one head (HD bf16 from
// `base + t * time_stride`) into `tile`; rows at or past `time`, and with
// kPadded the columns at or past the head's own width `columns` (a multiple
// of 8), are zero-filled (cp.async reads 0 bytes of them). The caller
// commits the group.
template <int HD, bool kPadded>
__device__ __forceinline__ void copy_tile_async(__nv_bfloat16* tile, const __nv_bfloat16* base,
                                                long long time_stride, int start, int time, int columns) {
  constexpr unsigned kChunks = Head<HD>::kChunks;
#pragma unroll
  for (int step = 0; step < kRows * static_cast<int>(kChunks) / kThreads; ++step) {
    const unsigned chunk = threadIdx.x + step * kThreads;
    const int row = static_cast<int>(chunk / kChunks);
    const int column = static_cast<int>(chunk % kChunks) * 8;
    const int t = start + row;
    const bool inside = t < time && (!kPadded || column < columns);
    const __nv_bfloat16* source =
        base + static_cast<long long>(t < time ? t : 0) * time_stride + (!kPadded || column < columns ? column : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(shared_address(tile + row * Head<HD>::kStride + column)),
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

// The A fragment of rows row0 .. row0 + 15 over columns 16k .. 16k + 15 of a
// tile whose rows are `stride` elements apart.
__device__ __forceinline__ void load_a_fragment(uint32_t (&a)[4], const __nv_bfloat16* tile, int stride, int row0,
                                                int k, int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * stride + 16 * k + (lane >> 4) * 8);
}

// The A fragments of rows row0 .. row0 + 15 over all HD columns of a tile
// (a[k] covers columns 16k .. 16k + 15).
template <int HD>
__device__ __forceinline__ void load_a_fragments(uint32_t (&a)[Head<HD>::kFragments][4], const __nv_bfloat16* tile,
                                                 int row0, int lane) {
#pragma unroll
  for (int k = 0; k < Head<HD>::kFragments; ++k) load_a_fragment(a[k], tile, Head<HD>::kStride, row0, k, lane);
}

// B fragments of out[r][n] += sum_k a[r][k] tile[n][k]: the tile holds B
// transposed (rows n, e.g. keys for q.k^T). For rows n0 .. n0 + 15 and
// reduction columns k0 .. k0 + 15: b[0], b[1] of the n8 tile n0 and b[2], b[3]
// of the n8 tile n0 + 8.
template <int HD>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const __nv_bfloat16* tile, int n0, int k0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * Head<HD>::kStride + k0 + ((lane >> 3) & 1) * 8);
}

// B fragments of out[r][n] += sum_k a[r][k] tile[k][n]: the tile holds B as
// it is (rows k, e.g. keys for p.v), read transposed by ldmatrix.trans. For
// reduction rows k0 .. k0 + 15 and columns n0 .. n0 + 15: b[0], b[1] of the
// n8 tile n0 and b[2], b[3] of the n8 tile n0 + 8.
template <int HD>
__device__ __forceinline__ void load_b_columns(uint32_t (&b)[4], const __nv_bfloat16* tile, int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * Head<HD>::kStride + n0 + (lane >> 4) * 8);
}

// acc[j] (the n8 tile j of a 16 x 8N product) += a (16 x HD, columns 16k ..
// 16k + 15 in a[k]) . tile^T, the tile's first 8N rows being the output
// columns (N = 8: all 64).
template <int HD, int N>
__device__ __forceinline__ void product_rows_step(float (&acc)[N][4], const uint32_t (&a)[4], int k,
                                                  const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int n = 0; n < N / 2; ++n) {
    uint32_t b[4];
    load_b_rows<HD>(b, tile, 16 * n, 16 * k, lane);
    mma(acc[2 * n], a, b[0], b[1]);
    mma(acc[2 * n + 1], a, b[2], b[3]);
  }
}

template <int HD, int N>
__device__ __forceinline__ void product_rows(float (&acc)[N][4], const uint32_t (&a)[Head<HD>::kFragments][4],
                                             const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int k = 0; k < Head<HD>::kFragments; ++k) product_rows_step<HD>(acc, a[k], k, tile, lane);
}

// product_rows with the A operand read from rows row0 .. row0 + 15 of
// `a_tile` one fragment at a time, for kernels whose registers cannot hold
// all of a wide head's fragments at once.
template <int HD, int N>
__device__ __forceinline__ void product_rows_from_tile(float (&acc)[N][4], const __nv_bfloat16* a_tile, int row0,
                                                       const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int k = 0; k < Head<HD>::kFragments; ++k) {
    uint32_t a[4];
    load_a_fragment(a, a_tile, Head<HD>::kStride, row0, k, lane);
    product_rows_step<HD>(acc, a, k, tile, lane);
  }
}

// acc[j] (the n8 tile j of a 16 x HD product) += a (16 x 16K) . tile, the
// tile's first 16K rows being the reduction rows (K = 4: all 64).
template <int HD, int K>
__device__ __forceinline__ void product_columns(float (&acc)[Head<HD>::kAccumulators][4], const uint32_t (&a)[K][4],
                                                const __nv_bfloat16* tile, int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      uint32_t b[4];
      load_b_columns<HD>(b, tile, 16 * k, 16 * n, lane);
      mma(acc[2 * n], a[k], b[0], b[1]);
      mma(acc[2 * n + 1], a[k], b[2], b[3]);
    }
}

// The A fragments of a 16 x 16K operand from f32 accumulator values already in
// C layout (value[j] of the n8 tile j), rounded to bf16.
template <int K>
__device__ __forceinline__ void pack_a_fragments(uint32_t (&a)[K][4], const float (&value)[2 * K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
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
