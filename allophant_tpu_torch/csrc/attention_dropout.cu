// Attention with dropout on the softmaxed weights (K5), and the dropout-mask
// kernel (K6), for Hopper (sm_90a), over the projection layout [B, T, H*hd]
// with padding expressed as an additive f32 key bias (0 valid / -1e9 padded).
//
// Replaces allophant_tpu/ops/oneshot_attention.py: _attention_dropout_kernel
// (launched by _oneshot_dropout_forward) and _dropout_mask_kernel (launched by
// _dropout_mask_bits).
//
// The mask: the TPU kernels draw from Mosaic's PRNG, whose stream cannot be
// reproduced here. Both kernels draw Philox4x32-10 instead (philox.cuh): a
// weight (b, h, row, col) is kept iff its u32 draw is below keep_threshold
// (round((1 - rate) * 2^32)), so the mask is a pure function of the two seeds
// and the indices, the backward (attention_backward.cu) regenerates it, and
// it never touches device memory on the training path. K6 writes the raw
// draws [B, H, T, T] u32 for checks; the training step never launches it.
//
// K5 semantics (the TPU kernel's, in K1's arithmetic, oneshot_attention.cu):
//   * base-2 softmax, peak over the BIASED scores, exponent (s - peak) + bias;
//   * the total sums the UNmasked exponentials (softmax normalises before
//     dropout), clamped at 1e-30 so a zero-length row stays finite;
//   * the masked, unnormalised weights are rounded to the value dtype before
//     P.V, and the sum is scaled by 1 / (total * keep_prob) after it (the f32
//     kernel divides, the bf16 one multiplies by the reciprocal), with
//     keep_prob = threshold / 2^32;
//   * for f32 inputs every product and sum is plain f32: no TF32.
//
// What bounds it on the H100: like K1, the work is 4 * T * valid keys * hd
// operations per (batch, head) against 4 * T * hd elements moved, and at the
// training shape ([8, 499, 1024] bf16) the bytes bound (about 0.010 ms at an
// NVIDIA H100 80GB HBM3's 3.35 TB/s) exceeds the bf16 tensor-core bound;
// beyond both, the design pays the exp2 and rescaling work per score and one
// Philox call (ten rounds of two 32-bit multiplies) per four scores on the
// CUDA cores, and mma.sync's instruction rate. Measured on an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py): 0.085 ms at that shape and rate 0.1,
// against 0.122 ms for scaled_dot_product_attention with dropout_p 0.1 and
// 0.656 ms for the first, FFMA version of this kernel.
//
// bf16 (the "mixed" preset that training runs): K1's tensor-core design
// (attention_tiles.cuh). One block per (batch, head, 64-query tile), four
// warps each owning 16 query rows; the query A fragments are loaded once;
// 64-key k and v tiles are double-buffered in shared memory by cp.async, so
// tile n + 1's copy overlaps tile n's products; S = Q.K^T and O += P.V run on
// mma.sync.m16n8k16. The peak and total stay in registers. The keep bits of a
// lane's 32 accumulator entries come from philox::query_tile_keep_bits, the
// mapping K4's query kernel uses: lane pairs share each Philox call through
// one shuffle. The exponentials join the total before the mask zeroes the
// dropped ones, and the kept ones are packed to bf16 as P.V's A fragments in
// registers. A block stops after the key tile of its batch row's last valid
// key (the keys after it have weight exactly 0 in f32, kept or not); a
// zero-length row visits every tile.
//
// f32 keeps the first version's arithmetic on the CUDA cores (FFMA): one
// block per (batch, head, 64-query tile) over 64-key tiles, ~66 KB of shared
// memory; each thread owns 4 query rows and two runs of 4 consecutive key
// columns of the score tile, so one Philox call gives the draws of one run.
// q, k and v are read in place through their batch and time strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "attention_wide.cuh"
#include "philox.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;      // 16 row groups x 8 column lanes
constexpr float kTinyTotal = 1e-30f;

// ---------------------------------------------------------------- f32, FFMA

constexpr int kRowsPerThread = 4;  // query rows per thread
constexpr int kColsPerThread = 8;  // key columns per thread: two runs of 4

// Key column (within the tile) of a thread's j-th score: runs of 4 at
// 4 * lane and 32 + 4 * lane.
__device__ __forceinline__ int score_column(int lane_col, int j) {
  return (j >> 2) * 32 + lane_col * 4 + (j & 3);
}

template <int HD, bool kPadded>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 1 : 2)
attention_dropout_kernel(const float* __restrict__ query, const float* __restrict__ key,
                         const float* __restrict__ value, const float* __restrict__ key_bias,
                         float* __restrict__ out, int time, int head_columns,
                         long long q_batch_stride, long long q_time_stride,
                         long long k_batch_stride, long long k_time_stride,
                         long long v_batch_stride, long long v_time_stride,
                         long long o_batch_stride, long long o_time_stride,
                         float score_scale, float bias_scale, uint32_t seed0, uint32_t seed1,
                         uint32_t threshold, float keep_prob, philox::HeadMap head_map) {
  // The head's own width: the constant HD unless it runs padded.
  const int columns = kPadded ? head_columns : HD;
  static_assert(HD % 8 == 0, "head_dim must be a multiple of 8");
  constexpr int kOutCols = HD / 8;
  constexpr int kQkStride = HD + 1;
  constexpr int kPStride = kBlockK + 1;

  extern __shared__ float shared[];
  float* q_tile = shared;                          // [kBlockQ][HD + 1]
  float* k_tile = q_tile + kBlockQ * kQkStride;    // [kBlockK][HD + 1]
  float* v_tile = k_tile + kBlockK * kQkStride;    // [kBlockK][HD]
  float* p_tile = v_tile + kBlockK * HD;           // [kBlockQ][kBlockK + 1]
  float* bias_tile = p_tile + kBlockQ * kPStride;  // [kBlockK]

  const int tid = threadIdx.x;
  const int lane_col = tid & 7;
  const int row_group = tid >> 3;
  const int query_start = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int mask_head = head_map(batch, head);
  const int head_offset = head * columns;

  const float* q_base = query + batch * q_batch_stride + head_offset;
  const float* k_base = key + batch * k_batch_stride + head_offset;
  const float* v_base = value + batch * v_batch_stride + head_offset;
  const float* bias_base = key_bias + static_cast<long long>(batch) * time;

  // Columns past the head's own width (a head run at a wider HD) load as 0.
  for (int index = tid; index < kBlockQ * HD; index += kThreads) {
    const int row = index / HD;
    const int col = index % HD;
    const int t = query_start + row;
    q_tile[row * kQkStride + col] = t < time && col < columns ? q_base[t * q_time_stride + col] : 0.0f;
  }

  float row_max[kRowsPerThread];
  float row_sum[kRowsPerThread];
  float acc[kRowsPerThread][kOutCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    row_max[i] = -INFINITY;
    row_sum[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) acc[i][j] = 0.0f;
  }

  for (int key_start = 0; key_start < time; key_start += kBlockK) {
    __syncthreads();
    for (int index = tid; index < kBlockK * HD; index += kThreads) {
      const int row = index / HD;
      const int col = index % HD;
      const int t = key_start + row;
      const bool inside = t < time && col < columns;
      k_tile[row * kQkStride + col] = inside ? k_base[t * k_time_stride + col] : 0.0f;
      v_tile[row * HD + col] = inside ? v_base[t * v_time_stride + col] : 0.0f;
    }
    for (int index = tid; index < kBlockK; index += kThreads) {
      const int t = key_start + index;
      bias_tile[index] = t < time ? bias_base[t] * bias_scale : -INFINITY;
    }
    __syncthreads();

    float scores[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) scores[i][j] = 0.0f;

#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[kRowsPerThread];
      float b[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) a[i] = q_tile[(row_group * kRowsPerThread + i) * kQkStride + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) b[j] = k_tile[score_column(lane_col, j) * kQkStride + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) scores[i][j] = fmaf(a[i], b[j], scores[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        scores[i][j] *= score_scale;
        tile_max = fmaxf(tile_max, scores[i][j] + bias_tile[score_column(lane_col, j)]);
      }
#pragma unroll
      for (int offset = 1; offset < 8; offset <<= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, offset));
      const float new_max = fmaxf(row_max[i], tile_max);
      const float rescale = exp2f(row_max[i] - new_max);
      row_max[i] = new_max;
      const int row = row_group * kRowsPerThread + i;
      // Draws of this row's two runs of four key columns.
      const uint4 draws0 = philox::dropout_draws(seed0, seed1, mask_head, query_start + row,
                                                 key_start / 4 + lane_col);
      const uint4 draws1 = philox::dropout_draws(seed0, seed1, mask_head, query_start + row,
                                                 (key_start + 32) / 4 + lane_col);
      float tile_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int col = score_column(lane_col, j);
        const float weight = exp2f((scores[i][j] - new_max) + bias_tile[col]);
        tile_sum += weight;
        const uint32_t draw = philox::word(j < 4 ? draws0 : draws1, j & 3);
        p_tile[row * kPStride + col] = draw < threshold ? weight : 0.0f;
      }
#pragma unroll
      for (int offset = 1; offset < 8; offset <<= 1)
        tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, offset);
      row_sum[i] = row_sum[i] * rescale + tile_sum;
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) acc[i][j] *= rescale;
    }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < kBlockK; ++k) {
      float p[kRowsPerThread];
      float v[kOutCols];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) p[i] = p_tile[(row_group * kRowsPerThread + i) * kPStride + k];
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) v[j] = v_tile[k * HD + lane_col + 8 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kOutCols; ++j) acc[i][j] = fmaf(p[i], v[j], acc[i][j]);
    }
  }

  float* o_base = out + batch * o_batch_stride + head_offset;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int t = query_start + row_group * kRowsPerThread + i;
    if (t >= time) continue;
    const float denominator = fmaxf(row_sum[i], kTinyTotal) * keep_prob;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j)
      if (lane_col + 8 * j < columns) o_base[t * o_time_stride + lane_col + 8 * j] = acc[i][j] / denominator;
  }
}

template <int HD>
constexpr size_t shared_bytes() {
  return sizeof(float) *
         (kBlockQ * (HD + 1) + kBlockK * (HD + 1) + kBlockK * HD + kBlockQ * (kBlockK + 1) + kBlockK);
}

// ------------------------------------------------------- bf16, tensor cores

using bf16 = __nv_bfloat16;

// Three blocks per SM at 64 columns, as ptxas chose them (160 registers)
// before the kernel took other widths; naming one block there lets it take
// 190 registers and two blocks, which ran slower on an H100.
template <int HD, bool kPadded>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 3 : 2)
attention_dropout_mma_kernel(const bf16* __restrict__ query, const bf16* __restrict__ key,
                             const bf16* __restrict__ value, const float* __restrict__ key_bias,
                             bf16* __restrict__ out, int time, int head_columns, long long q_batch_stride,
                             long long q_time_stride,
                             long long k_batch_stride, long long k_time_stride, long long v_batch_stride,
                             long long v_time_stride, long long o_batch_stride, long long o_time_stride,
                             float score_scale, float bias_scale, uint32_t seed0, uint32_t seed1,
                             uint32_t threshold, float keep_prob, philox::HeadMap head_map) {
  // The head's own width: the constant HD unless it runs padded.
  const int columns = kPadded ? head_columns : HD;
  constexpr int kTileElements = tiles::Head<HD>::kTileElements;
  constexpr int kAccumulators = tiles::Head<HD>::kAccumulators;
  extern __shared__ __align__(16) unsigned char shared_bytes_raw[];
  bf16* q_tile = reinterpret_cast<bf16*>(shared_bytes_raw);  // [64][HD + 8]
  bf16* k_tiles = q_tile + kTileElements;                      // 2 x [64][HD + 8]
  bf16* v_tiles = k_tiles + 2 * kTileElements;                 // 2 x [64][HD + 8]
  __shared__ float bias_tiles[2][kBlockK];
  __shared__ int scratch[kThreads / 32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = lane >> 2;   // accumulator rows group and group + 8
  const int column = lane & 3;   // accumulator columns 2 * column, 2 * column + 1
  const int query_start = blockIdx.x * kBlockQ;
  const int head_offset = blockIdx.y * columns;
  const int batch = blockIdx.z;
  const int mask_head = head_map(batch, blockIdx.y);
  const int row = query_start + 16 * warp + group;  // and row + 8

  const bf16* k_base = key + batch * k_batch_stride + head_offset;
  const bf16* v_base = value + batch * v_batch_stride + head_offset;
  const float* bias_row = key_bias + static_cast<long long>(batch) * time;

  auto load_keys = [&](int tile, int buffer) {
    const int key_start = tile * kBlockK;
    tiles::copy_tile_async<HD, kPadded>(k_tiles + buffer * kTileElements, k_base, k_time_stride, key_start, time, columns);
    tiles::copy_tile_async<HD, kPadded>(v_tiles + buffer * kTileElements, v_base, v_time_stride, key_start, time, columns);
    tiles::commit_copies();
    for (int index = threadIdx.x; index < kBlockK; index += kThreads) {
      const int t = key_start + index;
      // Keys past the end of the sequence are not keys at all: -inf keeps them
      // out of the peak and gives them an exact 0 weight.
      bias_tiles[buffer][index] = t < time ? bias_row[t] * bias_scale : -INFINITY;
    }
  };

  tiles::copy_tile_async<HD, kPadded>(q_tile, query + batch * q_batch_stride + head_offset, q_time_stride, query_start, time,
                             columns);
  load_keys(0, 0);  // the query tile joins the first group
  const int key_tiles = tiles::key_tiles_needed(tiles::last_valid_key(bias_row, time, scratch), time);

  uint32_t q_fragments[tiles::Head<HD>::kFragments][4];
  float acc[kAccumulators][4];
  float row_max[2] = {-INFINITY, -INFINITY};  // rows `row`, row + 8
  float row_sum[2] = {0.0f, 0.0f};            // this lane's columns only, unmasked
#pragma unroll
  for (int j = 0; j < kAccumulators; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int tile = 0; tile < key_tiles; ++tile) {
    const int buffer = tile & 1;
    if (tile + 1 < key_tiles) {
      load_keys(tile + 1, buffer ^ 1);
      tiles::wait_copies<1>();
    } else {
      tiles::wait_copies<0>();
    }
    __syncthreads();
    if (tile == 0) tiles::load_a_fragments<HD>(q_fragments, q_tile, 16 * warp, lane);
    const bf16* k_tile = k_tiles + buffer * kTileElements;
    const bf16* v_tile = v_tiles + buffer * kTileElements;
    const float* bias_tile = bias_tiles[buffer];

    float scores[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) scores[j][e] = 0.0f;
    tiles::product_rows<HD>(scores, q_fragments, k_tile, lane);
    const uint32_t kept = philox::query_tile_keep_bits(seed0, seed1, threshold, mask_head, row, tile * kBlockK, lane);

    float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        scores[j][e] *= score_scale;
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], scores[j][e] + bias_tile[8 * j + 2 * column + (e & 1)]);
      }
    float rescale[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float new_max = fmaxf(row_max[r], tile_max[r]);
      // row_max starts at -inf; every visited tile holds a key inside the
      // sequence, so new_max is finite and the first rescale is exp2(-inf) = 0.
      rescale[r] = exp2f(row_max[r] - new_max);
      row_max[r] = new_max;
      row_sum[r] *= rescale[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float weight = exp2f((scores[j][e] - row_max[e >> 1]) + bias_tile[8 * j + 2 * column + (e & 1)]);
        row_sum[e >> 1] += weight;  // before the mask: softmax normalises before dropout
        scores[j][e] = (kept >> (4 * j + e)) & 1u ? weight : 0.0f;
        if (j < kAccumulators) acc[j][e] *= rescale[e >> 1];
      }
#pragma unroll
    for (int j = 8; j < kAccumulators; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= rescale[e >> 1];
    uint32_t p_fragments[4][4];
    tiles::pack_a_fragments(p_fragments, scores);
    tiles::product_columns<HD>(acc, p_fragments, v_tile, lane);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  bf16* o_base = out + batch * o_batch_stride + head_offset;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
    row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
    const int t = row + 8 * r;
    if (t >= time) continue;
    const float inverse = 1.0f / (fmaxf(row_sum[r], kTinyTotal) * keep_prob);
#pragma unroll
    for (int j = 0; j < kAccumulators; ++j) {
      if (8 * j >= columns) break;  // columns past the head's own width
      const __nv_bfloat162 pair = __floats2bfloat162_rn(acc[j][2 * r] * inverse, acc[j][2 * r + 1] * inverse);
      *reinterpret_cast<__nv_bfloat162*>(o_base + t * o_time_stride + 8 * j + 2 * column) = pair;
    }
  }
}

// K6: one thread per (batch * heads + head, row, run of four columns).
__global__ void dropout_mask_kernel(uint32_t* __restrict__ out, int batch_heads, int heads, int time,
                                    uint32_t seed0, uint32_t seed1, philox::HeadMap head_map) {
  const int quads = (time + 3) / 4;
  const long long index = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(batch_heads) * time * quads;
  if (index >= total) return;
  const int quad = static_cast<int>(index % quads);
  const long long rest = index / quads;
  const int row = static_cast<int>(rest % time);
  const int batch_head = static_cast<int>(rest / time);
  const uint4 draws = philox::dropout_draws(seed0, seed1, head_map(batch_head / heads, batch_head % heads), row, quad);
  uint32_t* row_out = out + (static_cast<long long>(batch_head) * time + row) * time;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int col = quad * 4 + w;
    if (col < time) row_out[col] = philox::word(draws, w);
  }
}

int launch_f32(const void* query, const void* key, const void* value, const float* key_bias, void* out, int batch,
               int time, int heads, int head_dim, const long long* strides, float score_scale, float bias_scale,
               uint32_t seed0, uint32_t seed1, uint32_t threshold, float keep_prob, philox::HeadMap head_map,
               cudaStream_t stream) {
  return tiles::with_head_width(head_dim, [&](auto width, auto padded) {
    constexpr int HD = decltype(width)::value;
    constexpr bool kPadded = decltype(padded)::value;
    constexpr size_t bytes = shared_bytes<HD>();
    cudaError_t status = cudaFuncSetAttribute(attention_dropout_kernel<HD, kPadded>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (status != cudaSuccess) return static_cast<int>(status);
    const dim3 grid((time + kBlockQ - 1) / kBlockQ, heads, batch);
    attention_dropout_kernel<HD, kPadded><<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(query), static_cast<const float*>(key), static_cast<const float*>(value),
        key_bias, static_cast<float*>(out), time, head_dim, strides[0], strides[1], strides[2], strides[3],
        strides[4], strides[5], strides[6], strides[7], score_scale, bias_scale, seed0, seed1, threshold, keep_prob,
        head_map);
    return static_cast<int>(cudaGetLastError());
  }, [&] {
    return wide::launch_forward<float, true>(query, key, value, key_bias, out, batch, time, heads, head_dim, strides,
                                             score_scale, bias_scale, wide::Mask{seed0, seed1, threshold, 1, head_map},
                                             keep_prob, stream);
  });
}

int launch_bf16(const void* query, const void* key, const void* value, const float* key_bias, void* out, int batch,
                int time, int heads, int head_dim, const long long* strides, float score_scale, float bias_scale,
                uint32_t seed0, uint32_t seed1, uint32_t threshold, float keep_prob, philox::HeadMap head_map,
               cudaStream_t stream) {
  return tiles::with_head_width(head_dim, [&](auto width, auto padded) {
    constexpr int HD = decltype(width)::value;
    constexpr bool kPadded = decltype(padded)::value;
    constexpr size_t bytes = 5 * tiles::Head<HD>::kTileBytes;
    cudaError_t status = cudaFuncSetAttribute(attention_dropout_mma_kernel<HD, kPadded>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (status != cudaSuccess) return static_cast<int>(status);
    const dim3 grid((time + kBlockQ - 1) / kBlockQ, heads, batch);
    attention_dropout_mma_kernel<HD, kPadded><<<grid, kThreads, bytes, stream>>>(
        static_cast<const bf16*>(query), static_cast<const bf16*>(key), static_cast<const bf16*>(value), key_bias,
        static_cast<bf16*>(out), time, head_dim, strides[0], strides[1], strides[2], strides[3], strides[4],
        strides[5], strides[6], strides[7], score_scale, bias_scale, seed0, seed1, threshold, keep_prob, head_map);
    return static_cast<int>(cudaGetLastError());
  }, [&] {
    return wide::launch_forward<bf16, true>(query, key, value, key_bias, out, batch, time, heads, head_dim, strides,
                                            score_scale, bias_scale, wide::Mask{seed0, seed1, threshold, 1, head_map},
                                            keep_prob, stream);
  });
}

}  // namespace

// strides: q, k, v, out batch and time strides in elements (8 values); the
// head-dim axis must be contiguous, and for bf16 every head row must start on
// a 16-byte boundary (the wrapper checks both). head_dim: a positive
// multiple of 8; above 128 the chunked route of attention_wide.cuh runs
// (tiles::with_head_width). The call's heads are heads head_offset ..
// head_offset + heads - 1 of the model's total_heads, which key the mask
// (philox.cuh). dtype: 0 = f32, 1 = bf16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int attention_dropout_forward(const void* query, const void* key, const void* value,
                                         const float* key_bias, void* out, int batch, int time,
                                         int heads, int head_dim, const long long* strides,
                                         float score_scale, float bias_scale, uint32_t seed0,
                                         uint32_t seed1, uint32_t threshold, float keep_prob,
                                         int total_heads, int head_offset, int dtype, void* stream) {
  cudaStream_t cuda_stream = static_cast<cudaStream_t>(stream);
  if (head_offset < 0 || head_offset + heads > total_heads) return static_cast<int>(cudaErrorInvalidValue);
  const philox::HeadMap head_map{total_heads, head_offset};
  if (dtype == 0)
    return launch_f32(query, key, value, key_bias, out, batch, time, heads, head_dim, strides, score_scale,
                      bias_scale, seed0, seed1, threshold, keep_prob, head_map, cuda_stream);
  if (dtype == 1)
    return launch_bf16(query, key, value, key_bias, out, batch, time, heads, head_dim, strides, score_scale,
                       bias_scale, seed0, seed1, threshold, keep_prob, head_map, cuda_stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out: u32 [B, H, T, T], contiguous: the draws of heads head_offset ..
// head_offset + heads - 1 of the model's total_heads.
extern "C" int dropout_mask_forward(void* out, int batch, int heads, int time, uint32_t seed0,
                                    uint32_t seed1, int total_heads, int head_offset, void* stream) {
  if (head_offset < 0 || head_offset + heads > total_heads) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(batch) * heads * time * ((time + 3) / 4);
  constexpr int kMaskThreads = 256;
  const long long blocks = (threads + kMaskThreads - 1) / kMaskThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dropout_mask_kernel<<<static_cast<unsigned>(blocks), kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), batch * heads, heads, time, seed0, seed1,
      philox::HeadMap{total_heads, head_offset});
  return static_cast<int>(cudaGetLastError());
}
