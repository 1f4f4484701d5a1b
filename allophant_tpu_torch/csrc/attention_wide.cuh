// The chunked route of the attention kernels for head widths above 128: K1's
// forward (oneshot_attention.cu), K5's forward with dropout
// (attention_dropout.cu) and K4's backward (attention_backward.cu) launch
// these kernels when tiles::with_head_width finds a head wider than the
// widest tile (128 columns), in f32 and bf16.
//
// Replaces the same TPU kernels as those files; the TPU's plan
// (allophant_tpu/ops/oneshot_attention.py:plan_oneshot) sizes its blocks by
// H * hd and T, so its kernels take any head width. Here registers, not VMEM,
// bound a block: a 64-row tile's accumulators over 256 columns would not fit
// beside its scores. So a block owns one 128-wide chunk of the output
// columns (grid dimension heads * ceil(hd / 128)), and everything that needs
// the full width streams it: the scores q.k^T (and in the backward g.v^T)
// are accumulated over the head's 128-wide column chunks, each chunk of both
// operands copied into shared memory in turn. Every block of a head
// recomputes its scores; that is the price of registers sized to one chunk.
//
// Arithmetic (each kernel's semantics are those of its narrow version): the
// base-2 softmax with the peak over the biased scores, exponent (s - peak) +
// bias, keys past T at -inf, total clamped at 1e-30; the mask a weight of
// (b, h, query, key) is kept iff its Philox draw (philox.cuh) is below the
// threshold, the same draw as the narrow kernels'; the unnormalised weights
// (K1, K5), mscale o p and ds (K4) are rounded to the input dtype before
// their products; every sum is f32.
//
// Layout: four warps; the 64 x 64 score tile lands in shared memory as f32,
// so the softmax, the mask and the row statistics run on it with two threads
// a row, whatever the dtype. The products are the dtype's own: bf16 on the
// tensor cores (mma.sync.m16n8k16 through attention_tiles.cuh, each warp 16
// rows), f32 on the CUDA cores (FFMA, each thread 4 rows by 8 or 16
// columns). No copy is overlapped with a product and every block takes one
// SM's worth of registers: this route is meant to be right at widths no
// released encoder has, not fast.
//
// The backward's two kernels keep the narrow design: (a) one block per
// (batch, head, chunk, 64-query tile) computes the row statistics in one
// pass over the key tiles and dq's chunk in a second; (b) one block per
// (batch, head, chunk, 64-key tile) accumulates dk's and dv's chunks over the
// query tiles from those statistics. Nothing [T, T] is stored and there are
// no atomics, so two calls give bit-equal results.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "philox.cuh"

namespace wide {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 128;                // columns of one chunk
constexpr int kRows = tiles::kRows;        // rows of a tile
constexpr int kThreads = tiles::kThreads;  // four warps
constexpr int kScoreStride = kRows + 1;    // f32 [64][65] score tiles
constexpr float kTinyTotal = 1e-30f;

struct Mask {
  uint32_t seed0, seed1, threshold;
  int enabled;
  philox::HeadMap head_map;
};

// Batch and time strides of up to seven [B, T, H*hd] tensors, in the order
// the entry point lists them.
struct Strides {
  long long batch[7], time[7];
};

inline Strides unpack_strides(const long long* flat, int tensors) {
  Strides strides{};
  for (int i = 0; i < tensors; ++i) {
    strides.batch[i] = flat[2 * i];
    strides.time[i] = flat[2 * i + 1];
  }
  return strides;
}

__device__ __forceinline__ void put(float* pointer, float value) { *pointer = value; }
__device__ __forceinline__ void put(bf16* pointer, float value) { *pointer = __float2bfloat16(value); }

// The products of one dtype: S (64 x 64) += A . B^T over one chunk, and
// Acc (64 x 128) += X . Y with X a 64 x 64 weight tile and Y a 64-row chunk.
template <typename T>
struct Ops;

template <>
struct Ops<float> {
  static constexpr int kStride = kChunk + 1;  // chunk rows, conflict-free column reads
  static constexpr int kXStride = kRows + 1;
  static constexpr size_t kChunkBytes = sizeof(float) * kRows * kStride;
  static constexpr size_t kXBytes = sizeof(float) * kRows * kXStride;
  using Scores = float[4][8];  // rows 4 * (tid / 8) + i, columns tid % 8 + 8 j
  using Acc = float[4][16];    // rows 4 * (tid / 8) + i, columns tid % 8 + 8 j

  // Rows start .. start + 63 of `columns` columns from `base` (rows past
  // `time` and columns past `columns` zero).
  __device__ static void load(float* tile, const float* base, long long time_stride, int start, int time,
                              int columns) {
    for (int index = threadIdx.x; index < kRows * kChunk; index += kThreads) {
      const int row = index / kChunk;
      const int col = index % kChunk;
      const int t = start + row;
      tile[row * kStride + col] = t < time && col < columns ? base[t * time_stride + col] : 0.0f;
    }
  }
  __device__ static void wait() {}

  __device__ static void product_rows(Scores& s, const float* a, const float* b) {
    const int group = threadIdx.x >> 3, lane = threadIdx.x & 7;
#pragma unroll 4
    for (int d = 0; d < kChunk; ++d) {
      float x[4], y[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = a[(4 * group + i) * kStride + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = b[(lane + 8 * j) * kStride + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
    }
  }

  __device__ static void product_columns(Acc& acc, const float* x, const float* y) {
    const int group = threadIdx.x >> 3, lane = threadIdx.x & 7;
#pragma unroll 4
    for (int k = 0; k < kRows; ++k) {
      float p[4], v[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = x[(4 * group + i) * kXStride + k];
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = y[k * kStride + lane + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(p[i], v[j], acc[i][j]);
    }
  }

  template <int N, typename F>
  __device__ static void each(float (&values)[4][N], F f) {
    const int group = threadIdx.x >> 3, lane = threadIdx.x & 7;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) f(4 * group + i, lane + 8 * j, values[i][j]);
  }
};

template <>
struct Ops<bf16> {
  using Head = tiles::Head<kChunk>;
  static constexpr int kStride = Head::kStride;
  static constexpr int kXStride = kRows + 8;  // 144-byte rows: ldmatrix without bank conflicts
  static constexpr size_t kChunkBytes = Head::kTileBytes;
  static constexpr size_t kXBytes = sizeof(bf16) * kRows * kXStride;
  using Scores = float[8][4];  // the warp's 16 rows x 64 columns, C fragments
  using Acc = float[16][4];   // the warp's 16 rows x 128 columns, C fragments

  __device__ static void load(bf16* tile, const bf16* base, long long time_stride, int start, int time, int columns) {
    tiles::copy_tile_async<kChunk, true>(tile, base, time_stride, start, time, columns);
    tiles::commit_copies();
  }
  __device__ static void wait() { tiles::wait_copies<0>(); }

  __device__ static void product_rows(Scores& s, const bf16* a, const bf16* b) {
    tiles::product_rows_from_tile<kChunk>(s, a, 16 * (threadIdx.x >> 5), b, threadIdx.x & 31);
  }

  __device__ static void product_columns(Acc& acc, const bf16* x, const bf16* y) {
    const int lane = threadIdx.x & 31;
    uint32_t a[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) tiles::load_a_fragment(a[k], x, kXStride, 16 * (threadIdx.x >> 5), k, lane);
    tiles::product_columns<kChunk, 4>(acc, a, y, lane);
  }

  // Entry e of n8 tile j: row g + 8 (e / 2) of the warp's 16, column 8 j +
  // 2 c + e % 2, for lane = 4 g + c.
  template <int N, typename F>
  __device__ static void each(float (&values)[N][4], F f) {
    const int lane = threadIdx.x & 31;
    const int row0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) f(row0 + 8 * (e >> 1), 8 * j + 2 * (lane & 3) + (e & 1), values[j][e]);
  }
};

template <typename T, typename Values>
__device__ __forceinline__ void clear(Values& values) {
  Ops<T>::each(values, [](int, int, float& value) { value = 0.0f; });
}

// Shared memory of every wide kernel: two chunk tiles, two f32 score tiles,
// two weight tiles and eight f32 row vectors.
template <typename T>
struct Shared {
  static constexpr size_t kScoreBytes = sizeof(float) * kRows * kScoreStride;
  static constexpr size_t kBytes = 2 * Ops<T>::kChunkBytes + 2 * kScoreBytes + 2 * Ops<T>::kXBytes +
                                   8 * kRows * sizeof(float);
  T* a;
  T* b;
  float* s;
  float* dp;
  T* x1;
  T* x2;
  float* rows;  // rows + kRows * i: the i-th row vector

  __device__ explicit Shared(unsigned char* raw) {
    a = reinterpret_cast<T*>(raw);
    b = reinterpret_cast<T*>(raw + Ops<T>::kChunkBytes);
    s = reinterpret_cast<float*>(raw + 2 * Ops<T>::kChunkBytes);
    dp = reinterpret_cast<float*>(raw + 2 * Ops<T>::kChunkBytes + kScoreBytes);
    x1 = reinterpret_cast<T*>(raw + 2 * Ops<T>::kChunkBytes + 2 * kScoreBytes);
    x2 = reinterpret_cast<T*>(raw + 2 * Ops<T>::kChunkBytes + 2 * kScoreBytes + Ops<T>::kXBytes);
    rows = reinterpret_cast<float*>(raw + 2 * Ops<T>::kChunkBytes + 2 * kScoreBytes + 2 * Ops<T>::kXBytes);
  }
};

// out (f32 [64][65] in shared memory) = rows a_start .. of A times rows
// b_start .. of B transposed, over the head's full width, its 128-wide
// chunks streamed through the shared tiles a and b. Rows past `time` are 0.
// Ends with a barrier: out is visible to the whole block.
template <typename T>
__device__ void full_width_scores(float* out, const Shared<T>& shared, const T* a_base, long long a_time_stride,
                                  int a_start, const T* b_base, long long b_time_stride, int b_start, int time,
                                  int head_dim) {
  typename Ops<T>::Scores scores;
  clear<T>(scores);
  for (int column0 = 0; column0 < head_dim; column0 += kChunk) {
    const int columns = min(kChunk, head_dim - column0);
    Ops<T>::load(shared.a, a_base + column0, a_time_stride, a_start, time, columns);
    Ops<T>::load(shared.b, b_base + column0, b_time_stride, b_start, time, columns);
    Ops<T>::wait();
    __syncthreads();
    Ops<T>::product_rows(scores, shared.a, shared.b);
    __syncthreads();  // every warp is done with a and b before they are refilled
  }
  Ops<T>::each(scores, [&](int row, int col, float& value) { out[row * kScoreStride + col] = value; });
  __syncthreads();
}

// The bias of keys start .. start + 63, scaled, -inf past `time`.
__device__ __forceinline__ void load_bias(float* tile, const float* bias_row, int start, int time, float bias_scale) {
  if (threadIdx.x < kRows) {
    const int t = start + threadIdx.x;
    tile[threadIdx.x] = t < time ? bias_row[t] * bias_scale : -INFINITY;
  }
}

// The keep bits of keys key0 .. key0 + 3 (key0 a multiple of 4) of one query.
__device__ __forceinline__ uint32_t keep_quad(const Mask& mask, int mask_head, int query, int key0) {
  if (!mask.enabled) return 0xFu;
  return philox::keep_nibble(philox::dropout_draws(mask.seed0, mask.seed1, mask_head, query, key0 / 4),
                             mask.threshold);
}

// One thread of a row's two: its 32 columns of the score tile start here.
__device__ __forceinline__ int half_column() { return 32 * (threadIdx.x & 1); }
__device__ __forceinline__ int tile_row() { return threadIdx.x >> 1; }

// Online softmax step of the forward for one 64-key tile: updates the peak
// and the (unmasked) total of each row, writes the masked weights, rounded
// to T, to x and each row's rescale factor.
template <typename T>
__device__ void forward_weights(const Shared<T>& shared, const float* bias_tile, float* peak, float* total,
                                float* rescale, float score_scale, const Mask& mask, int mask_head, int query,
                                int key_start) {
  const int row = tile_row(), first = half_column();
  const float* scores = shared.s + row * kScoreStride + first;
  float tile_max = -INFINITY;
#pragma unroll 8
  for (int j = 0; j < 32; ++j) tile_max = fmaxf(tile_max, scores[j] * score_scale + bias_tile[first + j]);
  tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
  const float old_max = peak[row];
  // The first tile holds a key inside the sequence, so new_max is finite.
  const float new_max = fmaxf(old_max, tile_max);
  float sum = 0.0f;
  T* weights = shared.x1 + row * Ops<T>::kXStride + first;
#pragma unroll 2
  for (int quad = 0; quad < 8; ++quad) {
    const uint32_t keep = keep_quad(mask, mask_head, query, key_start + first + 4 * quad);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int j = 4 * quad + w;
      const float weight = exp2f((scores[j] * score_scale - new_max) + bias_tile[first + j]);
      sum += weight;
      put(weights + j, (keep >> w) & 1u ? weight : 0.0f);
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if ((threadIdx.x & 1) == 0) {
    const float factor = exp2f(old_max - new_max);
    rescale[row] = factor;
    peak[row] = new_max;
    total[row] = total[row] * factor + sum;
  }
}

// K1 (kDropout false, keep_prob 1) and K5: one block per (64-query tile,
// head * chunks + chunk, batch). Strides: q, k, v, out.
template <typename T, bool kDropout>
__global__ void __launch_bounds__(kThreads, 1)
forward_kernel(const T* __restrict__ query, const T* __restrict__ key, const T* __restrict__ value,
               const float* __restrict__ key_bias, T* __restrict__ out, int time, int heads, int head_dim,
               int chunks, Strides strides, float score_scale, float bias_scale, Mask mask, float keep_prob) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const Shared<T> shared(shared_raw);
  float* peak = shared.rows;
  float* total = shared.rows + kRows;
  float* rescale = shared.rows + 2 * kRows;
  float* bias_tile = shared.rows + 3 * kRows;
  __shared__ int scratch[kThreads / 32];

  const int query_start = blockIdx.x * kRows;
  const int head = blockIdx.y / chunks;
  const int column0 = (blockIdx.y % chunks) * kChunk;
  const int out_columns = min(kChunk, head_dim - column0);
  const int batch = blockIdx.z;
  const long long head_offset = static_cast<long long>(head) * head_dim;
  const T* q_base = query + batch * strides.batch[0] + head_offset;
  const T* k_base = key + batch * strides.batch[1] + head_offset;
  const T* v_base = value + batch * strides.batch[2] + head_offset + column0;
  const float* bias_row = key_bias + static_cast<long long>(batch) * time;
  const int mask_head = mask.head_map(batch, head);
  if (!kDropout) mask.enabled = 0;

  if (threadIdx.x < kRows) {
    peak[threadIdx.x] = -INFINITY;
    total[threadIdx.x] = 0.0f;
  }
  const int key_tiles = tiles::key_tiles_needed(tiles::last_valid_key(bias_row, time, scratch), time);
  typename Ops<T>::Acc acc;
  clear<T>(acc);
  for (int tile = 0; tile < key_tiles; ++tile) {
    const int key_start = tile * kRows;
    load_bias(bias_tile, bias_row, key_start, time, bias_scale);
    full_width_scores(shared.s, shared, q_base, strides.time[0], query_start, k_base, strides.time[1], key_start,
                      time, head_dim);
    Ops<T>::load(shared.a, v_base, strides.time[2], key_start, time, out_columns);
    forward_weights(shared, bias_tile, peak, total, rescale, score_scale, mask, mask_head,
                    query_start + tile_row(), key_start);
    Ops<T>::wait();
    __syncthreads();
    Ops<T>::each(acc, [&](int row, int, float& value) { value *= rescale[row]; });
    Ops<T>::product_columns(acc, shared.x1, shared.a);
    __syncthreads();
  }
  T* o_base = out + batch * strides.batch[3] + head_offset + column0;
  Ops<T>::each(acc, [&](int row, int col, float& value) {
    const int t = query_start + row;
    if (t < time && col < out_columns)
      put(o_base + t * strides.time[3] + col, value / (fmaxf(total[row], kTinyTotal) * keep_prob));
  });
}

// mscale of (query, key): the kept draw's 1 / keep_prob, 0 when dropped, 1
// without dropout.
__device__ __forceinline__ float mask_scale(const Mask& mask, float inverse_keep, int mask_head, int query, int key) {
  if (!mask.enabled) return 1.0f;
  const uint4 draws = philox::dropout_draws(mask.seed0, mask.seed1, mask_head, query, key / 4);
  return philox::word(draws, key & 3) < mask.threshold ? inverse_keep : 0.0f;
}

// K4's kernel (a): row statistics (peak, 1 / total, <dp, p>) of a 64-query
// tile, written to stats [3, B, H, T] by the chunk-0 block, and dq's chunk.
// Strides: q, k, v, g, dq, dk, dv.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
backward_query_kernel(const T* __restrict__ query, const T* __restrict__ key, const T* __restrict__ value,
                      const T* __restrict__ grad, const float* __restrict__ key_bias, T* __restrict__ d_query,
                      float* __restrict__ stats, int time, int heads, int head_dim, int chunks, Strides strides,
                      float score_scale, float bias_scale, float sm_scale, Mask mask, float inverse_keep) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const Shared<T> shared(shared_raw);
  float* peak = shared.rows;
  float* total = shared.rows + kRows;  // then 1 / total
  float* term = shared.rows + 2 * kRows;
  float* bias_tile = shared.rows + 3 * kRows;
  __shared__ int scratch[kThreads / 32];

  const int query_start = blockIdx.x * kRows;
  const int head = blockIdx.y / chunks;
  const int chunk = blockIdx.y % chunks;
  const int column0 = chunk * kChunk;
  const int out_columns = min(kChunk, head_dim - column0);
  const int batch = blockIdx.z;
  const long long head_offset = static_cast<long long>(head) * head_dim;
  const T* q_base = query + batch * strides.batch[0] + head_offset;
  const T* k_base = key + batch * strides.batch[1] + head_offset;
  const T* v_base = value + batch * strides.batch[2] + head_offset;
  const T* g_base = grad + batch * strides.batch[3] + head_offset;
  const float* bias_row = key_bias + static_cast<long long>(batch) * time;
  const int batch_head = batch * heads + head;
  const int mask_head = mask.head_map(batch, head);
  const int row = tile_row(), first = half_column();
  const int own_query = query_start + row;

  if (threadIdx.x < kRows) {
    peak[threadIdx.x] = -INFINITY;
    total[threadIdx.x] = 0.0f;
    term[threadIdx.x] = 0.0f;
  }
  const int key_tiles = tiles::key_tiles_needed(tiles::last_valid_key(bias_row, time, scratch), time);

  // Pass 1: peak, total and the unnormalised <dp, e> online.
  for (int tile = 0; tile < key_tiles; ++tile) {
    const int key_start = tile * kRows;
    load_bias(bias_tile, bias_row, key_start, time, bias_scale);
    full_width_scores(shared.s, shared, q_base, strides.time[0], query_start, k_base, strides.time[1], key_start,
                      time, head_dim);
    full_width_scores(shared.dp, shared, g_base, strides.time[3], query_start, v_base, strides.time[2], key_start,
                      time, head_dim);
    const float* scores = shared.s + row * kScoreStride + first;
    const float* d_scores = shared.dp + row * kScoreStride + first;
    float tile_max = -INFINITY;
    for (int j = 0; j < 32; ++j) tile_max = fmaxf(tile_max, scores[j] * score_scale + bias_tile[first + j]);
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float old_max = peak[row];
    const float new_max = fmaxf(old_max, tile_max);
    float sum = 0.0f, weighted = 0.0f;
    for (int j = 0; j < 32; ++j) {
      const int k = key_start + first + j;
      const float e = exp2f((scores[j] * score_scale - new_max) + bias_tile[first + j]);
      sum += e;
      weighted += e * (d_scores[j] * mask_scale(mask, inverse_keep, mask_head, own_query, k));
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    weighted += __shfl_xor_sync(0xffffffffu, weighted, 1);
    if ((threadIdx.x & 1) == 0) {
      const float factor = exp2f(old_max - new_max);
      peak[row] = new_max;
      total[row] = total[row] * factor + sum;
      term[row] = term[row] * factor + weighted;
    }
    __syncthreads();
  }
  if (threadIdx.x < kRows) {
    const float inverse_total = 1.0f / fmaxf(total[threadIdx.x], kTinyTotal);
    total[threadIdx.x] = inverse_total;
    term[threadIdx.x] *= inverse_total;
    const int t = query_start + threadIdx.x;
    if (chunk == 0 && t < time) {
      const long long plane = static_cast<long long>(gridDim.z) * heads * time;
      const long long index = static_cast<long long>(batch_head) * time + t;
      stats[index] = peak[threadIdx.x];
      stats[plane + index] = inverse_total;
      stats[2 * plane + index] = term[threadIdx.x];
    }
  }
  __syncthreads();

  // Pass 2: ds = p o (mscale o dp - <dp, p>), dq's chunk += ds . k's chunk.
  typename Ops<T>::Acc acc;
  clear<T>(acc);
  for (int tile = 0; tile < key_tiles; ++tile) {
    const int key_start = tile * kRows;
    load_bias(bias_tile, bias_row, key_start, time, bias_scale);
    full_width_scores(shared.s, shared, q_base, strides.time[0], query_start, k_base, strides.time[1], key_start,
                      time, head_dim);
    full_width_scores(shared.dp, shared, g_base, strides.time[3], query_start, v_base, strides.time[2], key_start,
                      time, head_dim);
    Ops<T>::load(shared.a, k_base + column0, strides.time[1], key_start, time, out_columns);
    const float* scores = shared.s + row * kScoreStride + first;
    const float* d_scores = shared.dp + row * kScoreStride + first;
    T* out_row = shared.x1 + row * Ops<T>::kXStride + first;
    for (int j = 0; j < 32; ++j) {
      const int k = key_start + first + j;
      const float p = exp2f((scores[j] * score_scale - peak[row]) + bias_tile[first + j]) * total[row];
      const float dp = d_scores[j] * mask_scale(mask, inverse_keep, mask_head, own_query, k);
      put(out_row + j, p * (dp - term[row]));
    }
    Ops<T>::wait();
    __syncthreads();
    Ops<T>::product_columns(acc, shared.x1, shared.a);
    __syncthreads();
  }
  T* dq_base = d_query + batch * strides.batch[4] + head_offset + column0;
  Ops<T>::each(acc, [&](int r, int col, float& value) {
    const int t = query_start + r;
    if (t < time && col < out_columns) put(dq_base + t * strides.time[4] + col, value * sm_scale);
  });
}

// K4's kernel (b): dk's and dv's chunks of a 64-key tile over every query
// tile, from kernel (a)'s statistics. The score tiles are key-major (s^T =
// k.q^T, dp^T = v.g^T), so (mscale o p)^T and ds^T are the X operands of dv
// += (mscale o p)^T g and dk += ds^T q as they are.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
backward_key_kernel(const T* __restrict__ query, const T* __restrict__ key, const T* __restrict__ value,
                    const T* __restrict__ grad, const float* __restrict__ key_bias, const float* __restrict__ stats,
                    T* __restrict__ d_key, T* __restrict__ d_value, int time, int heads, int head_dim, int chunks,
                    Strides strides, float score_scale, float bias_scale, float sm_scale, Mask mask,
                    float inverse_keep) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  const Shared<T> shared(shared_raw);
  float* peak = shared.rows;                   // of the query tile's queries
  float* inverse_total = shared.rows + kRows;  // 0 past time: p = 0
  float* term = shared.rows + 2 * kRows;
  float* key_bias_tile = shared.rows + 3 * kRows;  // this block's keys

  const int key_start = blockIdx.x * kRows;
  const int head = blockIdx.y / chunks;
  const int column0 = (blockIdx.y % chunks) * kChunk;
  const int out_columns = min(kChunk, head_dim - column0);
  const int batch = blockIdx.z;
  const long long head_offset = static_cast<long long>(head) * head_dim;
  const T* q_base = query + batch * strides.batch[0] + head_offset;
  const T* k_base = key + batch * strides.batch[1] + head_offset;
  const T* v_base = value + batch * strides.batch[2] + head_offset;
  const T* g_base = grad + batch * strides.batch[3] + head_offset;
  const int batch_head = batch * heads + head;
  const int mask_head = mask.head_map(batch, head);
  const long long plane = static_cast<long long>(gridDim.z) * heads * time;
  const int row = tile_row(), first = half_column();
  const int own_key = key_start + row;

  load_bias(key_bias_tile, key_bias + static_cast<long long>(batch) * time, key_start, time, bias_scale);
  typename Ops<T>::Acc d_key_acc, d_value_acc;
  clear<T>(d_key_acc);
  clear<T>(d_value_acc);
  for (int query_start = 0; query_start < time; query_start += kRows) {
    if (threadIdx.x < kRows) {
      const int t = query_start + threadIdx.x;
      const long long index = static_cast<long long>(batch_head) * time + t;
      peak[threadIdx.x] = t < time ? stats[index] : 0.0f;
      inverse_total[threadIdx.x] = t < time ? stats[plane + index] : 0.0f;
      term[threadIdx.x] = t < time ? stats[2 * plane + index] : 0.0f;
    }
    full_width_scores(shared.s, shared, k_base, strides.time[1], key_start, q_base, strides.time[0], query_start,
                      time, head_dim);
    full_width_scores(shared.dp, shared, v_base, strides.time[2], key_start, g_base, strides.time[3], query_start,
                      time, head_dim);
    Ops<T>::load(shared.a, g_base + column0, strides.time[3], query_start, time, out_columns);
    Ops<T>::load(shared.b, q_base + column0, strides.time[0], query_start, time, out_columns);
    const float* scores = shared.s + row * kScoreStride + first;
    const float* d_scores = shared.dp + row * kScoreStride + first;
    T* dropped_row = shared.x1 + row * Ops<T>::kXStride + first;
    T* d_scores_row = shared.x2 + row * Ops<T>::kXStride + first;
    for (int j = 0; j < 32; ++j) {
      const int q = first + j;
      const float p = query_start + q < time
                          ? exp2f((scores[j] * score_scale - peak[q]) + key_bias_tile[row]) * inverse_total[q]
                          : 0.0f;
      const float scale = mask_scale(mask, inverse_keep, mask_head, query_start + q, own_key);
      put(dropped_row + j, p * scale);
      put(d_scores_row + j, p * (d_scores[j] * scale - term[q]));
    }
    Ops<T>::wait();
    __syncthreads();
    Ops<T>::product_columns(d_value_acc, shared.x1, shared.a);
    Ops<T>::product_columns(d_key_acc, shared.x2, shared.b);
    __syncthreads();
  }
  T* dk_base = d_key + batch * strides.batch[5] + head_offset + column0;
  T* dv_base = d_value + batch * strides.batch[6] + head_offset + column0;
  Ops<T>::each(d_key_acc, [&](int r, int col, float& value) {
    const int t = key_start + r;
    if (t < time && col < out_columns) put(dk_base + t * strides.time[5] + col, value * sm_scale);
  });
  Ops<T>::each(d_value_acc, [&](int r, int col, float& value) {
    const int t = key_start + r;
    if (t < time && col < out_columns) put(dv_base + t * strides.time[6] + col, value);
  });
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

inline dim3 grid(int time, int heads, int head_dim, int batch) {
  return dim3((time + kRows - 1) / kRows, heads * ((head_dim + kChunk - 1) / kChunk), batch);
}

// K1 (kDropout false) or K5 at a head width above 128. strides: q, k, v,
// out batch and time strides (8 values).
template <typename T, bool kDropout>
int launch_forward(const void* query, const void* key, const void* value, const float* key_bias, void* out,
                   int batch, int time, int heads, int head_dim, const long long* strides, float score_scale,
                   float bias_scale, Mask mask, float keep_prob, cudaStream_t stream) {
  constexpr size_t bytes = Shared<T>::kBytes;
  const cudaError_t status = allow_shared(forward_kernel<T, kDropout>, bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  forward_kernel<T, kDropout><<<grid(time, heads, head_dim, batch), kThreads, bytes, stream>>>(
      static_cast<const T*>(query), static_cast<const T*>(key), static_cast<const T*>(value), key_bias,
      static_cast<T*>(out), time, heads, head_dim, (head_dim + kChunk - 1) / kChunk, unpack_strides(strides, 4),
      score_scale, bias_scale, mask, keep_prob);
  return static_cast<int>(cudaGetLastError());
}

// K4 at a head width above 128. strides: q, k, v, g, dq, dk, dv batch and
// time strides (14 values).
template <typename T>
int launch_backward(const void* query, const void* key, const void* value, const void* grad, const float* key_bias,
                    void* d_query, void* d_key, void* d_value, float* stats, int batch, int time, int heads,
                    int head_dim, const long long* strides, float score_scale, float bias_scale, float sm_scale,
                    Mask mask, float inverse_keep, cudaStream_t stream) {
  constexpr size_t bytes = Shared<T>::kBytes;
  cudaError_t status = allow_shared(backward_query_kernel<T>, bytes);
  if (status == cudaSuccess) status = allow_shared(backward_key_kernel<T>, bytes);
  if (status != cudaSuccess) return static_cast<int>(status);
  const int chunks = (head_dim + kChunk - 1) / kChunk;
  const Strides packed = unpack_strides(strides, 7);
  const T* q = static_cast<const T*>(query);
  const T* k = static_cast<const T*>(key);
  const T* v = static_cast<const T*>(value);
  const T* g = static_cast<const T*>(grad);
  backward_query_kernel<T><<<grid(time, heads, head_dim, batch), kThreads, bytes, stream>>>(
      q, k, v, g, key_bias, static_cast<T*>(d_query), stats, time, heads, head_dim, chunks, packed, score_scale,
      bias_scale, sm_scale, mask, inverse_keep);
  status = cudaGetLastError();
  if (status != cudaSuccess) return static_cast<int>(status);
  backward_key_kernel<T><<<grid(time, heads, head_dim, batch), kThreads, bytes, stream>>>(
      q, k, v, g, key_bias, stats, static_cast<T*>(d_key), static_cast<T*>(d_value), time, heads, head_dim, chunks,
      packed, score_scale, bias_scale, sm_scale, mask, inverse_keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wide
