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
//     P.V, and the sum is divided by total * keep_prob after it, with
//     keep_prob = threshold / 2^32;
//   * for f32 inputs every product and sum is plain f32: no TF32.
//
// What bounds it on the H100: like K1, arithmetic (4 * T^2 * hd operations per
// (batch, head) against 4 * T * hd elements moved) plus one Philox call per
// four weights (ten rounds of two 32-bit multiplies and xors). This first
// version runs on the CUDA cores (FFMA), so it is capped near the f32 vector
// rate; tensor cores (wgmma) are later work.
//
// Design: K1's, one block per (batch, head, 64-query tile), looping over
// 64-key tiles with an online max and sum; shared memory ~66 KB for hd = 64
// whatever T is, so every T is served (the TPU's dropout plan stops at
// T = 512). Each thread owns 4 query rows and two runs of 4 consecutive key
// columns of the score tile, so one Philox call gives the draws of one run.
// q, k and v are read in place through their batch and time strides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;      // 16 row groups x 8 column lanes
constexpr int kRowsPerThread = 4;  // query rows per thread
constexpr int kColsPerThread = 8;  // key columns per thread: two runs of 4
constexpr float kTinyTotal = 1e-30f;

__device__ __forceinline__ float load_as_float(const float* pointer) { return *pointer; }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* pointer) {
  return __bfloat162float(*pointer);
}
__device__ __forceinline__ void store_from_float(float* pointer, float value) { *pointer = value; }
__device__ __forceinline__ void store_from_float(__nv_bfloat16* pointer, float value) {
  *pointer = __float2bfloat16(value);
}
__device__ __forceinline__ float round_to(float value, const float*) { return value; }
__device__ __forceinline__ float round_to(float value, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(value));
}

// Key column (within the tile) of a thread's j-th score: runs of 4 at
// 4 * lane and 32 + 4 * lane.
__device__ __forceinline__ int score_column(int lane_col, int j) {
  return (j >> 2) * 32 + lane_col * 4 + (j & 3);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attention_dropout_kernel(const T* __restrict__ query, const T* __restrict__ key,
                         const T* __restrict__ value, const float* __restrict__ key_bias,
                         T* __restrict__ out, int time, int heads,
                         long long q_batch_stride, long long q_time_stride,
                         long long k_batch_stride, long long k_time_stride,
                         long long v_batch_stride, long long v_time_stride,
                         long long o_batch_stride, long long o_time_stride,
                         float score_scale, float bias_scale, uint32_t seed0, uint32_t seed1,
                         uint32_t threshold, float keep_prob) {
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
  const int batch_head = batch * heads + head;
  const int head_offset = head * HD;

  const T* q_base = query + batch * q_batch_stride + head_offset;
  const T* k_base = key + batch * k_batch_stride + head_offset;
  const T* v_base = value + batch * v_batch_stride + head_offset;
  const float* bias_base = key_bias + static_cast<long long>(batch) * time;

  for (int index = tid; index < kBlockQ * HD; index += kThreads) {
    const int row = index / HD;
    const int col = index % HD;
    const int t = query_start + row;
    q_tile[row * kQkStride + col] = t < time ? load_as_float(q_base + t * q_time_stride + col) : 0.0f;
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
      const bool inside = t < time;
      k_tile[row * kQkStride + col] = inside ? load_as_float(k_base + t * k_time_stride + col) : 0.0f;
      v_tile[row * HD + col] = inside ? load_as_float(v_base + t * v_time_stride + col) : 0.0f;
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
      const uint4 draws0 = philox::dropout_draws(seed0, seed1, batch_head, query_start + row,
                                                 key_start / 4 + lane_col);
      const uint4 draws1 = philox::dropout_draws(seed0, seed1, batch_head, query_start + row,
                                                 (key_start + 32) / 4 + lane_col);
      float tile_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int col = score_column(lane_col, j);
        const float weight = exp2f((scores[i][j] - new_max) + bias_tile[col]);
        tile_sum += weight;
        const uint32_t draw = philox::word(j < 4 ? draws0 : draws1, j & 3);
        p_tile[row * kPStride + col] = draw < threshold ? round_to(weight, query) : 0.0f;
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

  T* o_base = out + batch * o_batch_stride + head_offset;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int t = query_start + row_group * kRowsPerThread + i;
    if (t >= time) continue;
    const float denominator = fmaxf(row_sum[i], kTinyTotal) * keep_prob;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j)
      store_from_float(o_base + t * o_time_stride + lane_col + 8 * j, acc[i][j] / denominator);
  }
}

// K6: one thread per (batch * heads + head, row, run of four columns).
__global__ void dropout_mask_kernel(uint32_t* __restrict__ out, int batch_heads, int time,
                                    uint32_t seed0, uint32_t seed1) {
  const int quads = (time + 3) / 4;
  const long long index = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(batch_heads) * time * quads;
  if (index >= total) return;
  const int quad = static_cast<int>(index % quads);
  const long long rest = index / quads;
  const int row = static_cast<int>(rest % time);
  const int batch_head = static_cast<int>(rest / time);
  const uint4 draws = philox::dropout_draws(seed0, seed1, batch_head, row, quad);
  uint32_t* row_out = out + (static_cast<long long>(batch_head) * time + row) * time;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int col = quad * 4 + w;
    if (col < time) row_out[col] = philox::word(draws, w);
  }
}

template <int HD>
constexpr size_t shared_bytes() {
  return sizeof(float) *
         (kBlockQ * (HD + 1) + kBlockK * (HD + 1) + kBlockK * HD + kBlockQ * (kBlockK + 1) + kBlockK);
}

template <typename T, int HD>
int launch(const void* query, const void* key, const void* value, const float* key_bias, void* out,
           int batch, int time, int heads, const long long* strides, float score_scale,
           float bias_scale, uint32_t seed0, uint32_t seed1, uint32_t threshold, float keep_prob,
           cudaStream_t stream) {
  constexpr size_t bytes = shared_bytes<HD>();
  cudaError_t status = cudaFuncSetAttribute(attention_dropout_kernel<T, HD>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            static_cast<int>(bytes));
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid((time + kBlockQ - 1) / kBlockQ, heads, batch);
  attention_dropout_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(query), static_cast<const T*>(key), static_cast<const T*>(value),
      key_bias, static_cast<T*>(out), time, heads, strides[0], strides[1], strides[2], strides[3],
      strides[4], strides[5], strides[6], strides[7], score_scale, bias_scale, seed0, seed1,
      threshold, keep_prob);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: q, k, v, out batch and time strides in elements (8 values); the
// head-dim axis must be contiguous. dtype: 0 = f32, 1 = bf16. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int attention_dropout_forward(const void* query, const void* key, const void* value,
                                         const float* key_bias, void* out, int batch, int time,
                                         int heads, int head_dim, const long long* strides,
                                         float score_scale, float bias_scale, uint32_t seed0,
                                         uint32_t seed1, uint32_t threshold, float keep_prob,
                                         int dtype, void* stream) {
  cudaStream_t cuda_stream = static_cast<cudaStream_t>(stream);
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float, 64>(query, key, value, key_bias, out, batch, time, heads, strides,
                             score_scale, bias_scale, seed0, seed1, threshold, keep_prob, cuda_stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, 64>(query, key, value, key_bias, out, batch, time, heads, strides,
                                     score_scale, bias_scale, seed0, seed1, threshold, keep_prob,
                                     cuda_stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out: u32 [B, H, T, T], contiguous.
extern "C" int dropout_mask_forward(void* out, int batch, int heads, int time, uint32_t seed0,
                                    uint32_t seed1, void* stream) {
  const long long threads = static_cast<long long>(batch) * heads * time * ((time + 3) / 4);
  constexpr int kMaskThreads = 256;
  const long long blocks = (threads + kMaskThreads - 1) / kMaskThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dropout_mask_kernel<<<static_cast<unsigned>(blocks), kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), batch * heads, time, seed0, seed1);
  return static_cast<int>(cudaGetLastError());
}
