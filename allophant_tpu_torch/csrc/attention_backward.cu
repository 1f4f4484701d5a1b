// Fused attention backward (K4) for Hopper (sm_90a): dq, dk and dv of
// out = (m/keep o softmax(q k^T * s + bias)) v over the projection layout
// [B, T, H*hd], with the dropout mask m regenerated from its seeds (Philox,
// philox.cuh), or no mask at all for the backward of plain attention (K1).
//
// Replaces allophant_tpu/ops/oneshot_attention.py:
// _attention_dropout_bwd_kernel (launched by _oneshot_dropout_backward, which
// is also the backward of the dropout-free one-shot attention with
// rate=None).
//
// Math (the TPU kernel's, p the softmax, mscale = m / keep):
//   dv = (mscale o p)^T g,   dp = mscale o (g v^T),
//   ds = p o (dp - <dp, p>_row),   dq = ds k s,   dk = ds^T q s.
// For bf16 inputs, mscale o p and ds are rounded to bf16 before their
// products, as the TPU kernel casts them to the input dtype; every sum is f32.
//
// Design: the TPU kernel holds a whole [T, T] tile in VMEM; a Hopper SM has
// 227 KB of shared memory, so nothing [T, T] is kept anywhere: no tile in
// device memory, no atomics. Two kernels:
//   (a) one block per (batch, head, 64-query tile) makes two passes over the
//       64-key tiles. Pass 1 computes the row statistics online: the peak of
//       the biased base-2 scores, the total of the exponentials (clamped at
//       1e-30, so a zero-length row has uniform p over all its keys, padded
//       ones included) and <dp, p>. Pass 2 recomputes p and dp, forms ds
//       exactly as the plain version does and accumulates dq = ds k s. The
//       three f32 statistics are written to a [3, B, H, T] scratch.
//   (b) one block per (batch, head, 64-key tile) accumulates dk and dv over
//       the query tiles from those statistics.
// Each score tile costs q.k^T and g.v^T again in both kernels (the price of
// no atomics and no [T, T] storage). In (a) a thread owns 4 query rows and two
// runs of 4 key columns; in (b) it owns 4 consecutive keys and 8 queries; so
// one Philox call gives the four draws a thread needs for one run.
//
// What bounds it on the H100: arithmetic, about 4.5x the forward's q.k^T and
// p.v (nine 64x64xhd tile products per tile pair against two), on the CUDA
// cores (FFMA) in this first version: moving them onto wgmma is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kBlock = 64;             // query and key tile
constexpr int kThreads = 128;          // 16 row groups x 8 column lanes
constexpr int kRowsPerThread = 4;
constexpr int kColsPerThread = 8;
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

// Key column of a thread's j-th score in kernel (a): runs of 4 at 4 * lane
// and 32 + 4 * lane.
__device__ __forceinline__ int run_column(int lane_col, int j) {
  return (j >> 2) * 32 + lane_col * 4 + (j & 3);
}

struct Strides {
  long long q_batch, q_time, k_batch, k_time, v_batch, v_time, g_batch, g_time;
  long long dq_batch, dq_time, dk_batch, dk_time, dv_batch, dv_time;
};

struct Dropout {
  uint32_t seed0, seed1, threshold;
  float inverse_keep;  // 2^32 / threshold
  int enabled;         // 0: the backward of plain attention, no mask
};

// Loads a [kBlock][HD] tile of a [B, T, H*hd] tensor (rows past `time` zero)
// into shared memory with row stride HD + 1.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* tile, const T* base, long long time_stride, int start,
                                          int time) {
  for (int index = threadIdx.x; index < kBlock * HD; index += kThreads) {
    const int row = index / HD;
    const int col = index % HD;
    const int t = start + row;
    tile[row * (HD + 1) + col] = t < time ? load_as_float(base + t * time_stride + col) : 0.0f;
  }
}

// Kernel (a): row statistics and dq.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attention_backward_query_kernel(const T* __restrict__ query, const T* __restrict__ key,
                                const T* __restrict__ value, const T* __restrict__ grad,
                                const float* __restrict__ key_bias, T* __restrict__ d_query,
                                float* __restrict__ stats, int batch_size, int time, int heads,
                                Strides strides, float score_scale, float bias_scale, float sm_scale,
                                Dropout dropout) {
  constexpr int kOutCols = HD / 8;
  constexpr int kStride = HD + 1;
  constexpr int kPStride = kBlock + 1;

  extern __shared__ float shared[];
  float* q_tile = shared;                      // [kBlock][HD + 1]
  float* g_tile = q_tile + kBlock * kStride;   // [kBlock][HD + 1]
  float* k_tile = g_tile + kBlock * kStride;   // [kBlock][HD + 1]
  float* v_tile = k_tile + kBlock * kStride;   // [kBlock][HD + 1]
  float* ds_tile = v_tile + kBlock * kStride;  // [kBlock][kBlock + 1]
  float* bias_tile = ds_tile + kBlock * kPStride;

  const int tid = threadIdx.x;
  const int lane_col = tid & 7;
  const int row_group = tid >> 3;
  const int query_start = blockIdx.x * kBlock;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int batch_head = batch * heads + head;
  const int head_offset = head * HD;

  const T* k_base = key + batch * strides.k_batch + head_offset;
  const T* v_base = value + batch * strides.v_batch + head_offset;
  const float* bias_base = key_bias + static_cast<long long>(batch) * time;
  load_tile<T, HD>(q_tile, query + batch * strides.q_batch + head_offset, strides.q_time, query_start, time);
  load_tile<T, HD>(g_tile, grad + batch * strides.g_batch + head_offset, strides.g_time, query_start, time);

  float row_max[kRowsPerThread], row_sum[kRowsPerThread], row_dot[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    row_max[i] = -INFINITY;
    row_sum[i] = 0.0f;
    row_dot[i] = 0.0f;
  }
  float scores[kRowsPerThread][kColsPerThread];
  float d_probs[kRowsPerThread][kColsPerThread];

  // s = (q.k^T) * score_scale and dp = mscale o (g.v^T) of the current tiles.
  auto tile_products = [&](int key_start) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) scores[i][j] = d_probs[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[kRowsPerThread], c[kRowsPerThread], b[kColsPerThread], e[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        a[i] = q_tile[(row_group * kRowsPerThread + i) * kStride + d];
        c[i] = g_tile[(row_group * kRowsPerThread + i) * kStride + d];
      }
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        b[j] = k_tile[run_column(lane_col, j) * kStride + d];
        e[j] = v_tile[run_column(lane_col, j) * kStride + d];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          scores[i][j] = fmaf(a[i], b[j], scores[i][j]);
          d_probs[i][j] = fmaf(c[i], e[j], d_probs[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = query_start + row_group * kRowsPerThread + i;
      uint4 draws0 = make_uint4(0u, 0u, 0u, 0u), draws1 = draws0;
      if (dropout.enabled) {
        draws0 = philox::dropout_draws(dropout.seed0, dropout.seed1, batch_head, row, key_start / 4 + lane_col);
        draws1 = philox::dropout_draws(dropout.seed0, dropout.seed1, batch_head, row,
                                       (key_start + 32) / 4 + lane_col);
      }
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        scores[i][j] *= score_scale;
        if (dropout.enabled) {
          const uint32_t draw = philox::word(j < 4 ? draws0 : draws1, j & 3);
          d_probs[i][j] *= draw < dropout.threshold ? dropout.inverse_keep : 0.0f;
        }
      }
    }
  };

  auto load_keys = [&](int key_start) {
    __syncthreads();
    load_tile<T, HD>(k_tile, k_base, strides.k_time, key_start, time);
    load_tile<T, HD>(v_tile, v_base, strides.v_time, key_start, time);
    for (int index = tid; index < kBlock; index += kThreads) {
      const int t = key_start + index;
      bias_tile[index] = t < time ? bias_base[t] * bias_scale : -INFINITY;
    }
    __syncthreads();
  };

  // Pass 1: peak, total and <dp, e> online, with e = exp2((s - peak) + bias).
  for (int key_start = 0; key_start < time; key_start += kBlock) {
    load_keys(key_start);
    tile_products(key_start);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        tile_max = fmaxf(tile_max, scores[i][j] + bias_tile[run_column(lane_col, j)]);
#pragma unroll
      for (int offset = 1; offset < 8; offset <<= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, offset));
      const float new_max = fmaxf(row_max[i], tile_max);
      const float rescale = exp2f(row_max[i] - new_max);
      row_max[i] = new_max;
      float tile_sum = 0.0f, tile_dot = 0.0f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float weight = exp2f((scores[i][j] - new_max) + bias_tile[run_column(lane_col, j)]);
        tile_sum += weight;
        tile_dot = fmaf(weight, d_probs[i][j], tile_dot);
      }
#pragma unroll
      for (int offset = 1; offset < 8; offset <<= 1) {
        tile_sum += __shfl_xor_sync(0xffffffffu, tile_sum, offset);
        tile_dot += __shfl_xor_sync(0xffffffffu, tile_dot, offset);
      }
      row_sum[i] = row_sum[i] * rescale + tile_sum;
      row_dot[i] = row_dot[i] * rescale + tile_dot;
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    row_sum[i] = fmaxf(row_sum[i], kTinyTotal);
    row_dot[i] = row_dot[i] / row_sum[i];
  }

  // Pass 2: ds = p o (dp - <dp, p>), rounded as the TPU kernel rounds it, and
  // dq = ds k.
  float acc[kRowsPerThread][kOutCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) acc[i][j] = 0.0f;
  for (int key_start = 0; key_start < time; key_start += kBlock) {
    load_keys(key_start);
    tile_products(key_start);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int row = row_group * kRowsPerThread + i;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int col = run_column(lane_col, j);
        const float prob = exp2f((scores[i][j] - row_max[i]) + bias_tile[col]) / row_sum[i];
        ds_tile[row * kPStride + col] = round_to(prob * (d_probs[i][j] - row_dot[i]), query);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kBlock; ++k) {
      float ds[kRowsPerThread], kv[kOutCols];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) ds[i] = ds_tile[(row_group * kRowsPerThread + i) * kPStride + k];
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) kv[j] = k_tile[k * kStride + lane_col + 8 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kOutCols; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
  }

  T* dq_base = d_query + batch * strides.dq_batch + head_offset;
  const long long plane = static_cast<long long>(batch_size) * heads * time;
  float* stats_row = stats + static_cast<long long>(batch_head) * time;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int t = query_start + row_group * kRowsPerThread + i;
    if (t >= time) continue;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j)
      store_from_float(dq_base + t * strides.dq_time + lane_col + 8 * j, acc[i][j] * sm_scale);
    if (lane_col == 0) {
      stats_row[t] = row_max[i];
      stats_row[plane + t] = row_sum[i];
      stats_row[2 * plane + t] = row_dot[i];
    }
  }
}

// Kernel (b): dk and dv of one 64-key tile over every query tile.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attention_backward_key_kernel(const T* __restrict__ query, const T* __restrict__ key,
                              const T* __restrict__ value, const T* __restrict__ grad,
                              const float* __restrict__ key_bias, const float* __restrict__ stats,
                              T* __restrict__ d_key, T* __restrict__ d_value, int batch_size, int time,
                              int heads, Strides strides, float score_scale, float bias_scale,
                              float sm_scale, Dropout dropout) {
  constexpr int kOutCols = HD / 8;
  constexpr int kStride = HD + 1;
  constexpr int kPStride = kBlock + 1;

  extern __shared__ float shared[];
  float* k_tile = shared;                        // [kBlock keys][HD + 1]
  float* v_tile = k_tile + kBlock * kStride;     // [kBlock keys][HD + 1]
  float* q_tile = v_tile + kBlock * kStride;     // [kBlock queries][HD + 1]
  float* g_tile = q_tile + kBlock * kStride;     // [kBlock queries][HD + 1]
  float* pt_tile = g_tile + kBlock * kStride;    // [kBlock keys][kBlock + 1]: mscale o p
  float* dst_tile = pt_tile + kBlock * kPStride; // [kBlock keys][kBlock + 1]: p, then ds
  float* bias_tile = dst_tile + kBlock * kPStride;
  float* peak_tile = bias_tile + kBlock;
  float* total_tile = peak_tile + kBlock;
  float* dot_tile = total_tile + kBlock;

  const int tid = threadIdx.x;
  const int lane_col = tid & 7;  // query lane
  const int row_group = tid >> 3;  // keys row_group * 4 .. + 3
  const int key_start = blockIdx.x * kBlock;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int batch_head = batch * heads + head;
  const int head_offset = head * HD;
  const long long plane = static_cast<long long>(batch_size) * heads * time;
  const float* stats_row = stats + static_cast<long long>(batch_head) * time;
  const float* bias_base = key_bias + static_cast<long long>(batch) * time;

  load_tile<T, HD>(k_tile, key + batch * strides.k_batch + head_offset, strides.k_time, key_start, time);
  load_tile<T, HD>(v_tile, value + batch * strides.v_batch + head_offset, strides.v_time, key_start, time);
  for (int index = tid; index < kBlock; index += kThreads) {
    const int t = key_start + index;
    bias_tile[index] = t < time ? bias_base[t] * bias_scale : -INFINITY;
  }
  const T* q_base = query + batch * strides.q_batch + head_offset;
  const T* g_base = grad + batch * strides.g_batch + head_offset;

  float dk_acc[kRowsPerThread][kOutCols], dv_acc[kRowsPerThread][kOutCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  for (int query_start = 0; query_start < time; query_start += kBlock) {
    __syncthreads();
    load_tile<T, HD>(q_tile, q_base, strides.q_time, query_start, time);
    load_tile<T, HD>(g_tile, g_base, strides.g_time, query_start, time);
    for (int index = tid; index < kBlock; index += kThreads) {
      const int t = query_start + index;
      const bool inside = t < time;
      // A query past the sequence gets p = 0: exp2(s - inf) = 0.
      peak_tile[index] = inside ? stats_row[t] : INFINITY;
      total_tile[index] = inside ? stats_row[plane + t] : 1.0f;
      dot_tile[index] = inside ? stats_row[2 * plane + t] : 0.0f;
    }
    __syncthreads();

    // s^T (keys x queries), then p and the mask; mscale o p to pt_tile, p to dst_tile.
    float tile[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) tile[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[kRowsPerThread], b[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) a[i] = k_tile[(row_group * kRowsPerThread + i) * kStride + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) b[j] = q_tile[(lane_col + 8 * j) * kStride + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) tile[i][j] = fmaf(a[i], b[j], tile[i][j]);
    }
    uint32_t kept = 0xffffffffu;  // bit i * 8 + j: weight (key i, query j) kept
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int query_col = lane_col + 8 * j;
      if (dropout.enabled) {
        // The four consecutive keys of this thread share one draw call.
        const uint4 draws = philox::dropout_draws(dropout.seed0, dropout.seed1, batch_head,
                                                  query_start + query_col, (key_start + row_group * 4) / 4);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          if (philox::word(draws, i) >= dropout.threshold) kept &= ~(1u << (i * 8 + j));
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int key_row = row_group * kRowsPerThread + i;
        const float prob =
            exp2f((tile[i][j] * score_scale - peak_tile[query_col]) + bias_tile[key_row]) / total_tile[query_col];
        const float mscale = dropout.enabled ? ((kept >> (i * 8 + j)) & 1u ? dropout.inverse_keep : 0.0f) : 1.0f;
        pt_tile[key_row * kPStride + query_col] = round_to(prob * mscale, query);
        dst_tile[key_row * kPStride + query_col] = prob;
      }
    }

    // dp^T = mscale o (v.g^T), then ds over the p this thread stored.
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) tile[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[kRowsPerThread], b[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) a[i] = v_tile[(row_group * kRowsPerThread + i) * kStride + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) b[j] = g_tile[(lane_col + 8 * j) * kStride + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) tile[i][j] = fmaf(a[i], b[j], tile[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int key_row = row_group * kRowsPerThread + i;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int query_col = lane_col + 8 * j;
        const float mscale = dropout.enabled ? ((kept >> (i * 8 + j)) & 1u ? dropout.inverse_keep : 0.0f) : 1.0f;
        const float prob = dst_tile[key_row * kPStride + query_col];
        dst_tile[key_row * kPStride + query_col] =
            round_to(prob * (tile[i][j] * mscale - dot_tile[query_col]), query);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int q = 0; q < kBlock; ++q) {
      float p[kRowsPerThread], ds[kRowsPerThread], gv[kOutCols], qv[kOutCols];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        p[i] = pt_tile[(row_group * kRowsPerThread + i) * kPStride + q];
        ds[i] = dst_tile[(row_group * kRowsPerThread + i) * kPStride + q];
      }
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) {
        gv[j] = g_tile[q * kStride + lane_col + 8 * j];
        qv[j] = q_tile[q * kStride + lane_col + 8 * j];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kOutCols; ++j) {
          dv_acc[i][j] = fmaf(p[i], gv[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(ds[i], qv[j], dk_acc[i][j]);
        }
    }
  }

  T* dk_base = d_key + batch * strides.dk_batch + head_offset;
  T* dv_base = d_value + batch * strides.dv_batch + head_offset;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int t = key_start + row_group * kRowsPerThread + i;
    if (t >= time) continue;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) {
      store_from_float(dk_base + t * strides.dk_time + lane_col + 8 * j, dk_acc[i][j] * sm_scale);
      store_from_float(dv_base + t * strides.dv_time + lane_col + 8 * j, dv_acc[i][j]);
    }
  }
}

template <int HD>
constexpr size_t query_shared_bytes() {
  return sizeof(float) * (4 * kBlock * (HD + 1) + kBlock * (kBlock + 1) + kBlock);
}

template <int HD>
constexpr size_t key_shared_bytes() {
  return sizeof(float) * (4 * kBlock * (HD + 1) + 2 * kBlock * (kBlock + 1) + 4 * kBlock);
}

template <typename T, int HD>
int launch(const void* query, const void* key, const void* value, const void* grad, const float* key_bias,
           void* d_query, void* d_key, void* d_value, float* stats, int batch, int time, int heads,
           const Strides& strides, float score_scale, float bias_scale, float sm_scale, const Dropout& dropout,
           cudaStream_t stream) {
  constexpr size_t query_bytes = query_shared_bytes<HD>();
  constexpr size_t key_bytes = key_shared_bytes<HD>();
  cudaError_t status = cudaFuncSetAttribute(attention_backward_query_kernel<T, HD>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            static_cast<int>(query_bytes));
  if (status != cudaSuccess) return static_cast<int>(status);
  status = cudaFuncSetAttribute(attention_backward_key_kernel<T, HD>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(key_bytes));
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid((time + kBlock - 1) / kBlock, heads, batch);
  const T* q = static_cast<const T*>(query);
  const T* k = static_cast<const T*>(key);
  const T* v = static_cast<const T*>(value);
  const T* g = static_cast<const T*>(grad);
  attention_backward_query_kernel<T, HD><<<grid, kThreads, query_bytes, stream>>>(
      q, k, v, g, key_bias, static_cast<T*>(d_query), stats, batch, time, heads, strides, score_scale,
      bias_scale, sm_scale, dropout);
  status = cudaGetLastError();
  if (status != cudaSuccess) return static_cast<int>(status);
  attention_backward_key_kernel<T, HD><<<grid, kThreads, key_bytes, stream>>>(
      q, k, v, g, key_bias, stats, static_cast<T*>(d_key), static_cast<T*>(d_value), batch, time, heads,
      strides, score_scale, bias_scale, sm_scale, dropout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: q, k, v, g, dq, dk, dv batch and time strides in elements (14
// values); the head-dim axis must be contiguous. stats: f32 [3, B, H, T]
// scratch. use_dropout 0 computes the backward of plain attention (the seeds,
// threshold and inverse_keep are then unused). dtype: 0 = f32, 1 = bf16.
// Returns cudaGetLastError() after the two launches (0 on success).
extern "C" int attention_backward(const void* query, const void* key, const void* value, const void* grad,
                                  const float* key_bias, void* d_query, void* d_key, void* d_value,
                                  float* stats, int batch, int time, int heads, int head_dim,
                                  const long long* strides, float score_scale, float bias_scale,
                                  float sm_scale, uint32_t seed0, uint32_t seed1, uint32_t threshold,
                                  float inverse_keep, int use_dropout, int dtype, void* stream) {
  cudaStream_t cuda_stream = static_cast<cudaStream_t>(stream);
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  const Strides packed{strides[0], strides[1], strides[2],  strides[3],  strides[4],  strides[5],  strides[6],
                       strides[7], strides[8], strides[9], strides[10], strides[11], strides[12], strides[13]};
  const Dropout dropout{seed0, seed1, threshold, inverse_keep, use_dropout};
  if (dtype == 0)
    return launch<float, 64>(query, key, value, grad, key_bias, d_query, d_key, d_value, stats, batch, time,
                             heads, packed, score_scale, bias_scale, sm_scale, dropout, cuda_stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, 64>(query, key, value, grad, key_bias, d_query, d_key, d_value, stats, batch,
                                     time, heads, packed, score_scale, bias_scale, sm_scale, dropout,
                                     cuda_stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
