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
// p is the base-2 softmax of the forward kernels: peak over the biased
// scores, exponent (s - peak) + bias, keys past T at -inf, total clamped at
// 1e-30 (a zero-length row has uniform p over all its keys, padded ones
// included). For bf16 inputs, mscale o p and ds are rounded to bf16 before
// their products, as the TPU kernel casts them to the input dtype; every sum
// is f32.
//
// Design: the TPU kernel holds a whole [T, T] tile in VMEM; a Hopper SM has
// 227 KB of shared memory, so nothing [T, T] is kept anywhere: no tile in
// device memory, no atomics, and two calls give bit-equal results. Two
// kernels:
//   (a) one block per (batch, head, 64-query tile) makes two passes over the
//       64-key tiles. Pass 1 computes the row statistics online: the peak,
//       the total and <dp, p>. Pass 2 recomputes p and dp, forms ds exactly
//       as the plain version does and accumulates dq = ds k s. The three f32
//       statistics are written to a [3, B, H, T] scratch.
//   (b) one block per (batch, head, 64-key tile) accumulates dk and dv over
//       the query tiles from those statistics.
// Each score tile costs q.k^T and g.v^T again in both kernels (the price of
// no atomics and no [T, T] storage): nine 64 x 64 x hd products per tile pair.
//
// bf16 (the "mixed" preset that training runs), on the tensor cores: four
// warps, each owning 16 rows (queries in (a), keys in (b)); every product is
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix
// (attention_tiles.cuh). The block's own q and g (in (a)) or k and v (in (b))
// are loaded once as A fragments; the streamed tiles are bf16 in shared
// memory, filled by 16-byte cp.async into a double buffer, so that tile
// n + 1's copy overlaps tile n's products. In (a), s = q.k^T and dp = g.v^T
// read k and v row-wise and dq = ds.k reads k through ldmatrix.trans; row
// statistics reduce over a row's four lanes with shuffles. In (b), s^T = k.q^T
// and dp^T = v.g^T come out key-major, so (mscale o p)^T and ds^T are
// already in the A-fragment layout of dv = (mscale o p)^T g and dk = ds^T q:
// they are rounded to bf16 in registers, with no shared-memory round trip,
// and g and q are read through ldmatrix.trans. Key tiles past a batch row's
// last valid key are skipped in (a), and their dk and dv written as zeros in
// (b): with a -1e9 bias their p is exactly 0 in f32 once a valid key sets
// the peak (a zero-length row keeps every key). p is the exponential times
// the reciprocal of the total, one division per row instead of one per score
// (an f32 division is a dozen instructions; p differs from the quotient by
// at most an f32 rounding, far below the bf16 rounding that follows). Kernel
// (a) keeps pass 1's keep bits of the first 16 key tiles in shared memory
// for pass 2.
//
// The Philox words on m16n8 accumulator fragments. A draw is word col % 4 of
// the call with counter (col / 4, row, b * H + h), so one call covers four
// consecutive key columns of one query row. In (a), a lane holds rows g and
// g + 8 and the column pairs {2c, 2c + 1} of each n8 tile: lanes c = 2m and
// 2m + 1 need the two halves of the same call, for both rows. They share it
// by shuffle: the even lane draws row g's call, the odd lane row g + 8's, and
// one __shfl_xor_sync(1) of the 32 packed keep bits (four per n8 tile) gives
// each lane the half of its partner's call that it needs (this mapping is
// philox::query_tile_keep_bits, which K5's bf16 forward shares, so the two
// draw one mask). In (b), rows are
// keys and columns queries: the four lanes of equal c whose keys g lie in one
// quad (g = 4a .. 4a + 3) need the four calls (query 2c or 2c + 1) x (key quad
// a or a + 2); lane g % 4 draws one of them, and four shuffles among those
// lanes gather the four nibbles. A call is never computed by two lanes.
//
// What bounds it on the H100: arithmetic. Five products per (query, key)
// pair are the least the math needs (s, dp, dv, dq, dk); this design does
// nine, plus exp2 and, with dropout, one Philox call per four scores and
// pass on the CUDA cores; mma.sync's instruction rate caps the products
// below the tensor cores' wgmma rate (the next step).
//
// f32 keeps the first version's arithmetic on the CUDA cores (FFMA), so that
// the "float32" preset stays full f32: in (a) a thread owns 4 query rows and
// two runs of 4 key columns, in (b) 4 consecutive keys and 8 queries, so one
// Philox call gives the four draws a thread needs for one run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "philox.cuh"

namespace {

constexpr int kBlock = 64;             // query and key tile
constexpr int kThreads = 128;
constexpr float kTinyTotal = 1e-30f;

struct Strides {
  long long q_batch, q_time, k_batch, k_time, v_batch, v_time, g_batch, g_time;
  long long dq_batch, dq_time, dk_batch, dk_time, dv_batch, dv_time;
};

struct Dropout {
  uint32_t seed0, seed1, threshold;
  float inverse_keep;  // 2^32 / threshold
  int enabled;         // 0: the backward of plain attention, no mask
};

// ---------------------------------------------------------------- f32, FFMA

constexpr int kRowsPerThread = 4;  // 16 row groups x 8 column lanes
constexpr int kColsPerThread = 8;

// Key column of a thread's j-th score in kernel (a): runs of 4 at 4 * lane
// and 32 + 4 * lane.
__device__ __forceinline__ int run_column(int lane_col, int j) {
  return (j >> 2) * 32 + lane_col * 4 + (j & 3);
}

// Loads a [kBlock][HD] tile of a [B, T, H*hd] tensor (rows past `time` and
// columns past the head's own width `columns` zero) into shared memory with
// row stride HD + 1.
template <int HD>
__device__ __forceinline__ void load_tile(float* tile, const float* base, long long time_stride, int start,
                                          int time, int columns) {
  for (int index = threadIdx.x; index < kBlock * HD; index += kThreads) {
    const int row = index / HD;
    const int col = index % HD;
    const int t = start + row;
    tile[row * (HD + 1) + col] = t < time && col < columns ? base[t * time_stride + col] : 0.0f;
  }
}

// Kernel (a): row statistics and dq.
template <int HD, bool kPadded>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 1 : 2)
attention_backward_query_kernel(const float* __restrict__ query, const float* __restrict__ key,
                                const float* __restrict__ value, const float* __restrict__ grad,
                                const float* __restrict__ key_bias, float* __restrict__ d_query,
                                float* __restrict__ stats, int batch_size, int time, int heads, int head_columns,
                                Strides strides, float score_scale, float bias_scale, float sm_scale,
                                Dropout dropout) {
  // The head's own width: the constant HD unless it runs padded.
  const int columns = kPadded ? head_columns : HD;
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
  const int head_offset = head * columns;

  const float* k_base = key + batch * strides.k_batch + head_offset;
  const float* v_base = value + batch * strides.v_batch + head_offset;
  const float* bias_base = key_bias + static_cast<long long>(batch) * time;
  load_tile<HD>(q_tile, query + batch * strides.q_batch + head_offset, strides.q_time, query_start, time, columns);
  load_tile<HD>(g_tile, grad + batch * strides.g_batch + head_offset, strides.g_time, query_start, time, columns);

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
    load_tile<HD>(k_tile, k_base, strides.k_time, key_start, time, columns);
    load_tile<HD>(v_tile, v_base, strides.v_time, key_start, time, columns);
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

  // Pass 2: ds = p o (dp - <dp, p>) and dq = ds k.
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
        ds_tile[row * kPStride + col] = prob * (d_probs[i][j] - row_dot[i]);
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

  float* dq_base = d_query + batch * strides.dq_batch + head_offset;
  const long long plane = static_cast<long long>(batch_size) * heads * time;
  float* stats_row = stats + static_cast<long long>(batch_head) * time;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int t = query_start + row_group * kRowsPerThread + i;
    if (t >= time) continue;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j)
      if (lane_col + 8 * j < columns) dq_base[t * strides.dq_time + lane_col + 8 * j] = acc[i][j] * sm_scale;
    if (lane_col == 0) {
      stats_row[t] = row_max[i];
      stats_row[plane + t] = row_sum[i];
      stats_row[2 * plane + t] = row_dot[i];
    }
  }
}

// Kernel (b): dk and dv of one 64-key tile over every query tile.
template <int HD, bool kPadded>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 1 : 2)
attention_backward_key_kernel(const float* __restrict__ query, const float* __restrict__ key,
                              const float* __restrict__ value, const float* __restrict__ grad,
                              const float* __restrict__ key_bias, const float* __restrict__ stats,
                              float* __restrict__ d_key, float* __restrict__ d_value, int batch_size, int time,
                              int heads, int head_columns, Strides strides, float score_scale, float bias_scale,
                              float sm_scale, Dropout dropout) {
  // The head's own width: the constant HD unless it runs padded.
  const int columns = kPadded ? head_columns : HD;
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
  const int head_offset = head * columns;
  const long long plane = static_cast<long long>(batch_size) * heads * time;
  const float* stats_row = stats + static_cast<long long>(batch_head) * time;
  const float* bias_base = key_bias + static_cast<long long>(batch) * time;

  load_tile<HD>(k_tile, key + batch * strides.k_batch + head_offset, strides.k_time, key_start, time, columns);
  load_tile<HD>(v_tile, value + batch * strides.v_batch + head_offset, strides.v_time, key_start, time, columns);
  for (int index = tid; index < kBlock; index += kThreads) {
    const int t = key_start + index;
    bias_tile[index] = t < time ? bias_base[t] * bias_scale : -INFINITY;
  }
  const float* q_base = query + batch * strides.q_batch + head_offset;
  const float* g_base = grad + batch * strides.g_batch + head_offset;

  float dk_acc[kRowsPerThread][kOutCols], dv_acc[kRowsPerThread][kOutCols];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.0f;

  for (int query_start = 0; query_start < time; query_start += kBlock) {
    __syncthreads();
    load_tile<HD>(q_tile, q_base, strides.q_time, query_start, time, columns);
    load_tile<HD>(g_tile, g_base, strides.g_time, query_start, time, columns);
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
        pt_tile[key_row * kPStride + query_col] = prob * mscale;
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
        dst_tile[key_row * kPStride + query_col] = prob * (tile[i][j] * mscale - dot_tile[query_col]);
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

  float* dk_base = d_key + batch * strides.dk_batch + head_offset;
  float* dv_base = d_value + batch * strides.dv_batch + head_offset;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int t = key_start + row_group * kRowsPerThread + i;
    if (t >= time) continue;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) {
      if (lane_col + 8 * j >= columns) continue;
      dk_base[t * strides.dk_time + lane_col + 8 * j] = dk_acc[i][j] * sm_scale;
      dv_base[t * strides.dv_time + lane_col + 8 * j] = dv_acc[i][j];
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

// ------------------------------------------------------- bf16, tensor cores

using bf16 = __nv_bfloat16;

// Key tiles whose keep bits kernel (a) draws in pass 1 and keeps in shared
// memory for pass 2 (8 KB, T <= 1,024); later tiles draw them again.
constexpr int kCachedMaskTiles = 16;

// Kernel (b)'s keep bits of a lane's 32 accumulator entries of one 16 x 64
// transposed score tile (bit 4j + e for entry e of n8 tile j): keys
// warp_key_start + g (e < 2) and + g + 8, queries query_start + 8j + 2c +
// (e & 1). Entry e's draw is word g % 4 of call e of the four lanes
// 16 (g / 4) + 4i + c, i = 0..3: lane i draws call i (query parity i & 1, key
// quad of g or of g + 8 by i / 2), and the lanes gather each other's nibbles.
__device__ __forceinline__ uint32_t key_tile_keep_bits(const Dropout& dropout, int batch_head, int warp_key_start,
                                                       int query_start, int lane) {
  const int group = lane >> 2;
  const int column = lane & 3;
  const int word = group & 3;
  const int quad = warp_key_start / 4 + (group >> 2) + 2 * (word >> 1);
  uint32_t own = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint4 draws = philox::dropout_draws(dropout.seed0, dropout.seed1, batch_head,
                                              query_start + 8 * j + 2 * column + (word & 1), quad);
    own |= philox::keep_nibble(draws, dropout.threshold) << (4 * j);
  }
  uint32_t kept = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t call = __shfl_sync(0xffffffffu, own, (lane & 0x13) | (e << 2));
#pragma unroll
    for (int j = 0; j < 8; ++j) kept |= ((call >> (4 * j + word)) & 1u) << (4 * j + e);
  }
  return kept;
}

__device__ __forceinline__ float mask_scale(const Dropout& dropout, uint32_t kept, int bit) {
  return dropout.enabled ? ((kept >> bit) & 1u ? dropout.inverse_keep : 0.0f) : 1.0f;
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
}

// Stores rows `row` and row + 8 (if inside `time`) of the first `columns`
// columns of a 16 x 8N f32 accumulator, times `scale`, as bf16 at base + t *
// time_stride.
template <int N>
__device__ __forceinline__ void store_rows(bf16* base, long long time_stride, int row, int time, int columns,
                                           const float (&acc)[N][4], float scale, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row + 8 * r;
    if (t >= time) continue;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (8 * j >= columns) break;
      *reinterpret_cast<__nv_bfloat162*>(base + t * time_stride + 8 * j + 2 * (lane & 3)) =
          __floats2bfloat162_rn(acc[j][2 * r] * scale, acc[j][2 * r + 1] * scale);
    }
  }
}

// Whether a kernel keeps its own rows' A fragments (q and g in (a), k and v
// in (b)) in registers for the whole block: up to 64-wide heads. Wider ones
// read them from their shared-memory tiles at each product, since the
// accumulators (dq, or dk and dv) grow with the head width.
template <int HD>
constexpr bool kHoldFragments = HD <= 64;

// Kernel (a), bf16: row statistics and dq. Up to 64-wide heads it is held to
// 168 registers, so that three blocks share an SM: at 64 it would take about
// 220 and spills 4 bytes at that limit, and runs a few percent faster at the
// training shape. Wider heads keep two blocks per SM (255 registers). Kernel
// (b) spills 136 bytes at 168 registers for no measurable gain, so it keeps
// two blocks per SM at every width.
template <int HD, bool kPadded>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 3 : 2)
attention_backward_query_mma_kernel(const bf16* __restrict__ query, const bf16* __restrict__ key,
                                    const bf16* __restrict__ value, const bf16* __restrict__ grad,
                                    const float* __restrict__ key_bias, bf16* __restrict__ d_query,
                                    float* __restrict__ stats, int batch_size, int time, int heads, int head_columns,
                                    Strides strides, float score_scale, float bias_scale, float sm_scale,
                                    Dropout dropout) {
  // The head's own width: the constant HD unless it runs padded.
  const int columns = kPadded ? head_columns : HD;
  constexpr int kTileElements = tiles::Head<HD>::kTileElements;
  constexpr bool kHold = kHoldFragments<HD>;
  extern __shared__ __align__(16) unsigned char shared_raw[];
  bf16* q_tile = reinterpret_cast<bf16*>(shared_raw);  // [64][HD + 8]
  bf16* g_tile = q_tile + kTileElements;                // [64][HD + 8]
  bf16* k_tiles = g_tile + kTileElements;               // 2 x [64][HD + 8]
  bf16* v_tiles = k_tiles + 2 * kTileElements;          // 2 x [64][HD + 8]
  __shared__ float bias_tiles[2][kBlock];
  __shared__ uint32_t cached_keep_bits[kCachedMaskTiles][kThreads];  // pass 1's, for pass 2
  __shared__ int scratch[kThreads / 32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int column = lane & 3;
  const int query_start = blockIdx.x * kBlock;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int batch_head = batch * heads + head;
  const int head_offset = head * columns;
  const int row = query_start + 16 * warp + (lane >> 2);  // and row + 8

  const bf16* k_base = key + batch * strides.k_batch + head_offset;
  const bf16* v_base = value + batch * strides.v_batch + head_offset;
  const float* bias_row = key_bias + static_cast<long long>(batch) * time;

  auto load_keys = [&](int tile, int buffer) {
    const int key_start = tile * kBlock;
    tiles::copy_tile_async<HD, kPadded>(k_tiles + buffer * kTileElements, k_base, strides.k_time, key_start, time, columns);
    tiles::copy_tile_async<HD, kPadded>(v_tiles + buffer * kTileElements, v_base, strides.v_time, key_start, time, columns);
    tiles::commit_copies();
    for (int index = threadIdx.x; index < kBlock; index += kThreads) {
      const int t = key_start + index;
      bias_tiles[buffer][index] = t < time ? bias_row[t] * bias_scale : -INFINITY;
    }
  };

  tiles::copy_tile_async<HD, kPadded>(q_tile, query + batch * strides.q_batch + head_offset, strides.q_time, query_start,
                             time, columns);
  tiles::copy_tile_async<HD, kPadded>(g_tile, grad + batch * strides.g_batch + head_offset, strides.g_time, query_start, time,
                             columns);
  load_keys(0, 0);  // q and g join the first group
  const int key_tiles = tiles::key_tiles_needed(tiles::last_valid_key(bias_row, time, scratch), time);
  const int steps = 2 * key_tiles;  // pass 1, then pass 2, over the same tiles

  uint32_t q_fragments[kHold ? tiles::Head<HD>::kFragments : 1][4];
  uint32_t g_fragments[kHold ? tiles::Head<HD>::kFragments : 1][4];
  float row_max[2] = {-INFINITY, -INFINITY};  // rows `row`, row + 8
  float row_sum[2] = {0.0f, 0.0f};            // this lane's columns until pass 1 ends
  float row_dot[2] = {0.0f, 0.0f};
  float inverse_total[2];
  float dq[tiles::Head<HD>::kAccumulators][4];
  zero(dq);

  for (int step = 0; step < steps; ++step) {
    const int tile = step < key_tiles ? step : step - key_tiles;
    const int buffer = step & 1;
    if (step + 1 < steps) {
      load_keys(step + 1 < key_tiles ? step + 1 : step + 1 - key_tiles, buffer ^ 1);
      tiles::wait_copies<1>();
    } else {
      tiles::wait_copies<0>();
    }
    __syncthreads();
    if constexpr (kHold) {
      if (step == 0) {
        tiles::load_a_fragments<HD>(q_fragments, q_tile, 16 * warp, lane);
        tiles::load_a_fragments<HD>(g_fragments, g_tile, 16 * warp, lane);
      }
    }
    const bf16* k_tile = k_tiles + buffer * kTileElements;
    const bf16* v_tile = v_tiles + buffer * kTileElements;
    const float* bias_tile = bias_tiles[buffer];
    const int key_start = tile * kBlock;

    // s = (q.k^T) * score_scale and dp = mscale o (g.v^T).
    float scores[8][4], d_probs[8][4];
    zero(scores);
    zero(d_probs);
    if constexpr (kHold) {
      tiles::product_rows<HD>(scores, q_fragments, k_tile, lane);
      tiles::product_rows<HD>(d_probs, g_fragments, v_tile, lane);
    } else {
      tiles::product_rows_from_tile<HD>(scores, q_tile, 16 * warp, k_tile, lane);
      tiles::product_rows_from_tile<HD>(d_probs, g_tile, 16 * warp, v_tile, lane);
    }
    uint32_t kept = 0u;
    if (dropout.enabled) {
      // Each thread reads back only what it wrote itself: no barrier needed.
      if (step >= key_tiles && tile < kCachedMaskTiles) {
        kept = cached_keep_bits[tile][threadIdx.x];
      } else {
        kept = philox::query_tile_keep_bits(dropout.seed0, dropout.seed1, dropout.threshold, batch_head, row,
                                            key_start, lane);
        if (step < key_tiles && tile < kCachedMaskTiles) cached_keep_bits[tile][threadIdx.x] = kept;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        scores[j][e] *= score_scale;
        d_probs[j][e] *= mask_scale(dropout, kept, 4 * j + e);
      }

    if (step < key_tiles) {
      // Pass 1: peak, total and <dp, e> online, with e = exp2((s - peak) + bias).
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tile_max[e >> 1] = fmaxf(tile_max[e >> 1], scores[j][e] + bias_tile[8 * j + 2 * column + (e & 1)]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
        tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
        const float new_max = fmaxf(row_max[r], tile_max[r]);
        const float rescale = exp2f(row_max[r] - new_max);
        row_max[r] = new_max;
        row_sum[r] *= rescale;
        row_dot[r] *= rescale;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float weight = exp2f((scores[j][e] - row_max[e >> 1]) + bias_tile[8 * j + 2 * column + (e & 1)]);
          row_sum[e >> 1] += weight;
          row_dot[e >> 1] = fmaf(weight, d_probs[j][e], row_dot[e >> 1]);
        }
      if (step == key_tiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
          row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
          row_dot[r] += __shfl_xor_sync(0xffffffffu, row_dot[r], 1);
          row_dot[r] += __shfl_xor_sync(0xffffffffu, row_dot[r], 2);
          row_sum[r] = fmaxf(row_sum[r], kTinyTotal);
          row_dot[r] = row_dot[r] / row_sum[r];
          inverse_total[r] = 1.0f / row_sum[r];
        }
      }
    } else {
      // Pass 2: ds = p o (dp - <dp, p>), rounded to bf16 as the TPU kernel
      // rounds it, and dq += ds k.
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float prob =
              exp2f((scores[j][e] - row_max[r]) + bias_tile[8 * j + 2 * column + (e & 1)]) * inverse_total[r];
          scores[j][e] = prob * (d_probs[j][e] - row_dot[r]);
        }
      uint32_t ds_fragments[4][4];
      tiles::pack_a_fragments(ds_fragments, scores);
      tiles::product_columns<HD>(dq, ds_fragments, k_tile, lane);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  store_rows(d_query + batch * strides.dq_batch + head_offset, strides.dq_time, row, time, columns, dq, sm_scale,
             lane);
  if (column == 0) {
    const long long plane = static_cast<long long>(batch_size) * heads * time;
    float* stats_row = stats + static_cast<long long>(batch_head) * time;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row + 8 * r;
      if (t >= time) continue;
      stats_row[t] = row_max[r];
      stats_row[plane + t] = row_sum[r];
      stats_row[2 * plane + t] = row_dot[r];
    }
  }
}

// Kernel (b), bf16: dk and dv of one 64-key tile over every query tile.
template <int HD, bool kPadded>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 1 : 2)
attention_backward_key_mma_kernel(const bf16* __restrict__ query, const bf16* __restrict__ key,
                                  const bf16* __restrict__ value, const bf16* __restrict__ grad,
                                  const float* __restrict__ key_bias, const float* __restrict__ stats,
                                  bf16* __restrict__ d_key, bf16* __restrict__ d_value, int batch_size, int time,
                                  int heads, int head_columns, Strides strides, float score_scale, float bias_scale,
                                  float sm_scale, Dropout dropout) {
  // The head's own width: the constant HD unless it runs padded.
  const int columns = kPadded ? head_columns : HD;
  constexpr int kTileElements = tiles::Head<HD>::kTileElements;
  constexpr int kAccumulators = tiles::Head<HD>::kAccumulators;
  constexpr bool kHold = kHoldFragments<HD>;
  // Wide heads keep fewer registers live beside dk and dv (HD / 2 a lane
  // each): above 80 columns each query tile is taken in two parts of 32
  // queries, one after the other, and above 96 the block sweeps the query
  // tiles twice, first for dv and then for dk, so that the two accumulators
  // are never live together. No spill at 96 or 128.
  constexpr int kParts = HD > 80 ? 2 : 1;
  constexpr int kSweeps = HD > 96 ? 2 : 1;
  constexpr int kQueryTiles = 8 / kParts;  // n8 tiles of queries in a part
  extern __shared__ __align__(16) unsigned char shared_raw[];
  bf16* k_tile = reinterpret_cast<bf16*>(shared_raw);  // [64 keys][HD + 8]
  bf16* v_tile = k_tile + kTileElements;                // [64 keys][HD + 8]
  bf16* q_tiles = v_tile + kTileElements;               // 2 x [64 queries][HD + 8]
  bf16* g_tiles = q_tiles + 2 * kTileElements;          // 2 x [64 queries][HD + 8]
  __shared__ float stat_tiles[2][3][kBlock];            // peak, 1 / total, <dp, p> per query
  __shared__ int scratch[kThreads / 32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int column = lane & 3;
  const int key_start = blockIdx.x * kBlock;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int batch_head = batch * heads + head;
  const int head_offset = head * columns;
  const int warp_key_start = key_start + 16 * warp;
  const int row = warp_key_start + (lane >> 2);  // this lane's keys: row, row + 8
  const long long plane = static_cast<long long>(batch_size) * heads * time;
  const float* stats_row = stats + static_cast<long long>(batch_head) * time;
  const float* bias_row = key_bias + static_cast<long long>(batch) * time;
  bf16* dk_base = d_key + batch * strides.dk_batch + head_offset;
  bf16* dv_base = d_value + batch * strides.dv_batch + head_offset;

  const int last_valid = tiles::last_valid_key(bias_row, time, scratch);
  if (last_valid >= 0 && key_start > last_valid) {
    // Every key of the tile is padding behind a valid key: p = 0 exactly, so
    // dk = dv = 0.
    constexpr int kChunks = tiles::Head<HD>::kChunks;
    for (int chunk = threadIdx.x; chunk < kBlock * kChunks; chunk += kThreads) {
      const int t = key_start + chunk / kChunks;
      const int offset = (chunk % kChunks) * 8;
      if (t >= time || offset >= columns) continue;
      *reinterpret_cast<uint4*>(dk_base + t * strides.dk_time + offset) = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(dv_base + t * strides.dv_time + offset) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const bf16* q_base = query + batch * strides.q_batch + head_offset;
  const bf16* g_base = grad + batch * strides.g_batch + head_offset;
  auto load_queries = [&](int tile, int buffer) {
    const int query_start = tile * kBlock;
    tiles::copy_tile_async<HD, kPadded>(q_tiles + buffer * kTileElements, q_base, strides.q_time, query_start, time, columns);
    tiles::copy_tile_async<HD, kPadded>(g_tiles + buffer * kTileElements, g_base, strides.g_time, query_start, time, columns);
    tiles::commit_copies();
    for (int index = threadIdx.x; index < kBlock; index += kThreads) {
      const int t = query_start + index;
      const bool inside = t < time;
      // A query past the sequence gets p = 0: exp2(s - inf) = 0.
      stat_tiles[buffer][0][index] = inside ? stats_row[t] : INFINITY;
      stat_tiles[buffer][1][index] = inside ? 1.0f / stats_row[plane + t] : 1.0f;
      stat_tiles[buffer][2][index] = inside ? stats_row[2 * plane + t] : 0.0f;
    }
  };

  tiles::copy_tile_async<HD, kPadded>(k_tile, key + batch * strides.k_batch + head_offset, strides.k_time, key_start, time,
                             columns);
  tiles::copy_tile_async<HD, kPadded>(v_tile, value + batch * strides.v_batch + head_offset, strides.v_time, key_start, time,
                             columns);
  float key_bias_scaled[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row + 8 * r;
    key_bias_scaled[r] = t < time ? bias_row[t] * bias_scale : -INFINITY;
  }
  const int query_tiles = (time + kBlock - 1) / kBlock;

  uint32_t k_fragments[kHold ? tiles::Head<HD>::kFragments : 1][4];
  uint32_t v_fragments[kHold ? tiles::Head<HD>::kFragments : 1][4];
  float dk[kAccumulators][4], dv[kAccumulators][4];
  zero(dk);
  zero(dv);

#pragma unroll
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    const bool with_dv = kSweeps == 1 || sweep == 0;
    const bool with_dk = kSweeps == 1 || sweep == 1;
    if (sweep > 0) __syncthreads();  // the last sweep's readers are done with buffer 0
    load_queries(0, 0);               // k and v join the first sweep's first group
    for (int tile = 0; tile < query_tiles; ++tile) {
      const int buffer = tile & 1;
      if (tile + 1 < query_tiles) {
        load_queries(tile + 1, buffer ^ 1);
        tiles::wait_copies<1>();
      } else {
        tiles::wait_copies<0>();
      }
      __syncthreads();
      if constexpr (kHold) {
        if (tile == 0) {
          tiles::load_a_fragments<HD>(k_fragments, k_tile, 16 * warp, lane);
          tiles::load_a_fragments<HD>(v_fragments, v_tile, 16 * warp, lane);
        }
      }
      const bf16* q_tile = q_tiles + buffer * kTileElements;
      const bf16* g_tile = g_tiles + buffer * kTileElements;
      const float* peak = stat_tiles[buffer][0];
      const float* inverse_total = stat_tiles[buffer][1];
      const float* dot = stat_tiles[buffer][2];

      uint32_t kept = 0u;
      // One part of the tile's queries: rows kBlock / kParts * part onwards.
      auto take_part = [&](int part) {
        const int first_query = kBlock / kParts * part;
        const bf16* q_rows = q_tile + first_query * tiles::Head<HD>::kStride;
        const bf16* g_rows = g_tile + first_query * tiles::Head<HD>::kStride;

        // s^T = k.q^T (keys x queries), p, and dv += (mscale o p)^T g.
        float probs[kQueryTiles][4];
        zero(probs);
        if constexpr (kHold)
          tiles::product_rows<HD>(probs, k_fragments, q_rows, lane);
        else
          tiles::product_rows_from_tile<HD>(probs, k_tile, 16 * warp, q_rows, lane);
        if (part == 0)
          kept = dropout.enabled ? key_tile_keep_bits(dropout, batch_head, warp_key_start, tile * kBlock, lane) : 0u;
        float weighted[kQueryTiles][4];
#pragma unroll
        for (int j = 0; j < kQueryTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = first_query + 8 * j + 2 * column + (e & 1);
            const int bit = 4 * (kQueryTiles * part + j) + e;
            probs[j][e] = exp2f((probs[j][e] * score_scale - peak[q]) + key_bias_scaled[e >> 1]) * inverse_total[q];
            weighted[j][e] = probs[j][e] * mask_scale(dropout, kept, bit);
          }
        uint32_t fragments[kQueryTiles / 2][4];
        if (with_dv) {
          tiles::pack_a_fragments(fragments, weighted);
          tiles::product_columns<HD>(dv, fragments, g_rows, lane);
        }
        if (!with_dk) return;

        // dp^T = mscale o (v.g^T), ds^T = p o (dp^T - <dp, p>), and dk += ds^T q.
        float d_probs[kQueryTiles][4];
        zero(d_probs);
        if constexpr (kHold)
          tiles::product_rows<HD>(d_probs, v_fragments, g_rows, lane);
        else
          tiles::product_rows_from_tile<HD>(d_probs, v_tile, 16 * warp, g_rows, lane);
#pragma unroll
        for (int j = 0; j < kQueryTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = first_query + 8 * j + 2 * column + (e & 1);
            const int bit = 4 * (kQueryTiles * part + j) + e;
            d_probs[j][e] = probs[j][e] * (d_probs[j][e] * mask_scale(dropout, kept, bit) - dot[q]);
          }
        tiles::pack_a_fragments(fragments, d_probs);
        tiles::product_columns<HD>(dk, fragments, q_rows, lane);
      };
      if constexpr (kParts == 1) {
        take_part(0);
      } else {
#pragma unroll 1
        for (int part = 0; part < kParts; ++part) take_part(part);
      }
      __syncthreads();  // every warp is done with this buffer before it is refilled
    }
    if (kSweeps == 2 && sweep == 0) store_rows(dv_base, strides.dv_time, row, time, columns, dv, 1.0f, lane);
  }

  store_rows(dk_base, strides.dk_time, row, time, columns, dk, sm_scale, lane);
  if (kSweeps == 1) store_rows(dv_base, strides.dv_time, row, time, columns, dv, 1.0f, lane);
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

int launch_f32(const void* query, const void* key, const void* value, const void* grad, const float* key_bias,
               void* d_query, void* d_key, void* d_value, float* stats, int batch, int time, int heads, int head_dim,
               const Strides& strides, float score_scale, float bias_scale, float sm_scale, const Dropout& dropout,
               cudaStream_t stream) {
  return tiles::with_head_width(head_dim, [&](auto width, auto padded) {
    constexpr int HD = decltype(width)::value;
    constexpr bool kPadded = decltype(padded)::value;
    constexpr size_t query_bytes = query_shared_bytes<HD>();
    constexpr size_t key_bytes = key_shared_bytes<HD>();
    cudaError_t status = allow_shared(attention_backward_query_kernel<HD, kPadded>, query_bytes);
    if (status != cudaSuccess) return static_cast<int>(status);
    status = allow_shared(attention_backward_key_kernel<HD, kPadded>, key_bytes);
    if (status != cudaSuccess) return static_cast<int>(status);
    const dim3 grid((time + kBlock - 1) / kBlock, heads, batch);
    const float* q = static_cast<const float*>(query);
    const float* k = static_cast<const float*>(key);
    const float* v = static_cast<const float*>(value);
    const float* g = static_cast<const float*>(grad);
    attention_backward_query_kernel<HD, kPadded><<<grid, kThreads, query_bytes, stream>>>(
        q, k, v, g, key_bias, static_cast<float*>(d_query), stats, batch, time, heads, head_dim, strides, score_scale,
        bias_scale, sm_scale, dropout);
    status = cudaGetLastError();
    if (status != cudaSuccess) return static_cast<int>(status);
    attention_backward_key_kernel<HD, kPadded><<<grid, kThreads, key_bytes, stream>>>(
        q, k, v, g, key_bias, stats, static_cast<float*>(d_key), static_cast<float*>(d_value), batch, time, heads,
        head_dim, strides, score_scale, bias_scale, sm_scale, dropout);
    return static_cast<int>(cudaGetLastError());
  });
}

int launch_bf16(const void* query, const void* key, const void* value, const void* grad, const float* key_bias,
                void* d_query, void* d_key, void* d_value, float* stats, int batch, int time, int heads, int head_dim,
                const Strides& strides, float score_scale, float bias_scale, float sm_scale, const Dropout& dropout,
                cudaStream_t stream) {
  return tiles::with_head_width(head_dim, [&](auto width, auto padded) {
    constexpr int HD = decltype(width)::value;
    constexpr bool kPadded = decltype(padded)::value;
    constexpr size_t bytes = 6 * tiles::Head<HD>::kTileBytes;
    cudaError_t status = allow_shared(attention_backward_query_mma_kernel<HD, kPadded>, bytes);
    if (status != cudaSuccess) return static_cast<int>(status);
    status = allow_shared(attention_backward_key_mma_kernel<HD, kPadded>, bytes);
    if (status != cudaSuccess) return static_cast<int>(status);
    const dim3 grid((time + kBlock - 1) / kBlock, heads, batch);
    const bf16* q = static_cast<const bf16*>(query);
    const bf16* k = static_cast<const bf16*>(key);
    const bf16* v = static_cast<const bf16*>(value);
    const bf16* g = static_cast<const bf16*>(grad);
    attention_backward_query_mma_kernel<HD, kPadded><<<grid, kThreads, bytes, stream>>>(
        q, k, v, g, key_bias, static_cast<bf16*>(d_query), stats, batch, time, heads, head_dim, strides, score_scale,
        bias_scale, sm_scale, dropout);
    status = cudaGetLastError();
    if (status != cudaSuccess) return static_cast<int>(status);
    attention_backward_key_mma_kernel<HD, kPadded><<<grid, kThreads, bytes, stream>>>(
        q, k, v, g, key_bias, stats, static_cast<bf16*>(d_key), static_cast<bf16*>(d_value), batch, time, heads,
        head_dim, strides, score_scale, bias_scale, sm_scale, dropout);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// strides: q, k, v, g, dq, dk, dv batch and time strides in elements (14
// values); the head-dim axis must be contiguous, and for bf16 every head row
// must start on a 16-byte boundary (the wrapper checks both). head_dim: a
// multiple of 8 from 8 to 128 (tiles::with_head_width). stats: f32
// [3, B, H, T] scratch. use_dropout 0 computes the backward of plain
// attention (the seeds, threshold and inverse_keep are then unused). dtype:
// 0 = f32, 1 = bf16. Returns cudaGetLastError() after the two launches (0 on
// success).
extern "C" int attention_backward(const void* query, const void* key, const void* value, const void* grad,
                                  const float* key_bias, void* d_query, void* d_key, void* d_value,
                                  float* stats, int batch, int time, int heads, int head_dim,
                                  const long long* strides, float score_scale, float bias_scale,
                                  float sm_scale, uint32_t seed0, uint32_t seed1, uint32_t threshold,
                                  float inverse_keep, int use_dropout, int dtype, void* stream) {
  cudaStream_t cuda_stream = static_cast<cudaStream_t>(stream);
  const Strides packed{strides[0], strides[1], strides[2],  strides[3],  strides[4],  strides[5],  strides[6],
                       strides[7], strides[8], strides[9], strides[10], strides[11], strides[12], strides[13]};
  const Dropout dropout{seed0, seed1, threshold, inverse_keep, use_dropout};
  if (dtype == 0)
    return launch_f32(query, key, value, grad, key_bias, d_query, d_key, d_value, stats, batch, time, heads, head_dim,
                      packed, score_scale, bias_scale, sm_scale, dropout, cuda_stream);
  if (dtype == 1)
    return launch_bf16(query, key, value, grad, key_bias, d_query, d_key, d_value, stats, batch, time, heads,
                       head_dim, packed, score_scale, bias_scale, sm_scale, dropout, cuda_stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
