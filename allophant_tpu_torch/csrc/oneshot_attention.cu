// One-shot attention forward for Hopper (sm_90a): exact softmax attention over
// the projection layout [B, T, H*hd], with padding expressed as an additive f32
// key bias (0 valid / -1e9 padded).
//
// Replaces allophant_tpu/ops/oneshot_attention.py: _attention_kernel (plans
// "full" and "headblock") and _qblock_attention_kernel (plan "qblock"), and
// covers the range where allophant_tpu/ops/attention.py:fused_attention hands
// long sequences to JAX's library flash kernel: one kernel serves every T.
//
// Semantics kept from the TPU kernels:
//   * base-2 softmax: scores and bias are scaled by log2(e), exp becomes exp2;
//   * the peak is taken over the BIASED scores, and the exponent is evaluated
//     as (s - peak) + bias, so padded keys flush to exactly 0;
//   * the denominator is clamped at 1e-30, so a zero-length batch row yields a
//     finite output (the uniform average of its values) instead of 0/0 = NaN;
//   * for bf16 inputs the q.k products are bf16 x bf16 (exact in f32) summed in
//     f32, and the unnormalised weights are rounded to bf16 before P.V, with
//     the division by the f32 total after P.V (as the "qblock" TPU kernel does).
//   For f32 inputs every product and sum is plain f32: no TF32.
//
// What bounds it on the H100: at the flagship shapes (hd = 64, T <= a few
// thousand frames) the score work is 4*T^2*hd operations per (batch, head)
// against 4*T*hd elements moved, so the kernel is bound by arithmetic, not
// bytes. This first version runs that arithmetic on the CUDA cores (FFMA) for
// both dtypes, which caps it at the f32 vector rate (67 TFLOP/s) rather than the
// bf16 tensor-core rate (989 TFLOP/s): moving P.V and Q.K^T onto wgmma is left
// to a later change.
//
// Design: the TPU kernels keep a whole [T, T] (or [Tq, T]) f32 score tile in
// 16+ MB of VMEM. A Hopper SM has at most 227 KB of shared memory, so one block
// handles one (batch, head, 64-query tile) and loops over 64-key tiles with an
// online max and sum (flash-style rescaling): shared memory stays at ~66 KB for
// hd = 64 whatever T is, which removes the TPU's plan table and its T ceiling.
// q, k and v are read in place through their batch and time strides; no head
// transposes are made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;            // 16 row groups x 8 column lanes
constexpr int kRowsPerThread = 4;        // query rows per thread
constexpr int kColsPerThread = kBlockK / 8;  // key columns per thread in the score tile
constexpr float kTinyTotal = 1e-30f;

__device__ __forceinline__ float load_as_float(const float* pointer) { return *pointer; }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* pointer) {
  return __bfloat162float(*pointer);
}
__device__ __forceinline__ void store_from_float(float* pointer, float value) { *pointer = value; }
__device__ __forceinline__ void store_from_float(__nv_bfloat16* pointer, float value) {
  *pointer = __float2bfloat16(value);
}
// Rounds an f32 weight to the value dtype before P.V (identity for f32).
__device__ __forceinline__ float round_to(float value, const float*) { return value; }
__device__ __forceinline__ float round_to(float value, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(value));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
oneshot_attention_kernel(const T* __restrict__ query, const T* __restrict__ key,
                         const T* __restrict__ value, const float* __restrict__ key_bias,
                         T* __restrict__ out, int time, int heads,
                         long long q_batch_stride, long long q_time_stride,
                         long long k_batch_stride, long long k_time_stride,
                         long long v_batch_stride, long long v_time_stride,
                         long long o_batch_stride, long long o_time_stride,
                         float score_scale, float bias_scale) {
  static_assert(HD % 8 == 0, "head_dim must be a multiple of 8");
  constexpr int kOutCols = HD / 8;  // output columns per thread
  constexpr int kQkStride = HD + 1;  // +1 float: conflict-free column reads
  constexpr int kPStride = kBlockK + 1;

  extern __shared__ float shared[];
  float* q_tile = shared;                              // [kBlockQ][HD + 1]
  float* k_tile = q_tile + kBlockQ * kQkStride;        // [kBlockK][HD + 1]
  float* v_tile = k_tile + kBlockK * kQkStride;        // [kBlockK][HD]
  float* p_tile = v_tile + kBlockK * HD;               // [kBlockQ][kBlockK + 1]
  float* bias_tile = p_tile + kBlockQ * kPStride;      // [kBlockK]

  const int tid = threadIdx.x;
  const int lane_col = tid & 7;   // column lane within a row group of 8 threads
  const int row_group = tid >> 3;  // 0..15
  const int query_start = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int batch = blockIdx.z;
  const int head_offset = head * HD;

  const T* q_base = query + batch * q_batch_stride + head_offset;
  const T* k_base = key + batch * k_batch_stride + head_offset;
  const T* v_base = value + batch * v_batch_stride + head_offset;
  const float* bias_base = key_bias + static_cast<long long>(batch) * time;

  for (int index = tid; index < kBlockQ * HD; index += kThreads) {
    const int row = index / HD;
    const int col = index % HD;
    const int t = query_start + row;
    q_tile[row * kQkStride + col] =
        t < time ? load_as_float(q_base + t * q_time_stride + col) : 0.0f;
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
    __syncthreads();  // previous tile's readers are done with k/v/p
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
      // Keys past the end of the sequence are not keys at all: -inf keeps them
      // out of the peak and gives them an exact 0 weight.
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
      for (int j = 0; j < kColsPerThread; ++j) b[j] = k_tile[(lane_col + 8 * j) * kQkStride + d];
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
        tile_max = fmaxf(tile_max, scores[i][j] + bias_tile[lane_col + 8 * j]);
      }
#pragma unroll
      for (int offset = 1; offset < 8; offset <<= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, offset));
      const float new_max = fmaxf(row_max[i], tile_max);
      // row_max starts at -inf; the first tile always holds a key inside the
      // sequence, so new_max is finite and the rescale factor is exp2(-inf) = 0.
      const float rescale = exp2f(row_max[i] - new_max);
      row_max[i] = new_max;
      float tile_sum = 0.0f;
      const int row = row_group * kRowsPerThread + i;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int col = lane_col + 8 * j;
        const float weight = exp2f((scores[i][j] - new_max) + bias_tile[col]);
        tile_sum += weight;
        p_tile[row * kPStride + col] = round_to(weight, query);
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
    const float inverse_total = 1.0f / fmaxf(row_sum[i], kTinyTotal);
#pragma unroll
    for (int j = 0; j < kOutCols; ++j)
      store_from_float(o_base + t * o_time_stride + lane_col + 8 * j, acc[i][j] * inverse_total);
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
           float bias_scale, cudaStream_t stream) {
  constexpr size_t bytes = shared_bytes<HD>();
  cudaError_t status = cudaFuncSetAttribute(oneshot_attention_kernel<T, HD>,
                                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            static_cast<int>(bytes));
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid((time + kBlockQ - 1) / kBlockQ, heads, batch);
  oneshot_attention_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(query), static_cast<const T*>(key), static_cast<const T*>(value),
      key_bias, static_cast<T*>(out), time, heads, strides[0], strides[1], strides[2], strides[3],
      strides[4], strides[5], strides[6], strides[7], score_scale, bias_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: q, k, v, out batch and time strides in elements, in that order
// (8 values); the head-dim axis must be contiguous. dtype: 0 = f32, 1 = bf16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int oneshot_attention_forward(const void* query, const void* key, const void* value,
                                         const float* key_bias, void* out, int batch, int time,
                                         int heads, int head_dim, const long long* strides,
                                         float score_scale, float bias_scale, int dtype,
                                         void* stream) {
  cudaStream_t cuda_stream = static_cast<cudaStream_t>(stream);
  // Every released wav2vec2 / XLS-R encoder has 64-wide heads.
  if (head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float, 64>(query, key, value, key_bias, out, batch, time, heads, strides,
                             score_scale, bias_scale, cuda_stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, 64>(query, key, value, key_bias, out, batch, time, heads, strides,
                                     score_scale, bias_scale, cuda_stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
