// One-shot attention forward (K1) for Hopper (sm_90a): exact softmax attention
// over the projection layout [B, T, H*hd], with padding expressed as an
// additive f32 key bias (0 valid / -1e9 padded).
//
// Replaces allophant_tpu/ops/oneshot_attention.py: _attention_kernel (plans
// "full" and "headblock") and _qblock_attention_kernel (plan "qblock"), and
// covers the range where allophant_tpu/ops/attention.py:fused_attention hands
// long sequences to JAX's library flash kernel: one kernel serves every T.
//
// Semantics kept from the TPU kernels:
//   * base-2 softmax: scores and bias are scaled by log2(e), exp becomes exp2;
//   * the peak is taken over the BIASED scores, and the exponent is evaluated
//     as (s - peak) + bias, so padded keys flush to exactly 0; keys past T
//     take a -inf bias;
//   * the denominator is clamped at 1e-30, so a zero-length batch row yields a
//     finite output (the uniform average of its values) instead of 0/0 = NaN;
//   * for bf16 inputs the q.k products are bf16 x bf16 (exact in f32) summed in
//     f32, and the unnormalised weights are rounded to bf16 before P.V, with
//     the division by the f32 total after P.V (as the "qblock" TPU kernel does).
//   For f32 inputs every product and sum is plain f32: no TF32.
//
// Design: the TPU kernels keep a whole [T, T] (or [Tq, T]) f32 score tile in
// 16+ MB of VMEM. A Hopper SM has at most 227 KB of shared memory, so one block
// handles one (batch, head, 64-query tile) and loops over 64-key tiles with an
// online peak and total (flash-style rescaling), whatever T is. q, k and v are
// read in place through their batch and time strides; no head transposes.
//
// bf16 (the "mixed" preset that serving runs): four warps, each owning 16
// query rows. The query tile's mma A fragments are loaded once into
// registers; the 64-key k and v tiles are bf16 in shared memory, filled by
// 16-byte cp.async into a double buffer, so that tile n + 1's copy overlaps
// tile n's products. S = Q.K^T and O += P.V run on the tensor cores
// (mma.sync.m16n8k16, fed by ldmatrix; v through ldmatrix.trans). The peak and
// total stay in registers (a row's four lanes reduce the peak with shuffles);
// the weights, rounded to bf16 against the running peak, are repacked from
// the S accumulators into P.V's A fragments in registers (attention_tiles.cuh).
// A block stops after the key tile of its batch row's last valid key: the
// keys after it carry a -1e9 bias, so their weights are exactly 0 in f32 once
// a valid key sets the peak; a zero-length row visits every tile.
//
// What bounds it on the H100: the work is 4 * T * valid keys * hd operations
// per (batch, head) against 4 * T * hd elements moved, and at the serving
// shape ([8, 511, 1024]) the bytes bound (0.010 ms) exceeds the bf16
// tensor-core bound; what this design pays beyond both is the exp2 and
// rescaling work per score on the CUDA cores, and mma.sync's instruction
// rate (wgmma with TMA is the next step).
//
// f32 keeps the first version's arithmetic on the CUDA cores (FFMA), so that
// the "float32" preset stays full f32: one thread owns 4 query rows and 8 key
// (then output) columns, tiles are f32 in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tiles.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr float kTinyTotal = 1e-30f;

// ---------------------------------------------------------------- f32, FFMA

constexpr int kRowsPerThread = 4;            // query rows per thread
constexpr int kColsPerThread = kBlockK / 8;  // key columns per thread in the score tile

template <int HD, bool kPadded>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 1 : 2)
oneshot_attention_kernel(const float* __restrict__ query, const float* __restrict__ key,
                         const float* __restrict__ value, const float* __restrict__ key_bias,
                         float* __restrict__ out, int time, int heads, int head_columns,
                         long long q_batch_stride, long long q_time_stride,
                         long long k_batch_stride, long long k_time_stride,
                         long long v_batch_stride, long long v_time_stride,
                         long long o_batch_stride, long long o_time_stride,
                         float score_scale, float bias_scale) {
  // The head's own width: the constant HD unless it runs padded.
  const int columns = kPadded ? head_columns : HD;
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
    __syncthreads();  // previous tile's readers are done with k/v/p
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
        p_tile[row * kPStride + col] = weight;
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
    const float inverse_total = 1.0f / fmaxf(row_sum[i], kTinyTotal);
#pragma unroll
    for (int j = 0; j < kOutCols; ++j)
      if (lane_col + 8 * j < columns) o_base[t * o_time_stride + lane_col + 8 * j] = acc[i][j] * inverse_total;
  }
}

template <int HD>
constexpr size_t shared_bytes() {
  return sizeof(float) *
         (kBlockQ * (HD + 1) + kBlockK * (HD + 1) + kBlockK * HD + kBlockQ * (kBlockK + 1) + kBlockK);
}

// ------------------------------------------------------- bf16, tensor cores

using bf16 = __nv_bfloat16;

template <int HD, bool kPadded>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 1 : 2)
oneshot_attention_mma_kernel(const bf16* __restrict__ query, const bf16* __restrict__ key,
                             const bf16* __restrict__ value, const float* __restrict__ key_bias,
                             bf16* __restrict__ out, int time, int head_columns, long long q_batch_stride,
                             long long q_time_stride, long long k_batch_stride, long long k_time_stride,
                             long long v_batch_stride, long long v_time_stride, long long o_batch_stride,
                             long long o_time_stride, float score_scale, float bias_scale) {
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
  float row_max[2] = {-INFINITY, -INFINITY};  // rows group, group + 8
  float row_sum[2] = {0.0f, 0.0f};            // this lane's columns only
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
        row_sum[e >> 1] += weight;
        scores[j][e] = weight;
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
    const int t = query_start + 16 * warp + group + 8 * r;
    if (t >= time) continue;
    const float inverse_total = 1.0f / fmaxf(row_sum[r], kTinyTotal);
#pragma unroll
    for (int j = 0; j < kAccumulators; ++j) {
      if (8 * j >= columns) break;  // columns past the head's own width
      const __nv_bfloat162 pair =
          __floats2bfloat162_rn(acc[j][2 * r] * inverse_total, acc[j][2 * r + 1] * inverse_total);
      *reinterpret_cast<__nv_bfloat162*>(o_base + t * o_time_stride + 8 * j + 2 * column) = pair;
    }
  }
}

int launch_f32(const void* query, const void* key, const void* value, const float* key_bias, void* out, int batch,
               int time, int heads, int head_dim, const long long* strides, float score_scale, float bias_scale,
               cudaStream_t stream) {
  return tiles::with_head_width(head_dim, [&](auto width, auto padded) {
    constexpr int HD = decltype(width)::value;
    constexpr bool kPadded = decltype(padded)::value;
    constexpr size_t bytes = shared_bytes<HD>();
    cudaError_t status = cudaFuncSetAttribute(oneshot_attention_kernel<HD, kPadded>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (status != cudaSuccess) return static_cast<int>(status);
    const dim3 grid((time + kBlockQ - 1) / kBlockQ, heads, batch);
    oneshot_attention_kernel<HD, kPadded><<<grid, kThreads, bytes, stream>>>(
        static_cast<const float*>(query), static_cast<const float*>(key), static_cast<const float*>(value),
        key_bias, static_cast<float*>(out), time, heads, head_dim, strides[0], strides[1], strides[2], strides[3],
        strides[4], strides[5], strides[6], strides[7], score_scale, bias_scale);
    return static_cast<int>(cudaGetLastError());
  });
}

int launch_bf16(const void* query, const void* key, const void* value, const float* key_bias, void* out, int batch,
                int time, int heads, int head_dim, const long long* strides, float score_scale, float bias_scale,
                cudaStream_t stream) {
  return tiles::with_head_width(head_dim, [&](auto width, auto padded) {
    constexpr int HD = decltype(width)::value;
    constexpr bool kPadded = decltype(padded)::value;
    constexpr size_t bytes = 5 * tiles::Head<HD>::kTileBytes;
    cudaError_t status = cudaFuncSetAttribute(oneshot_attention_mma_kernel<HD, kPadded>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (status != cudaSuccess) return static_cast<int>(status);
    const dim3 grid((time + kBlockQ - 1) / kBlockQ, heads, batch);
    oneshot_attention_mma_kernel<HD, kPadded><<<grid, kThreads, bytes, stream>>>(
        static_cast<const bf16*>(query), static_cast<const bf16*>(key), static_cast<const bf16*>(value), key_bias,
        static_cast<bf16*>(out), time, head_dim, strides[0], strides[1], strides[2], strides[3], strides[4],
        strides[5], strides[6], strides[7], score_scale, bias_scale);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// strides: q, k, v, out batch and time strides in elements, in that order
// (8 values); the head-dim axis must be contiguous, and for bf16 every head
// row must start on a 16-byte boundary (the wrapper checks both). head_dim:
// a multiple of 8 from 8 to 128 (tiles::with_head_width). dtype: 0 = f32,
// 1 = bf16. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int oneshot_attention_forward(const void* query, const void* key, const void* value,
                                         const float* key_bias, void* out, int batch, int time,
                                         int heads, int head_dim, const long long* strides,
                                         float score_scale, float bias_scale, int dtype,
                                         void* stream) {
  cudaStream_t cuda_stream = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(query, key, value, key_bias, out, batch, time, heads, head_dim, strides, score_scale,
                      bias_scale, cuda_stream);
  if (dtype == 1)
    return launch_bf16(query, key, value, key_bias, out, batch, time, heads, head_dim, strides, score_scale,
                       bias_scale, cuda_stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
