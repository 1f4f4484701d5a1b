// Relative-key one-shot attention forward (K7) for Hopper (sm_90a): the
// self-attention of w2v-BERT 2.0's Conformer layers, over the projection
// layout [B, T, H*hd] with padding as an additive f32 key bias (0 valid /
// -1e9 padded), and a query-dependent term from a table of distance
// embeddings E [left + right + 1, hd]:
//
//   score(i, j) = (q_i . k_j + q_i . E[clamp(j - i, -left, right) + left]) * scale + bias_j
//
// It replaces no TPU kernel: the JAX package has no w2v-BERT. K1 takes only a
// [B, T] key bias, and as a bias the relative term is [B, H, T, T] (8 MB a row
// and layer at T = 500 in bf16, written and read back in each of 24 layers).
//
// Design: K1's block (oneshot_attention.cu), one (batch, head, 64-query tile)
// with an online peak and total over 64-key tiles, q, k and v read in place
// through their strides, S = Q.K^T and O += P.V on the tensor cores
// (mma.sync.m16n8k16) with the k and v tiles double-buffered by cp.async.
// Before the first key tile each warp multiplies its 16 query rows' A
// fragments by the distance table, held in shared memory as B rows padded to
// a multiple of 16, and stores the [16, left + right + 1] f32 products in a
// shared-memory region of its own. Each score then adds the product its
// distance picks (one shared-memory read, clamped index), before the scale.
// The arithmetic is K1's: base-2 softmax, the peak over the biased scores,
// the exponent as (s - peak) + bias, the unnormalised weights rounded to
// bf16 before P.V, the total clamped at 1e-30 and divided after P.V; a block
// stops after the key tile of its row's last valid key.
//
// What bounds it on the H100: K1's bytes (q, k, v and o once) and operations
// (4 * valid queries * valid keys * hd a head), plus 2 * (left + right + 1) *
// hd operations a query for the table, which at w2v-BERT's 73 distances is
// under a tenth of q.k at T = 224. Beyond the bound it pays K1's exp2 and
// rescaling on the CUDA cores, mma.sync's issue rate, and one shared-memory
// gather a score.
//
// bf16 only: the card runs no float32 route (the wrapper raises), head
// widths up to 128 (tiles::with_head_width), at most 256 distances. A launch
// makes no allocation and no synchronising call, so it can be captured in a
// CUDA graph (models/w2v_bert.py captures the layer stack).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr float kTinyTotal = 1e-30f;
constexpr int kMaxPositions = 256;
constexpr int kMaxDevices = 64;

using bf16 = __nv_bfloat16;

// Rows of the distance table in shared memory: the distances rounded up to
// the 16 rows of one pair of n8 product tiles, the extra rows zero.
__host__ __device__ constexpr int table_rows(int positions) { return (positions + 15) / 16 * 16; }

template <int HD>
size_t shared_bytes(int positions) {
  return 5 * tiles::Head<HD>::kTileBytes + static_cast<size_t>(table_rows(positions)) * tiles::Head<HD>::kStride * 2 +
         static_cast<size_t>(kBlockQ) * positions * sizeof(float);
}

template <int HD, bool kPadded>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 1 : 2)
relkey_attention_kernel(const bf16* __restrict__ query, const bf16* __restrict__ key, const bf16* __restrict__ value,
                        const float* __restrict__ key_bias, const bf16* __restrict__ table, bf16* __restrict__ out,
                        int time, int head_columns, int left, int right, long long q_batch_stride,
                        long long q_time_stride, long long k_batch_stride, long long k_time_stride,
                        long long v_batch_stride, long long v_time_stride, long long o_batch_stride,
                        long long o_time_stride, float score_scale, float bias_scale) {
  // The head's own width: the constant HD unless it runs padded.
  const int columns = kPadded ? head_columns : HD;
  const int positions = left + right + 1;
  const int rows = table_rows(positions);
  constexpr int kStride = tiles::Head<HD>::kStride;
  constexpr int kTileElements = tiles::Head<HD>::kTileElements;
  constexpr int kAccumulators = tiles::Head<HD>::kAccumulators;
  constexpr int kChunks = tiles::Head<HD>::kChunks;
  extern __shared__ __align__(16) unsigned char shared_bytes_raw[];
  bf16* q_tile = reinterpret_cast<bf16*>(shared_bytes_raw);  // [64][HD + 8]
  bf16* k_tiles = q_tile + kTileElements;                      // 2 x [64][HD + 8]
  bf16* v_tiles = k_tiles + 2 * kTileElements;                 // 2 x [64][HD + 8]
  bf16* e_tile = v_tiles + 2 * kTileElements;                  // [rows][HD + 8]
  float* relative = reinterpret_cast<float*>(e_tile + rows * kStride);  // [64][positions]
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
  // This warp's 16 rows of q . E^T.
  float* own_relative = relative + 16 * warp * positions;

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

  tiles::copy_tile_async<HD, kPadded>(q_tile, query + batch * q_batch_stride + head_offset, q_time_stride, query_start,
                                      time, columns);
  load_keys(0, 0);  // the query tile joins the first group
  // The distance table, 16 bytes a thread at a time (its rows are the
  // launched head width apart, a multiple of 8 columns), zero past its rows
  // and past the head's own columns.
  for (int chunk = threadIdx.x; chunk < rows * kChunks; chunk += kThreads) {
    const int row = chunk / kChunks;
    const int col = (chunk % kChunks) * 8;
    uint4 piece = make_uint4(0u, 0u, 0u, 0u);
    if (row < positions && col < columns)
      piece = *reinterpret_cast<const uint4*>(table + static_cast<long long>(row) * head_columns + col);
    *reinterpret_cast<uint4*>(e_tile + row * kStride + col) = piece;
  }
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
    if (tile == 0) {
      tiles::load_a_fragments<HD>(q_fragments, q_tile, 16 * warp, lane);
      for (int n0 = 0; n0 < rows; n0 += 16) {
        float products[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 4; ++e) products[half][e] = 0.0f;
#pragma unroll
        for (int k = 0; k < tiles::Head<HD>::kFragments; ++k) {
          uint32_t b[4];
          tiles::load_b_rows<HD>(b, e_tile, n0, 16 * k, lane);
          tiles::mma(products[0], q_fragments[k], b[0], b[1]);
          tiles::mma(products[1], q_fragments[k], b[2], b[3]);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int distance = n0 + 8 * half + 2 * column + (e & 1);
            if (distance < positions) own_relative[(group + 8 * (e >> 1)) * positions + distance] = products[half][e];
          }
      }
      __syncwarp();
    }
    const bf16* k_tile = k_tiles + buffer * kTileElements;
    const bf16* v_tile = v_tiles + buffer * kTileElements;
    const float* bias_tile = bias_tiles[buffer];
    const int key_start = tile * kBlockK;

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
        const int row = group + 8 * (e >> 1);
        const int key_index = key_start + 8 * j + 2 * column + (e & 1);
        const int distance = min(max(key_index - (query_start + 16 * warp + row), -left), right) + left;
        scores[j][e] = (scores[j][e] + own_relative[row * positions + distance]) * score_scale;
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

// Allows each instantiation the shared memory of the largest table it takes,
// once a device, so that a launch under CUDA graph capture makes no
// attribute call.
template <int HD, bool kPadded>
int allow_shared_bytes() {
  static bool allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status != cudaSuccess) return static_cast<int>(status);
  if (device < kMaxDevices && allowed[device]) return 0;
  status = cudaFuncSetAttribute(relkey_attention_kernel<HD, kPadded>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(shared_bytes<HD>(kMaxPositions)));
  if (status == cudaSuccess && device < kMaxDevices) allowed[device] = true;
  return static_cast<int>(status);
}

}  // namespace

// strides: q, k, v, out batch and time strides in elements, in that order
// (8 values); the head-dim axis must be contiguous and every head row must
// start on a 16-byte boundary (the wrapper checks both). head_dim: a positive
// multiple of 8 up to 128. table: bf16 [left + right + 1, head_dim],
// contiguous. Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a width or a table the kernel does not take.
extern "C" int relkey_attention_forward(const void* query, const void* key, const void* value, const float* key_bias,
                                        const void* table, void* out, int batch, int time, int heads, int head_dim,
                                        int left, int right, const long long* strides, float score_scale,
                                        float bias_scale, void* stream) {
  const int positions = left + right + 1;
  if (left < 0 || right < 0 || positions > kMaxPositions) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cuda_stream = static_cast<cudaStream_t>(stream);
  return tiles::with_head_width(head_dim, [&](auto width, auto padded) {
    constexpr int HD = decltype(width)::value;
    constexpr bool kPadded = decltype(padded)::value;
    const int status = allow_shared_bytes<HD, kPadded>();
    if (status != 0) return status;
    const size_t bytes = shared_bytes<HD>(positions);
    const dim3 grid((time + kBlockQ - 1) / kBlockQ, heads, batch);
    relkey_attention_kernel<HD, kPadded><<<grid, kThreads, bytes, cuda_stream>>>(
        static_cast<const bf16*>(query), static_cast<const bf16*>(key), static_cast<const bf16*>(value), key_bias,
        static_cast<const bf16*>(table), static_cast<bf16*>(out), time, head_dim, left, right, strides[0], strides[1],
        strides[2], strides[3], strides[4], strides[5], strides[6], strides[7], score_scale, bias_scale);
    return static_cast<int>(cudaGetLastError());
  }, [] { return static_cast<int>(cudaErrorInvalidValue); });
}
