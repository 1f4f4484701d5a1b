// Fused first wav2vec2 feature-extractor layer for Hopper (sm_90a):
// conv(k=10, s=5, 1 -> C) + bias + LayerNorm over the C channels + exact GELU,
// in one pass over raw audio, writing [B, F, C] in the model dtype with
// F = S / 5 - 1 (VALID convolution; the caller drops the S % 5 tail).
//
// Replaces allophant_tpu/ops/frame_encoder.py: _kernel (launched by
// _pallas_frame_conv through fused_frame_conv).
//
// Semantics kept from the TPU kernel: the 10-tap dot takes f32 operands and
// accumulates in f32, the bias is added after the dot, the variance is the
// centred (two-pass) one, and the output is rounded once to the model dtype.
// The TPU kernel evaluates erf with the Abramowitz-Stegun polynomial and an
// approximate reciprocal (about 1e-3 error, since Pallas on the TPU has no erf);
// here GELU uses the exact erff, the function that kernel approximates.
//
// What bounds it on the H100: every output element costs 10 multiply-adds plus
// the normalisation and one erff, and is written once; the input is 1/(C/5) of
// the output's size. At C = 512 the bytes bound is the [B, F, 512] activation
// (the largest tensor of the encoder), but the issue rate of the CUDA cores
// comes first: erff has two polynomial branches, and a warp almost always
// holds inputs on both sides of its branch point, so it runs both, one after
// the other, as dependent chains; with them an element takes about 80 lane
// instructions in the frame loop's SASS (chip_smoke.py prints the count),
// against 128 lanes an SM a cycle, and enough warps must be resident to hide
// the chains. The design spends as few instructions as it can beside that
// arithmetic, at two blocks of 8 warps an SM:
// - a warp computes kFrames frames at once, so each weight it reads from
//   shared memory feeds kFrames multiply-adds; the weights lie in shared
//   memory in a lane-major order, so a warp's float4 reads of one tap are
//   contiguous (no bank conflict), and a lane's reads of a tap are CPL / 4
//   LDS.128 for 10 * CPL * kFrames FMAs;
// - a lane owns groups of 16 bytes of output channels (8 bf16 or 4 f32), so
//   every store is one 16-byte vector and a warp writes 512 contiguous bytes;
// - the bias and the LayerNorm scale and shift stay in registers, and the
//   blocks are persistent (one wave over the SMs, the weights staged once a
//   block), each warp striding over groups of kFrames frames;
// - the LayerNorm statistics are warp shuffles over the frame's channels.
// Any C from 1 to 1024 is taken: channels per lane (CPL) is a template
// parameter (8, 16, 24 or 32), and the channels past C hold zero weights,
// bias, scale and shift, take no part in the mean (their value is 0), are
// masked out of the centred sum of squares and are never stored; a C that is
// not a multiple of the vector width stores one element at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTaps = 10;
constexpr int kStride = 5;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChannelsPerLane = 32;  // C up to 1024
// Frames a warp computes together: each weight read from shared memory feeds
// this many multiply-adds. Two measured fastest (NVIDIA H100 80GB HBM3):
// four frames take 235 registers, one block of 8 warps an SM, too few warps
// to hide erff's dependent chains; two fit in 128 registers at 16 channels
// a lane, two blocks an SM.
constexpr int kFrames = 2;

__device__ __forceinline__ float warp_sum(float value) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) value += __shfl_xor_sync(0xffffffffu, value, offset);
  return value;
}

__device__ __forceinline__ void store_one(float* pointer, float value) { *pointer = value; }
__device__ __forceinline__ void store_one(__nv_bfloat16* pointer, float value) { *pointer = __float2bfloat16(value); }

// 16 bytes of output: 4 f32 or 8 bf16, rounded once.
__device__ __forceinline__ void store_vector(float* pointer, const float (&values)[4]) {
  *reinterpret_cast<float4*>(pointer) = make_float4(values[0], values[1], values[2], values[3]);
}
__device__ __forceinline__ void store_vector(__nv_bfloat16* pointer, const float (&values)[8]) {
  uint4 packed;
  uint32_t* words = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(values[2 * i], values[2 * i + 1]);
    words[i] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  *reinterpret_cast<uint4*>(pointer) = packed;
}

template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads, CPL <= 16 ? 2 : 1)
frame_encoder_kernel(const float* __restrict__ audio, const float* __restrict__ weight,
                     const float* __restrict__ bias, const float* __restrict__ ln_scale,
                     const float* __restrict__ ln_bias, T* __restrict__ out, int batch, int frames, int channels,
                     long long audio_batch_stride, float eps) {
  constexpr int kVector = 16 / static_cast<int>(sizeof(T));  // channels of one 16-byte store
  constexpr int kGroups = CPL / kVector;                      // a lane's channel groups
  constexpr int kQuads = kVector / 4;                         // float4 weights of a group and tap
  constexpr int kCapacity = 32 * CPL;
  constexpr int kSamples = kStride * (kFrames - 1) + kTaps;
  // [tap][group][quad][lane] float4: a warp's reads of one (tap, group, quad)
  // are 512 contiguous bytes.
  __shared__ float4 weight_tile[kTaps * kCapacity / 4];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // This lane's channel j = kVector * g + v is (32 * g + lane) * kVector + v.
  auto channel_of = [&](int g, int v) { return (32 * g + lane) * kVector + v; };

  float* weight_floats = reinterpret_cast<float*>(weight_tile);
  for (int index = threadIdx.x; index < kTaps * kCapacity; index += kThreads) {
    const int k = index / kCapacity;
    const int c = index - k * kCapacity;
    const int group = c / kVector, v = c - group * kVector;
    const int g = group / 32, owner = group - g * 32;
    weight_floats[(((k * kGroups + g) * kQuads + v / 4) * 32 + owner) * 4 + v % 4] =
        c < channels ? weight[k * channels + c] : 0.0f;
  }
  float channel_bias[CPL], scale[CPL], shift[CPL];
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int v = 0; v < kVector; ++v) {
      const int c = channel_of(g, v);
      const bool inside = c < channels;
      channel_bias[g * kVector + v] = inside ? bias[c] : 0.0f;
      scale[g * kVector + v] = inside ? ln_scale[c] : 0.0f;
      shift[g * kVector + v] = inside ? ln_bias[c] : 0.0f;
    }
  __syncthreads();

  const int groups_per_row = (frames + kFrames - 1) / kFrames;
  const long long frame_groups = static_cast<long long>(batch) * groups_per_row;
  const float inverse_channels = 1.0f / static_cast<float>(channels);
  const bool padded = channels < kCapacity;
  const bool vector_stores = channels % kVector == 0;
  const int last_sample = kStride * (frames - 1) + kTaps - 1;
  for (long long group = static_cast<long long>(blockIdx.x) * kWarps + warp; group < frame_groups;
       group += static_cast<long long>(gridDim.x) * kWarps) {
    const int row = static_cast<int>(group / groups_per_row);
    const int first = static_cast<int>(group - static_cast<long long>(row) * groups_per_row) * kFrames;
    const float* audio_row = audio + row * audio_batch_stride;
    // Frames past the row's last read its last samples and are not stored.
    float samples[kSamples];
#pragma unroll
    for (int j = 0; j < kSamples; ++j) samples[j] = __ldg(audio_row + min(kStride * first + j, last_sample));

    float hidden[kFrames][CPL];
#pragma unroll
    for (int i = 0; i < kFrames; ++i)
#pragma unroll
      for (int c = 0; c < CPL; ++c) hidden[i][c] = 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) {
      float w[CPL];
#pragma unroll
      for (int g = 0; g < kGroups; ++g)
#pragma unroll
        for (int q = 0; q < kQuads; ++q) {
          const float4 quad = weight_tile[((k * kGroups + g) * kQuads + q) * 32 + lane];
          w[g * kVector + 4 * q] = quad.x;
          w[g * kVector + 4 * q + 1] = quad.y;
          w[g * kVector + 4 * q + 2] = quad.z;
          w[g * kVector + 4 * q + 3] = quad.w;
        }
#pragma unroll
      for (int i = 0; i < kFrames; ++i)
#pragma unroll
        for (int c = 0; c < CPL; ++c) hidden[i][c] = fmaf(samples[kStride * i + k], w[c], hidden[i][c]);
    }

#pragma unroll
    for (int i = 0; i < kFrames; ++i) {
      float total = 0.0f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        hidden[i][c] += channel_bias[c];
        total += hidden[i][c];
      }
      const float mean = warp_sum(total) * inverse_channels;
      float squares = 0.0f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) hidden[i][c] -= mean;
      if (padded) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const float centred = channel_of(c / kVector, c % kVector) < channels ? hidden[i][c] : 0.0f;
          squares = fmaf(centred, centred, squares);
        }
      } else {
#pragma unroll
        for (int c = 0; c < CPL; ++c) squares = fmaf(hidden[i][c], hidden[i][c], squares);
      }
      const float variance = warp_sum(squares) * inverse_channels;
      const float inverse_std = rsqrtf(variance + eps);
      const int frame = first + i;
      if (frame >= frames) continue;  // uniform across the warp
      T* out_frame = out + (static_cast<long long>(row) * frames + frame) * channels;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        float values[kVector];
#pragma unroll
        for (int v = 0; v < kVector; ++v) {
          const float normalized = hidden[i][g * kVector + v] * inverse_std * scale[g * kVector + v] +
                                   shift[g * kVector + v];
          // 0.5 x (1 + erf(x / sqrt 2)) as one multiply-add on 0.5 x.
          const float half = 0.5f * normalized;
          values[v] = fmaf(half, erff(normalized * 0.70710678118654752f), half);
        }
        const int c0 = channel_of(g, 0);
        if (vector_stores) {
          if (c0 < channels) store_vector(out_frame + c0, values);
        } else {
#pragma unroll
          for (int v = 0; v < kVector; ++v)
            if (c0 + v < channels) store_one(out_frame + c0 + v, values[v]);
        }
      }
    }
  }
}

template <typename T, int CPL>
int launch(const float* audio, const float* weight, const float* bias, const float* ln_scale,
           const float* ln_bias, void* out, int batch, int frames, int channels, long long audio_batch_stride,
           float eps, cudaStream_t stream) {
  int device = 0, processors = 0, per_processor = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status == cudaSuccess) status = cudaDeviceGetAttribute(&processors, cudaDevAttrMultiProcessorCount, device);
  if (status == cudaSuccess)
    status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_processor, frame_encoder_kernel<T, CPL>, kThreads, 0);
  if (status != cudaSuccess) return static_cast<int>(status);
  const long long frame_groups = static_cast<long long>(batch) * ((frames + kFrames - 1) / kFrames);
  const long long wanted = (frame_groups + kWarps - 1) / kWarps;
  const int blocks = static_cast<int>(std::max(1LL, std::min<long long>(wanted, 1LL * processors * std::max(per_processor, 1))));
  frame_encoder_kernel<T, CPL><<<blocks, kThreads, 0, stream>>>(audio, weight, bias, ln_scale, ln_bias,
                                                                 static_cast<T*>(out), batch, frames, channels,
                                                                 audio_batch_stride, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_channels(const float* audio, const float* weight, const float* bias, const float* ln_scale,
                    const float* ln_bias, void* out, int batch, int frames, int channels,
                    long long audio_batch_stride, float eps, cudaStream_t stream) {
  if (channels <= 256)
    return launch<T, 8>(audio, weight, bias, ln_scale, ln_bias, out, batch, frames, channels, audio_batch_stride, eps,
                        stream);
  if (channels <= 512)
    return launch<T, 16>(audio, weight, bias, ln_scale, ln_bias, out, batch, frames, channels, audio_batch_stride,
                         eps, stream);
  if (channels <= 768)
    return launch<T, 24>(audio, weight, bias, ln_scale, ln_bias, out, batch, frames, channels, audio_batch_stride,
                         eps, stream);
  return launch<T, 32>(audio, weight, bias, ln_scale, ln_bias, out, batch, frames, channels, audio_batch_stride, eps,
                       stream);
}

}  // namespace

// audio: [B, S] f32 rows with the given batch stride (S >= 5 * (frames + 1));
// weight: [10, C] f32 contiguous; bias, ln_scale, ln_bias: [C] f32;
// out: [B, frames, C] contiguous and 16-byte aligned, dtype 0 = f32, 1 = bf16;
// 1 <= C <= 1024. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int frame_encoder_forward(const float* audio, const float* weight, const float* bias,
                                     const float* ln_scale, const float* ln_bias, void* out,
                                     int batch, int frames, int channels,
                                     long long audio_batch_stride, float eps, int dtype,
                                     void* stream) {
  cudaStream_t cuda_stream = static_cast<cudaStream_t>(stream);
  if (channels < 1 || channels > 32 * kMaxChannelsPerLane) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_channels<float>(audio, weight, bias, ln_scale, ln_bias, out, batch, frames, channels,
                                  audio_batch_stride, eps, cuda_stream);
  if (dtype == 1)
    return launch_channels<__nv_bfloat16>(audio, weight, bias, ln_scale, ln_bias, out, batch, frames, channels,
                                          audio_batch_stride, eps, cuda_stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
