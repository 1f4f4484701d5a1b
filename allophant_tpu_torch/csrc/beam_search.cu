// The whole lexicon-free CTC prefix beam search in one launch for Hopper
// (sm_90a), plus the backtrace of its backpointers in a second small kernel.
//
// Replaces allophant_tpu/ops/beam_kernel.py: _beam_kernel (launched by
// beam_search_padded_pallas). The backtrace kernel replaces the reverse
// lax.scan of allophant_tpu/ops/decode.py: backtrace_beams_device.
//
// Semantics are those of beam_search_padded, float for float: the same
// sort-free pairwise merge by two 32-bit rolling hashes (h * P + c + 1,
// wrapping), the same flashlight-style representative backpointers (a merged
// pair keeps the backpointer of its best pre-merge candidate; ties go to the
// extension), the same top-K order (value descending, ties to the lowest
// k-major lane k * C + c), -1e30 as the dead-slot score and the same freeze
// past each row's length. log-add is written exactly as PyTorch's CUDA
// logaddexp computes it (max + log1pf(expf(-|a - b|))), and the file is built
// without fast math, so the kernel and the plain version on the card give the
// same floats.
//
// What bounds it on the H100: by bytes and operations the work is tiny (the
// [B, T, C] f32 emissions read once, two [T, B, K] int32 grids written once,
// a few dozen flops per candidate). What really holds it back is the serial
// chain: T steps, each a chain of K block-wide argmax rounds, so a launch
// takes T times the latency of one step whatever B is (rows run in parallel,
// one block each). The design keeps that chain short and on chip:
// - one block per batch row; the beam state (two hashes, last token, blank
//   and non-blank log-probs for each of K <= 16 slots) lives in shared memory;
// - the next step's emission row is copied into a shared-memory double
//   buffer with cp.async while the current step computes, so no global load
//   sits on the chain (rows wider than kStagedClassLimit read global memory);
// - merges are found in O(K^2) per step, not O(K^2 C): for each pair (k, k2)
//   the only class c whose extension of beam k can carry beam k2's first hash
//   is c = h1[k2] - h1[k] * P1 - 1 (mod 2^32), so one subtraction finds it
//   and the second hash confirms it;
// - each thread keeps a sorted top-KCAP list of its own candidates while it
//   scores them, so a selection round is one warp-shuffle argmax and one
//   barrier, not a rescan of the K * C candidates; only the K winners have
//   their fields recomputed.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;     // _NEG_INF: the score of an empty slot
constexpr float kDeadBelow = -5e29f;  // _NEG_INF / 2: a slot at or below it is dead
constexpr uint32_t kHashP1 = 1000003u;
constexpr uint32_t kHashP2 = 31337u;
constexpr int kMaxBeams = 16;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
// Rows up to this many classes are double-buffered in shared memory (2 * 64 KB).
constexpr int kStagedClassLimit = 16384;
constexpr int kNoLane = 0x7fffffff;

__device__ __forceinline__ float log_add(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// Candidate order: higher value first, then the lower lane.
__device__ __forceinline__ bool precedes(float value, int lane, float other_value, int other_lane) {
  return value > other_value || (value == other_value && lane < other_lane);
}

struct BeamState {
  uint32_t h1[kMaxBeams];
  uint32_t h2[kMaxBeams];
  int last[kMaxBeams];
  float logp_b[kMaxBeams];
  float logp_nb[kMaxBeams];
};

// Per-step quantities shared by every candidate of a row.
struct StepShared {
  float total[kMaxBeams];
  float stay_b[kMaxBeams];
  float stay_nb[kMaxBeams];
  float stay_total[kMaxBeams];
  int match_class[kMaxBeams * kMaxBeams];  // [k][k2]: class c extending k onto k2, or -1
};

struct Candidate {
  float logp_b, logp_nb, total;
  uint32_t h1, h2;
  bool ext_is_rep;
  int matched_slot;
};

// Candidate (k, c): c == blank is beam k's "stay"; any other c extends
// beam k's prefix by c, merged with the stay it lands on, if any.
__device__ __forceinline__ Candidate candidate(int k, int c, int beams, int blank, const BeamState& state,
                                               const StepShared& step, const float* emissions) {
  Candidate out;
  out.ext_is_rep = true;
  out.matched_slot = 0;
  if (c == blank) {
    bool consumed = false;
    for (int other = 0; other < beams; ++other) consumed |= step.match_class[other * kMaxBeams + k] >= 0;
    out.logp_b = consumed ? kNegInf : step.stay_b[k];
    out.logp_nb = consumed ? kNegInf : step.stay_nb[k];
    out.h1 = state.h1[k];
    out.h2 = state.h2[k];
  } else {
    const float source = c == state.last[k] ? state.logp_b[k] : step.total[k];
    const float ext_nb = source + emissions[c];
    int matched = -1;
    for (int k2 = 0; k2 < beams; ++k2)
      if (step.match_class[k * kMaxBeams + k2] == c) matched = k2;
    if (matched >= 0) {
      out.logp_nb = log_add(ext_nb, step.stay_nb[matched]);
      out.logp_b = step.stay_b[matched];
      out.ext_is_rep = ext_nb >= step.stay_total[matched];
      out.matched_slot = matched;
    } else {
      out.logp_nb = ext_nb;
      out.logp_b = kNegInf;
    }
    out.h1 = state.h1[k] * kHashP1 + static_cast<uint32_t>(c + 1);
    out.h2 = state.h2[k] * kHashP2 + static_cast<uint32_t>(c + 1);
  }
  out.total = log_add(out.logp_b, out.logp_nb);
  return out;
}

// One block per batch row. KCAP >= beams is the length of each thread's
// sorted candidate list.
template <int KCAP>
__global__ void __launch_bounds__(kMaxThreads)
beam_search_kernel(const float* __restrict__ emissions, const int* __restrict__ lengths,
                   int* __restrict__ parents, int* __restrict__ emitted, float* __restrict__ scores,
                   int batch, int time, int classes, int beams, int blank, int staged) {
  __shared__ BeamState states[2];
  __shared__ StepShared step;
  __shared__ float round_value[2][kMaxWarps];
  __shared__ int round_lane[2][kMaxWarps];
  __shared__ float chosen_total[kMaxBeams];
  __shared__ int chosen_lane[kMaxBeams];
  extern __shared__ float staged_rows[];  // [2][classes] when staged

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int warp_lane = tid & 31;
  const int warps = blockDim.x >> 5;
  const int lanes = beams * classes;
  const int length = min(max(lengths[row], 0), time);
  const float* row_emissions = emissions + static_cast<long long>(row) * time * classes;

  if (tid < beams) {
    states[0].h1[tid] = 1u;
    states[0].h2[tid] = 1u;
    states[0].last[tid] = -1;
    states[0].logp_b[tid] = tid == 0 ? 0.0f : kNegInf;
    states[0].logp_nb[tid] = kNegInf;
  }
  if (staged && length > 0) {
    for (int c = tid; c < classes; c += blockDim.x) __pipeline_memcpy_async(staged_rows + c, row_emissions + c, 4);
  }
  __pipeline_commit();

  int current = 0;
  for (int t = 0; t < length; ++t) {
    const float* frame;
    if (staged) {
      __pipeline_wait_prior(0);
      __syncthreads();  // step t's row has landed; step t - 1 is finished
      frame = staged_rows + (t & 1) * classes;
      if (t + 1 < length) {
        float* next = staged_rows + ((t + 1) & 1) * classes;
        const float* source = row_emissions + static_cast<long long>(t + 1) * classes;
        for (int c = tid; c < classes; c += blockDim.x) __pipeline_memcpy_async(next + c, source + c, 4);
      }
      __pipeline_commit();
    } else {
      __syncthreads();
      frame = row_emissions + static_cast<long long>(t) * classes;
    }
    const BeamState& state = states[current];

    // Merge pairs: extension (k, c) lands on beam k2's prefix iff both of
    // its hashes equal k2's, between live beams, for a non-blank c.
    if (tid < beams * beams) {
      const int k = tid / beams;
      const int k2 = tid - k * beams;
      const bool alive_k = log_add(state.logp_b[k], state.logp_nb[k]) > kDeadBelow;
      const bool alive_k2 = log_add(state.logp_b[k2], state.logp_nb[k2]) > kDeadBelow;
      const uint32_t c = state.h1[k2] - state.h1[k] * kHashP1 - 1u;
      const bool match = alive_k && alive_k2 && c < static_cast<uint32_t>(classes) &&
                         static_cast<int>(c) != blank && state.h2[k] * kHashP2 + c + 1u == state.h2[k2];
      step.match_class[k * kMaxBeams + k2] = match ? static_cast<int>(c) : -1;
    }
    if (tid < beams) {
      const float total = log_add(state.logp_b[tid], state.logp_nb[tid]);
      const int last = state.last[tid];
      const float last_emission = last >= 0 ? frame[last] : kNegInf;
      const float stay_b = total + frame[blank];
      const float stay_nb = state.logp_nb[tid] + last_emission;
      step.total[tid] = total;
      step.stay_b[tid] = stay_b;
      step.stay_nb[tid] = stay_nb;
      step.stay_total[tid] = log_add(stay_b, stay_nb);
    }
    __syncthreads();

    // Score this thread's candidates into its sorted top-KCAP list.
    float best_value[KCAP];
    int best_lane[KCAP];
#pragma unroll
    for (int j = 0; j < KCAP; ++j) {
      best_value[j] = -INFINITY;
      best_lane[j] = kNoLane;
    }
    for (int lane = tid; lane < lanes; lane += blockDim.x) {
      const int k = lane / classes;
      float value = candidate(k, lane - k * classes, beams, blank, state, step, frame).total;
      int id = lane;
#pragma unroll
      for (int j = 0; j < KCAP; ++j) {
        if (precedes(value, id, best_value[j], best_lane[j])) {
          const float displaced_value = best_value[j];
          const int displaced_lane = best_lane[j];
          best_value[j] = value;
          best_lane[j] = id;
          value = displaced_value;
          id = displaced_lane;
        }
      }
    }

    // K rounds of block-wide argmax over the heads of the lists; the owner
    // of each winner pops it.
    for (int slot = 0; slot < beams; ++slot) {
      float value = best_value[0];
      int id = best_lane[0];
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) {
        const float other_value = __shfl_xor_sync(0xffffffffu, value, offset);
        const int other_lane = __shfl_xor_sync(0xffffffffu, id, offset);
        if (precedes(other_value, other_lane, value, id)) {
          value = other_value;
          id = other_lane;
        }
      }
      const int parity = slot & 1;
      if (warp_lane == 0) {
        round_value[parity][warp] = value;
        round_lane[parity][warp] = id;
      }
      __syncthreads();
      value = round_value[parity][0];
      id = round_lane[parity][0];
      for (int w = 1; w < warps; ++w) {
        if (precedes(round_value[parity][w], round_lane[parity][w], value, id)) {
          value = round_value[parity][w];
          id = round_lane[parity][w];
        }
      }
      if (tid == 0) {
        chosen_total[slot] = value;
        chosen_lane[slot] = id;
      }
      if (best_lane[0] == id) {
#pragma unroll
        for (int j = 0; j + 1 < KCAP; ++j) {
          best_value[j] = best_value[j + 1];
          best_lane[j] = best_lane[j + 1];
        }
        best_value[KCAP - 1] = -INFINITY;
        best_lane[KCAP - 1] = kNoLane;
      }
    }
    __syncthreads();

    // Slot s takes the s-th winner: its state, its backpointer and its token.
    if (tid < beams) {
      const int slot = tid;
      const int lane = chosen_lane[slot];
      const int parent = lane / classes;
      const int token = lane - parent * classes;
      const Candidate chosen = candidate(parent, token, beams, blank, state, step, frame);
      const bool is_stay = token == blank;
      const bool dead = chosen_total[slot] <= kDeadBelow;
      BeamState& next = states[current ^ 1];
      next.logp_b[slot] = dead ? kNegInf : chosen.logp_b;
      next.logp_nb[slot] = dead ? kNegInf : chosen.logp_nb;
      next.h1[slot] = chosen.h1;
      next.h2[slot] = chosen.h2;
      next.last[slot] = is_stay ? state.last[parent] : token;
      const long long out = (static_cast<long long>(t) * batch + row) * beams + slot;
      parents[out] = is_stay || chosen.ext_is_rep ? parent : chosen.matched_slot;
      emitted[out] = !is_stay && chosen.ext_is_rep ? token : -1;
    }
    current ^= 1;
  }
  __syncthreads();

  // Past its length a row keeps its beams: each slot is its own parent and
  // emits nothing.
  for (int index = tid; index < (time - length) * beams; index += blockDim.x) {
    const int t = length + index / beams;
    const int slot = index - (index / beams) * beams;
    const long long out = (static_cast<long long>(t) * batch + row) * beams + slot;
    parents[out] = slot;
    emitted[out] = -1;
  }
  if (tid < beams) scores[row * beams + tid] = log_add(states[current].logp_b[tid], states[current].logp_nb[tid]);
}

template <int KCAP>
int launch(const float* emissions, const int* lengths, int* parents, int* emitted, float* scores, int batch,
           int time, int classes, int beams, int blank, cudaStream_t stream) {
  const int staged = classes <= kStagedClassLimit;
  const size_t shared_bytes = staged ? 2 * sizeof(float) * static_cast<size_t>(classes) : 0;
  if (shared_bytes > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(
        beam_search_kernel<KCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared_bytes));
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  // Enough whole warps for the K * C candidates and the K * K merge pairs,
  // at most kMaxThreads; each thread then scores ceil(K * C / threads) lanes.
  const int wanted = max(beams * classes, beams * beams);
  const int threads = min(kMaxThreads, (wanted + 31) / 32 * 32);
  beam_search_kernel<KCAP><<<batch, threads, shared_bytes, stream>>>(
      emissions, lengths, parents, emitted, scores, batch, time, classes, beams, blank, staged);
  return static_cast<int>(cudaGetLastError());
}

// One thread per (row, beam): walks t from T - 1 down to 0 along the parent
// chain, writing the token each step contributed to that hypothesis.
__global__ void beam_backtrace_kernel(const int* __restrict__ parents, const int* __restrict__ emitted,
                                      const int* __restrict__ lengths, int* __restrict__ collected, int batch,
                                      int time, int beams) {
  const int index = blockIdx.x * blockDim.x + threadIdx.x;
  if (index >= batch * beams) return;
  const int row = index / beams;
  const int beam = index - row * beams;
  const int length = lengths[row];
  int cursor = beam;
  for (int t = time - 1; t >= 0; --t) {
    const long long base = (static_cast<long long>(t) * batch + row) * beams;
    int token = -1;
    if (t < length) {
      token = emitted[base + cursor];
      cursor = parents[base + cursor];
    }
    collected[base + beam] = token;
  }
}

}  // namespace

// emissions: [B, T, C] f32 contiguous log-probabilities; lengths: [B] int32;
// parents, emitted: [T, B, K] int32; scores: [B, K] f32. 1 <= K <= 16,
// 1 <= C <= 32767, 0 <= blank < C. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int beam_search_forward(const float* emissions, const int* lengths, int* parents, int* emitted,
                                   float* scores, int batch, int time, int classes, int beams, int blank,
                                   void* stream) {
  cudaStream_t cuda_stream = static_cast<cudaStream_t>(stream);
  if (beams < 1 || beams > kMaxBeams || classes < 1 || classes > 32767 || blank < 0 || blank >= classes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  if (beams <= 1) return launch<1>(emissions, lengths, parents, emitted, scores, batch, time, classes, beams, blank, cuda_stream);
  if (beams <= 2) return launch<2>(emissions, lengths, parents, emitted, scores, batch, time, classes, beams, blank, cuda_stream);
  if (beams <= 4) return launch<4>(emissions, lengths, parents, emitted, scores, batch, time, classes, beams, blank, cuda_stream);
  if (beams <= 8) return launch<8>(emissions, lengths, parents, emitted, scores, batch, time, classes, beams, blank, cuda_stream);
  return launch<16>(emissions, lengths, parents, emitted, scores, batch, time, classes, beams, blank, cuda_stream);
}

// parents, emitted, collected: [T, B, K] int32; lengths: [B] int32.
extern "C" int beam_backtrace_forward(const int* parents, const int* emitted, const int* lengths, int* collected,
                                      int batch, int time, int beams, void* stream) {
  cudaStream_t cuda_stream = static_cast<cudaStream_t>(stream);
  const int threads = 128;
  const int total = batch * beams;
  if (total == 0 || time == 0) return 0;
  beam_backtrace_kernel<<<(total + threads - 1) / threads, threads, 0, cuda_stream>>>(
      parents, emitted, lengths, collected, batch, time, beams);
  return static_cast<int>(cudaGetLastError());
}
