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
// chain: T steps, each depending on the last, so a launch takes T times the
// latency of one step whatever B is (rows run in parallel). Two kernels keep
// that chain short; beam_search_forward picks one by shape alone (route()):
//
// The warp kernel, for K <= 8 beams and C <= 64 classes (every head of the
// flagship: K = 4 with C = 4 and C = 40), gives each batch row a block of one
// warp and has no barrier and no shared memory at all:
// - lane k holds slot k's state (two hashes, last token, blank and non-blank
//   log-probs, and their log-add, carried over from the candidate that
//   filled the slot) in registers; other lanes read it by __shfl_sync;
// - lane l holds the step's emissions of classes l and 32 + l, loaded one
//   step ahead with plain loads; any class's emission is one shuffle away;
// - each slot's lane computes its beam's "stay" and whether a merge consumes
//   it; every lane then evaluates its own candidates whole from those, with
//   no divergent phase and no branch: an unmerged extension needs no log-add
//   at all (see start_candidate), and the few merged ones take theirs in one
//   warp-uniform pass;
// - selection keeps the twin's order (value descending, ties to the lowest
//   k-major lane k * C + c). With K * C <= 32 each lane holds one candidate,
//   whose rank is the number of candidates that precede it (31 shuffles,
//   unique under that total order); ranks below K win and the rank is the
//   slot. With more, lane l holds class l of every beam and the candidates of
//   classes 32 and up are spread over the lanes; each lane sorts its keys (a
//   64-bit key orders value, then index) and five butterfly levels merge the
//   lanes' top-K lists, so every lane ends with the warp's top K;
// - a winner's candidate, already computed, moves to its slot's lane by
//   shuffle: nothing is recomputed.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py): 0.78 us a
// step at [288, 511, 4] and 1.5 us at [16, 511, 40], K = 4, against the
// block kernel's 3.0 and 3.4 us.
//
// The block kernel takes every wider row (the 2400-class inventory, up to
// 32,767 classes, K up to 16):
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
// The warp kernel's limits: a lane holds the emissions of two classes, and a
// slot's state sits on a lane of its own.
constexpr int kWarpMaxBeams = 8;
constexpr int kWarpMaxClasses = 64;
constexpr unsigned kAllLanes = 0xffffffffu;

// Without a branch, so that the compiler can interleave its long dependent
// chain with other work.
__device__ __forceinline__ float log_add(float a, float b) {
  const float sum = fmaxf(a, b) + log1pf(expf(-fabsf(a - b)));
  return isinf(a) && a == b ? a : sum;
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

// The emission of class c < 64 from a warp's row held as e0 = frame[lane],
// e1 = frame[32 + lane]. Every lane of the warp must call it.
__device__ __forceinline__ float class_emission(float e0, float e1, int c) {
  const float low = __shfl_sync(kAllLanes, e0, c & 31);
  const float high = __shfl_sync(kAllLanes, e1, c & 31);
  return c < 32 ? low : high;
}

// Every field of a candidate from lane `source`. Every lane must call it.
__device__ __forceinline__ Candidate shuffle_candidate(const Candidate& value, int source) {
  Candidate out;
  out.logp_b = __shfl_sync(kAllLanes, value.logp_b, source);
  out.logp_nb = __shfl_sync(kAllLanes, value.logp_nb, source);
  out.total = __shfl_sync(kAllLanes, value.total, source);
  out.h1 = __shfl_sync(kAllLanes, value.h1, source);
  out.h2 = __shfl_sync(kAllLanes, value.h2, source);
  out.ext_is_rep = __shfl_sync(kAllLanes, static_cast<int>(value.ext_is_rep), source) != 0;
  out.matched_slot = __shfl_sync(kAllLanes, value.matched_slot, source);
  return out;
}

// values[j] for a j < N known only at run time, by an unrolled select, so
// that the array stays in registers.
template <int N, typename T>
__device__ __forceinline__ T pick(const T (&values)[N], int j) {
  T out = values[0];
#pragma unroll
  for (int i = 1; i < N; ++i) out = i == j ? values[i] : out;
  return out;
}

// A key whose unsigned order is the candidate order: the value's bits mapped
// to an unsigned order (after -0 -> +0, so equal values give equal keys)
// above the complemented k-major index (ties to the lowest index).
__device__ __forceinline__ unsigned long long order_key(float value, int index) {
  const unsigned bits = __float_as_uint(value + 0.0f);
  const unsigned ordered = bits & 0x80000000u ? ~bits : bits | 0x80000000u;
  return static_cast<unsigned long long>(ordered) << 32 | ~static_cast<unsigned>(index);
}

// Sorts a[0..N) into descending order (a bitonic network; N a power of 2).
template <int N>
__device__ __forceinline__ void sort_descending(unsigned long long (&a)[N]) {
#pragma unroll
  for (int size = 2; size <= N; size *= 2)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride /= 2)
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int other = i ^ stride;
        if (other > i) {
          const unsigned long long x = a[i], y = a[other];
          const bool swap = (i & size) == 0 ? x < y : x > y;
          a[i] = swap ? y : x;
          a[other] = swap ? x : y;
        }
      }
}

// a = the N largest of a and b, in descending order; both come sorted
// descending. max(a[i], b[N - 1 - i]) holds them as a bitonic sequence,
// which the half-cleaners sort.
template <int N>
__device__ __forceinline__ void merge_top(unsigned long long (&a)[N], const unsigned long long (&b)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = a[i] > b[N - 1 - i] ? a[i] : b[N - 1 - i];
#pragma unroll
  for (int stride = N / 2; stride > 0; stride /= 2)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int other = i ^ stride;
      if (other > i) {
        const unsigned long long x = a[i], y = a[other];
        a[i] = x < y ? y : x;
        a[other] = x < y ? x : y;
      }
    }
}

// What a candidate needs of its beam: the beam's state and its "stay".
struct BeamView {
  float logp_b, total, stay_b, stay_nb, stay_total;
  uint32_t h1, h2;
  int last;
  bool alive, consumed;
};

// Candidate (k, c) of `beam` as candidate() computes it, except that a merged
// extension's log_add(ext_nb, stay_nb) and total are left for the caller
// (ext_nb is returned for them). An unmerged extension's blank part is
// -1e30, and log_add(x, -1e30) = max(x, -1e30) exactly for every x (x =
// -1e30 gains 0.69, far below its ulp), so its non-blank part and total are
// max(ext_nb, -1e30) with no log-add.
__device__ __forceinline__ Candidate start_candidate(const BeamView& beam, int c, int blank, float emission,
                                                     int matched, float merged_stay_b, float merged_stay_total,
                                                     float dead_total, float& ext_nb) {
  // Both kinds are formed and one is selected: no branch, so that the
  // compiler can interleave the candidates of a lane.
  ext_nb = (c == beam.last ? beam.logp_b : beam.total) + emission;
  const bool merged = matched >= 0;
  const bool stay = c == blank;
  const float ext_logp_nb = fmaxf(ext_nb, kNegInf);
  Candidate out;
  out.logp_b = stay ? (beam.consumed ? kNegInf : beam.stay_b) : (merged ? merged_stay_b : kNegInf);
  out.logp_nb = stay ? (beam.consumed ? kNegInf : beam.stay_nb) : ext_logp_nb;
  out.total = stay ? (beam.consumed ? dead_total : beam.stay_total) : ext_logp_nb;
  out.h1 = stay ? beam.h1 : beam.h1 * kHashP1 + static_cast<uint32_t>(c + 1);
  out.h2 = stay ? beam.h2 : beam.h2 * kHashP2 + static_cast<uint32_t>(c + 1);
  out.ext_is_rep = stay | !merged | (ext_nb >= merged_stay_total);
  out.matched_slot = stay | !merged ? 0 : matched;
  return out;
}

// One block of one warp per batch row, so that the compiler sees the row,
// its length and the step loop as uniform and emits plain shuffles; KCAP >=
// beams. With kOnePerLane (K * C <= 32) lane i holds candidate i and
// selection is by rank; otherwise by a warp-wide merge of sorted lists.
template <int KCAP, bool kOnePerLane>
__global__ void __launch_bounds__(32)
beam_search_warp_kernel(const float* __restrict__ emissions, const int* __restrict__ lengths,
                        int* __restrict__ parents, int* __restrict__ emitted, float* __restrict__ scores,
                        int batch, int time, int classes, int beams, int blank) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x;
  const int length = min(max(lengths[row], 0), time);
  const float* row_emissions = emissions + static_cast<long long>(row) * time * classes;
  const float dead_total = log_add(kNegInf, kNegInf);

  // Lane k < K holds slot k; the other lanes hold dead slots. total is
  // log_add(logp_b, logp_nb), carried over from the candidate that filled
  // the slot.
  uint32_t h1 = 1u, h2 = 1u;
  int last = -1;
  float logp_b = lane == 0 ? 0.0f : kNegInf;
  float logp_nb = kNegInf;
  float total = log_add(logp_b, logp_nb);

  // With one candidate a lane, lane i's candidate i = k * C + c.
  const int my_index = min(lane, beams * classes - 1);
  const int my_k = my_index / classes;
  const int my_c = my_index - my_k * classes;
  // With sorted lists, lane l holds class l of each beam, and the candidates
  // of classes 32 and up (K * (C - 32) of them) are spread k-major over the
  // lanes, one per lane in each chunk: chunk q's on lane l is (spread_k[q],
  // spread_c[q]).
  const int wide = max(classes - 32, 0);
  const int overflow = beams * wide;
  int spread_k[KCAP], spread_c[KCAP];
#pragma unroll
  for (int chunk = 0; chunk < KCAP; ++chunk) {
    const int spread = min(32 * chunk + lane, max(overflow - 1, 0));
    spread_k[chunk] = wide > 0 ? spread / wide : 0;
    spread_c[chunk] = 32 + spread - spread_k[chunk] * wide;
  }

  float e0 = 0.0f, e1 = 0.0f;  // this step's emissions of classes lane, 32 + lane
  if (length > 0) {
    if (lane < classes) e0 = row_emissions[lane];
    if (lane + 32 < classes) e1 = row_emissions[lane + 32];
  }

  for (int t = 0; t < length; ++t) {
    // Step t + 1's emissions, first read a step from now.
    float next0 = 0.0f, next1 = 0.0f;
    if (t + 1 < length) {
      const float* next = row_emissions + static_cast<long long>(t + 1) * classes;
      if (lane < classes) next0 = next[lane];
      if (lane + 32 < classes) next1 = next[lane + 32];
    }

    // Each slot's lane: its "stay" (same prefix) candidate before merging.
    const float blank_emission = class_emission(e0, e1, blank);
    const float last_emission = class_emission(e0, e1, max(last, 0));
    const bool alive = lane < beams && total > kDeadBelow;
    const float stay_b = total + blank_emission;
    const float stay_nb = logp_nb + (last >= 0 ? last_emission : kNegInf);
    const float stay_total = log_add(stay_b, stay_nb);
    const unsigned alive_mask = __ballot_sync(kAllLanes, alive);
    uint32_t beam_h1[KCAP], beam_h2[KCAP];
#pragma unroll
    for (int k = 0; k < KCAP; ++k) {
      beam_h1[k] = __shfl_sync(kAllLanes, h1, k);
      beam_h2[k] = __shfl_sync(kAllLanes, h2, k);
    }
    // Merge pairs: extension (k, c) lands on beam k2's prefix iff both of its
    // hashes equal k2's, between live beams, for a non-blank c. The only
    // candidate class is c = h1[k2] - h1[k] * P1 - 1 (mod 2^32); the second
    // hash confirms it. A stay is consumed when another beam lands on it.
    // (Bitwise & on the conditions: no branches.)
    bool consumed = false;
#pragma unroll
    for (int k = 0; k < KCAP; ++k) {
      const uint32_t c = h1 - beam_h1[k] * kHashP1 - 1u;
      consumed |= static_cast<bool>(alive_mask >> k & 1u) & alive & (c < static_cast<uint32_t>(classes)) &
                  (static_cast<int>(c) != blank) & (beam_h2[k] * kHashP2 + c + 1u == h2);
    }
    const unsigned consumed_mask = __ballot_sync(kAllLanes, consumed);

    // Beam k's view, from its lane. Every lane must call it.
    auto view_of = [&](int k) {
      BeamView view;
      view.logp_b = __shfl_sync(kAllLanes, logp_b, k);
      view.total = __shfl_sync(kAllLanes, total, k);
      view.stay_b = __shfl_sync(kAllLanes, stay_b, k);
      view.stay_nb = __shfl_sync(kAllLanes, stay_nb, k);
      view.stay_total = __shfl_sync(kAllLanes, stay_total, k);
      view.h1 = __shfl_sync(kAllLanes, h1, k);
      view.h2 = __shfl_sync(kAllLanes, h2, k);
      view.last = __shfl_sync(kAllLanes, last, k);
      view.alive = alive_mask >> k & 1u;
      view.consumed = consumed_mask >> k & 1u;
      return view;
    };
    // The beam whose stay extension (beam, c) lands on, or -1; the last
    // match wins on a double-hash collision.
    auto merge_target = [&](const BeamView& beam, int c) {
      int matched = -1;
#pragma unroll
      for (int k2 = 0; k2 < KCAP; ++k2) {
        const bool match = beam.alive & static_cast<bool>(alive_mask >> k2 & 1u) &
                           (beam_h1[k2] - beam.h1 * kHashP1 - 1u == static_cast<uint32_t>(c)) &
                           (beam.h2 * kHashP2 + static_cast<uint32_t>(c) + 1u == beam_h2[k2]);
        matched = match ? k2 : matched;
      }
      return matched;
    };

    // Slot s (on lane s) receives the s-th winner: its candidate and its
    // (parent, token).
    Candidate chosen = {};
    int chosen_parent = 0, chosen_token = 0;
    if constexpr (kOnePerLane) {
      const BeamView beam = view_of(my_k);
      const int matched = merge_target(beam, my_c);
      const int target = max(matched, 0);
      const float merged_b = __shfl_sync(kAllLanes, stay_b, target);
      const float merged_nb = __shfl_sync(kAllLanes, stay_nb, target);
      const float merged_total = __shfl_sync(kAllLanes, stay_total, target);
      float ext_nb;
      Candidate mine = start_candidate(beam, my_c, blank, class_emission(e0, e1, my_c), matched, merged_b, merged_total,
                                       dead_total, ext_nb);
      const bool merging = my_c != blank && matched >= 0;
      if (__any_sync(kAllLanes, merging) && merging) {
        mine.logp_nb = log_add(ext_nb, merged_nb);
        mine.total = log_add(mine.logp_b, mine.logp_nb);
      }
      const float value = lane < beams * classes ? mine.total : -INFINITY;
      int ranks[4] = {0, 0, 0, 0};  // four partial counts: four short add chains
#pragma unroll
      for (int offset = 1; offset < 32; ++offset)
        ranks[offset & 3] += precedes(__shfl_xor_sync(kAllLanes, value, offset), lane ^ offset, value, lane);
      const int rank = (ranks[0] + ranks[1]) + (ranks[2] + ranks[3]);
      int source = 0;
#pragma unroll
      for (int slot = 0; slot < KCAP; ++slot) {
        if (slot >= beams) break;
        const unsigned won = __ballot_sync(kAllLanes, rank == slot);
        source = lane == slot ? __ffs(won) - 1 : source;
      }
      chosen = shuffle_candidate(mine, source);
      chosen_parent = __shfl_sync(kAllLanes, my_k, source);
      chosen_token = __shfl_sync(kAllLanes, my_c, source);
    } else {
      // Candidates j < KCAP: class l of beam j; KCAP + q: chunk q of the
      // spread ones. No lane works through classes it does not hold.
      constexpr int kHeld = 2 * KCAP;
      BeamView views[KCAP];
#pragma unroll
      for (int k = 0; k < KCAP; ++k) views[k] = view_of(k);
      Candidate held[kHeld];
      float ext_nbs[kHeld], merged_nbs[kHeld];
      int ids[kHeld];         // k-major index k * C + c, or -1 for no candidate
      unsigned pending = 0u;  // bit j: candidate j is a merged extension
      auto hold = [&](int j, const BeamView& view, int k, int c, float emission, bool inside) {
        const int matched = merge_target(view, c);
        float merged_b = views[0].stay_b, merged_nb = views[0].stay_nb, merged_total = views[0].stay_total;
#pragma unroll
        for (int k2 = 1; k2 < KCAP; ++k2) {
          merged_b = k2 == matched ? views[k2].stay_b : merged_b;
          merged_nb = k2 == matched ? views[k2].stay_nb : merged_nb;
          merged_total = k2 == matched ? views[k2].stay_total : merged_total;
        }
        merged_nbs[j] = merged_nb;
        held[j] = start_candidate(view, c, blank, emission, matched, merged_b, merged_total, dead_total, ext_nbs[j]);
        ids[j] = inside ? k * classes + c : -1;
        pending |= static_cast<unsigned>(inside && c != blank && matched >= 0) << j;
      };
#pragma unroll
      for (int k = 0; k < KCAP; ++k) {
        ids[k] = ids[KCAP + k] = -1;
        if (k < beams) hold(k, views[k], k, min(lane, classes - 1), e0, lane < classes);
      }
#pragma unroll
      for (int chunk = 0; chunk < KCAP; ++chunk) {
        if (32 * chunk >= overflow) break;
        const int k = spread_k[chunk], c = spread_c[chunk];
        hold(KCAP + chunk, view_of(k), k, c, __shfl_sync(kAllLanes, e1, c - 32), 32 * chunk + lane < overflow);
      }
      // The merged extensions' two log-adds, one candidate a lane at a time.
      while (__any_sync(kAllLanes, pending != 0u)) {
        if (pending != 0u) {
          const int j = __ffs(pending) - 1;
          float merged_b = held[0].logp_b;
#pragma unroll
          for (int i = 1; i < kHeld; ++i)
            if (i == j) merged_b = held[i].logp_b;
          const float nb = log_add(pick(ext_nbs, j), pick(merged_nbs, j));
          const float sum = log_add(merged_b, nb);
#pragma unroll
          for (int i = 0; i < kHeld; ++i)
            if (i == j) {
              held[i].logp_nb = nb;
              held[i].total = sum;
            }
          pending &= pending - 1u;
        }
      }
      unsigned long long keys[kHeld];  // 0: no candidate
#pragma unroll
      for (int j = 0; j < kHeld; ++j) keys[j] = ids[j] >= 0 ? order_key(held[j].total, ids[j]) : 0ull;
      // The warp's top KCAP keys, on every lane: each lane sorts its own
      // (two sorting networks and a merge), then five butterfly levels each
      // merge a lane's list with its partner's. Slot s's lane notes where
      // its winner is.
      unsigned long long top[KCAP], spread_top[KCAP];
#pragma unroll
      for (int k = 0; k < KCAP; ++k) {
        top[k] = keys[k];
        spread_top[k] = keys[KCAP + k];
      }
      sort_descending(top);
      sort_descending(spread_top);
      merge_top(top, spread_top);
#pragma unroll
      for (int offset = 16; offset > 0; offset >>= 1) {
        unsigned long long partner[KCAP];
#pragma unroll
        for (int k = 0; k < KCAP; ++k) partner[k] = __shfl_xor_sync(kAllLanes, top[k], offset);
        merge_top(top, partner);
      }
      const unsigned long long winner = pick(top, lane);
      const unsigned order_mine = static_cast<unsigned>(winner >> 32);
      const int index = static_cast<int>(~static_cast<unsigned>(winner));
      int parent = 0;
#pragma unroll
      for (int k = 1; k < KCAP; ++k) parent += index >= k * classes;
      const int token = index - parent * classes;
      const int spread = parent * wide + token - 32;
      const int owner_mine = token < 32 ? token : spread & 31;
      const int held_mine = token < 32 ? parent : KCAP + (spread >> 5);
      if (lane < beams) {
        chosen_parent = parent;
        chosen_token = token;
      }
      // Every lane fetches its slot's winner from its owner, candidate by
      // candidate: shuffles only, no select of a run-time index on the chain.
      // The total comes back from the winner's key, whose high word holds
      // its bits in order.
#pragma unroll
      for (int j = 0; j < kHeld; ++j) {
        if (j >= KCAP && 32 * (j - KCAP) >= overflow) break;
        const int info = held[j].matched_slot << 1 | static_cast<int>(held[j].ext_is_rep);
        const float b = __shfl_sync(kAllLanes, held[j].logp_b, owner_mine);
        const float nb = __shfl_sync(kAllLanes, held[j].logp_nb, owner_mine);
        const uint32_t hash1 = __shfl_sync(kAllLanes, held[j].h1, owner_mine);
        const uint32_t hash2 = __shfl_sync(kAllLanes, held[j].h2, owner_mine);
        const int fetched = __shfl_sync(kAllLanes, info, owner_mine);
        const bool mine = j == held_mine;
        chosen.logp_b = mine ? b : chosen.logp_b;
        chosen.logp_nb = mine ? nb : chosen.logp_nb;
        chosen.h1 = mine ? hash1 : chosen.h1;
        chosen.h2 = mine ? hash2 : chosen.h2;
        chosen.ext_is_rep = mine ? (fetched & 1) != 0 : chosen.ext_is_rep;
        chosen.matched_slot = mine ? fetched >> 1 : chosen.matched_slot;
      }
      chosen.total = __uint_as_float(order_mine & 0x80000000u ? order_mine & 0x7fffffffu : ~order_mine);
    }

    // Slot s takes the s-th winner: its state, its backpointer and its token.
    const int parent_last = __shfl_sync(kAllLanes, last, chosen_parent);
    if (lane < beams) {
      const bool is_stay = chosen_token == blank;
      const bool dead = chosen.total <= kDeadBelow;
      logp_b = dead ? kNegInf : chosen.logp_b;
      logp_nb = dead ? kNegInf : chosen.logp_nb;
      total = dead ? dead_total : chosen.total;
      h1 = chosen.h1;
      h2 = chosen.h2;
      last = is_stay ? parent_last : chosen_token;
      const long long out = (static_cast<long long>(t) * batch + row) * beams + lane;
      parents[out] = is_stay || chosen.ext_is_rep ? chosen_parent : chosen.matched_slot;
      emitted[out] = !is_stay && chosen.ext_is_rep ? chosen_token : -1;
    }
    e0 = next0;
    e1 = next1;
  }

  // Past its length a row keeps its beams: each slot is its own parent and
  // emits nothing.
  for (int index = lane; index < (time - length) * beams; index += 32) {
    const int t = length + index / beams;
    const int slot = index - (index / beams) * beams;
    const long long out = (static_cast<long long>(t) * batch + row) * beams + slot;
    parents[out] = slot;
    emitted[out] = -1;
  }
  if (lane < beams) scores[row * beams + lane] = log_add(logp_b, logp_nb);
}

template <int KCAP, bool kOnePerLane>
int launch_warp(const float* emissions, const int* lengths, int* parents, int* emitted, float* scores, int batch,
                int time, int classes, int beams, int blank, cudaStream_t stream) {
  beam_search_warp_kernel<KCAP, kOnePerLane><<<batch, 32, 0, stream>>>(
      emissions, lengths, parents, emitted, scores, batch, time, classes, beams, blank);
  return static_cast<int>(cudaGetLastError());
}

template <bool kOnePerLane>
int launch_warp_beams(const float* emissions, const int* lengths, int* parents, int* emitted, float* scores,
                      int batch, int time, int classes, int beams, int blank, cudaStream_t stream) {
  if (beams <= 1)
    return launch_warp<1, kOnePerLane>(emissions, lengths, parents, emitted, scores, batch, time, classes, beams, blank, stream);
  if (beams <= 2)
    return launch_warp<2, kOnePerLane>(emissions, lengths, parents, emitted, scores, batch, time, classes, beams, blank, stream);
  if (beams <= 4)
    return launch_warp<4, kOnePerLane>(emissions, lengths, parents, emitted, scores, batch, time, classes, beams, blank, stream);
  return launch_warp<8, kOnePerLane>(emissions, lengths, parents, emitted, scores, batch, time, classes, beams, blank, stream);
}

// Which kernel searches a [B, T, C] block at beam width K: 0 the block
// kernel, 1 the warp kernel with one candidate a lane, 2 the warp kernel
// with sorted lists. Shape alone decides.
int route(int classes, int beams) {
  if (beams > kWarpMaxBeams || classes > kWarpMaxClasses) return 0;
  return beams * classes <= 32 ? 1 : 2;
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

// The kernel beam_search_forward launches for C classes at beam width K: 0
// the block kernel, 1 or 2 the warp kernel (one candidate a lane, or sorted
// lists).
extern "C" int beam_search_route(int classes, int beams) { return route(classes, beams); }

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
  const int path = route(classes, beams);
  if (path == 1)
    return launch_warp_beams<true>(emissions, lengths, parents, emitted, scores, batch, time, classes, beams, blank, cuda_stream);
  if (path == 2)
    return launch_warp_beams<false>(emissions, lengths, parents, emitted, scores, batch, time, classes, beams, blank, cuda_stream);
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
