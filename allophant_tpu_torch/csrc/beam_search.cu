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
// latency of one step whatever B is (rows run in parallel). Three kernels
// keep that chain short; beam_search_forward picks one by shape alone
// (route()):
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
//
// The wide kernel takes every K above 16 (CTC decoders commonly search 32 to
// 100 beams). A sorted list per thread no longer fits in registers there, and
// K selection rounds of one barrier each would cost K barriers a step, so:
// - one block per row; the row's workspace (slot state, per-step stays, a
//   hash table of the live beams and the K * C candidate keys) lies in
//   dynamic shared memory when it fits and otherwise in a global scratch
//   tensor that the wrapper allocates (beam_search_workspace_bytes);
// - merges are found by hashing, O(K * C) work a step and O(K) memory, not
//   O(K^2): each live beam's (h1, h2) goes into an open-addressing table
//   whose slot keeps the highest beam of an equal pair (the last matching
//   stay wins, as in the twin); each extension of a live beam probes it, and
//   a hit marks the table slot consumed, so the stays consumed are known
//   once every extension is scored;
// - every candidate's 64-bit order key (the warp kernel's: value, then the
//   complemented k-major index) is written once; a block-wide radix select
//   (8-bit digits from the top, warp-aggregated histogram counts, stopping
//   as soon as the selected bin holds exactly the winners still wanted)
//   finds the K-th largest key, whatever the ties; the K winners are then
//   gathered and ranked by counting, and only they have their fields
//   recomputed.
//
// The backtrace gives each row one block, copies the row's parents and
// tokens into shared memory (up to kBacktraceStagedInts a [T, K] array), and
// cuts the row's dependent chain of T parent loads into segments that are
// chased in parallel, then joined (beam_backtrace_kernel): about
// 3 sqrt(T / 2) dependent loads instead of T. Steps at or past a row's
// length are written as -1 with no chase.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;     // _NEG_INF: the score of an empty slot
constexpr float kDeadBelow = -5e29f;  // _NEG_INF / 2: a slot at or below it is dead
constexpr uint32_t kHashP1 = 1000003u;
constexpr uint32_t kHashP2 = 31337u;
constexpr int kMaxBeams = 16;  // the block kernel's widest K; wider rows take the wide kernel
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
// The wide kernel's block, and the dynamic shared memory it may take for a
// row's workspace and staged emissions before the workspace moves to global
// scratch.
constexpr int kWideThreads = 512;
constexpr size_t kWideSharedLimit = 200 * 1024;
// The backtrace's block, and about the most (segment, beam) pairs of its
// maps (two ints each in shared memory).
constexpr int kBacktraceThreads = 128;
constexpr int kBacktraceSegmentPairs = 4096;
// The most ints of one [T, K] array the backtrace stages in shared memory
// (two arrays: 64 KB).
constexpr int kBacktraceStagedInts = 8192;

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

// ------------------------------------------------------------- wide kernel

// Where each array of a row's workspace lies, in bytes from its start: the
// two slot states (h1, h2, last, logp_b, logp_nb), the step's per-beam
// quantities (total, stays, the table slot of each live beam), the hash table
// (beam, h1, h2, consumed per slot), the gathered and the ranked winners' keys
// and the K * C candidate keys.
struct WideLayout {
  int table_bits;
  size_t state, step, table, gathered, ranked, keys, bytes;

  __host__ __device__ WideLayout(int classes, int beams) : table_bits(1) {
    while ((1 << table_bits) < 2 * beams) ++table_bits;  // at most half full
    const size_t words = static_cast<size_t>(beams);
    state = 0;
    step = state + 10 * words * 4;
    table = step + 5 * words * 4;
    gathered = (table + 4 * (static_cast<size_t>(1) << table_bits) * 4 + 15) / 16 * 16;
    ranked = gathered + words * 8;
    keys = ranked + words * 8;
    bytes = (keys + words * classes * 8 + 15) / 16 * 16;
  }
};

__device__ __forceinline__ uint32_t table_slot(uint32_t h1, uint32_t h2, int bits) {
  return ((h1 ^ (h2 * 0x85EBCA6Bu)) * 0x9E3779B1u) >> (32 - bits);
}

// The two hash-table probes share this: the highest live beam whose (h1, h2)
// equal the given pair, and its slot, or -1.
__device__ __forceinline__ int probe(const int* table_beam, const uint32_t* table_h1, const uint32_t* table_h2,
                                     uint32_t h1, uint32_t h2, int bits, int& slot) {
  const uint32_t mask = (1u << bits) - 1u;
  for (uint32_t s = table_slot(h1, h2, bits);; s = (s + 1u) & mask) {
    const int beam = table_beam[s];
    if (beam < 0) return -1;
    if (table_h1[s] == h1 && table_h2[s] == h2) {
      slot = static_cast<int>(s);
      return beam;
    }
  }
}

// One block per batch row, any K. The row's workspace of WideLayout(classes,
// beams) is in dynamic shared memory with `workspace_in_shared`, else at its
// row's place in `global_workspace`; with `staged` the emission rows are
// double-buffered in dynamic shared memory after it.
__global__ void __launch_bounds__(kWideThreads)
beam_search_wide_kernel(const float* __restrict__ emissions, const int* __restrict__ lengths,
                        int* __restrict__ parents, int* __restrict__ emitted, float* __restrict__ scores, int batch,
                        int time, int classes, int beams, int blank, unsigned char* global_workspace,
                        int workspace_in_shared, int staged) {
  extern __shared__ __align__(16) unsigned char wide_shared[];
  __shared__ unsigned histogram[256];
  __shared__ unsigned long long select_prefix, select_mask;
  __shared__ unsigned select_remaining;
  __shared__ int select_done;
  __shared__ unsigned winner_count;

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int length = min(max(lengths[row], 0), time);
  const float* row_emissions = emissions + static_cast<long long>(row) * time * classes;
  const WideLayout layout(classes, beams);
  unsigned char* base = workspace_in_shared ? wide_shared : global_workspace + static_cast<size_t>(row) * layout.bytes;
  float* staged_rows = reinterpret_cast<float*>(wide_shared + (workspace_in_shared ? layout.bytes : 0));
  const int candidates = beams * classes;
  const int table_size = 1 << layout.table_bits;

  // Slot state s (0 or 1): h1, h2, last, logp_b and logp_nb, K words each.
  uint32_t* state_words = reinterpret_cast<uint32_t*>(base + layout.state);
  auto h1_of = [&](int s) { return state_words + 5 * s * beams; };
  auto h2_of = [&](int s) { return state_words + (5 * s + 1) * beams; };
  auto last_of = [&](int s) { return reinterpret_cast<int*>(state_words + (5 * s + 2) * beams); };
  auto blank_of = [&](int s) { return reinterpret_cast<float*>(state_words + (5 * s + 3) * beams); };
  auto non_blank_of = [&](int s) { return reinterpret_cast<float*>(state_words + (5 * s + 4) * beams); };
  float* step_total = reinterpret_cast<float*>(base + layout.step);
  float* stay_b = step_total + beams;
  float* stay_nb = stay_b + beams;
  float* stay_total = stay_nb + beams;
  int* slot_of = reinterpret_cast<int*>(stay_total + beams);
  int* table_beam = reinterpret_cast<int*>(base + layout.table);
  uint32_t* table_h1 = reinterpret_cast<uint32_t*>(table_beam + table_size);
  uint32_t* table_h2 = table_h1 + table_size;
  int* table_consumed = reinterpret_cast<int*>(table_h2 + table_size);
  unsigned long long* gathered = reinterpret_cast<unsigned long long*>(base + layout.gathered);
  unsigned long long* ranked = reinterpret_cast<unsigned long long*>(base + layout.ranked);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(base + layout.keys);

  for (int k = tid; k < beams; k += threads) {
    h1_of(0)[k] = 1u;
    h2_of(0)[k] = 1u;
    last_of(0)[k] = -1;
    blank_of(0)[k] = k == 0 ? 0.0f : kNegInf;
    non_blank_of(0)[k] = kNegInf;
  }
  for (int s = tid; s < table_size; s += threads) {
    table_beam[s] = -1;
    table_consumed[s] = 0;
  }
  for (int b = tid; b < 256; b += threads) histogram[b] = 0;
  if (staged && length > 0) {
    for (int c = tid; c < classes; c += threads) __pipeline_memcpy_async(staged_rows + c, row_emissions + c, 4);
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
        for (int c = tid; c < classes; c += threads) __pipeline_memcpy_async(next + c, source + c, 4);
      }
      __pipeline_commit();
    } else {
      __syncthreads();
      frame = row_emissions + static_cast<long long>(t) * classes;
    }
    const uint32_t* h1 = h1_of(current);
    const uint32_t* h2 = h2_of(current);
    const int* last = last_of(current);
    const float* logp_b = blank_of(current);
    const float* logp_nb = non_blank_of(current);

    // Each beam's stay before merging; each live beam enters the table.
    for (int k = tid; k < beams; k += threads) {
      const float total = log_add(logp_b[k], logp_nb[k]);
      const float last_emission = last[k] >= 0 ? frame[last[k]] : kNegInf;
      step_total[k] = total;
      stay_b[k] = total + frame[blank];
      stay_nb[k] = logp_nb[k] + last_emission;
      stay_total[k] = log_add(stay_b[k], stay_nb[k]);
      int slot = -1;
      if (total > kDeadBelow) {
        const uint32_t mask = static_cast<uint32_t>(table_size - 1);
        for (uint32_t s = table_slot(h1[k], h2[k], layout.table_bits);; s = (s + 1u) & mask) {
          const int previous = atomicCAS(&table_beam[s], -1, k);
          if (previous < 0) {
            table_h1[s] = h1[k];
            table_h2[s] = h2[k];
            slot = static_cast<int>(s);
            break;
          }
          // The claimant's hashes from the state, which its table entry may
          // not hold yet.
          if (h1[previous] == h1[k] && h2[previous] == h2[k]) {
            atomicMax(&table_beam[s], k);
            slot = static_cast<int>(s);
            break;
          }
        }
      }
      slot_of[k] = slot;
    }
    if (tid == 0) {
      select_prefix = 0ull;
      select_mask = 0ull;
      select_remaining = static_cast<unsigned>(beams);
      winner_count = 0u;
    }
    __syncthreads();

    // Every extension's key; a merge marks the stay's table slot consumed.
    for (int index = tid; index < candidates; index += threads) {
      const int k = index / classes;
      const int c = index - k * classes;
      if (c == blank) continue;
      const float ext_nb = (c == last[k] ? logp_b[k] : step_total[k]) + frame[c];
      int matched = -1, slot = 0;
      if (step_total[k] > kDeadBelow)
        matched = probe(table_beam, table_h1, table_h2, h1[k] * kHashP1 + static_cast<uint32_t>(c + 1),
                        h2[k] * kHashP2 + static_cast<uint32_t>(c + 1), layout.table_bits, slot);
      float total;
      if (matched >= 0) {
        table_consumed[slot] = 1;
        total = log_add(stay_b[matched], log_add(ext_nb, stay_nb[matched]));
      } else {
        total = log_add(kNegInf, ext_nb);
      }
      keys[index] = order_key(total, index);
    }
    __syncthreads();
    for (int k = tid; k < beams; k += threads) {
      const bool consumed = slot_of[k] >= 0 && table_consumed[slot_of[k]] != 0;
      const float total = consumed ? log_add(kNegInf, kNegInf) : stay_total[k];
      keys[k * classes + blank] = order_key(total, k * classes + blank);
    }
    __syncthreads();

    // Radix select of the K-th largest key, 8 bits a pass from the top. Warp
    // 0 reads each pass's histogram and leaves it zeroed for the next.
    for (int shift = 56; shift >= 0; shift -= 8) {
      const unsigned long long prefix = select_prefix, mask = select_mask;
      for (int start = warp * 32; start < candidates; start += threads) {
        const int index = start + lane;
        const unsigned long long key = index < candidates ? keys[index] : 0ull;
        const bool inside = index < candidates && (key & mask) == prefix;
        const unsigned digit = inside ? static_cast<unsigned>(key >> shift) & 255u : 256u + lane;
        const unsigned peers = __match_any_sync(kAllLanes, digit);
        if (inside && lane == __ffs(peers) - 1) atomicAdd(&histogram[digit], static_cast<unsigned>(__popc(peers)));
      }
      __syncthreads();
      if (warp == 0) {
        // Lane l holds digits 255 - 8l down to 248 - 8l.
        unsigned counts[8];
        unsigned sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          counts[j] = histogram[255 - 8 * lane - j];
          histogram[255 - 8 * lane - j] = 0u;
          sum += counts[j];
        }
        unsigned inclusive = sum;
#pragma unroll
        for (int offset = 1; offset < 32; offset <<= 1) {
          const unsigned below = __shfl_up_sync(kAllLanes, inclusive, offset);
          if (lane >= offset) inclusive += below;
        }
        const unsigned remaining = select_remaining;
        unsigned above = inclusive - sum;  // keys in higher digits
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (above < remaining && above + counts[j] >= remaining) {
            const unsigned wanted = remaining - above;
            select_prefix = prefix | static_cast<unsigned long long>(255 - 8 * lane - j) << shift;
            select_mask = mask | 255ull << shift;
            select_remaining = wanted;
            select_done = counts[j] == wanted;
          }
          above += counts[j];
        }
      }
      __syncthreads();
      if (select_done) break;
    }

    // The winners: every key whose selected bits reach the prefix; each
    // one's slot is the count of winners above it.
    {
      const unsigned long long prefix = select_prefix, mask = select_mask;
      for (int index = tid; index < candidates; index += threads) {
        const unsigned long long key = keys[index];
        if ((key & mask) >= prefix) gathered[atomicAdd(&winner_count, 1u)] = key;
      }
    }
    __syncthreads();
    for (int w = tid; w < beams; w += threads) {
      const unsigned long long key = gathered[w];
      int rank = 0;
      for (int other = 0; other < beams; ++other) rank += gathered[other] > key;
      ranked[rank] = key;
    }
    __syncthreads();

    // Slot s takes the s-th winner: its state, its backpointer and its token.
    for (int s = tid; s < beams; s += threads) {
      const unsigned long long key = ranked[s];
      const int index = static_cast<int>(~static_cast<unsigned>(key));
      const int parent = index / classes;
      const int token = index - parent * classes;
      const unsigned order = static_cast<unsigned>(key >> 32);
      const float total = __uint_as_float(order & 0x80000000u ? order & 0x7fffffffu : ~order);
      float b, nb;
      uint32_t hash1 = h1[parent], hash2 = h2[parent];
      int new_last = last[parent], parent_out = parent, token_out = -1;
      if (token == blank) {
        const bool consumed = slot_of[parent] >= 0 && table_consumed[slot_of[parent]] != 0;
        b = consumed ? kNegInf : stay_b[parent];
        nb = consumed ? kNegInf : stay_nb[parent];
      } else {
        const float ext_nb = (token == last[parent] ? logp_b[parent] : step_total[parent]) + frame[token];
        hash1 = hash1 * kHashP1 + static_cast<uint32_t>(token + 1);
        hash2 = hash2 * kHashP2 + static_cast<uint32_t>(token + 1);
        int matched = -1, slot = 0;
        if (step_total[parent] > kDeadBelow)
          matched = probe(table_beam, table_h1, table_h2, hash1, hash2, layout.table_bits, slot);
        const bool ext_is_rep = matched < 0 || ext_nb >= stay_total[matched];
        b = matched >= 0 ? stay_b[matched] : kNegInf;
        nb = matched >= 0 ? log_add(ext_nb, stay_nb[matched]) : ext_nb;
        new_last = token;
        parent_out = ext_is_rep ? parent : matched;
        token_out = ext_is_rep ? token : -1;
      }
      const bool dead = total <= kDeadBelow;
      blank_of(current ^ 1)[s] = dead ? kNegInf : b;
      non_blank_of(current ^ 1)[s] = dead ? kNegInf : nb;
      h1_of(current ^ 1)[s] = hash1;
      h2_of(current ^ 1)[s] = hash2;
      last_of(current ^ 1)[s] = new_last;
      const long long out = (static_cast<long long>(t) * batch + row) * beams + s;
      parents[out] = parent_out;
      emitted[out] = token_out;
    }
    __syncthreads();
    for (int s = tid; s < table_size; s += threads) {
      table_beam[s] = -1;
      table_consumed[s] = 0;
    }
    current ^= 1;
  }
  __syncthreads();

  // Past its length a row keeps its beams: each slot is its own parent and
  // emits nothing.
  for (int index = tid; index < (time - length) * beams; index += threads) {
    const int t = length + index / beams;
    const int slot = index - (index / beams) * beams;
    const long long out = (static_cast<long long>(t) * batch + row) * beams + slot;
    parents[out] = slot;
    emitted[out] = -1;
  }
  for (int k = tid; k < beams; k += threads)
    scores[row * beams + k] = log_add(blank_of(current)[k], non_blank_of(current)[k]);
}

// Bytes of shared memory the wide kernel's row needs (workspace and staged
// rows), and whether its workspace stays in shared memory.
size_t wide_staged_bytes(int classes) {
  return classes <= kStagedClassLimit ? 2 * sizeof(float) * static_cast<size_t>(classes) : 0;
}

bool wide_workspace_in_shared(int classes, int beams) {
  return WideLayout(classes, beams).bytes + wide_staged_bytes(classes) <= kWideSharedLimit;
}

int launch_wide(const float* emissions, const int* lengths, int* parents, int* emitted, float* scores, int batch,
                int time, int classes, int beams, int blank, void* workspace, cudaStream_t stream) {
  const bool in_shared = wide_workspace_in_shared(classes, beams);
  if (!in_shared && workspace == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared_bytes = (in_shared ? WideLayout(classes, beams).bytes : 0) + wide_staged_bytes(classes);
  const cudaError_t status = cudaFuncSetAttribute(beam_search_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                  static_cast<int>(shared_bytes));
  if (status != cudaSuccess) return static_cast<int>(status);
  const int wanted = max(beams * classes, beams);
  const int threads = min(kWideThreads, max(64, (wanted + 31) / 32 * 32));
  beam_search_wide_kernel<<<batch, threads, shared_bytes, stream>>>(
      emissions, lengths, parents, emitted, scores, batch, time, classes, beams, blank,
      static_cast<unsigned char*>(workspace), in_shared, wide_staged_bytes(classes) > 0);
  return static_cast<int>(cudaGetLastError());
}

// Which kernel searches a [B, T, C] block at beam width K: 0 the block
// kernel, 1 the warp kernel with one candidate a lane, 2 the warp kernel
// with sorted lists, 3 the wide kernel. Shape alone decides.
int route(int classes, int beams) {
  if (beams > kMaxBeams) return 3;
  if (beams > kWarpMaxBeams || classes > kWarpMaxClasses) return 0;
  return beams * classes <= 32 ? 1 : 2;
}

// ---------------------------------------------------------------- backtrace

// One block per row. The chase of a row's L valid steps, one dependent load
// a step, is cut into segments of `segment_steps` steps: (1) every (segment,
// beam) pair chases its segment from the segment's top, giving the segment's
// map of cursors (where a cursor entering at the top leaves at the bottom);
// (2) each beam composes the maps from the last segment down, giving the
// cursor that enters each segment; (3) every pair replays its segment from
// that cursor, writing its tokens. The dependent chain is 2 * segment_steps
// + segments loads instead of L. The maps and entry cursors sit in shared
// memory, and so do the row's parents and emitted tokens when `staged`
// (copied in first, every load in flight at once), so that the chain runs
// at shared-memory latency; otherwise they are read from device memory.
__global__ void __launch_bounds__(kBacktraceThreads)
beam_backtrace_kernel(const int* __restrict__ parents, const int* __restrict__ emitted,
                      const int* __restrict__ lengths, int* __restrict__ collected, int batch, int time, int beams,
                      int segment_steps, int max_pairs, int staged) {
  // maps and entry cursors, [max_pairs] each; then, when staged, the row's
  // parents and emitted tokens, [T][K] each.
  extern __shared__ int backtrace_shared[];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int length = min(max(lengths[row], 0), time);
  const long long step_stride = static_cast<long long>(batch) * beams;
  const long long row_offset = static_cast<long long>(row) * beams;

  // Past its length a row emits nothing: no chase.
  for (int index = tid; index < (time - length) * beams; index += kBacktraceThreads) {
    const int t = length + index / beams;
    collected[t * step_stride + row_offset + index % beams] = -1;
  }
  const int segments = (length + segment_steps - 1) / segment_steps;
  const int pairs = segments * beams;
  int* maps = backtrace_shared;
  int* entries = maps + max_pairs;
  const int* parent_rows = parents + row_offset;
  const int* emitted_rows = emitted + row_offset;
  long long stride = step_stride;
  if (staged) {
    int* staged_parents = entries + max_pairs;
    int* staged_emitted = staged_parents + time * beams;
    for (int index = tid; index < length * beams; index += kBacktraceThreads) {
      const long long source = (index / beams) * step_stride + row_offset + index % beams;
      staged_parents[index] = __ldg(parents + source);
      staged_emitted[index] = __ldg(emitted + source);
    }
    __syncthreads();
    parent_rows = staged_parents;
    emitted_rows = staged_emitted;
    stride = beams;
  }

  if (segments > 1) {
    for (int pair = tid; pair < pairs; pair += kBacktraceThreads) {
      const int segment = pair / beams;
      const int start = segment * segment_steps;
      int cursor = pair - segment * beams;
      for (int t = min(start + segment_steps, length) - 1; t >= start; --t) cursor = parent_rows[t * stride + cursor];
      maps[pair] = cursor;
    }
    __syncthreads();
    for (int beam = tid; beam < beams; beam += kBacktraceThreads) {
      int cursor = beam;
      entries[(segments - 1) * beams + beam] = cursor;
      for (int segment = segments - 1; segment > 0; --segment) {
        cursor = maps[segment * beams + cursor];
        entries[(segment - 1) * beams + beam] = cursor;
      }
    }
    __syncthreads();
  }
  for (int pair = tid; pair < pairs; pair += kBacktraceThreads) {
    const int segment = pair / beams;
    const int beam = pair - segment * beams;
    const int start = segment * segment_steps;
    int cursor = segments > 1 ? entries[pair] : beam;
    for (int t = min(start + segment_steps, length) - 1; t >= start; --t) {
      collected[t * step_stride + row_offset + beam] = emitted_rows[t * stride + cursor];
      cursor = parent_rows[t * stride + cursor];
    }
  }
}

}  // namespace

// The kernel beam_search_forward launches for C classes at beam width K: 0
// the block kernel, 1 or 2 the warp kernel (one candidate a lane, or sorted
// lists), 3 the wide kernel.
extern "C" int beam_search_route(int classes, int beams) { return route(classes, beams); }

// Bytes of global scratch beam_search_forward needs for each batch row at
// this shape: 0 unless the wide kernel's workspace exceeds shared memory.
extern "C" long long beam_search_workspace_bytes(int classes, int beams) {
  if (route(classes, beams) != 3 || wide_workspace_in_shared(classes, beams)) return 0;
  return static_cast<long long>(WideLayout(classes, beams).bytes);
}

// emissions: [B, T, C] f32 contiguous log-probabilities; lengths: [B] int32;
// parents, emitted: [T, B, K] int32; scores: [B, K] f32; workspace: B times
// beam_search_workspace_bytes(C, K) bytes of 16-byte-aligned device memory
// (null when that is 0). K >= 1, 1 <= C <= 32767, 0 <= blank < C. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int beam_search_forward(const float* emissions, const int* lengths, int* parents, int* emitted,
                                   float* scores, int batch, int time, int classes, int beams, int blank,
                                   void* workspace, void* stream) {
  cudaStream_t cuda_stream = static_cast<cudaStream_t>(stream);
  if (beams < 1 || classes < 1 || classes > 32767 || blank < 0 || blank >= classes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const int path = route(classes, beams);
  if (path == 3)
    return launch_wide(emissions, lengths, parents, emitted, scores, batch, time, classes, beams, blank, workspace,
                       cuda_stream);
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

// parents, emitted, collected: [T, B, K] int32 contiguous; lengths: [B]
// int32.
extern "C" int beam_backtrace_forward(const int* parents, const int* emitted, const int* lengths, int* collected,
                                      int batch, int time, int beams, void* stream) {
  cudaStream_t cuda_stream = static_cast<cudaStream_t>(stream);
  if (batch == 0 || time == 0 || beams == 0) return 0;
  // Segments of about sqrt(T / 2) steps minimise the chain 2 S + T / S; at
  // most kBacktraceSegmentPairs (segment, beam) pairs keep the maps small
  // (one segment, a plain chase, when K alone exceeds it).
  int segment_steps = max(1, static_cast<int>(ceil(sqrt(time / 2.0))));
  segment_steps = max(segment_steps, static_cast<int>((static_cast<long long>(time) * beams + kBacktraceSegmentPairs - 1) /
                                                      kBacktraceSegmentPairs));
  segment_steps = min(segment_steps, time);
  const int segments = (time + segment_steps - 1) / segment_steps;
  const int max_pairs = segments > 1 ? segments * beams : 0;
  const int staged = static_cast<long long>(time) * beams <= kBacktraceStagedInts;
  const size_t shared_bytes =
      sizeof(int) * (2 * static_cast<size_t>(max_pairs) + (staged ? 2 * static_cast<size_t>(time) * beams : 0));
  if (shared_bytes > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(beam_backtrace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    static_cast<int>(shared_bytes));
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  beam_backtrace_kernel<<<batch, kBacktraceThreads, shared_bytes, cuda_stream>>>(
      parents, emitted, lengths, collected, batch, time, beams, segment_steps, max_pairs, staged);
  return static_cast<int>(cudaGetLastError());
}
