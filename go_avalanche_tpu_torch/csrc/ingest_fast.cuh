// The fast path of the two window-ingest kernels (vote_u8.cu,
// vote_swar.cu), and their C entries' choice between it and the general
// 4-record walk of ingest.cuh.
//
// Both kernels compute one function, the reference's k-draw window
// ingest: `_vote_kernel` record by record with the per-step confidence
// transition, `_vote_kernel_swar` as the SWAR window fold and the closed
// form of the same transition.  The fast body below is the SWAR fold and
// the closed form, which give the per-step transition's bits, so both
// kernels run it.  Each file wraps it in its own `__global__` template,
// `vote_u8_kernel<K, CONS_ROW>` and `vote_swar_kernel<K, CONS_ROW>`, so
// that the profiler and the card tests tell the kernels apart by symbol
// alone; the wrappers add no instruction.
//
// The fast path takes the shapes every round hands over: T % 16 == 0,
// record planes and contiguous packs on 16-byte boundaries, each vote
// pack the contiguous plane or a row broadcast (the fused exchange's
// consider pack `consider[:, None].expand(n, t)`, column stride 0), and
// N*T/16 small enough for a 32-bit chunk index.
//  - One thread per 16 consecutive records of a row (4 SWAR words), on a
//    flat 1-D grid over the 16-record chunks, so that a narrow row (74
//    chunks at T = 1184) leaves no thread of a block idle.
//  - k (1..8) and the consider pack's form are template parameters, so
//    the draw loop unrolls, its shifts are constants and a row-broadcast
//    consider pack's per-draw bits are computed once for the thread's 4
//    words.
//  - Each plane is one 16-byte streaming load a thread (confidence two),
//    each output one 16-byte streaming store; a broadcast pack is one
//    byte a row, replicated to the lanes, its row a 32-bit division.
//  - `swar::window_step` per word and draw, then `swar::closed_form4`,
//    the closed-form confidence over a word's four lanes at once, which
//    also restores unmasked confidences and masks `changed`.
// By a count from the source, ~250 int32 instructions a 4-record word at
// k = 8, about 1 ms of instruction time at 16384 x 16384, next to 0.88 ms
// of bytes.
// No shared memory, no atomics, no synchronisation.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ingest.cuh"
#include "swar.cuh"

namespace ingest {

constexpr int kFastThreads = 256;
constexpr int kWords = 4;           // SWAR words a thread: 4 records each
constexpr int kRecords = 4 * kWords;

// A vote pack as the fast path reads it: the contiguous [N, T] plane in
// 16-byte chunks, or a row broadcast, row r's byte at `base + r * rs`.
struct Pack {
  const uint8_t* base;
  long long rs;
  bool broadcast;
};

struct FastArgs {
  const uint4* votes;        // [N*T/16] 16-byte chunks of the uint8 plane
  const uint4* consider;
  const uint4* confidence;   // [N*T/8] chunks of 8 uint16 confidences
  const uint4* mask;         // bool chunks; nullptr = every record
  Pack yes, cons;
  uint4* votes_out;
  uint4* consider_out;
  uint4* confidence_out;
  uint4* changed_out;
  uint32_t chunks, row_chunks;   // N*T/16, T/16
  int window, quorum, score;
};

// A row-broadcast pack's byte for `row`, in every byte lane.
__device__ __forceinline__ uint32_t row_lanes(const Pack& p, uint32_t row) {
  return __ldg(p.base + row * p.rs) * swar::kLaneLsb;
}

// One thread's 16 records.  CONS_ROW: the consider pack is a row
// broadcast, as on every round, so its 4 words are one value and each
// draw's consider bits are computed once for the thread.  The yes pack's
// form is read at run time.
template <int K, bool CONS_ROW>
__device__ __forceinline__ void fast_body(const FastArgs& a) {
  using swar::kLaneLsb;
  const uint32_t q = blockIdx.x * kFastThreads + threadIdx.x;   // chunk
  if (q >= a.chunks) return;
  const uint32_t row = CONS_ROW || a.yes.broadcast ? q / a.row_chunks : 0u;

  uint32_t vin[kWords], cin[kWords], yes[kWords], cons[kWords];
  swar::load_chunks<1>(a.votes + q, vin);
  swar::load_chunks<1>(a.consider + q, cin);
  if (a.yes.broadcast) {
    const uint32_t lanes = row_lanes(a.yes, row);
#pragma unroll
    for (int i = 0; i < kWords; ++i) yes[i] = lanes;
  } else {
    swar::load_chunks<1>(reinterpret_cast<const uint4*>(a.yes.base) + q, yes);
  }
  if constexpr (CONS_ROW) {
    const uint32_t lanes = row_lanes(a.cons, row);
#pragma unroll
    for (int i = 0; i < kWords; ++i) cons[i] = lanes;
  } else {
    swar::load_chunks<1>(reinterpret_cast<const uint4*>(a.cons.base) + q,
                         cons);
  }
  swar::Window w[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    w[i] = swar::window_start(vin[i], cin[i], a.window, a.quorum);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      swar::window_step(w[i], (yes[i] >> j) & kLaneLsb,
                        (cons[i] >> j) & kLaneLsb, j);
    }
  }

  uint32_t kept[kWords], conf[2 * kWords];      // kept: 0/1 per byte lane
  if (a.mask) {
    swar::load_chunks<1>(a.mask + q, kept);
  } else {
#pragma unroll
    for (int i = 0; i < kWords; ++i) kept[i] = kLaneLsb;
  }
  swar::load_chunks<2>(a.confidence + 2 * static_cast<size_t>(q), conf);
  uint32_t vout[kWords], cout[kWords], changed[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint32_t keep = kept[i] * 0xFFu;       // 0xFF per kept lane
    vout[i] = (w[i].votes & keep) | (vin[i] & ~keep);
    cout[i] = (w[i].consider & keep) | (cin[i] & ~keep);
    changed[i] = swar::closed_form4(w[i].out_concl, w[i].out_yes, kept[i],
                                    static_cast<uint32_t>(a.score),
                                    conf[2 * i], conf[2 * i + 1]);
  }
  swar::store_chunks<1>(a.votes_out + q, vout);
  swar::store_chunks<1>(a.consider_out + q, cout);
  swar::store_chunks<2>(a.confidence_out + 2 * static_cast<size_t>(q), conf);
  swar::store_chunks<1>(a.changed_out + q, changed);
}

// A fast kernel's 16 instances, [k - 1][consider pack a row broadcast].
using FastKernel = void (*)(FastArgs);
using FastKernels = FastKernel[8][2];

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u;
}

// The fast path's view of a pack, if it takes it: the contiguous plane
// on a 16-byte boundary, or a row broadcast.
inline bool fast_pack(const uint8_t* base, long long rs, long long cs,
                      long long t, Pack& p) {
  p = Pack{base, rs, cs == 0};
  return cs == 0 || (rs == t && cs == 1 && aligned16(base));
}

// Fill `f` and return true if the fast path takes the call `a`.
inline bool fast_args(const Args& a, FastArgs& f) {
  // The chunk index of every launched thread fits in 32 bits.
  const long long chunks = a.total / kRecords;
  if (a.total == 0 || a.t % kRecords != 0
      || chunks + kFastThreads > (1LL << 32)
      || !aligned16(a.votes) || !aligned16(a.consider)
      || !aligned16(a.confidence) || (a.mask && !aligned16(a.mask))
      || !aligned16(a.votes_out) || !aligned16(a.consider_out)
      || !aligned16(a.confidence_out) || !aligned16(a.changed_out)
      || !fast_pack(a.yes_pack, a.yes_rs, a.yes_cs, a.t, f.yes)
      || !fast_pack(a.consider_pack, a.cons_rs, a.cons_cs, a.t, f.cons)) {
    return false;
  }
  f.votes = reinterpret_cast<const uint4*>(a.votes);
  f.consider = reinterpret_cast<const uint4*>(a.consider);
  f.confidence = reinterpret_cast<const uint4*>(a.confidence);
  f.mask = reinterpret_cast<const uint4*>(a.mask);
  f.votes_out = reinterpret_cast<uint4*>(a.votes_out);
  f.consider_out = reinterpret_cast<uint4*>(a.consider_out);
  f.confidence_out = reinterpret_cast<uint4*>(a.confidence_out);
  f.changed_out = reinterpret_cast<uint4*>(a.changed_out);
  f.chunks = static_cast<uint32_t>(chunks);
  f.row_chunks = static_cast<uint32_t>(a.t / kRecords);
  f.window = a.window;
  f.quorum = a.quorum;
  f.score = a.score;
  return true;
}

// A C entry of an ingest kernel: validate the arguments, then launch
// the fast instance of k and the consider pack's form where the shape
// allows, else `any`, the general walk, on `stream`.  Returns
// cudaErrorInvalidValue on arguments the kernels do not take (a score
// outside (0, 0x7FFF], the config's range, included: `closed_form4`'s
// crossing test needs it), else cudaGetLastError() (0 = launched).  Pack
// strides are in elements; `mask` may be null (every record updates).
// `fast_out`, if not null, is set to 1 when the fast path was launched
// and to 0 when the general walk was, so a caller counts the paths.
inline int launch(void (*any)(Args), const FastKernels& fast,
                  const void* votes, const void* consider,
                  const void* confidence, const void* yes_pack,
                  long long yes_rs, long long yes_cs,
                  const void* consider_pack, long long cons_rs,
                  long long cons_cs, const void* mask, void* votes_out,
                  void* consider_out, void* confidence_out, void* changed_out,
                  long long n, long long t, int k, int window, int quorum,
                  int score, void* stream, int* fast_out) {
  Args a;
  if (!fill_args(a, votes, consider, confidence, yes_pack, yes_rs, yes_cs,
                 consider_pack, cons_rs, cons_cs, mask, votes_out,
                 consider_out, confidence_out, changed_out, n, t, k, window,
                 quorum, score)
      || score <= 0 || score > 0x7FFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FastArgs f;
  const bool takes_fast = fast_args(a, f);
  if (fast_out) *fast_out = takes_fast ? 1 : 0;
  if (!takes_fast) return launch(any, a, stream);
  const unsigned blocks = (f.chunks + kFastThreads - 1) / kFastThreads;
  fast[k - 1][f.cons.broadcast ? 1 : 0]<<<blocks, kFastThreads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
      f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ingest
