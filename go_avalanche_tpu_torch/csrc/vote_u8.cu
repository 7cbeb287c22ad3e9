// The u8 window-ingest kernel for Hopper (sm_90a): k bit-packed votes
// per record, applied oldest-first to the [N, T] vote-record planes.
//
// Replaces: go_avalanche_tpu/ops/pallas_vote.py::_vote_kernel (the Pallas
// TPU kernel launched by `register_packed_votes_pallas`).  Plain PyTorch
// version, and the oracle this kernel is held against on the card:
// go_avalanche_tpu_torch/ops/voterecord.py::register_packed_votes
// (absent_is_skip=False), through ops/pallas_vote.py.
//
// What it computes, per record, for draw j = 0 .. k-1: shift the yes and
// consider bits of draw j into the windows, keep the yes and consider
// counts incrementally (+ incoming bit, - evicted bit), compare them with
// the quorum, and run the confidence word's per-step transition (bump,
// flip or saturate at 0x7FFF); `changed` on a flip or an exact
// finalization hit.  Records outside the update mask keep their input.
//
// Bound.  Per record the kernel must read votes, consider, the yes pack,
// the mask (1 B each) and confidence (2 B), and write votes, consider,
// changed (1 B each) and confidence (2 B): 11 B per record, plus N bytes
// for the broadcast consider pack.  At 16384 x 16384 that is 2.95 GB, or
// 0.88 ms at 3.35 TB/s; at the DAG baseline's 10000 x 10000, 1.1 GB or
// 0.33 ms.  The integer work, N*T*k votes at one operation each, is
// 0.13 ms at 16384 x 16384 over Hopper's ~1.67e13 int32 operations a
// second (132 SMs x 64 lanes x ~1.98 GHz): bytes bound it, on paper.
//
// Two paths, one function; the C entry picks one per call.
//  - Fast path, `vote_u8_kernel<K, CONS_ROW>`, for the shapes every
//    round hands over: T % 16 == 0, record planes and contiguous packs
//    on 16-byte boundaries, each vote pack the contiguous plane or a row
//    broadcast (the fused exchange's consider pack
//    `consider[:, None].expand(n, t)`, column stride 0), and N*T/16
//    small enough for a 32-bit chunk index.
//    One thread per 16 consecutive records of a row (4 SWAR words), on a
//    flat 1-D grid over the 16-record chunks so that a narrow row (74
//    chunks at T = 1184) leaves no thread of a block idle.  k (1..8) and
//    the consider pack's form are template parameters, so the draw loop
//    unrolls, its shifts are constants and a row-broadcast consider
//    pack's per-draw bits are computed once for the thread's 4 words.
//    Each plane is one 16-byte streaming load a thread (confidence two),
//    each output one 16-byte streaming store; a broadcast pack is one
//    byte a row, replicated to the lanes, its row a 32-bit division.  The
//    fold is the SWAR one of the megakernel and vote_swar.cu (swar.cuh):
//    `window_step` per word and draw, then `closed_form4`, the
//    closed-form confidence over a word's four lanes at once, which also
//    restores unmasked confidences and masks `changed`.  The closed form
//    is the reference's `_confidence_closed_form`, so these are the
//    per-step transition's bits (the megakernel and vote_swar.cu hold the
//    same algebra bit-equal on the card).  By a count from the source,
//    ~250 int32 instructions a 4-record word at k = 8, about 1 ms of
//    issue at 16384 x 16384, next to 0.88 ms of bytes.
//  - General path, `vote_u8_kernel_any`, for every other shape: the flat
//    4-record walk of ingest.cuh (any N and T, a ragged last word, packs
//    through any strides), folding record by record with the per-step
//    transition (~30 instructions per record and draw, ~1000 a word at
//    k = 8), as the reference kernel runs it in int32 vector lanes.
// What each step did at 16384 x 16384, k = 8 (NVIDIA H100 80GB HBM3,
// 700 W): the general path alone, one thread per 4 records, took
// 4.74 ms, bound by instructions; the fast path (16 records a thread, k
// compiled in, 16-byte streaming I/O, the four-lane closed form) takes
// 1.17 ms, 1.32x the byte bound, at 48-88 registers and no spills.
// No shared memory, no atomics, no synchronisation; neither kernel
// allocates anything.

#include <cstdint>
#include <cuda_runtime.h>

#include "ingest.cuh"
#include "swar.cuh"

namespace {

using swar::kLaneLsb;

// --- general path -----------------------------------------------------

struct Fold {
  uint32_t votes, consider, conf;
  bool changed;
};

// One record through k draws: the reference's per-step transition.
__device__ __forceinline__ Fold fold_record(uint32_t votes, uint32_t consider,
                                            uint32_t conf, uint32_t yes_pack,
                                            uint32_t cons_pack,
                                            const ingest::Args& a) {
  const uint32_t window_mask = (1u << a.window) - 1u;
  const int top_bit = a.window - 1;
  const int threshold = a.quorum - 1;
  int yes_cnt = __popc(votes & consider);
  int cons_cnt = __popc(consider);
  bool changed = false;
  for (int j = 0; j < a.k; ++j) {
    const uint32_t in_yes_raw = (yes_pack >> j) & 1u;
    const uint32_t in_cons = (cons_pack >> j) & 1u;
    const uint32_t in_yes = in_yes_raw & in_cons;  // counted iff considered
    const uint32_t evict_yes = ((votes & consider) >> top_bit) & 1u;
    const uint32_t evict_cons = (consider >> top_bit) & 1u;
    yes_cnt += static_cast<int>(in_yes) - static_cast<int>(evict_yes);
    cons_cnt += static_cast<int>(in_cons) - static_cast<int>(evict_cons);
    votes = ((votes << 1) | in_yes_raw) & window_mask;
    consider = ((consider << 1) | in_cons) & window_mask;

    const bool yes = yes_cnt > threshold;
    const bool no = (cons_cnt - yes_cnt) > threshold;
    const bool conclusive = yes || no;
    const bool agree = ((conf & 1u) == 1u) == yes;
    const uint32_t bumped = (conf >> 1) >= 0x7FFFu ? conf : conf + 2u;
    if (conclusive) conf = agree ? bumped : static_cast<uint32_t>(yes);
    const bool finalized_now =
        (bumped >> 1) == static_cast<uint32_t>(a.score) && agree;
    changed = changed || (conclusive && (!agree || finalized_now));
  }
  return Fold{votes, consider, conf, changed};
}

__global__ void __launch_bounds__(ingest::kThreads)
    vote_u8_kernel_any(ingest::Args a) {
  const long long w =
      static_cast<long long>(blockIdx.x) * ingest::kThreads + threadIdx.x;
  if (4 * w >= a.total) return;
  const ingest::Word in = ingest::load_word(a, w);
  uint32_t votes = 0u, consider = 0u, changed = 0u;
  uint32_t conf[4];
  for (int b = 0; b < 4; ++b) {
    const int s = 8 * b;
    const Fold f = fold_record((in.votes >> s) & 0xFFu,
                               (in.consider >> s) & 0xFFu, in.conf[b],
                               (in.yes >> s) & 0xFFu, (in.cons >> s) & 0xFFu,
                               a);
    votes |= f.votes << s;
    consider |= f.consider << s;
    conf[b] = f.conf;
    changed |= static_cast<uint32_t>(f.changed) << s;
  }
  ingest::store_word(a, in, votes, consider, conf, changed);
}

// --- fast path --------------------------------------------------------

constexpr int kThreads = 256;
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
  return __ldg(p.base + row * p.rs) * kLaneLsb;
}

// CONS_ROW: the consider pack is a row broadcast, as on every round, so
// its 4 words are one value and each draw's consider bits are computed
// once for the thread.  The yes pack's form is read at run time.
template <int K, bool CONS_ROW>
__global__ void __launch_bounds__(kThreads) vote_u8_kernel(FastArgs a) {
  const uint32_t q = blockIdx.x * kThreads + threadIdx.x;   // chunk
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u;
}

// The fast path's view of a pack, if it takes it: the contiguous plane
// on a 16-byte boundary, or a row broadcast.
bool fast_pack(const uint8_t* base, long long rs, long long cs, long long t,
               Pack& p) {
  p = Pack{base, rs, cs == 0};
  return cs == 0 || (rs == t && cs == 1 && aligned16(base));
}

// Fill `f` and return true if the fast path takes the call `a`.
bool fast_args(const ingest::Args& a, FastArgs& f) {
  // The chunk index of every launched thread fits in 32 bits.
  const long long chunks = a.total / kRecords;
  if (a.total == 0 || a.t % kRecords != 0
      || chunks + kThreads > (1LL << 32)
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

template <int K>
void launch_fast(const FastArgs& f, unsigned blocks, cudaStream_t s) {
  if (f.cons.broadcast) {
    vote_u8_kernel<K, true><<<blocks, kThreads, 0, s>>>(f);
  } else {
    vote_u8_kernel<K, false><<<blocks, kThreads, 0, s>>>(f);
  }
}

int launch_fast(const FastArgs& f, int k, void* stream) {
  const unsigned blocks = (f.chunks + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch_fast<1>(f, blocks, s); break;
    case 2: launch_fast<2>(f, blocks, s); break;
    case 3: launch_fast<3>(f, blocks, s); break;
    case 4: launch_fast<4>(f, blocks, s); break;
    case 5: launch_fast<5>(f, blocks, s); break;
    case 6: launch_fast<6>(f, blocks, s); break;
    case 7: launch_fast<7>(f, blocks, s); break;
    default: launch_fast<8>(f, blocks, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).  Pack
// strides are in elements; `mask` may be null (every record updates).
// The score must be in (0, 0x7FFF], the config's range, which the fast
// path's crossing test needs.
extern "C" int vote_u8(const void* votes, const void* consider,
                       const void* confidence, const void* yes_pack,
                       long long yes_rs, long long yes_cs,
                       const void* consider_pack, long long cons_rs,
                       long long cons_cs, const void* mask, void* votes_out,
                       void* consider_out, void* confidence_out,
                       void* changed_out, long long n, long long t, int k,
                       int window, int quorum, int score, void* stream) {
  ingest::Args a;
  if (!ingest::fill_args(a, votes, consider, confidence, yes_pack, yes_rs,
                         yes_cs, consider_pack, cons_rs, cons_cs, mask,
                         votes_out, consider_out, confidence_out, changed_out,
                         n, t, k, window, quorum, score)
      || score <= 0 || score > 0x7FFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FastArgs f;
  if (fast_args(a, f)) return launch_fast(f, k, stream);
  return ingest::launch(vote_u8_kernel_any, a, stream);
}
