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
// Two paths, one function; the C entry (ingest_fast.cuh `launch`) picks
// one per call.
//  - Fast path, `vote_u8_kernel<K, CONS_ROW>`, for the shapes every
//    round hands over (T % 16 == 0, 16-byte aligned planes, packs
//    contiguous or row broadcasts): 16 records a thread, k compiled in,
//    the SWAR window fold and the four-lane closed form.  The body is
//    ingest_fast.cuh's, shared with vote_swar.cu; the closed form is the
//    reference's `_confidence_closed_form`, so these are the per-step
//    transition's bits.
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
#include "ingest_fast.cuh"

namespace {

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

template <int K, bool CONS_ROW>
__global__ void __launch_bounds__(ingest::kFastThreads)
    vote_u8_kernel(ingest::FastArgs a) {
  ingest::fast_body<K, CONS_ROW>(a);
}

const ingest::FastKernels kFast = {
    {vote_u8_kernel<1, false>, vote_u8_kernel<1, true>},
    {vote_u8_kernel<2, false>, vote_u8_kernel<2, true>},
    {vote_u8_kernel<3, false>, vote_u8_kernel<3, true>},
    {vote_u8_kernel<4, false>, vote_u8_kernel<4, true>},
    {vote_u8_kernel<5, false>, vote_u8_kernel<5, true>},
    {vote_u8_kernel<6, false>, vote_u8_kernel<6, true>},
    {vote_u8_kernel<7, false>, vote_u8_kernel<7, true>},
    {vote_u8_kernel<8, false>, vote_u8_kernel<8, true>},
};

}  // namespace

// Launch on `stream`: ingest_fast.cuh `launch`.
extern "C" int vote_u8(const void* votes, const void* consider,
                       const void* confidence, const void* yes_pack,
                       long long yes_rs, long long yes_cs,
                       const void* consider_pack, long long cons_rs,
                       long long cons_cs, const void* mask, void* votes_out,
                       void* consider_out, void* confidence_out,
                       void* changed_out, long long n, long long t, int k,
                       int window, int quorum, int score, void* stream) {
  return ingest::launch(vote_u8_kernel_any, kFast, votes, consider,
                        confidence, yes_pack, yes_rs, yes_cs, consider_pack,
                        cons_rs, cons_cs, mask, votes_out, consider_out,
                        confidence_out, changed_out, n, t, k, window, quorum,
                        score, stream);
}
