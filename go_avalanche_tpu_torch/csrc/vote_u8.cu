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
// 0.03 ms at 16384 x 16384 over 67e12 int32 operations a second: bytes
// bound it, on paper.
//
// Design.  Correct and simple first: one thread per 4-record word of the
// flat planes (ingest.cuh), records read and written as whole 32-bit
// words and confidence as one 64-bit word, so the plane traffic is
// coalesced and each byte is touched once.  The k-step fold runs per
// record in 32-bit registers, as the reference kernel runs it in int32
// vector lanes; no shared memory, no atomics, no synchronisation.  The
// per-step window and confidence transition is ~30 instructions per
// record and draw, ~240 per record at k = 8: at Hopper's int32 rate that
// is more time than the bytes take, so the arithmetic, not the memory,
// sets this kernel's time (PERF.md has it beside the bound).  The SWAR
// kernel (vote_swar.cu) computes the same function with a quarter of the
// window work and the closed-form confidence.

#include <cstdint>
#include <cuda_runtime.h>

#include "ingest.cuh"

namespace {

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
    vote_u8_kernel(ingest::Args a) {
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

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).  Pack
// strides are in elements; `mask` may be null (every record updates).
extern "C" int vote_u8(const void* votes, const void* consider,
                       const void* confidence, const void* yes_pack,
                       long long yes_rs, long long yes_cs,
                       const void* consider_pack, long long cons_rs,
                       long long cons_cs, const void* mask, void* votes_out,
                       void* consider_out, void* confidence_out,
                       void* changed_out, long long n, long long t, int k,
                       int window, int quorum, int score, void* stream) {
  return ingest::launch(vote_u8_kernel, votes, consider, confidence, yes_pack,
                        yes_rs, yes_cs, consider_pack, cons_rs, cons_cs, mask,
                        votes_out, consider_out, confidence_out, changed_out,
                        n, t, k, window, quorum, score, stream);
}
