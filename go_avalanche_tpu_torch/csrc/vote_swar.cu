// The SWAR window-ingest kernel for Hopper (sm_90a): k bit-packed votes
// per record on 4-record 32-bit words, then the closed-form confidence.
//
// Replaces: go_avalanche_tpu/ops/pallas_vote.py::_vote_kernel_swar (the
// Pallas TPU kernel launched by `register_packed_votes_pallas_swar`,
// with its device functions `swar_window_fold`, `swar_confidence_lane`,
// `swar_confidence_fold` and `_popcount8_i32`).  Plain PyTorch version,
// and the oracle this kernel is held against on the card:
// go_avalanche_tpu_torch/ops/voterecord.py::register_packed_votes_swar
// (absent_is_skip=False), through ops/pallas_vote.py.  The u8 kernel
// (vote_u8.cu) computes the same function.
//
// What it computes, per 4-record word: the k-draw SWAR window fold
// (swar.cuh, shared with the megakernel as the reference shares
// `swar_window_fold`), emitting per-draw quorum-yes and conclusive bits
// per byte lane, then the closed form of the k-step confidence fold per
// lane (the reference's `_confidence_closed_form`).  Records outside the
// update mask keep their input.
//
// Bound.  The same bytes as the u8 kernel: 11 B per record (votes,
// consider, yes pack, mask and 2 B confidence in; votes, consider,
// changed and 2 B confidence out) plus N bytes for the broadcast
// consider pack: 2.95 GB or 0.88 ms at 16384 x 16384 and 3.35 TB/s,
// 1.1 GB or 0.33 ms at 10000 x 10000.  The integer work, N*T*k votes at
// one operation each, is 0.13 ms at 16384 x 16384 over Hopper's ~1.67e13
// int32 operations a second: bytes bound it.
//
// Two paths, one function; the C entry (ingest_fast.cuh `launch`) picks
// one per call.
//  - Fast path, `vote_swar_kernel<K, CONS_ROW>`, for the shapes every
//    round hands over (T % 16 == 0, 16-byte aligned planes, packs
//    contiguous or row broadcasts): ingest_fast.cuh's body, the one
//    vote_u8.cu runs, 16 records a thread with k compiled in and the
//    closed form over a word's four lanes at once (`swar::closed_form4`).
//  - General path, `vote_swar_kernel_any`, for every other shape: one
//    thread per 4-record word of the flat planes (ingest.cuh, any N and
//    T, a ragged last word, packs through any strides), k a loop bound,
//    the scalar closed form per lane (`swar::confidence_closed_form`).
//    The uint8 planes are taken as they lie: a little-endian [N, T]
//    uint8 plane read as 32-bit words is the SWAR layout, and the int16
//    confidence plane read as 64-bit words is the reference's 4 per-lane
//    planes, so nothing is repacked (the TPU launcher's
//    `confidence[:, lane::4]` copies and restack have no counterpart).
// At 16384 x 16384, k = 8 (NVIDIA H100 80GB HBM3, 700 W) the general
// path alone took 2.34 ms, 2.66x the byte bound.
// No shared memory, no atomics, no synchronisation; neither kernel
// allocates anything.

#include <cstdint>
#include <cuda_runtime.h>

#include "ingest.cuh"
#include "ingest_fast.cuh"

namespace {

// --- general path -----------------------------------------------------

__global__ void __launch_bounds__(ingest::kThreads)
    vote_swar_kernel_any(ingest::Args a) {
  const long long w =
      static_cast<long long>(blockIdx.x) * ingest::kThreads + threadIdx.x;
  if (4 * w >= a.total) return;
  const ingest::Word in = ingest::load_word(a, w);
  swar::Window win = swar::window_start(in.votes, in.consider, a.window,
                                        a.quorum);
  for (int j = 0; j < a.k; ++j) {
    swar::window_step(win, (in.yes >> j) & swar::kLaneLsb,
                      (in.cons >> j) & swar::kLaneLsb, j);
  }
  uint32_t conf[4];
  uint32_t changed = 0u;
  for (int b = 0; b < 4; ++b) {
    const uint32_t concl = (win.out_concl >> (8 * b)) & 0xFFu;
    const uint32_t yes = (win.out_yes >> (8 * b)) & concl;
    bool lane_changed = false;
    conf[b] = swar::confidence_closed_form(
        in.conf[b], concl, yes, static_cast<uint32_t>(a.score),
        &lane_changed);
    changed |= static_cast<uint32_t>(lane_changed) << (8 * b);
  }
  ingest::store_word(a, in, win.votes, win.consider, conf, changed);
}

// --- fast path --------------------------------------------------------

template <int K, bool CONS_ROW>
__global__ void __launch_bounds__(ingest::kFastThreads)
    vote_swar_kernel(ingest::FastArgs a) {
  ingest::fast_body<K, CONS_ROW>(a);
}

const ingest::FastKernels kFast = {
    {vote_swar_kernel<1, false>, vote_swar_kernel<1, true>},
    {vote_swar_kernel<2, false>, vote_swar_kernel<2, true>},
    {vote_swar_kernel<3, false>, vote_swar_kernel<3, true>},
    {vote_swar_kernel<4, false>, vote_swar_kernel<4, true>},
    {vote_swar_kernel<5, false>, vote_swar_kernel<5, true>},
    {vote_swar_kernel<6, false>, vote_swar_kernel<6, true>},
    {vote_swar_kernel<7, false>, vote_swar_kernel<7, true>},
    {vote_swar_kernel<8, false>, vote_swar_kernel<8, true>},
};

}  // namespace

// Launch on `stream`: ingest_fast.cuh `launch`.
extern "C" int vote_swar(const void* votes, const void* consider,
                         const void* confidence, const void* yes_pack,
                         long long yes_rs, long long yes_cs,
                         const void* consider_pack, long long cons_rs,
                         long long cons_cs, const void* mask, void* votes_out,
                         void* consider_out, void* confidence_out,
                         void* changed_out, long long n, long long t, int k,
                         int window, int quorum, int score, void* stream) {
  return ingest::launch(vote_swar_kernel_any, kFast, votes, consider,
                        confidence, yes_pack, yes_rs, yes_cs, consider_pack,
                        cons_rs, cons_cs, mask, votes_out, consider_out,
                        confidence_out, changed_out, n, t, k, window, quorum,
                        score, stream);
}
