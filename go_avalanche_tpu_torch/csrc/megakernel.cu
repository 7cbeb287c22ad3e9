// Whole-round megakernel for Hopper (sm_90a): peer gather -> adversary
// transform -> k-draw window fold -> closed-form confidence -> polled
// restore, in one pass over the record planes.
//
// Replaces: go_avalanche_tpu/ops/megakernel.py::_mega_kernel (the Pallas
// TPU kernel launched by `fused_round`).  Plain PyTorch version, and the
// oracle this kernel is held against on the card:
// go_avalanche_tpu_torch/ops/megakernel.py::fused_round_reference.
//
// Bound.  Per record the kernel must read votes, consider (1 B each),
// confidence (2 B) and the polled flag (1 B), and write votes, consider,
// confidence and changed (5 B): about 10 B per record, 2.7 GB at
// 16384 x 16384, or ~0.8 ms at 3.35 TB/s.  The gathered preference words
// (N*k*T/8 bytes a round) come from the bit-packed [N, T/8] plane, which
// at 32 MiB fits the 50 MB L2, so the gather is served from L2 rather
// than device memory.  The kernel is bound by bytes.
//
// Design.  One thread per 4 tx columns of one node row: the record
// planes are read and written as whole 32-bit words (confidence as one
// 64-bit word), neighbouring threads on neighbouring words, so every
// plane access is coalesced.  A block covers 1024 columns of ONE row, so
// the row's k peer ids, responded and lie flags are the same address
// for the whole block (broadcast loads), and for draw j the block's
// threads read consecutive bytes of one peer row.  The TPU kernel staged
// all N rows of a column block in VMEM (1 MB); here nothing is staged in
// shared memory — the gather goes through L2.  The window fold runs SWAR
// on the word (4 byte lanes, the reference's `swar_window_fold`
// algebra; swar.cuh, shared with vote_swar.cu), emitting per-draw yes /
// conclusive bits, and the confidence
// word is touched once, by the closed form of the k-step fold
// (`voterecord._confidence_closed_form` in the reference).  Unpolled
// records are restored in-kernel.  No shared memory, no atomics, no
// synchronisation; the kernel allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

#include "swar.cuh"

namespace {

using swar::kLaneLsb;
constexpr int kThreads = 256;               // 1024 tx columns per block

// Four preference bits (tx columns 4g .. 4g+3) -> one bit per byte lane:
// nib * 0x00204081 places bit b at 8b + (other copies at disjoint
// positions), so no carries and the mask keeps exactly the lane LSBs.
__host__ __device__ __forceinline__ uint32_t nibble_lanes(uint32_t nib) {
  return (nib * 0x00204081u) & kLaneLsb;
}

struct RoundArgs {
  const uint32_t* votes;     // [n, t/4] words of the uint8 votes plane
  const uint32_t* consider;  // [n, t/4]
  const uint2* confidence;   // [n, t/4] words of 4 uint16 confidences
  const uint8_t* prefs;      // [n, t/8] bit-packed preferences
  const int32_t* peers;      // [n, k]
  const uint8_t* responded;  // [n, k] bool
  const uint8_t* lie;        // [n, k] bool
  const uint8_t* minority;   // [t/8] bit-packed minority colors
  const uint32_t* polled;    // [n, t/4] words of the bool polled plane
  uint32_t* votes_out;
  uint32_t* consider_out;
  uint2* confidence_out;
  uint32_t* changed_out;     // [n, t/4] words of the bool changed plane
  int n, t4, t8, k, window, quorum, score, oppose;
};

// One 4-column word of one row: the whole round.
__host__ __device__ __forceinline__ void round_word(const RoundArgs& a,
                                                    int row, int g) {
  const size_t idx = static_cast<size_t>(row) * a.t4 + g;
  const uint32_t votes_in = a.votes[idx];
  const uint32_t consider_in = a.consider[idx];
  const int byte = g >> 1;
  const int shift = (g & 1) * 4;
  const uint32_t minority =
      nibble_lanes((static_cast<uint32_t>(a.minority[byte]) >> shift) & 0xFu);

  swar::Window w = swar::window_start(votes_in, consider_in, a.window,
                                      a.quorum);
  for (int j = 0; j < a.k; ++j) {
    const size_t draw = static_cast<size_t>(row) * a.k + j;
    int peer = a.peers[draw];
    peer = peer < 0 ? 0 : (peer >= a.n ? a.n - 1 : peer);
    uint32_t in_yes_raw = nibble_lanes(
        (static_cast<uint32_t>(a.prefs[static_cast<size_t>(peer) * a.t8
                                       + byte]) >> shift) & 0xFu);
    const uint32_t lie = a.lie[draw] ? kLaneLsb : 0u;
    if (a.oppose) {  // OPPOSE_MAJORITY: a lie says the minority color
      in_yes_raw = (in_yes_raw & ~lie) | (minority & lie);
    } else {         // FLIP: a lie says the opposite
      in_yes_raw ^= lie;
    }
    const uint32_t in_cons = a.responded[draw] ? kLaneLsb : 0u;
    swar::window_step(w, in_yes_raw, in_cons, j);
  }
  const uint32_t votes = w.votes;
  const uint32_t consider = w.consider;

  const uint32_t polled = a.polled[idx];     // 0/1 per byte lane
  const uint32_t keep = polled * 0xFFu;      // 0xFF per polled lane
  a.votes_out[idx] = (votes & keep) | (votes_in & ~keep);
  a.consider_out[idx] = (consider & keep) | (consider_in & ~keep);

  const uint2 conf_in = a.confidence[idx];
  const uint32_t conf[4] = {conf_in.x & 0xFFFFu, conf_in.x >> 16,
                            conf_in.y & 0xFFFFu, conf_in.y >> 16};
  uint32_t conf_out[4];
  uint32_t changed = 0u;
  for (int lane = 0; lane < 4; ++lane) {
    const uint32_t concl = (w.out_concl >> (8 * lane)) & 0xFFu;
    const uint32_t yes = (w.out_yes >> (8 * lane)) & concl;
    bool lane_changed = false;
    const uint32_t folded = swar::confidence_closed_form(
        conf[lane], concl, yes, static_cast<uint32_t>(a.score),
        &lane_changed);
    const bool m = ((polled >> (8 * lane)) & 1u) != 0u;
    conf_out[lane] = m ? folded : conf[lane];
    changed |= static_cast<uint32_t>(m && lane_changed) << (8 * lane);
  }
  a.confidence_out[idx] = make_uint2(conf_out[0] | (conf_out[1] << 16),
                                     conf_out[2] | (conf_out[3] << 16));
  a.changed_out[idx] = changed;
}

__global__ void __launch_bounds__(kThreads) mega_round_kernel(RoundArgs a) {
  const int row = blockIdx.x;
  const int g = blockIdx.y * kThreads + threadIdx.x;
  if (g < a.t4) round_word(a, row, g);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int mega_round(const void* votes, const void* consider,
                          const void* confidence, const void* prefs,
                          const void* peers, const void* responded,
                          const void* lie, const void* minority,
                          const void* polled, void* votes_out,
                          void* consider_out, void* confidence_out,
                          void* changed_out, int n, int t, int k, int window,
                          int quorum, int score, int oppose,
                          void* stream) {
  if (n <= 0 || t <= 0 || t % 32 != 0 || k <= 0 || k > 8 || window <= 0
      || window > 8 || quorum <= 0 || quorum > window) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RoundArgs a;
  a.votes = static_cast<const uint32_t*>(votes);
  a.consider = static_cast<const uint32_t*>(consider);
  a.confidence = static_cast<const uint2*>(confidence);
  a.prefs = static_cast<const uint8_t*>(prefs);
  a.peers = static_cast<const int32_t*>(peers);
  a.responded = static_cast<const uint8_t*>(responded);
  a.lie = static_cast<const uint8_t*>(lie);
  a.minority = static_cast<const uint8_t*>(minority);
  a.polled = static_cast<const uint32_t*>(polled);
  a.votes_out = static_cast<uint32_t*>(votes_out);
  a.consider_out = static_cast<uint32_t*>(consider_out);
  a.confidence_out = static_cast<uint2*>(confidence_out);
  a.changed_out = static_cast<uint32_t*>(changed_out);
  a.n = n;
  a.t4 = t / 4;
  a.t8 = t / 8;
  a.k = k;
  a.window = window;
  a.quorum = quorum;
  a.score = score;
  a.oppose = oppose;
  const dim3 grid(static_cast<unsigned>(n),
                  static_cast<unsigned>((a.t4 + kThreads - 1) / kThreads));
  mega_round_kernel<<<grid, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
