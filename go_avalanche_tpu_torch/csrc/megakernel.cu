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
// 16384 x 16384, or 0.81 ms at 3.35 TB/s.  The gathered preference bits
// (N*k*T/8 bytes a round) come from the bit-packed [N, T/8] plane, which
// at 32 MiB fits the 50 MB L2.  A first design, one thread per 4 columns
// re-reading the row's draw data and gathering one byte per draw, ran
// ~400 int32 instructions per 4-column word and took 2.45 ms at
// 16384 x 16384, k = 8 (NVIDIA H100 80GB HBM3, 700 W): it was bound by
// instructions.  This design cuts instructions and load instructions;
// it takes 1.24 ms there, 1.5x the byte bound; by a count from the
// source, ~240 int32 instructions per word remain, about as much time
// as the byte stream.
//
// Design.  One thread per 16 tx columns of one node row (4 SWAR words,
// swar.cuh: 4 columns per 32-bit word, one byte lane each):
//  - k and the adversary strategy are template parameters (k = 1..8,
//    FLIP or OPPOSE_MAJORITY; the launcher dispatches), so the draw loop
//    unrolls, the per-draw shifts of `swar::window_step` are constants
//    and the strategy test leaves the loop.
//  - Votes, consider and polled are read as one 16-byte load each and
//    confidence as two, outputs stored the same way, all streaming
//    (`__ldcs` / `__stcs`) so the record stream does not evict the
//    preference plane from L2.  A draw's gather is one aligned 16-bit
//    load of the peer's preference row.
//  - The row's draw data (peer ids, responded, lie) is loaded once per
//    thread, with the widest aligned loads k allows, and each draw's lie
//    is applied to the whole 16-bit gathered chunk (FLIP: xor; OPPOSE:
//    the thread's minority chunk) before the 4-bit nibbles are spread
//    into byte lanes; `responded` becomes one lane word per draw,
//    shared by the 4 SWAR words.
//  These three took the kernel from 2.45 to 1.92 ms (same card).
//  - The closed-form confidence (`swar::confidence_closed_form`, the
//    reference's `_confidence_closed_form`) runs over the four byte
//    lanes of a word at once (`swar::closed_form4`, in swar.cuh with the
//    16-byte chunk I/O, shared with vote_u8.cu): flips, the last
//    conclusive vote and the trailing agree run are per-byte smears and
//    popcounts; only the 15-bit counter, its saturation and the score
//    crossing run per 16-bit lane, two records per 32-bit word.
//    1.92 -> 1.24 ms.
//  32 columns a thread (a 32-bit gather, 8 words) measured 1.28 ms
//  against 1.24 in the same run, at 75-105 registers against 48-72.
// No shared memory, no atomics, no synchronisation; the kernel allocates
// nothing.  A thread's 16 columns never straddle rows (t % 32 == 0), and
// the last block of a row masks the threads past the row's end.

#include <cstdint>
#include <cuda_runtime.h>

#include "swar.cuh"

namespace {

using swar::kLaneLsb;
using swar::closed_form4;
using swar::load_chunks;
using swar::store_chunks;
constexpr int kThreads = 256;
constexpr int kWords = 4;            // SWAR words a thread: 4 columns each
constexpr int kCols = 4 * kWords;    // tx columns a thread
constexpr int kChunks = kWords / 4;  // 16-byte chunks of a uint8 plane
using Bits = uint16_t;               // a thread's preference bits
constexpr uint32_t kAllBits = 0xFFFFu;

// Four preference bits (tx columns 4g .. 4g+3) -> one bit per byte lane:
// nib * 0x00204081 places bit b at 8b + (other copies at disjoint
// positions), so no carries and the mask keeps exactly the lane LSBs.
__host__ __device__ __forceinline__ uint32_t nibble_lanes(uint32_t nib) {
  return (nib * 0x00204081u) & kLaneLsb;
}

struct RoundArgs {
  const uint4* votes;        // [n, t/16] 16-byte chunks of the uint8 plane
  const uint4* consider;     // [n, t/16]
  const uint4* confidence;   // [n, t/8] chunks of 8 uint16 confidences
  const Bits* prefs;         // [n, t/kCols] bit-packed preferences
  const int32_t* peers;      // [n, k]
  const uint8_t* responded;  // [n, k] bool
  const uint8_t* lie;        // [n, k] bool
  const Bits* minority;      // [t/kCols] bit-packed minority colors
  const uint4* polled;       // [n, t/16] chunks of the bool polled plane
  uint4* votes_out;
  uint4* consider_out;
  uint4* confidence_out;
  uint4* changed_out;        // [n, t/16] chunks of the bool changed plane
  int n, tq, window, quorum, score;   // tq = t / kCols threads a row
};

// A row's K draw flags (bool bytes), byte j = draw j.  The row starts at
// a multiple of K bytes of an 8-byte aligned plane.
template <int K>
__device__ __forceinline__ uint64_t load_flags(const uint8_t* p) {
  if constexpr (K == 8) {
    return __ldg(reinterpret_cast<const unsigned long long*>(p));
  } else if constexpr (K == 4) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    uint64_t v = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      v |= static_cast<uint64_t>(__ldg(p + j)) << (8 * j);
    }
    return v;
  }
}

template <int K, bool OPPOSE>
__global__ void __launch_bounds__(kThreads) mega_round_kernel(RoundArgs a) {
  const int row = blockIdx.x;
  const int q = blockIdx.y * kThreads + threadIdx.x;   // kCols-column chunk
  if (q >= a.tq) return;
  const size_t rq = static_cast<size_t>(row) * a.tq + q;

  // The row's draws: peer ids (pairs of int32 where K is even), flags.
  int peer[K];
  const int32_t* peer_row = a.peers + static_cast<size_t>(row) * K;
  if constexpr (K % 2 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 2) {
      const int2 v = __ldg(reinterpret_cast<const int2*>(peer_row) + j / 2);
      peer[j] = v.x;
      peer[j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) peer[j] = __ldg(peer_row + j);
  }
  const uint64_t responded = load_flags<K>(a.responded
                                           + static_cast<size_t>(row) * K);
  const uint64_t lie = load_flags<K>(a.lie + static_cast<size_t>(row) * K);
  uint32_t gathered[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int p = peer[j] < 0 ? 0 : (peer[j] >= a.n ? a.n - 1 : peer[j]);
    gathered[j] = __ldg(a.prefs + static_cast<size_t>(p) * a.tq + q);
  }
  uint32_t minority = 0u;
  if constexpr (OPPOSE) minority = __ldg(a.minority + q);

  uint32_t vin[kWords], cin[kWords];
  load_chunks<kChunks>(a.votes + rq * kChunks, vin);
  load_chunks<kChunks>(a.consider + rq * kChunks, cin);
  swar::Window w[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    w[i] = swar::window_start(vin[i], cin[i], a.window, a.quorum);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const bool lies = ((lie >> (8 * j)) & 0xFFu) != 0u;
    uint32_t yes_bits = gathered[j];
    if constexpr (OPPOSE) {      // a lie says the minority color
      yes_bits = lies ? minority : yes_bits;
    } else {                     // FLIP: a lie says the opposite
      yes_bits ^= lies ? kAllBits : 0u;
    }
    const uint32_t in_cons =
        ((responded >> (8 * j)) & 0xFFu) != 0u ? kLaneLsb : 0u;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      swar::window_step(w[i], nibble_lanes((yes_bits >> (4 * i)) & 0xFu),
                        in_cons, j);
    }
  }

  uint32_t pin[kWords], conf[2 * kWords];
  load_chunks<kChunks>(a.polled + rq * kChunks, pin);
  load_chunks<2 * kChunks>(a.confidence + rq * 2 * kChunks, conf);
  uint32_t vout[kWords], cout[kWords], changed[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const uint32_t keep = pin[i] * 0xFFu;        // 0xFF per polled lane
    vout[i] = (w[i].votes & keep) | (vin[i] & ~keep);
    cout[i] = (w[i].consider & keep) | (cin[i] & ~keep);
    changed[i] = closed_form4(w[i].out_concl, w[i].out_yes, pin[i],
                              static_cast<uint32_t>(a.score), conf[2 * i],
                              conf[2 * i + 1]);
  }
  store_chunks<kChunks>(a.votes_out + rq * kChunks, vout);
  store_chunks<kChunks>(a.consider_out + rq * kChunks, cout);
  store_chunks<2 * kChunks>(a.confidence_out + rq * 2 * kChunks, conf);
  store_chunks<kChunks>(a.changed_out + rq * kChunks, changed);
}

template <int K>
void launch(const RoundArgs& a, bool oppose, dim3 grid, cudaStream_t s) {
  if (oppose) {
    mega_round_kernel<K, true><<<grid, kThreads, 0, s>>>(a);
  } else {
    mega_round_kernel<K, false><<<grid, kThreads, 0, s>>>(a);
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 = launched).  Every
// record plane must start on a 16-byte boundary, the other inputs on an
// 8-byte one.
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
      || window > 8 || quorum <= 0 || quorum > window || score <= 0
      || score > 0x7FFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  RoundArgs a;
  a.votes = static_cast<const uint4*>(votes);
  a.consider = static_cast<const uint4*>(consider);
  a.confidence = static_cast<const uint4*>(confidence);
  a.prefs = static_cast<const Bits*>(prefs);
  a.peers = static_cast<const int32_t*>(peers);
  a.responded = static_cast<const uint8_t*>(responded);
  a.lie = static_cast<const uint8_t*>(lie);
  a.minority = static_cast<const Bits*>(minority);
  a.polled = static_cast<const uint4*>(polled);
  a.votes_out = static_cast<uint4*>(votes_out);
  a.consider_out = static_cast<uint4*>(consider_out);
  a.confidence_out = static_cast<uint4*>(confidence_out);
  a.changed_out = static_cast<uint4*>(changed_out);
  a.n = n;
  a.tq = t / kCols;
  a.window = window;
  a.quorum = quorum;
  a.score = score;
  const dim3 grid(static_cast<unsigned>(n),
                  static_cast<unsigned>((a.tq + kThreads - 1) / kThreads));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool opp = oppose != 0;
  switch (k) {
    case 1: launch<1>(a, opp, grid, s); break;
    case 2: launch<2>(a, opp, grid, s); break;
    case 3: launch<3>(a, opp, grid, s); break;
    case 4: launch<4>(a, opp, grid, s); break;
    case 5: launch<5>(a, opp, grid, s); break;
    case 6: launch<6>(a, opp, grid, s); break;
    case 7: launch<7>(a, opp, grid, s); break;
    default: launch<8>(a, opp, grid, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
