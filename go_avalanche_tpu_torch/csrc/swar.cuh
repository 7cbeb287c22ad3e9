// SWAR device functions shared by the whole-round megakernel
// (megakernel.cu) and the SWAR ingest kernel (vote_swar.cu): the
// counterparts of the reference's `swar_window_fold` step,
// `swar_confidence_lane` and `_popcount8_i32`
// (go_avalanche_tpu/ops/pallas_vote.py), which its two kernels share the
// same way, so the window semantics of the two can never drift.
//
// Layout (go_avalanche_tpu/ops/swar.py): 4 adjacent tx columns of a
// uint8 plane per 32-bit word, little-endian, column 4w + b in byte lane
// b.  A uint8 [N, T] plane read as 32-bit words IS this layout.

#pragma once

#include <cstdint>

namespace swar {

constexpr uint32_t kLaneLsb = 0x01010101u;
constexpr uint32_t kLaneMsb = 0x80808080u;
constexpr uint32_t kNoCarry = 0xFEFEFEFEu;  // drops a lane's <<1 carry-out

// Per-byte-lane popcount of a 32-bit word.
__host__ __device__ __forceinline__ uint32_t popcount8_lanes(uint32_t x) {
  x = x - ((x >> 1) & 0x55555555u);
  x = (x & 0x33333333u) + ((x >> 2) & 0x33333333u);
  return (x + (x >> 4)) & 0x0F0F0F0Fu;
}

// The window of 4 records through a k-draw fold: the two window words,
// their incremental per-lane yes / consider counts, and the per-draw
// outcomes (bit j of each lane = draw j's quorum-yes / conclusive).
struct Window {
  uint32_t votes, consider, yes_cnt, cons_cnt, out_yes, out_concl;
  uint32_t window_lanes, gt_bias;
  int top_bit;
};

__host__ __device__ __forceinline__ Window window_start(uint32_t votes,
                                                        uint32_t consider,
                                                        int window,
                                                        int quorum) {
  Window w;
  w.votes = votes;
  w.consider = consider;
  w.yes_cnt = popcount8_lanes(votes & consider);
  w.cons_cnt = popcount8_lanes(consider);
  w.out_yes = 0u;
  w.out_concl = 0u;
  w.window_lanes = ((1u << window) - 1u) * kLaneLsb;
  w.top_bit = window - 1;
  // lane > quorum-1  <=>  (lane + 0x7F - (quorum-1)) has its MSB set.
  w.gt_bias = (0x7Fu - static_cast<uint32_t>(quorum - 1)) * kLaneLsb;
  return w;
}

// Draw j: shift its vote and consider bits (lane-LSB words) into the
// windows, update the counts by the incoming and the evicted bit, and
// record the per-lane quorum outcome at bit j.
__host__ __device__ __forceinline__ void window_step(Window& w,
                                                     uint32_t in_yes_raw,
                                                     uint32_t in_cons,
                                                     int j) {
  const uint32_t in_yes = in_yes_raw & in_cons;  // counted iff considered
  const uint32_t evict_yes = ((w.votes & w.consider) >> w.top_bit) & kLaneLsb;
  const uint32_t evict_cons = (w.consider >> w.top_bit) & kLaneLsb;
  w.yes_cnt = w.yes_cnt + in_yes - evict_yes;
  w.cons_cnt = w.cons_cnt + in_cons - evict_cons;
  w.votes = (((w.votes << 1) & kNoCarry) | in_yes_raw) & w.window_lanes;
  w.consider = (((w.consider << 1) & kNoCarry) | in_cons) & w.window_lanes;

  const uint32_t yes_m = (w.yes_cnt + w.gt_bias) & kLaneMsb;
  const uint32_t no_m = ((w.cons_cnt - w.yes_cnt) + w.gt_bias) & kLaneMsb;
  w.out_yes |= (yes_m >> (7 - j)) & (kLaneLsb << j);
  w.out_concl |= ((yes_m | no_m) >> (7 - j)) & (kLaneLsb << j);
}

// The k-step confidence fold of one record in closed form.  `concl` and
// `yes` hold the per-draw conclusive and (conclusive) yes outcomes, draw
// j at bit j.  A record flips iff some conclusive vote disagrees with its
// initial preference; the final preference is the last conclusive
// vote's; the final counter counts the trailing run of conclusive votes
// agreeing with it (the run starts at 0 after a flip, and otherwise
// extends the incoming counter, saturating at 0x7FFF).
__host__ __device__ __forceinline__ uint32_t confidence_closed_form(
    uint32_t conf, uint32_t concl, uint32_t yes, uint32_t score,
    bool* changed) {
  const uint32_t a0 = conf & 1u;
  const uint32_t c0 = conf >> 1;
  const bool flips = (concl & (yes ^ (a0 * 0xFFu))) != 0u;
  uint32_t f = concl | (concl >> 1);
  f |= f >> 2;
  f |= f >> 4;
  const uint32_t high = f ^ (f >> 1);  // highest conclusive draw
  const uint32_t a_fin = concl ? ((yes & high) ? 1u : 0u) : a0;
  const uint32_t disagree = concl & (yes ^ (a_fin * 0xFFu));
  uint32_t d = disagree | (disagree >> 1);
  d |= d >> 2;
  d |= d >> 4;
  const uint32_t run = popcount8_lanes(concl & ~d & 0xFFu);
  const uint32_t pc = popcount8_lanes(concl);
  const uint32_t extended = c0 + pc < 0x7FFFu ? c0 + pc : 0x7FFFu;
  const uint32_t counter = flips ? run - 1u : extended;
  bool crossed = c0 < score && c0 + pc >= score;
  if (score == 0x7FFFu) crossed = crossed || (c0 == 0x7FFFu && pc > 0u);
  *changed = flips || crossed;
  return (counter << 1) | a_fin;
}

}  // namespace swar
