// SWAR device functions shared by the whole-round megakernel
// (megakernel.cu) and the two ingest kernels (vote_u8.cu, vote_swar.cu):
// the counterparts of the reference's `swar_window_fold` step,
// `swar_confidence_lane` and `_popcount8_i32`
// (go_avalanche_tpu/ops/pallas_vote.py), which its kernels share the
// same way, so the window semantics of the kernels can never drift; the
// closed-form confidence over the four lanes of a word at once
// (`closed_form4`); and the 16-byte streaming record I/O of the kernels
// that walk 16 records a thread.
//
// Layout (go_avalanche_tpu/ops/swar.py): 4 adjacent tx columns of a
// uint8 plane per 32-bit word, little-endian, column 4w + b in byte lane
// b.  A uint8 [N, T] plane read as 32-bit words IS this layout.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace swar {

constexpr uint32_t kLaneLsb = 0x01010101u;
constexpr uint32_t kLaneMsb = 0x80808080u;
constexpr uint32_t kNoCarry = 0xFEFEFEFEu;  // drops a lane's <<1 carry-out
constexpr uint32_t kLow7 = 0x7F7F7F7Fu;

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

// Each byte lane's highest set bit smeared down over the lane's lower bits.
__host__ __device__ __forceinline__ uint32_t smear_down(uint32_t x) {
  x |= (x >> 1) & kLow7;
  x |= (x >> 2) & 0x3F3F3F3Fu;
  x |= (x >> 4) & 0x0F0F0F0Fu;
  return x;
}

// The MSB of each byte lane that is not zero.
__host__ __device__ __forceinline__ uint32_t lane_nonzero(uint32_t x) {
  return (((x & kLow7) + kLow7) | x) & kLaneMsb;
}

// The per-record inputs of the closed form for two records, spread from
// byte lanes into the 16-bit lanes of one confidence word.
struct Pair {
  uint32_t pc, run_less1, a_fin, flip_mask, keep;
};

// The folded confidence word of two records (restored where unpolled);
// sets `crossed` to the MSB of each 16-bit lane whose counter crossed
// the score.  `bias` is (0x8000 - score) in each 16-bit lane.
__device__ __forceinline__ uint32_t fold_pair(uint32_t c, const Pair& p,
                                              uint32_t score, uint32_t bias,
                                              uint32_t& crossed) {
  const uint32_t c0 = (c >> 1) & 0x7FFF7FFFu;
  const uint32_t sum = c0 + p.pc;                          // <= 0x8007
  const uint32_t over = sum & 0x80008000u;
  const uint32_t sat = over - (over >> 15);                // 0x7FFF lanes
  const uint32_t extended = (sum & ~(over | sat)) | sat;
  const uint32_t counter = (p.run_less1 & p.flip_mask)
                           | (extended & ~p.flip_mask);
  const uint32_t folded = (counter << 1) | p.a_fin;
  crossed = ((extended + bias) & ~(c0 + bias)) & 0x80008000u;
  if (score == 0x7FFFu) crossed |= over;   // c0 == 0x7FFF and a vote counted
  return (folded & p.keep) | (c & ~p.keep);
}

// `swar::confidence_closed_form` for the four records of one SWAR word.
// `concl` / `yes` hold each record's per-draw outcomes in its byte lane
// (draw j at bit j); `lo` / `hi` are the u16 confidences of records 0-1
// and 2-3, replaced by the folded ones where `polled` (0/1 per byte lane)
// is set.  Returns the changed flags, 0/1 per byte lane.  Needs
// 0 < score <= 0x7FFF.
__device__ __forceinline__ uint32_t closed_form4(uint32_t concl, uint32_t yes,
                                                 uint32_t polled,
                                                 uint32_t score,
                                                 uint32_t& lo, uint32_t& hi) {
  yes &= concl;
  const uint32_t a0 = __byte_perm(lo, hi, 0x6420) & kLaneLsb;
  const uint32_t flips = lane_nonzero(concl & (yes ^ (a0 * 0xFFu)));
  const uint32_t f = smear_down(concl);           // lane LSB: any conclusive
  const uint32_t high = f & ~((f >> 1) & kLow7);  // the last conclusive draw
  const uint32_t a_fin =
      ((((yes & high) + kLow7) & kLaneMsb) >> 7) | (a0 & ~f);
  const uint32_t d = smear_down(concl & (yes ^ (a_fin * 0xFFu)));
  const uint32_t pc = popcount8_lanes(concl);
  // The trailing agree run, less one where the record flips (run >= 1
  // there, so no lane borrows).
  const uint32_t run_less1 = popcount8_lanes(concl & ~d) - (flips >> 7);
  const uint32_t flip_mask = (flips >> 7) * 0xFFu;
  const uint32_t keep = polled * 0xFFu;
  const uint32_t bias = (0x8000u - score) * 0x00010001u;
  // Byte lanes 0-1 (2-3) to the two 16-bit lanes; 0xFF lanes to 0xFFFF.
  const Pair p01 = {
      __byte_perm(pc, 0u, 0x4140), __byte_perm(run_less1, 0u, 0x4140),
      __byte_perm(a_fin, 0u, 0x4140), __byte_perm(flip_mask, 0u, 0x1100),
      __byte_perm(keep, 0u, 0x1100)};
  const Pair p23 = {
      __byte_perm(pc, 0u, 0x4342), __byte_perm(run_less1, 0u, 0x4342),
      __byte_perm(a_fin, 0u, 0x4342), __byte_perm(flip_mask, 0u, 0x3322),
      __byte_perm(keep, 0u, 0x3322)};
  uint32_t crossed01, crossed23;
  lo = fold_pair(lo, p01, score, bias, crossed01);
  hi = fold_pair(hi, p23, score, bias, crossed23);
  const uint32_t crossed_lanes = __byte_perm(crossed01, crossed23, 0x7531);
  return ((flips | crossed_lanes) >> 7) & polled;
}

// N 16-byte chunks as 4N words, read / written streaming.
template <int N>
__device__ __forceinline__ void load_chunks(const uint4* p,
                                            uint32_t (&w)[4 * N]) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    const uint4 v = __ldcs(p + c);
    w[4 * c] = v.x;
    w[4 * c + 1] = v.y;
    w[4 * c + 2] = v.z;
    w[4 * c + 3] = v.w;
  }
}

template <int N>
__device__ __forceinline__ void store_chunks(uint4* p,
                                             const uint32_t (&w)[4 * N]) {
#pragma unroll
  for (int c = 0; c < N; ++c) {
    __stcs(p + c, make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2],
                             w[4 * c + 3]));
  }
}

}  // namespace swar
