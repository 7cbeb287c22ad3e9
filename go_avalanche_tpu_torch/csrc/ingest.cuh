// The record I/O shared by the two window-ingest kernels (vote_u8.cu,
// vote_swar.cu): arguments, the flat walk over the [N, T] planes, and
// the masked write-back.
//
// Both kernels are elementwise per record, so they walk the flat N*T
// planes: thread w owns records 4w .. 4w+3 (one 32-bit word of each
// uint8 plane, one 64-bit word of the uint16 confidence plane), and
// neighbouring threads own neighbouring words, so every record access
// is coalesced.  Any N and T are taken: the last word may be ragged
// (fewer than 4 records), and is read and written byte by byte.  Only
// the two vote packs need the record's row and column, because they
// may be broadcast views (the fused exchange's consider pack is an
// [N, 1] column expanded over T, stride 0): they are read through their
// row and column strides, as whole words where a pack is the contiguous
// [N, T] plane.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ingest {

constexpr int kThreads = 256;

struct Args {
  const uint8_t* votes;          // [N, T] contiguous
  const uint8_t* consider;       // [N, T] contiguous
  const uint16_t* confidence;    // [N, T] contiguous, u16 bit patterns
  const uint8_t* yes_pack;       // [N, T] through (yes_rs, yes_cs)
  const uint8_t* consider_pack;  // [N, T] through (cons_rs, cons_cs)
  const uint8_t* mask;           // [N, T] bool; nullptr = all records
  uint8_t* votes_out;
  uint8_t* consider_out;
  uint16_t* confidence_out;
  uint8_t* changed_out;          // [N, T] bool, exactly 0 or 1
  long long yes_rs, yes_cs, cons_rs, cons_cs;  // strides in elements
  long long total, t;            // N*T, T
  int k, window, quorum, score;
  bool yes_words, cons_words;    // pack is contiguous on a 4-byte boundary
};

// One thread's records: the input lanes (lane b = record i0 + b).
struct Word {
  long long i0;
  int nvalid;                    // 4, or fewer in the ragged last word
  uint32_t votes, consider, yes, cons;
  uint32_t keep;                 // 0xFF per lane that updates
  uint32_t conf[4];
};

__device__ __forceinline__ uint32_t load_u8x4(const uint8_t* p, long long i0,
                                              int nvalid) {
  if (nvalid == 4) return *reinterpret_cast<const uint32_t*>(p + i0);
  uint32_t x = 0u;
  for (int b = 0; b < nvalid; ++b) {
    x |= static_cast<uint32_t>(p[i0 + b]) << (8 * b);
  }
  return x;
}

__device__ __forceinline__ void store_u8x4(uint8_t* p, long long i0,
                                           int nvalid, uint32_t x) {
  if (nvalid == 4) {
    *reinterpret_cast<uint32_t*>(p + i0) = x;
    return;
  }
  for (int b = 0; b < nvalid; ++b) {
    p[i0 + b] = static_cast<uint8_t>(x >> (8 * b));
  }
}

// A vote pack's 4 bytes for records i0 .. i0+nvalid-1 at (row, col) of
// record i0; the column wraps into the next row at T.
__device__ __forceinline__ uint32_t load_pack(const uint8_t* p, long long rs,
                                              long long cs, bool words,
                                              long long i0, int nvalid,
                                              long long row, long long col,
                                              long long t) {
  if (words && nvalid == 4) return *reinterpret_cast<const uint32_t*>(p + i0);
  uint32_t x = 0u;
  for (int b = 0; b < nvalid; ++b) {
    x |= static_cast<uint32_t>(p[row * rs + col * cs]) << (8 * b);
    if (++col == t) {
      col = 0;
      ++row;
    }
  }
  return x;
}

__device__ __forceinline__ Word load_word(const Args& a, long long w) {
  Word in;
  in.i0 = 4 * w;
  const long long left = a.total - in.i0;
  in.nvalid = left < 4 ? static_cast<int>(left) : 4;
  in.votes = load_u8x4(a.votes, in.i0, in.nvalid);
  in.consider = load_u8x4(a.consider, in.i0, in.nvalid);
  long long row = 0, col = 0;
  if (!(a.yes_words && a.cons_words && in.nvalid == 4)) {
    row = in.i0 / a.t;
    col = in.i0 - row * a.t;
  }
  in.yes = load_pack(a.yes_pack, a.yes_rs, a.yes_cs, a.yes_words, in.i0,
                     in.nvalid, row, col, a.t);
  in.cons = load_pack(a.consider_pack, a.cons_rs, a.cons_cs, a.cons_words,
                      in.i0, in.nvalid, row, col, a.t);
  const uint32_t valid = in.nvalid == 4 ? 0x01010101u
                                        : (1u << (8 * in.nvalid)) / 0xFFu;
  const uint32_t m = a.mask ? load_u8x4(a.mask, in.i0, in.nvalid) : valid;
  in.keep = m * 0xFFu;             // bool bytes are 0 or 1
  if (in.nvalid == 4) {
    const uint2 c = *reinterpret_cast<const uint2*>(a.confidence + in.i0);
    in.conf[0] = c.x & 0xFFFFu;
    in.conf[1] = c.x >> 16;
    in.conf[2] = c.y & 0xFFFFu;
    in.conf[3] = c.y >> 16;
  } else {
    for (int b = 0; b < 4; ++b) {
      in.conf[b] = b < in.nvalid ? a.confidence[in.i0 + b] : 0u;
    }
  }
  return in;
}

// Write the updated lanes where the mask is set and the input elsewhere
// (the reference kernel's final `where`); `changed` (0/1 per lane) only
// where the mask is set.
__device__ __forceinline__ void store_word(const Args& a, const Word& in,
                                           uint32_t votes, uint32_t consider,
                                           const uint32_t conf[4],
                                           uint32_t changed) {
  store_u8x4(a.votes_out, in.i0, in.nvalid,
             (votes & in.keep) | (in.votes & ~in.keep));
  store_u8x4(a.consider_out, in.i0, in.nvalid,
             (consider & in.keep) | (in.consider & ~in.keep));
  store_u8x4(a.changed_out, in.i0, in.nvalid, changed & in.keep & 0x01010101u);
  uint32_t out[4];
  for (int b = 0; b < 4; ++b) {
    out[b] = ((in.keep >> (8 * b)) & 1u) ? conf[b] : in.conf[b];
  }
  if (in.nvalid == 4) {
    *reinterpret_cast<uint2*>(a.confidence_out + in.i0) =
        make_uint2(out[0] | (out[1] << 16), out[2] | (out[3] << 16));
  } else {
    for (int b = 0; b < in.nvalid; ++b) {
      a.confidence_out[in.i0 + b] = static_cast<uint16_t>(out[b]);
    }
  }
}

// Validate, fill Args and launch `kernel` over ceil(N*T / 4) threads on
// `stream`; returns cudaGetLastError() (0 = launched).
inline int launch(void (*kernel)(Args), const void* votes,
                  const void* consider, const void* confidence,
                  const void* yes_pack, long long yes_rs, long long yes_cs,
                  const void* consider_pack, long long cons_rs,
                  long long cons_cs, const void* mask, void* votes_out,
                  void* consider_out, void* confidence_out, void* changed_out,
                  long long n, long long t, int k, int window, int quorum,
                  int score, void* stream) {
  if (n < 0 || t <= 0 || k <= 0 || k > 8 || window <= 0 || window > 8
      || quorum <= 0 || quorum > window) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.votes = static_cast<const uint8_t*>(votes);
  a.consider = static_cast<const uint8_t*>(consider);
  a.confidence = static_cast<const uint16_t*>(confidence);
  a.yes_pack = static_cast<const uint8_t*>(yes_pack);
  a.consider_pack = static_cast<const uint8_t*>(consider_pack);
  a.mask = static_cast<const uint8_t*>(mask);
  a.votes_out = static_cast<uint8_t*>(votes_out);
  a.consider_out = static_cast<uint8_t*>(consider_out);
  a.confidence_out = static_cast<uint16_t*>(confidence_out);
  a.changed_out = static_cast<uint8_t*>(changed_out);
  a.yes_rs = yes_rs;
  a.yes_cs = yes_cs;
  a.cons_rs = cons_rs;
  a.cons_cs = cons_cs;
  a.total = n * t;
  a.t = t;
  a.k = k;
  a.window = window;
  a.quorum = quorum;
  a.score = score;
  a.yes_words = yes_rs == t && yes_cs == 1
                && (reinterpret_cast<uintptr_t>(yes_pack) & 3u) == 0u;
  a.cons_words = cons_rs == t && cons_cs == 1
                 && (reinterpret_cast<uintptr_t>(consider_pack) & 3u) == 0u;
  if (a.total == 0) return 0;
  const long long words = (a.total + 3) / 4;
  const unsigned blocks = static_cast<unsigned>((words + kThreads - 1)
                                                / kThreads);
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ingest
